"""Pluggable executor-engine registry for ``BitplaneNetwork``.

An *engine* is a name bound to a factory
``factory(bitnet, *, spec=None) -> Executor``; the returned object
implements the ``Executor`` protocol (the call surface
``BitplaneNetwork`` delegates to). Built-ins registered at import
(reference name in brackets):

  * ``"numpy"``                           — host bitplane fold (the
    default on the CPU);
  * ``"cuda"``          [``"pallas"``]    — monolithic ``lut_eval``
    kernel over the level-stacked ``DevicePlan``;
  * ``"cuda-streamed"`` [``"pallas-streamed"``] — streamed
    ``lut_eval_streamed`` kernel over the level-major ``TilePlan`` (the
    default on a CUDA device).

Registering a custom engine is one call and every call site that takes
``engine=`` (``BitplaneNetwork``, ``compile_logic_network``,
``LogicEngine``, ``launch.serve --engine``) picks it up with zero edits:

    from repro_torch.synth import executors

    @executors.register("my-engine")
    def build(bitnet, spec=None):
        return MyExecutor(bitnet)

Unknown names raise ``UnknownEngineError`` (a ``KeyError``) naming the
registered engines, at ``BitplaneNetwork`` construction time — not on
the first batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Executor(Protocol):
    """What an engine must implement (see ``_NumpyExecutor`` /
    ``_TorchExecutor`` in ``repro_torch.synth.executor``).

    Every method must be bit-identical to the numpy host fold on every
    reachable input; the engine-equivalence tests hold engines to that."""

    def pack_codes(self, codes):
        """(B, n_inputs) int codes -> packed PI words in the form this
        engine's ``classify_packed`` takes."""
        ...

    def apply_codes(self, codes: np.ndarray) -> np.ndarray:
        """(B, n_inputs) int codes -> (B, n_out_neurons) int64 codes."""
        ...

    def classify_codes(self, codes: np.ndarray,
                       n_classes: int) -> np.ndarray:
        """(B, n_inputs) int codes -> (B,) int32 argmax labels."""
        ...

    def classify_packed(self, pi_words, n_rows: int,
                        n_classes: int) -> np.ndarray:
        """Packed bitplanes (``pack_codes`` output, or (n_pi_wires, W)
        uint32 words) -> (n_rows,) int32 argmax labels (the
        serve-aggregation hot path)."""
        ...


ExecutorFactory = Callable[..., Executor]


class UnknownEngineError(KeyError):
    """Raised for an ``engine=`` name with no registered executor."""

    def __init__(self, name: str, known: Tuple[str, ...]):
        self.name = name
        self.known = tuple(known)
        super().__init__(
            f"unknown bitplane engine {name!r} (registered engines: "
            f"{', '.join(self.known) if self.known else '<none>'})")

    def __str__(self) -> str:   # KeyError str() would quote the message
        return self.args[0]


_REGISTRY: Dict[str, ExecutorFactory] = {}


def register(name: str, factory: Optional[ExecutorFactory] = None):
    """Bind ``name`` to an executor factory (idempotent re-bind wins).

    Usable directly — ``register("x", build)`` — or as a decorator —
    ``@register("x")``. The factory is called lazily, on the first
    batch through a ``BitplaneNetwork`` configured with that engine.
    """
    if factory is None:
        def _bind(f: ExecutorFactory) -> ExecutorFactory:
            _REGISTRY[name] = f
            return f
        return _bind
    _REGISTRY[name] = factory
    return factory


def get(name: str) -> ExecutorFactory:
    """Factory for a registered engine; ``UnknownEngineError`` if not."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownEngineError(name, names()) from None


def default_engine(device: torch.device) -> str:
    """The engine used where none is named: the streamed kernel on a
    CUDA device, the host fold elsewhere."""
    return "cuda-streamed" if torch.device(device).type == "cuda" else "numpy"


def names() -> Tuple[str, ...]:
    """Registered engine names, sorted (for CLIs and error messages)."""
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Built-in engines (factories import lazily: executor.py imports us)
# ---------------------------------------------------------------------------

@register("numpy")
def _numpy_engine(bitnet, spec=None):
    from .executor import _NumpyExecutor
    return _NumpyExecutor(bitnet, spec=spec)


@register("cuda")
def _cuda_engine(bitnet, spec=None):
    from .executor import _CudaExecutor
    return _CudaExecutor(bitnet, spec=spec)


@register("cuda-streamed")
def _streamed_engine(bitnet, spec=None):
    from .executor import _CudaStreamedExecutor
    return _CudaStreamedExecutor(bitnet, spec=spec)
