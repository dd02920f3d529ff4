"""Model configurations of the port: the JSC MLPs (``configs.jsc``) and
the LM stack's architectures, with ``--arch <id>`` resolution for the
launcher and the tests."""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (chameleon_34b, dbrx_132b, deepseek_67b,
                                 falcon_mamba_7b, glm4_9b, hymba_1_5b,
                                 mixtral_8x22b, nemotron_4_340b,
                                 phi4_mini_3_8b, seamless_m4t_large_v2)
from repro_torch.configs.base import (SHAPES, ArchConfig,  # noqa: F401
                                      ShapeConfig, TensorSpec, input_specs)

_MODULES = {
    "chameleon-34b": chameleon_34b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "falcon-mamba-7b": falcon_mamba_7b,
    "glm4-9b": glm4_9b,
    "deepseek-67b": deepseek_67b,
    "nemotron-4-340b": nemotron_4_340b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "mixtral-8x22b": mixtral_8x22b,
    "dbrx-132b": dbrx_132b,
    "hymba-1.5b": hymba_1_5b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKES: Dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch '{name}'; have {sorted(table)}")
    return table[name]


def all_cells() -> Tuple[Tuple[ArchConfig, ShapeConfig], ...]:
    """Every (arch x shape) dry-run cell, skips filtered per spec."""
    cells = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            if a.supports_shape(s):
                cells.append((a, s))
    return tuple(cells)
