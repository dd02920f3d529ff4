"""Partitioning rules and the mesh context of the port, as the
reference's ``repro/dist/shardings.py``.

One module owns the layout story:

  * ``use_mesh`` / ``active_mesh`` / ``suspend_mesh`` — the mesh the
    model code reads at call time, a
    ``torch.distributed.device_mesh.DeviceMesh`` with the reference's
    axis names (``("data", "model")`` or ``("pod", "data", "model")``).
    Inside ``use_mesh`` a plain tensor meeting a DTensor counts as
    replicated (``implicit_replication``): positions, masks and scalars
    are the same on every rank;
  * ``OPTS`` / ``set_opts`` — the strategy flags the placed paths read
    (expert parallelism, pure FSDP, serve-time tensor parallelism,
    sequence parallelism) and the dry run's mixed-precision flag;
  * ``param_pspec`` — the reference's 2-D (fsdp x tensor) rule table
    over the port's leaf names (``lm.named_leaves``). The port's layers
    are unstacked, so a layer leaf's spec is the reference's without
    its leading ``None``;
  * ``params_shardings`` / ``batch_shardings`` / ``cache_pspec`` — a
    ``Sharding`` (mesh and pruned spec) per leaf, and ``place_params``
    / ``place`` to make DTensors of them;
  * ``constraint`` and ``constrain_*`` — the activation constraints the
    model calls on its hot paths, a ``redistribute`` of a DTensor; each
    is a no-op off-mesh and on a plain tensor.

A spec is the reference's PartitionSpec as a tuple: one entry a tensor
dim, each ``None``, an axis name or a tuple of names. DTensor maps each
mesh dim to a placement instead, and ``to_placements`` converts: a
tensor dim sharded over ``("pod", "data")`` is ``Shard(d)`` on both mesh
dims, in mesh order. ``COUNTS`` counts the placed branches taken
(``redistribute`` at a constraint site, the placed attention, the
expert-parallel MoE, each branch of the placed decode attention, the
pipeline), so a caller can show that a run reached them.
"""
from __future__ import annotations

import collections
import contextlib
import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor

# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_ACTIVE_MESH: Optional[Any] = None
COUNTS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def use_mesh(mesh):
    """Dynamic-scope mesh: model code reads it via ``active_mesh()``, so
    the same forward runs placed or unplaced. The outermost ``use_mesh``
    of a mesh also turns on DTensor's implicit replication of plain
    tensors."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        if mesh is not None and prev is None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                yield mesh
        else:
            yield mesh
    finally:
        _ACTIVE_MESH = prev


def active_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def suspend_mesh():
    """Hide the active mesh (no-op constraints), as inside the
    pipeline's per-stage code, which works on local tensors."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = None
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


# ---------------------------------------------------------------------------
# Strategy flags
# ---------------------------------------------------------------------------

OPTS = {
    "moe_ep": False,         # explicit-collective expert parallelism
    "fsdp_pure": False,      # every mesh axis is data-parallel
    "serve_tp_only": False,  # decode: tensor-parallel only, batch replicated
    "seq_parallel": False,   # shard activation sequence axis over 'model'
    "bf16_params": False,    # mixed-precision training (f32 master in opt)
}


def set_opts(**kwargs) -> dict:
    """Set strategy flags; returns the previous values of the flags set."""
    prev = {}
    for k, v in kwargs.items():
        if k not in OPTS:
            raise KeyError(f"unknown sharding opt '{k}'; have {sorted(OPTS)}")
        prev[k] = OPTS[k]
        OPTS[k] = bool(v)
    return prev


# ---------------------------------------------------------------------------
# Mesh-axis helpers (a DeviceMesh, or anything with ``mesh_dim_names``
# and a ``shape`` tuple)
# ---------------------------------------------------------------------------

def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _mesh_axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return int(tuple(mesh.shape)[names.index(name)]) if name in names else 1


def _dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes in mesh order (everything but 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def _dp_for(mesh, batch: int):
    """The widest data-parallel axis (group) that divides ``batch``.

    Tries the full dp-axis product first (('pod','data') on multi-pod
    meshes), then shorter prefixes, then the remaining single axes.
    Returns a bare axis name, a tuple of names, or None (replicate).
    """
    axes = _dp_axes(mesh)
    cands = [axes[:i] for i in range(len(axes), 0, -1)]
    cands += [(a,) for a in axes[1:]]
    best, best_size = None, 1
    for cand in cands:
        size = 1
        for a in cand:
            size *= _mesh_axis_size(mesh, a)
        if size > best_size and batch % size == 0:
            best, best_size = cand, size
    if best is None:
        return None
    return best[0] if len(best) == 1 else best


def batch_axes():
    """Axes the leading batch dim shards over under the active mesh."""
    mesh = active_mesh()
    if mesh is None or OPTS["serve_tp_only"]:
        return None
    axes = _dp_axes(mesh)
    if OPTS["fsdp_pure"]:
        axes = axis_names(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


# ---------------------------------------------------------------------------
# Parameter partition rules
# ---------------------------------------------------------------------------

# (regex on the leaf's path without its layer prefix, '/'-joined) -> spec.
# First match wins; unmatched leaves replicate.
_RULES: Sequence[Tuple[str, Tuple]] = (
    (r"^embed$", ("model", "data")),         # (V, D): vocab=tensor, d=fsdp
    (r"^lm_head$", ("data", "model")),       # (D, V)
    (r"(^|/)(attn|cross)/(wq|wk|wv)$", ("data", "model")),
    (r"(^|/)(attn|cross)/wo$", ("model", "data")),
    (r"(^|/)mlp/(w1|w3|mask_w1)$", ("data", "model")),
    (r"(^|/)mlp/(w2|mask_w2)$", ("model", "data")),
    (r"(^|/)moe/router$", ("data", None)),   # (D, E): experts replicated
    (r"(^|/)moe/(w1|w3)$", (None, "data", "model")),   # (E, D, F)
    (r"(^|/)moe/w2$", (None, "model", "data")),        # (E, F, D)
    (r"(^|/)mamba/in_proj$", ("data", "model")),       # (D, 2*Di)
    (r"(^|/)mamba/out_proj$", ("model", "data")),      # (Di, D)
    (r"(^|/)mamba/x_proj$", ("model", None)),          # (Di, R+2N)
    (r"(^|/)mamba/dt_proj_w$", (None, "model")),       # (R, Di)
    (r"(^|/)mamba/conv_w$", (None, "model")),          # (CW, Di)
    (r"(^|/)mamba/A_log$", ("model", None)),           # (Di, N)
)

_STACKED = ("layers", "enc_layers")


def _base_path(name: str) -> str:
    """``layers::3::attn::wq`` -> ``attn/wq``; ``embed`` -> ``embed``."""
    parts = name.split("::")
    if len(parts) > 2 and parts[0] in _STACKED and parts[1].isdigit():
        parts = parts[2:]
    return "/".join(parts)


def param_pspec(name: str, leaf) -> Tuple:
    """Partition rule for one parameter leaf, ``name`` as
    ``lm.named_leaves`` gives it; ``leaf`` only contributes its ndim.
    Specs have exactly ``leaf.ndim`` entries."""
    base = _base_path(name)
    ndim = getattr(leaf, "ndim", len(getattr(leaf, "shape", ())))
    for pat, rule in _RULES:
        if re.search(pat, base):
            return tuple(rule) if len(rule) == ndim else (None,) * ndim
    return (None,) * ndim


def _prune_spec(mesh, shape, spec) -> Tuple:
    """Drop sharded axes that are absent from ``mesh`` or do not divide
    their dimension — the guard that lets one rule table serve smoke
    configs, degraded meshes and full production shapes alike."""
    if len(spec) > len(shape):
        raise ValueError(
            f"spec {spec} has more entries than array rank {len(shape)}")
    names = set(axis_names(mesh))
    out = []
    used = set()
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            out.append(None)
            continue
        group = (ax,) if isinstance(ax, str) else tuple(ax)
        while group:
            if all(a in names for a in group) and not (set(group) & used):
                size = 1
                for a in group:
                    size *= _mesh_axis_size(mesh, a)
                if dim % size == 0:
                    break
            group = group[:-1]
        if group:
            used.update(group)
            out.append(group[0] if len(group) == 1 else group)
        else:
            out.append(None)
    return tuple(out)


def to_placements(mesh, spec: Tuple) -> Tuple:
    """A (pruned) spec as DTensor placements, one a mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            out[names.index(a)] = Shard(dim)
    return tuple(out)


def spec_of(t) -> Tuple:
    """The spec of a placed tensor's placements (the inverse of
    ``to_placements``; a Partial placement counts as replicated)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    dims = [[] for _ in range(t.ndim)]
    for name, pl in zip(axis_names(mesh), t.placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
    return tuple(None if not g else g[0] if len(g) == 1 else tuple(g)
                 for g in dims)


class Sharding(NamedTuple):
    """The port's NamedSharding: a mesh and a pruned spec."""
    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> Tuple:
        return to_placements(self.mesh, self.spec)


def _named(tree) -> Dict[str, Any]:
    """Leaves of a ``Params`` (``lm.named_leaves``) or of a flat dict."""
    if isinstance(tree, dict):
        return dict(tree)
    from repro_torch.models.lm import named_leaves
    return dict(named_leaves(tree))


def params_shardings(mesh, params) -> Dict[str, Sharding]:
    """A ``Sharding`` for every leaf of ``params`` (a ``Params`` or a
    dict of name -> tensor), keyed by leaf name. Works on anything with
    a shape; the target of ``place_params`` and of a checkpoint restore
    onto another mesh (elastic rescale)."""
    return {name: Sharding(mesh, _prune_spec(mesh, tuple(leaf.shape),
                                             param_pspec(name, leaf)))
            for name, leaf in _named(params).items()}


def place(t: Tensor, sharding: Sharding):
    """A DTensor of ``t`` (the same full tensor on every rank, moved to
    the mesh's device) under ``sharding``: each rank keeps its shard,
    with no communication and no copy where the shard is ``t`` itself
    (then it shares ``t``'s memory)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    return distribute_tensor(t.to(mesh.device_type), mesh,
                             sharding.placements, src_data_rank=None)


def local_index(shape, sharding: Sharding) -> Tuple[slice, ...]:
    """This rank's block of a ``shape`` array under ``sharding``: each
    sharded dim split evenly, over its mesh axes in mesh order (the
    callback index of ``jax.make_array_from_callback``)."""
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    lo, size = [0] * len(shape), list(shape)
    for d, ax in enumerate(sharding.spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            n = _mesh_axis_size(mesh, a)
            if size[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {a} ({n})")
            size[d] //= n
            lo[d] += coord[names.index(a)] * size[d]
    return tuple(slice(o, o + n) for o, n in zip(lo, size))


def from_host(arr, sharding: Sharding, convert=None):
    """A DTensor of a host array (numpy, or anything sliceable) under
    ``sharding``: each rank slices out and copies only its own block
    (``convert`` turns that block into a CPU tensor; default
    ``torch.from_numpy`` of a contiguous copy)."""
    import numpy as np
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    block = arr[local_index(tuple(arr.shape), sharding)]
    t = (convert(block) if convert is not None
         else torch.from_numpy(np.ascontiguousarray(block)))
    return DTensor.from_local(t.to(mesh.device_type), mesh,
                              sharding.placements, run_check=False,
                              shape=torch.Size(arr.shape),
                              stride=_contiguous_stride(arr.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


@torch.no_grad()
def place_params(mesh, params, shardings: Optional[Dict[str, Sharding]]
                 = None):
    """Replace every leaf of ``params`` (a ``Params``) in place by its
    DTensor under ``shardings`` (default ``params_shardings``); returns
    ``params``."""
    shardings = shardings or params_shardings(mesh, params)
    for mod_name, mod in params.named_modules():
        prefix = mod_name.replace(".", "::") + "::" if mod_name else ""
        for store in (mod._parameters, mod._buffers):
            for key, t in list(store.items()):
                if t is None:
                    continue
                d = place(t.detach(), shardings[prefix + key])
                store[key] = (torch.nn.Parameter(d, requires_grad=False)
                              if store is mod._parameters else d)
    return params


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------

def batch_shardings(mesh, specs: Dict[str, Any]) -> Dict[str, Sharding]:
    """Shard every model input (a dict of anything with a shape) on its
    leading (batch) axis."""
    out = {}
    for name, leaf in specs.items():
        shape = tuple(leaf.shape)
        spec = () if not shape else (_dp_for(mesh, shape[0]),) + (
            None,) * (len(shape) - 1)
        out[name] = Sharding(mesh, spec)
    return out


def cache_pspec(mesh, cache: Dict[str, Any]) -> Dict[str, Sharding]:
    """Decode-cache shardings (the cache of ``lm.init_cache``).

    KV tensors (L, B, W, KV, dh) shard heads over 'model' when the
    kv-head count divides it, else the ring axis W (the cache stays
    sequence-sharded; ``layers.decode_attention`` mirrors this choice) —
    never both.
    """
    msize = _mesh_axis_size(mesh, "model")
    out = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            dp = _dp_for(mesh, shape[1])
            if shape[3] % msize == 0:
                spec = (None, dp, None, "model", None)
            elif shape[2] % msize == 0:
                spec = (None, dp, "model", None, None)
            else:
                spec = (None, dp, None, None, None)
        elif name == "positions":
            spec = (_dp_for(mesh, shape[0]), None)
        elif name == "ssm":                   # (L, B, Di, N)
            spec = (None, _dp_for(mesh, shape[1]), "model", None)
        elif name == "conv":                  # (L, B, CW-1, Di)
            spec = (None, _dp_for(mesh, shape[1]), None, "model")
        elif name == "enc_out":               # (B, F, D)
            spec = (_dp_for(mesh, shape[0]), None, None)
        else:
            spec = (None,) * len(shape)
        out[name] = Sharding(mesh, _prune_spec(mesh, shape, spec))
    return out


# ---------------------------------------------------------------------------
# Activation constraints (model hot paths)
# ---------------------------------------------------------------------------

_DTENSOR = None


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def one_axis_a_dim(t):
    """A placed ``t`` with no dim sharded over more than one mesh dim
    (those mesh dims replicated): an index tensor as torch 2.11's
    DTensor takes it (its index strategy refuses [Shard(0), Shard(0)],
    as ``fsdp_pure`` places a batch on a 2-D mesh). ``t`` itself when
    plain or already so."""
    if not is_placed(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dims = [p.dim for p in t.placements if isinstance(p, Shard)]
    if len(dims) == len(set(dims)):
        return t
    place = [Replicate() if isinstance(p, Shard) and dims.count(p.dim) > 1
             else p for p in t.placements]
    return t.redistribute(t.device_mesh, place)


def whole_heads(x, n_heads: int):
    """``x`` (..., n_heads * dh), about to be split into heads, with no
    mesh dim sharding its last dim unless that dim's size divides
    ``n_heads`` (the rule table shards a projection's columns whenever
    n_heads * dh divides, which can cut a head in two); ``x`` itself
    when plain."""
    if not is_placed(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    place = tuple(Replicate() if isinstance(pl, Shard) and pl.dim == last
                  and n_heads % mesh.size(i) else pl
                  for i, pl in enumerate(x.placements))
    if place == tuple(x.placements):
        return x
    COUNTS["whole_heads"] += 1
    return x.redistribute(mesh, place)


def constraint(x, *spec):
    """``x`` redistributed to ``spec`` on the active mesh; ``x`` itself
    off-mesh, for a plain tensor, or when it is placed so already. Axes
    that are missing from the mesh or do not divide the dimension are
    pruned instead of erroring."""
    mesh = active_mesh()
    if mesh is None or not is_placed(x):
        return x
    target = to_placements(mesh, _prune_spec(mesh, tuple(x.shape), spec))
    if tuple(x.placements) == target:
        return x
    COUNTS["constraint"] += 1
    return x.redistribute(mesh, target)


def constrain_hidden(x):
    """(B, S, D) residual-stream states: batch over the dp axes (all
    axes under fsdp_pure), sequence over 'model' under seq_parallel."""
    mesh = active_mesh()
    if mesh is None:
        return x
    spec = [batch_axes()] + [None] * (x.ndim - 1)
    if OPTS["seq_parallel"] and not OPTS["fsdp_pure"] and x.ndim >= 3:
        spec[1] = "model"
    return constraint(x, *spec)


def constrain_heads(q):
    """(B, S, H, dh) attention tensors: heads over 'model' (tensor
    parallelism); under fsdp_pure there is no tensor axis to use."""
    mesh = active_mesh()
    if mesh is None:
        return q
    spec = [batch_axes()] + [None] * (q.ndim - 1)
    if not OPTS["fsdp_pure"]:
        spec[-2] = "model"
    return constraint(q, *spec)


def constrain_logits(logits):
    """(B, C, Vp) loss-chunk logits: vocab over 'model' so the lse
    reduction stays sharded until the final scalar."""
    mesh = active_mesh()
    if mesh is None:
        return logits
    spec = [batch_axes()] + [None] * (logits.ndim - 1)
    if not OPTS["fsdp_pure"]:
        spec[-1] = "model"
    return constraint(logits, *spec)


# ---------------------------------------------------------------------------
# Local tensors and explicit collectives (the reference's shard_map
# regions: the expert-parallel MoE block, the pipeline)
# ---------------------------------------------------------------------------

def as_placed(t, mesh):
    """``t`` as a DTensor on ``mesh``: itself if placed, else replicated
    (the same tensor on every rank)."""
    if is_placed(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full(t):
    """The whole of a placed ``t`` on every rank; ``t`` if plain."""
    return t.full_tensor() if is_placed(t) else t


def to_local(t, mesh, placements, grad_placements=None) -> Tensor:
    """This rank's shard of ``t`` redistributed to ``placements``. Its
    gradient is read as ``grad_placements`` (default ``placements``):
    ``Partial()`` over a mesh dim where each rank's gradient is only its
    share, as for a tensor used by rows split over that dim."""
    return as_placed(t, mesh).redistribute(mesh, placements).to_local(
        grad_placements=grad_placements)


def gather_local(t: Tensor, axis: str, dim: int, mesh) -> Tensor:
    """A local shard all-gathered over mesh axis ``axis`` along ``dim``
    (its gradient a reduce-scatter); ``t`` itself when the axis is not
    in the mesh."""
    if axis not in axis_names(mesh):
        return t
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single_autograd",  # torch >= 2.13
                     None) or funcol.all_gather_tensor_autograd
    return gather(t, gather_dim=dim,
                  group=(mesh, axis_names(mesh).index(axis)))


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) over a group whose result every rank then uses
    alike: the gradient of each rank's term is the result's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyPartialGrad(torch.autograd.Function):
    """Identity whose gradient is all-reduced (sum) over a group: a
    replicated input each rank uses for its own share of the work."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: Tensor, mesh, axis: str) -> Tensor:
    """Sum of every rank's ``t`` over mesh axis ``axis``, replicated;
    ``t`` where the axis is absent or of size 1."""
    if _mesh_axis_size(mesh, axis) == 1:
        return t
    return _SumReplicated.apply(t, mesh.get_group(axis))


def copy_partial_grad(t: Tensor, mesh, axis: str) -> Tensor:
    """``t``, with its gradient summed over mesh axis ``axis``."""
    if _mesh_axis_size(mesh, axis) == 1:
        return t
    return _CopyPartialGrad.apply(t, mesh.get_group(axis))
