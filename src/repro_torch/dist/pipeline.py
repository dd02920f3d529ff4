"""GPipe pipeline parallelism over the layers, as the reference's
``repro/dist/pipeline.py``.

``pipeline_lm_forward`` partitions the decoder layers of the LM across
the 'model' mesh axis (one contiguous slab of layers a stage) and
streams microbatches through the stages:

  step t:  stage 0 ingests microbatch t (while any remain); every stage
           applies its layers to the microbatch it holds; every stage
           hands its output to stage s+1 (a ring shift).

After ``n_micro + n_stages - 1`` steps every microbatch has crossed all
stages; the last stage's outputs are summed over the stages, so the
result is replicated (bubble fraction (S-1)/T, the classic GPipe
schedule).

The reference runs the schedule inside ``shard_map`` with ``ppermute``
and ``psum``, which ``jax.grad`` differentiates. Here each rank runs
its stage on local tensors with explicit collectives that autograd
differentiates: the ring shift is ``all_to_all_single`` from
``torch.distributed.nn.functional`` (its gradient runs the ring
backwards); the closing sum's gradient is the identity (every rank uses
its result alike); the microbatches' gradient and each layer's are
summed over the stages, so after the backward every rank holds the
whole gradient of every leaf, as the unplaced forward's. Every rank
calls every collective in the same order. Embedding and the final norm
run outside the stages; activation constraints are suspended inside
them (``shardings.suspend_mesh``).

The parameters come unplaced (every rank holds every layer; each stage
reads its slab out of them), or placed by stage (``stage_params``: rank
s holds only its own layers, the reference's ``P(_STAGE_AXIS)`` on its
stacked layers). Placed, a stage's layer gradients stay on that stage,
as the reference's do, and no all-reduce of the layers runs.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.dist import shardings as sh

Tensor = torch.Tensor

_STAGE_AXIS = "model"


def _ring_shift(y: Tensor, stage: int, n_stages: int, group) -> Tensor:
    """Each stage's ``y`` handed to stage s+1 (mod n), differentiably."""
    from torch.distributed.nn.functional import all_to_all_single
    nxt, prv = (stage + 1) % n_stages, (stage - 1) % n_stages
    flat = y.reshape(1, -1)
    out = torch.empty_like(flat)
    out = all_to_all_single(
        out, flat, output_split_sizes=[int(i == prv) for i in range(n_stages)],
        input_split_sizes=[int(i == nxt) for i in range(n_stages)],
        group=group)
    return out.reshape(y.shape)


class _StageSlab(torch.autograd.Function):
    """The stage's own leaves out of every layer leaf (each rank passes
    all of them, in one order). The backward sums each leaf's gradient
    over the stages in one all-reduce, zeros for the leaves a stage did
    not use, so every rank gets every leaf's whole gradient."""

    @staticmethod
    def forward(ctx, group, lo: int, hi: int, *leaves):
        ctx.group, ctx.lo, ctx.hi = group, lo, hi
        ctx.shapes = [(t.shape, t.dtype, t.device) for t in leaves]
        return tuple(t.view_as(t) for t in leaves[lo:hi])

    @staticmethod
    def backward(ctx, *grads):
        import torch.distributed as dist
        full: List[Tensor] = []
        for i, (shape, _, dev) in enumerate(ctx.shapes):
            g = grads[i - ctx.lo] if ctx.lo <= i < ctx.hi else None
            full.append(torch.zeros(shape, dtype=torch.float32, device=dev)
                        if g is None else g.float())
        flat = torch.cat([g.reshape(-1) for g in full])
        dist.all_reduce(flat, group=ctx.group)
        out, at = [], 0
        for shape, dtype, _ in ctx.shapes:
            n = shape.numel()
            out.append(flat[at:at + n].view(shape).to(dtype))
            at += n
        return (None, None, None, *out)


class _Tree(dict):
    """A layer's leaves by key, read as ``_dec_block`` reads ``Params``."""
    prepared = False


def _tree(mod, values) -> _Tree:
    """``mod``'s structure (a ``Params``) over ``values``, taken in the
    order of ``lm.named_leaves``."""
    from torch import nn

    from repro_torch.models.lm import Params
    out = _Tree()
    out.prepared = getattr(mod, "prepared", False)
    for key in sorted(mod.keys()):
        v = mod[key]
        if isinstance(v, nn.ModuleList):
            out[key] = [_tree(sub, values) for sub in v]
        elif isinstance(v, Params):
            out[key] = _tree(v, values)
        else:
            out[key] = next(values)
    return out


def stage_params(cfg, params, mesh):
    """``params`` placed by stage over the mesh's 'model' axis: a
    ``Params`` holding this rank's slab of decoder layers (stage s of n
    holds layers [s L/n, (s+1) L/n)) and every other leaf whole, the
    tensors ``params``' own. ``stage`` records (s, n)."""
    from torch import nn

    from repro_torch.models.lm import Params
    n = sh._mesh_axis_size(mesh, _STAGE_AXIS)
    if cfg.n_layers % n:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n} "
                         f"stages")
    s = mesh.get_local_rank(_STAGE_AXIS)
    per = cfg.n_layers // n
    out = Params({})
    for key in params.keys():
        if key == "layers":
            out.add_module(key, nn.ModuleList(
                params.layers[s * per:(s + 1) * per]))
        elif key in params._modules:
            out.add_module(key, params._modules[key])
        elif key in params._buffers:
            out.register_buffer(key, params._buffers[key])
        else:
            out.register_parameter(key, params._parameters[key])
    out.stage = (s, n)
    return out


def pipeline_lm_forward(cfg, params, tokens: Tensor, mesh,
                        n_micro: int = 2) -> Tensor:
    """Stage-partitioned decoder forward. Returns (B, S, D) hidden
    states (post final-norm), numerically matching ``lm.forward``,
    replicated on every rank.

    Requires cfg.n_layers % mesh 'model' size == 0 and batch % n_micro
    == 0, and parameters unplaced or placed by ``stage_params`` over
    this mesh (no DTensor leaves). Dense / MoE / SSM decoder-only
    families only (no encoder-decoder cross-attention through the
    pipeline).
    """
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    n_stages = sh._mesh_axis_size(mesh, _STAGE_AXIS)
    n_layers = cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(
            f"n_layers={n_layers} not divisible by {n_stages} stages")
    if cfg.is_encdec:
        raise NotImplementedError("pipeline over enc-dec not supported")
    if any(sh.is_placed(t) for t in lm.leaves(params)):
        raise ValueError("the pipeline reads each stage's layers whole: "
                         "pass unplaced or stage_params' parameters")
    group = mesh.get_group(_STAGE_AXIS)
    stage = mesh.get_local_rank(_STAGE_AXIS)
    per = n_layers // n_stages
    mine = range(stage * per, (stage + 1) * per)
    staged = getattr(params, "stage", None)
    if staged is not None and staged != (stage, n_stages):
        raise ValueError(f"parameters placed for stage {staged[0]} of "
                         f"{staged[1]}, this rank is stage {stage} of "
                         f"{n_stages}")

    dt = L.cdtype(cfg)
    x = params["embed"].to(dt)[tokens]                         # (B, S, D)
    b, s, d = x.shape
    if b % n_micro:
        raise ValueError(f"batch={b} not divisible by n_micro={n_micro}")
    # every stage's share of the microbatches' gradient is summed
    x_mb = sh.copy_partial_grad(x, mesh, _STAGE_AXIS).reshape(
        n_micro, b // n_micro, s, d)
    positions = torch.arange(s, device=x.device)
    n_steps = n_micro + n_stages - 1

    layers = list(params.layers)
    if staged is not None:
        slab_layers = layers
    elif n_stages > 1:
        counts = [len(lm.named_leaves(lp)) for lp in layers]
        lo, hi = sum(counts[:mine.start]), sum(counts[:mine.stop])
        slab = iter(_StageSlab.apply(group, lo, hi,
                                     *(t for lp in layers
                                       for t in lm.leaves(lp))))
        slab_layers = [_tree(layers[i], slab) for i in mine]
    else:
        slab_layers = layers

    def run_slab(h: Tensor) -> Tensor:
        for lp in slab_layers:
            h, _ = lm._dec_block(cfg, lp, h, positions, None, False)
        return h

    first = torch.full((), stage == 0, device=x.device)
    last = torch.full((), stage == n_stages - 1, device=x.device)
    idx = torch.arange(n_micro, device=x.device)
    state = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    sh.COUNTS["pipeline"] += 1
    with sh.suspend_mesh():
        for t in range(n_steps):
            # every stage computes alike (where, not Python branches), so
            # each rank's backward reaches the same collectives
            h = torch.where(first, x_mb[min(t, n_micro - 1)], state)
            y = run_slab(h)
            # microbatch m exits the last stage at step m + n_stages - 1;
            # later (warm-down) iterations of stage 0 recirculate garbage
            # that never reaches the collection window
            hit = (idx == t - (n_stages - 1)) & last
            outs = torch.where(hit[:, None, None, None], y[None], outs)
            if n_stages > 1:
                state = _ring_shift(y, stage, n_stages, group)
        # only the last stage wrote into outs; sum it to every stage
        outs = sh.all_reduce_sum(outs, mesh, _STAGE_AXIS)
    hidden = outs.reshape(b, s, d)
    return L.rms_norm(hidden, params["final_norm"], cfg.norm_eps)
