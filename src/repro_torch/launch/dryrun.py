"""Multi-pod dry run of the port: one step of an (arch x shape x mesh)
cell at production scale, on no device, as the reference's
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's per-device cost and memory analysis. Here one
process joins a ``fake`` process group of 256 ranks, (data 16, model
16), or 512 with ``--mesh multi``, (pod 2, data 16, model 16), as rank
0. Every collective over that group returns at once without moving
data. Parameters, optimizer state, caches and batches are DTensors
placed by the port's rule table (``shardings.params_shardings``,
``cache_pspec``, ``batch_shardings``) over fake tensors
(``FakeTensorMode``), so nothing is allocated on any device or on the
host: the dry run is the one entry point of the port that asks for no
device. Then rank 0 runs one step of the function the reference lowers
(``make_train_step`` with AdamW, ``lm.prefill``, or ``lm.init_cache``
then ``lm.decode_step``) and counts, per device:

  * ``flops_per_device``: the local ``aten`` ops rank 0 runs, by
    ``torch.utils.flop_counter``'s formulas. Replicated work counts on
    every device, as in XLA's per-device cost. DTensor runs each op's
    sharding propagation on global-shape fake tensors; those ops are
    left out (a ``FlopCounterMode`` around DTensor ops counts the global
    product instead of the local one). Attention on fake CPU tensors
    takes the plain path (``layers.full_attention`` /
    ``chunked_attention``), so its products are the ones counted.
    ``flops_by_shape`` splits the count by ``aten`` op and the local
    shapes of its inputs (FLOPs and calls);
  * ``collectives``: the output bytes of every collective rank 0 issues,
    functional (``_c10d_functional.*``, which DTensor uses) and c10d
    (``c10d.allreduce_``, ``alltoall_base_``, ..., which the
    expert-parallel MoE and the pipeline issue), by the reference's five
    kinds. An all-to-all that sends to one rank and receives from one
    (the pipeline's ring shift) is the reference's ``ppermute``, so it
    counts as ``collective-permute``. DTensor moves a shard from one
    tensor dim to another by an all-to-all on a CUDA mesh, but on a CPU
    mesh by an all-gather and a local chunk; the dry run takes the
    all-to-all (``_card_alltoall``);
  * ``bytes_accessed_per_device``: the input plus output bytes of each
    local op that is not a view, unfused, as pessimistic as the CPU
    backend's ``bytes accessed`` in the reference (the roofline's
    dominance uses the analytic memory model, as the reference's does);
  * ``argument_size_in_bytes``: the local shard bytes of the step's
    arguments (``rule_table_argument_bytes``: the same from the rule
    table's arithmetic, which it must equal); ``output_size_in_bytes``: of its outputs
    (``alias_size_in_bytes`` of those that are arguments updated in
    place); ``temp_size_in_bytes``: the peak of live local bytes the
    step allocates beyond its arguments (autograd's saved tensors too).

The record keeps the reference's keys, so the roofline
(``repro_torch.bench.roofline``) reads both alike. Its ``extrapolated``
block equals the direct count: the reference fits 1 and 2 layers
because XLA counts a scanned layer once, while the port's layers are
unrolled, so ``fit_points`` is null.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
      --shape train_4k --mesh single --out build/dryrun_torch

Importing this module starts no process group; ``run_cell`` starts one
and tears it down before it returns.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.bench.meta import REPO_ROOT
from repro_torch.configs import ARCHS, SHAPES, input_specs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist import shardings as sh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
DEFAULT_OUT = os.path.join(REPO_ROOT, "build", "dryrun_torch")


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (collectives return at once and move nothing); the group is
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own process group; one "
                           "is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# Counting rank 0's local work
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _marked_propagation(counter):
    """Mark DTensor's sharding propagation (``counter.propagating``) so
    the counter leaves its ops out (it runs each op on global-shape fake
    tensors), and run it outside the step's fake mode: its index
    arithmetic reads small tensors' values (``.tolist()``), which fake
    tensors do not have, and its shape propagation makes fake tensors
    of its own."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    targets = [(ShardingPropagator, n) for n in (
        "propagate_op_sharding_non_cached",
        "_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
        if n in vars(ShardingPropagator)]
    if not targets:
        raise RuntimeError("this torch's DTensor has no sharding "
                           "propagation to leave out of the count")
    # the shard arithmetic of a strided placement, which a local
    # redistribution reaches too
    strided = getattr(pt, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        targets.append((strided, "local_shard_size_and_offset"))
    saved = {t: vars(t[0])[t[1]] for t in targets}

    def wrap(attr):
        fn = attr.__func__ if isinstance(attr, staticmethod) else attr

        def marked(*args, **kwargs):
            counter.propagating += 1
            try:
                with unset_fake_temporarily():
                    return fn(*args, **kwargs)
            finally:
                counter.propagating -= 1
        return staticmethod(marked) if isinstance(attr, staticmethod) \
            else marked

    for (cls, name), attr in saved.items():
        setattr(cls, name, wrap(attr))
    try:
        yield
    finally:
        for (cls, name), attr in saved.items():
            setattr(cls, name, attr)


@contextlib.contextmanager
def _card_alltoall():
    """Route DTensor's shard-to-shard redistribution to its all-to-all
    op, as on a CUDA mesh. On a CPU mesh DTensor gathers the whole
    tensor and keeps its chunk instead (gloo has no all-to-all), which
    would count 16x the bytes and the temporary memory. Under the fake
    group the op runs its fake kernel: a chunk the input's size."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))

    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return t._local_tensor if sh.is_placed(t) else t


def _leaves(tree) -> list:
    """Every tensor of an op's or a step's arguments or outputs:
    tensors, modules (``lm.Params``: parameters and buffers), dicts,
    lists and tuples (NamedTuples too)."""
    from torch import nn
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def collective_kind(func, args) -> Optional[str]:
    """The reference's kind of a collective op (``None`` for a wait or a
    barrier); raises for a collective it does not know."""
    name = func._overloadpacket.__name__.replace("_", "")
    if "wait" in name or "barrier" in name:
        return None
    if "allgather" in name:
        return "all-gather"
    if "allreduce" in name:
        return "all-reduce"
    if "reducescatter" in name:
        return "reduce-scatter"
    if "alltoall" in name:
        splits = [a for a in args if isinstance(a, (list, tuple)) and a
                  and all(isinstance(x, int) for x in a)]
        if len(splits) >= 2 and all(sum(x != 0 for x in s) == 1
                                    for s in splits):
            return "collective-permute"
        return "all-to-all"
    raise ValueError(f"collective {func} has no kind in {COLLECTIVES}")


def _counter_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class LocalCounter(TorchDispatchMode):
        """Counts the local ops rank 0 runs (see the module's note)."""

        def __init__(self, arg_storages):
            super().__init__()
            self.flops = 0
            self.flops_by_shape: Dict[str, list] = {}  # op, shapes -> [f, n]
            self.bytes = 0
            self.n_ops = 0
            self.coll_bytes = {c: 0.0 for c in COLLECTIVES}
            self.coll_counts = {c: 0 for c in COLLECTIVES}
            self.args = set(arg_storages)
            self.propagating = 0               # inside DTensor's propagation
            self.live: Dict[int, list] = {}     # storage -> [bytes, refs]
            self.cur = self.peak = 0

        def _release(self, key):
            entry = self.live.get(key)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] == 0:
                self.cur -= entry[0]
                del self.live[key]

        def _track(self, t, whole: bool):
            """Count ``t``'s storage live until its last tensor dies;
            ``whole``: the storage's size, else the tensor's (a fake
            collective's output may view a larger scratch storage)."""
            key = _storage_key(t)
            if key in self.args:
                return
            entry = self.live.get(key)
            if entry is None:
                size = t.untyped_storage().nbytes() if whole else _nbytes(t)
                entry = self.live[key] = [size, 0]
                self.cur += entry[0]
                self.peak = max(self.peak, self.cur)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _leaves((args, kwargs))
            if any(sh.is_placed(t) for t in ins):
                return NotImplemented      # DTensor dispatches to local ops
            out = func(*args, **kwargs)
            if self.propagating:
                return out
            self.n_ops += 1
            outs = _leaves(out)
            collective = func.namespace in ("_c10d_functional", "c10d",
                                            "_dtensor")
            if collective:
                kind = collective_kind(func, args)
                if kind is not None:
                    moved = outs or ins[:1]
                    self.coll_bytes[kind] += sum(_nbytes(t) for t in moved)
                    self.coll_counts[kind] += 1
            pkt = func._overloadpacket
            if pkt in flop_registry:
                f = flop_registry[pkt](*args, **kwargs, out_val=out)
                self.flops += f
                shapes = " ".join(str(list(t.shape)) for t in ins)
                entry = self.flops_by_shape.setdefault(f"{pkt} {shapes}",
                                                       [0, 0])
                entry[0] += f
                entry[1] += 1
            if not func.is_view:
                seen = set()
                for t in ins + outs:
                    if id(t) not in seen:
                        seen.add(id(t))
                        self.bytes += _nbytes(t)
            for t in outs:
                self._track(t, whole=not collective)
            return out

    return LocalCounter


def count_step(fn: Callable, args: Tuple) -> Dict:
    """Run ``fn(*args)`` once (under the fake mode ``args`` were made in)
    and count it as rank 0's work: the record's cost and memory keys."""
    arg_tensors = [_local(t) for t in _leaves(args)]
    counter = _counter_class()(_storage_key(t) for t in arg_tensors)
    with _marked_propagation(counter), _card_alltoall(), counter:
        out = fn(*args)
    out_tensors = {id(t): t for t in map(_local, _leaves(out))}
    coll = {"bytes": counter.coll_bytes, "counts": counter.coll_counts,
            "total_bytes": sum(counter.coll_bytes.values())}
    return {
        "flops_per_device": float(counter.flops),
        "flops_by_shape": {k: {"flops": float(f), "calls": n} for k, (f, n)
                           in sorted(counter.flops_by_shape.items())},
        "bytes_accessed_per_device": float(counter.bytes),
        "collectives": coll,
        "local_ops": counter.n_ops,
        "argument_size_in_bytes": sum(_nbytes(t) for t in arg_tensors),
        "output_size_in_bytes": sum(_nbytes(t) for t in out_tensors.values()),
        "alias_size_in_bytes": sum(
            _nbytes(t) for t in out_tensors.values()
            if _storage_key(t) in counter.args),
        "temp_size_in_bytes": counter.peak,
    }


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _placed_zeros(spec, sharding: sh.Sharding):
    """A DTensor of zeros of a ``TensorSpec`` (or a tensor's shape and
    dtype) under ``sharding``, each rank holding only its block."""
    from torch.distributed.tensor import DTensor
    shape = tuple(spec.shape)
    block = [s.stop - s.start for s in sh.local_index(shape, sharding)]
    return DTensor.from_local(
        torch.zeros(block, dtype=spec.dtype), sharding.mesh,
        sharding.placements, run_check=False, shape=torch.Size(shape),
        stride=sh._contiguous_stride(shape))


def _place_tree(tree: Dict[str, Any], shardings: Dict[str, sh.Sharding]):
    return {k: _placed_zeros(v, shardings[k]) for k, v in tree.items()}


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh
               ) -> Tuple[Callable, Tuple]:
    """(fn, args): the step the reference lowers for this cell and its
    arguments, placed on ``mesh``. Call under a fake tensor mode: the
    full-size parameters are made whole before they are placed."""
    from repro_torch.models import lm
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optim import AdamW

    specs = input_specs(cfg, shape)
    batch = _place_tree(specs, sh.batch_shardings(mesh, specs))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    sh.place_params(mesh, params)

    if shape.kind == "train":
        opt = AdamW(lr=1e-4, mixed_precision=sh.OPTS["bf16_params"])
        opt.cast_params(lm.leaves(params))
        state = init_state(cfg, opt, params=params)
        return make_train_step(cfg, opt), (state, batch)

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            return lm.prefill(cfg, params, **batch)

        return prefill, (params, batch)

    B, S = shape.global_batch, shape.seq_len
    enc_frames = (S // cfg.frontend_frames_div) if cfg.is_encdec else 0
    whole = lm.init_cache(cfg, B, S, enc_frames)
    cache = _place_tree(whole, sh.cache_pspec(mesh, whole))

    @torch.no_grad()
    def decode(params, cache, batch):
        return lm.decode_step(cfg, params, cache, batch["tokens"],
                              batch["positions"])

    return decode, (params, cache, batch)


def _block_bytes(t, sharding: sh.Sharding) -> int:
    """Bytes of one rank's block of ``t`` (its global shape) under
    ``sharding``: each sharded dim divided by its mesh axes' sizes."""
    n = t.element_size()
    for dim, ax in zip(t.shape, tuple(sharding.spec) + (None,) * t.ndim):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            dim //= sh._mesh_axis_size(sharding.mesh, a)
        n *= dim
    return n


def rule_table_bytes(shape: ShapeConfig, mesh, args: Tuple) -> int:
    """The local bytes of ``build_cell``'s arguments as the rule table
    places them (``params_shardings`` for the parameters and the
    optimizer's moments and master copy, ``batch_shardings``,
    ``cache_pspec``), from the global shapes alone."""
    from repro_torch.models import lm
    if shape.kind == "train":
        state, batch = args
        params, extra = state.params, [state.opt.mu, state.opt.nu,
                                       state.opt.master or []]
    else:
        params, batch = args[0], args[-1]
        extra = []
    pshard = sh.params_shardings(mesh, params)
    names = lm.leaf_names(params)
    total = sum(_block_bytes(t, pshard[n]) for n, t in
                zip(names, lm.leaves(params)))
    for group in extra:
        total += sum(_block_bytes(t, pshard[n]) for n, t in zip(names, group))
    trees = [(batch, sh.batch_shardings(mesh, batch))]
    if shape.kind == "decode":
        trees.append((args[1], sh.cache_pspec(mesh, args[1])))
    for tree, shardings in trees:
        total += sum(_block_bytes(t, shardings[k]) for k, t in tree.items())
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """One cell's record (see the module's note); a cell the arch does
    not support (full attention at 500k context) is ``skipped``."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if not cfg.supports_shape(shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch at 500k context"}
    # DTensor cannot run the MoE block's dispatch under the rule table
    # at (16, 16) (a view of a non-contiguous local shard in the expert
    # einsum, a scatter into a replicated buffer it cannot propagate):
    # the port's placed MoE is the expert-parallel branch
    prev = sh.set_opts(moe_ep=True) if cfg.family == "moe" else {}
    t0 = time.perf_counter()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            with _fake_mode(), sh.use_mesh(mesh):
                fn, args = build_cell(cfg, shape, mesh)
                t_build = time.perf_counter() - t0
                expected = rule_table_bytes(shape, mesh, args)
                cost = count_step(fn, args)
            n_dev = mesh.size()
            opts = {k: v for k, v in sh.OPTS.items() if v}
    finally:
        sh.set_opts(**prev)
    t_step = time.perf_counter() - t0 - t_build
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "n_devices": int(n_dev),
        "build_s": round(t_build, 2), "step_s": round(t_step, 2),
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "opts": opts,
        "torch": torch.__version__,
    }
    result.update(cost)
    result["rule_table_argument_bytes"] = expected
    # the port's layers are unrolled: the direct count is the whole step
    result["extrapolated"] = {
        "flops_per_device": cost["flops_per_device"],
        "bytes_accessed_per_device": cost["bytes_accessed_per_device"],
        "collective_bytes": dict(cost["collectives"]["bytes"]),
        "collective_total_bytes": cost["collectives"]["total_bytes"],
        "fit_points": None,
    }
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opts", default="",
                    help="comma list of sharding-strategy knobs: "
                         "seq_parallel,serve_tp_only,moe_ep,fsdp_pure,"
                         "bf16_params")
    args = ap.parse_args(argv)
    prev = sh.set_opts(**{k: True for k in args.opts.split(",") if k})

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = []
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip cached] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        res = run_cell(arch, shape, mp)
                    except Exception as e:  # noqa: BLE001
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape,
                               "mesh": "multi" if mp else "single",
                               "status": "error", "error": repr(e)}
                        failures.append(tag)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    if res["status"] == "ok":
                        print(f"  ok: flops/dev={res['flops_per_device']:.3e} "
                              f"coll={res['collectives']['total_bytes']:.3e}B "
                              f"step={res['step_s']}s", flush=True)
                    elif res["status"] == "skipped":
                        print(f"  skipped: {res['reason']}")
    finally:
        sh.set_opts(**prev)
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all requested dry-run cells passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
