"""The placed paths against the unplaced ones, on every rank of a
process group: the port's twin of the reference's
``tests/dist_check.py`` (``moe``, ``fsdp``, ``decode``, ``elastic``,
``pipeline``), plus the launcher and ``mesh_placed``.

Each check takes numpy inputs (the reference's parameters as the
weights bridge carries them, tokens), runs the unplaced path and the
placed one on a (data, model) mesh of the given shape over the
current process group, and returns numpy results by name, whole on
every rank: ``unplaced`` and ``placed`` (and their gradients where the
check has them), with ``counts``, the placed branches taken
(``shardings.COUNTS``). The caller holds them to each other and to the
reference (``tests/test_torch_dist.py`` on the CPU through
``world.run``; ``chip_smoke.py`` on the card). ``run_checks`` runs a
list of them in one world and returns each one's result or its
traceback. Everything here is float32 unless the config says
otherwise.
"""
from __future__ import annotations

import contextlib
import traceback
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import shardings as sh


def make_mesh(shape: Tuple[int, int], device: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def opts(**flags):
    prev = sh.set_opts(**flags)
    try:
        yield
    finally:
        sh.set_opts(**prev)


def host(t) -> np.ndarray:
    """A tensor (placed or not) as a whole host array, a copy (a CPU
    tensor's ``numpy()`` would follow later in-place updates)."""
    return np.array(sh.full(t).detach().float().cpu())


def stacked_numpy(params) -> Dict[str, Any]:
    """A port ``Params`` as the reference's parameter tree of numpy
    arrays (layers stacked on a leading axis): what
    ``weights.lm_params_from_jax`` takes, for a run without JAX."""
    from repro_torch.models.lm import Params

    def stack(subs):
        return {k: stack([s[k] for s in subs]) if isinstance(subs[0][k], dict)
                else np.stack([s[k] for s in subs]) for k in subs[0]}

    def tree(mod):
        out = {}
        for k in mod.keys():
            v = mod[k]
            if isinstance(v, torch.nn.ModuleList):
                out[k] = stack([tree(sub) for sub in v])
            elif isinstance(v, Params):
                out[k] = tree(v)
            else:
                out[k] = host(v)
        return out
    return tree(params)


def _params(cfg, params_np, device):
    from repro_torch.weights import lm_params_from_jax
    return lm_params_from_jax(cfg, params_np).to(device)


def _grads(loss, leaves) -> List[np.ndarray]:
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(tuple(t.shape), np.float32) if g is None else host(g)
            for t, g in zip(leaves, grads)]


def _counts(before) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in sh.COUNTS.items()
            if v - before.get(k, 0)}


def moe(cfg, p_np: Dict[str, np.ndarray], x_np: np.ndarray,
        cot_np: np.ndarray, shape, device: str) -> Dict[str, Any]:
    """The MoE block under ``moe_ep`` (expert parallelism with explicit
    collectives) against the unplaced block: output and the gradients of
    sum(out * cot) with respect to x and every weight."""
    from repro_torch.models import layers as L
    names = sorted(p_np)
    p = {k: torch.from_numpy(p_np[k]).to(device).requires_grad_(True)
         for k in names}
    x = torch.from_numpy(x_np).to(device).requires_grad_(True)
    cot = torch.from_numpy(cot_np).to(device)
    with torch.enable_grad():
        ref = L.moe(x, p, cfg)
        g_ref = _grads((ref * cot).sum(), [x] + [p[k] for k in names])
    mesh = make_mesh(shape, device)
    shard = sh.params_shardings(mesh, {f"moe::{k}": v
                                       for k, v in p_np.items()})
    pp = {k: sh.place(p[k].detach(), shard[f"moe::{k}"]).requires_grad_(True)
          for k in names}
    xp = sh.from_host(x_np, sh.batch_shardings(mesh, {"x": x_np})["x"]
                      ).requires_grad_(True)
    before = dict(sh.COUNTS)
    with opts(moe_ep=True), sh.use_mesh(mesh), torch.enable_grad():
        got = L.moe(xp, pp, cfg)
        g_got = _grads((got * cot).sum(), [xp] + [pp[k] for k in names])
    return {"unplaced": host(ref), "placed": host(got),
            "grads_unplaced": g_ref, "grads_placed": g_got,
            "counts": _counts(before)}


def fsdp(cfg, params_np, toks_np: np.ndarray, shape, device: str
         ) -> Dict[str, Any]:
    """One AdamW train step under ``fsdp_pure`` (the batch over every
    mesh axis, parameters placed by the rule table) against the
    unplaced step: loss, gradient norm and every leaf's first moment
    after the step, (1 - b1) x its clipped gradient (the updated leaf
    itself is lr x sign(g) where |g| is near eps, too sensitive to
    compare)."""
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optim import AdamW
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)
    batch_np = {"tokens": toks_np, "labels": toks_np}

    def run(params, batch):
        state = init_state(cfg, opt, params=params)
        state, m = step(state, batch)
        return (float(host(m["loss"])), float(host(m["grad_norm"])),
                [host(t) for t in state.opt.mu])

    ref = run(_params(cfg, params_np, device),
              {k: torch.from_numpy(v).to(device)
               for k, v in batch_np.items()})
    mesh = make_mesh(shape, device)
    before = dict(sh.COUNTS)
    with opts(fsdp_pure=True), sh.use_mesh(mesh):
        params = sh.place_params(mesh, _params(cfg, params_np, device))
        from repro_torch.data.tokens import sharded_batch
        batch = sharded_batch(batch_np, {
            k: sh.Sharding(mesh, sh._prune_spec(mesh, v.shape,
                                                (sh.batch_axes(), None)))
            for k, v in batch_np.items()})
        got = run(params, batch)
    return {"unplaced": ref, "placed": got, "counts": _counts(before)}


def mixed_precision(cfg, params_np, toks_np: np.ndarray, shape,
                    device: str) -> Dict[str, Any]:
    """Two AdamW steps with ``mixed_precision`` (bf16 live
    parameters, the float32 master in the optimizer state), parameters
    placed by the rule table, against the unplaced steps: the losses,
    every leaf's first moment after the first step (as ``fsdp``: the
    updated leaves are too sensitive to compare), and every leaf's
    master and live value after the last; with ``local_dtypes``, the
    types of the placed live leaves' local shards."""
    from repro_torch.models import lm
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.train.optim import AdamW
    opt = AdamW(lr=1e-3, mixed_precision=True)
    step = make_train_step(cfg, opt)
    batch_np = {"tokens": toks_np, "labels": toks_np}

    def run(params, batch):
        state = init_state(cfg, opt, params=params)
        losses = []
        for i in range(2):
            state, m = step(state, batch)
            losses.append(float(host(m["loss"])))
            if i == 0:
                mu = [host(t) for t in state.opt.mu]
        return (losses, mu, [host(t) for t in state.opt.master],
                [host(t) for t in lm.leaves(state.params)])

    ref = run(_params(cfg, params_np, device),
              {k: torch.from_numpy(v).to(device)
               for k, v in batch_np.items()})
    mesh = make_mesh(shape, device)
    with sh.use_mesh(mesh):
        params = sh.place_params(mesh, _params(cfg, params_np, device))
        from repro_torch.data.tokens import sharded_batch
        batch = sharded_batch(batch_np, sh.batch_shardings(mesh, batch_np))
        got = run(params, batch)
    local = {str(t.to_local().dtype) for t in lm.leaves(params)}
    return {"unplaced": ref, "placed": got, "local_dtypes": sorted(local)}


def decode(cfg, params_np, toks_np: np.ndarray, shape, device: str,
           prompt: int, max_seq: int) -> Dict[str, Any]:
    """One decode step under ``serve_tp_only`` (parameters and the
    prefill's cache placed, ``cache_pspec``) against the unplaced step
    on the same cache: logits and the updated cache; and the prefill
    itself placed against unplaced (last-token logits and the cache it
    builds)."""
    from repro_torch.models import lm
    params = _params(cfg, params_np, device)
    toks = torch.from_numpy(toks_np).to(device)
    with torch.no_grad():
        first, cache = lm.prefill(cfg, params, tokens=toks[:, :prompt],
                                  max_seq=max_seq)
        # before the decode steps write into the cache (a placed leaf
        # may share the unplaced one's memory)
        pre = [host(first)] + [host(cache[k]) for k in sorted(cache)]
        pos = torch.full((toks.shape[0],), prompt, dtype=torch.int32,
                         device=device)
        mesh = make_mesh(shape, device)
        shard = sh.cache_pspec(mesh, cache)
        placed_cache = {k: sh.place(v, shard[k]) for k, v in cache.items()}
        ref, ref_cache = lm.decode_step(
            cfg, params, {k: v.clone() for k, v in cache.items()},
            toks[:, prompt:prompt + 1], pos)
        before = dict(sh.COUNTS)
        with opts(serve_tp_only=True), sh.use_mesh(mesh):
            sh.place_params(mesh, params)
            got, got_cache = lm.decode_step(cfg, params, placed_cache,
                                            toks[:, prompt:prompt + 1], pos)
            first_p, cache_p = lm.prefill(cfg, params,
                                          tokens=toks[:, :prompt],
                                          max_seq=max_seq)
    return {"unplaced": host(ref), "placed": host(got),
            "prefill_unplaced": pre,
            "prefill_placed": [host(first_p)] + [host(cache_p[k])
                                                 for k in sorted(cache_p)],
            "cache_unplaced": {k: host(v) for k, v in ref_cache.items()},
            "cache_placed": {k: host(v) for k, v in got_cache.items()},
            "cache_specs": {k: v.spec for k, v in shard.items()},
            "counts": _counts(before)}


def elastic(cfg, params_np, shape_a, shape_b, device: str, ckpt_dir: str
            ) -> Dict[str, Any]:
    """Parameters placed on mesh A, saved, restored onto mesh B with
    ``shardings=``: every leaf bit for bit, placed on B."""
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    params = _params(cfg, params_np, device)
    want = [host(t) for t in lm.leaves(params)]
    mesh_a, mesh_b = make_mesh(shape_a, device), make_mesh(shape_b, device)
    sh.place_params(mesh_a, params)
    ckpt.save(ckpt_dir, 3, params)
    sh_b = sh.params_shardings(mesh_b, params)
    restored = ckpt.restore_latest(ckpt_dir, params, shardings=sh_b)
    names = lm.leaf_names(params)
    flat = dict(ckpt._walk(restored))
    return {"unplaced": want, "placed": [host(flat[n]) for n in names],
            "meshes": sorted({tuple(flat[n].device_mesh.shape)
                              for n in names}),
            "specs_match": all(sh.spec_of(flat[n]) == sh_b[n].spec
                               for n in names)}


def pipeline(cfg, params_np, toks_np: np.ndarray, shape, device: str,
             n_micro: int = 2) -> Dict[str, Any]:
    """``pipeline_lm_forward`` over the mesh's 'model' stages against
    ``lm.forward``: hidden states and the gradient of ``lm_loss`` of
    them for every leaf."""
    from repro_torch.dist.pipeline import pipeline_lm_forward
    from repro_torch.models import lm
    params = _params(cfg, params_np, device)
    toks = torch.from_numpy(toks_np).to(device)
    leaves = lm.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        h_ref = lm.forward(cfg, params, tokens=toks)[0]
        g_ref = _grads(lm.lm_loss(cfg, params, h_ref, toks), leaves)
        mesh = make_mesh(shape, device)
        before = dict(sh.COUNTS)
        with sh.use_mesh(mesh):
            h_pp = pipeline_lm_forward(cfg, params, toks, mesh,
                                       n_micro=n_micro)
            g_pp = _grads(lm.lm_loss(cfg, params, h_pp, toks), leaves)
    return {"unplaced": host(h_ref), "placed": host(h_pp),
            "grads_unplaced": g_ref, "grads_placed": g_pp,
            "counts": _counts(before)}


def pipeline_stages(cfg, params_np, toks_np: np.ndarray, shape,
                    device: str, n_micro: int = 2) -> Dict[str, Any]:
    """``pipeline_lm_forward`` over parameters placed by stage
    (``stage_params``) against ``lm.forward``: hidden states, and the
    gradient of ``lm_loss`` of them for each leaf this rank holds (its
    stage's layers, under their global names, and every leaf outside
    the layers) beside the unplaced gradient of the same leaf; the
    layers this rank holds."""
    from repro_torch.dist.pipeline import pipeline_lm_forward, stage_params
    from repro_torch.models import lm
    params = _params(cfg, params_np, device)
    toks = torch.from_numpy(toks_np).to(device)
    leaves = lm.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        h_ref = lm.forward(cfg, params, tokens=toks)[0]
        g_ref = dict(zip(lm.leaf_names(params), _grads(
            lm.lm_loss(cfg, params, h_ref, toks), leaves)))
        mesh = make_mesh(shape, device)
        staged = stage_params(cfg, params, mesh)
        stage, n = staged.stage
        first = stage * cfg.n_layers // n
        before = dict(sh.COUNTS)
        with sh.use_mesh(mesh):
            h_pp = pipeline_lm_forward(cfg, staged, toks, mesh,
                                       n_micro=n_micro)
            g_pp = _grads(lm.lm_loss(cfg, staged, h_pp, toks),
                          lm.leaves(staged))

    def global_name(name):
        parts = name.split("::")
        if parts[0] == "layers":
            parts[1] = str(first + int(parts[1]))
        return "::".join(parts)

    names = [global_name(n) for n in lm.leaf_names(staged)]
    return {"unplaced": host(h_ref), "placed": host(h_pp),
            "grads_placed": dict(zip(names, g_pp)),
            "grads_unplaced": {k: g_ref[k] for k in names},
            "layers_held": list(range(first, first + len(staged.layers))),
            "counts": _counts(before)}


def launcher(argv: Sequence[str]) -> Dict[str, float]:
    """``repro_torch.launch.train.main(argv)`` on this rank (its mesh
    over the current process group)."""
    from repro_torch.launch.train import main
    return main(list(argv))


def logic_labels(x_np: np.ndarray, backend: str, shape, device: str
                 ) -> Dict[str, Any]:
    """``build_logic_replicas(mesh=)`` on the demo JSC network against
    the unplaced executor: labels bit for bit."""
    from repro_torch.configs.jsc import JSC_DEMO
    from repro_torch.models.mlp import final_masks, init_mlp, to_logic
    from repro_torch.serve import build_logic_replicas
    from repro_torch.serving.engine import LogicEngine
    model = init_mlp(JSC_DEMO, torch.Generator().manual_seed(1))
    model.set_masks(final_masks(JSC_DEMO, model))
    net = to_logic(JSC_DEMO, model)
    want = LogicEngine(net, 5, backend=backend, device=device
                       ).scheduler_executor()(x_np)
    rs = build_logic_replicas(net, 5, n_replicas=1, backend=backend,
                              device=device, mesh=make_mesh(shape, device))
    return {"unplaced": np.asarray(want), "placed": np.asarray(rs(x_np)),
            "n_features": rs.n_features}


def batch_blocks(arrays: Dict[str, np.ndarray], shape, device: str
                 ) -> Dict[str, Any]:
    """``sharded_batch`` of host arrays by ``batch_shardings``: this
    rank's block of each, its index, and each whole again."""
    from repro_torch.data.tokens import sharded_batch
    mesh = make_mesh(shape, device)
    shard = sh.batch_shardings(mesh, arrays)
    placed = sharded_batch(arrays, shard)
    return {k: {"index": sh.local_index(v.shape, shard[k]),
                "local": placed[k].to_local().cpu().numpy(),
                "full": placed[k].full_tensor().cpu().numpy()}
            for k, v in arrays.items()}


def meshes(device: str) -> Dict[str, str]:
    """What each mesh maker says on this world: the production meshes
    and a model axis that does not divide it (the error's text, or
    ``ok``)."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    out = {}
    for label, make in (
            ("production", lambda: make_production_mesh(device=device)),
            ("multi_pod", lambda: make_production_mesh(multi_pod=True,
                                                       device=device)),
            ("model_par_3", lambda: make_host_mesh(3, device=device))):
        try:
            make()
            out[label] = "ok"
        except (RuntimeError, ValueError) as e:
            out[label] = f"{type(e).__name__}: {e}"
    return out


def run_checks(jobs: Sequence[Tuple[str, str, Dict[str, Any]]]
               ) -> Dict[str, Any]:
    """Each (label, check name, kwargs) in order on this rank: its result,
    or ``{"error": traceback}``."""
    out = {}
    for label, name, kw in jobs:
        try:
            out[label] = globals()[name](**kw)
        except Exception:
            out[label] = {"error": traceback.format_exc()}
    return out
