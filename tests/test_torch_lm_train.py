"""The port's LM training (``lm.lm_loss``, ``train.loop``, ``train.optim``'s
mixed precision, ``train.checkpoint``, ``dist.compress``, ``dist.fault``,
``data.tokens.Prefetcher``, ``launch.train``) against the reference
package, on the reference's init carried across with
``weights.lm_params_from_jax``; a gradient tree crosses the same way,
which gives a per-leaf comparison (``lm.named_leaves``). The reference
is compiled to round where its program rounds (``STRICT``), as in
tests/test_torch_lm.py. Also the twins of tests/test_train.py and of
tests/test_shardings.py's prefetcher test.

Tolerances. At float32 compute the loss is held within 1e-6 and every
gradient leaf within F32_TOL = 1e-5 x max(1, max |ref|) of the leaf
(measured: 9.5e-7 at most, on ``embed``). At the configs' bfloat16 the
backward's products and scatter-adds round in bf16 in another order of
summation (each side sums a product in float32 and rounds once, but the
order of the sum differs, and the embedding's gradient is a scatter-add
of bf16 rows, accumulated in bf16): BF16_GRAD_TOL allows four bf16 steps,
4 x 2^-7 x max(1, max |ref|). Measured on these batches: 0.0188 on
hymba's ``embed`` (2.4 steps at its max of 2.08), 0.0135 on glm4's,
every other leaf at most 0.0020.
"""
import dataclasses
import json
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as REF_SMOKES
from repro.data import tokens as ref_tokens
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train import optim as ref_optim
from repro.train.schedules import warmup_cosine as ref_warmup_cosine
from repro_torch.configs import SMOKES, get_arch
from repro_torch.data.tokens import Prefetcher, lm_batch
from repro_torch.dist import compress as C
from repro_torch.dist.fault import Heartbeat, StepWatchdog, retry_step
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW, global_norm
from repro_torch.train.schedules import warmup_cosine
from repro_torch.weights import lm_params_from_jax

STRICT = {"xla_allow_excess_precision": False}
F32_TOL = 1e-5
LOSS_TOL = 1e-6
BF16_GRAD_TOL = 4 * 2.0 ** -7
FAMILIES = ("glm4-9b", "mixtral-8x22b", "falcon-mamba-7b", "hymba-1.5b",
            "seamless-m4t-large-v2")
B, S = 2, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def leaf_err(got, ref) -> float:
    """max |got - ref| / max(1, max |ref|) over one leaf."""
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(1.0, np.abs(ref).max()))


def port_tree(cfg, tree) -> lm.Params:
    """A reference pytree (parameters or gradients) as the port's
    Params, float32, layers unstacked."""
    return lm_params_from_jax(cfg, jax.tree.map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)), tree))


def batches(cfg, batch, seq, step=0, seed=0):
    """The same batch for both packages: (jnp dict, torch dict); the
    encoder-decoder family gets seeded bf16 frame embeddings (seq // 8
    frames, normal x 0.1)."""
    toks, labels = ref_tokens.lm_batch(cfg, batch, seq, seed, step)
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.is_encdec:
        e = jnp.asarray(np.random.default_rng(1).normal(
            size=(batch, seq // 8, cfg.d_model)) * 0.1, jnp.bfloat16)
        rb["enc_embeds"] = e
        pb["enc_embeds"] = torch.from_numpy(
            np.array(e.astype(jnp.float32))).bfloat16()
    return rb, pb


def ref_loss_fn(rcfg):
    """The reference train step's loss (``loop.make_train_step``'s
    ``loss_fn``): forward over tokens, then ``lm_loss``."""
    def loss_fn(p, b):
        kw = {"enc_embeds": b["enc_embeds"]} if "enc_embeds" in b else {}
        hidden = rlm.forward(rcfg, p, tokens=b["tokens"], **kw)[0]
        return rlm.lm_loss(rcfg, p, hidden, b["labels"])
    return loss_fn


_GRADS = {}


def grads(name, dtype):
    """Both packages' loss and gradients on the same init and batch:
    (reference loss, reference gradients as port Params, port loss, port
    gradients, port params)."""
    key = (name, dtype)
    if key not in _GRADS:
        rcfg = dataclasses.replace(REF_SMOKES[name], compute_dtype=dtype)
        cfg = dataclasses.replace(SMOKES[name], compute_dtype=dtype)
        rp = rlm.init_params(rcfg, jax.random.PRNGKey(0))
        rb, pb = batches(rcfg, B, S)
        rl, rg = jax.jit(jax.value_and_grad(ref_loss_fn(rcfg)),
                         compiler_options=STRICT)(rp, rb)
        p = port_tree(cfg, rp)
        pl, pg = loop.loss_and_grads(cfg, p, pb)
        _GRADS[key] = (float(rl), port_tree(cfg, rg), float(pl), pg, p,
                       rp, rg)
    return _GRADS[key]


# ---------------------------------------------------------------------------
# the loss and the gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tie", [False, True])
def test_lm_loss_matches_reference(tie):
    """float32 within 1e-6 over two loss chunks (S 1,024) and a padded
    vocabulary (500 of 512 columns), on the same hidden states."""
    kw = dict(vocab_size=500, compute_dtype="float32", tie_embeddings=tie)
    rcfg = dataclasses.replace(REF_SMOKES["glm4-9b"], **kw)
    cfg = dataclasses.replace(SMOKES["glm4-9b"], **kw)
    assert cfg.padded_vocab == 512 and 1024 // lm.LOSS_CHUNK == 2
    rp = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(2, 1024, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 1024)).astype(np.int32)
    want = jax.jit(partial(rlm.lm_loss, rcfg))(rp, jnp.asarray(hidden),
                                                jnp.asarray(labels))
    got = lm.lm_loss(cfg, port_tree(cfg, rp), torch.from_numpy(hidden),
                     torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= LOSS_TOL * max(1, abs(float(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_reference(name, dtype):
    """Every gradient leaf of the port's loss against the reference's
    ``value_and_grad`` of its train step's loss: float32 within F32_TOL
    and the loss within 1e-6, bf16 within BF16_GRAD_TOL (module
    docstring); the same leaves in the same order."""
    rl, rg, pl, pg, p, _, _ = grads(name, dtype)
    names = lm.leaf_names(p)
    assert names == lm.leaf_names(rg) and len(pg) == len(names)
    tol = F32_TOL if dtype == "float32" else BF16_GRAD_TOL
    if dtype == "float32":
        assert abs(pl - rl) <= LOSS_TOL * max(1.0, abs(rl))
    for n, g, (_, want) in zip(names, pg, lm.named_leaves(rg)):
        assert leaf_err(g, want) <= tol, n


@pytest.mark.parametrize("mixed", [False, True])
def test_adamw_on_reference_gradients_matches_reference(mixed):
    """The reference's glm4 gradients (float32) fed to both packages'
    AdamW for two steps (warmup-cosine, decay, clip): the parameters,
    moments and, in mixed precision, the float32 master within float32
    rounding (1e-6 x max(1, |ref|)); the live bf16 parameters within one
    bf16 step of the reference's (their masters may round to either
    side)."""
    _, rg, _, _, p, rp, rgrads = grads("glm4-9b", "float32")
    kw = dict(weight_decay=0.01, grad_clip=1.0, mixed_precision=mixed)
    ropt = ref_optim.AdamW(lr=ref_warmup_cosine(1e-2, 1, 10), **kw)
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 10), **kw)
    cfg = dataclasses.replace(SMOKES["glm4-9b"], compute_dtype="float32")
    params = port_tree(cfg, rp)
    leaves = lm.leaves(params)
    rstate, state = ropt.init(rp), opt.init(leaves)
    rparams = rp
    if mixed:     # the live parameters' cast, as the reference's
        cast = opt.cast_params([t.detach().clone() for t in leaves])
        for n, a, (_, b) in zip(lm.leaf_names(params), cast, lm.named_leaves(
                port_tree(cfg, ropt.cast_params(rp)))):
            assert a.dtype == torch.bfloat16 and leaf_err(a, b) == 0, n
    for _ in range(2):
        rparams, rstate = ropt.update(rgrads, rstate, rparams)
        state = opt.update(lm.leaves(rg), state, leaves,
                           lm.reference_ndims(params))
    assert state.step == int(rstate.step) == 2
    for got, want in ((lm.leaves(port_tree(cfg, rparams)), leaves),):
        for n, a, b in zip(lm.leaf_names(params), want, got):
            assert a.dtype == (torch.bfloat16 if mixed else torch.float32)
            tol = 2.0 ** -7 if mixed else 1e-6
            assert leaf_err(a, b) <= tol, n
    trees = [(rstate.mu, state.mu), (rstate.nu, state.nu)]
    if mixed:
        trees.append((rstate.master, state.master))
    for rtree, plist in trees:
        for n, a, (_, b) in zip(lm.leaf_names(params), plist,
                                lm.named_leaves(port_tree(cfg, rtree))):
            assert leaf_err(a, b) <= 1e-6, n


def test_mixed_precision_train_steps_match_reference():
    """Three train steps of both packages with ``AdamW(mixed_precision=
    True)`` (glm4 smoke, float32 compute): the live parameters become
    bf16 after the first update and the float32 master carries the rule.
    Losses and gradient norms within 1e-6 relative (measured 1.5e-7),
    the masters within F32_TOL (measured 4.0e-6), the live bf16
    parameters within one bf16 step of their scale (measured 1.5e-5)."""
    rcfg = dataclasses.replace(REF_SMOKES["glm4-9b"], compute_dtype="float32")
    cfg = dataclasses.replace(SMOKES["glm4-9b"], compute_dtype="float32")
    kw = dict(lr=1e-3, weight_decay=0.01, mixed_precision=True)
    ropt, opt = ref_optim.AdamW(**kw), AdamW(**kw)
    rstate = ref_loop.init_state(rcfg, ropt, jax.random.PRNGKey(0))
    state = init_state(cfg, opt, params=port_tree(cfg, rstate.params))
    rstep = jax.jit(ref_loop.make_train_step(rcfg, ropt),
                    compiler_options=STRICT)
    step = make_train_step(cfg, opt)
    for t in range(3):
        rb, pb = batches(rcfg, 2, 32, step=t)
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, pb)
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(rm[key])) <= 1e-6 * float(
                rm[key]), (t, key)
    names = lm.leaf_names(state.params)
    for n, a, (_, b) in zip(names, lm.leaves(state.params),
                            lm.named_leaves(port_tree(cfg, rstate.params))):
        assert a.dtype == torch.bfloat16 and leaf_err(a, b) <= 2.0 ** -8, n
    for n, a, (_, b) in zip(names, state.opt.master, lm.named_leaves(
            port_tree(cfg, rstate.opt.master))):
        assert a.dtype == torch.float32 and leaf_err(a, b) <= F32_TOL, n


def test_grad_accum_matches_reference():
    """``grad_accum=4`` in both packages' train steps on a batch of 8:
    the loss within 1e-6 and the clipped gradient the optimizer took
    (mu / (1 - b1) after one step) within F32_TOL; the port's
    accumulated gradients against its own full-batch ones within
    F32_TOL."""
    name = "glm4-9b"
    rcfg = dataclasses.replace(REF_SMOKES[name], compute_dtype="float32")
    cfg = dataclasses.replace(SMOKES[name], compute_dtype="float32")
    ropt, opt = ref_optim.AdamW(lr=1e-3), AdamW(lr=1e-3)
    rstate = ref_loop.init_state(rcfg, ropt, jax.random.PRNGKey(0))
    state = init_state(cfg, opt, params=port_tree(cfg, rstate.params))
    rb, pb = batches(rcfg, 8, 32)
    rstate, rm = jax.jit(ref_loop.make_train_step(rcfg, ropt, grad_accum=4),
                         compiler_options=STRICT)(rstate, rb)
    _, full = loop.loss_and_grads(cfg, state.params, pb)
    state, m = make_train_step(cfg, opt, grad_accum=4)(state, pb)
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL * float(
        rm["loss"])
    names = lm.leaf_names(state.params)
    for n, a, (_, b) in zip(names, state.opt.mu,
                            lm.named_leaves(port_tree(cfg, rstate.opt.mu))):
        assert leaf_err(a / 0.1, b / 0.1) <= F32_TOL, n
    _, acc = loop.loss_and_grads(cfg, port_tree(cfg, ref_loop.init_state(
        rcfg, ropt, jax.random.PRNGKey(0)).params), pb, grad_accum=4)
    for n, a, b in zip(names, acc, full):
        assert leaf_err(a, b) <= F32_TOL, n


def test_fcp_masks_drift_as_in_the_reference():
    """The reference differentiates and steps its FCP masks (float32
    leaves of the parameter tree; ROADMAP "Reference caveats"), and the
    port's train step follows it: glm4 smoke, fcp_fanin 4, AdamW(lr
    1e-3, weight decay 0.01), batches (2, 32) of ``lm_batch``. At the
    config's bf16, one step moves all 20,480 elements of mask_w1 in both
    packages, by at most 1.01e-3, element [0, 0, 0] to 0.99899024; at
    float32, after two steps, the port's masks are the reference's
    within F32_TOL."""
    for dtype, steps in (("bfloat16", 1), ("float32", 2)):
        rcfg = dataclasses.replace(REF_SMOKES["glm4-9b"], fcp_fanin=4,
                                   compute_dtype=dtype)
        cfg = dataclasses.replace(SMOKES["glm4-9b"], fcp_fanin=4,
                                  compute_dtype=dtype)
        ropt = ref_optim.AdamW(lr=1e-3, weight_decay=0.01)
        opt = AdamW(lr=1e-3, weight_decay=0.01)
        rstate = ref_loop.init_state(rcfg, ropt, jax.random.PRNGKey(0))
        state = init_state(cfg, opt, params=port_tree(cfg, rstate.params))
        assert "layers::0::mlp::mask_w1" in lm.leaf_names(state.params)
        rstep = jax.jit(ref_loop.make_train_step(rcfg, ropt),
                        compiler_options=STRICT)
        step = make_train_step(cfg, opt)
        for t in range(steps):
            rb, pb = batches(rcfg, 2, 32, step=t)
            rstate, _ = rstep(rstate, rb)
            state, _ = step(state, pb)
        for w in ("mask_w1", "mask_w2"):
            rmask = np.asarray(rstate.params["layers"]["mlp"][w])
            pmask = np.stack([_f32(lp.mlp[w]) for lp in state.params.layers])
            if dtype == "bfloat16":
                for m in (rmask, pmask):
                    assert (m != 1.0).all()
                    assert abs(np.abs(m - 1).max() - 1.01e-3) < 1e-5
                    if w == "mask_w1":
                        assert m[0, 0, 0] == np.float32(0.99899024)
            else:
                assert np.abs(rmask - pmask).max() <= F32_TOL
        assert isinstance(state.params.layers[0].mlp._buffers["mask_w1"],
                          torch.Tensor)


def test_attention_gradients_on_the_cpu_match_reference():
    """CPU gradients through ``layers.attention`` (the plain path: the
    ``full_attention`` twin, differentiated by autograd, no autograd
    Function) and through ``chunked_attention`` against the reference's
    ``jax.grad`` of its own, float32 within F32_TOL."""
    rng = np.random.default_rng(4)
    q, k, v, w = (rng.normal(size=s).astype(np.float32) for s in (
        (2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16), (2, 40, 4, 16)))
    for kind, window in (("full", 0), ("full", 8), ("chunked", 8)):
        if kind == "full":
            def rf(q, k, v):
                return jnp.sum(RL.full_attention(q, k, v, causal=True,
                                                 window=window) * w)

            def pf(q, k, v):
                return L.attention(q, k, v, causal=True, window=window)
        else:
            def rf(q, k, v):
                return jnp.sum(RL.chunked_attention(
                    q, k, v, causal=True, window=window, chunk=16) * w)

            def pf(q, k, v):
                return L.chunked_attention(q, k, v, causal=True,
                                           window=window, chunk=16)
        want = jax.grad(rf, argnums=(0, 1, 2))(q, k, v)
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        got = torch.autograd.grad((pf(*ts) * torch.from_numpy(w)).sum(), ts)
        for a, b in zip(got, want):
            assert leaf_err(a, b) <= F32_TOL, kind


# ---------------------------------------------------------------------------
# twins of tests/test_train.py
# ---------------------------------------------------------------------------

def test_lm_loss_decreases_smoke():
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)
    state = init_state(cfg, opt, torch.Generator().manual_seed(0))
    losses = []
    for t in range(30):
        toks, labels = lm_batch(cfg, 4, 128, 0, t)
        state, m = step(state, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(labels)})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "d": [torch.ones(2, dtype=torch.bfloat16), 7]}


def _equal_trees(a, b):
    la, lb = list(ckpt._walk(a)), list(ckpt._walk(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 7, t)
    _equal_trees(t, ckpt.restore(path, t))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and set(manifest) == {
        "step", "time", "leaves", "extra"}
    assert manifest["leaves"]["d::0"]["dtype"] == "bfloat16"
    assert sorted(v["file"] for v in manifest["leaves"].values()) == [
        f"leaf_{i:05d}.npy" for i in range(4)]


def test_checkpoint_latest_and_gc(tmp_path):
    t = _tree()
    ac = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ac.save(s, t)
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    steps = sorted(int(d[5:]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]  # gc keeps 2


def test_checkpoint_atomicity(tmp_path):
    """A stale .tmp dir must never be picked up as a checkpoint."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_00000002.tmp")  # simulated crash
    assert ckpt.latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("direction", ["port_reads_reference",
                                       "reference_reads_port"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A tree of nested dicts and lists saved by either package reads
    back in the other, leaf for leaf (float32, int32, a scalar)."""
    rng = np.random.default_rng(0)
    arrays = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "layers": [{"b": rng.normal(size=5).astype(np.float32)},
                         {"b": rng.normal(size=5).astype(np.float32)}],
              "ids": np.arange(4, dtype=np.int32)}
    jtree = jax.tree.map(jnp.asarray, arrays)
    ttree = jax.tree.map(torch.from_numpy, arrays)
    if direction == "port_reads_reference":
        path = ref_ckpt.save(str(tmp_path), 3, jtree)
        got = ckpt.restore(path, ttree)
        for (k, a), (_, b) in zip(ckpt._walk(got), ckpt._walk(ttree)):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    else:
        path = ckpt.save(str(tmp_path), 3, ttree)
        got = ref_ckpt.restore(path, jtree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ckpt.latest_step(str(tmp_path)) == ref_ckpt.latest_step(
        str(tmp_path)) == 3


def _phi4_batches(cfg, batch=2, seq=64):
    t = 0
    while True:
        toks, labels = lm_batch(cfg, batch, seq, 0, t)
        t += 1
        yield {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}


def test_trainer_resume(tmp_path):
    """A new Trainer resumes at the last checkpoint's step with the
    saved parameters and optimizer state bit for bit."""
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)
    st = init_state(cfg, opt, torch.Generator().manual_seed(0))
    tr1 = Trainer(step, st, ckpt_dir=str(tmp_path), ckpt_every=5)
    tr1.run(_phi4_batches(cfg), 10, log_every=100, log_fn=lambda *_: None)
    # new trainer resumes at step 10
    st2 = init_state(cfg, opt, torch.Generator().manual_seed(1))
    tr2 = Trainer(step, st2, ckpt_dir=str(tmp_path), ckpt_every=5)
    assert tr2.step == 10 and tr2.state.opt.step == 10
    for a, b in zip(lm.leaves(tr1.state.params), lm.leaves(tr2.state.params)):
        assert torch.equal(a, b)
    for a, b in zip(tr1.state.opt.nu, tr2.state.opt.nu):
        assert torch.equal(a, b)
    assert tr2.state.params is st2.params      # restored in place


def test_emergency_checkpoint(tmp_path):
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3)
    st = init_state(cfg, opt, torch.Generator().manual_seed(0))
    tr = Trainer(make_train_step(cfg, opt), st, ckpt_dir=str(tmp_path),
                 ckpt_every=1000)

    def bad_batches():
        yield {"tokens": torch.zeros((2, 64), dtype=torch.int32),
               "labels": torch.zeros((2, 64), dtype=torch.int32)}
        raise RuntimeError("node failure")

    with pytest.raises(RuntimeError):
        tr.run(bad_batches(), 5, log_fn=lambda *_: None)
    latest = ckpt.latest_step(str(tmp_path))
    assert latest == 1  # emergency saved
    with open(tmp_path / f"step_{latest:08d}" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"emergency": True}


def test_failed_step_retries_from_unchanged_state(monkeypatch):
    """A failure injected into the first backward leaves the parameters
    and optimizer state untouched; ``retry_step`` runs the step again and
    it ends where an unfailing step ends, bit for bit."""
    cfg = get_arch("glm4-9b", smoke=True)
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    batch = next(_phi4_batches(cfg))

    def fresh():
        return init_state(cfg, opt, torch.Generator().manual_seed(0))

    clean, _ = make_train_step(cfg, opt)(fresh(), batch)
    state = fresh()
    before = [t.detach().clone() for t in lm.leaves(state.params)]
    real = loop._grads
    calls = {"n": 0}

    def flaky(loss, leaves):
        calls["n"] += 1
        if calls["n"] == 1:
            assert all(torch.equal(a, b) for a, b in
                       zip(before, lm.leaves(state.params)))
            raise RuntimeError("transient")
        return real(loss, leaves)

    monkeypatch.setattr(loop, "_grads", flaky)
    step = retry_step(make_train_step(cfg, opt), max_retries=2, backoff_s=0)
    state, m = step(state, batch)
    assert calls["n"] == 2 and state.opt.step == 1
    for a, b in zip(lm.leaves(state.params), lm.leaves(clean.params)):
        assert torch.equal(a, b)


def test_watchdog_flags_straggler():
    wd = StepWatchdog(min_steps=10, k_sigma=3.0)
    flagged = [wd.record(1.0 + 0.01 * (i % 3)) for i in range(20)]
    assert not any(flagged)
    assert wd.record(10.0)  # 10x step time -> straggler


def test_retry_step_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry_step(flaky, max_retries=3, backoff_s=0.0)() == "ok"
    assert calls["n"] == 3


def test_heartbeat_stale(tmp_path):
    hb1 = Heartbeat(str(tmp_path), 0)
    hb2 = Heartbeat(str(tmp_path), 1)
    hb1.beat(5)
    hb2.beat(5)
    assert hb1.stale_hosts(timeout_s=60) == []
    # host 1 stops beating
    with open(tmp_path / "host_1.json") as f:
        info = json.load(f)
    info["time"] -= 120
    with open(tmp_path / "host_1.json", "w") as f:
        json.dump(info, f)
    assert hb1.stale_hosts(timeout_s=60) == [1]


def test_topk_error_feedback_conserves_mass():
    """sparse + residual == accumulated gradient (EF identity)."""
    g = [torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 32)).astype(np.float32))]
    ef = C.init_ef(g)
    sparse, ef2 = C.topk_compress(g, ef, frac=0.1)
    np.testing.assert_allclose((sparse[0] + ef2.residual[0]).numpy(),
                               g[0].numpy(), rtol=1e-6)
    assert float((sparse[0] != 0).float().mean()) <= 0.12


def test_sign_compress_two_values():
    g = [torch.from_numpy(np.random.default_rng(0).normal(
        size=64).astype(np.float32))]
    ef = C.init_ef(g)
    q, ef2 = C.sign_compress(g, ef)
    vals = np.unique(np.round(np.abs(q[0].numpy()), 6))
    assert len(vals) <= 2  # {scale} (and possibly 0)
    np.testing.assert_allclose((q[0] + ef2.residual[0]).numpy(),
                               g[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme", ["topk", "sign"])
def test_compressors_match_reference(scheme):
    """Both compressors and their residuals against the reference's over
    three rounds of error feedback, float32 within 1e-6."""
    rng = np.random.default_rng(2)
    gs = [[rng.normal(size=s).astype(np.float32) for s in ((16, 8), (40,))]
          for _ in range(3)]
    ref_c = __import__("repro.dist.compress", fromlist=["x"])
    ref_ef = ref_c.init_ef([jnp.asarray(a) for a in gs[0]])
    ef = C.init_ef([torch.from_numpy(a) for a in gs[0]])
    for g in gs:
        if scheme == "topk":
            rq, ref_ef = ref_c.topk_compress([jnp.asarray(a) for a in g],
                                             ref_ef, 0.2)
            q, ef = C.topk_compress([torch.from_numpy(a) for a in g], ef, 0.2)
        else:
            rq, ref_ef = ref_c.sign_compress([jnp.asarray(a) for a in g],
                                             ref_ef)
            q, ef = C.sign_compress([torch.from_numpy(a) for a in g], ef)
        for a, b in zip(q + ef.residual, list(rq) + list(ref_ef.residual)):
            assert leaf_err(a, b) <= 1e-6


def test_compressed_training_still_converges():
    target = torch.tensor([1.0, -2.0, 3.0])
    w = torch.zeros(3)
    opt = AdamW(lr=0.05)
    st = opt.init([w])
    ef = C.init_ef([w])
    for _ in range(400):
        g = [2 * (w - target)]
        g, ef = C.topk_compress(g, ef, frac=0.4)
        st = opt.update(g, st, [w])
    np.testing.assert_allclose(w.numpy(), target.numpy(), atol=5e-2)


def test_grad_accum_matches_full_batch():
    """grad_accum=N must reproduce the full-batch gradients (linearity)."""
    cfg = get_arch("phi4-mini-3.8b", smoke=True)
    opt = AdamW(lr=1e-3)
    toks, labels = lm_batch(cfg, 8, 64, 0, 0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    out = []
    for n in (1, 4):
        st = init_state(cfg, opt, torch.Generator().manual_seed(0))
        out.append(make_train_step(cfg, opt, grad_accum=n)(st, batch))
    (s1, m1), (s4, m4) = out
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-3)
    # parameters after one update must agree closely
    d = [float((a - b).detach().abs().max()) for a, b in
         zip(lm.leaves(s1.params), lm.leaves(s4.params))]
    assert max(d) < 5e-3


def test_prefetcher():
    pf = Prefetcher(lambda step: step * 2, depth=2)
    got = [next(pf) for _ in range(5)]
    pf.close()
    assert got == [0, 2, 4, 6, 8]


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------

def test_launcher_resumes_on_the_cpu(tmp_path, capsys):
    """``--device cpu`` twice on one ``--ckpt-dir``: the second run
    resumes at the first's last step and goes on from there."""
    from repro_torch.launch.train import main
    args = ["--arch", "glm4-9b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "2", "--device", "cpu", "--compress", "topk"]
    first = main(args)
    assert ckpt.latest_step(str(tmp_path)) == 4 and first["step"] == 4
    second = main(args)
    assert second["step"] == 8 and np.isfinite(second["loss"])
    assert ckpt.latest_step(str(tmp_path)) == 8
    assert "step 6:" in capsys.readouterr().out
    shutil.rmtree(tmp_path)


def test_launcher_feeds_the_encoder_decoder_family():
    """seamless smoke through the launcher with ``--grad-accum 2``: zero
    ``enc_embeds`` of seq // 8 frames, as the reference feeds them."""
    from repro_torch.launch.train import batches as launch_batches
    from repro_torch.launch.train import main
    cfg = get_arch("seamless-m4t-large-v2", smoke=True)
    b = next(launch_batches(cfg, 2, 32, 0, torch.device("cpu")))
    assert b["enc_embeds"].shape == (2, 4, cfg.d_model)
    assert not b["enc_embeds"].any()
    last = main(["--arch", "seamless-m4t-large-v2", "--smoke", "--steps", "2", "--batch",
                 "2", "--seq", "32", "--grad-accum", "2", "--log-every",
                 "2", "--device", "cpu"])
    assert last["step"] == 2 and np.isfinite(last["loss"])


def test_qat_example_runs_on_the_cpu():
    from repro_torch.examples import train_lm_qat
    out = train_lm_qat.main(["--device", "cpu", "--steps", "3"])
    assert np.isfinite(out["qat"]["loss"]) and np.isfinite(
        out["float"]["loss"])
    assert train_lm_qat.qat_config().quant_bits == 4
