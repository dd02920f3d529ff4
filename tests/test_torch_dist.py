"""The placed paths of the port against its unplaced ones and against
the reference: the five checks of tests/dist_check.py (``moe``,
``fsdp``, ``decode``, ``elastic``, ``pipeline``) in one spawned gloo
world of 4 processes on the CPU, at the reference's configs and shapes
in float32 (``repro_torch.dist.checks``, through
``repro_torch.dist.world``).

Each placed result is held to the port's unplaced result within
PLACED_TOL x max(1, max |unplaced|) (the split sums change the float32
rounding only), and the unplaced result to the reference's unsharded
one, computed here in the parent process with JAX, at the tolerances of
the LM parity tests (F32_TOL, and LOSS_TOL for a loss). Decode's argmax
is equal; the elastic restore is bit for bit. Each check also shows the
placed branch it exists for was taken (``shardings.COUNTS``), and every
rank returns the same whole results. The ranks import no JAX: the
reference runs only here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.models.layers as RL
import repro.models.lm as RLM
from repro.train.loop import TrainState as RTrainState
from repro.train.loop import make_train_step as r_make_train_step
from repro.train.optim import AdamW as RAdamW
from repro_torch.configs import get_arch
from repro_torch.dist import checks, world
from repro_torch.models import lm
from repro_torch.weights import lm_params_from_jax

WORLD = 4
PLACED_TOL = 1e-5
F32_TOL, LOSS_TOL = 1e-5, 1e-6        # tests/test_torch_lm_train.py's
TIMEOUT = 240.0


def f32(cfg, **kw):
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def both(arch, **kw):
    """(reference config, port config), float32."""
    return (f32(RC.get_arch(arch, smoke=True), **kw),
            f32(get_arch(arch, smoke=True), **kw))


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_leaves(cfg, tree):
    """A reference pytree as the port's leaves (``lm.leaves`` order)."""
    return [t.numpy() for t in lm.leaves(lm_params_from_jax(cfg, tree))]


def err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def tokens(key, shape, vocab):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                         vocab), np.int32)


# the meshes of the world of 4; tests/test_torch_dist8.py runs the same
# checks at the reference's (2, 4) in a world of 8
MESHES = {"moe": (2, 2), "fsdp": (2, 2),
          "decode": {"decode_heads": (2, 2), "decode_sequence": (1, 4)},
          "elastic": ((2, 2), (4, 1)), "pipeline": (1, 4)}


def build(tmp_path_factory, meshes):
    """(jobs, reference results): every check on the given meshes, its
    inputs, and the reference's unsharded results."""
    jobs, ref = [], {}

    # moe: mixtral smoke, 4 experts, capacity factor 8, under moe_ep and
    # under the rule table alone
    rcfg, cfg = both("mixtral-8x22b", n_experts=4, capacity_factor=8.0)
    rp = RL.init_moe(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    names = sorted(rp)
    out, vjp = jax.vjp(lambda x_, p_: RL.moe(x_, p_, rcfg), jnp.asarray(x),
                       rp)
    gx, gp = vjp(jnp.asarray(cot))
    ref["moe"] = (np.asarray(out), [np.asarray(gx)]
                  + [np.asarray(gp[k]) for k in names])
    for label, moe_ep in (("moe", True), ("moe_rule_table", False)):
        jobs.append((label, "moe", dict(
            cfg=cfg, p_np=np_tree(rp), x_np=x, cot_np=cot,
            shape=meshes["moe"], device="cpu", moe_ep=moe_ep)))

    # fsdp: phi4-mini smoke, B 8 x S 64, one AdamW step under fsdp_pure
    rcfg, cfg = both("phi4-mini-3.8b")
    rp = RLM.init_params(rcfg, jax.random.PRNGKey(0))
    toks = tokens(1, (8, 64), rcfg.vocab_size)
    opt = RAdamW(lr=1e-3)
    state, m = jax.jit(r_make_train_step(rcfg, opt))(
        RTrainState(rp, opt.init(rp), None),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    ref["fsdp"] = (float(m["loss"]), float(m["grad_norm"]),
                   port_leaves(cfg, np_tree(state.opt.mu)))
    jobs.append(("fsdp", "fsdp", dict(cfg=cfg, params_np=np_tree(rp),
                                      toks_np=toks, shape=meshes["fsdp"],
                                      device="cpu")))
    # mixed precision: the same model and batch, two steps, rule table
    jobs.append(("mixed", "mixed_precision", dict(
        cfg=cfg, params_np=np_tree(rp), toks_np=toks, shape=meshes["fsdp"],
        device="cpu")))

    # decode: glm4 smoke, 4 x 32 prefill + one step, serve_tp_only; the
    # heads branch where the model axis divides KV 2, else the
    # sequence-sharded one
    rcfg, cfg = both("glm4-9b")
    rp = RLM.init_params(rcfg, jax.random.PRNGKey(0))
    toks = tokens(1, (4, 33), rcfg.vocab_size)
    _, cache = RLM.prefill(rcfg, rp, tokens=jnp.asarray(toks[:, :32]),
                           max_seq=40)
    logits, _ = RLM.decode_step(rcfg, rp, cache, jnp.asarray(toks[:, 32:]),
                                jnp.full((4,), 32, jnp.int32))
    ref["decode"] = np.asarray(logits, np.float32)
    for label, shape in meshes["decode"].items():
        jobs.append((label, "decode", dict(
            cfg=cfg, params_np=np_tree(rp), toks_np=toks, shape=shape,
            device="cpu", prompt=32, max_seq=40)))

    # elastic: saved on one mesh, restored on another
    shape_a, shape_b = meshes["elastic"]
    jobs.append(("elastic", "elastic", dict(
        cfg=cfg, params_np=np_tree(rp), shape_a=shape_a, shape_b=shape_b,
        device="cpu", ckpt_dir=str(tmp_path_factory.mktemp("elastic")))))

    # pipeline: glm4 smoke at 4 layers, 4 stages, n_micro 2, and grad
    rcfg, cfg = both("glm4-9b", n_layers=4)
    rp = RLM.init_params(rcfg, jax.random.PRNGKey(0))
    toks = tokens(1, (4, 32), rcfg.vocab_size)
    tj = jnp.asarray(toks)

    def loss(p):
        return RLM.lm_loss(rcfg, p, RLM.forward(rcfg, p, tokens=tj)[0], tj)

    ref["pipeline"] = (np.asarray(RLM.forward(rcfg, rp, tokens=tj)[0]),
                       port_leaves(cfg, np_tree(jax.grad(loss)(rp))))
    jobs.append(("pipeline", "pipeline", dict(
        cfg=cfg, params_np=np_tree(rp), toks_np=toks,
        shape=meshes["pipeline"], device="cpu", n_micro=2)))
    # the same, each rank holding only its stage's layers
    jobs.append(("pipeline_stages", "pipeline_stages", dict(
        cfg=cfg, params_np=np_tree(rp), toks_np=toks,
        shape=meshes["pipeline"], device="cpu", n_micro=2)))
    return jobs, ref


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's results, and the ranks' results of every check
    from one world of 4."""
    jobs, ref = build(tmp_path_factory, MESHES)
    ranks = world.run(checks.run_checks, WORLD, (jobs,), timeout=TIMEOUT)
    return ref, ranks


def result(run, label):
    ref, ranks = run
    got = ranks[0][label]
    assert "error" not in got, got["error"]
    return ref, got


def hold_same_results(ranks):
    for label, got in ranks[0].items():
        assert "error" not in got, got["error"]
        for other in ranks[1:]:
            a, b = got.get("placed"), other[label].get("placed")
            flat_a = a if isinstance(a, (list, tuple)) else [a]
            flat_b = b if isinstance(b, (list, tuple)) else [b]
            for x, y in zip(flat_a, flat_b):
                if isinstance(x, list):
                    assert all(np.array_equal(u, v) for u, v in zip(x, y))
                else:
                    assert np.array_equal(x, y), label


def test_every_rank_returns_the_same_results(run):
    hold_same_results(run[1])


def hold_moe(ref, got, branch="moe_expert_parallel"):
    """The placed block's output and gradients against the unplaced
    block's and the reference's; the placed branch taken once, the
    other never."""
    want_out, want_grads = ref["moe"]
    other = ({"moe_expert_parallel", "moe_rule_table"} - {branch}).pop()
    assert got["counts"].get(branch) == 1, got["counts"]
    assert got["counts"].get(other, 0) == 0, got["counts"]
    assert err(got["placed"], got["unplaced"]) <= PLACED_TOL
    assert err(got["unplaced"], want_out) <= F32_TOL
    for g_p, g_u, g_r in zip(got["grads_placed"], got["grads_unplaced"],
                             want_grads):
        assert err(g_p, g_u) <= PLACED_TOL
        assert err(g_u, g_r) <= F32_TOL


def test_moe_expert_parallel(run):
    """moe_ep on (2, 2): the output and the gradients of x and of every
    weight against the unplaced block and the reference's vmap path."""
    hold_moe(*result(run, "moe"))


def test_moe_rule_table(run):
    """moe_ep off on (2, 2): the MoE block on leaves placed by the rule
    table alone (routing, dispatch and combine on each rank's rows, the
    expert products on DTensors), held to the unplaced block and the
    reference's VJP as the expert-parallel branch is."""
    hold_moe(*result(run, "moe_rule_table"), branch="moe_rule_table")


def hold_fsdp(ref, got):
    r_loss, r_gnorm, r_leaves = ref["fsdp"]
    (u_loss, u_gnorm, u_leaves), (p_loss, p_gnorm, p_leaves) = \
        got["unplaced"], got["placed"]
    assert got["counts"].get("attention", 0) > 0, got["counts"]
    assert abs(u_loss - r_loss) <= LOSS_TOL * max(1.0, abs(r_loss))
    assert abs(u_gnorm - r_gnorm) <= F32_TOL * max(1.0, abs(r_gnorm))
    assert abs(p_loss - u_loss) <= PLACED_TOL * max(1.0, abs(u_loss))
    assert abs(p_gnorm - u_gnorm) <= PLACED_TOL * max(1.0, abs(u_gnorm))
    for a, b, c in zip(p_leaves, u_leaves, r_leaves):
        assert err(a, b) <= PLACED_TOL
        assert err(b, c) <= F32_TOL


def test_fsdp_pure_train_step(run):
    """One AdamW step under fsdp_pure on (2, 2): loss, gradient norm
    and every leaf's first moment after it."""
    hold_fsdp(*result(run, "fsdp"))


def hold_mixed_precision(got):
    (u_loss, u_mu, _, _), (p_loss, p_mu, p_master, p_live) = \
        got["unplaced"], got["placed"]
    assert got["local_dtypes"] == ["torch.bfloat16"]
    for a, b in zip(p_loss, u_loss):
        assert abs(a - b) <= PLACED_TOL * max(1.0, abs(b))
    for a, b in zip(p_mu, u_mu):
        assert err(a, b) <= PLACED_TOL
    for master, live in zip(p_master, p_live):
        # the live leaf is its master rounded to bf16
        assert np.array_equal(live, np.asarray(
            torch.from_numpy(master).bfloat16().float()))


def test_mixed_precision_placed_steps(run):
    """Two AdamW steps with mixed_precision, parameters placed by the
    rule table on (2, 2): every live leaf's local shard is bf16 (the
    cast swaps the placed tensor; ``.data =`` left the shard float32),
    the losses and the first step's moments match the unplaced steps
    within PLACED_TOL, and each live leaf is its master rounded to
    bf16."""
    hold_mixed_precision(result(run, "mixed")[1])


def hold_decode(ref, got, branch, specs):
    assert got["cache_specs"]["k"] == specs
    assert got["counts"].get(branch, 0) > 0, got["counts"]
    assert err(got["placed"], got["unplaced"]) <= PLACED_TOL
    assert err(got["unplaced"], ref["decode"]) <= F32_TOL
    assert (got["placed"].argmax(-1) == ref["decode"].argmax(-1)).all()
    for key, want in got["cache_unplaced"].items():
        assert err(got["cache_placed"][key], want) <= PLACED_TOL, key
    # the prefill itself placed: last-token logits and its cache
    for a, b in zip(got["prefill_placed"], got["prefill_unplaced"]):
        assert err(a, b) <= PLACED_TOL


@pytest.mark.parametrize("label,branch,specs", [
    ("decode_heads", "decode_heads", (None, "data", None, "model", None)),
    ("decode_sequence", "decode_sequence",
     (None, None, "model", None, None))])
def test_decode_serve_tp_only(run, label, branch, specs):
    """A decode step under serve_tp_only with its cache placed by
    cache_pspec: the logits, the argmax and the updated cache; the
    placed prefill's logits and cache."""
    hold_decode(*result(run, label), branch, specs)


def hold_elastic(got, restored_on):
    assert len(got["placed"]) == len(got["unplaced"])
    for a, b in zip(got["placed"], got["unplaced"]):
        assert np.array_equal(a, b)
    assert got["meshes"] == [restored_on] and got["specs_match"]


def test_elastic_restore_onto_another_mesh(run):
    """Placed on (2, 2), saved, restored onto (4, 1) with shardings=:
    bit for bit, every leaf on the new mesh under its rule."""
    hold_elastic(result(run, "elastic")[1], (4, 1))


def hold_pipeline(ref, got):
    want_h, want_g = ref["pipeline"]
    assert got["counts"].get("pipeline") == 1, got["counts"]
    assert err(got["placed"], got["unplaced"]) <= PLACED_TOL
    assert err(got["unplaced"], want_h) <= F32_TOL
    assert len(got["grads_placed"]) == len(want_g)
    for g_p, g_u, g_r in zip(got["grads_placed"], got["grads_unplaced"],
                             want_g):
        assert err(g_p, g_u) <= PLACED_TOL
        assert err(g_u, g_r) <= F32_TOL


def test_pipeline_forward_and_gradient(run):
    """GPipe over 4 stages with 2 microbatches: the hidden states and
    the gradient of lm_loss for every leaf."""
    hold_pipeline(*result(run, "pipeline"))


def hold_pipeline_stages(ref, ranks, layers_held):
    want_h, _ = ref["pipeline"]
    held = []
    for got in (r["pipeline_stages"] for r in ranks):
        assert "error" not in got, got["error"]
        assert got["counts"].get("pipeline") == 1, got["counts"]
        assert err(got["placed"], got["unplaced"]) <= PLACED_TOL
        assert err(got["unplaced"], want_h) <= F32_TOL
        assert set(got["grads_placed"]) == set(got["grads_unplaced"])
        for name, g in got["grads_placed"].items():
            assert err(g, got["grads_unplaced"][name]) <= PLACED_TOL, name
        held.append(got["layers_held"])
    assert held == layers_held


def test_pipeline_placed_by_stage(run):
    """GPipe over 4 stages with parameters placed by stage
    (``stage_params``): each rank holds one layer of the four, the
    hidden states match unplaced ``lm.forward``, and the gradient of
    lm_loss for each leaf a rank holds (its layer, the embedding, the
    final norm and the head) matches the unplaced one, within
    PLACED_TOL."""
    hold_pipeline_stages(*run, [[0], [1], [2], [3]])
