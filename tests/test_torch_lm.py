"""The port's LM stack (configs, layers, Mamba, the LM, the token stream)
against the reference package on the same inputs and, through
``weights.lm_params_from_jax``, the same weights.

Tolerances. At float32 compute every float output is held within
F32_TOL x max(1, |ref|), greedy tokens identical. At the configs' own
bfloat16 the port rounds where the reference's program rounds (after
each elementwise operation, the attention logits before or after their
scale, P before P.V, each product once from a float32 sum), and the
reference is compiled to do the same (``STRICT``). The two then differ
only where a float32 intermediate differs in its last bit (sin, cos,
exp and rsqrt of two libraries, the order of a product's sum) and lands
on the other side of a bfloat16 rounding: one bfloat16 step, 2^-7
relative for |x| in [1, 2), and two at most where such steps meet in
the smoke stacks. BF16_TOL allows four, x max(1, |ref|); greedy tokens
must be identical. Compiled with its defaults, XLA's CPU backend keeps
float32 inside some fusions of bfloat16 code and skips roundings the
program states, so the reference's own compiled and op-by-op runs part
by several steps; the port is held to that run within BF16_XLA_TOL,
eight steps.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SMOKES as REF_SMOKES
from repro.configs import all_cells as ref_all_cells
from repro.configs.base import SHAPES as REF_SHAPES
from repro.data import tokens as ref_tokens
from repro.models import layers as RL
from repro.models import lm as rlm
from repro.models import mamba as RM
from repro_torch.configs import ARCHS, SHAPES, SMOKES, all_cells, get_arch
from repro_torch.configs.base import torch_dtype
from repro_torch.data import tokens
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import mamba as M
from repro_torch.weights import lm_params_from_jax

# the reference compiled to round where its program rounds (XLA's CPU
# backend otherwise keeps float32 inside some fusions of bfloat16 code)
STRICT = {"xla_allow_excess_precision": False}
F32_TOL = 1e-5
BF16_TOL = 4 * 2.0 ** -7
BF16_XLA_TOL = 8 * 2.0 ** -7
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
DTYPES = ("float32", "bfloat16")
FAMILIES = ("glm4-9b", "phi4-mini-3.8b", "nemotron-4-340b",
            "falcon-mamba-7b", "hymba-1.5b")
B, S = 2, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, ref, tol, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max()) <= tol, (what, float(err.max()), tol)



def pair(rng, shape, dtype="float32"):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(rng.normal(size=shape), jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch_dtype(dtype))
    return j, t


_MODELS = {}


def models(name, dtype, **over):
    """(reference cfg, reference params, port cfg, port params) of the
    smoke config at ``dtype`` compute with the fields ``over`` replaced
    (``d_head=192``), the port's carried across."""
    key = (name, dtype, tuple(sorted(over.items())))
    if key not in _MODELS:
        rcfg = dataclasses.replace(REF_SMOKES[name], compute_dtype=dtype,
                                   **over)
        cfg = dataclasses.replace(SMOKES[name], compute_dtype=dtype, **over)
        rp = rlm.init_params(rcfg, jax.random.PRNGKey(0))
        _MODELS[key] = (rcfg, rp, cfg,
                        lm_params_from_jax(cfg, jax.tree.map(np.asarray, rp)))
    return _MODELS[key]


_RUNS = {}


def runs(name, dtype, **over):
    """forward, prefill and one decode_step of both packages on the same
    seeded tokens (B, S + 1): (reference outputs, port outputs)."""
    key = (name, dtype, tuple(sorted(over.items())))
    if key not in _RUNS:
        rcfg, rp, cfg, p = models(name, dtype, **over)
        toks = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        pos = np.full((B,), S, np.int32)
        @partial(jax.jit, compiler_options=STRICT)
        def reference(t, q):
            out = {"hidden": rlm.forward(rcfg, rp, tokens=t)[0]}
            out["prefill"], rc = rlm.prefill(rcfg, rp, tokens=t[:, :S],
                                             max_seq=S + 8)
            out["prefill_cache"] = rc
            out["decode"], out["decode_cache"] = rlm.decode_step(
                rcfg, rp, rc, t[:, S:], q)
            return out

        ref = reference(jnp.asarray(toks), jnp.asarray(pos))
        got = {"hidden": lm.forward(cfg, p, torch.from_numpy(toks))[0]}
        got["prefill"], c = lm.prefill(cfg, p, torch.from_numpy(toks[:, :S]),
                                       max_seq=S + 8)
        got["prefill_cache"] = {k: v.clone() for k, v in c.items()}
        got["decode"], got["decode_cache"] = lm.decode_step(
            cfg, p, c, torch.from_numpy(toks[:, S:]), torch.from_numpy(pos))
        _RUNS[key] = ref, got
    return _RUNS[key]


# ---------------------------------------------------------------------------
# Configs and the token stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_arch_config_matches_reference(name, smoke):
    ref = (REF_SMOKES if smoke else REF_ARCHS)[name]
    cfg = get_arch(name, smoke=smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for prop in ("head_dim", "d_inner", "dt_rank_", "padded_vocab",
                 "is_encdec", "n_dec_layers", "subquadratic"):
        assert getattr(cfg, prop) == getattr(ref, prop), prop
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert ([cfg.supports_shape(s) for s in SHAPES.values()]
            == [ref.supports_shape(s) for s in REF_SHAPES.values()])


def test_shapes_cells_and_dtypes():
    assert ({k: dataclasses.asdict(v) for k, v in SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()})
    assert ([(a.name, s.name) for a, s in all_cells()]
            == [(a.name, s.name) for a, s in ref_all_cells()])
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("Tensor")
    with pytest.raises(KeyError):
        get_arch("nope")


def test_param_count_magnitudes():
    """Twin of the reference's: analytic counts near the published sizes
    (glm4-9b: 9.40 B)."""
    expect = {"glm4-9b": 9.4e9, "deepseek-67b": 67e9,
              "falcon-mamba-7b": 7.3e9, "mixtral-8x22b": 141e9,
              "chameleon-34b": 34e9, "dbrx-132b": 132e9,
              "nemotron-4-340b": 340e9, "phi4-mini-3.8b": 3.8e9,
              "hymba-1.5b": 1.5e9}
    for name, want in expect.items():
        got = ARCHS[name].param_count()
        assert 0.75 * want < got < 1.35 * want, (name, got, want)


def test_long_500k_support_matrix():
    runnable = {a.name for a in ARCHS.values()
                if a.supports_shape(SHAPES["long_500k"])}
    assert runnable == {"falcon-mamba-7b", "hymba-1.5b", "mixtral-8x22b"}


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17)])
def test_token_stream_matches_reference(seed, step):
    cfg, rcfg = SMOKES["glm4-9b"], REF_SMOKES["glm4-9b"]
    np.testing.assert_array_equal(
        tokens.synth_tokens(cfg, 3, 40, seed, step),
        ref_tokens.synth_tokens(rcfg, 3, 40, seed, step))
    for got, want in zip(tokens.lm_batch(cfg, 2, 33, seed, step),
                         ref_tokens.lm_batch(rcfg, 2, 33, seed, step)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["glm4-9b", "phi4-mini-3.8b",
                                  "chameleon-34b"])
def test_rms_norm_and_rope_match_reference(name, dtype):
    """rotary_pct 0.5 (glm4), 0.75 (phi4) and 1.0 (chameleon): only
    int(dh * pct) // 2 * 2 channels rotate, as interleaved pairs."""
    rng = np.random.default_rng(0)
    cfg, rcfg = SMOKES[name], REF_SMOKES[name]
    np.testing.assert_array_equal(L.rope_freqs(cfg).numpy(),
                                  np.asarray(RL.rope_freqs(rcfg)))
    xj, xt = pair(rng, (2, 9, 64), dtype)
    scale = rng.normal(size=64).astype(np.float32)
    close(L.rms_norm(xt, torch.from_numpy(scale)),
          RL.rms_norm(xj, jnp.asarray(scale)), TOL[dtype], "rms_norm")
    qj, qt = pair(rng, (2, 9, 4, cfg.head_dim), dtype)
    pos = np.arange(3, 12)
    got = L.apply_rope(qt, torch.from_numpy(pos), cfg)
    want = RL.apply_rope(qj, jnp.asarray(pos), rcfg)
    close(got, want, TOL[dtype], "rope")
    rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
    np.testing.assert_array_equal(_np(got)[..., rot:], _np(qt)[..., rot:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("kind", ["full", "chunked"])
def test_prefill_attention_matches_reference(kind, window, dtype):
    rng = np.random.default_rng(1)
    qj, qt = pair(rng, (2, 37, 4, 16), dtype)
    kj, kt = pair(rng, (2, 37, 2, 16), dtype)
    vj, vt = pair(rng, (2, 37, 2, 16), dtype)
    if kind == "full":
        got = L.full_attention(qt, kt, vt, causal=True, window=window)
        want = RL.full_attention(qj, kj, vj, causal=True, window=window)
    else:
        got = L.chunked_attention(qt, kt, vt, causal=True, window=window,
                                  chunk=16)
        want = RL.chunked_attention(qj, kj, vj, causal=True, window=window,
                                    chunk=16)
    assert got.dtype == torch_dtype(dtype)
    close(got, want, TOL[dtype], kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_reference(window, dtype):
    rng = np.random.default_rng(2)
    qj, qt = pair(rng, (2, 1, 4, 8), dtype)
    kj, kt = pair(rng, (2, 8, 2, 8), dtype)
    vj, vt = pair(rng, (2, 8, 2, 8), dtype)
    cpos = np.array([[16, 17, 10, 11, 12, 13, 14, 15],
                     [0, 1, 2, 3, -1, -1, -1, -1]], np.int32)
    pos = np.array([17, 3], np.int32)
    got = L.decode_attention(qt, kt, vt, torch.from_numpy(cpos),
                             torch.from_numpy(pos), window=window)
    want = RL.decode_attention(qj, kj, vj, jnp.asarray(cpos),
                               jnp.asarray(pos), window=window)
    close(got, want, TOL[dtype], "decode_attention")


def test_attention_entry_point_on_the_cpu(monkeypatch):
    """On CPU tensors the prefill entry point is full_attention up to
    ATTN_CHUNK_THRESHOLD tokens and chunked_attention (chunk ATTN_CHUNK)
    above, bit for bit; the reference's mixer picks the same way."""
    monkeypatch.setattr(L, "ATTN_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(L, "ATTN_CHUNK", 8)
    rng = np.random.default_rng(3)
    for s, window in ((16, 0), (17, 0), (29, 6)):
        _, q = pair(rng, (1, s, 4, 8))
        _, k = pair(rng, (1, s, 2, 8))
        _, v = pair(rng, (1, s, 2, 8))
        want = (L.full_attention(q, k, v, causal=True, window=window)
                if s <= 16 else
                L.chunked_attention(q, k, v, causal=True, window=window,
                                    chunk=8))
        assert torch.equal(L.attention(q, k, v, causal=True, window=window),
                           want)


# the five tests of tests/test_attention.py, on the port

@pytest.mark.parametrize("sq,chunk,window,h,kv,seed", [
    (1, 4, 0, 2, 1, 0), (17, 16, 8, 4, 2, 1), (33, 32, 24, 4, 1, 2),
    (65, 16, 0, 2, 2, 3), (40, 4, 8, 4, 2, 4)])
def test_chunked_equals_full(sq, chunk, window, h, kv, seed):
    rng = np.random.default_rng(seed)
    _, q = pair(rng, (2, sq, h, 8))
    _, k = pair(rng, (2, sq, kv, 8))
    _, v = pair(rng, (2, sq, kv, 8))
    full = L.full_attention(q, k, v, causal=True, window=window)
    chk = L.chunked_attention(q, k, v, causal=True, window=window,
                              chunk=chunk)
    np.testing.assert_allclose(full.numpy(), chk.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_window_masks_strictly():
    """With window w, position p attends only to (p-w, p]."""
    rng = np.random.default_rng(0)
    s, w = 32, 8
    _, q = pair(rng, (1, s, 2, 4))
    _, k = pair(rng, (1, s, 2, 4))
    _, v = pair(rng, (1, s, 2, 4))
    out = L.full_attention(q, k, v, causal=True, window=w)
    k2, v2 = k.clone(), v.clone()
    k2[:, : s - w] = 1e6
    v2[:, : s - w] = 1e6
    out2 = L.full_attention(q, k2, v2, causal=True, window=w)
    np.testing.assert_allclose(out[:, -1].numpy(), out2[:, -1].numpy(),
                               rtol=1e-4)


def test_decode_attention_matches_full():
    """Decode path against a filled cache == last row of full attention."""
    rng = np.random.default_rng(1)
    b, s, h, kv, dh = 2, 16, 4, 2, 8
    _, q = pair(rng, (b, s, h, dh))
    _, k = pair(rng, (b, s, kv, dh))
    _, v = pair(rng, (b, s, kv, dh))
    full = L.full_attention(q, k, v, causal=True)
    cpos = torch.arange(s).expand(b, s)
    pos = torch.full((b,), s - 1, dtype=torch.int32)
    dec = L.decode_attention(q[:, -1:], k, v, cpos, pos)
    np.testing.assert_allclose(full[:, -1:].numpy(), dec.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_decode_attention_ring_window():
    """Ring cache with window: empty (-1) and out-of-window slots
    ignored."""
    rng = np.random.default_rng(2)
    _, q = pair(rng, (1, 1, 2, 4))
    _, k = pair(rng, (1, 8, 2, 4))
    _, v = pair(rng, (1, 8, 2, 4))
    cpos = torch.tensor([[16, 17, 10, 11, 12, 13, 14, 15]])
    pos = torch.tensor([17])
    out = L.decode_attention(q, k, v, cpos, pos, window=4)
    k2, v2 = k.clone(), v.clone()
    k2[:, [2, 3, 4]] = 1e6                 # positions 10, 11, 12
    v2[:, [2, 3, 4]] = 1e6
    out2 = L.decode_attention(q, k2, v2, cpos, pos, window=4)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-4)


def test_gqa_repeat_equivalence():
    """GQA == MHA with explicitly repeated KV heads."""
    rng = np.random.default_rng(3)
    _, q = pair(rng, (2, 8, 4, 8))
    _, k = pair(rng, (2, 8, 2, 8))
    _, v = pair(rng, (2, 8, 2, 8))
    out_gqa = L.full_attention(q, k, v, causal=True)
    out_mha = L.full_attention(q, L._repeat_kv(k, 2), L._repeat_kv(v, 2),
                               causal=True)
    np.testing.assert_allclose(out_gqa.numpy(), out_mha.numpy(), rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_mlp_matches_reference(act, dtype):
    rcfg = dataclasses.replace(REF_SMOKES["glm4-9b"], act=act,
                               compute_dtype=dtype)
    cfg = dataclasses.replace(SMOKES["glm4-9b"], act=act,
                              compute_dtype=dtype)
    rp = RL.init_mlp(jax.random.PRNGKey(0), rcfg)
    p = lm.Params({k: torch.from_numpy(np.asarray(v)) for k, v in rp.items()})
    xj, xt = pair(np.random.default_rng(4), (2, 5, 64), dtype)
    close(L.mlp(xt, p, cfg), RL.mlp(xj, rp, rcfg), TOL[dtype], act)


@pytest.mark.parametrize("nonnegative", [False, True])
def test_quant_linear_matches_reference(nonnegative):
    """QAT activations (PACT / signed by the input range), DoReFa weights
    and the FCP mask, in float32."""
    kw = dict(quant_bits=3, quant_weights=2, fcp_fanin=4,
              compute_dtype="float32")
    rcfg = dataclasses.replace(REF_SMOKES["nemotron-4-340b"], **kw)
    cfg = dataclasses.replace(SMOKES["nemotron-4-340b"], **kw)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    if nonnegative:
        x = np.abs(x)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    mask = (rng.random((64, 32)) < 0.3).astype(np.float32)
    alpha = np.float32(2.5)
    want = RL.quant_linear(jnp.asarray(x), jnp.asarray(w), rcfg,
                           jnp.asarray(mask), jnp.asarray(alpha), nonnegative)
    got = L.quant_linear(torch.from_numpy(x), torch.from_numpy(w), cfg,
                         torch.from_numpy(mask), torch.tensor(alpha),
                         nonnegative)
    close(got, want, F32_TOL, "quant_linear")


@pytest.mark.parametrize("dtype", DTYPES)
def test_cast_weights_is_the_cast_at_use(dtype):
    """``cast_weights_`` applies DoReFa and the mask once, before the
    cast; the MLP on the prepared module equals the MLP on the float32
    one bit for bit, and a second cast changes nothing."""
    kw = dict(quant_bits=2, quant_weights=2, fcp_fanin=4,
              compute_dtype=dtype)
    cfg = dataclasses.replace(SMOKES["phi4-mini-3.8b"], **kw)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    mlp0 = p.layers[0].mlp
    mlp0.mask_w1.copy_(torch.rand(mlp0.mask_w1.shape,
                                  generator=torch.Generator().manual_seed(1))
                       < 0.5)
    _, x = pair(np.random.default_rng(6), (2, 3, 64), dtype)
    want = L.mlp(x, mlp0, cfg)
    h_want = lm.forward(cfg, p, torch.arange(6).reshape(1, 6))[0]
    lm.cast_weights_(cfg, p)
    for _ in range(2):
        assert mlp0.prepared and mlp0.w1.dtype == torch_dtype(dtype)
        assert p.embed.dtype == p.layers[1].attn.wq.dtype == mlp0.w3.dtype
        assert p.final_norm.dtype == p.layers[0].ln1.dtype == torch.float32
        assert torch.equal(L.mlp(x, mlp0, cfg), want)
        assert torch.equal(lm.forward(cfg, p, torch.arange(6).reshape(1, 6))
                           [0], h_want)
        lm.cast_weights_(cfg, p)


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_forward_and_step_match_reference(dtype):
    rcfg, rp, cfg, p = models("falcon-mamba-7b", dtype)
    rm = jax.tree.map(lambda a: a[0], rp["layers"]["mamba"])
    pm = p.layers[0].mamba
    xj, xt = pair(np.random.default_rng(8), (2, 20, 64), dtype)
    want, rstate = jax.jit(lambda x: RM.mamba_forward(
        x, rm, rcfg, return_state=True), compiler_options=STRICT)(xj)
    got, state = M.mamba_forward(xt, pm, cfg, return_state=True)
    close(got, want, TOL[dtype], "mamba_forward")
    for key in ("ssm", "conv"):
        close(state[key], rstate[key], TOL[dtype], key)
    rcache = RM.init_mamba_cache(rcfg, 2, jnp.dtype(dtype))
    cache = M.init_mamba_cache(cfg, 2, torch_dtype(dtype))
    ref_step = jax.jit(lambda x, c: RM.mamba_step(x, c, rm, rcfg),
                       compiler_options=STRICT)
    for t in range(4):
        ry, rcache = ref_step(xj[:, t], rcache)
        y, cache = M.mamba_step(xt[:, t], cache, pm, cfg)
        close(y, ry, TOL[dtype], f"mamba_step {t}")
        for key in ("ssm", "conv"):
            close(cache[key], rcache[key], TOL[dtype], key)


def test_mamba_step_matches_forward():
    """Twin of the reference's: the sequence form replayed step by step."""
    cfg = SMOKES["falcon-mamba-7b"]
    p = lm.Params(M.init_mamba(torch.Generator().manual_seed(0), cfg))
    _, x = pair(np.random.default_rng(1), (2, 24, cfg.d_model))
    y_seq, states = M.mamba_forward(x, p, cfg, return_state=True)
    cache = M.init_mamba_cache(cfg, 2, torch.float32)
    outs = []
    for t in range(24):
        y, cache = M.mamba_step(x[:, t], cache, p, cfg)
        outs.append(y)
    np.testing.assert_allclose(y_seq.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(states["ssm"].numpy(), cache["ssm"].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16), (100, 16), (32, 64),
                                     (1, 4)])
def test_mamba_chunked_scan_matches_reference(s, chunk):
    """The doubling scan, chunked or flat, against the reference's
    ``_chunked_linear_scan`` and its flat ``associative_scan``."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 1.0, (2, s, 4, 3)).astype(np.float32)
    b = rng.normal(size=(2, s, 4, 3)).astype(np.float32)
    got = M._chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 chunk=chunk)

    def comb(l, r):
        return l[0] * r[0], r[1] + r[0] * l[1]

    flat, chunked = jax.jit(lambda a, b: (
        jax.lax.associative_scan(comb, (a, b), axis=1)[1],
        RM._chunked_linear_scan(a, b, chunk=chunk)))(jnp.asarray(a),
                                                     jnp.asarray(b))
    close(got, flat, F32_TOL, "flat")
    close(got, chunked, F32_TOL, "chunked")


def test_short_prompt_conv_state_follows_reference():
    """A prompt shorter than ssm_conv - 1 tokens leaves a conv state as
    short as the prompt in both packages (ROADMAP, Reference caveats)."""
    rcfg, rp, cfg, p = models("falcon-mamba-7b", "float32")
    for s in (1, 2, 3):
        toks = np.arange(1, s + 1, dtype=np.int32)[None]
        rc = jax.eval_shape(lambda t: rlm.prefill(
            rcfg, rp, tokens=t, max_seq=16)[1], jnp.asarray(toks))
        _, c = lm.prefill(cfg, p, torch.from_numpy(toks), max_seq=16)
        assert tuple(c["conv"].shape) == rc["conv"].shape
        assert c["conv"].shape[2] == min(s, cfg.ssm_conv - 1)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(name, dtype):
    ref, got = runs(name, dtype)
    assert got["hidden"].dtype == torch_dtype(dtype)
    close(got["hidden"], ref["hidden"], TOL[dtype], "hidden")


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_within_tolerance_of_default_compiled_reference(name):
    """At bfloat16, against the reference compiled as it runs by default
    (XLA free to keep excess precision)."""
    rcfg, rp, cfg, p = models(name, "bfloat16")
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    want = jax.jit(lambda t: rlm.forward(rcfg, rp, tokens=t)[0])(
        jnp.asarray(toks))
    close(runs(name, "bfloat16")[1]["hidden"], want, BF16_XLA_TOL, "hidden")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_matches_reference(name, dtype):
    ref, got = runs(name, dtype)
    close(got["prefill"], ref["prefill"], TOL[dtype], "logits")
    np.testing.assert_array_equal(_np(got["prefill"]).argmax(-1),
                                  _np(ref["prefill"]).argmax(-1))
    rc, c = ref["prefill_cache"], got["prefill_cache"]
    assert sorted(c) == sorted(rc)
    for key in rc:
        assert tuple(c[key].shape) == rc[key].shape, key
        if key == "positions":
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(rc[key]))
        else:
            close(c[key], rc[key], TOL[dtype], key)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_matches_reference(name, dtype):
    """One decode step on prefill's cache: logits and the updated cache
    (the port writes it in place; the reference returns a new one)."""
    ref, got = runs(name, dtype)
    close(got["decode"], ref["decode"], TOL[dtype], "logits")
    np.testing.assert_array_equal(_np(got["decode"]).argmax(-1),
                                  _np(ref["decode"]).argmax(-1))
    rc, c = ref["decode_cache"], got["decode_cache"]
    assert sorted(c) == sorted(rc)
    for key in rc:
        if key == "positions":
            np.testing.assert_array_equal(c[key].numpy(), np.asarray(rc[key]))
        else:
            close(c[key], rc[key], TOL[dtype], key)


# nemotron-4-340b's own head width at smoke width: d_model 64, 4 heads of
# 192 (96 rotary dims, rotary_pct 0.5), relu^2; on the card these heads
# take the flash kernel's 192 template
WIDE = {"d_head": 192}


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_head_forward_matches_reference(dtype):
    rcfg, _, cfg, _ = models("nemotron-4-340b", dtype, **WIDE)
    assert cfg.head_dim == rcfg.head_dim == 192
    ref, got = runs("nemotron-4-340b", dtype, **WIDE)
    assert got["hidden"].dtype == torch_dtype(dtype)
    close(got["hidden"], ref["hidden"], TOL[dtype], "hidden")


@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_head_prefill_and_decode_match_reference(dtype):
    """Prefill's logits and cache (k, v of 192-wide heads) and one
    decode step's, against the reference; greedy tokens identical."""
    ref, got = runs("nemotron-4-340b", dtype, **WIDE)
    for step in ("prefill", "decode"):
        close(got[step], ref[step], TOL[dtype], step)
        np.testing.assert_array_equal(_np(got[step]).argmax(-1),
                                      _np(ref[step]).argmax(-1))
        rc, c = ref[step + "_cache"], got[step + "_cache"]
        assert sorted(c) == sorted(rc)
        assert c["k"].shape[-1] == 192
        for key in rc:
            if key == "positions":
                np.testing.assert_array_equal(c[key].numpy(),
                                              np.asarray(rc[key]))
            else:
                close(c[key], rc[key], TOL[dtype], f"{step} {key}")


def test_wide_head_decode_matches_forward():
    """prefill + decode_step against forward at dh 192, bf16, with the
    reference test's tolerance and argmax (as ``test_decode_matches_
    forward`` holds the other families)."""
    cfg = dataclasses.replace(SMOKES["nemotron-4-340b"], **WIDE)
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    hidden, _, _ = lm.forward(cfg, p, toks)
    want = lm.logits_head(cfg, p, hidden[:, -1]).float().numpy()
    _, cache = lm.prefill(cfg, p, toks[:, :S], max_seq=S + 8)
    got, _ = lm.decode_step(cfg, p, cache, toks[:, S:],
                            torch.full((B,), S, dtype=torch.int32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", ["glm4-9b", "falcon-mamba-7b",
                                  "hymba-1.5b"])
def test_decode_matches_forward(name):
    """Twin of the reference's: prefill(x[:S]) + decode_step(x[S]) ==
    forward(x[:S+1])'s last logits, at the configs' bf16, with the
    reference test's tolerance and argmax."""
    cfg = SMOKES[name]
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    hidden, _, _ = lm.forward(cfg, p, toks)
    want = lm.logits_head(cfg, p, hidden[:, -1]).float().numpy()
    _, cache = lm.prefill(cfg, p, toks[:, :S], max_seq=S + 8)
    got, _ = lm.decode_step(cfg, p, cache, toks[:, S:],
                            torch.full((B,), S, dtype=torch.int32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_swa_ring_cache_long_decode():
    """Twin of the reference's: a hybrid ring cache stays consistent past
    the window."""
    cfg = SMOKES["hymba-1.5b"]                    # window 64
    p = lm.init_params(cfg, torch.Generator().manual_seed(0))
    s = 96
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, s + 1)).astype(np.int32))
    hidden, _, _ = lm.forward(cfg, p, toks)
    want = lm.logits_head(cfg, p, hidden[:, -1])
    _, cache = lm.prefill(cfg, p, toks[:, :s], max_seq=s + 8)
    assert cache["k"].shape[2] == cfg.window      # ring-bounded
    got, _ = lm.decode_step(cfg, p, cache, toks[:, s:],
                            torch.full((1,), s, dtype=torch.int32))
    np.testing.assert_array_equal(got.float().numpy().argmax(-1),
                                  want.float().numpy().argmax(-1))


def test_params_carry_across_and_init_matches_reference_layout():
    """``lm_params_from_jax`` keeps every leaf's value and layout; the
    port's seeded init has the reference's leaves and shapes, and one
    seed gives one set of weights."""
    rcfg, rp, cfg, p = models("hymba-1.5b", "bfloat16")
    assert set(p.keys()) == set(rp)
    for i, lp in enumerate(p.layers):
        for key, sub in rp["layers"].items():
            if isinstance(sub, dict):
                assert set(lp[key].keys()) == set(sub)
                for k, v in sub.items():
                    np.testing.assert_array_equal(lp[key][k].numpy(),
                                                  np.asarray(v[i]))
            else:
                np.testing.assert_array_equal(lp[key].numpy(),
                                              np.asarray(sub[i]))
    np.testing.assert_array_equal(p.embed.numpy(), np.asarray(rp["embed"]))
    mine = lm.init_params(cfg, torch.Generator().manual_seed(0))
    again = lm.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = {n: tuple(t.shape) for n, t in mine.state_dict().items()}
    assert shapes == {n: tuple(t.shape) for n, t in p.state_dict().items()}
    assert all(torch.equal(a, b) for a, b in zip(
        mine.state_dict().values(), again.state_dict().values()))
    with pytest.raises(ValueError):
        lm_params_from_jax(dataclasses.replace(cfg, n_layers=3),
                           jax.tree.map(np.asarray, rp))

