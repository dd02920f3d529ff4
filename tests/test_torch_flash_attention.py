"""repro_torch.kernels.flash_attention against
repro.kernels.flash_attention (the Pallas kernel in interpret mode) on
the same numpy inputs, at the reference test's tolerance
(rtol = atol = 2e-4 in float32, 2e-2 in bfloat16): causal, sliding
window, grouped-query heads and ragged sequence lengths. The backward's
plain version against ``jax.vjp`` of the reference's oracle (the
reference has no backward kernel: it trains through XLA's autodiff)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_ref as ref_oracle
from repro_torch.kernels.flash_attention import (attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_backward,
                                                 flash_attention_forward,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops


def _qkv(b, sq, sk, h, kv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kv, dh)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (2, 64, 64, 4, 2, 16, True, 0),       # GQA
    (1, 128, 128, 2, 2, 64, True, 0),     # exact blocks
    (2, 100, 100, 4, 1, 32, True, 24),    # window + ragged S
    (1, 33, 70, 4, 4, 8, False, 0),       # Sq != Sk, no mask
    (1, 257, 257, 2, 1, 128, True, 0),    # > 2 blocks, dh 128
    (1, 20, 45, 2, 1, 12, True, 7),       # Sq < Sk, window, dh not 2^k
])
def test_flash_attention_matches_reference_kernel(b, sq, sk, h, kv, dh,
                                                  causal, win):
    q, k, v = _qkv(b, sq, sk, h, kv, dh)
    want = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=win))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=win)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal,win", [(True, 0), (False, 0), (True, 5),
                                        (False, 3)])
def test_flat_oracle_matches_reference_oracle(causal, win):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 17, 8)).astype(np.float32)
    k = rng.normal(size=(3, 23, 8)).astype(np.float32)
    v = rng.normal(size=(3, 23, 8)).astype(np.float32)
    want = np.asarray(ref_oracle(*map(jnp.asarray, (q, k, v)),
                                 causal=causal, window=win))
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=win)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_take_the_mean_of_v():
    """Causal with a window and more queries than keys leaves rows with
    every key masked. The port gives them the dense softmax's answer,
    the mean of v, as the reference's oracle does; the reference kernel
    divides by the padded key count there once Sk > 128 is padded
    (ROADMAP, reference caveats)."""
    q, k, v = _qkv(1, 300, 130, 1, 1, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, window=4).numpy()
    want = np.asarray(ref_oracle(*(jnp.asarray(a[:, :, 0]) for a in
                                   (q, k, v)), causal=True, window=4))
    np.testing.assert_allclose(got[:, :, 0], want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[0, 299, 0], v[0, :, 0].mean(0),
                               rtol=2e-4, atol=2e-4)
    kernel = np.asarray(ref_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                  window=4))
    assert np.abs(kernel[0, 299, 0] - got[0, 299, 0]).max() > 1e-3
    np.testing.assert_allclose(kernel[0, :133], got[0, :133], rtol=2e-4,
                               atol=2e-4)


def test_attention_ref_repeats_kv_heads():
    q, k, v = _qkv(2, 9, 11, 6, 2, 4, seed=2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attention_ref(tq, tk, tv, causal=False)
    full = attention_ref(tq, tk.repeat_interleave(3, dim=2),
                         tv.repeat_interleave(3, dim=2), causal=False)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.mark.parametrize("causal,win", [(True, 0), (False, 3), (True, 4)])
def test_attention_ref_computes_float64_in_float64(causal, win):
    """Given float64 operands the plain version computes in float64 (the
    exact value the card's checks hold bf16 kernels to): a numpy float64
    softmax attention within 1e-12, rows with every key masked the mean
    of v; the reference's oracle (float32 scores) within 2e-5; and
    autograd's gradients pass ``gradcheck``."""
    q, k, v = _qkv(1, 30, 13, 4, 2, 6, seed=3)
    tq, tk, tv = (torch.from_numpy(a).double() for a in (q, k, v))
    got = attention_ref(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == torch.float64
    kh, vh = (np.repeat(a.astype(np.float64), 2, axis=2) for a in (k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kh) / np.sqrt(6)
    qpos, kpos = np.arange(30)[:, None], np.arange(13)[None, :]
    mask = np.ones((30, 13), bool)
    if causal:
        mask &= kpos <= qpos
    if win:
        mask &= kpos > qpos - win
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if not mask[-1].any():
        np.testing.assert_allclose(got.numpy()[0, -1], vh[0].mean(0),
                                   rtol=1e-12, atol=1e-12)
    flat = np.asarray(ref_oracle(*(jnp.asarray(a.transpose(0, 2, 1, 3)
                                               .reshape(-1, a.shape[1], 6))
                                   for a in (q, np.repeat(k, 2, axis=2),
                                             np.repeat(v, 2, axis=2))),
                                 causal=causal, window=win))
    np.testing.assert_allclose(
        got.numpy().transpose(0, 2, 1, 3).reshape(flat.shape), flat,
        rtol=2e-5, atol=2e-5)
    assert torch.autograd.gradcheck(
        lambda a, b, c: attention_ref(a, b, c, causal=causal, window=win),
        tuple(t[:, :8, :, :3].clone().requires_grad_(True)
              for t in (tq, tk, tv)))


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (1, 64, 64, 2, 2, 32, True, 0),       # the reference's test_flash_bf16
    (2, 64, 64, 4, 2, 16, True, 0),       # GQA
    (2, 100, 77, 4, 1, 32, True, 24),     # window + ragged S
])
def test_flash_attention_bf16_matches_reference_kernel(b, sq, sk, h, kv, dh,
                                                       causal, win):
    """bfloat16 operands: scores and softmax in float32, P rounded to
    bfloat16 before P.V, the output in bfloat16, as the reference kernel
    computes them; held at the reference's bf16 tolerance."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(b, sq, sk, h, kv, dh, seed=sq))
    want = np.asarray(ref_flash(q, k, v, causal=causal, window=win),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_wrapper_rejects_bad_operands():
    q = torch.zeros((1, 4, 3, 8))
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)                    # 3 heads over 2
    with pytest.raises(ValueError):
        flash_attention(q.double(), q, q)
    qk = torch.zeros((1, 4, 2, 8))
    for dtypes in ((torch.bfloat16, torch.float32, torch.float32),
                   (torch.float32, torch.float32, torch.bfloat16),
                   (torch.float16,) * 3):
        with pytest.raises(ValueError):
            flash_attention(*(qk.to(d) for d in dtypes))
    with pytest.raises(ValueError, match="dh"):
        flash_attention(torch.zeros((1, 4, 2, 257)),
                        torch.zeros((1, 4, 2, 257)),
                        torch.zeros((1, 4, 2, 257)))


def test_wrapper_takes_dh_up_to_256():
    """dh 256 runs (the plain version here, the widest template on the
    card); 257 raises, naming dh, in the forward and the backward."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 5, 5, 2, 1, 256))
    out = flash_attention(q, k, v)
    assert out.shape == q.shape and torch.isfinite(out).all()
    out, lse = flash_attention_forward(q, k, v)
    dq, dk, dv = flash_attention_backward(q, k, v, out, torch.ones_like(q),
                                          lse)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    wide = torch.zeros((1, 5, 2, 257))
    with pytest.raises(ValueError, match="dh"):
        flash_attention_forward(wide, wide, wide)
    with pytest.raises(ValueError, match="dh"):
        flash_attention_backward(wide, wide, wide, wide, wide,
                                 torch.zeros((1, 2, 5)))


# the wide heads: nemotron-4-340b's dh 192 and the widest template, 256;
# GQA at nemotron's group of 12 query heads to a KV head
WIDE_SHAPES = [
    (1, 40, 40, 2, 1, 192, True, 0),      # causal
    (1, 37, 37, 4, 2, 192, True, 9),      # window, ragged S
    (1, 24, 24, 12, 1, 192, True, 0),     # GQA 12:1
    (1, 20, 45, 2, 1, 192, True, 7),      # Sq < Sk, window
    (1, 40, 40, 2, 1, 256, True, 0),
    (1, 37, 37, 4, 2, 256, False, 9),     # window only
    (1, 24, 24, 12, 1, 256, True, 0),
    (1, 20, 45, 2, 1, 256, False, 0),     # Sq < Sk, no mask
]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", WIDE_SHAPES)
def test_wide_heads_match_reference_kernel(b, sq, sk, h, kv, dh, causal, win,
                                           dtype, tol):
    """dh 192 and 256 through the port's plain version (what the wrapper
    runs on CPU tensors) against the reference's Pallas kernel in
    interpret mode, whose blocks take the whole dh: float32 within 2e-4,
    bfloat16 within 2e-2 (the reference test's tolerances)."""
    q, k, v = (jnp.asarray(a, dtype)
               for a in _qkv(b, sq, sk, h, kv, dh, seed=dh + sq))
    want = np.asarray(ref_flash(q, k, v, causal=causal, window=win,
                                interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32))
                  .to(getattr(torch, dtype)) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, window=win)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


def _ref_multihead(q, k, v, causal, window):
    """The reference wrapper's GQA layout around its dense oracle."""
    b, sq, h, dh = q.shape
    rep = h // k.shape[2]

    def flat(t, n):
        return jnp.repeat(t.transpose(0, 2, 1, 3), n, axis=1).reshape(
            b * h, t.shape[1], dh)

    out = ref_oracle(flat(q, 1), flat(k, rep), flat(v, rep), causal=causal,
                     window=window)
    return out.reshape(b, h, sq, dh).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (2, 64, 64, 4, 2, 16, True, 0),       # GQA
    (2, 100, 100, 4, 1, 32, True, 24),    # window + ragged S
    (1, 33, 70, 4, 4, 8, False, 0),       # Sq != Sk, no mask
    (1, 40, 12, 2, 1, 8, False, 4),       # fully masked rows
])
def test_backward_plain_version_matches_reference_vjp(b, sq, sk, h, kv, dh,
                                                      causal, win):
    """``flash_attention_backward`` on CPU tensors (autograd through
    ``attention_ref``) against ``jax.vjp`` of the reference's oracle in
    its wrapper's GQA layout: dq, dk, dv within 1e-5 in float32."""
    q, k, v = _qkv(b, sq, sk, h, kv, dh, seed=sq)
    dout = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _ref_multihead(*a, causal, win),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_forward(tq, tk, tv, causal=causal, window=win)
    got = flash_attention_backward(tq, tk, tv, out, torch.from_numpy(dout),
                                   lse, causal=causal, window=win)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,win", [
    (1, 24, 24, 12, 1, 192, True, 0),     # nemotron's group, causal
    (1, 30, 30, 4, 2, 192, True, 8),      # window
    (1, 20, 33, 2, 1, 256, False, 0),     # Sq < Sk
    (1, 40, 12, 2, 1, 256, False, 4),     # fully masked rows
])
def test_wide_backward_matches_reference_vjp(b, sq, sk, h, kv, dh, causal,
                                             win):
    """The backward's plain version at dh 192 and 256 against
    ``jax.vjp`` of the reference's oracle (``full_attention``'s
    attention, differentiated by XLA): dq, dk, dv within 1e-5 in
    float32."""
    q, k, v = _qkv(b, sq, sk, h, kv, dh, seed=dh + sq)
    dout = np.random.default_rng(4).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: _ref_multihead(*a, causal, win),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_forward(tq, tk, tv, causal=causal, window=win)
    got = flash_attention_backward(tq, tk, tv, out, torch.from_numpy(dout),
                                   lse, causal=causal, window=win)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_forward_log_sum_exp_on_the_cpu():
    """The forward's log-sum-exp (the backward's input): logsumexp of the
    scaled scores over each row's unmasked keys, +inf where every key
    is masked, float32 (B, H, Sq); the output is ``flash_attention``'s."""
    q, k, v = _qkv(1, 40, 12, 2, 1, 8, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_forward(tq, tk, tv, causal=False, window=4)
    assert torch.equal(out, flash_attention(tq, tk, tv, causal=False,
                                            window=4))
    assert lse.dtype == torch.float32 and lse.shape == (1, 2, 40)
    s = np.einsum("bqhd,bkhd->bhqk", q, np.repeat(k, 2, axis=2)) / np.sqrt(8)
    i, j = np.arange(40)[:, None], np.arange(12)[None, :]
    keep = j > i - 4
    for row in range(40):
        got = lse[0, :, row].numpy()
        if not keep[row].any():
            assert np.isinf(got).all() and (got > 0).all()
            continue
        m = s[0, :, row, keep[row]]
        want = np.log(np.exp(m - m.max(0)).sum(0)) + m.max(0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        attention_lse_ref(tq, tk, causal=False, window=4).numpy(),
        lse.numpy())


def test_backward_wrapper_rejects_bad_operands():
    q = torch.zeros((1, 4, 2, 8))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q[:, :3], lse)     # dout shape
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q, lse[:, :1])     # lse shape
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q.bfloat16(), lse)  # dout type
    with pytest.raises(ValueError):
        flash_attention_backward(q, q, q, q, q, lse.double())


# the launch grids the wrapper checks against the card's limit, at the
# shapes the card launches: nemotron-4-340b's train_4k attention (B 1,
# S 4,096, H 96, KV 8, dh 192) and served prefill (S 32), glm4-9b's
# training shape (dh 128: no wide blocks) and the card tests' wide shapes

@pytest.mark.parametrize("sq,g,want", [
    (4096, 12, (1, 2)),      # train_4k: 64 rows of a head, heads in pairs
    (32, 12, (2, 2)),        # served prefill: 2 heads x 32 rows a tile
    (16, 12, (4, 1)),        # 4 heads x 16 rows, three tiles a group
    (8, 12, (4, 1)),         # 8 does not divide 12
    (5, 8, (8, 1)),          # 8 heads x 8 rows: the group in one tile
    (33, 12, (1, 2)),        # past 32 rows: no packing
    (32, 3, (1, 1)),         # an odd group: one head, one warpgroup
])
def test_forward_packing(sq, g, want):
    assert flash_ops._forward_packing(sq, g) == want


@pytest.mark.parametrize("b,sq,h,kv,dh,want", [
    (1, 4096, 96, 8, 192, (256 * 96, 64 * 48)),   # train_4k
    (1, 32, 96, 8, 192, (2 * 96, 24)),            # served prefill
    (1, 4096, 48, 4, 256, (256 * 48, 64 * 24)),
    (4, 1024, 32, 2, 128, (64 * 128, 0)),         # glm4-9b: no wgmma
    (1, 65, 3, 1, 192, (5 * 3, 2 * 3)),           # odd group
    (1, 5, 8, 1, 256, (8, 1)),                    # the group in a tile
])
def test_forward_grid(b, sq, h, kv, dh, want):
    assert flash_ops._forward_grid(b, sq, h, kv, dh) == want


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,slices,wide", [
    # train_4k: 64 key blocks x 8 KV heads already fill the card, so one
    # slice (the group's 12 heads walked by each block); dQ: 64 row
    # blocks x 48 head pairs
    (1, 4096, 4096, 96, 8, 192, 1, (512, 3072)),
    (1, 4096, 4096, 48, 4, 256, 2, (512, 1536)),
    (1, 256, 256, 12, 1, 192, 12, (48, 24)),      # a slice a head
    (1, 100, 100, 4, 2, 256, 2, (8, 4)),
    (1, 65, 200, 3, 1, 192, 3, (12, 6)),          # odd group: HB 1
    (4, 1024, 1024, 32, 2, 128, 4, (0, 0)),       # dh 128: no wide pass
])
def test_backward_grid(b, sq, sk, h, kv, dh, slices, wide):
    assert flash_ops._wide_slices(b, sk, kv, h // kv) == slices
    grid = flash_ops._backward_grid(b, sq, sk, h, kv, dh)
    assert grid[-2:] == wide
    # the wgmma branch of dh 64 / 128 and the mma.sync kernels as before
    assert grid[:6] == (-(-sk // 64) * b * h, -(-b * h * -(-sq // 64) * 64
                                               // 8),
                        -(-(b * sq * h + b * sk * kv) * dh // 1024),
                        -(-sq // 64) * b * h,
                        -(-sk // 64) * b * kv * (2 if dh > 128 else 1),
                        -(-b * sq * h // 8))
