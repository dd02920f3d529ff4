"""repro_torch.kernels.fanin_matmul against repro.kernels.fanin_matmul on
the same numpy inputs (rtol = atol = 1e-5, the reference test's
tolerance), and against the dense product with FCP masks from the
port's own ``core/fcp.py`` (1e-4); out-of-range indices and the
bfloat16 / float16 types against the reference kernel (its NaN
positions exactly, the values as each test states); ``plan_fanin``'s
branches and bytes."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.fanin_matmul import dense_equivalent as ref_dense
from repro.kernels.fanin_matmul import fanin_matmul as ref_fanin
from repro.kernels.fanin_matmul import fanin_matmul_ref as ref_oracle
from repro_torch.core.fcp import fanin_indices, topk_row_mask
from repro_torch.kernels.fanin_matmul import (dense_equivalent, fanin_matmul,
                                              fanin_matmul_ref)
from repro_torch.kernels.fanin_matmul.ops import plan_fanin
from repro_torch.kernels.spec import DEFAULT_SMEM_BUDGET

# torch type -> (jax type, numpy type of the same values)
TYPES = {torch.float32: (jnp.float32, np.float32),
         torch.bfloat16: (jnp.bfloat16, ml_dtypes.bfloat16),
         torch.float16: (jnp.float16, np.float16)}


@pytest.mark.parametrize("B,n,N,K", [(8, 32, 16, 3), (19, 64, 40, 5),
                                     (128, 128, 128, 7), (5, 16, 200, 2),
                                     (3, 9, 1, 1)])
def test_fanin_matmul_matches_reference(B, n, N, K):
    rng = np.random.default_rng(B + N)
    x = rng.normal(size=(B, n)).astype(np.float32)
    idx = rng.integers(0, n, (N, K)).astype(np.int32)
    w = rng.normal(size=(N, K)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    want = np.asarray(ref_fanin(*map(jnp.asarray, (x, idx, w, bias))))
    got = fanin_matmul(*map(torch.from_numpy, (x, idx, w, bias)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fanin_matmul_ref(*map(torch.from_numpy, (x, idx, w, bias))).numpy(),
        np.asarray(ref_oracle(*map(jnp.asarray, (x, idx, w, bias)))),
        rtol=1e-5, atol=1e-5)


def test_fanin_matmul_matches_dense_with_fcp_masks():
    rng = np.random.default_rng(0)
    B, n, N, K = 16, 32, 12, 4
    w_dense = torch.from_numpy(rng.normal(size=(N, n)).astype(np.float32))
    mask = topk_row_mask(w_dense, K)
    w_masked = torch.where(mask, w_dense, torch.zeros(()))
    idx, _ = fanin_indices(mask.numpy(), K)
    idx = torch.from_numpy(idx)
    w_k = torch.take_along_dim(w_masked, idx.long(), dim=1)
    x = torch.from_numpy(rng.normal(size=(B, n)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    want = dense_equivalent(x, w_masked, bias)
    np.testing.assert_allclose(fanin_matmul(x, idx, w_k, bias).numpy(),
                               want.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        want.numpy(),
        np.asarray(ref_dense(*map(jnp.asarray, (x.numpy(), w_masked.numpy(),
                                                bias.numpy())))),
        rtol=1e-5, atol=1e-5)


def test_terms_are_added_in_the_kernels_order():
    """k = 0 first, the bias last, each product rounded on its own."""
    x = torch.tensor([[1e8, 1.0, -1e8]], dtype=torch.float32)
    idx = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    w = torch.ones((1, 3), dtype=torch.float32)
    bias = torch.tensor([0.5], dtype=torch.float32)
    # (1e8 + 1) rounds to 1e8 in float32, so the 1 is lost
    assert fanin_matmul(x, idx, w, bias).item() == 0.5


def test_wrapper_rejects_bad_operands():
    x = torch.zeros((2, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.zeros((3, 2))
    with pytest.raises(ValueError):
        fanin_matmul(x.double(), idx, w, torch.zeros(3))
    with pytest.raises(ValueError):
        fanin_matmul(x, idx, w, torch.zeros(4))
    with pytest.raises(ValueError):
        fanin_matmul(x, idx, torch.zeros((3, 3)), torch.zeros(3))


def _operands(seed, B, n, N, K, wild):
    """Seeded float32 operands; with ``wild``, indices in [-n, 0) and
    outside [-n, n) (n, -n - 1, 2^30, -2^31) beside in-range ones."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n)).astype(np.float32)
    idx = rng.integers(0, n, (N, K)).astype(np.int32)
    if wild:
        idx[::3] -= n                                    # wraps
        out_of_range = np.array([n, -n - 1, 1 << 30, -(1 << 31)], np.int32)
        rows = rng.choice(N, size=4, replace=False)
        idx[rows, rng.integers(0, K, 4)] = out_of_range
    w = rng.normal(size=(N, K)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    return x, idx, w, bias


def _both(dtype, x, idx, w, bias):
    """(port, reference kernel) outputs as float64 numpy arrays, the
    floats first rounded to ``dtype``."""
    jdt, _ = TYPES[dtype]
    got = fanin_matmul(torch.from_numpy(x).to(dtype), torch.from_numpy(idx),
                       torch.from_numpy(w).to(dtype),
                       torch.from_numpy(bias).to(dtype))
    assert got.dtype == dtype
    want = ref_fanin(*(jnp.asarray(a).astype(jdt) for a in (x,)),
                     jnp.asarray(idx),
                     *(jnp.asarray(a).astype(jdt) for a in (w, bias)))
    assert want.dtype == jdt
    return (got.double().numpy(),
            np.asarray(want.astype(jnp.float32)).astype(np.float64))


def _source_rounding(dtype, x, idx, w, bias):
    """numpy after the reference kernel's source (``fanin_matmul.py``):
    each product in ``dtype``, the sum in float32 from k = 0, then the
    bias, then a cast; out-of-range gathers NaN."""
    _, ndt = TYPES[dtype]
    n = x.shape[1]
    xs = np.concatenate([x.astype(ndt), np.full((x.shape[0], 1), np.nan,
                                                ndt)], axis=1)
    cols = np.where(idx < 0, idx.astype(np.int64) + n, idx)
    cols = np.where((cols >= 0) & (cols < n), cols, n)
    wt = w.astype(ndt)
    acc = np.zeros((x.shape[0], idx.shape[0]), np.float32)
    for k in range(idx.shape[1]):
        acc = acc + (xs[:, cols[:, k]] * wt[:, k]).astype(np.float32)
    return (acc + bias.astype(ndt).astype(np.float32)).astype(ndt)


@pytest.mark.parametrize("dtype", list(TYPES), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("B,n,N,K", [(8, 32, 16, 3), (19, 64, 40, 7),
                                     (5, 16, 200, 9)])
def test_fanin_matmul_follows_reference_indices_and_types(dtype, B, n, N, K):
    """Indices in [-n, 0) wrap and any other outside [0, n) gives NaN, as
    in the reference kernel; in each type the output has the input's
    type. NaN positions must be equal. Values: float16 bit for bit;
    float32 within 1e-5 (XLA's float32 sum on the CPU differs from the
    kernel's by an ulp); bfloat16 within 2^-7 (sum |x w| + |bias| +
    |y|): XLA on the CPU keeps the bfloat16 product in float32 (excess
    precision) where the kernel's source, and the port, round it to
    bfloat16, which moves the sum by at most 2^-8 sum |x w|, and the
    final rounding by one bfloat16 ulp (2^-7 |y|)."""
    x, idx, w, bias = _operands(B + N + K, B, n, N, K, wild=True)
    got, want = _both(dtype, x, idx, w, bias)
    nan = np.isnan(want)
    assert nan.any() and (~nan).any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    if dtype == torch.float16:
        np.testing.assert_array_equal(got, want)
    elif dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        _, ndt = TYPES[dtype]
        xr, wr, br = (a.astype(ndt).astype(np.float64) for a in (x, w, bias))
        n_cols = x.shape[1]
        cols = np.where(idx < 0, idx + n_cols, idx).clip(0, n_cols - 1)
        mag = (np.abs(xr[:, cols] * wr[None]).sum(-1) + np.abs(br))[~nan]
        assert (np.abs(got - want) <= 2.0 ** -7 * (mag + np.abs(want))).all()


@pytest.mark.parametrize("dtype", list(TYPES), ids=lambda d: str(d)[6:])
def test_plain_version_rounds_where_the_reference_source_does(dtype):
    """The port (the plain version on the CPU) bit for bit against numpy
    rounding where ``fanin_matmul.py`` rounds, NaN positions equal."""
    x, idx, w, bias = _operands(5, 33, 70, 45, 11, wild=True)
    got = fanin_matmul(torch.from_numpy(x).to(dtype), torch.from_numpy(idx),
                       torch.from_numpy(w).to(dtype),
                       torch.from_numpy(bias).to(dtype))
    want = _source_rounding(dtype, x, idx, w, bias).astype(np.float64)
    got = got.double().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def test_out_of_range_index_is_nan_whatever_the_weight():
    x = torch.ones((2, 4))
    idx = torch.tensor([[4, 0], [-5, 1], [-4, 3]], dtype=torch.int32)
    w = torch.tensor([[0.0, 1.0], [0.0, 1.0], [1.0, 1.0]])
    y = fanin_matmul(x, idx, w, torch.zeros(3))
    assert torch.isnan(y[:, :2]).all()
    assert torch.equal(y[:, 2], torch.full((2,), 2.0))   # -4 reads column 0


@pytest.mark.parametrize("x_t,w_t,b_t", [
    (torch.float32, torch.float64, torch.float32),
    (torch.float64, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float64),
    (torch.bfloat16, torch.bfloat16, torch.int32),
    (torch.float64, torch.float64, torch.float64)])
def test_mixed_or_other_types_raise(x_t, w_t, b_t):
    """float64 (or an integer bias) in any place raises: the kernel takes
    float32, bfloat16 and float16, mixed as the next test holds them."""
    with pytest.raises(ValueError):
        fanin_matmul(torch.zeros((2, 4), dtype=x_t),
                     torch.zeros((3, 2), dtype=torch.int32),
                     torch.zeros((3, 2), dtype=w_t),
                     torch.zeros(3, dtype=b_t))


MIXED = [(x_t, w_t, b_t) for x_t in TYPES for w_t in TYPES for b_t in TYPES
         if not x_t == w_t == b_t]


@pytest.mark.parametrize("x_t,w_t,b_t", MIXED,
                         ids=lambda d: str(d)[6:])
def test_mixed_types_match_reference_kernel(x_t, w_t, b_t):
    """Mixed float32 / bfloat16 / float16 operands against the reference
    kernel (``fanin_matmul_pallas`` in interpret mode), which multiplies
    in JAX's promoted type of x and w, sums in float32, adds the bias in
    float32 and returns x's type: the output has x's type and the
    reference's NaN positions. Values: bit for bit where XLA on the CPU
    rounds as the kernel's source does (x in bfloat16 or float16 with a
    product in float32 or float16); with x in float32 within 1e-5, the
    float32 test's bound (XLA's float32 sum differs from the kernel's
    by an ulp); with a bfloat16 product (x and w in bfloat16) within
    2^-7 (sum |x w| + |bias| + |y|), the bound of the bfloat16 test:
    XLA keeps that product in float32."""
    x, idx, w, bias = _operands(len(MIXED), 19, 64, 40, 7, wild=True)
    got = fanin_matmul(torch.from_numpy(x).to(x_t), torch.from_numpy(idx),
                       torch.from_numpy(w).to(w_t),
                       torch.from_numpy(bias).to(b_t))
    assert got.dtype == x_t
    want = ref_fanin(jnp.asarray(x).astype(TYPES[x_t][0]), jnp.asarray(idx),
                     jnp.asarray(w).astype(TYPES[w_t][0]),
                     jnp.asarray(bias).astype(TYPES[b_t][0]),
                     interpret=True)
    assert want.dtype == TYPES[x_t][0]
    got = got.double().numpy()
    want = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    nan = np.isnan(want)
    assert nan.any() and (~nan).any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    if x_t == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    elif x_t == w_t == torch.bfloat16:
        xr, wr, br = (a.astype(TYPES[t][1]).astype(np.float64)
                      for a, t in ((x, x_t), (w, w_t), (bias, b_t)))
        cols = np.where(idx < 0, idx + x.shape[1], idx).clip(
            0, x.shape[1] - 1)
        mag = (np.abs(xr[:, cols] * wr[None]).sum(-1) + np.abs(br))[~nan]
        assert (np.abs(got - want) <= 2.0 ** -7 * (mag + np.abs(want))).all()
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x_t,w_t,b_t", [
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.float16, torch.bfloat16, torch.float16),
    (torch.float32, torch.float16, torch.bfloat16)], ids=lambda d: str(d)[6:])
def test_plain_version_rounds_mixed_types_where_the_source_does(x_t, w_t,
                                                                 b_t):
    """Mixed types through the plain version bit for bit against numpy
    after ``fanin_matmul.py``: each product in the promoted type of x
    and w, the float32 sum from k = 0, the bias in float32, x's type
    out; NaN positions equal."""
    x, idx, w, bias = _operands(6, 33, 70, 45, 11, wild=True)
    ndt = {t: TYPES[t][1] for t in TYPES}
    pdt = ndt[torch.promote_types(x_t, w_t)]
    n = x.shape[1]
    xs = np.concatenate([x.astype(ndt[x_t]),
                         np.full((x.shape[0], 1), np.nan, ndt[x_t])], axis=1)
    cols = np.where(idx < 0, idx.astype(np.int64) + n, idx)
    cols = np.where((cols >= 0) & (cols < n), cols, n)
    wt = w.astype(ndt[w_t])
    acc = np.zeros((x.shape[0], idx.shape[0]), np.float32)
    for k in range(idx.shape[1]):
        acc = acc + (xs[:, cols[:, k]].astype(pdt)
                     * wt[:, k].astype(pdt)).astype(np.float32)
    want = (acc + bias.astype(ndt[b_t]).astype(np.float32)).astype(
        ndt[x_t]).astype(np.float64)
    got = fanin_matmul(torch.from_numpy(x).to(x_t), torch.from_numpy(idx),
                       torch.from_numpy(w).to(w_t),
                       torch.from_numpy(bias).to(b_t)).double().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("dtype,B,n_in,N,want", [
    # the bench shape: two rows a block, 128 blocks, all neurons each;
    # 16 bytes of mbarrier, then the rows' bytes rounded up to 16 and 16
    # more
    (torch.float32, 256, 4096, 1024, (True, 2, 1024, 16 + 32768 + 16)),
    (torch.bfloat16, 256, 4096, 1024, (True, 2, 1024, 16 + 16384 + 16)),
    (torch.float16, 512, 4096, 3000, (True, 2, 3008, 16 + 16384 + 16)),
    # one float32 row fills the budget; one column more is not staged
    (torch.float32, 256, 58_104, 64, (True, 1, 64, 232_448)),
    (torch.float32, 256, 58_105, 64, (False, 2, 64, 0)),
    (torch.bfloat16, 600, 116_208, 64, (True, 1, 64, 232_448)),
    (torch.bfloat16, 600, 116_209, 64, (False, 2, 64, 0)),
    # two rows fit; two rows do not
    (torch.float32, 300, 10_000, 8, (True, 2, 32, 16 + 80_000 + 16)),
    (torch.float32, 600, 40_000, 8, (True, 1, 32, 16 + 160_000 + 16)),
    # a short batch splits its neurons over more blocks
    (torch.float32, 8, 4096, 1024, (True, 1, 64, 16 + 16_384 + 16)),
    (torch.float32, 1, 100, 1000, (True, 1, 32, 16 + 400 + 16)),
    (torch.float16, 3, 33, 45, (True, 1, 32, 16 + 80 + 16)),
])
def test_plan_fanin_branches_and_bytes(dtype, B, n_in, N, want):
    plan = plan_fanin(B, n_in, N, dtype)
    assert (plan.staged, plan.rows, plan.span, plan.smem_bytes) == want
    assert plan.smem_bytes <= DEFAULT_SMEM_BUDGET


@pytest.mark.parametrize("dtype", list(TYPES), ids=lambda d: str(d)[6:])
def test_plan_fanin_stays_in_budget_and_covers_every_neuron(dtype):
    size = torch.empty((), dtype=dtype).element_size()
    for B in (1, 7, 64, 200, 256, 513, 4096):
        for n_in in (1, 33, 4096, 30_000, 58_108, 58_109, 200_000):
            for N in (1, 45, 256, 1024, 5000):
                p = plan_fanin(B, n_in, N, dtype)
                need = [16 + -(-r * n_in * size // 16) * 16 + 16
                        for r in (0, 1, 2)]
                assert p.staged == (need[1] <= DEFAULT_SMEM_BUDGET)
                assert p.smem_bytes <= DEFAULT_SMEM_BUDGET
                if p.staged:
                    assert p.smem_bytes == need[p.rows]
                assert p.rows in (1, 2) and p.span % 32 == 0
                blocks = -(-N // p.span)
                assert blocks * p.span >= N > (blocks - 1) * p.span
