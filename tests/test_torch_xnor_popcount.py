"""repro_torch.kernels.xnor_popcount against repro.kernels.xnor_popcount
on the same numpy inputs: packing and the packed bipolar matmul, exact,
including zeros (which both pack as -1) and ragged feature counts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xnor_popcount import pack_bipolar as ref_pack
from repro.kernels.xnor_popcount import xnor_matmul as ref_xnor
from repro.kernels.xnor_popcount import xnor_matmul_ref as ref_oracle
from repro_torch.kernels.xnor_popcount import (pack_bipolar, xnor_matmul,
                                               xnor_matmul_packed,
                                               xnor_matmul_ref,
                                               xnor_popcount_ref)


def _bipolar(rng, shape, zeros=True):
    vals = [-1.0, 0.0, 1.0] if zeros else [-1.0, 1.0]
    return rng.choice(vals, shape).astype(np.float32)


@pytest.mark.parametrize("B,n,N", [(8, 32, 16), (17, 100, 33), (1, 7, 1),
                                   (40, 129, 250), (3, 64, 5),
                                   # across the kernel's 32 x 16 tiles,
                                   # 16-word slabs and the word
                                   (17, 257, 9), (33, 1000, 65),
                                   (64, 4096, 24)])
@pytest.mark.parametrize("zeros", [False, True])
def test_xnor_matmul_matches_reference_kernel(B, n, N, zeros):
    rng = np.random.default_rng(n + B)
    x, w = _bipolar(rng, (B, n), zeros), _bipolar(rng, (N, n), zeros)
    want = np.asarray(ref_xnor(jnp.asarray(x), jnp.asarray(w)))
    got = xnor_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if not zeros:                 # on +-1 inputs the float oracle agrees
        np.testing.assert_array_equal(
            xnor_matmul_ref(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
            want)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_pack_bipolar_matches_reference(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(6, n)).astype(np.float32)
    x[rng.random((6, n)) < 0.2] = 0.0
    x[0, 0] = np.nan
    x[1, -1] = -0.0
    want = np.asarray(ref_pack(jnp.asarray(x)))
    got = pack_bipolar(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_zero_counts_as_minus_one_as_in_the_kernel():
    """A 0 packs as -1, so the kernel route and the float oracle differ
    on it; the port's kernel route follows the reference's kernel."""
    x = np.ones((1, 34), np.float32)
    x[0, 5] = 0.0
    w = np.ones((1, 34), np.float32)
    want = int(np.asarray(ref_xnor(jnp.asarray(x), jnp.asarray(w)))[0, 0])
    oracle = int(np.asarray(ref_oracle(jnp.asarray(x), jnp.asarray(w)))[0, 0])
    assert (want, oracle) == (32, 33)
    assert int(xnor_matmul(torch.from_numpy(x), torch.from_numpy(w))) == 32
    assert int(xnor_matmul_ref(torch.from_numpy(x),
                               torch.from_numpy(w))) == 33


def test_packed_plain_version_counts_mismatches():
    rng = np.random.default_rng(3)
    xp = torch.from_numpy(rng.integers(0, 1 << 32, (5, 3), dtype=np.uint32)
                          .view(np.int32))
    wp = torch.from_numpy(rng.integers(0, 1 << 32, (4, 3), dtype=np.uint32)
                          .view(np.int32))
    xb = np.unpackbits(xp.numpy().view(np.uint8), axis=1)
    wb = np.unpackbits(wp.numpy().view(np.uint8), axis=1)
    want = 96 - 2 * (xb[:, None, :] != wb[None]).sum(-1)
    np.testing.assert_array_equal(xnor_popcount_ref(xp, wp, 96).numpy(),
                                  want)
    np.testing.assert_array_equal(xnor_matmul_packed(xp, wp, 96).numpy(),
                                  want)


def test_wrapper_rejects_bad_operands():
    xp = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        xnor_matmul_packed(xp.float(), xp, 96)
    with pytest.raises(ValueError):
        xnor_matmul_packed(xp, torch.zeros((2, 4), dtype=torch.int32), 96)
    with pytest.raises(ValueError):
        xnor_matmul_packed(xp, xp, 97)
    with pytest.raises(ValueError):
        xnor_matmul(torch.ones(2, 5), torch.ones(2, 6))


@pytest.mark.parametrize("n,vec", [(4096, True), (4000, False),
                                   (100, True), (257, False)])
def test_loads_are_vectorized_for_rows_of_whole_16_bytes(n, vec):
    """Rows of a multiple of 4 words at 16-byte aligned addresses load as
    16-byte vectors; the kernel loads the others word by word."""
    from repro_torch.kernels.xnor_popcount.ops import loads_vectorized
    x = pack_bipolar(torch.ones(3, n))
    assert loads_vectorized(x, x) == vec
    shifted = torch.zeros(x.numel() + 1, dtype=torch.int32)[1:].view(x.shape)
    assert not loads_vectorized(shifted, x)


@pytest.mark.parametrize("op", ["b1.and.popc", "b1.xor.popc", "s8"])
def test_mma_probe_expected_values(op):
    """The probe's host-side expectation of one mma instruction, against
    a bit-by-bit count."""
    from repro_torch.bench.mma_probe import _expected
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 32, (16, 8), dtype=np.uint32)
    w = rng.integers(0, 1 << 32, (8, 8), dtype=np.uint32)
    want = np.zeros((16, 8), np.int64)
    for m in range(16):
        for n in range(8):
            if op == "s8":
                want[m, n] = int((x[m].view(np.int8).astype(np.int64)
                                  * w[n].view(np.int8)).sum())
            else:
                both = x[m] & w[n] if op == "b1.and.popc" else x[m] ^ w[n]
                want[m, n] = sum(bin(int(v)).count("1") for v in both)
    np.testing.assert_array_equal(_expected(op, x, w), want)
