"""repro_torch.kernels.lut_layer against repro's ``lut_layer_ref`` on the
shape sweep of the reference kernel tests (exact). The CUDA kernel is
held against its plain version on the card in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_layer import lut_layer_ref as ref_lut_layer_ref
from repro_torch.kernels.lut_layer import lut_layer

SWEEP = [
    (8, 16, 32, 3, 2),
    (130, 20, 50, 4, 2),     # non-multiple of blocks
    (64, 64, 128, 6, 2),     # exact block
    (33, 10, 7, 2, 4),       # multi-level codes
    (16, 24, 200, 5, 3),
    (256, 64, 32, 3, 3),     # JSC-S second layer at serving batch
]


def _inputs(B, n_in, N, K, L, seed=None):
    rng = np.random.default_rng(B * 7 + N if seed is None else seed)
    codes = rng.integers(0, L, (B, n_in)).astype(np.int32)
    idx = rng.integers(0, n_in, (N, K)).astype(np.int32)
    tables = rng.integers(0, 8, (N, L ** K)).astype(np.int32)
    return codes, idx, tables


@pytest.mark.parametrize("B,n_in,N,K,L", SWEEP)
def test_plain_matches_reference(B, n_in, N, K, L):
    codes, idx, tables = _inputs(B, n_in, N, K, L)
    want = np.asarray(ref_lut_layer_ref(jnp.asarray(codes), jnp.asarray(idx),
                                        jnp.asarray(tables), L))
    got = lut_layer(torch.from_numpy(codes), torch.from_numpy(idx),
                    torch.from_numpy(tables), L)
    assert got.dtype == torch.int32 and got.shape == (B, N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_narrow_table_dtypes_are_cast():
    """Tables stored as int8 (as ``extract_layer_tables`` makes them)
    give the same result as int32 ones."""
    codes, idx, tables = _inputs(33, 10, 7, 2, 4)
    want = lut_layer(torch.from_numpy(codes), torch.from_numpy(idx),
                     torch.from_numpy(tables), 4)
    got = lut_layer(torch.from_numpy(codes.astype(np.int64)),
                    torch.from_numpy(idx),
                    torch.from_numpy(tables.astype(np.int8)), 4)
    assert torch.equal(got, want)


def test_wrapper_rejects_bad_shapes():
    codes, idx, tables = _inputs(8, 16, 32, 3, 2)
    with pytest.raises(ValueError, match="tables"):
        lut_layer(torch.from_numpy(codes), torch.from_numpy(idx),
                  torch.from_numpy(tables[:, :4].copy()), 2)
    with pytest.raises(ValueError, match="2-D"):
        lut_layer(torch.from_numpy(codes[0]), torch.from_numpy(idx),
                  torch.from_numpy(tables), 2)
