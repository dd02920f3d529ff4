"""repro_torch.kernels.lut_layer against repro's ``lut_layer_ref`` on the
shape sweep of the reference kernel tests (exact). The CUDA kernel is
held against its plain version on the card in test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_layer import lut_layer_ref as ref_lut_layer_ref
from repro_torch.kernels.lut_layer import (layer_smem_bytes, lut_layer,
                                           plan_layer)
from repro_torch.kernels.spec import DEFAULT_SMEM_BUDGET

SWEEP = [
    (8, 16, 32, 3, 2),
    (130, 20, 50, 4, 2),     # non-multiple of blocks
    (64, 64, 128, 6, 2),     # exact block
    (33, 10, 7, 2, 4),       # multi-level codes
    (16, 24, 200, 5, 3),
    (256, 64, 32, 3, 3),     # JSC-S second layer at serving batch
    (40, 12, 20, 4, 8),      # 4,096-entry tables: two neurons a block
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


@pytest.mark.parametrize("B,n_in,N,K,R,want", [
    (256, 16, 64, 3, 27, (32, 8, True)),     # JSC-S layer 1
    (256, 64, 32, 3, 27, (32, 8, True)),     # JSC-S layer 2
    (256, 32, 5, 3, 27, (5, 51, True)),      # JSC-S layer 3: one tile
    (256, 64, 64, 4, 256, (32, 8, True)),    # the kernel bench's shape
    (3, 16, 7, 2, 16, (7, 3, True)),         # fewer rows than a tile
])
def test_layer_plan_stages_what_fits(B, n_in, N, K, R, want):
    """Served shapes: 32-neuron tiles (the whole layer when narrower),
    one output per thread, tables and codes in shared memory."""
    assert plan_layer(B, n_in, N, K, R) == want


@pytest.mark.parametrize("B,n_in,N,K,R", [
    (256, 16, 32, 4, 2401),                  # JSC-L layer 1 (L = 7)
    (40, 12, 20, 4, 4096),                   # L = 8
    (70, 30, 9, 6, 729),                     # the sweep's (K, L) = (6, 3)
    (256, 8, 4, 6, 50_000),                  # one table a block
])
def test_layer_plan_splits_large_tables(B, n_in, N, K, R):
    """Large tables: fewer neurons a block, within 32 KB of tables (or
    one neuron), more rows a block, all within the 227 KB budget."""
    n_tile, b_tile, smem = plan_layer(B, n_in, N, K, R)
    assert smem and 1 <= n_tile <= N
    assert n_tile * R * 4 <= 32 * 1024 or n_tile == 1
    assert b_tile == min(B, 256 // n_tile)
    assert layer_smem_bytes(n_tile, b_tile, n_in, K, R) <= DEFAULT_SMEM_BUDGET


def test_layer_plan_reads_device_memory_past_the_budget():
    # a table (7^6 entries, 470 KB) or a row of codes (60,000) over the
    # budget: the device-memory branch, one output per thread
    assert plan_layer(33, 10, 3, 6, 7 ** 6) == (3, 33, False)
    assert plan_layer(5, 60_000, 7, 3, 27) == (7, 5, False)
    assert plan_layer(300, 10, 1000, 6, 7 ** 6) == (256, 1, False)
    # the batch tile shrinks to the rows of codes that fit
    n_tile, b_tile, smem = plan_layer(256, 20_000, 8, 3, 27)
    assert smem and b_tile == (DEFAULT_SMEM_BUDGET - layer_smem_bytes(
        n_tile, 0, 20_000, 3, 27)) // 80_000
