"""repro_torch.kernels.fanin_matmul against repro.kernels.fanin_matmul on
the same numpy inputs (rtol = atol = 1e-5, the reference test's
tolerance), and against the dense product with FCP masks from the
port's own ``core/fcp.py`` (1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fanin_matmul import dense_equivalent as ref_dense
from repro.kernels.fanin_matmul import fanin_matmul as ref_fanin
from repro.kernels.fanin_matmul import fanin_matmul_ref as ref_oracle
from repro_torch.core.fcp import fanin_indices, topk_row_mask
from repro_torch.kernels.fanin_matmul import (dense_equivalent, fanin_matmul,
                                              fanin_matmul_ref)


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
