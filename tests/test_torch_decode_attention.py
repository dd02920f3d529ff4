"""The decode_attention kernel (one query token over the serving ring KV
cache) and its wrapper. The CPU tests hold the wrapper's checks, its
plain version against the port's earlier plain decode attention bit for
bit, and the split count; the tests marked ``gpu`` hold the kernel to
the float64 attention on the card and skip without one. No JAX here:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_attention.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref,
                                                  split_count)
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.models import layers as L

BF16, F32 = torch.bfloat16, torch.float32
TOL = {BF16: 2e-2, F32: 2e-4}    # the flash kernel's, x max(1, max |exact|)


def ring(rng, w, lengths, holes=0, future=0):
    """cache_positions (B, W) and positions (B,) of rows that have seen
    ``lengths`` tokens: position p in slot p % w, the latest kept (so a
    row longer than w wraps), empty slots -1; then ``holes`` slots a row
    emptied and ``future`` slots a row holding positions past its own
    (never the current slot)."""
    b = len(lengths)
    pos = np.asarray(lengths, np.int64) - 1
    j = np.arange(w)[None, :]
    cpos = pos[:, None] - (pos[:, None] - j) % w
    cpos[cpos < 0] = -1
    for i in range(b):
        others = np.setdiff1d(np.arange(w), [pos[i] % w])
        for n, value in ((holes, lambda: -1),
                         (future, lambda: pos[i] + 1 + rng.integers(0, 50))):
            for s in rng.choice(others, min(n, len(others)), replace=False):
                cpos[i, s] = value()
    return (torch.from_numpy(cpos.astype(np.int32)),
            torch.from_numpy(pos.astype(np.int32)))


def operands(rng, b, w, h, kv, dh, dtype, device="cpu"):
    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(device, dtype)
    return draw(b, 1, h, dh), draw(b, w, kv, dh), draw(b, w, kv, dh)


def valid_mask(cpos, pos, window):
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if window > 0:
        valid &= cpos > (pos[:, None] - window)
    return valid


def plain_before(q, k_cache, v_cache, cache_positions, positions, window):
    """The port's plain decode attention as ``layers.decode_attention``
    computed it before the kernel took the card."""
    b, _, h, dh = q.shape
    kvh = k_cache.shape[2]
    q5 = q.reshape(b, 1, kvh, h // kvh, dh)
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=torch.float32,
                       device=q.device)
    logits = L.einsum("bqkgd,bwkd->bkgqw", q5, k_cache).float() * scale
    valid = (cache_positions >= 0) & \
        (cache_positions <= positions[:, None])
    if window > 0:
        valid &= cache_positions > (positions[:, None] - window)
    logits = logits.masked_fill(~valid[:, None, None, None, :], L.NEG)
    probs = L._softmax(logits).to(q.dtype)
    out = L.einsum("bkgqw,bwkd->bqkgd", probs, v_cache)
    return out.reshape(b, 1, h, dh)


# ---------------------------------------------------------------------------
# CPU: the wrapper's checks, its plain version, the split count
# ---------------------------------------------------------------------------

def _bad(case):
    rng = np.random.default_rng(0)
    q, k, v = operands(rng, 2, 8, 4, 2, 16, F32)
    cpos, pos = ring(rng, 8, [5, 8])
    args = dict(q=q, k_cache=k, v_cache=v, cache_positions=cpos,
                positions=pos)
    if case == "half":
        args.update(q=q.half(), k_cache=k.half(), v_cache=v.half())
    elif case == "int_q":
        args.update(q=q.int(), k_cache=k.int(), v_cache=v.int())
    elif case == "mixed_types":
        args.update(k_cache=k.bfloat16())
    elif case == "float_positions":
        args.update(cache_positions=cpos.float())
    elif case == "not_a_tensor":
        args.update(positions=pos.tolist())
    elif case == "two_tokens":
        args.update(q=torch.cat([q, q], dim=1))
    elif case == "k_not_4d":
        args.update(k_cache=k[:, :, 0])
    elif case == "v_shape":
        args.update(v_cache=v[:, :4])
    elif case == "dh_mismatch":
        args.update(k_cache=k[..., :8], v_cache=v[..., :8])
    elif case == "heads_not_grouped":
        args.update(q=torch.cat([q, q[:, :, :1]], dim=2))
    elif case == "positions_shape":
        args.update(cache_positions=cpos[:, :4])
    elif case == "batch_positions":
        args.update(positions=pos[:1])
    elif case == "zero_slots":
        args.update(k_cache=k[:, :0], v_cache=v[:, :0],
                    cache_positions=cpos[:, :0])
    elif case == "dh_over_256":
        q, k, v = operands(rng, 2, 8, 4, 2, 257, F32)
        args.update(q=q, k_cache=k, v_cache=v)
    return args


BAD = ["half", "int_q", "mixed_types", "float_positions", "not_a_tensor",
       "two_tokens", "k_not_4d", "v_shape", "dh_mismatch",
       "heads_not_grouped", "positions_shape", "batch_positions",
       "zero_slots", "dh_over_256"]


@pytest.mark.parametrize("case", BAD)
def test_wrapper_raises_on_what_it_does_not_take(case):
    launches = decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        decode_attention(**_bad(case))
    assert decode_attention.launches == launches


# the ring and window cases of the port's decode tests, and a wrapped ring
PLAIN_CASES = [
    # (cpos rows, pos, window)
    ([[16, 17, 10, 11, 12, 13, 14, 15], [0, 1, 2, 3, -1, -1, -1, -1]],
     [17, 3], 0),
    ([[16, 17, 10, 11, 12, 13, 14, 15], [0, 1, 2, 3, -1, -1, -1, -1]],
     [17, 3], 4),
    ([[16, 17, 10, 11, 12, 13, 14, 15]], [17], 4),
    ([list(range(8)), list(range(8))], [7, 7], 0),
    ([[8, 9, 10, 3, 4, 5, 6, 7], [-1] * 8], [10, 0], 5),
]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("case", range(len(PLAIN_CASES)))
def test_cpu_runs_the_plain_version_bit_for_bit(case, dtype):
    """On CPU tensors the wrapper and ``layers.decode_attention`` run the
    plain version, equal bit for bit to the port's plain decode attention
    before the kernel; no kernel is launched."""
    rows, pos, window = PLAIN_CASES[case]
    rng = np.random.default_rng(case)
    cpos = torch.tensor(rows, dtype=torch.int32)
    pos = torch.tensor(pos, dtype=torch.int32)
    q, k, v = operands(rng, cpos.shape[0], cpos.shape[1], 4, 2, 8, dtype)
    want = plain_before(q, k, v, cpos, pos, window)
    launches = decode_attention.launches
    for got in (decode_attention(q, k, v, cpos, pos, window=window),
                L.decode_attention(q, k, v, cpos, pos, window=window),
                L.decode_attention(q, k, v, cpos.long(), pos.long(),
                                   window=window)):
        assert got.dtype == dtype and torch.equal(got, want)
    assert decode_attention.launches == launches


def test_plain_version_in_float64_is_the_exact_attention():
    """The plain version on float64 operands computes in float64: the
    softmax over the valid slots alone, computed directly."""
    rng = np.random.default_rng(5)
    q, k, v = operands(rng, 3, 40, 6, 2, 16, torch.float64)
    cpos, pos = ring(rng, 40, [1, 30, 55], holes=3, future=2)
    got = decode_attention_ref(q, k, v, cpos, pos, window=12)
    valid = valid_mask(cpos, pos, 12)
    for i in range(3):
        for hh in range(6):
            kk, vv = k[i, valid[i], hh // 3], v[i, valid[i], hh // 3]
            p = torch.softmax(kk @ q[i, 0, hh] / 4.0, dim=0)
            torch.testing.assert_close(got[i, 0, hh], p @ vv, rtol=1e-12,
                                       atol=1e-12)


SPLIT_SHAPES = [
    # (b, kv, g, w, dtype): decode_heavy, prefill_heavy, glm4-9b, small
    (64, 8, 12, 4096, BF16), (8, 8, 12, 4096, BF16), (4, 2, 16, 256, BF16),
    (1, 8, 6, 4096, BF16), (1, 1, 1, 10, F32), (2, 2, 40, 64, F32),
    (65535, 1, 1, 1, BF16),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_count_is_a_function_of_the_shapes(shape):
    """The split count comes from the shapes alone (no data, no device):
    enough blocks for the card where W has the tiles, never more splits
    than tiles or MAX_SPLITS, never fewer than one."""
    b, kv, g, w, dtype = shape
    n = split_count(b, kv, g, w, dtype)
    assert n == split_count(b, kv, g, w, dtype)
    tiles = -(-w // dops.tile_keys(dtype))
    assert 1 <= n <= min(tiles, dops.MAX_SPLITS)
    blocks = b * kv * -(-g // dops.ROWS)
    assert blocks * n >= dops.TARGET_BLOCKS or n == min(tiles,
                                                        dops.MAX_SPLITS)
    assert n == 1 or blocks * (n - 1) < dops.TARGET_BLOCKS


# ---------------------------------------------------------------------------
# On the card: the kernel against the float64 attention
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def exact(q, k, v, cpos, pos, window):
    return decode_attention_ref(q.double(), k.double(), v.double(), cpos,
                                pos, window=window)


def held(got, want, dtype, what):
    err = float((got.double() - want).abs().max())
    bound = TOL[dtype] * max(1.0, float(want.abs().max()))
    assert math.isfinite(err) and err <= bound, (what, err, bound)


# (b, w, h, kv, dh, lengths, window, holes, future): every dh template
# and copy width, G 1 / 6 / 12 / 16 / 40, B 1 and 64, wrapped rings,
# empty and future slots, a row with one valid key, ragged lengths
CARD_CASES = {
    "g1_dh64_b1": (1, 64, 8, 8, 64, [40], 0, 0, 0),
    "g6_dh128_wrapped_window": (3, 256, 48, 8, 128, [700, 256, 90], 100, 0,
                                0),
    "g12_dh192_b64_ragged": (64, 1024, 96, 8, 192, "ragged", 0, 5, 3),
    "g16_dh256_one_key": (3, 130, 32, 2, 256, [1, 130, 77], 0, 0, 0),
    "g16_dh128_empty_slots": (4, 300, 32, 2, 128, [300, 12, 299, 150], 0,
                              40, 0),
    "g12_dh192_window_one_key": (2, 512, 24, 2, 192, [900, 3], 1, 0, 0),
    "g40_dh16_smoke": (2, 64, 40, 1, 16, [64, 9], 0, 2, 2),
    "g2_dh33_copy2": (2, 70, 4, 2, 33, [70, 5], 0, 3, 0),
    "g2_dh18_copy4": (2, 70, 4, 2, 18, [33, 70], 30, 0, 0),
    "g3_dh20_copy8": (2, 70, 6, 2, 20, [2, 69], 0, 0, 4),
}


def card_case(name, dtype, device, seed=0):
    b, w, h, kv, dh, lengths, window, holes, future = CARD_CASES[name]
    rng = np.random.default_rng(seed)
    if lengths == "ragged":                  # very different lengths
        lengths = [1, w, 2 * w + 17] + list(rng.integers(1, w, b - 3))
    q, k, v = operands(rng, b, w, h, kv, dh, dtype, device)
    cpos, pos = ring(rng, w, lengths, holes, future)
    return q, k, v, cpos.to(device), pos.to(device), window


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_float64_attention(cuda_device, name, dtype):
    q, k, v, cpos, pos, window = card_case(name, dtype, cuda_device)
    launches = decode_attention.launches
    got = decode_attention(q, k, v, cpos, pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == launches + 1
    b, _, h, dh = q.shape
    assert decode_attention.splits == split_count(
        b, k.shape[2], h // k.shape[2], k.shape[1], dtype)
    assert got.shape == q.shape and got.dtype == dtype
    held(got, exact(q, k, v, cpos, pos, window), dtype, name)
    again = decode_attention(q, k, v, cpos, pos, window=window)
    assert torch.equal(got, again)           # splits merge in a fixed order


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_kernel_at_the_served_decode_shape(cuda_device, dtype):
    """nemotron-4-340b's served decode: B 64 slots, W 4,096, KV 8, G 12,
    dh 192, log-normal lengths as the conversation mix's."""
    rng = np.random.default_rng(1)
    lengths = np.clip(rng.lognormal(math.log(1020), 0.5, 64), 2,
                      4095).astype(int)
    q, k, v = operands(rng, 64, 4096, 96, 8, 192, dtype, cuda_device)
    cpos, pos = (t.to(cuda_device) for t in ring(rng, 4096, lengths))
    got = decode_attention(q, k, v, cpos, pos)
    held(got, exact(q, k, v, cpos, pos, 0), dtype, "served shape")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_poisoned_invalid_slots_leave_the_output_unchanged(cuda_device,
                                                           dtype):
    """K and V of 1e6 in every invalid slot (empty, future, out of the
    window, past the row's length) change no output bit: those rows are
    never read."""
    b, w = 6, 700
    rng = np.random.default_rng(2)
    q, k, v = operands(rng, b, w, 24, 2, 192, dtype, cuda_device)
    cpos, pos = (t.to(cuda_device) for t in ring(
        rng, w, [1, 700, 1500, 64, 333, 9], holes=20, future=20))
    for window in (0, 50):
        got = decode_attention(q, k, v, cpos, pos, window=window)
        bad = ~valid_mask(cpos, pos, window)
        k2, v2 = k.clone(), v.clone()
        k2[bad], v2[bad] = 1e6, 1e6
        assert torch.equal(decode_attention(q, k2, v2, cpos, pos,
                                            window=window), got)
        held(got, exact(q, k, v, cpos, pos, window), dtype, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_row_with_no_valid_slot_gets_the_mean_of_v(cuda_device, dtype):
    """A row whose every slot is empty or ahead of it gets the plain
    version's answer: the softmax of W equal scores, the mean of v."""
    rng = np.random.default_rng(3)
    q, k, v = operands(rng, 2, 100, 8, 2, 64, dtype, cuda_device)
    cpos, pos = ring(rng, 100, [60, 1])
    cpos[1] = -1
    cpos[1, 7] = 5                           # ahead of position 0
    cpos, pos = cpos.to(cuda_device), pos.to(cuda_device)
    got = decode_attention(q, k, v, cpos, pos)
    want = exact(q, k, v, cpos, pos, 0)
    torch.testing.assert_close(want[1, 0, :4], v[1].double().mean(0)
                               .repeat_interleave(4, dim=0)[:4])
    held(got, want, dtype, "no valid slot")


@pytest.mark.gpu
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    """float64, int64 positions, a strided cache and W past the bitmap
    raise on the card; nothing runs the plain version instead."""
    rng = np.random.default_rng(4)
    q, k, v = operands(rng, 2, 64, 4, 2, 16, F32, cuda_device)
    cpos, pos = (t.to(cuda_device) for t in ring(rng, 64, [64, 3]))
    launches = decode_attention.launches
    with pytest.raises(ValueError):
        decode_attention(q.double(), k.double(), v.double(), cpos, pos)
    for cp, p in ((cpos.long(), pos), (cpos, pos.long())):
        with pytest.raises(ValueError, match="int32"):
            decode_attention(q, k, v, cp, p)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, k[:, ::2], v[:, ::2], cpos[:, ::2], pos)
    wide = torch.zeros((1, dops.MAX_W + 1, 1, 16), device=cuda_device)
    with pytest.raises(ValueError, match="W"):
        decode_attention(q[:1, :, :1], wide, wide,
                         torch.zeros((1, dops.MAX_W + 1), dtype=torch.int32,
                                     device=cuda_device), pos[:1])
    assert decode_attention.launches == launches


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["glm4-9b", "mixtral-8x22b", "hymba-1.5b"])
def test_decode_step_launches_the_kernel_once_a_layer(cuda_device, name):
    """A decode step on the card adds n_layers to
    ``decode_attention.launches``: one launch a layer, and its logits
    are finite."""
    from repro_torch.configs import SMOKES
    from repro_torch.models import lm
    cfg = SMOKES[name]
    params = lm.cast_weights_(cfg, lm.init_params(
        cfg, torch.Generator().manual_seed(0)).to(cuda_device))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20), dtype=np.int32)).to(cuda_device)
    with torch.inference_mode():
        _, cache = lm.prefill(cfg, params, toks, max_seq=48)
        launches = decode_attention.launches
        logits, _ = lm.decode_step(
            cfg, params, cache,
            torch.tensor([[1], [2]], dtype=torch.int32, device=cuda_device),
            torch.tensor([20, 20], dtype=torch.int32, device=cuda_device))
        torch.cuda.synchronize()
    assert decode_attention.launches == launches + cfg.n_layers
    assert bool(torch.isfinite(logits).all())
