"""Bit-parallel AIG simulation and simulation-based equivalence checking.

Samples are packed 32 per uint32 lane, so one AND node evaluation is a
single bitwise op over a word vector — random simulation of thousands of
patterns costs one numpy pass over the node list, or, with
``use_kernel=True``, one launch of the streamed lut_eval kernel on the
card (``repro_torch.kernels.aig_sim.aig_sim``; the reference's
``use_pallas=True``).

Equivalence checks come in two strengths:
  * ``exhaustive_equiv`` — all 2^n input patterns (n <= 16), a proof;
  * ``random_equiv`` — Monte-Carlo over packed random words, the
    fast-and-overwhelming check used for whole-network pipelines where
    exhaustive enumeration is infeasible (a single 32-lane word already
    tests 32 patterns per node pass).
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import DeviceLike

from .aig import AIG, lit_compl, lit_var

WORD_BITS = 32


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """(n, B) {0,1} -> (n, ceil(B/32)) uint32, sample s in bit s%32 of
    word s//32."""
    bits = np.asarray(bits).astype(np.uint32)
    n, b = bits.shape
    pad = (-b) % WORD_BITS
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((n, pad), np.uint32)], axis=1)
    lanes = bits.reshape(n, -1, WORD_BITS)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return np.bitwise_or.reduce(lanes << shifts, axis=2).astype(np.uint32)


def unpack_bits(words: np.ndarray, n_samples: int) -> np.ndarray:
    """Inverse of ``pack_bits``: (n, W) uint32 -> (n, n_samples) uint8."""
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    bits = (words[:, :, None] >> shifts) & np.uint32(1)
    return bits.reshape(words.shape[0], -1)[:, :n_samples].astype(np.uint8)


def input_patterns(n_vars: int) -> np.ndarray:
    """Packed exhaustive patterns: row v holds variable v over all 2^n
    minterms (minterm index little-endian in the variables)."""
    assert n_vars <= 16
    idx = np.arange(1 << n_vars, dtype=np.uint32)
    bits = np.stack([(idx >> v) & 1 for v in range(n_vars)])
    return pack_bits(bits)


def simulate(aig: AIG, pi_words: np.ndarray, use_kernel: bool = False,
             device: DeviceLike = None) -> np.ndarray:
    """Evaluate all outputs on packed input words.

    pi_words: (n_pis, W) uint32 -> (n_outputs, W) uint32. With
    ``use_kernel`` the node values come from the device route (the card
    unless ``device="cpu"``, where the kernel's plain version runs);
    otherwise from the numpy walk, and ``device`` is not used.
    """
    pi_words = np.ascontiguousarray(pi_words, np.uint32)
    assert pi_words.shape[0] == aig.n_pis
    if use_kernel:
        vals = _simulate_kernel(aig, pi_words, device)
    else:
        vals = _simulate_np(aig, pi_words)
    out = np.empty((len(aig.outputs), pi_words.shape[1]), np.uint32)
    for i, o in enumerate(aig.outputs):
        v = vals[lit_var(o)]
        out[i] = ~v if lit_compl(o) else v
    return out


def _simulate_np(aig: AIG, pi_words: np.ndarray) -> np.ndarray:
    n, w = aig.n_nodes, pi_words.shape[1]
    vals = np.zeros((n, w), np.uint32)
    vals[1: aig.n_pis + 1] = pi_words
    for node in range(aig.n_pis + 1, n):
        f0, f1 = aig.fanins(node)
        v0 = vals[lit_var(f0)]
        v1 = vals[lit_var(f1)]
        if lit_compl(f0):
            v0 = ~v0
        if lit_compl(f1):
            v1 = ~v1
        vals[node] = v0 & v1
    return vals


def _simulate_kernel(aig: AIG, pi_words: np.ndarray,
                     device: DeviceLike) -> np.ndarray:
    from repro_torch.kernels.aig_sim import aig_sim
    f0, f1 = aig.fanin_arrays()
    return aig_sim(pi_words, f0, f1, aig.n_pis, device=device)


def random_words(n_rows: int, n_words: int,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << WORD_BITS, (n_rows, n_words),
                        dtype=np.uint32)


def random_equiv(a: AIG, b: AIG, n_words: int = 64, seed: int = 0,
                 use_kernel: bool = False, device: DeviceLike = None) -> bool:
    """Monte-Carlo equivalence of two AIGs over the same PIs: 32*n_words
    random patterns. A miscompare is a proof of inequivalence; agreement
    is evidence (standard random-simulation filter). ``use_kernel`` and
    ``device`` as in ``simulate``."""
    assert a.n_pis == b.n_pis and len(a.outputs) == len(b.outputs)
    words = random_words(a.n_pis, n_words, seed)
    return bool(np.array_equal(
        simulate(a, words, use_kernel=use_kernel, device=device),
        simulate(b, words, use_kernel=use_kernel, device=device)))


def exhaustive_equiv(aig: AIG, tts) -> bool:
    """Prove each output equals the given truth table (python ints, bit r
    = minterm r) by exhaustive packed simulation. PIs <= 16."""
    n = aig.n_pis
    got = simulate(aig, input_patterns(n))
    bits = unpack_bits(got, 1 << n)
    for row, tt in zip(bits, tts):
        want = np.array([(tt >> r) & 1 for r in range(1 << n)], np.uint8)
        if not np.array_equal(row, want):
            return False
    return True
