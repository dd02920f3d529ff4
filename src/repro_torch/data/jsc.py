"""Synthetic jet-substructure-classification (JSC) dataset.

The real hls4ml/OpenML JSC data (16 HL features, 5 jet classes) is not
available offline; this generator produces a statistically similar task:
5 Gaussian class-conditional clusters in R^16 with anisotropic covariance
and controlled overlap, standardised to zero-mean/unit-variance features
(the real dataset is also standardised before QAT). Class overlap +
label noise are tuned so a strong (QDA) model tops out at ~77%, matching
the headroom structure of the published task (paper accuracies:
69.65–73.35% with LogicNets baselines 1.5–1.9 points lower).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

N_FEATURES = 16
N_CLASSES = 5


def make_jsc(n: int, seed: int = 0, spread: float = 0.5,
             label_noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n,16) float32 standardized, y (n,) int32)."""
    rng = np.random.default_rng(seed)
    # fixed class geometry (same for any seed -> train/test consistency)
    geo = np.random.default_rng(1234)
    means = geo.normal(size=(N_CLASSES, N_FEATURES)) * spread
    # anisotropic covariances via random rotations of diag scales
    covs = []
    for _ in range(N_CLASSES):
        q, _ = np.linalg.qr(geo.normal(size=(N_FEATURES, N_FEATURES)))
        scales = geo.uniform(0.5, 2.0, N_FEATURES)
        covs.append((q * scales) @ q.T)
    y = rng.integers(0, N_CLASSES, n)
    x = np.empty((n, N_FEATURES), np.float64)
    for c in range(N_CLASSES):
        idx = np.nonzero(y == c)[0]
        z = rng.normal(size=(len(idx), N_FEATURES))
        chol = np.linalg.cholesky(
            covs[c] + 1e-6 * np.eye(N_FEATURES))
        x[idx] = means[c] + z @ chol.T
    # standardise with FIXED stats (population level) so train/test agree
    x = (x - means.mean(0)) / x.std(0)
    if label_noise > 0:  # irreducible error, like the physical task
        flip = rng.random(n) < label_noise
        y = np.where(flip, rng.integers(0, N_CLASSES, n), y)
    return x.astype(np.float32), y.astype(np.int32)


def train_test(n_train: int = 20000, n_test: int = 5000,
               seed: int = 0):
    xtr, ytr = make_jsc(n_train, seed=seed)
    xte, yte = make_jsc(n_test, seed=seed + 1)
    return (xtr, ytr), (xte, yte)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Infinite shuffled batch iterator."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sl = perm[i: i + batch_size]
            yield x[sl], y[sl]
