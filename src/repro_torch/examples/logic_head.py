"""Convert an LM's classification head to fixed-function logic, the twin
of the reference's ``examples/logic_head.py``.

Pools hidden states from the hymba smoke backbone, trains a
fanin-constrained quantized MLP head on a synthetic 4-class task,
compiles the head to truth tables, verifies bit-exactness, and prices
it in LUTs.

  PYTHONPATH=src python -m repro_torch.examples.logic_head [--device cpu]

It runs on the card unless ``--device cpu`` is given. On the card the
backbone's prefill attention is the flash kernel and the logic network
runs on the lut_layer kernel; on the CPU both are their plain versions.
The backbone's weights are seeded with 0 from a ``torch.Generator``,
whose stream differs from ``jax.random``'s, so the features, and with
them the head's accuracy and LUT count, are not the reference's run's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core.logic_infer import hardware_report
from repro_torch.device import device_info, resolve_device
from repro_torch.models import lm
from repro_torch.models.mlp import MLPConfig, mlp_forward, to_logic
from repro_torch.train.jsc_trainer import train_jsc

N_TRAIN, N_TEST, S = 3000, 800, 32
BATCH = 250          # sequences a forward
N_CHECK = 512        # test rows held bit for bit
CLASSES = 4

# The reference's example on the CPU (jax 0.9.0, its seed-0 weights).
# The twin's seeded weights are other weights, so a run is held to it
# within bands, read from the twin's CPU runs over backbone seeds 0-5
# (test accuracy 0.6213-0.6750, 326-336 LUTs) and on the reference's own
# weights and head init (0.6938, 328 LUTs: the features part in their
# bf16 roundings and 500 steps carry that apart). The FFs are the
# head's output bits, so they are equal.
REFERENCE_RUN = {"test_acc": 0.7037, "luts": 336, "ffs": 84}
ACC_BAND = 0.12      # |test accuracy - the reference's|
LUT_BAND = 0.05      # |LUTs - the reference's| / the reference's


def within_reference_bands(out: dict) -> bool:
    """Whether a run's accuracy, LUTs and FFs are the reference run's,
    within the bands above."""
    ref = REFERENCE_RUN
    return (abs(out["test_acc"] - ref["test_acc"]) <= ACC_BAND
            and abs(out["luts"] - ref["luts"]) <= LUT_BAND * ref["luts"]
            and out["ffs"] == ref["ffs"])


def head_config(n_inputs: int) -> MLPConfig:
    return MLPConfig(
        name="lm-head", n_inputs=n_inputs,
        features=(24, 12, 4), fanins=(4, 4, 4),
        act_bits=(2, 2, 3), in_bits=2, n_classes=CLASSES, alpha=1.0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def pooled_features(cfg: ArchConfig, params: lm.Params,
                    tokens: np.ndarray) -> np.ndarray:
    """Mean over the sequence of ``lm.forward``'s hidden states (in the
    compute type, as the reference's ``jnp.mean``), float32 (N, D), in
    forwards of BATCH sequences on the parameters' device."""
    dev = params["embed"].device
    out = []
    for i in range(0, len(tokens), BATCH):
        hidden, _, _ = lm.forward(
            cfg, params, tokens=torch.from_numpy(tokens[i:i + BATCH]).to(dev))
        out.append(hidden.mean(dim=1).float().cpu().numpy())
    return np.concatenate(out)


def standardise_and_label(feats: np.ndarray):
    """Features standardised per column, and the labels of the seeded
    linear teacher over them."""
    feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-6)
    teacher = np.random.default_rng(7).normal(size=(feats.shape[1], CLASSES))
    return feats, (feats @ teacher).argmax(-1).astype(np.int32)


def run(cfg: ArchConfig, params: lm.Params, n_train: int = N_TRAIN,
        n_test: int = N_TEST, seq: int = S, steps: int = 500,
        log=print) -> dict:
    """The example on ``params``' device: features, the head's training
    (``train_jsc``'s seeded init), its logic network and its hardware
    report."""
    dev = params["embed"].device
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (n_train + n_test, seq),
                          dtype=np.int32)
    log("1) extracting pooled LM features ...")
    _sync(dev)
    t0 = time.perf_counter()
    feats = pooled_features(cfg, params, tokens)
    _sync(dev)
    feat_s = time.perf_counter() - t0
    feats, labels = standardise_and_label(feats)

    head = head_config(feats.shape[1])
    log("2) QAT+FCP training of the head ...")
    data = ((feats[:n_train], labels[:n_train]),
            (feats[n_train:], labels[n_train:]))
    res = train_jsc(head, steps=steps, data=data, device=dev)
    log(f"   head test acc: {res.test_acc:.4f} "
        f"(float ref {res.float_test_acc:.4f}, chance 0.25)")

    log("3) compiling the head to combinational logic ...")
    net = to_logic(head, res.model)
    x = torch.from_numpy(feats[n_train:n_train + N_CHECK]).to(dev)
    pred_head = torch.argmax(mlp_forward(head, res.model, x)[:, :CLASSES], -1)
    pred_logic = torch.argmax(net(x, use_kernel=True)[:, :CLASSES], -1)
    bit_exact = bool(torch.equal(pred_head, pred_logic))
    log(f"   bit-exact: {'OK' if bit_exact else 'FAILED'}")

    rep, _ = hardware_report(net)
    latency_ns = (head.n_layers + 1) * 1e3 / rep.fmax_mhz
    log(f"4) hardware: {rep.luts} LUTs, {rep.ffs} FFs, "
        f"fmax {rep.fmax_mhz:.0f} MHz -> {latency_ns:.1f} ns latency")
    return {"features": feats, "labels": labels, "result": res, "net": net,
            "bit_exact": bit_exact, "features_s": feat_s,
            "features_per_s": len(tokens) / feat_s,
            "test_acc": res.test_acc, "float_test_acc": res.float_test_acc,
            "luts": rep.luts, "ffs": rep.ffs, "fmax_mhz": rep.fmax_mhz,
            "latency_ns": latency_ns}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.logic_head")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_arch("hymba-1.5b", smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    out = run(cfg, params)
    print(f"   features: {out['features_per_s']:.1f} sequences/s on "
          f"{device_info(dev)['device']}")
    if not out["bit_exact"]:
        raise SystemExit("the logic network diverged from the head")
    return out


if __name__ == "__main__":
    main()
