"""The paper's technique inside an LM: QAT + FCP as config knobs on a
transformer, trained end to end with the fault-tolerant Trainer
(checkpoint + resume + straggler watchdog), the twin of the reference's
``examples/train_lm_qat.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_qat [--device cpu]

nemotron-4-340b's smoke config with 4-bit PACT activations and 4-bit
DoReFa weights (its squared-ReLU MLP is non-negative, so the paper's
activation-selection rule picks PACT), 150 steps at batch 8 x 128
tokens, then the float baseline on the same batches. It runs on the
card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.train import batches
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW
from repro_torch.train.schedules import warmup_cosine

STEPS = 150


def qat_config():
    return dataclasses.replace(
        get_arch("nemotron-4-340b", smoke=True),
        quant_bits=4,       # PACT 4-bit activations inside the MLP
        quant_weights=4,    # DoReFa 4-bit weights
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm_qat")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps = args.steps
    cfg = qat_config()
    print(f"config: {cfg.name} quant_bits={cfg.quant_bits} "
          f"quant_weights={cfg.quant_weights} act={cfg.act}")

    opt = AdamW(lr=warmup_cosine(1e-3, steps // 10, steps), weight_decay=0.01)
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(make_train_step(cfg, opt), state,
                          ckpt_dir=ckpt_dir, ckpt_every=50)
        final = trainer.run(batches(cfg, 8, 128, 0, dev), steps,
                            log_every=max(1, steps // 6))
    print(f"trained {steps} steps with 4-bit QAT; final loss "
          f"{final['loss']:.3f}")

    # float baseline for comparison
    cfg_f = dataclasses.replace(cfg, quant_bits=0, quant_weights=0)
    state_f = init_state(cfg_f, opt, torch.Generator(device=dev)
                         .manual_seed(0))
    final_f = Trainer(make_train_step(cfg_f, opt), state_f).run(
        batches(cfg_f, 8, 128, 0, dev), steps, log_every=steps,
        log_fn=lambda *_: None)
    print(f"float baseline loss {final_f['loss']:.3f} "
          f"(QAT gap: {final['loss'] - final_f['loss']:+.3f})")
    return {"qat": final, "float": final_f}


if __name__ == "__main__":
    main()
