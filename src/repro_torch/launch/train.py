"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --steps 100 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \
      [--device cpu]

The reference's flags (``repro/launch/train.py``) but its mesh flags
(``--model-par``, ``--production-mesh``, ``--multi-pod``: placement over
several devices waits for the multi-device slice), plus ``--device``. It
trains on the card unless ``--device cpu`` is given, and raises without
a card. ``--smoke`` trains the reduced config; a full-size arch's
float32 parameters, gradients and AdamW moments take 16 bytes a
parameter (150 GB for glm4-9b), more than one card holds. AdamW with a
warmup-cosine schedule (a tenth of the steps warm), weight decay 0.01
and clip 1.0, from parameters seeded with ``--seed``; batches of the
synthetic token stream in (seed, step); the encoder-decoder family gets
zero ``enc_embeds`` of seq / frontend_frames_div frames, as the
reference feeds it. Rerun with the same ``--ckpt-dir`` to resume.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import lm_batch
from repro_torch.device import resolve_device
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW
from repro_torch.train.schedules import warmup_cosine


def batches(cfg, batch: int, seq: int, seed: int, device):
    """The launcher's batch stream from step 0, on ``device``."""
    step = 0
    while True:
        toks, labels = lm_batch(cfg, batch, seq, seed, step)
        out = {"tokens": torch.from_numpy(toks).to(device),
               "labels": torch.from_numpy(labels).to(device)}
        if cfg.is_encdec:
            out["enc_embeds"] = torch.zeros(
                (batch, seq // cfg.frontend_frames_div, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        step += 1
        yield out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "sign"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "torch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)

    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps),
                weight_decay=0.01, grad_clip=1.0)
    step_fn = make_train_step(cfg, opt, compress=args.compress,
                              grad_accum=args.grad_accum)
    state = init_state(cfg, opt, torch.Generator(device=dev)
                       .manual_seed(args.seed), compress=args.compress)
    trainer = Trainer(step_fn, state, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    last = trainer.run(batches(cfg, args.batch, args.seq, args.seed, dev),
                       args.steps, log_every=args.log_every)
    print(f"done: final {last}")
    return last


if __name__ == "__main__":
    main()
