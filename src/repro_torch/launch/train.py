"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \
      --smoke --steps 100 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt \
      [--device cpu]
  torchrun --nproc-per-node N -m repro_torch.launch.train --arch glm4-9b \
      --smoke --model-par M

The reference's flags (``repro/launch/train.py``) plus ``--device``. It
trains on the card unless ``--device cpu`` is given, and raises without
a card. With neither ``--model-par`` nor ``--production-mesh`` it trains
unplaced on one device. ``--model-par M`` places the parameters, the
optimizer's moments and the batches (``dist.shardings``) on a (world /
M, M) ("data", "model") mesh over the processes ``torchrun`` started (a
world of one without it); ``--production-mesh`` on the reference's
16 x 16 (``--multi-pod``: 2 x 16 x 16) layout, which needs 256 (512)
processes and raises on fewer. Every rank runs the same steps; rank 0
prints. ``--layers N`` keeps the first N layers of a full-width config.
``--smoke`` trains the reduced config; a full-size arch's
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
import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.tokens import lm_batch, sharded_batch
from repro_torch.device import resolve_device
from repro_torch.dist import shardings as sh
from repro_torch.models import lm
from repro_torch.train.loop import Trainer, init_state, make_train_step
from repro_torch.train.optim import AdamW
from repro_torch.train.schedules import warmup_cosine


def batches(cfg, batch: int, seq: int, seed: int, device, mesh=None):
    """The launcher's batch stream from step 0, on ``device``; with a
    mesh, each batch placed by ``batch_shardings`` (each rank copies its
    own rows)."""
    step = 0
    while True:
        toks, labels = lm_batch(cfg, batch, seq, seed, step)
        frames = (batch, seq // cfg.frontend_frames_div, cfg.d_model)
        if mesh is None:
            out = {"tokens": torch.from_numpy(toks).to(device),
                   "labels": torch.from_numpy(labels).to(device)}
            if cfg.is_encdec:
                out["enc_embeds"] = torch.zeros(frames, dtype=torch.bfloat16,
                                                device=device)
        else:
            host = {"tokens": toks, "labels": labels}
            if cfg.is_encdec:
                host["enc_embeds"] = np.zeros(frames, dtype=np.float32)
            out = sharded_batch(host, sh.batch_shardings(mesh, host))
            if cfg.is_encdec:
                out["enc_embeds"] = out["enc_embeds"].to(torch.bfloat16)
        step += 1
        yield out


def make_mesh(args, device):
    """The mesh the flags ask for; None with neither mesh flag."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    if args.production_mesh:
        return make_production_mesh(multi_pod=args.multi_pod, device=device)
    if args.model_par is not None:
        return make_host_mesh(model_par=args.model_par, device=device)
    return None


class Run(NamedTuple):
    """A launch ready to train: ``trainer.run(stream, steps, ...)``
    under ``shardings.use_mesh(mesh)`` (``mesh`` None when unplaced)."""
    cfg: Any
    mesh: Any
    trainer: Trainer
    stream: Iterator
    steps: int
    log_every: int
    log: Callable


def setup(argv=None) -> Run:
    """Parse the flags and build the launch: config, mesh, seeded (and
    placed) state, a Trainer (resumed from ``--ckpt-dir``) and the
    batch stream."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N decoder layers (a full-width "
                         "run cut to fit the devices)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", default="none",
                    choices=["none", "topk", "sign"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=None,
                    help="place on a (world / M, M) data x model mesh")
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 (or 2x16x16 with --multi-pod) mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "torch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh = make_mesh(args, dev)
    rank0 = mesh is None or torch.distributed.get_rank() == 0
    log = print if rank0 else (lambda *_: None)

    opt = AdamW(lr=warmup_cosine(args.lr, args.steps // 10, args.steps),
                weight_decay=0.01, grad_clip=1.0)
    step_fn = make_train_step(cfg, opt, compress=args.compress,
                              grad_accum=args.grad_accum)
    with sh.use_mesh(mesh):
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(args.seed))
        if mesh is not None:
            sh.place_params(mesh, params)
        state = init_state(cfg, opt, params=params, compress=args.compress)
        trainer = Trainer(step_fn, state, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every)
    return Run(cfg, mesh, trainer,
               batches(cfg, args.batch, args.seq, args.seed, dev, mesh),
               args.steps, args.log_every, log)


def main(argv=None):
    run = setup(argv)
    with sh.use_mesh(run.mesh):
        last = run.trainer.run(run.stream, run.steps,
                               log_every=run.log_every, log_fn=run.log)
    run.log(f"done: final {last}")
    return last


if __name__ == "__main__":
    main()
