"""Serving launcher: compiled fixed-function logic classification.

  # JSC-S through the mapped 6-LUT netlist on the card, streamed kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --mode logic \\
      --backend bitplane --engine cuda-streamed

  # the same on the CPU, through the kernels' plain torch versions
  PYTHONPATH=src python -m repro_torch.launch.serve --mode logic \\
      --backend bitplane --engine cuda --device cpu

  # train JSC-S for 20 steps on the CPU first, then serve it there
  PYTHONPATH=src python -m repro_torch.launch.serve --mode logic \\
      --train-steps 20 --device cpu

As the reference launcher does, the model is first trained with QAT +
FCP (``train_jsc``, ``--train-steps``, default 400, from a
``torch.Generator`` seeded with ``--seed``; ``--train-steps 0`` gives
the seeded init projected to its fanin budget), on the same device as
the serving; or it is loaded from weights saved with
``repro_torch.weights.save_params_npz`` (``--params``). It is compiled
to truth tables on the host, synthesized to a mapped netlist for
``--backend bitplane``, and serves ``--requests`` requests of 64 rows
of the JSC test split through ``LogicEngine.serve_queue``. The launcher
prints the test accuracy after training, the mapped LUT count and
depth, the served accuracy, p50/p95 latency and each kernel's launches
during serving.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serving.engine import BACKENDS

ROWS_PER_REQUEST = 64


def serve_logic(jsc_name: str = "jsc-s", n_requests: int = 8,
                backend: str = "gather", engine: Optional[str] = None,
                params: Optional[str] = None, train_steps: int = 400,
                seed: int = 0, device=None) -> dict:
    from repro_torch.configs.jsc import JSC
    from repro_torch.data.jsc import train_test
    from repro_torch.kernels import launch_counts
    from repro_torch.models.mlp import to_logic
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.train.jsc_trainer import train_jsc
    from repro_torch.weights import load_params_npz

    dev = resolve_device(device)
    cfg = JSC[jsc_name]
    out = {}
    if params:
        print(f"[serve] loading {jsc_name} weights from {params}")
        model = load_params_npz(params)
    else:
        print(f"[serve] training {jsc_name} with QAT+FCP ({train_steps} "
              f"steps, seed {seed}, device {dev})")
        res = train_jsc(cfg, steps=train_steps, seed=seed, device=dev)
        print(f"  test acc: {res.test_acc:.4f} (float reference "
              f"{res.float_test_acc:.4f}); {res.steps} steps in "
              f"{res.seconds['qat']:.2f}s")
        model = res.model
        out["test_acc"] = res.test_acc
    print("[serve] compiling to fixed-function logic ...")
    net = to_logic(cfg, model)
    eng = LogicEngine(net, cfg.n_classes, backend=backend, engine=engine,
                      device=dev)
    if backend == "bitplane":
        print(f"  mapped: {eng.bitnet.mapped.n_luts} LUTs, "
              f"depth {eng.bitnet.mapped.depth} (engine {eng.engine}, "
              f"device {dev})")
    (_, _), (xte, yte) = train_test()
    reqs = [xte[i * ROWS_PER_REQUEST: (i + 1) * ROWS_PER_REQUEST]
            for i in range(n_requests)]
    before = launch_counts()
    results, stats = eng.serve_queue(reqs)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    acc = float(np.mean(np.concatenate(results)
                        == yte[: sum(len(r) for r in reqs)]))
    print(f"[serve] {n_requests} requests: acc={acc:.4f} "
          f"p50={stats['p50_us']:.1f}us p95={stats['p95_us']:.1f}us")
    print("[serve] kernel launches: " + ", ".join(
        f"{k}={v}" for k, v in launches.items()))
    return {**stats, **out, "acc": acc, "launches": launches}


def main(argv=None):
    from repro_torch.synth.executors import names as engine_names

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", choices=["logic"], default="logic")
    ap.add_argument("--jsc", default="jsc-s",
                    choices=["jsc-s", "jsc-m", "jsc-l"])
    ap.add_argument("--backend", choices=list(BACKENDS), default="gather",
                    help="logic inference path (bitplane = mapped netlist)")
    ap.add_argument("--engine", choices=list(engine_names()),
                    default=None,
                    help="bitplane netlist executor: host fold (numpy), "
                         "monolithic lut_eval kernel (cuda) or streamed "
                         "kernel (cuda-streamed); default cuda-streamed "
                         "on a CUDA device, numpy on the CPU")
    ap.add_argument("--requests", type=int, default=8,
                    help=f"requests of {ROWS_PER_REQUEST} rows to serve")
    ap.add_argument("--train-steps", type=int, default=400,
                    help="QAT + FCP training steps before compiling "
                         "(fine-tune of a fifth of them after)")
    ap.add_argument("--params", default=None, metavar="NPZ",
                    help="weights saved by repro_torch.weights."
                         "save_params_npz, served instead of training")
    ap.add_argument("--seed", type=int, default=0,
                    help="training seed (init and batches)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    return serve_logic(args.jsc, args.requests, backend=args.backend,
                       engine=args.engine, params=args.params,
                       train_steps=args.train_steps, seed=args.seed,
                       device=args.device)


if __name__ == "__main__":
    main()
