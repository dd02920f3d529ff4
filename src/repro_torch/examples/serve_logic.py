"""End-to-end serving example (the paper's deployment scenario).

Trains the JSC demo classifier, compiles it to fixed-function logic,
and serves batched classification requests through the LogicEngine
with latency percentiles, on the plain table gather (``gather``) and
on the lut_layer kernel (``lut_layer``; the reference's Pallas path).

  PYTHONPATH=src python -m repro_torch.examples.serve_logic [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.configs.jsc import JSC_DEMO
from repro_torch.data.jsc import train_test
from repro_torch.device import resolve_device
from repro_torch.models.mlp import to_logic
from repro_torch.serving.engine import LogicEngine
from repro_torch.train.jsc_trainer import train_jsc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_logic")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = JSC_DEMO
    data = train_test(8000, 2000, seed=0)

    print("training + compiling ...")
    res = train_jsc(cfg, steps=500, data=data, device=dev)
    net = to_logic(cfg, res.model)

    for backend in ("gather", "lut_layer"):
        eng = LogicEngine(net, cfg.n_classes, max_batch=256,
                          backend=backend, device=dev)
        xte, yte = data[1]
        requests = [xte[i * 128: (i + 1) * 128] for i in range(12)]
        results, stats = eng.serve_queue(requests)
        acc = float(np.mean(np.concatenate(results) == yte[: 12 * 128]))
        print(f"[{backend:9s}] 12 requests x128: acc={acc:.4f} "
              f"p50={stats['p50_us']:.0f}us p95={stats['p95_us']:.0f}us")


if __name__ == "__main__":
    main()
