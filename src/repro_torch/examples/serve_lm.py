"""Continuous-batching LM serving on a smoke config: prefill + slot pool
+ per-tick decode, the twin of the reference's ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Serves hymba-1.5b's smoke config (hybrid attention + SSM, ring cache),
10 requests of 8 to 31 tokens, 12 new tokens each, from weights seeded
with 0. It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import device_info, resolve_device
from repro_torch.models import lm
from repro_torch.serving.engine import LMEngine, LMRequest


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_arch("hymba-1.5b", smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    eng = LMEngine(cfg, params, n_slots=4, max_seq=160, device=dev)

    rng = np.random.default_rng(0)
    reqs = [LMRequest(prompt=rng.integers(0, cfg.vocab_size,
                                          rng.integers(8, 32),
                                          dtype=np.int32),
                      max_new_tokens=12) for _ in range(10)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests / {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s on {device_info(dev)['device']})")
    for i, r in enumerate(done[:3]):
        print(f"  req{i}: prompt_len={len(r.prompt)} -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
