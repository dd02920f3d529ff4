"""The flash backward's time on the card at the training path's shapes,
beside SDPA's backward, for this checkout or another one.

For each shape (``full``: glm4-9b's training shape, B 4, S 1,024, H 32,
KV 2, dh 128, causal, bf16; ``tp``: its tensor-parallel local shape,
H 16, KV 1): the backward's CUDA-event ms a call (back to back), the
profiler's device µs a call, whole and by kernel, SDPA's backward alone
(``torch.autograd.grad`` of one forward: the same gradients) the same
two ways, and SDPA's forward and backward together on the device. SDPA
is the yardstick only; the port never calls it. ``pass_bytes`` gives
the least bytes of the wgmma branch's first and last passes (its float32
workspace included) and their time at the card's memory rate.

``--src DIR`` imports the kernel package from another checkout's
``src`` (a ``git archive`` of the parent under ``build/``), so two
designs are timed on one card in one call; the profiling helper is this
checkout's.

    python src/repro_torch/bench/flash_backward.py [--src DIR]
        [--shapes full,tp]

prints one JSON object. Needs the card. ``chip_smoke.py`` runs it in a
process of its own for its device numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = {"full": (4, 1024, 1024, 32, 2, 128),
          "tp": (4, 1024, 1024, 16, 1, 128)}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
OWN_SRC = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))


def pass_bytes(b, sq, sk, h, kv, dh) -> dict:
    """Least bytes of the wgmma branch's prep pass (out and dout and lse
    read; lse2 and D written; the float32 dQ accumulator zeroed) and its
    finish pass (the accumulator and the G / HB float32 dK and dV
    partials read; dq, dk and dv written in bf16), and the µs each takes
    at HBM_BYTES_PER_S."""
    g = h // kv
    slices = g // 2 if g % 2 == 0 else g
    rows = b * h * -(-sq // 64) * 64
    acc = rows * dh * 4
    parts = 2 * slices * b * kv * -(-sk // 64) * 64 * dh * 4
    prep = 2 * b * sq * h * dh * 2 + b * h * sq * 4 + rows * 2 * 4 + acc
    finish = acc + parts + b * sq * h * dh * 2 + 2 * b * sk * kv * dh * 2
    return {"slices": slices, "prep": prep, "finish": finish,
            "partials": parts, "dq_accumulator": acc,
            "prep_us": prep / HBM_BYTES_PER_S * 1e6,
            "finish_us": finish / HBM_BYTES_PER_S * 1e6}


def events_ms(torch, fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(device_time, shapes=("full", "tp")) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)
    if not torch.cuda.is_available():
        raise RuntimeError("the flash backward bench needs the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    out = {"card": smi.stdout.strip().splitlines()[0] if smi.stdout else
           torch.cuda.get_device_name(0),
           "torch": torch.__version__, "shapes": {}}
    for name in shapes:
        b, sq, sk, h, kv, dh = SHAPES[name]
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, dout = (torch.randn(s, generator=g, device="cuda")
                         .to(torch.bfloat16) for s in (
                             (b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                             (b, sq, h, dh)))
        o, lse = flash_attention_forward(q, k, v, causal=True)
        bwd = lambda: flash_attention_backward(  # noqa: E731
            q, k, v, o, dout, lse, causal=True)
        ms = events_ms(torch, bwd)        # events first, then the profiler
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        so = sdpa()
        dt = dout.transpose(1, 2).contiguous()
        sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
            so, (qt, kt, vt), dt, retain_graph=True)
        sdpa_both = lambda: torch.autograd.grad(  # noqa: E731
            sdpa(), (qt, kt, vt), dt)
        sdpa_ms = events_ms(torch, sdpa_bwd)
        mine, alone = device_time(bwd, "flash_bwd"), device_time(sdpa_bwd)
        out["shapes"][name] = {
            "shape": [b, sq, sk, h, kv, dh], "ms": ms,
            "device_us": mine.call_us, "kernels_us": mine.kernels,
            "pass_bytes": pass_bytes(b, sq, sk, h, kv, dh),
            "sdpa_bwd_ms": sdpa_ms,
            "sdpa_bwd_device_us": alone.call_us,
            "sdpa_bwd_kernels_us": alone.kernels,
            "sdpa_fwd_bwd_device_us": device_time(sdpa_both).call_us}
        del q, k, v, dout, o, lse, qt, kt, vt, so, dt
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flash_backward.py")
    ap.add_argument("--src", default=OWN_SRC)
    ap.add_argument("--shapes", default="full,tp")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, OWN_SRC)
    from repro_torch.bench.profiled import device_time
    if src != OWN_SRC:
        # the kernels from the other checkout's package, not this one's
        for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[m]
        sys.path.insert(0, src)
    res = run(device_time, tuple(args.shapes.split(",")))
    res["src"] = src
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
