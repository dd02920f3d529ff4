"""The flash kernels' times on the card at the LM paths' shapes, beside
SDPA's, for this checkout or another one.

Shapes (causal, bf16): ``full``, glm4-9b's training shape, B 4, S 1,024,
H 32, KV 2, dh 128; ``tp``, its tensor-parallel local shape, H 16, KV
1; ``prefill``, glm4-9b's served prefill, B 1, S 32; ``nemotron``,
nemotron-4-340b's train_4k attention, B 1, S 4,096, H 96, KV 8, dh 192;
``nemotron_prefill``, its served prefill, B 1, S 32. For each shape the
forward's CUDA-event ms a call (back to back) and the profiler's device
µs a launch, without and with its log-sum-exp, and SDPA's forward's
device µs a call. For each shape of ``--shapes`` also the backward's
ms a call, its device µs a call, whole and by kernel, SDPA's backward
alone (``torch.autograd.grad`` of one forward: the same gradients) the
same two ways, and SDPA's forward and backward together on the device.
SDPA is the yardstick only; the port never calls it. ``pass_bytes``
gives the least bytes of the dh 64 / 128 wgmma branch's first and last
passes (its float32 workspace included) and their time at the card's
memory rate (null at other widths). A forward's device time counts the
one kernel it launches, of either branch.

``--src DIR`` imports the kernel package from another checkout's
``src`` (a ``git archive`` of the parent under ``build/``), so two
designs are timed on one card in one call; the profiling helper is this
checkout's.

    python src/repro_torch/bench/flash_backward.py [--src DIR]
        [--shapes full,tp] [--forward-shapes prefill,...]

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
          "tp": (4, 1024, 1024, 16, 1, 128),
          "prefill": (1, 32, 32, 32, 2, 128),
          "nemotron": (1, 4096, 4096, 96, 8, 192),
          "nemotron_prefill": (1, 32, 32, 96, 8, 192)}
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


def forward_times(torch, device_time, q, k, v) -> dict:
    """The forward's ms and device µs a launch without and with its
    log-sum-exp, and SDPA's forward's device µs a call."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_forward)
    with torch.no_grad():
        serve = lambda: flash_attention(q, k, v, causal=True)  # noqa: E731
        train = lambda: flash_attention_forward(  # noqa: E731
            q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        return {"fwd_ms": events_ms(torch, serve),
                "fwd_lse_ms": events_ms(torch, train),
                "fwd_device_us": device_time(serve, "flash_").launch_us,
                "fwd_lse_device_us": device_time(train, "flash_").launch_us,
                "sdpa_fwd_device_us": device_time(sdpa).call_us}


def operands(torch, b, sq, sk, h, kv, dh):
    g = torch.Generator(device="cuda").manual_seed(0)
    return tuple(torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                 for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh),
                           (b, sq, h, dh)))


def run(device_time, shapes=("full", "tp"), forward_shapes=()) -> dict:
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
           "torch": torch.__version__, "shapes": {}, "forward": {}}
    for name in forward_shapes:
        b, sq, sk, h, kv, dh = SHAPES[name]
        q, k, v, _ = operands(torch, b, sq, sk, h, kv, dh)
        out["forward"][name] = {"shape": [b, sq, sk, h, kv, dh],
                                **forward_times(torch, device_time, q, k, v)}
        del q, k, v
    for name in shapes:
        b, sq, sk, h, kv, dh = SHAPES[name]
        q, k, v, dout = operands(torch, b, sq, sk, h, kv, dh)
        fwd = forward_times(torch, device_time, q, k, v)
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
            "pass_bytes": (pass_bytes(b, sq, sk, h, kv, dh)
                           if dh in (64, 128) else None), **fwd,
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
    ap.add_argument("--forward-shapes", default="")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, OWN_SRC)
    from repro_torch.bench.profiled import device_time
    if src != OWN_SRC:
        # the kernels from the other checkout's package, not this one's
        for m in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[m]
        sys.path.insert(0, src)
    split = lambda a: tuple(n for n in a.split(",") if n)  # noqa: E731
    res = run(device_time, split(args.shapes), split(args.forward_shapes))
    res["src"] = src
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
