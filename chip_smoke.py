#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card     — ``nvidia-smi`` name and power limit, torch's device name;
  2. build    — compiles ``src/repro_torch/csrc/*.cu`` with nvcc for
                sm_90a (seconds, and each kernel's registers);
  3. kernels  — every kernel against its plain torch version on the
                card, bit for bit (``torch.equal``): lut_layer on JSC-S
                layer shapes and a ragged sweep, both lut_eval kernels
                on random mapped netlists (W in {1, 7, 130}, tile_rows in
                {8, 32}, the constant network, and a ~2,000-LUT,
                depth-12 netlist);
  4. serve    — the port's main path: a seeded full-width JSC-S is
                compiled to truth tables and a mapped 6-LUT netlist and
                serves 8 requests of 64 test rows through
                ``LogicEngine.serve_queue`` on bitplane (its default
                engine on the card, cuda-streamed), bitplane/cuda and
                lut_layer. Each run's serving starts with every
                kernel's launch count at 0 and must launch its kernel;
                its labels must equal the CPU gather path's and the
                float MLP's argmax, and its input codes on the card the
                CPU's;
  5. timing   — each kernel at the shapes the served batch gave it,
                held bit for bit against its plain version on those
                inputs, then timed beside it and its bound;
  6. profile  — one served batch per engine split into the stages of
                ``LogicEngine.stages`` (host clock) and the device's busy
                share (``torch.profiler``).

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
those lines. Without a CUDA device, or without the repository's
``src/`` beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
ALU_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak, used
#                               for the kernels' int32 ALU operations
N_REQUESTS, ROWS_PER_REQUEST = 8, 64
KERNELS = {
    "lut_eval_streamed": ("src/repro_torch/csrc/lut_eval.cu",
                          "src/repro/kernels/lut_eval/lut_eval.py:292"),
    "lut_eval": ("src/repro_torch/csrc/lut_eval.cu",
                 "src/repro/kernels/lut_eval/lut_eval.py:94"),
    "lut_layer": ("src/repro_torch/csrc/lut_layer.cu",
                  "src/repro/kernels/lut_layer/lut_layer.py:55"),
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` CUDA-event windows of ``iters`` calls each."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check(errs, name, got, want, what):
    """Bit-exact comparison of a kernel's output with its plain
    version's; records the max abs error under ``name``."""
    import torch
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {what}: {got.shape}/{got.dtype} vs "
            f"{want.shape}/{want.dtype}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    require(torch.equal(got, want), f"{name} {what}: differs from its "
            f"plain version (max abs err {err})")


def netlist_work(mapped, n_words: int):
    """(least bytes, operations) of evaluating ``mapped`` on ``n_words``
    words per wire: each real LUT's INIT at 2^m bits and its m int32
    leaf indices, the PI words read once, one int32 word per wire
    (constant row, PIs, LUTs) written once; three 32-bit operations per
    Shannon select, 2^m - 1 selects per LUT."""
    init_bits = sum(1 << len(l.leaves) for l in mapped.luts)
    n_leaves = sum(len(l.leaves) for l in mapped.luts)
    n_bytes = ((init_bits + 7) // 8 + 4 * n_leaves
               + 4 * n_words * (mapped.n_pis
                                + 1 + mapped.n_pis + mapped.n_luts))
    n_ops = 3 * n_words * sum((1 << len(l.leaves)) - 1 for l in mapped.luts)
    return n_bytes, n_ops


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Netlists for the kernel phase
# ---------------------------------------------------------------------------

def random_mapped(seed: int, n_vars: int, n_outs: int):
    import numpy as np
    from repro_torch import synth
    from repro_torch.synth.from_sop import table_to_aig
    rng = np.random.default_rng(seed)
    aig = synth.AIG(n_vars)
    aig.outputs = [table_to_aig(aig, rng.random(1 << n_vars) < 0.5, None,
                                [2 * (i + 1) for i in range(n_vars)])
                   for _ in range(n_outs)]
    return synth.synthesize(aig)


def constant_mapped():
    from repro_torch import synth
    aig = synth.AIG(3)
    aig.outputs = [1]
    return synth.synthesize(aig)


def wide_random_netlist(seed: int, n_pis: int = 64, n_levels: int = 12,
                        width: int = 170, k: int = 6):
    """A random mapped netlist of n_levels * width LUTs (2,040 at the
    defaults, the JSC-M scale) whose depth is exactly ``n_levels``:
    every LUT reads one wire of the level below and up to k-1 other
    earlier wires, with a random INIT vector."""
    import numpy as np
    from repro_torch.synth import MappedLUT, MappedNetwork
    rng = np.random.default_rng(seed)
    below = list(range(1, n_pis + 1))
    earlier = [0] + below
    luts, node = [], n_pis + 1
    for _ in range(n_levels):
        level = []
        for _ in range(width):
            m = int(rng.integers(2, k + 1))
            leaves = [int(rng.choice(below))]
            leaves += [int(v) for v in rng.choice(earlier, m - 1)]
            tt = (int.from_bytes(rng.bytes(8), "little")
                  & ((1 << (1 << m)) - 1))
            luts.append(MappedLUT(node, tuple(leaves), tt))
            level.append(node)
            node += 1
        earlier += level
        below = level
    outputs = [2 * v + int(rng.integers(0, 2)) for v in below[:40]]
    return MappedNetwork(n_pis, k, luts, outputs)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] {len(build.sources())} sources -> {build.LIB_NAME} "
          f"in {dt:.2f}s (nvcc {' '.join(build.NVCC_FLAGS)})")
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line or "Used" in line:
            print("[build]   " + line.split(":", 1)[-1].strip())


def phase_kernels(torch, errs):
    import numpy as np
    from repro_torch import synth
    from repro_torch.kernels.lut_eval import (level_starts, lut_eval,
                                              lut_eval_ref, lut_eval_streamed,
                                              lut_eval_streamed_ref)
    from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref
    from repro_torch.synth.executor import _compile_plan
    dev = torch.device("cuda")

    # lut_layer: JSC-S layer shapes at the serving batch, then a sweep
    shapes = [(256, 16, 64, 3, 3), (256, 64, 32, 3, 3), (256, 32, 5, 3, 3),
              (8, 16, 32, 3, 2), (130, 20, 50, 4, 2), (64, 64, 128, 6, 2),
              (33, 10, 7, 2, 4), (16, 24, 200, 5, 3), (70, 30, 9, 6, 3)]
    for (B, n_in, N, K, L) in shapes:
        g = torch.Generator(device="cpu").manual_seed(B * 7 + N)
        codes = torch.randint(0, L, (B, n_in), generator=g,
                              dtype=torch.int32).to(dev)
        idx = torch.randint(0, n_in, (N, K), generator=g,
                            dtype=torch.int32).to(dev)
        tables = torch.randint(0, 8, (N, L ** K), generator=g,
                               dtype=torch.int32).to(dev)
        check(errs, "lut_layer", lut_layer(codes, idx, tables, L),
              lut_layer_ref(codes, idx, tables, L), f"{(B, n_in, N, K, L)}")
        if (B, n_in, N) == (256, 64, 32):
            ms = time_ms(lambda: lut_layer(codes, idx, tables, L))
            plain = time_ms(lambda: lut_layer_ref(codes, idx, tables, L))
            print(f"[kernels] lut_layer {(B, n_in, N, K, L)}: {ms:.5f} ms, "
                  f"plain {plain:.5f} ms")
    print(f"[kernels] lut_layer == plain on {len(shapes)} shapes")

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                .copy()).to(dev)

    t0 = time.perf_counter()
    nets = [("random 9-var", random_mapped(0, 9, 3)),
            ("random 10-var", random_mapped(4, 10, 4)),
            ("constant", constant_mapped()),
            ("wide 2040-LUT", wide_random_netlist(7))]
    host_s = time.perf_counter() - t0
    for label, mapped in nets:
        plan = _compile_plan(mapped)
        for n_words in (1, 7, 130):
            words = synth.random_words(mapped.n_pis, n_words, seed=n_words)
            pw = i32(words)
            host = synth.execute_packed(mapped, words, plan=plan)
            dp = synth.compile_device_plan(mapped, plan)
            args = [i32(a) for a in (dp.leaf_idx, dp.tt_bits, dp.out_wires)]
            plane = lut_eval(pw, *args, n_wires=dp.n_wires)
            check(errs, "lut_eval", plane,
                  lut_eval_ref(pw, *args, n_wires=dp.n_wires),
                  f"{label} W={n_words}")
            out = plane.cpu().numpy().view(np.uint32)[dp.out_idx]
            out[dp.out_neg] = ~out[dp.out_neg]
            require(np.array_equal(out, host),
                    f"lut_eval {label} W={n_words}: differs from the host fold")
            for tile_rows in (8, 32):
                tp = synth.compile_tile_plan(plan, mapped.n_pis, mapped.k,
                                             tile_rows)
                targs = [i32(a) for a in (tp.tt_tiles, tp.leaf_tiles,
                                          tp.out_base,
                                          level_starts(tp.level_of_tile))]
                check(errs, "lut_eval_streamed",
                      lut_eval_streamed(pw, *targs, n_rows=tp.n_rows),
                      lut_eval_streamed_ref(pw, *targs, n_rows=tp.n_rows),
                      f"{label} W={n_words} T={tile_rows}")
            if label.startswith("wide") and n_words == 130:
                ms = time_ms(lambda: lut_eval(pw, *args, n_wires=dp.n_wires))
                sms = time_ms(lambda: lut_eval_streamed(pw, *targs,
                                                        n_rows=tp.n_rows))
                print(f"[kernels] {label} W=130: lut_eval {ms:.5f} ms, "
                      f"lut_eval_streamed (T={tp.tile_rows}) {sms:.5f} ms")
        print(f"[kernels] lut_eval, lut_eval_streamed == plain on {label}: "
              f"{mapped.n_luts} LUTs, depth {mapped.depth}, W in 1/7/130, "
              f"T in 8/32")
    print(f"[kernels] host synthesis of the test netlists {host_s:.1f}s")


def phase_serve(torch):
    """The main path, once per kernel. Returns what the timing phase
    needs: the served engines and the launches of each run."""
    import numpy as np
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import train_test
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.mlp import (final_masks, init_mlp, mlp_forward,
                                        to_logic)
    from repro_torch.serving.engine import LogicEngine

    t0 = time.perf_counter()
    model = init_mlp(JSC_S, torch.Generator().manual_seed(0))
    model.set_masks(final_masks(JSC_S, model))
    net = to_logic(JSC_S, model)
    (_, _), (xte, yte) = train_test()
    reqs = [xte[i * ROWS_PER_REQUEST: (i + 1) * ROWS_PER_REQUEST]
            for i in range(N_REQUESTS)]
    x = np.concatenate(reqs)
    print(f"[serve] seeded JSC-S compiled to tables in "
          f"{time.perf_counter() - t0:.1f}s; {x.shape[0]} rows in "
          f"{N_REQUESTS} requests")

    cpu_vals = net(torch.from_numpy(x))[:, :JSC_S.n_classes]
    want = LogicEngine(net, JSC_S.n_classes, backend="gather",
                       device="cpu").classify(x)
    ties = int((cpu_vals == cpu_vals.max(dim=1, keepdim=True).values)
               .sum(dim=1).gt(1).sum())
    xc = torch.from_numpy(x).cuda()
    codes_card = net.quantize_inputs(xc).cpu()
    require(torch.equal(codes_card, net.quantize_inputs(torch.from_numpy(x))),
            "input codes on the card differ from the CPU's")
    mlp_labels = torch.argmax(mlp_forward(JSC_S, model.cuda(), xc)
                              [:, :JSC_S.n_classes], dim=-1).cpu().numpy()
    require(np.array_equal(mlp_labels, want),
            "CPU gather labels differ from the float MLP's argmax on the card "
            f"({int((mlp_labels != want).sum())} rows)")
    acc = float(np.mean(want == yte[: x.shape[0]]))
    print(f"[serve] CPU gather: acc={acc:.4f}, {ties} rows with tied top "
          f"scores; card input codes and MLP argmax agree")

    runs = {}
    # engine None: the bitplane default on the card, the streamed kernel
    for backend, engine, kernel in (("bitplane", None, "lut_eval_streamed"),
                                    ("bitplane", "cuda", "lut_eval"),
                                    ("lut_layer", None, "lut_layer")):
        t0 = time.perf_counter()
        eng = LogicEngine(net, JSC_S.n_classes, backend=backend,
                          engine=engine, device="cuda")
        setup = time.perf_counter() - t0
        name = backend
        if backend == "bitplane":
            m = eng.bitnet.mapped
            name = f"{backend}/{eng.engine}"
            require(engine is not None or eng.engine == "cuda-streamed",
                    f"the bitplane default engine on the card is "
                    f"{eng.engine!r}, not 'cuda-streamed'")
        reset_launch_counts()
        results, stats = eng.serve_queue(reqs)
        counts = launch_counts()
        labels = np.concatenate(results)
        require(counts[kernel] > 0, f"{name}: {kernel} was not launched "
                f"(counts {counts})")
        require(np.array_equal(labels, want), f"{name}: labels differ from "
                f"the CPU gather path ({int((labels != want).sum())} rows)")
        shape = (f"{m.n_luts} LUTs depth {m.depth}, "
                 if backend == "bitplane" else "")
        print(f"[serve] {name}: {shape}labels == CPU gather == "
              f"MLP argmax; p50={stats['p50_us']:.1f}us "
              f"p95={stats['p95_us']:.1f}us batches={stats['n_batches']} "
              f"launches while serving {counts} (set-up with synthesis "
              f"{setup:.1f}s)")
        runs[kernel] = (eng, counts[kernel])
    return runs, xte[: 256]


def phase_timing(torch, runs, batch, errs, card):
    """Each kernel at the shapes of one served 256-row batch: held bit
    for bit against its plain version on the served inputs, then timed
    beside it. The bound counts the least bytes the function moves
    (``netlist_work``; lut_layer's tables at their stored width), the
    bytes of the padded plan tensors are printed beside it."""
    from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref
    rows = []

    def row(name, fn, plain, n_bytes, n_ops, launches, plan_bytes):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        b_ms, b_by = bound(n_bytes, n_ops)
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": errs.get(name, 0), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"[timing] {name}: {ms:.5f} ms (plain {plain_ms:.5f} ms, "
              f"bound {b_ms:.7f} ms by {b_by}: {n_bytes} least bytes, "
              f"{n_ops} ops; plan tensors {plan_bytes} bytes) on {card}")

    for name in ("lut_eval_streamed", "lut_eval"):
        eng, launches = runs[name]
        ex = eng.bitnet.executor
        words = eng.stages(batch)["quantize+pack"]()
        check(errs, name, ex.plane(words), ex.plane(words, plain=True),
              f"served JSC-S batch W={words.shape[1]}")
        n_bytes, n_ops = netlist_work(eng.bitnet.mapped, words.shape[1])
        plan = ((ex.tp.tt_tiles, ex.tp.leaf_tiles, ex.tp.out_base,
                 ex.tp.level_of_tile) if name == "lut_eval_streamed"
                else (ex.dp.leaf_idx, ex.dp.tt_bits, ex.dp.out_wires))
        row(name, lambda: ex.plane(words),
            lambda: ex.plane(words, plain=True), n_bytes, n_ops, launches,
            nbytes(words, ex.plane(words)) + sum(a.nbytes for a in plan))

    eng, launches = runs["lut_layer"]
    net = eng.net
    codes0 = net.quantize_inputs(torch.as_tensor(batch, device="cuda"))
    layers = [(idx, tables, lt) for lt, (idx, tables)
              in zip(net.layers, net.layer_tensors(codes0.device))]

    def chain(fn):
        c = codes0
        for idx, tables, lt in layers:
            c = fn(c, idx, tables, lt.in_spec.n_levels)
        return c

    n_bytes, n_ops, plan_bytes, c = 0, 0, 0, codes0
    for i, (idx, tables, lt) in enumerate(layers):
        nxt = lut_layer(c, idx, tables, lt.in_spec.n_levels)
        check(errs, "lut_layer", nxt,
              lut_layer_ref(c, idx, tables, lt.in_spec.n_levels),
              f"served JSC-S batch, layer {i}")
        n_bytes += nbytes(c, idx, nxt) + lt.tables.nbytes
        plan_bytes += nbytes(c, idx, tables, nxt)
        n_ops += 2 * idx.shape[1] * nxt.numel()
        c = nxt
    row("lut_layer", lambda: chain(lut_layer), lambda: chain(lut_layer_ref),
        n_bytes, n_ops, launches, plan_bytes)
    return rows


def phase_profile(torch, runs, batch, card):
    """Where one served 256-row batch spends its time, per engine: host
    clock per stage of ``LogicEngine.stages`` (median of 50, each ending
    in a synchronize), and the device's busy time from
    ``torch.profiler`` over 20 batches."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    def med_us(fn, n=50):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e6)
        return float(np.median(out))

    symbols = {"lut_eval_streamed": "lut_eval_streamed_kernel",
               "lut_eval": "lut_eval_kernel", "lut_layer": "lut_layer_kernel"}
    for kernel, (eng, _) in runs.items():
        serve = eng.scheduler_executor()
        parts = {k: med_us(f) for k, f in eng.stages(batch).items()}
        whole = med_us(lambda: serve(batch))
        for _ in range(5):
            serve(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                serve(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / 20
        busy, kern_us, kern_n = 0.0, 0.0, 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue               # host ops: their kernels count below
            dev = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            busy += dev
            if symbols[kernel] in e.key:
                kern_us += dev
                kern_n += e.count
        busy /= 20
        idle = 1.0 - busy / wall_us if wall_us else float("nan")
        kern = (f"{kern_us / kern_n:.2f} us per launch ({kern_n} launches)"
                if kern_n else "not seen by the profiler")
        name = (f"bitplane/{eng.engine}" if eng.backend == "bitplane"
                else eng.backend)
        print(f"[profile] {name} one 256-row batch: "
              f"{whole:.1f} us end to end; "
              + ", ".join(f"{k} {v:.1f} us" for k, v in parts.items())
              + f"; profiled {wall_us:.1f} us/batch, device busy "
              f"{busy:.2f} us (idle share {idle:.4f}); {symbols[kernel]} "
              f"device time {kern} on {card}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    errs = {}
    card = phase_card(torch)
    phase_build()
    phase_kernels(torch, errs)
    runs, batch = phase_serve(torch)
    rows = phase_timing(torch, runs, batch, errs, card)
    phase_profile(torch, runs, batch, card)
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
