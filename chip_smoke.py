#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. card     — ``nvidia-smi`` name and power limit, torch's device name;
  2. build    — compiles ``src/repro_torch/csrc/*.cu`` with nvcc for
                sm_90a (seconds, and each kernel's registers and stack
                frame); no lut_eval walk, aig_sim, xnor_popcount or
                fanin_matmul instance may keep a stack or spill, and
                xnor_popcount's SASS must hold binary tensor-core mma
                (BMMA);
     probe    — ``repro_torch.bench.mma_probe``: which binary and int8
                mma forms ptxas takes for sm_90a, one instruction of
                each against numpy, and each one's rate;
  3. kernels  — every kernel against its plain torch version on the
                card, bit for bit (``torch.equal``): lut_layer on JSC-S
                layer shapes and a ragged sweep that reaches each of its
                branches (whole tiles in shared memory, fewer neurons a
                block for large tables, device memory for a table or a
                row of codes over the budget), both lut_eval walks on
                random mapped netlists (W in {1, 7, 130}, tile_rows in
                {8, 32}, the constant network, and a ~2,000-LUT,
                depth-12 netlist whose plans stream through shared
                memory one level at a time), and on random k-LUT
                netlists for k = 1..6 with each walk's plan staged
                whole, streamed in chunks of less than a level, and
                streamed with the plane in device memory; at k = 2..6
                also with INIT masks 4 bytes past 16-byte alignment, on
                each of those branches;
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
                inputs, then timed beside it, its bound and the launch
                floor (the profiler's device time of a one-element
                ``zero_`` on the card);
  6. profile  — one served batch per engine split into the stages of
                ``LogicEngine.stages`` (host clock) and the device's busy
                share (``torch.profiler``);
  7. train    — the training front end on the card: one QAT step of
                full-width JSC-S from seeded weights on one batch, on
                the card and on the CPU, held within STEP_TOL (the CPU
                parity test's tolerance; TF32 off) but for each layer's
                b, whose gradient under BN is rounding noise; the same
                step without BN, b held too; then JSC-S trained
                with the launcher's settings (``train_jsc``: 400 QAT +
                FCP steps, 80 fine-tune steps, the float reference's
                800), with ms per step (synchronized) and the test and
                float accuracies, which must pass the reference test's
                bar of 0.5; the trained network compiled, synthesized
                and serving the 8 requests on cuda-streamed, cuda and
                lut_layer, each from launch counts at 0 and launching
                its kernel, with labels equal across the engines, to
                the trained model's argmax on the card and to the CPU
                gather path; and the profile phase's split of one
                served batch of the trained network;
     verify   — the verification slice on the train phase's network:
                ``check_synth_pipeline(net, formal=True)`` with every
                SAT verdict UNSAT, ``preflight`` of both walks' networks
                with the plan check's branch at the serving batch (W =
                8) equal to the launch each wrapper chose at that batch
                (``last_plan``, read at the call); plans corrupted three
                ways (a leaf at the dump row, an output wire past the
                plane, an INIT word other than 0 / ~0) refused by
                ``compile_device_plan(verify=True)`` and ``preflight``
                with no kernel launched; the streamed walk at every
                autotune candidate's geometry bit-exact against its
                plain version, the sweep's times (CUDA events behind a
                device spin) into a temporary cache, and a new executor
                taking the winner and serving ``classify``'s labels; the
                launcher's ``--check`` on bitplane with cuda and
                cuda-streamed, preflight OK and labels unchanged; and
                the Table 1 twin (``repro_torch.bench.table1_jsc``) on
                JSC-S at the launcher's 400 steps, its netlist
                equivalent on the card;
  8. loadgen  — the serving-at-scale path, from every launch count at
                0: ``repro_torch.bench.loadgen.run`` in its fast mode
                (JSC-S trained 150 steps, 1,000 requests a section) on
                gather, lut_layer, bitplane-cuda and bitplane-streamed,
                open and closed loop and two SLO lanes, two replicas
                behind ``least_slack``, traced, publishing into a
                registry behind a ``MetricsServer`` on 127.0.0.1; the
                labels of every section must equal ``classify``'s and
                agree across the backends, lut_eval_streamed, lut_eval
                and lut_layer must each launch, ``/metrics`` and
                ``/metrics.json`` must show every backend's window
                series, the trace must reconcile (``analyze_trace``, the
                reference's 5 % with its straggler allowance) with
                nothing dropped, and the latency table it wrote must
                hold finite, non-negative rows of both walks and name
                the card; it prints each section's qps, p50/p95/p99,
                batch occupancy, shed and miss rate, the online profile,
                the calibrated netlist estimate, the tracer overhead,
                the table's per-level and per-tile µs, and the garbage
                collector's passes during the run beside the requests
                slower than 20 ms that were in flight during a pass of
                10 ms or more. Then the trained
                network of the train phase under the scheduler, 1 and 2
                replicas, open and closed loop, with labels equal to
                ``classify``: qps, percentiles and occupancy of an
                unprofiled run, the device's idle share from a profiled
                one, and, with one replica, the online profiler fed by
                the bitplane aggregators;
  9. kernels2 — every kernel the kernel-bench path runs against its
                plain version on the card, on the bench's own inputs:
                lut_layer, lut_eval and lut_eval_streamed bit for bit;
                the aig_sim walk, the public ``aig_sim`` route and
                xnor_popcount bit for bit (the bench AIG at W 1 / 7 /
                256, a strict chain, forward literals, a 60,000-AND DAG
                whose planes sit in device memory at W 1 / 7 / 200,
                chains of inverters that run the sweeps to their cap and
                finish in node order, in shared and device memory; xnor
                with zeros, ragged B, N and n across its tiles and slabs,
                both of its load paths, and pad bits set), fanin_matmul
                bit for bit with NaN positions compared, in float32,
                bf16 and f16, on indices that wrap and indices out of
                range, on each branch of ``plan_fanin`` (1 and 2 rows a
                block, staged in shared memory, and too wide to stage,
                n_in 60,000 and 120,000, in device memory), and
                flash_attention within 2e-4 in float32 (TF32 off in the
                plain version) and 2e-2 in bfloat16 (the reference
                test's tolerances): bench, window, ragged, GQA and fully
                masked shapes, every dh template (16, 32, 64, 128) and
                every copy width of its K / V loads;
  10. bench   — the second path: ``repro_torch.bench.kernels_bench.run``
                once on the card at the reference's shapes, from every
                launch count at 0; each of its four kernels must launch;
                its rows are printed;
  11. timing2 — each of those kernels at the bench shapes beside its
                plain version, its bound, the library call that computes
                the same function (the faster of ``torch._int_mm`` of the
                int8 +-1 operands and the TF32 ``torch.matmul`` of the
                float ones, both exact; for fanin_matmul the fastest on
                the device of the masked dense product, ``torch.sparse.mm``
                of w as CSR with x^T and ``embedding_bag`` over x^T;
                ``scaled_dot_product_attention``) and its device
                time per launch and the library calls' device time per
                call (``torch.profiler``); beside them the aig_sim walk
                on a strict chain and a chain of inverters of 2,500 ANDs
                each, fanin_matmul at 1 and 2 rows a block and with
                its parts left out (no fanin terms; rows of 32 inputs), and
                bfloat16 rows of fanin_matmul and flash_attention at the
                bench shape, with the same library calls on the bf16
                operands. xnor's bound counts its bit products at the
                rate the probe measured for b1 ``and.popc`` in this run;
  12. latency — the benchmark runner, ``repro_torch.bench.run --fast
                --only latency,kernels``, once from every launch count
                at 0 into a temporary directory with a history ledger
                there: the latency section (JSC-S trained 200 steps,
                batch 256) must launch lut_layer, xnor_popcount and
                lut_eval_streamed; on its own inputs ``net(x,
                use_kernel=True)`` must equal ``net(x)``, the xnor path
                ``xnor_matmul_ref`` and the streamed walk's labels
                ``classify``'s; ``execute_packed_cuda`` and
                ``execute_packed_streamed`` on its netlist at W = 8 must
                equal ``execute_packed``; the check_regression twin must
                pass the written records against themselves with some
                metric checked, and a second history append must be
                skipped. It prints each path's wall µs, device µs (CUDA
                events behind a device spin, and whether the calls
                stayed queued behind it), device busy µs a call
                (``torch.profiler``) and the synchronizations one call
                makes (torch's sync debug mode) beside the card.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before
those lines. Without a CUDA device, or without the repository's
``src/`` beside this file, it exits non-zero at once.

    python3 chip_smoke.py --kernel-times

prints instead one JSON line of device times per launch (the
profiler's, back to back) of the aig_sim walk on the bench AIG, the
strict chain and the chain of inverters, and of xnor_popcount and
fanin_matmul (float32) at the bench shape, each first held to its
plain version, for the port beside
the script: a copy of this file in an older checkout times that
checkout's kernels through the same wrappers, so two checkouts compare
in one run on one card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
ALU_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak, used
#                               for the kernels' int32 ALU operations
N_REQUESTS, ROWS_PER_REQUEST = 8, 64
TRAIN_STEPS = 400             # the launcher's --train-steps default
STEP_TOL = 1e-5               # tests/test_torch_train.py's TOL
KERNELS = {
    "lut_eval_streamed": ("src/repro_torch/csrc/lut_eval.cu",
                          "src/repro/kernels/lut_eval/lut_eval.py:292"),
    "lut_eval": ("src/repro_torch/csrc/lut_eval.cu",
                 "src/repro/kernels/lut_eval/lut_eval.py:94"),
    "lut_layer": ("src/repro_torch/csrc/lut_layer.cu",
                  "src/repro/kernels/lut_layer/lut_layer.py:55"),
    "aig_sim": ("src/repro_torch/csrc/aig_sim.cu",
                "src/repro/kernels/aig_sim/aig_sim.py:49"),
    "xnor_popcount": ("src/repro_torch/csrc/xnor_popcount.cu",
                      "src/repro/kernels/xnor_popcount/xnor_popcount.py:61"),
    "fanin_matmul": ("src/repro_torch/csrc/fanin_matmul.cu",
                     "src/repro/kernels/fanin_matmul/fanin_matmul.py:47"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:73"),
}
F32_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 peak
TF32_OPS_PER_S = 495e12       # H100 SXM dense tensor-core peaks
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
BENCH_KERNELS = ("aig_sim", "xnor_popcount", "fanin_matmul",
                 "flash_attention")


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


def device_us(fn, kernel, n: int = 20):
    """The profiler's device time per launch of ``kernel`` (a substring of
    the kernel symbol; None: every kernel) over ``n`` back-to-back calls
    of ``fn``, and the launches seen; (None, 0) when the profiler saw
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (kernel is None or kernel in e.key)]
    launches = sum(e.count for e in mine)
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in mine)
    return (us / launches if launches else None), launches


def device_us_seen(fn, kernel, n: int = 10):
    """``device_us``, repeated up to three times until the profiler sees
    a launch (a session now and then sees none); fails if it never
    does."""
    for _ in range(3):
        us, launches = device_us(fn, kernel, n)
        if launches:
            return us, launches
    raise SmokeFailure(f"the profiler saw no {kernel or 'kernel'} in three "
                       "sessions")


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 matmuls on or off inside the block, as they were after."""
    import torch
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = enabled
    try:
        yield
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


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


def check_nan_equal(errs, name, got, want, what):
    """Bit-exact comparison of a float kernel's output with its plain
    version's, NaN positions included; records the max abs error of the
    other entries under ``name``."""
    import torch
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {what}: {got.shape}/{got.dtype} vs "
            f"{want.shape}/{want.dtype}")
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan),
            f"{name} {what}: NaN positions differ from its plain version")
    diff = (got[~nan].float() - want[~nan].float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    require(torch.equal(got[~nan], want[~nan]), f"{name} {what}: differs "
            f"from its plain version (max abs err {err})")


def fanin_operands(rng, B, n_in, N, K, dtype, device):
    """Seeded fanin_matmul operands in ``dtype``: a third of the indices
    in [-n_in, 0) (they wrap) and, where N allows, four out of range
    (n_in, -n_in - 1, 2^30, -2^31: NaN outputs)."""
    import torch
    idx = rng.integers(0, n_in, (N, K)).astype("int32")
    idx[::3] -= n_in
    if N >= 8 and K > 0:
        rows = rng.choice(N, size=4, replace=False)
        idx[rows, rng.integers(0, K, 4)] = [n_in, -n_in - 1, 1 << 30,
                                            -(1 << 31)]
    x, w, bias = (torch.from_numpy(rng.normal(size=s).astype("float32"))
                  .to(device=device, dtype=dtype)
                  for s in ((B, n_in), (N, K), (N,)))
    return x, torch.from_numpy(idx).to(device), w, bias


def misaligned(t):
    """A copy of ``t`` one int32 past a 16-byte aligned address."""
    import torch
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    off = (1 - buf.data_ptr() % 16 // 4) % 4
    out = buf[off: off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


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


def bound(n_bytes: int, n_ops: int, ops_per_s: float = ALU_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(errs, name, got, want, tol, what, relative=False):
    """Float comparison of a kernel's output with its plain version's:
    max |got - want| (over max(1, |want|) when ``relative``) within
    ``tol``; records the max abs error under ``name``."""
    import torch
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {what}: {got.shape}/{got.dtype} vs "
            f"{want.shape}/{want.dtype}")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    scaled = (float((diff / want.abs().clamp(min=1.0)).max())
              if relative and got.numel() else err)
    require(math.isfinite(scaled) and scaled <= tol,
            f"{name} {what}: error {scaled} exceeds {tol}")


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
                        width: int = 170, k: int = 6, min_leaves: int = 2):
    """A random mapped k-LUT netlist of n_levels * width LUTs (2,040 at
    the defaults, the JSC-M scale) whose depth is exactly ``n_levels``:
    every LUT has ``min_leaves`` to k leaves, one wire of the level below
    and the others earlier wires, with a random INIT vector."""
    import numpy as np
    from repro_torch.synth import MappedLUT, MappedNetwork
    rng = np.random.default_rng(seed)
    below = list(range(1, n_pis + 1))
    earlier = [0] + below
    luts, node = [], n_pis + 1
    for _ in range(n_levels):
        level = []
        for _ in range(width):
            m = int(rng.integers(min_leaves, k + 1))
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


def forward_literals(seed: int, n_pis: int, n_ands: int):
    """f0, f1 of random literals anywhere in the plane: about half name
    the node itself or a later one, which read 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_rows = 1 + n_pis + n_ands
    return tuple(rng.integers(0, 2 * n_rows, n_ands).astype(np.int32)
                 for _ in range(2))


def walk_check(torch, errs, f0, f1, n_pis, words, label):
    """The aig_sim walk on the card against its plain version (run on
    the CPU: a Python loop over the nodes), bit for bit; returns the
    walk's plan (word columns a block, planes in shared memory?)."""
    import numpy as np
    from repro_torch.kernels.aig_sim import aig_sim_ref, aig_sim_walk
    from repro_torch.kernels.aig_sim.ops import plan_walk
    host = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in (words, f0, f1)]
    check(errs, "aig_sim", aig_sim_walk(*(h.cuda() for h in host)),
          aig_sim_ref(*host, n_pis).cuda(), f"{label} W={words.shape[1]}")
    return plan_walk(n_pis, len(f0), words.shape[1])


def strict_chain(seed: int, n_pis: int, n_ands: int):
    """f0, f1 of a chain: node i ANDs node i - 1 (the last input for node
    0) with a random earlier literal; depth n_ands, values that settle
    early."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prev = 2 * (n_pis + np.arange(n_ands)) + rng.integers(0, 2, n_ands)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return prev.astype(np.int32), (rng.random(n_ands) * hi).astype(np.int32)


def toggling_chain(n_pis: int, n_ands: int):
    """f0, f1 of a chain of inverters: node i is NOT node i - 1 (the last
    input for node 0) AND the constant 1; its values change in every
    sweep until the n_ands-th."""
    import numpy as np
    prev = 2 * (n_pis + np.arange(n_ands)) + 1
    return prev.astype(np.int32), np.ones(n_ands, np.int32)


def chain_literals(seed: int, n_pis: int, n_ands: int):
    """f0, f1 of ``n_ands`` AND nodes, each reading two random literals
    of earlier nodes (the constant and the inputs included)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hi = 2 * (1 + n_pis + np.arange(n_ands))
    return ((rng.random(n_ands) * hi).astype(np.int32),
            (rng.random(n_ands) * hi).astype(np.int32))


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


def kernel_name(symbol: str) -> str:
    """``lut_eval_kernel<6>`` / ``flash_attention_kernel<bf16,64>`` from
    a mangled kernel symbol."""
    m = re.search(r"([a-z_]+_kernel)(I.*?EE)?", symbol)
    if not m:
        return symbol
    args, rest = [], m.group(2) or ""
    if rest.startswith("I13__nv_bfloat16"):
        args.append("bf16")
    elif rest.startswith("I6__half"):
        args.append("f16")
    elif rest.startswith("If"):
        args.append("float")
    args += [v if kind == "i" else ("smem" if v == "1" else "global")
             for kind, v in re.findall(r"L([ib])(\d+)E", rest)]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log: str):
    """(kernel, registers line, stack-frame line) per entry function of
    an ``nvcc -Xptxas=-v`` log."""
    out, name, stack = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line.rsplit(" ", 1)[-1])
        elif "bytes stack frame" in line:
            stack = line.strip()
        elif "Used" in line and name:
            out.append((name, line.split(":", 1)[-1].strip(), stack))
            name, stack = None, ""
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    build.library()
    dt = time.perf_counter() - t0
    print(f"[build] {len(build.sources())} sources -> {build.LIB_NAME} "
          f"in {dt:.2f}s (nvcc {' '.join(build.NVCC_FLAGS)})")
    report = ptxas_report(build.build_log())
    for name, regs, stack in report:
        print(f"[build]   {name}: {regs}; {stack}")
    lut = [(n, st) for n, _, st in report if "lut_eval" in n]
    require(len(lut) == 24, f"ptxas reported {len(lut)} lut_eval kernels, "
            "expected 24 (k = 1..6: the monolithic and the streamed walk, "
            "each with the plane in shared and in device memory)")
    for name, stack in lut:
        require(stack.startswith("0 bytes stack frame"),
                f"{name} keeps a stack frame: {stack}")
    layer = [n for n, _, _ in report if "lut_layer" in n]
    require(len(layer) == 14, f"ptxas reported {len(layer)} lut_layer "
            "kernels, expected 14 (K = 1..6 and any K, each staged in "
            "shared memory and reading device memory)")
    print("[build] every lut_eval walk, k = 1..6: 0 bytes of stack")
    for kernel, count, what in (
            ("aig_sim", 6, "1, 2 or 4 word columns a block, planes in "
             "shared or device memory"),
            ("xnor_popcount", 1, "one instance"),
            ("fanin_matmul", 12, "float32 / bf16 / f16 x 1 or 2 rows a "
             "block x rows in shared or device memory")):
        found = [(n, st) for n, _, st in report if kernel in n]
        require(len(found) == count, f"ptxas reported {len(found)} {kernel} "
                f"kernels, expected {count} ({what})")
        for name, stack in found:
            require(stack.startswith("0 bytes stack frame, 0 bytes spill"),
                    f"{name} keeps a stack frame or spills: {stack}")
        print(f"[build] every {kernel} instance ({count}): 0 bytes of stack, "
              "no spill")
    sass = sass_of(build.build().parent / build.LIB_NAME, "xnor_popcount")
    n_bmma = sum(1 for ln in sass.splitlines() if "BMMA" in ln)
    require(n_bmma > 0, "xnor_popcount_kernel has no BMMA (binary tensor-core"
            " mma) instruction in its SASS")
    print(f"[build] xnor_popcount_kernel SASS: {n_bmma} BMMA instructions "
          "(binary mma on the tensor cores)")


def sass_of(lib, kernel: str) -> str:
    """The SASS of the functions of ``lib`` whose name holds ``kernel``
    (``cuobjdump -sass`` beside nvcc)."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[:500]}")
    keep, mine = [], False
    for line in out.stdout.splitlines():
        if "Function :" in line:
            mine = kernel in line
        elif mine:
            keep.append(line)
    return "\n".join(keep)


def phase_probe():
    """The tensor-core instructions the xnor_popcount kernel may use
    (``repro_torch.bench.mma_probe``): which ``ptxas`` takes for sm_90a,
    whether one instruction agrees with numpy in the kernel's fragment
    layout, and each one's rate over the card."""
    from repro_torch.bench import mma_probe
    res = mma_probe.run()
    for op, r in res.items():
        print(f"[probe] mma {op}: " + (
            f"accepted, layout {'ok' if r['layout_ok'] else 'WRONG'}, "
            f"{r['tops']:.1f} TOPS" if r["accepted"] else
            f"refused by ptxas ({r['message'][:160]})"))
    and_popc = res["b1.and.popc"]
    require(and_popc["accepted"] and and_popc["layout_ok"]
            and and_popc["tops"], f"the kernel's b1 and.popc mma: {and_popc}")
    return and_popc["tops"] * 1e12


def phase_kernels(torch, errs):
    import numpy as np
    from repro_torch import synth
    from repro_torch.kernels.lut_eval import (level_starts, lut_eval,
                                              lut_eval_ref, lut_eval_streamed,
                                              lut_eval_streamed_ref,
                                              plan_stacked, plan_streamed,
                                              stacked_smem_bytes)
    from repro_torch.kernels.lut_eval.ops import streamed_smem_bytes, tt_stride
    from repro_torch.kernels.lut_layer import (lut_layer, lut_layer_ref,
                                               plan_layer)
    from repro_torch.kernels.spec import DEFAULT_SPEC
    from repro_torch.synth.executor import _compile_plan
    dev = torch.device("cuda")

    # lut_layer: JSC-S layer shapes at the serving batch, a sweep, JSC-L's
    # first layer (R 2,401) and R 4,096 (tiles of fewer neurons), then a
    # table (R 117,649) and a row of 60,000 codes over the budget (device
    # memory)
    shapes = [(256, 16, 64, 3, 3), (256, 64, 32, 3, 3), (256, 32, 5, 3, 3),
              (8, 16, 32, 3, 2), (130, 20, 50, 4, 2), (64, 64, 128, 6, 2),
              (33, 10, 7, 2, 4), (16, 24, 200, 5, 3), (70, 30, 9, 6, 3),
              (256, 16, 32, 4, 7), (40, 12, 20, 4, 8), (33, 10, 3, 6, 7),
              (5, 60_000, 7, 3, 3)]
    branches = {}
    for (B, n_in, N, K, L) in shapes:
        n_tile, b_tile, smem = plan_layer(B, n_in, N, K, L ** K)
        branch = ("device" if not smem else
                  "split" if n_tile < min(N, 32) else "smem")
        branches.setdefault(branch, []).append(
            f"{(B, n_in, N, K, L)} tile {n_tile}x{b_tile}")
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
    require(set(branches) == {"smem", "split", "device"},
            f"lut_layer branches reached: {sorted(branches)}")
    print(f"[kernels] lut_layer == plain on {len(shapes)} shapes; branches "
          + "; ".join(f"{b}: {', '.join(v)}" for b, v in branches.items()))

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
            if label.startswith("wide"):
                n_levels, lw = dp.out_wires.shape
                bw, smem, chunk = plan_stacked(dp.n_wires + 1, n_words,
                                               n_levels, lw, mapped.k)
                require(chunk == lw < n_levels * lw and smem,
                        f"{label}: the stacked plan's chunk is {chunk} slots "
                        f"of {n_levels} x {lw}, plane in shared memory "
                        f"{smem}; expected level by level beside the plane")
                print(f"[kernels] {label} W={n_words}: stacked plan streamed "
                      f"level by level ({lw} slots), bw {bw}, plane in "
                      "shared memory")
                n_tiles = tp.out_base.shape[0]
                bw, smem, chunk = plan_streamed(
                    tp.n_rows, n_words, int(tp.level_of_tile.max()) + 1,
                    n_tiles, tp.tile_rows, mapped.k)
                require(chunk < n_tiles, f"{label}: its plan of {n_tiles} "
                        "tiles was staged whole, not streamed")
                print(f"[kernels] {label} W={n_words} T={tp.tile_rows}: plan "
                      f"streamed in chunks of {chunk} of {n_tiles} tiles, bw "
                      f"{bw}, plane in {'shared' if smem else 'device'} "
                      "memory")
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

    # each walk's branches at every fold width: the plan staged whole
    # beside the plane (the default budget), streamed in chunks of less
    # than a level beside the plane (a budget of ten tiles; of two
    # ten-slot regions and a plane column in each half), and streamed
    # with the plane in device memory (two one-tile / one-slot regions)
    for k in range(1, 7):
        mapped = wide_random_netlist(k, n_pis=20, n_levels=4, width=70, k=k,
                                     min_leaves=1)
        plan = _compile_plan(mapped)
        dp = synth.compile_device_plan(mapped, plan)
        tp = synth.compile_tile_plan(plan, mapped.n_pis, k, 8)
        ls = level_starts(tp.level_of_tile)
        targs = [i32(a) for a in (tp.tt_tiles, tp.leaf_tiles, tp.out_base,
                                  ls)]
        args = [i32(a) for a in (dp.leaf_idx, dp.tt_bits, dp.out_wires)]
        n_levels, n_tiles = ls.shape[0] - 1, tp.out_base.shape[0]
        widest = int(np.diff(ls).max())
        lw = dp.out_wires.shape[1]
        n_rows = dp.n_wires + 1
        stacked = {
            "staged": DEFAULT_SPEC,
            "streamed": DEFAULT_SPEC.with_tile(smem_budget_bytes=2 * (
                stacked_smem_bytes(n_levels, lw, k, 10, 0, 0, False)
                + 4 * n_rows)),
            "device": DEFAULT_SPEC.with_tile(smem_budget_bytes=64 +
                stacked_smem_bytes(n_levels, lw, k, 1, 0, 0, False))}
        budgets = {
            "staged": DEFAULT_SPEC,
            "streamed": DEFAULT_SPEC.with_tile(
                smem_budget_bytes=10 * 4 * 8 * (tt_stride(k) + k) + 512),
            "device": DEFAULT_SPEC.with_tile(smem_budget_bytes=64 +
                streamed_smem_bytes(n_levels, n_tiles, 8, k, 1, 0, 0, False))}
        seen, seen_mono = [], []
        for n_words in (1, 7, 40):
            words = synth.random_words(mapped.n_pis, n_words, seed=k)
            pw = i32(words)
            host = synth.execute_packed(mapped, words, plan=plan)
            for mode, spec in stacked.items():
                bw, smem, chunk = plan_stacked(n_rows, n_words, n_levels, lw,
                                               k, spec)
                require((chunk >= n_levels * lw, smem) == (mode == "staged",
                                                           mode != "device")
                        and (mode == "staged" or chunk < lw),
                        f"k={k} W={n_words} stacked {mode}: chunk {chunk} "
                        f"of {n_levels} x {lw} slots, plane in shared "
                        f"memory {smem}")
                plane = lut_eval(pw, *args, n_wires=dp.n_wires, spec=spec)
                check(errs, "lut_eval", plane,
                      lut_eval_ref(pw, *args, n_wires=dp.n_wires),
                      f"k={k} W={n_words} {mode}")
                out = plane.cpu().numpy().view(np.uint32)[dp.out_idx]
                out[dp.out_neg] = ~out[dp.out_neg]
                require(np.array_equal(out, host), f"lut_eval k={k} "
                        f"W={n_words} {mode}: differs from the host fold")
                if n_words == 40:
                    seen_mono.append(f"{mode} (chunk {chunk}, bw {bw})")
            for mode, spec in budgets.items():
                bw, smem, chunk = plan_streamed(tp.n_rows, n_words, n_levels,
                                                n_tiles, 8, k, spec)
                require((chunk >= n_tiles, smem) == (mode == "staged",
                                                     mode != "device")
                        and (mode == "staged" or chunk < widest),
                        f"k={k} W={n_words} {mode}: chunk {chunk} of "
                        f"{n_tiles} tiles, plane in shared memory {smem}")
                check(errs, "lut_eval_streamed",
                      lut_eval_streamed(pw, *targs, n_rows=tp.n_rows,
                                        spec=spec),
                      lut_eval_streamed_ref(pw, *targs, n_rows=tp.n_rows),
                      f"k={k} W={n_words} {mode}")
                if n_words == 40:
                    seen.append(f"{mode} (chunk {chunk}, bw {bw})")
        print(f"[kernels] k={k}: {mapped.n_luts} LUTs in {n_tiles} tiles of "
              f"8 and {n_levels} x {lw} stacked slots, lut_eval and "
              f"lut_eval_streamed == plain at W in 1/7/40; monolithic walk "
              + ", ".join(seen_mono) + "; streamed walk " + ", ".join(seen))
        if k == 1:
            continue
        # INIT masks one int32 past an aligned address, on every branch of
        # both walks: the copy into shared memory takes its word-by-word
        # path, and the plane is the plain version's
        pw = i32(synth.random_words(mapped.n_pis, 7, seed=k))
        for mode in stacked:
            tt_off, tiles_off = misaligned(args[1]), misaligned(targs[0])
            require(tt_off.data_ptr() % 16 != 0
                    and tiles_off.data_ptr() % 16 != 0,
                    f"k={k} {mode}: the shifted masks are 16-byte aligned")
            check(errs, "lut_eval",
                  lut_eval(pw, args[0], tt_off, args[2], n_wires=dp.n_wires,
                           spec=stacked[mode]),
                  lut_eval_ref(pw, *args, n_wires=dp.n_wires),
                  f"k={k} {mode}, misaligned masks")
            check(errs, "lut_eval_streamed",
                  lut_eval_streamed(pw, tiles_off, *targs[1:],
                                    n_rows=tp.n_rows, spec=budgets[mode]),
                  lut_eval_streamed_ref(pw, *targs, n_rows=tp.n_rows),
                  f"k={k} {mode}, misaligned masks")
        print(f"[kernels] k={k}: masks at an address 4 bytes past 16-byte "
              "alignment, both walks == plain on the staged, streamed and "
              "device branches (W=7)")


def phase_serve(torch):
    """The main path, once per kernel. Returns what the timing phase
    needs: the served engines and the launches of each run."""
    import numpy as np
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import train_test
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

    return serve_engines(torch, net, reqs, want, "[serve]"), xte[: 256]


def serve_engines(torch, net, reqs, want, label):
    """Serve ``reqs`` on bitplane (its default engine on the card,
    cuda-streamed), bitplane/cuda and lut_layer, each run from launch
    counts at 0; each must launch its kernel and give the labels
    ``want``. Returns {kernel: (engine, launches)}."""
    import numpy as np
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.engine import LogicEngine

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
        require(counts[kernel] > 0, f"{label} {name}: {kernel} was not "
                f"launched (counts {counts})")
        require(np.array_equal(labels, want), f"{label} {name}: labels "
                f"differ from the CPU gather path "
                f"({int((labels != want).sum())} rows)")
        shape = (f"{m.n_luts} LUTs depth {m.depth}, "
                 if backend == "bitplane" else "")
        print(f"{label} {name}: {shape}labels == CPU gather == "
              f"MLP argmax; p50={stats['p50_us']:.1f}us "
              f"p95={stats['p95_us']:.1f}us batches={stats['n_batches']} "
              f"launches while serving {counts} (set-up with synthesis "
              f"{setup:.1f}s)")
        runs[kernel] = (eng, counts[kernel])
    return runs


def phase_timing(torch, runs, batch, errs, card):
    """Each kernel at the shapes of one served 256-row batch: held bit
    for bit against its plain version on the served inputs, then timed
    beside it. The bound counts the least bytes the function moves
    (``netlist_work``; lut_layer's tables at their stored width), the
    bytes of the padded plan tensors are printed beside it."""
    from repro_torch.kernels.lut_eval import (plan_stacked, plan_streamed,
                                              stacked_smem_bytes,
                                              streamed_smem_bytes)
    from repro_torch.kernels.lut_layer import (layer_smem_bytes, lut_layer,
                                               lut_layer_ref, plan_layer)
    rows = []
    # the launch floor: the smallest kernel torch launches
    one = torch.ones(1, device="cuda")
    floor, n_floor = device_us(one.zero_, None)
    require(floor is not None, "the profiler saw no device time of zero_")
    print(f"[timing] launch floor: one-element zero_ {floor:.2f} us per "
          f"launch on the device ({n_floor} launches) on {card}")

    def row(name, fn, plain, n_bytes, n_ops, launches, plan_bytes):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        dev, n = device_us(fn, f"{name}_kernel")
        b_ms, b_by = bound(n_bytes, n_ops)
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": errs.get(name, 0), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None})
        print(f"[timing] {name}: {ms:.5f} ms (plain {plain_ms:.5f} ms, "
              f"bound {b_ms:.7f} ms by {b_by}: {n_bytes} least bytes, "
              f"{n_ops} ops; plan tensors {plan_bytes} bytes); device "
              + (f"{dev:.2f} us per launch back to back ({n} launches; "
                 f"launch floor {floor:.2f} us)"
                 if n else "time not seen by the profiler") + f" on {card}")

    for name in ("lut_eval_streamed", "lut_eval"):
        eng, launches = runs[name]
        ex = eng.bitnet.executor
        words = eng.stages(batch)["quantize+pack"]()
        if name == "lut_eval_streamed":
            tp = ex.tp
            geom = (int(tp.level_of_tile.max()) + 1, tp.n_tiles,
                    tp.tile_rows, tp.k)
            bw, smem, chunk = plan_streamed(tp.n_rows, words.shape[1], *geom)
            require(chunk >= tp.n_tiles and smem, "the served plan is not "
                    "staged whole beside the plane in shared memory")
            used = streamed_smem_bytes(*geom, chunk, tp.n_rows, bw, smem)
            print(f"[timing] served JSC-S W={words.shape[1]}: the streamed "
                  f"plan ({tp.n_tiles} tiles) staged whole, {used} bytes of "
                  f"shared memory with the plane, one block of {bw} words")
        else:
            dp = ex.dp
            n_levels, lw = dp.out_wires.shape
            geom = (dp.n_wires + 1, words.shape[1], n_levels, lw, dp.k)
            bw, smem, chunk = plan_stacked(*geom)
            require(chunk >= n_levels * lw and smem, "the served stacked "
                    "plan is not staged whole beside the plane in shared "
                    "memory")
            used = stacked_smem_bytes(n_levels, lw, dp.k, chunk,
                                      dp.n_wires + 1, bw, smem)
            print(f"[timing] served JSC-S W={words.shape[1]}: the stacked "
                  f"plan ({n_levels} levels x {lw} slots, "
                  f"{int((dp.out_wires < dp.n_wires).sum())} LUTs) staged "
                  f"whole, {used} bytes of shared memory with the plane, "
                  f"one block of {bw} words")
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
        L = lt.in_spec.n_levels
        nxt = lut_layer(c, idx, tables, L)
        check(errs, "lut_layer", nxt, lut_layer_ref(c, idx, tables, L),
              f"served JSC-S batch, layer {i}")
        shape = (*c.shape, *idx.shape, tables.shape[1])
        n_tile, b_tile, smem = plan_layer(*shape)
        require(smem, f"served layer {i} {shape} is not staged in shared "
                "memory")
        dev, n = device_us(lambda c=c, idx=idx, tables=tables, L=L:
                           lut_layer(c, idx, tables, L), "lut_layer_kernel")
        print(f"[timing] lut_layer served layer {i} (B, n_in, N, K, R) "
              f"{shape}: blocks of {n_tile} neurons x {b_tile} rows, "
              f"{layer_smem_bytes(n_tile, b_tile, shape[1], shape[3], shape[4])}"
              " bytes of shared memory; device "
              + (f"{dev:.2f} us per launch back to back ({n} launches)"
                 if n else "time not seen by the profiler") + f" on {card}")
        n_bytes += nbytes(c, idx, nxt) + lt.tables.nbytes
        plan_bytes += nbytes(c, idx, tables, nxt)
        n_ops += 2 * idx.shape[1] * nxt.numel()
        c = nxt
    row("lut_layer", lambda: chain(lut_layer), lambda: chain(lut_layer_ref),
        n_bytes, n_ops, launches, plan_bytes)
    return rows


def phase_profile(torch, runs, batch, card, label=""):
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
        print(f"[profile] {label}{name} one 256-row batch: "
              f"{whole:.1f} us end to end; "
              + ", ".join(f"{k} {v:.1f} us" for k, v in parts.items())
              + f"; profiled {wall_us:.1f} us/batch, device busy "
              f"{busy:.2f} us (idle share {idle:.4f}); {symbols[kernel]} "
              f"device time {kern} on {card}")


def phase_train(torch, card):
    """The training front end on the card, then the trained network
    served through the three kernels. Returns the served engines as
    ``phase_serve`` does, and the trained model."""
    import copy

    import numpy as np
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import batches, train_test
    from repro_torch.models.mlp import init_mlp, mlp_forward, to_logic
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.train.jsc_trainer import TrainStep, train_jsc
    from repro_torch.train.optim import AdamW

    (xtr, ytr), (xte, yte) = train_test()
    init = init_mlp(JSC_S, torch.Generator().manual_seed(0))
    xb, yb = next(batches(xtr, ytr, 256, 0))
    lr = 2e-3
    # one step of JSC-S on both devices, and one of JSC-S without BN:
    # under BN a layer's b has a zero gradient up to rounding, so Adam
    # moves it by up to lr in a direction rounding picks and b is not
    # compared there; without BN b has a gradient of its own and is
    # compared with everything else
    no_bn = dataclasses.replace(JSC_S, bn=False)
    for cfg, first in ((JSC_S, init), (no_bn, None)):
        if first is None:
            first = init_mlp(cfg, torch.Generator().manual_seed(0))
        after = {}
        with tf32(False):
            for dev in ("cpu", "cuda"):
                model = copy.deepcopy(first).to(dev)
                step = TrainStep(cfg, model, AdamW(
                    lr=lr, weight_decay=1e-4, grad_clip=1.0))
                loss, grads = step.loss_and_grads(xb, yb)
                step.opt.update(grads, step.state, step.params)
                sd = model.state_dict()
                after[dev] = (
                    [loss] + list(grads) + list(sd.values()),
                    ["loss"] + [f"grad {i}" for i in range(len(grads))]
                    + list(sd))
        worst, skipped = 0.0, []
        for got, want, name in zip(after["cuda"][0], after["cpu"][0],
                                   after["cpu"][1]):
            got, want = got.detach().cpu(), want.detach()
            if want.dtype == torch.bool:
                require(torch.equal(got, want),
                        f"train step: {name} differs")
                continue
            if cfg.bn and name.endswith(".b"):
                skipped.append(name)
                continue
            tol = STEP_TOL * max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            require(err <= tol, f"train step on the card ({cfg.name}, bn "
                    f"{cfg.bn}): {name} differs from the CPU's by {err} "
                    f"(tolerance {tol})")
            worst = max(worst, err)
        require(not cfg.bn or len(skipped) == cfg.n_layers,
                f"train step: skipped {skipped}")
        print(f"[train] one {cfg.name} step with BN {cfg.bn} (loss, "
              f"{len(grads)} gradients, "
              + ("BN statistics, " if cfg.bn else "")
              + f"parameters after AdamW) on the card == the CPU's within {STEP_TOL} x "
              f"max(1, |cpu|) (max abs difference {worst:.3g}; "
              + (f"{', '.join(skipped)} not compared: a gradient of "
                 "rounding noise under BN" if cfg.bn else "b compared")
              + "), TF32 off")

    # where one training step's time goes: host clock per step (ends in
    # a synchronize) against the device's busy time (torch.profiler)
    from torch.profiler import ProfilerActivity, profile
    step = TrainStep(JSC_S, copy.deepcopy(init).cuda(),
                     AdamW(lr=lr, weight_decay=1e-4, grad_clip=1.0))
    for _ in range(5):
        step(xb, yb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step(xb, yb)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            step(xb, yb)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
                  for e in dev_events) / 20
    n_dev = sum(e.count for e in dev_events) / 20
    host = sorted((e for e in events
                   if e.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:4]
    print(f"[train] one JSC-S QAT step: {wall_ms:.3f} ms host clock, "
          f"device busy {busy_us:.1f} us over {n_dev:.0f} device "
          f"operations (idle share {1 - busy_us / (wall_ms * 1e3):.4f}); "
          "most host time in " + ", ".join(
              f"{e.key} {e.self_cpu_time_total / 20:.0f} us x "
              f"{e.count / 20:.0f}" for e in host) + f" per step on {card}")
    print(f"[train] float32 matmuls: TF32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    res = train_jsc(JSC_S, steps=TRAIN_STEPS, device="cuda")
    print(f"[train] JSC-S {TRAIN_STEPS} QAT + FCP steps and "
          f"{res.steps - TRAIN_STEPS} fine-tune steps of 256 rows on the "
          f"card: {res.seconds['qat'] * 1e3 / res.steps:.3f} ms per step "
          f"({res.seconds['qat']:.2f} s); float reference 800 steps "
          f"{res.seconds['float'] * 1e3 / 800:.3f} ms per step; test acc "
          f"{res.test_acc:.4f}, train acc {res.train_acc:.4f}, float test "
          f"acc {res.float_test_acc:.4f} on {card}")
    require(res.test_acc > 0.5, f"trained JSC-S test accuracy "
            f"{res.test_acc} is not above 0.5")
    for i, layer in enumerate(res.model.layers):
        require(int(layer.mask.sum(1).max()) <= JSC_S.fanins[i],
                f"trained layer {i} exceeds its fanin")

    t0 = time.perf_counter()
    net = to_logic(JSC_S, res.model)
    reqs = [xte[i * ROWS_PER_REQUEST: (i + 1) * ROWS_PER_REQUEST]
            for i in range(N_REQUESTS)]
    x = np.concatenate(reqs)
    want = LogicEngine(net, JSC_S.n_classes, backend="gather",
                       device="cpu").classify(x)
    mlp_labels = torch.argmax(mlp_forward(JSC_S, res.model,
                                          torch.from_numpy(x).cuda())
                              [:, :JSC_S.n_classes], dim=-1).cpu().numpy()
    require(np.array_equal(mlp_labels, want), "trained JSC-S: CPU gather "
            "labels differ from the trained MLP's argmax on the card "
            f"({int((mlp_labels != want).sum())} rows)")
    print(f"[train] trained JSC-S compiled to tables in "
          f"{time.perf_counter() - t0:.1f}s; CPU gather acc "
          f"{float(np.mean(want == yte[: x.shape[0]])):.4f} on "
          f"{x.shape[0]} rows == the trained MLP's argmax on the card")
    return (serve_engines(torch, net, reqs, want, "[train] served trained"),
            res.model)


def phase_verify(torch, card, trained, model):
    """The verification slice on the trained network of the train phase
    (``trained`` as ``serve_engines`` returns it, ``model`` its MLP):
    the check pipeline with SAT proofs and the serving preflight, the
    plan check's branch against each walk's own launch at the serving
    batch, corrupted plans refused with no launch, the streamed walk's
    autotune sweep on the card and a new executor taking its winner, the
    launcher's ``--check`` on both walks, and the Table 1 twin on JSC-S
    with the launcher's step count."""
    import copy
    import tempfile

    import numpy as np
    from repro_torch.bench.table1_jsc import run_one
    from repro_torch.check import (CheckFailure, check_synth_pipeline,
                                   preflight)
    from repro_torch.check.plan_check import SERVE_WORDS
    from repro_torch.configs.jsc import JSC_S
    from repro_torch.data.jsc import train_test
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.lut_eval import (autotune, lut_eval,
                                              lut_eval_streamed)
    from repro_torch.kernels.spec import DEFAULT_SPEC
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.synth import compile_device_plan
    from repro_torch.synth.executor import (BitplaneNetwork,
                                            _CudaStreamedExecutor)
    from repro_torch.weights import save_params_npz

    t_phase = time.perf_counter()
    streamed = trained["lut_eval_streamed"][0].bitnet
    mono = trained["lut_eval"][0].bitnet
    net = streamed.net
    (_, _), (xte, _) = train_test()
    x = xte[: N_REQUESTS * ROWS_PER_REQUEST]
    want = LogicEngine(net, JSC_S.n_classes, backend="gather",
                       device="cpu").classify(x)

    # the check pipeline, SAT proofs included, and the serving preflight
    t0 = time.perf_counter()
    rep = check_synth_pipeline(net=net, formal=True)
    require(rep.ok, "check_synth_pipeline(formal=True) on the trained "
            "network:\n" + rep.format())
    for key in sorted(k for k in rep.info if k.startswith("formal[")):
        st = rep.info[key]
        print(f"[verify] formal {key[7:-1]}: {st['verdict']} "
              f"({st.get('outputs', '?')} outputs, {st.get('queries', 0)} "
              f"SAT queries, {st.get('conflicts', 0)} conflicts)")
        require(st["verdict"] == "UNSAT", f"formal {key}: {st['verdict']}")
    sw = rep.info["sat_sweep"]
    print(f"[verify] {rep.format()} ({rep.info['n_luts']} LUTs, depth "
          f"{rep.info['depth']}; sat sweep {sw['dup_lut_outputs']} "
          f"duplicate LUT outputs) in {time.perf_counter() - t0:.1f}s")
    words = streamed.pack_inputs(x[: 256])
    require(tuple(words.shape) == (streamed.mapped.n_pis, SERVE_WORDS),
            f"serving batch words {tuple(words.shape)}")
    for walk, bn, fn in (("lut_eval", mono, lut_eval),
                         ("lut_eval_streamed", streamed, lut_eval_streamed)):
        pre = preflight(bn)
        require(pre.ok, f"preflight ({bn.engine}):\n" + pre.format())
        branch = pre.info[walk]
        bn.executor.plane(words)        # the walk's own launch at W = 8
        torch.cuda.synchronize()
        took = fn.last_plan
        require(took == (branch["block_w"], branch["plane"] == "shared",
                         branch["chunk"]),
                f"{walk}: the plan check reports {branch}, the wrapper "
                f"launched (block_w, plane in shared, chunk) = {took}")
        print(f"[verify] preflight {bn.engine}: OK ({pre.checked} checks); "
              f"{walk} at W = {SERVE_WORDS}: plane in {branch['plane']} "
              f"memory, plan {branch['plan']} (chunk {branch['chunk']}), "
              f"{branch['block_w']} words a block, {branch['smem_bytes']} "
              f"bytes of shared memory == the wrapper's launch {took}")

    # a corrupted plan is refused before any launch
    n_wires = 1 + mono.mapped.n_pis + mono.mapped.n_luts
    before = launch_counts()
    for code, corrupt in (
            ("leaf-range", lambda p: p.levels[0].leaf_idx.__setitem__(
                (0, 0), n_wires)),
            ("out-range", lambda p: p.levels[-1].out_wires.__setitem__(
                0, n_wires + 5)),
            ("tt-encoding", lambda p: p.levels[0].tt_bits.__setitem__(
                (0, 0), 5))):
        bad = copy.copy(mono)
        bad._plan = copy.deepcopy(mono._plan)
        corrupt(bad._plan)
        try:
            compile_device_plan(bad.mapped, bad._plan, verify=True)
            raise SmokeFailure(f"compile_device_plan(verify=True) took a "
                               f"plan with a {code} fault")
        except CheckFailure as e:
            got = sorted({i.code for i in e.report.errors})
        pre = preflight(bad)
        require(code in got and not pre.ok
                and code in {i.code for i in pre.errors},
                f"corrupted plan ({code}): verify gave {got}, preflight "
                f"{pre.format()}")
        print(f"[verify] corrupted plan ({code}): compile_device_plan"
              f"(verify=True) raised CheckFailure {got}; preflight FAIL")
    require(launch_counts() == before, f"a kernel launched while checking "
            f"corrupted plans: {before} -> {launch_counts()}")

    # the streamed walk's autotune sweep, into a temporary cache
    cache_dir = tempfile.mkdtemp(prefix="autotune-")
    os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(cache_dir,
                                                      "tiles.json")
    try:
        for tile_rows, block_w in autotune.DEFAULT_CANDIDATES:
            ex = _CudaStreamedExecutor(streamed, spec=DEFAULT_SPEC.with_tile(
                tile_rows=tile_rows, block_w=block_w))
            n = lut_eval_streamed.launches
            got = ex.plane(words)
            torch.cuda.synchronize()
            require(lut_eval_streamed.launches == n + 1
                    and torch.equal(got, ex.plane(words, plain=True)),
                    f"streamed plane at tile_rows {tile_rows}, block_w "
                    f"{block_w} differs from its plain version")
        timings = []
        best = autotune.autotune_streamed(streamed, words, timings=timings)
        for tile_rows, block_w, us in timings:
            print(f"[verify] autotune tile_rows {tile_rows:3d} block_w "
                  f"{block_w:3d}: {us:.3f} us a batch of {SERVE_WORDS} "
                  f"words (plane bit-exact) on {card}")
        print(f"[verify] autotune winner tile_rows {best[0]} block_w "
              f"{best[1]}: {best[2]:.3f} us")
        tuned = BitplaneNetwork(net, streamed.mapped, engine="cuda-streamed",
                                device="cuda")
        tex = tuned.executor
        require((tex.spec.tile.tile_rows, tex.spec.tile.block_w,
                 tex.tp.tile_rows) == (best[0], best[1], best[0]),
                f"a new streamed executor took {tex.spec.tile}, not the "
                f"winner {best[:2]}")
        n = lut_eval_streamed.launches
        labels = tuned.classify(x, JSC_S.n_classes)
        require(lut_eval_streamed.launches > n
                and np.array_equal(labels, want),
                "the tuned streamed executor's labels differ from classify's "
                f"({int((labels != want).sum())} rows)")
        print(f"[verify] new executor took tile_rows {best[0]} block_w "
              f"{best[1]} from the cache; {labels.shape[0]} labels == "
              "classify's (CPU gather)")
    finally:
        os.environ["REPRO_AUTOTUNE_CACHE"] = ""

    # the launcher's --check on both walks, serving the trained weights
    npz = os.path.join(cache_dir, "jsc_s.npz")
    save_params_npz(npz, model)
    for engine, kernel in (("cuda", "lut_eval"),
                           ("cuda-streamed", "lut_eval_streamed")):
        out = serve_main(["--mode", "logic", "--backend", "bitplane",
                          "--engine", engine, "--params", npz, "--check",
                          "--requests", str(N_REQUESTS)])
        require(out["preflight"].ok and np.array_equal(out["labels"], want)
                and out["launches"][kernel] > 0,
                f"--check with engine {engine}: preflight "
                f"{out['preflight'].ok}, labels differ in "
                f"{int((out['labels'] != want).sum())} rows, launches "
                f"{out['launches']}")
        print(f"[verify] launcher --check --engine {engine}: preflight OK, "
              f"{out['labels'].shape[0]} labels unchanged, launches "
              f"{out['launches']}")

    # the Table 1 twin on JSC-S, the launcher's step count
    t0 = time.perf_counter()
    n = lut_eval_streamed.launches
    r = run_one("jsc-s", steps=TRAIN_STEPS, device="cuda")
    t_table = time.perf_counter() - t0
    require(r["synth"]["equivalent"] and lut_eval_streamed.launches > n,
            f"Table 1 twin: mapped netlist not equivalent on the card ({r})")
    print(f"[verify] table1 jsc-s ({TRAIN_STEPS} steps): acc "
          f"{r['accuracy']:.4f} (LogicNets {r['logicnets_accuracy']:.4f}); "
          f"NullaNet {r['nullanet']['luts']} LUTs {r['nullanet']['ffs']} FFs "
          f"depth {r['nullanet']['depth']} against LogicNets "
          f"{r['logicnets_baseline']['luts']} LUTs "
          f"{r['logicnets_baseline']['ffs']} FFs: LUTs "
          f"{r['lut_reduction_x']}x fewer, fmax {r['fmax_increase_x']}x, "
          f"latency {r['latency_reduction_x']}x; whole network "
          f"{r['synth']['luts']} LUTs, sat sweep "
          f"{r['synth']['sat_sweep']['dup_lut_outputs']} duplicate pairs; "
          f"{t_table:.1f}s")
    shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"[verify] phase {time.perf_counter() - t_phase:.1f}s")


LOADGEN_BACKENDS = ("gather", "lut_layer", "bitplane-cuda",
                    "bitplane-streamed")
LOADGEN_KERNELS = ("lut_eval_streamed", "lut_eval", "lut_layer")
LOADGEN_PROFILE_ITERS = 200   # launches per latency-table prefix (the
#                               reference's fast mode takes 2)


def scrape(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as r:
        require(r.status == 200, f"{url}: HTTP {r.status}")
        return r.read().decode()


def phase_loadgen(torch, card, trained):
    """The serving-at-scale path: the loadgen harness on four backends
    with two replicas, traced and published behind the metrics
    endpoint, from launch counts at 0; then the trained network of the
    train phase (``trained``, as ``serve_engines`` returns it) under
    the scheduler with 1 and 2 replicas, for qps, percentiles and the
    device's idle share."""
    import gc
    import math
    import tempfile

    import numpy as np
    from repro_torch.bench import loadgen as lg
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import (LatencyTable, MetricsRegistry,
                                 MetricsServer, analyze_trace)

    # every garbage-collector pass of the run, on the tracer's clock
    # (perf_counter µs): a pass stops the scheduler thread with the rest
    gc_passes, gc_start = [], {}

    def on_gc(phase, info):
        now = time.perf_counter() * 1e6
        if phase == "start":
            gc_start["t"] = now
        else:
            gc_passes.append((info["generation"], gc_start.get("t", now),
                              now))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "t.json")
        reg = MetricsRegistry()
        srv = MetricsServer(reg, port=0)
        gc.callbacks.append(on_gc)
        try:
            reset_launch_counts()
            out = lg.run(fast=True, backends=LOADGEN_BACKENDS,
                         loadgen="both", n_replicas=2, trace=trace,
                         registry=reg, write_json=False,
                         profile_iters=LOADGEN_PROFILE_ITERS)
            counts = launch_counts()
            prom = scrape(srv.url)
            snap = json.loads(scrape(srv.url + ".json"))
        finally:
            gc.callbacks.remove(on_gc)
            srv.close()
        seconds = time.perf_counter() - t0
        report = analyze_trace(trace)
        table = LatencyTable.load(out["trace"]["lut_table"])

    require(out["argmax_identical_across_backends"],
            "loadgen: argmax differs across backends")
    for b, rec in out["backends"].items():
        for sec, key in (("open_loop", "identical_to_classify"),
                         ("closed_loop", "identical_to_classify"),
                         ("slo_lanes", "identical_on_served")):
            require(rec[sec][key], f"loadgen {b}/{sec}: labels differ from "
                    "classify")
    for k in LOADGEN_KERNELS:
        require(counts[k] > 0, f"loadgen: {k} was not launched (counts "
                f"{counts})")
    for b in LOADGEN_BACKENDS:
        require(f"{b}.windows" in snap and snap[f"{b}.windows"]["lanes"],
                f"/metrics.json has no window series of {b}")
        name = re.sub(r"[^a-zA-Z0-9_:]", "_", f"{b}.windows.window_us")
        require(f"repro_{name} " in prom,
                f"/metrics has no window series of {b}")
    rec = report.reconciliation()
    require(rec["ok"] and rec["n_checked"] > 0,
            f"loadgen trace does not reconcile: {rec}")
    require(out["trace"]["dropped"] == 0,
            f"loadgen trace dropped {out['trace']['dropped']} events")
    walks = {r["source"] for r in table.rows}
    require({"plan", "tile"} <= walks, f"latency table rows {walks}")
    require(all(math.isfinite(r["device_us"]) and r["device_us"] >= 0
                for r in table.rows), "latency table: a row is not finite "
            "and non-negative")
    require(table.meta.get("backend") == "cuda"
            and table.meta.get("device") == torch.cuda.get_device_name(0),
            f"latency table meta {table.meta}")

    print(f"[loadgen] run on {LOADGEN_BACKENDS}, 2 replicas, "
          f"{out['n_requests']} requests a section, {out['train_steps']} "
          f"training steps: {seconds:.1f}s; launches {counts}; offered "
          f"{out['offered_qps']} qps open loop, {out['slo_offered_qps']} "
          f"qps SLO lanes {out['slo_us']} us; sequential baseline "
          f"{out['baseline_sequential']['qps']:.1f} qps on {card}")
    for b, r in out["backends"].items():
        for sec in ("open_loop", "closed_loop"):
            x = r[sec]
            print(f"[loadgen] {b}/{sec}: {x['qps']:.1f} qps p50 "
                  f"{x['p50_us']:.1f} p95 {x['p95_us']:.1f} p99 "
                  f"{x['p99_us']:.1f} us, occupancy "
                  f"{x['mean_batch_occupancy']:.4f} ({x['n_batches']} "
                  f"batches), shed {x['shed']}, miss rate "
                  f"{x['deadline_miss_rate']:.4f}")
        lanes = r["slo_lanes"]
        print(f"[loadgen] {b}/slo_lanes: {lanes['qps']:.1f} qps, shed "
              f"{lanes['shed']}, miss rate {lanes['deadline_miss_rate']}; "
              + "; ".join(f"lane {k} p50 {v['p50_us']:.1f} p99 "
                          f"{v['p99_us']:.1f} us attainment "
                          f"{v['slo_attainment']}"
                          for k, v in lanes["lanes"].items()))
        if "online_profile" in r:
            print(f"[loadgen] {b}: calibrated netlist estimate "
                  f"{out['trace']['exec_estimate_us'][b]} us/batch; online "
                  f"profile {r['online_profile']}")
    print(f"[loadgen] tracer overhead {out['tracer_overhead']}")
    print(f"[loadgen] trace: {out['trace']['events']} events, "
          f"reconciliation {rec}")
    long_gc = [(g, a, b) for g, a, b in gc_passes if b - a >= 10_000]
    slow = [r for r in report.requests if r.latency_us is not None
            and r.t_begin_us is not None and r.latency_us >= 20_000]
    hit = [r for r in slow if any(a < r.t_end_us and b > r.t_begin_us
                                  for _, a, b in long_gc)]
    print(f"[loadgen] garbage collection during the run: {len(gc_passes)} "
          f"passes (generation 0/1/2: "
          + "/".join(str(sum(1 for p in gc_passes if p[0] == g))
                     for g in (0, 1, 2))
          + f"), passes of 10 ms or more (generation, us): "
          f"{[(g, round(b - a, 1)) for g, a, b in long_gc]}; requests "
          f"slower than 20 ms: {len(slow)} of {len(report.requests)}, "
          f"{len(hit)} of them in flight during such a pass")
    print(f"[loadgen] latency table meta {table.meta}")
    for r in table.rows:
        where = (f"level {r['level']}" if r["source"] == "plan" else
                 f"tile {r['tile']} (level {r['level']})"
                 if r["source"] == "tile" else
                 f"width {r['level_width']} fanin {r['fanin']}")
        print(f"[loadgen] latency table {r['source']} {where}: "
              f"{r['device_us']:.3f} us"
              + (f" (prefix {r['prefix_us']:.3f} us)" if "prefix_us" in r
                 else "") + f" at w_words {r['w_words']} on {card}")
    sched_rows(torch, card, trained, out["offered_qps"], table)


def sched_rows(torch, card, trained, offered_qps, table):
    """The trained network under the scheduler: each backend with 1 and
    2 replicas (a second engine of its own; ``least_slack``), open loop
    at ``offered_qps`` and closed loop, 1,000 one-row requests of the
    test split. qps, percentiles and occupancy come from an unprofiled
    run, the device's idle share from a second, profiled run of the
    same section; with one replica the bitplane aggregator feeds an
    ``OnlineProfiler`` seeded from ``table``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bench import loadgen as lg
    from repro_torch.data.jsc import train_test
    from repro_torch.obs import LatencyTable, OnlineProfiler
    from repro_torch.serve import ReplicaSet
    from repro_torch.serving.engine import LogicEngine
    from repro_torch.synth import compile_device_plan

    xte = train_test()[1][0]
    xs = np.ascontiguousarray(xte[np.arange(1000) % xte.shape[0]],
                              np.float32)
    net = trained["lut_layer"][0].net
    engines = {"gather": LogicEngine(net, 5, backend="gather",
                                     device="cuda"),
               "lut_layer": trained["lut_layer"][0],
               "bitplane-cuda": trained["lut_eval"][0],
               "bitplane-streamed": trained["lut_eval_streamed"][0]}
    want = engines["gather"].classify(xs)
    for b, eng in engines.items():
        twin = LogicEngine(net, 5, backend=eng.backend, engine=eng.engine,
                           device="cuda")
        for n_rep in (1, 2):
            prof = None
            if n_rep == 1:
                ex = eng.scheduler_executor()
                if eng.aggregator is not None:
                    est = table.estimate_plan_us(
                        compile_device_plan(eng.bitnet.mapped))
                    prof = OnlineProfiler(LatencyTable(
                        rows=table.rows, meta=table.meta),
                        predicted_us=est, sample_every=4)
                    eng.aggregator.on_device_us = prof.observe
            else:
                ex = ReplicaSet([eng.scheduler_executor(),
                                 twin.scheduler_executor()],
                                policy="least_slack", n_features=16)
            for loop in ("open", "closed"):
                def go():
                    if loop == "open":
                        return lg.run_open_loop(ex, xs, offered_qps,
                                                max_batch=256)
                    return lg.run_closed_loop(ex, xs, max_batch=256)
                got, snap = go()
                require(np.array_equal(got, want), f"sched {b} x{n_rep} "
                        f"{loop} loop: labels differ from classify")
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    t0 = time.perf_counter()
                    go()
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
                busy = sum(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
                           for e in p.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA)
                print(f"[sched] trained {b} x{n_rep} {loop} loop: "
                      f"{snap['qps']:.1f} qps p50 {snap['p50_us']:.1f} p95 "
                      f"{snap['p95_us']:.1f} p99 {snap['p99_us']:.1f} us, "
                      f"occupancy {snap['mean_batch_occupancy']:.4f} "
                      f"({snap['n_batches']} batches); profiled run device "
                      f"busy {busy:.1f} of {wall_us:.1f} us (idle share "
                      f"{1.0 - busy / wall_us:.4f}) on {card}")
            if prof is not None:
                eng.aggregator.on_device_us = None
                print(f"[sched] trained {b} x1 online profile "
                      f"{prof.stats()} (wall us around classify_packed: "
                      "host dispatch plus device)")


def phase_kernels2(torch, errs):
    """Every kernel of the kernel-bench path against its plain version on
    the card: the bench's own inputs, and ragged shapes."""
    import numpy as np
    from repro_torch import synth
    from repro_torch.bench.kernels_bench import FULL, make_inputs
    from repro_torch.kernels.aig_sim import aig_sim
    from repro_torch.kernels.fanin_matmul import fanin_matmul, fanin_matmul_ref
    from repro_torch.kernels.fanin_matmul.ops import plan_fanin
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.lut_eval import (lut_eval, lut_eval_ref,
                                              lut_eval_streamed,
                                              lut_eval_streamed_ref)
    from repro_torch.kernels.lut_layer import lut_layer, lut_layer_ref
    from repro_torch.kernels.aig_sim.ops import max_sweeps
    from repro_torch.kernels.xnor_popcount import (pack_bipolar,
                                                   xnor_matmul_packed,
                                                   xnor_matmul_ref,
                                                   xnor_popcount_ref)
    from repro_torch.kernels.xnor_popcount.ops import loads_vectorized
    from repro_torch.synth.simulate import _simulate_np
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    inp = make_inputs(dev, FULL)
    print(f"[kernels2] bench inputs (two AIGs synthesized) in "
          f"{time.perf_counter() - t0:.1f}s")

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    a = inp.lut_layer
    shape = (*a.codes.shape, a.idx.shape[0], a.idx.shape[1], a.L)
    check(errs, "lut_layer", lut_layer(a.codes, a.idx, a.tables, a.L),
          lut_layer_ref(a.codes, a.idx, a.tables, a.L), f"bench {shape}")
    a = inp.lut_eval
    check(errs, "lut_eval",
          lut_eval(a.words, a.leaf_idx, a.tt_bits, a.out_wires,
                   n_wires=a.dp.n_wires),
          lut_eval_ref(a.words, a.leaf_idx, a.tt_bits, a.out_wires,
                       n_wires=a.dp.n_wires), "bench netlist")
    targs = (a.words, a.tt_tiles, a.leaf_tiles, a.out_base, a.level_start)
    check(errs, "lut_eval_streamed",
          lut_eval_streamed(*targs, n_rows=a.tp.n_rows),
          lut_eval_streamed_ref(*targs, n_rows=a.tp.n_rows), "bench netlist")
    print(f"[kernels2] lut_layer {shape}, lut_eval and lut_eval_streamed "
          f"(T={a.tp.tile_rows}) == plain on the bench's "
          f"{a.mapped.n_luts}-LUT netlist at W={a.words.shape[1]}")

    a = inp.aig
    for n_words in (1, 7, 256):
        words = (a.host_words if n_words == 256 else
                 synth.random_words(a.n_pis, n_words, seed=n_words))
        tw, smem = walk_check(torch, errs, a.f0, a.f1, a.n_pis, words,
                              f"bench AIG ({a.f0.shape[0]} ANDs)")
        require(smem, f"bench AIG W={n_words}: planes not in shared memory")
        routed = aig_sim(words, a.f0, a.f1, a.n_pis, device=dev)
        require(np.array_equal(routed, _simulate_np(a.aig, words)),
                f"aig_sim route W={n_words}: differs from the numpy walk")
        require(np.array_equal(synth.simulate(a.aig, words, use_kernel=True,
                                              device=dev),
                               synth.simulate(a.aig, words)),
                f"simulate(use_kernel=True) W={n_words} differs")
        print(f"[kernels2] aig_sim walk == plain on the bench AIG "
              f"({a.f0.shape[0]} ANDs) at W={n_words}: tiles of {tw} words, "
              f"{-(-n_words // tw)} blocks, planes in shared memory; route "
              "== numpy walk")
    # a strict chain (depth = node count), random literals reaching the
    # node itself and later rows (read 0), a 60,000-AND DAG whose
    # planes cannot fit shared memory, and chains of inverters, whose
    # values change in every sweep up to the cap (the walk then
    # finishes in node order), in shared and in device memory
    cases = [("strict chain of 2,500 ANDs", strict_chain(3, 16, 2500), 16,
              (1, 200), True),
             ("forward literals, 3,000 ANDs", forward_literals(4, 5, 3000),
              5, (1, 33), True),
             ("60,000-AND DAG", chain_literals(5, 16, 60_000), 16,
              (1, 7, 200), False),
             ("chain of 2,500 inverters", toggling_chain(16, 2500), 16,
              (1, 200), True),
             ("chain of 60,000 inverters", toggling_chain(16, 60_000), 16,
              (3,), False)]
    for label, (f0, f1), n_pis, widths, in_smem in cases:
        if "inverters" in label:     # depth n_ands, a change every sweep
            require(len(f0) > max_sweeps(len(f0)), f"aig_sim {label}: "
                    "the sweeps end before their cap")
        for n_words in widths:
            words = synth.random_words(n_pis, n_words, seed=n_words)
            tw, smem = walk_check(torch, errs, f0, f1, n_pis, words, label)
            require(smem == in_smem, f"aig_sim {label} W={n_words}: planes "
                    f"in shared memory {smem}, expected {in_smem}")
        print(f"[kernels2] aig_sim walk == plain on the {label}, W in "
              f"{'/'.join(map(str, widths))}: planes in "
              f"{'shared' if in_smem else 'device'} memory"
              + (f"; {max_sweeps(len(f0))} sweeps, then node order"
                 if "inverters" in label else ""))

    rng = np.random.default_rng(11)
    xshapes = [(256, 4096, 256, False), (256, 4096, 256, True),
               (37, 100, 70, True), (1, 7, 1, True), (300, 1000, 33, False),
               (17, 257, 9, True), (33, 1000, 65, False),
               (64, 4096, 24, True), (64, 4000, 24, False)]
    vec_seen = set()
    for (B, n, N, zeros) in xshapes:
        if (B, n, N, zeros) == (256, 4096, 256, False):
            x, w = inp.xnor.x, inp.xnor.w
        else:
            vals = [-1.0, 0.0, 1.0] if zeros else [-1.0, 1.0]
            x = t(rng.choice(vals, (B, n)), torch.float32)
            w = t(rng.choice(vals, (N, n)), torch.float32)
        xp, wp = pack_bipolar(x), pack_bipolar(w)
        vec_seen.add(loads_vectorized(xp, wp))
        got = xnor_matmul_packed(xp, wp, n)
        check(errs, "xnor_popcount", got, xnor_popcount_ref(xp, wp, n),
              f"{(B, n, N)} zeros={zeros}")
        if not zeros:
            check(errs, "xnor_popcount", got, xnor_matmul_ref(x, w),
                  f"{(B, n, N)} against the float oracle")
    require(vec_seen == {True, False}, "xnor_popcount: its 16-byte and its "
            f"word-by-word loads were not both reached ({vec_seen})")
    # packed words with their pad bits set: every bit of every word counts
    for (B, n, N) in ((33, 1000, 65), (64, 4000, 24)):
        xp, wp = (t(rng.integers(0, 1 << 32, (r, -(-n // 32)),
                                 dtype=np.uint32).view(np.int32))
                  for r in (B, N))
        check(errs, "xnor_popcount", xnor_matmul_packed(xp, wp, n),
              xnor_popcount_ref(xp, wp, n), f"{(B, n, N)} pad bits set")
    print(f"[kernels2] xnor_popcount (binary tensor cores) == plain on "
          f"{len(xshapes)} shapes, 16-byte and word-by-word loads (== the "
          "float oracle on +-1 inputs), and with pad bits set")

    # fanin_matmul bit for bit in each type, NaN positions included, on
    # both branches of plan_fanin: rows staged in shared memory (1 and 2
    # a block, neurons split over blocks, several neurons a thread) and
    # rows too wide to stage (n_in 60,000 in float32, 120,000 in every
    # type; 1 and 2 a block), indices that wrap and indices out of
    # range; the bench's own inputs first
    fshapes = [(256, 4096, 1024, 8), (70, 33, 45, 3), (8, 4096, 1024, 8),
               (129, 1001, 257, 13), (513, 2000, 3000, 5),
               (9, 500, 37, 300), (5, 60_000, 70, 9), (300, 60_000, 33, 4),
               (3, 120_000, 40, 4), (300, 120_000, 20, 3)]
    branches = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for (B, n_in, N, K) in fshapes:
            if (B, n_in, N, K) == fshapes[0] and dtype == torch.float32:
                f = inp.fanin
                x, idx, w, bias = f.x, f.idx, f.w, f.bias
            else:
                x, idx, w, bias = fanin_operands(rng, B, n_in, N, K, dtype,
                                                 dev)
            plan = plan_fanin(B, n_in, N, dtype)
            branches.setdefault(dtype, set()).add((plan.staged, plan.rows))
            check_nan_equal(errs, "fanin_matmul", fanin_matmul(x, idx, w, bias),
                            fanin_matmul_ref(x, idx, w, bias),
                            f"{dtype} {(B, n_in, N, K)}")
    for dtype, seen in branches.items():
        require(seen == {(True, 1), (True, 2), (False, 1), (False, 2)},
                f"fanin_matmul {dtype}: branches reached {sorted(seen)}, "
                "expected 1 and 2 rows a block, staged and in device memory")
    print(f"[kernels2] fanin_matmul == plain (NaN positions included) in "
          f"float32 / bf16 / f16 on {len(fshapes)} shapes each: 1 and 2 rows "
          "a block, staged and in device memory, wrapped and out-of-range "
          "indices")

    # bench, window, ragged / GQA, Sq != Sk, dh 128, fully masked rows;
    # then the 16 template (dh 8) and the K / V copy widths (dh 6, 5, 7,
    # 12: 8- and 4-byte copies in float32, 4-, 2- and 8-byte in bf16)
    ashapes = [(1, 1024, 1024, 4, 2, 64, True, 0),
               (1, 300, 300, 4, 1, 32, True, 64),
               (2, 130, 77, 4, 2, 16, True, 0),
               (1, 33, 70, 4, 4, 8, False, 0),
               (1, 257, 257, 2, 1, 128, True, 0),
               (1, 300, 130, 1, 1, 8, True, 4),
               (1, 130, 130, 2, 1, 100, True, 0),
               (1, 65, 200, 3, 1, 6, True, 0),
               (1, 65, 200, 3, 3, 5, False, 0),
               (1, 65, 200, 2, 1, 7, True, 9),
               (1, 65, 200, 2, 1, 12, True, 0)]
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for (b, sq, sk, h, kv, dh, causal, win) in ashapes:
            if sq == 1024:
                q, k, v = inp.flash.q, inp.flash.k, inp.flash.v
            else:
                q = t(rng.normal(size=(b, sq, h, dh)), torch.float32)
                k = t(rng.normal(size=(b, sk, kv, dh)), torch.float32)
                v = t(rng.normal(size=(b, sk, kv, dh)), torch.float32)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            with tf32(False):
                want = attention_ref(q, k, v, causal=causal, window=win)
            name = ("flash_attention" if dtype == torch.float32
                    else "flash_attention bf16")
            check_close(errs, name,
                        flash_attention(q, k, v, causal=causal, window=win),
                        want, tol, f"{(b, sq, sk, h, kv, dh, causal, win)}")
        print(f"[kernels2] flash_attention {dtype} within {tol} of plain on "
              f"{len(ashapes)} shapes (dh templates 16/32/64/128, every "
              f"copy width; max abs err "
              f"{errs['flash_attention' if tol == 2e-4 else 'flash_attention bf16']:.3g})")
    return inp


def phase_bench(torch):
    """The kernel-bench path, once, from every launch count at 0."""
    from repro_torch.bench.kernels_bench import run
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t0 = time.perf_counter()
    reset_launch_counts()
    rows = run(device="cuda")
    counts = launch_counts()
    for name in BENCH_KERNELS:
        require(counts[name] > 0, f"bench: {name} was not launched "
                f"(counts {counts})")
    require(all(math.isfinite(v) and v > 0 for v in rows.values()),
            f"bench: a row is not a positive time: {rows}")
    print(f"[bench] {len(rows)} rows in {time.perf_counter() - t0:.1f}s; "
          f"launches {counts}")
    print("[bench] us per call: " + ", ".join(f"{k} {v:.1f}"
                                              for k, v in rows.items()))
    return counts


def phase_latency(torch, card):
    """The benchmark runner's latency and kernels sections, once, from
    every launch count at 0 (``repro_torch.bench.run --fast``): the
    latency section's own launches, its kernel paths held bit for bit
    against their plain counterparts on its inputs, both
    ``execute_packed`` walks on the trained netlist at W = 8 against the
    host fold, the regression gate over the written records against
    themselves and the history ledger's idempotent append."""
    import io
    import tempfile

    import numpy as np
    from repro_torch.bench import check_regression, history, latency, run
    from repro_torch.core.logic_infer import classify
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.xnor_popcount import xnor_matmul, xnor_matmul_ref
    from repro_torch.synth import (execute_packed, execute_packed_cuda,
                                   execute_packed_streamed, random_words)
    t0 = time.perf_counter()
    section_counts = {}
    timed = latency.run

    def counted(**kw):                # the latency section's own launches
        out = timed(**kw)
        section_counts.update(launch_counts())
        return out

    with tempfile.TemporaryDirectory() as tmp:
        ledger = os.path.join(tmp, "history.jsonl")
        latency.run = counted
        try:
            reset_launch_counts()
            res = run.main(["--fast", "--only", "latency,kernels",
                            "--out-dir", tmp, "--history", ledger])
        finally:
            latency.run = timed
        counts = launch_counts()
        for name in ("lut_layer", "xnor_popcount", "lut_eval_streamed"):
            require(section_counts.get(name, 0) > 0,
                    f"latency: {name} was not launched by the latency "
                    f"section (counts {section_counts})")
        rec = res["latency"]
        require(rec["backend"] == "cuda", f"latency: record on {rec}")
        require(all(rec["identical"].values()),
                f"latency: a kernel path differs: {rec['identical']}")

        lr = latency.last_run
        net, x = lr.net, lr.x
        require(torch.equal(net(x, use_kernel=True), net(x)),
                "latency: net(x, use_kernel=True) differs from net(x)")
        sx = torch.sign(x)
        require(torch.equal(xnor_matmul(sx, lr.wq),
                            xnor_matmul_ref(sx, lr.wq)),
                "latency: xnor_matmul differs from xnor_matmul_ref")
        labels = classify(net, x, latency.N_CLASSES).cpu().numpy()
        require(np.array_equal(lr.bitnet.classify(x, latency.N_CLASSES),
                               labels),
                "latency: the streamed walk's labels differ from classify's")
        mapped = lr.bitnet.mapped
        words = random_words(mapped.n_pis, 8, seed=0)
        want = execute_packed(mapped, words)
        for name, fn in (("execute_packed_cuda", execute_packed_cuda),
                         ("execute_packed_streamed", execute_packed_streamed)):
            require(np.array_equal(fn(mapped, words), want),
                    f"latency: {name} differs from execute_packed at W = 8 "
                    f"({mapped.n_luts} LUTs)")

        files = [run.bench_path(tmp, s) for s in ("latency", "kernels")]
        for path in files:
            with open(path) as f:
                doc = json.load(f)
            require(set(doc) == {"section", "meta", "rows", "results"}
                    and doc["rows"], f"latency: {path} layout {set(doc)}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = check_regression.main(
                ["--files", ",".join(os.path.basename(p) for p in files),
                 "--fresh-dir", tmp, "--baseline-dir", tmp])
        n_checked = sum(int(n) for n in re.findall(r"(\d+) metrics checked",
                                                   buf.getvalue()))
        require(rc == 0 and n_checked > 0,
                f"latency: check_regression gave {rc}, {n_checked} metrics "
                f"checked:\n{buf.getvalue()}")
        n_entries = len(history.load_history(ledger))
        require(n_entries == 2, f"latency: {n_entries} ledger entries")
        require(all(history.append_file(p, path=ledger) is None
                    for p in files),
                "latency: a second history append was not skipped")

    # each path's device busy time a call (the profiler) and the
    # synchronizations one call makes (torch's sync debug mode warns on
    # each): a path that synchronizes cannot queue behind the spin
    busy, syncs = {}, {}
    fns = {"logic": lambda: net(x), "logic_pallas": lambda: net(
               x, use_kernel=True),
           "dense_float": lambda: latency.dense_forward(x, lr.ws),
           "xnor": lambda: xnor_matmul(torch.sign(x), lr.wq),
           "bitplane_streamed": lambda: lr.bitnet.classify(
               x, latency.N_CLASSES)}
    with tf32(False):
        for name, fn in fns.items():
            us, n = device_us(fn, None, 10)
            busy[name] = us * n / 10 if n else None
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    fn()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[name] = sum("synchroniz" in str(w.message) for w in seen)
    print(f"[latency] {len(files)} records, {n_checked} metrics checked, "
          f"ledger {n_entries} entries (a rerun skipped); launches in the "
          f"latency section {section_counts}, in both {counts}; "
          f"{time.perf_counter() - t0:.1f}s")
    print("[latency] batch {} (JSC-S, {} steps, test acc {:.4f}), streamed "
          "tile {}: ".format(rec["batch"], rec["train"]["steps"],
                             rec["train"]["test_acc"],
                             rec["bitplane_streamed_tile"])
          + "; ".join(
              f"{p} wall {rec[p + '_us']:.2f} us, device "
              f"{rec[p + '_device_us']:.2f} us (queued "
              f"{rec['device_queued'][p]}), busy "
              + (f"{busy[p]:.2f} us" if busy[p] is not None else "not seen")
              + f", {syncs[p]} syncs a call"
              for p in latency.PATHS)
          + f"; logic_vs_dense_x {rec['logic_vs_dense_x']} on {card}")
    return counts


def kernel_time_fns(torch, inp, errs):
    """label -> (function, kernel symbol) of the kernel times: the
    aig_sim walk on the bench AIG, on a strict chain and on a chain of
    inverters of 2,500 ANDs each at the bench's width, xnor_popcount and
    fanin_matmul (float32) at the bench shape, each first held to its
    plain version. Only wrappers whose signatures every checkout of the
    port shares."""
    import numpy as np
    from repro_torch.kernels.aig_sim import aig_sim_ref, aig_sim_walk
    from repro_torch.kernels.xnor_popcount import (pack_bipolar,
                                                   xnor_matmul_packed,
                                                   xnor_popcount_ref)
    a = inp.aig
    words = torch.from_numpy(np.random.default_rng(1).integers(
        0, 1 << 32, (16, a.words.shape[1]), dtype=np.uint32)
        .view(np.int32)).cuda()
    walks = {"bench AIG": (a.words, a.f0_t, a.f1_t, a.n_pis)}
    for label, lits in (("strict chain", strict_chain(0, 16, 2500)),
                        ("chain of inverters", toggling_chain(16, 2500))):
        walks[label] = (words, *(torch.from_numpy(f).cuda() for f in lits),
                        16)
    fns = {}
    for label, (w, f0, f1, n_pis) in walks.items():
        check(errs, "aig_sim", aig_sim_walk(w, f0, f1),
              aig_sim_ref(w, f0, f1, n_pis), f"{label} (timing)")
        fns[f"aig_sim {label}"] = (
            lambda w=w, f0=f0, f1=f1: aig_sim_walk(w, f0, f1),
            "aig_sim_kernel")
    x, w = inp.xnor.x, inp.xnor.w
    xp, wp = pack_bipolar(x), pack_bipolar(w)
    check(errs, "xnor_popcount", xnor_matmul_packed(xp, wp, x.shape[1]),
          xnor_popcount_ref(xp, wp, x.shape[1]), "bench (timing)")
    fns["xnor_popcount bench"] = (
        lambda: xnor_matmul_packed(xp, wp, x.shape[1]),
        "xnor_popcount_kernel")
    from repro_torch.kernels.fanin_matmul import fanin_matmul, fanin_matmul_ref
    f = inp.fanin
    got = fanin_matmul(f.x, f.idx, f.w, f.bias)
    torch.cuda.synchronize()
    require(torch.equal(got, fanin_matmul_ref(f.x, f.idx, f.w, f.bias)),
            "fanin_matmul bench (timing): differs from its plain version")
    fns["fanin_matmul bench"] = (
        lambda: fanin_matmul(f.x, f.idx, f.w, f.bias), "fanin_matmul_kernel")
    return fns


def phase_kernel_times(torch, card):
    """``--kernel-times``: one JSON line of the profiler's device time
    per launch of each of ``kernel_time_fns``."""
    import repro_torch
    from repro_torch.bench.kernels_bench import FULL, make_inputs
    inp = make_inputs(torch.device("cuda"), FULL)
    res = {"package": os.path.dirname(repro_torch.__file__), "card": card}
    for label, (fn, symbol) in kernel_time_fns(torch, inp, {}).items():
        res[f"{label} device us"] = device_us_seen(fn, symbol)[0]
    print(json.dumps(res))


def phase_timing2(torch, inp, counts, errs, card, b1_ops_per_s):
    """The bench-path kernels at the bench shapes: wrapper time (CUDA
    events), the plain version's (few calls), the least bytes / operations
    of this run's inputs, the library call's time and the device time per
    launch from ``torch.profiler``. Each library call is first held to
    the kernel's result: exactly for xnor, within the kernel's tolerance
    for the float ones (TF32 off)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.aig_sim import aig_sim_ref, aig_sim_walk
    from repro_torch.kernels.fanin_matmul import (dense_equivalent,
                                                  fanin_matmul,
                                                  fanin_matmul_ref)
    from repro_torch.kernels.fanin_matmul.ops import (FaninPlan, launch_plan,
                                                      plan_fanin,
                                                      staged_bytes)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.xnor_popcount import (pack_bipolar,
                                                   xnor_matmul_packed,
                                                   xnor_popcount_ref)
    rows, fns = [], {}
    lib_fns = {}        # label -> (library call, TF32 on)

    def row(name, fn, plain, lib_ms, n_bytes, n_ops, ops_per_s=ALU_OPS_PER_S):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, iters=3, reps=3)
        b_ms, b_by = bound(n_bytes, n_ops, ops_per_s)
        src, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": errs.get(name, 0), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
        fns[name] = fn
        lib = f"{lib_ms:.5f} ms" if lib_ms is not None else "none"
        print(f"[timing2] {name}: {ms:.5f} ms (plain {plain_ms:.5f} ms; "
              f"library {lib}; bound {b_ms:.7f} ms by {b_by}: {n_bytes} "
              f"bytes, {n_ops} ops) on {card}")

    a = inp.aig
    n_ands = a.f0.shape[0]
    plane_rows = 1 + a.n_pis + n_ands
    n_words = a.words.shape[1]
    row("aig_sim", lambda: aig_sim_walk(a.words, a.f0_t, a.f1_t),
        lambda: aig_sim_ref(a.words, a.f0_t, a.f1_t, a.n_pis), None,
        nbytes(a.words, a.f0_t, a.f1_t) + 4 * plane_rows * n_words,
        3 * n_ands * n_words)
    # the walk off the bench path, at the bench's width: a strict chain
    # of 2,500 ANDs (depth 2,500, values that settle early) and a chain
    # of 2,500 inverters (the sweeps run to their cap, then node order)
    chains = {k: v for k, v in kernel_time_fns(torch, inp, errs).items()
              if "chain" in k}
    for label, (fn, _) in chains.items():
        print(f"[timing2] {label} of 2,500 ANDs at W={n_words}: "
              f"{time_ms(fn, iters=5, reps=5):.5f} ms (bench AIG row "
              f"above) on {card}")

    # xnor's library yardsticks, both exact on +-1 operands: the int8
    # product in int32, and the TF32 float product (+-1 products summed
    # in float32, exact below 2^24)
    x, w = inp.xnor.x, inp.xnor.w
    n = x.shape[1]
    xp, wp = pack_bipolar(x), pack_bipolar(w)
    B, W = xp.shape
    N = wp.shape[0]
    got = xnor_matmul_packed(xp, wp, n)
    libs = {}
    with tf32(True):
        check({}, "xnor_popcount", (x @ w.T).to(torch.int32), got,
              "against the TF32 matmul")
        libs["TF32 matmul"] = time_ms(lambda: x @ w.T)
    lib_fns["xnor_popcount TF32 matmul"] = (lambda: x @ w.T, True)
    x8, w8 = (torch.where(t_ > 0, 1, -1).to(torch.int8) for t_ in (x, w))
    for w8t in (w8.t(), w8.t().contiguous()):
        try:
            check({}, "xnor_popcount", torch._int_mm(x8, w8t), got,
                  "against the int8 matmul")
        except RuntimeError as e:            # layout this build refuses
            print(f"[timing2] torch._int_mm refused a layout: "
                  f"{str(e).splitlines()[0][:120]}")
            continue
        int_mm = lambda w8t=w8t: torch._int_mm(x8, w8t)  # noqa: E731
        libs["int8 _int_mm"] = time_ms(int_mm)
        lib_fns["xnor_popcount int8 _int_mm"] = (int_mm, False)
        break
    print("[timing2] xnor_popcount library calls: " + ", ".join(
        f"{k} {v:.5f} ms" for k, v in libs.items()) + f" on {card}")
    # the kernel's products run on the binary tensor cores, whose rate
    # NVIDIA does not publish: each of the B x N x 32W bit products
    # (AND and accumulate, two operations) at the b1 and.popc rate the
    # probe measured on this card in this run
    row("xnor_popcount", lambda: xnor_matmul_packed(xp, wp, n),
        lambda: xnor_popcount_ref(xp, wp, n), min(libs.values()),
        nbytes(xp, wp) + 4 * B * N, 2 * B * N * 32 * W, b1_ops_per_s)
    print(f"[timing2] xnor_popcount operations at the probe's b1 and.popc "
          f"rate, {b1_ops_per_s / 1e12:.1f} TOPS (int8 tensor rate "
          f"{INT8_OPS_PER_S / 1e12:.0f}) "
          f"on {card}")

    # fanin_matmul beside the PyTorch calls that compute its function:
    # the masked dense product, the CSR product (w as (N, n_in)) with
    # x^T, and embedding_bag over the columns of x (its table x^T made
    # once, outside the timed call); each first held to the kernel (TF32
    # off). The bench's bias is 0, so the two calls without a bias
    # compute all of it. The row takes the fastest on the device.
    f = inp.fanin
    B, n_in = f.x.shape
    N, K = f.idx.shape
    n_cols = int(torch.unique(f.idx).numel())
    require(not f.bias.any(), "the bench's fanin bias is not 0")

    def fanin_libs(x, w, bias):
        w_dense = torch.zeros((N, n_in), dtype=x.dtype, device=x.device)
        w_dense.scatter_add_(1, f.idx.long(), w)
        crow = torch.arange(0, N * K + 1, K, device=x.device)
        w_csr = torch.sparse_csr_tensor(crow, f.idx.long().flatten(),
                                        w.flatten(), (N, n_in))
        table = x.T.contiguous()
        return {"dense product": lambda: dense_equivalent(x, w_dense, bias),
                "sparse.mm CSR": lambda: torch.sparse.mm(w_csr, x.T),
                "embedding_bag": lambda: F.embedding_bag(
                    f.idx, table, per_sample_weights=w, mode="sum")}

    def fanin_lib_row(label, x, w, bias, tol_of):
        """(ms, device us, name) of the fastest library call on the
        device, after holding each to the kernel within ``tol_of(got)``
        of max(1, |y|); a call this torch refuses is printed and
        skipped."""
        got = fanin_matmul(x, f.idx, w, bias)
        best = None
        for name, fn in fanin_libs(x, w, bias).items():
            try:
                with tf32(False):
                    y = fn()
            except (RuntimeError, NotImplementedError) as e:
                print(f"[timing2] {label} library {name} refused: "
                      f"{str(e).splitlines()[0][:120]}")
                continue
            y = y if name == "dense product" else y.T
            check_close({}, "fanin_matmul", y.to(got.dtype), got,
                        tol_of(got), f"{label} against the {name}",
                        relative=True)
            with tf32(False):
                per_launch, n = device_us_seen(fn, None)
                ms = time_ms(fn)
            dev_us = per_launch * n / 10           # every kernel of a call
            print(f"[timing2] {label} library {name}: {ms:.5f} ms, device "
                  f"{dev_us:.2f} us per call ({n / 10:g} kernels) on {card}")
            if best is None or dev_us < best[1]:
                best = (ms, dev_us, name)
        require(best is not None, f"{label}: no library call ran")
        return best

    lib_ms, _, lib_name = fanin_lib_row("fanin_matmul", f.x, f.w, f.bias,
                                        lambda got: 1e-4)
    print(f"[timing2] fanin_matmul library: {lib_name}, the fastest on "
          f"the device")
    fanin_bytes = (4 * B * n_cols + nbytes(f.idx, f.w, f.bias) + 4 * B * N)
    with tf32(False):
        row("fanin_matmul", lambda: fanin_matmul(f.x, f.idx, f.w, f.bias),
            lambda: fanin_matmul_ref(f.x, f.idx, f.w, f.bias), lib_ms,
            fanin_bytes, 2 * B * N * K + B * N, F32_OPS_PER_S)
    # the kernel at 1 and 2 rows a block (all neurons a block) beside the
    # plan's own choice, on the bench's inputs
    plan = plan_fanin(B, n_in, N, torch.float32)
    for n_rows in (1, 2):
        alt = FaninPlan(True, n_rows, N,
                        staged_bytes(n_rows, n_in, torch.float32))
        out = torch.empty((B, N), dtype=torch.float32, device=f.x.device)
        got = launch_plan(f.x, f.idx, f.w, f.bias, out, alt)
        check({}, "fanin_matmul", got.view(torch.int32),
              fanin_matmul(f.x, f.idx, f.w, f.bias).view(torch.int32),
              f"{n_rows} rows a block")
        us, _ = device_us_seen(
            lambda: launch_plan(f.x, f.idx, f.w, f.bias, out, alt),
            "fanin_matmul_kernel")
        print(f"[timing2] fanin_matmul at {n_rows} rows a block, "
              f"{-(-B // n_rows)} blocks: device {us:.2f} us per launch"
              + (" (the plan's)" if (n_rows, N) == (plan.rows, plan.span)
                 else "") + f" on {card}")
    # where the time goes: the bench launch without its fanin terms (the
    # rows' copy and the output's stores), and with rows of 32 inputs
    # (the terms' loads and the gathers, next to no rows to copy)
    for label, (xs, ks) in (("K 0", (f.x, f.idx[:, :0].contiguous())),
                            ("rows of 32 inputs",
                             (f.x[:, :32].contiguous(), f.idx % 32))):
        ws = f.w[:, :ks.shape[1]].contiguous()
        check_nan_equal({}, "fanin_matmul", fanin_matmul(xs, ks, ws, f.bias),
                        fanin_matmul_ref(xs, ks, ws, f.bias), label)
        us, _ = device_us_seen(lambda: fanin_matmul(xs, ks, ws, f.bias),
                               "fanin_matmul_kernel")
        print(f"[timing2] fanin_matmul bench shape, {label}: device "
              f"{us:.2f} us per launch on {card}")

    # the bfloat16 row at the same shape (not on the bench path: its
    # numbers are printed here, not in the kernels line). The library
    # calls do not round each product to bf16 as the kernel does: within
    # 2^-7 (sum |x w| + |y|) of it, over max(1, |y|)
    xb, wb, bb = (t_.to(torch.bfloat16) for t_ in (f.x, f.w, f.bias))
    mag = fanin_matmul_ref(xb.float().abs(), f.idx, wb.float().abs(),
                           bb.float().abs())
    got_b = fanin_matmul(xb, f.idx, wb, bb)
    tol_b = float((2.0 ** -7 * (mag + got_b.float().abs())
                   / got_b.float().abs().clamp(min=1.0)).max())
    lib_b_ms, lib_b_us, lib_b_name = fanin_lib_row(
        "fanin_matmul bf16", xb, wb, bb, lambda got: tol_b)
    fanin_bf16 = lambda: fanin_matmul(xb, f.idx, wb, bb)  # noqa: E731
    ms = time_ms(fanin_bf16)
    plain_ms = time_ms(lambda: fanin_matmul_ref(xb, f.idx, wb, bb), iters=3,
                       reps=3)
    n_bytes = 2 * B * n_cols + nbytes(f.idx, wb, bb) + 2 * B * N
    b_ms, b_by = bound(n_bytes, 2 * B * N * K + B * N, F32_OPS_PER_S)
    print(f"[timing2] fanin_matmul bf16: {ms:.5f} ms (plain {plain_ms:.5f} "
          f"ms; library {lib_b_name} {lib_b_ms:.5f} ms, device "
          f"{lib_b_us:.2f} us; bound {b_ms:.7f} ms by {b_by}: {n_bytes} "
          f"bytes; max abs err {errs.get('fanin_matmul', 0.0):.3g}) on "
          f"{card}")

    q, k, v = inp.flash.q, inp.flash.k, inp.flash.v
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    pairs = b * h * sum(min(i + 1, sk) for i in range(sq))     # causal
    flops = 4 * dh * pairs

    def sdpa_of(q, k, v):
        qt, kt, vt = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        except TypeError:             # torch without enable_gqa
            ke, ve = (t_.repeat_interleave(h // kvh, dim=1)
                      for t_ in (kt, vt))
            return lambda: F.scaled_dot_product_attention(
                qt, ke, ve, is_causal=True)

    sdpa = sdpa_of(q, k, v)
    lib_fns["flash_attention SDPA"] = (sdpa, False)
    with tf32(False):
        check_close({}, "flash_attention", sdpa().transpose(1, 2),
                    flash_attention(q, k, v), 2e-4,
                    "against the library call")
        row("flash_attention", lambda: flash_attention(q, k, v),
            lambda: attention_ref(q, k, v), time_ms(sdpa),
            nbytes(q, k, v) + 4 * q.numel(), flops, F32_OPS_PER_S)
    print(f"[timing2] flash_attention float32 as three TF32 passes: bound "
          f"{bound(nbytes(q, k, v) + 4 * q.numel(), 3 * flops, TF32_OPS_PER_S)[0]:.7f}"
          f" ms ({3 * flops} TF32 operations at 495 T/s) on {card}")

    # the bfloat16 row at the same shape: not on the bench path, so its
    # numbers are printed here and not in the kernels line
    qb, kb, vb = (t_.to(torch.bfloat16) for t_ in (q, k, v))
    sdpa_bf16 = sdpa_of(qb, kb, vb)
    lib_fns["flash_attention bf16 SDPA"] = (sdpa_bf16, False)
    got_bf16 = flash_attention(qb, kb, vb)
    check_close({}, "flash_attention bf16", sdpa_bf16().transpose(1, 2),
                got_bf16, 2e-2, "against the library call")
    bf16_fn = lambda: flash_attention(qb, kb, vb)  # noqa: E731
    ms = time_ms(bf16_fn)
    plain_ms = time_ms(lambda: attention_ref(qb, kb, vb), iters=3, reps=3)
    lib_ms = time_ms(sdpa_bf16)
    n_bytes = nbytes(qb, kb, vb, got_bf16)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    print(f"[timing2] flash_attention bf16: {ms:.5f} ms (plain "
          f"{plain_ms:.5f} ms; library {lib_ms:.5f} ms; bound {b_ms:.7f} ms "
          f"by {b_by}: {n_bytes} bytes, {flops} bf16 operations at 989 T/s; "
          f"max abs err {errs.get('flash_attention bf16', 0.0):.3g}) on "
          f"{card}")

    # device time per launch, one profiler session per kernel
    for name, fn in [*fns.items(),
                     *((k, fn) for k, (fn, _) in chains.items()),
                     ("fanin_matmul bf16", fanin_bf16),
                     ("flash_attention bf16", bf16_fn)]:
        dev, n = device_us(fn, name.split()[0] + "_kernel", 10)
        print(f"[timing2] {name} kernel device time "
              + (f"{dev:.2f} us per launch ({n} launches)" if n else
                 "not seen by the profiler") + f" on {card}")
    # the library calls' device time: every device event of 10 calls
    for label, (fn, on) in lib_fns.items():
        with tf32(on):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        print(f"[timing2] library {label} device time {us / 10:.2f} us per "
              f"call on {card}")
    return rows


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
    # no persisted tile geometry outside the verify phase's own cache
    os.environ["REPRO_AUTOTUNE_CACHE"] = ""
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--kernel-times"]:
        phase_kernel_times(torch, phase_card(torch))
        return 0
    t_start = time.perf_counter()
    errs = {}
    card = phase_card(torch)
    phase_build()
    b1_ops_per_s = phase_probe()
    phase_kernels(torch, errs)
    runs, batch = phase_serve(torch)
    rows = phase_timing(torch, runs, batch, errs, card)
    phase_profile(torch, runs, batch, card)
    trained, model = phase_train(torch, card)
    phase_verify(torch, card, trained, model)
    phase_profile(torch, trained, batch, card, "trained ")
    phase_loadgen(torch, card, trained)
    inp = phase_kernels2(torch, errs)
    counts = phase_bench(torch)
    rows += phase_timing2(torch, inp, counts, errs, card, b1_ops_per_s)
    phase_latency(torch, card)
    require(len(rows) == len(KERNELS), f"{len(rows)} kernel rows")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
