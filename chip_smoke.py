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
                (BMMA); the flash forward, dK / dV and dQ instances at
                dh 192 and 256 in float32 and bf16 must be there, with
                their spill printed, and the bf16 dh 192 ones (on
                nemotron-4-340b's path) may not spill;
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
                n_in 60,000 and 120,000, in device memory), and on
                four mixes of types (x, w, bias), and flash_attention
                within 2e-4 in float32 (TF32 off in the plain version)
                and 2e-2 in bfloat16 (the reference test's tolerances):
                bench, window, ragged, GQA and fully masked shapes,
                every dh template (16, 32, 64, 128, 192, 256) and every
                copy width of its K / V loads; above dh 128 within the
                tolerance x max(1, |plain|) and, in bfloat16, within
                2e-2 of the float64 attention and no farther from it
                than the plain versions in bf16;
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
                makes (torch's sync debug mode) beside the card;
  13. lm      — the LM serving path: glm4-9b at full width (seed 0,
                float32 init cast to bf16 by ``LMEngine``) serving 8
                prompts of 32 tokens from ``default_rng(0)`` through 4
                slots, ``max_seq`` 256, 16 new tokens each, from every
                launch count at 0: every request served, flash_attention
                launched 8 x 40 times (one a layer per prefill), the
                tokens those of a single-request greedy loop on the card
                or, where they part, within LM_PART_TOL |top| of the
                loop's top; prefill + decode_step against forward at S
                48 within LM_ATOL + LM_RTOL |x| (the reference's
                decode-vs-forward tolerance); the kernel within 2e-2 of its
                plain version and of the full_attention twin on the q,
                k, v of layer 0 of a served prefill and, on those of a
                2,100-token one, within 2e-2 of the float64 attention
                and no farther from it than the plain versions in bf16
                (``check_attention_exact``), then timed beside SDPA (row
                7c of the kernels line); the decode
                step's time, device busy and idle share, launches and
                synchronizations against its byte bound; then
                hymba-1.5b at full width with a 1,100-token prompt past
                its 1,024 window and three of 32 (max_seq 1,200, 8 new
                tokens): a window-long ring cache, 4 x 32 flash
                launches, decode against forward on the long prompt;
  14. lm2     — the MoE and encoder-decoder families: mixtral-8x22b at
                full width cut to 4 of its 56 layers (41.7 GB float32 at
                init), served through ``LMEngine`` with the lm phase's
                traffic (8 x 4 flash launches, the single-request loop,
                decode against forward at capacity factor 8), its decode
                step against its byte bound (every expert's weights);
                then seamless-m4t-large-v2 at full width and depth, a
                batch of 4 with 256 frames of ``enc_embeds`` through
                ``prefill(enc_embeds=)`` and 15 greedy ``decode_step``s
                (24 + 2 x 24 flash launches in prefill, 24 a step),
                decode against forward; the flash kernel within 2e-2 of
                its plain versions at each new shape (mixtral's
                windowed GQA prefill, seamless's encoder, cross-attention
                in prefill and in decode), timed beside SDPA (rows
                7d-7g of the kernels line);
  15. lm_train — LM training: glm4-9b at full width cut to 4 of its
                40 layers (2.06 G parameters, float32 parameters,
                gradients and AdamW moments 32.9 GB), six AdamW steps
                through ``Trainer`` at B 4 x S 1,024 from every launch
                count at 0: finite losses, the flash forward launched 8
                times a step (each block recomputed in the backward) and
                the flash backward 4, ms a step, tokens/s, peak memory,
                the profiled idle share and launches a step beside the
                step's bound; the moe, ssm, hybrid, encoder-decoder and
                QAT-example smoke configs at float32, step 1's loss and
                every gradient leaf on the card within TRAIN_CARD_TOL of
                the CPU's, then three steps each (top-k, sign and
                grad_accum 2 once each); a smoke-width checkpoint at step
                3 resumed by a new Trainer bit for bit, and a step that
                raises leaving an emergency checkpoint; the flash
                backward within 2e-4 (float32) / 2e-2 (bf16) x max(1,
                max |plain|) of autograd through ``attention_ref`` at
                every shape the phase launched it at and a ragged one,
                and rows 7h / 7i of the kernels line (the forward with
                its log-sum-exp and the backward at glm4-9b's training
                shape, beside SDPA); the backward's and SDPA's device
                times there and at the (H 16, KV 1) shape come from
                ``bench/flash_backward.py`` in a process of its own.
  16. lm_wide — nemotron-4-340b (heads 192 wide) at full width cut to 2
                of its 96 layers (60.9 GiB float32 at init, about 69.7
                GiB at the peak of the engine's cast), served with the
                lm phase's traffic and held as glm4-9b is (8 x 2 flash
                launches, the single-request loop, decode against
                forward, the kernel against its plain versions at a
                served prefill and against the float64 attention at a
                2,100-token one; every served prefill through the wide
                wgmma forward); the flash backward at dh 150 / 192 /
                256 in both types (bf16 at 192 / 256 on the wgmma
                branch, the rest on mma.sync); its train_4k attention
                (B 1, S 4,096, H 96, KV 8, dh 192, causal, bf16) forward
                and backward under autograd on the wgmma branches, one
                launch each, the output,
                dq, dk and dv held to their float64 values, a KV group
                at a time: over the tensor and each 256 positions no
                farther from them than EXACT_FWD_FACTOR (output) or
                EXACT_BWD_FACTOR (gradients) times the plain versions in
                bf16, each output element within 2e-2 x max(1, |exact|);
                timed beside SDPA (rows
                7j-7l of the kernels line; device times from
                ``bench/flash_backward.py`` in a process of its own);
  16b. decode_attention — the decode attention kernel at
                nemotron-4-340b's served decode (B 64 slots, W 4,096, H
                96, KV 8, dh 192, bf16, contexts of the conversation
                mix): one launch at the shapes' split count, within 2e-2
                x max(1, |exact|) of the float64 attention and within
                2e-2 of SDPA over the valid keys (a yardstick the port
                never calls), timed beside its plain version and SDPA,
                its device time a call against its byte bound; then the
                main path there: one ``lm.decode_step`` of nemotron-4-340b
                (2 layers, bf16 weights) over such a ring from every
                launch count at 0, one launch a layer (the row's
                launches) and the kernel's share of the step's device
                time (the last row of the kernels line); every engine
                run above (glm4-9b, hymba, mixtral, nemotron) and
                seamless's decode loop require one launch a layer in
                each decode step; the build phase requires its twelve
                instances (dh 16-256, bf16 and float32), the bf16 dh 192
                one without spill;
  17. dist    — the placed paths: glm4-9b (4 of 40 layers) through the
                launcher unplaced and at ``--model-par 1`` (NCCL world
                1), decode under serve_tp_only, the pipeline at one
                stage, a placed checkpoint, the smoke checks at (1, 1),
                GPipe on two ranks sharing the card over gloo with every
                layer on each rank and with each rank holding only its
                stage (``stage_params``), flash at the TP-local shape;
  18. logic_head — the ``logic_head`` example twin on hymba-1.5b's
                smoke config and at its full width (bf16 weights), each
                from launch counts at 0: pooled features through the
                flash kernel, the head trained with ``train_jsc`` and
                compiled to logic, the network on lut_layer bit-exact
                with the head's argmax; the smoke run's accuracy, LUTs
                and FFs held to the reference's CPU run within the
                twin's bands; features a second, accuracy and LUTs;
  19. dryrun  — the dry run under this machine's torch, each in a
                process of its own with the card hidden: glm4-9b
                train_4k, mixtral-8x22b decode_32k and
                seamless-m4t-large-v2 prefill_32k on (16, 16), glm4-9b
                decode_32k on (2, 16, 16), and the pipeline twin; each
                ``ok`` with FLOPs above 0 and argument bytes equal to the
                rule table's shards; roofline rows at the H100's rates.

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

    python3 chip_smoke.py --decode-attention

runs only the card, build and decode_attention phases and prints that
phase's row as ``{"kernels": [...]}``.
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
    # no TPU kernel: the reference differentiates full_attention in XLA
    "flash_attention_backward": ("src/repro_torch/csrc/flash_attention.cu",
                                 "src/repro/models/layers.py:81"),
    # no TPU kernel: the reference's decode attention is plain jnp
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/models/layers.py:151"),
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


def time_ms(fn, iters: int = 200, reps: int = 7, warm: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``iters`` calls each,
    after ``warm`` calls."""
    import torch
    for _ in range(warm):
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


def count_syncs(torch, fn) -> int:
    """Synchronizations one call of ``fn`` makes: the warnings torch's
    sync debug mode gives, one a synchronizing operation (not its
    one-time note that the mode is a prototype)."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in seen)


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
    """``lut_eval_kernel<6>`` / ``flash_attention_kernel<bf16,64>`` /
    ``fanin_matmul_kernel<bf16,float,2,smem>`` from a mangled kernel
    symbol (a repeated type, mangled as a substitution, as the first)."""
    m = re.search(r"([a-z_]+_kernel)(I.*?EE)?", symbol)
    if not m:
        return symbol
    args, rest = [], (m.group(2) or "")[1:]
    types = (("13__nv_bfloat16", "bf16"), ("6__half", "f16"), ("f", "float"))
    while rest and not rest.startswith("L"):
        for code, name in types:
            if rest.startswith(code):
                args.append(name)
                rest = rest[len(code):]
                break
        else:
            sub = re.match(r"S\d*_", rest)
            if not (sub and args):
                break
            args.append(args[0])
            rest = rest[sub.end():]
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
            ("fanin_matmul", 20, "x in float32 / bf16 / f16 with w of x's "
             "type, and x in bf16 / f16 with float32 w (mixed types) x 1 or "
             "2 rows a block x rows in shared or device memory")):
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
    # the flash backward's wgmma branch: dh 64 and 128, warpgroup mma
    wg = [n for n, _, _ in report if n.startswith("flash_bwd_wgmma_kernel<")]
    require(len(wg) == 2, f"ptxas reported {len(wg)} flash_bwd_wgmma_kernel "
            "instances, expected 2 (dh 64 and 128)")
    lib = build.build().parent / build.LIB_NAME
    sass = sass_of(lib, "flash_bwd_wgmma_kernel")
    n_gmma = sum(1 for ln in sass.splitlines() if "HGMMA" in ln)
    require(n_gmma > 0, "flash_bwd_wgmma_kernel has no HGMMA (warpgroup "
            "mma) instruction in its SASS")
    print(f"[build] flash_bwd_wgmma_kernel SASS (dh 64 and 128): {n_gmma} "
          "HGMMA instructions (wgmma on the tensor cores)")
    # the wide wgmma branch (bf16 at dh 192 and 256, NC = dh / 64 = 3, 4):
    # the forward and the backward's dK / dV and dQ passes, none spilling
    by_name = {n: (regs, stack) for n, regs, stack in report}
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_dkdv_kernel",
                   "flash_bwd_wgmma_dq_kernel"):
        for nc in (3, 4):
            name = f"{kernel}<{nc}>"
            require(name in by_name, f"ptxas reported no {name}")
            regs, stack = by_name[name]
            require(stack.startswith("0 bytes stack frame, 0 bytes spill"),
                    f"{name} keeps a stack frame or spills: {stack}")
            print(f"[build] wide wgmma {name} (dh {64 * nc}): {regs}; "
                  f"{stack}")
        n_gmma = sum(1 for ln in sass_of(lib, kernel).splitlines()
                     if "HGMMA" in ln)
        require(n_gmma > 0, f"{kernel} has no HGMMA (warpgroup mma) "
                "instruction in its SASS")
        print(f"[build] {kernel} SASS (dh 192 and 256): {n_gmma} HGMMA "
              "instructions")
    # the wide templates: the forward and the mma.sync backward at dh 192
    # and 256 in both types; none of nemotron-4-340b's (bf16, 192) spills
    wide = {}
    for name, regs, stack in report:
        m = re.match(r"(flash_attention_kernel|flash_bwd_wide_dkdv_kernel|"
                     r"flash_bwd_wide_dq_kernel)<(float|bf16),(192|256)>$",
                     name)
        if m:
            spill = re.search(r"(\d+) bytes spill stores", stack)
            wide[m.groups()] = (regs, stack, int(spill.group(1)) if spill
                                else None)
    for kernel in ("flash_attention_kernel", "flash_bwd_wide_dkdv_kernel",
                   "flash_bwd_wide_dq_kernel"):
        for dtype in ("float", "bf16"):
            for dhp in ("192", "256"):
                require((kernel, dtype, dhp) in wide, f"ptxas reported no "
                        f"{kernel}<{dtype},{dhp}>")
                regs, stack, spill = wide[(kernel, dtype, dhp)]
                require(spill is not None, f"{kernel}<{dtype},{dhp}>: no "
                        f"spill count in {stack!r}")
                print(f"[build] wide flash {kernel}<{dtype},{dhp}>: {regs}; "
                      f"{stack}; spill stores {spill} bytes")
                if (dtype, dhp) == ("bf16", "192"):
                    require(spill == 0, f"{kernel}<bf16,192> (nemotron-4-"
                            f"340b's path) spills {spill} bytes: {stack}")
    print("[build] the wide flash templates (dh 192 and 256, float32 and "
          "bf16): forward, dK / dV and dQ instances found; the bf16 dh 192 "
          "ones spill 0 bytes")
    # the decode attention kernel: six widths in both types, none of
    # nemotron-4-340b's (bf16, 192) spilling
    for dtype in ("float", "bf16"):
        for dhp in ("16", "32", "64", "128", "192", "256"):
            name = f"decode_attention_kernel<{dtype},{dhp}>"
            require(name in by_name, f"ptxas reported no {name}")
            regs, stack = by_name[name]
            print(f"[build] {name}: {regs}; {stack}")
            if (dtype, dhp) == ("bf16", "192"):
                require(stack.startswith("0 bytes stack frame, 0 bytes "
                                         "spill"), f"{name} spills: {stack}")


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
    from repro_torch.bench.profiled import device_time
    from repro_torch.kernels.lut_eval import (plan_stacked, plan_streamed,
                                              stacked_smem_bytes,
                                              streamed_smem_bytes)
    from repro_torch.kernels.lut_layer import (layer_smem_bytes, lut_layer,
                                               lut_layer_ref, plan_layer)
    rows = []
    # the launch floor: the smallest kernel torch launches
    one = torch.ones(1, device="cuda")
    zero = device_time(one.zero_, None, 20)
    floor = zero.launch_us
    require(floor is not None, "the profiler saw no device time of zero_")
    print(f"[timing] launch floor: one-element zero_ {floor:.2f} us per "
          f"launch on the device ({zero.seen} launches) on {card}")

    def row(name, fn, plain, n_bytes, n_ops, launches, plan_bytes):
        ms, plain_ms = time_ms(fn), time_ms(plain)
        t_ = device_time(fn, f"{name}_kernel", 20)
        dev, n = t_.launch_us, t_.seen
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
        t_ = device_time(lambda c=c, idx=idx, tables=tables, L=L:
                         lut_layer(c, idx, tables, L), "lut_layer_kernel", 20)
        dev, n = t_.launch_us, t_.seen
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
    # mixed types, as the reference kernel takes them: each product in
    # the promoted type of x and w, x's type out (w and bias of another
    # type reach the kernel in float32)
    mixed = [(torch.bfloat16, torch.float32, torch.bfloat16),
             (torch.float16, torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16, torch.float16),
             (torch.float32, torch.float16, torch.bfloat16)]
    for x_t, w_t, b_t in mixed:
        for (B, n_in, N, K) in (fshapes[1], fshapes[9]):
            x, idx, w, bias = fanin_operands(rng, B, n_in, N, K,
                                             torch.float32, dev)
            x, w, bias = x.to(x_t), w.to(w_t), bias.to(b_t)
            launched = fanin_matmul.launches
            got = fanin_matmul(x, idx, w, bias)
            require(fanin_matmul.launches == launched + 1
                    and got.dtype == x_t, f"fanin_matmul {x_t}/{w_t}/{b_t}: "
                    f"launches {fanin_matmul.launches - launched}, {got.dtype}")
            check_nan_equal(errs, "fanin_matmul", got,
                            fanin_matmul_ref(x, idx, w, bias),
                            f"x {x_t}, w {w_t}, bias {b_t} {(B, n_in, N, K)}")
    print(f"[kernels2] fanin_matmul == plain on {len(mixed)} mixed (x, w, "
          "bias) types, rows staged and in device memory")

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
               (1, 65, 200, 2, 1, 12, True, 0),
               # the wide templates: 192 (nemotron-4-340b's group of 12,
               # ragged dh 150, odd dh 193) and 256 (window only, fully
               # masked rows, dh 200)
               (1, 130, 130, 2, 1, 192, True, 0),
               (1, 100, 77, 12, 1, 192, True, 24),
               (1, 130, 130, 2, 1, 150, True, 0),
               (1, 65, 200, 2, 1, 193, True, 9),
               (1, 70, 90, 2, 1, 256, False, 40),
               (1, 300, 130, 1, 1, 256, True, 4),
               (1, 130, 130, 4, 2, 200, True, 0)]
    wide_exact = {}
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
            # the wide templates' shapes within tol x max(1, |plain|):
            # a bf16 output past 2 (a window of 4 keys reads few values
            # of v) steps by 2^-6 or more, so two roundings of one
            # value part by more than 2e-2 there; in bf16 they are also
            # held to the float64 attention (check_attention_exact)
            shape = (b, sq, sk, h, kv, dh, causal, win)
            check_close(errs, name,
                        flash_attention(q, k, v, causal=causal, window=win),
                        want, tol, f"{shape}", relative=dh > 128)
            if dh > 128 and dtype == torch.bfloat16:
                wide_exact[shape] = check_attention_exact(
                    q, k, v, {"causal": causal, "window": win},
                    f"kernels2 flash_attention bf16 {shape}",
                    factor=EXACT_FWD_FACTOR)
        print(f"[kernels2] flash_attention {dtype} within {tol} (x max(1, "
              f"|plain|) at dh above 128) of plain on {len(ashapes)} shapes "
              f"(dh templates 16/32/64/128/192/256, every copy width; max "
              f"abs err "
              f"{errs['flash_attention' if tol == 2e-4 else 'flash_attention bf16']:.3g})")
    print(f"[kernels2] flash_attention bf16 at dh above 128 within "
          f"{LM_KERNEL_TOL} of the float64 attention and no farther from it "
          f"than {EXACT_FWD_FACTOR} x attention_ref and full_attention in "
          f"bf16 (max abs err of "
          f"flash / attention_ref / full_attention): " + "; ".join(
              f"{shape} {e['flash']:.6g} / {e['attention_ref']:.6g} / "
              f"{e['full_attention']:.6g}" for shape, e in wide_exact.items()))
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
    from repro_torch.bench.profiled import device_time
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
            busy[name] = device_time(fn, None, 10).call_us
            torch.cuda.synchronize()
            syncs[name] = count_syncs(torch, fn)
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
    from repro_torch.bench.profiled import device_time
    import repro_torch
    from repro_torch.bench.kernels_bench import FULL, make_inputs
    inp = make_inputs(torch.device("cuda"), FULL)
    res = {"package": os.path.dirname(repro_torch.__file__), "card": card}
    for label, (fn, symbol) in kernel_time_fns(torch, inp, {}).items():
        us = device_time(fn, symbol).launch_us
        require(us is not None, f"the profiler saw no {symbol} in three "
                "sessions")
        res[f"{label} device us"] = us
    print(json.dumps(res))


def phase_timing2(torch, inp, counts, errs, card, b1_ops_per_s):
    """The bench-path kernels at the bench shapes: wrapper time (CUDA
    events), the plain version's (few calls), the least bytes / operations
    of this run's inputs, the library call's time and the device time per
    launch from ``torch.profiler``. Each library call is first held to
    the kernel's result: exactly for xnor, within the kernel's tolerance
    for the float ones (TF32 off)."""
    from repro_torch.bench.profiled import device_time
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
        device (by CUDA events where the profiler missed a launch of
        one), after holding each to the kernel within ``tol_of(got)``
        of max(1, |y|); a call this torch refuses is printed and
        skipped."""
        got = fanin_matmul(x, f.idx, w, bias)
        cands = []
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
                t_ = device_time(fn, None)
                ms = time_ms(fn)
            dev_us = t_.call_us                    # every kernel of a call
            print(f"[timing2] {label} library {name}: {ms:.5f} ms, device "
                  f"{us_text(dev_us)} per call ({t_.launches} kernels) on "
                  f"{card}")
            cands.append((ms, dev_us, name))
        require(cands, f"{label}: no library call ran")
        by_device = all(c[1] is not None for c in cands)
        if not by_device:
            print(f"[timing2] {label}: the profiler missed library launches; "
                  "the fastest by CUDA events")
        return min(cands, key=lambda c: c[1] if by_device else c[0])

    lib_ms, _, lib_name = fanin_lib_row("fanin_matmul", f.x, f.w, f.bias,
                                        lambda got: 1e-4)
    print(f"[timing2] fanin_matmul library: {lib_name}, the fastest")
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
        us = device_time(
            lambda: launch_plan(f.x, f.idx, f.w, f.bias, out, alt),
            "fanin_matmul_kernel").launch_us
        require(us is not None, "the profiler saw no fanin_matmul_kernel "
                f"at {n_rows} rows a block")
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
        us = device_time(lambda: fanin_matmul(xs, ks, ws, f.bias),
                         "fanin_matmul_kernel").launch_us
        require(us is not None, "the profiler saw no fanin_matmul_kernel "
                f"at {label}")
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
          f"{us_text(lib_b_us)}; bound {b_ms:.7f} ms by {b_by}: {n_bytes} "
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
        t_ = device_time(fn, name.split()[0] + "_kernel")
        dev, n = t_.launch_us, t_.seen
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


# ---------------------------------------------------------------------------
# The LM serving path
# ---------------------------------------------------------------------------

LM_ARCH, LM_HYBRID = "glm4-9b", "hymba-1.5b"
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 32, 16   # the launcher's --mode lm
LM_SLOTS, LM_MAX_SEQ = 4, 256
LM_DECODE_S = 48                             # tests/test_models.py:45
LM_LONG_PREFILL = 2100                       # past ATTN_CHUNK_THRESHOLD
HYBRID_LONG, HYBRID_SHORT, HYBRID_MAX_SEQ, HYBRID_NEW = 1100, 32, 1200, 8
LM_KERNEL_TOL = 2e-2        # flash against its plain versions in bf16
# How far a bf16 flash kernel may be from the float64 attention where it
# is not held to "no farther than the plain version in bf16": a multiple
# of the plain version's distance. The forward rounds P before it
# normalises and the plain version after, so either can be the farther
# by a few percent (kernels2's dh 193 case on an H100: 0.00797 against
# 0.00782). The backward rounds dS to bf16 for its tensor-core products
# (dQ = dS K, dK = dS^T Q) where the plain version keeps it in float32:
# at nemotron's train_4k shape dq is 1.30x the plain version's distance,
# 1.43x over its first 256 rows.
EXACT_FWD_FACTOR = 1.25
EXACT_BWD_FACTOR = 2.0
# decode against forward: |a - b| <= LM_ATOL + LM_RTOL |b|, the
# reference's own decode-vs-forward tolerance (tests/test_models.py:70);
# products of other shapes round in other orders, and forty layers carry
# it to the logits
LM_ATOL, LM_RTOL = 0.15, 0.1
# the engine against a single-request loop: where the engine's token is
# not the loop's argmax, the loop's logit for it lies within four bf16
# steps of the top (a step at |x| is at most 2^-7 |x|); a batch of slots
# and a batch of one round their products in other orders
LM_PART_TOL = 4 * 2.0 ** -7


def lm_tol(ref):
    return LM_ATOL + LM_RTOL * ref.abs()


def logit_gap(logits):
    """Top-1 minus top-2 of one row of logits (float)."""
    top = logits.float().topk(2).values
    return float(top[0] - top[1])


def decode_vs_forward(torch, lm, cfg, params, tokens, s, max_seq, label,
                      **kw):
    """prefill(x[:s]) + decode_step(x[s]) against forward(x[:s+1])'s last
    logits (``kw``: the encoder's ``enc_embeds``, the same for both):
    within lm_tol, and argmax equal in every row whose top-2 gap exceeds
    it. Returns the largest |difference|."""
    b = tokens.shape[0]
    with torch.inference_mode():
        hidden, _, _ = lm.forward(cfg, params, tokens, **kw)
        want = lm.logits_head(cfg, params, hidden[:, -1]).float()
        del hidden
        _, cache = lm.prefill(cfg, params, tokens[:, :s], max_seq=max_seq,
                              **kw)
        got, _ = lm.decode_step(
            cfg, params, cache, tokens[:, s:s + 1],
            torch.full((b,), s, dtype=torch.int32, device=tokens.device))
        got = got.float()
    err = (got - want).abs()
    require(bool((err <= lm_tol(want)).all()),
            f"lm {label}: decode against forward exceeds {LM_ATOL} + "
            f"{LM_RTOL}|x| (max abs err {float(err.max())})")
    for i in range(b):
        if logit_gap(want[i]) > float(lm_tol(want[i].max())):
            require(int(got[i].argmax()) == int(want[i].argmax()),
                    f"lm {label}: row {i} argmax differs at a top-2 gap of "
                    f"{logit_gap(want[i])}")
    return float(err.max())


def serve_timed(torch, lm, eng, reqs):
    """``eng.run(reqs)`` with every launch counted from 0 and each
    prefill and decode step timed (host clock ending in a synchronize:
    the engine synchronizes on each token anyway). Requires one
    decode_attention launch a layer in each decode step: the engine's
    ticks go through the kernel. Returns (done, seconds, flash launches,
    prefill ms, decode ms)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    timed = {"prefill": [], "decode_step": []}
    real = {name: getattr(lm, name) for name in timed}

    def timer(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kw)
            torch.cuda.synchronize()
            timed[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name in timed:
        setattr(lm, name, timer(name))
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        for name, fn in real.items():
            setattr(lm, name, fn)
    n_steps = len(timed["decode_step"])
    require(n_steps > 0 and counts["decode_attention"]
            == n_steps * eng.cfg.n_layers,
            f"{eng.cfg.name}: decode_attention launched "
            f"{counts['decode_attention']} times in the engine's {n_steps} "
            f"decode steps, expected {n_steps} x {eng.cfg.n_layers}")
    print(f"[serve] {eng.cfg.name}: {counts['decode_attention']} "
          f"decode_attention launches in {n_steps} decode steps")
    return (done, seconds, counts["flash_attention"], timed["prefill"],
            timed["decode_step"])


def record_attention(layers, kind=lambda q, k, kw: "prefill"):
    """While the context is open, count each call of the attention entry
    point under ``kind(q, k, kwargs)`` (None: neither counted nor kept)
    and keep a copy of the first (q, k, v, kwargs) of each kind. Yields
    (first, counts), two dicts by kind."""
    first, counts = {}, {}
    real = layers.attention

    def recording(q, k, v, **kw):
        label = kind(q, k, kw)
        if label is not None:
            counts[label] = counts.get(label, 0) + 1
            if label not in first:
                first[label] = (q.detach().clone(), k.detach().clone(),
                                v.detach().clone(), kw)
        return real(q, k, v, **kw)

    @contextlib.contextmanager
    def ctx():
        layers.attention = recording
        try:
            yield first, counts
        finally:
            layers.attention = real
    return ctx()


def single_loop_partings(torch, lm, cfg, params, reqs, dev, max_seq, label):
    """The served requests again through a single-request greedy loop on
    the card: where the engine's token is not the loop's argmax, the
    loop's logit for it lies within LM_PART_TOL |top| of the top; the
    loop then takes the engine's token and goes on comparing to the last
    token. Returns the partings (request, token, gap)."""
    parted = []
    with torch.inference_mode():
        for j, req in enumerate(reqs):
            logits, cache = lm.prefill(
                cfg, params, torch.as_tensor(req.prompt[None], device=dev),
                max_seq=max_seq)
            pos = len(req.prompt)
            for i, tok in enumerate(req.out_tokens):
                row_ = logits[0].float()
                if int(row_.argmax()) != tok:
                    top = float(row_.max())
                    gap = top - float(row_[tok])
                    parted.append((j, i, gap))
                    require(gap <= LM_PART_TOL * abs(top),
                            f"{label}: request {j} parts from the single "
                            f"loop at token {i}: the engine's token is {gap} "
                            f"under the top {top} (limit {LM_PART_TOL} "
                            "|top|)")
                if i + 1 == len(req.out_tokens):
                    break
                logits, cache = lm.decode_step(
                    cfg, params, cache,
                    torch.tensor([[tok]], dtype=torch.int32, device=dev),
                    torch.tensor([pos], dtype=torch.int32, device=dev))
                pos += 1
    return parted


def partings_text(parted, n_tok):
    return ("every token equal" if not parted else
            "; ".join(f"request {j} parts at token {i}, the engine's token "
                      f"{g:.5f} under the top (limit {LM_PART_TOL} |top|)"
                      for j, i, g in parted)) + f" over {n_tok} tokens"


def flash_row(torch, name, q, k, v, kw, launches, err):
    """Row of the kernels line for flash_attention at one recorded shape:
    CUDA-event ms of the wrapper, of its plain version and of SDPA (held
    within LM_KERNEL_TOL of the kernel), and the bound from this shape's
    work (4 dh flops for each (query, key) pair its mask keeps, the
    operands read and the output written once). Returns (row, device µs
    a launch, SDPA device µs a call, bytes, flops); a device time the
    profiler did not see is None."""
    from repro_torch.bench.profiled import device_time
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.models import layers as L
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    mask = L._mask(sq, sk, causal, window, q.device)
    flops = 4 * dh * b * h * int(mask.sum())
    fn = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
    got = fn()
    n_bytes = nbytes(q, k, v, got)
    b_ms, b_by = bound(n_bytes, flops, BF16_OPS_PER_S)
    qt, kt, vt = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    # the library in its best mode: a mask only where the window cuts
    cut = window and window < sk
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask if cut else None,
        is_causal=bool(causal and not cut), enable_gqa=True)
    check_close({}, name, sdpa().transpose(1, 2), got, LM_KERNEL_TOL,
                "against the library call")
    src, replaces = KERNELS["flash_attention"]
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": time_ms(fn), "plain_ms": time_ms(
               lambda: attention_ref(q, k, v, **kw), iters=20, reps=3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa)}
    # the call launches one kernel: the mma.sync or the wgmma forward
    dev_us = device_time(fn, "flash_", 20).launch_us
    sdpa_us = device_time(sdpa, None, 20).call_us
    return row, dev_us, sdpa_us, n_bytes, flops


def us_text(us):
    return "not seen" if us is None else f"{us:.2f} us"


def decode_profile(torch, lm, cfg, params, cache, toks, pos, n=5):
    """Device busy and idle share of one decode step (``torch.profiler``
    over ``n`` steps, each ending in a synchronize), the kernels a step
    launches and the synchronizations one step makes (torch's sync debug
    mode warns on each)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        lm.decode_step(cfg, params, cache, toks, pos)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                lm.decode_step(cfg, params, cache, toks, pos)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / n
    busy, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    busy /= n
    with torch.inference_mode():
        syncs = count_syncs(
            torch, lambda: lm.decode_step(cfg, params, cache, toks, pos))
    return wall_us, busy, 1.0 - busy / wall_us, kernels / n, syncs


def decode_bytes(cfg, params, cache, batch):
    """Least bytes a decode step moves: every decoder weight read once
    (the embedding: its ``batch`` rows; every expert of an MoE layer,
    since the reference computes every expert's buffer, full or not),
    the whole cache read once (KV ring, its positions, the SSM state and
    conv tail, the encoder's ``enc_out`` that cross-attention reads), and
    the SSM state and conv tail written once (a step replaces them). The
    encoder's weights (``enc_layers``, ``enc_norm``) are never read in a
    decode step."""
    n = sum(t.numel() * t.element_size()
            for name, t in params.named_parameters()
            if name != "embed" and not name.startswith("enc_"))
    n += batch * cfg.d_model * params.embed.element_size()
    n += sum(t.numel() * t.element_size() for t in cache.values())
    return n + sum(t.numel() * t.element_size() for key, t in cache.items()
                   if key in ("ssm", "conv"))


def check_attention(errs, name, q, k, v, kw, what):
    """The flash kernel against ``attention_ref`` and the CPU path's twin
    (``full_attention``, or ``chunked_attention`` above
    ATTN_CHUNK_THRESHOLD) on one recorded prefill's q, k, v: within
    LM_KERNEL_TOL, and within LM_KERNEL_TOL x max |plain| (past a
    thousand keys the outputs shrink to about sqrt(e / n)). Returns the
    kernel's output."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.models import layers as L
    got = flash_attention(q, k, v, **kw)
    long = max(q.shape[1], k.shape[1]) > L.ATTN_CHUNK_THRESHOLD
    twin = (L.chunked_attention(q, k, v, chunk=L.ATTN_CHUNK, **kw) if long
            else L.full_attention(q, k, v, **kw))
    for want, against in ((attention_ref(q, k, v, **kw), "attention_ref"),
                          (twin, "chunked_attention" if long
                           else "full_attention")):
        check_close(errs, name, got, want, LM_KERNEL_TOL,
                    f"{what} against {against}")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        require(err <= LM_KERNEL_TOL * scale,
                f"{name} {what} against {against}: error {err} exceeds "
                f"{LM_KERNEL_TOL} x max |plain| {scale}")
    return got


def check_attention_exact(q, k, v, kw, what, factor=1.0):
    """The flash kernel against its plain version in float64
    (``attention_ref`` on the same q, k, v values, upcast): within
    LM_KERNEL_TOL, and no farther from it than ``factor`` times the plain
    versions in q's type, ``attention_ref`` and ``full_attention``. For
    bf16 outputs of magnitude 1 to 4 (hymba's), two bf16 roundings of one
    value can differ by more than LM_KERNEL_TOL, so the float64 value is
    the one every version is held to. Returns each version's max abs
    error."""
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.models import layers as L
    with tf32(False):
        exact = attention_ref(q.double(), k.double(), v.double(), **kw)
        outs = {"flash": flash_attention(q, k, v, **kw),
                "attention_ref": attention_ref(q, k, v, **kw),
                "full_attention": L.full_attention(q, k, v, **kw)}
    errs = {}
    for name, out in outs.items():
        require(out.shape == exact.shape and out.dtype == q.dtype,
                f"{what}: {name} gave {tuple(out.shape)} {out.dtype}")
        errs[name] = float((out.double() - exact).abs().max())
        require(math.isfinite(errs[name]), f"{what}: {name} not finite")
    require(errs["flash"] <= LM_KERNEL_TOL,
            f"{what}: flash_attention {errs['flash']} from the float64 "
            f"attention, above {LM_KERNEL_TOL}")
    for name in ("attention_ref", "full_attention"):
        require(errs["flash"] <= factor * errs[name],
                f"{what}: flash_attention {errs['flash']} from the float64 "
                f"attention, farther than {factor} x {name} in {q.dtype} "
                f"({errs[name]})")
    return errs


def serve_full_width(torch, card, errs, cfg, tag):
    """``cfg`` at full width through ``LMEngine`` from seeded float32
    weights (cast to bf16 by the engine), from every launch count at 0:
    LM_REQUESTS prompts of LM_PROMPT tokens through LM_SLOTS slots, every
    request served with flash launched once a layer a prefill, the
    tokens a single-request loop's or within LM_PART_TOL of its top;
    decode against forward; the kernel against its plain versions on
    the q, k, v of layer 0 of a served prefill (``check_attention``) and
    of a LM_LONG_PREFILL-token one (``check_attention_exact``), timed
    beside SDPA; the
    decode step's time, idle share, launches and synchronizations
    against its byte bound. Frees what it made. Returns the kernels
    line's row of the served prefill."""
    import gc

    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import LMEngine, LMRequest
    dev = torch.device("cuda")
    # 1. through the engine, from every launch count at 0
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    f32_bytes = sum(t.numel() * 4 for t in params.parameters())
    t_init = time.perf_counter() - t0
    eng = LMEngine(cfg, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                   device=dev)
    rng = np.random.default_rng(0)
    reqs = [LMRequest(prompt=rng.integers(0, cfg.vocab_size, LM_PROMPT,
                                          dtype=np.int32),
                      max_new_tokens=LM_NEW) for _ in range(LM_REQUESTS)]
    with record_attention(L) as (seen, _):
        done, seconds, launches, prefill_ms, decode_ms = serve_timed(
            torch, lm, eng, reqs)
    require(len(done) == LM_REQUESTS
            and all(len(r.out_tokens) == LM_NEW for r in reqs),
            f"{tag}: {len(done)} requests done, tokens "
            f"{[len(r.out_tokens) for r in reqs]}")
    require(launches == LM_REQUESTS * cfg.n_layers,
            f"{tag}: flash_attention launched {launches} times in the engine's "
            f"run, expected {LM_REQUESTS} x {cfg.n_layers}")
    n_tok = sum(len(r.out_tokens) for r in reqs)

    parted = single_loop_partings(torch, lm, cfg, params, reqs, dev,
                                  LM_MAX_SEQ, tag)

    # 2. decode against forward at full width
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, LM_DECODE_S + 1)).astype(np.int32), device=dev)
    dvf_err = decode_vs_forward(torch, lm, cfg, params, toks, LM_DECODE_S,
                                LM_DECODE_S + 8, cfg.name)

    # 3. the kernel against its plain versions at the path's shapes
    q, k, v, kw = seen["prefill"]
    with record_attention(L) as (long_seen, _), torch.inference_mode():
        lm.prefill(cfg, params, torch.as_tensor(np.random.default_rng(3)
                   .integers(0, cfg.vocab_size, (1, LM_LONG_PREFILL))
                   .astype(np.int32), device=dev))
    ql, kl, vl, kwl = long_seen["prefill"]
    require(q.shape == (1, LM_PROMPT, cfg.n_heads, cfg.head_dim)
            and q.dtype == torch.bfloat16 and ql.shape[1] == LM_LONG_PREFILL
            and LM_LONG_PREFILL > L.ATTN_CHUNK_THRESHOLD,
            f"{tag}: recorded attention inputs {tuple(q.shape)} {q.dtype}, "
            f"{tuple(ql.shape)}")
    name = f"flash_attention {cfg.name} prefill"
    got = check_attention(errs, name, q, k, v, kw, "served prefill layer 0")
    what = f"{cfg.name} {LM_LONG_PREFILL}-token prefill layer 0"
    long_errs = check_attention_exact(ql, kl, vl, kwl, what)
    del ql, kl, vl

    # the row of the kernels line: the kernel at the served prefill's shape
    b, sq, h, dh = q.shape
    row, dev_us, sdpa_us, n_bytes, flops = flash_row(
        torch, name, q, k, v, kw, launches, errs[name])
    b_ms, b_by = row["bound_ms"], row["bound_by"]

    # 4. the decode step: time, idle share, launches, bound
    toks4 = torch.as_tensor(eng.last_tok, device=dev)
    pos4 = torch.as_tensor(eng.positions, device=dev)
    wall_us, busy_us, idle, kernels, syncs = decode_profile(
        torch, lm, cfg, params, eng.cache, toks4, pos4)
    step_bytes = decode_bytes(cfg, params, eng.cache, LM_SLOTS)
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {cfg.name} ({cfg.param_count() / 1e9:.2f} B parameters, "
          f"{f32_bytes / 1e9:.1f} GB float32 at init in {t_init:.1f}s, "
          f"bf16 after the engine's cast): {LM_REQUESTS} requests of "
          f"{LM_PROMPT} tokens, {LM_SLOTS} slots, max_seq {LM_MAX_SEQ}: "
          f"{n_tok} tokens in {seconds:.3f}s ({n_tok / seconds:.1f} tok/s); "
          f"flash_attention launches {launches} ({cfg.n_layers} a request); "
          f"prefill median {statistics.median(prefill_ms):.3f} ms a request "
          f"({len(prefill_ms)}), decode median "
          f"{statistics.median(decode_ms):.3f} ms a step ({len(decode_ms)}) "
          f"on {card}")
    print(f"[{tag}] single-request loop: {partings_text(parted, n_tok)}"
          f"; decode against forward (S {LM_DECODE_S}) max abs err "
          f"{dvf_err:.5f} (tolerance {LM_ATOL} + {LM_RTOL}|x|)")
    print(f"[{tag}] decode step ({LM_SLOTS} slots): profiled {wall_us:.1f} us, "
          f"device busy {busy_us:.1f} us, idle share {idle:.4f}, "
          f"{kernels:.0f} kernel launches and {syncs} synchronizations a "
          f"step; bound {step_bound_ms:.4f} "
          f"ms ({step_bytes} bytes over 3.35 TB/s: the bf16 weights a step "
          f"reads and the cache); max_memory_allocated {peak} bytes on "
          f"{card}")
    print(f"[{tag}] flash_attention at {cfg.name}'s prefill (B {b}, S {sq}, "
          f"H {h}, "
          f"KV {k.shape[2]}, dh {dh}, bf16): {row['ms']:.5f} ms, device "
          f"{us_text(dev_us)} a launch; plain {row['plain_ms']:.5f} ms; SDPA "
          f"{row['library_ms']:.5f} ms (device {us_text(sdpa_us)} a call); "
          f"bound {b_ms:.7f} ms by {b_by} "
          f"({n_bytes} bytes, {flops} operations at 989 T/s); max abs err "
          f"{row['max_abs_err']:.4g}; kernel within {LM_KERNEL_TOL} of "
          f"full_attention at S {LM_PROMPT} and of the float64 attention, "
          f"no farther than attention_ref and full_attention in bf16, at S "
          f"{LM_LONG_PREFILL} (max abs err of flash / attention_ref / "
          f"full_attention {long_errs['flash']:.6g} / "
          f"{long_errs['attention_ref']:.6g} / "
          f"{long_errs['full_attention']:.6g}) on {card}")
    del eng, params, seen, q, k, v, got, toks4, pos4, toks
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_lm(torch, card, errs):
    """The LM serving path on the card: glm4-9b at full width through
    ``LMEngine`` (the flash kernel one launch a layer per prefill, from
    every launch count at 0), against a single-request greedy loop;
    decode against forward; the kernel against its plain versions at
    the path's shapes (one layer of a served prefill, and of a prefill
    past ATTN_CHUNK_THRESHOLD); then hymba-1.5b at full width with a
    prompt past its window. Returns row 7c of the kernels line."""
    import gc

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import LMEngine, LMRequest
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1-4. glm4-9b through the engine, from every launch count at 0
    row = serve_full_width(torch, card, errs, get_arch(LM_ARCH), "lm")

    # 5. hymba-1.5b: a prompt past its window, three short ones
    hcfg = get_arch(LM_HYBRID)
    hparams = lm.init_params(hcfg, torch.Generator(device=dev).manual_seed(0))
    heng = LMEngine(hcfg, hparams, n_slots=LM_SLOTS,
                    max_seq=HYBRID_MAX_SEQ, device=dev)
    rng = np.random.default_rng(1)
    long_prompt = rng.integers(0, hcfg.vocab_size, HYBRID_LONG + 1,
                               dtype=np.int32)
    hreqs = [LMRequest(prompt=long_prompt[:HYBRID_LONG],
                       max_new_tokens=HYBRID_NEW)] + [
        LMRequest(prompt=rng.integers(0, hcfg.vocab_size, HYBRID_SHORT,
                                      dtype=np.int32),
                  max_new_tokens=HYBRID_NEW) for _ in range(3)]
    with record_attention(L, lambda q, k, kw: "long" if q.shape[1] ==
                          HYBRID_LONG else None) as (hseen, _):
        hdone, hsec, hlaunch, hpre, hdec = serve_timed(torch, lm, heng,
                                                       hreqs)
    require(len(hdone) == 4 and all(len(r.out_tokens) == HYBRID_NEW
                                    for r in hreqs),
            f"lm {LM_HYBRID}: {len(hdone)} done")
    require(hlaunch == 4 * hcfg.n_layers,
            f"lm {LM_HYBRID}: flash_attention launched {hlaunch} times")
    require(heng.cache["k"].shape[2] == hcfg.window,
            f"lm {LM_HYBRID}: attention cache {tuple(heng.cache['k'].shape)}"
            f" is not window-long ({hcfg.window})")
    # the kernel against its plain versions at the long prompt's shape:
    # 76 query rows past the sliding window
    require(len(hseen) == 1, f"lm {LM_HYBRID}: no {HYBRID_LONG}-token "
            "prefill attention was recorded")
    hq, hk, hv, hkw = hseen["long"]
    require(hkw.get("window") == hcfg.window == 1024
            and hq.shape == (1, HYBRID_LONG, hcfg.n_heads, hcfg.head_dim)
            and hk.shape[2] == hcfg.n_kv_heads and hq.shape[1] > hcfg.window
            and hq.dtype == torch.bfloat16,
            f"lm {LM_HYBRID}: recorded attention inputs {tuple(hq.shape)} "
            f"{tuple(hk.shape)} {hq.dtype} {hkw}")
    hattn_errs = {}
    check_attention(hattn_errs, "flash_attention", hq, hk, hv, hkw,
                    f"{LM_HYBRID} {HYBRID_LONG}-token prefill layer 0")
    del hq, hk, hv, hseen
    hdvf = decode_vs_forward(
        torch, lm, hcfg, hparams, torch.as_tensor(long_prompt[None],
                                                  device=dev),
        HYBRID_LONG, HYBRID_MAX_SEQ, LM_HYBRID)
    hn = sum(len(r.out_tokens) for r in hreqs)
    hwall, hbusy, hidle, hkern, hsync = decode_profile(
        torch, lm, hcfg, hparams, heng.cache,
        torch.as_tensor(heng.last_tok, device=dev),
        torch.as_tensor(heng.positions, device=dev))
    hstep_bytes = decode_bytes(hcfg, hparams, heng.cache, LM_SLOTS)
    print(f"[lm] {LM_HYBRID}: prompts {HYBRID_LONG} (past the window of "
          f"{hcfg.window}) and 3 x {HYBRID_SHORT}, max_seq {HYBRID_MAX_SEQ}: "
          f"{hn} tokens in {hsec:.3f}s ({hn / hsec:.1f} tok/s); attention "
          f"cache {tuple(heng.cache['k'].shape)}; flash_attention launches "
          f"{hlaunch}; prefill median {statistics.median(hpre):.3f} ms "
          f"(longest {max(hpre):.3f}), decode median "
          f"{statistics.median(hdec):.3f} ms a step; profiled step "
          f"{hwall:.1f} us, busy {hbusy:.1f} us, idle share {hidle:.4f}, "
          f"{hkern:.0f} launches, {hsync} synchronizations; bound "
          f"{hstep_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({hstep_bytes} "
          f"bytes over 3.35 TB/s, as glm4's); flash_attention at the "
          f"{HYBRID_LONG}-token prefill (window {hcfg.window}, H "
          f"{hcfg.n_heads}, KV {hcfg.n_kv_heads}, dh {hcfg.head_dim}) within "
          f"{LM_KERNEL_TOL} of attention_ref and full_attention (max abs err "
          f"{hattn_errs['flash_attention']:.4g}); decode against "
          f"forward at S {HYBRID_LONG} "
          f"max abs err {hdvf:.5f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}")
    del heng, hparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f}s")
    return row


MOE_ARCH, ENCDEC_ARCH = "mixtral-8x22b", "seamless-m4t-large-v2"
MOE_LAYERS = 4            # of 56: 41.7 GB of float32 at init on one card
MOE_DVF_CF = 8.0          # tests/test_models.py:53-54: no token drops
ENCDEC_BATCH, ENCDEC_FRAMES = 4, 256


def phase_lm_moe_encdec(torch, card, errs):
    """The MoE and encoder-decoder families on the card. mixtral-8x22b
    at full width, cut to MOE_LAYERS of its 56 layers, served through
    ``LMEngine`` with the glm4 phase's traffic (every request served,
    flash launched once a layer a request, the tokens a single-request
    loop's or within LM_PART_TOL of its top), decode against forward at
    capacity factor 8; then seamless-m4t-large-v2 at full width and
    depth, a batch of 4 through ``prefill(enc_embeds=)`` and greedy
    ``decode_step``, decode against forward. The flash kernel is held
    against ``attention_ref`` and its CPU twin at every new shape the
    two serve (mixtral's windowed GQA prefill; seamless's encoder,
    cross-attention in prefill and in decode) and timed beside SDPA.
    Returns rows 7d-7g of the kernels line."""
    import gc

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving.engine import LMEngine, LMRequest
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows = []

    # 1. mixtral-8x22b, its depth cut, through the engine
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    f32_bytes = sum(t_.numel() * 4 for t_ in params.parameters())
    t_init = time.perf_counter() - t0
    eng = LMEngine(cfg, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ,
                   device=dev)
    rng = np.random.default_rng(0)
    reqs = [LMRequest(prompt=rng.integers(0, cfg.vocab_size, LM_PROMPT,
                                          dtype=np.int32),
                      max_new_tokens=LM_NEW) for _ in range(LM_REQUESTS)]
    with record_attention(L) as (seen, _):
        done, seconds, launches, prefill_ms, decode_ms = serve_timed(
            torch, lm, eng, reqs)
    require(len(done) == LM_REQUESTS
            and all(len(r.out_tokens) == LM_NEW for r in reqs),
            f"{MOE_ARCH}: {len(done)} requests done")
    require(launches == LM_REQUESTS * cfg.n_layers,
            f"{MOE_ARCH}: flash_attention launched {launches} times in the "
            f"engine's run, expected {LM_REQUESTS} x {cfg.n_layers}")
    n_tok = sum(len(r.out_tokens) for r in reqs)
    parted = single_loop_partings(torch, lm, cfg, params, reqs, dev,
                                  LM_MAX_SEQ, MOE_ARCH)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, LM_DECODE_S + 1)).astype(np.int32), device=dev)
    dvf = decode_vs_forward(
        torch, lm, dataclasses.replace(cfg, capacity_factor=MOE_DVF_CF),
        params, toks, LM_DECODE_S, LM_DECODE_S + 8, MOE_ARCH)

    # row 7d: the kernel at the served prefill (window, GQA 6:1, dh 128)
    q, k, v, kw = seen["prefill"]
    require(q.shape == (1, LM_PROMPT, 48, 128) and k.shape[2] == 8
            and kw.get("window") == cfg.window == 4096
            and q.dtype == torch.bfloat16,
            f"{MOE_ARCH}: recorded attention inputs {tuple(q.shape)} "
            f"{tuple(k.shape)} {q.dtype} {kw}")
    name = "flash_attention mixtral-8x22b prefill"
    check_attention(errs, name, q, k, v, kw, "served prefill layer 0")
    row, dev_us, sdpa_us, n_bytes, flops = flash_row(
        torch, name, q, k, v, kw, launches, errs[name])
    rows.append(row)
    wall_us, busy_us, idle, kernels, syncs = decode_profile(
        torch, lm, cfg, params, eng.cache,
        torch.as_tensor(eng.last_tok, device=dev),
        torch.as_tensor(eng.positions, device=dev))
    step_bytes = decode_bytes(cfg, params, eng.cache, LM_SLOTS)
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm2] {MOE_ARCH}: depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers at full width (d {cfg.d_model}, H "
          f"{cfg.n_heads}, KV {cfg.n_kv_heads}, d_ff {cfg.d_ff}, "
          f"{cfg.n_experts} experts top-{cfg.moe_top_k}, window "
          f"{cfg.window}, capacity factor {cfg.capacity_factor}); "
          f"{cfg.param_count() / 1e9:.2f} B parameters, "
          f"{f32_bytes / 1e9:.1f} GB float32 at init in {t_init:.1f}s, bf16 "
          f"after the engine's cast; max_memory_allocated {peak} bytes on "
          f"{card}")
    print(f"[lm2] {MOE_ARCH}: {LM_REQUESTS} requests of {LM_PROMPT} tokens, "
          f"{LM_SLOTS} slots, max_seq {LM_MAX_SEQ}: {n_tok} tokens in "
          f"{seconds:.3f}s ({n_tok / seconds:.1f} tok/s); flash_attention "
          f"launches {launches} ({cfg.n_layers} a request); prefill median "
          f"{statistics.median(prefill_ms):.3f} ms a request, decode median "
          f"{statistics.median(decode_ms):.3f} ms a step "
          f"({len(decode_ms)}); decode step profiled {wall_us:.1f} us, "
          f"device busy {busy_us:.1f} us, idle share {idle:.4f}, "
          f"{kernels:.0f} kernel launches and {syncs} synchronizations a "
          f"step; bound {step_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"({step_bytes} bytes over 3.35 TB/s: every expert's bf16 weights "
          f"and the cache) on {card}")
    print(f"[lm2] {MOE_ARCH}: single-request loop: "
          f"{partings_text(parted, n_tok)}; decode against forward (S "
          f"{LM_DECODE_S}, capacity factor {MOE_DVF_CF}) max abs err "
          f"{dvf:.5f} (tolerance {LM_ATOL} + {LM_RTOL}|x|); flash_attention "
          f"at the prefill (B 1, S {LM_PROMPT}, H 48, KV 8, dh 128, window "
          f"{cfg.window}, bf16): {row['ms']:.5f} ms, device "
          f"{us_text(dev_us)} a launch; plain {row['plain_ms']:.5f} ms; SDPA "
          f"{row['library_ms']:.5f} ms (device {us_text(sdpa_us)} a call); "
          f"bound {row['bound_ms']:.7f} ms by {row['bound_by']} ({n_bytes} "
          f"bytes, {flops} operations at 989 T/s); max abs err "
          f"{row['max_abs_err']:.4g} on {card}")
    del eng, params, seen, q, k, v, toks
    gc.collect()
    torch.cuda.empty_cache()

    # 2. seamless-m4t-large-v2 at full width and depth
    t_enc = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(ENCDEC_ARCH)
    params = lm.cast_weights_(cfg, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(0)
    enc = torch.as_tensor(rng.normal(size=(
        ENCDEC_BATCH, ENCDEC_FRAMES, cfg.d_model)) * 0.1,
        device=dev).to(torch.bfloat16)
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (ENCDEC_BATCH, LM_PROMPT + 1)).astype(np.int32),
        device=dev)
    max_seq = LM_PROMPT + LM_NEW
    out_toks, step_ms = [], []

    def kind(q, k, kw):
        if kw.get("causal", True):
            return "decoder"
        if k.shape[1] != ENCDEC_FRAMES:
            return None
        if q.shape[1] == ENCDEC_FRAMES:
            return "encoder"
        return {LM_PROMPT: "cross prefill", 1: "cross decode"}.get(
            q.shape[1])

    with torch.inference_mode():          # warm: the first call's shapes
        _, cache = lm.prefill(cfg, params, toks[:, :LM_PROMPT],
                              enc_embeds=enc, max_seq=max_seq)
        lm.decode_step(cfg, params, cache, toks[:, LM_PROMPT:],
                       torch.full((ENCDEC_BATCH,), LM_PROMPT,
                                  dtype=torch.int32, device=dev))
        del cache
    with record_attention(L, kind) as (eseen, counts), \
            torch.inference_mode():
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(cfg, params, toks[:, :LM_PROMPT],
                                   enc_embeds=enc, max_seq=max_seq)
        nxt = logits.argmax(-1).to(torch.int32)
        out_toks.append(nxt.cpu())
        e_prefill_ms = (time.perf_counter() - t0) * 1e3
        n_prefill = launch_counts()["flash_attention"]
        d_prefill = launch_counts()["decode_attention"]
        pos = torch.full((ENCDEC_BATCH,), LM_PROMPT, dtype=torch.int32,
                         device=dev)
        t1 = time.perf_counter()
        for _ in range(LM_NEW - 1):
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(cfg, params, cache, nxt[:, None],
                                           pos)
            nxt = logits.argmax(-1).to(torch.int32)
            out_toks.append(nxt.cpu())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            pos += 1
        e_seconds = e_prefill_ms / 1e3 + time.perf_counter() - t1
        n_steps = launch_counts()["flash_attention"] - n_prefill
        d_steps = launch_counts()["decode_attention"] - d_prefill
    n_etok = ENCDEC_BATCH * LM_NEW
    require(n_prefill == cfg.n_enc_layers + 2 * cfg.n_layers
            and n_steps == (LM_NEW - 1) * cfg.n_layers,
            f"{ENCDEC_ARCH}: flash_attention launched {n_prefill} times in "
            f"prefill and {n_steps} in {LM_NEW - 1} decode steps")
    # the decoder's self-attention over the ring: the decode kernel alone
    require(d_prefill == 0 and d_steps == (LM_NEW - 1) * cfg.n_layers,
            f"{ENCDEC_ARCH}: decode_attention launched {d_prefill} times in "
            f"prefill and {d_steps} in {LM_NEW - 1} decode steps")
    require(counts == {"encoder": cfg.n_enc_layers,
                       "decoder": cfg.n_layers,
                       "cross prefill": cfg.n_layers,
                       "cross decode": (LM_NEW - 1) * cfg.n_layers},
            f"{ENCDEC_ARCH}: attention calls by kind {counts}")
    require(cache["enc_out"].shape == (ENCDEC_BATCH, ENCDEC_FRAMES,
                                       cfg.d_model)
            and all(bool((t_ >= 0).all() and (t_ < cfg.padded_vocab).all())
                    for t_ in out_toks),
            f"{ENCDEC_ARCH}: enc_out {tuple(cache['enc_out'].shape)}")
    edvf = decode_vs_forward(torch, lm, cfg, params, toks, LM_PROMPT,
                             max_seq, ENCDEC_ARCH, enc_embeds=enc)
    ewall, ebusy, eidle, ekern, esync = decode_profile(
        torch, lm, cfg, params, cache, nxt[:, None], pos)
    estep_bytes = decode_bytes(cfg, params, cache, ENCDEC_BATCH)

    # rows 7e-7g: the encoder, cross-attention in prefill and in decode
    shapes = {"encoder": (ENCDEC_FRAMES, ENCDEC_FRAMES),
              "cross prefill": (LM_PROMPT, ENCDEC_FRAMES),
              "cross decode": (1, ENCDEC_FRAMES)}
    texts = []
    for kind_, (sq, sk) in shapes.items():
        q, k, v, kw = eseen[kind_]
        require(q.shape == (ENCDEC_BATCH, sq, 16, 64)
                and k.shape == (ENCDEC_BATCH, sk, 16, 64)
                and kw.get("causal") is False and not kw.get("window")
                and q.dtype == torch.bfloat16,
                f"{ENCDEC_ARCH} {kind_}: recorded attention inputs "
                f"{tuple(q.shape)} {tuple(k.shape)} {q.dtype} {kw}")
        name = f"flash_attention seamless-m4t-large-v2 {kind_}"
        check_attention(errs, name, q, k, v, kw, f"{kind_} layer 0")
        row, dev_us, sdpa_us, n_bytes, flops = flash_row(
            torch, name, q, k, v, kw, counts[kind_], errs[name])
        rows.append(row)
        texts.append(
            f"{kind_} (B {ENCDEC_BATCH}, Sq {sq}, Sk {sk}, H 16, dh 64, not "
            f"causal; {counts[kind_]} launches): {row['ms']:.5f} ms, device "
            f"{us_text(dev_us)} a launch; plain {row['plain_ms']:.5f} ms; "
            f"SDPA {row['library_ms']:.5f} ms (device {us_text(sdpa_us)} a "
            f"call); bound {row['bound_ms']:.7f} ms by {row['bound_by']} "
            f"({n_bytes} bytes, {flops} operations); max abs err "
            f"{row['max_abs_err']:.4g}")
    print(f"[lm2] {ENCDEC_ARCH}: {cfg.n_enc_layers} + {cfg.n_layers} layers "
          f"at full width (d {cfg.d_model}, H {cfg.n_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}), nothing cut; "
          f"{cfg.param_count() / 1e9:.2f} B parameters; a batch of "
          f"{ENCDEC_BATCH}, {ENCDEC_FRAMES} frames, prompts of {LM_PROMPT} "
          f"tokens, {LM_NEW} new: {n_etok} tokens in {e_seconds:.3f}s "
          f"({n_etok / e_seconds:.1f} tok/s); prefill {e_prefill_ms:.3f} ms "
          f"({n_prefill} flash launches), decode median "
          f"{statistics.median(step_ms):.3f} ms a step ({cfg.n_layers} flash "
          f"launches a step); decode step profiled {ewall:.1f} us, device "
          f"busy {ebusy:.1f} us, idle share {eidle:.4f}, {ekern:.0f} kernel "
          f"launches and {esync} synchronizations a step; bound "
          f"{estep_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({estep_bytes} bytes "
          f"over 3.35 TB/s: the decoder's and the head's bf16 weights and the "
          f"caches, enc_out among them); decode against forward max abs err "
          f"{edvf:.5f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}")
    for text in texts:
        print(f"[lm2] flash_attention at {ENCDEC_ARCH}'s {text} on {card}")
    del params, cache, enc, toks, eseen, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm2] seamless {time.perf_counter() - t_enc:.1f}s; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    return rows

# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------

LM_TRAIN_ARCH, LM_TRAIN_LAYERS = "glm4-9b", 4   # of 40: 2.06 G parameters
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 4, 1024, 6  # two loss chunks a row
SMOKE_B, SMOKE_S, SMOKE_STEPS = 2, 64, 3
# smoke configurations at float32 (TF32 off), one step's loss and every
# gradient leaf on the card against the CPU's within TRAIN_CARD_TOL x
# max(1, max |cpu|): the products sum in other orders on the two devices
# (float32 rounding, 1e-7 relative a product) and the flash kernel's
# three TF32 passes err by about 1e-6
TRAIN_CARD_TOL = 1e-4
FLASH_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def attn_key(q, k, kw):
    """The kernel shape of one attention call on the card: (q shape, k
    shape, type, causal, window); None for a call on the CPU."""
    if q.device.type != "cuda":
        return None
    return (tuple(q.shape), tuple(k.shape), str(q.dtype).split(".")[1],
            bool(kw.get("causal", True)), int(kw.get("window", 0)))


def flash_grads_close(torch, errs, name, q, k, v, kw):
    """The backward kernel against autograd through ``attention_ref`` (TF32
    off) on q, k, v and a seeded dout: dq, dk, dv each within the
    forward's tolerance (2e-4 float32, 2e-2 bf16) x max(1, max |plain|);
    the forward's output with its log-sum-exp bit for bit the serving
    launch's. Returns (out, lse, dout, max abs error)."""
    from repro_torch.kernels.flash_attention import (
        attention_backward_ref, flash_attention, flash_attention_backward,
        flash_attention_forward)
    tol = FLASH_TOL[str(q.dtype).split(".")[1]]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    g = torch.Generator(device=q.device).manual_seed(q.shape[1])
    dout = torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
    with torch.no_grad():
        out, lse = flash_attention_forward(q, k, v, causal=causal,
                                           window=window)
        require(torch.equal(out, flash_attention(q, k, v, causal=causal,
                                                 window=window)),
                f"{name}: the forward with its log-sum-exp differs from the "
                "serving launch")
        got = flash_attention_backward(q, k, v, out, dout, lse,
                                       causal=causal, window=window)
    with tf32(False):
        want = attention_backward_ref(q, k, v, dout, causal=causal,
                                      window=window)
    torch.cuda.synchronize()
    worst = 0.0
    for gname, a, b in zip(("dq", "dk", "dv"), got, want):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{name} {gname}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        err = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        require(math.isfinite(err) and err <= tol * scale,
                f"{name} {gname}: error {err} exceeds {tol} x {scale}")
        worst = max(worst, err)
    errs[name] = max(errs.get(name, 0.0), worst)
    return out, lse, dout, worst


def leaf_errs(torch, got, want):
    """Per leaf max |got - want| / max(1, max |want|), got on the card."""
    return [float((a.detach().float().cpu() - b.detach().float()).abs().max())
            / max(1.0, float(b.detach().float().abs().max()))
            for a, b in zip(got, want)]


def smoke_batch(torch, cfg, dev, seed=0):
    from repro_torch.data.tokens import lm_batch
    toks, labels = lm_batch(cfg, SMOKE_B, SMOKE_S, seed, 0)
    b = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.is_encdec:
        b["enc_embeds"] = torch.randn(
            (SMOKE_B, SMOKE_S // cfg.frontend_frames_div, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 1)) * 0.1
    return {k: v.to(dev) for k, v in b.items()}


def phase_lm_train(torch, card, errs):
    """LM training on the card. (b) glm4-9b at full width, 4 of its 40
    layers, six AdamW steps through ``Trainer`` from every launch count at
    0: finite losses, flash forward 2 a layer a step (the block's
    recomputation included) and backward 1; ms a step, tokens/s, peak
    memory, the profiled idle share, launches a step, the step's bound.
    (c) Five smoke configurations (moe, ssm, hybrid, encdec, the QAT
    example's) at float32: step 1's loss and gradients on the card
    against the CPU's, then three steps on the card (top-k, sign and
    grad_accum 2 once each). (d) A smoke-width checkpoint written at step
    3, resumed bit for bit by a new Trainer, and an emergency checkpoint
    after a failing batch. (a) The backward kernel against autograd
    through ``attention_ref`` at every shape the phase launched it at and
    at a ragged one; rows 7h / 7i of the kernels line at glm4's training
    shape beside SDPA."""
    from repro_torch.bench.profiled import device_time
    import copy
    import gc
    import tempfile

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.examples.train_lm_qat import qat_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        attention_backward_ref, attention_ref, flash_attention_backward,
        flash_attention_forward)
    from repro_torch.launch.train import batches
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import (Trainer, init_state, loss_and_grads,
                                        make_train_step)
    from repro_torch.train.optim import AdamW
    from repro_torch.train.schedules import warmup_cosine
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    # (b) glm4-9b, 4 of 40 layers at full width, through Trainer
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_LAYERS)
    opt = AdamW(lr=warmup_cosine(3e-4, 1, LM_TRAIN_STEPS), weight_decay=0.01,
                grad_clip=1.0)
    state = init_state(cfg, opt, torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in lm.leaves(state.params))
    stream = batches(cfg, LM_TRAIN_B, LM_TRAIN_S, 0, dev)
    trainer = Trainer(make_train_step(cfg, opt), state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    key = lambda q, k, kw: attn_key(q, k, kw)  # noqa: E731
    branches0 = dict(flash_attention_backward.branches)
    with record_attention(L, key) as (seen, calls):
        reset_launch_counts()
        for _ in range(LM_TRAIN_STEPS):
            t0 = time.perf_counter()
            last = trainer.run(stream, 1, log_every=1, log_fn=lambda *_: None)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(last["loss"])
        counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_fwd = counts["flash_attention"]
    n_bwd = counts["flash_attention_backward"]
    require(all(math.isfinite(x) for x in losses),
            f"lm_train {LM_TRAIN_ARCH}: losses {losses}")
    require(n_fwd == 2 * LM_TRAIN_LAYERS * LM_TRAIN_STEPS
            and n_bwd == LM_TRAIN_LAYERS * LM_TRAIN_STEPS,
            f"lm_train {LM_TRAIN_ARCH}: flash forward {n_fwd}, backward "
            f"{n_bwd} "
            f"launches in {LM_TRAIN_STEPS} steps, expected "
            f"{2 * LM_TRAIN_LAYERS} and {LM_TRAIN_LAYERS} a step")
    wg_train = (flash_attention_backward.branches["wgmma"]
                - branches0.get("wgmma", 0))
    require(wg_train == n_bwd, f"lm_train {LM_TRAIN_ARCH}: {wg_train} of "
            f"{n_bwd} backward launches took the wgmma branch")
    # every layer's wq, wk, wv took a non-zero gradient: its first moment
    mu = trainer.state.opt.mu
    attn_mu = [float(mu[i].abs().max()) for i, n in enumerate(
        lm.leaf_names(trainer.state.params))
        if n.endswith(("::wq", "::wk", "::wv"))]
    require(len(attn_mu) == 3 * LM_TRAIN_LAYERS and min(attn_mu) > 0,
            f"lm_train: wq / wk / wv first moments {attn_mu}")
    # one profiled step: device busy, idle share, kernel launches a step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(stream, 1, log_every=1, log_fn=lambda *_: None)
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    idle = 1.0 - busy_us / 1e3 / prof_ms
    med_ms = statistics.median(step_ms[1:])
    tokens = LM_TRAIN_B * LM_TRAIN_S
    glm_key = next(iter(seen))
    gq, gk, gv, gkw = seen[glm_key]
    b_, sq, h, dh = gq.shape
    causal, window = gkw.get("causal", True), gkw.get("window", 0)
    pairs = b_ * h * int(L._mask(sq, gk.shape[1], causal, window, dev).sum())
    # the step's products: 8 N T (forward, remat forward, backward); the
    # finer count: the layers' matrices 8 N_layers T, the head's 6 N_head T
    # (no remat), attention 18 dh a kept pair a layer (4 + 4 forward, 10
    # backward); the embedding is a gather
    head = cfg.d_model * cfg.padded_vocab
    n_layers = n_params - (2 - cfg.tie_embeddings) * head - cfg.d_model
    flop_issue = 8 * n_params * tokens
    flop_fine = (8 * n_layers * tokens + 6 * head * tokens
                 + 18 * dh * pairs * LM_TRAIN_LAYERS)
    adam_bytes = 28 * n_params
    print(f"[lm_train] {LM_TRAIN_ARCH} at full width, {LM_TRAIN_LAYERS} of 40 "
          f"layers ({n_params} parameters), B {LM_TRAIN_B} x S {LM_TRAIN_S}, "
          f"AdamW warmup-cosine, decay 0.01, clip 1.0: losses "
          f"{[round(x, 4) for x in losses]}; ms a step "
          f"{[round(x, 1) for x in step_ms]} "
          f"(median of steps 2-{LM_TRAIN_STEPS} {med_ms:.3f} ms, "
          f"{tokens / med_ms * 1e3:.1f} tokens/s); max_memory_allocated "
          f"{peak} bytes; flash launches {n_fwd} forward and {n_bwd} backward "
          f"in {LM_TRAIN_STEPS} steps; on {card}")
    print(f"[lm_train] profiled step {prof_ms:.3f} ms: device busy "
          f"{busy_us / 1e3:.3f} ms, idle share {idle:.4f}, {kernels} kernel "
          f"launches; bound {flop_issue / BF16_OPS_PER_S * 1e3:.3f} ms "
          f"({flop_issue:.4g} FLOP, 8 N T with the remat forward, at 989 "
          f"TFLOP/s; counted finer, {flop_fine:.4g} FLOP, "
          f"{flop_fine / BF16_OPS_PER_S * 1e3:.3f} ms) and AdamW "
          f"{adam_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
          f"({adam_bytes} bytes, 28 a parameter, over 3.35 TB/s) on {card}")
    require(len(seen) == 1 and glm_key[:3] == (
        (LM_TRAIN_B, LM_TRAIN_S, cfg.n_heads, cfg.head_dim),
        (LM_TRAIN_B, LM_TRAIN_S, cfg.n_kv_heads, cfg.head_dim), "bfloat16"),
        f"lm_train: attention shapes {list(seen)}")
    del trainer, state, stream, mu, prof
    gc.collect()
    torch.cuda.empty_cache()

    # (c) smoke configurations at float32: card against CPU, then 3 steps
    smokes = [("moe", get_arch("mixtral-8x22b", smoke=True), "topk", 1),
              ("ssm", get_arch("falcon-mamba-7b", smoke=True), "sign", 1),
              ("hybrid", get_arch("hymba-1.5b", smoke=True), "none", 2),
              ("encdec", get_arch("seamless-m4t-large-v2", smoke=True),
               "none", 1),
              ("qat", qat_config(), "none", 1)]
    texts, failures = [], []
    with record_attention(L, key) as (sseen, _):
        for label, scfg, compress, accum in smokes:
            scfg = dataclasses.replace(scfg, compute_dtype="float32")
            cpu_p = lm.init_params(scfg, torch.Generator().manual_seed(0))
            card_p = copy.deepcopy(cpu_p).to(dev)
            with tf32(False):
                cl, cg = loss_and_grads(scfg, cpu_p, smoke_batch(
                    torch, scfg, "cpu"), accum)
                gl, gg = loss_and_grads(scfg, card_p, smoke_batch(
                    torch, scfg, dev), accum)
            lerr = abs(float(gl) - float(cl)) / max(1.0, abs(float(cl)))
            gerrs = leaf_errs(torch, gg, cg)
            worst = max(gerrs)
            names = lm.leaf_names(cpu_p)
            if not (lerr <= TRAIN_CARD_TOL and worst <= TRAIN_CARD_TOL):
                failures.append(f"{label}: loss {lerr}, leaf "
                                f"{names[gerrs.index(worst)]} {worst}")
            sopt = AdamW(lr=1e-3, weight_decay=0.01)
            st = init_state(scfg, sopt, params=card_p, compress=compress)
            tr = Trainer(make_train_step(scfg, sopt, compress=compress,
                                         grad_accum=accum), st)
            sl = []
            it = iter(lambda: smoke_batch(torch, scfg, dev, len(sl)), None)
            for _ in range(SMOKE_STEPS):
                sl.append(tr.run(it, 1, log_every=1,
                                 log_fn=lambda *_: None)["loss"])
            require(all(math.isfinite(x) for x in sl),
                    f"lm_train {label}: losses {sl}")
            texts.append(f"{label} ({scfg.name}, compress {compress}, "
                         f"grad_accum {accum}): step 1 loss {float(cl):.6f} "
                         f"CPU / {float(gl):.6f} card (err {lerr:.3g}), worst "
                         f"leaf {names[gerrs.index(worst)]} {worst:.3g}; "
                         f"losses {[round(x, 4) for x in sl]}")
    for t in texts:
        print(f"[lm_train] {t}")
    require(not failures, f"lm_train: card against CPU beyond "
            f"{TRAIN_CARD_TOL}: {failures}")

    # (d) checkpoints at smoke width on the card
    ccfg = get_arch(LM_TRAIN_ARCH, smoke=True)
    copt = AdamW(lr=1e-3, weight_decay=0.01)
    with tempfile.TemporaryDirectory() as d:
        tr1 = Trainer(make_train_step(ccfg, copt), init_state(
            ccfg, copt, torch.Generator(device=dev).manual_seed(0)),
            ckpt_dir=d, ckpt_every=3)
        tr1.run(batches(ccfg, 2, 64, 0, dev), 3, log_fn=lambda *_: None)
        require(ckpt.latest_step(d) == 3, f"lm_train: latest step "
                f"{ckpt.latest_step(d)}, expected 3")
        tr2 = Trainer(make_train_step(ccfg, copt), init_state(
            ccfg, copt, torch.Generator(device=dev).manual_seed(1)),
            ckpt_dir=d, ckpt_every=3)
        same = all(torch.equal(a, b) for a, b in zip(
            lm.leaves(tr1.state.params), lm.leaves(tr2.state.params)))
        same_opt = all(torch.equal(a, b) for a, b in zip(
            tr1.state.opt.mu + tr1.state.opt.nu,
            tr2.state.opt.mu + tr2.state.opt.nu))
        require(tr2.step == 3 and same and same_opt,
                f"lm_train: resumed at step {tr2.step}, parameters equal "
                f"{same}, moments equal {same_opt}")

        # step 4 runs, step 5 raises on every retry
        real, calls = tr2.train_step, []

        def failing(state, batch):
            calls.append(len(calls))
            if len(calls) > 1:
                raise RuntimeError("injected failure")
            return real(state, batch)

        tr2.train_step = failing
        try:
            tr2.run(batches(ccfg, 2, 64, 0, dev), 3, log_fn=lambda *_: None)
            raised = False
        except RuntimeError:
            raised = True
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            extra = json.load(f)["extra"]
        require(raised and ckpt.latest_step(d) == 4 and extra == {
            "emergency": True}, f"lm_train: emergency checkpoint "
            f"{ckpt.latest_step(d)} {extra}")
    print(f"[lm_train] checkpoint: {ccfg.name} saved at step 3, a new "
          "Trainer resumed at step 3 with parameters and moments bit for "
          f"bit; a step that raised ({len(calls) - 1} tries) left an "
          "emergency checkpoint at step 4")

    # (a) the backward kernel at every shape the phase launched it at
    ragged = torch.Generator(device=dev).manual_seed(5)
    shapes = dict(sseen)
    shapes[("ragged",)] = tuple(
        torch.randn(s, generator=ragged, device=dev).to(torch.bfloat16)
        for s in ((1, 100, 4, 64), (1, 100, 2, 64), (1, 100, 2, 64))) + (
        {"causal": True, "window": 0},)
    bwd_errs = {}
    branches0 = dict(flash_attention_backward.branches)
    for k_, (q, k, v, kw) in shapes.items():
        require(q.device.type == "cuda", f"lm_train: {k_} recorded on "
                f"{q.device}")
        flash_grads_close(torch, bwd_errs, str(k_), q, k, v, kw)
    # both branches of the backward: wgmma (bf16 at dh 64 and 128) and
    # the mma.sync kernels (float32, other dh)
    took = {b_: flash_attention_backward.branches[b_] - branches0.get(b_, 0)
            for b_ in ("wgmma", "mma")}
    require(took["wgmma"] > 0 and took["mma"] > 0,
            f"lm_train: backward branches reached {took}")
    kinds = sorted(str(k_) for k_ in shapes)
    require(any(k_[2] == "float32" for k_ in sseen)
            and any(k_[4] > 0 and k_[1][2] < k_[0][2] for k_ in sseen)
            and any(not k_[3] and k_[0][1] != k_[1][1] for k_ in sseen),
            f"lm_train: no float32, windowed GQA or cross shape among {kinds}")
    print(f"[lm_train] flash backward within 2e-4 (float32) / 2e-2 (bf16) x "
          f"max(1, max |plain|) of autograd through attention_ref at "
          + "; ".join(f"{k_}: {e:.3g}" for k_, e in sorted(
              bwd_errs.items())))

    # rows 7h / 7i: glm4-9b's training shape
    name_f = "flash_attention glm4-9b train forward"
    name_b = "flash_attention_backward glm4-9b train"
    out, lse, dout, berr = flash_grads_close(torch, errs, name_b, gq, gk, gv,
                                             gkw)
    ferr = float((out.float() - attention_ref(gq, gk, gv, **gkw).float())
                 .abs().max())
    require(ferr <= LM_KERNEL_TOL, f"{name_f}: error {ferr}")
    errs[name_f] = ferr
    fwd = lambda: flash_attention_forward(gq, gk, gv, **gkw)  # noqa: E731
    bwd = lambda: flash_attention_backward(  # noqa: E731
        gq, gk, gv, out, dout, lse, **gkw)
    f_bytes = nbytes(gq, gk, gv, out, lse)
    b_bytes = nbytes(gq, gk, gv, out, dout, lse, gq, gk, gv)
    f_ms, f_by = bound(f_bytes, 4 * dh * pairs, BF16_OPS_PER_S)
    # S recomputed, dP, dV, dQ, dK: 10 dh flops a kept pair
    b_ms, b_by = bound(b_bytes, 10 * dh * pairs, BF16_OPS_PER_S)
    qt, kt, vt = (t_.transpose(1, 2).contiguous().requires_grad_(True)
                  for t_ in (gq, gk, gv))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=bool(causal), enable_gqa=True)
    require(not window, f"lm_train: glm4's window {window}")
    so = sdpa()
    dt_ = dout.transpose(1, 2).contiguous()
    check_close({}, name_f, so.detach().transpose(1, 2), out, LM_KERNEL_TOL,
                "against SDPA")
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        so, (qt, kt, vt), dt_, retain_graph=True)
    with torch.no_grad():
        row_f = {"name": name_f, "route": "cuda",
                 "source": KERNELS["flash_attention"][0],
                 "replaces": KERNELS["flash_attention"][1],
                 "launches": n_fwd, "max_abs_err": ferr, "ms": time_ms(fwd),
                 "plain_ms": time_ms(lambda: attention_ref(gq, gk, gv, **gkw),
                                     iters=10, reps=3),
                 "bound_ms": f_ms, "bound_by": f_by,
                 "library_ms": time_ms(sdpa)}
    row_b = {"name": name_b, "route": "cuda",
             "source": KERNELS["flash_attention_backward"][0],
             "replaces": KERNELS["flash_attention_backward"][1],
             "launches": n_bwd, "max_abs_err": berr, "ms": time_ms(bwd, 50),
             "plain_ms": time_ms(lambda: attention_backward_ref(
                 gq, gk, gv, dout, **gkw), iters=5, reps=3),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(sdpa_bwd, 50)}
    f_us = device_time(fwd, "flash_attention_kernel", 20).launch_us
    require(f_us is not None, "lm_train: the profiler saw no flash forward")
    with torch.no_grad():
        sf_call_us = device_time(sdpa, None, 20).call_us
    # the tensor-parallel local shape (glm4-9b's heads a rank at
    # --model-par 2): half the work of the full shape
    tp = torch.Generator(device=dev).manual_seed(7)
    tq, tk, tv = (torch.randn(s_, generator=tp, device=dev).to(torch.bfloat16)
                  for s_ in ((b_, sq, h // 2, dh), (b_, sq, 1, dh),
                             (b_, sq, 1, dh)))
    tout, tlse, tdout, tp_err = flash_grads_close(
        torch, errs, "flash_attention_backward glm4-9b tensor-parallel",
        tq, tk, tv, gkw)
    tp_bwd = lambda: flash_attention_backward(  # noqa: E731
        tq, tk, tv, tout, tdout, tlse, **gkw)
    tp_ms = time_ms(tp_bwd, 50)
    # the backward's and SDPA's device times at both shapes, from the
    # bench script in a process of its own: late in this script the
    # profiler's sessions have missed launches of these calls
    bench = subprocess.run(
        [sys.executable, os.path.join(ROOT, "src", "repro_torch", "bench",
                                      "flash_backward.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    require(bench.returncode == 0, f"lm_train: flash_backward.py exit "
            f"{bench.returncode}\n{bench.stderr[-3000:]}")
    dev_b = json.loads(bench.stdout.strip().splitlines()[-1])["shapes"]
    require(dev_b["full"]["shape"] == [b_, sq, sq, h, gk.shape[2], dh]
            and dev_b["tp"]["shape"] == [b_, sq, sq, h // 2, 1, dh],
            f"lm_train: the bench's shapes {dev_b['full']['shape']} "
            f"{dev_b['tp']['shape']}")
    bwd_call_us, tp_call_us = (dev_b[k_]["device_us"] for k_ in ("full", "tp"))
    per_kernel = dev_b["full"]["kernels_us"]
    sbo_call_us = dev_b["full"]["sdpa_bwd_device_us"]
    sb_call_us = dev_b["full"]["sdpa_fwd_bwd_device_us"]
    fin = dev_b["full"]["pass_bytes"]
    print(f"[lm_train] flash forward at glm4-9b's training shape (B {b_}, S "
          f"{sq}, H {h}, KV {gk.shape[2]}, dh {dh}, causal, bf16, with its "
          f"log-sum-exp): {row_f['ms']:.5f} ms, device {us_text(f_us)} a "
          f"launch; plain {row_f['plain_ms']:.5f} ms; SDPA forward "
          f"{row_f['library_ms']:.5f} ms (device "
          f"{us_text(sf_call_us)} a call); bound "
          f"{f_ms:.6f} ms by {f_by} ({f_bytes} bytes, {4 * dh * pairs} FLOP); "
          f"max abs err {ferr:.4g}; {n_fwd} launches on {card}")
    print(f"[lm_train] flash backward at that shape: {row_b['ms']:.5f} ms, "
          f"device {us_text(bwd_call_us)} a launch ("
          + "; ".join(f"{re.search(r'flash_bwd_[a-z]+', k_).group(0)} "
                      f"{t_:.2f} us" for k_, t_ in sorted(per_kernel.items()))
          + f"; the last pass's least bytes {fin['finish']}, "
          f"{fin['finish_us']:.2f} us, of which {fin['slices']} float32 "
          f"partials {fin['partials']} and the dQ accumulator "
          f"{fin['dq_accumulator']}); plain "
          f"{row_b['plain_ms']:.5f} ms; SDPA backward "
          f"{row_b['library_ms']:.5f} ms, device "
          f"{us_text(sbo_call_us)} a call alone, "
          f"SDPA forward + backward's "
          f"{us_text(sb_call_us)} a call (device times from "
          f"flash_backward.py); bound "
          f"{b_ms:.6f} ms by {b_by} ({b_bytes} bytes, {10 * dh * pairs} "
          f"FLOP); max abs err {berr:.4g}; {n_bwd} launches on {card}")
    print(f"[lm_train] flash backward at the tensor-parallel local shape "
          f"(H {h // 2}, KV 1, the rest as above): {tp_ms:.5f} ms, device "
          f"{us_text(tp_call_us)} a launch ("
          + (f"{tp_call_us / bwd_call_us:.3f} of the full shape's"
             if tp_call_us and bwd_call_us else "its share not seen")
          + f"); max abs err {tp_err:.4g} on {card}")
    del gq, gk, gv, out, lse, dout, qt, kt, vt, so, seen, sseen, shapes
    del tq, tk, tv, tout, tlse, tdout
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lm_train] phase {time.perf_counter() - t_phase:.1f}s")
    return [row_f, row_b]


# ---------------------------------------------------------------------------
# lm_wide: nemotron-4-340b, whose heads take the flash kernels' 192 template
# ---------------------------------------------------------------------------

WIDE_ARCH = "nemotron-4-340b"
WIDE_LAYERS = 2           # of 96: 60.9 GiB of float32 at init on one card
WIDE_TRAIN = (1, 4096, 96, 8, 192)   # train_4k's attention: B, S, H, KV, dh
# the backward's wide templates at small shapes, in both types
WIDE_SMALL = (((1, 256, 12, 1, 192), {"causal": True, "window": 0}),
              ((1, 100, 4, 2, 256), {"causal": True, "window": 40}),
              ((1, 130, 2, 1, 150), {"causal": False, "window": 0}))


def grouped_plain(torch, q, k, v, kw, dout=None, dtype=None):
    """``attention_ref``'s output or, given ``dout``,
    ``attention_backward_ref``'s (dq, dk, dv), TF32 off, one KV head's
    group of query heads at a time, on the operands cast to ``dtype``
    (float64 for the exact values): the plain version, on a shape whose
    float32 scores take 6.4 GB at once."""
    from repro_torch.kernels.flash_attention import (attention_backward_ref,
                                                     attention_ref)
    g = q.shape[2] // k.shape[2]
    parts = []
    with tf32(False):
        for j in range(k.shape[2]):
            qs, ks, vs = (t_[:, :, i:i + n].to(dtype or t_.dtype) for t_, i, n
                          in ((q, j * g, g), (k, j, 1), (v, j, 1)))
            parts.append(attention_ref(qs, ks, vs, **kw) if dout is None
                         else attention_backward_ref(
                             qs, ks, vs, dout[:, :, j * g:(j + 1) * g]
                             .to(dtype or dout.dtype), **kw))
    if dout is None:
        return torch.cat(parts, 2)
    return tuple(torch.cat(t_, 2) for t_ in zip(*parts))


def held_to_exact(name, got, plain, exact, factor, tol=None, block=256):
    """``got`` (a kernel's, in bf16) against the float64 ``exact``, beside
    the plain version in the same type (``plain``): the max abs error at
    most ``factor`` times the plain version's, over the whole tensor and
    over each ``block`` positions along dim 1 (rows of q, keys of k and
    v, over every head and dh); with ``tol`` each element also within
    ``tol`` x max(1, |exact|). Returns the max abs errors (the kernel's,
    the plain version's) and the largest blockwise ratio of the two."""
    require(got.shape == plain.shape == exact.shape
            and got.dtype == plain.dtype,
            f"{name}: {got.shape}/{got.dtype}, plain {plain.shape}/"
            f"{plain.dtype}, exact {exact.shape}")
    diff = (got.double() - exact).abs()
    pdiff = (plain.double() - exact).abs()
    err, perr = float(diff.max()), float(pdiff.max())
    blocks = [(float(diff[:, i:i + block].max()),
               float(pdiff[:, i:i + block].max()))
              for i in range(0, exact.shape[1], block)]
    ratio = max(e_ / max(p_, 1e-300) for e_, p_ in blocks)
    print(f"[lm_wide] {name}: max abs err from the float64 value {err:.6g} "
          f"(the plain version in bf16 {perr:.6g}); a block of {block} "
          f"positions at most {ratio:.4f} x the plain version's")
    require(math.isfinite(err) and err <= factor * perr,
            f"{name}: {err} from the float64 value, farther than {factor} x "
            f"the plain version in {plain.dtype} ({perr})")
    require(ratio <= factor, f"{name}: a block of {block} positions "
            f"{ratio} x as far from the float64 value as the plain version")
    if tol is not None:
        rel = float((diff / exact.abs().clamp(min=1)).max())
        require(rel <= tol, f"{name}: {rel} from the float64 value (x "
                f"max(1, |exact|)), above {tol}")
    return err, perr, ratio


def phase_lm_wide(torch, card, errs):
    """nemotron-4-340b on the card: heads 192 wide, the flash kernels'
    192 template. The configuration at full width cut to WIDE_LAYERS of
    its 96 layers served as glm4-9b is (``serve_full_width``: 8 x 2
    flash launches, the single-request loop, decode against forward, the
    kernel against its plain versions at a served prefill and, against
    the float64 attention, at a 2,100-token one); the backward's wide
    templates at small shapes in float32 and bf16; then its train_4k
    attention shape (B 1, S 4,096, H 96, KV 8, dh 192, causal, bf16):
    the forward and backward kernels under autograd, one launch each,
    the output, dq, dk and dv held to their float64 values one KV group
    at a time (``held_to_exact``: no farther, over the tensor and each
    256 positions, than EXACT_FWD_FACTOR or EXACT_BWD_FACTOR times the
    plain versions in bf16; each output element within LM_KERNEL_TOL x
    max(1, |exact|)), dq, dk and dv bit for bit again from a direct
    launch, timed beside SDPA. Returns
    rows 7j-7l of the kernels line."""
    import gc

    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_forward)
    from repro_torch.models import layers as L
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # 1. served at full width, its depth cut
    cfg = dataclasses.replace(get_arch(WIDE_ARCH), n_layers=WIDE_LAYERS)
    require(cfg.head_dim == 192 and cfg.d_model == 18432,
            f"{WIDE_ARCH}: dh {cfg.head_dim}, d_model {cfg.d_model}")
    fwd0 = dict(flash_attention.branches)
    row_j = serve_full_width(torch, card, errs, cfg, "lm_wide")
    peak_serve = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    # served: every prefill through the wide wgmma forward (Sq 32, two
    # heads packed a tile)
    took = {b_: flash_attention.branches[b_] - fwd0.get(b_, 0)
            for b_ in ("mma", "wgmma")}
    require(took["mma"] == 0 and took["wgmma"] >= LM_REQUESTS * cfg.n_layers,
            f"lm_wide: the served prefills' forward branches {took}")

    # 2. the backward's wide templates at small shapes, both types: bf16 at
    # dh 192 and 256 on the wgmma branch, float32 and dh 150 on mma.sync
    branches0 = dict(flash_attention_backward.branches)
    small, want = {}, {"mma": 0, "wgmma": 0}
    rng = torch.Generator(device=dev).manual_seed(9)
    for (b_, s_, h_, kv_, dh_), kw in WIDE_SMALL:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=rng, device=dev).to(dtype)
                       for shape in ((b_, s_, h_, dh_), (b_, s_, kv_, dh_),
                                     (b_, s_, kv_, dh_)))
            name = f"{(b_, s_, h_, kv_, dh_)} {kw} {str(dtype)[6:]}"
            flash_grads_close(torch, small, name, q, k, v, kw)
            want["wgmma" if dtype == torch.bfloat16 and dh_ in (192, 256)
                 else "mma"] += 1
    took = {b_: flash_attention_backward.branches[b_] - branches0.get(b_, 0)
            for b_ in ("mma", "wgmma")}
    require(took == want, f"lm_wide: the wide backward's branches {took}, "
            f"expected {want}")
    print("[lm_wide] flash backward at the wide templates within 2e-4 "
          "(float32) / 2e-2 (bf16) x max(1, max |plain|), branches "
          f"{took}: " + "; ".join(f"{k_}: {e:.3g}"
                                  for k_, e in sorted(small.items())))

    # 3. the train_4k attention shape under autograd, from counts at 0
    b_, s_, h_, kv_, dh_ = WIDE_TRAIN
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev)
                     .to(torch.bfloat16) for shape in (
                         (b_, s_, h_, dh_), (b_, s_, kv_, dh_),
                         (b_, s_, kv_, dh_), (b_, s_, h_, dh_)))
    kw = {"causal": True, "window": 0}
    qg, kg, vg = (t_.detach().requires_grad_(True) for t_ in (q, k, v))
    branches0 = dict(flash_attention_backward.branches)
    fwd0 = dict(flash_attention.branches)
    reset_launch_counts()
    out = flash_attention(qg, kg, vg, **kw)
    grads = torch.autograd.grad(out, (qg, kg, vg), dout)
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fwd, n_bwd = counts["flash_attention"], counts["flash_attention_backward"]
    require(n_fwd == 1 and n_bwd == 1 and
            flash_attention.branches["wgmma"] == fwd0.get("wgmma", 0) + 1
            and flash_attention_backward.branches["wgmma"] ==
            branches0.get("wgmma", 0) + 1,
            f"lm_wide: train_4k attention launched the forward {n_fwd} and "
            f"the backward {n_bwd} times (forward branches "
            f"{dict(flash_attention.branches)}, backward "
            f"{dict(flash_attention_backward.branches)})")
    out = out.detach()
    del qg, kg, vg
    with torch.no_grad():
        out_l, lse = flash_attention_forward(q, k, v, **kw)
        again = flash_attention_backward(q, k, v, out_l, dout, lse, **kw)
    require(torch.equal(out_l, out), "lm_wide: the forward with its "
            "log-sum-exp differs from the autograd launch's")
    for gname, a, b in zip(("dq", "dk", "dv"), grads, again):
        require(torch.equal(a, b), f"lm_wide: {gname} of two backward "
                "launches differ")
    # held to the float64 values beside the plain versions in bf16. The
    # gradients are not held element by element: where an element's terms
    # cancel, its bf16 rounding error is set by their size, not by its
    # own, and the plain version's dk and dv exceed 2e-2 x max(1, |exact|)
    # at this shape
    exact = grouped_plain(torch, q, k, v, kw, dtype=torch.float64)
    ferr, fperr, _ = held_to_exact("train_4k forward", out,
                                   grouped_plain(torch, q, k, v, kw), exact,
                                   EXACT_FWD_FACTOR, tol=LM_KERNEL_TOL)
    del exact
    exact = grouped_plain(torch, q, k, v, kw, dout, dtype=torch.float64)
    plain = grouped_plain(torch, q, k, v, kw, dout)
    held = {gname: held_to_exact(f"train_4k {gname}", a, p_, e_,
                                 EXACT_BWD_FACTOR)
            for gname, a, p_, e_ in zip(("dq", "dk", "dv"), grads, plain,
                                        exact)}
    berr = max(h_[0] for h_ in held.values())
    torch.cuda.synchronize()
    del exact, plain
    name_f = f"flash_attention {WIDE_ARCH} train forward"
    name_b = f"flash_attention_backward {WIDE_ARCH} train"
    errs[name_f], errs[name_b] = ferr, berr
    del again

    # rows 7k / 7l: times beside the bound, the plain versions and SDPA
    pairs = b_ * h_ * int(L._mask(s_, s_, True, 0, dev).sum())
    f_bytes = nbytes(q, k, v, out, lse)
    b_bytes = nbytes(q, k, v, out, dout, lse, q, k, v)
    f_ms, f_by = bound(f_bytes, 4 * dh_ * pairs, BF16_OPS_PER_S)
    # S recomputed, dP, dV, dQ, dK: 10 dh flops a kept pair
    b_ms, b_by = bound(b_bytes, 10 * dh_ * pairs, BF16_OPS_PER_S)
    fwd = lambda: flash_attention_forward(q, k, v, **kw)  # noqa: E731
    bwd = lambda: flash_attention_backward(  # noqa: E731
        q, k, v, out, dout, lse, **kw)
    qt, kt, vt = (t_.transpose(1, 2).contiguous().requires_grad_(True)
                  for t_ in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    so = sdpa()
    check_close({}, name_f, so.detach().transpose(1, 2), out, LM_KERNEL_TOL,
                "against SDPA", relative=True)
    dt_ = dout.transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        so, (qt, kt, vt), dt_, retain_graph=True)
    with torch.no_grad():
        row_k = {"name": name_f, "route": "cuda",
                 "source": KERNELS["flash_attention"][0],
                 "replaces": KERNELS["flash_attention"][1],
                 "launches": n_fwd, "max_abs_err": ferr,
                 "ms": time_ms(fwd, iters=10, reps=3, warm=2),
                 "plain_ms": time_ms(lambda: grouped_plain(
                     torch, q, k, v, kw), iters=1, reps=3, warm=1),
                 "bound_ms": f_ms, "bound_by": f_by,
                 "library_ms": time_ms(sdpa, iters=10, reps=3, warm=2)}
    row_l = {"name": name_b, "route": "cuda",
             "source": KERNELS["flash_attention_backward"][0],
             "replaces": KERNELS["flash_attention_backward"][1],
             "launches": n_bwd, "max_abs_err": berr,
             "ms": time_ms(bwd, iters=5, reps=3, warm=2),
             "plain_ms": time_ms(lambda: grouped_plain(
                 torch, q, k, v, kw, dout), iters=1, reps=3, warm=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(sdpa_bwd, iters=10, reps=3, warm=2)}
    del qt, kt, vt, so, dt_, q, k, v, dout, out, out_l, lse, grads
    gc.collect()
    torch.cuda.empty_cache()
    # device times from the bench script in a process of its own (late
    # in this script the profiler's sessions have missed launches)
    bench = subprocess.run(
        [sys.executable, os.path.join(ROOT, "src", "repro_torch", "bench",
                                      "flash_backward.py"),
         "--shapes", "nemotron", "--forward-shapes", "nemotron_prefill"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    require(bench.returncode == 0, f"lm_wide: flash_backward.py exit "
            f"{bench.returncode}\n{bench.stderr[-3000:]}")
    dev_b = json.loads(bench.stdout.strip().splitlines()[-1])
    nem, pre = dev_b["shapes"]["nemotron"], dev_b["forward"]["nemotron_prefill"]
    require(nem["shape"] == [b_, s_, s_, h_, kv_, dh_]
            and pre["shape"][3:] == [h_, kv_, dh_],
            f"lm_wide: the bench's shapes {nem['shape']} {pre['shape']}")
    print(f"[lm_wide] flash_attention at {WIDE_ARCH}'s served prefill "
          f"(row 7j): device {us_text(pre['fwd_device_us'])} a launch in "
          f"flash_backward.py (SDPA forward {us_text(pre['sdpa_fwd_device_us'])}"
          f" a call); max_memory_allocated {peak_serve} bytes in the serving "
          f"run (float32 init and the engine's cast) on {card}")
    print(f"[lm_wide] flash forward at {WIDE_ARCH}'s train_4k attention (B "
          f"{b_}, S {s_}, H {h_}, KV {kv_}, dh {dh_}, causal, bf16, with its "
          f"log-sum-exp): {row_k['ms']:.5f} ms, device "
          f"{us_text(nem['fwd_lse_device_us'])} a launch; plain (a KV group "
          f"at a time) {row_k['plain_ms']:.5f} ms; SDPA forward "
          f"{row_k['library_ms']:.5f} ms, device "
          f"{us_text(nem['sdpa_fwd_device_us'])} a call; bound {f_ms:.6f} ms "
          f"by {f_by} ({f_bytes} bytes, {4 * dh_ * pairs} FLOP); max abs err "
          f"from the float64 attention {ferr:.6g} (attention_ref in bf16 "
          f"{fperr:.6g}, a factor {EXACT_FWD_FACTOR} allowed; each element "
          f"within {LM_KERNEL_TOL} x max(1, |exact|)); {n_fwd} launch on "
          f"{card}")
    print(f"[lm_wide] flash backward there (FlashAttention under autograd, "
          f"the wgmma branch: dK and dV a 64-key block by two warpgroups, "
          f"dQ a pass of its own): "
          f"{row_l['ms']:.5f} ms, device {us_text(nem['device_us'])} a call ("
          + "; ".join(f"{re.search(r'flash_bwd_[a-z_]+?_kernel', k_).group(0)} "
                      f"{t_:.2f} us" for k_, t_ in sorted(
                          nem["kernels_us"].items()))
          + f"); plain (a KV group at a time) {row_l['plain_ms']:.5f} ms; "
          f"SDPA backward {row_l['library_ms']:.5f} ms, device "
          f"{us_text(nem['sdpa_bwd_device_us'])} a call alone, SDPA forward "
          f"+ backward {us_text(nem['sdpa_fwd_bwd_device_us'])}; bound "
          f"{b_ms:.6f} ms by {b_by} ({b_bytes} bytes, {10 * dh_ * pairs} "
          f"FLOP); max abs err from the float64 gradients (the plain "
          f"version's in bf16) "
          + ", ".join(f"{gname} {h_[0]:.6g} ({h_[1]:.6g})"
                      for gname, h_ in held.items())
          + f", a factor {EXACT_BWD_FACTOR} allowed; dq, dk, dv equal over "
          f"two launches; {n_bwd} launch on {card}")
    print(f"[lm_wide] phase {time.perf_counter() - t_phase:.1f}s")
    return [row_j, row_k, row_l]


# ---------------------------------------------------------------------------
# decode_attention: one token over the serving ring cache
# ---------------------------------------------------------------------------

DECODE_SHAPE = (64, 4096, 96, 8, 192)   # B, W, H, KV, dh: decode_heavy's


def served_contexts(rng, n: int):
    """Context lengths of ``n`` slots of the decode_heavy cell's
    conversation mix at a random moment: requests drawn in proportion to
    their output length (the time a slot holds one), each part way
    through its output. Prompts log-normal through median 1,020 and mean
    1,155, clipped at 3,072; outputs through 129 and 211, clipped at
    1,023 (``perfbench/traffic/closed_azure_conv.json``)."""
    import numpy as np

    def lognormal(median, mean, hi, size):
        sigma = math.sqrt(2 * math.log(mean / median))
        return np.clip(rng.lognormal(math.log(median), sigma, size), 1,
                       hi).astype(np.int64)

    prompts = lognormal(1020, 1155, 3072, 8192)
    outs = lognormal(129, 211, 1023, 8192)
    pick = rng.choice(8192, n, p=outs / outs.sum())
    return prompts[pick] + (rng.random(n) * outs[pick]).astype(np.int64) + 1


def phase_decode_attention(torch, card, errs):
    """The decode attention kernel at nemotron-4-340b's served decode
    (``DECODE_SHAPE``, bf16, the conversation mix's contexts, no ring
    wrapped): one launch, the split count of the shapes, held to the
    float64 attention within LM_KERNEL_TOL x max(1, max |exact|) and to
    SDPA over the valid keys (each row's keys padded to the longest
    row, masked: a yardstick the port never calls) within LM_KERNEL_TOL;
    timed beside its plain version and SDPA, its device time a call
    (both kernels) against its byte bound: the K and V of every valid
    slot, q and out. Returns the kernels line's row."""
    import gc

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.bench.profiled import device_time
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref,
                                                      split_count)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    b, w, h, kv, dh = DECODE_SHAPE
    ctx = served_contexts(np.random.default_rng(0), b)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
               for shape in ((b, 1, h, dh), (b, w, kv, dh), (b, w, kv, dh)))
    slots = torch.arange(w, dtype=torch.int32, device=dev)
    ctx_t = torch.as_tensor(ctx, dtype=torch.int32, device=dev)
    cpos = torch.where(slots[None, :] < ctx_t[:, None], slots[None, :],
                       torch.full((), -1, dtype=torch.int32, device=dev))
    pos = ctx_t - 1
    fn = lambda: decode_attention(q, k, v, cpos, pos)  # noqa: E731
    launches = decode_attention.launches
    got = fn()
    torch.cuda.synchronize()
    splits = split_count(b, kv, h // kv, w, torch.bfloat16)
    require(decode_attention.launches == launches + 1
            and decode_attention.splits == splits,
            f"decode_attention: {decode_attention.launches - launches} "
            f"launches, {decode_attention.splits} splits (want 1, {splits})")
    exact = decode_attention_ref(q.double(), k.double(), v.double(), cpos,
                                 pos)
    plain = decode_attention_ref(q, k, v, cpos, pos)
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    scale = max(1.0, float(exact.abs().max()))
    require(math.isfinite(err) and err <= LM_KERNEL_TOL * scale,
            f"decode_attention: {err} from the float64 attention, above "
            f"{LM_KERNEL_TOL} x {scale}")
    errs["decode_attention"] = err
    del exact
    lmax = int(ctx.max())
    kt, vt = (t[:, :lmax].transpose(1, 2).contiguous() for t in (k, v))
    mask = (slots[:lmax][None, :] < ctx_t[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    check_close({}, "decode_attention", sdpa().transpose(1, 2), got,
                LM_KERNEL_TOL, "against the library call")
    n_kv = int(ctx.sum())
    n_bytes = n_kv * kv * dh * 2 * 2 + nbytes(q, got)
    b_ms, b_by = bound(n_bytes, 4 * dh * h * n_kv, BF16_OPS_PER_S)
    ms = time_ms(fn)
    dt = device_time(fn, "decode_attention", 20)
    lib = device_time(sdpa, None, 20)
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, cpos, pos),
                       iters=10, reps=3)
    library_ms = time_ms(sdpa)
    # ms is CUDA events over 200 back-to-back calls: the share by it
    # where the profiler's session missed a launch
    share = (f"{100 * b_ms * 1e3 / dt.call_us:.1f} % of the bound"
             if dt.call_us else
             f"not seen; {100 * b_ms / ms:.1f} % of the bound by CUDA events")
    print(f"[decode_attention] B {b} W {w} H {h} KV {kv} dh {dh} bf16, "
          f"contexts {n_kv} (mean {n_kv / b:.1f}, max {lmax}), {splits} "
          f"splits: {ms:.5f} ms a call, device {us_text(dt.call_us)} a call "
          f"({share}); by kernel "
          + ", ".join(f"{kernel_name(k_)} {us_:.2f} us"
                      for k_, us_ in dt.kernels.items())
          + f"; bound {b_ms:.5f} ms ({b_by}: {n_bytes} B); plain "
          f"{plain_ms:.5f} ms; SDPA over the valid keys {library_ms:.5f} ms, "
          f"device {us_text(lib.call_us)} a call; max abs error from the "
          f"float64 attention {err:.4g} (plain bf16 {plain_err:.4g}) on "
          f"{card}")
    del q, k, v, kt, vt, got, plain
    gc.collect()
    torch.cuda.empty_cache()
    launches, tick = served_decode_tick(torch, ctx)
    src, replaces = KERNELS["decode_attention"]
    row = {"name": "decode_attention", "route": "cuda", "source": src,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "device_us": dt.call_us, "splits": splits, "tick": tick}
    print(f"[decode_attention] phase {time.perf_counter() - t_phase:.1f}s")
    return row


def served_decode_tick(torch, ctx):
    """The main path at decode_heavy's shape: nemotron-4-340b cut to
    WIDE_LAYERS layers, bf16 weights, a DECODE_SHAPE ring whose slots hold
    the contexts ``ctx``, one ``lm.decode_step`` from every launch count
    at 0. Requires one decode_attention launch a layer at the shapes'
    split count. Times the step by CUDA events and its attention by the
    program tracer's ``lm.decode_attention`` spans (their device
    intervals, one a layer); the largest other kernel comes from the
    profiler, "not seen" where its session misses a kernel of the step
    (as it does late in a whole smoke run). Returns (launches, {the
    step's us, the decode attention's us and share, the largest other
    kernel})."""
    import gc

    from repro_torch.bench.profiled import device_time
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      split_count)
    from repro_torch.models import lm
    from repro_torch.obs.trace import program_tracer
    dev = torch.device("cuda")
    b, w, h, kv, dh = DECODE_SHAPE
    cfg = dataclasses.replace(get_arch(WIDE_ARCH), n_layers=WIDE_LAYERS)
    require((cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (h, kv, dh),
            f"{WIDE_ARCH}: heads {cfg.n_heads}, {cfg.n_kv_heads} KV, dh "
            f"{cfg.head_dim}")
    params = lm.cast_weights_(cfg, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))
    cache = lm.init_cache(cfg, b, w, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen,
                                     device=dev))
    slots = torch.arange(w, dtype=torch.int32, device=dev)
    ctx_t = torch.as_tensor(ctx, dtype=torch.int32, device=dev)
    cache["positions"].copy_(torch.where(slots[None, :] < ctx_t[:, None],
                                         slots[None, :], -1))
    toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    step = lambda: lm.decode_step(cfg, params, cache, toks,  # noqa: E731
                                  ctx_t)
    n_steps = 5
    tr = program_tracer()
    with torch.inference_mode():
        reset_launch_counts()
        step()
        torch.cuda.synchronize()
        launches = launch_counts()["decode_attention"]
        splits = decode_attention.splits
        step_us = time_ms(step, iters=n_steps, reps=5, warm=1) * 1e3
        tr.enabled = True
        tr.clear()
        try:
            for _ in range(n_steps):
                step()
            torch.cuda.synchronize()
            spans = [e.args["device_ms"] for e in tr.events()
                     if e.name == "lm.decode_attention"]
        finally:
            tr.enabled = False
            tr.clear()
        dt = device_time(step, None, 5)
    want = split_count(b, kv, h // kv, w, torch.bfloat16)
    require(launches == cfg.n_layers and splits == want,
            f"{WIDE_ARCH} decode step: {launches} decode_attention launches "
            f"at {splits} splits, expected {cfg.n_layers} at {want}")
    require(len(spans) == n_steps * cfg.n_layers
            and all(ms_ is not None for ms_ in spans),
            f"{WIDE_ARCH} decode step: lm.decode_attention device spans "
            f"{spans} in {n_steps} steps of {cfg.n_layers} layers")
    attn_us = sum(spans) * 1e3 / n_steps
    other = max(((us, k_) for k_, us in dt.kernels.items()
                 if "decode_attention" not in k_), default=(None, ""))
    tick = {"step_us": step_us, "attention_us": attn_us,
            "attention_share": attn_us / step_us,
            "top_other_kernel": kernel_name(other[1]) if other[1] else None,
            "top_other_us": other[0]}
    print(f"[decode_attention] {WIDE_ARCH} ({cfg.n_layers} layers, bf16) "
          f"decode step at B {b} W {w}: {launches} decode_attention launches "
          f"({splits} splits), {step_us:.2f} us a step by CUDA events, "
          f"decode attention {attn_us:.2f} us by its spans "
          f"({100 * attn_us / step_us:.1f} %); largest other kernel "
          + (f"{kernel_name(other[1])} {other[0]:.2f} us" if other[1]
             else "not seen (the profiler missed a kernel of the step)"))
    del params, cache, toks, step
    gc.collect()
    torch.cuda.empty_cache()
    return launches, tick


# ---------------------------------------------------------------------------
# dist: the LM stack placed over a device mesh
# ---------------------------------------------------------------------------

DIST_STEPS = 3                # the launcher's steps a run (step 1 warms up)
PR24_STEP_MS = 256.704        # lm_train's median step, PR 24's last run
DIST_TOL = 1e-5               # placed against unplaced at float32
TP_LOCAL = (4, 1024, 16, 1, 128)  # glm4-9b's heads a rank at --model-par 2


def phase_dist(torch, card):
    """The placed paths on the card. (a) World 1 over NCCL (a mesh
    (1, 1) from ``make_host_mesh``): glm4-9b at full width, 4 of 40
    layers, three steps through the launcher (``launch.train.setup``)
    unplaced and with ``--model-par 1``: the losses and gradient norms
    of both, the step ms beside PR 24's, peak memory, the placed run's
    DTensor leaves, its redistributes at constraint sites and the flash
    kernel launched from its placed attention, none of them in the
    unplaced run; (b) a decode step under ``serve_tp_only`` against the
    unplaced one on the same cache (tokens equal), (c) the pipeline at
    one stage against ``lm.forward``, (d) a placed smoke checkpoint
    restored with ``shardings=`` bit for bit, (e) the smoke checks of
    ``repro_torch.dist.checks`` at (1, 1) within DIST_TOL (the decode
    check's placed prefill too). (f) Two ranks
    on the one card over gloo (NCCL refuses a second rank on a card it
    already has): the GPipe check at two stages, forward and gradient,
    within DIST_TOL, with every layer on each rank and with each rank
    holding only its stage's layers (``pipeline_stages``); DTensor's own
    collectives do not run there (see PERF.md). (g) The flash forward with its log-sum-exp and the
    backward at the local shape of glm4-9b at --model-par 2 (H 16, KV 1)
    against their plain versions."""
    import gc
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_arch
    from repro_torch.dist import checks, world
    from repro_torch.dist import shardings as sh
    from repro_torch.dist.pipeline import pipeline_lm_forward
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import (
        attention_ref, flash_attention_backward, flash_attention_forward)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import setup
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh(1)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1
            and tuple(mesh.shape) == (1, 1),
            f"dist: {dist.get_backend()} world {dist.get_world_size()}, "
            f"mesh {tuple(mesh.shape)}")

    def branches(before):
        return {k: v - before.get(k, 0) for k, v in sh.COUNTS.items()
                if v - before.get(k, 0)}

    # (a) the launcher's training step, unplaced and on the mesh (1, 1)
    argv = ["--arch", LM_TRAIN_ARCH, "--layers", str(LM_TRAIN_LAYERS),
            "--batch", str(LM_TRAIN_B), "--seq", str(LM_TRAIN_S),
            "--steps", str(DIST_STEPS), "--log-every", "1"]
    runs = {}
    for label, extra in (("unplaced", []), ("placed", ["--model-par", "1"])):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = setup(argv + extra)
        before = dict(sh.COUNTS)
        reset_launch_counts()
        losses, gnorms, ms = [], [], []
        with sh.use_mesh(run.mesh):
            for _ in range(DIST_STEPS):
                t0 = time.perf_counter()
                last = run.trainer.run(run.stream, 1, log_every=1,
                                       log_fn=lambda *_: None)
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(last["loss"])
                gnorms.append(last["grad_norm"])
        leaves = lm.leaves(run.trainer.state.params)
        runs[label] = {
            "losses": losses, "gnorms": gnorms, "ms": ms,
            "peak": torch.cuda.max_memory_allocated(),
            "flash": launch_counts()["flash_attention"],
            "branches": branches(before),
            "dtensor": sum(isinstance(t, DTensor) for t in leaves),
            "leaves": len(leaves)}
        del run, leaves
    gc.collect()
    torch.cuda.empty_cache()
    up, pl = runs["unplaced"], runs["placed"]
    require(up["dtensor"] == 0 and not up["branches"],
            f"dist: the unplaced run reached a placed branch: {up}")
    require(pl["dtensor"] == pl["leaves"],
            f"dist: {pl['dtensor']} of {pl['leaves']} leaves are DTensors")
    require(pl["branches"].get("constraint", 0) > 0
            and pl["branches"].get("attention", 0) > 0,
            f"dist: placed branches taken {pl['branches']}")
    require(pl["flash"] == up["flash"] == 2 * LM_TRAIN_LAYERS * DIST_STEPS,
            f"dist: flash launches placed {pl['flash']}, unplaced "
            f"{up['flash']}")
    d_loss = max(abs(a - b) for a, b in zip(pl["losses"], up["losses"]))
    d_gn = max(abs(a - b) for a, b in zip(pl["gnorms"], up["gnorms"]))
    require(all(math.isfinite(x) for x in pl["losses"] + pl["gnorms"])
            and d_loss <= LM_PART_TOL * max(1.0, max(up["losses"]))
            and d_gn <= LM_PART_TOL * max(1.0, max(up["gnorms"])),
            f"dist: placed losses {pl['losses']} / gradient norms "
            f"{pl['gnorms']} against {up['losses']} / {up['gnorms']}")
    for label, r in runs.items():
        print(f"[dist] {LM_TRAIN_ARCH} {LM_TRAIN_LAYERS} of 40 layers, B "
              f"{LM_TRAIN_B} x S {LM_TRAIN_S}, launcher "
              f"{'--model-par 1 (mesh (1, 1), NCCL world 1)' if label == 'placed' else 'without a mesh flag'}: "
              f"losses {r['losses']}, gradient norms {r['gnorms']}, ms a "
              f"step {[round(x, 3) for x in r['ms']]} (median of steps "
              f"2-{DIST_STEPS} {statistics.median(r['ms'][1:]):.3f} ms; PR "
              f"24's unplaced median {PR24_STEP_MS} ms), "
              f"max_memory_allocated {r['peak']} bytes, flash launches "
              f"{r['flash']}, DTensor leaves {r['dtensor']} of "
              f"{r['leaves']}, placed branches {r['branches']} on {card}")
    print(f"[dist] placed against unplaced: max |loss difference| {d_loss:.6g}"
          f", max |gradient norm difference| {d_gn:.6g}")

    # (b) decode under serve_tp_only, (c) the pipeline at one stage
    cfg = dataclasses.replace(get_arch(LM_TRAIN_ARCH),
                              n_layers=LM_TRAIN_LAYERS)
    params = lm.cast_weights_(cfg, lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, LM_PROMPT + 1))).to(dev)
    pos = torch.full((4,), LM_PROMPT, dtype=torch.int32, device=dev)
    with torch.no_grad():
        want_h = lm.forward(cfg, params, tokens=toks[:, :LM_PROMPT])[0]
        before = dict(sh.COUNTS)
        with sh.use_mesh(mesh):
            got_h = pipeline_lm_forward(cfg, params, toks[:, :LM_PROMPT],
                                        mesh, n_micro=2)
        pipe = branches(before)
        d_pipe = float((got_h.float() - want_h.float()).abs().max())
        require(pipe.get("pipeline") == 1 and bool(
            ((got_h.float() - want_h.float()).abs()
             <= lm_tol(want_h.float())).all()),
            f"dist: the pipeline at one stage against forward, max abs "
            f"{d_pipe} ({pipe})")
        del want_h, got_h
        _, cache = lm.prefill(cfg, params, toks[:, :LM_PROMPT],
                              max_seq=LM_MAX_SEQ)
        want, _ = lm.decode_step(cfg, params, {k: v.clone() for k, v in
                                               cache.items()},
                                 toks[:, LM_PROMPT:], pos)
        shard = sh.cache_pspec(mesh, cache)
        placed_cache = {k: sh.place(v, shard[k]) for k, v in cache.items()}
        sh.place_params(mesh, params)
        before = dict(sh.COUNTS)
        with checks.opts(serve_tp_only=True), sh.use_mesh(mesh):
            got, _ = lm.decode_step(cfg, params, placed_cache,
                                    toks[:, LM_PROMPT:], pos)
        dec = branches(before)
        got = got.full_tensor()
    d_dec = float((got.float() - want.float()).abs().max())
    require(torch.equal(got.argmax(-1), want.argmax(-1))
            and dec.get("decode_heads", 0) == LM_TRAIN_LAYERS,
            f"dist: placed decode tokens {got.argmax(-1).tolist()} against "
            f"{want.argmax(-1).tolist()}, branches {dec}")
    print(f"[dist] {LM_TRAIN_ARCH} {LM_TRAIN_LAYERS} layers (bf16 weights): "
          f"decode step under serve_tp_only on the placed cache (k "
          f"{shard['k'].spec}): tokens {got.argmax(-1).tolist()} equal the "
          f"unplaced step's, max |logit difference| {d_dec:.6g}, branches "
          f"{dec}; pipeline at one stage (2 microbatches) against forward "
          f"at S {LM_PROMPT}: max abs {d_pipe:.6g}")
    del params, cache, placed_cache, got, want
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a placed checkpoint restored with shardings=, bit for bit
    scfg = get_arch(LM_TRAIN_ARCH, smoke=True)
    sp = lm.init_params(scfg, torch.Generator(device=dev).manual_seed(0))
    want_leaves = [t.detach().clone() for t in lm.leaves(sp)]
    sh.place_params(mesh, sp)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, sp)
        restored = ckpt.restore_latest(d, sp, shardings=sh.params_shardings(
            mesh, sp))
    flat = dict(ckpt._walk(restored))
    got_leaves = [flat[n] for n in lm.leaf_names(sp)]
    require(all(isinstance(t, DTensor) for t in got_leaves) and all(
        torch.equal(t.full_tensor(), w) for t, w in
        zip(got_leaves, want_leaves)),
        "dist: the placed checkpoint did not restore bit for bit")
    print(f"[dist] checkpoint: {scfg.name} placed, saved and restored with "
          f"shardings= onto the mesh: {len(got_leaves)} leaves bit for bit")

    # (e) the smoke checks at (1, 1), float32
    rng = np.random.default_rng(1)
    f32 = dict(compute_dtype="float32")
    glm = dataclasses.replace(scfg, **f32)
    glm4 = dataclasses.replace(scfg, n_layers=4, **f32)
    phi = dataclasses.replace(get_arch("phi4-mini-3.8b", smoke=True), **f32)

    def np_params(c):
        return checks.stacked_numpy(lm.init_params(
            c, torch.Generator().manual_seed(0)))

    pipe_job = ("pipeline", "pipeline", dict(
        cfg=glm4, params_np=np_params(glm4), toks_np=rng.integers(
            0, 512, (4, 32)).astype(np.int32), shape=(1, 2), device="cuda"))
    jobs = [("fsdp", "fsdp", dict(cfg=phi, params_np=np_params(phi),
                                  toks_np=rng.integers(0, 512, (8, 64)).astype(
                                      np.int32), shape=(1, 1),
                                  device="cuda")),
            ("decode", "decode", dict(
                cfg=glm, params_np=np_params(glm), toks_np=rng.integers(
                    0, 512, (4, 33)).astype(np.int32), shape=(1, 1),
                device="cuda", prompt=32, max_seq=40)),
            ("pipeline", "pipeline", dict(pipe_job[2], shape=(1, 1)))]

    def close(label, got, want):
        e = float(np.abs(np.asarray(got, np.float64) - want).max()
                  / max(1.0, float(np.abs(want).max())))
        require(e <= DIST_TOL, f"dist {label}: {e} beyond {DIST_TOL}")
        return e

    with tf32(False):
        res = checks.run_checks(jobs)
    texts = []
    for label, r in res.items():
        require("error" not in r, f"dist {label}:\n{r.get('error')}")
        if label == "fsdp":
            e = max([close(label, a, b) for a, b in
                     zip(r["placed"][2], r["unplaced"][2])]
                    + [close(label, r["placed"][i], r["unplaced"][i])
                       for i in (0, 1)])
        else:
            e = close(label, r["placed"], r["unplaced"])
            for a, b in (list(zip(r.get("grads_placed", []),
                                  r.get("grads_unplaced", [])))
                         + list(zip(r.get("prefill_placed", []),
                                    r.get("prefill_unplaced", [])))):
                e = max(e, close(label, a, b))
        texts.append(f"{label} {e:.3g} {r['counts']}")
    print(f"[dist] smoke checks at (1, 1), float32, placed against "
          f"unplaced (max |diff| / max(1, max |unplaced|)): "
          + "; ".join(texts))

    # (f) two ranks on the one card: gloo, the GPipe check at two stages,
    # with every layer on every rank and with each rank's own stage only
    t0 = time.perf_counter()
    stage_job = ("pipeline_stages", "pipeline_stages", pipe_job[2])
    two = world.run(checks.run_checks, 2, ([pipe_job, stage_job],),
                    backend="gloo", device="cuda", timeout=300)
    e2, e_staged, held = [], [], []
    for rank, res2 in enumerate(two):
        r = res2["pipeline"]
        require("error" not in r, f"dist two ranks:\n{r.get('error')}")
        require(r["counts"].get("pipeline") == 1,
                f"dist two ranks: {r['counts']}")
        e2.append(max([close("pipeline x2", r["placed"], r["unplaced"])]
                      + [close("pipeline x2", a, b) for a, b in zip(
                          r["grads_placed"], r["grads_unplaced"])]))
        r = res2["pipeline_stages"]
        require("error" not in r, f"dist two ranks, staged:\n"
                f"{r.get('error')}")
        e_staged.append(max(
            [close("pipeline stages x2", r["placed"], r["unplaced"])]
            + [close("pipeline stages x2", g, r["grads_unplaced"][n])
               for n, g in r["grads_placed"].items()]))
        held += r["layers_held"]
    require(sorted(held) == [0, 1, 2, 3], f"dist two ranks, staged: "
            f"layers held {held}")
    print(f"[dist] two ranks on one card (gloo; NCCL refuses a second rank "
          f"on a card): GPipe over 2 stages, 2 microbatches, glm4 smoke at "
          f"4 layers, float32: hidden states and every gradient leaf within "
          f"{max(e2):.3g} of the unplaced forward on each rank; with each "
          f"rank holding only its stage's 2 layers (stage_params), hidden "
          f"states and the gradient of every leaf it holds within "
          f"{max(e_staged):.3g} ({time.perf_counter() - t0:.1f}s with the "
          f"ranks' start)")

    # (g) flash at glm4-9b's local shape at --model-par 2
    b_, s_, h_, kv_, dh_ = TP_LOCAL
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((b_, s_, n, dh_), generator=g, device=dev)
               .to(torch.bfloat16) for n in (h_, kv_, kv_))
    kw = {"causal": True, "window": 0}
    local_errs = {}
    out, lse, dout, berr = flash_grads_close(
        torch, local_errs, "flash_attention_backward glm4-9b TP-local",
        q, k, v, kw)
    ferr = float((out.float() - attention_ref(q, k, v, **kw).float())
                 .abs().max())
    require(ferr <= LM_KERNEL_TOL, f"dist: flash at the TP-local shape: "
            f"error {ferr}")
    f_ms = time_ms(lambda: flash_attention_forward(q, k, v, **kw), 50)
    b_ms = time_ms(lambda: flash_attention_backward(q, k, v, out, dout, lse,
                                                    **kw), 20)
    print(f"[dist] flash at glm4-9b's local shape at --model-par 2 (B {b_}, "
          f"S {s_}, H {h_}, KV {kv_}, dh {dh_}, causal, bf16): forward with "
          f"its log-sum-exp within {ferr:.4g} of attention_ref, "
          f"{f_ms:.5f} ms; backward within {berr:.4g} (x max(1, |plain|)) "
          f"of autograd through attention_ref, {b_ms:.5f} ms; on {card}")
    del q, k, v, out, lse, dout
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f}s")


def phase_logic_head(torch, card):
    """The ``logic_head`` example twin on the card, from launch counts at
    0: hymba-1.5b's smoke config (seed 0), then its full width (seed 0,
    the weight matrices cast to bf16 as ``LMEngine`` serves it). Each
    run's prefill attention launches flash_attention once a layer a
    forward of ``logic_head.BATCH`` sequences, its logic network lut_layer
    once a head layer; the head's argmax and the network's are equal on
    the test rows. The smoke run's accuracy, LUTs and FFs are those of
    the reference's own CPU run within the twin's bands
    (``logic_head.within_reference_bands``). After each run, with the
    counts read, both kernels are held against their plain versions at
    the path's shapes: flash on the first forward's recorded q, k, v
    (``check_attention_exact``); and the logic network's output codes on
    the test rows, every code, equal between lut_layer and the plain
    gather."""
    import gc

    from repro_torch.configs import get_arch
    from repro_torch.examples import logic_head as LH
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n_forwards = -(-(LH.N_TRAIN + LH.N_TEST) // LH.BATCH)
    for label, smoke in (("smoke", True), ("full width", False)):
        cfg = get_arch("hymba-1.5b", smoke=smoke)
        params = lm.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0))
        if not smoke:
            lm.cast_weights_(cfg, params)
        reset_launch_counts()
        with record_attention(L) as (seen, calls):
            out = LH.run(cfg, params, log=lambda *_: None)
        counts = launch_counts()
        n_head = len(LH.head_config(cfg.d_model).features)
        require(counts["flash_attention"] == n_forwards * cfg.n_layers
                == calls.get("prefill") and counts["lut_layer"] == n_head,
                f"logic_head {label}: launches {counts}, attention calls "
                f"{calls}")
        require(out["bit_exact"], f"logic_head {label}: the logic network "
                f"parted from the head's argmax")
        q, k, v, kw = seen["prefill"]
        require(q.is_cuda and q.shape == (LH.BATCH, LH.S, cfg.n_heads,
                                          cfg.head_dim)
                and k.shape[2] == cfg.n_kv_heads,
                f"logic_head {label}: recorded attention inputs "
                f"{tuple(q.shape)} {tuple(k.shape)} {q.device}")
        attn = check_attention_exact(q, k, v, kw,
                                     f"logic_head {label} prefill layer 0")
        q_shape, q_dtype = tuple(q.shape), q.dtype
        del q, k, v, seen
        net = out["net"]
        x = torch.from_numpy(
            out["features"][LH.N_TRAIN:LH.N_TRAIN + LH.N_CHECK]).to(dev)
        codes = net.quantize_inputs(x)
        got_codes = net.apply_codes(codes, use_kernel=True)
        want_codes = net.apply_codes(codes, use_kernel=False)
        require(got_codes.shape == (LH.N_CHECK, net.n_outputs)
                and torch.equal(got_codes, want_codes),
                f"logic_head {label}: lut_layer's codes part from the plain "
                f"gather's on {int((got_codes != want_codes).sum())} of "
                f"{want_codes.numel()}")
        if smoke:
            require(LH.within_reference_bands(out),
                    f"logic_head smoke: accuracy {out['test_acc']}, "
                    f"{out['luts']} LUTs, {out['ffs']} FFs against the "
                    f"reference's {LH.REFERENCE_RUN} (bands "
                    f"{LH.ACC_BAND}, {LH.LUT_BAND})")
        print(f"[logic_head] {cfg.name} ({label}): features "
              f"{out['features_per_s']:.1f} sequences/s ({LH.N_TRAIN + LH.N_TEST}"
              f" x {LH.S} tokens in {out['features_s']:.3f} s, flash "
              f"launches {counts['flash_attention']}; flash at q {q_shape} "
              f"{q_dtype}: max abs err {attn['flash']:.4g} against "
              f"attention_ref in float64, attention_ref's own in bf16 "
              f"{attn['attention_ref']:.4g}, full_attention's "
              f"{attn['full_attention']:.4g}); head test accuracy "
              f"{out['test_acc']:.4f} (float {out['float_test_acc']:.4f}"
              + (f"; the reference's CPU run {LH.REFERENCE_RUN['test_acc']}"
                 if smoke else "") + f"), bit-exact on {LH.N_CHECK} rows "
              f"(lut_layer launches {counts['lut_layer']}; its codes equal "
              f"the plain gather's, all {got_codes.numel()}), {out['luts']} "
              f"LUTs" + (f" (reference {LH.REFERENCE_RUN['luts']})"
                         if smoke else "") + f", {out['ffs']} FFs, fmax "
              f"{out['fmax_mhz']:.0f} MHz, {out['latency_ns']:.1f} ns on "
              f"{card}")
        del params, out, net, x, codes, got_codes, want_codes
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[logic_head] phase {time.perf_counter() - t_phase:.1f}s")


# (arch, shape, mesh, --opts): mixtral-8x22b under the rule table (the
# reference's default) and under moe_ep, asked for
DRYRUN_CELLS = (("glm4-9b", "train_4k", "single", ""),
                ("mixtral-8x22b", "decode_32k", "single", ""),
                ("mixtral-8x22b", "decode_32k", "single", "moe_ep"),
                ("seamless-m4t-large-v2", "prefill_32k", "single", ""),
                ("glm4-9b", "decode_32k", "multi", ""))
DRYRUN_TIMEOUT_S = 420


def dryrun_tag(arch: str, shape: str, mesh: str, opts: str) -> str:
    return "_".join([arch, shape, mesh] + ([opts.replace(",", "+")]
                                          if opts else []))


def phase_dryrun(card):
    """The dry run under this machine's torch, on fake tensors with no
    device (the card hidden from the processes): the DRYRUN_CELLS through
    ``python -m repro_torch.launch.dryrun`` and the pipeline twin
    (``repro_torch.examples.pipeline_dryrun``), each a process of its
    own, all at once. Each cell must end ``ok`` with FLOPs per device
    above 0, its argument bytes equal to the rule table's local shards
    and its record's ``opts`` the options it was given (mixtral-8x22b
    runs under the rule table and under ``moe_ep``); the pipeline's argument bytes must be one stage's slab of
    3 layers, the embedding, norm and head, and the tokens, its bubble
    15/79 and its ring shift a collective-permute each schedule step.
    Prints each cell's roofline row (H100 rates) and seconds."""
    import tempfile

    from repro_torch.bench import roofline
    t_phase = time.perf_counter()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as out_dir:
        cmds = {dryrun_tag(*cell): [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
            "--shape", s, "--mesh", m, "--out",
            os.path.join(out_dir, dryrun_tag(*cell)), "--force", "--opts", o]
            for cell in DRYRUN_CELLS for a, s, m, o in [cell]}
        cmds["pipeline"] = [sys.executable, "-c",
                            "import json; from repro_torch.examples import "
                            "pipeline_dryrun as p; print(json.dumps(p.run()))"]
        logs = {k: open(os.path.join(out_dir, k + ".log"), "w+")
                for k in cmds}
        procs = {k: (subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                      stdout=logs[k],
                                      stderr=subprocess.STDOUT),
                     time.perf_counter()) for k, c in cmds.items()}
        done = {}
        try:
            while len(done) < len(procs):
                require(time.perf_counter() - t_phase < DRYRUN_TIMEOUT_S,
                        f"dryrun: {sorted(set(procs) - set(done))} still "
                        f"running after {DRYRUN_TIMEOUT_S} s")
                for k, (p, t0) in procs.items():
                    if k not in done and p.poll() is not None:
                        logs[k].seek(0)
                        done[k] = (p.returncode, logs[k].read(),
                                   time.perf_counter() - t0)
                time.sleep(0.2)
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs.values():
                f.close()
        for k, (rc, log, _) in done.items():
            require(rc == 0, f"dryrun {k}: exit {rc}\n{log[-5000:]}")
        for a, s, m, o in DRYRUN_CELLS:
            tag = dryrun_tag(a, s, m, o)
            with open(os.path.join(out_dir, tag, f"{a}_{s}_{m}.json")) as f:
                rec = json.load(f)
            require(rec["status"] == "ok" and rec["flops_per_device"] > 0
                    and rec["argument_size_in_bytes"]
                    == rec["rule_table_argument_bytes"]
                    and sorted(rec["opts"]) == sorted(filter(None,
                                                             o.split(","))),
                    f"dryrun {tag}: {json.dumps(rec)[:2000]}")
            row = roofline.roofline_row(rec)
            print(f"[dryrun] {tag} (torch {rec['torch']}, "
                  f"{rec['n_devices']} fake ranks, opts {rec['opts']}): "
                  f"flops/device {rec['flops_per_device']:.6e}, collectives "
                  f"{rec['collectives']['total_bytes']:.6e} B "
                  f"{rec['collectives']['counts']}, args "
                  f"{rec['argument_size_in_bytes']} B (rule table "
                  f"{rec['rule_table_argument_bytes']}), temps "
                  f"{rec['temp_size_in_bytes']} B; roofline at H100 rates: "
                  f"compute {row['t_compute_s']:.6g} s, memory "
                  f"{row['t_memory_s']:.6g} s (raw {row['t_memory_raw_s']:.6g}"
                  f"), collective {row['t_collective_s']:.6g} s, dominant "
                  f"{row['dominant']}, roofline "
                  f"{100 * row['roofline_fraction']:.2f}%; build "
                  f"{rec['build_s']} s, step {rec['step_s']} s, process "
                  f"{done[tag][2]:.1f} s")
    pipe = json.loads(done["pipeline"][1].strip().splitlines()[-1])
    steps = pipe["n_micro"] + pipe["n_stages"] - 1
    coll = pipe["collectives"]
    require(pipe["layers_a_stage"] == 3 and pipe["n_stages"] == 16
            and pipe["argument_size_in_bytes"] == pipe["slab_bytes"]
            + pipe["other_bytes"] + pipe["tokens_bytes"]
            and pipe["bubble"] == 15 / 79
            and coll["counts"]["collective-permute"] == steps
            and pipe["flops_per_device"] > 0,
            f"dryrun pipeline: {pipe}")
    gib = 2 ** 30
    print(f"[dryrun] pipeline twin (chameleon-34b, 16 stages x 3 layers, "
          f"{pipe['n_micro']} microbatches): flops/device "
          f"{pipe['flops_per_device']:.6e}, args "
          f"{pipe['argument_size_in_bytes'] / gib:.4f} GiB/dev (slab "
          f"{pipe['slab_bytes'] / gib:.4f}), temps "
          f"{pipe['temp_size_in_bytes'] / gib:.4f} GiB/dev, "
          f"collective-permute {coll['bytes']['collective-permute']:.6e} B "
          f"in {coll['counts']['collective-permute']}, bubble "
          f"{pipe['bubble']:.4f}; process {done['pipeline'][2]:.1f} s")
    print(f"[dryrun] phase {time.perf_counter() - t_phase:.1f}s (the "
          f"processes at once, on the host's cores; no device, {card} "
          f"hidden)")


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
    if sys.argv[1:] == ["--decode-attention"]:
        card = phase_card(torch)
        phase_build()
        print(json.dumps({"kernels": [phase_decode_attention(torch, card,
                                                             {})]}))
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
    rows.append(phase_lm(torch, card, errs))
    rows += phase_lm_moe_encdec(torch, card, errs)
    rows += phase_lm_train(torch, card, errs)
    rows += phase_lm_wide(torch, card, errs)
    rows.append(phase_decode_attention(torch, card, errs))
    phase_dist(torch, card)
    phase_logic_head(torch, card)
    phase_dryrun(card)
    require(len(rows) == len(KERNELS) + 9, f"{len(rows)} kernel rows")
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
