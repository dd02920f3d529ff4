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

  # micro-batch scheduler with 2 replicas and two SLO lanes, traced;
  # then the trace's per-request phase breakdown
  PYTHONPATH=src python -m repro_torch.launch.serve --mode logic \\
      --sched --replicas 2 --slo-us 2000,20000 --trace /tmp/t.json
  PYTHONPATH=src python -m repro_torch.obs.analyze --trace /tmp/t.json

  # the loadgen harness (open + closed loop, SLO lanes) behind a live
  # metrics endpoint
  PYTHONPATH=src python -m repro_torch.launch.serve --mode logic \\
      --backend bitplane --engine cuda-streamed --sched --replicas 2 \\
      --loadgen both --slo-us 2000,20000 --trace /tmp/t.json \\
      --metrics-port 0

As the reference launcher does, the model is first trained with QAT +
FCP (``train_jsc``, ``--train-steps``, default 400, from a
``torch.Generator`` seeded with ``--seed``; ``--train-steps 0`` gives
the seeded init projected to its fanin budget), on the same device as
the serving; or it is loaded from weights saved with
``repro_torch.weights.save_params_npz`` (``--params``). It is compiled
to truth tables on the host, synthesized to a mapped netlist for
``--backend bitplane``, and serves ``--requests`` requests of 64 rows
of the JSC test split through ``LogicEngine.serve_queue``, or, with
``--sched``, ``--requests`` x 64 one-row requests through the
micro-batch scheduler (``--replicas`` engines behind ``least_loaded``
dispatch, ``least_slack`` when ``--slo-us`` gives lane budgets). With
``--loadgen`` it runs ``repro_torch.bench.loadgen.run`` on the backend
instead (which trains its own JSC-S for ``--train-steps``, as the
reference's does). ``--trace PATH`` writes a Chrome trace of the
request lifecycle; ``--metrics-port`` serves the metrics registry on
127.0.0.1 for the run (``/metrics``, ``/metrics.json``). The launcher
prints the test accuracy after training, the mapped LUT count and
depth, the served accuracy, p50/p95 latency and each kernel's launches
during serving.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.serving.engine import BACKENDS

ROWS_PER_REQUEST = 64


def serve_logic(jsc_name: str = "jsc-s", n_requests: int = 8,
                backend: str = "gather", engine: Optional[str] = None,
                params: Optional[str] = None, train_steps: int = 400,
                seed: int = 0, device=None, sched: bool = False,
                replicas: int = 1, qps: Optional[float] = None,
                loadgen: Optional[str] = None,
                slo_us: Optional[Sequence[float]] = None,
                trace: Optional[str] = None,
                metrics_port: Optional[int] = None) -> dict:
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

    # pull-based metrics endpoint (Prometheus text exposition on
    # /metrics, raw snapshot on /metrics.json), alive for the duration
    # of the serving run; daemon thread, so an exception path cannot
    # wedge process exit
    mserver = None
    registry = None
    if metrics_port is not None:
        from repro_torch.obs import MetricsRegistry, MetricsServer
        registry = MetricsRegistry()
        mserver = MetricsServer(registry, port=metrics_port)
        print(f"[serve] metrics endpoint: {mserver.url}")
    try:
        if loadgen:                     # full benchmark harness
            return _serve_loadgen(backend, engine, n_requests, qps, loadgen,
                                  replicas, train_steps, slo_us, trace,
                                  registry, dev)
        tracer = None
        if trace:
            from repro_torch.obs import SpanTracer
            tracer = SpanTracer()
        before = launch_counts()
        if sched:                       # scheduler + replica dispatch
            stats = _serve_sched(eng, net, cfg, backend, engine, n_requests,
                                 replicas, slo_us, tracer, trace, registry,
                                 xte, yte, dev)
        else:
            reqs = [xte[i * ROWS_PER_REQUEST: (i + 1) * ROWS_PER_REQUEST]
                    for i in range(n_requests)]
            results, stats = eng.serve_queue(reqs, tracer=tracer)
            if tracer is not None:
                from repro_torch.obs import write_chrome_trace
                write_chrome_trace(trace, tracer)
                print(f"[serve] trace: {tracer.n_recorded} events -> "
                      f"{trace}")
            acc = float(np.mean(np.concatenate(results)
                                == yte[: sum(len(r) for r in reqs)]))
            print(f"[serve] {n_requests} requests: acc={acc:.4f} "
                  f"p50={stats['p50_us']:.1f}us "
                  f"p95={stats['p95_us']:.1f}us")
            stats = {**stats, "acc": acc}
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        print("[serve] kernel launches: " + ", ".join(
            f"{k}={v}" for k, v in launches.items()))
        return {**stats, **out, "launches": launches}
    finally:
        if mserver is not None:
            mserver.close()


def _serve_loadgen(backend, engine, n_requests, qps, loadgen, replicas,
                   train_steps, slo_us, trace, registry, dev) -> dict:
    """``--loadgen``: the loadgen harness on this one backend."""
    from repro_torch.bench import loadgen as lg

    out = lg.run(fast=True, backends=(backend,), n_requests=n_requests,
                 qps=qps, loadgen=loadgen, n_replicas=replicas,
                 steps=train_steps, engine=engine, slo_us=slo_us,
                 trace=trace, registry=registry, device=dev)
    rec = out["backends"][backend]
    mode = "open_loop" if "open_loop" in rec else "closed_loop"
    print(f"[serve] {mode}: {rec[mode]['qps']:.0f} qps "
          f"p95={rec[mode]['p95_us']:.1f}us "
          f"occ={rec[mode]['mean_batch_occupancy']:.2f}")
    if "slo_lanes" in rec:
        for lane, lr in rec["slo_lanes"]["lanes"].items():
            print(f"[serve] slo lane {lane} "
                  f"({rec['slo_lanes']['slo_us'][int(lane)]:.0f}us): "
                  f"attainment={lr['slo_attainment']:.3f} "
                  f"miss_rate={lr['deadline_miss_rate']:.3f} "
                  f"shed={lr['shed']} p99={lr['p99_us']:.0f}us")
    return rec


def _serve_sched(eng, net, cfg, backend, engine, n_requests, replicas,
                 slo_us, tracer, trace, registry, xte, yte, dev) -> dict:
    """``--sched``: one-row requests through the micro-batch scheduler,
    over ``replicas`` engines when more than one."""
    from repro_torch.serve import (MicroBatchScheduler, RequestRejected,
                                   SchedConfig, build_logic_replicas)
    executor = eng.scheduler_executor()
    if replicas > 1:                    # independent data-parallel engines
        executor = build_logic_replicas(
            net, cfg.n_classes, n_replicas=replicas, backend=backend,
            max_batch=eng.max_batch,
            policy="least_slack" if slo_us else "least_loaded",
            engine=engine, device=dev)
    n = n_requests * ROWS_PER_REQUEST
    s = MicroBatchScheduler(
        executor, SchedConfig(max_batch=eng.max_batch,
                              max_queue=4 * n,
                              n_priorities=max(2, len(slo_us or ())),
                              lane_slo_us=slo_us),
        tracer=tracer)
    if registry is not None:            # live pull endpoint content
        from repro_torch.obs import WindowedMetrics
        s.metrics.publish(registry, "serve")
        if hasattr(executor, "publish"):
            executor.publish(registry)
        wm = WindowedMetrics()
        s.metrics.add_sink(wm)
        wm.publish(registry, "windows")
    s.start()
    futs = [s.submit(xte[i % xte.shape[0]]) for i in range(n)]
    s.stop(drain=True)
    got = np.full((len(futs),), -1, np.int32)
    for i, f in enumerate(futs):
        try:
            got[i] = int(f.result(timeout=30))
        except RequestRejected:
            pass                        # shed past its lane SLO
    served = got >= 0
    acc = float(np.mean(
        got[served] == yte[np.arange(len(got)) % yte.shape[0]][served]
    )) if served.any() else 0.0
    snap = s.metrics.snapshot()
    if tracer is not None:
        _export_trace(trace, tracer, s, executor)
    print(f"[serve] sched x{replicas}: {len(futs)} requests "
          f"acc={acc:.4f} p50={snap['p50_us']:.1f}us "
          f"p95={snap['p95_us']:.1f}us qps={snap['qps']:.0f} "
          f"occ={snap['mean_batch_occupancy']:.2f} "
          f"shed={snap['shed']} "
          f"miss_rate={snap['deadline_miss_rate']:.3f}")
    return {**snap, "acc": acc}


def _export_trace(path: str, tracer, sched, executor) -> None:
    """Write the Chrome trace with a full metrics-registry snapshot as
    ``otherData`` (scheduler metrics + replica/aggregator stats)."""
    from repro_torch.obs import MetricsRegistry, write_chrome_trace

    reg = MetricsRegistry()
    sched.metrics.publish(reg, "serve")
    if hasattr(executor, "publish"):
        executor.publish(reg)
    write_chrome_trace(path, tracer, other_data=reg.snapshot())
    print(f"[serve] trace: {tracer.n_recorded} events "
          f"({tracer.n_dropped} dropped) -> {path}")


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
    ap.add_argument("--sched", action="store_true",
                    help="serve through the repro_torch.serve micro-batch "
                         "scheduler instead of the blocking loop")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind the "
                         "scheduler (least-loaded dispatch)")
    ap.add_argument("--qps", type=float, default=None,
                    help="offered open-loop arrival rate for --loadgen")
    ap.add_argument("--loadgen", choices=["open", "closed", "both"],
                    default=None,
                    help="drive the scheduler with the "
                         "repro_torch.bench.loadgen harness and report "
                         "p50/p95/p99+QPS")
    ap.add_argument("--slo-us", default=None,
                    help="comma list of per-lane SLO deadline budgets in "
                         "µs (lane 0 first, e.g. '100,1000'); requests "
                         "past their lane budget are shed with a typed "
                         "DEADLINE_EXCEEDED reject")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the request lifecycle with "
                         "repro_torch.obs and write a Chrome trace-event "
                         "JSON (open in ui.perfetto.dev) with the "
                         "metrics-registry snapshot embedded as otherData")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve a pull-based metrics endpoint on this "
                         "port of 127.0.0.1 for the duration of the run: "
                         "Prometheus text exposition on /metrics, raw "
                         "registry snapshot on /metrics.json (0 = "
                         "ephemeral port, printed at startup)")
    args = ap.parse_args(argv)
    slo_us = (tuple(float(v) for v in args.slo_us.split(","))
              if args.slo_us else None)
    return serve_logic(args.jsc, args.requests, backend=args.backend,
                       engine=args.engine, params=args.params,
                       train_steps=args.train_steps, seed=args.seed,
                       device=args.device, sched=args.sched,
                       replicas=args.replicas, qps=args.qps,
                       loadgen=args.loadgen, slo_us=slo_us,
                       trace=args.trace, metrics_port=args.metrics_port)


if __name__ == "__main__":
    main()
