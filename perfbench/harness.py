"""What every cell shares: finding a cell's files by name, the run's
context, the traced slice and its reduction, and the result line.

A traced slice is read from the profiler's raw events
(``kineto_results.events()``), not from ``key_averages``: device
operations with their times, and each one's launch tied to the span of
the harness it was issued under (``perfbench:<span>[:key=value...]``,
``record_function`` ranges around calls into the port), through the
host operation or annotation it is linked to.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPAN_PREFIX = "perfbench:"
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# Finding a cell's files by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as fh:
        return json.load(fh)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: Dict, name: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(spec: Dict, name: str, root: Path = ROOT) -> Dict:
    return load_json(root / config_entry(spec, name)["file"])


def load_traffic(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_limits(cell: str) -> Dict:
    return load_json(HERE / "limits" / f"{cell}.json")["limits"]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    """``perfbench/kinds/<kind>.py``: the driver of a mix's kind."""
    return importlib.import_module(f"perfbench.kinds.{kind}")


def base_name(name: str) -> str:
    """A metric split by cell (``request_p95_ms.prefill``) reads the
    quantity of its name before the first dot."""
    return name.split(".")[0]


def metric_reader(name: str) -> Callable:
    """The reader ``metrics/<name>.py``, else that of its base name."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{base_name(name)}.py"
    return load_module(path, "perfbench_metric_" + name.replace(".", "_")).read


def cell_metrics(spec: Dict, cell: str, section: str) -> List[Dict]:
    """The metrics of ``section`` (``end_to_end`` / ``per_layer``) that
    the cell reports: those naming it under ``workloads``, and those with
    no ``workloads`` key."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """One run of one cell. ``t0`` is the process's start (perf_counter);
    a kind calls ``window_opens()`` when the measured window starts,
    which fixes ``setup_s``."""
    cell: str
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    setup_s: Optional[float] = None
    device_kind: str = ""
    last_phase: Optional[float] = None

    def window_opens(self) -> float:
        now = time.perf_counter()
        self.setup_s = now - self.t0
        return now

    def phase(self, name: str) -> None:
        """Log the seconds since the last phase (set-up's split)."""
        now = time.perf_counter()
        self.log(f"set-up: {name} {now - (self.last_phase or self.t0):.3f} s")
        self.last_phase = now

    def log(self, msg: str) -> None:
        print(f"[perfbench {self.cell}] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a kind hands back: the end-to-end values by metric name,
    the checks, counts, and, traced, the slice."""
    values: Dict[str, float]
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    slice: Optional["Slice"] = None
    picked: List = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        from perfbench import checks
        return checks.correct(self.checks)


# ---------------------------------------------------------------------------
# The traced slice
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    span: Optional[str]       # the harness span its launch was issued in

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Span:
    kind: str                 # e.g. "prefill", "decode", "train_step"
    attrs: Dict[str, float]
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Slice:
    """A traced stretch of the window: its length by the host's clock,
    the device operations run in it, the harness spans, the port's launch
    counters' growth over it, and the cell's configuration and mix. The
    shares and rates read ``window_s``, its length by the trace itself."""
    wall_s: float
    ops: List[DeviceOp]
    spans: List[Span]
    counts: Dict[str, int]
    arch: Dict
    traffic: Dict
    gaps: List[List]          # [[label, seconds]] longest idle gaps
    device_kind: str = ""

    @property
    def busy_s(self) -> float:
        return union_seconds([(o.start_ns, o.end_ns) for o in self.ops])

    @property
    def window_s(self) -> float:
        """From the first device operation's start to the last one's end,
        on the trace's own clock."""
        if not self.ops:
            return 0.0
        return (max(o.end_ns for o in self.ops)
                - min(o.start_ns for o in self.ops)) * 1e-9

    def spans_of(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    def ops_under(self, kind: str) -> List[DeviceOp]:
        return [o for o in self.ops if o.span == kind]


def union_seconds(intervals) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def parse_span(name: str):
    """``perfbench:decode:active=64:ctx=70123`` -> ("decode", {...})."""
    parts = name[len(SPAN_PREFIX):].split(":")
    attrs = {}
    for p in parts[1:]:
        key, _, value = p.partition("=")
        attrs[key] = float(value)
    return parts[0], attrs


def span_name(kind: str, **attrs) -> str:
    return SPAN_PREFIX + ":".join([kind] + [f"{k}={v}" for k, v in
                                            attrs.items()])


def read_profile(prof, wall_s: float, counts: Dict[str, int], arch: Dict,
                 traffic: Dict, device_kind: str = "") -> Slice:
    """The slice from a stopped ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    for e in events:
        (dev if e.device_type() == cuda else host).append(e)
    spans = []
    for e in host:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            kind, attrs = parse_span(name)
            start = e.start_ns()
            spans.append(Span(kind, attrs, start, start + e.duration_ns()))
    spans.sort(key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]

    def span_at(t: int) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i].kind if i >= 0 and t <= spans[i].end_ns else None

    # a device op's launch: the host event it is linked to (an operator
    # or annotation), else the runtime call with its correlation id
    host_start, runtime_start = {}, {}
    for e in host:
        runtime = e.name().startswith(("cuda", "cu"))
        (runtime_start if runtime else host_start)[e.correlation_id()] = \
            e.start_ns()
    ops = []
    for e in dev:
        name = e.name()
        if name.startswith(SPAN_PREFIX):      # the GPU side of an annotation
            continue
        start = e.start_ns()
        launched = host_start.get(e.linked_correlation_id())
        if launched is None:
            launched = runtime_start.get(e.correlation_id())
        ops.append(DeviceOp(name, start, start + e.duration_ns(),
                            span_at(launched) if launched is not None
                            else None))
    ops.sort(key=lambda o: o.start_ns)
    return Slice(wall_s, ops, spans, counts, arch, traffic,
                 idle_gaps(ops, host, spans), device_kind)


def idle_gaps(ops: List[DeviceOp], host, spans: List[Span], n: int = 10):
    """The ``n`` longest stretches with no device operation, each named
    by what the host was doing: the harness span it fell in and the
    first host operator that started in it."""
    busy = []
    for o in ops:
        if busy and o.start_ns <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], o.end_ns)
        else:
            busy.append([o.start_ns, o.end_ns])
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:n]
    starts = sorted((e.start_ns(), e.name()) for e in host
                    if not e.name().startswith(SPAN_PREFIX))
    keys = [s for s, _ in starts]
    out = []
    for length, g0, g1 in gaps:
        inside = [s.kind for s in spans if s.start_ns <= g0 <= s.end_ns]
        i = bisect.bisect_left(keys, g0)
        op = starts[i][1] if i < len(starts) and starts[i][0] < g1 else "none"
        label = f"{inside[-1] if inside else 'outside spans'} / {op}"
        out.append([label, length * 1e-9])
    return out


def profiler(device):
    """A profiler of the host and, on the card, the device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def load_kernels(r: "Run") -> None:
    """Load the port's kernel library (built by the first run in a
    checkout) before anything else, so set-up's split shows it."""
    r.phase("imports and the card")
    if r.device.type == "cuda":
        from repro_torch.kernels import build
        build.library()
    r.phase("kernel library")


def warm_profiler(device) -> None:
    """Start and stop the profiler once in set-up: its first start takes
    about a second, which would otherwise fall inside the window."""
    import torch
    with profiler(device):
        (torch.ones(8, device=device) + 1).sum().item()


def top_device_ops(ops: List[DeviceOp], n: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for o in ops:
        by[o.name] = by.get(o.name, 0.0) + o.seconds
    return [[k[:200], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ---------------------------------------------------------------------------
# Checks shared by the kinds
# ---------------------------------------------------------------------------

def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is
    JAX's, flax's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_TOP})


def device_description(device) -> Dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
