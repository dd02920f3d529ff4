"""repro_torch.obs — observability for the port.

Only the disabled tracer is ported so far: the scheduler and the
bitplane path carry instrumentation points that call it. The span
tracer, exporters and metrics registry of ``repro.obs`` are still to
port.
"""
from .trace import NULL_TRACER, NullTracer  # noqa: F401
