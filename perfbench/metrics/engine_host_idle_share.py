"""``engine_host_idle_share`` (%): the device's idle time in the traced
slice (the gaps between the union of its device operations) that falls
outside every ``engine.decode`` and ``engine.prefill`` host interval,
over the slice's time (``window_s``): the device waiting on the
engine's own host work (admission, the argmax's sync, retiring slots),
not on the model's launches. That host work includes the closed loop's
client hook, which runs inside the engine's clock reads (submitting
requests, starting and stopping the profiler): the reading follows the
host's speed."""
import bisect

from perfbench import program


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(s, evs=None):
    evs = program.in_slice(s, evs)
    model = merged(program.bounds_us(e) for e in evs
                   if e.name in ("engine.decode", "engine.prefill"))
    if not model or not s.ops or s.window_s <= 0:
        return None
    busy = merged((program.us(o.start_ns), program.us(o.end_ns))
                  for o in s.ops)
    ends = [b for _, b in model]
    idle = 0.0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        idle += g1 - g0
        i = bisect.bisect_right(ends, g0)      # first interval ending past g0
        while i < len(model) and model[i][0] < g1:
            idle -= min(model[i][1], g1) - max(model[i][0], g0)
            i += 1
    return 100.0 * idle * 1e-6 / s.window_s
