"""``admission_wait_mean_ms`` (ms): the mean time a request waited from
enqueue to its admission into a slot, over the admissions of the traced
slice, from the engine's ``engine.first_token`` instants
(``queue_wait_us``, on the engine's clock)."""
import statistics

from perfbench import program


def read(s, evs=None):
    waits = program.args_of(program.in_slice(s, evs), "engine.first_token",
                            "queue_wait_us")
    return statistics.fmean(waits) * 1e-3 if waits else None
