"""``first_token_p50_ms`` (ms): the median time from enqueue to first
token over the admissions of the traced slice, from the engine's
``engine.first_token`` instants (``first_token_us``, on the engine's
clock)."""
import statistics

from perfbench import program


def read(s, evs=None):
    waits = program.args_of(program.in_slice(s, evs), "engine.first_token",
                            "first_token_us")
    return statistics.median(waits) * 1e-3 if waits else None
