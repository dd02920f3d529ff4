"""``engine_prefill_share`` (%): the share of the traced slice's device
time spent in kernels launched under ``lm.prefill``, the engine's
admissions."""


def read(s):
    under = sum(o.seconds for o in s.ops_under("prefill"))
    total = sum(o.seconds for o in s.ops)
    if not s.spans_of("prefill") or under <= 0 or total <= 0:
        return None
    return 100.0 * under / total
