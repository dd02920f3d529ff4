"""``flash_roofline.prefill`` (%): the flash attention launches of the
prefills in the traced slice (one a layer a prompt, B 1, causal, no
log-sum-exp): their least time at each prompt's length, from ``work``,
over the device time of the ``flash`` kernels launched under
``lm.prefill``."""
from perfbench import work


def read(s):
    pre = s.spans_of("prefill")
    device = sum(o.seconds for o in s.ops_under("prefill")
                 if "flash" in o.name)
    if not pre or device <= 0:
        return None
    k = work.dims(s.arch)
    bound = sum(k["L"] * work.bound_s(*work.flash_forward_work(
        1, int(p.attrs["S"]), int(p.attrs["S"]), k["h"], k["kv"], k["dh"],
        False), s.device_kind) for p in pre)
    return 100.0 * bound / device
