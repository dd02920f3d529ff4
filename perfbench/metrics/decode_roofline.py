"""``decode_roofline`` (%): the decode steps of the traced slice: their
least time (``work.decode_bytes`` at the HBM peak: bf16 weights read,
the cache at the active slots' lengths, new K / V and the logits
written; or their operations at the bf16 peak, if longer) over the
device time of the kernels launched under ``lm.decode_step``."""
from perfbench import work


def read(s):
    dec = s.spans_of("decode")
    device = sum(o.seconds for o in s.ops_under("decode"))
    if not dec or device <= 0:
        return None
    bound = sum(work.bound_s(
        work.decode_flops(s.arch, int(d.attrs["active"]), int(d.attrs["ctx"])),
        work.decode_bytes(s.arch, int(d.attrs["active"]), int(d.attrs["ctx"]),
                          int(d.attrs["slots"])), s.device_kind) for d in dec)
    return 100.0 * bound / device
