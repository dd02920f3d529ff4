"""``flash_roofline.train`` (%): the flash attention launches of the
traced training steps, forward (with its log-sum-exp) and backward, at
the cell's shape: their least time (operations at the bf16 peak or
bytes at the HBM peak, launch by launch, from ``work``) over the device
time of every kernel whose name holds ``flash``. Launches are the port's
own counters' growth over the slice."""
from perfbench import work


def read(s):
    n_fwd = s.counts.get("flash_attention", 0)
    n_bwd = s.counts.get("flash_attention_backward", 0)
    device = sum(o.seconds for o in s.ops if "flash" in o.name)
    if not (n_fwd or n_bwd) or device <= 0:
        return None
    k = work.dims(s.arch)
    b, n = int(s.traffic["batch"]), int(s.traffic["seq"])
    shape = (b, n, n, k["h"], k["kv"], k["dh"])
    bound = (n_fwd * work.bound_s(*work.flash_forward_work(*shape, True),
                                  s.device_kind)
             + n_bwd * work.bound_s(*work.flash_backward_work(*shape),
                                    s.device_kind))
    return 100.0 * bound / device
