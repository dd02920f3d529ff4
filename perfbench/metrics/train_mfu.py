"""``train_mfu`` (%): model FLOPs of the traced training steps over the
slice's time (its first device operation to its last) at the card's
bf16 peak. Model FLOPs: 6 N T over the
layers' and the head's matrices, attention's causal products three
times; recomputation is not counted (``work.train_model_flops``)."""
from perfbench import work


def read(s):
    steps = s.spans_of("train_step")
    if not steps or s.window_s <= 0:
        return None
    flops = len(steps) * work.train_model_flops(
        s.arch, int(s.traffic["batch"]), int(s.traffic["seq"]))
    return 100.0 * flops / (s.window_s * work.peak(s.device_kind)["bf16_flops"])
