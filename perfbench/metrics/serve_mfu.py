"""``serve_mfu`` (%): model FLOPs of every prompt and output token the
engine processed in the traced slice over the slice's time (its first
device operation to its last) at the card's bf16 peak. Each ``perfbench:prefill`` span carries its prompt
length (every token through the layers, the head for the last), each
``perfbench:decode`` span its active slots and their summed contexts
(inactive slots' rows are not counted)."""
from perfbench import work


def read(s):
    pre, dec = s.spans_of("prefill"), s.spans_of("decode")
    if not (pre or dec) or s.window_s <= 0:
        return None
    flops = sum(work.prefill_flops(s.arch, int(p.attrs["S"])) for p in pre)
    flops += sum(work.decode_flops(s.arch, int(d.attrs["active"]),
                                   int(d.attrs["ctx"])) for d in dec)
    return 100.0 * flops / (s.window_s * work.peak(s.device_kind)["bf16_flops"])
