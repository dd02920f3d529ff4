"""``decode_attention_share`` (%): the device time of the traced decode
steps' attention over their caches (``lm.decode_attention``, one span a
layer a step) over that of the whole steps (``engine.decode``); each a
span's device interval, the stream time between two CUDA events."""
from perfbench import program


def read(s, evs=None):
    evs = program.in_slice(s, evs)
    attn = program.device_ms(evs, "lm.decode_attention")
    step = program.device_ms(evs, "engine.decode")
    if attn is None or step is None or step <= 0:
        return None
    return 100.0 * attn / step
