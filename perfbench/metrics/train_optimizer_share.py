"""``train_optimizer_share`` (%): the device time of the traced training
steps' ``train.optimizer`` spans (the global norm and AdamW's update)
over that of ``train.forward``, ``train.backward`` and
``train.optimizer`` together; each a span's device interval, the stream
time between two CUDA events."""
from perfbench import program


def read(s, evs=None):
    evs = program.in_slice(s, evs)
    parts = [program.device_ms(evs, n) for n in
             ("train.forward", "train.backward", "train.optimizer")]
    if any(p is None for p in parts) or sum(parts) <= 0:
        return None
    return 100.0 * parts[2] / sum(parts)
