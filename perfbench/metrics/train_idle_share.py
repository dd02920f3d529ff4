"""``train_idle_share`` (%): the share of the traced training slice,
from its first device operation to its last, in which no operation ran
on the device."""


def read(s):
    if not s.ops or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
