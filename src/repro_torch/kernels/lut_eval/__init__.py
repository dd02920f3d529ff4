from .ops import level_starts, lut_eval, lut_eval_streamed, plan_block  # noqa: F401
from .ref import lut_eval_ref, lut_eval_streamed_ref, tile_fold  # noqa: F401
