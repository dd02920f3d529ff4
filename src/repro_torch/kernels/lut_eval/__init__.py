from .ops import (level_starts, lut_eval, lut_eval_streamed,  # noqa: F401
                  plan_block, plan_stacked, plan_streamed,
                  stacked_smem_bytes, streamed_smem_bytes)
from .ref import (lut_eval_gather_ref, lut_eval_ref,  # noqa: F401
                  lut_eval_streamed_ref, tile_fold)
