from .ops import layer_smem_bytes, lut_layer, plan_layer  # noqa: F401
from .ref import lut_layer_ref  # noqa: F401
