from .ops import lut_layer  # noqa: F401
from .ref import lut_layer_ref  # noqa: F401
