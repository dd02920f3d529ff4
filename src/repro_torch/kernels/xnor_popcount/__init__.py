from .ops import xnor_matmul, xnor_matmul_packed  # noqa: F401
from .ref import pack_bipolar, xnor_matmul_ref, xnor_popcount_ref  # noqa: F401
