from .ops import fanin_matmul  # noqa: F401
from .ref import dense_equivalent, fanin_matmul_ref  # noqa: F401
