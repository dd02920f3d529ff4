from .ops import (FlashAttention, flash_attention,  # noqa: F401
                  flash_attention_backward, flash_attention_forward)
from .ref import (attention_backward_ref, attention_lse_ref,  # noqa: F401
                  attention_ref, flash_attention_ref)
