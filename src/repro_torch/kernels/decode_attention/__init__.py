"""Single-token attention over the serving ring KV cache, read in place."""
from .ops import decode_attention, split_count  # noqa: F401
from .ref import decode_attention_ref, decode_logits  # noqa: F401
