"""Serving substrate: the batched request engine for logic networks,
behind the ``repro_torch.serve`` micro-batching scheduler."""
