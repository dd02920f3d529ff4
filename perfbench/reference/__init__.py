"""The plain PyTorch reference the port is held to. It imports nothing
of the port (``repro_torch``) nor of the JAX package."""
