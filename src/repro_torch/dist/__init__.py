"""Distributed substrate of the port, so far its single-device part:

  compress — error-feedback gradient compression (top-k, signSGD).
  fault    — heartbeat files, step watchdog, retrying step wrapper.

Mesh placement (the reference's ``shardings`` and ``pipeline``) waits
for the multi-device slice (ROADMAP Queue 1).
"""
from repro_torch.dist import compress, fault  # noqa: F401
