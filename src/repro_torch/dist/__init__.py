"""Distributed substrate of the port: mesh and sharding rules, gradient
compression, fault tolerance and pipeline parallelism.

Modules:
  shardings — mesh context, strategy flags (OPTS), param/activation
              partition rules, placement of leaves as DTensors.
  compress  — error-feedback gradient compression (top-k, signSGD).
  fault     — heartbeat files, step watchdog, retrying step wrapper.
  pipeline  — GPipe-style stage-parallel LM forward over the layers
              (imported explicitly; it depends on repro_torch.models).
"""
from repro_torch.dist import compress, fault, shardings  # noqa: F401
