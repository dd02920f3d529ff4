"""repro_torch — the PyTorch / CUDA port of ``repro`` (NullaNet Tiny).

A second package beside the JAX reference: it imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``, and mirrors
``repro``'s layout and names so the counterpart of each module is easy
to find. Every TPU kernel on a ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), with a plain torch version beside it
(``kernels/*/ref.py``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain versions run.
"""
