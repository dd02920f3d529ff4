"""The benchmark of the PyTorch / CUDA port (``repro_torch``).

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and
prints one JSON line. Everything a cell needs is found by name:
``configs/<config>.json`` (sizes, seeded weights' layout),
``traffic/<mix>.json`` (parameters of one general generator, with the
``kind`` that drives it: ``kinds/<kind>.py``), ``limits/<cell>.json``
(the limits that decide ``correct``) and ``metrics/<metric>.py`` (one
reader of the traced slice each). ``reference/`` is the plain PyTorch
model the port is held to; it imports nothing of the port.
"""
