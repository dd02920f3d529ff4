"""Runnable examples of the port, twins of the reference's
``examples/quickstart.py``, ``examples/serve_logic.py`` and
``examples/serve_lm.py``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_logic [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Each runs on the card unless ``--device cpu`` is given.
"""
