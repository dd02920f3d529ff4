"""Runnable examples of the port, twins of the reference's
``examples/quickstart.py`` and ``examples/serve_logic.py``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_logic [--device cpu]

Both train on the card unless ``--device cpu`` is given.
"""
