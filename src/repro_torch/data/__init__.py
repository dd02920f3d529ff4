"""Data pipelines: the synthetic JSC generator and the synthetic LM
token stream (numpy)."""
