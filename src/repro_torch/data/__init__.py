"""Data pipelines: the synthetic JSC generator (numpy)."""
