"""Per-metric readers, one module per metric name (see harness.py)."""
