"""The port's benchmark: a data-driven harness over configurations, traffic
mixes, cells and per-layer metrics (see ``harness.py``)."""
