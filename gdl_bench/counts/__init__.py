"""Operation and byte counts by configuration family and kernel."""
