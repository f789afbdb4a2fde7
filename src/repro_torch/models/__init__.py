"""The counters of the port (PyTorch)."""
