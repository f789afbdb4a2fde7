"""The counters' optimizer and its learning-rate schedules (PyTorch)."""
