"""Fault-tolerant runtime of the port (the training supervisor)."""
