"""The TargetFuse pipeline of the port: capture, dedup, counting,
selection, ledgers and the Mission stage graph."""
