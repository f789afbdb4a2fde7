"""Counting metric of the port: CMAE, the paper's headline metric
(a copy of ``cmae`` in ``repro/core/metrics.py``)."""
from __future__ import annotations

import numpy as np


def cmae(pred_counts, true_counts) -> float:
    """Count Mean Absolute Error: sum|y_i - g_i| / sum g_i (paper §IV-A6)."""
    y = np.asarray(pred_counts, dtype=np.float64)
    g = np.asarray(true_counts, dtype=np.float64)
    denom = max(g.sum(), 1e-9)
    return float(np.abs(y - g).sum() / denom)
