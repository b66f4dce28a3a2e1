"""Statistics the metric readers and the bound arithmetic share."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (``statistics.quantiles``,
    exclusive method, as the bounds are set)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def finite(x: float) -> float:
    """``x``, or the largest float where ``x`` is infinite (JSON has no inf)."""
    return x if math.isfinite(x) else 1.7976931348623157e308
