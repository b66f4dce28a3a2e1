"""Runtime substrate: serving-side latency statistics and fault injection."""

from repro_torch.runtime.resilience import (
    EMAMeanVar,
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
)

__all__ = ["EMAMeanVar", "StragglerDetector", "FailureInjector", "InjectedFailure"]
