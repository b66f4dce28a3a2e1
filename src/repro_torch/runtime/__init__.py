"""Runtime substrate: checkpointing, the restart loop, latency statistics
and fault injection."""

from repro_torch.runtime.resilience import (
    EMAMeanVar,
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
    resilient_train_loop,
)

__all__ = ["EMAMeanVar", "StragglerDetector", "FailureInjector", "InjectedFailure",
           "resilient_train_loop"]
