"""Runtime substrate: checkpointing, the restart loop, latency statistics,
fault injection and elastic re-mesh."""

from repro_torch.runtime.resilience import (
    EMAMeanVar,
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
    elastic_remesh,
    resilient_train_loop,
)

__all__ = ["EMAMeanVar", "StragglerDetector", "FailureInjector", "InjectedFailure",
           "resilient_train_loop", "elastic_remesh"]
