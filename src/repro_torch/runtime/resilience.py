"""Fault tolerance for serving: latency statistics and fault injection.

The serving half of the JAX package's ``runtime/resilience.py``, in plain
Python (nothing here touches a tensor):

* :class:`EMAMeanVar` — exponential moving mean/variance of a latency
  stream; the core of :class:`StragglerDetector` and of
  ``engine.server.DegradePolicy``'s rolling p99 estimate.
* :class:`StragglerDetector` — flags z-score outliers in per-step latency.
* :class:`FailureInjector` — deterministic failure injection:
  ``SRServer(..., injector=...)`` calls :meth:`FailureInjector.on_dispatch`
  before every launch, so tests can fail the k-th dispatch, delay a
  dispatch or a replica, or poison one hosted model and check that the
  server fails only the affected requests.  ``fail_at_steps`` /
  :meth:`FailureInjector.maybe_fail` serve a training loop.

The restart loop (``resilient_train_loop``) and elastic re-mesh
(``elastic_remesh``) of the JAX module are training code; they belong to
the benchmarks and LM items, which are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

__all__ = ["EMAMeanVar", "StragglerDetector", "FailureInjector", "InjectedFailure"]


class EMAMeanVar:
    """Exponential moving mean/variance of a latency stream.

    The variance is SEEDED from the first nonzero delta: the plain
    recurrence leaves ``var == 0`` after a constant-latency prefix, which
    would disarm a ``var > 0`` z-score gate for one fold longer than its
    warm-up promises.
    """

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var: float = 0.0
        self.n = 0

    def fold(self, x: float) -> None:
        """Fold one observation into the moving statistics."""
        self.n += 1
        if self.mean is None:
            self.mean = float(x)
            return
        delta = x - self.mean
        if self.var == 0.0 and delta != 0.0:
            self.var = delta * delta
        else:
            self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.mean += self.alpha * delta

    @property
    def std(self) -> float:
        return self.var ** 0.5

    def zscore(self, x: float) -> float:
        """How many moving standard deviations ``x`` sits from the mean.
        With zero variance any deviation is infinitely surprising (``±inf``),
        so a spike after a constant warm-up is still flagged."""
        if self.mean is None:
            return 0.0
        delta = x - self.mean
        if self.var > 0:
            return delta / self.var ** 0.5
        if delta == 0:
            return 0.0
        return float("inf") if delta > 0 else float("-inf")

    def upper(self, z: float) -> float:
        """``mean + z * std`` — the normal-approximation upper quantile
        (z = 2.326 ~ p99) the serving degrade policy tracks."""
        if self.mean is None:
            return 0.0
        return self.mean + z * self.std


class StragglerDetector:
    """EMA-based per-step latency outlier detection."""

    def __init__(self, alpha: float = 0.1, z_threshold: float = 3.0, warmup: int = 5):
        self.alpha, self.z = alpha, z_threshold
        self.warmup = warmup
        self._ema = EMAMeanVar(alpha)
        self.n = 0
        self.flagged: list = []

    # outliers are never folded, so these track the clean baseline
    @property
    def mean(self) -> Optional[float]:
        return self._ema.mean

    @property
    def var(self) -> float:
        return self._ema.var

    def update(self, step: int, seconds: float) -> bool:
        self.n += 1
        if self._ema.mean is None:
            self._ema.fold(seconds)
            return False
        is_straggler = False
        if self.n > self.warmup:
            zscore = self._ema.zscore(seconds)
            if zscore > self.z:
                is_straggler = True
                self.flagged.append((step, seconds, zscore))
        if not is_straggler:
            self._ema.fold(seconds)
        return is_straggler


class InjectedFailure(RuntimeError):
    """Raised by :class:`FailureInjector` at a configured injection point —
    distinguishable from organic failures in tests."""


class FailureInjector:
    """Deterministic failure injection.

    Serving path: pass the injector to ``SRServer(..., injector=...)``; the
    server calls :meth:`on_dispatch` before every launch, after executor
    resolution, so an injected fault flows through the server's normal
    dispatch-failure isolation:

    * ``fail_dispatches`` — zero-based global dispatch indices that raise
      :class:`InjectedFailure`;
    * ``delay_dispatches`` — ``{index: seconds}``: stall those launches;
    * ``poison_models`` — model names whose EVERY dispatch fails;
    * ``delay_replicas`` — ``{replica_index: seconds}``: stall every
      dispatch routed to one replica.

    Training path: ``fail_at_steps`` and a :meth:`maybe_fail` call at the
    top of each step.
    """

    def __init__(self, fail_at_steps=(), *, fail_dispatches=(), delay_dispatches=None,
                 poison_models=(), delay_replicas=None):
        self.fail_at = set(fail_at_steps)
        self.fired = set()
        self.fail_dispatches = set(fail_dispatches)
        self.delay_dispatches = dict(delay_dispatches or {})
        self.poison_models = set(poison_models)
        self.delay_replicas = dict(delay_replicas or {})
        self.dispatch_index = 0  # dispatches seen via on_dispatch
        self.injected_failures = 0
        self.injected_delays = 0

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")

    def on_dispatch(self, *, model: Optional[str] = None,
                    replica: Optional[int] = None) -> None:
        """Serving-path injection point: called once per dispatch launch."""
        k = self.dispatch_index
        self.dispatch_index += 1
        delay = self.delay_dispatches.get(k, 0.0)
        if replica is not None:
            delay = max(delay, self.delay_replicas.get(replica, 0.0))
        if delay > 0:
            self.injected_delays += 1
            time.sleep(delay)
        if model is not None and model in self.poison_models:
            self.injected_failures += 1
            raise InjectedFailure(f"injected poison: model {model!r}")
        if k in self.fail_dispatches:
            self.injected_failures += 1
            raise InjectedFailure(f"injected failure at dispatch {k}")

    def stats(self) -> Dict[str, int]:
        return {
            "dispatches_seen": self.dispatch_index,
            "injected_failures": self.injected_failures,
            "injected_delays": self.injected_delays,
        }
