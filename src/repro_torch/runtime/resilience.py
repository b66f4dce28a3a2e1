"""Fault tolerance: the restart loop, latency statistics and fault
injection — the port of ``repro.runtime.resilience``.

* :func:`resilient_train_loop` — wraps a train step; on a failure it
  restores the newest complete checkpoint (``runtime.checkpoint``) and
  replays the data stream from that step (the stream is a pure function of
  the step, see ``data.synthetic``).
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

Elastic re-mesh (the reference's ``elastic_remesh``) comes with the
dry-run slice's sharding rules (ROADMAP queue 1, item 14g).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.layers.params import tree_leaves, tree_map
from repro_torch.runtime import checkpoint as ckpt_lib

__all__ = ["EMAMeanVar", "StragglerDetector", "FailureInjector", "InjectedFailure",
           "resilient_train_loop"]


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


def _clone(state):
    return tree_map(torch.clone, state, is_leaf=lambda x: not isinstance(x, dict))


def _synchronize(state) -> None:
    """Wait for the device of the state's first leaf (the reference's
    ``jax.block_until_ready``), so a step's time is the device's."""
    leaf = tree_leaves(state)[0]
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def resilient_train_loop(
    *,
    init_state,
    train_step: Callable,
    batch_fn: Callable[[int], Dict],
    total_steps: int,
    ckpt_dir: str,
    cfg=None,
    checkpoint_every: int = 50,
    keep: int = 3,
    max_restarts: int = 5,
    injector: Optional[FailureInjector] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
) -> Tuple[Any, Dict]:
    """Run to ``total_steps`` surviving failures. Returns ``(state, report)``.

    ``train_step`` may update the state in place (``distributed.steps``'
    does), so the loop keeps a copy of ``init_state`` on its device until a
    checkpoint has *completed* (``latest_step`` finds one; an asynchronous
    write that fails leaves none): a failure before that restarts from the
    copy, as the reference restarts from ``init_state``.  Without a
    completed checkpoint (``checkpoint_every=0``, or every write failing)
    the copy is held for the whole run, which costs one state's device
    memory.
    """
    detector = StragglerDetector()
    restarts = 0
    state = init_state
    start = ckpt_lib.latest_step(ckpt_dir)
    initial = None
    if start is not None:
        start, state = ckpt_lib.restore(ckpt_dir, state, cfg)
        start += 1
    else:
        start = 0
        initial = _clone(init_state)

    step = start
    while step < total_steps:
        try:
            # monotonic: step-latency deltas must not jump with NTP slews
            t0 = time.monotonic()
            if injector is not None:
                injector.maybe_fail(step)
            state, metrics = train_step(state, batch_fn(step))
            _synchronize(state)
            detector.update(step, time.monotonic() - t0)
            if on_metrics is not None:
                on_metrics(step, metrics)
            if checkpoint_every and (step + 1) % checkpoint_every == 0:
                ckpt_lib.save(ckpt_dir, step, state, cfg, keep=keep, blocking=False)
            if initial is not None and step >= checkpoint_every > 0 \
                    and ckpt_lib.latest_step(ckpt_dir) is not None:
                initial = None  # a failure from here on restores a checkpoint
            step += 1
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt_lib.wait_pending()
            last = ckpt_lib.latest_step(ckpt_dir)
            if last is not None:
                _, state = ckpt_lib.restore(ckpt_dir, state, cfg)
                step = last + 1
            elif initial is not None:
                state = _clone(initial)
                step = 0
            else:  # resumed from a checkpoint that has since gone
                raise
    ckpt_lib.wait_pending()
    return state, {
        "restarts": restarts,
        "stragglers": list(detector.flagged),
        "finished_step": step,
    }
