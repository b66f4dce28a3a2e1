"""Micro-batching scheduler — cross-request coalescing into bucket dispatches.

The paper's accelerator sustains its frame rate by keeping the datapath fed
with a continuous stream of bands; the serving analogue is keeping every
compiled bucket full of REAL frames.  ``MicroBatchScheduler`` is the pure
bookkeeping half of that (no tensors, no compute — execution lives in
``engine.server``):

* **Admission.**  Requests enter per-key FIFO queues; the server enforces
  its ``max_inflight_frames`` bound at admission and raises
  :class:`QueueFullError` (or blocks and drains, or SHEDS queued work —
  see below) when the queue is full.
* **Deadlines.**  A request may carry an absolute monotonic ``deadline``;
  :meth:`MicroBatchScheduler.expire_due` removes queued, never-dispatched
  requests whose deadline has passed (the server fails their futures with
  ``DeadlineExceededError`` before they ever compile or dispatch).  A
  partially-served request is past recall — its in-flight frames complete
  regardless, exactly like :meth:`MicroBatchScheduler.drop`.
* **Load shedding.**  Under ``admission="shed"`` the server asks
  :meth:`MicroBatchScheduler.shed_victims` to evict the *lowest-priority,
  latest-deadline* queued work (never the newcomer, and never anything
  already dispatched) to make room; victims' futures fail with
  ``RequestShedError``.  If nothing strictly less urgent than the
  newcomer can free enough frames, the newcomer itself is rejected.
* **Coalescing.**  The key is ``(model, plan, dtype-name)`` — exactly the
  session's compile-cache key plus the model name — because frames that
  share a key are served by the SAME compiled executor, so frames from
  different requests can ride in ONE bucket-sized dispatch.  Two concurrent
  half-bucket requests become a single full bucket (fill ratio 1.0) instead
  of two padded dispatches.
* **Bucket choice.**  A dispatch's bucket is derived from the key's TOTAL
  pending frames (``session._bucket_for`` — power-of-two, ``max_bucket``
  capped), so queued traffic fills the largest legal bucket.  A request
  left partially served pins its bucket (the *carry* bucket) for its tail
  dispatches — the same program serves every chunk of a long clip, exactly
  like the pre-server pipelined path (no tail-driven recompiles).
* **Priority.**  Across keys, the key holding the highest-priority request
  dispatches first (FIFO on arrival within a priority level).  Within a
  key, requests coalesce in arrival order — they share dispatches anyway.

Counters (:meth:`MicroBatchScheduler.stats`) record dispatches, how many
coalesced multiple requests, real frames vs bucket slots (the mean fill
ratio — the padding the coalescer eliminated), queue depth peaks and
admission rejections; ``recent_dispatches`` keeps a bounded log for tests
and debugging.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = [
    "MicroBatchScheduler",
    "QueueFullError",
    "DeadlineExceededError",
    "RequestShedError",
    "SchedRequest",
    "Ticket",
    "Dispatch",
]

# bounded debug/test log of formed dispatches (oldest dropped first)
RECENT_DISPATCH_LOG = 256


class QueueFullError(RuntimeError):
    """Admission rejected: the server's ``max_inflight_frames`` bound is
    full and the admission policy is ``"reject"`` (or ``"shed"`` with the
    newcomer itself the least-urgent work queued)."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed while it was still queued — it was
    cancelled before compiling or dispatching.  A ``TimeoutError``
    subclass, but distinct from the plain ``TimeoutError`` that
    ``SRFuture.result(timeout=)`` raises when only the *wait* expires
    (the request itself stays queued and may still complete)."""


class RequestShedError(QueueFullError):
    """This queued request was EVICTED under ``admission="shed"``: the
    bound was full and a newer, more urgent request claimed its frames.
    Subclasses :class:`QueueFullError` so callers handling queue-full
    rejection handle shedding too."""


@dataclasses.dataclass
class SchedRequest:
    """One admitted request: a flat ``(N, H, W, C)`` frame batch plus the
    assembly state the server needs to slice its results back out.

    ``served`` counts frames handed to dispatches, ``completed`` frames
    whose HR output has been sliced into ``pieces``; the request's future
    resolves when ``completed == n``.
    """

    seq: int
    key: tuple  # (model, plan, dtype_name) — the coalescing key
    session: object  # owning SRSession
    plan: object  # SRPlan
    flat: object  # (N, H, W, C) tensor, serving dtype applied
    n: int
    priority: int
    future: object  # SRFuture
    ndim: int  # caller's original rank (3 | 4 | 5)
    lead: Optional[tuple]  # (B, T) when ndim == 5
    # absolute time.monotonic() seconds; None = no deadline.  Checked by
    # expire_due while the request is still fully queued.
    deadline: Optional[float] = None
    # admission timestamp (time.monotonic()) — end-to-end latency anchor
    # for the server's degrade policy
    admitted_at: float = 0.0
    # time.perf_counter() seconds: the submit call began; the dispatch of
    # its first frames launched (the session's queue-wait and latency)
    submitted_at: float = 0.0
    dispatched_at: float = 0.0
    # partial-band request (temporal delta serving): the band indices the
    # ``n`` slab rows of ``flat`` correspond to.  None = whole frames.
    # Band requests use a "bands"-suffixed key, so the coalescer never
    # mixes band slabs and frames in one dispatch.
    bands: Optional[tuple] = None
    served: int = 0
    completed: int = 0
    pieces: List = dataclasses.field(default_factory=list)
    failed: bool = False


@dataclasses.dataclass
class Ticket:
    """One request's slice of a dispatch: frames ``[start, start + n)`` of
    the request occupy slab rows ``[slot, slot + n)``."""

    request: SchedRequest
    start: int
    n: int
    slot: int


@dataclasses.dataclass
class Dispatch:
    """A formed bucket-sized dispatch: which requests' frames fill which
    slab rows.  Rows past ``real`` are zero padding."""

    key: tuple
    session: object
    plan: object
    bucket: int
    tickets: List[Ticket]
    # replica index the server routed this dispatch to (mesh serving;
    # recorded at launch, None on single-device sessions)
    replica: Optional[int] = None
    # partial-band dispatch (temporal delta serving): the band index each
    # real slab row serves, in slot order.  None = a whole-frame dispatch.
    band_subset: Optional[tuple] = None

    @property
    def real(self) -> int:
        return sum(t.n for t in self.tickets)

    @property
    def fill(self) -> float:
        return self.real / self.bucket

    @property
    def requests(self) -> List[SchedRequest]:
        seen, out = set(), []
        for t in self.tickets:
            if id(t.request) not in seen:
                seen.add(id(t.request))
                out.append(t.request)
        return out


class MicroBatchScheduler:
    """Queues + coalescing policy; the server drives it under its lock."""

    def __init__(self):
        self._queues: Dict[tuple, Deque[SchedRequest]] = {}
        self._carry: Dict[tuple, int] = {}  # pinned bucket of a partial head
        self._seq = itertools.count()
        self.pending_frames = 0
        self.peak_pending_frames = 0
        self.submitted_requests = 0
        self.submitted_frames = 0
        self.dispatches = 0
        self.coalesced_dispatches = 0
        self.frames_dispatched = 0
        self.slots_dispatched = 0
        self.rejected = 0
        self.expired = 0  # queued requests cancelled past their deadline
        self.shed = 0  # queued requests evicted under admission="shed"
        # replica index -> dispatches routed there (mesh serving only;
        # stays empty on single-device sessions)
        self.replica_dispatches: Dict[int, int] = {}
        self.recent_dispatches: Deque[dict] = deque(maxlen=RECENT_DISPATCH_LOG)

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def next_seq(self) -> int:
        return next(self._seq)

    def add(self, req: SchedRequest) -> None:
        self._queues.setdefault(req.key, deque()).append(req)
        self.submitted_requests += 1
        self.submitted_frames += req.n
        self.pending_frames += req.n
        self.peak_pending_frames = max(self.peak_pending_frames, self.pending_frames)

    def note_rejected(self) -> None:
        self.rejected += 1

    def note_empty_request(self) -> None:
        """An admitted zero-frame request (resolved without a dispatch)."""
        self.submitted_requests += 1

    def note_routed(self, replica: int) -> None:
        """A dispatch landed on a replica (server records it at launch)."""
        self.replica_dispatches[replica] = (
            self.replica_dispatches.get(replica, 0) + 1
        )

    def has_pending(self) -> bool:
        return self.pending_frames > 0

    def pending_for(self, key: tuple) -> int:
        q = self._queues.get(key)
        return sum(r.n - r.served for r in q) if q else 0

    def drop(self, req: SchedRequest) -> None:
        """Remove a failed request's undispatched remainder from its queue
        (frames already handed to in-flight dispatches are past recall —
        their tickets are skipped at completion)."""
        q = self._queues.get(req.key)
        if not q or req not in q:
            return
        remaining = req.n - req.served
        q.remove(req)
        self.pending_frames -= remaining
        if req.served > 0:
            # only a partially-served head pins a carry bucket — dropping
            # it must release the pin, or the next unrelated request would
            # dispatch at the dead request's bucket
            self._carry.pop(req.key, None)
        if not q:
            del self._queues[req.key]
            self._carry.pop(req.key, None)

    def expire_due(self, now: float) -> List[SchedRequest]:
        """Remove queued, never-dispatched requests whose deadline passed.

        Returns them (the server fails each future with
        ``DeadlineExceededError``).  A partially-served request is kept:
        its dispatched frames are in flight and its tail must ride the
        pinned carry bucket — cancelling half a clip would hand back a
        torn result.  Expiry is therefore all-or-nothing, decided before
        the first frame dispatches.
        """
        if not self._queues:
            return []
        expired: List[SchedRequest] = []
        for key in list(self._queues):
            q = self._queues[key]
            due = [r for r in q
                   if r.deadline is not None and r.served == 0
                   and r.deadline <= now]
            for r in due:
                q.remove(r)
                self.pending_frames -= r.n
                expired.append(r)
            if not q:
                del self._queues[key]
                self._carry.pop(key, None)
        self.expired += len(expired)
        return expired

    def shed_victims(self, need: int, *, priority: int,
                     deadline: Optional[float]) -> Optional[List[SchedRequest]]:
        """Pick queued work to evict so ``need`` frames fit, or ``None``.

        Only requests ranked strictly BELOW the newcomer are candidates:
        lower priority, or equal priority with a later deadline (no
        deadline sorts latest — unconstrained work is the first to go).
        Partially-served requests are immune (their frames are in
        flight).  Victims are taken worst-first — lowest priority, then
        latest deadline, then newest — and removed from their queues;
        the caller fails their futures with ``RequestShedError``.

        Returns ``None`` without evicting anything when the candidates
        cannot free ``need`` frames: the newcomer is then the least
        urgent work in the building and should be rejected instead.
        """
        inf = float("inf")
        new_dl = inf if deadline is None else deadline

        def rank(r: SchedRequest) -> tuple:
            r_dl = inf if r.deadline is None else r.deadline
            return (r.priority, -r_dl, -r.seq)  # ascending = worst first

        cands = [
            r for q in self._queues.values() for r in q
            if r.served == 0 and (
                r.priority < priority
                or (r.priority == priority
                    and (inf if r.deadline is None else r.deadline) > new_dl)
            )
        ]
        cands.sort(key=rank)
        victims: List[SchedRequest] = []
        freed = 0
        for r in cands:
            if freed >= need:
                break
            victims.append(r)
            freed += r.n
        if freed < need:
            return None
        for r in victims:
            self.drop(r)
        self.shed += len(victims)
        return victims

    # ------------------------------------------------------------------
    # Dispatch formation
    # ------------------------------------------------------------------
    def _select_key(self, ready) -> Optional[tuple]:
        """The next key to dispatch: highest pending priority wins, FIFO
        (head arrival order) within a priority level; keys whose session
        has no pipeline-depth slack (``ready``) are skipped this round."""
        best_key, best_rank = None, None
        for key, q in self._queues.items():
            if not q or not ready(q[0].session):
                continue
            rank = (-max(r.priority for r in q), q[0].seq)
            if best_rank is None or rank < best_rank:
                best_key, best_rank = key, rank
        return best_key

    def next_dispatch(self, ready, bucket_fn=None) -> Optional[Dispatch]:
        """Form the next bucket-sized dispatch, or ``None`` if nothing is
        pending for a ready session.  Consumes the taken frames from the
        queues and updates the coalescing counters.  ``bucket_fn``, when
        given, post-processes a freshly derived bucket size (the server's
        degrade policy shrinks buckets under pressure); a carry-pinned
        bucket is NEVER resized — a clip mid-flight keeps its program."""
        key = self._select_key(ready)
        if key is None:
            return None
        q = self._queues[key]
        session = q[0].session
        # a partially-served head pins the bucket its first chunk used, so
        # clip tails never compile a second (smaller) program; otherwise
        # size the bucket to everything pending for the key — coalesced
        # traffic fills the largest legal bucket
        bucket = self._carry.get(key)
        if bucket is None:
            bucket = session._bucket_for(self.pending_for(key))
            if bucket_fn is not None:
                bucket = max(1, int(bucket_fn(bucket)))
        tickets: List[Ticket] = []
        slot = 0
        while q and slot < bucket:
            r = q[0]
            take = min(r.n - r.served, bucket - slot)
            tickets.append(Ticket(request=r, start=r.served, n=take, slot=slot))
            r.served += take
            slot += take
            if r.served == r.n:
                q.popleft()
            else:
                break  # bucket full mid-request — it stays at the head
        if q and q[0].served > 0:
            self._carry[key] = bucket
        else:
            self._carry.pop(key, None)
        if not q:
            del self._queues[key]
        subset: Optional[tuple] = None
        if tickets[0].request.bands is not None:
            # band requests only ever share a queue with band requests
            # (the "bands" key marker), so every ticket carries indices
            picked: List[int] = []
            for t in tickets:
                picked.extend(t.request.bands[t.start : t.start + t.n])
            subset = tuple(picked)
        d = Dispatch(key=key, session=session, plan=tickets[0].request.plan,
                     bucket=bucket, tickets=tickets, band_subset=subset)
        self.pending_frames -= d.real
        self.dispatches += 1
        if len(d.requests) > 1:
            self.coalesced_dispatches += 1
        self.frames_dispatched += d.real
        self.slots_dispatched += bucket
        self.recent_dispatches.append({
            "model": key[0],
            "lr_shape": list(d.plan.lr_shape),
            "dtype": key[2],
            "bucket": bucket,
            "frames": d.real,
            "fill": d.fill,
            "requests": len(d.requests),
            "priority": max(t.request.priority for t in tickets),
            "bands": None if subset is None else list(subset),
        })
        return d

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Cumulative coalescing/queue counters.

        ``mean_fill_ratio`` is real frames over bucket slots across every
        dispatch — 1.0 means the coalescer padded nothing; ``padded_frames``
        is the absolute slack.  ``coalesced_dispatches`` counts dispatches
        that carried more than one request.
        """
        slots = self.slots_dispatched
        return {
            "submitted_requests": self.submitted_requests,
            "submitted_frames": self.submitted_frames,
            "pending_frames": self.pending_frames,
            "peak_pending_frames": self.peak_pending_frames,
            "dispatches": self.dispatches,
            "coalesced_dispatches": self.coalesced_dispatches,
            "frames_dispatched": self.frames_dispatched,
            "slots_dispatched": slots,
            "padded_frames": slots - self.frames_dispatched,
            "mean_fill_ratio": self.frames_dispatched / slots if slots else 0.0,
            "rejected": self.rejected,
            "expired": self.expired,
            "shed": self.shed,
            "replica_dispatches": dict(self.replica_dispatches),
            # live carry pins — an abandoned clip must release its pinned
            # bucket (the stream-cleanup leak test asserts this hits 0)
            "carry_buckets": len(self._carry),
        }
