"""Concurrency lint: an AST pass over the serving sources.

An AST pass over the port's serving sources (:func:`default_lint_targets`:
``engine/{server,scheduler,session}.py``, the ``engine/temporal`` sources
and ``runtime/resilience.py``) that flags:

* ``blocking_under_lock`` — a blocking call (a device wait —
  ``torch.cuda.synchronize()``, ``event.synchronize()``,
  ``stream.synchronize()`` —, a device-to-host read — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()`` —, ``.result()``,
  ``np.asarray`` on device data, ``time.sleep``, ``.join()``, a nested
  ``.acquire()``) made while a lock is lexically held.  Device waits under
  the server lock serialize EVERY submitter on one dispatch.
  Condition-variable methods (``wait``/``wait_for``/``notify``/
  ``notify_all``) are safe-listed: a CV wait *releases* the lock, and
  that is the sanctioned blocking-under-lock pattern.
* ``await_under_lock`` — ``await`` inside a ``with <lock>:`` body of an
  ``async def``: the coroutine suspends while holding a thread lock any
  other task may need, a classic event-loop deadlock.
* ``blocking_in_async`` — a blocking call made directly inside an
  ``async def`` (not wrapped in ``asyncio.to_thread``): it stalls the
  whole event loop, not just this request.
* ``lock_order_cycle`` — lock-acquisition-order extraction: every
  ``with A: ... with B:`` nesting contributes an A->B edge; a cycle in
  the resulting graph means two code paths can acquire the same pair of
  locks in opposite orders (deadlock-capable).
* ``wall_clock`` — a ``time.time()`` call anywhere in a serving source:
  deadline and latency arithmetic must use ``time.monotonic()`` /
  ``time.perf_counter()``.  Wall clocks jump (NTP slew, manual resets),
  and a backwards jump turns every queued deadline into "already
  expired".

The pass is LEXICAL: it sees lock scopes and calls within one function
body, not across call boundaries or aliasing — by design.  It is a
cheap, zero-false-negative-within-scope gate, not an alias analysis;
cross-function patterns (the server's off-lock ``event.synchronize()``
discipline, for instance) are enforced by the runtime tests.

Lock-like names are recognized by their terminal identifier segment
(``lock``/``mutex``/``cv``/``cond``/``sem``/``semaphore``), so
``self._lock``, ``self._cv`` and ``queue_cond`` all count.

The rules are those of the JAX package's ``analysis/concurrency_lint.py``;
the blocking names add torch's device waits and device-to-host reads.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.findings import Finding

__all__ = [
    "lint_source",
    "lint_files",
    "default_lint_targets",
    "BLOCKING_CALLS",
    "SAFE_UNDER_LOCK",
    "WALL_CLOCK_CALLS",
    "LOCK_NAME_RE",
]

# Terminal attribute/function names whose call blocks the calling thread:
# the JAX package's names, and torch's device waits (a stream, event or
# device ``synchronize``) and device-to-host reads (``item``, ``tolist``,
# ``cpu``, ``numpy`` wait for the card when the tensor lives there).
BLOCKING_CALLS = frozenset({
    "block_until_ready",
    "result",
    "asarray",
    "device_get",
    "sleep",
    "join",
    "acquire",
    "synchronize",
    "item",
    "tolist",
    "cpu",
    "numpy",
})

# Condition-variable methods that are the SANCTIONED way to block under a
# lock (wait releases it; notify is non-blocking bookkeeping).
SAFE_UNDER_LOCK = frozenset({"wait", "wait_for", "notify", "notify_all"})

# Terminal names whose call reads the WALL clock — banned outright in
# serving sources (deadline/latency math must survive NTP jumps).  The
# monotonic family (monotonic, perf_counter) is the sanctioned clock.
WALL_CLOCK_CALLS = frozenset({"time"})

LOCK_NAME_RE = re.compile(
    r"(^|_)(lock|mutex|cv|cond|sem|semaphore)s?($|_)", re.IGNORECASE
)


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _lock_id(expr: ast.AST) -> Optional[str]:
    """The lock a with-item acquires, as its source text — or None if the
    expression does not look lock-like."""
    name = _terminal_name(expr)
    if name is not None and LOCK_NAME_RE.search(name):
        try:
            return ast.unparse(expr)
        except Exception:
            return name
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    return _terminal_name(call.func)


class _FunctionLinter(ast.NodeVisitor):
    """Walk ONE function body tracking the lexically-held lock stack."""

    def __init__(self, filename: str, func_name: str, is_async: bool,
                 findings: List[Finding],
                 lock_edges: Set[Tuple[str, str]]):
        self.filename = filename
        self.func_name = func_name
        self.is_async = is_async
        self.findings = findings
        self.lock_edges = lock_edges
        self.held: List[str] = []

    def _where(self, node: ast.AST) -> str:
        return f"{self.filename}:{node.lineno} in {self.func_name}"

    # --- lock scopes ---------------------------------------------------
    def _visit_with(self, node) -> None:
        acquired: List[str] = []
        for item in node.items:
            lock = _lock_id(item.context_expr)
            if lock is not None:
                for outer in self.held:
                    if outer != lock:
                        self.lock_edges.add((outer, lock))
                self.held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()
        # with-item expressions themselves may contain calls to inspect
        for item in node.items:
            self.visit(item.context_expr)

    def visit_With(self, node: ast.With) -> None:
        self._visit_with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._visit_with(node)

    # --- blocking constructs -------------------------------------------
    def visit_Await(self, node: ast.Await) -> None:
        if self.held:
            self.findings.append(Finding(
                checker="concurrency",
                rule="await_under_lock",
                severity="error",
                message=(
                    f"await while holding {self.held[-1]!r} — the "
                    "coroutine suspends with the lock held; any other "
                    "task needing it deadlocks the event loop"
                ),
                where=self._where(node),
            ))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)
        if name in WALL_CLOCK_CALLS:
            self.findings.append(Finding(
                checker="concurrency",
                rule="wall_clock",
                severity="error",
                message=(
                    f"wall-clock call {name}() in serving code — deadline "
                    "and latency math must use time.monotonic() or "
                    "time.perf_counter(); an NTP jump would expire (or "
                    "immortalize) every queued deadline at once"
                ),
                where=self._where(node),
            ))
        if name in SAFE_UNDER_LOCK:
            pass  # CV wait/notify: the sanctioned pattern
        elif name in BLOCKING_CALLS:
            if self.held:
                self.findings.append(Finding(
                    checker="concurrency",
                    rule="blocking_under_lock",
                    severity="error",
                    message=(
                        f"blocking call {name}() while holding "
                        f"{self.held[-1]!r} — every other thread "
                        "contending for the lock stalls on this wait"
                    ),
                    where=self._where(node),
                ))
            elif self.is_async:
                self.findings.append(Finding(
                    checker="concurrency",
                    rule="blocking_in_async",
                    severity="error",
                    message=(
                        f"blocking call {name}() directly inside an async "
                        "function stalls the whole event loop — wrap it "
                        "in asyncio.to_thread"
                    ),
                    where=self._where(node),
                ))
        self.generic_visit(node)

    # Nested defs get their own linter (their body runs later, under
    # whatever locks hold at CALL time, which this lexical pass cannot
    # know — so they are linted lock-free from scratch).
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        _lint_function(node, self.filename, self.findings, self.lock_edges)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        _lint_function(node, self.filename, self.findings, self.lock_edges)


def _lint_function(node, filename: str, findings: List[Finding],
                   lock_edges: Set[Tuple[str, str]]) -> None:
    linter = _FunctionLinter(
        filename, node.name,
        isinstance(node, ast.AsyncFunctionDef),
        findings, lock_edges,
    )
    for stmt in node.body:
        linter.visit(stmt)


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    """First lock-order cycle found by DFS, as the lock path, or None."""
    graph: Dict[str, List[str]] = {}
    for a, b in sorted(edges):
        graph.setdefault(a, []).append(b)
    done: Set[str] = set()

    def dfs(n: str, path: List[str]) -> Optional[List[str]]:
        if n in path:
            return path[path.index(n):] + [n]
        if n in done:
            return None
        path.append(n)
        for m in graph.get(n, ()):
            cyc = dfs(m, path)
            if cyc is not None:
                return cyc
        path.pop()
        done.add(n)
        return None

    for start in list(graph):
        cyc = dfs(start, [])
        if cyc is not None:
            return cyc
    return None


def lint_source(source: str, filename: str = "<string>") -> List[Finding]:
    """Lint one module's source text; returns all findings."""
    findings: List[Finding] = []
    lock_edges: Set[Tuple[str, str]] = set()
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as exc:
        return [Finding(
            checker="concurrency",
            rule="unparseable",
            severity="error",
            message=f"cannot parse: {exc}",
            where=filename,
        )]
    # traverse module and class bodies only, so each function is linted
    # exactly once by _lint_function (nested defs recurse inside it)
    def visit_body(body) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _lint_function(stmt, filename, findings, lock_edges)
            elif isinstance(stmt, ast.ClassDef):
                visit_body(stmt.body)

    visit_body(tree.body)
    cycle = _find_cycle(lock_edges)
    if cycle is not None:
        findings.append(Finding(
            checker="concurrency",
            rule="lock_order_cycle",
            severity="error",
            message=(
                "inconsistent lock acquisition order — two paths can "
                "acquire these locks in opposite orders (deadlock): "
                + " -> ".join(cycle)
            ),
            where=filename,
        ))
    return findings


def default_lint_targets(root: Optional[str] = None) -> List[Path]:
    """The port's serving-loop sources — the files where a blocking call
    under a lock stalls live traffic: the server, scheduler and session,
    the temporal delta path (the output cache takes a lock on the splice
    path; ``DeltaSession`` runs inside ``stream()``'s worker threads) and
    ``runtime/resilience.py`` (its EMA core and ``FailureInjector`` run
    inside the serving loop)."""
    base = Path(root) if root else Path(__file__).resolve().parents[1]
    eng = base / "engine"
    return [
        eng / "server.py",
        eng / "scheduler.py",
        eng / "session.py",
        eng / "temporal" / "band_diff.py",
        eng / "temporal" / "delta_stream.py",
        eng / "temporal" / "output_cache.py",
        base / "runtime" / "resilience.py",
    ]


def lint_files(paths: Optional[Iterable] = None) -> List[Finding]:
    """Lint source files (default: the port's serving sources)."""
    findings: List[Finding] = []
    for p in (paths if paths is not None else default_lint_targets()):
        p = Path(p)
        findings.extend(lint_source(p.read_text(), filename=p.name))
    return findings
