"""Runtime lock sanitizer: the dynamic counterpart of rules ORP020–ORP022
(counterpart of ``orp_tpu/lint/lock_audit.py``).

`concurrency.py` proves what it can statically; this module catches what
only execution shows. :class:`LockAudit` wraps named locks so that while a
test runs it records, per thread, the ORDER locks are acquired in and HOW
LONG each is held. At the end (or any point) the test calls
:meth:`LockAudit.check`:

* two threads that acquired the same pair of locks in opposite orders is a
  latent deadlock — reported as :class:`LockOrderInversion` naming both
  acquisition sites (file:line of each ``with``/``acquire``), even though
  the interleaving that would actually deadlock never fired;
* a lock held longer than its budget is the serve-stall class ORP021
  hunts — reported as :class:`HoldBudgetExceeded` naming the lock, the
  hold, and the site that acquired it.

The wrapper is designed so ``threading.Condition`` keeps working:
CPython's Condition copies ``acquire``/``release`` from the lock it is
given and picks up ``_release_save``/``_acquire_restore``/``_is_owned``
when the lock defines them — :class:`_AuditedLock` defines all five, so
``Condition(audit.wrap("host", lock))`` routes every wait/notify hand-off
through the bookkeeping (a ``wait()`` correctly ends the hold and a
wake-up correctly restarts it).

Overhead is a dict update and a ``perf_counter`` pair per acquire
(``tests/test_torch_lint_concurrency.py`` counts the bookkeeping per
acquire rather than timing it, so a loaded test worker cannot trip it).

Usage::

    audit = LockAudit(hold_budget_s=0.25)
    host._lock = audit.wrap("host", host._lock)
    ...hammer the host from threads...
    audit.check()     # raises on inversion / budget breach
    audit.report()    # {"edges": [...], "max_hold_s": {...}, ...}

:func:`audit_host` wires a :class:`~orp_tpu_torch.serve.host.ServeHost` (its
host lock + swap condition, pending lock, tier lock, every current
tenant's build lock, and the condition of every live tenant's
:class:`~orp_tpu_torch.serve.batcher.MicroBatcher`) in one call.
"""

from __future__ import annotations

import sys
import threading
import time


class LockAuditError(AssertionError):
    """Base: the audited run violated the lock discipline."""


class LockOrderInversion(LockAuditError):
    """Lock pair acquired in both orders — a latent deadlock."""


class HoldBudgetExceeded(LockAuditError):
    """A lock was held longer than its budget."""


def _site(depth: int) -> str:
    """file:line of the acquiring frame, skipping this module's own."""
    f = sys._getframe(depth)
    while f is not None and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    if f is None:  # pragma: no cover - interpreter shutdown
        return "<unknown>"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class _AuditedLock:
    """Delegating wrapper around a Lock/RLock with acquisition bookkeeping.

    Reentrant acquires (RLock) are tracked by depth: only the outermost
    acquire records an ordering edge and starts the hold clock, only the
    final release stops it — a nested ``with self._lock`` inside an RLock
    region is not a second hold."""

    __slots__ = ("_audit", "name", "_inner", "_budget_s", "_depth")

    def __init__(self, audit: "LockAudit", name: str, inner,
                 budget_s: float | None):
        self._audit = audit
        self.name = name
        self._inner = inner
        self._budget_s = budget_s
        self._depth = threading.local()

    # -- lock protocol --------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration (CPython copies these when present) ------------

    def _release_save(self):
        # Condition.wait(): the hold genuinely ends here (other threads run)
        self._note_released(full=True)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._note_acquired(restore=True)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock fallback (the stdlib's own trick, inverted cheaply)
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    # -- bookkeeping ----------------------------------------------------------

    def _note_acquired(self, restore: bool = False) -> None:
        depth = getattr(self._depth, "n", 0)
        self._depth.n = depth + 1
        if depth == 0 or restore:
            self._audit._on_acquire(self, _site(2), restore=restore)

    def _note_released(self, full: bool = False) -> None:
        depth = getattr(self._depth, "n", 1)
        self._depth.n = 0 if full else depth - 1
        if self._depth.n == 0:
            self._audit._on_release(self, _site(2))


class LockAudit:
    """Records per-thread acquisition order and hold times across every
    lock wrapped through :meth:`wrap`; :meth:`check` raises on an order
    inversion or a hold-budget breach, :meth:`report` returns the ledger."""

    def __init__(self, hold_budget_s: float | None = None):
        self.hold_budget_s = hold_budget_s
        self._mu = threading.Lock()          # guards the ledgers below
        self._held = threading.local()       # per-thread [(lock, t0, site)]
        # (outer name, inner name) -> (outer site, inner site) first seen
        self._edges: dict[tuple[str, str], tuple[str, str]] = {}
        self._max_hold: dict[str, tuple[float, str]] = {}
        self._violations: list[LockAuditError] = []
        self._acquires: dict[str, int] = {}

    # -- wiring ---------------------------------------------------------------

    def wrap(self, name: str, lock=None, *,
             hold_budget_s: float | None | str = "inherit") -> _AuditedLock:
        """Wrap ``lock`` (default: a fresh ``threading.Lock``) under
        ``name``. Pass ``hold_budget_s=None`` to exempt one lock from the
        audit-wide budget (e.g. a build serializer that exists to hold
        construction — the ORP012/ORP021 exemption, made explicit)."""
        if lock is None:
            lock = threading.Lock()
        budget = (self.hold_budget_s if hold_budget_s == "inherit"
                  else hold_budget_s)
        return _AuditedLock(self, name, lock, budget)

    # -- event sinks (called by _AuditedLock) ---------------------------------

    def _on_acquire(self, lock: _AuditedLock, site: str,
                    restore: bool = False) -> None:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        t0 = time.perf_counter()
        with self._mu:
            self._acquires[lock.name] = self._acquires.get(lock.name, 0) + 1
            for outer, _t, outer_site in stack:
                if outer is lock:
                    continue
                edge = (outer.name, lock.name)
                if edge not in self._edges:
                    self._edges[edge] = (outer_site, site)
                    rev = self._edges.get((lock.name, outer.name))
                    if rev is not None:
                        self._violations.append(LockOrderInversion(
                            f"lock-order inversion: {outer.name} -> "
                            f"{lock.name} here ({outer_site} then {site}) "
                            f"but {lock.name} -> {outer.name} elsewhere "
                            f"({rev[0]} then {rev[1]}) — two threads "
                            "interleaving these orders deadlock"))
        stack.append((lock, t0, site))

    def _on_release(self, lock: _AuditedLock, site: str) -> None:
        stack = getattr(self._held, "stack", None) or []
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                _l, t0, acq_site = stack.pop(i)
                held = time.perf_counter() - t0
                with self._mu:
                    prev = self._max_hold.get(lock.name)
                    if prev is None or held > prev[0]:
                        self._max_hold[lock.name] = (held, acq_site)
                    budget = lock._budget_s
                    if budget is not None and held > budget:
                        self._violations.append(HoldBudgetExceeded(
                            f"{lock.name} held {held * 1e3:.1f} ms > budget "
                            f"{budget * 1e3:.1f} ms (acquired at "
                            f"{acq_site}) — every thread queued on it paid "
                            "that stall"))
                return

    # -- results --------------------------------------------------------------

    def check(self) -> None:
        """Raise the first recorded violation (inversions first)."""
        with self._mu:
            for v in self._violations:
                if isinstance(v, LockOrderInversion):
                    raise v
            if self._violations:
                raise self._violations[0]

    def report(self) -> dict:
        """The full ledger: observed order edges (with first-seen sites),
        per-lock max hold + acquiring site, acquire counts, violations."""
        with self._mu:
            return {
                "edges": [
                    {"from": a, "to": b, "from_site": sa, "to_site": sb}
                    for (a, b), (sa, sb) in sorted(self._edges.items())
                ],
                "max_hold_s": {
                    name: {"hold_s": round(h, 6), "site": s}
                    for name, (h, s) in sorted(self._max_hold.items())
                },
                "acquires": dict(sorted(self._acquires.items())),
                "violations": [str(v) for v in self._violations],
            }


def audit_host(host, audit: LockAudit) -> LockAudit:
    """Wrap a live :class:`~orp_tpu_torch.serve.host.ServeHost`'s locks —
    host lock (recreating ``_swap_cv`` on the wrapper so waits stay
    audited), pending lock, tier lock, every CURRENT tenant's build lock
    (tenants added later are not wired — call again after ``add_tenant``)
    and the condition of every live tenant's batcher
    (:func:`audit_condition`; a batcher built later is not wired). Build
    locks get no hold budget: they exist to hold construction."""
    host._lock = audit.wrap("ServeHost._lock", host._lock)
    host._swap_cv = threading.Condition(host._lock)
    host._pending_lock = audit.wrap("ServeHost._pending_lock",
                                    host._pending_lock)
    host.tiers._lock = audit.wrap("TierManager._lock", host.tiers._lock)
    with host._lock:
        tenants = list(host._tenants.values())
    for t in tenants:
        t.build_lock = audit.wrap(f"_Tenant.build_lock[{t.name}]",
                                  t.build_lock, hold_budget_s=None)
        batcher = getattr(t, "batcher", None)
        if batcher is not None:
            audit_condition(batcher._cv, audit, f"MicroBatcher._cv[{t.name}]")
    return audit


def audit_condition(cv: threading.Condition, audit: LockAudit,
                    name: str) -> threading.Condition:
    """Route a LIVE ``threading.Condition`` (a running batcher's, whose
    worker may be waiting on it) through ``audit`` in place: its lock and
    the five lock methods CPython copies onto a Condition are swapped for
    the wrapper's, so the next acquire, wait hand-off and notify are
    audited while waiters already parked keep their wake-ups."""
    wrapped = audit.wrap(name, cv._lock)
    cv._lock = wrapped
    cv.acquire = wrapped.acquire
    cv.release = wrapped.release
    cv._release_save = wrapped._release_save
    cv._acquire_restore = wrapped._acquire_restore
    cv._is_owned = wrapped._is_owned
    return cv
