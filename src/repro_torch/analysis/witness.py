"""Runtime lock-order witness -- lockdep-lite.

Each thread keeps a stack of held lock acquisitions. On every *blocking*
acquire the stack is checked against the declared ranks in
:mod:`.lock_order`:

  * an anti-edge hit or a held lock of rank >= the acquired rank raises
    :class:`~repro_torch.analysis.lock_order.LockOrderViolation` (inversion);
  * same-class nesting of a ``multi`` class is allowed but recorded as
    an *instance* edge; closing a cycle in the global instance-edge
    graph (typically across threads: T1 took A then B, T2 takes B then
    A) raises at the acquire that would complete the cycle;
  * ``req.mp_mutex`` under ``req.mp_mutex`` is allowed iff the thread
    holds the target req's rwlock *write grant* (the bailout gate);
  * trylock acquires are never flagged but join the held stack.

Every acquisition also records a class-level edge (held-top -> acquired,
tagged ok/gated/trylock) into a global graph; :func:`dump_graph` emits it
as JSON -- CI uploads this as the observed lock-edge artifact.

Violations both raise *and* latch into a global list: scheduler workers
may swallow task exceptions, so the lockdep CI lane asserts the latch is
empty after every test (see tests/conftest.py).
"""
from __future__ import annotations

import json
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

from .lock_order import (ANTI_EDGES, LOCK_CLASSES, LockClass, LockOrderViolation,
                         raw_lock)

RWLOCK_CLASS = LOCK_CLASSES["req.rwlock"]

_tls = threading.local()

# global state below is guarded by _glock (a raw lock: the witness's own
# bookkeeping is outside the checked universe, by construction)
_glock = raw_lock()
_class_edges: Dict[Tuple[str, str, str], int] = {}   # (src, dst, tag) -> count
_iedges: Dict[int, Set[int]] = {}                    # instance id -> successors
_ilabel: Dict[int, str] = {}                         # instance id -> label
violations: List[str] = []


class _Held:
    __slots__ = ("cls", "rank", "group", "trylock", "write", "iid", "site")

    def __init__(self, cls: str, rank: int, group: object, trylock: bool,
                 write: bool, iid: int, site: str) -> None:
        self.cls = cls
        self.rank = rank
        self.group = group
        self.trylock = trylock
        self.write = write
        self.iid = iid
        self.site = site


def _stack() -> List[_Held]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site(depth: int) -> str:
    try:
        f = sys._getframe(depth)
        return f"{f.f_code.co_filename}:{f.f_lineno}"
    except ValueError:  # pragma: no cover - shallow stack
        return "?"


def _violate(msg: str) -> None:
    with _glock:
        violations.append(msg)
    raise LockOrderViolation(msg)


def _holds_write_grant(held: List[_Held], group: object) -> bool:
    for h in held:
        if h.cls == "req.rwlock" and h.write and h.group == group:
            return True
    return False


def _record_edge(src: Optional[_Held], dst_cls: str, tag: str) -> None:
    key = (src.cls if src is not None else "<none>", dst_cls, tag)
    with _glock:
        _class_edges[key] = _class_edges.get(key, 0) + 1


def _record_instance_edge(src: _Held, dst_iid: int, dst_label: str,
                          site: str) -> None:
    """Add src -> dst to the instance graph; raise if it closes a cycle."""
    with _glock:
        _ilabel.setdefault(src.iid, f"{src.cls}@{src.site}")
        _ilabel.setdefault(dst_iid, dst_label)
        succ = _iedges.setdefault(src.iid, set())
        if dst_iid in succ:
            return
        # would dst -> ... -> src close a cycle?
        seen: Set[int] = set()
        frontier = [dst_iid]
        while frontier:
            n = frontier.pop()
            if n == src.iid:
                path = (f"{_ilabel.get(dst_iid, dst_iid)} ..-> "
                        f"{_ilabel.get(src.iid, src.iid)}")
                msg = (f"lock-order cycle: acquiring {dst_label} at {site} "
                       f"while holding {_ilabel[src.iid]} closes {path} "
                       f"(edge observed on another acquisition order)")
                violations.append(msg)
                raise LockOrderViolation(msg)
            if n in seen:
                continue
            seen.add(n)
            frontier.extend(_iedges.get(n, ()))
        succ.add(dst_iid)


def check_and_push(cls: LockClass, group: object, iid: int,
                   trylock: bool = False, write: bool = False,
                   depth: int = 3) -> None:
    """Order-check an acquisition against the thread's held stack, then
    push it. ``depth`` locates the caller's frame for the site label."""
    held = _stack()
    site = _site(depth)
    label = f"{cls.name}@{site}"
    tag = "trylock" if trylock else "ok"
    top = held[-1] if held else None
    if not trylock:
        for h in held:
            anti = ANTI_EDGES.get((h.cls, cls.name))
            if anti is not None:
                _violate(
                    f"anti-edge {h.cls} -> {cls.name}: acquiring "
                    f"{label} while holding {h.cls}@{h.site} -- {anti}")
            if h.rank > cls.rank:
                _violate(
                    f"rank inversion: acquiring {label} (rank {cls.rank}) "
                    f"while holding {h.cls}@{h.site} (rank {h.rank}); "
                    "blocking acquisitions must strictly ascend in rank")
            if h.rank == cls.rank:
                if (cls.name == "req.mp_mutex"
                        and _holds_write_grant(held, group)):
                    tag = "gated"  # bailout: write grant held
                elif cls.multi:
                    _record_instance_edge(h, iid, label, site)
                else:
                    _violate(
                        f"same-rank nesting: acquiring {label} while "
                        f"holding {h.cls}@{h.site} (both rank {cls.rank}); "
                        "only 'multi' classes and write-grant-gated req "
                        "mutexes may nest at one rank")
    _record_edge(top, cls.name, tag)
    held.append(_Held(cls.name, cls.rank, group, trylock, write, iid, site))


def pop(iid: int) -> None:
    """Remove the most recent held entry for instance ``iid`` (locks are
    not always released LIFO -- e.g. the quiesce mutex bounce)."""
    held = getattr(_tls, "held", None)
    if not held:
        return
    for i in range(len(held) - 1, -1, -1):
        if held[i].iid == iid:
            del held[i]
            return


class WitnessLock:
    """Instrumented ``threading.Lock`` returned by ``named_lock`` when the
    witness is on. Implements ``_is_owned`` so ``threading.Condition``
    delegates ownership checks instead of probing with a trylock (which
    would perturb the held stack); ``Condition.wait`` releases and
    reacquires through :meth:`release`/:meth:`acquire`, so the held stack
    stays accurate across waits."""

    __slots__ = ("_lock", "cls", "group", "_owner")

    def __init__(self, cls: LockClass, group: object = None) -> None:
        self._lock = raw_lock()
        self.cls = cls
        self.group = group
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            # check BEFORE blocking: the point is to report the deadlock
            # instead of hanging in it
            check_and_push(self.cls, self.group, id(self), trylock=False)
            got = self._lock.acquire(True, timeout)
            if not got:  # timeout: undo the push
                pop(id(self))
                return False
        else:
            got = self._lock.acquire(False)
            if not got:
                return False
            check_and_push(self.cls, self.group, id(self), trylock=True)
        self._owner = threading.get_ident()
        return True

    def release(self) -> None:
        self._owner = None
        pop(id(self))
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self.cls.name} group={self.group!r}>"


# ------------------------------------------------------- virtual entities
def push_virtual(cls: LockClass, group: object, iid: int,
                 write: bool = False, trylock: bool = False) -> None:
    """Track a virtual lock entity (the rwlock grant) on the held stack.
    Called from req.py's hooks, which fire OUTSIDE the rwlock's internal
    condition lock so no false cond -> rwlock edge is recorded."""
    check_and_push(cls, group, iid, trylock=trylock, write=write, depth=4)


def pop_virtual(iid: int) -> None:
    pop(iid)


def held_classes() -> List[str]:
    """The calling thread's held stack, outermost first (for tests)."""
    return [h.cls for h in _stack()]


# ------------------------------------------------------------ global state
def clear_violations() -> List[str]:
    """Drain the latched violation list (tests that provoke violations on
    purpose call this in their cleanup). Preserves the edge graphs."""
    with _glock:
        drained = violations[:]
        del violations[:]
    return drained


def reset() -> None:
    """Full reset: latched violations AND both edge graphs."""
    with _glock:
        del violations[:]
        _class_edges.clear()
        _iedges.clear()
        _ilabel.clear()


def dump_graph() -> dict:
    """The observed class-level edge graph + any latched violations, in a
    JSON-serializable shape (the CI lock-edge artifact)."""
    with _glock:
        edges = [
            {"src": s, "dst": d, "tag": t, "count": n}
            for (s, d, t), n in sorted(_class_edges.items())
        ]
        return {"edges": edges, "violations": violations[:]}


def dump_graph_to(path: str) -> None:
    with open(path, "w") as fh:
        json.dump(dump_graph(), fh, indent=2, sort_keys=True)
