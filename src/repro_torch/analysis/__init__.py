"""Static + runtime concurrency discipline for the swap path.

One source of truth, checked two ways:

  * :mod:`.lock_order` -- the declared lock hierarchy. Every lock class in
    the system has a name and a rank here; ``named_lock`` is the zero-cost
    construction wrapper the rest of the tree uses.
  * the AST static lint stays in the reference package and is run over
    this one (``python -m repro.analysis.lint src/repro_torch``): rank
    violations visible lexically, blocking calls under the MP mutex, bare
    ``threading.Lock()`` construction outside the registry, and
    deprecated ``TaijiSystem.read/write/ms_addr`` shim calls.
  * :mod:`.witness` -- the runtime lock-order witness (lockdep-lite).
    ``TAIJI_LOCKDEP=1`` makes ``named_lock`` return instrumented locks that
    record per-thread acquisition stacks, build the observed rank-edge
    graph, and raise on inversion or cross-thread cycle formation.
"""
from .lock_order import (  # noqa: F401
    ANTI_EDGES,
    LOCK_CLASSES,
    LockOrderViolation,
    STATE,
    disable,
    enable,
    named_lock,
)
