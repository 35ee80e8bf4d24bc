"""Trace-driven workload replay (tracehm-style TSV traces).

A trace is a TSV file: one header comment carrying the parameters every
replayer needs to reproduce payloads byte-for-byte, then one op per line:

    # taiji-trace v1 seed=7 ms_bytes=16384 mps_per_ms=8 zero=0.60 comp=0.25
    0	alloc	12	0
    1	touch	0x30800	1
    2	tick	6	0
    3	touch	0x30800	0
    4	upgrade	2	0
    5	free	12	0

Columns are ``seq, op, ms/addr, is_write``:

  * ``alloc``/``free`` -- arg is a trace-level MS *token*; the replayer
    maps tokens to (node, gfn) through the fleet controller's admission
    path, so the trace itself is placement-agnostic.
  * ``touch``  -- arg is a hex address ``token*ms_bytes + mp*mp_bytes``;
    ``is_write`` selects guest write (payload derived deterministically
    from the header seed) vs. guest read (faulting swapped MPs back in).
  * ``tick``   -- arg fleet controller rounds to run (BACK phases: LRU
    aging + staggered reclaim windows).
  * ``upgrade``-- start a rolling hot-upgrade; arg is the per-node drain
    duration in rounds.
  * ``kill``   -- chaos: kill node ``arg``; ``is_write=1`` means drained
    (graceful decommission: MSs live-migrate off first), 0 a hard crash
    (contents lost; the controller re-places committed MSs on the next
    tick).
  * ``recover``-- chaos: bring node ``arg`` back, fresh and empty.
  * ``migrate``-- live-migrate MS token ``arg`` to the least-pressured
    other node (controller placement, read-verified).

Captured application workloads add two *payload* ops with a
fifth column:

    7	wdata	0x30880	1	eJzLSM3JyQcABiwCFQ==
    8	rdata	0x30880	0	64:9c2e5a31

  * ``wdata`` -- a real guest write captured at the access layer
    (:class:`TraceRecorder` on a ``GuestSpace``); the column carries the
    actual bytes (zlib+base64), so replays rewrite the application's
    data -- real KV blocks, expert weights -- byte-identically instead
    of deriving pages from the header seed.
  * ``rdata`` -- a captured guest read; the column carries
    ``nbytes:crc32`` of what the application saw, so every replayed read
    is verified against the capture-time content.

Everything is seeded and single-threaded (round-based), so replaying the
same trace twice yields byte-identical deterministic snapshots -- the
failure schedule is part of the trace, so chaos replays deterministically
too.

Port: a copy of ``repro/fleet/trace.py`` with no framework in it. The
format, the generators and the payload derivation are the reference's
byte for byte, so a trace written by either package replays on the other;
:class:`TraceRecorder` observes the port's :class:`~..core.guest.GuestSpace`.
"""
from __future__ import annotations

import base64
import binascii
import json
import random
import zlib
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..analysis.lock_order import named_lock
from ..core.guest import GuestObserver

TRACE_MAGIC = "taiji-trace v1"

OP_ALLOC = "alloc"
OP_FREE = "free"
OP_TOUCH = "touch"
OP_TICK = "tick"
OP_UPGRADE = "upgrade"
# chaos ops: the failure schedule is part of the trace, so two
# replays of the same trace see byte-identical failures
OP_KILL = "kill"          # arg node_id; is_write=1 -> drained (graceful)
OP_RECOVER = "recover"    # arg node_id
OP_MIGRATE = "migrate"    # arg MS token; controller picks the destination
# captured-workload payload ops: column 5 carries content
OP_WDATA = "wdata"        # arg byte addr; payload = zlib+base64 bytes
OP_RDATA = "rdata"        # arg byte addr; payload = "nbytes:crc32hex"

PAYLOAD_OPS = frozenset((OP_WDATA, OP_RDATA))
_HEX_OPS = frozenset((OP_TOUCH, OP_WDATA, OP_RDATA))

# paper Fig 15c production mix: 76.79% zero pages, 23.21% compressed at
# ~47.63% ratio. The generator defaults add an incompressible tail so the
# backend's raw branch is exercised too.
DEFAULT_ZERO_FRAC = 0.60
DEFAULT_COMP_FRAC = 0.25

K_PAGE_ZERO, K_PAGE_COMP, K_PAGE_RAND = "zero", "comp", "rand"


# --------------------------------------------------------------- payloads
def _page_hash(seed: int, token: int, mp: int) -> int:
    return zlib.crc32(f"{seed}/{token}/{mp}".encode())


def page_kind(seed: int, token: int, mp: int,
              zero_frac: float, comp_frac: float) -> str:
    """Deterministic page class for (trace, token, mp) -- no RNG state."""
    u = (_page_hash(seed, token, mp) & 0xFFFFFF) / float(1 << 24)
    if u < zero_frac:
        return K_PAGE_ZERO
    if u < zero_frac + comp_frac:
        return K_PAGE_COMP
    return K_PAGE_RAND


def page_bytes(seed: int, token: int, mp: int, mp_bytes: int,
               zero_frac: float, comp_frac: float) -> bytes:
    """The payload a ``touch`` write carries: purely a function of the
    trace header + address, so generator, replayer and verifier agree."""
    kind = page_kind(seed, token, mp, zero_frac, comp_frac)
    if kind == K_PAGE_ZERO:
        return bytes(mp_bytes)
    h = _page_hash(seed, token, mp)
    rng = np.random.default_rng(h)
    if kind == K_PAGE_COMP:
        # ~50%-compressible: structured half + incompressible half
        structured = np.full(mp_bytes // 2, h & 0xFF, np.uint8)
        noise = rng.integers(0, 256, mp_bytes - mp_bytes // 2, dtype=np.int64)
        return structured.tobytes() + noise.astype(np.uint8).tobytes()
    return rng.integers(0, 256, mp_bytes, dtype=np.int64).astype(
        np.uint8).tobytes()


def touch_addr(token: int, mp: int, ms_bytes: int, mp_bytes: int) -> int:
    return token * ms_bytes + mp * mp_bytes


# ------------------------------------------------------------------ format
class TraceHeader:
    def __init__(self, seed: int, ms_bytes: int, mps_per_ms: int,
                 zero_frac: float, comp_frac: float) -> None:
        if mps_per_ms < 1:
            raise ValueError(f"mps_per_ms must be >= 1, got {mps_per_ms}")
        if ms_bytes <= 0 or ms_bytes % mps_per_ms:
            raise ValueError(
                f"ms_bytes ({ms_bytes}) must be a positive multiple of "
                f"mps_per_ms ({mps_per_ms})")
        self.seed = seed
        self.ms_bytes = ms_bytes
        self.mps_per_ms = mps_per_ms
        self.mp_bytes = ms_bytes // mps_per_ms
        self.zero_frac = zero_frac
        self.comp_frac = comp_frac

    def line(self) -> str:
        return (f"# {TRACE_MAGIC} seed={self.seed} ms_bytes={self.ms_bytes} "
                f"mps_per_ms={self.mps_per_ms} zero={self.zero_frac:.6g} "
                f"comp={self.comp_frac:.6g}")

    @classmethod
    def parse(cls, line: str) -> "TraceHeader":
        if TRACE_MAGIC not in line:
            raise ValueError(f"not a taiji trace header: {line!r}")
        kv = dict(tok.split("=", 1) for tok in line.split() if "=" in tok)
        try:
            return cls(seed=int(kv["seed"]), ms_bytes=int(kv["ms_bytes"]),
                       mps_per_ms=int(kv["mps_per_ms"]),
                       zero_frac=float(kv["zero"]),
                       comp_frac=float(kv["comp"]))
        except KeyError as e:
            raise ValueError(
                f"trace header missing key {e.args[0]}: {line!r}") from None
        except ValueError as e:
            raise ValueError(f"malformed trace header {line!r}: {e}") from None


def format_line(seq: int, op: str, arg: int, is_write: int,
                payload: str = "") -> str:
    arg_s = f"0x{arg:x}" if op in _HEX_OPS else str(arg)
    if op in PAYLOAD_OPS:
        return f"{seq}\t{op}\t{arg_s}\t{is_write}\t{payload}"
    return f"{seq}\t{op}\t{arg_s}\t{is_write}"


def parse_line(line: str) -> Tuple[int, str, int, int, str]:
    """Parse one op line into ``(seq, op, arg, is_write, payload)``.

    ``payload`` is the fifth column of the captured-workload ops
    (``wdata``/``rdata``) and ``""`` otherwise; a fifth column on any
    other op -- or a payload op without one -- is malformed.
    """
    parts = line.rstrip("\n").split("\t")
    if len(parts) not in (4, 5):
        raise ValueError(
            f"malformed trace line (want 4 or 5 tab-separated columns, "
            f"got {len(parts)}): {line!r}")
    seq_s, op, arg_s, w_s = parts[:4]
    payload = parts[4] if len(parts) == 5 else ""
    if (len(parts) == 5) != (op in PAYLOAD_OPS) or (op in PAYLOAD_OPS
                                                    and not payload):
        raise ValueError(
            f"payload column is required for {sorted(PAYLOAD_OPS)} ops "
            f"and forbidden otherwise: {line!r}")
    try:
        seq = int(seq_s)
        arg = int(arg_s, 16 if arg_s.startswith("0x") else 10)
        w = int(w_s)
    except ValueError as e:
        raise ValueError(f"malformed trace line {line!r}: {e}") from None
    if w not in (0, 1):
        raise ValueError(f"is_write must be 0 or 1 in {line!r}")
    return seq, op, arg, w, payload


def encode_payload(data: bytes) -> str:
    """Write payload wire form: zlib+base64 (tab-free single token)."""
    return base64.b64encode(zlib.compress(bytes(data), 6)).decode("ascii")


def decode_payload(payload: str) -> bytes:
    try:
        return zlib.decompress(base64.b64decode(payload, validate=True))
    except (binascii.Error, zlib.error, ValueError) as e:
        raise ValueError(f"malformed wdata payload: {e}") from None


def encode_read_check(data: bytes) -> str:
    """Read-verify wire form: ``nbytes:crc32hex`` of the bytes read."""
    return f"{len(data)}:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def decode_read_check(payload: str) -> Tuple[int, int]:
    try:
        nbytes_s, crc_s = payload.split(":", 1)
        nbytes, crc = int(nbytes_s), int(crc_s, 16)
    except ValueError as e:
        raise ValueError(f"malformed rdata check: {e}") from None
    if nbytes < 0:
        raise ValueError(f"malformed rdata check (negative size): {payload!r}")
    return nbytes, crc


# --------------------------------------------------------------- generator
class TraceGen:
    """Synthesizes the paper's workload shapes as a seeded trace.

    Phases compose: FRONT fill (allocs + page-mix writes), BACK aging
    (ticks that age the LRU and fire staggered reclaim windows), fault
    bursts (Zipf-popular reads over the filled set, faulting swapped MPs
    back in), churn (free/realloc) and a rolling hot-upgrade marker.
    """

    def __init__(self, seed: int, ms_bytes: int, mps_per_ms: int,
                 zero_frac: float = DEFAULT_ZERO_FRAC,
                 comp_frac: float = DEFAULT_COMP_FRAC) -> None:
        self.header = TraceHeader(seed, ms_bytes, mps_per_ms,
                                  zero_frac, comp_frac)
        self._rng = random.Random(seed)
        self._ops: List[Tuple[str, int, int]] = []
        self._next_token = 0
        self._live: List[int] = []

    # ------------------------------------------------------------- phases
    def front_fill(self, n_ms: int, write_frac: float = 1.0) -> List[int]:
        """FRONT phase: allocate ``n_ms`` sections, write the page mix."""
        hdr = self.header
        tokens = []
        for _ in range(n_ms):
            token = self._next_token
            self._next_token += 1
            self._ops.append((OP_ALLOC, token, 0))
            self._live.append(token)
            tokens.append(token)
            for mp in range(hdr.mps_per_ms):
                if write_frac >= 1.0 or self._rng.random() < write_frac:
                    addr = touch_addr(token, mp, hdr.ms_bytes, hdr.mp_bytes)
                    self._ops.append((OP_TOUCH, addr, 1))
        return tokens

    def back_phase(self, n_ticks: int) -> None:
        """BACK phase: controller rounds only (aging + reclaim windows)."""
        self._ops.append((OP_TICK, n_ticks, 0))

    def fault_burst(self, n_touches: int, zipf_a: float = 1.2,
                    tick_every: int = 0) -> None:
        """Read burst with Zipf MS popularity and sequential MP locality."""
        hdr = self.header
        if not self._live:
            return
        ranks = np.arange(1, len(self._live) + 1, dtype=np.float64)
        pop = 1.0 / ranks ** zipf_a
        weights = list(pop / pop.sum())
        cursor: Dict[int, int] = {}
        for i in range(n_touches):
            token = self._rng.choices(self._live, weights=weights)[0]
            mp = cursor.get(token, 0) % hdr.mps_per_ms
            cursor[token] = mp + 1
            addr = touch_addr(token, mp, hdr.ms_bytes, hdr.mp_bytes)
            self._ops.append((OP_TOUCH, addr, 0))
            if tick_every and (i + 1) % tick_every == 0:
                self._ops.append((OP_TICK, 1, 0))

    def churn(self, n_frees: int, n_allocs: int) -> None:
        """Free a seeded sample, then re-allocate fresh sections."""
        n_frees = min(n_frees, len(self._live))
        for token in self._rng.sample(self._live, n_frees):
            self._live.remove(token)
            self._ops.append((OP_FREE, token, 0))
        self.front_fill(n_allocs)

    def rolling_upgrade(self, drain_rounds: int = 2,
                        settle_ticks: int = 8) -> None:
        """Rolling hot-upgrade marker + enough ticks to complete it."""
        self._ops.append((OP_UPGRADE, drain_rounds, 0))
        if settle_ticks:
            self._ops.append((OP_TICK, settle_ticks, 0))

    # -------------------------------------------------------- chaos phases
    def kill_node(self, node_id: int, *, drain: bool = False,
                  settle_ticks: int = 2) -> None:
        """Chaos op: kill a node (``drain`` = migrate its MSs off first);
        the settle ticks let the controller run failure recovery."""
        self._ops.append((OP_KILL, node_id, 1 if drain else 0))
        if settle_ticks:
            self._ops.append((OP_TICK, settle_ticks, 0))

    def recover_node(self, node_id: int, settle_ticks: int = 1) -> None:
        """Chaos op: bring a killed node back (fresh and empty)."""
        self._ops.append((OP_RECOVER, node_id, 0))
        if settle_ticks:
            self._ops.append((OP_TICK, settle_ticks, 0))

    def migrate(self, token: int) -> None:
        """Live-migrate one MS token (replay-side controller placement)."""
        self._ops.append((OP_MIGRATE, token, 0))

    def migrate_sample(self, n: int) -> List[int]:
        """Migrate a seeded sample of live tokens."""
        n = min(n, len(self._live))
        tokens = self._rng.sample(self._live, n)
        for token in tokens:
            self.migrate(token)
        return tokens

    # -------------------------------------------------------------- output
    def lines(self) -> List[str]:
        out = [self.header.line()]
        out.extend(format_line(i, op, arg, w)
                   for i, (op, arg, w) in enumerate(self._ops))
        return out

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.lines()) + "\n")

    @property
    def n_ops(self) -> int:
        return len(self._ops)


class _Coverage:
    """Merged, sorted, disjoint ``[start, end)`` byte intervals of one MS
    whose replay-side content is known (written during capture, or
    zero-filled by a capture-time alloc)."""

    __slots__ = ("iv",)

    def __init__(self, iv: Optional[List[Tuple[int, int]]] = None) -> None:
        self.iv: List[Tuple[int, int]] = iv or []

    def add(self, start: int, end: int) -> None:
        if end <= start:
            return
        merged: List[Tuple[int, int]] = []
        for s, e in self.iv:
            if e < start or s > end:         # disjoint (touching merges)
                merged.append((s, e))
            else:
                start, end = min(s, start), max(e, end)
        merged.append((start, end))
        merged.sort()
        self.iv = merged

    def gaps(self, start: int, end: int) -> List[Tuple[int, int]]:
        """Uncovered subranges of ``[start, end)``, in order."""
        out: List[Tuple[int, int]] = []
        cur = start
        for s, e in self.iv:
            if e <= cur:
                continue
            if s >= end:
                break
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
            if cur >= end:
                return out
        if cur < end:
            out.append((cur, end))
        return out


class TraceRecorder(GuestObserver):
    """Capture observer: renders live guest traffic on a ``GuestSpace``
    into a replayable fleet trace (tracehm's record-at-the-access-layer
    design).

    Attach to the canonical space of the system an application drives::

        rec = space.attach(TraceRecorder.for_space(space))
        ... run the serving loop ...
        lines = rec.lines()            # replayable on any fleet

    Allocs/frees become placement-agnostic token ops; writes become
    ``wdata`` ops carrying the application's actual bytes; reads become
    ``rdata`` ops carrying a content hash, so a replay verifies every
    read against what the application really saw; zero-length residency
    hints (batched touch, step pins) become ``touch`` reads; background
    rounds become ``tick`` ops.

    Partial captures replay byte-identically: an MS allocated *before*
    capture started is registered lazily on first access with empty
    write coverage, and a read of any not-yet-covered range first emits
    a ``wdata`` re-establishing the observed bytes -- the replay cannot
    know pre-capture content any other way.  MSs allocated during
    capture start fully covered (alloc zero-fills on both sides).
    """

    def __init__(self, ms_bytes: int, mps_per_ms: int, *,
                 seed: int = 0) -> None:
        # zero/comp fracs are meaningless for captured payloads; the
        # header keeps them only so seed-derived touch writes (if any
        # are spliced in) stay well-defined
        self.header = TraceHeader(seed, ms_bytes, mps_per_ms, 0.0, 0.0)
        self._lock = named_lock("metrics")
        self._token: Dict[int, int] = {}     # live gfn -> trace token
        self._cov: Dict[int, _Coverage] = {}  # token -> known-content ranges
        self._next_token = 0
        self._ops: List[Tuple[str, int, int, str]] = []

    @classmethod
    def for_space(cls, space, *, seed: int = 0) -> "TraceRecorder":
        return cls(space.cfg.ms_bytes, space.cfg.mps_per_ms, seed=seed)

    # ------------------------------------------------------ observer hooks
    def on_alloc(self, gfn: int) -> None:
        with self._lock:
            # a capture-time alloc is zero-filled at replay too: the
            # whole MS counts as known content
            self._register(gfn, covered=True)

    def on_free(self, gfn: int) -> None:
        with self._lock:
            token = self._token.pop(gfn, None)
            if token is not None:
                self._cov.pop(token, None)
                self._ops.append((OP_FREE, token, 0, ""))

    def on_access(self, gfn: int, off: int, nbytes: int, is_write: bool,
                  data: Optional[bytes] = None) -> None:
        with self._lock:
            token = self._token_of(gfn)
            addr = token * self.header.ms_bytes + off
            if nbytes == 0:                  # residency hint (touch / pin)
                self._ops.append((OP_TOUCH, addr, 0, ""))
                return
            cov = self._cov[token]
            if is_write:
                cov.add(off, off + nbytes)
                self._ops.append((OP_WDATA, addr, 1, encode_payload(data)))
                return
            # pre-capture content (lazily-registered MS, or any range no
            # recorded write covers) must be re-established before the
            # read can verify -- emit the observed bytes as wdata first
            for gs, ge in cov.gaps(off, off + nbytes):
                self._ops.append((
                    OP_WDATA, token * self.header.ms_bytes + gs, 1,
                    encode_payload(data[gs - off:ge - off])))
            cov.add(off, off + nbytes)
            self._ops.append((OP_RDATA, addr, 0, encode_read_check(data)))

    def on_tick(self, rounds: int) -> None:
        with self._lock:
            self._ops.append((OP_TICK, rounds, 0, ""))

    def _register(self, gfn: int, *, covered: bool) -> int:
        token = self._next_token
        self._next_token += 1
        self._token[gfn] = token
        self._cov[token] = _Coverage(
            [(0, self.header.ms_bytes)] if covered else None)
        self._ops.append((OP_ALLOC, token, 0, ""))
        return token

    def _token_of(self, gfn: int) -> int:
        token = self._token.get(gfn)
        if token is None:                    # allocated before capture began
            token = self._register(gfn, covered=False)
        return token

    # -------------------------------------------------------------- output
    def lines(self) -> List[str]:
        with self._lock:
            return [self.header.line()] + [
                format_line(i, op, arg, w, payload)
                for i, (op, arg, w, payload) in enumerate(self._ops)]

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.lines()) + "\n")

    @property
    def n_ops(self) -> int:
        with self._lock:
            return len(self._ops)

    def op_counts(self) -> Dict[str, int]:
        """Recorded ops by kind (e.g. ``{"alloc": 3, "wdata": 12, ...}``)."""
        with self._lock:
            counts: Dict[str, int] = {}
            for op, _arg, _w, _payload in self._ops:
                counts[op] = counts.get(op, 0) + 1
            return counts


class TraceReplayer:
    """Deterministic seeded trace replay through a fleet controller.

    Single-threaded, round-based: trace lines are applied in order, so
    two replays of the same trace through identically-configured fleets
    produce byte-identical deterministic snapshots. Placement is decided
    live by the controller's admission path; tokens that were rejected at
    admission simply drop their later touches (counted, like a guest VM
    that was never scheduled onto the fleet).
    """

    def __init__(self, controller, lines: Iterable[str], *,
                 upgrade_module_cls=None, verify_reads: bool = True) -> None:
        from ..core.hotupgrade import EngineModuleV2
        from .controller import REJECT_NO_CAPACITY, REJECT_OVERCOMMIT
        from .node import NodeDeadError, NodeNotServingError
        self._not_serving_exc = NodeNotServingError
        self._dead_exc = NodeDeadError
        self.controller = controller
        self.upgrade_module_cls = upgrade_module_cls or EngineModuleV2
        self.verify_reads = verify_reads
        # failure recovery + drain migrations remap (node, gfn) pairs; the
        # listener keeps the token map and the written-set in sync
        controller.remap_listener = self._on_remap

        lines = [ln for ln in lines if ln.strip()]
        if not lines or not lines[0].startswith("#"):
            raise ValueError("trace must start with a header comment")
        self.header = TraceHeader.parse(lines[0])
        self._body = [ln for ln in lines[1:] if not ln.startswith("#")]

        self.placed: Dict[int, Tuple[object, int]] = {}   # token -> (node, gfn)
        self._loc: Dict[Tuple[int, int], int] = {}  # (node_id, gfn) -> token
        # token -> written MP set: keyed by token so frees, hard-kill
        # re-placements and losses forget a whole token in one pop
        self.written: Dict[int, Set[int]] = {}
        # tokens whose captured payload content died with a node (hard
        # kill re-placed them as fresh zeroed MSs): rdata content checks
        # must not expect the capture-time bytes any more
        self.payload_lost: Set[int] = set()
        self.counters: Dict[str, int] = {
            "ops": 0, "allocs": 0, "frees": 0, "reads": 0, "writes": 0,
            "ticks": 0, "upgrades": 0, "touch_unplaced": 0,
            "touch_not_serving": 0, "free_not_serving": 0,
            "verify_failures": 0,
            "payload_writes": 0, "payload_reads": 0,
            "payload_verify_skipped": 0,
            "kills": 0, "recovers": 0,
            "migrations": 0, "migrate_rejected": 0, "migrate_unplaced": 0,
            "touch_dead": 0, "free_dead": 0,
            "ms_migrated": 0, "ms_replaced": 0, "ms_lost": 0,
            "reject_" + REJECT_OVERCOMMIT: 0,
            "reject_" + REJECT_NO_CAPACITY: 0,
        }

    # --------------------------------------------------------------- replay
    def run(self) -> Dict[str, object]:
        for line in self._body:
            _seq, op, arg, is_write, payload = parse_line(line)
            self.counters["ops"] += 1
            if op == OP_ALLOC:
                self._op_alloc(arg)
            elif op == OP_FREE:
                self._op_free(arg)
            elif op == OP_TOUCH:
                self._op_touch(arg, is_write)
            elif op == OP_WDATA:
                self._op_wdata(arg, payload)
            elif op == OP_RDATA:
                self._op_rdata(arg, payload)
            elif op == OP_TICK:
                for _ in range(arg):
                    self.controller.tick()
                self.counters["ticks"] += arg
            elif op == OP_UPGRADE:
                self.controller.start_rolling_upgrade(
                    self.upgrade_module_cls, drain_rounds=arg)
                self.counters["upgrades"] += 1
            elif op == OP_KILL:
                self.controller.kill_node(arg, drain=bool(is_write))
                self.counters["kills"] += 1
            elif op == OP_RECOVER:
                self.controller.recover_node(arg)
                self.counters["recovers"] += 1
            elif op == OP_MIGRATE:
                self._op_migrate(arg)
            else:
                raise ValueError(f"unknown trace op {op!r}: {line!r}")
        return self.result()

    # -------------------------------------------------------- chaos remaps
    def _on_remap(self, src_node, old_gfn: int, dst_node,
                  new_gfn, preserved: bool) -> None:
        """Controller notification: an MS moved (migration, preserved) or
        was re-placed fresh / lost (failure recovery)."""
        token = self._loc.pop((src_node.node_id, old_gfn), None)
        if token is None:
            return                       # not a replayer-tracked MS
        if dst_node is None:             # lost with the node: no capacity
            self.placed.pop(token, None)
            self.counters["ms_lost"] += 1
            self.written.pop(token, None)
            self.payload_lost.discard(token)
            return
        self.placed[token] = (dst_node, new_gfn)
        self._loc[(dst_node.node_id, new_gfn)] = token
        if preserved:
            self.counters["ms_migrated"] += 1
        else:
            # hard-kill re-placement: a fresh zeroed MS -- prior writes
            # are gone, so read-verify (seed-derived AND captured-payload
            # content checks) must not expect them
            self.counters["ms_replaced"] += 1
            self.written.pop(token, None)
            self.payload_lost.add(token)

    def _op_migrate(self, token: int) -> None:
        placed = self.placed.get(token)
        if placed is None:
            self.counters["migrate_unplaced"] += 1
            return
        node, gfn = placed
        dst, _new_gfn, _reason = self.controller.migrate_ms(node, gfn)
        if dst is None:
            self.counters["migrate_rejected"] += 1
        else:
            self.counters["migrations"] += 1   # map updated via _on_remap

    def _op_alloc(self, token: int) -> None:
        node, gfn, reason = self.controller.admit_alloc()
        self.counters["allocs"] += 1
        if node is None:
            key = "reject_" + reason
            self.counters[key] = self.counters.get(key, 0) + 1
            return
        self.placed[token] = (node, gfn)
        self._loc[(node.node_id, gfn)] = token

    def _op_free(self, token: int) -> None:
        placed = self.placed.pop(token, None)
        if placed is None:
            return
        node, gfn = placed
        try:
            node.free_ms_gfn(gfn)
        except self._dead_exc:
            # the owner died and recovery has not settled yet: the free is
            # lost traffic; the tick-driven re-placement will remap it
            self.counters["free_dead"] += 1
            self.placed[token] = placed
            return
        except self._not_serving_exc:
            # the owner is draining: the free is lost traffic, like any
            # other op against a mid-upgrade node; its data stays live
            self.counters["free_not_serving"] += 1
            self.placed[token] = placed
            return
        self.counters["frees"] += 1
        self._loc.pop((node.node_id, gfn), None)
        self.written.pop(token, None)
        self.payload_lost.discard(token)

    def _op_touch(self, addr: int, is_write: int) -> None:
        hdr = self.header
        token = addr // hdr.ms_bytes
        mp = (addr % hdr.ms_bytes) // hdr.mp_bytes
        placed = self.placed.get(token)
        if placed is None:
            self.counters["touch_unplaced"] += 1
            return
        node, gfn = placed
        try:
            if is_write:
                node.write_mp(gfn, mp, page_bytes(
                    hdr.seed, token, mp, hdr.mp_bytes,
                    hdr.zero_frac, hdr.comp_frac))
                self.written.setdefault(token, set()).add(mp)
                self.counters["writes"] += 1
            else:
                got = node.read_mp(gfn, mp)
                self.counters["reads"] += 1
                if self.verify_reads and mp in self.written.get(token, ()):
                    want = page_bytes(hdr.seed, token, mp, hdr.mp_bytes,
                                      hdr.zero_frac, hdr.comp_frac)
                    if got != want:
                        self.counters["verify_failures"] += 1
        except self._dead_exc:
            self.counters["touch_dead"] += 1
        except self._not_serving_exc:
            self.counters["touch_not_serving"] += 1

    # ------------------------------------------------- captured payload ops
    def _locate(self, addr: int):
        """(node, gfn, byte offset) for a captured payload address, or
        ``None`` (counted like any other unplaced touch)."""
        token, off = divmod(addr, self.header.ms_bytes)
        placed = self.placed.get(token)
        if placed is None:
            self.counters["touch_unplaced"] += 1
            return None
        node, gfn = placed
        return node, gfn, off

    def _op_wdata(self, addr: int, payload: str) -> None:
        loc = self._locate(addr)
        if loc is None:
            return
        node, gfn, off = loc
        data = decode_payload(payload)
        try:
            node.write_at(gfn, off, data)
        except self._dead_exc:
            self.counters["touch_dead"] += 1
            return
        except self._not_serving_exc:
            self.counters["touch_not_serving"] += 1
            return
        self.counters["payload_writes"] += 1

    def _op_rdata(self, addr: int, payload: str) -> None:
        nbytes, crc = decode_read_check(payload)
        loc = self._locate(addr)
        if loc is None:
            return
        node, gfn, off = loc
        try:
            got = node.read_at(gfn, off, nbytes)
        except self._dead_exc:
            self.counters["touch_dead"] += 1
            return
        except self._not_serving_exc:
            self.counters["touch_not_serving"] += 1
            return
        self.counters["payload_reads"] += 1
        if not self.verify_reads:
            return
        if addr // self.header.ms_bytes in self.payload_lost:
            # the token's content died in a hard kill and was re-placed
            # zeroed: a capture-time hash cannot match, and that is the
            # correct replay outcome, not a data-integrity failure
            self.counters["payload_verify_skipped"] += 1
            return
        if zlib.crc32(got) & 0xFFFFFFFF != crc:
            self.counters["verify_failures"] += 1

    # --------------------------------------------------------------- result
    def result(self) -> Dict[str, object]:
        snap = self.controller.snapshot()
        snap["deterministic"]["replay"] = dict(sorted(self.counters.items()))
        return snap

    def deterministic_bytes(self) -> bytes:
        return json.dumps(self.result()["deterministic"],
                          sort_keys=True).encode()


class FailureSchedule:
    """Seeded chaos plan: which nodes die (drained or hard), which come
    back, and how many live MSs migrate.

    The plan is derived purely from ``(seed, n_nodes)`` and rendered into
    trace ops, so the failure schedule travels with the trace: replaying
    the same file replays the same failures at the same points, and the
    determinism contract extends over chaos by construction.
    """

    def __init__(self, seed: int, n_nodes: int, *, kills: int = 1,
                 drain_frac: float = 0.5, recover: bool = True,
                 migrations: int = 0) -> None:
        if n_nodes < 2:
            raise ValueError("a chaos schedule needs >= 2 nodes (a survivor)")
        rng = random.Random(seed)
        self.seed = seed
        self.n_nodes = n_nodes
        self.migrations = migrations
        kills = min(kills, n_nodes - 1)          # someone must survive
        victims = rng.sample(range(n_nodes), kills)
        self.kill_events: List[Tuple[int, bool]] = [
            (v, rng.random() < drain_frac) for v in victims]
        self.recover_nodes: List[int] = list(victims) if recover else []


def chaos_trace(seed: int, ms_bytes: int, mps_per_ms: int, n_nodes: int, *,
                fill_ms: int, burst: int, kills: int = 1,
                migrations: int = 2, drain_frac: float = 0.5,
                recover: bool = True,
                zero_frac: float = DEFAULT_ZERO_FRAC,
                comp_frac: float = DEFAULT_COMP_FRAC) -> TraceGen:
    """The canonical chaos scenario: fill + age (so the fleet holds a
    mixed resident/swapped population), live-migrate a seeded sample of
    MSs, fault-burst, kill nodes mid-replay (drained and hard per the
    seeded schedule), burst over the survivors, recover, and burst again
    against the rebuilt fleet."""
    gen = TraceGen(seed, ms_bytes, mps_per_ms, zero_frac, comp_frac)
    sched = FailureSchedule(seed ^ 0xC4A05, n_nodes, kills=kills,
                            drain_frac=drain_frac, recover=recover,
                            migrations=migrations)
    gen.front_fill(fill_ms)
    gen.back_phase(8)                       # age to COLD + reclaim windows
    gen.migrate_sample(sched.migrations)    # live migration under load
    gen.fault_burst(burst // 3, tick_every=48)
    for node_id, drain in sched.kill_events:
        gen.kill_node(node_id, drain=drain)
    gen.fault_burst(burst // 3, tick_every=48)
    for node_id in sched.recover_nodes:
        gen.recover_node(node_id)
    gen.back_phase(4)
    gen.fault_burst(burst - 2 * (burst // 3), tick_every=64)
    return gen


def paper_trace(seed: int, ms_bytes: int, mps_per_ms: int, *,
                fill_ms: int, burst: int, churn_frees: int = 0,
                upgrade: bool = True,
                zero_frac: float = DEFAULT_ZERO_FRAC,
                comp_frac: float = DEFAULT_COMP_FRAC) -> TraceGen:
    """The canonical scenario: fill past the fleet admission cap, age +
    reclaim, fault-burst, churn, then one rolling hot-upgrade and a
    second burst against the upgraded modules."""
    gen = TraceGen(seed, ms_bytes, mps_per_ms, zero_frac, comp_frac)
    gen.front_fill(fill_ms)
    gen.back_phase(8)                       # age to COLD + reclaim windows
    gen.fault_burst(burst, tick_every=48)   # faults vs. staggered BACK
    if churn_frees:
        gen.churn(churn_frees, churn_frees // 2)
        gen.back_phase(4)
    if upgrade:
        gen.rolling_upgrade(drain_rounds=2)
        gen.fault_burst(burst // 2, tick_every=64)
    return gen
