"""AST concurrency lint over the port's own lock hierarchy.

A copy of ``repro/analysis/lint.py`` that reads the ranks, bindings and
anti-edges of :mod:`repro_torch.analysis.lock_order`, so the lock
classes only the port declares (``backend.staging``, ``kernels.build``,
``guard``) are rank-checked too. Run as::

    python -m repro_torch.analysis.lint src/repro_torch

Walks every ``*.py`` under the given paths and reports, with
``path:line:col CODE`` findings:

  * **TJL001** -- a lock acquisition whose *lexical* ``with``-stack (or
    ``.acquire()``/``.release()`` bracket) violates the declared ranks in
    :mod:`.lock_order`, including the declared anti-edges.
  * **TJL002** -- a known-blocking call (``time.sleep``,
    ``zlib.compress``/``decompress``, a foreign condvar ``.wait``) inside
    a lexical scope holding a ``NO_BLOCKING_UNDER`` class (the MP mutex:
    the fault fast path's latency budget).
  * **TJL003** -- bare ``threading.Lock()``/``RLock``/``Semaphore`` (or
    zero-arg ``Condition()``) construction outside the registry: every
    lock must be built via ``named_lock`` so it carries a declared class.
  * **TJL004** -- calls to the deprecated ``TaijiSystem.read/write/
    ms_addr`` shims (``GuestSpace`` replaced them).

Lock expressions are resolved through ``LINT_BINDINGS`` (attribute name,
scoped by enclosing class), simple local aliases (``lock =
req.mp_mutex``), and an explicit trailing pragma comment on the line::

    with reqs._lock:   # lock: req.tree

Unresolvable expressions are skipped -- cross-function nesting is the
runtime witness's job; the lint never guesses.
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .lock_order import (
    ANTI_EDGES,
    BLOCKING_CALLS,
    LINT_BINDINGS,
    LOCK_CLASSES,
    NO_BLOCKING_UNDER,
    RANK,
)

# the registry implementation itself constructs the raw locks
_REGISTRY_FILES = ("lock_order.py", "witness.py")
_BARE_CTORS = ("Lock", "RLock", "Semaphore", "BoundedSemaphore")
_DEPRECATED_SHIMS = ("read", "write")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col} {self.code} {self.message}"


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self._class_stack: List[str] = []
        # lexical held stack: (lock class, receiver base name) -- the
        # base distinguishes `req.mp_cond` from `other.mp_cond` for the
        # same-cond wait exemption
        self._held: List[Tuple[str, Optional[str]]] = []
        self._aliases: Dict[str, str] = {}  # local name -> lock class
        self._in_analysis_pkg = any(
            path.replace("\\", "/").endswith("repro_torch/analysis/" + f)
            for f in _REGISTRY_FILES)

    # ------------------------------------------------------------- helpers
    def _emit(self, node: ast.AST, code: str, message: str) -> None:
        self.findings.append(Finding(
            self.path, node.lineno, node.col_offset, code, message))

    def _pragma_class(self, node: ast.AST) -> Optional[str]:
        line = self.lines[node.lineno - 1] if node.lineno <= len(self.lines) \
            else ""
        marker = "# lock:"
        i = line.find(marker)
        if i < 0:
            return None
        name = line[i + len(marker):].strip().split()[0]
        return name if name in LOCK_CLASSES else None

    def _resolve(self, expr: ast.AST) -> Optional[str]:
        """Map a lock expression to a declared class name, or None."""
        if isinstance(expr, ast.Subscript):
            return self._resolve(expr.value)
        if isinstance(expr, ast.Name):
            return self._aliases.get(expr.id)
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if (isinstance(expr.value, ast.Name)
                    and expr.value.id == "self" and self._class_stack):
                cls = LINT_BINDINGS.get((self._class_stack[-1], attr))
                if cls is not None:
                    return cls
            return LINT_BINDINGS.get((None, attr))
        return None

    def _check_acquire(self, node: ast.AST, cls: str) -> None:
        """TJL001: rank/anti-edge check against the lexical held stack."""
        for held, _base in self._held:
            anti = ANTI_EDGES.get((held, cls))
            if anti is not None:
                self._emit(node, "TJL001",
                           f"anti-edge: acquiring '{cls}' while holding "
                           f"'{held}' -- {anti}")
                return
            if RANK[held] > RANK[cls]:
                self._emit(node, "TJL001",
                           f"rank inversion: acquiring '{cls}' (rank "
                           f"{RANK[cls]}) while holding '{held}' (rank "
                           f"{RANK[held]})")
                return
            if RANK[held] == RANK[cls] and not LOCK_CLASSES[cls].multi:
                self._emit(node, "TJL001",
                           f"same-rank nesting: acquiring '{cls}' while "
                           f"holding '{held}' (both rank {RANK[cls]}); "
                           "only the runtime witness can prove this safe "
                           "(write-grant gate)")
                return

    # -------------------------------------------------------- scope plumbing
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def _visit_function(self, node) -> None:
        held, aliases = self._held, self._aliases
        self._held, self._aliases = [], {}
        self.generic_visit(node)
        self._held, self._aliases = held, aliases

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Assign(self, node: ast.Assign) -> None:
        # simple alias:  lock = req.mp_mutex
        if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            cls = (self._pragma_class(node)
                   or (self._resolve(node.value)
                       if isinstance(node.value,
                                     (ast.Attribute, ast.Subscript, ast.Name))
                       else None))
            if cls is not None:
                self._aliases[node.targets[0].id] = cls
        self.generic_visit(node)

    # ------------------------------------------------------------ with-stack
    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        pragma = self._pragma_class(node)
        for item in node.items:
            cls = pragma or self._resolve(item.context_expr)
            if cls is None:
                continue
            self._check_acquire(item.context_expr, cls)
            self._held.append((cls, self._base_of(item.context_expr)))
            pushed += 1
        for child in node.body:
            self.visit(child)
        del self._held[len(self._held) - pushed:]

    visit_AsyncWith = visit_With

    # ----------------------------------------------------------------- calls
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            attr = func.attr
            recv = func.value
            if attr in ("acquire", "__enter__"):
                cls = self._resolve(recv)
                if cls is not None:
                    if self._blocking_args(node):
                        self._check_acquire(node, cls)
                    self._held.append((cls, self._base_of(recv)))
            elif attr in ("release", "__exit__"):
                cls = self._resolve(recv)
                if cls is not None:
                    self._pop_held(cls)
            elif attr in ("acquire_read", "acquire_write"):
                cls = self._resolve(recv)
                if cls == "req.rwlock":
                    if self._blocking_args(node):
                        self._check_acquire(node, cls)
                    self._held.append((cls, self._base_of(recv)))
            elif attr in ("release_read", "release_write"):
                cls = self._resolve(recv)
                if cls == "req.rwlock":
                    self._pop_held(cls)
            elif attr == "wait":
                self._check_wait(node, recv)
            elif attr == "ms_addr":
                self._emit(node, "TJL004",
                           "deprecated TaijiSystem.ms_addr shim; use "
                           "GuestSpace.addr_of / gfn-relative APIs")
            elif attr in _DEPRECATED_SHIMS and self._system_receiver(recv):
                self._emit(node, "TJL004",
                           f"deprecated TaijiSystem.{attr} shim; use "
                           f"GuestSpace.{attr}(gfn, ..., off=...)")
        self._check_blocking_call(node)
        self._check_bare_ctor(node)
        self.generic_visit(node)

    @staticmethod
    def _blocking_args(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "blocking" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        if node.args and isinstance(node.args[0], ast.Constant):
            return bool(node.args[0].value)
        return True

    @staticmethod
    def _system_receiver(recv: ast.AST) -> bool:
        if isinstance(recv, ast.Name):
            return recv.id == "system"
        return isinstance(recv, ast.Attribute) and recv.attr == "system"

    def _no_blocking_scope(self) -> Optional[str]:
        for held, _base in self._held:
            if held in NO_BLOCKING_UNDER:
                return held
        return None

    @staticmethod
    def _base_of(expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        name = _dotted(expr)
        return name.split(".", 1)[0] if name else None

    def _pop_held(self, cls: str) -> None:
        for i in range(len(self._held) - 1, -1, -1):
            if self._held[i][0] == cls:
                del self._held[i]
                return

    def _check_wait(self, node: ast.Call, recv: ast.AST) -> None:
        scope = self._no_blocking_scope()
        if scope is None:
            return
        cls = self._resolve(recv)
        if cls is None:
            return  # unknown receiver: never guess
        base = self._base_of(recv)
        if any(h == cls and b == base for h, b in self._held):
            # the cond of a held lock: wait releases it (the Fig 8
            # (3.3) same-MP wait)
            return
        self._emit(node, "TJL002",
                   f"condvar wait on '{cls}' inside a '{scope}' scope "
                   "(blocks the fault path's mutex)")

    def _check_blocking_call(self, node: ast.Call) -> None:
        scope = self._no_blocking_scope()
        if scope is None:
            return
        name = _dotted(node.func)
        if name in BLOCKING_CALLS:
            self._emit(node, "TJL002",
                       f"blocking call {name}() inside a '{scope}' scope "
                       "(the MP mutex bounds the fault path's tail "
                       "latency)")

    def _check_bare_ctor(self, node: ast.Call) -> None:
        if self._in_analysis_pkg:
            return
        name = _dotted(node.func)
        if name is None or not name.startswith("threading."):
            return
        ctor = name.split(".", 1)[1]
        if ctor in _BARE_CTORS or (ctor == "Condition" and not node.args):
            self._emit(node, "TJL003",
                       f"bare {name}() construction; build locks via "
                       "repro_torch.analysis.lock_order.named_lock so they "
                       "carry a declared class/rank")


# ------------------------------------------------------------ entry points
def lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, exc.offset or 0, "TJL000",
                        f"syntax error: {exc.msg}")]
    linter = _FileLinter(path, source)
    linter.visit(tree)
    return linter.findings


def lint_paths(paths) -> List[Finding]:
    import os
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            findings.extend(lint_file(root))
            continue
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fn)))
    findings.sort(key=lambda f: (f.path, f.line, f.col))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.analysis.lint <path> [path ...]",
              file=sys.stderr)
        return 2
    findings = lint_paths(argv)
    for f in findings:
        print(f)
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
