"""Red-black tree keyed by integer GFN.

The paper stores all swap request entities (``req``) in a red-black tree so
a page fault can locate the req for the faulting address efficiently
(§4.2.2: "All reqs are unique and stored in a red-black tree for efficient
page-fault lookup"). We reproduce that structure rather than substituting a
hash map so the lookup path has the same asymptotics and supports
floor-lookup (find the req covering an address range).

Not thread safe by itself; the swap engine guards it with a short mutex,
matching the kernel's tree-lock discipline.
"""
from __future__ import annotations

from typing import Any, Iterator, Optional

RED = 0
BLACK = 1


class _Node:
    __slots__ = ("key", "value", "left", "right", "parent", "color")

    def __init__(self, key: int, value: Any) -> None:
        self.key = key
        self.value = value
        self.left: Optional[_Node] = None
        self.right: Optional[_Node] = None
        self.parent: Optional[_Node] = None
        self.color = RED


class RBTree:
    def __init__(self) -> None:
        self.root: Optional[_Node] = None
        self.size = 0

    # ------------------------------------------------------------- rotations
    def _rotate_left(self, x: _Node) -> None:
        y = x.right
        assert y is not None
        x.right = y.left
        if y.left is not None:
            y.left.parent = x
        y.parent = x.parent
        if x.parent is None:
            self.root = y
        elif x is x.parent.left:
            x.parent.left = y
        else:
            x.parent.right = y
        y.left = x
        x.parent = y

    def _rotate_right(self, x: _Node) -> None:
        y = x.left
        assert y is not None
        x.left = y.right
        if y.right is not None:
            y.right.parent = x
        y.parent = x.parent
        if x.parent is None:
            self.root = y
        elif x is x.parent.right:
            x.parent.right = y
        else:
            x.parent.left = y
        y.right = x
        x.parent = y

    # ---------------------------------------------------------------- insert
    def insert(self, key: int, value: Any) -> None:
        """Insert key -> value; keys must be unique (reqs are unique)."""
        node = _Node(key, value)
        parent, cur = None, self.root
        while cur is not None:
            parent = cur
            if key < cur.key:
                cur = cur.left
            elif key > cur.key:
                cur = cur.right
            else:
                raise KeyError(f"duplicate key {key}")
        node.parent = parent
        if parent is None:
            self.root = node
        elif key < parent.key:
            parent.left = node
        else:
            parent.right = node
        self.size += 1
        self._insert_fixup(node)

    def _insert_fixup(self, z: _Node) -> None:
        while z.parent is not None and z.parent.color == RED:
            gp = z.parent.parent
            assert gp is not None
            if z.parent is gp.left:
                y = gp.right
                if y is not None and y.color == RED:
                    z.parent.color = BLACK
                    y.color = BLACK
                    gp.color = RED
                    z = gp
                else:
                    if z is z.parent.right:
                        z = z.parent
                        self._rotate_left(z)
                    z.parent.color = BLACK
                    gp.color = RED
                    self._rotate_right(gp)
            else:
                y = gp.left
                if y is not None and y.color == RED:
                    z.parent.color = BLACK
                    y.color = BLACK
                    gp.color = RED
                    z = gp
                else:
                    if z is z.parent.left:
                        z = z.parent
                        self._rotate_right(z)
                    z.parent.color = BLACK
                    gp.color = RED
                    self._rotate_left(gp)
        assert self.root is not None
        self.root.color = BLACK

    # ---------------------------------------------------------------- lookup
    def find(self, key: int) -> Any:
        cur = self.root
        while cur is not None:
            if key < cur.key:
                cur = cur.left
            elif key > cur.key:
                cur = cur.right
            else:
                return cur.value
        return None

    def floor(self, key: int) -> Any:
        """Value with the greatest key <= ``key`` (covering-range lookup)."""
        cur, best = self.root, None
        while cur is not None:
            if cur.key == key:
                return cur.value
            if cur.key < key:
                best = cur
                cur = cur.right
            else:
                cur = cur.left
        return best.value if best is not None else None

    # ---------------------------------------------------------------- delete
    def _minimum(self, node: _Node) -> _Node:
        while node.left is not None:
            node = node.left
        return node

    def _transplant(self, u: _Node, v: Optional[_Node]) -> None:
        if u.parent is None:
            self.root = v
        elif u is u.parent.left:
            u.parent.left = v
        else:
            u.parent.right = v
        if v is not None:
            v.parent = u.parent

    def delete(self, key: int) -> Any:
        z = self.root
        while z is not None and z.key != key:
            z = z.left if key < z.key else z.right
        if z is None:
            raise KeyError(key)
        value = z.value
        y, y_color = z, z.color
        if z.left is None:
            x, x_parent = z.right, z.parent
            self._transplant(z, z.right)
        elif z.right is None:
            x, x_parent = z.left, z.parent
            self._transplant(z, z.left)
        else:
            y = self._minimum(z.right)
            y_color = y.color
            x = y.right
            if y.parent is z:
                x_parent = y
            else:
                x_parent = y.parent
                self._transplant(y, y.right)
                y.right = z.right
                y.right.parent = y
            self._transplant(z, y)
            y.left = z.left
            y.left.parent = y
            y.color = z.color
        self.size -= 1
        if y_color == BLACK:
            self._delete_fixup(x, x_parent)
        return value

    def _delete_fixup(self, x: Optional[_Node], parent: Optional[_Node]) -> None:
        while x is not self.root and (x is None or x.color == BLACK):
            if parent is None:
                break
            if x is parent.left:
                w = parent.right
                if w is not None and w.color == RED:
                    w.color = BLACK
                    parent.color = RED
                    self._rotate_left(parent)
                    w = parent.right
                if w is None:
                    x, parent = parent, parent.parent
                    continue
                wl_black = w.left is None or w.left.color == BLACK
                wr_black = w.right is None or w.right.color == BLACK
                if wl_black and wr_black:
                    w.color = RED
                    x, parent = parent, parent.parent
                else:
                    if wr_black:
                        if w.left is not None:
                            w.left.color = BLACK
                        w.color = RED
                        self._rotate_right(w)
                        w = parent.right
                    assert w is not None
                    w.color = parent.color
                    parent.color = BLACK
                    if w.right is not None:
                        w.right.color = BLACK
                    self._rotate_left(parent)
                    x, parent = self.root, None
            else:
                w = parent.left
                if w is not None and w.color == RED:
                    w.color = BLACK
                    parent.color = RED
                    self._rotate_right(parent)
                    w = parent.left
                if w is None:
                    x, parent = parent, parent.parent
                    continue
                wl_black = w.left is None or w.left.color == BLACK
                wr_black = w.right is None or w.right.color == BLACK
                if wl_black and wr_black:
                    w.color = RED
                    x, parent = parent, parent.parent
                else:
                    if wl_black:
                        if w.right is not None:
                            w.right.color = BLACK
                        w.color = RED
                        self._rotate_left(w)
                        w = parent.left
                    assert w is not None
                    w.color = parent.color
                    parent.color = BLACK
                    if w.left is not None:
                        w.left.color = BLACK
                    self._rotate_right(parent)
                    x, parent = self.root, None
        if x is not None:
            x.color = BLACK

    # ------------------------------------------------------------- iteration
    def items(self) -> Iterator[tuple]:
        stack, cur = [], self.root
        while stack or cur is not None:
            while cur is not None:
                stack.append(cur)
                cur = cur.left
            cur = stack.pop()
            yield cur.key, cur.value
            cur = cur.right

    def __len__(self) -> int:
        return self.size

    def __contains__(self, key: int) -> bool:
        return self.find(key) is not None

    # ------------------------------------------------------------ validation
    def check_invariants(self) -> int:
        """Verify RB invariants; returns black-height. Used by property tests."""

        def rec(node: Optional[_Node]) -> int:
            if node is None:
                return 1
            if node.color == RED:
                for c in (node.left, node.right):
                    if c is not None and c.color == RED:
                        raise AssertionError("red node with red child")
            lh = rec(node.left)
            rh = rec(node.right)
            if lh != rh:
                raise AssertionError("black-height mismatch")
            if node.left is not None and node.left.key >= node.key:
                raise AssertionError("BST order violated (left)")
            if node.right is not None and node.right.key <= node.key:
                raise AssertionError("BST order violated (right)")
            return lh + (1 if node.color == BLACK else 0)

        if self.root is not None and self.root.color != BLACK:
            raise AssertionError("root must be black")
        return rec(self.root)
