"""Query AST: regular-expression atoms + Boolean document operators.

Semantics mirror the reference's ast.h node kinds
(src/main/ast.h:77-200): REGEXP/SEQUENCE/ATOM/SET/CHARACTER/
STRING with repeat ranges, Boolean AND/OR/NOT/THEN/WITHIN with distances,
and APPROX settings (cost bound + per-edit costs, index_types.h:148-162).
Patterns are matched by *backward* search over the index, so `reverse()`
produces the reversed AST (the reference's is_reversed flag, ast.h).

Character classes are boolean masks over the 261-symbol alphabet
(nfa.h:38-49 uses 261-bit masks; here numpy bool arrays, packed later for
device kernels).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np

from ..alphabet import ALPHA_SIZE, CHARACTER_OFFSET

UNBOUNDED = -1


# ---------- regexp level ----------


@dataclasses.dataclass
class RChar:
    """Single-position character class (mask over alphabet codes)."""

    mask: np.ndarray  # bool[ALPHA_SIZE]

    @classmethod
    def from_byte(cls, b: int) -> "RChar":
        m = np.zeros(ALPHA_SIZE, dtype=bool)
        m[b + CHARACTER_OFFSET] = True
        return cls(m)

    @classmethod
    def from_bytes_set(cls, bs, negate: bool = False) -> "RChar":
        m = np.zeros(ALPHA_SIZE, dtype=bool)
        for b in bs:
            m[b + CHARACTER_OFFSET] = True
        if negate:
            m = ~m
            m[:CHARACTER_OFFSET] = False  # never match escape codes
        return cls(m)

    @classmethod
    def any(cls) -> "RChar":
        m = np.ones(ALPHA_SIZE, dtype=bool)
        m[:CHARACTER_OFFSET] = False  # '.' does not cross doc boundaries
        return cls(m)


@dataclasses.dataclass
class RStr:
    """Literal byte string."""

    data: bytes


@dataclasses.dataclass
class RSeq:
    children: List["RNode"]


@dataclasses.dataclass
class RAlt:
    children: List["RNode"]


@dataclasses.dataclass
class RRep:
    child: "RNode"
    lo: int
    hi: int  # UNBOUNDED for no limit


RNode = Union[RChar, RStr, RSeq, RAlt, RRep]


def reverse_regexp(node: RNode) -> RNode:
    if isinstance(node, (RChar, RStr)):
        if isinstance(node, RStr):
            return RStr(node.data[::-1])
        return node
    if isinstance(node, RSeq):
        return RSeq([reverse_regexp(c) for c in reversed(node.children)])
    if isinstance(node, RAlt):
        return RAlt([reverse_regexp(c) for c in node.children])
    if isinstance(node, RRep):
        return RRep(reverse_regexp(node.child), node.lo, node.hi)
    raise TypeError(node)


def as_literal(node: RNode) -> Optional[bytes]:
    """If the regexp is a plain literal string, return its bytes."""
    if isinstance(node, RStr):
        return node.data
    if isinstance(node, RChar):
        idx = np.nonzero(node.mask)[0]
        if len(idx) == 1 and idx[0] >= CHARACTER_OFFSET:
            return bytes([int(idx[0]) - CHARACTER_OFFSET])
        return None
    if isinstance(node, RSeq):
        parts = []
        for c in node.children:
            p = as_literal(c)
            if p is None:
                return None
            parts.append(p)
        return b"".join(parts)
    return None


# ---------- approx settings ----------


@dataclasses.dataclass(frozen=True)
class ApproxSettings:
    """Edit-distance settings (set_default_regexp_settings,
    index_types.h:155-162): cost_bound == max allowed cost + 1; a state at
    cost_bound is not a match."""

    cost_bound: int = 1  # 1 => exact matching only
    subst_cost: int = 1
    delete_cost: int = 1
    insert_cost: int = 1

    @classmethod
    def exact(cls) -> "ApproxSettings":
        return cls()

    @classmethod
    def edit_distance(cls, k: int) -> "ApproxSettings":
        return cls(cost_bound=k + 1)


# ---------- boolean level ----------


@dataclasses.dataclass
class QTerm:
    regexp: RNode
    approx: ApproxSettings = dataclasses.field(default_factory=ApproxSettings)


@dataclasses.dataclass
class QAnd:
    left: "QNode"
    right: "QNode"


@dataclasses.dataclass
class QOr:
    left: "QNode"
    right: "QNode"


@dataclasses.dataclass
class QNot:
    left: "QNode"
    right: "QNode"


@dataclasses.dataclass
class QThen:
    left: "QNode"
    right: "QNode"
    distance: int


@dataclasses.dataclass
class QWithin:
    left: "QNode"
    right: "QNode"
    distance: int


QNode = Union[QTerm, QAnd, QOr, QNot, QThen, QWithin]
