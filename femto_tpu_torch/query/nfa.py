"""Regexp AST -> epsilon-free NFA with character-class mask transitions.

The reference compiles AST -> Thompson NFA -> collapsed NFA without
epsilons, with 261-bit character masks per transition and approximate-search
state = per-node error counters (src/main/compile_regexp.h:
29-38, nfa.h:38-120).  Same pipeline here; masks are numpy bool[ALPHA_SIZE]
and the NFA is small host-side metadata — the heavy per-character range
stepping happens on device (regexp.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..alphabet import ALPHA_SIZE
from .ast import RAlt, RChar, RNode, RRep, RSeq, RStr, UNBOUNDED, reverse_regexp

MAX_REPEAT_EXPANSION = 64


@dataclasses.dataclass
class NFA:
    """Epsilon-free NFA.

    num_states: int
    start:      state 0 by convention
    accept:     bool[num_states] — accepting states
    trans:      list over states of (mask bool[ALPHA], target) transitions
    char_union: bool[num_states, ALPHA] — union of outgoing masks per state
    """

    num_states: int
    accept: np.ndarray
    trans: List[List[Tuple[np.ndarray, int]]]
    char_union: np.ndarray

    def start_set(self) -> frozenset:
        return frozenset([0])

    def reachable_chars(self, states) -> np.ndarray:
        m = np.zeros(ALPHA_SIZE, dtype=bool)
        for s in states:
            m |= self.char_union[s]
        return m

    def step(self, states, c: int) -> frozenset:
        out = set()
        for s in states:
            for mask, t in self.trans[s]:
                if mask[c]:
                    out.add(t)
        return frozenset(out)

    def is_final(self, states) -> bool:
        return any(self.accept[s] for s in states)


class _Builder:
    """Thompson construction with epsilon edges, then epsilon removal."""

    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[np.ndarray, int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int):
        self.eps[a].append(b)

    def add_edge(self, a: int, mask: np.ndarray, b: int):
        self.edges[a].append((mask, b))

    def build(self, node: RNode) -> Tuple[int, int]:
        """Returns (entry, exit) fragment states."""
        if isinstance(node, RStr):
            if len(node.data) == 0:
                s = self.new_state()
                return s, s
            entry = self.new_state()
            cur = entry
            for b in node.data:
                nxt = self.new_state()
                self.add_edge(cur, RChar.from_byte(b).mask, nxt)
                cur = nxt
            return entry, cur
        if isinstance(node, RChar):
            a, b = self.new_state(), self.new_state()
            self.add_edge(a, node.mask, b)
            return a, b
        if isinstance(node, RSeq):
            if not node.children:
                s = self.new_state()
                return s, s
            entry, cur = None, None
            for ch in node.children:
                e, x = self.build(ch)
                if entry is None:
                    entry = e
                else:
                    self.add_eps(cur, e)
                cur = x
            return entry, cur
        if isinstance(node, RAlt):
            a, b = self.new_state(), self.new_state()
            for ch in node.children:
                e, x = self.build(ch)
                self.add_eps(a, e)
                self.add_eps(x, b)
            return a, b
        if isinstance(node, RRep):
            lo = max(0, node.lo)
            hi = node.hi
            if hi != UNBOUNDED and hi > MAX_REPEAT_EXPANSION:
                hi = MAX_REPEAT_EXPANSION
            entry = self.new_state()
            cur = entry
            # mandatory copies
            for _ in range(lo):
                e, x = self.build(node.child)
                self.add_eps(cur, e)
                cur = x
            if hi == UNBOUNDED:
                # star on one more copy
                e, x = self.build(node.child)
                self.add_eps(cur, e)
                self.add_eps(x, e)
                out = self.new_state()
                self.add_eps(cur, out)
                self.add_eps(x, out)
                return entry, out
            # optional copies
            outs = [cur]
            for _ in range(hi - lo):
                e, x = self.build(node.child)
                self.add_eps(cur, e)
                cur = x
                outs.append(cur)
            out = self.new_state()
            for o in outs:
                self.add_eps(o, out)
            return entry, out
        raise TypeError(node)


def _eps_closure(eps: List[List[int]]) -> List[set]:
    n = len(eps)
    clos = [set([i]) for i in range(n)]
    changed = True
    while changed:
        changed = False
        for i in range(n):
            add = set()
            for j in clos[i]:
                for k in eps[j]:
                    if k not in clos[i] and k not in add:
                        add.add(k)
            if add:
                clos[i] |= add
                changed = True
    return clos


def compile_nfa(node: RNode, reverse: bool = True) -> NFA:
    """Compile (optionally reversed — required for backward index search)."""
    if reverse:
        node = reverse_regexp(node)
    b = _Builder()
    entry, exit_ = b.build(node)
    clos = _eps_closure(b.eps)

    # Reachable subset construction is not needed — we keep NFA states but
    # remove epsilons: state s has char edge (mask, t') for every s' in
    # closure(s) with edge (mask, t); accepting if closure contains exit.
    n_raw = len(b.eps)
    # map raw states to compact ids for states reachable from closure(entry)
    # via char edges.
    start_c = clos[entry]
    # collapse: new start state representing closure(entry)
    # We renumber: state 0 = start superstate; others = raw states.
    id_map = {}

    def sid(raw: int) -> int:
        if raw not in id_map:
            id_map[raw] = len(id_map)
        return id_map[raw]

    trans: List[List[Tuple[np.ndarray, int]]] = []
    accept_flags: List[bool] = []

    def ensure(idx: int):
        while len(trans) <= idx:
            trans.append([])
            accept_flags.append(False)

    # start superstate
    START = 0
    trans.append([])
    accept_flags.append(exit_ in start_c)
    worklist = []

    def add_edges_from_closure(src_id: int, closure_set):
        for s2 in closure_set:
            for mask, t in b.edges[s2]:
                t_id = sid(t) + 1  # shift: 0 reserved for start
                ensure(t_id)
                trans[src_id].append((mask, t_id))
                if t_id not in seen:
                    seen.add(t_id)
                    worklist.append((t_id, t))

    seen = set([START])
    add_edges_from_closure(START, start_c)
    while worklist:
        t_id, raw = worklist.pop()
        ensure(t_id)
        accept_flags[t_id] = exit_ in clos[raw]
        add_edges_from_closure(t_id, clos[raw])

    num = len(trans)
    char_union = np.zeros((num, ALPHA_SIZE), dtype=bool)
    for s in range(num):
        for mask, t in trans[s]:
            char_union[s] |= mask
    return NFA(
        num_states=num,
        accept=np.array(accept_flags, dtype=bool),
        trans=trans,
        char_union=char_union,
    )
