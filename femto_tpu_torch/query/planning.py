"""Query planning: normalize regexps before compilation.

The reference's query_planning.c:14-80 streamlines queries by hoisting
unanchored `.*` edges (index search is substring-anchored, so leading and
trailing `.*`/`.+`-style wildcards are redundant or transformable) and
detects patterns that match the empty string (which match every row).
"""

from __future__ import annotations

from .ast import RAlt, RChar, RNode, RRep, RSeq, RStr


def fold_case(node: RNode) -> RNode:
    """Case-insensitive transform (femto_search --icase,
    search_tool.cc / toloweralpha index_types.h:75-84): every ASCII letter
    becomes a two-letter character class; charset masks get both cases."""
    from ..alphabet import CHARACTER_OFFSET

    if isinstance(node, RStr):
        if not any(65 <= b <= 90 or 97 <= b <= 122 for b in node.data):
            return node
        parts: list = []
        for b in node.data:
            if 65 <= b <= 90 or 97 <= b <= 122:
                parts.append(RChar.from_bytes_set([b & ~0x20, b | 0x20]))
            else:
                parts.append(RStr(bytes([b])))
        return RSeq(parts)
    if isinstance(node, RChar):
        mask = node.mask.copy()
        for b in range(65, 91):
            if mask[b + CHARACTER_OFFSET] or mask[b + 32 + CHARACTER_OFFSET]:
                mask[b + CHARACTER_OFFSET] = True
                mask[b + 32 + CHARACTER_OFFSET] = True
        return RChar(mask)
    if isinstance(node, RSeq):
        return RSeq([fold_case(c) for c in node.children])
    if isinstance(node, RAlt):
        return RAlt([fold_case(c) for c in node.children])
    if isinstance(node, RRep):
        return RRep(fold_case(node.child), node.lo, node.hi)
    raise TypeError(node)


def matches_empty(node: RNode) -> bool:
    """Can the regexp match the empty string? (matches_empty_string)"""
    if isinstance(node, RStr):
        return len(node.data) == 0
    if isinstance(node, RChar):
        return False
    if isinstance(node, RSeq):
        return all(matches_empty(c) for c in node.children)
    if isinstance(node, RAlt):
        return any(matches_empty(c) for c in node.children)
    if isinstance(node, RRep):
        return node.lo == 0 or matches_empty(node.child)
    raise TypeError(node)


def _is_dot_star(node: RNode) -> bool:
    """`.*` or `.{0,k}`-style: a repeat of any-char with lo == 0."""
    return (
        isinstance(node, RRep)
        and node.lo == 0
        and isinstance(node.child, RChar)
        and bool(node.child.mask[5:].all())
    )


def streamline(node: RNode) -> RNode:
    """Drop leading/trailing unanchored any-char wildcards (streamline_query
    semantics: `.*abc.*` finds the same row ranges as `abc`)."""
    if isinstance(node, RSeq):
        children = [streamline_inner(c) for c in node.children]
        while children and _is_dot_star(children[0]):
            children.pop(0)
        while children and _is_dot_star(children[-1]):
            children.pop()
        if not children:
            return RStr(b"")
        if len(children) == 1:
            return children[0]
        return RSeq(children)
    return streamline_inner(node)


def streamline_inner(node: RNode) -> RNode:
    """Recursive cleanup: flatten nested sequences, merge literal runs."""
    if isinstance(node, RSeq):
        flat = []
        for c in node.children:
            c = streamline_inner(c)
            if isinstance(c, RSeq):
                flat.extend(c.children)
            elif isinstance(c, RStr) and flat and isinstance(flat[-1], RStr):
                flat[-1] = RStr(flat[-1].data + c.data)
            else:
                flat.append(c)
        if len(flat) == 1:
            return flat[0]
        return RSeq(flat)
    if isinstance(node, RAlt):
        return RAlt([streamline_inner(c) for c in node.children])
    if isinstance(node, RRep):
        return RRep(streamline_inner(node.child), node.lo, node.hi)
    return node
