"""Query-language parser (Python recursive descent; no flex/bison).

Implements the grammar of src/main/QUERY_FORMAT.txt and
posix.bison.y:58-140: whitespace-separated terms concatenate; Boolean
AND/OR/NOT/"THEN n"/"WITHIN n" are flat left-associative; parentheses group
both Boolean expressions and regexp groups; APPROX [k | max:s:d:i] prefixes
a term.  Quoting: backslash escapes (\\n, \\xNN, ...), double quotes
(escapes honored), single quotes (fully literal), {x HEX} byte sequences.
POSIX ERE subset: . [] [^] * + ? | {m,n} () — no ^/$ anchors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .ast import (
    ALPHA_SIZE,
    ApproxSettings,
    QAnd,
    QNode,
    QNot,
    QOr,
    QTerm,
    QThen,
    QWithin,
    RAlt,
    RChar,
    RNode,
    RRep,
    RSeq,
    RStr,
    UNBOUNDED,
)


class ParseError(ValueError):
    pass


_ESCAPES = {
    "n": 0x0A, "t": 0x09, "r": 0x0D, "b": 0x08,
    "f": 0x0C, "a": 0x07, "e": 0x1B, "v": 0x0B,
}

_BOOL_WORDS = {"AND", "OR", "NOT", "THEN", "WITHIN", "APPROX"}


class _Lexer:
    """Produces a token stream.  Token kinds:
    CHAR (literal byte), STR (bytes), DOT, SET (mask), LPAREN, RPAREN,
    STAR, PLUS, QMARK, PIPE, REPEAT (lo, hi), BOOL (op, dist),
    APPROX (settings), SPACE (term separator), EOF.
    """

    def __init__(self, s: str):
        self.s = s
        self.i = 0
        self.toks: List[Tuple] = []
        self._lex()

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _next(self) -> str:
        c = self._peek()
        self.i += 1
        return c

    def _lex_escape(self) -> int:
        """After a backslash: return the byte value."""
        c = self._next()
        if c == "":
            raise ParseError("dangling backslash")
        if c in _ESCAPES:
            return _ESCAPES[c]
        if c == "x":
            h = self.s[self.i : self.i + 2]
            if len(h) < 2 or not all(x in "0123456789abcdefABCDEF" for x in h):
                raise ParseError("bad \\x escape")
            self.i += 2
            return int(h, 16)
        return ord(c) & 0xFF

    def _lex_dquote(self) -> bytes:
        out = bytearray()
        while True:
            c = self._next()
            if c == "":
                raise ParseError("unterminated double quote")
            if c == '"':
                return bytes(out)
            if c == "\\":
                out.append(self._lex_escape())
            else:
                out.extend(c.encode("latin-1", "replace"))

    def _lex_squote(self) -> bytes:
        out = bytearray()
        while True:
            c = self._next()
            if c == "":
                raise ParseError("unterminated single quote")
            if c == "'":
                return bytes(out)
            out.extend(c.encode("latin-1", "replace"))

    def _lex_hexbrace(self) -> bytes:
        # after "{x": hex digits and spaces until }
        out = bytearray()
        digits = ""
        while True:
            c = self._next()
            if c == "":
                raise ParseError("unterminated {x }")
            if c == "}":
                break
            if c == " ":
                continue
            if c not in "0123456789abcdefABCDEF":
                raise ParseError("bad hex digit in {x }")
            digits += c
        for j in range(0, len(digits) - len(digits) % 2, 2):
            out.append(int(digits[j : j + 2], 16))
        return bytes(out)

    def _lex_bracket(self):
        # after "[": bracket expression
        negate = False
        if self._peek() == "^":
            self._next()
            negate = True
        mask = np.zeros(ALPHA_SIZE, dtype=bool)

        def getb() -> Optional[int]:
            c = self._next()
            if c == "":
                raise ParseError("unterminated [ ]")
            if c == "]":
                return None
            if c == "\\":
                return self._lex_escape()
            return ord(c) & 0xFF

        prev: Optional[int] = None
        while True:
            b = getb()
            if b is None:
                break
            if b == ord("-") and prev is not None and self._peek() not in ("]", ""):
                # range
                hi_c = getb()
                if hi_c is None:
                    raise ParseError("unterminated range in [ ]")
                from ..alphabet import CHARACTER_OFFSET

                lo, hi = prev, hi_c
                if lo > hi:
                    raise ParseError("reversed range in [ ]")
                mask[lo + CHARACTER_OFFSET : hi + CHARACTER_OFFSET + 1] = True
                prev = None
                continue
            from ..alphabet import CHARACTER_OFFSET

            mask[b + CHARACTER_OFFSET] = True
            prev = b
        if negate:
            mask = ~mask
            mask[: np.int64(5)] = False
        return ("SET", mask)

    def _lex_repeat_range(self) -> Optional[Tuple[int, int]]:
        # at '{': try {m}, {m,}, {m,n}; returns None if not a repeat form
        save = self.i
        self._next()  # consume {
        num = ""
        while self._peek().isdigit():
            num += self._next()
        if num == "":
            self.i = save
            return None
        if self._peek() == "}":
            self._next()
            return (int(num), int(num))
        if self._peek() == ",":
            self._next()
            num2 = ""
            while self._peek().isdigit():
                num2 += self._next()
            if self._peek() == "}":
                self._next()
                return (int(num), int(num2) if num2 else UNBOUNDED)
        self.i = save
        return None

    def _lex_word(self) -> str:
        w = ""
        while self._peek().isalpha():
            w += self._next()
        return w

    def _lex(self):
        t = self.toks
        while self.i < len(self.s):
            c = self._peek()
            if c.isspace():
                self._next()
                if t and t[-1][0] not in ("SPACE", "BOOL", "APPROX", "LPAREN", "PIPE"):
                    t.append(("SPACE",))
                continue
            if c.isupper():
                save = self.i
                w = self._lex_word()
                if w in _BOOL_WORDS:
                    if w == "APPROX":
                        t.append(("APPROX", self._lex_approx_settings()))
                    elif w in ("THEN", "WITHIN"):
                        dist = self._lex_distance()
                        t.append(("BOOL", w, dist))
                    else:
                        t.append(("BOOL", w, 0))
                    continue
                # plain word, emit chars
                for ch in w:
                    t.append(("CHAR", ord(ch)))
                continue
            self._next()
            if c == "\\":
                t.append(("CHAR", self._lex_escape()))
            elif c == '"':
                t.append(("STR", self._lex_dquote()))
            elif c == "'":
                t.append(("STR", self._lex_squote()))
            elif c == ".":
                t.append(("DOT",))
            elif c == "[":
                t.append(self._lex_bracket())
            elif c == "(":
                t.append(("LPAREN",))
            elif c == ")":
                t.append(("RPAREN",))
            elif c == "*":
                t.append(("STAR",))
            elif c == "+":
                t.append(("PLUS",))
            elif c == "?":
                t.append(("QMARK",))
            elif c == "|":
                t.append(("PIPE",))
            elif c == "{":
                if self._peek() == "x":
                    self._next()
                    t.append(("STR", self._lex_hexbrace()))
                else:
                    self.i -= 1
                    rr = self._lex_repeat_range()
                    if rr is not None:
                        t.append(("REPEAT", rr[0], rr[1]))
                    else:
                        self._next()
                        t.append(("CHAR", ord("{")))
            else:
                t.append(("CHAR", ord(c) & 0xFF))
        t.append(("EOF",))

    def _lex_distance(self) -> int:
        while self._peek().isspace():
            self._next()
        num = ""
        while self._peek().isdigit():
            num += self._next()
        if num == "":
            raise ParseError("THEN/WITHIN requires a distance")
        return int(num)

    def _lex_approx_settings(self) -> ApproxSettings:
        save = self.i
        while self._peek() == " ":
            self._next()
        num = ""
        while self._peek().isdigit():
            num += self._next()
        if num == "":
            self.i = save
            return ApproxSettings.edit_distance(1)
        if self._peek() == ":":
            parts = [int(num)]
            while self._peek() == ":":
                self._next()
                n2 = ""
                while self._peek().isdigit():
                    n2 += self._next()
                parts.append(int(n2) if n2 else 1)
            while len(parts) < 4:
                parts.append(1)
            return ApproxSettings(
                cost_bound=parts[0] + 1,
                subst_cost=parts[1],
                delete_cost=parts[2],
                insert_cost=parts[3],
            )
        return ApproxSettings.edit_distance(int(num))


class _Parser:
    def __init__(self, toks: List[Tuple]):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def skip_spaces(self):
        while self.peek()[0] == "SPACE":
            self.next()

    # boolean_exp: term (BOOL term)*    (flat left-assoc, posix.bison.y:118)
    def parse_boolean(self) -> QNode:
        left = self.parse_boolean_rest()
        while True:
            self.skip_spaces()
            if self.peek()[0] == "BOOL":
                _, op, dist = self.next()
                right = self.parse_boolean_rest()
                left = {
                    "AND": lambda a, b: QAnd(a, b),
                    "OR": lambda a, b: QOr(a, b),
                    "NOT": lambda a, b: QNot(a, b),
                    "THEN": lambda a, b: QThen(a, b, dist),
                    "WITHIN": lambda a, b: QWithin(a, b, dist),
                }[op](left, right)
            else:
                return left

    def parse_boolean_rest(self) -> QNode:
        self.skip_spaces()
        approx = ApproxSettings.exact()
        if self.peek()[0] == "APPROX":
            approx = self.next()[1]
            self.skip_spaces()
        # '(' may open a Boolean group ("(a AND b) OR c",
        # posix.bison.y:122-124) or a regexp group ("(ab|cd)ef").
        # Speculatively parse a Boolean group; backtrack if the contents
        # contain no Boolean operator.
        if self.peek()[0] == "LPAREN":
            save = self.i
            self.next()
            try:
                inner = self.parse_boolean()
                if not isinstance(inner, QTerm) and self.peek()[0] == "RPAREN":
                    self.next()
                    return inner
            except ParseError:
                pass
            self.i = save
        regexp = self.parse_regexp(stop_on_bool=True)
        if regexp is None:
            raise ParseError("expected a pattern")
        return QTerm(regexp=regexp, approx=approx)

    # regexp: alternation of sequences, stopping at boolean keywords/EOF.
    def parse_regexp(self, stop_on_bool: bool) -> Optional[RNode]:
        alts = [self.parse_sequence(stop_on_bool)]
        while self.peek()[0] == "PIPE":
            self.next()
            alts.append(self.parse_sequence(stop_on_bool))
        if len(alts) == 1:
            return alts[0]
        return RAlt(alts)

    def parse_sequence(self, stop_on_bool: bool) -> RNode:
        parts: List[RNode] = []
        while True:
            tok = self.peek()
            kind = tok[0]
            if kind in ("EOF", "RPAREN", "PIPE"):
                break
            if kind == "BOOL" or kind == "APPROX":
                if stop_on_bool:
                    break
                raise ParseError("unexpected boolean operator")
            if kind == "SPACE":
                # terms concatenate; a space followed by a boolean keyword
                # ends the term.
                j = self.i
                while self.toks[j][0] == "SPACE":
                    j += 1
                if self.toks[j][0] in ("BOOL", "APPROX", "EOF", "RPAREN"):
                    break
                self.next()
                continue
            atom = self.parse_atom()
            atom = self.maybe_repeat(atom)
            parts.append(atom)
        if len(parts) == 1:
            return parts[0]
        return RSeq(parts)

    def parse_atom(self) -> RNode:
        tok = self.next()
        kind = tok[0]
        if kind == "CHAR":
            return RStr(bytes([tok[1]]))
        if kind == "STR":
            return RStr(tok[1])
        if kind == "DOT":
            return RChar.any()
        if kind == "SET":
            return RChar(tok[1])
        if kind == "LPAREN":
            inner = self.parse_regexp(stop_on_bool=False)
            if self.peek()[0] != "RPAREN":
                raise ParseError("expected )")
            self.next()
            return inner
        raise ParseError(f"unexpected token {tok}")

    def maybe_repeat(self, atom: RNode) -> RNode:
        tok = self.peek()
        if tok[0] == "STAR":
            self.next()
            return RRep(atom, 0, UNBOUNDED)
        if tok[0] == "PLUS":
            self.next()
            return RRep(atom, 1, UNBOUNDED)
        if tok[0] == "QMARK":
            self.next()
            return RRep(atom, 0, 1)
        if tok[0] == "REPEAT":
            self.next()
            return RRep(atom, tok[1], tok[2])
        return atom


def parse_query(s: str) -> QNode:
    """Parse a FEMTO-syntax query string into the Boolean/regexp AST."""
    lx = _Lexer(s)
    p = _Parser(lx.toks)
    node = p.parse_boolean()
    p.skip_spaces()
    if p.peek()[0] != "EOF":
        raise ParseError(f"trailing input at token {p.peek()}")
    return node
