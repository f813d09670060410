"""The query engine: regex, approximate and Boolean queries over an index
of any tier, answered where the index lives (femto_tpu.query)."""

from .ast import (
    ApproxSettings,
    QAnd,
    QNot,
    QOr,
    QTerm,
    QThen,
    QWithin,
    RAlt,
    RChar,
    RRep,
    RSeq,
    RStr,
)
from .parser import parse_query, ParseError
from .nfa import NFA, compile_nfa
from .results import Results, ResultType
from .engine import (
    TruncationWarning,
    count_query,
    docs_query,
    docs_query_ex,
    execute,
    find_strings,
    term_ranges,
)
from .regexp import RegexpMatch, run_regexp
from .regexp_device import run_regexp_device
