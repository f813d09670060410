from .rank import lf_step
from .search_ops import (
    backward_search,
    backward_search_steps,
    backward_step_pair,
    extract_backward,
    locate_rows,
)
