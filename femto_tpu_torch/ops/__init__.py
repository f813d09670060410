from .rank import lf_step
from .search_ops import backward_search, extract_backward, locate_rows
