"""femto_tpu_torch: the FM-index of femto_tpu on PyTorch and CUDA (H100).

The port of femto_tpu's single-device full tier: document preparation,
suffix sort and index packaging on the card, and count / locate / extract
served by hand-written CUDA kernels (csrc/, built and bound by kernels.py).
It imports torch and numpy only; femto_tpu stays the JAX reference.
"""

from .alphabet import (
    ALPHA_SIZE,
    CHARACTER_OFFSET,
    PreparedText,
    prepare_documents,
)
from .fmindex import (
    FMArrays,
    FMIndex,
    FMMeta,
    arrays_from_numpy,
    build_index,
)
from .suffix import suffix_array
from .search import (
    count,
    count_ranges,
    extract_all_documents,
    extract_document,
    locate,
    locate_range,
    locate_rows_array,
    offsets_to_docs,
)

__version__ = "0.1.0"
