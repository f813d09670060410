"""femto_tpu_torch: the FM-index of femto_tpu on PyTorch and CUDA (H100).

The port of femto_tpu's single-device index in all five storage tiers
(full, compact, packed, vseg, vrle): document preparation, suffix sort
and index packaging on the card, .npz and .ftpu persistence, count /
locate / extract / context / range_docs, and the query engine
(femto_tpu_torch.query: regex, approximate and Boolean queries, the
device regex frontier), chunked builds past 2^31 symbols with per-segment
doc lists (femto_tpu_torch.multi), and the sharded index of all five
tiers with its doc lists, checkpoint / resume and query engine
(femto_tpu_torch.parallel), served by hand-written CUDA kernels (csrc/,
built and bound by kernels.py).  It
imports torch and numpy only; femto_tpu stays the JAX reference.

The sharded index runs on a mesh of D shards:

    from femto_tpu_torch import parallel as tpar
    mesh = tpar.LocalMesh(4, device="cuda")      # 4 shards on one card
    six = tpar.build_index_sharded(prepared, mesh, tier="packed")
    first, last = tpar.sharded_backward_search(six, mesh, packed_pats)
    offsets = tpar.sharded_locate(six, mesh, rows)

or one shard per process, the collectives on NCCL:

    from femto_tpu_torch.parallel import distributed as ftd
    ftd.initialize("host0:29500", num_processes=4, process_id=rank)
    mesh = ftd.global_mesh()                      # a DistMesh
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
    l1_group_for,
)
from .suffix import bwt_from_sa, suffix_array
from .search import (
    count,
    count_ranges,
    extract_all_documents,
    extract_context,
    extract_context_batch,
    extract_document,
    locate,
    locate_range,
    locate_rows_array,
    offsets_to_docs,
    range_docs,
)

__version__ = "0.1.0"
