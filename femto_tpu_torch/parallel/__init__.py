"""The sharded index on a mesh of shards (femto_tpu/parallel's port).

LocalMesh holds every shard in one process on one card; DistMesh one shard
per torch.distributed process (parallel/distributed.py).  All five tiers
build (with doc lists and checkpoint / resume) and answer count, locate
and the query engine's regex, approximate, Boolean and docs queries.
"""

from .mesh import DistMesh, LocalMesh
from .dist_sort import dist_sort
from .dist_build import (build_index_sharded, dist_suffix_array,
                         pad_text_for_mesh)
from .dist_query import (sharded_arrays_from_numpy, sharded_backward_search,
                         sharded_count_query, sharded_docs_query,
                         sharded_locate, sharded_regexp_matches,
                         sharded_term_ranges)
