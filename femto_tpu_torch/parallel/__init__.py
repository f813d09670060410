"""The sharded index on a mesh of shards (femto_tpu/parallel's port).

LocalMesh holds every shard in one process on one card; DistMesh one shard
per torch.distributed process (parallel/distributed.py).  The full,
compact and packed tiers build and answer count and locate.
"""

from .mesh import DistMesh, LocalMesh
from .dist_sort import dist_sort
from .dist_build import (build_index_sharded, dist_suffix_array,
                         pad_text_for_mesh)
from .dist_query import (sharded_arrays_from_numpy, sharded_backward_search,
                         sharded_locate)
