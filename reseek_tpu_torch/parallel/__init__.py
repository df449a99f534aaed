"""Multi-device and multi-process search of the port, counterpart of
``reseek_tpu.parallel``: the device mesh (mesh.py), the top-B merge
(topk.py) and the multi-process -fast search (multihost.py)."""

from reseek_tpu_torch.parallel.mesh import (Mesh, as_mesh, host_shard_bounds)
from reseek_tpu_torch.parallel.topk import (merge_topk_distributed,
                                            merge_topk_sharded,
                                            sharded_prefilter_search)

__all__ = ["Mesh", "as_mesh", "host_shard_bounds", "merge_topk_sharded",
           "merge_topk_distributed", "sharded_prefilter_search"]
