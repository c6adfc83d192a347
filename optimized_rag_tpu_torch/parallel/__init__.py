"""Device-mesh parallelism of the port (``optimized_rag_tpu/parallel``): a
``Mesh`` of torch devices, the corpus row-sharded over its data axis, a
top-k per shard and a gather and merge of the [shards, B, k] winners
(``torch.distributed.all_gather`` across processes)."""

from optimized_rag_tpu_torch.parallel.mesh import (
    make_mesh, corpus_sharding, replicated_sharding)
from optimized_rag_tpu_torch.parallel.sharded_topk import (
    sharded_topk, ShardedDenseIndex)

__all__ = ["ShardedDenseIndex", "corpus_sharding", "make_mesh",
           "replicated_sharding", "sharded_topk"]
