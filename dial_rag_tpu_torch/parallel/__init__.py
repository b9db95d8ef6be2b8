from dial_rag_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    dp_slots,
    visible_devices,
)
from dial_rag_tpu_torch.parallel.sharded_index import (
    ShardedBm25Index,
    ShardedBm25SparseIndex,
    ShardedDenseIndex,
    ShardedLateInteractionIndex,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "dp_slots",
    "visible_devices",
    "ShardedBm25Index",
    "ShardedBm25SparseIndex",
    "ShardedDenseIndex",
    "ShardedLateInteractionIndex",
]
