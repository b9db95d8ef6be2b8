from dial_rag_tpu_torch.runtime.resource_counter import ResourceCounter
from dial_rag_tpu_torch.runtime.limited import (
    AsyncGeneratorWithTotal,
    DialLimitedResources,
    map_with_resource_limits,
)

__all__ = [
    "ResourceCounter",
    "AsyncGeneratorWithTotal",
    "DialLimitedResources",
    "map_with_resource_limits",
]
