from dial_rag_tpu_torch.utils.streams import (
    LoggerStream,
    MarkdownStream,
    MultiStream,
    StreamWithPrefix,
)
from dial_rag_tpu_torch.utils.timing import timed_block, timeout

__all__ = [
    "StreamWithPrefix",
    "MarkdownStream",
    "LoggerStream",
    "MultiStream",
    "timed_block",
    "timeout",
]
