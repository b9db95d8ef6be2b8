"""PyTorch/CUDA port of ``dial_rag_tpu`` for an NVIDIA H100.

The first slice: WordPiece tokenization, the bge-small encoder with
hand-written Hopper kernels for its two fused blocks, pooling, the dense
index and the semantic retriever. Entry points take ``device`` and run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from dial_rag_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
