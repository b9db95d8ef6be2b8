"""PyTorch/CUDA port of ``dial_rag_tpu`` for an NVIDIA H100.

WordPiece tokenization, the bge-small encoder with hand-written Hopper
kernels for its two fused bf16 blocks and for the f32 attention forward
and backward, pooling, the dense index, the semantic retriever, keyword
preprocessing, BM25 and its retriever, the RRF ensemble (with C++ host
cores for keywords and WordPiece, ``native``), the late-interaction and
chargram arms, concurrent serving (coalesced encodes and scans,
``runtime``; the device-index cache, ``index.device_cache``), the
document pipeline (``documents``: PDF, office, text, Markdown and CSV
parsing, by-title chunking), index storage (``storage``), the DIAL
service (``service``: indexing, retrieval and rag chat completions over
HTTP; ``python -m dial_rag_tpu_torch.main``), and contrastive fine-tuning
of the encoder (``training``). Entry points take ``device`` and run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from dial_rag_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]
