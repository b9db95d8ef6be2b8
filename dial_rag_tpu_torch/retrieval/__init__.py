from dial_rag_tpu_torch.retrieval.all_documents import AllDocumentsRetriever
from dial_rag_tpu_torch.retrieval.bm25_retriever import Bm25Retriever
from dial_rag_tpu_torch.retrieval.chargram_retriever import ChargramRetriever
from dial_rag_tpu_torch.retrieval.ensemble import EnsembleRetriever
from dial_rag_tpu_torch.retrieval.late_interaction import LateInteractionRetriever
from dial_rag_tpu_torch.retrieval.semantic import SemanticRetriever

__all__ = [
    "AllDocumentsRetriever",
    "Bm25Retriever",
    "ChargramRetriever",
    "EnsembleRetriever",
    "LateInteractionRetriever",
    "SemanticRetriever",
]
