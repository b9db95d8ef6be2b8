from dial_rag_tpu_torch.documents.pdf.document import PdfDocument, PdfError
from dial_rag_tpu_torch.documents.pdf.text import PageText, TextBlock, extract_pages_text

__all__ = [
    "PdfDocument",
    "PdfError",
    "PageText",
    "TextBlock",
    "extract_pages_text",
]
