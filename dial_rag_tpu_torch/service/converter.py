"""Office -> PDF conversion (mirror of reference converter.py).

Uses the LibreOffice `soffice` binary when present, serialized by a
1-slot semaphore (LibreOffice cannot run concurrent instances under one
profile). When the binary is absent (minimal TPU images), office
documents fail with a clear InvalidDocumentError instead of garbage
parses."""

import asyncio
import logging
import shutil
import tempfile
from pathlib import Path

from dial_rag_tpu_torch.documents.mime import MIME_PDF, OFFICE_MIMES
from dial_rag_tpu_torch.errors import InvalidDocumentError

logger = logging.getLogger(__name__)

_converter_semaphore = asyncio.Semaphore(1)
CONVERT_TIMEOUT_S = 300.0

_EXT_BY_MIME = {
    "application/msword": ".doc",
    "application/vnd.openxmlformats-officedocument.wordprocessingml.document": ".docx",
    "application/vnd.ms-powerpoint": ".ppt",
    "application/vnd.openxmlformats-officedocument.presentationml.presentation": ".pptx",
    "application/vnd.ms-powerpoint.presentation.macroenabled.12": ".pptm",
    "application/vnd.oasis.opendocument.text": ".odt",
    "application/vnd.oasis.opendocument.presentation": ".odp",
}


def needs_conversion(mime_type: str) -> bool:
    return mime_type in OFFICE_MIMES


def soffice_available() -> bool:
    return shutil.which("soffice") is not None


async def convert_to_pdf(document_bytes: bytes, mime_type: str) -> bytes:
    if not soffice_available():
        raise InvalidDocumentError(
            "Office document conversion requires LibreOffice (soffice), "
            "which is not available in this deployment. Please convert the "
            "document to PDF and try again."
        )
    ext = _EXT_BY_MIME.get(mime_type, ".doc")
    async with _converter_semaphore:  # LibreOffice is single-instance
        with tempfile.TemporaryDirectory() as tmpdir:
            src = Path(tmpdir) / f"document{ext}"
            src.write_bytes(document_bytes)
            proc = await asyncio.create_subprocess_exec(
                "soffice",
                "--headless",
                "--convert-to",
                "pdf",
                "--outdir",
                tmpdir,
                str(src),
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
            )
            # the port bounds every subprocess it starts (the JAX
            # package's conversion waits without a limit)
            try:
                stdout, stderr = await asyncio.wait_for(
                    proc.communicate(), CONVERT_TIMEOUT_S
                )
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
                raise InvalidDocumentError(
                    "The office document conversion timed out."
                ) from None
            out = Path(tmpdir) / "document.pdf"
            if proc.returncode != 0 or not out.exists():
                logger.warning(
                    f"soffice failed ({proc.returncode}): {stderr!r}"
                )
                raise InvalidDocumentError(
                    "Failed to convert the office document to PDF."
                )
            return out.read_bytes()


async def convert_document_if_needed(
    mime_type: str, document_bytes: bytes, stageio
) -> tuple[str, bytes]:
    """Returns (effective mime, effective bytes).

    With LibreOffice present, office files become PDFs (page-image
    retrieval then works on them). Without it, zip-based formats
    (docx/pptx/odt/odp) fall through unchanged: the first-party OOXML/
    ODF parser (documents/office.py) extracts their text directly, so
    text retrieval keeps working on minimal images.
    """
    if not needs_conversion(mime_type):
        return mime_type, document_bytes
    if not soffice_available():
        from dial_rag_tpu_torch.documents.office import NATIVE_OFFICE_MIMES

        if mime_type in NATIVE_OFFICE_MIMES:
            stageio.write(
                "LibreOffice unavailable; using native text extraction "
                "(no page images)\n"
            )
            return mime_type, document_bytes
    stageio.write(f"Converting {mime_type} to PDF\n")
    pdf_bytes = await convert_to_pdf(document_bytes, mime_type)
    return MIME_PDF, pdf_bytes
