"""Per-document indexing outcomes + user-facing error aggregation
(mirror of reference indexing_results.py + indexing_api.py helpers)."""

from dataclasses import dataclass
from typing import Generator

from dial_rag_tpu_torch.documents.model import DocumentRecord
from dial_rag_tpu_torch.errors import DialRagError
from dial_rag_tpu_torch.service.api import (
    DocumentIndexingResultResponse,
    IndexingError,
    IndexingResponse,
)
from dial_rag_tpu_torch.service.dial_client import INDEX_MIME_TYPE
from dial_rag_tpu_torch.service.indexing_task import IndexingTask
from dial_rag_tpu_torch.service.protocol import Attachment


@dataclass
class DocumentIndexingResult:
    task: IndexingTask


@dataclass
class DocumentIndexingSuccess(DocumentIndexingResult):
    doc_record: DocumentRecord


@dataclass
class DocumentIndexingFailure(DocumentIndexingResult):
    exception: Exception

    def iter_leaf_exceptions(self) -> Generator[BaseException, None, None]:
        yield from _iter_leaf_exceptions(self.exception)


def _iter_leaf_exceptions(exception: BaseException):
    if isinstance(exception, BaseExceptionGroup):
        for inner in exception.exceptions:
            yield from _iter_leaf_exceptions(inner)
    else:
        yield exception


def get_indexing_failures(
    indexing_results: list[DocumentIndexingResult],
) -> list[DocumentIndexingFailure]:
    return [
        r for r in indexing_results if isinstance(r, DocumentIndexingFailure)
    ]


def get_status_code(leaf_exception: BaseException) -> int:
    if isinstance(leaf_exception, DialRagError):
        return leaf_exception.status_code
    return 500


def get_user_facing_error_message(leaf_exception: BaseException) -> str:
    if isinstance(leaf_exception, DialRagError):
        return leaf_exception.message.replace("\n", " ")
    if isinstance(leaf_exception, TimeoutError):
        return "Timed out during download"
    return "Internal error"


def _table_cell(text: str) -> str:
    """Pipes/newlines in file names would break the markdown table."""
    return text.replace("|", "\\|").replace("\n", " ").replace("\r", " ")


def format_document_loading_errors(
    failures: list[DocumentIndexingFailure],
) -> str:
    return "\n".join(
        [
            "I'm sorry, but I can't process the documents because of the "
            "following errors:\n",
            "|Document|Error|",
            "|---|---|",
            *(
                f"|{_table_cell(failure.task.attachment_link.display_name)}|"
                f"{_table_cell(get_user_facing_error_message(exception))}|"
                for failure in failures
                for exception in failure.iter_leaf_exceptions()
            ),
            "\nPlease try again with different documents.",
        ]
    )


def create_document_loading_exception(
    failures: list[DocumentIndexingFailure],
) -> DialRagError:
    # 4xx beats 5xx: user-input errors take priority
    status_code = min(
        get_status_code(exception)
        for failure in failures
        for exception in failure.iter_leaf_exceptions()
    )
    error = DialRagError(format_document_loading_errors(failures))
    error.status_code = status_code
    return error


def create_indexing_response(
    indexing_results: list[DocumentIndexingResult],
) -> IndexingResponse:
    result: dict[str, DocumentIndexingResultResponse] = {}
    for r in indexing_results:
        if isinstance(r, DocumentIndexingFailure):
            result[r.task.attachment_link.dial_link] = (
                DocumentIndexingResultResponse(
                    errors=[
                        IndexingError(
                            message=get_user_facing_error_message(e)
                        )
                        for e in r.iter_leaf_exceptions()
                    ]
                )
            )
    return IndexingResponse(indexing_result=result)


def create_indexing_results_attachments(
    indexing_results: list[DocumentIndexingResult],
) -> list[Attachment]:
    attachments: list[Attachment] = []
    for r in indexing_results:
        if isinstance(r, DocumentIndexingSuccess):
            attachments.append(
                Attachment(
                    type=INDEX_MIME_TYPE,
                    url=r.task.index_url,
                    reference_url=r.task.attachment_link.dial_link,
                )
            )
    response = create_indexing_response(indexing_results)
    attachments.append(
        Attachment(
            title="Indexing results",
            type=response.CONTENT_TYPE,
            data=response.model_dump_json(),
        )
    )
    return attachments
