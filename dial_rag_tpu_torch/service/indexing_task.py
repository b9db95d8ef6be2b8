"""Indexing tasks: content-addressed index URLs + user-supplied index
attachments (mirror of reference indexing_task.py)."""

import re
from dataclasses import dataclass

from dial_rag_tpu_torch.errors import InvalidAttachmentError, InvalidDocumentError
from dial_rag_tpu_torch.service.attachments import AttachmentLink
from dial_rag_tpu_torch.service.dial_client import INDEX_MIME_TYPE, DialApiClient
from dial_rag_tpu_torch.storage.storage import link_to_index_url

INDEX_MIME_TYPES_REGEX = re.compile(r"^application/x\.aidial-rag\.index\.")


@dataclass(frozen=True)
class IndexingTask:
    attachment_link: AttachmentLink
    index_url: str


def _is_rag_index(attachment: AttachmentLink) -> bool:
    if attachment.type is None:
        return False
    if not INDEX_MIME_TYPES_REGEX.match(attachment.type):
        return False
    if attachment.type != INDEX_MIME_TYPE:
        raise InvalidDocumentError(f"Unknown index type: {attachment.type}")
    if not attachment.reference_url:
        raise InvalidDocumentError(
            "Index attachment must have a reference URL"
        )
    return True


def is_in_dial_rag_bucket(url: str, bucket_id: str) -> bool:
    # trailing slash: bucket 'abc' must not claim 'files/abcdef/...'
    return url.startswith(f"files/{bucket_id}/")


def validate_indexing_task(
    task: IndexingTask, dial_api_client: DialApiClient
) -> None:
    """A user-supplied index URL inside the RAG bucket must match the
    content-addressed path, or it could overwrite another document's
    index."""
    index_url = task.index_url
    if not is_in_dial_rag_bucket(index_url, dial_api_client.bucket_id):
        return  # Dial Core enforces access for foreign buckets
    expected = link_to_index_url(
        task.attachment_link.dial_link, dial_api_client.bucket_id
    )
    if index_url != expected:
        raise InvalidAttachmentError(
            f"Index URL {index_url} does not match the expected index path "
            f"{expected}."
        )


def create_indexing_tasks(
    attachment_links: list[AttachmentLink],
    dial_api_client: DialApiClient,
) -> list[IndexingTask]:
    # single pass: validation side effects (unknown index type, missing
    # reference) run exactly once per attachment
    index_attachments: dict[str, str] = {}
    document_links: list[AttachmentLink] = []
    for a in attachment_links:
        if _is_rag_index(a):
            ref = str(a.reference_url)
            index_attachments[ref] = a.dial_link
            # also key the normalized dial-relative form so an absolute
            # reference matches a relatively-attached document and
            # vice versa
            for prefix in ("/v1/", "v1/"):
                marker = f"{prefix}files/"
                if marker in ref:
                    index_attachments.setdefault(
                        "files/" + ref.split(marker, 1)[1], a.dial_link
                    )
        else:
            document_links.append(a)
    return [
        IndexingTask(
            attachment_link=link,
            index_url=(
                index_attachments.get(link.dial_link)
                or link_to_index_url(link.dial_link, dial_api_client.bucket_id)
            ),
        )
        for link in document_links
    ]
