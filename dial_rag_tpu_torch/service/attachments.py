"""Attachment link resolution.

Covers the reference's attachment-link behavior (reference
attachment_link.py): a link arriving in message custom_content may be
Dial-relative (``files/<bucket>/<path>``), an absolute URL into the
Dial file API, or an absolute external URL. Each resolves to one
``AttachmentLink`` carrying the canonical Dial-relative form (for Dial
API calls), the absolute URL (for fetching), the user-facing display
name (bucket stripped, percent-decoding applied), and the metadata URL
when the file lives in Dial.

Resolution here is a single pass over the link text: Dial-relative
forms are recovered by stripping the Dial base prefix (which preserves
query/fragment verbatim), and path checks run on the raw ``/``-split
segments. Malformed links raise ``InvalidAttachmentError`` (a curated
400) — never an assert.
"""

from typing import Iterator
from urllib.parse import unquote, urljoin, urlparse

from dial_rag_tpu_torch.service._model import BaseModel

from dial_rag_tpu_torch.errors import InvalidAttachmentError
from dial_rag_tpu_torch.service.messages import Message, Role
from dial_rag_tpu_torch.service.request_context import RequestContext


def _dial_relative(absolute_url: str, base_url: str) -> str:
    """The path of a Dial URL relative to the Dial API base."""
    if not absolute_url.startswith(base_url):
        raise InvalidAttachmentError(
            f"Dial URL is outside the Dial API base: {absolute_url}"
        )
    return absolute_url[len(base_url) :]


def _display_name(link: str) -> str:
    """External URLs display verbatim; Dial-relative links must be
    ``files/<bucket>/<path...>`` and display as the percent-decoded
    path with the bucket stripped."""
    parsed = urlparse(link)
    if parsed.netloc:
        return link
    if parsed.path.startswith("/"):
        raise InvalidAttachmentError(f"Dial link is not relative: {link}")
    segments = [s for s in parsed.path.split("/") if s]
    if segments[:1] != ["files"]:
        raise InvalidAttachmentError(
            f"Dial link is not a link to files: {link}"
        )
    if len(segments) < 3:
        raise InvalidAttachmentError(f"Missing bucket in Dial link: {link}")
    return "/".join(unquote(s) for s in segments[2:])


class AttachmentLink(BaseModel):
    """dial_link: the original (possibly relative) URL used to refer to
    the attachment in Dial APIs; absolute_url: for fetching content;
    display_name: user-visible name without the bucket."""

    dial_link: str
    absolute_url: str
    display_name: str
    dial_metadata_url: str | None = None
    type: str | None = None
    reference_url: str | None = None

    def __str__(self) -> str:
        return self.dial_link

    @property
    def is_dial_document(self) -> bool:
        return self.dial_metadata_url is not None

    @classmethod
    def from_link(
        cls,
        request_context: RequestContext,
        link: str,
        type: str | None = None,
        reference_url: str | None = None,
    ) -> "AttachmentLink":
        base_url = request_context.dial_base_url
        absolute_url = urljoin(base_url, link, allow_fragments=True)
        in_dial = request_context.is_dial_url(absolute_url)
        if in_dial and link == absolute_url:
            # the caller handed us the absolute form; Dial APIs want
            # the relative one
            link = _dial_relative(absolute_url, base_url)
        return cls(
            dial_link=link,
            absolute_url=absolute_url,
            display_name=_display_name(link),
            dial_metadata_url=(
                urljoin(
                    request_context.dial_metadata_base_url,
                    link,
                    allow_fragments=True,
                )
                if in_dial
                else None
            ),
            type=type,
            reference_url=reference_url,
        )


def get_attachment_links(
    request_context: RequestContext, messages: list[Message]
) -> Iterator[AttachmentLink]:
    """Attachment links from user messages, in message order."""
    for message in messages:
        if message.role != Role.USER:
            continue
        custom_content = message.custom_content
        if custom_content is None:
            continue
        for attachment in custom_content.attachments or []:
            if attachment.url is None:
                raise InvalidAttachmentError(
                    "An attachment is missing its URL."
                )
            yield AttachmentLink.from_link(
                request_context,
                attachment.url,
                attachment.type,
                attachment.reference_url,
            )
