"""By-title chunking of parsed document elements.

Reproduces the semantics the reference gets from unstructured's
``chunking_strategy="by_title"`` with ``max_characters=new_after_n_chars=
1000``, ``multipage_sections=False`` and ``combine_text_under_n_chars=0``
(document_loaders.py:215-232):

- a Title element always starts a new chunk (its text is included at the
  head of the chunk);
- chunks never span pages (multipage_sections=False);
- a chunk closes once adding the next element would exceed
  ``max_characters``; elements join with "\n\n";
- a single oversized element is hard-split at word boundaries where
  possible;
- no post-merging of small chunks (combine_under=0).
"""

from dataclasses import dataclass, field


@dataclass
class Element:
    text: str
    is_title: bool = False
    page_number: int | None = None
    metadata: dict = field(default_factory=dict)


def _split_oversized(text: str, max_characters: int) -> list[str]:
    parts = []
    while len(text) > max_characters:
        cut = text.rfind(" ", 1, max_characters + 1)
        if cut <= 0:
            cut = max_characters
        parts.append(text[:cut].rstrip())
        text = text[cut:].lstrip()
    if text:
        parts.append(text)
    return parts


def chunk_by_title(
    elements: list[Element], max_characters: int = 1000
) -> list[tuple[str, dict]]:
    """Elements -> list of (chunk_text, metadata). Metadata carries the
    page_number of the chunk's first element (when known) plus any shared
    element metadata."""
    chunks: list[tuple[str, dict]] = []
    current: list[str] = []
    current_len = 0
    current_meta: dict = {}

    def flush():
        nonlocal current, current_len, current_meta
        if current:
            chunks.append(("\n\n".join(current), dict(current_meta)))
        current = []
        current_len = 0
        current_meta = {}

    prev_page: int | None = None
    for el in elements:
        text = el.text.strip()
        if not text:
            continue
        page_changed = (
            el.page_number is not None
            and prev_page is not None
            and el.page_number != prev_page
        )
        is_table = el.metadata.get("category") == "table"
        if el.is_title or page_changed or is_table:
            flush()
        if el.page_number is not None:
            prev_page = el.page_number

        for piece in _split_oversized(text, max_characters):
            added = len(piece) + (2 if current else 0)
            if current and current_len + added > max_characters:
                flush()
            if not current:
                current_meta = dict(el.metadata)
                if el.page_number is not None:
                    current_meta["page_number"] = el.page_number
            current.append(piece)
            current_len += len(piece) + (2 if current_len else 0)
        if is_table:
            # tables are isolated chunks (the reference's chunker gives
            # Table elements their own chunk)
            flush()

    flush()
    return chunks
