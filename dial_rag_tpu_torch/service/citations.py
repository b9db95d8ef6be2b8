"""Streamed citation rewriting.

The LLM is prompted to cite context chunks as ``<[n]>`` (1-based index
into the retrieved chunks). This transformer rewrites the streamed
answer so users see compact ``[k]`` references numbered by first use,
and reports which chunks were actually cited. Behavioral contract
matches the reference (reference qa_chain.py:144-195):

- tags may be split across stream chunks ("… <[" | "1]> …");
- out-of-bounds ids (e.g. a literal "[23]" inside document content)
  pass through unchanged with a warning;
- each distinct cited chunk gets the next reference number at first
  use; repeats reuse it;
- after the stream ends, cited chunks are reported in first-use order.

Mechanism: complete tags in the buffered text are renumbered with one
regex substitution, and the only text held back is a trailing suffix
that is still a proper prefix of a tag (``<``, ``<[``, ``<[12``,
``<[12]``) — everything else streams out immediately, so a stray
``<[`` mid-text does not stall emission until stream end.
"""

import logging
import re
from typing import AsyncIterator

logger = logging.getLogger(__name__)

REF_PATTERN = re.compile(r"<\[(\d+)\]>")
# a trailing fragment that could still grow into a complete tag
_PARTIAL_TAG = re.compile(r"<(\[\d*\]?)?$")


async def rewrite_citations(
    answer_stream: AsyncIterator[str],
    num_found_items: int,
) -> AsyncIterator[tuple[str, list[int] | None]]:
    """Yields (text_piece, None) for rewritten answer text, then finally
    ("", used_chunk_indices) with 0-based indices of cited chunks in
    first-use order."""
    cited: list[int] = []  # 0-based chunk indices, first-use order

    def renumber(match: re.Match) -> str:
        raw_id = int(match.group(1))
        if not (1 <= raw_id <= num_found_items):
            logger.warning(
                "Chunk ID in model response is out of bounds: "
                f"{raw_id} / {num_found_items}"
            )
            return match.group(0)
        chunk = raw_id - 1
        if chunk not in cited:
            cited.append(chunk)
        return f"[{cited.index(chunk) + 1}]"

    held = ""
    async for piece in answer_stream:
        pending = held + piece
        partial = _PARTIAL_TAG.search(pending)
        boundary = partial.start() if partial else len(pending)
        ready, held = pending[:boundary], pending[boundary:]
        text = REF_PATTERN.sub(renumber, ready)
        if text:
            yield text, None

    if held:  # an unterminated tag fragment flushes verbatim
        yield held, None

    yield "", cited
