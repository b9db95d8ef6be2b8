"""Chunk statistics printed into indexing stages.

Counterpart of the reference's print_stats.py (chunk count + size
distribution written to the user-visible stage content so indexing
behavior is observable without logs)."""

import statistics


def format_chunk_stats(chunks) -> str:
    """One-line chunk count + text-size distribution summary."""
    if not chunks:
        return "Chunks: 0\n"
    sizes = [len(c.text.encode("utf-8")) for c in chunks]
    pages = {c.page_number for c in chunks if c.page_number is not None}
    parts = [
        f"Chunks: {len(sizes)}",
        f"total {sum(sizes)} B",
        f"median {int(statistics.median(sizes))} B",
        f"max {max(sizes)} B",
    ]
    if pages:
        parts.append(f"pages {len(pages)}")
    return ", ".join(parts) + "\n"


def print_chunk_stats(stream, chunks) -> None:
    stream.write(format_chunk_stats(chunks))
