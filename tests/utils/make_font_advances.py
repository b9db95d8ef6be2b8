"""Writes ``dial_rag_tpu_torch/documents/pdf/_font_advances.py``: the
whole-pixel advances that FreeType's auto-hinter gives each glyph of the
port's page font (Aileron Regular, the font of Pillow's
``ImageFont.load_default``) at 1 to MAX_SIZE pixels per em, as Pillow's
basic layout reads them (``FreeTypeFont.getlength`` of one character).

The auto-hinter moves a glyph's edges to the pixel grid and its advance
with them, so about a quarter of these advances differ by a pixel from
the rounded linear advance; a line of text drifts by several pixels
without them. This is what a TrueType ``hdmx`` table holds, which the
font lacks. The table stores each advance's difference from the rounded
linear advance, zlib-compressed.

Run from the repository root: ``python -m tests.utils.make_font_advances``.
"""

import base64
import math
import zlib
from pathlib import Path

from PIL import ImageFont

from dial_rag_tpu_torch.documents.pdf._font import DEFAULT_FONT

MAX_SIZE = 256
OUT = Path(__file__).resolve().parents[2] / "dial_rag_tpu_torch" / "documents" / "pdf" / "_font_advances.py"


def main() -> None:
    font = DEFAULT_FONT
    char_of = {0: "￿"}  # a character the cmap lacks draws glyph 0
    for code, gid in sorted(font.cmap.items()):
        char_of.setdefault(gid, chr(code))
    rows = bytearray()
    for size in range(1, MAX_SIZE + 1):
        pil = ImageFont.load_default(size=size)
        for gid in range(font.num_glyphs):
            char = char_of.get(gid)
            linear = int(math.floor(font.advances[gid] * size / font.units_per_em + 0.5))
            delta = 0 if char is None else int(pil.getlength(char)) - linear
            assert -8 < delta < 8, (size, gid, delta)
            rows.append(delta + 8)
    text = base64.b64encode(zlib.compress(bytes(rows), 9)).decode()
    lines = "\n".join(text[i:i + 76] for i in range(0, len(text), 76))
    OUT.write_text(
        '"""Hinted whole-pixel advances of the page font: for each size 1 to\n'
        "MAX_SIZE pixels per em and each glyph, the advance FreeType's\n"
        "auto-hinter gives minus the rounded linear advance, plus 8, one byte\n"
        "each, zlib-compressed. Written by tests/utils/make_font_advances.py;\n"
        'do not edit."""\n\n'
        f"MAX_SIZE = {MAX_SIZE}\n"
        f"NUM_GLYPHS = {font.num_glyphs}\n"
        f'DELTAS = b"""\n{lines}\n"""\n'
    )


if __name__ == "__main__":
    main()
