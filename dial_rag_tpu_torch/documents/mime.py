"""Content-type normalization and magic sniffing (first-party libmagic-lite)."""

MIME_PDF = "application/pdf"
MIME_HTML = "text/html"
MIME_PLAIN = "text/plain"
MIME_CSV = "text/csv"
MIME_MARKDOWN = "text/markdown"

IMAGE_MIMES = {
    "image/png",
    "image/jpeg",
    "image/bmp",
    "image/tiff",
    "image/gif",
    "image/webp",
}

OFFICE_MIMES = {
    "application/msword",
    "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    "application/vnd.ms-powerpoint",
    "application/vnd.openxmlformats-officedocument.presentationml.presentation",
    "application/vnd.ms-powerpoint.presentation.macroenabled.12",
    "application/vnd.oasis.opendocument.text",
    "application/vnd.oasis.opendocument.presentation",
}

_EXT_TO_MIME = {
    ".pdf": MIME_PDF,
    ".html": MIME_HTML,
    ".htm": MIME_HTML,
    ".txt": MIME_PLAIN,
    ".md": MIME_MARKDOWN,
    ".csv": MIME_CSV,
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".bmp": "image/bmp",
    ".tif": "image/tiff",
    ".tiff": "image/tiff",
    ".gif": "image/gif",
    ".webp": "image/webp",
    ".doc": "application/msword",
    ".docx": "application/vnd.openxmlformats-officedocument.wordprocessingml.document",
    ".ppt": "application/vnd.ms-powerpoint",
    ".pptx": "application/vnd.openxmlformats-officedocument.presentationml.presentation",
    ".pptm": "application/vnd.ms-powerpoint.presentation.macroenabled.12",
    ".odt": "application/vnd.oasis.opendocument.text",
    ".odp": "application/vnd.oasis.opendocument.presentation",
    ".xlsx": (
        "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet"
    ),
}

_MAGIC = [
    (b"%PDF-", MIME_PDF),
    (b"\x89PNG\r\n\x1a\n", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"II*\x00", "image/tiff"),
    (b"MM\x00*", "image/tiff"),
    (b"GIF87a", "image/gif"),
    (b"GIF89a", "image/gif"),
]


def _looks_like_bmp(data: bytes) -> bool:
    """'BM' alone matches ordinary text ("BMW sales..."); require the BMP
    header's reserved words to be zero and a sane header size too."""
    return (
        len(data) >= 18
        and data[:2] == b"BM"
        and data[6:10] == b"\x00\x00\x00\x00"
        and data[14] in (12, 40, 52, 56, 108, 124)
    )


def normalize_content_type(content_type: str) -> str:
    """Strip parameters: 'text/html; charset=utf-8' -> 'text/html'."""
    return content_type.split(";", 1)[0].strip().lower()


def mime_from_name(name: str) -> str | None:
    name = name.lower()
    for ext, mime in _EXT_TO_MIME.items():
        if name.endswith(ext):
            return mime
    return None


def sniff_mime(data: bytes) -> str | None:
    if _looks_like_bmp(data):
        return "image/bmp"
    head = data[:16]
    for magic, mime in _MAGIC:
        if head.startswith(magic):
            return mime
    if head[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "image/webp"
    return None


def detect_mime(
    content_type: str | None, file_name: str | None, data: bytes
) -> str:
    """Resolve the effective mime: sniffed magic wins over generic headers;
    declared types win over extensions."""
    declared = (
        normalize_content_type(content_type) if content_type else None
    )
    if declared in (None, "", "application/octet-stream", "binary/octet-stream"):
        declared = None
    sniffed = sniff_mime(data)
    by_name = mime_from_name(file_name) if file_name else None
    if sniffed:
        # a declared text type with PDF magic etc. is wrong; trust magic
        return sniffed
    if declared:
        return declared
    if by_name:
        return by_name
    # last resort: decodable as text?
    try:
        data[:4096].decode("utf-8")
        return MIME_PLAIN
    except UnicodeDecodeError:
        return "application/octet-stream"


def are_image_pages_supported(mime: str) -> bool:
    return mime == MIME_PDF or mime in IMAGE_MIMES
