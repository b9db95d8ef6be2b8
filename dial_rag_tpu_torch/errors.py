"""Error taxonomy (mirrors reference aidial_rag/errors.py semantics:
4xx user errors vs 5xx processing errors, per-document isolation)."""


class DialRagError(Exception):
    status_code: int = 500

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class InvalidDocumentError(DialRagError):
    status_code = 400


class InvalidAttachmentError(DialRagError):
    status_code = 400


class InvalidConfigurationError(DialRagError):
    status_code = 400


class RateLimitError(DialRagError):
    status_code = 429


class NotEnoughDailyTokensError(RateLimitError):
    pass


class DocumentProcessingError(DialRagError):
    """Wraps a per-document failure; the message must not leak the full
    document link (the reference redacts it — errors.py:53-70)."""

    def __init__(self, display_name: str, cause: Exception):
        self.cause = cause
        status = getattr(cause, "status_code", 500)
        self.status_code = status if isinstance(status, int) else 500
        # our own error types carry safe messages; foreign exceptions
        # (e.g. aiohttp's ClientResponseError) embed the full document
        # URL in str() — redact to the type name
        message = getattr(cause, "message", None)
        if not isinstance(message, str) or not message:
            message = (
                str(cause)
                if isinstance(cause, DialRagError)
                else type(cause).__name__
            )
        super().__init__(
            f"Unable to process document '{display_name}': {message}"
        )


class NotPortedError(DialRagError, NotImplementedError):
    """A part of the service the port does not serve yet; the message
    names its ROADMAP item. A ``DialRagError``, so a per-document failure
    carries the message into the indexing result."""

    status_code = 501
