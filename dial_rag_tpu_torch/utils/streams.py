"""Composable write-streams feeding user-visible stages and logs
(mirrors reference content_stream.py: prefix/markdown/logger/multi)."""

import logging

_logger = logging.getLogger(__name__)


class StreamWithPrefix:
    def __init__(self, stream, prefix: str):
        self.stream = stream
        self.prefix = prefix

    def write(self, content: str):
        if not content.strip(" \n"):
            # keep-alive/empty writes pass through unprefixed (dropping
            # them would break keep-alive semantics downstream)
            self.stream.write(content)
            return
        self.stream.write(f"{self.prefix} {content}")


class MarkdownStream:
    def __init__(self, stream):
        self.stream = stream

    def write(self, content: str):
        self.stream.write(f"{content}\n\n")


class LoggerStream:
    def __init__(self, logger=_logger, log_level: int = logging.INFO):
        self.logger = logger
        self.log_level = log_level

    def write(self, content: str):
        if message := content.strip(" \n"):
            self.logger.log(self.log_level, message)


class MultiStream:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, content: str):
        for stream in self.streams:
            stream.write(content)


class NullStream:
    def write(self, content: str):
        pass
