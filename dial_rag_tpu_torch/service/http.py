"""HTTP/1.1 on ``asyncio`` streams: the server the service answers on and
the client it calls Dial Core with (the card's machine has no aiohttp).
The names are aiohttp's, for what the service uses of it.

Server (``Application``, ``serve``, ``run_app``): routes by method and
path (``{name}`` and ``{name:regex}`` segments into ``match_info``);
``Content-Length`` and chunked request bodies up to ``client_max_size``
(413 beyond it), ``Expect: 100-continue``; keep-alive; ``json_response``,
``Response`` and ``StreamResponse`` (chunked transfer encoding, each
``write`` flushed to the socket); 404 and 405 bodies as aiohttp writes
them. A handler is cancelled when its client goes away (the connection
reaches EOF, or a write fails), so a streamed pipeline never runs on for
a dead connection. Every read has a timeout.

Client (``ClientSession``): ``base_url`` joined as aiohttp joins it
(absolute URLs stand as they are); GET, HEAD, PUT and POST with headers,
``params``, a JSON body or a ``FormData`` (``multipart/form-data``) body;
``raise_for_status``; a response read whole (``read``, ``json``,
``text``) or line by line (``async for line in response.content``);
``ClientTimeout`` (total, connect, sock_connect, sock_read; by default
aiohttp's 300 s total and 30 s connect); ``http`` and ``https`` (through
``ssl.create_default_context()``). Errors: ``ClientError`` ⊃
``ClientConnectionError`` ⊃ ``ServerTimeoutError`` (also an
``asyncio.TimeoutError``), and ``ClientResponseError(status, message)``."""

import asyncio
import json
import json as _json
import logging
import re
import ssl
import uuid
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, urlencode, urljoin, urlsplit

logger = logging.getLogger(__name__)

REASONS = {
    100: "Continue", 200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed", 408: "Request Timeout",
    413: "Request Entity Too Large", 429: "Too Many Requests", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}
MAX_LINE = 8190
MAX_HEADERS = 100
KEEPALIVE_TIMEOUT = 75.0  # aiohttp's keepalive_timeout
READ_TIMEOUT = 60.0  # a request's header lines and each body read
DISCONNECT_POLL_S = 0.25


class Headers:
    """Case-insensitive multi-valued header map (insertion order kept)."""

    def __init__(self, items=None):
        self._items: list[tuple[str, str]] = []
        if isinstance(items, Headers):
            self._items = list(items._items)
        elif isinstance(items, dict):
            self._items = [(str(k), str(v)) for k, v in items.items()]
        elif items:
            self._items = [(str(k), str(v)) for k, v in items]

    def get(self, name: str, default=None):
        name = name.lower()
        for k, v in self._items:
            if k.lower() == name:
                return v
        return default

    def __getitem__(self, name: str) -> str:
        value = self.get(name)
        if value is None:
            raise KeyError(name)
        return value

    def __setitem__(self, name: str, value) -> None:
        self._items = [(k, v) for k, v in self._items if k.lower() != name.lower()]
        self._items.append((name, str(value)))

    def setdefault(self, name: str, value) -> str:
        if name not in self:
            self[name] = value
        return self[name]

    def __contains__(self, name) -> bool:
        return self.get(name) is not None

    def items(self):
        return list(self._items)

    def keys(self):
        return [k for k, _ in self._items]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._items)

    def __repr__(self) -> str:
        return f"Headers({self._items!r})"


def _content_type(headers: Headers) -> str:
    return (headers.get("Content-Type") or "").split(";")[0].strip().lower()


async def _read_line(reader: asyncio.StreamReader, timeout: float | None) -> bytes:
    try:
        line = await asyncio.wait_for(reader.readuntil(b"\n"), timeout)
    except asyncio.LimitOverrunError as e:
        raise _BadRequest(400, "line too long") from e
    except asyncio.IncompleteReadError as e:
        if e.partial:
            raise _BadRequest(400, "incomplete line") from e
        raise EOFError from e
    if len(line) > MAX_LINE + 2:
        raise _BadRequest(400, "line too long")
    return line.rstrip(b"\r\n")


async def _read_headers(reader, timeout) -> Headers:
    headers = Headers()
    while True:
        line = await _read_line(reader, timeout)
        if not line:
            return headers
        if len(headers) >= MAX_HEADERS:
            raise _BadRequest(431, "too many headers")
        name, sep, value = line.decode("latin-1").partition(":")
        if not sep or not name or name != name.strip():
            raise _BadRequest(400, f"bad header line {line[:80]!r}")
        headers._items.append((name, value.strip()))


class _BadRequest(Exception):
    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


# --- server -------------------------------------------------------------------


class Request:
    def __init__(self, method: str, target: str, version: str, headers: Headers, body: bytes, app):
        self.method = method
        parts = urlsplit(target)
        self.path = parts.path
        self.query = dict(parse_qsl(parts.query, keep_blank_values=True))
        self.version = version
        self.headers = headers
        self._body = body
        self.app = app
        self.match_info: dict[str, str] = {}
        self._writer: asyncio.StreamWriter | None = None
        self._streamed = False

    async def read(self) -> bytes:
        return self._body

    async def json(self, loads=json.loads):
        return loads(self._body.decode("utf-8"))


class StreamResponse:
    def __init__(self, *, status: int = 200, reason: str | None = None, headers=None):
        self.status = status
        self.reason = reason or REASONS.get(status, "Unknown")
        self.headers = Headers(headers)
        self._writer: asyncio.StreamWriter | None = None
        self._chunked = False
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._writer is not None

    def _head(self) -> bytes:
        lines = [f"HTTP/1.1 {self.status} {self.reason}"]
        lines += [f"{k}: {v}" for k, v in self.headers.items()]
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def prepare(self, request: Request) -> "StreamResponse":
        if self._writer is not None:
            return self
        writer = request._writer
        if "Content-Length" not in self.headers:
            self._chunked = True
            self.headers["Transfer-Encoding"] = "chunked"
        self.headers.setdefault("Content-Type", "application/octet-stream")
        writer.write(self._head())
        self._writer = writer
        request._streamed = True
        await _drain(writer)
        return self

    async def write(self, data: bytes) -> None:
        if self._writer is None:
            raise RuntimeError("write() before prepare()")
        if not data:
            return
        if self._chunked:
            self._writer.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        else:
            self._writer.write(data)
        await _drain(self._writer)

    async def write_eof(self) -> None:
        if self._eof:
            return
        if self._chunked:
            self._writer.write(b"0\r\n\r\n")
            await _drain(self._writer)
        self._eof = True


async def _drain(writer: asyncio.StreamWriter) -> None:
    if writer.transport.is_closing():
        raise ConnectionResetError("client disconnected")
    await writer.drain()


class Response(StreamResponse):
    def __init__(self, *, body: bytes | str | None = None, text: str | None = None, status: int = 200,
                 reason: str | None = None, headers=None, content_type: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if text is not None:
            body = text
            content_type = content_type or "text/plain"
            charset = charset or "utf-8"
        if isinstance(body, str):
            charset = charset or "utf-8"
            body = body.encode(charset)
        self.body = body or b""
        if content_type:
            self.headers["Content-Type"] = f"{content_type}; charset={charset}" if charset else content_type
        self.headers["Content-Length"] = str(len(self.body))

    async def _send(self, writer: asyncio.StreamWriter, head_only: bool) -> None:
        self.headers.setdefault("Content-Type", "application/octet-stream")
        writer.write(self._head() + (b"" if head_only else self.body))
        await _drain(writer)


def json_response(data: Any = None, *, status: int = 200, headers=None, dumps=json.dumps) -> Response:
    return Response(text=dumps(data), status=status, headers=headers, content_type="application/json")


class HTTPException(Exception):
    status = 500

    def __init__(self, text: str | None = None):
        self.text = text if text is not None else f"{self.status}: {REASONS.get(self.status, 'Error')}"
        super().__init__(self.text)


class HTTPNotFound(HTTPException):
    status = 404


Handler = Callable[[Request], Awaitable[StreamResponse]]


class _Route:
    def __init__(self, method: str, path: str, handler: Handler):
        self.method = method
        self.handler = handler
        pattern, pos = "", 0
        for m in re.finditer(r"\{(\w+)(?::([^{}]+))?\}", path):
            pattern += re.escape(path[pos : m.start()]) + f"(?P<{m.group(1)}>{m.group(2) or '[^{}/]+'})"
            pos = m.end()
        self.regex = re.compile("^" + pattern + re.escape(path[pos:]) + "$")


class Router:
    def __init__(self):
        self.routes: list[_Route] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self.routes.append(_Route(method.upper(), path, handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_put(self, path: str, handler: Handler) -> None:
        self.add_route("PUT", path, handler)

    def resolve(self, method: str, path: str) -> tuple[_Route | None, dict, list[str]]:
        allowed: list[str] = []
        for route in self.routes:
            m = route.regex.match(path)
            if m is None:
                continue
            if route.method == method:
                return route, m.groupdict(), []
            allowed.append(route.method)
        return None, {}, allowed


class Application:
    def __init__(self, *, client_max_size: int = 1024**2):
        self.client_max_size = client_max_size
        self.router = Router()
        self.on_startup: list[Callable[["Application"], Awaitable[None]]] = []
        self.on_cleanup: list[Callable[["Application"], Awaitable[None]]] = []
        self._state: dict = {}

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    async def _read_body(self, reader, headers: Headers, writer) -> bytes:
        encoding = (headers.get("Transfer-Encoding") or "").lower()
        expect = (headers.get("Expect") or "").lower() == "100-continue"
        if encoding and encoding != "chunked":
            raise _BadRequest(400, f"unsupported Transfer-Encoding {encoding!r}")
        if encoding != "chunked":
            length_text = headers.get("Content-Length") or "0"
            if not length_text.isdigit():
                raise _BadRequest(400, "bad Content-Length")
            length = int(length_text)
            if length > self.client_max_size:
                raise _BadRequest(413, f"Maximum request body size {self.client_max_size} exceeded, "
                                       f"actual body size {length}")
            if expect and length:
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await _drain(writer)
            try:
                return await asyncio.wait_for(reader.readexactly(length), READ_TIMEOUT + length / (1 << 20))
            except asyncio.IncompleteReadError as e:
                raise EOFError from e
        if expect:
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await _drain(writer)
        body = bytearray()
        while True:
            size_line = await _read_line(reader, READ_TIMEOUT)
            try:
                size = int(size_line.split(b";")[0].strip(), 16)
            except ValueError as e:
                raise _BadRequest(400, "bad chunk size") from e
            if size == 0:
                while await _read_line(reader, READ_TIMEOUT):
                    pass  # trailers
                return bytes(body)
            if len(body) + size > self.client_max_size:
                raise _BadRequest(413, f"Maximum request body size {self.client_max_size} exceeded")
            try:
                body += await asyncio.wait_for(reader.readexactly(size + 2), READ_TIMEOUT)
            except asyncio.IncompleteReadError as e:
                raise EOFError from e
            del body[-2:]

    async def _respond_text(self, writer, status: int, text: str, close: bool, extra=None) -> None:
        response = Response(text=text, status=status, headers=extra)
        if close:
            response.headers["Connection"] = "close"
        await response._send(writer, head_only=False)

    async def _run_handler(self, route: _Route, request: Request, reader) -> StreamResponse:
        """The handler's response; the handler is cancelled when its client
        reaches EOF before it returns."""
        task = asyncio.ensure_future(route.handler(request))

        async def watch():
            while not reader.at_eof():
                await asyncio.sleep(DISCONNECT_POLL_S)

        watcher = asyncio.ensure_future(watch())
        try:
            await asyncio.wait({task, watcher}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            task.cancel()
            raise
        finally:
            watcher.cancel()
        if not task.done():
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
            raise ConnectionResetError("client disconnected")
        return task.result()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    line = await _read_line(reader, KEEPALIVE_TIMEOUT)
                except (EOFError, asyncio.TimeoutError):
                    return
                except _BadRequest as e:
                    await self._respond_text(writer, e.status, f"{e.status}: {e.text}", close=True)
                    return
                if not line:
                    continue
                try:
                    method, target, version = line.decode("latin-1").split(" ")
                    if not version.startswith("HTTP/1."):
                        raise ValueError(version)
                    headers = await _read_headers(reader, READ_TIMEOUT)
                    body = await self._read_body(reader, headers, writer)
                except _BadRequest as e:
                    await self._respond_text(writer, e.status, f"{e.status}: {e.text}", close=True)
                    return
                except ValueError:
                    await self._respond_text(writer, 400, "400: Bad Request", close=True)
                    return
                connection = (headers.get("Connection") or "").lower()
                keep_alive = connection != "close" if version == "HTTP/1.1" else connection == "keep-alive"
                request = Request(method, target, version, headers, body, self)
                request._writer = writer
                route, match_info, allowed = self.router.resolve(method, request.path)
                if route is None:
                    if allowed:
                        await self._respond_text(writer, 405, "405: Method Not Allowed", not keep_alive,
                                                 {"Allow": ",".join(sorted(set(allowed)))})
                    else:
                        await self._respond_text(writer, 404, "404: Not Found", not keep_alive)
                    if not keep_alive:
                        return
                    continue
                request.match_info = match_info
                try:
                    response = await self._run_handler(route, request, reader)
                except HTTPException as e:
                    response = Response(text=e.text, status=e.status)
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception:
                    logger.exception("Error handling request")
                    if request._streamed:
                        return  # the head is out: nothing more can be said
                    response = Response(
                        text="500 Internal Server Error\n\nServer got itself in trouble", status=500
                    )
                if isinstance(response, Response) and not response.prepared:
                    if not keep_alive:
                        response.headers["Connection"] = "close"
                    await response._send(writer, head_only=method == "HEAD")
                elif not response._eof:
                    await response.write_eof()
                if not keep_alive:
                    return
        except (ConnectionError, EOFError, asyncio.TimeoutError, asyncio.IncompleteReadError):
            return
        finally:
            writer.close()


class Server:
    """A running ``Application`` on ``host:port`` (``port`` 0 picks one)."""

    def __init__(self, app: Application, server: asyncio.AbstractServer):
        self.app = app
        self._server = server
        self.port = server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        self._server.close()
        await self._server.wait_closed()
        for hook in self.app.on_cleanup:
            await hook(self.app)


async def serve(app: Application, host: str = "127.0.0.1", port: int = 0) -> Server:
    for hook in app.on_startup:
        await hook(app)
    server = await asyncio.start_server(app._handle, host, port, limit=1 << 16)
    return Server(app, server)


def run_app(app: Application, *, host: str = "0.0.0.0", port: int = 8080) -> None:
    async def main():
        server = await serve(app, host, port)
        logger.info(f"serving on http://{host}:{server.port}")
        try:
            await asyncio.Event().wait()
        finally:
            await server.close()

    asyncio.run(main())


# --- client -------------------------------------------------------------------


class ClientError(Exception):
    pass


class ClientConnectionError(ClientError):
    pass


class ClientPayloadError(ClientError):
    pass


class ServerTimeoutError(ClientConnectionError, asyncio.TimeoutError):
    pass


class ConnectionTimeoutError(ServerTimeoutError):
    pass


class SocketTimeoutError(ServerTimeoutError):
    pass


class ClientResponseError(ClientError):
    def __init__(self, *, status: int, message: str = "", headers=None, url: str = ""):
        self.status = status
        self.message = message
        self.headers = headers
        self.url = url
        super().__init__(status, message)

    def __str__(self) -> str:
        return f"{self.status}, message={self.message!r}, url={self.url!r}"


class ContentTypeError(ClientResponseError):
    pass


class ClientTimeout:
    def __init__(self, total: float | None = None, connect: float | None = None,
                 sock_read: float | None = None, sock_connect: float | None = None):
        self.total = total
        self.connect = connect
        self.sock_read = sock_read
        self.sock_connect = sock_connect


DEFAULT_TIMEOUT = ClientTimeout(total=300, sock_connect=30)


class FormData:
    def __init__(self):
        self._fields: list[tuple[str, bytes, str | None, str | None]] = []

    def add_field(self, name: str, value, *, filename: str | None = None, content_type: str | None = None):
        if hasattr(value, "read"):
            value = value.read()
        if isinstance(value, str):
            value = value.encode("utf-8")
        self._fields.append((name, bytes(value), filename, content_type))

    def encode(self) -> tuple[bytes, str]:
        boundary = uuid.uuid4().hex
        out = bytearray()
        for name, data, filename, content_type in self._fields:
            disposition = f'form-data; name="{_quote_param(name)}"'
            if filename is not None:
                disposition += f'; filename="{_quote_param(filename)}"'
            out += f"--{boundary}\r\n".encode()
            out += f"Content-Type: {content_type or 'application/octet-stream'}\r\n".encode()
            out += f"Content-Disposition: {disposition}\r\n".encode("utf-8")
            out += f"Content-Length: {len(data)}\r\n\r\n".encode()
            out += data + b"\r\n"
        out += f"--{boundary}--\r\n".encode()
        return bytes(out), f"multipart/form-data; boundary={boundary}"


def _quote_param(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"')


_JSON_TYPE = re.compile(r"^application/(?:[\w.+-]+?\+)?json$")


class _Deadline:
    def __init__(self, timeout: ClientTimeout):
        loop = asyncio.get_running_loop()
        self.end = None if timeout.total is None else loop.time() + timeout.total
        self.sock_read = timeout.sock_read

    def left(self, per_call: float | None) -> float | None:
        if self.end is None:
            return per_call
        left = max(0.0, self.end - asyncio.get_running_loop().time())
        return left if per_call is None else min(left, per_call)

    async def run(self, coro, per_call: float | None, error=SocketTimeoutError):
        try:
            return await asyncio.wait_for(coro, self.left(per_call))
        except asyncio.TimeoutError as e:
            raise error("Timeout on reading data from socket" if error is SocketTimeoutError
                        else "Connection timeout") from e

    async def read(self, coro):
        """``coro`` (a socket read) within the total and the read timeouts;
        a malformed or cut response is a ``ClientPayloadError``."""
        try:
            return await self.run(coro, self.sock_read)
        except (_BadRequest, EOFError, asyncio.IncompleteReadError, ValueError, ConnectionError) as e:
            raise ClientPayloadError(f"Response payload is not completed: {e!r}") from e


class StreamContent:
    """The response body as it arrives: ``read()``, or ``async for line``
    (each line with its ``\\n``, as aiohttp's ``StreamReader`` gives it)."""

    def __init__(self, response: "ClientResponse"):
        self._response = response
        self._buffer = b""

    async def read(self, n: int = -1) -> bytes:
        out = bytearray(self._buffer)
        self._buffer = b""
        while n < 0 or len(out) < n:
            piece = await self._response._next_piece()
            if not piece:
                break
            out += piece
        if n >= 0 and len(out) > n:
            self._buffer = bytes(out[n:])
            out = out[:n]
        return bytes(out)

    async def readline(self) -> bytes:
        while b"\n" not in self._buffer:
            piece = await self._response._next_piece()
            if not piece:
                line, self._buffer = self._buffer, b""
                return line
            self._buffer += piece
        line, _, self._buffer = self._buffer.partition(b"\n")
        return line + b"\n"

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        line = await self.readline()
        if not line:
            raise StopAsyncIteration
        return line


class ClientResponse:
    def __init__(self, method: str, url: str, reader, writer, deadline: _Deadline):
        self.method = method
        self.url = url
        self._reader = reader
        self._writer = writer
        self._deadline = deadline
        self.status = 0
        self.reason = ""
        self.headers = Headers()
        self._remaining: int | None = None
        self._chunked = False
        self._done = False
        self._body: bytes | None = None
        self.content = StreamContent(self)

    async def _start(self) -> None:
        while True:
            line = await self._deadline.read(_read_status(self._reader))
            version, _, rest = line.decode("latin-1").partition(" ")
            status_text, _, reason = rest.partition(" ")
            if not version.startswith("HTTP/1.") or not status_text.isdigit():
                raise ClientConnectionError(f"bad status line {line[:80]!r}")
            headers = await self._deadline.read(_read_headers(self._reader, None))
            if int(status_text) != 100:
                break
        self.status, self.reason, self.headers = int(status_text), reason, headers
        if self.method == "HEAD" or self.status in (204, 304) or 100 <= self.status < 200:
            self._remaining = 0
        elif (headers.get("Transfer-Encoding") or "").lower() == "chunked":
            self._chunked = True
        elif headers.get("Content-Length") is not None:
            self._remaining = int(headers["Content-Length"])
        if self._remaining == 0:
            self._finish()

    async def _next_piece(self) -> bytes:
        """The next bytes of the body (b"" at its end)."""
        if self._done:
            return b""
        if self._chunked:
            size_line = await self._deadline.read(_read_line(self._reader, None))
            size = int(size_line.split(b";")[0].strip(), 16)
            if size == 0:
                while await self._deadline.read(_read_line(self._reader, None)):
                    pass
                self._finish()
                return b""
            data = await self._deadline.read(self._reader.readexactly(size + 2))
            return data[:-2]
        if self._remaining is None:
            data = await self._deadline.read(self._reader.read(1 << 16))
            if not data:
                self._finish()
            return data
        data = await self._deadline.read(self._reader.read(min(self._remaining, 1 << 16)))
        if not data:
            raise ClientPayloadError("Response payload is not completed")
        self._remaining -= len(data)
        if self._remaining == 0:
            self._finish()
        return data

    def _finish(self) -> None:
        self._done = True
        self.close()

    @property
    def ok(self) -> bool:
        return self.status < 400

    @property
    def content_type(self) -> str:
        return _content_type(self.headers) or "application/octet-stream"

    def raise_for_status(self) -> None:
        if not self.ok:
            self.release()
            raise ClientResponseError(status=self.status, message=self.reason, headers=self.headers, url=self.url)

    async def read(self) -> bytes:
        if self._body is None:
            try:
                self._body = await self.content.read()
            except (ConnectionError, asyncio.IncompleteReadError) as e:
                raise ClientPayloadError(str(e)) from e
        return self._body

    async def json(self, *, content_type: str | None = "application/json", loads=json.loads):
        body = await self.read()
        if content_type is not None and not _JSON_TYPE.match(self.content_type):
            raise ContentTypeError(
                status=self.status, message=f"Attempt to decode JSON with unexpected mimetype: {self.content_type}",
                headers=self.headers, url=self.url,
            )
        return loads(body.decode("utf-8"))

    def release(self) -> None:
        self.close()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


async def _read_status(reader) -> bytes:
    try:
        line = await _read_line(reader, None)
    except EOFError as e:
        raise ClientConnectionError("Server disconnected") from e
    return line


class _RequestContext:
    """``await session.get(...)`` or ``async with session.get(...)``."""

    def __init__(self, coro):
        self._coro = coro
        self._response: ClientResponse | None = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        self._response = await self._coro
        return self._response

    async def __aexit__(self, *exc) -> None:
        if self._response is not None:
            self._response.release()


class ClientSession:
    def __init__(self, base_url: str | None = None, *, timeout: ClientTimeout | None = None):
        self._base_url = base_url
        self._timeout = timeout or DEFAULT_TIMEOUT
        self._responses: list[ClientResponse] = []
        self.closed = False

    def _build_url(self, url: str) -> str:
        if self._base_url is None or urlsplit(url).scheme:
            return url
        return urljoin(self._base_url, url)

    def request(self, method: str, url: str, **kwargs) -> _RequestContext:
        return _RequestContext(self._request(method.upper(), url, **kwargs))

    def get(self, url: str, **kwargs) -> _RequestContext:
        return self.request("GET", url, **kwargs)

    def head(self, url: str, **kwargs) -> _RequestContext:
        return self.request("HEAD", url, **kwargs)

    def put(self, url: str, **kwargs) -> _RequestContext:
        return self.request("PUT", url, **kwargs)

    def post(self, url: str, **kwargs) -> _RequestContext:
        return self.request("POST", url, **kwargs)

    async def _request(self, method: str, url: str, *, headers=None, json: Any = None, data: Any = None,
                       params: dict | None = None, timeout: ClientTimeout | None = None) -> ClientResponse:
        if self.closed:
            raise RuntimeError("Session is closed")
        url = self._build_url(url)
        if params:
            url += ("&" if urlsplit(url).query else "?") + urlencode(params)
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ClientConnectionError(f"unsupported URL {url!r}")
        timeout = timeout or self._timeout
        deadline = _Deadline(timeout)
        request_headers = Headers(headers)
        body = b""
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
            request_headers.setdefault("Content-Type", "application/json")
        elif isinstance(data, FormData):
            body, content_type = data.encode()
            request_headers["Content-Type"] = content_type
        elif data is not None:
            body = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        port = parts.port or (443 if parts.scheme == "https" else 80)
        default_port = (parts.scheme == "https" and port == 443) or (parts.scheme == "http" and port == 80)
        request_headers.setdefault("Host", parts.hostname if default_port else f"{parts.hostname}:{port}")
        request_headers.setdefault("Accept", "*/*")
        request_headers.setdefault("Accept-Encoding", "identity")
        request_headers["Connection"] = "close"
        if body or method in ("POST", "PUT"):
            request_headers["Content-Length"] = str(len(body))
        connect = timeout.sock_connect if timeout.sock_connect is not None else timeout.connect
        try:
            reader, writer = await deadline.run(
                asyncio.open_connection(
                    parts.hostname, port,
                    ssl=ssl.create_default_context() if parts.scheme == "https" else None,
                    limit=1 << 16,
                ),
                connect,
                ConnectionTimeoutError,
            )
        except ServerTimeoutError:
            raise
        except OSError as e:
            raise ClientConnectionError(f"Cannot connect to host {parts.hostname}:{port}: {e}") from e
        target = parts.path or "/"
        if parts.query:
            target += "?" + parts.query
        head = f"{method} {target} HTTP/1.1\r\n" + "".join(f"{k}: {v}\r\n" for k, v in request_headers.items())
        response = ClientResponse(method, url, reader, writer, deadline)
        try:
            writer.write(head.encode("latin-1") + b"\r\n" + body)
            await deadline.run(writer.drain(), timeout.sock_read)
            await response._start()
        except (ConnectionError, asyncio.IncompleteReadError) as e:
            response.close()
            raise ClientConnectionError(f"Server disconnected: {e}") from e
        except BaseException:
            response.close()
            raise
        self._responses.append(response)
        return response

    async def close(self) -> None:
        for response in self._responses:
            response.close()
        self._responses.clear()
        self.closed = True

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

