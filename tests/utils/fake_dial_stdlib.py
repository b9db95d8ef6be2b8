"""Fake Dial Core on the standard library only (``http.server`` in a
thread), for hermetic runs where aiohttp is missing, as on the card's
machine: the endpoints and scripting of ``tests/utils/fake_dial.py``
(bucket, limits, files GET / HEAD / PUT and metadata, scripted chat
completions with tool calls and streamed answers, seeded embeddings),
answered the same way. It shares no code with the service it serves.
"""

import email.parser
import email.policy
import hashlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class FakeDialCore:
    def __init__(self):
        self.files: dict[str, bytes] = {}  # path (after /v1/) -> bytes
        self.content_types: dict[str, str] = {}
        # scripted chat completions: list of str answers or callables
        # (messages -> str); popped per request, last one repeats
        self.llm_responses: list = ["I don't know."]
        self.llm_requests: list[dict] = []
        self.embedding_dim = 16
        # set to an HTTP status (e.g. 429) to make every embeddings
        # call fail with it
        self.embeddings_status: int | None = None
        self._lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port = None

    def add_file(self, path: str, data: bytes, content_type: str):
        self.files[path] = data
        self.content_types[path] = content_type

    def script_llm(self, *responses):
        self.llm_responses = list(responses)

    def _next_llm_response(self, body: dict) -> str:
        with self._lock:
            self.llm_requests.append(body)
            response = self.llm_responses[0]
            if len(self.llm_responses) > 1:
                self.llm_responses.pop(0)
        if callable(response):
            return response(body)
        return response

    # -- the routes ----------------------------------------------------------

    def _route(self, method: str, path: str):
        """(handler, match) for ``method path``: 404 when no path matches,
        405 when only another method does."""
        routes = [
            ("GET", r"/v1/bucket", self._bucket),
            ("GET", r"/v1/deployments/(?P<model>[^/]+)/limits", self._limits),
            ("GET", r"/v1/files/(?P<path>.*)", self._get_file),
            ("HEAD", r"/v1/files/(?P<path>.*)", self._get_file),
            ("PUT", r"/v1/files/(?P<path>.*)", self._put_file),
            ("GET", r"/v1/metadata/files/(?P<path>.*)", self._metadata),
            ("HEAD", r"/v1/metadata/files/(?P<path>.*)", self._metadata),
            ("POST", r"/openai/deployments/(?P<model>[^/]+)/chat/completions", self._chat_completions),
            ("POST", r"/openai/deployments/(?P<model>[^/]+)/embeddings", self._embeddings),
        ]
        allowed = False
        for route_method, pattern, handler in routes:
            m = re.fullmatch(pattern, path)
            if m is None:
                continue
            if route_method == method:
                return handler, m
            allowed = True
        return (405 if allowed else 404), None

    def _bucket(self, request, m):
        request.send_json({"bucket": "test-bucket"})

    def _limits(self, request, m):
        request.send_json(
            {
                "minuteTokenStats": {"total": 100000, "used": 0},
                "dayTokenStats": {"total": 10000000, "used": 0},
            }
        )

    def _get_file(self, request, m):
        full = f"files/{m['path']}"
        if full not in self.files:
            request.send_text(404, "404: Not Found")
            return
        request.send_body(
            200, self.files[full], self.content_types.get(full, "application/octet-stream")
        )

    def _put_file(self, request, m):
        full = f"files/{m['path']}"
        message = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            f"Content-Type: {request.headers['Content-Type']}\r\n\r\n".encode() + request.body
        )
        part = next(iter(message.iter_parts()))
        self.files[full] = part.get_payload(decode=True)
        self.content_types[full] = part.get("Content-Type", "application/octet-stream")
        request.send_json({"url": full})

    def _metadata(self, request, m):
        full = f"files/{m['path']}"
        if full not in self.files:
            request.send_text(404, "404: Not Found")
            return
        request.send_json(
            {
                "name": full.split("/")[-1],
                "url": full,
                "contentType": self.content_types.get(full),
                "contentLength": len(self.files[full]),
            }
        )

    def _chat_completions(self, request, m):
        body = json.loads(request.body)
        answer = self._next_llm_response(body)

        tool_choice = body.get("tool_choice")
        if tool_choice:
            # forced function call (standalone question chain)
            name = tool_choice["function"]["name"]
            message = {
                "role": "assistant",
                "content": None,
                "tool_calls": [
                    {
                        "id": "call_1",
                        "type": "function",
                        "function": {
                            "name": name,
                            "arguments": json.dumps({"question": answer}),
                        },
                    }
                ],
            }
            request.send_json(
                {
                    "id": "cmpl-1",
                    "object": "chat.completion",
                    "choices": [{"index": 0, "message": message, "finish_reason": "stop"}],
                }
            )
            return

        if body.get("stream"):
            request.start_stream("text/event-stream")
            # stream in small pieces to exercise chunk-boundary handling
            for i in range(0, len(answer), 7):
                chunk = {
                    "id": "cmpl-1",
                    "object": "chat.completion.chunk",
                    "choices": [
                        {"index": 0, "delta": {"content": answer[i : i + 7]}, "finish_reason": None}
                    ],
                }
                request.write_chunk(f"data: {json.dumps(chunk)}\n\n".encode())
            request.write_chunk(b"data: [DONE]\n\n")
            request.end_stream()
            return

        request.send_json(
            {
                "id": "cmpl-1",
                "object": "chat.completion",
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": answer},
                        "finish_reason": "stop",
                    }
                ],
            }
        )

    def _embeddings(self, request, m):
        if self.embeddings_status is not None:
            request.send_json(
                {"error": {"message": "rate limited", "code": "429"}}, status=self.embeddings_status
            )
            return
        body = json.loads(request.body)
        inputs = list(body.get("input") or [])
        inputs += [c["data"] for c in body.get("custom_input", [])]
        data = []
        for i, item in enumerate(inputs):
            seed = int.from_bytes(hashlib.sha256(str(item).encode()).digest()[:4], "big")
            rng = np.random.default_rng(seed)
            vec = rng.normal(size=self.embedding_dim)
            vec /= np.linalg.norm(vec)
            data.append({"object": "embedding", "index": i, "embedding": vec.tolist()})
        request.send_json({"object": "list", "data": data})

    # -- lifecycle -----------------------------------------------------------

    def _handler_class(self):
        core = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 60  # each socket read

            def log_message(self, *args):
                pass

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                if (self.headers.get("Transfer-Encoding") or "").lower() == "chunked":
                    self.body = self._read_chunked()
                else:
                    self.body = self.rfile.read(length) if length else b""
                path = self.path.split("?", 1)[0]
                handler, m = core._route(self.command, path)
                if handler == 404:
                    self.send_text(404, "404: Not Found")
                elif handler == 405:
                    self.send_text(405, "405: Method Not Allowed")
                else:
                    handler(self, m)

            def _read_chunked(self) -> bytes:
                body = b""
                while True:
                    size = int(self.rfile.readline().split(b";")[0].strip(), 16)
                    if size == 0:
                        while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                            pass
                        return body
                    body += self.rfile.read(size)
                    self.rfile.readline()

            do_GET = do_HEAD = do_PUT = do_POST = _serve

            def send_body(self, status: int, data: bytes, content_type: str):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(data)

            def send_json(self, value, status: int = 200):
                self.send_body(status, json.dumps(value).encode(), "application/json; charset=utf-8")

            def send_text(self, status: int, text: str):
                self.send_body(status, text.encode(), "text/plain; charset=utf-8")

            def start_stream(self, content_type: str):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

            def write_chunk(self, data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            def end_stream(self):
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

        return Handler

    def start_sync(self) -> str:
        self._server = ThreadingHTTPServer(("127.0.0.1", 0), self._handler_class())
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
                                        daemon=True)
        self._thread.start()
        self.port = self._server.server_address[1]
        return f"http://127.0.0.1:{self.port}"

    def stop_sync(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=10)
            self._server = None

    async def start(self) -> str:
        return self.start_sync()

    async def stop(self):
        self.stop_sync()
