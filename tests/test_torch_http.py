"""The port's HTTP/1.1 module (``service/http.py``) against aiohttp.

The server is driven by aiohttp's client: keep-alive on one pooled
connection, JSON, chunked SSE flushed event by event, chunked and
``Expect: 100-continue`` request bodies, 400, 404, 405 and 413, and a
client that goes away mid-stream cancelling the handler. The client talks
to an aiohttp server: status errors, the total, read and connect
timeouts, a multipart body that aiohttp's reader parses to the same file,
SSE read line by line, ``base_url`` joined as aiohttp joins it, and https
through the default SSL context."""

import asyncio
import json
import socket

import aiohttp
import pytest
from aiohttp import web

from dial_rag_tpu_torch.service import http


def port_app(max_size: int = 1 << 20) -> tuple[http.Application, dict]:
    app = http.Application(client_max_size=max_size)
    state = {"cancelled": asyncio.Event(), "first_sent": asyncio.Event(), "release": asyncio.Event()}

    async def echo(request):
        return http.json_response({"json": await request.json(), "key": request.headers.get("api-key"),
                                   "query": request.query})

    async def body_size(request):
        return http.json_response({"size": len(await request.read())})

    async def events(request):
        response = http.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await response.prepare(request)
        await response.write(b"data: first\n\n")
        state["first_sent"].set()
        await state["release"].wait()
        for i in range(3):
            await response.write(f"data: {i}\n\n".encode())
        await response.write(b"data: [DONE]\n\n")
        await response.write_eof()
        return response

    async def forever(request):
        response = http.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await response.prepare(request)
        try:
            while True:
                await response.write(b"data: tick\n\n")
                await asyncio.sleep(0.02)
        except BaseException:
            state["cancelled"].set()
            raise

    async def missing(request):
        raise http.HTTPNotFound()

    async def boom(request):
        raise RuntimeError("boom")

    app.router.add_post("/echo", echo)
    app.router.add_post("/size", body_size)
    app.router.add_put("/size", body_size)
    app.router.add_get("/events", events)
    app.router.add_get("/forever", forever)
    app.router.add_get("/files/{path:.*}", missing)
    app.router.add_get("/boom", boom)
    return app, state


async def test_server_keep_alive_json_and_errors():
    app, _ = port_app()
    connections = []
    handle = app._handle

    async def counting(reader, writer):
        connections.append(1)
        await handle(reader, writer)

    app._handle = counting
    server = await http.serve(app)
    base = f"http://127.0.0.1:{server.port}"
    try:
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=1)) as s:
            for i in range(3):
                async with s.post(base + "/echo?a=1", json={"i": i, "t": "é"}, headers={"api-key": "k"}) as r:
                    assert r.status == 200 and r.headers["Content-Type"] == "application/json; charset=utf-8"
                    assert await r.json() == {"json": {"i": i, "t": "é"}, "key": "k", "query": {"a": "1"}}
            async with s.get(base + "/nowhere") as r:
                assert (r.status, await r.text()) == (404, "404: Not Found")
            async with s.post(base + "/events") as r:
                assert (r.status, await r.text(), r.headers["Allow"]) == (405, "405: Method Not Allowed", "GET,HEAD")
            async with s.get(base + "/files/a/b.pdf") as r:
                assert (r.status, await r.text()) == (404, "404: Not Found")
            async with s.get(base + "/boom") as r:
                assert r.status == 500
            async with s.post(base + "/echo", data=b"{not json") as r:
                assert r.status == 500
        assert len(connections) == 1
    finally:
        await server.close()


async def test_server_bodies_chunked_continue_and_413():
    app, _ = port_app(max_size=1000)
    server = await http.serve(app)
    base = f"http://127.0.0.1:{server.port}"

    async def chunks(n):
        for _ in range(n):
            yield b"x" * 100

    try:
        async with aiohttp.ClientSession() as s:
            async with s.post(base + "/size", data=chunks(5)) as r:
                assert (r.status, await r.json()) == (200, {"size": 500})
            async with s.put(base + "/size", data=b"y" * 700, expect100=True) as r:
                assert (r.status, await r.json()) == (200, {"size": 700})
            async with s.post(base + "/size", data=b"z" * 1001) as r:
                assert r.status == 413
            async with s.post(base + "/size", data=chunks(11)) as r:
                assert r.status == 413
    finally:
        await server.close()


async def test_server_malformed_requests_are_400():
    app, _ = port_app()
    server = await http.serve(app)
    try:
        for raw in (b"NONSENSE\r\n\r\n", b"GET / HTTP/9.9\r\n\r\n", b"POST /size HTTP/1.1\r\nContent-Length: x\r\n\r\n",
                    b"GET / HTTP/1.1\r\nno colon here\r\n\r\n",
                    b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n"):
            reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
            writer.write(raw)
            await writer.drain()
            status = await asyncio.wait_for(reader.readline(), 5)
            assert status.startswith(b"HTTP/1.1 400 "), (raw[:40], status)
            writer.close()
    finally:
        await server.close()


async def test_server_streams_sse_event_by_event():
    app, state = port_app()
    server = await http.serve(app)
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://127.0.0.1:{server.port}/events") as r:
                assert r.headers["Transfer-Encoding"] == "chunked"
                # the first event arrives while the handler still waits
                assert await asyncio.wait_for(r.content.readline(), 5) == b"data: first\n"
                assert not state["release"].is_set()
                state["release"].set()
                rest = [line async for line in r.content]
        assert [x for x in rest if x.strip()] == [b"data: 0\n", b"data: 1\n", b"data: 2\n", b"data: [DONE]\n"]
    finally:
        await server.close()


async def test_client_disconnect_cancels_the_handler():
    app, state = port_app()
    server = await http.serve(app)
    try:
        async with aiohttp.ClientSession() as s:
            r = await s.get(f"http://127.0.0.1:{server.port}/forever")
            assert await r.content.readline() == b"data: tick\n"
            r.close()
        await asyncio.wait_for(state["cancelled"].wait(), 5)
    finally:
        await server.close()


async def test_handler_is_cancelled_when_its_client_closes_before_the_head():
    """A client gone before any byte of the answer (the connection at
    EOF) cancels the handler too."""
    app = http.Application()
    done = asyncio.Event()

    async def slow(request):
        try:
            await asyncio.sleep(30)
        finally:
            done.set()
        return http.json_response({})

    app.router.add_get("/slow", slow)
    server = await http.serve(app)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n")
        await writer.drain()
        await asyncio.sleep(0.1)
        writer.close()
        await asyncio.wait_for(done.wait(), 5)
    finally:
        await server.close()


# --- the client against aiohttp's server -----------------------------------------


@pytest.fixture
def aiohttp_server_factory():
    runners = []

    async def start(app: web.Application) -> str:
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        runners.append(runner)
        return f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"

    async def stop():
        for runner in runners:
            await runner.cleanup()

    return start, stop


def aiohttp_app(state: dict) -> web.Application:
    app = web.Application()

    async def echo(request):
        return web.json_response({"method": request.method, "path": request.path, "query": dict(request.query),
                                  "key": request.headers.get("api-key"), "body": await request.text()})

    async def upload(request):
        reader = await request.multipart()
        field = await reader.next()
        data = await field.read()
        state["upload"] = (field.name, field.filename, field.headers.get("Content-Type"), bytes(data))
        return web.json_response({"url": request.match_info["path"]})

    async def sse(request):
        response = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await response.prepare(request)
        for i in range(3):
            await response.write(f'data: {{"i": {i}}}\n\n'.encode())
        await response.write(b"data: [DONE]\n\n")
        await response.write_eof()
        return response

    async def slow(request):
        await asyncio.sleep(5)
        return web.json_response({})

    async def stall(request):
        response = web.StreamResponse()
        await response.prepare(request)
        await response.write(b"partial")
        await asyncio.sleep(5)
        return response

    async def head(request):
        return web.Response(body=b"12345", headers={"ETag": '"abc"'}, content_type="application/pdf")

    async def text(request):
        return web.Response(text="not json")

    app.router.add_route("*", "/v1/echo/{tail:.*}", echo)
    app.router.add_put("/v1/files/{path:.*}", upload)
    app.router.add_get("/sse", sse)
    app.router.add_get("/slow", slow)
    app.router.add_get("/stall", stall)
    app.router.add_get("/head", head)
    app.router.add_get("/text", text)
    async def missing(request):
        raise web.HTTPNotFound()

    async def limited(request):
        return web.json_response({"error": "x"}, status=429)

    app.router.add_get("/missing", missing)
    app.router.add_get("/limited", limited)
    return app


async def test_client_methods_base_url_and_errors(aiohttp_server_factory):
    start, stop = aiohttp_server_factory
    state = {}
    base = await start(aiohttp_app(state))
    try:
        async with http.ClientSession(base_url=f"{base}/v1/") as s:
            async with s.get("echo/a/b", params={"api-version": "x y"}, headers={"api-key": "k"}) as r:
                assert r.status == 200 and r.ok
                assert await r.json() == {"method": "GET", "path": "/v1/echo/a/b", "query": {"api-version": "x y"},
                                          "key": "k", "body": ""}
            async with s.post("echo/p", json={"q": "é"}) as r:
                assert json.loads((await r.json())["body"]) == {"q": "é"}
            form = http.FormData()
            form.add_field("file", b"\x00index\r\n--bytes", filename="files/b/idx.bin", content_type="application/x-i")
            async with s.put("files/b/idx.bin", data=form) as r:
                r.raise_for_status()
                assert await r.json() == {"url": "b/idx.bin"}
            assert state["upload"] == ("file", "files/b/idx.bin", "application/x-i", b"\x00index\r\n--bytes")
            async with s.head(f"{base}/head") as r:
                assert r.status == 200 and r.headers.get("etag") == '"abc"' and await r.read() == b""
                assert {k.lower(): v for k, v in r.headers.items()}["content-length"] == "5"
        async with http.ClientSession() as s:
            for path, status, reason in (("/missing", 404, "Not Found"), ("/limited", 429, "Too Many Requests")):
                async with s.get(base + path) as r:
                    with pytest.raises(http.ClientResponseError) as info:
                        r.raise_for_status()
                assert (info.value.status, info.value.message) == (status, reason)
                assert isinstance(info.value, http.ClientError)
            async with s.get(base + "/text") as r:
                with pytest.raises(http.ContentTypeError):
                    await r.json()
            response = await s.get(base + "/sse")
            lines = [line async for line in response.content]
            response.release()
            assert [x for x in lines if x.strip()] == [b'data: {"i": 0}\n', b'data: {"i": 1}\n', b'data: {"i": 2}\n',
                                                       b"data: [DONE]\n"]
    finally:
        await stop()


async def test_client_timeouts(aiohttp_server_factory, monkeypatch):
    start, stop = aiohttp_server_factory
    base = await start(aiohttp_app({}))
    try:
        async with http.ClientSession(timeout=http.ClientTimeout(total=0.3)) as s:
            with pytest.raises(asyncio.TimeoutError):
                async with s.get(base + "/slow"):
                    pass
        async with http.ClientSession(timeout=http.ClientTimeout(total=30, sock_read=0.3)) as s:
            async with s.get(base + "/stall") as r:
                with pytest.raises(http.ServerTimeoutError):
                    await r.read()

        async def never_connects(*args, **kwargs):
            await asyncio.sleep(30)

        monkeypatch.setattr(asyncio, "open_connection", never_connects)
        async with http.ClientSession(timeout=http.ClientTimeout(total=30, connect=0.2)) as s:
            with pytest.raises(http.ConnectionTimeoutError):
                await s.get(base + "/slow")
    finally:
        await stop()


async def test_client_connection_errors(aiohttp_server_factory):
    start, stop = aiohttp_server_factory
    base = await start(aiohttp_app({}))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    closed_port = sock.getsockname()[1]
    sock.close()
    try:
        async with http.ClientSession() as s:
            with pytest.raises(http.ClientConnectionError):
                await s.get(f"http://127.0.0.1:{closed_port}/")
            # https through the default SSL context: the plain-HTTP server
            # fails the handshake
            with pytest.raises(http.ClientConnectionError):
                await s.get(base.replace("http://", "https://") + "/sse")
    finally:
        await stop()


@pytest.mark.parametrize("base,url", [
    ("http://dial:8080/v1/", "files/b/doc.pdf"),
    ("http://dial:8080/v1/", "bucket"),
    ("http://dial:8080/v1/", "deployments/gpt/limits"),
    ("http://dial:8080/v1/", "metadata/files/b/a%20b.pdf?x=1"),
    ("http://dial:8080/v1/", "https://attacker.example/x"),
    ("http://dial:8080/v1/", "files/b/../../x"),
    ("http://dial:8080/", "v1/files/b"),
    (None, "http://dial:8080/v1/files/b"),
])
async def test_base_url_joins_as_aiohttp(base, url):
    async with aiohttp.ClientSession(base_url=base) as ref:
        expected = str(ref._build_url(url))
    assert http.ClientSession(base_url=base)._build_url(url) == expected
