"""A small HTTP/1.1 server on the standard library (``asyncio`` streams).

It stands in for the part of ``aiohttp.web`` that the JAX package's server
uses (``bitnet_tpu/serve/server.py``), with the same names, so the port's
handlers read as the JAX ones do: ``Application`` and its router (method,
path, ``{name}`` parameters, 404 / 405 as aiohttp words them),
``Request`` (``headers``, ``remote``, ``match_info``, ``content_length``,
``json()``), ``Response`` / ``json_response``, ``StreamResponse`` (chunked
transfer encoding, for server-sent events), ``WebSocketResponse`` (RFC
6455: the ``Sec-WebSocket-Accept`` handshake, masked client frames,
fragments, ping / pong, close) and the ``HTTP*`` exceptions.

What aiohttp did on its own is done here:

- bodies are read at most ``client_max_size`` bytes; a larger declared
  ``Content-Length`` is left unread (the handler answers 413 from
  ``content_length``, and the connection closes after the response);
- every response passes the ``on_response_prepare`` hooks before its head
  is written (the server's security headers), streams included;
- while a handler runs, the connection is watched: a client that closes
  its socket cancels the handler's task (a WebSocket's close frame or a
  lost socket cancels the handler too, unless it is waiting for a message);
- ``Server.shutdown`` stops accepting, lets the handlers in flight finish
  (up to a timeout, then cancels them), closes idle connections, then runs
  the ``on_shutdown`` hooks.

``run_app`` serves until SIGINT / SIGTERM; ``ServerThread`` serves from a
thread of its own (tests, ``chip_smoke.py``).
"""

from __future__ import annotations

import asyncio
import base64
import email.utils
import enum
import hashlib
import json
import signal
import struct
import threading
import traceback
from http import HTTPStatus
from typing import Any, Awaitable, Callable, NamedTuple
from urllib.parse import parse_qsl, unquote, urlsplit

MAX_HEAD_BYTES = 64 << 10
WS_MAX_MESSAGE = 4 << 20                # aiohttp's default max_msg_size
WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class Headers:
    """Case-insensitive header map that keeps the first spelling."""

    def __init__(self, items=()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in (items.items() if isinstance(items, dict) else items):
            self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value) -> None:
        old = self._d.get(key.lower())
        self._d[key.lower()] = (old[0] if old else key, str(value))

    def __contains__(self, key) -> bool:
        return key.lower() in self._d

    def get(self, key: str, default=None):
        e = self._d.get(key.lower())
        return default if e is None else e[1]

    def setdefault(self, key: str, value) -> str:
        if key not in self:
            self[key] = value
        return self[key]

    def items(self):
        return [(k, v) for k, v in self._d.values()]

    def __repr__(self) -> str:
        return f"Headers({dict(self.items())!r})"


# ---------------------------------------------------------------- responses
class Response:
    """A whole response: status, headers, body bytes."""

    def __init__(self, *, body: bytes | None = None, status: int = 200,
                 text: str | None = None, headers=None,
                 content_type: str | None = None, charset: str | None = None):
        self.status = status
        self.headers = Headers(headers or {})
        if text is not None:
            charset = charset or "utf-8"
            body = text.encode(charset)
            ct = content_type or "text/plain"
            self.headers.setdefault("Content-Type", f"{ct}; charset={charset}")
        elif content_type is not None:
            self.headers.setdefault("Content-Type", content_type + (
                f"; charset={charset}" if charset else ""))
        self.body = body or b""


def json_response(data: Any = None, *, status: int = 200, headers=None,
                  dumps: Callable[[Any], str] = json.dumps) -> Response:
    return Response(text=dumps(data), status=status, headers=headers,
                    content_type="application/json")


class HTTPException(Exception):
    """An error response raised from a handler (aiohttp's ``web.HTTP*``)."""

    status_code = 500

    def __init__(self, *, text: str | None = None, content_type: str | None = None,
                 headers=None):
        self.text = (text if text is not None else
                     f"{self.status_code}: {HTTPStatus(self.status_code).phrase}")
        self.content_type = content_type or "text/plain"
        self.headers = headers or {}
        super().__init__(self.text)

    def as_response(self) -> Response:
        ct, _, cs = self.content_type.partition("; charset=")
        return Response(text=self.text, status=self.status_code, headers=self.headers,
                        content_type=ct, charset=cs or None)


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413


class HTTPUnprocessableEntity(HTTPException):
    status_code = 422


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class StreamResponse:
    """A response written in pieces: the head at ``prepare``, then each
    ``write`` as one chunk of a chunked body, ``write_eof`` the last."""

    def __init__(self, *, status: int = 200, headers=None):
        self.status = status
        self.headers = Headers(headers or {})
        self._conn: _Connection | None = None
        self._eof = False

    @property
    def prepared(self) -> bool:
        return self._conn is not None

    async def prepare(self, request: "Request") -> "StreamResponse":
        if self._conn is None:
            self._conn = request._conn
            request._stream = self
            self.headers["Transfer-Encoding"] = "chunked"
            await self._conn.write_head(request, self)
        return self

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("write() before prepare()")
        if data:
            await self._conn.send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if self._conn is not None and not self._eof:
            self._eof = True
            await self._conn.send(b"0\r\n\r\n")


# ---------------------------------------------------------------- websocket
class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    CLOSE = 0x8
    PING = 0x9
    PONG = 0xA
    CLOSED = 0x101
    ERROR = 0x102


class WSMessage(NamedTuple):
    type: WSMsgType
    data: Any
    extra: Any = None


class WebSocketResponse:
    """The server side of one WebSocket (RFC 6455).  A reader task takes
    the client's frames off the socket as they come (answering pings and
    the close handshake), so a client that goes away is seen while the
    handler streams: its task is cancelled unless it waits for a message."""

    def __init__(self):
        self.closed = False
        self.close_code: int | None = None
        self._conn: _Connection | None = None
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._reader: asyncio.Task | None = None
        self._receiving = False
        self._task: asyncio.Task | None = None

    async def prepare(self, request: "Request") -> "WebSocketResponse":
        h = request.headers
        key = h.get("Sec-WebSocket-Key", "")
        if (h.get("Upgrade", "").lower() != "websocket"
                or "upgrade" not in h.get("Connection", "").lower()):
            raise HTTPBadRequest(text=f"No WebSocket UPGRADE hdr: {h.get('Upgrade')}\n "
                                      'Can "Upgrade" only to "WebSocket".')
        if h.get("Sec-WebSocket-Version", "") != "13":
            raise HTTPBadRequest(text="Unsupported version: "
                                      f"{h.get('Sec-WebSocket-Version')}")
        try:
            ok = len(base64.b64decode(key, validate=True)) == 16
        except ValueError:
            ok = False
        if not ok:
            raise HTTPBadRequest(text=f"Handshake error: {key!r}")
        conn = request._conn
        conn.stop_watch()
        accept = base64.b64encode(hashlib.sha1(key.encode() + WS_GUID).digest())
        resp = StreamResponse(status=101, headers={
            "Upgrade": "websocket", "Connection": "upgrade",
            "Sec-WebSocket-Accept": accept.decode()})
        await conn.write_head(request, resp)
        self._conn = conn
        self._task = asyncio.current_task()
        self._reader = asyncio.create_task(self._read_frames())
        return self

    async def _frame(self) -> tuple[bool, int, bytes]:
        conn = self._conn
        b0, b1 = await conn.readexactly(2)
        fin, op, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        if n == 126:
            n = struct.unpack("!H", await conn.readexactly(2))[0]
        elif n == 127:
            n = struct.unpack("!Q", await conn.readexactly(8))[0]
        if n > WS_MAX_MESSAGE:
            raise _WSError(1009, "message too big")
        mask = await conn.readexactly(4) if masked else None
        data = await conn.readexactly(n) if n else b""
        if mask is not None and data:
            m = (mask * (n // 4 + 1))[:n]
            data = (int.from_bytes(data, "big") ^ int.from_bytes(m, "big")).to_bytes(n, "big")
        return fin, op, data

    async def _read_frames(self) -> None:
        parts: list[bytes] = []
        first_op = None
        try:
            while True:
                fin, op, data = await self._frame()
                if op == WSMsgType.PING:
                    await self._send_frame(WSMsgType.PONG, data)
                    continue
                if op == WSMsgType.PONG:
                    continue
                if op == WSMsgType.CLOSE:
                    code = struct.unpack("!H", data[:2])[0] if len(data) >= 2 else 1005
                    self.close_code = code
                    if not self.closed:
                        await self._send_close(1000 if code == 1005 else code)
                    self._gone(WSMessage(WSMsgType.CLOSE, code, data[2:].decode(
                        "utf-8", "replace")))
                    return
                if op in (WSMsgType.TEXT, WSMsgType.BINARY):
                    parts, first_op = [data], op
                elif op == WSMsgType.CONTINUATION and first_op is not None:
                    parts.append(data)
                else:
                    raise _WSError(1002, f"unexpected opcode {op}")
                if sum(map(len, parts)) > WS_MAX_MESSAGE:
                    raise _WSError(1009, "message too big")
                if fin:
                    payload = b"".join(parts)
                    msg = (WSMessage(WSMsgType.TEXT, payload.decode("utf-8"))
                           if first_op == WSMsgType.TEXT
                           else WSMessage(WSMsgType.BINARY, payload))
                    parts, first_op = [], None
                    self._inbox.put_nowait(msg)
        except _WSError as e:
            await self._send_close(e.code)
            self._gone(WSMessage(WSMsgType.ERROR, e))
        except (asyncio.IncompleteReadError, ConnectionError, UnicodeDecodeError) as e:
            self.closed = True
            self._gone(WSMessage(WSMsgType.CLOSED, None, e))

    def _gone(self, msg: WSMessage) -> None:
        """The client closed: end the iteration, and cancel a handler that
        is busy elsewhere (its request)."""
        self._inbox.put_nowait(msg)
        if not self._receiving and self._task is not None and not self._task.done():
            self._task.cancel()

    async def _send_frame(self, op: int, data: bytes) -> None:
        n = len(data)
        head = bytes([0x80 | op])
        if n < 126:
            head += bytes([n])
        elif n < 1 << 16:
            head += bytes([126]) + struct.pack("!H", n)
        else:
            head += bytes([127]) + struct.pack("!Q", n)
        await self._conn.send(head + data)

    async def _send_close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self._send_frame(WSMsgType.CLOSE, struct.pack("!H", code))
            except ConnectionError:
                pass

    async def receive(self) -> WSMessage:
        self._receiving = True
        try:
            return await self._inbox.get()
        finally:
            self._receiving = False

    def __aiter__(self):
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSED, WSMsgType.ERROR):
            raise StopAsyncIteration
        return msg

    async def send_str(self, data: str) -> None:
        if self.closed:
            raise ConnectionResetError("Cannot write to closing transport")
        await self._send_frame(WSMsgType.TEXT, data.encode())

    async def send_json(self, data: Any, dumps: Callable[[Any], str] = json.dumps) -> None:
        await self.send_str(dumps(data))

    async def close(self, code: int = 1000) -> None:
        await self._send_close(code)
        if self._reader is not None and not self._reader.done():
            self._reader.cancel()


class _WSError(Exception):
    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


# ---------------------------------------------------------------- requests
class Request:
    def __init__(self, conn: "_Connection", method: str, target: str, version: str,
                 headers: Headers, body: bytes | None, too_large: bool):
        self._conn = conn
        self.app = conn.server.app
        self.method = method
        self.version = version
        u = urlsplit(target)
        self.path = unquote(u.path)
        self.query = dict(parse_qsl(u.query))
        self.headers = headers
        self.match_info: dict[str, str] = {}
        self._body = body
        self._too_large = too_large
        self._stream: StreamResponse | None = None     # a response begun
        peer = conn.writer.get_extra_info("peername")
        self.remote = peer[0] if isinstance(peer, tuple) else None

    @property
    def content_length(self) -> int | None:
        v = self.headers.get("Content-Length")
        try:
            return int(v) if v is not None else None
        except ValueError:
            return None

    async def read(self) -> bytes:
        if self._too_large:
            raise HTTPRequestEntityTooLarge(text="request body too large")
        return self._body or b""

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self, loads: Callable[[str], Any] = json.loads) -> Any:
        return loads(await self.text())


Handler = Callable[[Request], Awaitable[Any]]


class Router:
    """Routes by method and path; ``{name}`` matches one path segment."""

    def __init__(self):
        self._routes: list[tuple[str, list[str], Handler]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        self._routes.append((method.upper(), path.strip("/").split("/"), handler))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        segs = path.strip("/").split("/")
        allowed = set()
        for m, pattern, handler in self._routes:
            if len(pattern) != len(segs):
                continue
            info = {}
            for p, s in zip(pattern, segs):
                if p.startswith("{") and p.endswith("}") and s:
                    info[p[1:-1]] = s
                elif p != s:
                    break
            else:
                if m == method or (method == "HEAD" and m == "GET"):
                    return handler, info
                allowed.add(m)
        if allowed:
            raise HTTPMethodNotAllowed(headers={"Allow": ",".join(sorted(allowed))})
        raise HTTPNotFound()


class Application:
    """Routes plus the hooks: ``on_response_prepare`` (each called as
    ``hook(request, response)`` before a head is written) and
    ``on_shutdown`` (each awaited as ``hook(app)`` after the drain)."""

    def __init__(self, client_max_size: int = 1 << 20):
        self.router = Router()
        self.client_max_size = client_max_size
        self.on_response_prepare: list[Callable[[Request, Any], None]] = []
        self.on_shutdown: list[Callable[["Application"], Awaitable[None]]] = []


# ---------------------------------------------------------------- connections
class _Connection:
    """One client connection: requests read in turn (keep-alive), each
    handler run as a task with the socket watched for its close."""

    def __init__(self, server: "Server", reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.busy = False
        self._watch: asyncio.Task | None = None
        self._discard = False

    async def _fill(self) -> None:
        data = await self.reader.read(65536)
        if not data:
            raise asyncio.IncompleteReadError(bytes(self.buf), None)
        self.buf += data

    async def readuntil(self, sep: bytes, limit: int) -> bytes:
        while True:
            i = self.buf.find(sep)
            if i >= 0:
                out = bytes(self.buf[:i + len(sep)])
                del self.buf[:i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise ValueError("head too large")
            await self._fill()

    async def readexactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            await self._fill()
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    async def send(self, data: bytes) -> None:
        self.writer.write(data)
        await self.writer.drain()

    async def write_head(self, request: Request | None, resp) -> None:
        for hook in self.server.app.on_response_prepare:
            hook(request, resp)
        resp.headers.setdefault("Date", email.utils.formatdate(usegmt=True))
        lines = [f"HTTP/1.1 {resp.status} {_reason(resp.status)}"]
        lines += [f"{k}: {v}" for k, v in resp.headers.items()]
        await self.send(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))

    async def _watch_peer(self) -> None:
        """Read while a handler runs: bytes of a next request are kept, the
        end of the stream returns (the client went away)."""
        try:
            while True:
                data = await self.reader.read(65536)
                if not data:
                    return
                if not self._discard:
                    self.buf += data
        except ConnectionError:
            return

    def stop_watch(self) -> None:
        if self._watch is not None:
            self._watch.cancel()

    async def _read_body(self, headers: Headers, limit: int) -> tuple[bytes | None, bool, bool]:
        """(body, too_large, close_after)."""
        if headers.get("Transfer-Encoding", "").lower() == "chunked":
            body = bytearray()
            while True:
                size = int((await self.readuntil(b"\r\n", MAX_HEAD_BYTES)).split(b";")[0], 16)
                if size == 0:
                    while await self.readuntil(b"\r\n", MAX_HEAD_BYTES) != b"\r\n":
                        pass                  # trailer fields
                    return bytes(body), False, False
                if len(body) + size > limit:
                    return None, True, True   # the rest unread: close after the reply
                body += (await self.readexactly(size + 2))[:-2]
        n = int(headers.get("Content-Length", "0") or 0)
        if n < 0:
            raise ValueError("negative Content-Length")
        if n > limit:
            return None, True, True           # left unread: close after the reply
        return (await self.readexactly(n) if n else b""), False, False

    async def run(self) -> None:
        app = self.server.app
        while not self.server.closing:
            try:
                head = await self.readuntil(b"\r\n\r\n", MAX_HEAD_BYTES)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except ValueError:
                await self._plain(400, "Bad Request", close=True)
                return
            text = head.decode("latin-1").strip("\r\n")
            if not text:
                continue                     # empty lines before a request
            try:
                line, *rest = text.split("\r\n")
                method, target, version = line.split(" ")
                if not version.startswith("HTTP/1."):
                    raise ValueError(version)
                headers = Headers()
                for h in rest:
                    k, _, v = h.partition(":")
                    if not k.strip():
                        raise ValueError(h)
                    headers[k.strip()] = v.strip()
                if (headers.get("Expect", "").lower() == "100-continue"
                        and int(headers.get("Content-Length", "0") or 0)
                        <= app.client_max_size):
                    await self.send(b"HTTP/1.1 100 Continue\r\n\r\n")
                body, too_large, close_after = await self._read_body(
                    headers, app.client_max_size)
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            except ValueError:
                await self._plain(400, "Bad Request", close=True)
                return
            conn_hdr = headers.get("Connection", "").lower()
            close_after |= (conn_hdr == "close"
                            or (version == "HTTP/1.0" and conn_hdr != "keep-alive"))
            request = Request(self, method.upper(), target, version, headers, body,
                              too_large)
            self.busy = True               # until the response is written
            self._discard = close_after
            try:
                resp = await self._dispatch(request)
                if isinstance(resp, WebSocketResponse):
                    await resp.close()       # the socket was upgraded: its end
                    return
                if resp is None:
                    return                   # the client left
                if request._stream is not None and resp is not request._stream:
                    return                   # failed mid-stream: the head is out
                if isinstance(resp, StreamResponse):
                    if not resp.prepared:
                        await resp.prepare(request)
                    await resp.write_eof()
                else:
                    await self._write(request, resp, close_after)
            finally:
                self.busy = False
            if close_after:
                return

    async def _plain(self, status: int, text: str, close: bool) -> None:
        resp = Response(text=text, status=status)
        try:
            await self._write(None, resp, close)
        except ConnectionError:
            pass

    async def _write(self, request: Request | None, resp: Response, close: bool) -> None:
        resp.headers["Content-Length"] = str(len(resp.body))
        if close:
            resp.headers["Connection"] = "close"
        await self.write_head(request, resp)
        if resp.body and (request is None or request.method != "HEAD"):
            await self.send(resp.body)

    async def _call(self, request: Request):
        try:
            handler, request.match_info = self.server.app.router.resolve(
                request.method, request.path)
            resp = await handler(request)
        except HTTPException as e:
            return e.as_response()
        except (asyncio.CancelledError, ConnectionError):
            raise
        except Exception:
            traceback.print_exc()
            return Response(text="500 Internal Server Error\n\nServer got itself in trouble",
                            status=500)
        if isinstance(resp, HTTPException):
            return resp.as_response()
        return resp

    async def _dispatch(self, request: Request):
        """The handler's response, or None when the client went away (the
        handler's task was cancelled)."""
        task = asyncio.create_task(self._call(request))
        self.server.tasks.add(task)
        self._watch = asyncio.create_task(self._watch_peer())
        try:
            done, _ = await asyncio.wait({task, self._watch},
                                         return_when=asyncio.FIRST_COMPLETED)
            if task not in done and not self._watch.cancelled():
                task.cancel()                    # the socket closed mid-request
                await asyncio.wait({task})
                return None
            await asyncio.wait({task})
            try:
                return task.result()
            except (asyncio.CancelledError, ConnectionError):
                return None
        finally:
            self.server.tasks.discard(task)
            if not self._watch.done():
                self._watch.cancel()
                await asyncio.wait({self._watch})
            self._watch = None


class Server:
    """The listening socket and its connections."""

    def __init__(self, app: Application):
        self.app = app
        self.closing = False
        self.tasks: set[asyncio.Task] = set()
        self._conns: set[_Connection] = set()
        self._server: asyncio.base_events.Server | None = None
        self.port: int | None = None

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._client, host, port,
                                                  limit=MAX_HEAD_BYTES)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _client(self, reader, writer) -> None:
        conn = _Connection(self, reader, writer)
        self._conns.add(conn)
        try:
            await conn.run()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(conn)
            writer.close()

    async def shutdown(self, timeout: float = 60.0) -> None:
        """Stop accepting, drain the handlers in flight, close the idle
        connections, then run the on_shutdown hooks."""
        self.closing = True
        if self._server is not None:
            self._server.close()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while any(c.busy for c in self._conns) and loop.time() < deadline:
            await asyncio.sleep(0.01)
        for t in list(self.tasks):
            t.cancel()
        for c in list(self._conns):
            c.writer.close()
        for hook in self.app.on_shutdown:
            await hook(self.app)


def run_app(app: Application, host: str = "127.0.0.1", port: int = 8080,
            shutdown_timeout: float = 60.0, print=print) -> None:
    """Serve until SIGINT or SIGTERM, then shut down gracefully."""

    async def main():
        server = Server(app)
        await server.start(host, port)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        print(f"======== Running on http://{host}:{server.port} ========\n"
              "(Press CTRL+C to quit)", flush=True)
        await stop.wait()
        await server.shutdown(shutdown_timeout)

    asyncio.run(main())


class ServerThread:
    """An application served by an event loop in a thread of its own:
    ``ServerThread(app).start()`` returns once it listens (``port``);
    ``stop()`` shuts it down gracefully and joins the thread."""

    def __init__(self, app: Application, host: str = "127.0.0.1", port: int = 0):
        self.app, self.host, self.port = app, host, port
        self.loop: asyncio.AbstractEventLoop | None = None
        self._server: Server | None = None
        self._ready = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bitnet-http")

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run(self) -> None:
        self.loop = asyncio.new_event_loop()
        try:
            self._server = Server(self.app)
            self.loop.run_until_complete(self._server.start(self.host, self.port))
            self.port = self._server.port
        except BaseException as e:   # noqa: BLE001 — reported by start()
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()
        self.loop.close()

    def start(self, timeout: float = 30.0) -> "ServerThread":
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("the HTTP server did not start")
        if self._error is not None:
            raise self._error
        return self

    def stop(self, timeout: float = 60.0) -> None:
        if self.loop is None or not self._thread.is_alive():
            return
        fut = asyncio.run_coroutine_threadsafe(self._server.shutdown(timeout), self.loop)
        try:
            fut.result(timeout + 30)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=30)


__all__ = [
    "Application", "Headers", "HTTPBadRequest", "HTTPException", "HTTPMethodNotAllowed",
    "HTTPNotFound", "HTTPRequestEntityTooLarge", "HTTPUnprocessableEntity", "Request",
    "Response", "Router", "Server", "ServerThread", "StreamResponse", "WSMessage",
    "WSMsgType", "WebSocketResponse", "json_response", "run_app",
]
