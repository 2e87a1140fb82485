"""The port's HTTP server (``bitnet_tpu_torch/serve/server.py`` on the
standard-library ``serve/http.py``) against the JAX package's aiohttp
server, on the CPU.

Both serve the mini QK256 GGUF at ``compute_dtype="f32"``, an f32 cache and
``kernel_path="xla"`` (where greedy tokens are the same in both packages,
``tests/test_torch_scheduler.py``), two slots, S = 128.  The JAX app runs
under ``aiohttp.test_utils.TestServer`` as ``tests/test_serve.py`` runs it,
the port's on a loopback port through ``serve/http.ServerThread`` with
``device="cpu"``; one aiohttp client sends both the same requests, one at a
time.  Held equal, with ids, timestamps and timings masked: every route's
status and JSON body, greedy tokens and text, the SSE event sequences
(native and OpenAI, ``[DONE]`` included), the WebSocket message sequence,
the security headers; the Prometheus metric names (the port's scheduler
keeps three counters more: prefills, decode_s, captures).  Security (401,
429 then the 403 auto-block, 413, 400, 422) mirrors
``tests/test_server_security.py``.  A client that closes mid-stream
cancels its request.
"""

import asyncio
import json
import os
import threading
import time

import jax.numpy as jnp
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestServer  # noqa: E402

from bitnet_tpu.config import EngineConfig as JEngineConfig  # noqa: E402
from bitnet_tpu.models import load_model as jload_model  # noqa: E402
from bitnet_tpu.serve.model_manager import ModelManager as JModelManager  # noqa: E402
from bitnet_tpu.serve.model_manager import RateLimiter as JRateLimiter  # noqa: E402
from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler  # noqa: E402
from bitnet_tpu.serve.server import BitNetServer as JServer  # noqa: E402
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer  # noqa: E402
from bitnet_tpu_torch.config import EngineConfig  # noqa: E402
from bitnet_tpu_torch.errors import ConfigError  # noqa: E402
from bitnet_tpu_torch.models.loader import load_model  # noqa: E402
from bitnet_tpu_torch.serve import http  # noqa: E402
from bitnet_tpu_torch.serve.model_manager import ModelManager, RateLimiter  # noqa: E402
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler  # noqa: E402
from bitnet_tpu_torch.serve.server import MAX_BODY_BYTES, SECURITY_HEADERS, BitNetServer  # noqa: E402
from bitnet_tpu_torch.tokenizer import load_tokenizer  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

KW = dict(max_seq_len=128, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
MASK = {"id", "created", "latency_s", "loaded_at", "checked_at", "uptime_s",
        "request_id"}


class _F(float):
    """A float that equals another within LOGPROB_TOL: the only floats the
    bodies carry are log-probabilities, which an f32 ulp of the logits
    moves."""

    def __eq__(self, other):
        return isinstance(other, float) and abs(self - other) <= LOGPROB_TOL

    __hash__ = float.__hash__


LOGPROB_TOL = 1e-5


def mask(x):
    if isinstance(x, dict):
        return {k: ("<masked>" if k in MASK else mask(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [mask(v) for v in x]
    if isinstance(x, float):
        return _F(x)
    return x


class _JaxApp:
    """The JAX app under aiohttp's TestServer, on an event loop of its own."""

    def __init__(self, app):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.server = TestServer(app, host="127.0.0.1")
        asyncio.run_coroutine_threadsafe(self.server.start_server(), self.loop).result(60)
        self.url = f"http://127.0.0.1:{self.server.port}"

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.server.close(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)


class Pair:
    """A JAX server and the port's, started over their own schedulers."""

    def __init__(self, jsrv, psrv):
        self.jsrv, self.psrv = jsrv, psrv
        self.japp = _JaxApp(jsrv.build_app())
        self.papp = http.ServerThread(psrv.build_app()).start()

    def stop(self):
        self.japp.stop()
        self.papp.stop()

    def run(self, fn):
        """``fn(session, url)`` against both; (JAX result, port result)."""
        async def both():
            async with aiohttp.ClientSession() as s:
                return (await fn(s, self.japp.url), await fn(s, self.papp.url))
        return asyncio.run(both())


async def fetch(s, url, method, path, **kw):
    async with s.request(method, url + path, **kw) as r:
        body = await r.read()
        try:
            js = json.loads(body)
        except ValueError:
            js = None
        return r.status, dict(r.headers), body, js


@pytest.fixture(scope="module")
def models(mini_gguf_qk256):
    path = mini_gguf_qk256.path
    jcfg, jparams, _ = jload_model(path, param_dtype=jnp.float32)
    cfg, params, _ = load_model(path, param_dtype=torch.float32, device="cpu")
    return (jcfg, jparams, jload_tokenizer(path)), (cfg, params, load_tokenizer(path))


def _scheds(models, **kw):
    (jcfg, jparams, jtok), (cfg, params, tok) = models
    js = JScheduler(jcfg, jparams, jtok, JEngineConfig(**KW), num_slots=2, **kw)
    ps = ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(**KW), num_slots=2,
                                     device="cpu", **kw)
    return js, ps


@pytest.fixture(scope="module")
def pair(models):
    js, ps = _scheds(models)
    p = Pair(JServer(js), BitNetServer(ps, device="cpu"))
    yield p
    p.stop()
    js.shutdown()
    ps.shutdown()


# --------------------------------------------------------------------------
# every route: status and body
# --------------------------------------------------------------------------
GREEDY = {"max_new_tokens": 6, "greedy": True}
CHAT = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}}]

ROUTES = [
    ("POST", "/v1/inference", {"prompt": "hello", **GREEDY}),
    ("POST", "/inference", {"tokens": [1, 7, 20, 3], **GREEDY}),
    ("POST", "/v1/inference", {"prompt": "ab", "max_new_tokens": 5, "greedy": True,
                               "repetition_penalty": 1.3, "logit_bias": {"98": 2.0},
                               "priority": 1, "timeout_s": 60}),
    ("POST", "/v1/inference", {"prompt": "ab", **GREEDY, "logprobs": 2}),
    ("POST", "/v1/inference", {"prompt": "ab", "max_new_tokens": 8, "greedy": True,
                               "stop": "e"}),
    ("POST", "/v1/inference", {"prompt": "ab", "max_new_tokens": 6, "greedy": True,
                               "grammar": 'root ::= [ab]{3} "!"'}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 5, "greedy": True}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 4, "greedy": True,
                                      "n": 2, "logprobs": True, "top_logprobs": 2}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 24, "greedy": True,
                                      "tools": TOOLS, "tool_choice": "required"}),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "max_tokens": 24, "greedy": True,
                                      "response_format": {"type": "json_object"}}),
    ("POST", "/v1/completions", {"prompt": "abc", "max_tokens": 5, "greedy": True,
                                 "echo": True, "logprobs": 1}),
    ("POST", "/v1/completions", {"prompt": ["ab", "cd"], "max_tokens": 3,
                                 "greedy": True}),
    ("POST", "/v1/completions", {"prompt": ["ab", "cd"], "max_tokens": 3,
                                 "stream": True}),
    ("POST", "/tokenize", {"content": "hello there"}),
    ("POST", "/tokenize", {"content": 5}),
    ("POST", "/detokenize", {"tokens": [1, 107, 104, 111]}),
    ("POST", "/detokenize", {"tokens": [-1]}),
    ("GET", "/props", None),
    ("GET", "/slots", None),
    ("GET", "/v1/models", None),
    ("GET", "/v1/models/bitnet-tpu", None),
    ("GET", "/v1/models/nope", None),
    ("GET", "/health", None),
    ("GET", "/healthz", None),
    ("GET", "/v1/canary", None),
    ("POST", "/v1/models/load", {"name": "x"}),
    ("POST", "/v1/admin/checkpoint", {}),
    ("DELETE", "/v1/models/nope", None),
    ("POST", "/v1/inference", {"prompt": "x", "model": "nope"}),
    ("GET", "/v1/nothing", None),
    ("PUT", "/v1/inference", None),
]


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p} {i}" for i, (m, p, _b) in enumerate(ROUTES)])
def test_routes_answer_as_the_jax_server(pair, method, path, body):
    kw = {} if body is None else {"json": body}
    (js, jh, jb, jj), (ps, ph, pb, pj) = pair.run(
        lambda s, u: fetch(s, u, method, path, **kw))
    assert ps == js, (pb, jb)
    if jj is None:
        assert pb == jb
    else:
        assert mask(pj) == mask(jj)
    for k in SECURITY_HEADERS:
        if k in jh:
            assert ph.get(k) == jh[k], k
        assert k in ph
    assert ph.get("Content-Type") == jh.get("Content-Type")
    if jh.get("WWW-Authenticate"):
        assert ph["WWW-Authenticate"] == jh["WWW-Authenticate"]


def test_stats_and_devices_keys_are_the_jax_servers(pair):
    (_, _, _, jst), (_, _, _, pst) = pair.run(lambda s, u: fetch(s, u, "GET", "/v1/stats"))
    assert set(jst) <= set(pst)
    assert set(pst) - set(jst) <= {"prefills", "decode_s", "captures"}
    (_, _, _, jd), (_, _, _, pd) = pair.run(lambda s, u: fetch(s, u, "GET", "/v1/devices"))
    assert set(pd) == set(jd) and set(pd["device"]) == set(jd["device"])
    assert [set(x) for x in pd["schedulers"]] == [set(x) for x in jd["schedulers"]]
    assert pd["device"]["platform"] == "cpu" and pd["healthy"] == jd["healthy"] is True


def test_metrics_names_are_the_jax_servers(pair):
    (js, jh, jb, _), (ps, ph, pb, _) = pair.run(lambda s, u: fetch(s, u, "GET", "/metrics"))
    assert ps == js == 200 and ph["Content-Type"] == jh["Content-Type"]

    def names(b):
        return {ln.split()[0] for ln in b.decode().splitlines() if ln and ln[0] != "#"}
    jn, pn = names(jb), names(pb)
    assert jn <= pn
    assert pn - jn <= {"bitnet_prefills", "bitnet_decode_s", "bitnet_captures"}


def test_embeddings_are_the_jax_servers(pair):
    body = {"input": ["hello", [1, 7, 20]]}
    (js, _, _, jj), (ps, _, _, pj) = pair.run(
        lambda s, u: fetch(s, u, "POST", "/v1/embeddings", json=body))
    assert ps == js == 200
    assert [d["index"] for d in pj["data"]] == [d["index"] for d in jj["data"]]
    # the JAX scheduler's throwaway cache is bf16 (allocate_cache's default,
    # bitnet_tpu/serve/scheduler.py:1885), the port's f32 for an f32 pool:
    # the rows differ by the KV's bf16 rounding
    for a, b in zip(pj["data"], jj["data"]):
        torch.testing.assert_close(torch.tensor(a["embedding"]),
                                   torch.tensor(b["embedding"]), atol=2e-3, rtol=1e-2)
    assert pj["usage"] == jj["usage"] and pj["model"] == jj["model"]
    (js, _, _, jj), (ps, _, _, pj) = pair.run(
        lambda s, u: fetch(s, u, "POST", "/v1/embeddings", json={"input": 3}))
    assert ps == js == 422 and pj == jj


# --------------------------------------------------------------------------
# streams: SSE and the WebSocket
# --------------------------------------------------------------------------
def _events(body: bytes) -> list:
    out = []
    for frame in body.decode().split("\n\n"):
        if not frame:
            continue
        assert frame.startswith("data: "), frame
        data = frame[len("data: "):]
        out.append(data if data == "[DONE]" else mask(json.loads(data)))
    return out


STREAMS = [
    ("/v1/inference/stream", {"prompt": "hello", **GREEDY}),
    ("/v1/inference/stream", {"prompt": "ab", **GREEDY, "logprobs": 1}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 5, "greedy": True,
                              "stream": True}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 24, "greedy": True,
                              "stream": True, "tools": TOOLS,
                              "tool_choice": {"type": "function",
                                              "function": {"name": "get_weather"}}}),
    ("/v1/completions", {"prompt": "abc", "max_tokens": 5, "greedy": True,
                         "stream": True, "echo": True}),
]


@pytest.mark.parametrize("path,body", STREAMS, ids=[f"{p} {i}" for i, (p, _b) in
                                                     enumerate(STREAMS)])
def test_sse_events_are_the_jax_servers(pair, path, body):
    (js, jh, jb, _), (ps, ph, pb, _) = pair.run(
        lambda s, u: fetch(s, u, "POST", path, json=body))
    assert ps == js == 200
    assert ph["Content-Type"] == jh["Content-Type"] == "text/event-stream"
    assert ph["Transfer-Encoding"] == "chunked"
    je, pe = _events(jb), _events(pb)
    assert pe == je
    assert len(pe) >= 3


def test_websocket_messages_are_the_jax_servers(pair):
    async def talk(s, u):
        msgs = []
        async with s.ws_connect(u + "/v1/ws") as ws:
            await ws.send_json({"prompt": "hello", **GREEDY})
            while True:
                m = await ws.receive_json()
                msgs.append(m)
                if m.get("done"):
                    break
            await ws.send_json({"prompt": "x", "max_new_tokens": 0})
            msgs.append(await ws.receive_json())
            await ws.send_json({"tokens": [1, 7, 20], "max_new_tokens": 3,
                                "greedy": True, "logprobs": 1})
            while True:
                m = await ws.receive_json()
                msgs.append(m)
                if m.get("done"):
                    break
            await ws.close()
        return msgs
    jm, pm = pair.run(talk)
    assert mask(pm) == mask(jm) and len(pm) >= 5 and pm[-1]["done"] is True


def test_websocket_ping_and_binary_close(pair):
    """A ping is answered with a pong; a binary frame ends the session."""
    async def talk(s, u):
        async with s.ws_connect(u + "/v1/ws", autoping=False) as ws:
            await ws.ping(b"hi")
            pong = await ws.receive()
            await ws.send_bytes(b"\x00")
            end = await ws.receive()
            return pong.type, pong.data, end.type
    jr, pr = pair.run(talk)
    assert pr == jr
    assert pr[0] == aiohttp.WSMsgType.PONG and pr[1] == b"hi"


def _wait_cancelled(sched, before):
    deadline = time.time() + 30
    while sched.stats["cancelled"] == before and time.time() < deadline:
        time.sleep(0.02)
    return sched.stats["cancelled"] - before


def test_a_client_that_closes_mid_stream_cancels_its_request(pair):
    sched = pair.psrv.scheduler
    before = sched.stats["cancelled"]

    async def go(s, u):
        if u != pair.papp.url:
            return None
        async with s.post(u + "/v1/inference/stream",
                          json={"prompt": "hello", "max_new_tokens": 100,
                                "greedy": True}) as r:
            await r.content.readline()          # the first event, then close
        return True
    pair.run(go)
    assert _wait_cancelled(sched, before) == 1


def test_a_client_that_closes_mid_collect_cancels_its_request(pair):
    """The non-streaming route too: the socket's close cancels the
    handler, which cancels the request."""
    import socket

    sched = pair.psrv.scheduler
    before, n0 = sched.stats["cancelled"], sched.stats["requests"]
    body = json.dumps({"prompt": "hello", "max_new_tokens": 120, "greedy": True,
                       "min_new_tokens": 120}).encode()
    sock = socket.create_connection(("127.0.0.1", pair.papp.port))
    sock.sendall(b"POST /v1/inference HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(body), body))
    deadline = time.time() + 30
    while sched.stats["requests"] == n0 and time.time() < deadline:
        time.sleep(0.005)
    sock.close()
    assert _wait_cancelled(sched, before) == 1


def test_concurrent_requests_each_equal_their_solo_answer(pair):
    bodies = [{"prompt": p, "max_new_tokens": 5, "greedy": True}
              for p in ("a", "bc", "def", "ghij", "k", "lm")]

    async def solo(s, u):
        return [(await fetch(s, u, "POST", "/v1/inference", json=b))[3]["tokens"]
                for b in bodies]

    async def together(s, u):
        rs = await asyncio.gather(*[fetch(s, u, "POST", "/v1/inference", json=b)
                                    for b in bodies])
        return [r[3]["tokens"] for r in rs]
    (jsolo, psolo) = pair.run(solo)
    (_, ptog) = pair.run(together)
    assert psolo == jsolo and ptog == psolo


# --------------------------------------------------------------------------
# security: mirrors tests/test_server_security.py on both servers
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def secured(pair, mini_gguf_qk256, tmp_path_factory):
    """Servers with a token, over the module's schedulers (adopted)."""
    jm = JModelManager(JEngineConfig(**KW))
    jm.adopt("m", pair.jsrv.scheduler, path=mini_gguf_qk256.path)
    pm = ModelManager(EngineConfig(**KW), device="cpu")
    pm.adopt("m", pair.psrv.scheduler, path=mini_gguf_qk256.path)
    allowed = [str(tmp_path_factory.mktemp("allowed"))]
    p = Pair(JServer(manager=jm, auth_token="sekrit", allowed_model_dirs=allowed),
             BitNetServer(manager=pm, auth_token="sekrit", allowed_model_dirs=allowed))
    yield p
    p.stop()


AUTH = {"Authorization": "Bearer sekrit"}
SECURED = [
    ("POST", "/v1/inference", {"prompt": "x"}, {}),
    ("POST", "/v1/inference", {"prompt": "x", "max_new_tokens": 1},
     {"Authorization": "Bearer wrong"}),
    ("POST", "/v1/inference", {"prompt": "x", "max_new_tokens": 2, "greedy": True}, AUTH),
    ("GET", "/health", None, {}),
    ("POST", "/v1/models/load", {"name": "x", "path": "/nope"}, {}),
    ("DELETE", "/v1/models/m", None, {}),
    ("POST", "/v1/models/load", {"name": "evil", "path": "/etc/passwd"}, AUTH),
    ("POST", "/v1/admin/checkpoint", {"directory": "/etc"}, AUTH),
    ("POST", "/v1/admin/resume", {"directory": "/etc"}, AUTH),
    ("POST", "/v1/admin/resume", {}, AUTH),
    ("POST", "/tokenize", {"content": "x"}, {}),
    ("GET", "/slots", None, {}),
    ("GET", "/v1/ws", None, {}),
] + [("POST", "/v1/inference", b, AUTH) for b in (
    {"prompt": "x", "max_new_tokens": 0},
    {"prompt": "x", "max_new_tokens": "many"},
    {"prompt": "x", "temperature": -1.0},
    {"prompt": "x", "top_p": 1.5},
    {"prompt": "x", "top_k": -3},
    {"prompt": "x", "repetition_penalty": 0.0},
    {"prompt": 42},
    {"messages": []},
    {"messages": [{"role": "user"}]},
    {"tokens": ["a"]},
    {"prompt": "x", "grammar": "root ::= ("},
    {"prompt": "x", "tools": [{"type": "nope"}]},
    {"prompt": "x", "tool_choice": "required"},
    {"prompt": "x", "logit_bias": {"a": 1}},
    {"prompt": "x", "min_new_tokens": 9, "max_new_tokens": 3},
)]


@pytest.mark.parametrize("method,path,body,headers", SECURED,
                         ids=[f"{m} {p} {i}" for i, (m, p, _b, _h) in enumerate(SECURED)])
def test_security_answers_are_the_jax_servers(secured, method, path, body, headers):
    kw = {"headers": headers}
    if body is not None:
        kw["json"] = body
    (js, jh, jb, jj), (ps, ph, pb, pj) = secured.run(
        lambda s, u: fetch(s, u, method, path, **kw))
    assert ps == js, (pb, jb)
    assert mask(pj) == mask(jj)
    assert ph.get("WWW-Authenticate") == jh.get("WWW-Authenticate")
    for k, v in SECURITY_HEADERS.items():
        assert ph[k] == v


@pytest.mark.parametrize("how", ["declared", "invalid", "empty", "chunked"])
def test_body_limits_are_the_jax_servers(secured, how):
    """A declared Content-Length past the limit is a 413 before the body is
    read; a chunked body past it fails the JSON read (400), as in aiohttp."""
    big = json.dumps({"prompt": "z" * (MAX_BODY_BYTES + 1024)}).encode()
    data = {"declared": big, "invalid": b"{not json", "empty": b""}.get(how)

    def kw():
        if data is not None:
            return {"data": data, "headers": {**AUTH, "Content-Type": "application/json"}}

        async def chunks():
            for i in range(0, len(big), 1 << 16):
                yield big[i:i + (1 << 16)]
        return {"data": chunks(), "headers": {**AUTH, "Content-Type": "application/json"}}
    (js, _, jb, jj), (ps, _, pb, pj) = secured.run(
        lambda s, u: fetch(s, u, "POST", "/v1/inference", **kw()))
    assert ps == js == (413 if how == "declared" else 400)
    assert pj == jj


def test_rate_limit_then_auto_block_is_the_jax_servers(pair):
    js, ps = pair.jsrv.scheduler, pair.psrv.scheduler
    p = Pair(JServer(js, rate_limiter=JRateLimiter(rate_per_s=0.0, burst=1)),
             BitNetServer(ps, rate_limiter=RateLimiter(rate_per_s=0.0, burst=1),
                          device="cpu"))
    try:
        async def go(s, u):
            out = [(await fetch(s, u, "POST", "/v1/inference", json={
                "prompt": "x", "max_new_tokens": 1, "greedy": True}))[0]]
            for _ in range(60):
                out.append((await fetch(s, u, "POST", "/v1/inference",
                                        json={"prompt": "x"}))[0])
            return out
        jst, pst = p.run(go)
    finally:
        p.stop()
    assert pst == jst
    assert pst[0] == 200 and 429 in pst and pst[-1] == 403


# --------------------------------------------------------------------------
# the model manager over HTTP, checkpoints over HTTP
# --------------------------------------------------------------------------
def test_model_load_list_unload_and_the_whitelist(pair, mini_gguf_qk256, tmp_path):
    """A second model loads while the first serves (both loops on the
    device's one device loop thread), answers as the first (the same GGUF),
    lists, and unloads; a path outside the whitelist is refused."""
    d = os.path.dirname(mini_gguf_qk256.path)
    pm = ModelManager(EngineConfig(**KW), num_slots=2, device="cpu")
    pm.adopt("bitnet-tpu", pair.psrv.scheduler)
    srv = http.ServerThread(BitNetServer(manager=pm, allowed_model_dirs=[d]).build_app())
    srv.start()
    body = {"prompt": "hello", **GREEDY}
    try:
        async def go(s, u):
            first = await fetch(s, u, "POST", "/v1/inference", json=body)
            bg = asyncio.ensure_future(fetch(s, u, "POST", "/v1/inference", json={
                "prompt": "abc", "max_new_tokens": 40, "greedy": True}))
            load = await fetch(s, u, "POST", "/v1/models/load", json={
                "name": "second", "path": mini_gguf_qk256.path})
            second = await fetch(s, u, "POST", "/v1/inference",
                                 json={**body, "model": "second"})
            listed = await fetch(s, u, "GET", "/v1/models")
            refused = await fetch(s, u, "POST", "/v1/models/load", json={
                "name": "evil", "path": str(tmp_path / "x.gguf")})
            again = await fetch(s, u, "POST", "/v1/models/load", json={
                "name": "second", "path": mini_gguf_qk256.path})
            gone = await fetch(s, u, "DELETE", "/v1/models/second")
            after = await fetch(s, u, "GET", "/v1/models")
            return first, await bg, load, second, listed, refused, again, gone, after
        first, bg, load, second, listed, refused, again, gone, after = asyncio.run(
            _one(srv.url, go))
    finally:
        srv.stop()
        if "second" in {m["name"] for m in pm.list()}:
            pm.unload("second")
    assert first[0] == bg[0] == 200 and bg[3]["num_tokens"] >= 1
    assert load[0] == 200 and load[3]["name"] == "second"
    assert load[3]["chat_template"] == listed[3]["models"][1]["chat_template"]
    assert second[0] == 200 and second[3]["tokens"] == first[3]["tokens"]
    assert [m["name"] for m in listed[3]["models"]] == ["bitnet-tpu", "second"]
    assert refused[0] == 403 and again[0] == 400
    assert gone == (200, gone[1], gone[2], {"unloaded": "second"})
    assert [m["name"] for m in after[3]["models"]] == ["bitnet-tpu"]


async def _one(url, fn):
    async with aiohttp.ClientSession() as s:
        return await fn(s, url)


def test_admin_checkpoint_and_resume_over_http(pair, tmp_path):
    """An empty pool checkpoints nothing and resumes nothing, on both
    servers alike (the scheduler's files: tests/test_torch_server_units.py)."""
    d = str(tmp_path / "ck")
    body = {"directory": d}
    (js, _, _, jj), (ps, _, _, pj) = pair.run(
        lambda s, u: fetch(s, u, "POST", "/v1/admin/checkpoint", json=body))
    assert ps == js == 200 and pj == jj == {"written": [], "count": 0}
    (js, _, _, jj), (ps, _, _, pj) = pair.run(
        lambda s, u: fetch(s, u, "POST", "/v1/admin/resume", json=body))
    assert ps == js == 200 and pj == jj == {"resumed": []}


def test_the_server_needs_cuda_unless_asked_for_cpu(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        BitNetServer(pair.psrv.scheduler)
    with pytest.raises(ConfigError, match="CUDA is not available"):
        ModelManager()
    srv = BitNetServer(pair.psrv.scheduler, device="cpu")
    assert srv.manager.device.type == "cpu"
