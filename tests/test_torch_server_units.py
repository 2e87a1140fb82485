"""The server's modules on the CPU, held to the JAX package's:
``toolcall.py``, ``obs/otlp.py``, ``obs/profiler.py``, ``serve/recovery.py``,
``serve/health.py``, ``serve/model_manager.py`` (the rate limiter, the
template detection), the scheduler's request checkpoints (files from either
package resume in the other to the unbroken run's greedy tokens), the
device loop (two schedulers on one device thread, jobs between steps),
the HTTP layer's own pieces (routing, the WebSocket accept key, chunked
bodies, the graceful shutdown) and ``cli serve`` / ``python -m
bitnet_tpu_torch.server`` as processes.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bitnet_tpu.errors as jerr
import bitnet_tpu.toolcall as jtc
from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGen
from bitnet_tpu.models import load_model as jload_model
from bitnet_tpu.obs import otlp as jotlp
from bitnet_tpu.obs import profiler as jprof
from bitnet_tpu.serve import health as jhealth
from bitnet_tpu.serve import model_manager as jmm
from bitnet_tpu.serve import recovery as jrec
from bitnet_tpu.serve.scheduler import ContinuousBatchingScheduler as JScheduler
from bitnet_tpu.tokenizer import load_tokenizer as jload_tokenizer
import bitnet_tpu_torch.errors as perr
import bitnet_tpu_torch.toolcall as ptc
from bitnet_tpu_torch import cli
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.models.loader import load_model
from bitnet_tpu_torch.obs import otlp as potlp
from bitnet_tpu_torch.obs import profiler as pprof
from bitnet_tpu_torch.serve import health as phealth
from bitnet_tpu_torch.serve import http
from bitnet_tpu_torch.serve import model_manager as pmm
from bitnet_tpu_torch.serve import recovery as prec
from bitnet_tpu_torch.serve import scheduler as psched
from bitnet_tpu_torch.serve.scheduler import ContinuousBatchingScheduler
from bitnet_tpu_torch.tokenizer import load_tokenizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
PROMPT = [1, 7, 20, 3]

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather for a city",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"}},
                   "required": ["city"]}}},
    {"type": "function", "function": {"name": "noop"}}]


# --------------------------------------------------------------------------
# toolcall.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("tools,choice", [
    (TOOLS, None), (TOOLS, "auto"), (TOOLS, "required"),
    (TOOLS, {"type": "function", "function": {"name": "noop"}}),
    ([], None), ("x", None), ([{"type": "function", "function": {"name": ""}}], None),
    (TOOLS + TOOLS[:1], None), (TOOLS, "sometimes"),
    (TOOLS, {"type": "function", "function": {"name": "missing"}}),
    ([{"type": "function", "function": {"name": "f", "parameters": 3}}], None)])
def test_tool_validation_and_grammar_are_the_jax_modules(tools, choice):
    try:
        want = jtc.validate_tools(tools, choice)
    except jtc.ToolCallError as e:
        with pytest.raises(ptc.ToolCallError, match=None) as got:
            ptc.validate_tools(tools, choice)
        assert str(got.value) == str(e) and isinstance(got.value, perr.ConfigError)
        return
    fns = ptc.validate_tools(tools, choice)
    assert fns == want
    assert ptc.tool_choice_grammar(fns, choice) == jtc.tool_choice_grammar(want, choice)
    assert ptc.tools_system_text(fns) == jtc.tools_system_text(want)


@pytest.mark.parametrize("text", [
    '{"name": "get_weather", "arguments": {"city": "Oslo"}}',
    '  {"name": "noop", "arguments": {}}  ', '{"name": "other", "arguments": {}}',
    '{"name": "noop", "arguments": 3}', "plain text", "{broken", "[1, 2]"])
def test_tool_call_parsing_is_the_jax_modules(text):
    fns = ptc.validate_tools(TOOLS)
    assert ptc.parse_tool_calls(text, fns) == jtc.parse_tool_calls(text, fns)


def test_tool_messages_are_the_jax_modules():
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "hi"},
            {"role": "assistant", "content": None, "tool_calls": [
                {"function": {"name": "get_weather", "arguments": '{"city": "Oslo"}'}},
                {"function": {"arguments": "{}"}}, "junk",
                {"function": {"name": "noop", "arguments": "{bad"}}]},
            {"role": "tool", "name": "get_weather", "content": "sunny"}]
    for m in (msgs, msgs[1:]):
        got = ptc.normalize_tool_messages(m, ptc.validate_tools(TOOLS))
        want = jtc.normalize_tool_messages(m, jtc.validate_tools(TOOLS))
        assert [(x.role, x.content) for x in got] == [(x.role, x.content) for x in want]


# --------------------------------------------------------------------------
# obs: otlp, profiler
# --------------------------------------------------------------------------
def _no_times(doc):
    if isinstance(doc, dict):
        return {k: _no_times(v) for k, v in doc.items() if not k.endswith("UnixNano")}
    if isinstance(doc, list):
        return [_no_times(v) for v in doc]
    return doc


@pytest.mark.parametrize("metrics,attrs", [
    ({"requests_total": 3, "queue_depth": 1.5, "uptime_seconds": 9.0}, None),
    ({}, {"service.name": "x", "host": "h"}),
    ({"a_total": 0, "b": -1}, {"k": 1})])
def test_otlp_payload_is_the_jax_modules(metrics, attrs):
    got = potlp.encode_metrics(metrics, attrs, start_ns=5)
    want = jotlp.encode_metrics(metrics, attrs, start_ns=5)
    assert _no_times(got) == _no_times(want)
    sums = [m for m in got["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]
            if "sum" in m]
    assert all(m["sum"]["dataPoints"][0]["startTimeUnixNano"] == "5" for m in sums)


def test_otlp_is_inert_without_an_endpoint(monkeypatch):
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    e = potlp.OTLPExporter(lambda: {"x": 1.0})
    e.start()
    assert not e.enabled and e._thread is None and e.export_once() is False
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", "http://127.0.0.1:9/")
    e = potlp.OTLPExporter(lambda: {"x": 1.0}, timeout_s=0.5)
    assert e.endpoint == "http://127.0.0.1:9/v1/metrics"
    assert e.export_once() is False and e.failed == 1


def test_profiler_phases_and_traces(tmp_path):
    for mod in (pprof, jprof):
        p = mod.Profiler()
        with p.phase("prefill", n=3):
            pass
        for _ in range(2):
            with p.phase("decode"):
                pass
        p.instant("mark")
        summ = p.summary()
        assert sorted(summ) == ["decode", "prefill"] and summ["decode"]["count"] == 2
        p.export_chrome_trace(str(tmp_path / f"{mod.__name__}.json"))
        doc = json.loads((tmp_path / f"{mod.__name__}.json").read_text())
        assert [e["name"] for e in doc["traceEvents"]] == ["prefill", "decode", "decode",
                                                           "mark"]
    with pprof.device_trace(str(tmp_path / "dev")) as d:
        torch.ones(4) @ torch.ones(4)
    names = {e.get("name") for e in json.loads(
        open(os.path.join(d, "trace.json")).read())["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    assert pprof.device_memory_stats() == {"available": False, "platform": "cpu"} \
        or torch.cuda.is_available()


# --------------------------------------------------------------------------
# recovery
# --------------------------------------------------------------------------
ERRORS = ["ConfigError", "FormatError", "SecurityError", "TokenizerError", "ModelError",
          "KernelError", "QuantizationError", "StrictModeViolation", "BitNetError"]


@pytest.mark.parametrize("exc", [
    *[(name, "boom") for name in ERRORS],
    ("InferenceError", "no free slot"), ("InferenceError", "Queue full"),
    ("InferenceError", "bad input"), ("InferenceError", "request timed out"),
    ("TimeoutError", ""), ("ConnectionError", ""), ("BrokenPipeError", ""),
    ("MemoryError", ""), ("RuntimeError", "device reset")])
def test_error_classes_are_the_jax_modules(exc):
    import builtins

    name, msg = exc
    pe = getattr(perr, name, None) or getattr(builtins, name)
    je = getattr(jerr, name, None) or getattr(builtins, name)
    got, want = prec.classify_error(pe(msg)), jrec.classify_error(je(msg))
    assert got.value == want.value
    assert (prec.RetryPolicy().should_retry(pe(msg), 0)
            == jrec.RetryPolicy().should_retry(je(msg), 0))
    assert not prec.RetryPolicy().should_retry(pe(msg), 2)


@pytest.mark.parametrize("depth,slots,requested", [
    (0, 4, 500), (15, 4, 500), (16, 4, 500), (63, 4, 500), (64, 4, 500),
    (64, 4, 32), (3, 0, 300), (200, 8, 1000)])
def test_degradation_caps_are_the_jax_modules(depth, slots, requested):
    pg, jg = prec.GracefulDegradation(), jrec.GracefulDegradation()
    pl, jl = pg.level(depth, slots), jg.level(depth, slots)
    assert pl.value == jl.value
    assert pg.cap_tokens(pl, requested) == jg.cap_tokens(jl, requested)


def test_retry_policy_backs_off_and_reraises():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TimeoutError("again")
        return "ok"
    pol = prec.RetryPolicy(base_delay_s=0.001, max_delay_s=0.002)
    assert pol.run(flaky) == "ok" and len(calls) == 3
    assert prec.RetryPolicy(jitter=0.0).delay(3) == jrec.RetryPolicy(jitter=0.0).delay(3)
    with pytest.raises(perr.ConfigError):
        pol.run(lambda: (_ for _ in ()).throw(perr.ConfigError("no")))


# --------------------------------------------------------------------------
# model manager pieces, health, the failover router
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models(mini_gguf_qk256):
    path = mini_gguf_qk256.path
    jcfg, jparams, _ = jload_model(path, param_dtype=jnp.float32)
    cfg, params, _ = load_model(path, param_dtype=torch.float32, device="cpu")
    return (jcfg, jparams, jload_tokenizer(path)), (cfg, params, load_tokenizer(path))


def make(models, **kw):
    cfg, params, tok = models[1]
    kw.setdefault("num_slots", 2)
    return ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(**KW), device="cpu",
                                       **kw)


def make_jax(models, **kw):
    cfg, params, tok = models[0]
    kw.setdefault("num_slots", 2)
    return JScheduler(cfg, params, tok, JEngineConfig(**KW), **kw)


def test_rate_limiter_is_the_jax_modules():
    for mod in (pmm, jmm):
        rl = mod.RateLimiter(rate_per_s=0.0, burst=2)
        assert [rl.allow("a") for _ in range(3)] == [True, True, False]
        rl.block("b")
        assert rl.is_blocked("b") and not rl.allow("b")
        rl.unblock("b")
        assert rl.allow("b") and rl.cleanup(max_age_s=-1) == 2


def test_template_detection_is_the_jax_modules(mini_gguf_qk256, mini_gguf_bitnet32):
    for path in (mini_gguf_qk256.path, mini_gguf_bitnet32.path, "", "/nonexistent"):
        got, want = pmm._detect_template(path), jmm._detect_template(path)
        assert (got[0].value, got[1], got[2]) == (want[0].value, want[1], want[2])


def test_health_snapshot_and_router_are_the_jax_modules(models):
    ps, js = make(models), make_jax(models)
    try:
        pman = pmm.ModelManager(EngineConfig(**KW), device="cpu")
        jman = jmm.ModelManager(JEngineConfig(**KW))
        pman.adopt("a", ps)
        jman.adopt("a", js)
        got, want = phealth.HealthMonitor(pman), jhealth.HealthMonitor(jman)
        g, w = got.refresh(), want.refresh()
        assert set(g) == set(w) and set(g["device"]) == set(w["device"])
        assert g["schedulers"][0].keys() == w["schedulers"][0].keys()
        assert g["healthy"] is w["healthy"] is True
        c = got.canary(max_new_tokens=2)
        assert c["ok"] is True and c["tokens"] == want.canary(max_new_tokens=2)["tokens"]
        assert prec.FailoverRouter(pman).route()[1] == jrec.FailoverRouter(jman).route()[1]
        with pytest.raises(perr.ModelError, match="not loaded"):
            prec.FailoverRouter(pman).route("zzz")
        got.refresh_s = 0.01
        got.start()
        t0 = got.snapshot["checked_at"]
        time.sleep(0.2)
        got.stop()
        assert got.snapshot["checked_at"] > t0
    finally:
        ps.shutdown()
        js.shutdown()
    assert not ps.alive
    assert prec.FailoverRouter(pman)._healthy(ps) is False
    assert phealth.HealthMonitor(pman).refresh()["healthy"] is False


# --------------------------------------------------------------------------
# request checkpoints: either package resumes the other's files
# --------------------------------------------------------------------------
def _step_until(sched, reqs, n_first, got):
    """Step a hand-driven scheduler until each request emitted n_first
    tokens (or finished)."""
    for _ in range(400):
        sched._step()
        for i, r in enumerate(reqs):
            while True:
                try:
                    tok, _t, done, _r = r.out.get_nowait()
                except Exception:
                    break
                if tok is not None:
                    got[i].append(tok)
        if all(len(g) >= n_first for g in got):
            return


def _drain(sched, reqs, got, steps=400):
    done = [False] * len(reqs)
    for _ in range(steps):
        if all(done):
            return
        sched._step()
        for i, r in enumerate(reqs):
            while not done[i]:
                try:
                    tok, _t, fin, _r = r.out.get_nowait()
                except Exception:
                    break
                if tok is not None:
                    got[i].append(tok)
                done[i] = fin
    assert all(done)


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port"),
                                     ("port", "port")])
def test_request_checkpoints_resume_across_packages(models, tmp_path, src, dst):
    """Two greedy requests decode 4 tokens each, a third waits in the
    queue; the source checkpoints them, the destination resumes the files:
    every request's tokens are the unbroken run's."""
    prompts = [PROMPT, [1, 9, 9, 40, 41], [1, 5, 6]]
    makers = {"port": (make, GenerationConfig), "jax": (make_jax, JGen)}
    mk, G = makers[src]
    gen = G(max_new_tokens=10, greedy=True)
    full = make(models, start_loop=False)
    want = [[] for _ in prompts]
    _drain(full, [full.submit(p, GenerationConfig(max_new_tokens=10, greedy=True))
                  for p in prompts], want)
    full.shutdown()

    s1 = mk(models, start_loop=False)
    reqs = [s1.submit(p, gen) for p in prompts]
    first = [[] for _ in prompts]
    _step_until(s1, reqs[:2], 4, first[:2])
    written = s1.checkpoint_requests(str(tmp_path))
    assert len(written) == 3 and sum(w.endswith(".pending.json") for w in written) == 1
    s1.shutdown()
    mk2, _ = makers[dst]
    s2 = mk2(models, start_loop=False)
    resumed = s2.resume_requests(str(tmp_path))
    assert len(resumed) == 3
    rest = [[] for _ in resumed]
    _drain(s2, resumed, rest)
    s2.shutdown()
    by_prompt = {tuple(r.token_ids): i for i, r in enumerate(resumed)}
    for i, p in enumerate(prompts):
        j = by_prompt[tuple(p)]
        got = rest[j] if i == 2 else first[i] + rest[j]
        assert got == want[i], (i, first[i], rest[j], want[i])


def test_checkpoint_of_a_paged_pool_resumes_dense(models, tmp_path):
    """A paged pool's slot rows are gathered from its pages into the
    canonical layout; a dense pool (and a paged one) resume them."""
    gen = GenerationConfig(max_new_tokens=9, greedy=True)
    full = make(models, start_loop=False)
    want = [[]]
    _drain(full, [full.submit(PROMPT, gen)], want)
    s1 = make(models, start_loop=False, paged=True, page_size=8)
    r = s1.submit(PROMPT, gen)
    first = [[]]
    _step_until(s1, [r], 3, first)
    s1.checkpoint_requests(str(tmp_path))
    for kw in ({}, {"paged": True, "page_size": 4}):
        s2 = make(models, start_loop=False, **kw)
        rest = [[]]
        _drain(s2, s2.resume_requests(str(tmp_path)), rest)
        assert first[0] + rest[0] == want[0], kw


def test_a_resumed_request_keeps_its_min_phase(models, tmp_path):
    """A request checkpointed inside its min_new_tokens phase resumes with
    the rest of that phase (EOS and the stop ids still banned) to the
    unbroken run's tokens.  The JAX scheduler cannot resume that file: it
    gives the resumed request the whole min_new_tokens against its smaller
    budget, which its GenerationConfig refuses."""
    gen = GenerationConfig(max_new_tokens=12, min_new_tokens=10, greedy=True)
    full = make(models, start_loop=False)
    want = [[]]
    _drain(full, [full.submit(PROMPT, gen)], want)
    s1 = make(models, start_loop=False)
    first = [[]]
    _step_until(s1, [s1.submit(PROMPT, gen)], 4, first)
    s1.checkpoint_requests(str(tmp_path))
    s2 = make(models, start_loop=False)
    resumed = s2.resume_requests(str(tmp_path))
    assert resumed[0].gen.min_new_tokens == 10 - len(first[0])
    assert s2.slots[0].min_ban
    rest = [[]]
    _drain(s2, resumed, rest)
    assert first[0] + rest[0] == want[0]
    with pytest.raises(jerr.ConfigError, match="min_new_tokens"):
        make_jax(models, start_loop=False).resume_requests(str(tmp_path))


# --------------------------------------------------------------------------
# the device loop
# --------------------------------------------------------------------------
def _collect(req, timeout=120):
    toks = []
    while True:
        tok, _t, done, _r = req.out.get(timeout=timeout)
        if tok is not None:
            toks.append(tok)
        if done:
            return toks


def test_schedulers_on_one_device_share_its_loop(models):
    """Two started schedulers of one device step on one thread; each
    answers as alone; an embedding asked while the pool decodes is the
    idle one, computed on the device loop's thread between steps."""
    a, b = make(models), make(models)
    try:
        assert a._devloop is b._devloop is psched.DeviceLoop.get(torch.device("cpu"))
        idle = a.embed_ids([1, 7, 20, 3, 9])
        gen = GenerationConfig(max_new_tokens=30, greedy=True)
        ra, rb = a.submit(PROMPT, gen), b.submit(PROMPT, gen)
        seen = set()
        orig = a._embed_ids

        def spy(ids):
            seen.add(threading.get_ident())
            return orig(ids)
        a._embed_ids = spy
        busy = a.embed_ids([1, 7, 20, 3, 9])
        ta, tb = _collect(ra), _collect(rb)
        assert ta == tb and len(ta) == 30
        assert seen == {a._devloop.ident} and a._devloop.ident != threading.get_ident()
        np.testing.assert_array_equal(busy, idle)
    finally:
        a.shutdown()
        b.shutdown()


def test_a_failing_scheduler_leaves_the_others_running(models):
    a, b = make(models), make(models)
    try:
        def boom():
            raise RuntimeError("step failed")
        a._step = boom
        ra = a.submit(PROMPT, GenerationConfig(max_new_tokens=3, greedy=True))
        tok, _t, done, reason = ra.out.get(timeout=30)
        assert (tok, done, reason) == (None, True, None)
        assert isinstance(a.error, RuntimeError) and not a.alive
        rb = b.submit(PROMPT, GenerationConfig(max_new_tokens=3, greedy=True))
        assert len(_collect(rb)) == 3 and b.alive
        with pytest.raises(ValueError, match="job"):
            psched.run_on_device("cpu", lambda: (_ for _ in ()).throw(ValueError("job")))
    finally:
        a.shutdown()
        b.shutdown()


def test_a_dropped_hand_driven_scheduler_releases_its_device(models):
    """A scheduler stepped by hand claims the card for the stepping thread;
    its shutdown, or its end, gives the card back, so a later scheduler's
    loop can drive it (a decode from a thread that owns nothing still
    raises)."""
    import gc

    from bitnet_tpu_torch.ops import decode_attention as da

    card = torch.device("cuda", 0)
    for end in ("shutdown", "drop"):
        s = make(models, start_loop=False)
        s.device = card                       # the claim alone: no CUDA call
        s._claim()
        assert da._OWNERS[0][0] == threading.get_ident()
        err = {}
        t = threading.Thread(target=lambda: err.setdefault("e", _raises(
            lambda: da.claim_device(card, "another loop"))))
        t.start()
        t.join()
        assert "already driven" in str(err["e"])
        if end == "shutdown":
            s.shutdown()
        del s
        gc.collect()
        assert 0 not in da._OWNERS


def _raises(fn):
    try:
        fn()
    except RuntimeError as e:
        return e
    return None


def test_a_request_the_failed_loop_ended_is_an_error(models):
    """The loop fails with a request in flight: the client gets a 500 and
    the health check a 503, never a finished answer."""
    from bitnet_tpu_torch.serve.server import BitNetServer

    s = make(models)
    srv = http.ServerThread(BitNetServer(s, device="cpu").build_app()).start()
    real = s._step

    def step():
        if s.stats["requests"]:
            raise RuntimeError("the device failed")
        return real()
    s._step = step
    try:
        req = urllib.request.Request(srv.url + "/v1/inference", data=json.dumps(
            {"tokens": PROMPT, "max_new_tokens": 4, "greedy": True}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(srv.url + "/health", timeout=60)
        assert e.value.code == 503
    finally:
        srv.stop()
        s.shutdown()


def test_the_device_loop_ends_with_its_last_scheduler(models):
    s = make(models)
    drv = s._devloop
    s.shutdown()
    assert s not in drv._scheds and not s.alive
    if drv._scheds:                  # another test's scheduler still runs here
        pytest.skip("the CPU's device loop steps other schedulers of this process")
    drv.thread.join(10)
    assert not drv.thread.is_alive() and psched.DeviceLoop.get(drv.device) is None
    assert psched.run_on_device("cpu", threading.get_ident) == threading.get_ident()


# --------------------------------------------------------------------------
# the HTTP layer's own pieces
# --------------------------------------------------------------------------
def test_router_matches_methods_paths_and_parameters():
    r = http.Router()

    async def h(req):
        return None
    r.add_get("/v1/models/{name}", h)
    r.add_delete("/v1/models/{name}", h)
    r.add_post("/v1/models/load", h)
    assert r.resolve("GET", "/v1/models/abc") == (h, {"name": "abc"})
    assert r.resolve("HEAD", "/v1/models/abc")[1] == {"name": "abc"}
    assert r.resolve("POST", "/v1/models/load") == (h, {})
    with pytest.raises(http.HTTPMethodNotAllowed) as e:
        r.resolve("PUT", "/v1/models/abc")
    assert e.value.headers["Allow"] == "DELETE,GET"
    with pytest.raises(http.HTTPNotFound):
        r.resolve("GET", "/v1/models/")
    h2 = http.Headers({"Content-Type": "a"})
    h2["content-type"] = "b"
    assert h2.items() == [("Content-Type", "b")] and "CONTENT-TYPE" in h2


def _raw(port, data: bytes, until=b"\r\n\r\n", timeout=30) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(data)
        buf = b""
        while until not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
        return buf


def test_websocket_handshake_and_chunked_bodies():
    """RFC 6455's own example key; a chunked request body; a masked text
    frame echoed; a bad handshake is a 400."""
    app = http.Application()

    async def echo(request):
        return http.json_response(await request.json())

    async def ws_echo(request):
        ws = http.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            await ws.send_str(msg.data.upper())
        return ws
    app.router.add_post("/echo", echo)
    app.router.add_get("/ws", ws_echo)
    srv = http.ServerThread(app).start()
    try:
        r = _raw(srv.port, b"POST /echo HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked"
                           b"\r\n\r\n4\r\n{\"a\"\r\n3\r\n: 1\r\n1\r\n}\r\n0\r\n\r\n",
                 until=b"}")
        assert r.startswith(b"HTTP/1.1 200 OK") and r.endswith(b'{"a": 1}')
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
            s.sendall(b"\r\nPOST /echo HTTP/1.1\r\nHost: x\r\nExpect: 100-continue\r\n"
                      b"Content-Length: 8\r\n\r\n")
            assert s.recv(64) == b"HTTP/1.1 100 Continue\r\n\r\n"
            s.sendall(b'{"b": 2}')
            r = b""
            while not r.endswith(b"}"):
                r += s.recv(4096)
            assert r.startswith(b"HTTP/1.1 200 OK") and r.endswith(b'{"b": 2}')
        key = b"dGhlIHNhbXBsZSBub25jZQ=="
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as s:
            s.sendall(b"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: "
                      b"Upgrade\r\nSec-WebSocket-Key: " + key +
                      b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
            head = b""
            while b"\r\n\r\n" not in head:
                head += s.recv(1)
            assert head.startswith(b"HTTP/1.1 101 ")
            assert b"Sec-WebSocket-Accept: s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" in head
            payload, mask = b"hello", b"\x01\x02\x03\x04"
            s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask
                      + bytes(c ^ mask[i % 4] for i, c in enumerate(payload)))
            frame = s.recv(64)
            assert frame == bytes([0x81, 5]) + b"HELLO"
            s.sendall(bytes([0x88, 0x82]) + mask + bytes(
                c ^ mask[i % 4] for i, c in enumerate(b"\x03\xe8")))
            assert s.recv(64)[:2] == bytes([0x88, 2])
        bad = _raw(srv.port, b"GET /ws HTTP/1.1\r\nHost: x\r\n\r\n")
        assert bad.startswith(b"HTTP/1.1 400 ")
    finally:
        srv.stop()


def test_shutdown_drains_in_flight_handlers_before_the_hooks():
    app = http.Application()
    order = []
    release = threading.Event()

    async def slow(request):
        order.append("handler start")
        while not release.is_set():
            await asyncio.sleep(0.01)
        order.append("handler end")
        return http.json_response({"ok": True})

    async def hook(app):
        order.append("hook")
    app.router.add_get("/slow", slow)
    app.on_shutdown.append(hook)
    srv = http.ServerThread(app).start()
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "r", _raw(srv.port, b"GET /slow HTTP/1.1\r\nHost: x\r\n\r\n", until=b"}")))
    t.start()
    while not order:
        time.sleep(0.01)
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    time.sleep(0.2)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", srv.port), timeout=2).close()
    release.set()
    stopper.join(30)
    t.join(30)
    assert order == ["handler start", "handler end", "hook"]
    assert out["r"].startswith(b"HTTP/1.1 200 OK") and out["r"].endswith(b'{"ok": true}')


# --------------------------------------------------------------------------
# cli serve and the shim, as processes
# --------------------------------------------------------------------------
def _shard_refusal(path, monkeypatch, shard):
    """``cli serve --shard`` and the JAX ``serve(shard=)`` on a malformed
    value: the same ConfigError, raised before any rank starts
    (``bitnet_tpu/serve/server.py:1321-1334``)."""
    from bitnet_tpu.errors import ConfigError as JConfigError
    from bitnet_tpu.serve.server import serve as jax_serve

    monkeypatch.delenv("BITNET_COORDINATOR", raising=False)
    with pytest.raises(JConfigError) as want:
        jax_serve(path, shard=shard)
    with pytest.raises(perr.ConfigError) as got:
        cli.main(["serve", "-m", path, "--shard", shard, "--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shard", ["2", "0,1", "1,-2"])
def test_cli_serve_shard_parse_errors_are_the_jax_servers(mini_gguf_qk256, monkeypatch,
                                                          shard):
    _shard_refusal(mini_gguf_qk256.path, monkeypatch, shard)


def test_cli_serve_refuses_shard_and_needs_cuda(mini_gguf_qk256, monkeypatch):
    """A malformed ``--shard`` raises the JAX server's ConfigError
    (``--shard`` itself is ported: it raised naming #13); without a card
    and without ``--device cpu`` serve raises."""
    _shard_refusal(mini_gguf_qk256.path, monkeypatch, "2,x")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(perr.ConfigError, match="CUDA is not available"):
        cli.main(["serve", "-m", mini_gguf_qk256.path])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("entry", [["-m", "bitnet_tpu_torch.cli", "serve"],
                                   ["-m", "bitnet_tpu_torch.server"]])
def test_serve_as_a_process_answers(mini_gguf_qk256, entry, models):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.Popen([sys.executable, *entry, "-m", mini_gguf_qk256.path,
                          "--port", str(port), "--device", "cpu", "--max-seq-len", "64",
                          "--kv-cache-dtype", "f32"],
                         cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as r:
                    assert r.status == 200
                    break
            except OSError:
                if time.time() > deadline or p.poll() is not None:
                    raise AssertionError(p.stdout.read() if p.poll() is not None else
                                         "no answer")
                time.sleep(0.2)
        req = urllib.request.Request(url + "/v1/inference", data=json.dumps(
            {"tokens": PROMPT, "max_new_tokens": 5, "greedy": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        p.terminate()
        out, _ = p.communicate(timeout=60)
    assert p.returncode == 0, out
    assert "Running on http://127.0.0.1:" in out
    # the process's compute dtype is bf16 (EngineConfig's default): its
    # tokens are checked against a bf16 scheduler here
    cfg, params, _ = load_model(mini_gguf_qk256.path, device="cpu")
    tok = models[1][2]
    s = ContinuousBatchingScheduler(cfg, params, tok, EngineConfig(
        max_seq_len=64, kv_cache_dtype="f32"), num_slots=4, device="cpu",
        start_loop=False)
    want = [[]]
    _drain(s, [s.submit(PROMPT, GenerationConfig(max_new_tokens=5, greedy=True))], want)
    assert body["tokens"] == want[0]
