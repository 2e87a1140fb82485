"""HTTP inference server.

Counterpart of ``bitnet_tpu/serve/server.py`` on the port's scheduler and
on ``serve/http.py``, a standard-library HTTP/1.1 layer with aiohttp.web's
names (the card's machine has no aiohttp): the same 24 routes, bodies,
status codes, SSE frames and WebSocket messages.  Where it differs:

- a handler waits for its request's tokens on the event loop (the
  request's ``TokenQueue`` wakes it), not in an executor thread a stream;
- a request that the scheduler's failed loop ended is a 500 (the JAX
  ``_collect`` read it as a finished ``max_tokens`` answer);
- the security headers reach every response, streams included (aiohttp's
  middleware ran after a stream's head was sent);
- ``/health`` and ``/v1/devices`` refresh the snapshot in an executor (the
  card's memory is read on the device loop's thread);
- ``serve(shard="DP,TP")`` runs one process a rank (``parallel/``): with
  ``$BITNET_COORDINATOR`` each process is one rank of the launch contract
  (``parallel/multihost.py``), rank 0 the frontend and the others in
  ``follow()``; without it, on one host, ``serve`` starts the dp·tp − 1
  followers itself (a ``FileStore`` rendezvous, ``LOCAL_RANK`` each), where
  the JAX package's one controller drove every chip.

The JAX module's own summary follows.

Route parity with ``bitnet-server`` (``src/lib.rs:265-309``):
- ``POST /v1/inference``          — single-shot generation
- ``POST /v1/inference/stream``   — SSE token stream
- ``POST /v1/chat/completions``   — OpenAI-compatible chat endpoint
  (gpu-hal's openai-compat server equivalent)
- ``GET  /v1/models``             — loaded model info
- ``GET  /v1/stats``              — scheduler statistics
- ``GET  /health`` / ``/healthz`` — liveness/readiness
- ``GET  /metrics``               — Prometheus text format

Middleware: security headers + request-size limits + request-schema
validation + bearer-token auth + per-IP rate limiting with auto-blocking
(``bitnet-server/src/lib.rs:293-309`` middleware stack + ``src/security.rs``);
the continuous-batching scheduler replaces the reference's ``BatchEngine``;
graceful shutdown drains the scheduler; client disconnects cancel the
in-flight request (``streaming.rs:499``).
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import time

from ..config import EngineConfig, GenerationConfig
from ..engine.stop import StopReason
from ..errors import ConfigError, InferenceError
from . import http as web
from .scheduler import ContinuousBatchingScheduler

MAX_BODY_BYTES = 1 << 20
START_TIME = time.time()

SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "Referrer-Policy": "no-referrer",
    "Cache-Control": "no-store",
}

# consecutive rate-limit rejections before an IP is auto-blocked
AUTO_BLOCK_STRIKES = 50


def _validate_body(body: dict) -> str | None:
    """Request-schema validation (security validator parity).

    Returns an error string (→ 422) or None.
    """
    if not isinstance(body, dict):
        return "body must be a JSON object"
    if "messages" in body:
        msgs = body["messages"]
        if (not isinstance(msgs, list) or not msgs
                or not all(isinstance(m, dict) and "role" in m
                           and ("content" in m or "tool_calls" in m)
                           for m in msgs)):
            return ("messages must be a non-empty list of {role, content} "
                    "(assistant turns may carry tool_calls instead)")
    elif "tokens" in body:
        toks = body["tokens"]
        if (not isinstance(toks, list) or not toks
                or not all(isinstance(t, int) and t >= 0 for t in toks)):
            return "tokens must be a non-empty list of non-negative ints"
    else:
        p = body.get("prompt", "")
        if not isinstance(p, str) and not (
                isinstance(p, list) and p
                and all(isinstance(x, str) for x in p)):
            return "prompt must be a string or an array of strings"
    mnt = body.get("max_new_tokens", body.get("max_tokens", 128))
    if not isinstance(mnt, int) or not (1 <= mnt <= 65536):
        return "max_new_tokens must be an int in [1, 65536]"
    for key, lo, hi in (("temperature", 0.0, 100.0), ("top_p", 0.0, 1.0),
                        ("min_p", 0.0, 1.0)):
        v = body.get(key)
        if v is not None and (not isinstance(v, (int, float))
                              or not (lo <= float(v) <= hi)):
            return f"{key} must be a number in [{lo}, {hi}]"
    tk = body.get("top_k")
    if tk is not None and (not isinstance(tk, int) or tk < 0):
        return "top_k must be a non-negative int"
    rp = body.get("repetition_penalty")
    if rp is not None and (not isinstance(rp, (int, float))
                           or float(rp) <= 0):
        return "repetition_penalty must be > 0"
    for key in ("frequency_penalty", "presence_penalty"):
        v = body.get(key)
        if v is not None and (not isinstance(v, (int, float))
                              or not (-2.0 <= float(v) <= 2.0)):
            return f"{key} must be a number in [-2, 2]"
    lb = body.get("logit_bias")
    if lb is not None:
        if not isinstance(lb, dict):
            return "logit_bias must be an object of token_id -> bias"
        for k, v in lb.items():
            try:
                tok = int(k)
            except (TypeError, ValueError):
                return "logit_bias keys must be integer token ids"
            if tok < 0 or not isinstance(v, (int, float)):
                return "logit_bias keys must be token ids >= 0 with " \
                       "numeric values"
    mint = body.get("min_new_tokens", body.get("min_tokens"))
    if mint is not None and (isinstance(mint, bool)
                             or not isinstance(mint, int)
                             or not (0 <= mint <= 65536)):
        return "min_new_tokens must be an int in [0, 65536]"
    if isinstance(mint, int) and isinstance(mnt, int) and mint > mnt:
        return "min_new_tokens must be <= max_new_tokens"
    sp = body.get("stop")
    if sp is not None and not (
            isinstance(sp, str)
            or (isinstance(sp, list)
                and all(isinstance(x, str) for x in sp))):
        return "stop must be a string or an array of strings"
    sd = body.get("seed")
    if sd is not None and (isinstance(sd, bool) or not isinstance(sd, int)):
        return "seed must be an integer"
    lp = body.get("logprobs")
    if lp is not None and not isinstance(lp, (bool, int)):
        return "logprobs must be a boolean or an integer"
    if isinstance(lp, int) and not isinstance(lp, bool) \
            and not (0 <= lp <= 32):
        return "logprobs must be in [0, 32]"
    tlp = body.get("top_logprobs")
    if tlp is not None and (not isinstance(tlp, int)
                            or isinstance(tlp, bool)
                            or not (0 <= tlp <= 32)):
        return "top_logprobs must be an integer in [0, 32]"
    nch = body.get("n")
    if nch is not None and (not isinstance(nch, int)
                            or isinstance(nch, bool)
                            or not (1 <= nch <= 8)):
        return "n must be an integer in [1, 8]"
    g = body.get("grammar")
    if g is not None and not isinstance(g, str):
        return "grammar must be a GBNF source string"
    js = body.get("json_schema")
    if js is not None and not isinstance(js, (dict, str)):
        return "json_schema must be an object or a JSON string"
    rf = body.get("response_format")
    if rf is not None:
        if not isinstance(rf, dict) or rf.get("type") not in (
                "text", "json_object", "json_schema"):
            return ("response_format.type must be one of "
                    "text | json_object | json_schema")
        if rf.get("type") == "json_schema":
            spec = rf.get("json_schema")
            if not isinstance(spec, dict) \
                    or not isinstance(spec.get("schema", {}), dict):
                return "response_format.json_schema.schema must be an object"
    if g is not None or js is not None or rf is not None:
        from ..grammar import Grammar, GrammarError

        try:
            src = _resolve_grammar(body)
            if src is not None:
                Grammar.from_gbnf(src)
        except GrammarError as e:
            return f"invalid grammar: {e}"
    if body.get("tools") is not None:
        from ..toolcall import ToolCallError, validate_tools

        try:
            validate_tools(body["tools"], body.get("tool_choice"))
        except ToolCallError as e:
            return str(e)
    elif body.get("tool_choice") not in (None, "auto", "none"):
        return "tool_choice requires tools"
    return None


def _resolve_grammar(body: dict) -> str | None:
    """Constrained-output source, by precedence: explicit GBNF
    ``grammar`` > ``json_schema`` > OpenAI ``response_format``."""
    from ..grammar import JSON_GRAMMAR, json_schema_grammar

    if body.get("grammar"):
        return body["grammar"]
    if body.get("json_schema") is not None:
        return json_schema_grammar(body["json_schema"])
    rf = body.get("response_format") or {}
    t = rf.get("type")
    if t == "json_object":
        return JSON_GRAMMAR
    if t == "json_schema":
        spec = rf.get("json_schema") or {}
        return json_schema_grammar(spec.get("schema") or {})
    return None


def _num(body: dict, key: str, default):
    """Field with an explicit JSON null treated as 'use the default'
    (a null would otherwise 500 inside float()/int())."""
    v = body.get(key)
    return default if v is None else v


def _gen_config_from_body(body: dict) -> GenerationConfig:
    mnt = body.get("max_new_tokens")
    if mnt is None:
        mnt = _num(body, "max_tokens", 128)
    return GenerationConfig(
        max_new_tokens=int(mnt),
        min_new_tokens=int(_num(body, "min_new_tokens",
                                _num(body, "min_tokens", 0))),
        temperature=float(_num(body, "temperature", 1.0)),
        top_k=int(_num(body, "top_k", 0)),
        top_p=float(_num(body, "top_p", 1.0)),
        min_p=float(_num(body, "min_p", 0.0)),
        repetition_penalty=float(_num(body, "repetition_penalty", 1.0)),
        frequency_penalty=float(_num(body, "frequency_penalty", 0.0)),
        presence_penalty=float(_num(body, "presence_penalty", 0.0)),
        logit_bias=tuple(sorted(
            (int(k), float(v))
            for k, v in (body.get("logit_bias") or {}).items())),
        seed=body.get("seed"),
        greedy=bool(body.get("greedy", False)),
        stop_sequences=_stop_tuple(body.get("stop")),
        grammar=_resolve_grammar(body),
        logprobs=_resolve_logprobs(body),
    )


def _stop_tuple(stop) -> tuple:
    """OpenAI allows a bare string — one sequence, NOT per-character
    (tuple('###') would explode into ('#','#','#'))."""
    if stop is None:
        return ()
    if isinstance(stop, str):
        return (stop,)
    return tuple(stop)


def _resolve_logprobs(body: dict) -> int | None:
    """OpenAI conventions: completions pass ``logprobs: <int>``; chat
    passes ``logprobs: true`` + ``top_logprobs: <int>``."""
    lp = body.get("logprobs")
    if lp is None or lp is False:
        return None
    if lp is True:
        return int(body.get("top_logprobs", 0) or 0)
    return int(lp)


def _openai_logprobs(entries: list[dict]) -> dict:
    """OpenAI *completions*-style logprobs block from scheduler entries."""
    text_offset, off = [], 0
    for e in entries:
        text_offset.append(off)
        off += len(e["text"])
    return {
        "tokens": [e["text"] for e in entries],
        "token_ids": [e["token_id"] for e in entries],
        "token_logprobs": [e["logprob"] for e in entries],
        "top_logprobs": [{t["token"]: t["logprob"] for t in e["top"]}
                         for e in entries],
        "text_offset": text_offset,
    }


def _chat_logprobs(entries: list[dict]) -> dict:
    """OpenAI *chat*-style logprobs block from scheduler entries."""
    return {"content": [{
        "token": e["text"],
        "logprob": e["logprob"],
        "top_logprobs": [{"token": t["token"], "logprob": t["logprob"]}
                         for t in e["top"]],
    } for e in entries]}


def _submit_kwargs(body: dict) -> dict:
    out: dict = {}
    if isinstance(body.get("timeout_s"), (int, float)):
        out["timeout_s"] = float(body["timeout_s"])
    if isinstance(body.get("priority"), int):
        out["priority"] = body["priority"]
    return out


class BitNetServer:
    def __init__(self, scheduler: ContinuousBatchingScheduler | None = None,
                 model_name: str = "bitnet-tpu",
                 manager=None, rate_limiter=None,
                 auth_token: str | None = None,
                 allowed_model_dirs: list[str] | None = None, device="cuda",
                 multihost: bool = False):
        """``auth_token``: when set (or via $BITNET_AUTH_TOKEN), every API
        route except health/metrics requires ``Authorization: Bearer
        <token>`` (reference JWT-auth parity, src/test_validate_jwt.rs).
        ``allowed_model_dirs``: directory whitelist for /v1/models/load —
        admin routes otherwise accept arbitrary server paths.
        ``device``: the card unless the caller passes ``"cpu"`` (a manager
        given by the caller keeps its own)."""
        from .model_manager import ModelManager

        self.manager = manager or ModelManager(device=device)
        if scheduler is not None:
            self.manager.adopt(model_name, scheduler)
        self.model_name = model_name
        self.multihost = multihost
        self.rate_limiter = rate_limiter  # None = unlimited
        self.auth_token = auth_token or os.environ.get("BITNET_AUTH_TOKEN")
        self.allowed_model_dirs = (
            [os.path.realpath(d) for d in allowed_model_dirs]
            if allowed_model_dirs else None)
        self._strikes: dict[str, int] = {}
        from .health import HealthMonitor

        self.health = HealthMonitor(self.manager)
        # OTLP/HTTP metrics push (monitoring/otlp.rs parity) — inert
        # unless OTEL_EXPORTER_OTLP_ENDPOINT is configured
        from ..obs.otlp import OTLPExporter
        from .recovery import FailoverRouter, GracefulDegradation

        self.otlp = OTLPExporter(self._collect_metrics)
        self.otlp.start()
        self.router = FailoverRouter(self.manager)
        self.degradation = GracefulDegradation()

    def _collect_metrics(self) -> dict[str, float]:
        agg: dict[str, float] = {}
        try:
            for info in self.manager.list():
                st = self.manager.get(info["name"]).stats
                for k, v in st.items():
                    agg[k] = agg.get(k, 0.0) + float(v)
        except Exception:
            pass
        agg["uptime_seconds"] = time.time() - START_TIME
        # cumulative counters get OTLP sum semantics via the _total suffix
        for k in ("requests", "completed", "tokens_generated",
                  "decode_steps", "cancelled", "timeouts"):
            if k in agg:
                agg[f"{k}_total"] = agg.pop(k)
        return agg

    @property
    def scheduler(self):
        """Default model's scheduler (back-compat accessor)."""
        return self.manager.get()

    def _sched_for(self, body: dict):
        """Health-gated routing with model failover
        (execution_router.rs parity; see serve/recovery.py)."""
        sched, _name = self.router.route(body.get("model"))
        return sched

    def _gen_for(self, body: dict, sched) -> GenerationConfig:
        """GenerationConfig with graceful degradation: queue pressure caps
        max_new_tokens (error_recovery.rs GracefulDegradation)."""
        from ..errors import ConfigError

        try:
            gen = _gen_config_from_body(body)
        except (ConfigError, TypeError, ValueError) as e:
            # belt and braces behind _validate_body: config rejections
            # surface as 422, never a 500 (or worse, a thread death)
            raise web.HTTPUnprocessableEntity(
                text=json.dumps({"error": str(e)}),
                content_type="application/json") from None
        level = self.degradation.level(sched.stats.get("queue_depth", 0),
                                       sched.B)
        cap = self.degradation.cap_tokens(level, gen.max_new_tokens)
        if cap != gen.max_new_tokens:
            import dataclasses as _dc

            gen = _dc.replace(gen, max_new_tokens=cap)
        return gen

    def _check_auth(self, request):
        """Bearer-token gate. Returns a 401 response or None."""
        if self.auth_token is None:
            return None
        hdr = request.headers.get("Authorization", "")
        if hdr == f"Bearer {self.auth_token}":
            return None
        return web.json_response({"error": "unauthorized"}, status=401,
                                 headers={"WWW-Authenticate": "Bearer"})

    def _check_rate(self, request):
        """Token-bucket + blocklist check (security.rs parity).
        Returns a 429/403 response when rejected, else None.  IPs that
        keep hammering past the limit are auto-blocked."""
        if self.rate_limiter is None:
            return None
        ip = request.remote or "?"
        if getattr(self.rate_limiter, "is_blocked", None) and \
                self.rate_limiter.is_blocked(ip):
            return web.json_response({"error": "blocked"}, status=403)
        if not self.rate_limiter.allow(ip):
            strikes = self._strikes.get(ip, 0) + 1
            self._strikes[ip] = strikes
            if strikes >= AUTO_BLOCK_STRIKES:
                self.rate_limiter.block(ip)
                return web.json_response({"error": "blocked"}, status=403)
            return web.json_response(
                {"error": "rate limit exceeded"}, status=429)
        self._strikes.pop(ip, None)
        return None

    def _gate(self, request):
        """auth + rate limit, in that order; None when admitted."""
        return self._check_auth(request) or self._check_rate(request)

    # ------------------------------------------------------------ helpers
    def _encode(self, body: dict, scheduler=None) -> list[int]:
        sched = scheduler or self.scheduler
        tk = sched.tokenizer
        if "tokens" in body:
            return [int(t) for t in body["tokens"]]
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            # prompt arrays are a /v1/completions feature — that route
            # splits them per prompt before encoding; anywhere else the
            # only sane reading is the first element
            prompt = prompt[0] if prompt else ""
        add_bos = True
        if "messages" in body:
            from .. import templates

            tools = body.get("tools")
            if tools and body.get("tool_choice") != "none":
                from ..toolcall import normalize_tool_messages, validate_tools

                msgs = normalize_tool_messages(
                    body["messages"], validate_tools(tools))
            else:
                msgs = [templates.Message(m["role"], m.get("content") or "")
                        for m in body["messages"]]
            # the model's own embedded jinja chat template wins when the
            # GGUF ships one (executed sandboxed — HF semantics); the
            # DETECTED family template is the fallback, never hardcoded
            # ChatML (VERDICT weak #9).  The family's BOS policy applies
            # either way (llama3 embeds its own BOS — double-BOS skews
            # the first logits).
            ttype = self.manager.template_for(sched)
            entry = self.manager.entry_for(sched)
            prompt = None
            if entry is not None and entry.chat_template_jinja:
                try:
                    prompt = templates.render_jinja(
                        entry.chat_template_jinja, msgs,
                        **entry.special_tokens)
                except templates.ChatTemplateError:
                    prompt = None
            if prompt is None:
                prompt = templates.render_chat(ttype, msgs)
            add_bos = templates.spec_for(ttype).add_bos
            bos_str = (entry.special_tokens.get("bos_token")
                       if entry is not None else None)
            if bos_str and prompt.startswith(bos_str):
                add_bos = False       # jinja already emitted BOS
        return tk.encode(prompt, add_bos=add_bos)

    async def _next(self, req, timeout: float = 600.0):
        """The request's next result, awaited on the event loop: the
        request's queue wakes it (``TokenQueue.notify``)."""
        ev = getattr(req, "_aio_event", None)
        if ev is None:
            loop = asyncio.get_running_loop()
            ev = req._aio_event = asyncio.Event()
            req.out.notify(lambda: loop.call_soon_threadsafe(ev.set))
        deadline = time.monotonic() + timeout
        while True:
            # ev.set runs on this loop, so no put's wake-up falls between
            # the clear and the look
            ev.clear()
            try:
                item = req.out.get_nowait()
            except queue.Empty:
                item = None
            if item is not None:
                if item[2] and item[3] is None:
                    # the loop failed (it ends every request without a
                    # reason): an error, never a finished answer
                    raise InferenceError("the scheduler's loop failed; the request "
                                         "did not finish")
                return item
            left = deadline - time.monotonic()
            if left <= 0:
                raise queue.Empty
            try:
                await asyncio.wait_for(ev.wait(), left)
            except asyncio.TimeoutError:
                pass

    async def _collect(self, req) -> tuple[str, list[int], StopReason]:
        """Run one request to completion; a dropped client cancels the
        in-flight generation (streaming.rs:499)."""
        toks, texts, reason = [], [], StopReason.MAX_TOKENS
        try:
            while True:
                tok, text, done, r = await self._next(req)
                if tok is not None:
                    toks.append(tok)
                    texts.append(text)
                if done:
                    return "".join(texts), toks, r or reason
        except asyncio.CancelledError:
            req.cancel()
            raise

    def _admit_body(self, request, body):
        """Shared gate: JSON error passthrough → auth/rate → schema."""
        if isinstance(body, web.Response):
            return body
        gated = self._gate(request)
        if gated is not None:
            return gated
        err = _validate_body(body)
        if err is not None:
            return web.json_response({"error": err}, status=422)
        return None

    # ------------------------------------------------------------- routes
    async def handle_inference(self, request):
        body = await self._json(request)
        rej = self._admit_body(request, body)
        if rej is not None:
            return rej
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        ids = self._encode(body, sched)
        t0 = time.time()
        req = sched.submit(ids, self._gen_for(body, sched),
                           **_submit_kwargs(body))
        text, toks, reason = await self._collect(req)
        out = {
            "text": text,
            "tokens": toks,
            "num_tokens": len(toks),
            "stop_reason": reason.value if reason else None,
            "prompt_tokens": len(ids),
            "latency_s": round(time.time() - t0, 4),
            "model": self.model_name,
        }
        if req.logprobs is not None:
            out["logprobs"] = _openai_logprobs(req.logprobs)
        return web.json_response(out)

    async def handle_stream(self, request):
        body = await self._json(request)
        rej = self._admit_body(request, body)
        if rej is not None:
            return rej
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        ids = self._encode(body, sched)
        req = sched.submit(ids, self._gen_for(body, sched),
                           **_submit_kwargs(body))

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        idx = 0
        try:
            while True:
                tok, text, done, reason = await self._next(req)
                if tok is not None:
                    event = {"token": tok, "text": text, "index": idx}
                    if req.logprobs is not None and idx < len(req.logprobs):
                        # real value, not the reference's hardcoded None
                        # (bitnet-server/src/sse.rs:102)
                        event["logprob"] = req.logprobs[idx]["logprob"]
                    payload = json.dumps(event)
                    await resp.write(f"data: {payload}\n\n".encode())
                    idx += 1
                if done:
                    fin = json.dumps({"done": True,
                                      "stop_reason":
                                      reason.value if reason else None})
                    await resp.write(f"data: {fin}\n\n".encode())
                    break
        except (asyncio.CancelledError, ConnectionResetError,
                ConnectionError):
            # client went away mid-stream → free the slot within one step
            req.cancel()
            raise
        await resp.write_eof()
        return resp

    async def _stream_openai(self, request, req, cid: str,
                             object_type: str, chat: bool,
                             echo_text: str | None = None):
        """SSE stream in OpenAI chunk format, terminated by [DONE]."""
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        created = int(time.time())

        def chunk(payload: dict, finish=None) -> bytes:
            body = dict(payload, finish_reason=finish, index=0)
            return ("data: " + json.dumps({
                "id": cid, "object": object_type, "created": created,
                "model": self.model_name, "choices": [body],
            }) + "\n\n").encode()

        try:
            if chat:
                await resp.write(chunk({"delta": {"role": "assistant"}}))
            elif echo_text:
                await resp.write(chunk({"text": echo_text,
                                        "logprobs": None}))
            idx = 0
            while True:
                tok, text, done, reason = await self._next(req)
                if tok is not None:
                    lp = None
                    if req.logprobs is not None and idx < len(req.logprobs):
                        e = req.logprobs[idx]
                        lp = ({"content": [{
                            "token": e["text"], "logprob": e["logprob"],
                            "top_logprobs": [
                                {"token": t["token"],
                                 "logprob": t["logprob"]}
                                for t in e["top"]]}]} if chat
                            else _openai_logprobs([e]))
                    body = ({"delta": {"content": text}, "logprobs": lp}
                            if chat else
                            {"text": text, "logprobs": lp})
                    await resp.write(chunk(body))
                    idx += 1
                if done:
                    finish = ("stop" if reason in (
                        StopReason.EOS, StopReason.STOP_TOKEN,
                        StopReason.STOP_SEQUENCE) else "length")
                    final = ({"delta": {}} if chat
                             else {"text": "", "logprobs": None})
                    await resp.write(chunk(final, finish))
                    await resp.write(b"data: [DONE]\n\n")
                    break
        except (asyncio.CancelledError, ConnectionResetError,
                ConnectionError):
            req.cancel()
            raise
        await resp.write_eof()
        return resp

    async def handle_completions(self, request):
        """OpenAI /v1/completions (text_completion wire format; the
        native schema stays on /v1/inference)."""
        body = await self._json(request)
        rej = self._admit_body(request, body)
        if rej is not None:
            return rej
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        prompts = body.get("prompt", "")
        many = isinstance(prompts, list) and prompts \
            and all(isinstance(p, str) for p in prompts)
        if not many:
            prompts = [prompts if isinstance(prompts, str) else ""]
        gen = self._gen_for(body, sched)
        if body.get("stream"):
            if many and len(prompts) > 1 or int(body.get("n") or 1) > 1:
                # honest rejection beats silently dropping prompts/choices
                return web.json_response(
                    {"error": "stream=true supports a single prompt "
                              "and n=1"}, status=422)
            ids = self._encode(dict(body, prompt=prompts[0]), sched)
            req = sched.submit(ids, gen, **_submit_kwargs(body))
            return await self._stream_openai(
                request, req, f"cmpl-{req.id}", "text_completion",
                chat=False, echo_text=(prompts[0] if body.get("echo")
                                       else None))
        n = int(body.get("n") or 1)
        reqs, lens = [], []
        for p in prompts:
            ids = self._encode(dict(body, prompt=p), sched)
            lens.append(len(ids))       # each prompt billed ONCE, not ×n
            for i in range(n):
                g = (gen if n == 1
                     else gen.replace(seed=(gen.seed + i
                                            if gen.seed is not None
                                            else None)))
                reqs.append(sched.submit(ids, g, **_submit_kwargs(body)))
        results = await asyncio.gather(*[self._collect(r) for r in reqs])
        choices, total_out = [], 0
        for i, (req, (text, toks, reason)) in enumerate(zip(reqs, results)):
            total_out += len(toks)
            if body.get("echo"):
                text = prompts[i // n] + text
            choices.append({
                "text": text,
                "index": i,
                "logprobs": (_openai_logprobs(req.logprobs)
                             if req.logprobs is not None else None),
                "finish_reason": ("stop" if reason in (
                    StopReason.EOS, StopReason.STOP_TOKEN,
                    StopReason.STOP_SEQUENCE) else "length"),
            })
        return web.json_response({
            "id": f"cmpl-{reqs[0].id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": sum(lens),
                "completion_tokens": total_out,
                "total_tokens": sum(lens) + total_out,
            },
        })

    async def handle_chat_completions(self, request):
        """OpenAI-compatible endpoint."""
        body = await self._json(request)
        rej = self._admit_body(request, body)
        if rej is not None:
            return rej
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        # OpenAI tools protocol: constrain forced calls with a grammar
        # compiled from the tool's JSON-schema parameters (toolcall.py)
        fns = None
        if body.get("tools") and body.get("tool_choice") != "none":
            from ..toolcall import (
                parse_tool_calls,
                tool_choice_grammar,
                validate_tools,
            )

            fns = validate_tools(body["tools"], body.get("tool_choice"))
            tg = tool_choice_grammar(fns, body.get("tool_choice"))
            if tg is not None and not body.get("grammar"):
                body = dict(body, grammar=tg)
        ids = self._encode(body, sched)
        if body.get("stream"):
            # OpenAI chat streaming: role chunk → content deltas → final
            # finish_reason chunk → data: [DONE]
            req = sched.submit(ids, self._gen_for(body, sched),
                               **_submit_kwargs(body))
            if fns is None:
                return await self._stream_openai(
                    request, req, f"chatcmpl-{req.id}",
                    "chat.completion.chunk", chat=True)
            # with tools the output must be parsed before the client
            # sees it: buffer, then emit role → tool_calls/content
            # delta → finish → [DONE] (OpenAI streaming tool protocol)
            text, _toks, reason = await self._collect(req)
            calls = parse_tool_calls(text, fns)
            cid = f"chatcmpl-{req.id}"
            created = int(time.time())

            def chunk(delta, finish=None):
                return ("data: " + json.dumps({
                    "id": cid, "object": "chat.completion.chunk",
                    "created": created, "model": self.model_name,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}],
                }) + "\n\n").encode()

            resp = web.StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache"})
            await resp.prepare(request)
            await resp.write(chunk({"role": "assistant"}))
            if calls is not None:
                deltas = [dict(c, index=i) for i, c in enumerate(calls)]
                await resp.write(chunk({"tool_calls": deltas}))
                await resp.write(chunk({}, "tool_calls"))
            else:
                await resp.write(chunk({"content": text}))
                await resp.write(chunk({}, "stop" if reason in (
                    StopReason.EOS, StopReason.STOP_TOKEN,
                    StopReason.STOP_SEQUENCE) else "length"))
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            return resp
        n = int(body.get("n") or 1)
        gen = self._gen_for(body, sched)
        reqs = []
        for i in range(n):
            # distinct choices: derive per-choice seeds from the request
            # seed (or leave None → scheduler picks fresh entropy)
            g = (gen if n == 1
                 else gen.replace(seed=(gen.seed + i
                                        if gen.seed is not None else None)))
            reqs.append(sched.submit(ids, g, **_submit_kwargs(body)))
        results = await asyncio.gather(*[self._collect(r) for r in reqs])
        choices = []
        total_out = 0
        for i, (req, (text, toks, reason)) in enumerate(zip(reqs, results)):
            total_out += len(toks)
            message: dict = {"role": "assistant", "content": text}
            finish = ("stop" if reason in (
                StopReason.EOS, StopReason.STOP_TOKEN,
                StopReason.STOP_SEQUENCE) else "length")
            if fns is not None:
                calls = parse_tool_calls(text, fns)
                if calls is not None:
                    message = {"role": "assistant", "content": None,
                               "tool_calls": calls}
                    finish = "tool_calls"
            choices.append({
                "index": i,
                "message": message,
                "logprobs": (_chat_logprobs(req.logprobs)
                             if req.logprobs is not None else None),
                "finish_reason": finish,
            })
        return web.json_response({
            "id": f"chatcmpl-{reqs[0].id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": len(ids),
                "completion_tokens": total_out,
                "total_tokens": len(ids) + total_out,
            },
        })

    async def handle_embeddings(self, request):
        """OpenAI /v1/embeddings: final-hidden-state mean pooling
        (llama.cpp ``embedding=True`` semantics)."""
        body = await self._json(request)
        rej = self._admit_body(request, body)
        if rej is not None:
            return rej
        raw = body.get("input")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and raw \
                and all(isinstance(x, int) for x in raw):
            inputs = [raw]                    # one token array
        elif isinstance(raw, list) and raw \
                and all(isinstance(x, (str, list)) for x in raw):
            inputs = raw
        else:
            return web.json_response(
                {"error": "input must be a string, an array of strings, "
                          "or token arrays"}, status=422)
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        loop = asyncio.get_event_loop()

        def run():
            data, total = [], 0
            for i, item in enumerate(inputs):
                ids = (sched.tokenizer.encode(item, add_bos=True)
                       if isinstance(item, str) else [int(t) for t in item])
                total += len(ids)
                h = sched.embed_ids(ids)              # [T, H]
                data.append({"object": "embedding", "index": i,
                             "embedding": h.mean(axis=0).tolist()})
            return data, total

        try:
            data, total = await loop.run_in_executor(None, run)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=422)
        return web.json_response({
            "object": "list",
            "data": data,
            "model": body.get("model") or self.model_name,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    async def handle_tokenize(self, request):
        """POST /tokenize {content, add_special?} — llama.cpp server
        compat endpoint."""
        gated = self._gate(request)
        if gated is not None:
            return gated
        body = await self._json(request)
        if isinstance(body, web.Response):
            return body
        content = body.get("content", body.get("prompt", ""))
        if not isinstance(content, str):
            return web.json_response({"error": "content must be a string"},
                                     status=422)
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        ids = sched.tokenizer.encode(
            content, add_bos=bool(body.get("add_special", True)))
        return web.json_response({"tokens": list(ids)})

    async def handle_detokenize(self, request):
        """POST /detokenize {tokens} — llama.cpp server compat."""
        gated = self._gate(request)
        if gated is not None:
            return gated
        body = await self._json(request)
        if isinstance(body, web.Response):
            return body
        toks = body.get("tokens")
        if not isinstance(toks, list) \
                or not all(isinstance(t, int) and t >= 0 for t in toks):
            return web.json_response(
                {"error": "tokens must be a list of non-negative ints"},
                status=422)
        try:
            sched = self._sched_for(body)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        return web.json_response(
            {"content": sched.tokenizer.decode([int(t) for t in toks])})

    async def handle_props(self, request):
        """GET /props — llama.cpp server compat: model/runtime props."""
        gated = self._gate(request)
        if gated is not None:
            return gated
        sched = self.scheduler
        cfg = sched.cfg
        return web.json_response({
            "model_path": self.model_name,
            "n_ctx": sched.S,
            "total_slots": sched.B,
            "chat_template": "",
            "model": {
                "vocab_size": cfg.vocab_size,
                "n_embd": cfg.hidden_size,
                "n_layer": cfg.num_layers,
                "n_head": cfg.num_heads,
                "n_head_kv": cfg.num_kv_heads,
            },
        })

    async def handle_slots(self, request):
        """GET /slots — llama.cpp server compat: per-slot pool state."""
        gated = self._gate(request)
        if gated is not None:
            return gated
        sched = self.scheduler
        out = []
        for i, s in enumerate(sched.slots):
            req = s.req   # snapshot: the decode thread nulls it on finish
            entry = {"id": i, "state": (
                "prefilling" if s.prefilling
                else "processing" if s.active else "idle")}
            if req is not None:
                entry.update({
                    "request_id": req.id,
                    "n_ctx": sched.S,
                    "n_past": s.pos,
                    "n_decoded": s.generated,
                    "priority": req.priority,
                })
            out.append(entry)
        return web.json_response(out)

    async def handle_models(self, request):
        models = self.manager.list()
        return web.json_response({
            "models": models,
            "default": self.manager.default_name,
            # OpenAI list-models wire shape alongside the native one,
            # so openai-client model discovery works against this server
            "object": "list",
            "data": [{"id": m.get("name", "bitnet-tpu"),
                      "object": "model",
                      "created": int(START_TIME),
                      "owned_by": "bitnet-tpu"} for m in models],
        })

    async def handle_model_get(self, request):
        try:
            return web.json_response(
                self.manager.info(request.match_info["name"]))
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)

    def _dir_allowed(self, directory: str):
        """Admin path whitelist (same policy as /v1/models/load)."""
        if self.allowed_model_dirs is None:
            return None
        real = os.path.realpath(str(directory))
        if any(real.startswith(d + os.sep) or real == d
               for d in self.allowed_model_dirs):
            return None
        return web.json_response(
            {"error": "directory outside allowed model directories"},
            status=403)

    async def handle_checkpoint(self, request):
        """POST /v1/admin/checkpoint {directory, model?} — quiesce the
        decode loop at a step boundary and snapshot every in-flight
        request (preemption drills / planned restarts; reference
        checkpoint_manager.rs parity, SURVEY §5)."""
        body = await self._json(request)
        if isinstance(body, web.Response):
            return body
        gated = self._gate(request)
        if gated is not None:
            return gated
        directory = body.get("directory")
        if not directory:
            return web.json_response({"error": "need 'directory'"},
                                     status=400)
        rej = self._dir_allowed(directory)
        if rej is not None:
            return rej
        try:
            sched = self.manager.get(body.get("model"))
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        loop = asyncio.get_event_loop()

        def run():
            try:
                sched.pause()
                return sched.checkpoint_requests(str(directory))
            finally:
                # idempotent: also correct when pause() itself failed
                sched.unpause()

        try:
            written = await loop.run_in_executor(None, run)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        return web.json_response({"written": written,
                                  "count": len(written)})

    async def handle_resume(self, request):
        """POST /v1/admin/resume {directory, model?} — restore
        checkpointed requests and run them to completion; returns the
        finished texts (an admin drain, not client re-attachment)."""
        body = await self._json(request)
        if isinstance(body, web.Response):
            return body
        gated = self._gate(request)
        if gated is not None:
            return gated
        directory = body.get("directory")
        if not directory:
            return web.json_response({"error": "need 'directory'"},
                                     status=400)
        rej = self._dir_allowed(directory)
        if rej is not None:
            return rej
        try:
            sched = self.manager.get(body.get("model"))
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        loop = asyncio.get_event_loop()
        try:
            reqs = await loop.run_in_executor(
                None, lambda: sched.resume_requests(str(directory)))
        except Exception as e:
            return web.json_response({"error": str(e)}, status=500)
        results = await asyncio.gather(*[self._collect(r) for r in reqs])
        return web.json_response({"resumed": [
            {"request_id": r.id, "text": text, "num_tokens": len(toks),
             "stop_reason": reason.value if reason else None}
            for r, (text, toks, reason) in zip(reqs, results)]})

    async def handle_model_load(self, request):
        """POST /v1/models/load {name, path, default?} — load a model
        (reference model load route, lib.rs:265-282).  Admin route: auth +
        rate limit + model-directory whitelist (an unauthenticated client
        must not be able to mmap arbitrary server paths into HBM)."""
        body = await self._json(request)
        if isinstance(body, web.Response):
            return body
        gated = self._gate(request)
        if gated is not None:
            return gated
        if self.multihost:
            return web.json_response(
                {"error": "model hot-load is disabled in multi-host mode "
                          "(followers replay one model's control stream)"},
                status=409)
        name, path = body.get("name"), body.get("path")
        if not name or not path:
            return web.json_response(
                {"error": "need 'name' and 'path'"}, status=400)
        if self.allowed_model_dirs is not None:
            real = os.path.realpath(str(path))
            if not any(real.startswith(d + os.sep) or real == d
                       for d in self.allowed_model_dirs):
                return web.json_response(
                    {"error": "path outside allowed model directories"},
                    status=403)
        loop = asyncio.get_event_loop()
        try:
            info = await loop.run_in_executor(
                None, lambda: self.manager.load(
                    name, str(path), bool(body.get("default", False))))
        except Exception as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(info)

    async def handle_model_unload(self, request):
        gated = self._gate(request)
        if gated is not None:
            return gated
        if self.multihost:
            return web.json_response(
                {"error": "model unload is disabled in multi-host mode"},
                status=409)
        name = request.match_info["name"]
        try:
            self.manager.unload(name)
        except Exception as e:
            return web.json_response({"error": str(e)}, status=404)
        return web.json_response({"unloaded": name})

    async def handle_stats(self, request):
        agg: dict = {}
        for info in self.manager.list():
            st = self.manager.get(info["name"]).stats
            for k, v in st.items():
                agg[k] = agg.get(k, 0) + v
        return web.json_response({
            **agg,
            "models_loaded": len(self.manager.list()),
            "uptime_s": round(time.time() - START_TIME, 1),
        })

    async def handle_health(self, request):
        snap = await asyncio.get_running_loop().run_in_executor(
            None, self.health.refresh)
        status = 200 if snap["healthy"] else 503
        return web.json_response(
            {"status": "ok" if snap["healthy"] else "degraded"},
            status=status)

    async def handle_devices(self, request):
        """Device health + per-model scheduler status
        (reference /v1/devices route)."""
        return web.json_response(await asyncio.get_running_loop().run_in_executor(
            None, self.health.refresh))

    async def handle_canary(self, request):
        loop = asyncio.get_event_loop()
        result = await loop.run_in_executor(None, self.health.canary)
        return web.json_response(result,
                                 status=200 if result.get("ok") else 503)

    async def handle_ws(self, request):
        """WebSocket streaming (bitnet-server/src/websocket.rs parity):
        client sends an inference JSON body, receives one message per
        token plus a final done message."""
        gated = self._gate(request)
        if gated is not None:
            return gated
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        req = None
        try:
            async for msg in ws:
                if msg.type != web.WSMsgType.TEXT:
                    break
                try:
                    body = json.loads(msg.data)
                    err = _validate_body(body)
                    if err is not None:
                        await ws.send_json({"error": err})
                        continue
                    sched = self._sched_for(body)
                    ids = self._encode(body, sched)
                    req = sched.submit(ids, self._gen_for(body, sched),
                                       **_submit_kwargs(body))
                except Exception as e:
                    await ws.send_json({"error": str(e)})
                    continue
                idx = 0
                while True:
                    tok, text, done, reason = await self._next(req)
                    if tok is not None:
                        event = {"token": tok, "text": text, "index": idx}
                        if req.logprobs is not None \
                                and idx < len(req.logprobs):
                            # websocket.rs:26 Token.logprob, filled for real
                            event["logprob"] = req.logprobs[idx]["logprob"]
                        await ws.send_json(event)
                        idx += 1
                    if done:
                        await ws.send_json({
                            "done": True,
                            "stop_reason": reason.value if reason else None})
                        req = None
                        break
        except (asyncio.CancelledError, ConnectionResetError):
            if req is not None:
                req.cancel()
            raise
        return ws

    async def handle_metrics(self, request):
        """Prometheus text exposition (monitoring/prometheus.rs parity)."""
        s = self.scheduler.stats
        lines = []
        for k, v in s.items():
            lines.append(f"# TYPE bitnet_{k} gauge")
            lines.append(f"bitnet_{k} {v}")
        lines.append("# TYPE bitnet_uptime_seconds counter")
        lines.append(f"bitnet_uptime_seconds {time.time() - START_TIME:.1f}")
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    async def _json(self, request):
        if request.content_length and request.content_length > MAX_BODY_BYTES:
            return web.json_response({"error": "body too large"}, status=413)
        try:
            return await request.json()
        except Exception:
            return web.json_response({"error": "invalid JSON"}, status=400)

    # --------------------------------------------------------------- app
    def build_app(self):
        def security_headers(request, resp):
            for k, v in SECURITY_HEADERS.items():
                resp.headers.setdefault(k, v)

        app = web.Application(client_max_size=MAX_BODY_BYTES)
        app.on_response_prepare.append(security_headers)
        app.router.add_post("/v1/inference", self.handle_inference)
        app.router.add_post("/inference", self.handle_inference)  # legacy
        app.router.add_post("/v1/inference/stream", self.handle_stream)
        app.router.add_post("/v1/chat/completions",
                            self.handle_chat_completions)
        app.router.add_post("/v1/completions", self.handle_completions)
        app.router.add_post("/v1/embeddings", self.handle_embeddings)
        app.router.add_post("/tokenize", self.handle_tokenize)
        app.router.add_post("/detokenize", self.handle_detokenize)
        app.router.add_get("/props", self.handle_props)
        app.router.add_get("/slots", self.handle_slots)
        app.router.add_get("/v1/models", self.handle_models)
        app.router.add_post("/v1/models/load", self.handle_model_load)
        app.router.add_post("/v1/admin/checkpoint", self.handle_checkpoint)
        app.router.add_post("/v1/admin/resume", self.handle_resume)
        app.router.add_get("/v1/models/{name}", self.handle_model_get)
        app.router.add_delete("/v1/models/{name}",
                              self.handle_model_unload)
        app.router.add_get("/v1/stats", self.handle_stats)
        app.router.add_get("/health", self.handle_health)
        app.router.add_get("/healthz", self.handle_health)
        app.router.add_get("/metrics", self.handle_metrics)
        app.router.add_get("/v1/devices", self.handle_devices)
        app.router.add_get("/v1/canary", self.handle_canary)
        app.router.add_get("/v1/ws", self.handle_ws)
        return app


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8080,
          max_seq_len: int = 2048, kv_cache_dtype: str = "bf16",
          kernel_path: str = "auto", num_slots: int = 4,
          shard: str | None = None, auth_token: str | None = None,
          model_dirs: list[str] | None = None, paged: bool = False,
          num_pages: int | None = None, page_size: int = 16,
          chunked_prefill: int | None = None,
          speculative_k: int = 0,
          decode_steps_per_dispatch: int = 1,
          pipeline_depth: int = 1, device="cuda") -> None:
    """Load model + start the server (blocking; SIGINT / SIGTERM shut it
    down gracefully: stop accepting, drain, then stop the schedulers).
    ``bitnet_tpu/serve/server.py:1297-1394`` on ``device`` (the card unless
    the caller asks for ``"cpu"``).

    ``shard="DP,TP"`` serves over a (data, model) mesh, one process a rank.
    With ``$BITNET_COORDINATOR`` this process is the rank the launch
    contract names (``parallel/multihost.py``): rank 0 serves, the others
    replay its control stream (``serve/follower.worker_loop``) and return
    when it stops.  Without it, on one host, this process is rank 0 and
    starts the dp·tp − 1 others itself, each ``serve`` with the same
    arguments, a ``FileStore`` under a temporary directory and its
    ``LOCAL_RANK``; they end with the server.  The backend is the
    launch contract's (``$BITNET_DIST_BACKEND``; ranks that share a card
    need gloo)."""
    import torch

    from ..device_probe import resolve_device
    from ..models.loader import load_model
    from ..parallel.multihost import init_distributed, is_primary
    from ..tokenizer import load_tokenizer
    from .model_manager import ModelManager

    # the card unless the caller asks for the CPU: refused before any rank
    # is started or joined
    dev = resolve_device(device)
    # ONE validated parse of --shard for every branch (single host, frontend,
    # follower): all ranks fail alike on bad input
    shard_dp = shard_tp = None
    if shard:
        try:
            dp_s, tp_s = shard.split(",")
            shard_dp, shard_tp = int(dp_s), int(tp_s)
        except ValueError:
            raise ConfigError(
                f"--shard expects DP,TP (e.g. 2,4), got {shard!r}") from None
        if shard_dp < 1 or shard_tp < 1:
            raise ConfigError(f"--shard axes must be >= 1, got {shard!r}")
    followers = []
    if shard and shard_dp * shard_tp > 1 and not os.environ.get("BITNET_COORDINATOR"):
        followers = _start_followers(shard_dp * shard_tp, dict(
            model_path=model_path, host=host, port=port, max_seq_len=max_seq_len,
            kv_cache_dtype=kv_cache_dtype, kernel_path=kernel_path,
            num_slots=num_slots, shard=shard, auth_token=auth_token,
            model_dirs=model_dirs, paged=paged, num_pages=num_pages,
            page_size=page_size, chunked_prefill=chunked_prefill,
            speculative_k=speculative_k,
            decode_steps_per_dispatch=decode_steps_per_dispatch,
            pipeline_depth=pipeline_depth, device=str(device)))
    distributed = init_distributed(device=dev)
    ecfg = EngineConfig(max_seq_len=max_seq_len,
                        kv_cache_dtype=kv_cache_dtype,
                        kernel_path=kernel_path)
    mesh = channel = None
    if distributed:
        from ..parallel.mesh import rank_device
        from ..parallel.multihost import host_mesh
        from .follower import ControlChannel, worker_loop

        # this rank's card (LOCAL_RANK), or the CPU where the caller asks
        dev = rank_device(device=device)
        if not is_primary():
            # a follower: replay the frontend's control stream until it stops
            worker_loop(model_path, ecfg, num_slots=num_slots, tp=shard_tp, device=dev)
            return
        mesh = host_mesh(tp=shard_tp, device=dev)
        channel = ControlChannel()
    else:
        if shard:
            from ..parallel import make_mesh

            mesh = make_mesh(dp=shard_dp, tp=shard_tp, device=dev)
    cfg, params, _ = load_model(
        model_path,
        param_dtype=torch.float32 if ecfg.compute_dtype == "f32" else torch.bfloat16,
        device=dev)
    if ecfg.max_seq_len > cfg.max_seq_len:
        ecfg = ecfg.replace(max_seq_len=cfg.max_seq_len)
    tokenizer = load_tokenizer(model_path)
    sched = ContinuousBatchingScheduler(cfg, params, tokenizer, ecfg,
                                        num_slots=num_slots, mesh=mesh,
                                        channel=channel,
                                        paged=paged, num_pages=num_pages,
                                        page_size=page_size,
                                        chunked_prefill=chunked_prefill,
                                        speculative_k=speculative_k,
                                        decode_steps_per_dispatch=(
                                            decode_steps_per_dispatch),
                                        pipeline_depth=pipeline_depth,
                                        device=dev)
    manager = ModelManager(ecfg, num_slots=num_slots, mesh=mesh, device=dev)
    manager.adopt("bitnet-tpu", sched, path=model_path)
    # hot-load is confined to the started model's directory unless the
    # operator widens it (admin routes must not accept arbitrary paths)
    dirs = model_dirs or [os.path.dirname(os.path.abspath(model_path))]
    server = BitNetServer(manager=manager, auth_token=auth_token,
                          allowed_model_dirs=dirs, device=dev,
                          multihost=distributed)
    app = server.build_app()

    async def on_shutdown(app):
        server.otlp.stop()
        server.manager.shutdown()        # the followers' stop record

    app.on_shutdown.append(on_shutdown)
    try:
        web.run_app(app, host=host, port=port)
    finally:
        _stop_followers(followers)


def _start_followers(n: int, kwargs: dict) -> list:
    """Ranks 1 … n − 1 of a one-host ``serve --shard``: each a process
    running ``serve(**kwargs)`` as that rank (``BITNET_PROCESS_ID``,
    ``LOCAL_RANK``), over a ``FileStore`` in a new temporary directory; this
    process becomes rank 0.  Returns the processes."""
    import subprocess
    import sys
    import tempfile

    store = os.path.join(tempfile.mkdtemp(prefix="bitnet_serve_"), "store")
    env = {"BITNET_COORDINATOR": "file://" + store, "BITNET_NUM_PROCESSES": str(n),
           "LOCAL_WORLD_SIZE": str(n)}
    os.environ.update(env, BITNET_PROCESS_ID="0", LOCAL_RANK="0")
    code = ("import json, sys; from bitnet_tpu_torch.serve.server import serve; "
            "serve(**json.loads(sys.argv[1]))")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = []
    for r in range(1, n):
        penv = {**os.environ, **env, "BITNET_PROCESS_ID": str(r), "LOCAL_RANK": str(r),
                "PYTHONPATH": os.pathsep.join(
                    [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                              if p])}
        procs.append(subprocess.Popen([sys.executable, "-c", code, json.dumps(kwargs)],
                                      env=penv))
    return procs


def _stop_followers(procs: list, timeout_s: float = 60.0) -> None:
    """Wait for the followers this process started (the stop record ends
    them), and kill any that outlive ``timeout_s``."""
    import subprocess

    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
