"""Continuous-batching scheduler.

Counterpart of ``bitnet_tpu/serve/scheduler.py``: a fixed pool of B cache
slots; every step advances ALL active sequences in one batched forward;
finished sequences free their slot at once and pending requests are
prefilled into free slots between steps.  Kept from the JAX scheduler:

- ``Request`` / ``_Slot``, ``submit`` / ``stream`` / ``shutdown`` /
  ``pause`` / ``unpause``, priorities, ``timeout_s``, ``queue_timeout_s``,
  cancellation, ``max_admissions_per_step``, priority preemption (recompute
  mode), per-slot logit-bias rows, the ``min_new_tokens`` ban, Mirostat,
  grammars and logprobs sampled on the host from the step's raw logits
  (they force K=1), stop ids / EOS / stop sequences / overshoot over a
  K-step window, ``stats`` and the loop thread;
- the dense pool (``allocate_cache`` for ``num_slots``, ``kv_cache_dtype``
  'auto' resolved for the pool: int8) and the paged pool (``paged=True``:
  ``engine/paged_cache.py``, refcounted pages, shared-prefix forks, growth
  at page boundaries covering a whole K-step window, the youngest slot
  finished ``CONTEXT_FULL`` when the pool runs dry);
- chunked prefill (``chunked_prefill=N``): N prompt tokens a step,
  interleaved with the pool's decode steps;
- per-slot sampling: every parameter a per-slot column of one sampler
  (``engine/sampling.pooled_sample``), and slot b's own random stream: a
  ``torch.Generator`` seeded at admission by the engine's seed rule, drawn
  as the engine at B=1 draws (one [1, V] a step), so a request's tokens
  equal ``InferenceEngine.generate``'s with the same seed.

How the port runs it on the card: each pool step is a CUDA graph
(``engine/loop.PoolSegment``: forward → head → pooled sample, K times),
captured once per (B, K, attention plan, cache dtype, static sampler flags,
``BITNET_*`` environment) and replayed over static buffers; the host copies
the slots' tokens, positions, history and parameters in before a replay
and reads the K tokens after.  Prefills and chunks run eagerly, at B=1 over
the slot's own rows (dense: a view of the slot in the pool, written in
place, so the JAX ``splice`` is a no-op copy here; paged: straight into
the slot's pages).  The cache, the bias rows and the block table are
written in place and never replaced: a captured graph holds their
addresses.  Every device call runs on the loop's thread, on one stream: the
decode attention's arrival counters are one buffer a device, and a decode
from another thread while the scheduler runs raises
(``ops/decode_attention.claim_device``).

The loop thread is a device's, not a scheduler's: every started scheduler
on one device is stepped in turn by that device's ``DeviceLoop`` (so two
models serve from one card, as the JAX ``ModelManager`` loads them), and
work that other threads bring to the device runs there as a job between
steps (``run_on_device``: embeddings, a model load's copies and
re-quantization, request checkpoints, the health check's memory read), so
no thread touches the card while a pool step is being captured.  A
request's results arrive in a ``TokenQueue``, which can also wake an event
loop (the HTTP server waits on it without a thread a request).

Serving-level speculation (``speculative_k``, ``:259-267``,
``:1255-1355``): every greedy slot with no penalty, bias or host-side
sampler and room for k + 1 rows drafts k tokens by n-gram lookup, and all
of them verify in ONE dispatch (``engine/speculative.VerifyStep``: a forward
of k + 1 tokens over the dense pool, the other slots masked, each row's
argmax read back; on the card a CUDA graph per k + 1); each slot's length is
then set in place, and the other slots ride the step's normal dispatch.

Pipelined issue-ahead serving (``pipeline_depth > 1``, ``:233-253``,
``:556-645``, ``:2265-2528``): the decode state lives on the device
(``engine/loop.PoolPipeline``), up to ``pipeline_depth`` K-step windows are
in flight, each chaining on the last with no host work, the oldest read
first and the tokens of a slot that stopped or changed hands (its
occupancy epoch) dropped.  Admissions and finishes are small writes on the
same stream between windows; host-side samplers and min-token phases fall
back to the synchronous step until those slots finish; ``pause`` drains the
windows; ``repetition_window`` is pinned to ``HISTORY_W``.  Both modes need
a dense pool (a paged pool raises ``InferenceError``, as in the JAX
package), and they exclude each other.

``checkpoint_requests`` / ``resume_requests`` (``:983-1247``) write and
read the JAX package's files: each active slot's canonical ``[L, T, KV, D]``
rows through ``engine/checkpoint.py`` beside a ``.req.json`` of its
sampling fields, and a ``.pending.json`` for each request that had no
token yet; either package resumes the other's.

A mesh (``mesh=``, ``parallel/mesh.py``; ``:181-227``, ``:297-326``): the
weights are the rank's shard and the pool its rows of the KV heads and, on
the data axis, of the slots (a dense slot's prefill runs on the data rank
that holds it and its logits are broadcast over the axis; a paged pool is
whole on every data rank).  Every rank runs the same program (one process a
rank), so a mesh of more than one rank needs ``channel``, a
``serve.follower.ControlChannel``: the frontend (rank 0) sends one record
before each device call (a prefill, a length, a bias row, a pool step) and
the other ranks replay them in :meth:`follow` (``:882``), each on its own
shard.  Sampling stays on the frontend: every rank's logits are the whole
model's (the model axis gathers them), and the followers' tokens are never
read.  On a live mesh the pool steps run eagerly (K steps a dispatch
still), since a CUDA graph cannot hold a host-staged collective; as in the
JAX package a channel refuses the paged pool, ``pipeline_depth > 1``,
``speculative_k``, checkpoint / resume and embeddings.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import glob
import json
import os
import queue
import threading
import time
import traceback
import weakref
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..config import (EngineConfig, GenerationConfig, ModelConfig,
                      resolve_kernel_path)
from ..device_probe import resolve_device
from ..engine.cache import allocate_cache
from ..engine.engine import prepare_params
from ..engine.loop import HISTORY_W, INT_COLS, PoolPipeline, PoolSegment
from ..engine.sampling import NEG_INF, MirostatState, SamplerChain, logprob_entry
from ..engine.stop import StopCriteria, StopReason
from ..errors import ConfigError, InferenceError
from ..models.bitnet import (BitNetParams, decode_attn_plan, forward, kv_dtype_name,
                             logits as model_logits, stacked_decode_ok)
from ..ops.decode_attention import claim_device, release_device
from ..parallel.mesh import DATA_AXIS

# an idle slot's float row: neutral top_p, typical_p and repetition penalty
IDLE_FLOATS = np.array([0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 0.0], np.float32)


class TokenQueue(queue.Queue):
    """A request's results, ``(token_id, text, done, reason)``; each ``put``
    also calls the callbacks given to :meth:`notify` (from the putting
    thread), so an event loop can wait without a thread of its own."""

    def __init__(self):
        super().__init__()
        self._notify: list[Callable[[], None]] = []

    def notify(self, fn: Callable[[], None]) -> None:
        self._notify.append(fn)

    def put(self, item, block: bool = True, timeout: float | None = None) -> None:
        super().put(item, block, timeout)
        for fn in list(self._notify):
            fn()


@dataclasses.dataclass
class Request:
    token_ids: list[int]
    gen: GenerationConfig
    # results are streamed through this queue as (token_id, text, done, reason)
    out: TokenQueue = dataclasses.field(default_factory=TokenQueue)
    id: int = 0
    submitted_at: float = dataclasses.field(default_factory=time.time)
    priority: int = 0           # lower = sooner
    timeout_s: float | None = None        # total deadline from submission
    queue_timeout_s: float | None = None  # max wait before admission
    # per emitted token {"token_id","text","logprob","top"} when
    # gen.logprobs is set; appended before the matching out.put
    logprobs: list[dict] | None = None
    # host perf_counter() of each emitted token (TTFT, gaps between tokens)
    token_times: list = dataclasses.field(default_factory=list)
    preemptions: int = 0        # times the request was evicted and requeued
    _cancel: threading.Event = dataclasses.field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Request the generation to stop; the slot frees within one step."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()


@dataclasses.dataclass
class _Slot:
    active: bool = False
    req: Request | None = None
    stop: StopCriteria | None = None
    generated: int = 0
    pos: int = 0
    out_ids: list = dataclasses.field(default_factory=list)
    gen: Any = None                       # the slot's torch.Generator
    hist: Any = None                      # engine-shaped history row (np.int64)
    mirostat: MirostatState | None = None
    deadline: float | None = None
    pages: list = dataclasses.field(default_factory=list)  # paged mode
    admitted_at: float = 0.0
    prefilling: bool = False
    pf_done: int = 0              # suffix tokens prefilled so far
    pf_base: int = 0              # forked-prefix length (paged mode)
    grammar: Any = None           # VocabMatcher | None
    lp_pending: Any = None
    min_ban: bool = False
    # occupancy epoch: bumped at every activation, so a pipelined read drops
    # the tokens of a window that belong to an earlier occupant
    epoch: int = 0

    @property
    def hostside(self) -> bool:
        """Sampling needs host-side per-step state or a per-step logits
        read (forces K=1)."""
        return (self.mirostat is not None or self.grammar is not None
                or (self.req is not None and self.req.gen.logprobs is not None))

    @property
    def occupied(self) -> bool:
        return self.active or self.prefilling


def _device_key(device: torch.device) -> tuple[str, int]:
    if device.type != "cuda":
        return device.type, 0
    return "cuda", torch.cuda.current_device() if device.index is None else device.index


class DeviceLoop:
    """The one thread that drives a device: it steps every scheduler
    attached to it in turn and, between steps, runs the jobs other threads
    hand it (:meth:`call`).  It starts with the first scheduler of its
    device and ends when the last one leaves; a scheduler whose step raises
    fails its own requests and leaves, and the others go on."""

    _lock = threading.Lock()
    _loops: dict[tuple[str, int], "DeviceLoop"] = {}

    def __init__(self, device: torch.device):
        self.device = device
        self.key = _device_key(device)
        self.wake = threading.Event()
        self._scheds: list = []
        self._jobs: collections.deque = collections.deque()
        self._closed = False
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name=f"bitnet-device-{self.key[0]}{self.key[1]}")
        self.ident: int | None = None

    @classmethod
    def get(cls, device: torch.device) -> "DeviceLoop | None":
        with cls._lock:
            return cls._loops.get(_device_key(device))

    @classmethod
    def attach(cls, sched) -> "DeviceLoop":
        """Add ``sched`` to its device's loop (started if need be)."""
        with cls._lock:
            key = _device_key(sched.device)
            drv = cls._loops.get(key)
            if drv is None:
                drv = cls._loops[key] = DeviceLoop(sched.device)
                drv._scheds.append(sched)
                drv.thread.start()
            else:
                drv._scheds.append(sched)
        drv.wake.set()
        return drv

    def detach(self, sched) -> None:
        """Remove ``sched``; returns once no step of it is running."""
        def remove():
            with DeviceLoop._lock:
                if sched in self._scheds:
                    self._scheds.remove(sched)
        if threading.get_ident() == self.ident or not self.thread.is_alive():
            remove()
        else:
            self.call(remove)

    def on_thread(self) -> bool:
        return threading.get_ident() == self.ident

    def call(self, fn: Callable[[], Any], timeout: float | None = None) -> Any:
        """Run ``fn`` on the device loop's thread between steps; its result, or
        its exception raised here."""
        if self.on_thread():
            return fn()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with DeviceLoop._lock:
            if self._closed:
                fut = None
            else:
                self._jobs.append((fn, fut))
        if fut is None:                      # the device loop has just ended
            return fn()
        self.wake.set()
        return fut.result(timeout)

    def _run_jobs(self) -> None:
        while True:
            with DeviceLoop._lock:
                if not self._jobs:
                    return
                fn, fut = self._jobs.popleft()
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:   # noqa: BLE001 — handed to the caller
                fut.set_exception(e)

    def _run(self) -> None:
        self.ident = threading.get_ident()
        try:
            while True:
                self.wake.clear()
                self._run_jobs()
                with DeviceLoop._lock:
                    scheds = list(self._scheds)
                    if not scheds and not self._jobs:
                        self._closed = True
                        del DeviceLoop._loops[self.key]
                        return
                worked = False
                for s in scheds:
                    try:
                        worked |= bool(s._tick())
                    except BaseException as e:   # noqa: BLE001 — its requests fail
                        traceback.print_exception(e)
                        s._died(e)
                        with DeviceLoop._lock:
                            if s in self._scheds:
                                self._scheds.remove(s)
                if not worked:
                    self.wake.wait(timeout=0.05)
        finally:
            if self.device.type == "cuda":
                release_device(self.device, self.ident)


def run_on_device(device: str | torch.device, fn: Callable[[], Any]) -> Any:
    """``fn()`` on the thread that drives ``device`` when schedulers run
    there (between their steps, so no pool step is being captured), else
    on the calling thread."""
    drv = DeviceLoop.get(torch.device(device))
    return fn() if drv is None else drv.call(fn)


class ContinuousBatchingScheduler:
    """Owns the model and the pool cache; its decode loop runs on its
    device's :class:`DeviceLoop` thread.  ``device`` defaults to the card and raises without CUDA unless
    the caller passes ``"cpu"`` (the kernels' plain versions)."""

    MAX_SEGMENTS = 16

    def __init__(self, cfg: ModelConfig, params: BitNetParams, tokenizer,
                 engine_cfg: EngineConfig | None = None, num_slots: int = 4,
                 mesh=None, max_admissions_per_step: int = 2, paged: bool = False,
                 num_pages: int | None = None, page_size: int = 16, channel=None,
                 start_loop: bool = True, decode_steps_per_dispatch: int = 1,
                 chunked_prefill: int | None = None, speculative_k: int = 0,
                 pipeline_depth: int = 1, device: str | torch.device = "cuda"):
        self._channel = channel
        if channel is not None:
            if mesh is None:
                raise InferenceError(
                    "multi-host scheduling requires a mesh spanning all "
                    "processes (parallel.multihost.host_mesh)")
            if paged:
                raise InferenceError(
                    "multi-host scheduling does not support the paged "
                    "pool yet (host-side block-table updates are global "
                    "ops that would need mirroring)")
        if mesh is not None and mesh.size > 1 and channel is None:
            raise ConfigError(
                f"a mesh of {mesh.size} ranks needs a ControlChannel: every rank "
                "runs the scheduler's device calls, rank 0 serving and the others "
                "in follow() (serve.follower)")
        self.mesh = mesh
        live_mesh = mesh is not None and mesh.live
        self.pipeline_depth = max(1, int(pipeline_depth))
        if self.pipeline_depth > 1 and (paged or speculative_k or live_mesh):
            raise InferenceError(
                "pipeline_depth > 1 requires a dense single-host pool "
                "without serving-level speculation")
        self.speculative_k = max(0, int(speculative_k))
        if self.speculative_k:
            from ..engine.speculative import NgramDraft

            self._spec_draft = NgramDraft()
            if paged or live_mesh:
                raise InferenceError("speculative_k requires a dense single-host pool")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.engine_cfg = ec = engine_cfg or EngineConfig()
        cfg.validate()
        self.B = num_slots
        self.S = ec.max_seq_len
        self.max_admissions_per_step = max(1, max_admissions_per_step)
        self.decode_steps_per_dispatch = max(1, decode_steps_per_dispatch)
        self.chunked_prefill = chunked_prefill
        if chunked_prefill is not None and chunked_prefill < 8:
            raise InferenceError("chunked_prefill must be ≥ 8 tokens")
        self.paged = paged
        self.page_size = page_size
        self._kp = resolve_kernel_path(ec.kernel_path, self.device)
        # 'auto' as the engine resolves it for a pool of num_slots
        kv_dtype = ec.replace(max_batch_size=num_slots).resolve_kv_cache_dtype()
        if paged and kv_dtype not in ("bf16", "f32"):
            raise InferenceError("paged scheduler: quantized KV pages not supported")
        # the weights' preparation (TL re-quantization runs kernels) and the
        # pool's allocation run where the device's other schedulers step
        run_on_device(self.device, lambda: self._init_device(
            params, kv_dtype, num_pages))
        self.slots = [_Slot() for _ in range(self.B)]
        self.pending: "queue.PriorityQueue[tuple[int, float, int, Request]]" = \
            queue.PriorityQueue()
        self._tokens = np.zeros(self.B, np.int64)     # next input per slot
        # per-slot logit-bias rows [B, V] on the device, allocated on the
        # first biased request and then written in place
        self._bias_rows: torch.Tensor | None = None
        self._bias_live = np.zeros(self.B, bool)
        self._wake = threading.Event()
        self._stopping = False
        self._req_counter = 0
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0, "completed": 0, "tokens_generated": 0,
            "decode_steps": 0, "active_slots": 0, "queue_depth": 0,
            "cancelled": 0, "timeouts": 0,
            # B=1 prefill forwards (whole prompts and chunks); host seconds
            # of the pool dispatches (copies in, replay, tokens read; a
            # graph's capture aside) and the graphs captured
            "prefills": 0, "decode_s": 0.0, "captures": 0,
        }
        self._segments: collections.OrderedDict = collections.OrderedDict()
        self._verifies: dict = {}            # speculative verify steps by k + 1
        self._graph_pool = None
        # pipelined mode: the device state (built at first use), whether it
        # holds the host's slots, its view of each slot (active, epoch), the
        # windows in flight and the tokens they will emit a slot
        self._pl: PoolPipeline | None = None
        self._pl_valid = False
        self._pl_mirror = [False] * self.B
        self._pl_mirror_epoch = [-1] * self.B
        self._pl_inflight: collections.deque = collections.deque()
        self._pl_issued = np.zeros(self.B, np.int64)
        self._owner: int | None = None      # thread that drives the device
        self.error: BaseException | None = None
        # called as hook(request, raw logits row [V] on the device) for each
        # token sampled at K=1 (and each first token): a check's window
        self.logits_hook = None
        self._devloop: DeviceLoop | None = None
        if start_loop:
            self._devloop = DeviceLoop.attach(self)
            self._wake = self._devloop.wake

    def _init_device(self, params, kv_dtype: str, num_pages: int | None) -> None:
        cfg, ec, mesh = self.cfg, self.engine_cfg, self.mesh
        self.params, _ = prepare_params(params, ec, self.device, self._kp)
        if mesh is not None:
            from ..parallel.sharding import shard_params, validate_mesh_for

            validate_mesh_for(cfg, self.B, mesh, self.params)
            self.params = shard_params(mesh, cfg, self.params)
        if self.paged:
            from ..engine.paged_cache import allocate_paged_cache

            nb = -(-self.S // self.page_size)
            self.cache, self.pool = allocate_paged_cache(
                cfg if mesh is None else mesh.local_cfg(cfg), self.B,
                num_pages or self.B * nb, self.page_size, nb, kv_dtype,
                device=self.device)
            self.S_view = nb * self.page_size
        elif mesh is not None:
            from ..parallel.sharding import allocate_sharded_cache

            # the rank's rows only: the whole pool is never allocated
            self.cache = allocate_sharded_cache(mesh, cfg, self.B, self.S, kv_dtype,
                                                device=self.device)
        else:
            self.cache = allocate_cache(cfg, self.B, self.S, kv_dtype, device=self.device)

    @property
    def alive(self) -> bool:
        """The loop runs: started, not shut down, not failed."""
        d = self._devloop
        return (d is not None and d.thread.is_alive() and not self._stopping
                and self.error is None)


    # ------------------------------------------------------------- public
    def submit(self, token_ids: list[int], gen: GenerationConfig | None = None,
               priority: int = 0, timeout_s: float | None = None,
               queue_timeout_s: float | None = None) -> Request:
        gen = gen or GenerationConfig()
        with self._lock:
            self._req_counter += 1
            rid = self._req_counter
        req = Request(token_ids=list(token_ids), gen=gen, id=rid, priority=priority,
                      timeout_s=timeout_s, queue_timeout_s=queue_timeout_s,
                      logprobs=[] if gen.logprobs is not None else None)
        self.pending.put((priority, req.submitted_at, rid, req))
        self.stats["requests"] += 1
        self._wake.set()
        return req

    def stream(self, req: Request, timeout: float = 300.0
               ) -> Iterator[tuple[int, str]]:
        """Yield (token_id, text) until the request finishes."""
        while True:
            tok, text, done, reason = req.out.get(timeout=timeout)
            if tok is not None:
                yield tok, text
            if done:
                if reason is None and self.error is not None:
                    raise InferenceError(f"scheduler loop failed: {self.error!r}")
                return

    def shutdown(self) -> None:
        self._stopping = True
        self._wake.set()
        if self._channel is not None and self._channel.primary:
            # the followers' stop, after this rank's last step
            run_on_device(self.device, self._send_stop)
        if self._devloop is not None:
            self._devloop.detach(self)
        elif self._owner is not None:
            release_device(self.device, self._owner)
            self._owner = None

    def pause(self, timeout: float = 30.0) -> None:
        """Quiesce the decode loop at the next step boundary; :meth:`unpause`
        resumes it.  No-op without a running loop."""
        self._pause_req = True
        self._wake.set()
        if not self.alive:
            return
        deadline = time.time() + timeout
        while not getattr(self, "_paused_at_barrier", False):
            if time.time() > deadline:
                self._pause_req = False
                self._wake.set()
                raise InferenceError("scheduler pause timed out")
            time.sleep(0.005)

    def unpause(self) -> None:
        self._pause_req = False
        self._wake.set()

    # ----------------------------------------------------- multi-host
    def _send(self, record: tuple) -> None:
        """The frontend's control record before a device call (none on a
        follower, which is replaying one, or without a channel)."""
        ch = self._channel
        if ch is not None and ch.primary:
            ch.send(record)

    def _send_stop(self) -> None:
        if self._channel is not None and self._channel.primary \
                and not getattr(self, "_stop_sent", False):
            self._stop_sent = True
            self._channel.send(("stop",))

    def _owner_slot(self, slot_idx: int) -> tuple[int, int | None]:
        """(the data rank holding slot ``slot_idx``, its row in this rank's
        pool or None when another data rank holds it)."""
        Bl = self.cache.k.shape[1]
        if self.paged or Bl == self.B:
            return 0, slot_idx
        owner = slot_idx // Bl
        mine = self.mesh.axis(DATA_AXIS).index == owner
        return owner, (slot_idx - owner * Bl) if mine else None

    def _set_length(self, slot_idx: int, T: int) -> None:
        """A slot's valid length, written where its rows live."""
        self._send(("length", slot_idx, T))
        _, row = self._owner_slot(slot_idx)
        if row is not None:
            self.cache.lengths[row] = T

    def follow(self) -> None:
        """Worker follower loop (``serve/follower.py``): replay the
        frontend's control records so every rank makes the same device
        calls, collectives included, in the same order, each on its own
        shard; the tokens it samples are never read.  Blocks until a
        ``stop`` record."""
        ch = self._channel
        if ch is None or ch.primary:
            raise InferenceError(
                "follow() runs on non-primary processes with a channel")
        self._claim()
        while True:
            rec = ch.recv()
            op = rec[0]
            if op == "stop":
                return
            if op == "noop":
                continue
            if op == "prefill":
                _, slot_idx, ids, start = rec
                self._prefill_dense(slot_idx, ids, start)
            elif op == "length":
                self._set_length(rec[1], rec[2])
            elif op == "bias":
                self._set_slot_bias(rec[1], rec[2])
            elif op == "pool":
                _, ints, floats, k_eff, use_typical, use_bias, use_sampling = rec
                self._get_segment(k_eff, use_typical, use_bias, use_sampling)(
                    ints, floats, [None] * self.B)
            else:  # pragma: no cover - protocol guard
                raise InferenceError(f"unknown control record {op!r}")

    # ------------------------------------------------- preemption recovery
    def checkpoint_requests(self, directory: str) -> list[str]:
        """Snapshot every in-flight request's decode state to disk
        (``bitnet_tpu/serve/scheduler.py:983-1102``): an active slot's rows
        as ``slot{i}_req{id}`` (``engine/checkpoint.save``) beside
        ``.req.json``; a request still queued or mid-prefill as
        ``queued_req{id}.pending.json``.  Runs between the loop's steps
        (the rows are read on the device's thread); returns the paths
        written."""
        if self._channel is not None:
            raise InferenceError(
                "checkpoint/resume is frontend-local and not mirrored to "
                "followers; drain requests before stopping a multi-host "
                "serve instead")
        return run_on_device(self.device, lambda: self._checkpoint(directory))

    def _slot_rows(self, i: int, kv_len: int):
        """Slot i's first kv_len rows as canonical host ``[L, T, KV, D]`` k
        and v, and a 1-byte cache's ``[L, T, KV]`` scales."""
        from ..engine.prefix_cache import canonical_rows, to_host

        L, KV, D = self.cfg.num_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        if not self.paged:
            return canonical_rows(self.cache, kv_len, i, KV)
        pages = torch.tensor(self.slots[i].pages[: -(-kv_len // self.page_size)],
                             dtype=torch.long, device=self.cache.k.device)
        k, v = (to_host(a[:, :, pages].permute(0, 2, 3, 1, 4).reshape(
            L, -1, KV, D)[:, :kv_len]) for a in (self.cache.k, self.cache.v))
        return k, v, None, None

    def _checkpoint(self, directory: str) -> list[str]:
        from ..engine import checkpoint as ckpt

        os.makedirs(directory, exist_ok=True)
        written = []
        for i, slot in enumerate(self.slots):
            if not slot.active or slot.req is None:
                continue
            kv_len = slot.pos
            k, v, ks, vs = self._slot_rows(i, kv_len)
            state = ckpt.DecodeState(
                prompt_ids=list(slot.req.token_ids), generated_ids=list(slot.out_ids),
                rng_key=None, kv_len=kv_len, k=k, v=v, k_scale=ks, v_scale=vs)
            path = os.path.join(directory, f"slot{i}_req{slot.req.id}")
            ckpt.save(state, path)
            with open(path + ".req.json", "w") as f:
                json.dump({"request_id": slot.req.id, "generated": slot.generated,
                           "gen": _gen_fields(slot.req.gen)}, f)
            written.append(path)
        # requests with no decoded token yet (mid-chunked-prefill or still
        # queued) restart from scratch on resume: prompt and sampling only
        queued = [s.req for s in self.slots if s.prefilling and s.req is not None]
        drained = []
        while True:
            try:
                drained.append(self.pending.get_nowait())
            except queue.Empty:
                break
        for item in drained:
            self.pending.put(item)
            queued.append(item[3])
        for req in queued:
            path = os.path.join(directory, f"queued_req{req.id}.pending.json")
            with open(path, "w") as f:
                json.dump({"request_id": req.id, "token_ids": list(req.token_ids),
                           "priority": req.priority, "gen": _gen_fields(req.gen)}, f)
            written.append(path)
        return written

    def resume_requests(self, directory: str) -> list[Request]:
        """Restore checkpointed requests into free slots
        (``bitnet_tpu/serve/scheduler.py:1104-1247``): generation goes on
        where it stopped, the token emitted but not yet decoded as the next
        input; the queued ones are submitted again.  Runs between the
        loop's steps."""
        if self._channel is not None:
            raise InferenceError(
                "checkpoint/resume is frontend-local and not mirrored to "
                "followers; resume before entering multi-host mode")
        return run_on_device(self.device, lambda: self._resume(directory))

    def _restore_rows(self, slot_idx: int, state) -> None:
        """Write a snapshot's rows into slot ``slot_idx`` (dense: its rows,
        the rest zeroed, scales one past kv_len; paged: fresh pages)."""
        from ..engine.prefix_cache import as_tensor

        L, KV, D = self.cfg.num_layers, self.cfg.num_kv_heads, self.cfg.head_dim
        T = state.kv_len
        c = self.cache
        k, v = (as_tensor(a).to(c.k.device, c.k.dtype) for a in (state.k, state.v))
        if (k.shape[0], k.shape[2], k.shape[3]) != (L, KV, D):
            raise InferenceError(f"checkpoint shape {tuple(k.shape)} does not match "
                                 f"model {(L, KV, D)}")
        if self.paged:
            from ..engine.paged_cache import pages_needed

            if c.k.dtype != k.dtype:
                raise InferenceError("paged resume: the snapshot's dtype is not the pool's")
            n = pages_needed(T, self.page_size)
            if n > self.pool.free_pages:
                raise InferenceError("no free pages to resume a checkpointed request")
            pages = self.pool.alloc(n)
            self.slots[slot_idx].pages = pages
            self._write_table(slot_idx, 0, pages)
            P = self.page_size
            pad = n * P - T
            for dst, rows in ((c.k, k), (c.v, v)):
                r = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
                dst[:, :, torch.tensor(pages, device=dst.device)] = r.reshape(
                    L, n, P, KV, D).permute(0, 3, 1, 2, 4)
        else:
            for dst, rows in ((c.k, k), (c.v, v)):
                dst[:, slot_idx].zero_()
                dst[:, slot_idx, :T] = rows.reshape(L, T, KV * D)
            if c.k_scale is not None:
                for dst, sc in ((c.k_scale, state.k_scale), (c.v_scale, state.v_scale)):
                    dst[:, slot_idx].fill_(1.0)
                    dst[:, slot_idx, :T] = as_tensor(sc).to(dst.device, dst.dtype)
        c.lengths[slot_idx] = T

    def _resume(self, directory: str) -> list[Request]:
        from ..engine import checkpoint as ckpt

        restored = []
        for meta_path in sorted(glob.glob(f"{directory}/*.req.json")):
            base = meta_path[: -len(".req.json")]
            with open(meta_path) as f:
                meta = json.load(f)
            state = ckpt.load(base)
            slot_idx = next((i for i, s in enumerate(self.slots) if not s.occupied), None)
            if slot_idx is None:
                raise InferenceError("no free slot to resume a checkpointed request")
            g = meta["gen"]
            remaining = int(g["max_new_tokens"]) - int(meta["generated"])
            if remaining <= 0 or not state.generated_ids:
                continue
            # the min phase's rest (the JAX scheduler keeps the whole
            # min_new_tokens, which GenerationConfig refuses past max)
            gen = _gen_from_fields(g, remaining, min(remaining, max(
                0, int(g.get("min_new_tokens", 0)) - len(state.generated_ids))))
            req = Request(token_ids=state.prompt_ids, gen=gen, id=meta["request_id"],
                          logprobs=[] if gen.logprobs is not None else None)
            self._restore_rows(slot_idx, state)
            slot = self.slots[slot_idx]
            eos = getattr(self.tokenizer, "eos_token_id", None)
            slot.req = req
            slot.stop = StopCriteria(
                max_new_tokens=remaining, eos_token_id=eos,
                stop_token_ids=frozenset(gen.stop_token_ids),
                stop_sequences=tuple(gen.stop_sequences),
                min_new_tokens=gen.min_new_tokens)
            slot.generated = 0
            slot.pos = state.kv_len
            slot.out_ids = list(state.generated_ids)
            slot.gen = torch.Generator(device=self.device).manual_seed(self._seed(gen))
            # the history the unbroken run holds here: the prompt's tail,
            # rolled once for each token emitted
            W = min(gen.repetition_window, HISTORY_W)
            slot.hist = self._history_row(state.prompt_ids, W)
            for t in state.generated_ids:
                if W:
                    slot.hist = np.concatenate([slot.hist[1:], [t]])
            slot.mirostat = MirostatState.from_config(gen) if gen.mirostat else None
            slot.grammar = self._grammar_matcher(gen)
            if slot.grammar is not None:
                # replay the emitted text so the pushdown state matches
                for t in state.generated_ids:
                    slot.grammar.accept(int(t))
            slot.deadline = None
            slot.admitted_at = time.time()
            slot.min_ban = False
            if gen.logit_bias or self._bias_live[slot_idx]:
                self._set_slot_bias(slot_idx, gen.logit_bias)
            if gen.min_new_tokens:                 # the min phase goes on
                ban = self._min_ban_bias(gen)
                if dict(ban) != dict(gen.logit_bias):
                    slot.min_ban = True
                    self._set_slot_bias(slot_idx, ban)
            slot.prefilling = False
            slot.active = True
            slot.epoch += 1
            self._tokens[slot_idx] = state.generated_ids[-1]
            restored.append(req)
            self.stats["requests"] += 1
        # prompts that never produced a token re-enter the queue
        for meta_path in sorted(glob.glob(f"{directory}/*.pending.json")):
            with open(meta_path) as f:
                meta = json.load(f)
            g = meta["gen"]
            restored.append(self.submit(meta["token_ids"],
                                        _gen_from_fields(g, int(g["max_new_tokens"])),
                                        priority=int(meta.get("priority", 0))))
        self._wake.set()
        return restored

    def embed_ids(self, token_ids: list[int]) -> np.ndarray:
        """Final-hidden-state embeddings [T, H] f32 on the host, from a
        throwaway B=1 cache (the pool is not touched); lengths bucket to
        powers of two.  Runs between the loop's steps."""
        if self._channel is not None:
            raise InferenceError(
                "embeddings are frontend-local; not supported on a "
                "multi-host scheduler")
        return run_on_device(self.device, lambda: self._embed_ids(token_ids))

    def _embed_ids(self, token_ids: list[int]) -> np.ndarray:
        T = len(token_ids)
        if T == 0:
            raise InferenceError("empty input")
        if T > self.S:
            raise InferenceError(f"input {T} tokens > max_seq_len {self.S}")
        Tp = min(self.S, 1 << max(3, (T - 1).bit_length()))
        cache = allocate_cache(self.cfg, 1, Tp, "f32" if self.cache.k.dtype ==
                               torch.float32 else "bf16", device=self.device)
        toks = np.zeros((1, Tp), np.int64)
        toks[0, :T] = token_ids
        pos = np.full((1, Tp), Tp, np.int64)
        pos[0, :T] = np.arange(T)
        with torch.inference_mode():
            h, _, _ = forward(self.cfg, self.params, self._dev(toks), self._dev(pos),
                              cache.k, cache.v, cache.lengths,
                              self._dev(np.array([T])), self._kp)
            return h[0, :T].to(torch.float32).cpu().numpy()

    # ----------------------------------------------------------- helpers
    def _dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _bucket(self, T: int) -> int:
        b = 8
        while b < T:
            b *= 2
        return min(b, self.S)

    def _seed(self, gen: GenerationConfig) -> int:
        """The engine's seed rule (``engine.generate_stream``)."""
        if gen.seed is not None:
            return gen.seed
        return 0 if self.engine_cfg.strict.deterministic else time.time_ns() % (2**31)

    def plan(self) -> str:
        """The attention plan of the pool's decode step: ``paged`` (K33), the
        dense stacked loop's plan, or ``generic``."""
        if not stacked_decode_ok(self.cfg, self.params, 1, self.B, self._kp):
            return "generic"
        return "paged" if self.paged else decode_attn_plan(
            self.B, kv_dtype_name(self.cache.k.dtype))

    def _get_segment(self, n_steps: int, use_typical: bool, use_bias: bool,
                     use_sampling: bool) -> PoolSegment:
        """The K-step pool program keyed on B, K, the plan, the cache dtype,
        the static sampler flags and the ``BITNET_*`` environment (LRU)."""
        key = (self.B, n_steps, self.plan(), str(self.cache.k.dtype), use_typical,
               use_bias, use_sampling,
               tuple(sorted((k, v) for k, v in os.environ.items()
                            if k.startswith("BITNET_"))))
        seg = self._segments.get(key)
        if seg is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            seg = PoolSegment(self.cfg, self.params, self.cache, self._kp, n_steps,
                              self.S, self.device, self._graph_pool, paged=self.paged,
                              use_typical=use_typical, use_sampling=use_sampling,
                              bias_rows=self._bias_rows if use_bias else None,
                              eager=self.mesh is not None and self.mesh.live)
            self._segments[key] = seg
            while len(self._segments) > self.MAX_SEGMENTS:
                self._segments.popitem(last=False)
        self._segments.move_to_end(key)
        return seg

    def _history_row(self, token_ids: list[int], W: int) -> np.ndarray:
        """The engine's history at the first sample: the prompt's last W
        ids, left-aligned, -1 padding (``engine.generate_stream``)."""
        row = np.full(W, -1, np.int64)
        tail = list(token_ids)[-W:] if W > 0 else []
        row[: len(tail)] = tail
        return row

    # ------------------------------------------------------------- prefills
    def _prefill_dense(self, slot_idx: int, ids: list[int], start: int) -> torch.Tensor:
        """B=1 bucketed prefill of ``ids`` at positions start… over slot
        ``slot_idx``'s own rows (a view of the pool, written in place; the
        rows start… are attended after the ``start`` already there).
        Returns the last real token's logits [1, V]."""
        Tc = len(ids)
        Tp = self._bucket(Tc)
        self.stats["prefills"] += 1
        self._send(("prefill", slot_idx, list(ids), start))
        toks = np.zeros((1, Tp), np.int64)
        toks[0, :Tc] = ids
        pos = np.full((1, Tp), self.S, np.int64)
        pos[0, :Tc] = np.arange(start, start + Tc)
        owner, row = self._owner_slot(slot_idx)
        with torch.inference_mode():
            lg = None
            if row is not None:
                c, sl = self.cache, slice(row, row + 1)
                ks = None if c.k_scale is None else c.k_scale[:, sl]
                vs = None if c.v_scale is None else c.v_scale[:, sl]
                h, _, _ = forward(self.cfg, self.params, self._dev(toks), self._dev(pos),
                                  c.k[:, sl], c.v[:, sl], self._dev(np.array([start])),
                                  self._dev(np.array([Tc])), self._kp, ks, vs)
                lg = model_logits(self.cfg, self.params, h[:, Tc - 1:Tc], self._kp)[:, 0]
            if self.mesh is not None and self.mesh.axis(DATA_AXIS).size > 1:
                # the data rank holding the slot ran it: its logits to all
                if lg is None:
                    lg = torch.empty((1, self.cfg.vocab_size), dtype=torch.float32,
                                     device=self.device)
                lg = self.mesh.axis(DATA_AXIS).broadcast(
                    lg.to(torch.float32).contiguous(), src=owner)
            return lg

    def _prefill_paged(self, slot_idx: int, ids: list[int], start: int) -> torch.Tensor:
        """B=1 prefill straight into the slot's pages: a one-row
        ``PagedKVCache`` over the pool's k / v and the slot's table row, the
        ``start`` rows before it (a forked prefix or earlier chunks)
        attended.  Returns the last real token's logits [1, V]."""
        from ..engine.paged_cache import PagedKVCache, paged_forward

        Tc = len(ids)
        Tp = self._bucket(Tc)
        self.stats["prefills"] += 1
        toks = np.zeros((1, Tp), np.int64)
        toks[0, :Tc] = ids
        pos = np.full((1, Tp), self.S_view, np.int64)
        pos[0, :Tc] = np.arange(start, start + Tc)
        c = self.cache
        with torch.inference_mode():
            sub = PagedKVCache(k=c.k, v=c.v, tables=c.tables[slot_idx:slot_idx + 1],
                               lengths=self._dev(np.array([start], np.int32)),
                               page_size=self.page_size)
            h, _ = paged_forward(self.cfg, self.params, self._dev(toks), self._dev(pos),
                                 sub, self._dev(np.array([Tc], np.int32)), self._kp)
            return model_logits(self.cfg, self.params, h[:, Tc - 1:Tc], self._kp)[:, 0]

    # ---------------------------------------------------------- preemption
    def _maybe_preempt(self) -> None:
        """Priority preemption (recompute mode): when a strictly
        higher-priority request waits and no slot is free, evict the
        lowest-priority ACTIVE slot; its tokens fold into the prompt and its
        sampler / grammar / stop state is stashed on the Request, so
        re-admission re-prefills once and continues the same stream."""
        if self.pending.empty():
            return
        with self.pending.mutex:
            if not self.pending.queue:
                return
            best_prio = self.pending.queue[0][0]
        if any(not s.occupied for s in self.slots):
            return
        worst_i, worst_p = None, best_prio
        for i, s in enumerate(self.slots):
            if s.active and not s.prefilling and s.req is not None \
                    and s.req.priority > worst_p:
                worst_p, worst_i = s.req.priority, i
        if worst_i is None:
            return
        slot = self.slots[worst_i]
        req = slot.req
        req.token_ids = list(req.token_ids) + list(slot.out_ids)
        req.preemptions += 1
        req._preempt = {"gen": slot.gen, "hist": slot.hist, "mirostat": slot.mirostat,
                        "grammar": slot.grammar, "stop": slot.stop,
                        "generated": slot.generated}
        slot.active = False
        slot.req = None
        slot.grammar = None
        slot.lp_pending = None
        slot.min_ban = False
        self._release_slot_pages(worst_i)
        self.pending.put((req.priority, req.submitted_at, req.id, req))
        self.stats["preempted"] = self.stats.get("preempted", 0) + 1
        self.stats["active_slots"] = sum(1 for s in self.slots if s.active)

    # ----------------------------------------------------------- admission
    def _admit(self) -> None:
        """Admit pending requests into free slots.  The pipelined mode
        defers each admission's first sample until every prefill of the
        step is queued: the first read then waits once for the windows in
        flight (``bitnet_tpu/serve/scheduler.py:1401-1431``)."""
        defer: list | None = [] if self.pipeline_depth > 1 else None
        try:
            self._admit_loop(defer)
        finally:
            for slot_idx, lg in defer or ():
                self._activate(slot_idx, lg)

    def _admit_loop(self, defer: list | None) -> None:
        admitted = 0
        for slot_idx, slot in enumerate(self.slots):
            if slot.occupied:
                continue
            if admitted >= self.max_admissions_per_step:
                return  # bound prefill head-of-line blocking per step
            try:
                _, _, _, req = self.pending.get_nowait()
            except queue.Empty:
                return
            now = time.time()
            if req.cancelled:
                req.out.put((None, "", True, StopReason.CANCELLED))
                self.stats["cancelled"] += 1
                self.stats["completed"] += 1
                continue
            if (req.queue_timeout_s is not None
                    and getattr(req, "_preempt", None) is None
                    and now - req.submitted_at > req.queue_timeout_s):
                req.out.put((None, "", True, StopReason.TIMEOUT))
                self.stats["timeouts"] += 1
                self.stats["completed"] += 1
                continue
            T = len(req.token_ids)
            if T == 0 or T >= self.S:
                req.out.put((None, "", True, StopReason.CONTEXT_FULL))
                self.stats["completed"] += 1
                continue
            staged = self.chunked_prefill is not None and T > self.chunked_prefill
            pf_base, lg = 0, None
            if self.paged:
                m = self._paged_alloc_slot(slot_idx, req, T)
                if m is None:             # pool exhausted: requeue, stop admitting
                    self.pending.put((req.priority, req.submitted_at, req.id, req))
                    return
                pf_base = m
                if not staged:
                    lg = self._prefill_paged(slot_idx, req.token_ids[m:], m)
                    self._set_length(slot_idx, T)
            elif not staged:
                lg = self._prefill_dense(slot_idx, req.token_ids, 0)
                self._set_length(slot_idx, T)
            admitted += 1
            self._install(slot_idx, slot, req, T)
            if staged:
                slot.prefilling = True
                slot.pf_done = 0
                slot.pf_base = pf_base
                slot.pos = 0
                self.stats["chunked_admissions"] = (
                    self.stats.get("chunked_admissions", 0) + 1)
                continue
            if defer is not None:
                defer.append((slot_idx, lg))
            else:
                self._activate(slot_idx, lg)

    def _install(self, slot_idx: int, slot: _Slot, req: Request, T: int) -> None:
        """The slot's request state: stop criteria, generator, history,
        Mirostat, grammar, deadline, bias rows and the min-phase ban (a
        preempted request's stashed state continues)."""
        eos = getattr(self.tokenizer, "eos_token_id", None)
        gen = req.gen
        slot.req = req
        slot.stop = StopCriteria(
            max_new_tokens=gen.max_new_tokens, eos_token_id=eos,
            stop_token_ids=frozenset(gen.stop_token_ids),
            stop_sequences=tuple(gen.stop_sequences),
            min_new_tokens=gen.min_new_tokens)
        slot.generated = 0
        slot.pos = T
        slot.out_ids = []
        slot.gen = torch.Generator(device=self.device).manual_seed(self._seed(gen))
        slot.hist = self._history_row(req.token_ids, min(gen.repetition_window,
                                                          HISTORY_W))
        slot.mirostat = MirostatState.from_config(gen) if gen.mirostat else None
        slot.grammar = self._grammar_matcher(gen)
        slot.deadline = (req.submitted_at + req.timeout_s
                         if req.timeout_s is not None else None)
        slot.admitted_at = time.time()
        res = req.__dict__.pop("_preempt", None)
        if res is not None:
            slot.gen, slot.hist = res["gen"], res["hist"]
            slot.mirostat, slot.grammar = res["mirostat"], res["grammar"]
            slot.stop, slot.generated = res["stop"], res["generated"]
        if gen.logit_bias or self._bias_live[slot_idx]:
            self._set_slot_bias(slot_idx, gen.logit_bias)
        slot.min_ban = False
        mn = slot.stop.min_new_tokens
        if mn and slot.generated < mn:
            ban = self._min_ban_bias(gen)
            if dict(ban) != dict(gen.logit_bias):
                slot.min_ban = True
                self._set_slot_bias(slot_idx, ban)

    def _activate(self, slot_idx: int, lg: torch.Tensor) -> None:
        slot = self.slots[slot_idx]
        slot.prefilling = False
        slot.active = True
        slot.epoch += 1
        first = self._sample_first(slot, lg)
        if first is None:                      # grammar dead end
            self._finish(slot_idx, StopReason.EOS)
        else:
            self._emit(slot_idx, first)

    # ---------------------------------------------------- chunked prefill
    def _advance_prefills(self) -> bool:
        """ONE prompt chunk for up to ``max_admissions_per_step`` staging
        slots (dense: into the slot's rows; paged: into its reserved pages);
        slots whose last chunk completed activate.  True when any chunk
        ran."""
        C = self.chunked_prefill
        worked, advanced = False, 0
        for slot_idx, slot in enumerate(self.slots):
            if not slot.prefilling:
                continue
            if advanced >= self.max_admissions_per_step:
                return True
            req = slot.req
            if req is None or req.cancelled:
                self._finish(slot_idx, StopReason.CANCELLED)
                continue
            if slot.deadline is not None and time.time() > slot.deadline:
                self._finish(slot_idx, StopReason.TIMEOUT)
                continue
            worked = True
            advanced += 1
            total = len(req.token_ids) - slot.pf_base
            start = slot.pf_base + slot.pf_done
            Tc = min(C, len(req.token_ids) - start)
            ids = req.token_ids[start:start + Tc]
            lg = (self._prefill_paged(slot_idx, ids, start) if self.paged
                  else self._prefill_dense(slot_idx, ids, start))
            slot.pf_done += Tc
            self.stats["prefill_chunks"] = self.stats.get("prefill_chunks", 0) + 1
            if slot.pf_done < total:
                continue
            T = len(req.token_ids)
            self._set_length(slot_idx, T)
            slot.pos = T
            self._activate(slot_idx, lg)
        return worked

    # ------------------------------------------------------------ paged ops
    def _find_fork_source(self, prompt: list[int], T: int) -> tuple[int, int | None]:
        """Longest page-aligned common prefix with an active slot's prompt
        (at least one suffix token left).  Returns (m, source slot|None)."""
        page = self.page_size
        best_m, best_j = 0, None
        for j, s in enumerate(self.slots):
            if not s.active or s.req is None:
                continue
            m = 0
            for a, b in zip(prompt, s.req.token_ids):
                if a != b:
                    break
                m += 1
            m = (m // page) * page
            m = min(m, ((T - 1) // page) * page)
            if m >= page and m > best_m and s.pos >= m:
                best_m, best_j = m, j
        return best_m, best_j

    def _write_table(self, slot_idx: int, start: int, pages: list[int]) -> None:
        if pages:
            self.cache.tables[slot_idx, start:start + len(pages)] = torch.tensor(
                pages, dtype=torch.int32)

    def _paged_alloc_slot(self, slot_idx: int, req: Request, T: int) -> int | None:
        """Reserve the slot's pages for a T-token prompt: fork shared-prefix
        pages, allocate the rest, write the block table.  Returns the
        forked-prefix length m (0 if none), or None when the pool is dry."""
        from ..engine import paged_cache as pc

        page = self.page_size
        slot = self.slots[slot_idx]
        m, src = self._find_fork_source(req.token_ids, T)
        need_new = pc.pages_needed(T, page) - m // page
        if need_new > self.pool.free_pages:
            return None
        pages: list[int] = []
        if m > 0 and src is not None:
            shared = self.slots[src].pages[: m // page]
            self.pool.retain(shared)
            pages.extend(shared)
            self.stats["prefix_forked_pages"] = (
                self.stats.get("prefix_forked_pages", 0) + len(shared))
        else:
            m = 0
        pages.extend(self.pool.alloc(need_new))
        slot.pages = pages
        self._write_table(slot_idx, 0, pages)
        return m

    def _release_slot_pages(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        if not self.paged or not slot.pages:
            return
        self.pool.release(slot.pages)
        slot.pages = []
        self.cache.tables[slot_idx] = -1
        self.cache.lengths[slot_idx] = 0

    def _paged_grow(self, active_idx: list[int], steps: int = 1) -> list[int]:
        """Allocate page-boundary pages for this window's writes (``steps``
        tokens); when the pool is dry, finish the youngest slots
        CONTEXT_FULL until the rest fit.  Returns the surviving indices."""
        from ..engine import paged_cache as pc

        survivors = sorted(active_idx, key=lambda i: self.slots[i].admitted_at)
        kept = []
        nb = self.cache.tables.shape[1]
        for i in survivors:
            slot = self.slots[i]
            will_emit = steps
            if slot.req is not None:
                will_emit = max(1, min(steps, slot.req.gen.max_new_tokens
                                       - slot.generated))
            need = min(pc.pages_needed(slot.pos + will_emit, self.page_size), nb)
            grow = need - len(slot.pages)
            if grow <= 0:
                kept.append(i)
                continue
            if grow > self.pool.free_pages:
                if slot.req is not None:
                    slot.req.out.put((None, "", True, StopReason.CONTEXT_FULL))
                slot.active = False
                slot.req = None
                slot.grammar = None
                slot.lp_pending = None
                slot.min_ban = False
                self.stats["completed"] += 1
                self.stats["evictions"] = self.stats.get("evictions", 0) + 1
                self._release_slot_pages(i)
                continue
            new = self.pool.alloc(grow)
            self._write_table(i, len(slot.pages), new)
            slot.pages.extend(new)
            kept.append(i)
        kept.sort()
        return kept

    # ------------------------------------------------------ sampling state
    def _set_slot_bias(self, slot_idx: int, bias) -> None:
        """Write one slot's logit-bias row in place (admit time and the end
        of the min phase; never shipped per step)."""
        self._send(("bias", slot_idx, tuple(bias)))
        V = self.cfg.vocab_size
        if self._bias_rows is None:
            if not bias:
                return
            self._bias_rows = torch.zeros((self.B, V), dtype=torch.float32,
                                          device=self.device)
        row = np.zeros((V,), np.float32)
        for tok, val in bias:
            if 0 <= tok < V:
                row[tok] = val
        self._bias_rows[slot_idx] = torch.from_numpy(row)
        self._bias_live[slot_idx] = bool(bias)

    def _grammar_matcher(self, gen: GenerationConfig):
        if not gen.grammar:
            return None
        if self.tokenizer is None:
            raise InferenceError("grammar decoding requires a tokenizer")
        from ..grammar import Grammar, TokenVocab, VocabMatcher

        if not hasattr(self, "_grammar_vocab"):
            self._grammar_vocab = TokenVocab.from_tokenizer(self.tokenizer)
            self._grammar_cache: dict[str, Grammar] = {}
        g = self._grammar_cache.get(gen.grammar)
        if g is None:
            g = Grammar.from_gbnf(gen.grammar)
            if len(self._grammar_cache) >= 32:
                self._grammar_cache.pop(next(iter(self._grammar_cache)))
            self._grammar_cache[gen.grammar] = g
        return VocabMatcher(g, self._grammar_vocab)

    def _min_ban_bias(self, gen: GenerationConfig) -> tuple:
        """Request bias merged with −1e30 on EOS and the stop ids (the min
        phase; the engine's ``sampler_ban``)."""
        d = dict(gen.logit_bias)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is not None:
            d[int(eos)] = -1e30
        for t in gen.stop_token_ids:
            d[int(t)] = -1e30
        return tuple(sorted(d.items()))

    def _chain(self, slot: _Slot) -> SamplerChain:
        gen = slot.req.gen
        if slot.min_ban:
            gen = gen.replace(logit_bias=self._min_ban_bias(gen), min_new_tokens=0)
        return SamplerChain(gen)

    def _grammar_row(self, slot: _Slot, lg: torch.Tensor) -> torch.Tensor | None:
        """The grammar mask on a [1, V] row (the engine's: in the min phase
        EOS does not count as a way out); None at a dead end."""
        mask = slot.grammar.allowed_mask()
        if mask.shape[0] != lg.shape[-1]:
            raise InferenceError(f"grammar mask over {mask.shape[0]} tokens, logits "
                                 f"over {lg.shape[-1]}: the tokenizer's vocab is not "
                                 "the model's")
        stoppable = mask
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if slot.min_ban and eos is not None and mask.any():
            stoppable = mask.copy()
            stoppable[eos] = False
        if not stoppable.any():
            return None
        return torch.where(torch.tensor(mask, device=lg.device)[None, :], lg, NEG_INF)

    def _host_sample(self, slot: _Slot, lg: torch.Tensor, u: torch.Tensor | None
                     ) -> int | None:
        """One token of a slot from its raw logits [1, V] as the engine
        samples it (grammar mask, Mirostat or the chain over the slot's
        history); ``u`` [1, V] the step's uniforms, or None to draw them
        from the slot's generator.  None at a grammar dead end."""
        raw = lg
        if slot.grammar is not None:
            lg = self._grammar_row(slot, lg)
            if lg is None:
                return None
        gen = slot.req.gen
        if slot.mirostat is not None:
            row = lg[0]
            if slot.min_ban:
                eos = getattr(self.tokenizer, "eos_token_id", None)
                ban = [int(t) for t in {eos, *gen.stop_token_ids}
                       if t is not None and t < row.shape[0]]
                if ban:
                    row = row.clone()
                    row[ban] = NEG_INF
            tok = (slot.mirostat.sample(row, slot.gen) if u is None
                   else slot.mirostat.sample_with_uniforms(row, u[0]))
        else:
            hist = torch.from_numpy(slot.hist[None]).to(lg.device)
            chain = self._chain(slot)
            tok = int((chain.sample(lg, hist, slot.gen) if u is None
                       else chain.sample_with_uniforms(lg, hist, u))[0])
        if slot.grammar is not None:
            slot.grammar.accept(tok)
        if self.logits_hook is not None:
            self.logits_hook(slot.req, raw[0])
        self._stash_logprobs(slot, raw, tok)
        return tok

    def _sample_first(self, slot: _Slot, lg: torch.Tensor) -> int | None:
        """The first token from the prefill logits, with the slot's
        generator and the prompt-tail history: the engine's first sample."""
        return self._host_sample(slot, lg.to(torch.float32), None)

    def _stash_logprobs(self, slot: _Slot, raw: torch.Tensor, tok: int) -> None:
        gen = slot.req.gen
        if gen.logprobs is None:
            return
        lp, top = logprob_entry(raw.reshape(-1).to(torch.float32).cpu().numpy(), tok,
                                gen.logprobs)
        piece = self.tokenizer.token_to_piece(tok) if self.tokenizer else ""
        tops = [{"token_id": i,
                 "token": self.tokenizer.token_to_piece(i) if self.tokenizer else "",
                 "logprob": l} for i, l in top]
        slot.lp_pending = {"token_id": tok, "text": piece, "logprob": lp, "top": tops}

    # ------------------------------------------------------------ results
    def _finish(self, slot_idx: int, reason: StopReason) -> None:
        """Evict a slot without a token (cancel / timeout / dead end)."""
        slot = self.slots[slot_idx]
        if slot.req is not None:
            slot.req.out.put((None, "", True, reason))
        slot.active = False
        slot.prefilling = False
        slot.pf_done = 0
        slot.grammar = None
        slot.lp_pending = None
        slot.min_ban = False
        slot.req = None
        self.stats["completed"] += 1
        self._release_slot_pages(slot_idx)
        if reason == StopReason.CANCELLED:
            self.stats["cancelled"] += 1
        elif reason == StopReason.TIMEOUT:
            self.stats["timeouts"] += 1

    def _emit(self, slot_idx: int, tok: int) -> None:
        """Record a generated token (rolling the slot's history as the
        engine does); handle stop and eviction."""
        slot = self.slots[slot_idx]
        req, stop = slot.req, slot.stop
        slot.out_ids.append(tok)
        if slot.hist.shape[0]:
            slot.hist = np.concatenate([slot.hist[1:], [tok]])
        text = self.tokenizer.token_to_piece(tok) if self.tokenizer else ""
        reason = stop.check(tok, text)
        slot.generated += 1
        self.stats["tokens_generated"] += 1
        if slot.min_ban and slot.generated >= stop.min_new_tokens:
            slot.min_ban = False
            self._set_slot_bias(slot_idx, req.gen.logit_bias)
        lp, slot.lp_pending = slot.lp_pending, None
        if req.logprobs is not None and lp is not None \
                and reason not in (StopReason.STOP_TOKEN, StopReason.EOS):
            req.logprobs.append(lp)
        if reason not in (StopReason.STOP_TOKEN, StopReason.EOS):
            req.token_times.append(time.perf_counter())
        if reason in (StopReason.STOP_TOKEN, StopReason.EOS):
            req.out.put((None, "", True, reason))
        elif reason is not None:
            req.out.put((tok, text, True, reason))
        elif slot.pos + 1 >= self.S:
            req.out.put((tok, text, True, StopReason.CONTEXT_FULL))
        else:
            req.out.put((tok, text, False, None))
            self._tokens[slot_idx] = tok
            return
        slot.active = False
        slot.grammar = None
        slot.lp_pending = None
        slot.min_ban = False
        slot.req = None
        self.stats["completed"] += 1
        self._release_slot_pages(slot_idx)

    # --------------------------------------------------------------- loop
    def _tick(self) -> bool:
        """One turn of the loop on the device loop's thread: a step, or the pause
        barrier.  False when there was nothing to do."""
        if self._stopping:
            return False
        if getattr(self, "_pause_req", False):
            if self.pipeline_depth > 1 and self._pl_inflight:
                self._pl_drain()
                self._pl_sync_host()
            self._paused_at_barrier = True
            return False
        self._paused_at_barrier = False
        worked = self._step_pipelined() if self.pipeline_depth > 1 else self._step()
        ch = self._channel
        if not worked and ch is not None and ch.primary and time.time() - ch.last_send > 5.0:
            # idle heartbeat: the followers' blocking receive never waits out
            # the transport's timeout
            self._send(("noop",))
        return worked

    def _died(self, e: BaseException) -> None:
        """The loop failed: end every request (their reason is None) and
        release the followers."""
        self.error = e
        self._fail_all()
        try:
            self._send_stop()
        except Exception:          # noqa: BLE001 — the loop is failing anyway
            pass

    def _fail_all(self) -> None:
        for s in self.slots:
            if s.req is not None:
                s.req.out.put((None, "", True, None))
                s.req = None
            s.active = s.prefilling = False
        while True:
            try:
                _, _, _, req = self.pending.get_nowait()
            except queue.Empty:
                return
            req.out.put((None, "", True, None))

    def _claim(self) -> None:
        """The calling thread drives the device from now on (claimed again
        at every step; a hand-driven scheduler's claim ends with its
        shutdown, or with the scheduler itself)."""
        if self.device.type != "cuda":
            return
        claim_device(self.device, "a ContinuousBatchingScheduler's loop")
        if self._owner is None:
            self._owner = threading.get_ident()
            if self._devloop is None:
                weakref.finalize(self, release_device, self.device, self._owner)

    def _sweep(self) -> None:
        """Cancellations and deadlines first: free slots before admitting."""
        now = time.time()
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            if s.req is not None and s.req.cancelled:
                self._finish(i, StopReason.CANCELLED)
            elif s.deadline is not None and now > s.deadline:
                self._finish(i, StopReason.TIMEOUT)

    def _slot_row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Slot i's rows of a pool step: ints (token, position, active,
        top_k, history with -1 padding) and floats (temperature, 0 when
        greedy, top_p, min_p, typical_p and the three penalties)."""
        s = self.slots[i]
        g = s.req.gen
        ints = np.full(INT_COLS + HISTORY_W, -1, np.int64)
        ints[:INT_COLS] = (self._tokens[i], s.pos, 1, g.top_k)
        ints[INT_COLS:INT_COLS + s.hist.shape[0]] = s.hist
        floats = np.array((0.0 if g.is_greedy else g.temperature, g.top_p, g.min_p,
                           g.typical_p, g.repetition_penalty, g.frequency_penalty,
                           g.presence_penalty), np.float32)
        return ints, floats

    def _step(self) -> bool:
        """One scheduler iteration: sweep cancellations / deadlines, preempt,
        admit, advance chunked prefills, run the speculative slots' verify
        and one pool dispatch.  False when there was nothing to do (the
        loop may sleep)."""
        self._claim()
        self._sweep()
        self._maybe_preempt()
        self._admit()
        chunk_worked = (self._advance_prefills()
                        if self.chunked_prefill is not None else False)
        active_idx = [i for i, s in enumerate(self.slots) if s.active]
        if self.speculative_k and active_idx:
            active_idx = self._run_spec_slots(active_idx)
            if not active_idx:
                self.stats["active_slots"] = sum(1 for s in self.slots if s.active)
                self.stats["queue_depth"] = self.pending.qsize()
                return True
        k_eff = (1 if any(self.slots[i].hostside or self.slots[i].min_ban
                          for i in active_idx) else self.decode_steps_per_dispatch)
        if self.paged and active_idx:
            active_idx = self._paged_grow(active_idx, k_eff)
        self.stats["active_slots"] = len(active_idx)
        self.stats["queue_depth"] = self.pending.qsize()
        if not active_idx:
            return chunk_worked

        ints = np.zeros((self.B, INT_COLS + HISTORY_W), np.int64)
        ints[:, INT_COLS:] = -1
        floats = np.tile(IDLE_FLOATS, (self.B, 1))
        gens: list = [None] * self.B
        use_typical = use_bias = use_sampling = False
        for i in active_idx:
            s = self.slots[i]
            g = s.req.gen
            ints[i], floats[i] = self._slot_row(i)
            use_typical |= g.typical_p < 1.0 and not g.is_greedy
            use_bias |= bool(self._bias_live[i])
            use_sampling |= not g.is_greedy or s.mirostat is not None
            gens[i] = s.gen
        seg = self._get_segment(k_eff, use_typical, use_bias, use_sampling)
        self._send(("pool", ints, floats, k_eff, use_typical, use_bias, use_sampling))
        t0, cap0 = time.perf_counter(), seg.capture_s
        toks, raw, u = seg(ints, floats, gens)
        # a first call's capture is not a step's time
        self.stats["decode_s"] += time.perf_counter() - t0 - (seg.capture_s - cap0)
        self.stats["captures"] += seg.capture_s != cap0
        self.stats["decode_steps"] += k_eff
        if k_eff > 1:
            for step in range(k_eff):
                for i in active_idx:
                    s = self.slots[i]
                    if not s.active:
                        continue      # stopped earlier in the window
                    s.pos += 1
                    self._emit(i, int(toks[step, i]))
            return True
        for i in active_idx:
            s = self.slots[i]
            tok = int(toks[0, i])
            if s.hostside:
                tok = self._host_sample(s, raw[i:i + 1],
                                        None if u is None else u[i:i + 1])
                if tok is None:
                    self._finish(i, StopReason.EOS)
                    continue
            elif self.logits_hook is not None:
                self.logits_hook(s.req, raw[i])
            s.pos += 1
            self._emit(i, tok)
        return True

    # ------------------------------------------------- speculative decode
    def _get_verify(self, Tk: int):
        """The verify of Tk tokens a slot over the whole dense pool (the
        slots not verifying masked: position S, no real token), every row's
        argmax read back; keyed on Tk, B, the cache dtype, the kernel path
        and the ``BITNET_*`` environment."""
        from ..engine.speculative import VerifyStep

        key = (Tk, self.B, str(self.cache.k.dtype), self._kp,
               tuple(sorted((k, v) for k, v in os.environ.items()
                            if k.startswith("BITNET_"))))
        v = self._verifies.get(key)
        if v is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            v = self._verifies[key] = VerifyStep(
                self.cfg, self.params, self.cache, self._kp, Tk, self.B, False,
                self.device, self._graph_pool)
        return v

    def _spec_eligible(self, slot: _Slot) -> bool:
        g = slot.req.gen
        return (g.is_greedy and not slot.hostside and not slot.min_ban
                and g.repetition_penalty == 1.0
                and g.frequency_penalty == 0.0
                and g.presence_penalty == 0.0
                and not g.logit_bias
                and slot.pos + self.speculative_k + 1 < self.S)

    def _run_spec_slots(self, active_idx: list[int]) -> list[int]:
        """Every eligible slot drafts k tokens and all verify in ONE
        dispatch; each emits its accepted drafts and the correction (or
        the bonus token when all k pass).  Returns the slots the step's
        normal dispatch must handle."""
        from ..engine.speculative import verify_input

        k = self.speculative_k
        Tk = k + 1
        spec_idx = [i for i in active_idx if self._spec_eligible(self.slots[i])]
        rest = [i for i in active_idx if i not in spec_idx]
        if not spec_idx:
            return rest
        inp = verify_input(self.B, Tk, self.S)
        drafts: dict[int, list[int]] = {}
        for i in spec_idx:
            s = self.slots[i]
            draft = self._spec_draft.propose(s.req.token_ids + s.out_ids, k)
            drafts[i] = draft
            inp[i, :Tk] = [int(self._tokens[i])] + list(draft)
            inp[i, Tk:2 * Tk] = np.arange(s.pos, s.pos + Tk)
            inp[i, 2 * Tk] = s.pos
            inp[i, 2 * Tk + 1] = Tk
        want, _ = self._get_verify(Tk)(inp)                 # [B, Tk]
        self.stats["decode_steps"] += 1
        self.stats["spec_drafted"] = self.stats.get("spec_drafted", 0) + k * len(spec_idx)
        for i in spec_idx:
            s = self.slots[i]
            draft = drafts[i]
            emitted = 0
            for j in range(k):
                if int(want[i, j]) != draft[j]:
                    break
                s.pos += 1
                emitted += 1
                self._emit(i, draft[j])
                if not s.active:
                    break
            else:
                j = k
            self.stats["spec_accepted"] = (
                self.stats.get("spec_accepted", 0) + min(emitted, k))
            if s.active and emitted == j:
                # the correction (a mismatch) or the bonus (all k accepted)
                s.pos += 1
                self._emit(i, int(want[i, j]))
            if s.active:
                self.cache.lengths[i] = s.pos
        return rest

    # ------------------------------------------------------ pipelined mode
    def _pl_rebuild_state(self) -> None:
        """(Re)write the device state from the host's slots: at first use
        and on the return from a synchronous excursion."""
        if self._pl is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._pl = PoolPipeline(self.cfg, self.params, self.cache, self._kp, self.S,
                                    self.device, self.pipeline_depth,
                                    self.decode_steps_per_dispatch, self._graph_pool)
        ints = np.zeros((self.B, INT_COLS + HISTORY_W), np.int64)
        ints[:, INT_COLS:] = -1
        floats = np.tile(IDLE_FLOATS, (self.B, 1))
        gens: list = [None] * self.B
        for i, s in enumerate(self.slots):
            live = s.active and s.req is not None
            if live:
                ints[i], floats[i] = self._slot_row(i)
                gens[i] = s.gen
            self._pl_mirror[i] = live
            self._pl_mirror_epoch[i] = s.epoch if live else -1
        self._pl.load(ints, floats, gens)
        self._pl_valid = True

    def _pl_sync_host(self) -> None:
        """Carry the device's generator states back to the slots whose
        current occupancy ran on the device (before a synchronous excursion,
        a preemption or a pause; the windows are drained).  Tokens,
        positions and histories are the host's already: every window's
        tokens were emitted."""
        if not self._pl_valid:
            return
        for i, s in enumerate(self.slots):
            if (s.active and s.req is not None and self._pl_mirror[i]
                    and self._pl_mirror_epoch[i] == s.epoch):
                s.gen.set_state(self._pl.gens[i].get_state())

    def _pl_apply_lifecycle(self) -> None:
        """Diff the slots against the device's view and write the rows that
        changed; keyed by occupancy epoch, since a slot freed and admitted
        again within one iteration never shows an idle interval."""
        for i, s in enumerate(self.slots):
            if s.active and s.req is not None and (
                    not self._pl_mirror[i] or self._pl_mirror_epoch[i] != s.epoch):
                ints, floats = self._slot_row(i)
                self._pl.admit(i, ints, floats, s.gen)
                self._pl_mirror[i] = True
                self._pl_mirror_epoch[i] = s.epoch
                # the old occupant's windows no longer speak for the slot
                self._pl_issued[i] = 0
            elif not s.active and self._pl_mirror[i]:
                self._pl.finish(i)
                self._pl_mirror[i] = False

    def _pl_live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots)
                if s.active and s.req is not None and self._pl_mirror[i]]

    def _pl_can_issue(self) -> bool:
        """Another window only if some slot has tokens to emit beyond those
        already in flight."""
        for i in self._pl_live():
            s = self.slots[i]
            if (s.req.gen.max_new_tokens - s.generated > self._pl_issued[i]
                    and s.pos + self._pl_issued[i] < self.S):
                return True
        return False

    def _pl_window_k(self) -> int:
        """The window: the pool's largest remaining budget a slot, rounded
        down to a power of two no larger than ``decode_steps_per_dispatch``
        (a full window at a cohort's tail decodes mostly finished slots)."""
        rem_max = 0
        for i in self._pl_live():
            s = self.slots[i]
            rem = s.req.gen.max_new_tokens - s.generated - self._pl_issued[i]
            rem_max = max(rem_max, min(rem, self.S - s.pos - self._pl_issued[i]))
        if rem_max <= 0:
            return 0
        k = 1
        while k * 2 <= min(self.decode_steps_per_dispatch, rem_max):
            k *= 2
        return k

    def _pl_issue(self) -> bool:
        k = self._pl_window_k()
        if k <= 0:
            return False
        live = [s.req.gen for s in self.slots if s.active and s.req is not None]
        use_typical = any(g.typical_p < 1.0 and not g.is_greedy for g in live)
        use_sampling = any(not g.is_greedy for g in live)
        use_bias = any(self._bias_live[i] for i in range(self.B) if self.slots[i].active)
        handle = self._pl.issue(k, use_typical, use_sampling,
                                self._bias_rows if use_bias else None)
        snap = [(i, self.slots[i].epoch) for i in self._pl_live()]
        for i, _ in snap:
            self._pl_issued[i] += k
        self._pl_inflight.append((handle, k, snap))
        return True

    def _pl_read_one(self) -> None:
        """Read the oldest window and emit its tokens, dropping those of
        slots that stopped or changed hands since it was issued."""
        handle, k, snap = self._pl_inflight.popleft()
        rows = self._pl.read(handle)                     # [k, B]
        for i, _ in snap:
            self._pl_issued[i] = max(0, self._pl_issued[i] - k)
        self.stats["decode_steps"] += k
        for step in range(k):
            for i, ep in snap:
                s = self.slots[i]
                if not s.active or s.req is None or s.epoch != ep:
                    continue
                s.pos += 1
                self._emit(i, int(rows[step, i]))

    def _pl_drain(self) -> None:
        while self._pl_inflight:
            self._pl_read_one()

    def _pl_hostside(self) -> bool:
        return any(s.occupied and (s.hostside or s.min_ban) for s in self.slots)

    def _step_pipelined(self) -> bool:
        """One pipelined iteration (``bitnet_tpu/serve/scheduler.py:
        2463-2528``).  False when there was nothing to do."""
        self._claim()
        self._sweep()
        # preemption snapshots the slots: drain only when it would trigger
        if not self.pending.empty() and all(s.occupied for s in self.slots):
            self._pl_drain()
            self._pl_sync_host()
            self._maybe_preempt()
        # each admission's first read waits for the windows in flight: admit
        # when the pipe is empty or enough slots are free to share the wait
        want = self.pending.qsize()
        if want:
            free = sum(1 for s in self.slots if not s.occupied)
            if (not self._pl_inflight
                    or free >= min(self.max_admissions_per_step, want)):
                self._admit()
        chunk_worked = (self._advance_prefills()
                        if self.chunked_prefill is not None else False)
        if self._pl_hostside():
            # host-side samplers and min-token phases: drain, carry the
            # state back, and take the synchronous step until they finish
            self._pl_drain()
            self._pl_sync_host()
            self._pl_valid = False
            worked = self._step()
            self.stats["pipeline_fallback_steps"] = (
                self.stats.get("pipeline_fallback_steps", 0) + 1)
            return worked or chunk_worked
        if not self._pl_valid:
            self._pl_rebuild_state()
            self._pl_issued[:] = 0
        self._pl_apply_lifecycle()
        self.stats["active_slots"] = sum(1 for s in self.slots if s.active)
        self.stats["queue_depth"] = self.pending.qsize()
        issued = False
        while len(self._pl_inflight) < self.pipeline_depth and self._pl_can_issue():
            if not self._pl_issue():
                break
            issued = True
        if self._pl_inflight and (len(self._pl_inflight) >= self.pipeline_depth
                                  or not self._pl_can_issue()):
            # a full pipe reads half its depth; a draining one one window
            full = len(self._pl_inflight) >= self.pipeline_depth
            for _ in range(max(1, self.pipeline_depth // 2) if full else 1):
                if self._pl_inflight:
                    self._pl_read_one()
            return True
        return issued or chunk_worked


_GEN_FIELDS = ("max_new_tokens", "temperature", "top_k", "top_p", "min_p",
               "repetition_penalty", "seed", "greedy", "stop_token_ids", "grammar",
               "logprobs", "min_new_tokens")


def _gen_fields(g: GenerationConfig) -> dict:
    """The sampling fields a request checkpoint keeps (the JAX file's)."""
    out = {k: getattr(g, k) for k in _GEN_FIELDS}
    out["stop_token_ids"] = list(g.stop_token_ids)
    return out


def _gen_from_fields(g: dict, max_new_tokens: int,
                     min_new_tokens: int | None = None) -> GenerationConfig:
    if min_new_tokens is None:
        min_new_tokens = int(g.get("min_new_tokens", 0))
    return GenerationConfig(
        max_new_tokens=max_new_tokens, temperature=g["temperature"], top_k=g["top_k"],
        top_p=g["top_p"], min_p=g["min_p"], repetition_penalty=g["repetition_penalty"],
        seed=g["seed"], greedy=g["greedy"],
        stop_token_ids=tuple(g.get("stop_token_ids", ())), grammar=g.get("grammar"),
        logprobs=g.get("logprobs"), min_new_tokens=min_new_tokens)
