"""Multi-step decode segments: K decode steps a host round trip.

Counterpart of ``bitnet_tpu/engine/loop.py``.  The eager decode loop
syncs with the host every token; on the card that round trip (the
Python of ~150 launches and the token's read-back) takes several times
the step's device time, so :meth:`InferenceEngine.generate_stream` decodes
in K-token SEGMENTS: sample → forward → logits K times with no host work
in between, the host then running its stop logic over the K tokens.  The
JAX package jits a ``lax.scan`` of the K bodies; on the card the same
function is one CUDA graph of the K bodies, captured once and replayed:

- the carry (logits, positions, history) and the active-slot counts live
  in static device buffers owned by the segment; a call copies its inputs
  in (a buffer passed back from the last call is not copied), replays the
  graph, and finds the K tokens and the new carry in those buffers.  The
  sampled token feeds the next forward and ``pos`` advances on the
  device; the cache is written in place (``forward_cache``);
- the sampler's uniforms come from a generator registered with the graph
  (``CUDAGraph.register_generator_state``): the request generator's state
  is copied into it before a replay and back after, so the K draws are
  those of K eager draws and the request's stream goes on from there;
- every intermediate comes from the graph's memory pool (fixed addresses
  across replays): the TMA descriptors the kernels build on the host keep
  the weights', the cache's and these buffers' addresses, so the engine
  drops a segment whose captured buffers it no longer holds;
- the kernel wrappers count their launches in Python, which a replay does
  not run: the segment records the counts its capture added, takes them
  back (a capture launches nothing) and adds them on every replay
  (``ops/registry.add_launch_counts``).

On the CPU (only when the caller asked for it, as the tests do) the same
body runs K times eagerly.  On the card a capture or a replay that fails
raises: no path runs the K steps eagerly there.  Sampling threads the
generator and the repetition history through the steps, so the tokens
equal K single steps' (``tests/test_torch_segments.py``).
"""

from __future__ import annotations

import gc
import time

import torch

from ..config import ModelConfig
import numpy as np

from ..models.bitnet import BitNetParams, forward, forward_cache, logits as model_logits
from ..ops import registry
from ..ops.decode_attention import attn_counters
from .sampling import SamplerChain, draw_uniforms, pooled_sample


def buffer_addresses(params: BitNetParams, cache) -> tuple:
    """What a captured graph holds of an engine: its weights (the
    parameters object stands for them) and its cache buffers' addresses."""
    return (id(params), cache.k.data_ptr(), cache.v.data_ptr(),
            cache.lengths.data_ptr(),
            *(t.data_ptr() for t in (cache.k_scale, cache.v_scale) if t is not None))


class DecodeSegment:
    """``segment(logits, pos, history, generator, active)`` →
    ``(tokens [B, K], logits [B, V], pos [B], history [B, W])``.

    ``logits`` [B, V] are the last step's (the first token is sampled from
    them); ``pos`` [B] int32 each slot's next position (S for an idle
    slot); ``history`` [B, W] int64 the repetition window (-1 padding);
    ``generator`` the request's ``torch.Generator`` (unused when greedy);
    ``active`` [B] int32, 1 for a live slot: an idle slot's positions are
    S (its writes drop), its length and position do not advance and its
    history does not roll.  ``tokens[:, j]`` is the j-th sampled token.
    On the card the outputs are the segment's own buffers, valid until its
    next call."""

    def __init__(self, cfg: ModelConfig, params: BitNetParams, cache,
                 kernel_path: str, sampler_chain: SamplerChain, n_steps: int,
                 max_seq_len: int, device: torch.device, pool=None):
        if n_steps < 1:
            raise ValueError(f"a segment takes n_steps >= 1, got {n_steps}")
        self.cfg, self.params, self.cache = cfg, params, cache
        self.buffers = buffer_addresses(params, cache)
        self.kernel_path = kernel_path
        self.chain = sampler_chain
        self.n_steps = n_steps
        self.S = max_seq_len
        self.device = torch.device(device)
        self.pool = pool                 # a graph pool handle to share, or None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: dict[str, int] = {}   # each replay's launches, by kernel
        self.capture_s = 0.0
        self.calls = 0                   # on the card: graph replays

    # -- the body ------------------------------------------------------------
    def _step(self, lg, pos, hist, gen, active, live):
        """One step of ``bitnet_tpu/engine/loop.py:44-58``."""
        u = (None if self.chain.config.is_greedy
             else draw_uniforms(lg.shape, gen, lg.device))
        nxt = self.chain.sample_with_uniforms(lg, hist, u)            # [B] int32
        positions = torch.where(live, pos, self.S)[:, None]   # idle: writes drop
        h, _ = forward_cache(self.cfg, self.params, nxt[:, None], positions,
                             self.cache, active, self.kernel_path)
        lg = model_logits(self.cfg, self.params, h, self.kernel_path)[:, -1]
        if hist.shape[1] > 0:
            rolled = torch.cat([hist[:, 1:], nxt[:, None].to(hist.dtype)], dim=1)
            hist = torch.where(live[:, None], rolled, hist)
        return lg, pos + active, hist, nxt

    def _eager(self, logits, pos, history, generator, active):
        live = active > 0
        toks = []
        for _ in range(self.n_steps):
            logits, pos, history, nxt = self._step(logits, pos, history, generator,
                                                   active, live)
            toks.append(nxt)
        return torch.stack(toks, dim=1), logits, pos, history

    # -- the graph -----------------------------------------------------------
    def _capture(self, logits: torch.Tensor, history: torch.Tensor) -> None:
        """Capture the K bodies over fresh static buffers shaped like the
        first call's inputs."""
        dev, B = logits.device, logits.shape[0]
        greedy = self.chain.config.is_greedy
        # what a capture cannot do: zero the attention's arrival counters
        # (the first call on a device) and copy the bias lists to the card
        attn_counters(self.device)
        self.chain.prepare(logits.shape[-1], dev)
        self._lg = torch.empty_like(logits)
        self._pos = torch.empty((B,), dtype=torch.int32, device=dev)
        self._hist = torch.empty_like(history)
        self._active = torch.empty((B,), dtype=torch.int32, device=dev)
        self._tok = torch.empty((B, self.n_steps), dtype=torch.int32, device=dev)
        self._gen = None if greedy else torch.Generator(device=dev)

        def body():
            lg, pos, hist = self._lg, self._pos, self._hist
            live = self._active > 0
            for j in range(self.n_steps):
                lg, pos, hist, nxt = self._step(lg, pos, hist, self._gen,
                                                self._active, live)
                self._tok[:, j].copy_(nxt)
            self._lg.copy_(lg)
            self._pos.copy_(pos)
            self._hist.copy_(hist)
        self.graph, self.launches, self.capture_s = capture_graph(
            body, () if self._gen is None else (self._gen,), self.pool)

    def _replay(self, logits, pos, history, generator, active):
        if self.graph is None:
            self._capture(logits, history)
        for dst, src in ((self._lg, logits), (self._pos, pos), (self._hist, history),
                         (self._active, active)):
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        if self._gen is not None:
            self._gen.set_state(generator.get_state())
        self.graph.replay()
        if self._gen is not None:
            generator.set_state(self._gen.get_state())
        registry.add_launch_counts(self.launches)
        return self._tok, self._lg, self._pos, self._hist

    def __call__(self, logits: torch.Tensor, pos: torch.Tensor,
                 history: torch.Tensor, generator: torch.Generator | None,
                 active: torch.Tensor):
        self.calls += 1
        with torch.inference_mode():
            if self.device.type == "cpu":
                return self._eager(logits, pos.to(torch.int32), history, generator,
                                   active.to(torch.int32))
            return self._replay(logits, pos, history, generator, active)


def capture_graph(body, generators=(), pool=None):
    """Capture ``body()`` into one ``torch.cuda.CUDAGraph`` (in the memory
    pool ``pool``, with ``generators`` registered) and return (graph, the
    launch counts its capture added, capture seconds).  The capture
    launched nothing, so its wrappers' counts are taken back; a replay's
    owner adds them (``registry.add_launch_counts``).  A failed capture
    raises, with the counts taken back.

    The cyclic garbage collector is off during the capture: an object it
    frees there (pinned host memory that a copy used, say) records events
    on the caller's stream, which invalidates the capture."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = registry.launch_counts()
    collecting = gc.isenabled()
    gc.disable()
    try:
        # torch.cuda.graph synchronizes the device, then captures on its own
        # side stream; a replay runs on the caller's stream, after the input
        # copies and before the read-back, as eager steps do
        with torch.cuda.graph(graph, pool=pool):
            body()
    finally:
        if collecting:
            gc.enable()
        after = registry.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        registry.add_launch_counts(delta, times=-1)
    return graph, delta, time.perf_counter() - t0


# the pooled repetition history's width (``bitnet_tpu/serve/scheduler.py:63``)
HISTORY_W = 64
# the per-slot integer columns: token, position, active, top_k, then history
INT_COLS = 4
# the per-slot float columns: temperature (0 greedy), top_p, min_p,
# typical_p, repetition, frequency and presence penalties
FLOAT_COLS = 7


class PoolSegment:
    """K decode steps of a scheduler's pool in one host round trip: the
    JAX scheduler's ``decode_step`` (K=1) and ``decode_multi`` (``:465``,
    ``:499``), dense or paged (``:647``, ``:670``).  Each step is forward →
    head → :func:`~.sampling.pooled_sample` with every sampling parameter a
    per-slot column, the repetition history rolled and the next token fed
    where a slot is live.

    ``segment(ints, floats, generators)``: ``ints`` [B, INT_COLS +
    HISTORY_W] int64 host array (token, position, active, top_k, history
    with -1 padding), ``floats`` [B, FLOAT_COLS] f32, ``generators`` B
    ``torch.Generator`` or None (slot b's uniforms [1, V] a step, as the
    engine at B=1 draws them; unused without ``use_sampling``).  Returns
    (tokens [K, B] host int64, the last step's raw logits [B, V] and
    uniforms [B, V] or None, on the device).  An idle slot rides at
    position S (dense: the view length when paged), attends over
    nothing new and neither its position nor its length advances.

    On the card the K bodies are one CUDA graph (:func:`capture_graph`),
    captured at the first call over static input buffers that a call
    copies into: slot b's generator state is copied into a generator
    registered with the graph before a replay and back after; the bias
    rows, the cache and (paged) the block table are the scheduler's own
    buffers, written in place between replays.  On the CPU, and with
    ``eager`` (a live mesh's collectives), the same body runs eagerly on
    the slots' own generators."""

    def __init__(self, cfg: ModelConfig, params: BitNetParams, cache, kernel_path: str,
                 n_steps: int, max_seq_len: int, device, pool=None, paged: bool = False,
                 use_typical: bool = False, use_sampling: bool = False,
                 bias_rows: torch.Tensor | None = None, eager: bool = False):
        self.cfg, self.params, self.cache = cfg, params, cache
        # on the card too the body runs eagerly (a live mesh: a CUDA graph
        # cannot hold a host-staged collective)
        self.eager = eager or torch.device(device).type == "cpu"
        self.kernel_path, self.n_steps = kernel_path, n_steps
        self.paged = paged
        self.S = cache.view_len if paged else max_seq_len
        self.device = torch.device(device)
        self.pool = pool
        self.use_typical, self.use_sampling = use_typical, use_sampling
        self.bias_rows = bias_rows
        self.graph = None
        self.launches: dict[str, int] = {}
        self.capture_s = 0.0
        self.calls = 0

    def _draw(self, gens, B, V, dev):
        return torch.cat([draw_uniforms((1, V), g, dev) if g is not None
                          else torch.ones((1, V), device=dev) for g in gens[:B]])

    def _body(self, ints, fl, gens):
        """The K steps over device inputs; returns (tokens [K, B], raw, u)."""
        cfg, params, cache, kp = self.cfg, self.params, self.cache, self.kernel_path
        tok = ints[:, 0].to(torch.int32)
        pos = ints[:, 1].to(torch.int32)
        act = ints[:, 2].to(torch.int32)
        top_k = ints[:, 3]
        hist = ints[:, INT_COLS:]
        live = act > 0
        toks, raw, u = [], None, None
        for _ in range(self.n_steps):
            pos_in = torch.where(live, pos, self.S)[:, None]
            if self.paged:
                from .paged_cache import paged_forward
                h, _ = paged_forward(cfg, params, tok[:, None], pos_in, cache, act, kp)
            else:
                h, _, _ = forward(cfg, params, tok[:, None], pos_in, cache.k, cache.v,
                                  torch.where(live, pos, 0), 1, kp, cache.k_scale,
                                  cache.v_scale)
                cache.lengths += (act if params.mesh is None else
                                  params.mesh.data_rows(act, cache.lengths.shape[0]))
            raw = model_logits(cfg, params, h, kp)[:, -1].to(torch.float32)
            u = (self._draw(gens, raw.shape[0], raw.shape[1], raw.device)
                 if self.use_sampling else None)
            nxt = pooled_sample(raw, fl[:, 0], top_k, fl[:, 1], fl[:, 2], fl[:, 3],
                                fl[:, 4], fl[:, 5], fl[:, 6], self.bias_rows, hist, u,
                                self.use_typical)
            hist = torch.where(live[:, None],
                               torch.cat([hist[:, 1:], nxt[:, None].to(hist.dtype)], 1),
                               hist)
            pos = pos + act
            tok = torch.where(live, nxt, tok)
            toks.append(nxt)
        # the carry back into the inputs: a pipelined window's next window
        # reads it there (a synchronous call's inputs are copied in anew)
        ints[:, 0].copy_(tok)
        ints[:, 1].copy_(pos)
        ints[:, INT_COLS:].copy_(hist)
        return torch.stack(toks), raw, u

    def _capture(self, B: int, V: int, state=None) -> None:
        """Capture the K steps over static inputs: fresh buffers, or the
        (ints, floats, generators) of a pipeline's device-resident state."""
        dev = self.device
        attn_counters(dev)
        if state is None:
            self._ints = torch.empty((B, INT_COLS + HISTORY_W), dtype=torch.int64,
                                     device=dev)
            self._fl = torch.empty((B, FLOAT_COLS), dtype=torch.float32, device=dev)
            gens = [torch.Generator(device=dev) for _ in range(B)]
        else:
            self._ints, self._fl, gens = state
        self._gens = gens if self.use_sampling else []
        self._out: tuple = ()

        def body():
            self._out = self._body(self._ints, self._fl, self._gens)
        self.graph, self.launches, self.capture_s = capture_graph(body, self._gens,
                                                                  self.pool)

    def __call__(self, ints, floats, generators):
        self.calls += 1
        with torch.inference_mode():
            if self.eager:
                toks, raw, u = self._body(torch.from_numpy(ints).to(self.device),
                                          torch.from_numpy(floats).to(self.device),
                                          generators)
                return toks.cpu().numpy().astype(np.int64), raw, u
            B = ints.shape[0]
            if self.graph is None:
                self._capture(B, self.cfg.vocab_size)
            self._ints.copy_(torch.from_numpy(ints))
            self._fl.copy_(torch.from_numpy(floats))
            live = [b for b in range(B) if self.use_sampling and ints[b, 2]
                    and generators[b] is not None]
            for b in live:
                self._gens[b].set_state(generators[b].get_state())
            self.graph.replay()
            for b in live:
                generators[b].set_state(self._gens[b].get_state())
            registry.add_launch_counts(self.launches)
            toks, raw, u = self._out
            return toks.cpu().numpy().astype(np.int64), raw, u

    def launch(self, ints: torch.Tensor, floats: torch.Tensor, generators: list):
        """One window over a pipeline's device-resident state (written
        back in place): on the card a replay of the graph captured over
        that state (no copy in, nothing read), on the CPU the eager body.
        Returns the window's tokens [K, B] int32 on the device."""
        self.calls += 1
        with torch.inference_mode():
            if self.device.type == "cpu":
                return self._body(ints, floats, generators)[0]
            if self.graph is None:
                self._capture(ints.shape[0], self.cfg.vocab_size,
                              (ints, floats, generators))
            self.graph.replay()
            registry.add_launch_counts(self.launches)
            return self._out[0]


class PoolPipeline:
    """Issue-ahead K-step windows of a dense pool: the JAX scheduler's
    pipelined mode (``pipeline_depth > 1``, ``bitnet_tpu/serve/scheduler.py:
    556-645``, ``:2265-2528``).

    The decode state lives on the device: ``ints`` [B, INT_COLS +
    HISTORY_W] (token, position, active, top_k, history), ``floats``
    [B, FLOAT_COLS] and B generators.  A window (:meth:`issue`) is a
    :class:`PoolSegment` of k steps whose graph reads that state and writes
    the next tokens, positions and history back into it, so windows chain
    with no host work in between; its k tokens go to one of ``depth``
    pinned host buffers (a ring: at most ``depth`` windows are in flight)
    by a copy behind a CUDA event, and :meth:`read` waits for that event
    alone.  The host writes the state only when a slot is admitted
    (:meth:`admit`: its row from pinned memory, its generator's state into
    the state's generator) or finishes (:meth:`finish`), and after a
    synchronous excursion (:meth:`load`).  Everything runs on the caller's
    one stream: the decode attention's arrival counters are one buffer a
    device.  On the CPU a window runs at :meth:`issue` and :meth:`read`
    returns its tokens."""

    def __init__(self, cfg: ModelConfig, params: BitNetParams, cache, kernel_path: str,
                 max_seq_len: int, device, depth: int, max_steps: int, pool=None):
        dev = self.device = torch.device(device)
        B = cache.k.shape[1]
        self.depth = depth
        self.ints = torch.zeros((B, INT_COLS + HISTORY_W), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((B, FLOAT_COLS), dtype=torch.float32, device=dev)
        self.gens = [torch.Generator(device=dev) for _ in range(B)]
        self._make = (cfg, params, cache, kernel_path, max_seq_len, pool)
        self.segments: dict = {}
        self._ring = ([torch.empty((max_steps, B), dtype=torch.int32, pin_memory=True)
                       for _ in range(depth)] if dev.type == "cuda" else [])
        self._issued = 0

    def _to_device(self, dst: torch.Tensor, host: np.ndarray) -> None:
        """An asynchronous copy from pinned memory (a pageable copy would
        wait for the windows in flight)."""
        src = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type == "cuda":
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def load(self, ints: np.ndarray, floats: np.ndarray, generators: list) -> None:
        """The whole state from the host (its first use, and the return
        from a synchronous excursion)."""
        self._to_device(self.ints, ints)
        self._to_device(self.floats, floats)
        for b, g in enumerate(generators):
            if g is not None:
                self.gens[b].set_state(g.get_state())

    def admit(self, b: int, ints_row: np.ndarray, floats_row: np.ndarray,
              generator) -> None:
        self._to_device(self.ints[b], ints_row)
        self._to_device(self.floats[b], floats_row)
        if generator is not None:
            self.gens[b].set_state(generator.get_state())

    def finish(self, b: int) -> None:
        self.ints[b, 2] = 0

    def issue(self, k: int, use_typical: bool, use_sampling: bool,
              bias_rows: torch.Tensor | None):
        """Launch one k-step window; returns a handle for :meth:`read`."""
        key = (k, use_typical, use_sampling, bias_rows is not None)
        seg = self.segments.get(key)
        if seg is None:
            cfg, params, cache, kp, S, pool = self._make
            seg = self.segments[key] = PoolSegment(
                cfg, params, cache, kp, k, S, self.device, pool,
                use_typical=use_typical, use_sampling=use_sampling,
                bias_rows=bias_rows)
        toks = seg.launch(self.ints, self.floats, self.gens)
        if self.device.type == "cpu":
            return toks.numpy().astype(np.int64)
        host = self._ring[self._issued % self.depth][:k]
        self._issued += 1
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def read(self, handle) -> np.ndarray:
        """A window's tokens [k, B] int64 on the host."""
        if isinstance(handle, np.ndarray):
            return handle
        host, ev = handle
        ev.synchronize()
        return host.numpy().astype(np.int64)


def build_decode_segment(cfg: ModelConfig, params: BitNetParams, cache,
                         kernel_path: str, sampler_chain: SamplerChain,
                         n_steps: int, max_seq_len: int,
                         device: torch.device | str, pool=None) -> DecodeSegment:
    """A K-step decode segment over ``cache`` (written in place); on the
    card it is captured at its first call."""
    return DecodeSegment(cfg, params, cache, kernel_path, sampler_chain, n_steps,
                         max_seq_len, device, pool)
