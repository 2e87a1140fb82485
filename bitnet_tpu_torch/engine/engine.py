"""InferenceEngine: bucketed prefill, then streamed decode, on one device;
or one prefill over a pool of prompts, then lockstep decode.

Counterpart of ``bitnet_tpu/engine/engine.py``: token-id or text prompts
(through the engine's tokenizer), ``prefill_buckets`` padding (padded
positions carry S, so their cache writes drop), the full ``SamplerChain``
with a seeded ``torch.Generator``, stop ids / EOS / stop sequences /
max tokens, the ``min_new_tokens`` EOS ban, keep-half context shift (or,
under ``context_overflow='stop'``, a stop with ``CONTEXT_FULL``), logprobs,
``generate_batch`` over up to ``max_batch_size`` prompts, ``eval_ids``
(per-position logits of one prefill: the crossval entry point), a
``kernel_recorder`` naming the path and the kernels that ran, and the last
``generate`` request kept for replay from a receipt, and the per-request
state of ``:188-300``, ``:374-538``, ``:587-690`` and ``:989-1009``: a
prompt-prefix cache (``prefix_cache_tokens``: the longest stored prefix is
copied back into slot 0 from its host snapshot and only the suffix runs),
``generate_stream(resume=True)`` / ``generate_from_state`` after a
checkpoint restore, grammar-constrained decoding (a host mask a step) and
Mirostat, and ``embed_ids``.
``kernel_path='auto'`` resolves against the device: ``w2a8`` on the card,
``xla`` on the CPU.  ``generate_stream`` decodes in K-step segments
(``engine/loop.py``, ``:302-322``, ``:621-650``, ``:723-741``): one CUDA
graph of K sample → forward → logits steps a host round trip on the card
(``decode_steps_per_dispatch``, auto 8 there and 1 on the CPU), the host
replaying its stop logic over the K tokens; Mirostat, a grammar, logprobs,
the ``min_new_tokens`` phase and the last tokens before ``max_new_tokens``
or the context's end take the eager single step.  ``sliding_window=W``
(``:151-168``, ``:448-488``) runs the engine over the windowed ring cache
(``engine/windowed_cache.py``): prefill buckets stop at W, a longer
prompt runs in chunks of at most W, every step is the eager single step
(no segment: its graph would write ring rows the positions array does
not record), and checkpoint capture and resume are refused.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Iterator

import numpy as np
import torch

from ..config import (EngineConfig, GenerationConfig, ModelConfig,
                      resolve_kernel_path)
from ..device_probe import resolve_device
from ..errors import ConfigError, InferenceError
from ..models.bitnet import (
    BitNetParams,
    decode_attn_plan,
    forward_cache,
    fuse_block_params,
    kv_dtype_name,
    logits as model_logits,
    quantize_head,
    stacked_decode_ok,
    with_col_scales_params,
)
from ..ops import registry
from ..quant.tl import quantize_params_tl
from .cache import allocate_cache, reset_cache
from .windowed_cache import (allocate_windowed_cache, forward_windowed,
                             reset_windowed_cache)
from .prefix_cache import PrefixCache, as_tensor, snapshot_from_cache
from .sampling import NEG_INF, MirostatState, SamplerChain, logprob_entry
from .stop import StopCriteria, StopReason


@dataclasses.dataclass
class TokenEvent:
    """One streamed token."""

    token_id: int
    text: str
    index: int
    logprob: float | None = None
    top_logprobs: list[tuple[int, float]] | None = None


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    stop_reason: StopReason
    prompt_tokens: int
    metrics: dict
    # acceptance stats when produced by engine.speculative (else None)
    spec_stats: dict | None = None
    # per emitted token: {"token_id", "text", "logprob", "top"} when
    # GenerationConfig.logprobs is set
    logprobs: list[dict] | None = None


@dataclasses.dataclass
class PerformanceMetrics:
    """tok/s, TTFT and the timing breakdown (host clock around work that
    ends in a device synchronize)."""

    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    ttft_s: float = 0.0
    decode_steps: int = 0
    device: str = ""

    @property
    def decode_tok_s(self) -> float:
        return self.generated_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prompt_tokens / self.prefill_s if self.prefill_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4),
            "ttft_s": round(self.ttft_s, 4),
            "decode_tok_s": round(self.decode_tok_s, 2),
            "prefill_tok_s": round(self.prefill_tok_s, 2),
            "decode_steps": self.decode_steps,
            "device": self.device,
        }


def prefill_buckets(max_seq_len: int, smallest: int = 8) -> list[int]:
    out, b = [], smallest
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return out


def prepare_params(params: BitNetParams, ec: EngineConfig, device: torch.device,
                   kernel_path: str) -> tuple[BitNetParams, bool]:
    """The weights as an engine (or a scheduler) runs them on ``device``:
    the embedding in the compute dtype (the activations' dtype: its rows
    feed the residual stream), TL re-quantization, fused projections, the
    kernels' column scales and, for ``logits_dtype='int8'`` on ``w2a8``, the
    int8 head.  Returns (params, whether fusing the projections fell
    back)."""
    params = params.to(device)
    act = torch.float32 if ec.compute_dtype == "f32" else torch.bfloat16
    if params.embed.dtype != act:
        params = dataclasses.replace(params, embed=params.embed.to(act))
    if ec.weight_quant in ("tl1", "tl2"):
        # runtime TL re-quantization on the device, before fusion
        # (``bitnet_tpu/engine/engine.py:119-128``)
        params = quantize_params_tl(params, ec.weight_quant)
    fuse_fell_back = False
    blocks = params.blocks
    if ec.fuse_projections and blocks.wqkv is None:
        blocks = fuse_block_params(blocks)
        fuse_fell_back = blocks.wqkv is None
    params = with_col_scales_params(dataclasses.replace(params, blocks=blocks))
    if ec.logits_dtype == "int8" and kernel_path == "w2a8":
        params = quantize_head(params)
    return params, fuse_fell_back


class InferenceEngine:
    """Engine over a flat ``[L, B, S, KV*D]`` cache of ``max_batch_size``
    slots (bf16, int8 or fp8-e4m3): one sequence in slot 0
    (``generate``), or a pool of up to B prompts in lockstep
    (``generate_batch``)."""

    def __init__(self, cfg: ModelConfig, params: BitNetParams,
                 engine_cfg: EngineConfig | None = None, tokenizer=None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = ec = engine_cfg or EngineConfig()
        self.tokenizer = tokenizer
        cfg.validate()
        if ec.max_seq_len > cfg.max_seq_len:
            raise ConfigError(
                f"engine max_seq_len {ec.max_seq_len} exceeds model context "
                f"{cfg.max_seq_len}")
        self.kernel_path = resolve_kernel_path(ec.kernel_path, self.device)
        params, fuse_fell_back = prepare_params(params, ec, self.device,
                                                self.kernel_path)
        self.params = params
        self.kv_dtype = ec.resolve_kv_cache_dtype()
        self.windowed = ec.sliding_window > 0
        if self.windowed:
            self.cache = allocate_windowed_cache(cfg, ec.max_batch_size,
                                                 ec.sliding_window, self.kv_dtype,
                                                 device=self.device)
        else:
            self.cache = allocate_cache(cfg, ec.max_batch_size, ec.max_seq_len,
                                        self.kv_dtype, device=self.device)
        # a windowed engine's prefills stop at the ring's width (two tokens
        # a window apart may not meet on one ring row in one call)
        self._buckets = prefill_buckets(min(ec.sliding_window, ec.max_seq_len)
                                        if self.windowed else ec.max_seq_len)
        self.load_report = None
        self.kernel_recorder: list[str] = []
        if ec.weight_quant in ("tl1", "tl2"):
            self.kernel_recorder.append(f"weight_quant_{ec.weight_quant}")
        blk = params.blocks.wqkv
        if (blk is not None and blk.kind in ("tl", "bitnet32")
                and self.kernel_path == "w2a8" and blk.k % 256 == 0
                and os.environ.get("BITNET_TL_W2A8", "1") == "1"):
            # the JAX engine's receipt (``engine.py:174-183``)
            self.kernel_recorder.append("ternary_matmul_tl_w2a8_stacked")
        if fuse_fell_back:
            self.kernel_recorder.append("fuse_projections_fallback")
        self.last_metrics = PerformanceMetrics()
        self._last_stop_reason = StopReason.MAX_TOKENS
        self._last_request: dict | None = None    # generate's, for replay
        self.prefix_cache = (PrefixCache(ec.prefix_cache_tokens)
                             if ec.prefix_cache_tokens > 0 else None)
        # K-step decode segments by sampler, K and kernel knobs (LRU); on
        # the card their graphs share one memory pool
        self._segments: collections.OrderedDict = collections.OrderedDict()
        self._graph_pool = None
        self.mesh = None                  # shard_to_mesh's

    @classmethod
    def from_gguf(cls, path: str, engine_cfg: EngineConfig | None = None,
                  tokenizer=None, device: str | torch.device = "cuda",
                  mode: str = "auto") -> "InferenceEngine":
        """Load a GGUF, a SafeTensors file or an HF checkpoint directory
        (``models/loader.load_model``, ``mode`` ``auto`` or ``dense``) and
        build the engine on it; ``eng.load_report`` keeps the load's report
        (``bitnet_tpu/engine/engine.py:1033-1052``)."""
        from ..models.loader import load_model
        from ..tokenizer import load_tokenizer

        engine_cfg = engine_cfg or EngineConfig()
        dev = resolve_device(device)
        cfg, params, report = load_model(path, mode=mode, param_dtype=(
            torch.float32 if engine_cfg.compute_dtype == "f32" else torch.bfloat16),
            device=dev)
        if engine_cfg.max_seq_len > cfg.max_seq_len:
            engine_cfg = engine_cfg.replace(max_seq_len=cfg.max_seq_len)
        if tokenizer is None:
            tokenizer = load_tokenizer(path)
        eng = cls(cfg, params, engine_cfg, tokenizer, device=dev)
        eng.load_report = report
        return eng

    # -- helpers -------------------------------------------------------------
    def _bucket(self, T: int) -> int:
        for b in self._buckets:
            if T <= b:
                return b
        raise InferenceError(
            f"prompt of {T} tokens exceeds max_seq_len {self.engine_cfg.max_seq_len}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _record_kernels(self, before: dict[str, int]) -> None:
        for kid, n in registry.launch_counts().items():
            if n > before.get(kid, 0):
                self.kernel_recorder.append(f"kernel_{kid}_x{n - before[kid]}")

    def stacked_decode(self) -> bool:
        """Whether decode steps take the fused stacked loop (slice 1); a
        windowed engine's never do."""
        return not self.windowed and stacked_decode_ok(
            self.cfg, self.params, 1, self.engine_cfg.max_batch_size,
            self.kernel_path)

    def _forward(self, tokens: torch.Tensor, positions: torch.Tensor,
                 n_real, trace=None) -> torch.Tensor:
        """One forward call over the engine's cache, dense or ring
        (positions of S are padding: their writes drop); returns the
        final-normed hidden [B, T, H]."""
        if self.windowed:
            h, self.cache = forward_windowed(
                self.cfg, self.params, tokens, positions, self.cache, n_real,
                self.kernel_path, pad_marker=self.engine_cfg.max_seq_len)
            return h
        h, self.cache = forward_cache(self.cfg, self.params, tokens, positions,
                                      self.cache, n_real, self.kernel_path, trace)
        return h

    def _reset(self) -> None:
        if self.windowed:
            reset_windowed_cache(self.cache)
        else:
            reset_cache(self.cache)

    def decode_plan(self) -> str:
        """The decode-attention plan of this engine's pool and cache, under
        the environment's kernel-selection knobs: the name the JAX engine
        records (``bitnet_tpu/engine/engine.py:746-774``)."""
        return decode_attn_plan(self.engine_cfg.max_batch_size,
                                kv_dtype_name(self.cache.k.dtype))

    # -- K-step segments -------------------------------------------------------
    MAX_SEGMENTS = 16

    def _segment_steps(self) -> int:
        """Decode steps a host round trip: ``decode_steps_per_dispatch``, or
        for 0 (auto) 8 on the card and 1 elsewhere (the JAX rule,
        ``bitnet_tpu/engine/engine.py:302-306``, with the card as the
        accelerator)."""
        k = self.engine_cfg.decode_steps_per_dispatch
        if self.mesh is not None and self.mesh.live:
            return 1        # a CUDA graph cannot hold a host-staged collective
        if k == 0:
            return 8 if self.device.type == "cuda" else 1
        return k

    def warmup(self, token_ids: list[int], gen_cfg: GenerationConfig) -> None:
        """One throwaway request of one K-step segment's tokens (at least 2)
        under ``gen_cfg``, so that the segment's CUDA-graph capture, the
        port's compile, falls outside the requests timed after it."""
        n = max(2, self._segment_steps())
        for _ in self.generate_stream(token_ids, gen_cfg.replace(max_new_tokens=n)):
            pass

    def _get_segment(self, gen_cfg: GenerationConfig, n_steps: int):
        """The K-step segment (``engine/loop.py``) keyed as the JAX engine
        keys it (K and every sampler field, ``:308-322``), plus the
        repetition window (its shape) and the kernel-selection knobs (the
        plan a graph captured).  Segments whose graphs hold buffers the
        engine no longer holds (a replaced cache or weights) are dropped
        first."""
        from .loop import buffer_addresses, build_decode_segment

        key = ("seg", n_steps, gen_cfg.temperature, gen_cfg.top_k,
               gen_cfg.top_p, gen_cfg.min_p, gen_cfg.typical_p,
               gen_cfg.repetition_penalty, gen_cfg.frequency_penalty,
               gen_cfg.presence_penalty, gen_cfg.logit_bias, gen_cfg.is_greedy,
               gen_cfg.repetition_window,
               tuple(sorted((k, v) for k, v in os.environ.items()
                            if k.startswith("BITNET_"))))
        if (self._segments and next(iter(self._segments.values())).buffers
                != buffer_addresses(self.params, self.cache)):
            self._segments.clear()
        seg = self._segments.get(key)
        if seg is None:
            if self.device.type == "cuda" and self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            seg = build_decode_segment(
                self.cfg, self.params, self.cache, self.kernel_path,
                SamplerChain(gen_cfg), n_steps, self.engine_cfg.max_seq_len,
                self.device, self._graph_pool)
            self._segments[key] = seg
            while len(self._segments) > self.MAX_SEGMENTS:
                self._segments.popitem(last=False)
        self._segments.move_to_end(key)
        return seg

    # -- steps ---------------------------------------------------------------
    def _check_prompt(self, T: int) -> None:
        if T == 0:
            raise InferenceError("empty prompt")
        S = self.engine_cfg.max_seq_len
        if T > S:
            raise InferenceError(f"prompt {T} tokens > max_seq_len {S}")

    def _restore_prefix(self, snap, m: int) -> None:
        """Copy ``snap``'s first m rows (canonical ``[L, m, KV, D]``, and a
        1-byte cache's ``[L, m, KV]`` scales) into slot 0 and set
        ``lengths[0] = m`` (``bitnet_tpu/engine/engine.py:374-397``): one
        host-to-device copy a buffer, cast to the cache's dtype."""
        c = self.cache
        L = c.k.shape[0]
        for dst, src in ((c.k, snap.k), (c.v, snap.v)):
            dst[:, 0, :m] = as_tensor(src)[:, :m].reshape(L, m, -1).to(
                self.device, dst.dtype)
        if c.k_scale is not None:
            for dst, src in ((c.k_scale, snap.k_scale), (c.v_scale, snap.v_scale)):
                dst[:, 0, :m] = as_tensor(src)[:, :m].to(self.device, dst.dtype)
        c.lengths[0] = m

    def _prefill_slot0(self, token_ids: list[int], trace=None, snap=None,
                       m: int = 0) -> tuple[torch.Tensor, int]:
        """Reset the cache, restore ``snap``'s first m rows when given, and
        run the rest of the prompt (positions m…T-1) in slot 0 as one
        bucketed prefill; returns (final-normed hidden [B, Tp, H], Tp),
        the suffix's last token at row T-m-1.  Call under
        ``torch.inference_mode``."""
        T = len(token_ids)
        self._check_prompt(T)
        S = self.engine_cfg.max_seq_len
        self._reset()
        if m > 0:
            self._restore_prefix(snap, m)
            self.kernel_recorder.append(f"prefix_restore_m{m}")
        B = self.engine_cfg.max_batch_size
        Ts = T - m
        Tp = self._bucket(Ts)
        toks = np.zeros((B, Tp), np.int32)
        toks[0, :Ts] = token_ids[m:]
        pos = np.full((B, Tp), S, np.int32)      # padding → dropped writes
        pos[0, :Ts] = np.arange(m, T)
        n_real = np.zeros((B,), np.int32)
        n_real[0] = Ts
        dev = self.device
        h = self._forward(torch.from_numpy(toks).to(dev), torch.from_numpy(pos).to(dev),
                          torch.from_numpy(n_real).to(dev), trace)
        return h, Tp

    def _prefill_windowed(self, token_ids: list[int]) -> torch.Tensor:
        """The ring's prefill (``bitnet_tpu/engine/engine.py:448-488``):
        reset, then the prompt in chunks of at most the largest bucket (W),
        each a bucketed call in slot 0; the last chunk's last-token logits
        [B, V].  Only the trailing W positions stay resident."""
        self._reset()
        T = len(token_ids)
        S = self.engine_cfg.max_seq_len
        B = self.engine_cfg.max_batch_size
        cap = self._buckets[-1]
        dev = self.device
        done = n_chunks = 0
        with torch.inference_mode():
            while done < T:
                piece = token_ids[done:done + cap]
                Ts = len(piece)
                Tp = self._bucket(Ts)
                toks = np.zeros((B, Tp), np.int32)
                toks[0, :Ts] = piece
                pos = np.full((B, Tp), S, np.int32)      # padding → dropped
                pos[0, :Ts] = np.arange(done, done + Ts)
                n_real = np.zeros((B,), np.int32)
                n_real[0] = Ts
                h = self._forward(torch.from_numpy(toks).to(dev),
                                  torch.from_numpy(pos).to(dev),
                                  torch.from_numpy(n_real).to(dev))
                done += Ts
                n_chunks += 1
            lg = model_logits(self.cfg, self.params, h[:, Ts - 1:Ts],
                              self.kernel_path)[:, 0]
        self.kernel_recorder.append(
            f"prefill_windowed_{self.kernel_path}_W{self.engine_cfg.sliding_window}"
            f"_chunks{n_chunks}")
        return lg

    def prefill(self, token_ids: list[int]) -> torch.Tensor:
        """Reset the cache and run the prompt; returns last-token logits
        [B, V].  With a prefix cache the longest stored prefix (at most
        T-1 tokens: one always runs, for its logits) is restored from its
        host snapshot, only the suffix runs, and the whole prompt's rows
        are stored (``bitnet_tpu/engine/engine.py:399-446``)."""
        T = len(token_ids)
        self._check_prompt(T)
        if self.windowed:
            return self._prefill_windowed(token_ids)
        m, snap = 0, None
        if self.prefix_cache is not None:
            m, snap = self.prefix_cache.lookup(token_ids)
            m = min(m, T - 1)
        with torch.inference_mode():
            h, Tp = self._prefill_slot0(token_ids, snap=snap, m=m)
            lg = model_logits(self.cfg, self.params, h[:, T - m - 1:T - m],
                              self.kernel_path)[:, 0]
        self.kernel_recorder.append(f"prefill_{self.kernel_path}_T{Tp}")
        if self.prefix_cache is not None:
            self.prefix_cache.insert(list(token_ids), snapshot_from_cache(
                self.cache, T, kv_heads=self.cfg.num_kv_heads))
        return lg

    def embed_ids(self, token_ids: list[int]) -> np.ndarray:
        """Final-normed hidden states of the sequence, [T, H] float32 on
        the host, from one cold bucketed prefill of slot 0
        (``bitnet_tpu/engine/engine.py:989-1009``)."""
        T = len(token_ids)
        with torch.inference_mode():
            h, _Tp = self._prefill_slot0(token_ids)
            return h[0, :T].to(torch.float32).cpu().numpy()

    # -- cross-validation ----------------------------------------------------
    def eval_ids(self, token_ids: list[int], trace=None) -> np.ndarray:
        """Per-position logits of the whole sequence, [T, V] float32 on the
        host, from one bucketed prefill of slot 0 on the engine's device
        (``bitnet_tpu/engine/engine.py:1011-1030``; the crossval entry
        point).  ``trace``, a ``verify.trace.TraceSink``, records the real
        positions of slot 0 at each layer (``models.bitnet.forward``)."""
        T = len(token_ids)
        hook = None if trace is None else (
            lambda name, t: trace.record(name, t[0, :T]))
        before = registry.launch_counts()
        with torch.inference_mode():
            h, Tp = self._prefill_slot0(token_ids, hook)
            lg = model_logits(self.cfg, self.params, h[:1, :T],
                              self.kernel_path)[0]
            out = lg.to(torch.float32).cpu().numpy()
        self.kernel_recorder.append(f"eval_{self.kernel_path}_T{Tp}")
        self._record_kernels(before)
        return out

    def decode_step(self, token_id: int, position: int) -> torch.Tensor:
        """Feed one token at ``position`` in slot 0; returns logits [B, V]."""
        B = self.engine_cfg.max_batch_size
        S = self.engine_cfg.max_seq_len
        host = np.zeros((2, B, 1), np.int32)     # token | position, one copy
        host[0, 0, 0] = token_id
        host[1] = S                              # idle slots: writes dropped
        host[1, 0, 0] = position
        with torch.inference_mode():
            tok, pos = torch.from_numpy(host).to(self.device)
            h = self._forward(tok, pos, 1)
            return model_logits(self.cfg, self.params, h,
                                self.kernel_path)[:, -1]

    # -- resume --------------------------------------------------------------
    def _relogit_last(self, token_ids: list[int]) -> torch.Tensor:
        """Last-token logits from a restored cache: rewind slot 0's length
        by one and run the final token through one decode step (its row is
        written again in place; ``bitnet_tpu/engine/engine.py:487-504``)."""
        T = len(token_ids)
        if self.cache.lengths.shape[0] != self.engine_cfg.max_batch_size:
            raise ConfigError("resume on a data-sharded engine: slot 0's rows live on "
                              "data rank 0 only")
        self.cache.lengths[0] = T - 1
        lg = self.decode_step(int(token_ids[-1]), T - 1)
        self.kernel_recorder.append("resume_relogit")
        return lg

    def generate_from_state(self, token_ids: list[int],
                            already_generated: int = 0,
                            gen_cfg: GenerationConfig | None = None
                            ) -> GenerationResult:
        """Continue generation after a checkpoint restore
        (``checkpoint.resume_generation``).  ``token_ids`` is the whole
        context (prompt + tokens generated so far); only the new tokens
        are returned.  A grammar's matcher replays the tokens generated
        so far (``bitnet_tpu/engine/engine.py:507-538``)."""
        gen_cfg = gen_cfg or GenerationConfig()
        remaining = gen_cfg.max_new_tokens - already_generated
        if remaining <= 0:
            return GenerationResult(
                text="", token_ids=[], stop_reason=StopReason.MAX_TOKENS,
                prompt_tokens=len(token_ids), metrics={})
        gen_cfg = gen_cfg.replace(max_new_tokens=remaining)
        if gen_cfg.grammar and already_generated:
            self._grammar_replay = token_ids[-already_generated:]
        out_ids = [ev.token_id for ev in
                   self.generate_stream(token_ids, gen_cfg, resume=True)]
        text = (self.tokenizer.decode(out_ids)
                if self.tokenizer is not None else "")
        return GenerationResult(
            text=text, token_ids=out_ids, stop_reason=self._last_stop_reason,
            prompt_tokens=len(token_ids), metrics=self.last_metrics.as_dict())

    def _grammar_matcher(self, gen_cfg: GenerationConfig):
        """The request's constrained-decoding state: the vocab's pieces
        read once, compiled grammars cached by source (32 at most;
        ``bitnet_tpu/engine/engine.py:282-300``)."""
        if not gen_cfg.grammar:
            return None
        if self.tokenizer is None:
            raise InferenceError("grammar decoding requires a tokenizer")
        from ..grammar import Grammar, TokenVocab, VocabMatcher

        if not hasattr(self, "_grammar_vocab"):
            self._grammar_vocab = TokenVocab.from_tokenizer(self.tokenizer)
            self._grammar_cache: dict[str, Grammar] = {}
        g = self._grammar_cache.get(gen_cfg.grammar)
        if g is None:
            g = Grammar.from_gbnf(gen_cfg.grammar)
            if len(self._grammar_cache) >= 32:
                self._grammar_cache.pop(next(iter(self._grammar_cache)))
            self._grammar_cache[gen_cfg.grammar] = g
        return VocabMatcher(g, self._grammar_vocab)

    # -- generation ----------------------------------------------------------
    def generate_stream(self, token_ids: list[int],
                        gen_cfg: GenerationConfig | None = None,
                        resume: bool = False) -> Iterator[TokenEvent]:
        """Stream tokens, in the JAX engine's loop order: context check
        (keep-half shift, or stop with ``CONTEXT_FULL``) → grammar mask
        (a dead end stops with ``EOS``) → sample (Mirostat, or the chain)
        → grammar accept → stop id / EOS (not emitted) → emit → max tokens
        / stop sequence → decode the emitted token.  ``resume=True`` skips
        the prefill: slot 0 already holds the context's rows (a checkpoint
        restore) and the last token is decoded again for its logits."""
        gen_cfg = gen_cfg or GenerationConfig()
        metrics = PerformanceMetrics(prompt_tokens=len(token_ids),
                                     device=str(self.device))
        self.last_metrics = metrics
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        stop = StopCriteria(
            max_new_tokens=gen_cfg.max_new_tokens, eos_token_id=eos_id,
            stop_token_ids=frozenset(gen_cfg.stop_token_ids),
            stop_sequences=tuple(gen_cfg.stop_sequences),
            min_new_tokens=gen_cfg.min_new_tokens)
        sampler = SamplerChain(gen_cfg)
        # min_new_tokens: EOS (and the stop ids) banned through the logit
        # bias while fewer tokens than the minimum are out
        sampler_ban = None
        if gen_cfg.min_new_tokens > 0:
            d = dict(gen_cfg.logit_bias)
            if eos_id is not None:
                d[int(eos_id)] = -1e30
            for t in gen_cfg.stop_token_ids:
                d[int(t)] = -1e30
            if d != dict(gen_cfg.logit_bias):
                sampler_ban = SamplerChain(gen_cfg.replace(
                    logit_bias=tuple(sorted(d.items())), min_new_tokens=0))
        self._last_stop_reason = StopReason.MAX_TOKENS
        seed = gen_cfg.seed if gen_cfg.seed is not None else (
            0 if self.engine_cfg.strict.deterministic
            else time.time_ns() % (2**31))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mirostat = (MirostatState.from_config(gen_cfg)
                    if gen_cfg.mirostat else None)
        grammar = self._grammar_matcher(gen_cfg)
        replay = self.__dict__.pop("_grammar_replay", None)
        if grammar is not None and replay:
            for t in replay:
                grammar.accept(int(t))
        before = registry.launch_counts()

        if resume and self.windowed:
            raise InferenceError(
                "checkpoint resume requires the dense cache (DecodeState "
                "snapshots are position-indexed rows)")
        t0 = time.perf_counter()
        logits = (self._relogit_last(token_ids) if resume
                  else self.prefill(token_ids))
        self._sync()
        metrics.prefill_s = metrics.ttft_s = time.perf_counter() - t0
        self._record_kernels(before)

        B = self.engine_cfg.max_batch_size
        S = self.engine_cfg.max_seq_len
        W = gen_cfg.repetition_window
        penalized = (gen_cfg.repetition_penalty != 1.0
                     or gen_cfg.frequency_penalty != 0.0
                     or gen_cfg.presence_penalty != 0.0)
        history = np.full((B, W), -1, np.int64)
        hist_ids = list(token_ids)[-W:] if W > 0 else []
        history[0, : len(hist_ids)] = hist_ids
        history_dev = torch.from_numpy(history).to(self.device)
        lp_n = gen_cfg.logprobs
        # K-step segments (engine/loop.py); Mirostat, a grammar, logprobs and
        # the ring keep K = 1 (host state or a host read every step; a
        # segment would write ring rows that no positions array records)
        K = (self._segment_steps()
             if mirostat is None and grammar is None and lp_n is None
             and not self.windowed else 1)
        if K > 1:
            active = torch.zeros((B,), dtype=torch.int32, device=self.device)
            active[0] = 1
            pos_host = np.full((B,), S, np.int32)      # idle slots at S
        before = registry.launch_counts()
        t_dec = time.perf_counter()
        pos = len(token_ids)
        generated = 0
        emitted: list[int] = []
        stopped = False
        while not stopped:
            if pos >= S:
                if self.engine_cfg.context_overflow == "stop":
                    self._last_stop_reason = StopReason.CONTEXT_FULL
                    break
                # keep-half shift, then re-prefill
                keep = max(1, S // 2)
                kept = (list(token_ids) + emitted)[-keep:]
                logits = self.prefill(kept)
                pos = keep
                self.kernel_recorder.append(f"context_shift_keep{keep}")
                continue
            in_min = generated < gen_cfg.min_new_tokens
            if (K > 1 and gen_cfg.max_new_tokens - generated >= K and pos + K <= S
                    and not in_min):
                # K tokens decoded on the device in one round trip; the host
                # replays the stop logic and drops the overshoot (the cache
                # and pos keep all K steps, as in ``:723-741``)
                pos_host[0] = pos
                toks, logits, _pos, history_dev = self._get_segment(gen_cfg, K)(
                    logits, torch.from_numpy(pos_host).to(self.device),
                    history_dev, gen, active)
                step_toks = toks[0].tolist()              # waits for the device
                pos += K
                metrics.decode_steps += K
                for tok_id in step_toks:
                    generated += 1
                    metrics.generated_tokens = generated
                    text = (self.tokenizer.token_to_piece(tok_id)
                            if self.tokenizer is not None else "")
                    reason = stop.check(tok_id, text)
                    if reason in (StopReason.STOP_TOKEN, StopReason.EOS):
                        self._last_stop_reason = reason
                        stopped = True
                        break
                    emitted.append(tok_id)
                    yield TokenEvent(token_id=tok_id, text=text, index=generated - 1)
                    if reason is not None:
                        self._last_stop_reason = reason
                        stopped = True
                        break
                continue
            step_logits = logits
            if grammar is not None:
                mask = grammar.allowed_mask()
                if mask.shape[0] != logits.shape[-1]:
                    raise InferenceError(
                        f"grammar mask over {mask.shape[0]} tokens, logits "
                        f"over {logits.shape[-1]}: the tokenizer's vocab "
                        "is not the model's")
                stoppable = mask
                if in_min and eos_id is not None and mask.any():
                    stoppable = mask.copy()       # the min phase bans EOS
                    stoppable[eos_id] = False
                if not stoppable.any():
                    # a dead end with EOS illegal: stop cleanly
                    self._last_stop_reason = StopReason.EOS
                    self.kernel_recorder.append("grammar_dead_end")
                    break
                step_logits = torch.where(
                    torch.tensor(mask, device=self.device)[None, :], logits,
                    NEG_INF)
            if mirostat is not None:
                row = step_logits[0]
                if in_min:       # EOS and the stop ids banned, as the chain does
                    ban = [int(t) for t in {eos_id, *gen_cfg.stop_token_ids}
                           if t is not None and t < row.shape[0]]
                    if ban:
                        row = row.clone()
                        row[ban] = NEG_INF
                tok_id = mirostat.sample(row, gen)     # waits for the device
                sampled = self._agree(torch.full((B,), tok_id, dtype=torch.int32,
                                                 device=self.device))
                tok_id = int(sampled[0])
            else:
                chain = (sampler_ban if in_min and sampler_ban is not None
                         else sampler)
                sampled = self._agree(chain.sample(step_logits, history_dev, gen))  # [B]
                tok_id = int(sampled[0])              # waits for the device
            if grammar is not None:
                grammar.accept(tok_id)
            generated += 1
            metrics.generated_tokens = generated
            text = (self.tokenizer.token_to_piece(tok_id)
                    if self.tokenizer is not None else "")
            ev = TokenEvent(token_id=tok_id, text=text, index=generated - 1)
            if lp_n is not None:
                ev.logprob, ev.top_logprobs = logprob_entry(
                    logits[0].to(torch.float32).cpu().numpy(), tok_id, lp_n)
            reason = stop.check(tok_id, text)
            if reason in (StopReason.STOP_TOKEN, StopReason.EOS):
                self._last_stop_reason = reason     # stop tokens not emitted
                break
            emitted.append(tok_id)
            yield ev
            if reason is not None:
                self._last_stop_reason = reason
                break
            logits = self.decode_step(tok_id, pos)
            if penalized:
                history_dev = torch.roll(history_dev, -1, dims=1)
                history_dev[:, -1] = sampled
            pos += 1
            metrics.decode_steps += 1
        self._sync()
        metrics.decode_s = time.perf_counter() - t_dec
        n = generated
        if self.windowed:
            self.kernel_recorder.append(
                f"decode_{self.kernel_path}_attn_windowed"
                f"_W{self.engine_cfg.sliding_window}_x{n}")
        elif self.stacked_decode():
            self.kernel_recorder.append(
                f"decode_{self.kernel_path}_attn_{self.decode_plan()}_x{n}")
        else:
            self.kernel_recorder.append(f"decode_{self.kernel_path}_x{n}")
        self._record_kernels(before)

    def generate(self, prompt: str | list[int],
                 gen_cfg: GenerationConfig | None = None) -> GenerationResult:
        """Tokenize (for a text prompt) → generate → decode."""
        gen_cfg = gen_cfg or GenerationConfig()
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise InferenceError("string prompt requires a tokenizer")
            token_ids = self.tokenizer.encode(prompt, add_bos=gen_cfg.add_bos)
        else:
            token_ids = list(prompt)
        out_ids: list[int] = []
        lps: list[dict] | None = [] if gen_cfg.logprobs is not None else None
        for ev in self.generate_stream(token_ids, gen_cfg):
            out_ids.append(ev.token_id)
            if lps is not None:
                lps.append({"token_id": ev.token_id, "text": ev.text,
                            "logprob": ev.logprob, "top": ev.top_logprobs or []})
        text = self.tokenizer.decode(out_ids) if self.tokenizer is not None else ""
        # recorded for deterministic replay through receipts
        # (``bitnet_tpu/engine/engine.py:801-812``)
        self._last_request = {
            "prompt_ids": list(token_ids),
            "output_ids": list(out_ids),
            "gen": {
                "max_new_tokens": gen_cfg.max_new_tokens,
                "temperature": gen_cfg.temperature,
                "top_k": gen_cfg.top_k,
                "top_p": gen_cfg.top_p,
                "min_p": gen_cfg.min_p,
                "repetition_penalty": gen_cfg.repetition_penalty,
                "seed": gen_cfg.seed,
                "greedy": gen_cfg.greedy,
            },
        }
        return GenerationResult(text=text, token_ids=out_ids,
                                stop_reason=self._last_stop_reason,
                                prompt_tokens=len(token_ids),
                                metrics=self.last_metrics.as_dict(),
                                logprobs=lps)

    def prefill_batch(self, prompts: list[list[int]]) -> torch.Tensor:
        """Reset the cache and run ONE bucketed prefill over the pool: slot
        i holds prompt i, idle slots and padding carry position S (their
        writes drop).  Returns each slot's last-token logits [B, V]."""
        B = self.engine_cfg.max_batch_size
        S = self.engine_cfg.max_seq_len
        nb = len(prompts)
        if nb > B:
            raise InferenceError(f"{nb} prompts > max_batch_size {B}; raise "
                                 "EngineConfig.max_batch_size")
        lens = [len(p) for p in prompts]
        if not lens or min(lens) == 0:
            raise InferenceError("empty prompt in batch")
        if max(lens) >= S:
            raise InferenceError(f"prompt of {max(lens)} tokens >= "
                                 f"max_seq_len {S}")
        self._reset()
        Tp = self._bucket(max(lens))
        toks = np.zeros((B, Tp), np.int32)
        pos = np.full((B, Tp), S, np.int32)
        n_real = np.zeros((B,), np.int32)
        last_idx = np.zeros((B,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : lens[i]] = p
            pos[i, : lens[i]] = np.arange(lens[i])
            n_real[i] = lens[i]
            last_idx[i] = lens[i] - 1
        dev = self.device
        with torch.inference_mode():
            h = self._forward(torch.from_numpy(toks).to(dev),
                              torch.from_numpy(pos).to(dev),
                              torch.from_numpy(n_real).to(dev))
            h_last = h[torch.arange(B, device=dev),
                       torch.from_numpy(last_idx).to(dev)][:, None]
            lg = model_logits(self.cfg, self.params, h_last,
                              self.kernel_path)[:, 0]
        self.kernel_recorder.append(f"prefill_batch{nb}_T{Tp}")
        return lg

    def decode_batch_step(self, tokens: torch.Tensor,
                          positions: np.ndarray) -> torch.Tensor:
        """One lockstep decode step of the pool: ``tokens`` [B] on the
        device, ``positions`` [B] on the host (S for idle slots).  Returns
        logits [B, V]."""
        dev = self.device
        with torch.inference_mode():
            h = self._forward(
                tokens.to(dev, torch.int32)[:, None],
                torch.from_numpy(np.asarray(positions, np.int32)[:, None]).to(dev), 1)
            return model_logits(self.cfg, self.params, h, self.kernel_path)[:, -1]

    def generate_batch(self, prompts: list[list[int]],
                       gen_cfg: GenerationConfig | None = None
                       ) -> list[GenerationResult]:
        """Batched generation (``bitnet_tpu/engine/engine.py:825-950``): ONE
        bucketed prefill over all slots, then lockstep decode with per-slot
        stop criteria.  Idle slots and padding carry position S; a finished
        slot keeps riding the step at position S (the stacked decode loop
        clamps its write to row S-1 of its own slot, the generic path drops
        it) and its output is ignored.  ``last_metrics`` holds the pool's
        totals."""
        gen_cfg = gen_cfg or GenerationConfig()
        if gen_cfg.grammar:
            raise InferenceError(
                "grammar decoding is per-sequence host-side state; use "
                "generate/generate_stream or the scheduler, not the "
                "lockstep batch API")
        if gen_cfg.logprobs is not None:
            raise InferenceError(
                "logprobs need per-step host logits reads; use "
                "generate/generate_stream, not the lockstep batch API")
        B = self.engine_cfg.max_batch_size
        S = self.engine_cfg.max_seq_len
        nb = len(prompts)
        if nb == 0:
            return []
        lens = [len(p) for p in prompts]
        metrics = PerformanceMetrics(prompt_tokens=sum(lens),
                                     device=str(self.device))
        self.last_metrics = metrics
        dev = self.device
        before = registry.launch_counts()

        t0 = time.perf_counter()
        logits = self.prefill_batch(prompts)
        self._sync()
        metrics.prefill_s = metrics.ttft_s = time.perf_counter() - t0

        # --- lockstep decode ---
        eos_id = getattr(self.tokenizer, "eos_token_id", None)
        stops = [StopCriteria(
            max_new_tokens=gen_cfg.max_new_tokens, eos_token_id=eos_id,
            stop_token_ids=frozenset(gen_cfg.stop_token_ids),
            stop_sequences=tuple(gen_cfg.stop_sequences)) for _ in range(nb)]
        done = [False] * nb
        reasons = [StopReason.MAX_TOKENS] * nb
        outs: list[list[int]] = [[] for _ in range(nb)]
        seed = gen_cfg.seed if gen_cfg.seed is not None else (
            0 if self.engine_cfg.strict.deterministic
            else time.time_ns() % (2**31))
        gen = torch.Generator(device=dev).manual_seed(seed)
        sampler = SamplerChain(gen_cfg)
        W = gen_cfg.repetition_window
        penalized = (gen_cfg.repetition_penalty != 1.0
                     or gen_cfg.frequency_penalty != 0.0
                     or gen_cfg.presence_penalty != 0.0)
        history = np.full((B, W), -1, np.int64)
        for i, p in enumerate(prompts):
            tail = p[-W:] if W > 0 else []
            history[i, : len(tail)] = tail
        history_dev = torch.from_numpy(history).to(dev)
        positions_host = np.array(lens + [0] * (B - nb), np.int32)
        t_dec = time.perf_counter()
        while not all(done):
            if positions_host[:nb].max() >= S:
                break
            sampled = self._agree(sampler.sample(logits, history_dev, gen))   # [B]
            samp_host = sampled.cpu().numpy()
            for i in range(nb):
                if done[i]:
                    continue
                t = int(samp_host[i])
                piece = (self.tokenizer.token_to_piece(t)
                         if self.tokenizer is not None else "")
                r = stops[i].check(t, piece)
                if r in (StopReason.STOP_TOKEN, StopReason.EOS):
                    done[i], reasons[i] = True, r
                    continue
                outs[i].append(t)
                if r is not None:
                    done[i], reasons[i] = True, r
            if all(done):
                break
            positions = np.full((B,), S, np.int32)
            for i in range(nb):
                if not done[i] and positions_host[i] < S:
                    positions[i] = positions_host[i]
                    positions_host[i] += 1
            logits = self.decode_batch_step(sampled, positions)
            if penalized:
                history_dev = torch.roll(history_dev, -1, dims=1)
                history_dev[:, -1] = sampled
            metrics.decode_steps += 1
        self._sync()
        metrics.decode_s = time.perf_counter() - t_dec
        metrics.generated_tokens = sum(len(o) for o in outs)
        self.kernel_recorder.append(f"decode_batch{nb}")
        self._record_kernels(before)
        return [GenerationResult(
            text=(self.tokenizer.decode(outs[i])
                  if self.tokenizer is not None else ""),
            token_ids=outs[i], stop_reason=reasons[i], prompt_tokens=lens[i],
            metrics={}) for i in range(nb)]

    # -- multi-card ------------------------------------------------------------
    def _agree(self, sampled: torch.Tensor) -> torch.Tensor:
        """Rank 0's sampled tokens on every rank of a live mesh (the ranks'
        logits are the whole model's on each, but one broadcast a step makes
        the next step's input the same everywhere by construction)."""
        if self.mesh is None or not self.mesh.live:
            return sampled
        return self.mesh.world.broadcast(sampled.contiguous(), src=0)

    def shard_to_mesh(self, mesh=None, dp: int | None = None,
                      tp: int | None = None) -> "InferenceEngine":
        """Re-place the parameters and the KV cache on a (data, model) mesh
        (``bitnet_tpu/engine/engine.py:953-987``), one process a rank: this
        rank keeps its shard of the weights (``parallel/sharding.py``:
        column-parallel q / k / v / gate / up, row-parallel o / down with
        the model axis's all-reduces) and allocates only its rows of the
        cache (its KV heads; its slots on the data axis).  Every rank calls
        it, and then every entry point, in the same order.  ``mesh`` or
        ``dp`` / ``tp`` (``parallel.make_mesh``: a mesh of dp · tp ranks
        needs ``torch.distributed`` initialized with as many processes; a
        single process builds only the mesh of one).  Captured segments are
        dropped; on a live mesh decode steps at K = 1 and the sampled tokens
        are rank 0's.  Refused: fused projections, dimensions that do not
        split into whole granules (``validate_mesh_for``), and on a live
        mesh the windowed ring and the prefix cache.  Returns self."""
        from ..parallel import make_mesh
        from ..parallel.sharding import (allocate_sharded_cache, shard_params,
                                         validate_mesh_for)

        if self.mesh is not None:
            raise ConfigError("the engine is sharded already")
        if mesh is None:
            mesh = make_mesh(dp=dp, tp=tp, device=self.device)
        validate_mesh_for(self.cfg, self.engine_cfg.max_batch_size, mesh, self.params)
        if mesh.live and (self.windowed or self.prefix_cache is not None):
            raise ConfigError("a live mesh takes the dense cache without a prefix "
                              "cache (EngineConfig(sliding_window=0, "
                              "prefix_cache_tokens=0))")
        self.params = shard_params(mesh, self.cfg, self.params)
        self.cache = allocate_sharded_cache(mesh, self.cfg, self.engine_cfg.max_batch_size,
                                            self.engine_cfg.max_seq_len, self.kv_dtype,
                                            device=self.device)
        self.mesh = mesh
        # drop graphs captured over the unsharded weights and cache
        self._segments.clear()
        self._graph_pool = None
        return self
