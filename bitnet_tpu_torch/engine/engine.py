"""InferenceEngine: bucketed prefill, then greedy decode, on one device.

Counterpart of ``bitnet_tpu/engine/engine.py`` for slice 1: token-id
prompts, ``prefill_buckets`` padding (padded positions carry S, so their
cache writes drop), single-step greedy decode, stop ids / EOS / max
tokens, and a ``kernel_recorder`` naming the path and the kernels that
ran.  PyTorch runs eagerly, so there is no compiled program per bucket;
the decode step is one Python call of the model per token (a CUDA graph
around it is later work).
"""

from __future__ import annotations

import dataclasses
import enum
import time

import numpy as np
import torch

from ..config import EngineConfig, GenerationConfig, ModelConfig
from ..device_probe import resolve_device
from ..errors import ConfigError, InferenceError
from ..models.bitnet import (
    BitNetParams,
    decode_attn_plan,
    forward_cache,
    fuse_block_params,
    logits as model_logits,
    quantize_head,
)
from ..ops import registry
from .cache import allocate_cache, reset_cache
from .sampling import argmax


class StopReason(enum.Enum):
    MAX_TOKENS = "max_tokens"
    STOP_TOKEN = "stop_token"
    EOS = "eos"
    CONTEXT_FULL = "context_full"


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    stop_reason: StopReason
    prompt_tokens: int
    metrics: dict


def prefill_buckets(max_seq_len: int, smallest: int = 8) -> list[int]:
    out, b = [], smallest
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return out


class InferenceEngine:
    """Single-sequence engine over a [B ≤ 2] flat bf16 cache."""

    def __init__(self, cfg: ModelConfig, params: BitNetParams,
                 engine_cfg: EngineConfig | None = None,
                 device: str | torch.device = "cuda",
                 eos_token_id: int | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.engine_cfg = ec = engine_cfg or EngineConfig()
        self.eos_token_id = eos_token_id
        cfg.validate()
        if ec.max_seq_len > cfg.max_seq_len:
            raise ConfigError(
                f"engine max_seq_len {ec.max_seq_len} exceeds model context "
                f"{cfg.max_seq_len}")
        params = params.to(self.device)
        # compute_dtype is the activations' dtype: the embedding rows feed
        # the residual stream in it
        act = torch.float32 if ec.compute_dtype == "f32" else torch.bfloat16
        if params.embed.dtype != act:
            params = dataclasses.replace(params, embed=params.embed.to(act))
        if params.blocks.wqkv is None:
            params = dataclasses.replace(
                params, blocks=fuse_block_params(params.blocks))
        if ec.logits_dtype == "int8":
            params = quantize_head(params)
        self.params = params
        self.kv_dtype = ec.resolve_kv_cache_dtype()
        self.plan = decode_attn_plan(ec.max_batch_size, self.kv_dtype)
        self.cache = allocate_cache(cfg, ec.max_batch_size, ec.max_seq_len,
                                    self.kv_dtype, device=self.device)
        self._buckets = prefill_buckets(ec.max_seq_len)
        self.kernel_recorder: list[str] = []
        self.last_metrics: dict = {}

    @classmethod
    def from_gguf(cls, path: str, engine_cfg: EngineConfig | None = None,
                  device: str | torch.device = "cuda") -> "InferenceEngine":
        from ..models.loader import load_model

        engine_cfg = engine_cfg or EngineConfig()
        dev = resolve_device(device)
        cfg, params, meta = load_model(path, param_dtype=(
            torch.float32 if engine_cfg.compute_dtype == "f32" else torch.bfloat16))
        if engine_cfg.max_seq_len > cfg.max_seq_len:
            engine_cfg = engine_cfg.replace(max_seq_len=cfg.max_seq_len)
        return cls(cfg, params, engine_cfg, device=dev,
                   eos_token_id=meta.get("eos_token_id"))

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

    # -- steps ---------------------------------------------------------------
    def prefill(self, token_ids: list[int]) -> torch.Tensor:
        """Reset the cache and run the prompt; returns last-token logits
        [B, V] (f32)."""
        T = len(token_ids)
        if T == 0:
            raise InferenceError("empty prompt")
        S = self.engine_cfg.max_seq_len
        if T > S:
            raise InferenceError(f"prompt {T} tokens > max_seq_len {S}")
        reset_cache(self.cache)
        B = self.engine_cfg.max_batch_size
        Tp = self._bucket(T)
        toks = np.zeros((B, Tp), np.int32)
        toks[0, :T] = token_ids
        pos = np.full((B, Tp), S, np.int32)      # padding → dropped writes
        pos[0, :T] = np.arange(T)
        n_real = np.zeros((B,), np.int32)
        n_real[0] = T
        dev = self.device
        with torch.inference_mode():
            h, self.cache = forward_cache(
                self.cfg, self.params, torch.from_numpy(toks).to(dev),
                torch.from_numpy(pos).to(dev), self.cache,
                torch.from_numpy(n_real).to(dev))
            lg = model_logits(self.cfg, self.params, h[:, T - 1:T])[:, 0]
        self.kernel_recorder.append(f"prefill_w2a8_T{Tp}")
        return lg

    def decode_step(self, token_id: int, position: int) -> torch.Tensor:
        """Feed one token at ``position`` in slot 0; returns logits [B, V]."""
        B = self.engine_cfg.max_batch_size
        S = self.engine_cfg.max_seq_len
        host = np.zeros((2, B, 1), np.int32)     # token | position, one copy
        host[0, 0, 0] = token_id
        host[1] = S                              # idle slots write row S-1
        host[1, 0, 0] = position
        with torch.inference_mode():
            tok, pos = torch.from_numpy(host).to(self.device)
            h, self.cache = forward_cache(self.cfg, self.params, tok, pos,
                                          self.cache, 1)
            return model_logits(self.cfg, self.params, h)[:, -1]

    # -- generation ----------------------------------------------------------
    def generate(self, prompt_ids: list[int],
                 gen_cfg: GenerationConfig | None = None) -> GenerationResult:
        """Greedy generation from a token-id prompt."""
        gen_cfg = gen_cfg or GenerationConfig()
        S = self.engine_cfg.max_seq_len
        before = registry.launch_counts()
        t0 = time.perf_counter()
        logits = self.prefill(prompt_ids)
        self._sync()
        prefill_s = time.perf_counter() - t0
        self._record_kernels(before)

        # the JAX engine's loop order: context check → sample → stop ids /
        # EOS (not emitted) → emit → max tokens → decode the emitted token
        before = registry.launch_counts()
        t1 = time.perf_counter()
        out: list[int] = []
        pos, steps = len(prompt_ids), 0
        while True:
            if pos >= S:
                reason = StopReason.CONTEXT_FULL
                break
            tok = int(argmax(logits)[0])        # waits for the device
            if tok in gen_cfg.stop_token_ids:
                reason = StopReason.STOP_TOKEN
                break
            if self.eos_token_id is not None and tok == self.eos_token_id:
                reason = StopReason.EOS
                break
            out.append(tok)
            if len(out) >= gen_cfg.max_new_tokens:
                reason = StopReason.MAX_TOKENS
                break
            logits = self.decode_step(tok, pos)
            pos += 1
            steps += 1
        decode_s = time.perf_counter() - t1
        self.kernel_recorder.append(
            f"decode_w2a8_attn_{self.plan}_x{len(out)}")
        self._record_kernels(before)
        self.last_metrics = {
            "prompt_tokens": len(prompt_ids), "generated_tokens": len(out),
            "decode_steps": steps, "prefill_s": prefill_s,
            "decode_s": decode_s, "device": str(self.device)}
        return GenerationResult(out, reason, len(prompt_ids), self.last_metrics)
