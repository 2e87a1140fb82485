"""Synthetic mini-GGUF fixture generator.

TPU-build equivalent of ``cargo xtask gen-mini-gguf``
(``xtask/src/main.rs:713-720``): writes a tiny but fully valid BitNet GGUF so
loader/engine tests run without a real 2B checkpoint.  Also returns the
float reference weights so tests can check dequantization parity.

Own copy of ``bitnet_tpu/gguf/fixtures.py`` (``f32``, ``qk256``,
``bitnet32`` and ``q8_0`` linears), so ``chip_smoke.py`` can write a GGUF
without the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import ModelConfig
from ..quant.ggml_classic import dequantize_q8_0, quantize_q8_0
from ..quant.i2s import dequantize_bitnet32, quantize_bitnet32
from ..quant.qk256 import dequantize_qk256, quantize_qk256
from .constants import GGMLType
from .writer import GGUFWriter


@dataclass
class MiniModelSpec:
    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    max_seq_len: int = 128
    rope_base: float = 10000.0
    rms_norm_eps: float = 1e-5
    quant: str = "f32"  # 'f32' | 'bitnet32' | 'qk256' | 'q8_0'
    # store quantized linears orientation-FLIPPED ([in, out] instead of
    # [out, in]) — exercises the loader's transposed-I2_S repack path
    # (reference re-derives orientation, formats/gguf/loader.rs:1427-1480)
    transposed: bool = False
    sub_norm: bool = False   # emit BitNet 2B-4T attn/ffn sub-layernorms
    seed: int = 0
    architecture: str = "bitnet-25"   # reference arch string family
    tie_embeddings: bool = True
    # extra metadata key/values written verbatim (e.g. an embedded
    # tokenizer.chat_template for jinja-execution tests)
    extra_metadata: dict | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def to_model_config(self) -> ModelConfig:
        return ModelConfig(
            vocab_size=self.vocab_size,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_layers=self.num_layers,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            max_seq_len=self.max_seq_len,
            rope_base=self.rope_base,
            rms_norm_eps=self.rms_norm_eps,
            tie_word_embeddings=self.tie_embeddings,
            architecture=self.architecture,
        )


@dataclass
class MiniModel:
    spec: MiniModelSpec
    path: str
    # float reference weights by GGUF tensor name, row-major [out, in]
    weights: dict[str, np.ndarray] = field(default_factory=dict)


def _linear_names(i: int) -> list[tuple[str, str]]:
    return [
        (f"blk.{i}.attn_q.weight", "qkv"),
        (f"blk.{i}.attn_k.weight", "qkv"),
        (f"blk.{i}.attn_v.weight", "qkv"),
        (f"blk.{i}.attn_output.weight", "o"),
        (f"blk.{i}.ffn_gate.weight", "ffn"),
        (f"blk.{i}.ffn_up.weight", "ffn"),
        (f"blk.{i}.ffn_down.weight", "ffn"),
    ]


def generate_mini_gguf(path: str, spec: MiniModelSpec | None = None) -> MiniModel:
    """Write a tiny valid BitNet GGUF to ``path``; returns reference weights."""
    spec = spec or MiniModelSpec()
    rng = np.random.default_rng(spec.seed)
    H, F, V = spec.hidden_size, spec.intermediate_size, spec.vocab_size
    Hd, nh, nkv = spec.head_dim, spec.num_heads, spec.num_kv_heads

    w = GGUFWriter()
    arch = spec.architecture
    w.add_metadata("general.architecture", arch)
    w.add_metadata("general.name", "bitnet-tpu-mini")
    w.add_metadata(f"{arch}.embedding_length", H)
    w.add_metadata(f"{arch}.block_count", spec.num_layers)
    w.add_metadata(f"{arch}.attention.head_count", nh)
    w.add_metadata(f"{arch}.attention.head_count_kv", nkv)
    w.add_metadata(f"{arch}.feed_forward_length", F)
    w.add_metadata(f"{arch}.context_length", spec.max_seq_len)
    w.add_metadata(f"{arch}.rope.freq_base", float(spec.rope_base))
    w.add_metadata(f"{arch}.attention.layer_norm_rms_epsilon",
                   float(spec.rms_norm_eps))
    w.add_metadata(f"{arch}.vocab_size", V)
    w.add_metadata("general.file_type", 0)

    # minimal byte-level tokenizer vocab (mock-tokenizer equivalent of
    # ``bitnet-tokenizers/src/mock.rs`` but stored the real GGUF way)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(V - 3)]
    w.add_metadata("tokenizer.ggml.model", "llama")
    w.add_metadata("tokenizer.ggml.tokens", tokens)
    w.add_metadata("tokenizer.ggml.scores", [0.0] * len(tokens))
    # type 2 = unknown/control for specials, 6 = byte
    w.add_metadata("tokenizer.ggml.token_type", [2, 3, 3] + [6] * (V - 3))
    w.add_metadata("tokenizer.ggml.bos_token_id", 1)
    w.add_metadata("tokenizer.ggml.eos_token_id", 2)
    w.add_metadata("tokenizer.ggml.unknown_token_id", 0)
    for k, v in (spec.extra_metadata or {}).items():
        w.add_metadata(k, v)

    weights: dict[str, np.ndarray] = {}

    # Quantized fixtures have weight values on the raw LUT scale (±1, ±2 —
    # QK256 has no per-block scales), which would saturate attention softmax
    # and make f32-vs-f64 parity flaky.  Shrink the norm gains so activations
    # stay in a numerically tame range; real checkpoints are trained with
    # this balance built in.
    norm_gain = 1.0 if spec.quant in ("f32", "q8_0") else 0.05

    def add_float(name: str, arr: np.ndarray) -> None:
        weights[name] = arr.astype(np.float32)
        w.add_tensor(name, arr.astype(np.float32), GGMLType.F32)

    def add_linear(name: str, out_dim: int, in_dim: int) -> None:
        # small-magnitude weights; for quantized variants generate data that
        # round-trips (so fixture parity tests can be exact where desired)
        raw = rng.standard_normal((out_dim, in_dim)).astype(np.float32) * 0.05
        if spec.quant == "f32":
            add_float(name, raw)
            return
        # square tensors are orientation-ambiguous from shape alone (the
        # loader, like the reference, assumes [out, in] then) — only flip
        # non-square linears
        flip = spec.transposed and out_dim != in_dim
        stored = raw.T.copy() if flip else raw
        shape = (in_dim, out_dim) if flip else (out_dim, in_dim)
        if spec.quant == "bitnet32":
            payload = quantize_bitnet32(stored)
            deq = dequantize_bitnet32(payload, raw.size).reshape(shape)
            weights[name] = deq.T if flip else deq
            w.add_quantized_tensor(name, shape, GGMLType.I2_S, payload)
            return
        if spec.quant == "qk256":
            payload = quantize_qk256(stored)
            deq = dequantize_qk256(payload, shape[0], shape[1])
            weights[name] = deq.T if flip else deq
            w.add_quantized_tensor(name, shape, GGMLType.I2_S, payload)
            return
        if spec.quant == "q8_0":
            # classic GGML 8-bit blocks: the generic llama-family path,
            # loaded as dense linears
            payload = quantize_q8_0(stored)
            deq = dequantize_q8_0(np.frombuffer(payload, np.uint8),
                                  raw.size).reshape(shape)
            weights[name] = deq.T if flip else deq
            w.add_quantized_tensor(name, shape, GGMLType.Q8_0, payload)
            return
        raise ValueError(f"unknown quant {spec.quant!r}")

    emb = rng.standard_normal((V, H)).astype(np.float32) * 0.05
    add_float("token_embd.weight", emb)

    for i in range(spec.num_layers):
        add_float(f"blk.{i}.attn_norm.weight", (np.ones(H) + rng.standard_normal(H) * 0.01) * norm_gain)
        add_linear(f"blk.{i}.attn_q.weight", nh * Hd, H)
        add_linear(f"blk.{i}.attn_k.weight", nkv * Hd, H)
        add_linear(f"blk.{i}.attn_v.weight", nkv * Hd, H)
        if spec.sub_norm:
            add_float(f"blk.{i}.attn_sub_norm.weight",
                      (np.ones(nh * Hd)
                       + rng.standard_normal(nh * Hd) * 0.01) * norm_gain)
        add_linear(f"blk.{i}.attn_output.weight", H, nh * Hd)
        add_float(f"blk.{i}.ffn_norm.weight", (np.ones(H) + rng.standard_normal(H) * 0.01) * norm_gain)
        add_linear(f"blk.{i}.ffn_gate.weight", F, H)
        add_linear(f"blk.{i}.ffn_up.weight", F, H)
        if spec.sub_norm:
            add_float(f"blk.{i}.ffn_sub_norm.weight",
                      (np.ones(F) + rng.standard_normal(F) * 0.01)
                      * norm_gain)
        add_linear(f"blk.{i}.ffn_down.weight", H, F)

    add_float("output_norm.weight", (np.ones(H) + rng.standard_normal(H) * 0.01) * norm_gain)
    if not spec.tie_embeddings:
        add_linear("output.weight", V, H)

    w.write(path)
    return MiniModel(spec=spec, path=path, weights=weights)
