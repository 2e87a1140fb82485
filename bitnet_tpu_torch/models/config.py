"""ModelConfig extraction from GGUF metadata (counterpart of
bitnet_tpu/models/config.py).

Key handling mirrors the reference GGUF loader's metadata plumbing
(``crates/bitnet-models/src/formats/gguf/loader.rs``): hyperparameters come
from ``<arch>.*`` keys with conservative defaults, vocab size falls back to
the tokenizer token list length.
"""

from __future__ import annotations

from ..config import ModelConfig
from ..gguf.reader import GGUFReader


def config_from_gguf(reader: GGUFReader) -> ModelConfig:
    arch = reader.architecture or "llama"
    g = reader.arch_key

    hidden = int(g("embedding_length", 2560))
    n_heads = int(g("attention.head_count", 20))
    n_kv = int(g("attention.head_count_kv", n_heads))
    head_dim = int(g("attention.key_length", hidden // n_heads))

    vocab = g("vocab_size")
    if vocab is None:
        toks = reader.metadata.get("tokenizer.ggml.tokens")
        vocab = len(toks) if toks is not None else 32000
    # detect untied lm_head
    tied = "output.weight" not in reader.tensors

    # FFN activation: silu by default (matches the reference transformer,
    # bitnet-transformer lib.rs:765); converters may declare relu2 (the
    # BitNet 2B-4T paper activation) via metadata
    act = (g("activation_function")
           or reader.metadata.get("general.activation") or "silu")
    act = {"swish": "silu", "silu": "silu", "relu2": "relu2",
           "relu_squared": "relu2", "gelu": "gelu"}.get(
        str(act).lower(), "silu")

    return ModelConfig(
        hidden_act=act,
        vocab_size=int(vocab),
        hidden_size=hidden,
        intermediate_size=int(g("feed_forward_length", 4 * hidden)),
        num_layers=int(g("block_count", 30)),
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        max_seq_len=int(g("context_length", 4096)),
        rope_base=float(g("rope.freq_base", 10000.0)),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        tie_word_embeddings=tied,
        architecture=arch,
    )
