"""BitNet-shaped models with random ternary weights, made from a seed.

The counterpart of ``bench.py:101-180`` of the JAX package: random int32
words ARE random ternary codes in the kernels' word layout, so a full
2B-shaped model needs no checkpoint and no repack, and its bytes and
operations are exactly the real model's.  Weights are drawn on the target
device from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.linear import TernaryLinear
from ..ops.rope import build_rope_tables
from .bitnet import BitNetParams, BlockParams

# bitnet-b1.58-2B-4T's published shapes (ROADMAP.md:29, README.md:133-134)
BITNET_2B4T = ModelConfig(
    vocab_size=128256, hidden_size=2560, intermediate_size=6912,
    num_layers=30, num_heads=20, num_kv_heads=5, head_dim=128,
    max_seq_len=4096, rope_base=500000.0, rms_norm_eps=1e-5,
    use_sub_norm=True)


def build_synthetic(cfg: ModelConfig = BITNET_2B4T, seed: int = 0,
                    device="cuda") -> BitNetParams:
    """Unfused params (the engine fuses them) for ``cfg``; norms are ones,
    with 2B-4T's attn/ffn sub-layernorms when ``cfg.use_sub_norm``.  The
    per-layer weight scale 0.02 keeps activations sane through 30 layers
    (the JAX package's bench uses the same)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, H, F, V = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                  cfg.vocab_size)
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sub_norms = cfg.use_sub_norm

    def lin(k: int, n: int) -> TernaryLinear:
        kp, npad = -(-k // 256) * 256, -(-n // 128) * 128
        words = torch.randint(-2**31, 2**31, (L, kp // 16, npad),
                              dtype=torch.int32, generator=g, device=dev)
        return TernaryLinear(kind="qk256", k=k, n=n, packed=words,
                             scales=torch.full((L,), 0.02, device=dev))

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)  # noqa: E731
    blocks = BlockParams(
        attn_norm=ones(L, H), wq=lin(H, nh * D), wk=lin(H, nkv * D),
        wv=lin(H, nkv * D), wo=lin(nh * D, H), ffn_norm=ones(L, H),
        w_gate=lin(H, F), w_up=lin(H, F), w_down=lin(F, H),
        attn_sub_norm=ones(L, nh * D) if sub_norms else None,
        ffn_sub_norm=ones(L, F) if sub_norms else None)
    sin, cos = build_rope_tables(D, cfg.max_seq_len, cfg.rope_base, device=dev)
    embed = (torch.randn((V, H), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    return BitNetParams(embed=embed, blocks=blocks, final_norm=ones(H),
                        rope_sin=sin, rope_cos=cos)
