"""BitNet-shaped models with random ternary weights, made from a seed:
bitnet-b1.58-2B-4T's shapes (``BITNET_2B4T``) and the 8B-class
Llama-3-8B-1.58 shapes (``LLAMA3_8B_158``).

The counterpart of ``bench.py:101-180`` of the JAX package: random int32
words ARE random ternary codes in the kernels' word layout, so a full
2B-shaped model needs no checkpoint and no repack, and its bytes and
operations are exactly the real model's.  Weights are drawn on the target
device from a seeded ``torch.Generator``.

``kind="qk256"`` gives the QK256 model (one scale 0.02 a layer);
``kind="bitnet32"`` the BitNet32-F16 model: the same random words plus
per-32-row block scales, f16 values drawn around 0.02 and clipped to the
loader's [1e-3, 1e3] (``quant/i2s.py``), zero in the padded rows and
columns as the loader leaves them.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.linear import TernaryLinear
from ..ops.rope import build_rope_tables
from ..quant.i2s import SCALE_MAX as I2S_SCALE_MAX, SCALE_MIN as I2S_SCALE_MIN
from .bitnet import BitNetParams, BlockParams

# bitnet-b1.58-2B-4T's published shapes (ROADMAP.md:29, README.md:133-134)
BITNET_2B4T = ModelConfig(
    vocab_size=128256, hidden_size=2560, intermediate_size=6912,
    num_layers=30, num_heads=20, num_kv_heads=5, head_dim=128,
    max_seq_len=4096, rope_base=500000.0, rms_norm_eps=1e-5,
    use_sub_norm=True)

# the 8B-class model: Llama-3-8B-1.58's shapes (``bench.py:57-58``,
# BASELINE.json config #5), 32/8 heads of 128, tied head, no sub-norms, so
# its generic path can take the fused W2A8 FFN (K24)
LLAMA3_8B_158 = ModelConfig(
    vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
    max_seq_len=4096, rope_base=500000.0, rms_norm_eps=1e-5,
    use_sub_norm=False)


def build_synthetic(cfg: ModelConfig = BITNET_2B4T, seed: int = 0,
                    device="cuda", kind: str = "qk256") -> BitNetParams:
    """Unfused params (the engine fuses them) for ``cfg``; norms are ones,
    with 2B-4T's attn/ffn sub-layernorms when ``cfg.use_sub_norm``.  The
    per-layer weight scale 0.02 keeps activations sane through 30 layers
    (the JAX package's bench uses the same)."""
    if kind not in ("qk256", "bitnet32"):
        raise ValueError(f"synthetic kinds are qk256 and bitnet32, got {kind!r}")
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
        if kind == "qk256":
            return TernaryLinear(kind="qk256", k=k, n=n, packed=words,
                                 scales=torch.full((L,), 0.02, device=dev))
        s = torch.rand((L, k // 32, n), generator=g, device=dev) * 0.02 + 0.01
        s = torch.clamp(s.to(torch.float16).to(torch.float32), I2S_SCALE_MIN,
                        I2S_SCALE_MAX)
        scales = torch.zeros((L, kp // 32, npad), device=dev)
        scales[:, : k // 32, :n] = s
        return TernaryLinear(kind="bitnet32", k=k, n=n, packed=words,
                             scales=scales)

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


def condition_norms(params: BitNetParams, cfg: ModelConfig) -> BitNetParams:
    """Set a synthetic model's norm gains, in place, as
    ``tools/gen_2b_gguf.py`` sets its GGUF's: pre-norm gains that make q, k
    and v unit-variance (1 / (0.02 · sqrt(H · E[w²])), E[w²] = 2.5 for the
    codes' values {-2, -1, 1, 2} at ``build_synthetic``'s scale 0.02) and
    sub-norm gains of 0.05 (a residual-dominated stream).  With gains of
    one, two valid routes through 30 random layers part too far for a
    cosine gate to tell a fault from rounding
    (``python -m bitnet_tpu_torch.tools.prefill_routes``)."""
    b = params.blocks
    pre = 1.0 / (0.02 * (cfg.hidden_size * 2.5) ** 0.5)
    b.attn_norm.fill_(pre)
    b.ffn_norm.fill_(pre)
    for sub in (b.attn_sub_norm, b.ffn_sub_norm):
        if sub is not None:
            sub.fill_(0.05)
    return params
