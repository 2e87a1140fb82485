"""Independent numpy reference forward pass (the parity golden model).

Counterpart of ``bitnet_tpu/verify/reference.py``, kept as its own copy
(the port imports nothing of the JAX package): a completely separate
implementation of the same architecture, in plain numpy with no code
shared with the port's torch model (different loop structure, float64
throughout), used to gate the port's forward with per-token cosine
similarity (``crossval/src/logits_compare.rs:55-98``).
"""

from __future__ import annotations

import numpy as np

from ..config import ModelConfig


def _rms_norm(x: np.ndarray, w: np.ndarray, eps: float) -> np.ndarray:
    var = np.mean(x * x, axis=-1, keepdims=True)
    return x / np.sqrt(var + eps) * w


def _silu(x: np.ndarray) -> np.ndarray:
    return x / (1.0 + np.exp(-x))


def _rope_rotate(x: np.ndarray, pos: int, base: float) -> np.ndarray:
    """x: [n_heads, D] at a single absolute position (split layout)."""
    nh, D = x.shape
    half = D // 2
    j = np.arange(half, dtype=np.float64)
    inv_freq = base ** (-2.0 * j / D)
    ang = pos * inv_freq
    c, s = np.cos(ang), np.sin(ang)
    x0, x1 = x[:, :half], x[:, half:]
    return np.concatenate([x0 * c - x1 * s, x0 * s + x1 * c], axis=1)


def reference_forward(
    cfg: ModelConfig,
    weights: dict[str, np.ndarray],
    tokens: list[int],
) -> np.ndarray:
    """Full-sequence forward; returns logits [T, vocab] in float32.

    ``weights``: GGUF-named float weight dict ([out, in] row-major), e.g.
    the fixture's reference weights or a dequantized checkpoint.
    """
    emb = weights["token_embd.weight"]  # [V, H]
    H, nh, nkv, D = (cfg.hidden_size, cfg.num_heads,
                     cfg.num_kv_heads, cfg.head_dim)
    G = nh // nkv
    T = len(tokens)
    x = emb[np.asarray(tokens)].astype(np.float64)  # [T, H]

    for L in range(cfg.num_layers):
        w = lambda role: weights[f"blk.{L}.{role}.weight"].astype(np.float64)
        # attention
        h = _rms_norm(x, w("attn_norm"), cfg.rms_norm_eps)
        q = h @ w("attn_q").T   # [T, nh*D]
        k = h @ w("attn_k").T   # [T, nkv*D]
        v = h @ w("attn_v").T
        q = q.reshape(T, nh, D)
        k = k.reshape(T, nkv, D)
        v = v.reshape(T, nkv, D)
        for t in range(T):
            q[t] = _rope_rotate(q[t], t, cfg.rope_base)
            k[t] = _rope_rotate(k[t], t, cfg.rope_base)

        out = np.zeros((T, nh, D))
        scale = 1.0 / np.sqrt(D)
        for hd in range(nh):
            kv = hd // G
            scores = (q[:, hd] @ k[:, kv].T) * scale  # [T, T]
            mask = np.triu(np.ones((T, T), dtype=bool), k=1)
            scores[mask] = -np.inf
            scores -= scores.max(axis=-1, keepdims=True)
            p = np.exp(scores)
            p /= p.sum(axis=-1, keepdims=True)
            out[:, hd] = p @ v[:, kv]
        attn = out.reshape(T, nh * D)
        if f"blk.{L}.attn_sub_norm.weight" in weights:
            attn = _rms_norm(attn, w("attn_sub_norm"), cfg.rms_norm_eps)
        x = x + attn @ w("attn_output").T

        # FFN (SwiGLU)
        h = _rms_norm(x, w("ffn_norm"), cfg.rms_norm_eps)
        gate = _silu(h @ w("ffn_gate").T)
        up = h @ w("ffn_up").T
        gu = gate * up
        if f"blk.{L}.ffn_sub_norm.weight" in weights:
            gu = _rms_norm(gu, w("ffn_sub_norm"), cfg.rms_norm_eps)
        x = x + gu @ w("ffn_down").T

    x = _rms_norm(x, weights["output_norm.weight"].astype(np.float64),
                  cfg.rms_norm_eps)
    if "output.weight" in weights:
        lm = weights["output.weight"].astype(np.float64)
    else:
        lm = emb.astype(np.float64)
    return (x @ lm.T).astype(np.float32)


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity between two logit vectors
    (``crossval/src/logits_compare.rs:75``)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return float(a @ b / (na * nb))


def compare_logits(
    ours: np.ndarray,      # [T, V]
    theirs: np.ndarray,    # [T, V]
    threshold: float = 0.99,
) -> dict:
    """Per-position cosine comparison with first-divergence detection
    (``crossval/src/logits_compare.rs:55-98``)."""
    T = min(len(ours), len(theirs))
    sims = [cosine_similarity(ours[t], theirs[t]) for t in range(T)]
    first_div = next((t for t, s in enumerate(sims) if s < threshold), None)
    return {
        "positions": T,
        "cosine_similarities": sims,
        "min_cosine": min(sims) if sims else 1.0,
        "mean_cosine": float(np.mean(sims)) if sims else 1.0,
        "first_divergence": first_div,
        "passed": first_div is None,
        "threshold": threshold,
    }
