"""Classic GGML block-quant codecs: Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, and the
K-quants Q4_K and Q6_K (numpy, on the host at load time).

Own copy of ``bitnet_tpu/quant/ggml_classic.py``: the loader dequantizes
these types to dense linears, as the JAX loader does (``_to_float``,
``bitnet_tpu/models/loader.py:98-117``), so generic llama-family GGUFs
load and run.

Layouts (ggml-quants semantics, 32-element blocks):
- Q8_0: 34 B = f16 d + 32×i8 q;             v = q · d
- Q4_0: 18 B = f16 d + 16 B nibbles;        v = (q − 8) · d
- Q4_1: 20 B = f16 d + f16 m + 16 B;        v = q · d + m
- Q5_0: 22 B = f16 d + 4 B qh + 16 B;       v = (q5 − 16) · d
- Q5_1: 24 B = f16 d + f16 m + 4 B qh + 16 B; v = q5 · d + m
Nibble order: low nibbles of the 16 bytes are elements 0..15, high
nibbles are 16..31; qh holds each element's 5th bit (LSB-first).
"""

from __future__ import annotations

import numpy as np

from ..errors import QuantizationError

BLOCK = 32
BYTES = {"q8_0": 34, "q4_0": 18, "q4_1": 20, "q5_0": 22, "q5_1": 24}


def _blocks(payload, nelems: int, bpb: int, kind: str,
            block: int = BLOCK) -> np.ndarray:
    raw = np.frombuffer(payload, dtype=np.uint8) if isinstance(
        payload, (bytes, bytearray)) else np.ascontiguousarray(
        payload, np.uint8)
    if nelems % block != 0:
        raise QuantizationError(f"{kind}: nelems {nelems} % {block} != 0")
    nb = nelems // block
    if raw.size < nb * bpb:
        raise QuantizationError(
            f"{kind}: payload {raw.size} B < required {nb * bpb} B")
    return raw[: nb * bpb].reshape(nb, bpb)


def _f16(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b).view(np.float16)[:, 0].astype(np.float32)


def _nibbles(qs: np.ndarray) -> np.ndarray:
    """[nb, 16] bytes → [nb, 32] values: low nibbles then high nibbles."""
    lo = qs & 0x0F
    hi = qs >> 4
    return np.concatenate([lo, hi], axis=1).astype(np.int32)


def _qh_bits(qh: np.ndarray) -> np.ndarray:
    """[nb, 4] bytes → [nb, 32] per-element 5th bits (LSB-first u32)."""
    u = np.ascontiguousarray(qh).view(np.uint32)[:, 0]
    return ((u[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
            ).astype(np.int32)


# -- dequantizers -------------------------------------------------------------
def dequantize_q8_0(payload, nelems: int) -> np.ndarray:
    b = _blocks(payload, nelems, 34, "Q8_0")
    d = _f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return (q * d[:, None]).reshape(-1)


def dequantize_q4_0(payload, nelems: int) -> np.ndarray:
    b = _blocks(payload, nelems, 18, "Q4_0")
    d = _f16(b[:, 0:2])
    q = _nibbles(b[:, 2:18])
    return ((q - 8).astype(np.float32) * d[:, None]).reshape(-1)


def dequantize_q4_1(payload, nelems: int) -> np.ndarray:
    b = _blocks(payload, nelems, 20, "Q4_1")
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    q = _nibbles(b[:, 4:20]).astype(np.float32)
    return (q * d[:, None] + m[:, None]).reshape(-1)


def dequantize_q5_0(payload, nelems: int) -> np.ndarray:
    b = _blocks(payload, nelems, 22, "Q5_0")
    d = _f16(b[:, 0:2])
    qh = _qh_bits(b[:, 2:6])
    q = _nibbles(b[:, 6:22]) | (qh << 4)
    return ((q - 16).astype(np.float32) * d[:, None]).reshape(-1)


def dequantize_q5_1(payload, nelems: int) -> np.ndarray:
    b = _blocks(payload, nelems, 24, "Q5_1")
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = _qh_bits(b[:, 4:8])
    q = (_nibbles(b[:, 8:24]) | (qh << 4)).astype(np.float32)
    return (q * d[:, None] + m[:, None]).reshape(-1)


# -- K-quants (256-element super-blocks) --------------------------------------
QK_K = 256


def dequantize_q6_k(payload, nelems: int) -> np.ndarray:
    """Q6_K: 210 B = ql[128] + qh[64] + int8 scales[16] + f16 d.

    y[j] = d · scale[j//16] · (q6[j] − 32), with the 6-bit values split
    across low nibbles (ql) and 2-bit highs (qh) in ggml's two-half
    interleave (public ggml-quants spec; validated structurally — exact
    cross-validation against llama.cpp pending a real K-quant GGUF).
    """
    b = _blocks(payload, nelems, 210, "Q6_K", block=QK_K)
    nb = b.shape[0]
    ql = b[:, 0:128].astype(np.int32)
    qh = b[:, 128:192].astype(np.int32)
    sc = b[:, 192:208].view(np.int8).astype(np.float32)
    d = np.ascontiguousarray(b[:, 208:210]).view(np.float16)[:, 0]
    d = d.astype(np.float32)

    y = np.empty((nb, QK_K), np.float32)
    for half in range(2):                       # two 128-element halves
        qlh = ql[:, half * 64:(half + 1) * 64]  # [nb, 64]
        qhh = qh[:, half * 32:(half + 1) * 32]  # [nb, 32]
        sch = sc[:, half * 8:(half + 1) * 8]    # [nb, 8]
        base = half * 128
        l = np.arange(32)
        q1 = (qlh[:, l] & 0xF) | (((qhh[:, l] >> 0) & 3) << 4)
        q2 = (qlh[:, l + 32] & 0xF) | (((qhh[:, l] >> 2) & 3) << 4)
        q3 = (qlh[:, l] >> 4) | (((qhh[:, l] >> 4) & 3) << 4)
        q4 = (qlh[:, l + 32] >> 4) | (((qhh[:, l] >> 6) & 3) << 4)
        idx = l // 16                            # scale index within group
        y[:, base + l] = sch[:, idx] * (q1 - 32)
        y[:, base + 32 + l] = sch[:, idx + 2] * (q2 - 32)
        y[:, base + 64 + l] = sch[:, idx + 4] * (q3 - 32)
        y[:, base + 96 + l] = sch[:, idx + 6] * (q4 - 32)
    return (y * d[:, None]).reshape(-1)


def _scale_min_k4(j: int, scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """ggml get_scale_min_k4: 8 (scale, min) 6-bit pairs in 12 bytes."""
    if j < 4:
        sc = scales[:, j] & 63
        mn = scales[:, j + 4] & 63
    else:
        sc = (scales[:, j + 4] & 0xF) | ((scales[:, j - 4] >> 6) << 4)
        mn = (scales[:, j + 4] >> 4) | ((scales[:, j] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def dequantize_q4_k(payload, nelems: int) -> np.ndarray:
    """Q4_K: 144 B = f16 d + f16 dmin + scales[12] + qs[128].

    y = d·sc·q − dmin·m per 32-element sub-block (public ggml spec;
    validated structurally — see dequantize_q6_k note).
    """
    b = _blocks(payload, nelems, 144, "Q4_K", block=QK_K)
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    scales = b[:, 4:16].astype(np.int32)
    qs = b[:, 16:144].astype(np.int32)

    y = np.empty((b.shape[0], QK_K), np.float32)
    for j in range(4):                           # 4 × 64-element chunks
        sc1, m1 = _scale_min_k4(2 * j, scales)
        sc2, m2 = _scale_min_k4(2 * j + 1, scales)
        q = qs[:, j * 32:(j + 1) * 32]
        y[:, j * 64: j * 64 + 32] = (d * sc1)[:, None] * (q & 0xF) \
            - (dmin * m1)[:, None]
        y[:, j * 64 + 32: j * 64 + 64] = (d * sc2)[:, None] * (q >> 4) \
            - (dmin * m2)[:, None]
    return y.reshape(-1)


# -- quantizers (converter + round-trip tests) --------------------------------
def quantize_q8_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    if x.size % BLOCK != 0:
        raise QuantizationError("Q8_0 needs nelems % 32 == 0")
    xb = x.reshape(-1, BLOCK)
    amax = np.abs(xb).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    scale = np.where(d > 0, 1.0 / np.where(d > 0, d, 1), 0.0)
    q = np.clip(np.round(xb * scale[:, None]), -127, 127).astype(np.int8)
    out = np.empty((xb.shape[0], 34), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


def quantize_q4_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    if x.size % BLOCK != 0:
        raise QuantizationError("Q4_0 needs nelems % 32 == 0")
    xb = x.reshape(-1, BLOCK)
    # ggml: d = max-by-|.| / -8 (sign kept), q = round(x/d) + 8
    idx = np.abs(xb).argmax(axis=1)
    maxv = xb[np.arange(xb.shape[0]), idx]
    d = (maxv / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 0.0)
    q = np.clip(np.round(xb * inv[:, None]) + 8, 0, 15).astype(np.uint8)
    out = np.empty((xb.shape[0], 18), np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()
