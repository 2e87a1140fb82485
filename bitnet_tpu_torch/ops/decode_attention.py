"""v1 flash decode attention: K5 and the seven other v1 kernels, their
plain versions, and the split-S launchers and plain pieces that every
decode-attention wrapper of the port shares.

Every decode-attention function of the JAX package is one of two: the
new token's q, k, v arrive apart (RoPE done, rounded to the cache dtype,
K5's function) or as the raw fused q|k|v row (RoPE, and for a quantized
cache the new rows' quantization, inside the kernel, K2's function).  On
the card both run the split-S kernel of ``csrc/decode_attention.cu``
(``attn_decode``), one launch a call: its grid (splits, kv heads, B)
makes the TPU kernels' per-b grid, whole-batch grid, stacked or
per-layer-slice forms and v1 or v2 bodies one kernel.  A block streams
the R cache rows of its split through TMA (R from :func:`attn_plan`, so
the blocks give each SM at most one, two over a 1-byte cache), and the last block of a (b, kv
head) to finish folds the splits' partials and the new token, counting
the arrivals in a per-device counter buffer that every call leaves zero
(:func:`attn_counters`).  Each wrapper launches that kernel under its own
counter; its plain version follows its Pallas kernel, down to the chunks
of cache rows against whose running maxima it rounds its softmax weights
to bf16 (the only place where the TPU kernels of one function differ
numerically).

Wrappers here, each over layer ``l`` of the flat stacks [L, B, S, KV*D]:

- K5 :func:`decode_attention` ← ``decode_attention``
  (``bitnet_tpu/ops/decode_attention.py:922``, pallas_call ``:960``), the
  generic ``block_forward`` decode and plan ``flash``;
- K13 :func:`decode_attention_qkv_v1` ← ``decode_attention_qkv``
  (``:440``, pallas_call ``:488``), plan ``qkv`` and the generic path's
  ``BITNET_ROPE_FUSED=1`` branch;
- K14 :func:`decode_attention_qkv_quant_v1` ← ``decode_attention_qkv_quant``
  (``:808``, ``:859``), plan ``qkv_quant``;
- K15 :func:`decode_attention_quant` ← ``decode_attention_quant``
  (``:618``, ``:655``), plan ``flash_quant``;
- K16 :func:`decode_attention_batched_v1` ← ``decode_attention_batched``
  (``:1076``, ``:1114``), plan ``batched``;
- K17 :func:`decode_attention_quant_batched_v1` ←
  ``decode_attention_quant_batched`` (``:1226``, ``:1262``), plan
  ``quant_batched``;
- K18 :func:`decode_attention_qkv_batched` ← ``decode_attention_qkv_batched``
  (``:1389``, ``:1421``), plan ``qkv_batched``;
- K19 :func:`decode_attention_qkv_quant_batched` ←
  ``decode_attention_qkv_quant_batched`` (``:1572``, ``:1609``), plan
  ``qkv_quant_batched``;
- K25 :func:`decode_attention_stacked` ← ``decode_attention_stacked``
  (``:149``, ``:204``) and K26 :func:`decode_attention_stacked_inplace` ←
  ``decode_attention_stacked_inplace`` (``:271``, ``:334``): K5 over layer
  ``l`` of a 5-D stack [L, B, S, KV, D], K26 also writing the new rows in
  place.  No model path calls them, in either package.

The unquantized kernels take a bf16 or an f32 cache (an f32 cache rounds
nothing to bf16); a quantized cache keeps its f32 scales in the canonical
``[L, B, S, KV]`` layout; the kernels read them with strides.
"""

from __future__ import annotations

import functools
import threading

import torch

from . import _cuda

NEG_INF = -1e30
DEFAULT_CHUNK = 1024  # the JAX kernels' largest sequence chunk (one grid step)
# the CUDA kernel's splits: at least one 64-row stage, at most 256 splits
# (csrc SR, MAX_SPLITS); the (b, kv head) counters one buffer a device holds
ATTN_MIN_ROWS = 64
ATTN_MAX_SPLITS = 256
ATTN_COUNTERS = 4096
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the quantized caches the kernels stream (csrc `cache` argument), and the
# unquantized ones
QUANT_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
FLOAT_CODE = {torch.bfloat16: 2, torch.float32: 3}


# --------------------------------------------------------------------------
# the plain pieces
# --------------------------------------------------------------------------
def quantize_kv(x: torch.Tensor, dtype: torch.dtype):
    """Per-vector absmax quantization of KV rows (``_quantize_kv``,
    ``bitnet_tpu/models/bitnet.py:1171-1182``): x [..., D] → (codes in
    ``dtype``, scale [...] f32) with scale = max(absmax, 1e-8) / qmax
    (127 for int8, 448 for fp8-e4m3) and codes x / scale, rounded half to
    even and clipped to ±127 for int8."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, an f32 ulp away from the quotient the kernels and
    # the reference compute
    qmax = absmax.new_full((), 127.0 if dtype == torch.int8 else 448.0)
    scale = torch.clamp(absmax, min=1e-8) / qmax
    q = xf / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(dtype), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """codes [..., D] × scale [...] → f32 rows (the round trip)."""
    return codes.to(torch.float32) * scale[..., None]


def v1_chunk(S: int, top: int = DEFAULT_CHUNK) -> int:
    """The per-b kernels' chunk: min(top, S), halved until it divides S
    (1024 for the v1 kernels, 512 for the per-b v2 kernel)."""
    chunk = min(top, S)
    while S % chunk:
        chunk //= 2
    return chunk


def pick_group(B: int) -> tuple[int, int]:
    """The v2 wrappers' batch groups (``_pick_group``,
    ``decode_attention_v2.py:1130``): the TPU's VMEM scope holds at most 16
    slots' scratch.  The CUDA kernels need no groups; the plain versions
    use the group size only to choose the TPU kernels' chunk."""
    if B <= 16:
        return B, 1
    for bg in (8, 4, 2, 1):
        if B % bg == 0:
            return bg, B // bg
    return 1, B


def pick_chunk(S: int, B: int, itemsize: int) -> int:
    """The cache rows a whole-batch TPU grid step reads (``_pick_chunk``,
    ``decode_attention_v2.py:1145``; the v1 whole-batch wrappers use its
    2048-row budget for every cache dtype, ``decode_attention.py:1108``)."""
    rows = 2048 if itemsize >= 2 else 4096
    chunk = min(max(128, 1 << ((rows // B).bit_length() - 1)), S, DEFAULT_CHUNK)
    while S % chunk:
        chunk //= 2
    return chunk


def online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos, chunk,
                         k_scale_l=None, v_scale_l=None):
    """The JAX kernels' online softmax over one layer's cache, chunk by
    chunk: qf [B, KV, G, D] f32 (the cache-dot operand), m [B, KV, G] and
    ctx [B, KV, G, D] the new token's init (d = 1); caches [B, S, KV*D]
    read as f32; pos [B] valid rows.  The weights e round to bf16 before
    the PV product; a quantized cache's scales [B, S, KV] multiply the
    scores after the dot and e before that rounding, while d sums the
    unscaled e.  Returns ctx / d [B, KV, G, D] f32."""
    B, KV, G, D = qf.shape
    S = k_cache_l.shape[1]
    scale = float(D) ** -0.5
    ew = torch.bfloat16 if k_scale_l is not None else k_cache_l.dtype
    d = torch.ones_like(m)
    kc = k_cache_l.reshape(B, S, KV, D)
    vc = v_cache_l.reshape(B, S, KV, D)
    for c0 in range(0, S, chunk):
        s = torch.einsum("bkgd,bskd->bkgs", qf,
                         kc[:, c0:c0 + chunk].to(torch.float32)) * scale
        if k_scale_l is not None:
            s = s * k_scale_l[:, c0:c0 + chunk].permute(0, 2, 1)[:, :, None, :]
        idx = torch.arange(c0, c0 + chunk, device=qf.device)
        s = torch.where((idx[None, :] < pos[:, None])[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        d = d * alpha + e.sum(-1)
        if v_scale_l is not None:
            e = e * v_scale_l[:, c0:c0 + chunk].permute(0, 2, 1)[:, :, None, :]
        r = torch.einsum("bkgs,bskd->bkgd", e.to(ew).to(torch.float32),
                         vc[:, c0:c0 + chunk].to(torch.float32))
        ctx = ctx * alpha[..., None] + r
        m = m_new
    return ctx / d[..., None]


def new_token_init(q, k_new, v_new, dtype):
    """The softmax init of the kernels that take q and the new rows apart
    (K5's function): all three rounded to ``dtype``; m = q·k_new/√D and
    ctx = v_new.  Returns (qf [B, KV, G, D], m, ctx) in f32."""
    B, H, D = q.shape
    KV = k_new.shape[1]
    qf = q.to(dtype).to(torch.float32).reshape(B, KV, H // KV, D)
    kn = k_new.to(dtype).to(torch.float32)
    vn = v_new.to(dtype).to(torch.float32)
    m = (qf * kn[:, :, None, :]).sum(-1) * float(D) ** -0.5
    return qf, m, vn[:, :, None, :].expand(qf.shape).clone()


def split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos, chunk,
                          k_scale_l=None, v_scale_l=None):
    """K5's function on one layer, as the Pallas kernels compute it: q
    [B, H, D] roped, k_new / v_new [B, KV, D] (a quantized cache's rows
    round-tripped), caches [B, S, KV*D] PRE-write, pos [B] valid rows.
    q, k_new and v_new round to the cache dtype (bf16 for a quantized
    cache); the online softmax starts from the new token and walks the
    cache in ``chunk`` rows.  Returns [B, H, D] in q's dtype."""
    dt = torch.bfloat16 if k_scale_l is not None else k_cache_l.dtype
    qf, m, ctx = new_token_init(q, k_new, v_new, dt)
    out = online_softmax_plain(qf, m, ctx, k_cache_l, v_cache_l, pos, chunk,
                               k_scale_l, v_scale_l)
    return out.reshape(q.shape).to(q.dtype)


def rope_rows(rows: torch.Tensor, sin_row: torch.Tensor,
              cos_row: torch.Tensor) -> torch.Tensor:
    """Split-layout RoPE of [B, n, D] f32 rows by [B, D/2] tables, written
    as the JAX kernels do: x·[cos,cos] + [-x_hi, x_lo]·[sin,sin]."""
    half = rows.shape[-1] // 2
    cs = torch.cat([cos_row, cos_row], dim=-1)[:, None, :]
    sn = torch.cat([sin_row, sin_row], dim=-1)[:, None, :]
    rot = torch.cat([-rows[..., half:], rows[..., :half]], dim=-1)
    return rows * cs + rot * sn


def qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l, pos,
                        n_heads, n_kv, chunk, k_scale_l=None, v_scale_l=None):
    """K2's function on one layer, as the rope-fused Pallas kernels
    compute it: qkv [B, H+2KV, D] raw; RoPE of q and k in f32; the new
    token's init from the f32 roped k row and the f32 v row (a quantized
    cache: the rows quantized per kv head by :func:`quantize_kv` and the
    init from their round trip); q rounded to bf16 for the cache dot; the
    cache walked in ``chunk`` rows.  Returns (attn [B, H, D] in qkv's
    dtype, k_row, v_row [B, KV, D] in the cache dtype), or for a quantized
    cache (attn, k codes, v codes, k_s, v_s [B, KV] f32)."""
    B, _, D = qkv.shape
    H, KV = n_heads, n_kv
    cdt = k_cache_l.dtype
    rows = qkv.to(torch.float32)
    qk = rope_rows(rows[:, : H + KV], sin_row, cos_row)
    q = qk[:, :H].reshape(B, KV, H // KV, D)                 # f32 roped
    k_new, v_new = qk[:, H:], rows[:, H + KV:]               # [B, KV, D] f32
    if k_scale_l is None:
        new_rows = (k_new.to(cdt), v_new.to(cdt))
        q_dot = q.to(cdt).to(torch.float32)
    else:
        kq, ks = quantize_kv(k_new, cdt)
        vq, vs = quantize_kv(v_new, cdt)
        k_new, v_new = dequantize_kv(kq, ks), dequantize_kv(vq, vs)
        new_rows = (kq, vq, ks, vs)
        q_dot = q.to(torch.bfloat16).to(torch.float32)
    m = (q * k_new[:, :, None, :]).sum(-1) * float(D) ** -0.5
    ctx = v_new[:, :, None, :].expand(q.shape).clone()
    out = online_softmax_plain(q_dot, m, ctx, k_cache_l, v_cache_l, pos, chunk,
                               k_scale_l, v_scale_l)
    return (out.reshape(B, H, D).to(qkv.dtype), *new_rows)


# --------------------------------------------------------------------------
# the plan, the counters, argument checks and the two launchers
# --------------------------------------------------------------------------
def attn_plan(B: int, KV: int, S: int, sms: int, itemsize: int = 2) -> int:
    """R, the cache rows of one split of the CUDA kernel: the least power
    of two >= 64 whose B·KV·ceil(S/R) blocks give the ``sms`` SMs at most
    one each (two over a 1-byte cache, ``itemsize`` 1), one split a slot
    where B·KV alone fills them, and at most 256 splits.  A bf16 block keeps
    up to three stages of its split in flight, so one block an SM already
    draws the card's bandwidth, and fewer splits leave less to combine; a
    1-byte block's stage is bound by its warps' code conversions, which a
    second block an SM overlaps (the split sweep of
    ``tools/kernel_profile.py``)."""
    blocks = sms * (2 if itemsize == 1 else 1)
    R = ATTN_MIN_ROWS
    while R < S and (B * KV * -(-S // R) > blocks or -(-S // R) > ATTN_MAX_SPLITS):
        R *= 2
    return R


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS: dict[int, torch.Tensor] = {}
# device index -> (thread id, what) of a scheduler's loop that drives it
_OWNERS: dict[int, tuple[int, str]] = {}


def claim_device(device: torch.device, what: str) -> None:
    """Reserve ``device``'s decode attention for the calling thread (a
    scheduler's loop): the arrival counters are one buffer a device and the
    kernels that reset them must run in order on one stream, so another
    thread's decode on the device raises (:func:`attn_counters`)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    me = threading.get_ident()
    owner = _OWNERS.get(index)
    if owner is not None and owner[0] != me:
        raise RuntimeError(f"cuda:{index} is already driven by {owner[1]} in another "
                           "thread")
    _OWNERS[index] = (me, what)


def release_device(device: torch.device, owner: int) -> None:
    """End thread ``owner``'s reservation of ``device`` (if it holds it)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    if _OWNERS.get(index, (None,))[0] == owner:
        del _OWNERS[index]


def attn_counters(device: torch.device) -> torch.Tensor:
    """The int32 [ATTN_COUNTERS] arrival counters of ``device``, zeroed
    once, shared by the split-S kernel and K33 (``ops/paged_attention``) on
    one stream: the kernel's last block of each (b, kv head) resets its counter,
    so every call, and every replay of a CUDA graph, finds them zero.  The
    first call on a device must run outside a graph capture (a capture
    does not run the zeroing).  ``cuda`` without an index is the current
    device, whose counters the kernels' tensors (always indexed) find."""
    index = torch.cuda.current_device() if device.index is None else device.index
    owner = _OWNERS.get(index)
    if owner is not None and owner[0] != threading.get_ident():
        raise RuntimeError(
            f"decode attention on cuda:{index} from another thread while {owner[1]} "
            "drives the device: the kernels' arrival counters are one buffer a "
            "device, used in order on one stream; decode through the scheduler "
            "(submit) or shut it down first")
    buf = _COUNTERS.get(index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first decode-attention call on a device must "
                               "run before a CUDA graph capture")
        buf = _COUNTERS[index] = torch.zeros(ATTN_COUNTERS, dtype=torch.int32,
                                             device=torch.device("cuda", index))
    return buf


def _attn_scratch(what, dev, B, KV, S, G, D, itemsize):
    """(R, partials, md offset in bytes, counters) of one call over a cache
    of ``itemsize``-byte elements: the partials' ctx [B, KV, NS, G, D] then
    their (m, d) [B, KV, NS, G, 2] in one f32 buffer, ctx first so its
    float4 rows stay aligned."""
    if B * KV > ATTN_COUNTERS:
        raise ValueError(f"{what}: B*KV = {B * KV} exceeds the {ATTN_COUNTERS} "
                         "arrival counters")
    R = attn_plan(B, KV, S, _sm_count(dev.index), itemsize)
    NS = -(-S // R)
    n_ctx = B * KV * NS * G * D
    part = torch.empty(n_ctx + B * KV * NS * G * 2, dtype=torch.float32, device=dev)
    return R, part, 4 * n_ctx, attn_counters(dev)


def check_layer_args(l, q, k_new, v_new, k_cache, v_cache):
    B, H, D = q.shape
    L, Bc, S, KVD = k_cache.shape
    KV = k_new.shape[1]
    if (tuple(k_new.shape) != (B, KV, D) or tuple(v_new.shape) != (B, KV, D)
            or KVD != KV * D or Bc != B or H % KV):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k_new "
                         f"{tuple(k_new.shape)}, cache {tuple(k_cache.shape)}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")


def check_qkv_args(l, qkv, sin_row, cos_row, k_cache, v_cache, n_heads, n_kv):
    B, R, D = qkv.shape
    L, Bc, S, KVD = k_cache.shape
    if R != n_heads + 2 * n_kv or KVD != n_kv * D or Bc != B:
        raise ValueError(f"shape mismatch: qkv {tuple(qkv.shape)}, cache "
                         f"{tuple(k_cache.shape)}, H={n_heads} KV={n_kv}")
    if tuple(v_cache.shape) != tuple(k_cache.shape) or not 0 <= l < L:
        raise ValueError("v_cache must match k_cache; l in range")
    if tuple(sin_row.shape) != (B, D // 2) or tuple(cos_row.shape) != (B, D // 2):
        raise ValueError(f"sin/cos rows must be [{B}, {D // 2}]")


def launch_split_attention(what: str, l: int, q, k_new, v_new, k_cache,
                           v_cache, pos, k_scale=None, v_scale=None,
                           write_pos=None):
    """The split-S kernel without RoPE over layer ``l`` of the flat stacks
    [L, B, S, KV*D]: a bf16 or f32 cache, or an int8 / fp8 cache with its
    f32 scale stacks [L, B, S, KV].  With ``write_pos`` [B] int32 (K26, an
    unquantized cache) the combine also writes the new rows, cast to
    the cache dtype, at those rows of layer ``l`` in place.  Checks what the
    CUDA kernel takes and launches it; counts nothing (each wrapper counts
    its own launches)."""
    B, H, D = q.shape
    L, _, S, _ = k_cache.shape
    KV = k_new.shape[1]
    quant = k_scale is not None
    cache_ok = (k_cache.dtype in QUANT_CODE if quant
                else k_cache.dtype in FLOAT_CODE)
    if (not q.is_cuda or q.dtype not in _DTYPE_CODE or k_new.dtype != q.dtype
            or v_new.dtype != q.dtype or not cache_ok
            or v_cache.dtype != k_cache.dtype or D not in (64, 128)
            or H // KV > 8 or (quant and write_pos is not None)):
        raise ValueError(
            f"{what} takes CUDA bf16/f32 q, k_new, v_new of one dtype, a "
            f"{'int8/fp8' if quant else 'bf16/f32'} cache, D in (64, 128) and "
            f"H/KV <= 8; got {q.device} {q.dtype}, {k_new.dtype}, "
            f"{k_cache.dtype}, D={D}, H={H}, KV={KV}")
    tensors = (q, k_new, v_new, k_cache, v_cache, pos) + (
        (k_scale, v_scale) if quant else ()) + (
        (write_pos,) if write_pos is not None else ())
    dev_i = q.get_device()
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous on q's device")
    if pos.dtype != torch.int32 or pos.shape != (B,) or (
            write_pos is not None and (write_pos.dtype != torch.int32
                                       or write_pos.shape != (B,))):
        raise ValueError("pos (and write_pos) must be int32 [B]")
    if quant and (k_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (L, B, S, KV)
                  or tuple(v_scale.shape) != (L, B, S, KV)):
        raise ValueError(f"{what}: scales must be f32 [{L}, {B}, {S}, {KV}]")
    dev = q.device
    R, part, md, counters = _attn_scratch(what, dev, B, KV, S, H // KV, D,
                                          k_cache.element_size())
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    layer = l * k_cache.stride(0) * k_cache.element_size()   # bytes to layer l
    args = (q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr() + layer, v_cache.data_ptr() + layer)
    tail = (pos.data_ptr(), B, H, KV, D, S, R, float(D) ** -0.5, out.data_ptr(),
            part.data_ptr() + md, part.data_ptr(), counters.data_ptr(),
            _DTYPE_CODE[q.dtype])
    lib = _cuda.library("decode_attention")
    if quant:
        sl = 4 * l * k_scale.stride(0)
        rc = lib.bn_decode_attention_quant(
            *args, k_scale.data_ptr() + sl, v_scale.data_ptr() + sl, *tail,
            QUANT_CODE[k_cache.dtype], _cuda.stream_ptr(dev))
    else:
        wp = None if write_pos is None else write_pos.data_ptr()
        rc = lib.bn_decode_attention(*args, pos.data_ptr(), wp, *tail[1:],
                                     FLOAT_CODE[k_cache.dtype],
                                     _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, what)
    return out


def launch_qkv_attention(what, l, qkv, sin_row, cos_row, k_cache, v_cache,
                         pos, n_heads, n_kv, k_scale=None, v_scale=None):
    """The split-S kernel with RoPE (a bf16 or f32 cache, or an int8 / fp8
    cache with its scale stacks, quantizing the new rows) over layer ``l``;
    counts nothing.  Returns what :func:`qkv_attention_plain` returns."""
    B, _, D = qkv.shape
    L, _, S, _ = k_cache.shape
    quant = k_scale is not None
    G = n_heads // n_kv
    cache_ok = (k_cache.dtype in QUANT_CODE if quant
                else k_cache.dtype in FLOAT_CODE)
    if (not qkv.is_cuda or qkv.dtype not in _DTYPE_CODE or not cache_ok
            or v_cache.dtype != k_cache.dtype or D not in (64, 128)
            or n_heads % n_kv or G > 8):
        raise ValueError(
            f"{what} takes CUDA bf16/f32 qkv, a "
            f"{'int8/fp8' if quant else 'bf16/f32'} cache, D in (64, 128) and "
            f"H/KV <= 8; got {qkv.device} {qkv.dtype}, {k_cache.dtype}, "
            f"D={D}, H={n_heads}, KV={n_kv}")
    dev_i = qkv.get_device()
    tensors = (qkv, sin_row, cos_row, k_cache, v_cache, pos) + (
        (k_scale, v_scale) if quant else ())
    if any(t.get_device() != dev_i or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} operands must be contiguous on qkv's device")
    if sin_row.dtype != torch.float32 or pos.dtype != torch.int32:
        raise ValueError("sin/cos rows must be f32 and pos int32")
    if quant and (k_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != (L, B, S, n_kv)
                  or tuple(v_scale.shape) != (L, B, S, n_kv)):
        raise ValueError(f"{what}: scales must be f32 [{L}, {B}, {S}, {n_kv}]")
    dev = qkv.device
    R, part, md, counters = _attn_scratch(what, dev, B, n_kv, S, G, D,
                                          k_cache.element_size())
    out = torch.empty((B, n_heads, D), dtype=qkv.dtype, device=dev)
    # the new rows (and scales) apart: a view of one buffer would be an ATen op
    k_row, v_row = (torch.empty((B, n_kv, D), dtype=k_cache.dtype, device=dev)
                    for _ in range(2))
    layer = l * k_cache.stride(0) * k_cache.element_size()   # bytes to layer l
    head = (qkv.data_ptr(), sin_row.data_ptr(), cos_row.data_ptr(),
            k_cache.data_ptr() + layer, v_cache.data_ptr() + layer)
    dims = (pos.data_ptr(), B, n_heads, n_kv, D, S, R, float(D) ** -0.5,
            out.data_ptr(), k_row.data_ptr(), v_row.data_ptr())
    parts = (part.data_ptr() + md, part.data_ptr(), counters.data_ptr(),
             _DTYPE_CODE[qkv.dtype])
    lib = _cuda.library("decode_attention")
    if quant:
        sl = 4 * l * k_scale.stride(0)
        k_s, v_s = (torch.empty((B, n_kv), dtype=torch.float32, device=dev)
                    for _ in range(2))
        rc = lib.bn_decode_attention_qkv_quant(
            *head, k_scale.data_ptr() + sl, v_scale.data_ptr() + sl, *dims,
            k_s.data_ptr(), v_s.data_ptr(), *parts,
            QUANT_CODE[k_cache.dtype], _cuda.stream_ptr(dev))
    else:
        rc = lib.bn_decode_attention_qkv(*head, *dims, *parts,
                                         FLOAT_CODE[k_cache.dtype],
                                         _cuda.stream_ptr(dev))
    _cuda.check(lib, "decode_attention", rc, what)
    if quant:
        return out, k_row, v_row, k_s, v_s
    return out, k_row, v_row


def split_call(wrapper, what, plain, l, q, k_new, v_new, k_cache, v_cache, pos,
               k_scale=None, v_scale=None):
    """A no-RoPE wrapper's body: check; for CPU tensors ``plain`` on layer
    ``l`` (``plain(q, k_new, v_new, k_l, v_l[, ks_l, vs_l], pos)``); for
    CUDA tensors the split-S kernel, counted on ``wrapper.launches``."""
    check_layer_args(l, q, k_new, v_new, k_cache, v_cache)
    if q.device.type == "cpu":
        scales = () if k_scale is None else (k_scale[l], v_scale[l])
        return plain(q, k_new, v_new, k_cache[l], v_cache[l], *scales, pos)
    out = launch_split_attention(what, l, q, k_new, v_new, k_cache, v_cache,
                                 pos, k_scale, v_scale)
    wrapper.launches += 1
    return out


def qkv_call(wrapper, what, plain, l, qkv, sin_row, cos_row, k_cache, v_cache,
             pos, n_heads, n_kv, k_scale=None, v_scale=None):
    """A rope-fused wrapper's body: check; for CPU tensors ``plain`` on
    layer ``l`` (``plain(qkv, sin, cos, k_l, v_l[, ks_l, vs_l], pos, H,
    KV)``); for CUDA tensors the split-S kernel with RoPE, counted on
    ``wrapper.launches``."""
    check_qkv_args(l, qkv, sin_row, cos_row, k_cache, v_cache, n_heads, n_kv)
    if qkv.device.type == "cpu":
        scales = () if k_scale is None else (k_scale[l], v_scale[l])
        return plain(qkv, sin_row, cos_row, k_cache[l], v_cache[l], *scales,
                     pos, n_heads, n_kv)
    out = launch_qkv_attention(what, l, qkv, sin_row, cos_row, k_cache, v_cache,
                               pos, n_heads, n_kv, k_scale, v_scale)
    wrapper.launches += 1
    return out


# --------------------------------------------------------------------------
# K5: q and the new rows apart, a bf16 or f32 cache, per-b v1 chunks
# --------------------------------------------------------------------------
def decode_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos):
    """K5 on one layer, as the JAX kernel computes it: q [B, H, D] (roped),
    k_new / v_new [B, KV, D], caches [B, S, KV*D] (PRE-write), pos [B]
    valid rows.  q, k_new and v_new are cast to the cache dtype; the online
    softmax starts from the new token (m = q·k_new/√D, d = 1, ctx = v_new)
    and walks the cache in chunks of min(1024, S) rows, rounding its
    weights to the cache dtype before the PV product.  Returns [B, H, D]
    in q's dtype."""
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 v1_chunk(k_cache_l.shape[1]))


def decode_attention(l: int, q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K5 over layer ``l`` of the flat stacks [L, B, S, KV*D].

    q [B, H, D] roped, k_new / v_new [B, KV, D] (k roped), all in one
    dtype (bf16/f32); pos [B] int32 = rows already in the cache.  Returns
    attn [B, H, D] in q's dtype.  Writes nothing."""
    return split_call(decode_attention, "K5", decode_attention_plain, l, q,
                      k_new, v_new, k_cache, v_cache, pos)


decode_attention.launches = 0


# --------------------------------------------------------------------------
# K13, K14: the rope-fused per-b v1 kernels (B ≤ 2 under BITNET_B1_ATTN=v1)
# --------------------------------------------------------------------------
def decode_attention_qkv_v1_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                                  pos, n_heads, n_kv):
    """K13 on one layer: K2's function in the v1 chunks of min(1024, S)."""
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv, v1_chunk(k_cache_l.shape[1]))


def decode_attention_qkv_v1(l: int, qkv: torch.Tensor, sin_row: torch.Tensor,
                            cos_row: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: torch.Tensor,
                            n_heads: int, n_kv: int):
    """K13 over layer ``l`` of the flat bf16 / f32 stacks: qkv [B, H+2KV, D] raw
    (bf16/f32), sin/cos rows [B, D/2] f32, pos [B] int32 rows already
    cached.  Returns (attn [B, H, D], the roped k row and the v row
    [B, KV, D] in the cache dtype) — the JAX kernel keeps both rows in f32
    for the new token's init, as K2 does."""
    return qkv_call(decode_attention_qkv_v1, "K13", decode_attention_qkv_v1_plain,
                    l, qkv, sin_row, cos_row, k_cache, v_cache, pos, n_heads, n_kv)


decode_attention_qkv_v1.launches = 0


def decode_attention_qkv_quant_v1_plain(qkv, sin_row, cos_row, k_cache_l,
                                        v_cache_l, k_scale_l, v_scale_l, pos,
                                        n_heads, n_kv):
    """K14 on one layer: K7's function in the v1 chunks of min(1024, S)."""
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv, v1_chunk(k_cache_l.shape[1]),
                               k_scale_l, v_scale_l)


def decode_attention_qkv_quant_v1(l: int, qkv: torch.Tensor,
                                  sin_row: torch.Tensor, cos_row: torch.Tensor,
                                  k_cache: torch.Tensor, v_cache: torch.Tensor,
                                  k_scale: torch.Tensor, v_scale: torch.Tensor,
                                  pos: torch.Tensor, n_heads: int, n_kv: int):
    """K14: K13 over an int8 / fp8 stack and its f32 scale stacks
    [L, B, S, KV].  Returns (attn, k codes, v codes [B, KV, D], k_s, v_s
    [B, KV] f32)."""
    return qkv_call(decode_attention_qkv_quant_v1, "K14",
                    decode_attention_qkv_quant_v1_plain, l, qkv, sin_row,
                    cos_row, k_cache, v_cache, pos, n_heads, n_kv, k_scale,
                    v_scale)


decode_attention_qkv_quant_v1.launches = 0


# --------------------------------------------------------------------------
# K15: K5 over a quantized cache (plan flash_quant)
# --------------------------------------------------------------------------
def decode_attention_quant_plain(q, k_new, v_new, k_cache_l, v_cache_l,
                                 k_scale_l, v_scale_l, pos):
    """K15 on one layer: q, k_new, v_new (round-tripped rows) rounded to
    bf16, the codes read as bf16, scores scaled by the k scales after the
    dot, weights by the v scales before their bf16 rounding (``:590-608``);
    chunks of min(1024, S)."""
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 v1_chunk(k_cache_l.shape[1]), k_scale_l,
                                 v_scale_l)


def decode_attention_quant(l: int, q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """K15 over layer ``l`` of the flat int8 / fp8 stacks and their f32
    scale stacks [L, B, S, KV]; q [B, H, D] roped, k_new / v_new the new
    rows after the quantization round trip.  Returns [B, H, D] in q's
    dtype."""
    return split_call(decode_attention_quant, "K15", decode_attention_quant_plain,
                      l, q, k_new, v_new, k_cache, v_cache, pos, k_scale, v_scale)


decode_attention_quant.launches = 0


# --------------------------------------------------------------------------
# K16, K17: the whole-batch v1 kernels (plan batched / quant_batched)
# --------------------------------------------------------------------------
def decode_attention_batched_v1_plain(q, k_new, v_new, k_cache_l, v_cache_l,
                                      pos):
    """K16 on one layer: K5's function in the v1 whole-batch chunks (a
    2048-row budget over the whole pool, ``:1108``)."""
    B, S = q.shape[0], k_cache_l.shape[1]
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 pick_chunk(S, B, 2))


def decode_attention_batched_v1(l: int, q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                pos: torch.Tensor) -> torch.Tensor:
    """K16 over layer ``l`` of the flat bf16 / f32 stacks for a pool: the
    arguments of K5."""
    return split_call(decode_attention_batched_v1, "K16",
                      decode_attention_batched_v1_plain, l, q, k_new, v_new,
                      k_cache, v_cache, pos)


decode_attention_batched_v1.launches = 0


def decode_attention_quant_batched_v1_plain(q, k_new, v_new, k_cache_l,
                                            v_cache_l, k_scale_l, v_scale_l,
                                            pos):
    """K17 on one layer: K15's function in the v1 whole-batch chunks (the
    same 2048-row budget as bf16, ``:1256``)."""
    B, S = q.shape[0], k_cache_l.shape[1]
    return split_attention_plain(q, k_new, v_new, k_cache_l, v_cache_l, pos,
                                 pick_chunk(S, B, 2), k_scale_l, v_scale_l)


def decode_attention_quant_batched_v1(l: int, q: torch.Tensor,
                                      k_new: torch.Tensor, v_new: torch.Tensor,
                                      k_cache: torch.Tensor,
                                      v_cache: torch.Tensor,
                                      k_scale: torch.Tensor,
                                      v_scale: torch.Tensor,
                                      pos: torch.Tensor) -> torch.Tensor:
    """K17 over layer ``l`` of the flat int8 / fp8 stacks for a pool: the
    arguments of K15."""
    return split_call(decode_attention_quant_batched_v1, "K17",
                      decode_attention_quant_batched_v1_plain, l, q, k_new,
                      v_new, k_cache, v_cache, pos, k_scale, v_scale)


decode_attention_quant_batched_v1.launches = 0


# --------------------------------------------------------------------------
# K18, K19: the rope-fused whole-batch v1 kernels (BITNET_BATCHED_ATTN=1)
# --------------------------------------------------------------------------
def decode_attention_qkv_batched_plain(qkv, sin_row, cos_row, k_cache_l,
                                       v_cache_l, pos, n_heads, n_kv):
    """K18 on one layer: K2's function in the v1 whole-batch chunks."""
    B, S = qkv.shape[0], k_cache_l.shape[1]
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv, pick_chunk(S, B, 2))


def decode_attention_qkv_batched(l: int, qkv: torch.Tensor,
                                 sin_row: torch.Tensor, cos_row: torch.Tensor,
                                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                                 pos: torch.Tensor, n_heads: int, n_kv: int):
    """K18 over layer ``l`` of the flat bf16 / f32 stacks for a pool: the
    arguments and results of K13."""
    return qkv_call(decode_attention_qkv_batched, "K18",
                    decode_attention_qkv_batched_plain, l, qkv, sin_row,
                    cos_row, k_cache, v_cache, pos, n_heads, n_kv)


decode_attention_qkv_batched.launches = 0


def decode_attention_qkv_quant_batched_plain(qkv, sin_row, cos_row, k_cache_l,
                                             v_cache_l, k_scale_l, v_scale_l,
                                             pos, n_heads, n_kv):
    """K19 on one layer: K7's function in the v1 whole-batch chunks (the
    2048-row budget, ``:1602``)."""
    B, S = qkv.shape[0], k_cache_l.shape[1]
    return qkv_attention_plain(qkv, sin_row, cos_row, k_cache_l, v_cache_l,
                               pos, n_heads, n_kv, pick_chunk(S, B, 2),
                               k_scale_l, v_scale_l)


def decode_attention_qkv_quant_batched(l: int, qkv: torch.Tensor,
                                       sin_row: torch.Tensor,
                                       cos_row: torch.Tensor,
                                       k_cache: torch.Tensor,
                                       v_cache: torch.Tensor,
                                       k_scale: torch.Tensor,
                                       v_scale: torch.Tensor,
                                       pos: torch.Tensor, n_heads: int,
                                       n_kv: int):
    """K19 over layer ``l`` of the flat int8 / fp8 stacks for a pool: the
    arguments and results of K14."""
    return qkv_call(decode_attention_qkv_quant_batched, "K19",
                    decode_attention_qkv_quant_batched_plain, l, qkv, sin_row,
                    cos_row, k_cache, v_cache, pos, n_heads, n_kv, k_scale,
                    v_scale)


decode_attention_qkv_quant_batched.launches = 0


# --------------------------------------------------------------------------
# K25, K26: the 5-D stacked-cache kernels (no model caller in either package)
# --------------------------------------------------------------------------
def _flat_stack(k_cache: torch.Tensor, v_cache: torch.Tensor):
    """[L, B, S, KV, D] stacks → the flat [L, B, S, KV*D] views (the same
    memory, as the JAX wrapper's free reshape)."""
    if k_cache.dim() != 5 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"caches must be one [L, B, S, KV, D] shape; got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    L, B, S, KV, D = k_cache.shape
    return (k_cache.view(L, B, S, KV * D), v_cache.view(L, B, S, KV * D))


# K25's plain version is K5's: the stacked Pallas kernel runs K5's body over
# the same chunks of min(1024, S) rows
decode_attention_stacked_plain = decode_attention_plain


def decode_attention_stacked(l: int, q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             pos: torch.Tensor) -> torch.Tensor:
    """K25 ← ``decode_attention_stacked``
    (``bitnet_tpu/ops/decode_attention.py:149``, pallas_call ``:204``): K5
    on layer ``l`` of the 5-D stacks [L, B, S, KV, D] (bf16 or f32, PRE-
    write); q [B, H, D] roped, k_new / v_new [B, KV, D], cast to the cache
    dtype; pos [B] int32 rows already cached.  Returns [B, H, D] in q's
    dtype."""
    kf, vf = _flat_stack(k_cache, v_cache)
    return split_call(decode_attention_stacked, "K25",
                      decode_attention_stacked_plain, l, q, k_new, v_new, kf,
                      vf, pos)


decode_attention_stacked.launches = 0


def decode_attention_stacked_inplace_plain(q, k_new, v_new, k_cache_l,
                                           v_cache_l, pos, write_pos):
    """K26 on one layer view [B, S, KV*D]: K25's attention over the
    PRE-write rows, then the new rows cast to the cache dtype written in
    place at ``write_pos[b]``, dropped outside [0, S) (the JAX kernel's
    row mask).  Returns attn [B, H, D] in q's dtype."""
    attn = decode_attention_stacked_plain(q, k_new, v_new, k_cache_l,
                                          v_cache_l, pos)
    B, S, KVD = k_cache_l.shape
    wp = write_pos.to(torch.int64)
    keep = (wp >= 0) & (wp < S)
    b = torch.arange(B, device=q.device)[keep]
    k_cache_l[b, wp[keep]] = k_new[keep].reshape(-1, KVD).to(k_cache_l.dtype)
    v_cache_l[b, wp[keep]] = v_new[keep].reshape(-1, KVD).to(v_cache_l.dtype)
    return attn


def decode_attention_stacked_inplace(l: int, q: torch.Tensor,
                                     k_new: torch.Tensor, v_new: torch.Tensor,
                                     k_cache: torch.Tensor,
                                     v_cache: torch.Tensor, pos: torch.Tensor,
                                     write_pos: torch.Tensor | None = None):
    """K26 ← ``decode_attention_stacked_inplace`` (``:271``, pallas_call
    ``:334``): K25, and the new k / v rows (cast to the cache dtype)
    written into layer ``l`` of the caller's stacks at ``write_pos`` [B]
    int32 (default ``pos``), dropped outside [0, S).  Attention reads the
    PRE-write cache, so a ``write_pos < pos`` attends over the old row and
    the new token.  Returns (attn [B, H, D], k_cache, v_cache): the
    caller's own tensors, written in place (JAX donates and aliases them)."""
    kf, vf = _flat_stack(k_cache, v_cache)
    wp = pos if write_pos is None else write_pos
    check_layer_args(l, q, k_new, v_new, kf, vf)
    if q.device.type == "cpu":
        attn = decode_attention_stacked_inplace_plain(q, k_new, v_new, kf[l],
                                                      vf[l], pos, wp)
    else:
        attn = launch_split_attention("K26", l, q, k_new, v_new, kf, vf, pos,
                                      write_pos=wp)
        decode_attention_stacked_inplace.launches += 1
    return attn, k_cache, v_cache


decode_attention_stacked_inplace.launches = 0
