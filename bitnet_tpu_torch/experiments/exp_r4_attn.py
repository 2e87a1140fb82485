"""Per-layer decode-attention microbench over resident caches, on the card.

Counterpart of ``experiments/exp_r4_attn.py``: an L-layer loop of one
attention variant over a cache stack that stays in device memory, at the
2B shapes (L = 30, 5 kv heads, 4 query heads each, D = 128), B = 8 and
S = 1024 by default, every slot's cache full (pos = S − 1).  Each variant
is the port's kernel for the JAX function of the same name in the script;
``stacked`` and ``stacked_inplace`` are the port's own, over the 5-D stack:
the two JAX functions have no caller, in the script or elsewhere, and these
variants give their kernels a layer loop that a user can run and time
beside their twins (K5 and the pool kernels):

  einsum  the new row written into a copy of the layer, then plain torch
          attention (the JAX einsum path)          plain torch
  v1b     decode_attention_batched                 K16
  v1q     decode_attention_quant_batched (int8)    K17
  v2b     decode_attention_batched_v2              K22
  v2q     decode_attention_quant_batched_v2 (int8) K23
  v2p     decode_attention_perb_v2                 K27
  perb    decode_attention                         K5
  v1kb    decode_attention_qkv_batched             K18
  v1kq    decode_attention_qkv_quant_batched       K19
  v2kb    decode_attention_qkv_batched_v2          K20
  v2kq    decode_attention_qkv_quant_batched_v2    K21
  stacked          decode_attention_stacked          K25
  stacked_inplace  decode_attention_stacked_inplace  K26 (the new rows
          written in place at pos, every layer)
  none    no attention (the loop's own floor)      plain torch
  paged   JAX's stock paged_attention               K33 (128-row pages in
          the stock layout [KV, B*S/128, 128, D], 4 pages a compute block,
          each slot's pages contiguous; ``pages_per_compute_block`` sets the
          TPU kernel's step and selects nothing on the card)

Usage, one variant per process as the script:

    ONLY=v2p python -m bitnet_tpu_torch.experiments.exp_r4_attn [--device cpu]

with ``B``, ``S`` and ``CHUNK`` in the environment.  ``CHUNK`` set the TPU
kernels' grid step; it selects nothing on the card.  The time is
:func:`~bitnet_tpu_torch.obs.timing.chain_timer`'s device time of the
L-layer loop (CUDA-graph replays), printed a layer beside the stream floor:
the k and v caches' bytes over the H100's 3.35 TB/s.  The k and v caches
are two tensors here (the script passed one array for both, which on the
card would serve the second read from the L2).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..device_probe import resolve_device
from ..obs.timing import chain_timer
from ..ops import decode_attention as da
from ..ops import decode_attention_v2 as da2
from ..ops.attention import attention
from ..ops.paged_attention import paged_attention

HBM_BPS = 3.35e12          # H100 SXM data sheet
KV, G, D = 5, 4, 128       # the 2B shapes
H = KV * G

# variant -> (wrapper, its arguments: "split" q/k/v apart over the flat
# stack, "perb" over one layer's 4-D cache, "stacked" over the 5-D stack,
# "rope" the raw q|k|v row; quant)
VARIANTS = {
    "v1b": (da.decode_attention_batched_v1, "split", False),
    "v1q": (da.decode_attention_quant_batched_v1, "split", True),
    "v2b": (da2.decode_attention_batched_v2, "split", False),
    "v2q": (da2.decode_attention_quant_batched_v2, "split", True),
    "v2p": (da2.decode_attention_perb_v2, "perb", False),
    "perb": (da.decode_attention, "split", False),
    "v1kb": (da.decode_attention_qkv_batched, "rope", False),
    "v1kq": (da.decode_attention_qkv_quant_batched, "rope", True),
    "v2kb": (da2.decode_attention_qkv_batched_v2, "rope", False),
    "v2kq": (da2.decode_attention_qkv_quant_batched_v2, "rope", True),
    "stacked": (da.decode_attention_stacked, "stacked", False),
    "stacked_inplace": (da.decode_attention_stacked_inplace, "stacked", False),
}
PLAIN = ("einsum", "none")
ALL = (*PLAIN[:1], *VARIANTS, PLAIN[1], "paged")


def make_variant(only: str, L: int = 30, B: int = 8, S: int = 1024,
                 device="cuda"):
    """The L-layer loop of variant ``only`` over resident caches.  Returns
    (step(carry, i) -> carry, make_carry(salt) -> carry, the kernel's
    wrapper or None, the stream floor in seconds a layer)."""
    if only == "paged":
        return _paged_variant(L, B, S, device)
    if only not in VARIANTS and only not in PLAIN:
        raise ValueError(f"unknown variant {only!r}; one of {', '.join(ALL)}")
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    fn, kind, quant = VARIANTS.get(only, (None, "plain", False))
    shape = (L, B, S, KV * D)
    if quant:
        kc, vc = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        scales = tuple(torch.rand((L, B, S, KV), generator=g, device=dev) * 0.015
                       + 0.005 for _ in range(2))
    else:
        kc, vc = ((torch.randn(shape, generator=g, device=dev) * 0.3
                   ).to(torch.bfloat16) for _ in range(2))
        scales = ()
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    kn, vn = (torch.randn((B, KV, D), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    ang = torch.rand((B, D // 2), generator=g, device=dev) * 6.283
    sin, cos = torch.sin(ang), torch.cos(ang)
    b_idx = torch.arange(B, device=dev)

    def attn(l, h):
        if kind == "split":
            return fn(l, h, kn, vn, kc, vc, *scales, pos)
        if kind == "perb":
            return fn(h, kn, vn, kc[l].view(B, S, KV, D), vc[l].view(B, S, KV, D), pos)
        if kind == "stacked":
            out = fn(l, h, kn, vn, kc.view(L, B, S, KV, D), vc.view(L, B, S, KV, D),
                     pos)
            return out[0] if isinstance(out, tuple) else out
        if only == "none":
            return h + kn.sum(dim=1, keepdim=True)
        # einsum: the new row written into a copy of the layer, then attention
        kcw = kc[l].view(B, S, KV, D).index_put((b_idx, pos.long()), kn)
        vcw = vc[l].view(B, S, KV, D).index_put((b_idx, pos.long()), vn)
        return attention(h[:, None], kcw, vcw, pos[:, None], pos + 1)[:, 0]

    if kind == "rope":
        def step(qkv, i):
            h = qkv
            for l in range(L):
                o = fn(l, h, sin, cos, kc, vc, *scales, pos, n_heads=H, n_kv=KV)[0]
                h = h * 0.98 + torch.cat([o, o[:, :2 * KV]], dim=1).to(h.dtype) * 0.01
            return h

        rows = H + 2 * KV
    else:
        def step(q, i):
            h = q
            for l in range(L):
                h = attn(l, h).to(h.dtype)
            return h * 0.5 + q

        rows = H

    def make_carry(salt):
        gc = torch.Generator(device=dev).manual_seed(salt)
        return (torch.randn((B, rows, D), generator=gc, device=dev)
                * (1 + salt % 3)).to(torch.bfloat16)

    floor = 2 * B * S * KV * D * (1 if quant else 2) / HBM_BPS
    return step, make_carry, fn, floor


PAGE, PAGES_PER_COMPUTE_BLOCK = 128, 4     # exp_r4_attn.py:67, :84


def _paged_variant(L: int, B: int, S: int, device):
    """``exp_r4_attn.py:63-88``: the L-layer loop of the stock paged
    attention (K33) over 128-row pages [L, KV, B*S/128, 128, D] bf16, slot
    b's pages b*S/128 … (b+1)*S/128 - 1, every slot at length S, v pages
    half the k pages; each layer's output is the next layer's q."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    npages = S // PAGE
    kp = (torch.randn((L, KV, B * npages, PAGE, D), generator=g, device=dev) * 0.3
          ).to(torch.bfloat16)
    vp = kp * 0.5
    pidx = (torch.arange(B, device=dev)[:, None] * npages
            + torch.arange(npages, device=dev)[None, :]).to(torch.int32)
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)

    def step(q, i):
        h = q
        for l in range(L):
            h = paged_attention(h, kp[l], vp[l], lengths, pidx).to(h.dtype)
        return h * 0.5 + q

    def make_carry(salt):
        gc = torch.Generator(device=dev).manual_seed(salt)
        return (torch.randn((B, H, D), generator=gc, device=dev)
                * (1 + salt % 3)).to(torch.bfloat16)

    floor = 2 * B * S * KV * D * 2 / HBM_BPS
    return step, make_carry, paged_attention, floor


def bench_variant(only: str, L: int = 30, B: int = 8, S: int = 1024,
                  device="cuda", n_hi: int = 24, n_lo: int = 6,
                  pairs: int = 3) -> dict:
    """Device seconds of the L-layer loop of ``only`` (host seconds on the
    CPU, tests only), printed and returned a layer beside the floor."""
    step, make_carry, fn, floor = make_variant(only, L, B, S, device)
    dt_s = chain_timer(step, make_carry, n_hi, n_lo, pairs=pairs)
    dev = make_carry(0).device
    print(f"{only}: {dt_s * 1e3:.3f} ms/scan = {dt_s / L * 1e6:.2f} us/layer "
          f"(stream floor {floor * 1e6:.2f} us/layer at 3.35 TB/s)", flush=True)
    return {"variant": only, "kernel": None if fn is None else fn.__name__,
            "L": L, "B": B, "S": S, "device": str(dev), "ms_per_scan": dt_s * 1e3,
            "us_per_layer": dt_s / L * 1e6, "floor_us_per_layer": floor * 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = os.environ.get("ONLY", "v2b")
    B = int(os.environ.get("B", "8"))
    S = int(os.environ.get("S", "1024"))
    chunk = os.environ.get("CHUNK")
    print(f"device={args.device} ONLY={only} B={B} S={S} chunk={chunk}", flush=True)
    if chunk:
        print(f"CHUNK={chunk} set the TPU kernels' grid step; it selects nothing "
              "on the card", flush=True)
    bench_variant(only, B=B, S=S, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
