"""The one-launch split-S decode attention's host side, on the CPU: the
split plan (``attn_plan``), the scratch and arrival counters a call takes,
and the C entry points against their ctypes signatures.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py -k attn``)."""

import re

import pytest
import torch

from bitnet_tpu_torch.ops import _cuda
from bitnet_tpu_torch.ops import decode_attention as dk
from bitnet_tpu_torch.ops import decode_attention_v2 as da

SRC = (_cuda.CSRC / "decode_attention.cu").read_text()
# (B, KV, S) of the models' decode steps: the 2B-4T's 5 and the 8B-class
# model's 8 kv heads, one sequence or a pool, short and long caches
SHAPES = [(B, KV, S) for B in (1, 8, 64) for KV in (1, 5, 8)
          for S in (1000, 4096, 32768)]
SMS = (132, 78)               # an H100 SXM, a part of a card


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("B,KV,S", SHAPES)
def test_attn_plan_is_a_power_of_two_split(B, KV, S, sms, itemsize):
    """R is a power of two of at least one 64-row stage, and a slot has at
    most 256 splits."""
    R = dk.attn_plan(B, KV, S, sms, itemsize)
    assert R >= dk.ATTN_MIN_ROWS and R & (R - 1) == 0
    assert -(-S // R) <= dk.ATTN_MAX_SPLITS
    # the least such R: half of it would give some SM a second block (a
    # third over a 1-byte cache) or too many splits, unless R is the least
    # split or covers S already
    if R > dk.ATTN_MIN_ROWS and R // 2 < S:
        half = -(-S // (R // 2))
        per_sm = 2 if itemsize == 1 else 1
        assert B * KV * half > per_sm * sms or half > dk.ATTN_MAX_SPLITS


@pytest.mark.parametrize("itemsize", [1, 2])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("KV,S", [(5, 4096), (8, 4096), (5, 2048), (8, 8192)])
def test_attn_plan_fills_the_sms_at_b1(KV, S, sms, itemsize):
    """One long sequence spreads over more than half of the SMs, at most
    one block each (over a 1-byte cache more than one block an SM, at most
    two)."""
    per_sm = 2 if itemsize == 1 else 1
    R = dk.attn_plan(1, KV, S, sms, itemsize)
    blocks = KV * -(-S // R)
    assert per_sm * sms / 2 < blocks <= per_sm * sms


@pytest.mark.parametrize("KV", [5, 8])
@pytest.mark.parametrize("S", [1024, 4096])
def test_attn_plan_takes_one_split_where_the_pool_fills_the_card(KV, S):
    """A pool whose B * KV blocks alone cover the SMs runs one split a slot:
    no partials, no counter."""
    for B in (64, 32):
        for itemsize in (1, 2):
            if B * KV > 132 * (2 if itemsize == 1 else 1):
                assert dk.attn_plan(B, KV, S, 132, itemsize) >= S


def test_attn_plan_matches_the_kernel_constants():
    """The plan's least split is the kernel's stage (SR) and its split cap
    the kernel's MAX_SPLITS."""
    assert _constant("SR") == dk.ATTN_MIN_ROWS
    assert _constant("MAX_SPLITS") == dk.ATTN_MAX_SPLITS


def test_counter_buffer_covers_every_pool():
    """One counter a (b, kv head): the buffer holds a pool of 64 slots of
    every model's kv heads many times over."""
    assert dk.ATTN_COUNTERS >= 64 * 32
    assert dk.ATTN_COUNTERS & (dk.ATTN_COUNTERS - 1) == 0


@pytest.mark.parametrize("B,KV,S,G,D", [(1, 5, 4096, 4, 128), (8, 5, 1024, 4, 128),
                                        (64, 8, 1024, 4, 128), (3, 2, 1000, 8, 64)])
def test_attn_scratch_layout(monkeypatch, B, KV, S, G, D):
    """A call's scratch: the partials' ctx [B, KV, NS, G, D] first (its
    float4 rows 16-byte aligned), then their (m, d) pairs; NS = ceil(S/R)
    for the plan's R; the device's counters."""
    counters = torch.zeros(dk.ATTN_COUNTERS, dtype=torch.int32)
    monkeypatch.setattr(dk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(dk, "attn_counters", lambda dev: counters)
    R, part, md, cnt = dk._attn_scratch("K5", torch.device("cpu"), B, KV, S, G, D, 2)
    NS = -(-S // R)
    assert R == dk.attn_plan(B, KV, S, 132, 2)
    assert part.dtype == torch.float32 and part.numel() == B * KV * NS * G * (D + 2)
    assert md == 4 * B * KV * NS * G * D and md % 16 == 0
    assert cnt is counters


def test_attn_scratch_refuses_more_slots_than_counters(monkeypatch):
    monkeypatch.setattr(dk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(dk, "attn_counters", lambda dev: None)
    with pytest.raises(ValueError, match="arrival counters"):
        dk._attn_scratch("K8", torch.device("cpu"), dk.ATTN_COUNTERS, 2, 64, 4, 128, 2)


ENTRY_POINTS = ("bn_decode_attention_qkv", "bn_decode_attention_qkv_quant",
                "bn_decode_attention", "bn_decode_attention_quant")


@pytest.mark.parametrize("fn", ENTRY_POINTS)
def test_entry_points_take_the_split_and_the_counters(fn):
    """Each attention entry point takes R after S and the counters after
    the partials, and its ctypes signature has a c_int and a c_void_p
    there."""
    params = re.search(rf"^int {fn}\(([^)]*)\)\s*\{{", SRC, re.M | re.S).group(1)
    names = [re.split(r"[\s*]+", a.strip())[-1] for a in params.split(",")]
    sig = _cuda.SIGNATURES["decode_attention"][fn]
    assert len(sig) == len(names)
    assert names[names.index("S") + 1] == "R" and sig[names.index("R")] is _cuda.I
    assert names[names.index("part_ctx") + 1] == "counters"
    assert sig[names.index("counters")] is _cuda.P


def test_no_path_keeps_the_two_pass_kernels():
    assert "attn_split" not in SRC and "attn_combine" not in SRC
    assert len(re.findall(r"<<<", SRC)) == 2       # the attention kernel and K3
    assert not hasattr(dk, "SPLIT")


@pytest.mark.parametrize("wrapper,plain", [
    (dk.decode_attention, dk.decode_attention_plain),
    (da.decode_attention_batched, da.decode_attention_batched_plain)])
def test_cpu_calls_run_the_plain_version_and_take_no_counters(monkeypatch, wrapper, plain):
    """On CPU tensors a wrapper runs its plain version: no plan, no scratch,
    no counters, no launch counted."""
    def refuse(*a):
        raise AssertionError("the CPU path took the kernel's scratch")
    monkeypatch.setattr(dk, "_attn_scratch", refuse)
    g = torch.Generator().manual_seed(0)
    L, B, S, H, KV, D = 2, 3, 130, 8, 2, 64
    kc, vc = (torch.randn((L, B, S, KV * D), generator=g).bfloat16() for _ in range(2))
    q = torch.randn((B, H, D), generator=g).bfloat16()
    kn, vn = (torch.randn((B, KV, D), generator=g).bfloat16() for _ in range(2))
    pos = torch.tensor([0, 64, 130], dtype=torch.int32)
    before = wrapper.launches
    out = wrapper(1, q, kn, vn, kc, vc, pos)
    assert wrapper.launches == before
    assert torch.equal(out, plain(q, kn, vn, kc[1], vc[1], pos))


def test_timeline_stamps_find_their_lines():
    """``tools/attn_timeline`` stamps an instrumented copy of the kernel
    beside fixed source lines: every one is in the source once."""
    from bitnet_tpu_torch.tools import attn_timeline

    out = attn_timeline.instrumented_source(SRC)
    assert out.count("BN_T(") + out.count("BN_C(") == len(attn_timeline.ANCHORS) + 2
    assert "bn_attn_stamps" in out
