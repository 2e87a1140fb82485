"""Where the card's decode path parts from the plain versions on the CPU.

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.parity_probe [--steps 6]

Each case builds one model from a seed and loads it into two engines, one
on the card (the CUDA kernels) and one on the CPU (the plain versions).
Both prefill the same prompt; then, for each decode step, both are fed
the same token (the card's greedy pick) and, before the step, the layers
are walked the way ``models.bitnet._decode_stacked`` walks them:

- local: each kernel on the card gets the CPU walk's exact inputs (and a
  copy of the CPU cache), so the difference of its output is its own.
  K1's int8 rows are compared element by element (``xq`` flips).  Each
  plain version is also run on the card on the same inputs: the floor
  that PyTorch's CPU and CUDA builds of the same ops leave.
- chained: each device carries its own hidden state and cache, as the
  engines do; the difference after each kernel shows how the local
  differences compound through int8 requantization.

The cases: ``small-b2`` (the two-slot f32 engine of
``tests/test_torch_cuda.py``) and ``full-b1`` (``chip_smoke.py``'s
2-layer full-width parity model), each at f32 and bf16 activations.  One
JSON line per case, with the card's name and power limit; everything
also goes to ``chiprun_out/parity_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..config import EngineConfig, ModelConfig
from ..device_probe import require_sm90
from ..engine.engine import InferenceEngine
from ..models.bitnet import _scale_vec
from ..models.synthetic import BITNET_2B4T, build_synthetic
from ..ops import _cuda
from ..ops import decode_attention_v2 as da
from ..ops import ternary_matmul as tm

SMALL = ModelConfig(vocab_size=512, hidden_size=512, intermediate_size=768,
                    num_layers=2, num_heads=8, num_kv_heads=2, head_dim=64,
                    max_seq_len=256)
# name -> (config, B, params seed, prompt)
CASES = {
    "small-b2": (SMALL, 2, 3, list(range(7, 47))),
    "full-b1": (BITNET_2B4T.replace(num_layers=2), 1, 7, [int(t) for t in torch.randint(
        0, BITNET_2B4T.vocab_size, (24,), generator=torch.Generator().manual_seed(3))]),
}
K1_OPS = ("qkv", "o", "gate_up", "down")


class _Side:
    """One engine's params, and its K1 / K2 calls by the kernel (on the
    card) or by the plain version."""

    def __init__(self, eng: InferenceEngine):
        self.cfg, self.p, self.dev = eng.cfg, eng.params, eng.device
        self.sv = {n: _scale_vec(getattr(self.p.blocks, n))
                   for n in ("wqkv", "wo", "w_gateup", "w_down")}

    def k1(self, l, name, x, gamma_name, plain, glu=False, resid=None):
        lin = getattr(self.p.blocks, name)
        gamma = getattr(self.p.blocks, gamma_name)
        eps = self.cfg.rms_norm_eps
        if plain or self.dev.type == "cpu":
            g_l = None if gamma is None else gamma[l]
            xq = tm.quantize_rows(tm.w2a8_preamble_plain(x, g_l, eps, glu))[0]
            return tm.ternary_matmul_w2a8_normed_plain(
                x, lin.packed[l], self.sv[name][l], g_l, eps, glu, resid, lin.n), xq
        out, xq, _, _ = tm._w2a8_normed_cuda(l, x, lin.packed, self.sv[name], gamma,
                                             lin.k, lin.n, eps, glu, resid)
        return out, xq

    def k2(self, l, qkv, sin_r, cos_r, kc, vc, pos, plain):
        nh, nkv = self.cfg.num_heads, self.cfg.num_kv_heads
        if plain or self.dev.type == "cpu":
            return da.decode_attention_qkv_plain(qkv, sin_r, cos_r, kc[l], vc[l],
                                                 pos, nh, nkv)
        return da.decode_attention_qkv(l, qkv, sin_r, cos_r, kc, vc, pos, nh, nkv)


def walk(side: _Side, tok: int, position: int, kc, vc, lengths, ref=None,
         plain=False) -> dict:
    """One decode step's layers on ``side`` without writing the cache.
    Returns every op's output keyed (op, layer); with ``ref`` (the CPU
    walk's record) each op reads the reference's inputs instead of its own."""
    cfg, dev = side.cfg, side.dev
    L, B, S = kc.shape[0], kc.shape[1], kc.shape[2]
    nh, nkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qpos = torch.full((B,), S, dtype=torch.int64)
    qpos[0] = position
    rp = torch.clamp(qpos, max=side.p.rope_sin.shape[0] - 1).to(dev)
    sin_r = side.p.rope_sin[rp].contiguous()
    cos_r = side.p.rope_cos[rp].contiguous()
    pos = lengths.to(device=dev, dtype=torch.int32).contiguous()
    toks = torch.zeros((B,), dtype=torch.int64)
    toks[0] = tok
    rec = {("down", -1): side.p.embed[toks.to(dev)]}

    def get(op, l):
        return (rec if ref is None else ref)[(op, l)].to(dev)

    for l in range(L):
        rec[("qkv", l)], rec[("qkv.xq", l)] = side.k1(
            l, "wqkv", get("down", l - 1), "attn_norm", plain)
        attn, rec[("k_row", l)], rec[("v_row", l)] = side.k2(
            l, get("qkv", l).view(B, nh + 2 * nkv, D), sin_r, cos_r, kc, vc, pos, plain)
        rec[("attn", l)] = attn.reshape(B, nh * D)
        rec[("o", l)], rec[("o.xq", l)] = side.k1(
            l, "wo", get("attn", l), "attn_sub_norm", plain, resid=get("down", l - 1))
        rec[("gate_up", l)], rec[("gate_up.xq", l)] = side.k1(
            l, "w_gateup", get("o", l), "ffn_norm", plain)
        rec[("down", l)], rec[("down.xq", l)] = side.k1(
            l, "w_down", get("gate_up", l), "ffn_sub_norm", plain, glu=True,
            resid=get("o", l))
    return rec


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def compare(got: dict, want: dict, L: int) -> dict:
    """Per op: relative L2 difference per layer; for K1 also the int8
    activations that differ (flips) per layer and the largest flip."""
    out = {}
    for op in K1_OPS + ("attn", "k_row"):
        row = {"rel": [_rel(got[(op, l)], want[(op, l)]) for l in range(L)]}
        if op in K1_OPS:
            d = [(got[(op + ".xq", l)].cpu().int() - want[(op + ".xq", l)].int()).abs()
                 for l in range(L)]
            row["xq_flips"] = [int((x > 0).sum()) for x in d]
            row["xq_max_step"] = max(int(x.max()) for x in d)
            row["xq_n"] = int(want[(op + ".xq", 0)].numel())
        out[op] = row
    return out


def run_case(name: str, dtype: str, steps: int, dev) -> dict:
    cfg, B, seed, prompt = CASES[name]
    params = build_synthetic(cfg, seed=seed, device="cpu")
    ec = EngineConfig(max_seq_len=256, max_batch_size=B, compute_dtype=dtype,
                      logits_dtype="int8", kv_cache_dtype="bf16")
    eg = InferenceEngine(cfg, params, ec, device=dev)
    ecpu = InferenceEngine(cfg, params, ec, device="cpu")
    g, c = _Side(eg), _Side(ecpu)
    lg, lc = eg.prefill(prompt), ecpu.prefill(prompt)
    T, L = len(prompt), cfg.num_layers
    kd = (eg.cache.k[:, 0, :T].cpu().float() - ecpu.cache.k[:, 0, :T].float())
    res = {"case": name, "dtype": dtype, "B": B, "prompt": T,
           "prefill": {"logits_cos": float(torch.nn.functional.cosine_similarity(
                           lg[0].float().cpu(), lc[0].float(), dim=0)),
                       "k_cache_elems_differ_frac": float((kd != 0).float().mean()),
                       "k_cache_rel": _rel(eg.cache.k[:, 0, :T], ecpu.cache.k[:, 0, :T])},
           "steps": []}
    local_k, local_p, chained = [], [], []
    pos = T
    for _ in range(steps):
        kc, vc = ecpu.cache.k.to(dev), ecpu.cache.v.to(dev)
        tok = int(lg[0].argmax())
        ref = walk(c, tok, pos, ecpu.cache.k, ecpu.cache.v, ecpu.cache.lengths)
        local_k.append(compare(walk(g, tok, pos, kc, vc, ecpu.cache.lengths, ref=ref),
                               ref, L))
        local_p.append(compare(walk(g, tok, pos, kc, vc, ecpu.cache.lengths, ref=ref,
                                    plain=True), ref, L))
        chained.append(compare(walk(g, tok, pos, eg.cache.k, eg.cache.v,
                                    eg.cache.lengths), ref, L))
        a, b = lg[0].float().cpu(), lc[0].float()
        top2 = torch.topk(b, 2).values
        res["steps"].append({
            "pos": pos, "logits_cos": float(torch.nn.functional.cosine_similarity(
                a, b, dim=0)),
            "argmax_cuda": tok, "argmax_cpu": int(b.argmax()),
            "cpu_top2_margin": float(top2[0] - top2[1]),
            "logits_max_abs_diff": float((a - b).abs().max())})
        lg, lc = eg.decode_step(tok, pos), ecpu.decode_step(tok, pos)
        pos += 1

    def mean_over_steps(rows, op, key):
        return [sum(r[op][key][l] for r in rows) / len(rows) for l in range(L)]

    for label, rows in (("local_kernel", local_k), ("local_plain_on_card", local_p),
                        ("chained", chained)):
        res[label] = {op: {k: mean_over_steps(rows, op, k)
                           for k in ("rel", "xq_flips") if k in rows[0][op]}
                      for op in rows[0]}
        for op in K1_OPS:
            res[label][op]["xq_max_step"] = max(r[op]["xq_max_step"] for r in rows)
            res[label][op]["xq_n"] = rows[0][op]["xq_n"]
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--dtypes", default="f32,bf16")
    args = ap.parse_args(argv)
    require_sm90(0)
    dev = torch.device("cuda", 0)
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    results = []
    for name in args.cases.split(","):
        for dtype in args.dtypes.split(","):
            r = run_case(name, dtype, args.steps, dev)
            r["card"] = smi
            results.append(r)
            print(json.dumps(r), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "parity_probe.json").write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
