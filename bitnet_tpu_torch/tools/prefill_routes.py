"""How far valid routes through the full-depth synthetic 2B model part,
at norm gains of one and at ``models.synthetic.condition_norms``'s gains.

Run on the card from the repository root:

    python -m bitnet_tpu_torch.tools.prefill_routes

For each gain setting the 2B fused engine of ``chip_smoke.py``'s requests
phase (int8 head, bf16 cache, S=1024, B=1) takes 500 random tokens (seed
19) and holds the last-token logits of a cold prefill against those of:
the same prefill again (``repeat``), a prefix-cache hit restoring the
first 480 rows (``hit``), 480 tokens prefilled then 20 decode steps
(``decode20``), and the same prefill with plain attention in place of
flash attention (``plain_attention``).  Each route computes the same
logits correctly; their cosines are the floor under which a cosine gate
cannot tell a fault from rounding.  One JSON line per setting, with the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
from unittest import mock

import torch

from ..config import EngineConfig
from ..device_probe import require_sm90
from ..engine.engine import InferenceEngine
from ..models import bitnet
from ..models.synthetic import BITNET_2B4T, build_synthetic, condition_norms
from ..ops.attention import attention


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.nn.functional.cosine_similarity(
        a.float().cpu(), b.float().cpu(), dim=0))


def routes(cfg, params, dev, tokens: list[int], m: int = 480) -> dict:
    """Cosines of each route's last-token logits against a cold prefill
    (the prefix is the first m tokens)."""
    ec = EngineConfig(max_seq_len=1024, kv_cache_dtype="bf16", logits_dtype="int8",
                      kernel_path="w2a8", fuse_projections=True)
    eng = InferenceEngine(cfg, params, ec, device=dev)
    hit = InferenceEngine(cfg, params, ec.replace(prefix_cache_tokens=4096), device=dev)
    with torch.inference_mode():
        cold = eng.prefill(tokens)[0].clone()
        out = {"repeat": eng.prefill(tokens)[0].clone()}
        hit.prefill(tokens[:m])
        out["hit"] = hit.prefill(tokens)[0].clone()
        eng.prefill(tokens[:m])
        for i, t in enumerate(tokens[m:]):
            lg = eng.decode_step(t, m + i)
        out["decode20"] = lg[0].clone()
        with mock.patch.object(bitnet, "flash_attention", attention):
            out["plain_attention"] = eng.prefill(tokens)[0].clone()
    res = {k: _cosine(v, cold) for k, v in out.items()}
    res["argmax_agree"] = sum(int(v.argmax()) == int(cold.argmax()) for v in out.values())
    return res


def main(argv=None) -> int:
    del argv
    require_sm90(0)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    g = torch.Generator().manual_seed(19)
    tokens = [int(t) for t in torch.randint(3, BITNET_2B4T.vocab_size, (500,),
                                            generator=g)]
    params = build_synthetic(BITNET_2B4T, seed=0, device=dev)
    for gains in ("one", "conditioned"):
        if gains == "conditioned":
            condition_norms(params, BITNET_2B4T)
        print(json.dumps({"gains": gains, "nvidia_smi": smi,
                          **routes(BITNET_2B4T, params, dev, tokens)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
