"""Deterministic replay from honest-compute receipts.

Counterpart of ``bitnet_tpu/verify/replay.py`` (SURVEY.md §5:
"deterministic replay from receipts").  A receipt that carries its
generation request (prompt tokens, sampling config with its seed, output
tokens) is a reproducibility contract: feeding the same request back
through the engine must reproduce the exact token sequence.  A divergence
means nondeterminism (a different kernel path, changed weights, a kernel
whose sums depend on the launch), which strict mode exists to catch.
"""

from __future__ import annotations

import dataclasses

from ..config import GenerationConfig
from ..errors import InferenceError
from .receipts import InferenceReceipt


@dataclasses.dataclass
class ReplayReport:
    matched: bool
    expected: list[int]
    got: list[int]
    first_divergence: int | None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def replay_receipt(engine, receipt: InferenceReceipt) -> ReplayReport:
    """Re-run the receipt's request; compare outputs token for token."""
    req = receipt.request
    if not req:
        raise InferenceError(
            "receipt carries no request block — regenerate with a current "
            "engine (request recording ships with receipts >= 1.0.0)")
    g = dict(req.get("gen") or {})
    if g.get("seed") is None and not g.get("greedy"):
        raise InferenceError(
            "receipt request is non-deterministic (no seed, not greedy); "
            "replay would be meaningless")
    gen_cfg = GenerationConfig(
        max_new_tokens=int(g.get("max_new_tokens", 128)),
        temperature=float(g.get("temperature", 1.0)),
        top_k=int(g.get("top_k", 0)),
        top_p=float(g.get("top_p", 1.0)),
        min_p=float(g.get("min_p", 0.0)),
        repetition_penalty=float(g.get("repetition_penalty", 1.0)),
        seed=g.get("seed"),
        greedy=bool(g.get("greedy", False)),
    )
    expected = [int(t) for t in req.get("output_ids", [])]
    result = engine.generate([int(t) for t in req["prompt_ids"]], gen_cfg)
    got = result.token_ids
    first_div = next(
        (i for i, (a, b) in enumerate(zip(expected, got)) if a != b), None)
    if first_div is None and len(expected) != len(got):
        first_div = min(len(expected), len(got))
    return ReplayReport(
        matched=first_div is None,
        expected=expected,
        got=got,
        first_divergence=first_div,
    )
