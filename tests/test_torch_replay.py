"""Deterministic replay from the port's receipts on the CPU, against the
JAX package's replay on the same GGUF: greedy and seeded requests replay
token for token, a tampered receipt diverges where it was changed, a
receipt without a request (or one that is not deterministic) is refused
with the JAX package's error, and a receipt the JAX engine wrote replays
on the port's engine."""

import pytest
import torch

from bitnet_tpu.config import EngineConfig as JEngineConfig
from bitnet_tpu.config import GenerationConfig as JGenerationConfig
from bitnet_tpu.engine.engine import InferenceEngine as JEngine
from bitnet_tpu.errors import InferenceError as JInferenceError
from bitnet_tpu.verify import receipts as jreceipts
from bitnet_tpu.verify.replay import replay_receipt as jreplay_receipt
from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
from bitnet_tpu_torch.engine.engine import InferenceEngine
from bitnet_tpu_torch.errors import InferenceError
from bitnet_tpu_torch.verify.receipts import InferenceReceipt, generate_receipt
from bitnet_tpu_torch.verify.replay import replay_receipt

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

CFG = dict(max_seq_len=64, kv_cache_dtype="f32", compute_dtype="f32")
GENS = {"greedy": dict(max_new_tokens=6, greedy=True),
        "seeded": dict(max_new_tokens=6, temperature=0.9, top_k=40, seed=123)}


@pytest.fixture(scope="module")
def engine(mini_gguf_qk256):
    return InferenceEngine.from_gguf(mini_gguf_qk256.path,
                                     EngineConfig(kernel_path="w2a8", **CFG),
                                     device="cpu")


@pytest.mark.parametrize("mode", ["greedy", "seeded"])
def test_replay_reproduces(engine, mode):
    out = engine.generate([2, 7, 11], GenerationConfig(**GENS[mode]))
    rec = generate_receipt(engine)
    assert rec.request["output_ids"] == out.token_ids
    assert rec.request["gen"]["seed"] == GENS[mode].get("seed")
    rep = replay_receipt(engine, InferenceReceipt.from_json(rec.to_json()))
    assert rep.matched and rep.first_divergence is None, rep.as_dict()
    assert rep.got == rep.expected == out.token_ids


@pytest.mark.parametrize("where", [0, 3, "short", "long"])
def test_replay_detects_a_divergence(engine, where):
    engine.generate([2, 7, 11], GenerationConfig(max_new_tokens=4, greedy=True))
    rec = generate_receipt(engine)
    out = rec.request["output_ids"]
    if where == "short":
        rec.request["output_ids"] = out[:2]
    elif where == "long":
        rec.request["output_ids"] = out + [5]
    else:
        out[where] = 9999                              # tampered
    rep = replay_receipt(engine, rec)
    assert not rep.matched
    assert rep.first_divergence == {"short": 2, "long": 4}.get(where, where)


@pytest.mark.parametrize("request_", [None, {"prompt_ids": [1], "output_ids": [2],
                                             "gen": {"seed": None, "greedy": False}}],
                         ids=["no_request", "not_deterministic"])
def test_replay_refuses_what_the_jax_replay_refuses(engine, mini_gguf_qk256, request_):
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(**CFG))
    with pytest.raises(InferenceError) as e:
        replay_receipt(engine, InferenceReceipt(request=request_))
    with pytest.raises(JInferenceError) as je_err:
        jreplay_receipt(je, jreceipts.InferenceReceipt(request=request_))
    assert str(e.value) == str(je_err.value)


def test_a_jax_receipt_replays_on_the_port(engine, mini_gguf_qk256):
    """The JAX engine's greedy receipt (path w2a8) replays token for token
    on the port's engine, as it does on the JAX engine.  (A seeded one
    would not: the two packages' samplers draw from different RNGs.)"""
    je = JEngine.from_gguf(mini_gguf_qk256.path, JEngineConfig(kernel_path="w2a8", **CFG))
    je.generate([3, 5, 8], JGenerationConfig(**GENS["greedy"]))
    jrec = jreceipts.generate_receipt(je)
    want = jreplay_receipt(je, jrec)
    got = replay_receipt(engine, InferenceReceipt.from_json(jrec.to_json()))
    assert want.matched and got.matched
    assert got.as_dict() == want.as_dict()
