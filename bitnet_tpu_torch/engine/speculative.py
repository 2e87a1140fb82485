"""Speculative decoding: draft k tokens, verify them in one target forward.

Counterpart of ``bitnet_tpu/engine/speculative.py``: ``SpeculativeConfig``,
``AcceptanceStats``, the ``DraftSource`` protocol with ``NgramDraft``
(prompt lookup: the tokens that followed the longest matching suffix) and
``EngineDraft`` (a second engine decoding greedily), and
``SpeculativeDecoder.generate`` with the ``greedy`` (accept while the
target's argmax is the draft token) and ``threshold`` (accept while the
target's softmax probability of the draft token is at least
``accept_threshold``) policies.  Rejected draft rows are never removed from
the cache: the length is rolled back and the next round overwrites them.

How the port runs it on the card:

- **The verify** (:class:`VerifyStep`) is one forward over T = k_eff + 1
  tokens a slot plus the head, captured as one CUDA graph per (T, B, cache
  dtype, kernel path, ``BITNET_*`` knobs) over a static input buffer
  (tokens, positions, valid lengths, real counts) and replayed each round:
  an eager forward at T > 1 costs about a prefill.  It writes the engine's
  cache and ``lengths`` in place, so the engine's decode segments keep
  their buffers; a verify whose captured buffers the engine no longer holds
  is dropped, as ``InferenceEngine._get_segment`` drops its segments.
- **The acceptance reads** run in the same graph: each row's argmax and,
  under ``threshold``, each draft token's probability; one copy of
  [2T-1] numbers comes back, never the [T, V] logits.
- **EngineDraft** drafts its k tokens as one greedy decode segment of
  K = k (``engine/loop.py``): one replay on the card, k eager steps on
  the CPU, the tokens of k single steps either way.

On the CPU (when the caller asks for it, as the tests do) the same body
runs eagerly.  On the card a failed capture raises: no round runs an eager
forward there.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Protocol

import numpy as np
import torch

from ..config import GenerationConfig
from ..errors import InferenceError
from ..models.bitnet import forward, logits as model_logits
from ..ops import registry
from .loop import buffer_addresses, capture_graph
from .stop import StopCriteria, StopReason


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    num_draft_tokens: int = 4
    policy: str = "greedy"            # 'greedy' | 'threshold'
    accept_threshold: float = 0.3     # used by 'threshold'
    max_ngram: int = 3                # NgramDraft suffix length

    def __post_init__(self):
        if self.num_draft_tokens < 1:
            raise InferenceError("num_draft_tokens must be >= 1")
        if self.policy not in ("greedy", "threshold"):
            raise InferenceError(f"unknown policy {self.policy!r}")


@dataclasses.dataclass
class AcceptanceStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    def as_dict(self) -> dict:
        return {
            "rounds": self.rounds,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": round(self.acceptance_rate, 4),
        }


class DraftSource(Protocol):
    def begin(self, tokens: list[int]) -> None: ...
    def propose(self, tokens: list[int], k: int) -> list[int]: ...


class NgramDraft:
    """Prompt-lookup drafting: longest-suffix match in the history."""

    def __init__(self, max_ngram: int = 3, fallback_token: int = 0):
        self.max_ngram = max_ngram
        self.fallback_token = fallback_token

    def begin(self, tokens: list[int]) -> None:
        pass

    def propose(self, tokens: list[int], k: int) -> list[int]:
        n = len(tokens)
        for m in range(min(self.max_ngram, n - 1), 0, -1):
            suffix = tokens[n - m:]
            # the most recent earlier occurrence of the suffix
            for start in range(n - m - 1, -1, -1):
                if tokens[start:start + m] == suffix:
                    cont = tokens[start + m:start + m + k]
                    if cont:
                        out = list(cont)
                        while len(out) < k:
                            out.append(out[-1])
                        return out
        return [tokens[-1] if tokens else self.fallback_token] * k


class EngineDraft:
    """Draft from a (smaller) ``InferenceEngine`` decoding greedily: k
    steps as one greedy decode segment of K = k over its slot 0."""

    GREEDY = GenerationConfig(greedy=True, repetition_window=0)

    def __init__(self, engine):
        self.engine = engine

    def begin(self, tokens: list[int]) -> None:
        self._logits = self.engine.prefill(tokens)
        self._ctx = list(tokens)

    def propose(self, tokens: list[int], k: int) -> list[int]:
        # resync when the accepted sequence is not what was drafted: compare
        # the content, not the length (with k-1 drafts accepted the lengths
        # match, but the draft cache holds the rejected k-th token)
        if list(tokens) != self._ctx:
            self.begin(tokens)
        eng = self.engine
        B = eng.engine_cfg.max_batch_size
        dev = eng.device
        pos = torch.full((B,), eng.engine_cfg.max_seq_len, dtype=torch.int32)
        pos[0] = len(tokens)
        active = torch.zeros((B,), dtype=torch.int32)
        active[0] = 1
        seg = eng._get_segment(self.GREEDY, k)
        with torch.inference_mode():
            toks, self._logits, _, _ = seg(
                self._logits, pos.to(dev), torch.zeros((B, 0), dtype=torch.int64,
                                                       device=dev),
                None, active.to(dev))
            out = toks[0].tolist()
        self._ctx = list(tokens) + out
        return out


class VerifyStep:
    """``step(inp)``: one forward of T tokens a slot over ``cache`` (written
    in place, ``lengths += n_real``), the head on the first ``rows`` slots,
    each row's argmax and, with ``probs``, each draft token's softmax
    probability (the acceptance reads of ``bitnet_tpu/engine/speculative.py:
    279-298``, ``bitnet_tpu/serve/scheduler.py:1255-1285``).

    ``inp`` [B, 2T+2] int32 host array: the tokens, their positions (S
    where a slot is masked: its writes drop), the valid length before the
    call and the real token count (0 masked).  Returns [rows, T] int32
    argmaxes and, with ``probs``, [rows, T-1] float32 probabilities of the
    tokens 1… of each row.  On the card it is captured at its first call
    and replayed; ``launches`` holds a replay's counts, added on each."""

    def __init__(self, cfg, params, cache, kernel_path: str, T: int, rows: int,
                 probs: bool, device, pool=None):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.buffers = buffer_addresses(params, cache)
        self.kernel_path, self.T, self.rows, self.probs = kernel_path, T, rows, probs
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.launches: dict[str, int] = {}
        self.capture_s = 0.0
        self.calls = 0

    def _body(self, inp: torch.Tensor) -> torch.Tensor:
        T, R, c = self.T, self.rows, self.cache
        toks, pos = inp[:, :T], inp[:, T:2 * T]
        n_real = inp[:, 2 * T + 1]
        h, _, _ = forward(self.cfg, self.params, toks, pos, c.k, c.v, inp[:, 2 * T],
                          n_real, self.kernel_path, c.k_scale, c.v_scale)
        c.lengths += n_real
        lg = model_logits(self.cfg, self.params, h[:R], self.kernel_path).to(torch.float32)
        best = torch.argmax(lg, dim=-1).to(torch.int32)              # [R, T]
        if not self.probs:
            return best
        row = lg[:, :-1] - lg[:, :-1].amax(dim=-1, keepdim=True)
        p = torch.exp(row)
        p = p / p.sum(dim=-1, keepdim=True)
        pd = p.gather(-1, toks[:R, 1:, None].to(torch.int64))[..., 0]   # [R, T-1]
        return torch.cat([best, pd.contiguous().view(torch.int32)], dim=1)

    def __call__(self, inp: np.ndarray):
        self.calls += 1
        with torch.inference_mode():
            if self.device.type == "cpu":
                out = self._body(torch.from_numpy(inp)).numpy()
            else:
                if self.graph is None:
                    self._inp = torch.empty(inp.shape, dtype=torch.int32,
                                            device=self.device)

                    def body():
                        self._out = self._body(self._inp)
                    self.graph, self.launches, self.capture_s = capture_graph(
                        body, (), self.pool)
                self._inp.copy_(torch.from_numpy(inp))
                self.graph.replay()
                registry.add_launch_counts(self.launches)
                out = self._out.cpu().numpy()
        T = self.T
        if not self.probs:
            return out, None
        return out[:, :T], np.ascontiguousarray(out[:, T:]).view(np.float32)


def verify_input(B: int, T: int, S: int) -> np.ndarray:
    """A [B, 2T+2] ``VerifyStep`` input with every slot masked."""
    inp = np.zeros((B, 2 * T + 2), np.int32)
    inp[:, T:2 * T] = S
    return inp


class SpeculativeDecoder:
    """Greedy (or threshold) speculative generation over a target engine."""

    MAX_VERIFIES = 16

    def __init__(self, engine, draft: DraftSource | None = None,
                 spec_cfg: SpeculativeConfig | None = None):
        if getattr(engine, "windowed", False):
            # the verify writes rows at absolute positions: a ring has no
            # such rows (the JAX decoder does not check, and writes past it)
            raise InferenceError("speculative decoding needs the dense cache, "
                                 "not a sliding-window ring")
        self.engine = engine
        self.spec_cfg = spec_cfg or SpeculativeConfig()
        self.draft = draft or NgramDraft(self.spec_cfg.max_ngram)
        self.stats = AcceptanceStats()
        self._verifies: dict = {}

    def _get_verify(self, T: int) -> VerifyStep:
        """The verify of T tokens keyed on T, the engine's B, its cache
        dtype, its kernel path, the policy and the ``BITNET_*`` knobs; all
        are dropped once the engine holds other buffers than they captured."""
        eng = self.engine
        if (self._verifies and next(iter(self._verifies.values())).buffers
                != buffer_addresses(eng.params, eng.cache)):
            self._verifies.clear()
        key = (T, eng.engine_cfg.max_batch_size, str(eng.cache.k.dtype),
               eng.kernel_path, self.spec_cfg.policy,
               tuple(sorted((k, v) for k, v in os.environ.items()
                            if k.startswith("BITNET_"))))
        v = self._verifies.get(key)
        if v is None:
            if eng.device.type == "cuda" and eng._graph_pool is None:
                eng._graph_pool = torch.cuda.graph_pool_handle()
            v = VerifyStep(eng.cfg, eng.params, eng.cache, eng.kernel_path, T, 1,
                           self.spec_cfg.policy == "threshold", eng.device,
                           eng._graph_pool)
            self._verifies[key] = v
            while len(self._verifies) > self.MAX_VERIFIES:
                self._verifies.pop(next(iter(self._verifies)))
        return v

    def _truncate(self, length: int) -> None:
        """Roll slot 0's valid length back (rejected drafts stay as masked
        rows and are overwritten next round)."""
        self.engine.cache.lengths[0] = length

    def generate(self, token_ids: list[int],
                 gen_cfg: GenerationConfig | None = None):
        """Speculative decode (``bitnet_tpu/engine/speculative.py:183-318``).
        Returns an ``engine.GenerationResult`` with ``spec_stats``."""
        from .engine import GenerationResult

        eng = self.engine
        gen_cfg = gen_cfg or GenerationConfig(greedy=True)
        if not gen_cfg.is_greedy and self.spec_cfg.policy == "greedy":
            raise InferenceError(
                "greedy acceptance requires greedy generation; use "
                "policy='threshold' for sampled decoding")
        if gen_cfg.grammar:
            raise InferenceError(
                "grammar decoding is not supported with speculative "
                "decoding (draft tokens bypass the grammar mask)")
        if gen_cfg.logprobs is not None:
            raise InferenceError(
                "logprobs are not supported with speculative decoding "
                "(verify-step logits are consumed on device)")
        k = self.spec_cfg.num_draft_tokens
        S = eng.engine_cfg.max_seq_len
        B = eng.engine_cfg.max_batch_size

        eos = None
        if eng.tokenizer is not None:
            eos = getattr(eng.tokenizer, "eos_token_id", None)
        stop = StopCriteria(
            max_new_tokens=gen_cfg.max_new_tokens,
            eos_token_id=eos,
            stop_token_ids=frozenset(gen_cfg.stop_token_ids),
            stop_sequences=tuple(gen_cfg.stop_sequences),
        )

        lg = eng.prefill(token_ids)
        tokens = list(token_ids)
        out_tokens: list[int] = []
        next_tok = int(torch.argmax(lg[0].to(torch.float32)))
        stop_reason = StopReason.MAX_TOKENS

        def emit(t: int) -> bool:
            nonlocal stop_reason
            piece = ""
            if eng.tokenizer is not None:
                piece = eng.tokenizer.token_to_piece(t)
            # checked BEFORE appending: stop tokens and EOS are not emitted,
            # as in generate_stream, so the greedy path stays lossless
            r = stop.check(t, piece)
            if r in (StopReason.STOP_TOKEN, StopReason.EOS):
                stop_reason = r
                return True
            out_tokens.append(t)
            tokens.append(t)
            if r is not None:
                stop_reason = r
                return True
            return False

        if emit(next_tok):
            return GenerationResult(
                token_ids=out_tokens, text=self._decode_text(out_tokens),
                stop_reason=stop_reason, prompt_tokens=len(token_ids),
                metrics={}, spec_stats=self.stats.as_dict())

        self.draft.begin(tokens)
        while True:
            n = len(tokens)
            if n + k + 1 > S:
                k_eff = S - n - 1
                if k_eff < 1:
                    stop_reason = StopReason.MAX_TOKENS
                    break
            else:
                k_eff = k

            draft = self.draft.propose(tokens, k_eff)
            self.stats.rounds += 1
            self.stats.proposed += k_eff

            # one target forward over [last accepted, d1..dk]
            K1 = k_eff + 1
            inp = verify_input(B, K1, S)
            inp[0, :K1] = [tokens[-1]] + draft
            inp[0, K1:2 * K1] = np.arange(n - 1, n + k_eff)
            inp[0, 2 * K1] = n - 1
            inp[0, 2 * K1 + 1] = K1
            # lengths include tokens[-1] (written by the last round or the
            # prefill); rewound by 1 so writing it again keeps them exact
            self._truncate(n - 1)
            best, probs = self._get_verify(K1)(inp)
            eng.kernel_recorder.append(f"spec_verify_k{k_eff}")

            accepted = 0
            if self.spec_cfg.policy == "greedy":
                for i, d in enumerate(draft):
                    if int(best[0, i]) == d:
                        accepted += 1
                    else:
                        break
            else:
                for i in range(len(draft)):
                    if probs[0, i] >= self.spec_cfg.accept_threshold:
                        accepted += 1
                    else:
                        break
            self.stats.accepted += accepted

            stopped = False
            for d in draft[:accepted]:
                if emit(d):
                    stopped = True
                    break
            if stopped:
                break

            # the cache holds n-1 + K1 rows; n + accepted are real
            self._truncate(n + accepted)
            # the next token: the first position not accepted
            next_tok = int(best[0, accepted])
            if emit(next_tok):
                break

        return GenerationResult(
            token_ids=out_tokens, text=self._decode_text(out_tokens),
            stop_reason=stop_reason, prompt_tokens=len(token_ids),
            metrics={}, spec_stats=self.stats.as_dict())

    def _decode_text(self, ids: list[int]) -> str:
        if self.engine.tokenizer is None:
            return ""
        return self.engine.tokenizer.decode(ids)
