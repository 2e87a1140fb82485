"""Stop criteria for the decode loop.

Own copy of ``bitnet_tpu/engine/stop.py``: the port imports nothing of the
JAX package.

Parity with ``bitnet-generation`` (``src/lib.rs:33-170``): stop-token-ID
sets, EOS, string stop-sequences (including sequences straddling token
boundaries via a rolling text tail), and max-token limits — checked in the
same priority order as the reference engine
(``bitnet-inference/src/engine.rs:1315+``: ID set → EOS → string tails).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class StopReason(enum.Enum):
    MAX_TOKENS = "max_tokens"
    STOP_TOKEN = "stop_token"
    EOS = "eos"
    STOP_SEQUENCE = "stop_sequence"
    CANCELLED = "cancelled"
    TIMEOUT = "timeout"
    CONTEXT_FULL = "context_full"


@dataclass
class StopCriteria:
    max_new_tokens: int = 128
    eos_token_id: int | None = None
    stop_token_ids: frozenset[int] = frozenset()
    stop_sequences: tuple[str, ...] = ()
    # EOS / stop-token / stop-sequence triggers are suppressed until
    # this many tokens emitted (vLLM min_tokens semantics; the sampler
    # additionally bans the EOS logit during this phase)
    min_new_tokens: int = 0

    # rolling state
    _tail: str = field(default="", repr=False)
    _count: int = field(default=0, repr=False)

    def reset(self) -> None:
        self._tail = ""
        self._count = 0

    def check(self, token_id: int, token_text: str = "") -> StopReason | None:
        """Feed one generated token; returns a StopReason or None.

        Priority (engine.rs:1315+): explicit stop-ID set → EOS → string
        stop-sequences → max tokens.
        """
        self._count += 1
        armed = self._count > self.min_new_tokens
        if armed and token_id in self.stop_token_ids:
            return StopReason.STOP_TOKEN
        if armed and self.eos_token_id is not None \
                and token_id == self.eos_token_id:
            return StopReason.EOS
        if self.stop_sequences:
            self._tail += token_text
            max_len = max(len(s) for s in self.stop_sequences)
            # keep enough tail to match a sequence straddling a boundary
            if len(self._tail) > 2 * max_len:
                self._tail = self._tail[-2 * max_len:]
            if armed:
                for s in self.stop_sequences:
                    if s and s in self._tail:
                        return StopReason.STOP_SEQUENCE
        if self._count >= self.max_new_tokens:
            return StopReason.MAX_TOKENS
        return None

    def trailing_match_len(self) -> int:
        """Length of text to withhold from streaming because it could be a
        prefix of a stop sequence (so stop strings never leak to clients)."""
        best = 0
        for s in self.stop_sequences:
            for i in range(1, len(s)):
                if self._tail.endswith(s[:i]):
                    best = max(best, i)
        return best
