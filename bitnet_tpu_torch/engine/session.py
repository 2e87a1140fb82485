"""Session-level orchestration contracts (a copy of
``bitnet_tpu/engine/session.py`` over the port's engine and templates).

Rebuild of ``bitnet-engine-core`` (``src/lib.rs:49-378``):
``InferenceSession`` trait → a Session object owning per-conversation
state; ``SessionConfig`` → typed knobs; ``EngineState`` → an explicit
state machine (the reference tracks IDLE/PREFILL/DECODE/ERROR transitions
for observability and to reject misuse like decoding before prefill).

A Session composes the stateless-ish InferenceEngine with chat history,
template rendering, and the context-eviction policy — the unit the chat
REPL and the server hold per conversation.
"""

from __future__ import annotations

import dataclasses
import enum
import time

from ..config import GenerationConfig
from ..errors import InferenceError
from .context import ContextWindowConfig, evict


class SessionState(enum.Enum):
    IDLE = "idle"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    DONE = "done"
    ERROR = "error"

    def can_transition(self, to: "SessionState") -> bool:
        allowed = {
            SessionState.IDLE: {SessionState.PREFILLING, SessionState.ERROR},
            SessionState.PREFILLING: {SessionState.DECODING,
                                      SessionState.ERROR},
            SessionState.DECODING: {SessionState.DONE, SessionState.ERROR},
            SessionState.DONE: {SessionState.PREFILLING, SessionState.IDLE,
                                SessionState.ERROR},
            SessionState.ERROR: {SessionState.IDLE},
        }
        return to in allowed[self]


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Per-session knobs (engine-core SessionConfig, lib.rs:94)."""

    system_prompt: str | None = None
    template: str | None = None        # None = autodetect
    max_history_tokens: int = 0        # 0 = engine max_seq_len - headroom
    context_headroom: int = 256        # room reserved for the reply
    keep_history: bool = True


class StateTracker:
    """Explicit state machine with transition validation + history
    (engine-core EngineState, lib.rs:274-378)."""

    def __init__(self):
        self.state = SessionState.IDLE
        self.history: list[tuple[float, str]] = [(time.time(), "idle")]

    def transition(self, to: SessionState) -> None:
        if not self.state.can_transition(to):
            raise InferenceError(
                f"illegal session transition {self.state.value} → {to.value}")
        self.state = to
        self.history.append((time.time(), to.value))

    def fail(self) -> None:
        self.state = SessionState.ERROR
        self.history.append((time.time(), "error"))


class Session:
    """One conversation over an InferenceEngine."""

    def __init__(self, engine, session_cfg: SessionConfig | None = None):
        self.engine = engine
        self.cfg = session_cfg or SessionConfig()
        self.tracker = StateTracker()
        self.messages: list[dict] = []
        if self.cfg.system_prompt:
            self.messages.append({"role": "system",
                                  "content": self.cfg.system_prompt})

    # ------------------------------------------------------------ chat
    def _render(self) -> str:
        from .. import templates

        t = (templates.TemplateType(self.cfg.template)
             if self.cfg.template else templates.TemplateType.CHATML)
        msgs = [templates.Message(m["role"], m["content"])
                for m in self.messages]
        return templates.render_chat(t, msgs)

    def _budget(self) -> int:
        if self.cfg.max_history_tokens > 0:
            return self.cfg.max_history_tokens
        return max(64, self.engine.engine_cfg.max_seq_len
                   - self.cfg.context_headroom)

    def send(self, user_message: str,
             gen_cfg: GenerationConfig | None = None) -> str:
        """Append a user turn, generate the assistant reply."""
        gen_cfg = gen_cfg or GenerationConfig()
        self.messages.append({"role": "user", "content": user_message})
        prompt = self._render()
        tk = self.engine.tokenizer
        if tk is None:
            raise InferenceError("session requires a tokenizer")
        ids = tk.encode(prompt, add_bos=gen_cfg.add_bos)
        ids = evict(ids, ContextWindowConfig(self._budget()))

        self.tracker.transition(SessionState.PREFILLING)
        try:
            out = []
            first = True
            for ev in self.engine.generate_stream(ids, gen_cfg):
                if first:
                    self.tracker.transition(SessionState.DECODING)
                    first = False
                out.append(ev.token_id)
            if first:  # zero tokens generated still passed through decode
                self.tracker.transition(SessionState.DECODING)
            self.tracker.transition(SessionState.DONE)
        except Exception:
            self.tracker.fail()
            raise
        text = tk.decode(out)
        if self.cfg.keep_history:
            self.messages.append({"role": "assistant", "content": text})
        else:
            self.messages.pop()
        return text

    def reset(self) -> None:
        self.messages = ([{"role": "system",
                           "content": self.cfg.system_prompt}]
                         if self.cfg.system_prompt else [])
        self.tracker = StateTracker()

    @property
    def state(self) -> SessionState:
        return self.tracker.state
