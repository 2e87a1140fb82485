"""Token-level grammar filtering: lazy pushdown→DFA + vectorized masks (a
copy of ``bitnet_tpu/grammar/vocab.py``, numpy only).

A token is *admissible* in a grammar state iff its entire decoded piece
is consumable by the pushdown matcher.  Scanning the vocab piece by
piece is O(V·len) pushdown advances per state — seconds in Python at a
32k-piece vocab.  Three structural collapses make it fast:

1. **Character equivalence classes.**  The grammar's char items cut the
   codespace into intervals; within an interval every codepoint matches
   exactly the same items, so one representative advance stands in for
   all of them.  A JSON-style grammar yields a few dozen classes.
2. **Lazy DFA over classes.**  Reachable pushdown states (stack-sets)
   get integer ids; a transition row ``T[state, class] → state`` is
   filled on first use (one pushdown advance per class).  Decoding
   visits few states (inside a string, inside a number, …), so the
   closure stays small even though the pushdown is technically infinite.
3. **Vectorized token runs.**  All pieces are pre-encoded as a padded
   ``[V, Lmax]`` class matrix; a mask is computed by running every
   token through ``T`` simultaneously with numpy gathers (dead state
   −1 absorbing) — ~Lmax vector ops instead of V trie walks.

Masks are memoised per DFA state and shared by every request using the
same (grammar, vocab) pair, so the steady-state cost is a dict hit.
"""

from __future__ import annotations

import bisect

import numpy as np

from .gbnf import _CHAR, Grammar, GrammarMatcher, _advance

_DEAD = -1


class TokenVocab:
    """The tokenizer's pieces (build once, share across requests)."""

    def __init__(self, pieces: list[str], eos_token_id: int | None = None):
        self.pieces = [p or "" for p in pieces]
        self.size = len(self.pieces)
        self.eos_token_id = eos_token_id
        # grammar -> DFA, LRU-capped: each entry holds a [V, Lmax] piece
        # matrix (a few MB at large vocabs), so unbounded growth on
        # per-request schemas would leak.  The value keeps a strong ref
        # to the Grammar so the id() key can never go stale.
        self._dfas: "dict[int, tuple[Grammar, _GrammarDFA]]" = {}

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "TokenVocab":
        v = tokenizer.vocab_size
        if callable(v):          # Tokenizer trait method (reference
            v = v()              # lib.rs:83 convention) vs plain attribute
        pieces = [tokenizer.token_to_piece(i) or "" for i in range(v)]
        return cls(pieces, getattr(tokenizer, "eos_token_id", None))

    MAX_DFAS = 8

    def dfa(self, grammar: Grammar) -> "_GrammarDFA":
        hit = self._dfas.get(id(grammar))
        if hit is not None:
            return hit[1]
        d = _GrammarDFA(grammar, self)
        while len(self._dfas) >= self.MAX_DFAS:
            self._dfas.pop(next(iter(self._dfas)))     # FIFO eviction
        self._dfas[id(grammar)] = (grammar, d)
        return d


class _GrammarDFA:
    """Lazily-closed DFA over char classes with per-state vocab masks."""

    def __init__(self, grammar: Grammar, vocab: TokenVocab):
        self.rules = grammar.rules
        # interval partition of the codespace from every char item
        bounds = {0, 0x110000}
        for rule in self.rules:
            for alt in rule:
                for item in alt:
                    if item[0] == _CHAR:
                        for lo, hi in item[1]:
                            bounds.add(lo)
                            bounds.add(hi + 1)
        starts = sorted(bounds)
        self.reps = starts[:-1]               # representative cp per class
        C = len(self.reps)

        # pieces → padded [V, Lmax] class matrix (−1 = past end)
        V = vocab.size
        eos = vocab.eos_token_id
        lens = [0 if (not p or t == eos) else len(p)
                for t, p in enumerate(vocab.pieces)]
        Lmax = max(lens) if any(lens) else 1
        self.pcls = np.full((V, Lmax), -1, np.int32)
        cls_cache: dict[int, int] = {}
        for tid, piece in enumerate(vocab.pieces):
            if not lens[tid]:
                continue
            row = self.pcls[tid]
            for i, ch in enumerate(piece):
                cp = ord(ch)
                c = cls_cache.get(cp)
                if c is None:
                    c = cls_cache[cp] = bisect.bisect_right(starts, cp) - 1
                row[i] = c
        # empty/control/EOS pieces never advance a grammar
        self.valid = np.asarray([bool(n) for n in lens])
        self.eos_token_id = eos

        self._sids: dict[frozenset, int] = {}
        self._states: list[frozenset] = []
        self._T = np.full((16, C), -2, np.int32)   # −2 = row not filled
        self._filled: list[bool] = []
        self._masks: dict[int, np.ndarray] = {}

    # ------------------------------------------------------------- states
    def _sid(self, stacks: frozenset) -> int:
        sid = self._sids.get(stacks)
        if sid is None:
            sid = len(self._states)
            self._sids[stacks] = sid
            self._states.append(stacks)
            self._filled.append(False)
            if sid >= len(self._T):
                self._T = np.vstack(
                    [self._T, np.full_like(self._T, -2)])
        return sid

    def _fill_row(self, sid: int) -> None:
        if self._filled[sid]:
            return
        stacks = self._states[sid]
        for c, rep in enumerate(self.reps):
            nxt = _advance(self.rules, stacks, rep)
            # index _T directly: _sid() may reallocate it (vstack growth)
            self._T[sid, c] = self._sid(nxt) if nxt else _DEAD
        self._filled[sid] = True

    # -------------------------------------------------------------- masks
    def mask_for(self, stacks: frozenset, can_complete: bool) -> np.ndarray:
        """Boolean [V] admissibility mask for a pushdown state (EOS set
        when the grammar can complete there).  Cached per state; callers
        must treat the result as read-only."""
        sid = self._sid(stacks)
        key = sid if not can_complete else ~sid
        cached = self._masks.get(key)
        if cached is not None:
            return cached

        # compacting run: tokens leave the working set as soon as their
        # piece ends (admissible) or their state dies, so later steps
        # index ever-smaller arrays (numbers/keywords kill most of a
        # 128k vocab at the first character)
        mask = np.zeros(self.valid.size, dtype=bool)
        idx = np.flatnonzero(self.valid)
        st = np.full(idx.size, sid, np.int32)
        for i in range(self.pcls.shape[1]):
            c = self.pcls[idx, i]
            ended = c < 0
            if ended.any():
                mask[idx[ended]] = True            # piece fully consumed
                keep = ~ended
                idx, st, c = idx[keep], st[keep], c[keep]
            if idx.size == 0:
                break
            for s in np.unique(st):
                self._fill_row(int(s))
            st = self._T[st, c]
            alive = st >= 0
            if not alive.all():
                idx, st = idx[alive], st[alive]
        mask[idx] = True                           # ran to Lmax, alive
        if can_complete and self.eos_token_id is not None:
            mask = mask.copy()
            mask[self.eos_token_id] = True
        mask.setflags(write=False)
        if len(self._masks) >= 2048:       # [V]-bool each; bound memory
            self._masks.pop(next(iter(self._masks)))
        self._masks[key] = mask
        return mask


class VocabMatcher:
    """Per-sequence constrained-decoding state over a shared vocab."""

    def __init__(self, grammar: Grammar, vocab: TokenVocab):
        self.vocab = vocab
        self.matcher = GrammarMatcher(grammar)
        self._dfa = vocab.dfa(grammar)

    # ------------------------------------------------------------------
    def allowed_mask(self) -> np.ndarray:
        """Boolean [V] mask of admissible next tokens (EOS included when
        the grammar can complete).  Read-only, shared across requests."""
        return self._dfa.mask_for(self.matcher.stacks,
                                  self.matcher.can_complete)

    def accept(self, token_id: int) -> None:
        """Advance past a sampled token (no-op for EOS)."""
        if token_id == self.vocab.eos_token_id:
            return
        piece = self.vocab.pieces[token_id]
        if piece and not self.matcher.feed_text(piece):
            # the caller sampled outside the mask (shouldn't happen) —
            # freeze the matcher dead so only EOS remains
            self.matcher.stacks = frozenset()

    @property
    def exhausted(self) -> bool:
        """Only EOS is legal (grammar complete or dead-ended)."""
        return self.matcher.must_complete or not self.matcher.alive
