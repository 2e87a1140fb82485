"""GBNF grammar engine: parser, compiler, and incremental matcher (a copy
of ``bitnet_tpu/grammar/gbnf.py``).

Grammar-constrained decoding (llama.cpp GBNF dialect) — a capability the
reference does not have (no grammar/GBNF support anywhere in BitNet-rs);
it is table stakes for modern structured-output serving, so this build
ships it.  Design follows the llama.cpp sampler's pushdown-automaton
semantics (sets of stacks for nondeterminism) but is an independent
implementation:

- A grammar compiles to rules of *alternatives*; each alternative is a
  sequence of items: character classes (sets of codepoint ranges,
  optionally negated) or references to other rules.  Literals, groups,
  and the ``* + ? {m,n}`` repetitions are rewritten into generated rules
  at parse time, so the matcher only ever sees chars and refs.
- Matcher state is a SET of stacks; a stack is a tuple of (rule, alt,
  pos) frames (topmost last).  Normalisation expands refs until every
  stack's next item is a terminal (or the stack is empty = the grammar
  can complete here).  Feeding a character keeps the stacks whose
  terminal matches, advanced and re-normalised.
- Token-level filtering walks the tokenizer's piece trie against the
  stack set, pruning whole subtrees on dead prefixes, and memoises masks
  by (state, trie) — JSON-ish grammars are narrow, so this is cheap.

GBNF syntax supported: ``name ::= expr``, alternation ``|``, sequencing,
literals ``"..."`` (escapes ``\\" \\\\ \\n \\r \\t \\xHH \\uXXXX``), char
classes ``[a-z0-9_]`` / ``[^...]`` (same escapes plus ``\\]``), ``.``
(any char), grouping ``(...)``, postfix ``* + ? {m} {m,} {m,n}``, and
``#`` comments.
"""

from __future__ import annotations

import dataclasses

from ..errors import ConfigError

# a char item: (ranges, negated) with ranges a tuple of (lo, hi) codepoint
# pairs (inclusive); a ref item: rule index
_CHAR, _REF = 0, 1


class GrammarError(ConfigError):
    """Malformed GBNF text or JSON schema."""


@dataclasses.dataclass(frozen=True)
class Grammar:
    """Compiled grammar: ``rules[i]`` is a tuple of alternatives, each a
    tuple of items ``(_CHAR, ranges, neg)`` / ``(_REF, rule_idx)``."""

    rules: tuple
    root: int
    names: tuple          # rule index -> name (generated rules: "name$n")

    @classmethod
    def from_gbnf(cls, text: str, root: str = "root") -> "Grammar":
        return _Parser(text).compile(root)

    def initial_stacks(self) -> frozenset:
        """The matcher start state (normalised)."""
        return _normalize(self.rules,
                          frozenset({((self.root, 0, 0),)})
                          if len(self.rules[self.root]) == 1 else
                          frozenset({((self.root, a, 0),)
                                     for a in range(len(self.rules[self.root]))}))


# -------------------------------------------------------------- parsing
_ESCAPES = {"n": "\n", "r": "\r", "t": "\t", '"': '"', "\\": "\\",
            "[": "[", "]": "]", "^": "^", "-": "-", "/": "/"}


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        # rule name -> index; bodies filled as parsed
        self.indices: dict[str, int] = {}
        self.bodies: dict[int, list] = {}
        self.names: list[str] = []

    # -- low-level lexing ------------------------------------------------
    def _ws(self, newlines: bool = True) -> None:
        t, n = self.text, len(self.text)
        while self.pos < n:
            c = t[self.pos]
            if c == "#":
                while self.pos < n and t[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            else:
                return

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _fail(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        raise GrammarError(f"GBNF parse error at line {line}: {msg}")

    def _name(self) -> str:
        start = self.pos
        # NB: guard the empty string from _peek() at EOF — "" is a
        # substring of any string, so `"" in "-_"` would loop forever
        while (c := self._peek()) and (c.isalnum() or c in "-_"):
            self.pos += 1
        if self.pos == start:
            self._fail("expected rule name")
        return self.text[start: self.pos]

    def _escape(self) -> str:
        c = self.text[self.pos]
        self.pos += 1
        if c != "\\":
            return c
        e = self.text[self.pos] if self.pos < len(self.text) else ""
        self.pos += 1
        if e in _ESCAPES:
            return _ESCAPES[e]
        if e == "x":
            h, self.pos = self.text[self.pos: self.pos + 2], self.pos + 2
            return chr(int(h, 16))
        if e == "u":
            h, self.pos = self.text[self.pos: self.pos + 4], self.pos + 4
            return chr(int(h, 16))
        if e == "U":
            h, self.pos = self.text[self.pos: self.pos + 8], self.pos + 8
            return chr(int(h, 16))
        self._fail(f"bad escape \\{e}")

    # -- rule registry ---------------------------------------------------
    def _rule_idx(self, name: str) -> int:
        if name not in self.indices:
            self.indices[name] = len(self.names)
            self.names.append(name)
        return self.indices[name]

    def _gen_rule(self, base: str, alts: list) -> int:
        idx = self._rule_idx(f"{base}${len(self.names)}")
        self.bodies[idx] = alts
        return idx

    # -- grammar structure -------------------------------------------------
    def compile(self, root: str) -> Grammar:
        self._ws()
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws()
        if root not in self.indices:
            self._fail(f"no '{root}' rule")
        missing = [self.names[i] for i in range(len(self.names))
                   if i not in self.bodies]
        if missing:
            self._fail(f"undefined rule(s): {', '.join(missing)}")
        rules = tuple(tuple(tuple(alt) for alt in self.bodies[i])
                      for i in range(len(self.names)))
        return Grammar(rules=rules, root=self.indices[root],
                       names=tuple(self.names))

    def _parse_rule(self) -> None:
        name = self._name()
        self._ws()
        if self.text[self.pos: self.pos + 3] != "::=":
            self._fail(f"expected '::=' after '{name}'")
        self.pos += 3
        idx = self._rule_idx(name)
        if idx in self.bodies:
            self._fail(f"duplicate rule '{name}'")
        self.bodies[idx] = self._alternates(name)

    def _alternates(self, base: str) -> list:
        alts = [self._sequence(base)]
        while True:
            # a `|` may sit on a continuation line — look ahead across
            # newlines, but restore if the next token is something else
            save = self.pos
            self._ws()
            if self._peek() == "|":
                self.pos += 1
                alts.append(self._sequence(base))
            else:
                self.pos = save
                return alts

    def _sequence(self, base: str) -> list:
        items: list = []
        atoms = 0
        while True:
            self._ws(newlines=False)
            c = self._peek()
            if c == "" or c in "|)" or c in "\r\n":
                if atoms == 0:
                    # `a | | b` is always a typo; epsilon is spelt ""
                    self._fail('empty alternate (use "" for epsilon)')
                return items
            item = self._item(base)
            atoms += 1
            items.extend(self._repetition(base, item))

    def _item(self, base: str) -> list:
        """One atom as a list of items (a literal is several chars)."""
        c = self._peek()
        if c == '"':
            self.pos += 1
            out = []
            while self._peek() != '"':
                if self.pos >= len(self.text):
                    self._fail("unterminated literal")
                ch = self._escape()
                out.append((_CHAR, ((ord(ch), ord(ch)),), False))
            self.pos += 1
            return out
        if c == "[":
            self.pos += 1
            neg = False
            if self._peek() == "^":
                neg = True
                self.pos += 1
            ranges = []
            while self._peek() != "]":
                if self.pos >= len(self.text):
                    self._fail("unterminated char class")
                lo = self._escape()
                hi = lo
                if self._peek() == "-" and self.text[
                        self.pos + 1: self.pos + 2] != "]":
                    self.pos += 1
                    hi = self._escape()
                ranges.append((ord(lo), ord(hi)))
            self.pos += 1
            if not ranges and not neg:
                self._fail("empty char class")
            return [(_CHAR, tuple(ranges), neg)]
        if c == ".":
            self.pos += 1
            return [(_CHAR, ((0, 0x10FFFF),), False)]
        if c == "(":
            self.pos += 1
            alts = self._alternates(base)
            self._ws()
            if self._peek() != ")":
                self._fail("expected ')'")
            self.pos += 1
            return [(_REF, self._gen_rule(base, alts))]
        if c.isalnum() or c in "-_":
            return [(_REF, self._rule_idx(self._name()))]
        self._fail(f"unexpected character {c!r}")

    def _repetition(self, base: str, item: list) -> list:
        c = self._peek()
        if c == "*":
            self.pos += 1
            r = self._rule_idx(f"{base}${len(self.names)}")
            self.names  # placate linters
            self.bodies[r] = [item + [(_REF, r)], []]
            return [(_REF, r)]
        if c == "+":
            self.pos += 1
            r = self._rule_idx(f"{base}${len(self.names)}")
            self.bodies[r] = [item + [(_REF, r)], list(item)]
            return [(_REF, r)]
        if c == "?":
            self.pos += 1
            return [(_REF, self._gen_rule(base, [list(item), []]))]
        if c == "{":
            self.pos += 1
            start = self.pos
            while self._peek().isdigit():
                self.pos += 1
            m = int(self.text[start: self.pos] or "0")
            n = m
            if self._peek() == ",":
                self.pos += 1
                start = self.pos
                while self._peek().isdigit():
                    self.pos += 1
                n = int(self.text[start: self.pos]) \
                    if self.pos > start else None
            if self._peek() != "}":
                self._fail("expected '}' in repetition bound")
            self.pos += 1
            out: list = []
            for _ in range(m):
                out.extend(item)
            if n is None:                      # {m,} = m copies then *
                r = self._rule_idx(f"{base}${len(self.names)}")
                self.bodies[r] = [item + [(_REF, r)], []]
                out.append((_REF, r))
            else:
                if n < m:
                    self._fail("repetition bound {m,n} needs n >= m")
                for _ in range(n - m):         # (item)? × (n-m)
                    out.append(
                        (_REF, self._gen_rule(base, [list(item), []])))
            return out
        return item


# -------------------------------------------------------------- matching
def _normalize(rules, stacks: frozenset) -> frozenset:
    """Expand refs / pop finished frames until every stack's next item is
    a terminal char class (or the stack is empty: grammar may complete)."""
    out = set()
    seen = set()
    work = list(stacks)
    while work:
        st = work.pop()
        if st in seen:
            continue
        seen.add(st)
        if not st:
            out.add(st)
            continue
        rule, alt, pos = st[-1]
        body = rules[rule][alt]
        if pos >= len(body):                   # alternative done → pop
            work.append(st[:-1])
            continue
        item = body[pos]
        if item[0] == _CHAR:
            out.add(st)
            continue
        # ref: the continuation resumes past the ref
        cont = st[:-1] + ((rule, alt, pos + 1),)
        child = item[1]
        for a in range(len(rules[child])):
            work.append(cont + ((child, a, 0),))
    return frozenset(out)


def _match(item, ch: int) -> bool:
    _, ranges, neg = item
    hit = any(lo <= ch <= hi for lo, hi in ranges)
    return hit != neg


def _advance(rules, stacks: frozenset, ch: int) -> frozenset:
    nxt = set()
    for st in stacks:
        if not st:
            continue                     # completed stacks consume nothing
        rule, alt, pos = st[-1]
        item = rules[rule][alt][pos]
        if _match(item, ch):
            nxt.add(st[:-1] + ((rule, alt, pos + 1),))
    if not nxt:
        return frozenset()
    return _normalize(rules, frozenset(nxt))


class GrammarMatcher:
    """Incremental per-sequence matcher over a compiled :class:`Grammar`.

    ``accept_text`` drives raw characters; :class:`VocabMatcher` (vocab.py)
    layers token-trie filtering on top.
    """

    def __init__(self, grammar: Grammar):
        self.grammar = grammar
        self.stacks = grammar.initial_stacks()

    def copy(self) -> "GrammarMatcher":
        m = GrammarMatcher.__new__(GrammarMatcher)
        m.grammar = self.grammar
        m.stacks = self.stacks
        return m

    @property
    def alive(self) -> bool:
        return bool(self.stacks)

    @property
    def can_complete(self) -> bool:
        """True when the text so far is a complete sentence (EOS legal)."""
        return any(not st for st in self.stacks)

    @property
    def must_complete(self) -> bool:
        """True when NO further character is legal (only EOS)."""
        return all(not st for st in self.stacks)

    def feed_text(self, text: str) -> bool:
        """Advance through ``text``; False (state unchanged) on reject."""
        stacks = self.stacks
        for ch in text:
            stacks = _advance(self.grammar.rules, stacks, ord(ch))
            if not stacks:
                return False
        self.stacks = stacks
        return True

    def would_accept(self, text: str) -> bool:
        stacks = self.stacks
        for ch in text:
            stacks = _advance(self.grammar.rules, stacks, ord(ch))
            if not stacks:
                return False
        return True
