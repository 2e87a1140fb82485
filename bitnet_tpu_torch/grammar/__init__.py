"""Grammar-constrained decoding (GBNF + JSON schema): the port's own copy
of ``bitnet_tpu/grammar/`` (pure Python and numpy; the port imports
nothing of the JAX package).

Capability the reference lacks entirely (no grammar support anywhere in
BitNet-rs) but that modern llama.cpp-compatible serving requires:
constrain sampling so output always matches a formal grammar — llama.cpp
GBNF dialect — or a JSON schema (OpenAI ``response_format``).

Usage::

    from bitnet_tpu_torch.grammar import Grammar, TokenVocab, VocabMatcher
    g = Grammar.from_gbnf('root ::= "yes" | "no"')
    vocab = TokenVocab.from_tokenizer(tok)     # build once, share
    m = VocabMatcher(g, vocab)                 # per sequence
    mask = m.allowed_mask()                    # bool [V]
    m.accept(sampled_id)

Engine/scheduler integration: ``GenerationConfig(grammar=<gbnf text>)``
routes sampling through a host-side mask each step, applied to the
logits on their device (``torch.where(mask, logits, NEG_INF)``; same
pattern as mirostat's host-side adaptive state).
"""

from .gbnf import Grammar, GrammarError, GrammarMatcher
from .json_schema import JSON_GRAMMAR, json_schema_grammar
from .vocab import TokenVocab, VocabMatcher

__all__ = [
    "Grammar", "GrammarError", "GrammarMatcher",
    "JSON_GRAMMAR", "json_schema_grammar",
    "TokenVocab", "VocabMatcher",
]
