"""llama-cpp-python-compatible API over the port's engine, on the card.

Drop-in replacement for ``llama_cpp.Llama``: swap

    from llama_cpp import Llama

for

    from bitnet_tpu_torch.compat.llama import Llama

and existing llama-cpp-python call sites work unchanged.  The port of
``bitnet_tpu/compat/llama.py:38-645``: ``Llama`` (completions and chat
completions, streamed or not, embeddings, ``tokenize`` / ``detokenize``,
the low-level ``eval`` / ``sample`` / ``generate``, ``save_state`` /
``load_state``), ``LlamaGrammar``, ``LlamaCache``, ``llama_backend_init``
and ``llama_backend_free``, with the same arguments, outputs and
defaults.  ``logit_bias`` / ``frequency_penalty`` / ``presence_penalty``
reach the sampler chain, ``stream=True`` yields OpenAI-style chunks, and
``create_chat_completion`` renders through the GGUF's embedded jinja
template or the template catalog.

``Llama(..., device="cuda")`` builds its engine on the card unless the
caller passes ``device="cpu"`` (the kernels' plain versions).  GPU and
thread knobs (``n_gpu_layers``, ``n_threads``, ``tensor_split``, ...) are
accepted and ignored, as in the JAX class; ``n_ctx`` is the engine's
``max_seq_len``.  ``sample`` draws from an explicit ``torch.Generator``
seeded as the JAX class steps its key's seed (the constructor's ``seed``,
then seed + 1, ...; the clock's nanoseconds when ``seed < 0``).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

from ..config import EngineConfig, GenerationConfig
from ..errors import InferenceError


def _bias_tuple(logit_bias) -> tuple:
    if not logit_bias:
        return ()
    return tuple(sorted((int(k), float(v))
                        for k, v in dict(logit_bias).items()))


class LlamaGrammar:
    """llama-cpp-python ``LlamaGrammar`` compatible holder of GBNF text.

    Validates eagerly (like llama.cpp's grammar parser) so a malformed
    grammar raises at construction, not mid-generation.
    """

    def __init__(self, gbnf: str):
        from ..grammar import Grammar

        Grammar.from_gbnf(gbnf)          # raises GrammarError if malformed
        self._grammar = gbnf

    @classmethod
    def from_string(cls, grammar: str, verbose: bool = True,
                    **_kw) -> "LlamaGrammar":
        return cls(grammar)

    @classmethod
    def from_json_schema(cls, json_schema, verbose: bool = True,
                         **_kw) -> "LlamaGrammar":
        from ..grammar import json_schema_grammar

        return cls(json_schema_grammar(json_schema))

    @classmethod
    def from_file(cls, file, verbose: bool = True, **_kw) -> "LlamaGrammar":
        with open(file) as f:
            return cls(f.read())

    def __str__(self) -> str:
        return self._grammar


def _chat_logprobs_arg(kwargs: Dict[str, Any]) -> Optional[int]:
    """OpenAI chat convention: ``logprobs=True`` + ``top_logprobs=N``."""
    lp = kwargs.get("logprobs")
    if lp is True:
        return int(kwargs.get("top_logprobs", 0) or 0)
    if isinstance(lp, int) and not isinstance(lp, bool):
        return lp
    return None


def _grammar_source(grammar=None, response_format=None) -> Optional[str]:
    """GBNF source from a compat ``grammar=`` arg (``LlamaGrammar`` or raw
    GBNF text) or an OpenAI-style ``response_format`` dict; grammar wins."""
    if grammar is not None:
        return (grammar._grammar if isinstance(grammar, LlamaGrammar)
                else str(grammar))
    rf = response_format or {}
    t = rf.get("type")
    if t == "json_object":
        from ..grammar import JSON_GRAMMAR, json_schema_grammar

        # llama-cpp-python extension: {"type": "json_object", "schema": …}
        schema = rf.get("schema")
        return json_schema_grammar(schema) if schema else JSON_GRAMMAR
    if t == "json_schema":
        from ..grammar import json_schema_grammar

        return json_schema_grammar(
            (rf.get("json_schema") or {}).get("schema") or {})
    return None


class Llama:
    """Drop-in replacement for ``llama_cpp.Llama`` on the card."""

    def __init__(
        self,
        model_path: str,
        n_ctx: int = 512,
        n_batch: int = 512,
        n_threads: Optional[int] = None,
        n_gpu_layers: int = 0,
        seed: int = -1,
        logits_all: bool = False,
        vocab_only: bool = False,
        embedding: bool = False,
        chat_format: Optional[str] = None,
        verbose: bool = True,
        device: str = "cuda",
        **_ignored: Any,
    ):
        from ..engine.engine import InferenceEngine

        self.model_path = model_path
        self.verbose = verbose
        self._seed = seed if seed >= 0 else None
        self._n_ctx = n_ctx
        self._chat_format = chat_format
        self._logits_all = logits_all
        self._embedding = embedding

        eng_cfg = EngineConfig(max_seq_len=n_ctx)
        self._engine = InferenceEngine.from_gguf(model_path, eng_cfg, device=device)
        if self._engine.tokenizer is None:
            raise InferenceError(
                f"no tokenizer discoverable for {model_path}")
        # detected chat template (GGUF metadata → name), overridable via
        # chat_format= (llama-cpp chat_format strings map through parse)
        from .. import templates

        if chat_format:
            self._template = templates.TemplateType.parse(chat_format)
        else:
            self._template = templates.detect(self.metadata, model_path)

        # eval/sample state (the low-level llama.cpp-style API)
        self._n_past = 0
        self._last_logits: Optional[np.ndarray] = None
        self._eval_tokens: List[int] = []

    # ------------------------------------------------------------ tokens
    def tokenize(self, text: Union[str, bytes], add_bos: bool = True,
                 special: bool = True) -> List[int]:
        if isinstance(text, bytes):
            text = text.decode("utf-8")
        return list(self._engine.tokenizer.encode(text, add_bos=add_bos))

    def detokenize(self, tokens: List[int], *a, **_kw) -> bytes:
        return self._engine.tokenizer.decode(list(tokens)).encode("utf-8")

    # ------------------------------------------------- low-level eval API
    def eval(self, tokens: List[int], **_kw) -> int:
        """Evaluate tokens; stores last-position logits (llama_cpp.eval).

        The whole accumulated sequence is (re)evaluated through the
        engine's prefill — correct and simple; the engine's own
        generate paths keep the KV cache incremental.
        """
        self._eval_tokens.extend(int(t) for t in tokens)
        logits = self._engine.eval_ids(self._eval_tokens)
        self._last_logits = logits[-1]
        self._n_past = len(self._eval_tokens)
        return 0

    def sample(
        self,
        top_k: int = 40,
        top_p: float = 0.95,
        temperature: float = 0.8,
        repeat_penalty: float = 1.1,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        mirostat_mode: int = 0,
        mirostat_tau: float = 5.0,
        mirostat_eta: float = 0.1,
        logit_bias: Optional[Dict[int, float]] = None,
        **_kw,
    ) -> int:
        if self._last_logits is None:
            raise RuntimeError("No logits available. Call eval() first.")
        import torch

        from ..engine.sampling import MirostatState, SamplerChain

        cfg = GenerationConfig(
            temperature=temperature, top_k=top_k, top_p=top_p,
            repetition_penalty=repeat_penalty,
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty,
            logit_bias=_bias_tuple(logit_bias),
            mirostat=mirostat_mode, mirostat_tau=mirostat_tau,
            mirostat_eta=mirostat_eta,
            greedy=temperature <= 0.0,
        )
        dev = self._engine.device
        gen = torch.Generator(device=dev).manual_seed(
            self._seed if self._seed is not None else time.time_ns() % 2**31)
        self._seed = (self._seed + 1) if self._seed is not None else None
        W = cfg.repetition_window
        hist = np.full((1, W), -1, np.int32)
        tail = self._eval_tokens[-W:]
        if tail:
            hist[0, -len(tail):] = tail
        row = torch.from_numpy(self._last_logits).to(dev)[None, :]
        if mirostat_mode in (1, 2):
            st = MirostatState.from_config(cfg)
            return int(st.sample(row[0], gen))
        chain = SamplerChain(cfg)
        return int(chain.sample(row, torch.from_numpy(hist).to(dev), gen)[0])

    def generate(self, tokens: List[int], reset: bool = True,
                 **sample_kwargs) -> Iterator[int]:
        """Token generator over the low-level eval/sample pair
        (llama_cpp.generate). ``stopping_criteria`` supported."""
        stopping = sample_kwargs.pop("stopping_criteria", None)
        if reset:
            self.reset()
        self.eval(list(tokens))
        while True:
            tok = self.sample(**sample_kwargs)
            if stopping is not None and stopping(
                    self._eval_tokens, self._last_logits):
                return
            yield tok
            self.eval([tok])

    # ------------------------------------------------------- completions
    def __call__(self, prompt: str, **kwargs) -> Union[Dict[str, Any],
                                                       Iterator[Dict]]:
        return self.create_completion(prompt, **kwargs)

    def create_completion(
        self,
        prompt: Union[str, List[str], List[int]],
        suffix: Optional[str] = None,
        max_tokens: int = 128,
        temperature: float = 0.8,
        top_p: float = 0.95,
        top_k: int = 40,
        min_p: float = 0.0,
        typical_p: float = 1.0,
        repeat_penalty: float = 1.1,
        frequency_penalty: float = 0.0,
        presence_penalty: float = 0.0,
        mirostat_mode: int = 0,
        mirostat_tau: float = 5.0,
        mirostat_eta: float = 0.1,
        echo: bool = False,
        stop: Optional[Union[str, List[str]]] = None,
        stream: bool = False,
        seed: Optional[int] = None,
        logit_bias: Optional[Dict[int, float]] = None,
        grammar: Optional[Union["LlamaGrammar", str]] = None,
        logprobs: Optional[int] = None,
        **_kw,
    ):
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
            # batch of prompts → one merged response (reference
            # create_completion list behavior)
            results = [self.create_completion(
                p, max_tokens=max_tokens, temperature=temperature,
                top_p=top_p, top_k=top_k, min_p=min_p,
                typical_p=typical_p, repeat_penalty=repeat_penalty,
                frequency_penalty=frequency_penalty,
                presence_penalty=presence_penalty,
                mirostat_mode=mirostat_mode, mirostat_tau=mirostat_tau,
                mirostat_eta=mirostat_eta,
                echo=echo, stop=stop, seed=seed, logit_bias=logit_bias,
                grammar=grammar, logprobs=logprobs)
                for p in prompt]
            return {
                "id": f"cmpl-{uuid.uuid4().hex[:24]}",
                "object": "text_completion",
                "created": int(time.time()),
                "model": self.model_path,
                "choices": [dict(r["choices"][0], index=i)
                            for i, r in enumerate(results)],
                "usage": {
                    "prompt_tokens": sum(
                        r["usage"]["prompt_tokens"] for r in results),
                    "completion_tokens": sum(
                        r["usage"]["completion_tokens"] for r in results),
                    "total_tokens": sum(
                        r["usage"]["total_tokens"] for r in results),
                },
            }

        stop_list = ([stop] if isinstance(stop, str) else list(stop or []))
        gen_cfg = GenerationConfig(
            max_new_tokens=max_tokens,
            temperature=max(temperature, 0.0),
            top_k=top_k, top_p=top_p, min_p=min_p, typical_p=typical_p,
            repetition_penalty=repeat_penalty,
            frequency_penalty=frequency_penalty,
            presence_penalty=presence_penalty,
            logit_bias=_bias_tuple(logit_bias),
            mirostat=mirostat_mode, mirostat_tau=mirostat_tau,
            mirostat_eta=mirostat_eta,
            seed=seed if seed is not None else self._seed,
            greedy=temperature <= 0.0,
            stop_sequences=tuple(stop_list),
            grammar=_grammar_source(grammar),
            logprobs=logprobs,
        )
        if isinstance(prompt, list):            # token-id prompt
            token_ids = [int(t) for t in prompt]
            prompt_text = None
        else:
            token_ids = self.tokenize(prompt, add_bos=gen_cfg.add_bos)
            prompt_text = prompt
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"

        if stream:
            return self._stream_completion(cid, token_ids, gen_cfg,
                                           object_type="text_completion")

        res = self._engine_generate(token_ids, gen_cfg)
        text = res["text"]
        if echo and prompt_text is not None:
            text = prompt_text + text
        return {
            "id": cid,
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_path,
            "choices": [{
                "text": text,
                "index": 0,
                "logprobs": self._format_logprobs(res.get("logprobs")),
                "finish_reason": res["finish_reason"],
            }],
            "usage": {
                "prompt_tokens": len(token_ids),
                "completion_tokens": res["completion_tokens"],
                "total_tokens": len(token_ids) + res["completion_tokens"],
            },
        }

    def create_chat_completion(
        self,
        messages: List[Dict[str, str]],
        stream: bool = False,
        stop: Optional[Union[str, List[str]]] = None,
        max_tokens: int = 128,
        **kwargs,
    ):
        """OpenAI-style chat completion through the prompt-template
        catalog — absent from the reference's compat layer; exceeds it.
        Supports ``tools``/``tool_choice`` (grammar-forced calls)."""
        from ..toolcall import parse_tool_calls, tool_choice_grammar
        from .. import templates

        # OpenAI tools protocol (absent from llama-cpp-python's own
        # compat in the reference): forced calls are grammar-constrained
        tools, tool_choice = kwargs.get("tools"), kwargs.get("tool_choice")
        fns = None
        if tools and tool_choice != "none":
            from ..toolcall import normalize_tool_messages, validate_tools

            fns = validate_tools(tools, tool_choice)
            msgs = normalize_tool_messages(messages, fns)
        else:
            msgs = [templates.Message(m["role"], m.get("content") or "")
                    for m in messages]
        # llama-cpp-python parity: the model's own embedded jinja chat
        # template wins when present (and no chat_format override); the
        # family catalog is the fallback
        prompt = None
        if self._chat_format is None:
            try:
                prompt = templates.render_chat_embedded(
                    self.metadata, msgs)
            except templates.ChatTemplateError:
                prompt = None
        if prompt is None:
            prompt = templates.render_chat(self._template, msgs)
        spec = templates.spec_for(self._template)
        stop_list = ([stop] if isinstance(stop, str) else list(stop or []))
        stop_list.extend(s for s in spec.stop_sequences
                         if s not in stop_list)
        add_bos = spec.add_bos
        from ..templates.jinja import special_token_strings

        bos_str = special_token_strings(self.metadata).get("bos_token")
        if bos_str and prompt.startswith(bos_str):
            add_bos = False           # jinja already emitted BOS
        token_ids = self.tokenize(prompt, add_bos=add_bos)

        gen_cfg = GenerationConfig(
            max_new_tokens=max_tokens,
            temperature=max(float(kwargs.get("temperature", 0.8)), 0.0),
            top_k=int(kwargs.get("top_k", 40)),
            top_p=float(kwargs.get("top_p", 0.95)),
            min_p=float(kwargs.get("min_p", 0.0)),
            repetition_penalty=float(kwargs.get("repeat_penalty", 1.1)),
            frequency_penalty=float(kwargs.get("frequency_penalty", 0.0)),
            presence_penalty=float(kwargs.get("presence_penalty", 0.0)),
            logit_bias=_bias_tuple(kwargs.get("logit_bias")),
            seed=kwargs.get("seed", self._seed),
            greedy=float(kwargs.get("temperature", 0.8)) <= 0.0,
            stop_sequences=tuple(stop_list),
            grammar=_grammar_source(kwargs.get("grammar"),
                                    kwargs.get("response_format"))
            or (tool_choice_grammar(fns, tool_choice) if fns else None),
            logprobs=_chat_logprobs_arg(kwargs),
        )
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        if stream:
            return self._stream_completion(cid, token_ids, gen_cfg,
                                           object_type="chat.completion.chunk")
        res = self._engine_generate(token_ids, gen_cfg)
        message: Dict[str, Any] = {"role": "assistant",
                                   "content": res["text"]}
        finish = res["finish_reason"]
        if fns is not None:
            calls = parse_tool_calls(res["text"], fns)
            if calls is not None:
                message = {"role": "assistant", "content": None,
                           "tool_calls": calls}
                finish = "tool_calls"
        lp_block = None
        if res.get("logprobs") is not None:
            piece = self._engine.tokenizer.token_to_piece
            lp_block = {"content": [{
                "token": e["text"], "logprob": e["logprob"],
                "top_logprobs": [{"token": piece(i) or "", "logprob": l}
                                 for i, l in e["top"]],
            } for e in res["logprobs"]]}
        return {
            "id": cid,
            "object": "chat.completion",
            "created": int(time.time()),
            "model": self.model_path,
            "choices": [{
                "index": 0,
                "message": message,
                "logprobs": lp_block,
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": len(token_ids),
                "completion_tokens": res["completion_tokens"],
                "total_tokens": len(token_ids) + res["completion_tokens"],
            },
        }

    # ------------------------------------------------------- embeddings
    def create_embedding(self, input: Union[str, List[str]],
                         model: Optional[str] = None) -> Dict[str, Any]:
        if isinstance(input, str):
            input = [input]
        data = []
        total = 0
        for i, text in enumerate(input):
            ids = self.tokenize(text)
            total += len(ids)
            h = self._engine.embed_ids(ids)       # [T, H]
            data.append({
                "object": "embedding",
                "embedding": h.mean(axis=0).tolist(),   # mean pooling
                "index": i,
            })
        return {
            "object": "list",
            "data": data,
            "model": model or self.model_path,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }

    def embed(self, input: Union[str, List[str]]) -> List:
        out = self.create_embedding(input)["data"]
        if len(out) == 1:
            return out[0]["embedding"]
        return [d["embedding"] for d in out]

    # ----------------------------------------------------------- state
    def reset(self) -> None:
        self._n_past = 0
        self._eval_tokens = []
        self._last_logits = None

    def save_state(self):
        from ..engine.checkpoint import capture

        return capture(self._engine, self._eval_tokens, [])

    def load_state(self, state) -> None:
        from ..engine.checkpoint import restore

        restore(self._engine, state)
        self._eval_tokens = list(state.all_ids)
        self._n_past = len(self._eval_tokens)

    def set_cache(self, cache: Any) -> None:
        self._cache_obj = cache

    def get_cache(self) -> Any:
        return getattr(self, "_cache_obj", None)

    # ------------------------------------------------------- properties
    @property
    def n_vocab(self) -> int:
        return self._engine.tokenizer.vocab_size()

    @property
    def n_ctx(self) -> int:
        return self._n_ctx

    @property
    def n_embd(self) -> int:
        return self._engine.cfg.hidden_size

    # llama-cpp-python exposes these as methods on some versions
    def n_vocab_(self) -> int:
        return self.n_vocab

    @property
    def metadata(self) -> dict:
        if not hasattr(self, "_metadata"):
            meta: dict = {}
            if str(self.model_path).endswith(".gguf"):
                try:
                    from ..gguf.reader import GGUFReader

                    r = GGUFReader(self.model_path)
                    meta = dict(r.metadata)
                    r.close()
                except Exception:
                    meta = {}
            self._metadata = meta
        return self._metadata

    # ------------------------------------------------------- internals
    def _engine_generate(self, token_ids: List[int],
                         gen_cfg: GenerationConfig) -> Dict[str, Any]:
        from ..engine.stop import StopReason

        res = self._engine.generate(token_ids, gen_cfg)
        reason = ("length" if res.stop_reason == StopReason.MAX_TOKENS
                  else "stop")
        return {
            "text": res.text,
            "completion_tokens": len(res.token_ids),
            "finish_reason": reason,
            "logprobs": res.logprobs,
        }

    def _format_logprobs(self, entries) -> Optional[Dict[str, Any]]:
        """Engine logprob entries → OpenAI completions logprobs block."""
        if entries is None:
            return None
        piece = self._engine.tokenizer.token_to_piece
        text_offset, off = [], 0
        for e in entries:
            text_offset.append(off)
            off += len(e["text"])
        return {
            "tokens": [e["text"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [{piece(i) or "": lp for i, lp in e["top"]}
                             for e in entries],
            "text_offset": text_offset,
        }

    def _stream_completion(self, cid: str, token_ids: List[int],
                           gen_cfg: GenerationConfig,
                           object_type: str) -> Iterator[Dict[str, Any]]:
        from ..engine.stop import StopReason

        created = int(time.time())
        chat = object_type == "chat.completion.chunk"
        n = 0
        if chat:
            yield {
                "id": cid, "object": object_type, "created": created,
                "model": self.model_path,
                "choices": [{"index": 0,
                             "delta": {"role": "assistant"},
                             "finish_reason": None}],
            }
        for ev in self._engine.generate_stream(token_ids, gen_cfg):
            n += 1
            piece = ev.text
            body = ({"delta": {"content": piece}} if chat
                    else {"text": piece, "logprobs": None})
            yield {
                "id": cid, "object": object_type, "created": created,
                "model": self.model_path,
                "choices": [dict(body, index=0, finish_reason=None)],
            }
        reason = ("length"
                  if self._engine._last_stop_reason == StopReason.MAX_TOKENS
                  else "stop")
        final = ({"delta": {}} if chat else {"text": "", "logprobs": None})
        yield {
            "id": cid, "object": object_type, "created": created,
            "model": self.model_path,
            "choices": [dict(final, index=0, finish_reason=reason)],
        }


# ---------------------------------------------------------------------------
# Module-level llama.cpp compatibility helpers
# ---------------------------------------------------------------------------
def llama_backend_init(numa: bool = False) -> None:
    """No-op (the engine initializes its device)."""


def llama_backend_free() -> None:
    """No-op."""


class LlamaCache:
    """Pickle-compatible opaque cache object (reference
    llama_compat.py:364-374)."""

    def __init__(self, capacity: int = 512):
        self.capacity = capacity
        self.data: dict = {}

    def __getstate__(self):
        return self.data

    def __setstate__(self, state):
        self.data = state


__all__ = ["Llama", "LlamaCache", "llama_backend_init", "llama_backend_free"]
