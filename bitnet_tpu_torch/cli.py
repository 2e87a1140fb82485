"""bitnet_tpu_torch command-line interface: the JAX CLI's subcommands on
the card.

Counterpart of ``bitnet_tpu/cli.py``, subcommand for subcommand (a test
holds the two parsers' sets equal), with the same flags, JSON keys, text
and exit codes.  ``run`` (``:20-118``, ``:155-269``): the same generation
and engine flags, prompt templates, streamed text and the ``[n tokens,
ttft, tok/s]`` line, plus ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain versions), as every subcommand that builds an
engine takes it (``chat``, ``score``, ``benchmark``, ``crossval``,
``replay``, ``serve``).  ``run --receipt PATH`` writes an honest-compute
receipt naming the hand-written kernels that launched; ``run
--grammar-file`` / ``--json-schema`` constrain the output
(``:132-151``); ``run --speculative K [--draft-model PATH]`` decodes
greedily through ``engine/speculative.SpeculativeDecoder`` (``:219-237``).
``benchmark-kernels`` (``:477-497``) prints ``tools/kernel_bench.py``'s
JSON.  ``crossval``, ``gate``, ``verify-receipt``, ``replay`` and
``trace-diff`` (``:744-865``) verify; ``gate --require-native`` checks
that the loader packs QK256 on the device (the port's counterpart of the
JAX native codec).  ``serve`` (``:878-893``) starts the HTTP server;
``--shard DP,TP`` serves over a mesh of ranks, one process a rank (on one
host without ``$BITNET_COORDINATOR`` it starts its followers itself;
``serve/server.serve``).  ``convert``,
``st-inspect`` and ``st-merge`` handle SafeTensors checkpoints.
``tokenize``, ``inspect``, ``chat``, ``score``, ``benchmark``,
``list-templates``, ``list-architectures``, ``compat-check``, ``config``,
``info``, ``bench-compare``, ``preflight``, ``fingerprint``, ``ln-check``
and ``download-model`` (``:273-455``, ``:500-743``, ``:838-856``) are the
JAX ones; ``info`` and ``preflight`` report torch and the card in place
of JAX and the TPU.  ``--model`` takes a GGUF, a ``.safetensors`` file or
an HF checkpoint directory, and defaults to ``config set model``'s value.

    python -m bitnet_tpu_torch.cli run --model model.gguf --prompt "Hello"
    python -m bitnet_tpu_torch.cli serve -m model.gguf --port 8080
    python -m bitnet_tpu_torch.cli crossval -m model.gguf --tokens 2,7,11,5
    python -m bitnet_tpu_torch.cli benchmark-kernels --attention all --m 8
    python -m bitnet_tpu_torch.cli run -m hf_checkpoint_dir/ --sliding-window 256
    python -m bitnet_tpu_torch.cli convert -i model.safetensors -o model.gguf
    python -m bitnet_tpu_torch.cli score -m model.gguf --file text.txt
    python -m bitnet_tpu_torch.cli fingerprint -m model.gguf
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_gen_flags(p: argparse.ArgumentParser) -> None:
    """Generation and engine flags (bitnet_tpu/cli.py:20-88)."""
    p.add_argument("--model", "-m", default=None,
                   help="GGUF, .safetensors file or HF checkpoint directory "
                        "(default: the `config set model` value)")
    p.add_argument("--tokenizer", help="tokenizer.json path (optional)")
    p.add_argument("--prompt", "-p", default="Hello")
    p.add_argument("--max-new-tokens", "-n", type=int, default=128)
    p.add_argument("--min-new-tokens", type=int, default=0,
                   help="suppress EOS/stop triggers until this many "
                        "tokens are emitted (vLLM min_tokens)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--min-p", type=float, default=0.0)
    p.add_argument("--repetition-penalty", type=float, default=1.0)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--logit-bias", default=None,
                   help="comma-separated token_id:bias pairs, e.g. "
                        "'128001:-100,42:5' (<= -100 bans the token)")
    p.add_argument("--stop", "--stop-sequence", action="append",
                   default=[], metavar="SEQ",
                   help="stop sequence (repeatable; adds to the "
                        "template's own stops)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--logprobs", type=int, default=None, metavar="N",
                   help="report per-token log-probabilities plus the "
                        "top-N alternatives (stderr table)")
    p.add_argument("--grammar-file", default=None, metavar="GBNF",
                   help="constrain output to a GBNF grammar file")
    p.add_argument("--json-schema", default=None, metavar="SCHEMA",
                   help="constrain output to a JSON schema: 'any' (any "
                        "JSON value), an inline {...} schema, or a file")
    p.add_argument("--prompt-template", default=None,
                   help="template type, or 'embedded' to execute the "
                        "GGUF's own jinja chat template (sandboxed)")
    p.add_argument("--system-prompt", default=None)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--kv-cache-dtype", default="bf16",
                   choices=["bf16", "f32", "int8", "fp8", "auto"],
                   help="auto = int8 once max-seq-len >= 4096, else bf16")
    p.add_argument("--kernel-path", default="auto",
                   choices=["auto", "w2a8", "pallas", "xla"],
                   help="auto = w2a8 on the card, xla on the CPU")
    p.add_argument("--compute-dtype", default="bf16", choices=["bf16", "f32"])
    p.add_argument("--weight-quant", default="none",
                   choices=["none", "tl1", "tl2"],
                   help="re-quantize every linear to TL1 (64-row blocks) or "
                        "TL2 (128-row blocks) at load")
    p.add_argument("--decode-steps", type=int, default=0,
                   help="decode tokens per host round-trip (K-step "
                        "segments, one CUDA graph on the card; 0 = auto: 8 "
                        "on the card, 1 on the CPU). Tokens equal K=1's.")
    p.add_argument("--sliding-window", type=int, default=0, metavar="W",
                   help="sliding-window attention over a ring-buffer KV "
                        "cache of W tokens: unbounded generation in "
                        "constant device memory (0 = off; W <= "
                        "--max-seq-len)")
    p.add_argument("--strict", action="store_true",
                   help="strict mode: no mock tokenizer")
    p.add_argument("--no-stream", action="store_true")
    p.add_argument("--receipt", default=None,
                   help="write an honest-compute receipt JSON here")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding with K n-gram draft tokens "
                        "(greedy only; lossless)")
    p.add_argument("--draft-model", default=None,
                   help="GGUF path of a smaller draft model for "
                        "--speculative (default: n-gram self-drafting)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")


def _build_engine(args):
    """bitnet_tpu/cli.py:91-118, on ``args.device``."""
    from .config import EngineConfig, StrictMode
    from .device_probe import resolve_device
    from .engine.engine import InferenceEngine
    from .tokenizer import HFTokenizer, load_tokenizer

    device = resolve_device(args.device)
    strict = StrictMode(enabled=args.strict, allow_mock=not args.strict,
                        deterministic=args.deterministic)
    ecfg = EngineConfig(
        max_seq_len=args.max_seq_len,
        kv_cache_dtype=args.kv_cache_dtype,
        kernel_path=args.kernel_path,
        compute_dtype=args.compute_dtype,
        weight_quant=args.weight_quant,
        decode_steps_per_dispatch=args.decode_steps,
        sliding_window=args.sliding_window,
        strict=strict,
    )
    if args.tokenizer:
        tokenizer = HFTokenizer(args.tokenizer)
    else:
        tokenizer = load_tokenizer(args.model, allow_mock=strict.allow_mock)
    if strict.enabled and tokenizer.is_mock:
        from .errors import StrictModeViolation

        raise StrictModeViolation("strict mode: mock tokenizer banned")
    return InferenceEngine.from_gguf(args.model, ecfg, tokenizer=tokenizer,
                                     device=device)


def _parse_logit_bias(spec: str | None) -> tuple:
    """'128001:-100,42:5' → ((42, 5.0), (128001, -100.0))."""
    if not spec:
        return ()
    pairs = {}
    for part in spec.split(","):
        tok, _, val = part.partition(":")
        pairs[int(tok.strip())] = float(val.strip())
    return tuple(sorted(pairs.items()))


def _resolve_cli_grammar(args) -> str | None:
    """--grammar-file / --json-schema → GBNF source, None when neither is
    given (bitnet_tpu/cli.py:132-151)."""
    gf, js = args.grammar_file, args.json_schema
    if gf and js:
        from .errors import ConfigError

        raise ConfigError("--grammar-file and --json-schema are exclusive")
    if gf:
        with open(gf) as f:
            return f.read()
    if js:
        from .grammar import JSON_GRAMMAR, json_schema_grammar

        if js == "any":
            return JSON_GRAMMAR
        if js.lstrip().startswith("{"):
            return json_schema_grammar(js)
        with open(js) as f:
            return json_schema_grammar(f.read())
    return None


def _gen_config(args, extra_stops=()):
    """bitnet_tpu/cli.py:155-175."""
    from .config import GenerationConfig

    return GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        min_new_tokens=args.min_new_tokens,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        min_p=args.min_p,
        repetition_penalty=args.repetition_penalty,
        frequency_penalty=args.frequency_penalty,
        presence_penalty=args.presence_penalty,
        logit_bias=_parse_logit_bias(args.logit_bias),
        seed=args.seed if not args.deterministic else (args.seed or 42),
        greedy=args.greedy or args.deterministic,
        stop_sequences=tuple(extra_stops) + tuple(args.stop or ()),
        grammar=_resolve_cli_grammar(args),
        logprobs=args.logprobs,
    )


def _prepare_prompt(args):
    """Template detect / apply (bitnet_tpu/cli.py:178-207)."""
    from . import templates
    from .gguf.reader import GGUFReader

    if args.prompt_template == "embedded":
        with GGUFReader(args.model) as r:
            md = dict(r.metadata)
        msgs = []
        if args.system_prompt:
            msgs.append(templates.Message("system", args.system_prompt))
        msgs.append(templates.Message("user", args.prompt))
        text = templates.render_chat_embedded(md, msgs)
        return text, templates.spec_for(templates.detect(md))
    if args.prompt_template:
        t = templates.TemplateType.parse(args.prompt_template)
    else:
        try:
            with GGUFReader(args.model) as r:
                t = templates.detect(r.metadata)
        except Exception:
            t = templates.TemplateType.RAW
    spec = templates.spec_for(t)
    return templates.apply(t, args.prompt, args.system_prompt), spec


def cmd_run(args) -> int:
    """bitnet_tpu/cli.py:213-269: stream the text to stdout, the metrics
    line (and logprobs, when asked) to stderr."""
    engine = _build_engine(args)
    text, spec = _prepare_prompt(args)
    gcfg = _gen_config(args, extra_stops=spec.stop_sequences)
    gcfg = gcfg.replace(add_bos=spec.add_bos)
    if args.speculative > 0:
        from .engine.speculative import EngineDraft, SpeculativeConfig, SpeculativeDecoder

        draft = None
        if args.draft_model:
            d_args = argparse.Namespace(**vars(args))
            d_args.model = args.draft_model
            draft = EngineDraft(_build_engine(d_args))
        dec = SpeculativeDecoder(
            engine, draft=draft,
            spec_cfg=SpeculativeConfig(num_draft_tokens=args.speculative))
        ids = engine.tokenizer.encode(text, add_bos=gcfg.add_bos)
        r = dec.generate(ids, gcfg.replace(greedy=True))
        print(r.text)
        print(f"[speculative: {r.spec_stats}]", file=sys.stderr)
    elif args.no_stream:
        print(engine.generate(text, gcfg).text)
    else:
        ids = engine.tokenizer.encode(text, add_bos=gcfg.add_bos)
        for ev in engine.generate_stream(ids, gcfg):
            sys.stdout.write(ev.text)
            sys.stdout.flush()
            if gcfg.logprobs is not None and ev.logprob is not None:
                alts = " ".join(
                    f"{engine.tokenizer.token_to_piece(i)!r}:{lp:.3f}"
                    for i, lp in (ev.top_logprobs or []))
                print(f"[lp {ev.text!r}:{ev.logprob:.3f}"
                      + (f" | {alts}" if alts else "") + "]", file=sys.stderr)
        print()
    m = engine.last_metrics.as_dict()
    print(f"[{m['generated_tokens']} tokens, "
          f"ttft {m['ttft_s']*1000:.0f} ms, "
          f"{m['decode_tok_s']:.2f} tok/s decode]", file=sys.stderr)
    if args.receipt:
        from .verify.receipts import generate_receipt

        rec = generate_receipt(engine, metrics=m)
        with open(args.receipt, "w") as f:
            json.dump(rec.to_dict(), f, indent=2)
        print(f"receipt written to {args.receipt}", file=sys.stderr)
    return 0


def cmd_tokenize(args) -> int:
    """Token ids and pieces of ``--prompt`` (bitnet_tpu/cli.py:273-284)."""
    from .tokenizer import load_tokenizer

    tk = load_tokenizer(args.model)
    ids = tk.encode(args.prompt, add_bos=not args.no_bos)
    print(json.dumps({
        "text": args.prompt,
        "ids": ids,
        "pieces": [tk.token_to_piece(i) or f"<{i}>" for i in ids],
        "count": len(ids),
    }, indent=2))
    return 0


def cmd_inspect(args) -> int:
    """GGUF metadata dump (bitnet_tpu/cli.py:287-319)."""
    from .gguf.reader import GGUFReader

    with GGUFReader(args.model) as r:
        quant_hist: dict[str, int] = {}
        tensors = []
        for info in r:
            tname = info.ggml_type.name
            quant_hist[tname] = quant_hist.get(tname, 0) + 1
            tensors.append({"name": info.name, "shape": list(info.logical_shape),
                            "type": tname, "bytes": info.nbytes})
        out = {
            "path": args.model,
            "version": r.version,
            "n_tensors": len(r.tensors),
            "n_kv": len(r.metadata),
            "architecture": r.architecture,
            "alignment": r.alignment,
            "quantization_histogram": quant_hist,
            "metadata": {
                k: (v if isinstance(v, (int, float, str, bool))
                    else f"<{type(v).__name__}[{len(v)}]>")
                for k, v in r.metadata.items()
            },
        }
        if args.tensors:
            out["tensors"] = tensors
        print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_chat(args) -> int:
    """Interactive REPL on ``args.device`` (bitnet_tpu/cli.py:322-363):
    ``/help``, ``/clear``, ``/metrics`` (the last turn's metrics, ``{}``
    before the first), ``/exit``."""
    from . import templates

    engine = _build_engine(args)
    t = (templates.TemplateType.parse(args.prompt_template)
         if args.prompt_template else templates.TemplateType.INSTRUCT)
    spec = templates.spec_for(t)
    history: list[templates.Message] = []
    if args.system_prompt:
        history.append(templates.Message("system", args.system_prompt))
    print("bitnet-tpu chat — /help for commands", file=sys.stderr)
    turns = 0
    while True:
        try:
            line = input("> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() == "/exit":
            break
        if line.strip() == "/help":
            print("/help /clear /metrics /exit", file=sys.stderr)
            continue
        if line.strip() == "/clear":
            history = history[:1] if args.system_prompt else []
            print("(history cleared)", file=sys.stderr)
            continue
        if line.strip() == "/metrics":
            print(json.dumps(engine.last_metrics.as_dict() if turns else {}),
                  file=sys.stderr)
            continue
        history.append(templates.Message("user", line))
        prompt = templates.render_chat(t, history)
        gcfg = _gen_config(args, extra_stops=spec.stop_sequences)
        ids = engine.tokenizer.encode(prompt, add_bos=spec.add_bos)
        reply = []
        for ev in engine.generate_stream(ids, gcfg):
            sys.stdout.write(ev.text)
            sys.stdout.flush()
            reply.append(ev.text)
        print()
        turns += 1
        history.append(templates.Message("assistant", "".join(reply)))
    return 0


def cmd_score(args) -> int:
    """Perplexity of ``--prompt`` or ``--file`` from one ``eval_ids`` on
    ``args.device`` (bitnet_tpu/cli.py:366-389)."""
    import numpy as np

    engine = _build_engine(args)
    text = args.prompt
    if args.file:
        with open(args.file) as f:
            text = f.read()
    ids = engine.tokenizer.encode(text, add_bos=True)
    if len(ids) < 2:
        print("need at least 2 tokens", file=sys.stderr)
        return 1
    ids = ids[: args.max_seq_len]
    logits = engine.eval_ids(ids)  # [T, V]
    logp = logits - np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(
        -1, keepdims=True)) - logits.max(-1, keepdims=True)
    nll = -np.mean([logp[t, ids[t + 1]] for t in range(len(ids) - 1)])
    print(json.dumps({
        "tokens": len(ids),
        "nll": float(nll),
        "perplexity": float(np.exp(nll)),
    }, indent=2))
    return 0


def cmd_benchmark(args) -> int:
    """One warm-up request (``InferenceEngine.warmup``), then one timed
    greedy request of ``-n`` tokens (seed 42) on ``args.device``
    (bitnet_tpu/cli.py:392-416)."""
    import time

    from .config import GenerationConfig

    engine = _build_engine(args)
    gcfg = GenerationConfig(max_new_tokens=args.max_new_tokens, greedy=True, seed=42)
    ids = engine.tokenizer.encode(args.prompt, add_bos=True)
    engine.warmup(ids, gcfg)
    t0 = time.perf_counter()
    n = 0
    for _ in engine.generate_stream(ids, gcfg):
        n += 1
    dt = time.perf_counter() - t0
    m = engine.last_metrics.as_dict()
    print(json.dumps({
        "prompt_tokens": len(ids),
        "generated_tokens": n,
        "wall_s": round(dt, 3),
        "decode_tok_s": m["decode_tok_s"],
        "ttft_s": m["ttft_s"],
        "kernel_path": engine.kernel_path,
    }))
    return 0


def cmd_list_templates(args) -> int:
    """bitnet_tpu/cli.py:419-426."""
    from . import templates

    for t in templates.TemplateType:
        spec = templates.spec_for(t)
        print(f"{t.value:20s} stops={list(spec.stop_sequences)} "
              f"bos={spec.add_bos}")
    return 0


def cmd_list_architectures(args) -> int:
    """bitnet_tpu/cli.py:429-436."""
    from .models.arch_registry import list_architectures

    for spec in list_architectures():
        tern = "ternary" if spec.supports_ternary else "dense"
        print(f"{spec.name:<14} [{spec.family}-family, {tern}] "
              f"{spec.description}")
    return 0


def cmd_compat_check(args) -> int:
    """GGUF compatibility report, optionally repaired into ``--fix-out``
    (bitnet_tpu/cli.py:439-453); exit 1 while errors remain."""
    from .verify.compat import diagnose, export_fixed

    report = diagnose(args.model)
    if args.fix_out:
        fixed = export_fixed(args.model, args.fix_out)
        report["applied"] = fixed["applied"]
        report["out_path"] = args.fix_out
        report["remaining_errors"] = diagnose(args.fix_out)["errors"]
        print(json.dumps(report, indent=2))
        return 0 if not report["remaining_errors"] else 1
    print(json.dumps(report, indent=2))
    return 0 if not report["errors"] else 1


# the variable that opens ``download-model`` to the network (the JAX
# package's ``tokenizer/download.ENV_ALLOW``)
ENV_ALLOW_DOWNLOADS = "BITNET_ALLOW_DOWNLOADS"


def cmd_download_model(args) -> int:
    """Fetch a GGUF from the HF hub (bitnet_tpu/cli.py:500-522): refused
    unless ``$BITNET_ALLOW_DOWNLOADS`` opens it, or when no hub client is
    installed."""
    import os

    if os.environ.get(ENV_ALLOW_DOWNLOADS, "").strip() not in ("1", "true", "yes"):
        print(json.dumps({"error": f"downloads disabled; set {ENV_ALLOW_DOWNLOADS}=1 "
                                   "or place the GGUF manually"}), file=sys.stderr)
        return 1
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        print(json.dumps({"error": "huggingface_hub unavailable"}), file=sys.stderr)
        return 1
    path = hf_hub_download(repo_id=args.repo, filename=args.file,
                           local_dir=args.out_dir)
    print(json.dumps({"path": path}))
    return 0


def _config_path() -> str:
    """``$BITNET_TPU_CONFIG``, else ``~/.config/bitnet_tpu/config.json``:
    the JAX CLI's file (bitnet_tpu/cli.py:525-531)."""
    import os

    return os.environ.get(
        "BITNET_TPU_CONFIG",
        os.path.join(os.path.expanduser("~"), ".config", "bitnet_tpu", "config.json"))


def _load_cli_config() -> dict:
    import os

    p = _config_path()
    if not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def cmd_config(args) -> int:
    """Persistent CLI defaults (bitnet_tpu/cli.py:548-583): ``path``,
    ``show``, ``set KEY VALUE`` (JSON values stay typed), ``unset KEY``;
    ``model`` is the default of every ``--model``."""
    import os

    path = _config_path()
    cfg = _load_cli_config()
    if args.action == "path":
        print(path)
        return 0
    if args.action == "show":
        print(json.dumps(cfg, indent=2))
        return 0
    if args.action == "set":
        if args.key is None or args.value is None:
            print("usage: config set KEY VALUE", file=sys.stderr)
            return 2
        val: object = args.value
        try:
            val = json.loads(args.value)
        except json.JSONDecodeError:
            pass
        cfg[args.key] = val
    elif args.action == "unset":
        if args.key is None:
            print("usage: config unset KEY", file=sys.stderr)
            return 2
        cfg.pop(args.key, None)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    print(json.dumps(cfg, indent=2))
    return 0


def cmd_info(args) -> int:
    """Versions and the device (bitnet_tpu/cli.py:586-635): torch and its
    CUDA build in place of jax / jaxlib, ``device_probe`` in place of the
    JAX probe, under the same ``--device-timeout`` watchdog (a card that
    does not answer is reported, never waited on)."""
    import platform
    import threading

    import numpy as np
    import torch

    info = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "numpy": np.__version__,
        "config_file": _config_path(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
    }
    probe_out: dict = {}

    def _probe():
        from .device_probe import probe_device

        p = probe_device()
        probe_out.update(backend="cuda" if p.platform == "gpu" else "cpu",
                         device=p.as_dict(),
                         recommended_kernel_path=p.recommended_kernel_path)

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout=args.device_timeout)
    if probe_out:
        info.update(probe_out)
    else:
        info["device"] = ("unavailable (device init exceeded "
                          f"{args.device_timeout:.0f}s)")
    print(json.dumps(info, indent=2))
    return 0


def _bench_metrics(path: str) -> dict[str, float]:
    """Numeric metrics of a bench artifact (bitnet_tpu/cli.py:638-672): a
    bench's stdout (its JSON line), a ``{"parsed": {...}}`` or ``{"tail":
    "..."}`` record, or a plain JSON object."""
    with open(path) as f:
        raw = f.read()
    doc = None
    try:
        doc = json.loads(raw)
    except json.JSONDecodeError:
        pass
    if doc is None:
        for line in raw.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    doc = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
    if doc is None:
        raise SystemExit(f"no JSON metrics found in {path}")
    if isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    elif "tail" in doc and "value" not in doc:
        for line in str(doc["tail"]).splitlines():
            line = line.strip()
            if line.startswith("{") and '"metric"' in line:
                try:
                    doc = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
    return {k: float(v) for k, v in doc.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def cmd_bench_compare(args) -> int:
    """Compare two bench artifacts (bitnet_tpu/cli.py:675-717): keys naming
    ms / latency / seconds / time are lower-is-better, the rest
    higher-is-better; exit 1 on a regression beyond ``--threshold``."""
    base = _bench_metrics(args.baseline)
    cand = _bench_metrics(args.candidate)
    lower_better = ("ms", "latency", "_s", "seconds", "time")
    rows = []
    regressions = 0
    for key in sorted(set(base) & set(cand)):
        b, c = base[key], cand[key]
        if b == 0:
            continue
        lb = any(t in key.lower() for t in lower_better)
        change = (b - c) / abs(b) if lb else (c - b) / abs(b)
        status = "ok"
        if change < -args.threshold:
            status = "REGRESSION"
            regressions += 1
        elif change > args.threshold:
            status = "improved"
        rows.append({"metric": key, "baseline": b, "candidate": c,
                     "change_pct": round(100 * change, 2),
                     "direction": "lower" if lb else "higher",
                     "status": status})
    only = {"baseline_only": sorted(set(base) - set(cand)),
            "candidate_only": sorted(set(cand) - set(base))}
    report = {"rows": rows, "regressions": regressions,
              "threshold_pct": 100 * args.threshold, **only}
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for r in rows:
            print(f"{r['status']:>10}  {r['metric']}: "
                  f"{r['baseline']:g} -> {r['candidate']:g} "
                  f"({r['change_pct']:+.1f}%)")
        if only["baseline_only"] or only["candidate_only"]:
            print(f"unmatched: {only}", file=sys.stderr)
        print(f"{regressions} regression(s) at "
              f"±{100 * args.threshold:.0f}%")
    return 1 if regressions else 0


def cmd_preflight(args) -> int:
    """Readiness report (bitnet_tpu/cli.py:720-742): the card
    (``device_probe``) in place of the TPU probe, ``native_codec`` true
    when that card is there (the loader packs QK256 on it), ``nvcc`` and
    ``g++`` as the toolchain, the external C++ reference."""
    import shutil

    from .device_probe import probe_device
    from .errors import KernelError
    from .ops._cuda import nvcc_path
    from .verify.crossval import cpp_reference_available

    try:
        nvcc = bool(nvcc_path())
    except KernelError:
        nvcc = False
    probe = probe_device()
    report = {
        "device": probe.as_dict(),
        "recommended_kernel_path": probe.recommended_kernel_path,
        "native_codec": probe.platform == "gpu",
        "toolchain": {"nvcc": nvcc, "gxx": shutil.which("g++") is not None},
        "cpp_reference": cpp_reference_available(),
    }
    print(json.dumps(report, indent=2))
    return 0


def cmd_fingerprint(args) -> int:
    """bitnet_tpu/cli.py:838-842."""
    from .models.validation import checkpoint_metadata

    print(json.dumps(checkpoint_metadata(args.model), indent=2))
    return 0


def cmd_ln_check(args) -> int:
    """LayerNorm RMS envelope (bitnet_tpu/cli.py:845-854); exit 1 when a
    norm is rejected."""
    from .gguf.reader import GGUFReader
    from .models.validation import detect_rules, validate_model_lns

    with GGUFReader(args.model) as r:
        rules = detect_rules(r.architecture or "")
        report = validate_model_lns(r, rules)
    print(json.dumps(report, indent=2))
    return 0 if not report["rejected"] else 1


def cmd_crossval(args) -> int:
    """Per-token logits cross-validation (bitnet_tpu/cli.py:744-765):
    ``eval_ids`` on ``--device`` against the C++ golden (``cppref``), an
    external C++ build (``cpp``) or the numpy golden (``golden``)."""
    from .verify import crossval as cv
    from .verify.trace import TraceSink

    engine = _build_engine(args)
    ids = [int(t) for t in args.tokens.split(",")] if args.tokens else \
        engine.tokenizer.encode(args.prompt, add_bos=True)
    sink = TraceSink() if args.trace_out else None
    if args.backend == "cpp":
        res = cv.crossval_cpp(engine, args.model, ids,
                              threshold=args.threshold, trace=sink)
    elif args.backend == "cppref":
        res = cv.crossval_cppref(engine, args.model, ids,
                                 threshold=args.threshold, trace=sink)
    else:
        # golden: numpy reference forward over the dequantized GGUF
        res = cv.crossval_golden_gguf(engine, args.model, ids,
                                      threshold=args.threshold, trace=sink)
    if sink is not None:
        sink.dump(args.trace_out)
    if args.baselines:
        cv.record_baseline(res, args.baselines, {"model": args.model})
    print(json.dumps(res.as_dict(), indent=2))
    return 0 if res.passed else 1


def cmd_gate(args) -> int:
    """CI gate (bitnet_tpu/cli.py:767-810): one JSON verdict over the
    device, a receipt and an optional crossval against the C++ golden.
    ``--require-cuda`` (the JAX gate's ``--require-tpu``) checks that
    ``--device`` is an sm_90 card."""
    from .device_probe import resolve_device

    checks: dict[str, bool] = {}
    try:
        # a cuda device resolves only when it is an sm_90 card
        dev = resolve_device(args.device)
        checks["device_reachable"] = True
    except Exception:
        dev = None
        checks["device_reachable"] = False
    # the JAX key says the native codec is built; here that the loader can
    # pack QK256 on the device, i.e. that it is reachable (always true when
    # not required, as there)
    checks["native_codec"] = not args.require_native or dev is not None
    if args.receipt:
        from .verify.receipts import InferenceReceipt, validate_receipt

        try:
            with open(args.receipt) as f:
                r = InferenceReceipt.from_json(f.read())
            checks["receipt_valid"] = not validate_receipt(r, strict=True)
        except Exception:
            checks["receipt_valid"] = False
    if args.require_cuda:
        checks["cuda"] = dev is not None and dev.type == "cuda"
    extra: dict = {}
    if args.crossval_model:
        # engine vs the in-repo independent C++ golden (>0.99 cosine)
        from .engine.engine import InferenceEngine
        from .verify import crossval as cv

        try:
            engine = InferenceEngine.from_gguf(args.crossval_model,
                                               device=args.device)
            ids = [int(t) for t in args.crossval_tokens.split(",")]
            res = cv.crossval_cppref(engine, args.crossval_model, ids)
            checks["crossval_cppref"] = res.passed
            extra["crossval"] = {"min_cosine": res.min_cosine,
                                 "backend": res.backend}
        except Exception as e:
            checks["crossval_cppref"] = False
            extra["crossval"] = {"error": str(e)}
    verdict = all(checks.values())
    print(json.dumps({"checks": checks, "passed": verdict, **extra},
                     indent=2))
    return 0 if verdict else 1


def cmd_verify_receipt(args) -> int:
    """Validate an honest-compute receipt (bitnet_tpu/cli.py:812-822)."""
    from .verify.receipts import InferenceReceipt, validate_receipt

    with open(args.receipt) as f:
        r = InferenceReceipt.from_json(f.read())
    problems = validate_receipt(r, strict=not args.tolerant)
    print(json.dumps({"receipt": args.receipt, "problems": problems,
                      "valid": not problems}, indent=2))
    return 0 if not problems else 1


def cmd_replay(args) -> int:
    """Replay a receipt's generation on ``--device`` and check the output
    token for token (bitnet_tpu/cli.py:824-856)."""
    from .verify.receipts import InferenceReceipt
    from .verify.replay import replay_receipt

    with open(args.replay_receipt) as f:
        rec = InferenceReceipt.from_json(f.read())
    engine = _build_engine(args)
    report = replay_receipt(engine, rec)
    print(json.dumps(report.as_dict(), indent=2))
    return 0 if report.matched else 1


def cmd_trace_diff(args) -> int:
    """Compare two activation trace dumps (bitnet_tpu/cli.py:857-865)."""
    from .verify.trace import TraceSink, compare_records

    a = TraceSink.load(args.a)
    b = TraceSink.load(args.b)
    diffs = compare_records(a.records, b.records, rms_rtol=args.rms_tol)
    print(json.dumps({"mismatches": diffs}, indent=2))
    return 0 if not diffs else 1


# chain lengths of the plain versions' host timing (--device cpu, tests)
CPU_CHAINS = {"n_hi": 4, "n_lo": 2, "pairs": 1}


def cmd_benchmark_kernels(args) -> int:
    """Per-kernel micro-benchmarks (bitnet_tpu/cli.py:477-497): the 2B
    decode shapes, one ``--shape``, or ``--attention`` variants."""
    from .device_probe import resolve_device
    from .tools.kernel_bench import (ATTN_VARIANTS, bench_decode_attention,
                                     bench_decode_shapes, bench_ternary_kernel)

    dev = resolve_device(args.device)
    kw = {"device": dev, **(CPU_CHAINS if dev.type == "cpu" else {})}
    if args.attention:
        variants = (ATTN_VARIANTS if args.attention == "all"
                    else args.attention.split(","))
        results = [bench_decode_attention(v, B=args.m, S=args.seq_len, **kw)
                   for v in variants]
    elif args.shape:
        k, n = (int(x) for x in args.shape.split("x"))
        results = [bench_ternary_kernel(k, n, m=args.m, **kw)]
    else:
        results = bench_decode_shapes(m=args.m, **kw)
    print(json.dumps([r.as_dict() for r in results], indent=2))
    return 0


def cmd_convert(args) -> int:
    """SafeTensors → GGUF (bitnet_tpu/cli.py:868-875)."""
    from .tools.st2gguf import convert_safetensors_to_gguf

    convert_safetensors_to_gguf(args.input, args.output, quant=args.quant)
    print(f"wrote {args.output}")
    return 0


def cmd_st_inspect(args) -> int:
    """Header-only summary of a SafeTensors file (bitnet_tpu/cli.py:456-465)."""
    from .tools.st_tools import inspect_safetensors

    report = inspect_safetensors(args.input)
    if not args.verbose:
        report["tensors"] = report["tensors"][:10] + (
            [{"...": f"{report['num_tensors'] - 10} more"}]
            if report["num_tensors"] > 10 else [])
    print(json.dumps(report, indent=2))
    return 0


def cmd_st_merge(args) -> int:
    """Merge SafeTensors shards into one file (bitnet_tpu/cli.py:468-474)."""
    from .tools.st_tools import merge_safetensors

    inputs = args.inputs[0] if len(args.inputs) == 1 else args.inputs
    print(json.dumps(merge_safetensors(inputs, args.output), indent=2))
    return 0


def cmd_serve(args) -> int:
    """bitnet_tpu/cli.py:878-893, on ``args.device``."""
    from .serve.server import serve

    serve(model_path=args.model, host=args.host, port=args.port,
          max_seq_len=args.max_seq_len, shard=args.shard,
          num_slots=args.num_slots,
          kv_cache_dtype=args.kv_cache_dtype,
          kernel_path=args.kernel_path,
          auth_token=args.auth_token, model_dirs=args.model_dir,
          paged=args.paged, num_pages=args.num_pages,
          page_size=args.page_size,
          chunked_prefill=args.chunked_prefill,
          speculative_k=args.speculative,
          decode_steps_per_dispatch=args.serve_decode_steps,
          pipeline_depth=args.pipeline_depth, device=args.device)
    return 0


def _add_serve_parser(sub) -> None:
    """bitnet_tpu/cli.py:929-969, plus ``--device``."""
    p = sub.add_parser("serve", help="HTTP inference server")
    p.add_argument("--shard", default=None, metavar="DP,TP",
                   help="shard the slot pool over a (data, model) mesh, one "
                        "process a rank, e.g. --shard 2,4 on an 8-card host")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--kv-cache-dtype", default="bf16")
    p.add_argument("--kernel-path", default="auto")
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--auth-token", default=None,
                   help="bearer-token auth (also $BITNET_AUTH_TOKEN)")
    p.add_argument("--model-dir", action="append", default=None,
                   help="whitelist dir for /v1/models/load (repeatable)")
    p.add_argument("--paged", action="store_true",
                   help="back the slot pool with the shared page pool "
                        "(device memory sized by live tokens, prefix forking)")
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="serving-level speculative decoding: verify K "
                        "n-gram draft tokens per forward (greedy slots, "
                        "dense single-host pools)")
    p.add_argument("--chunked-prefill", type=int, default=None,
                   metavar="N",
                   help="prefill long prompts N tokens per scheduler "
                        "step, interleaved with decode (bounds "
                        "inter-token latency of in-flight streams)")
    p.add_argument("--serve-decode-steps", type=int, default=1,
                   metavar="K",
                   help="decode steps per device dispatch in the "
                        "serving pool (tokens identical to K=1; stop/"
                        "admission latency bounded by K)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   metavar="D",
                   help="issue up to D decode windows ahead of the "
                        "reader (device-resident decode state; dense "
                        "single-host pools)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    p.set_defaults(fn=cmd_serve)


def _add_inspection_parsers(sub) -> None:
    """The subcommands of bitnet_tpu/cli.py:905-927, :978-982, :996-997,
    :1012-1017, :1059-1067, :1076-1102: model inspection, the chat REPL,
    scoring and the throughput bench (those three on ``--device``), the
    catalogs, the config file, the host report and bench comparison."""
    p = sub.add_parser("tokenize", help="tokenize a prompt")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--prompt", "-p", required=True)
    p.add_argument("--no-bos", action="store_true")
    p.set_defaults(fn=cmd_tokenize)

    p = sub.add_parser("inspect", help="dump GGUF metadata")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--tensors", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("chat", help="interactive chat REPL")
    _add_gen_flags(p)
    p.set_defaults(fn=cmd_chat)

    p = sub.add_parser("score", help="perplexity scoring")
    _add_gen_flags(p)
    p.add_argument("--file", help="text file to score")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("benchmark", help="deterministic throughput bench")
    _add_gen_flags(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("compat-check", help="diagnose GGUF compatibility")
    p.add_argument("--model", "-m", default=None)
    p.add_argument("--fix-out", default=None,
                   help="write a repaired GGUF here (export_fixed)")
    p.set_defaults(fn=cmd_compat_check)

    p = sub.add_parser("preflight", help="environment readiness report")
    p.set_defaults(fn=cmd_preflight)

    p = sub.add_parser("download-model",
                       help="fetch a GGUF from the HF hub (offline-gated)")
    p.add_argument("--repo", required=True)
    p.add_argument("--file", default="ggml-model-i2_s.gguf")
    p.add_argument("--out-dir", default=".")
    p.set_defaults(fn=cmd_download_model)

    p = sub.add_parser("fingerprint", help="checkpoint fingerprint + metadata")
    p.add_argument("--model", "-m", default=None)
    p.set_defaults(fn=cmd_fingerprint)

    p = sub.add_parser("ln-check", help="LayerNorm RMS envelope validation")
    p.add_argument("--model", "-m", default=None)
    p.set_defaults(fn=cmd_ln_check)

    p = sub.add_parser("list-templates")
    p.set_defaults(fn=cmd_list_templates)

    p = sub.add_parser("list-architectures")
    p.set_defaults(fn=cmd_list_architectures)

    p = sub.add_parser("info", help="system / runtime report")
    p.add_argument("--device-timeout", type=float, default=20.0,
                   help="seconds to wait for the device probe before "
                        "reporting the device as unavailable")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("config", help="persistent CLI defaults")
    p.add_argument("action", choices=["show", "set", "unset", "path"])
    p.add_argument("key", nargs="?", default=None)
    p.add_argument("value", nargs="?", default=None)
    p.set_defaults(fn=cmd_config)

    p = sub.add_parser("bench-compare",
                       help="compare two bench artifacts, flag regressions "
                            "(exit 1 on regression)")
    p.add_argument("baseline", help="a bench's output or a BENCH_r{N}.json")
    p.add_argument("candidate")
    p.add_argument("--threshold", type=float, default=0.05,
                   help="relative regression tolerance (default 5%%)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_bench_compare)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="bitnet-tpu-torch",
                                 description="BitNet inference on an H100")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("run", help="single-shot generation")
    _add_gen_flags(p)
    p.set_defaults(fn=cmd_run)
    p = sub.add_parser("benchmark-kernels",
                       help="per-kernel ternary matmul / decode-attention "
                            "microbenchmarks")
    p.add_argument("--shape", default=None, metavar="KxN",
                   help="one shape, e.g. 2560x6912 (default: 2B decode set)")
    p.add_argument("--m", type=int, default=1, help="batch rows")
    p.add_argument("--attention", default=None, metavar="V1,V2|all",
                   help="bench decode-attention kernels instead "
                        "(decode_attn_plan variant names, or 'all')")
    p.add_argument("--seq-len", type=int, default=1024,
                   help="cache length for --attention")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu times the plain "
                        "PyTorch versions on the host, for tests only)")
    p.set_defaults(fn=cmd_benchmark_kernels)

    p = sub.add_parser("crossval",
                       help="per-token logits cross-validation")
    _add_gen_flags(p)
    p.add_argument("--tokens", default=None,
                   help="comma-separated token ids (else encode --prompt)")
    p.add_argument("--backend", default="cppref",
                   choices=["cppref", "cpp", "golden"],
                   help="cppref = in-repo independent C++ forward pass; "
                        "cpp = external bitnet.cpp/llama.cpp via "
                        "BITNET_CPP_DIR; golden = numpy reference over "
                        "the dequantized GGUF")
    p.add_argument("--threshold", type=float, default=0.99)
    p.add_argument("--baselines", default=None,
                   help="append the result to this baselines.json")
    p.add_argument("--trace-out", default=None, metavar="JSON",
                   help="also dump eval_ids' per-layer activation trace "
                        "here (compare two with trace-diff)")
    p.set_defaults(fn=cmd_crossval)

    p = sub.add_parser("gate", help="CI gate: JSON pass/fail verdict")
    p.add_argument("--receipt", default=None)
    p.add_argument("--require-cuda", action="store_true",
                   help="fail unless --device is an sm_90 CUDA card")
    p.add_argument("--require-native", action="store_true",
                   help="fail unless the loader packs QK256 on --device "
                        "(the JAX CLI's native codec check)")
    p.add_argument("--crossval-model", default=None,
                   help="GGUF to cross-validate against the independent "
                        "C++ golden (cosine gate)")
    p.add_argument("--crossval-tokens", default="1,2,3,4,5",
                   help="comma-separated token ids for --crossval-model")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain PyTorch versions)")
    p.set_defaults(fn=cmd_gate)

    p = sub.add_parser("verify-receipt",
                       help="validate an honest-compute receipt")
    p.add_argument("receipt")
    p.add_argument("--tolerant", action="store_true")
    p.set_defaults(fn=cmd_verify_receipt)

    p = sub.add_parser("replay",
                       help="deterministically replay a receipt")
    _add_gen_flags(p)
    p.add_argument("--receipt-in", dest="replay_receipt", required=True,
                   help="receipt JSON to replay")
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("trace-diff",
                       help="compare two activation trace dumps")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--rms-tol", type=float, default=0.02)
    p.set_defaults(fn=cmd_trace_diff)
    _add_serve_parser(sub)

    p = sub.add_parser("convert", help="SafeTensors → GGUF")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--quant", default="f16",
                   choices=["f16", "f32", "bitnet32", "qk256"])
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("st-inspect", help="inspect a SafeTensors file")
    p.add_argument("input")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="list every tensor")
    p.set_defaults(fn=cmd_st_inspect)

    p = sub.add_parser("st-merge", help="merge SafeTensors shards")
    p.add_argument("inputs", nargs="+",
                   help="shard files, an index.json, or a directory")
    p.add_argument("--output", "-o", required=True)
    p.set_defaults(fn=cmd_st_merge)
    _add_inspection_parsers(sub)
    args = ap.parse_args(argv)
    if getattr(args, "model", "absent") is None:
        # --model accepted but not given: the config file's default
        # (bitnet_tpu/cli.py:1104-1110)
        args.model = _load_cli_config().get("model")
        if args.model is None:
            ap.error("--model/-m is required (or set a default once: "
                     "bitnet-tpu-torch config set model /path/model.gguf)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
