"""bitnet_tpu_torch command-line interface: ``run``, ``benchmark-kernels``
and the verification subcommands.

Counterpart of ``bitnet_tpu/cli.py``'s ``run`` (``:20-118``,
``:155-269``): the same generation and engine flags, prompt templates,
streamed text and the ``[n tokens, ttft, tok/s]`` line, plus ``--device``
(default ``cuda``; ``--device cpu`` runs the kernels' plain versions).
``run --receipt PATH`` writes an honest-compute receipt whose ``kernels``
name the hand-written kernels that launched; ``run --grammar-file`` /
``--json-schema`` constrain the output as the JAX CLI's do
(``:132-151``); ``run --speculative K [--draft-model PATH]`` decodes
greedily through ``engine/speculative.SpeculativeDecoder`` (``:219-237``:
n-gram drafts, or a draft GGUF loaded under the same flags; the text on
stdout, ``[speculative: {...}]`` on stderr).  Flags whose paths are not
ported raise ``NotImplementedError`` naming their ROADMAP item; none is
silently ignored.  ``benchmark-kernels`` (``:477-497``, ``:999-1010``)
prints the JSON of ``tools/kernel_bench.py``: device time per kernel call
on the card, the plain versions' host time with ``--device cpu`` (for
tests only).  ``crossval``, ``gate``, ``verify-receipt``, ``replay`` and
``trace-diff`` (``:744-865``) print the JAX CLI's JSON and exit codes;
``crossval --trace-out`` also dumps the port's per-layer activation trace
for ``trace-diff``.  ``serve`` (``:878-893``, ``:929-969``) starts the
HTTP server (``serve/server.py`` on the standard-library ``serve/http.py``)
with the JAX CLI's flags plus ``--device``; ``--shard`` raises naming
ROADMAP queue 1 #13.  ``convert``, ``st-inspect`` and ``st-merge``
(``:456-475``, ``:868-875``, ``:971-994``) convert, inspect and merge
SafeTensors checkpoints with the JAX CLI's flags and output.  ``--model``
takes a GGUF, a ``.safetensors`` file or an HF checkpoint directory
(converted once to a cached sibling GGUF), and ``run --sliding-window W``
decodes over the windowed ring cache.  The other subcommands are #17.

    python -m bitnet_tpu_torch.cli run --model model.gguf --prompt "Hello"
    python -m bitnet_tpu_torch.cli serve -m model.gguf --port 8080
    python -m bitnet_tpu_torch.cli crossval -m model.gguf --tokens 2,7,11,5
    python -m bitnet_tpu_torch.cli benchmark-kernels --attention all --m 8
    python -m bitnet_tpu_torch.cli run -m hf_checkpoint_dir/ --sliding-window 256
    python -m bitnet_tpu_torch.cli convert -i model.safetensors -o model.gguf
"""

from __future__ import annotations

import argparse
import json
import sys

from .config import not_ported


def _add_gen_flags(p: argparse.ArgumentParser) -> None:
    """Generation and engine flags (bitnet_tpu/cli.py:20-88)."""
    p.add_argument("--model", "-m", required=True,
                   help="GGUF, .safetensors file or HF checkpoint directory")
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

    if args.require_native:
        raise not_ported("the host C++ codec (--require-native)", "#22")
    checks: dict[str, bool] = {}
    try:
        # a cuda device resolves only when it is an sm_90 card
        dev = resolve_device(args.device)
        checks["device_reachable"] = True
    except Exception:
        dev = None
        checks["device_reachable"] = False
    checks["native_codec"] = True       # never required: see --require-native
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
                   help="shard the slot pool over a (data, model) mesh: not "
                        "ported (ROADMAP.md queue 1 #13)")
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
                   help="the host C++ codec: not ported (ROADMAP.md "
                        "queue 1 #22)")
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
