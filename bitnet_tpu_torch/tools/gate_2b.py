"""One-command 2B readiness gate of the port: the counterpart of
``tools/gate_2b.py``, through the port's own CLI.

Steps, each but the build a process of its own, as a user would run them:
  1. generate (or reuse) the full-width synthetic 2B GGUF with
     ``tools/gen_2b_gguf.py`` (H=2560, F=6912, L=30, 20/5 heads, 32k
     vocab, random I2_S payloads from a seed);
  2. build the independent C++ golden if missing
     (``make -C native CXX=g++ build/bitnet_golden``, ``cppref_binary``);
  3. ``python -m bitnet_tpu_torch.cli run --greedy --receipt``: load,
     greedy generation on ``--device``, an honest-compute receipt;
  4. ``cli gate --receipt`` (with ``--require-cuda`` on the card): the
     receipt strict-valid, the device an sm_90 card;
  5. ``cli crossval --backend cppref``: per-position logits cosine and
     perplexity against the C++ forward pass (gate: every cosine >= 0.99);
  6. with ``--with-golden``: the same against the numpy golden (slow at
     full width; a second, redundant check);
  7. with ``--trace-dir``: step 5 also dumps its per-layer trace, and a
     ``--device cpu`` crossval (the kernels' plain versions) dumps its
     own; ``cli trace-diff`` names the first layer where they part.

Prints ONE JSON verdict line and exits nonzero on any failed check.

    python -m bitnet_tpu_torch.tools.gate_2b [--gguf PATH] [--kind qk256|bitnet32]
        [--device cuda] [--kernel-path auto|w2a8|pallas|xla] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ..errors import InferenceError
from ..verify.crossval import cppref_binary

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PY = sys.executable


def run(cmd: list[str], timeout: int = 600) -> tuple[int, str, str]:
    """(rc, stdout, stderr) of ``cmd`` run from the repository root, with
    the root on ``PYTHONPATH`` (``tools/gen_2b_gguf.py`` imports the
    package beside it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO, env=env)
    except subprocess.TimeoutExpired:
        return 124, "", f"timeout after {timeout}s: {' '.join(cmd)}"
    return p.returncode, p.stdout, p.stderr


def _last_json(text: str) -> dict | None:
    """The JSON object a CLI command printed last on stdout."""
    try:
        return json.loads(text[text.index("{"):text.rindex("}") + 1])
    except ValueError:
        return None


CLI = [PY, "-m", "bitnet_tpu_torch.cli"]
CROSSVAL_KEYS = ("cosines", "min_cosine", "first_divergence", "ppl_ours",
                 "ppl_theirs", "ppl_rel_delta")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gguf", default=None,
                    help="GGUF path (default: bitnet2b_<kind>_gate.gguf "
                         "under the temporary directory; generated if absent)")
    ap.add_argument("--kind", default="qk256", choices=["qk256", "bitnet32"])
    ap.add_argument("--tokens", default="2,7,11,5",
                    help="comma token ids for the crossval positions")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device of steps 3-5 (default cuda; cpu runs "
                         "the kernels' plain PyTorch versions)")
    ap.add_argument("--kernel-path", default="auto",
                    choices=["auto", "w2a8", "pallas", "xla"])
    ap.add_argument("--with-golden", action="store_true",
                    help="also run the numpy-golden leg")
    ap.add_argument("--trace-dir", default=None,
                    help="dump the crossval's per-layer traces on --device "
                         "and on the CPU here, and trace-diff them")
    args = ap.parse_args(argv)
    gguf = args.gguf or os.path.join(tempfile.gettempdir(),
                                     f"bitnet2b_{args.kind}_gate.gguf")

    t0 = time.time()
    checks: dict[str, bool] = {}
    extra: dict = {"device": args.device, "kernel_path": args.kernel_path}
    seconds: dict[str, float] = {}

    def step(name, cmd, timeout):
        t = time.time()
        out = run(cmd, timeout)
        seconds[name] = round(time.time() - t, 1)
        return out

    engine = ["--max-seq-len", "256", "--device", args.device,
              "--kernel-path", args.kernel_path]

    # 1. model file
    if not os.path.exists(gguf):
        rc, out, err = step("generate", [PY, "tools/gen_2b_gguf.py", args.kind,
                                         gguf], 900)
        checks["gguf_generated"] = rc == 0 and os.path.exists(gguf)
        if not checks["gguf_generated"]:
            extra["gen_error"] = (out + err)[-800:]
    else:
        checks["gguf_generated"] = True

    # 2. native golden binary (make, with g++, if missing)
    t = time.time()
    try:
        cppref_binary()
        checks["golden_built"] = True
    except InferenceError as e:
        checks["golden_built"] = False
        extra["golden_error"] = str(e)[-800:]
    seconds["golden_build"] = round(time.time() - t, 1)

    # 3-4. CLI load → greedy generate → receipt, validated by the CLI gate
    tmp = tempfile.TemporaryDirectory(prefix="gate2b_")
    receipt = os.path.join(tmp.name, "receipt.json")
    if checks["gguf_generated"]:
        rc, out, err = step("run", CLI + [
            "run", "-m", gguf, "--prompt", "The",
            "--max-new-tokens", str(args.max_new), "--greedy", "--no-stream",
            "--receipt", receipt, *engine], 1200)
        checks["cli_generate"] = rc == 0
        if rc != 0:
            extra["run_error"] = (out + err)[-800:]
        gate = ["gate", "--receipt", receipt, "--device", args.device]
        if args.device.startswith("cuda"):
            gate.append("--require-cuda")
        rc, out, err = step("gate", CLI + gate, 300)
        checks["receipt_valid"] = rc == 0
        extra["gate"] = _last_json(out)
        if os.path.exists(receipt):
            with open(receipt) as f:
                r = json.load(f)
            extra["receipt"] = {k: r.get(k) for k in
                                ("backend", "compute_path", "kernels")}
            extra["receipt"]["nvidia_smi"] = r["environment"].get("nvidia_smi")
    else:
        checks["cli_generate"] = checks["receipt_valid"] = False

    # 5. per-position cosine + ppl parity vs the independent C++ golden
    trace = {}
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        trace = {d: os.path.join(args.trace_dir, f"trace_{d}.json")
                 for d in ("device", "cpu")}
    if checks["golden_built"] and checks["gguf_generated"]:
        cmd = CLI + ["crossval", "-m", gguf, "--tokens", args.tokens,
                     "--backend", "cppref", *engine]
        if trace:
            cmd += ["--trace-out", trace["device"]]
        rc, out, err = step("crossval_cppref", cmd, 1200)
        j = _last_json(out)
        checks["crossval_cppref"] = rc == 0 and j is not None and j["passed"]
        if j is not None:
            extra["cppref"] = {k: j.get(k) for k in CROSSVAL_KEYS}
        else:
            extra["cppref_raw"] = (out + err)[-800:]
    else:
        checks["crossval_cppref"] = False

    # 6. numpy golden leg (independent of the C++ one; opt-in)
    if args.with_golden and checks["gguf_generated"]:
        rc, out, err = step("crossval_golden", CLI + [
            "crossval", "-m", gguf, "--tokens", args.tokens,
            "--backend", "golden", *engine], 1200)
        checks["crossval_golden"] = rc == 0
        j = _last_json(out)
        extra["golden"] = ({"min_cosine": j.get("min_cosine")} if j
                           else {"raw": (out + err)[-400:]})

    # 7. the same crossval on the CPU's plain versions, and where the two
    # devices' layers part (information: not a check)
    if trace and os.path.exists(trace["device"]):
        rc, out, err = step("crossval_cpu", CLI + [
            "crossval", "-m", gguf, "--tokens", args.tokens,
            "--backend", "cppref", "--max-seq-len", "256", "--device", "cpu",
            "--kernel-path", "w2a8" if args.kernel_path == "auto"
            else args.kernel_path, "--trace-out", trace["cpu"]], 1800)
        j = _last_json(out)
        extra["cpu_cppref"] = ({k: j.get(k) for k in CROSSVAL_KEYS} if j
                               else {"raw": (out + err)[-400:]})
        rc, out, err = step("trace_diff", CLI + [
            "trace-diff", trace["device"], trace["cpu"]], 300)
        j = _last_json(out)
        diffs = (j or {}).get("mismatches", [])
        extra["trace_diff"] = {"mismatches": len(diffs),
                               "first": diffs[0] if diffs else None}

    tmp.cleanup()
    verdict = {
        "gate": "2b-readiness",
        "pass": all(checks.values()),
        "checks": checks,
        "elapsed_s": round(time.time() - t0, 1),
        "seconds": seconds,
        **extra,
    }
    print(json.dumps(verdict))
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
