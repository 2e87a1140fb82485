"""SafeTensors checkpoints in the port (``tools/safetensors_io.py``,
``tools/st2gguf.py``, ``tools/st_tools.py``, the loader's
``_resolve_checkpoint`` and the CLI's ``convert``, ``st-inspect`` and
``st-merge``) against the ``safetensors`` library and the JAX package.

- The port's files and the library's read each other bit for bit.
- A converted GGUF is the JAX converter's, byte for byte, for each
  ``--quant``; from a file, from a sharded directory with and without
  ``model.safetensors.index.json``.
- A SafeTensors file or an HF directory loads through a cached sibling
  GGUF, reused while it is newer than every shard (the JAX mtime rule).
- ``cli run`` on a ``.safetensors`` file and on an HF directory prints the
  JAX CLI's greedy text; ``st-inspect``, ``st-merge`` and ``convert``
  print the JAX CLI's output.
- A BF16 checkpoint converts and loads as the JAX ``load_model`` route
  converts and loads it.
"""

import json
import os

import numpy as np
import pytest
import torch

from bitnet_tpu import cli as jcli
from bitnet_tpu_torch import cli
from bitnet_tpu_torch.errors import ModelError
from bitnet_tpu_torch.tools import safetensors_io as sio

st_lib = pytest.importorskip("safetensors.numpy")

# the suite runs one worker process per core: one torch thread each
# keeps the small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

H, F, V, L, NH, NKV, D = 64, 128, 320, 2, 4, 2, 16


def _checkpoint(seed=0):
    """HF-named tensors of a 2-layer model (f16 linears, f32 norms) and its
    config.json."""
    rng = np.random.default_rng(seed)
    t = {"model.embed_tokens.weight": (rng.standard_normal((V, H)) * 0.05).astype(np.float16),
         "model.norm.weight": (1 + rng.standard_normal(H) * 0.01).astype(np.float32)}
    for i in range(L):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = (1 + rng.standard_normal(H) * 0.01).astype(np.float32)
        t[p + "post_attention_layernorm.weight"] = np.ones(H, np.float32)
        for nm, shape in (("self_attn.q_proj", (NH * D, H)), ("self_attn.k_proj", (NKV * D, H)),
                          ("self_attn.v_proj", (NKV * D, H)), ("self_attn.o_proj", (H, NH * D)),
                          ("mlp.gate_proj", (F, H)), ("mlp.up_proj", (F, H)),
                          ("mlp.down_proj", (H, F))):
            t[p + nm + ".weight"] = (rng.standard_normal(shape) * 0.08).astype(np.float16)
    t["rotary.inv_freq"] = np.arange(8, dtype=np.float32)      # unmapped: skipped
    cfg = {"hidden_size": H, "intermediate_size": F, "num_hidden_layers": L,
           "num_attention_heads": NH, "num_key_value_heads": NKV, "head_dim": D,
           "vocab_size": V, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
           "max_position_embeddings": 128}
    return t, cfg


def _write_file(tmp_path, name="model.safetensors"):
    t, cfg = _checkpoint()
    path = tmp_path / name
    sio.save_file(t, str(path))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    return str(path), t


def _write_dir(d, index=True):
    """Two shards (layer 0 and the globals; layer 1), with or without
    ``model.safetensors.index.json``."""
    t, cfg = _checkpoint()
    d.mkdir()
    shards = {"model-00001-of-00002.safetensors": {}, "model-00002-of-00002.safetensors": {}}
    for k, v in t.items():
        shards["model-00002-of-00002.safetensors" if ".layers.1." in k
               else "model-00001-of-00002.safetensors"][k] = v
    for fn, part in shards.items():
        sio.save_file(part, str(d / fn))
    if index:
        wm = {k: fn for fn, part in shards.items() for k in part}
        (d / "model.safetensors.index.json").write_text(json.dumps({"weight_map": wm}))
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d), t


# ------------------------------------------------------------ the format
TENSORS = {"a_f32": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
           "b_f16": (np.arange(6, dtype=np.float16) - 2.5).reshape(2, 3),
           "c_f64": np.array([1e-300, -2.5]), "d_i64": np.array([[-3, 2**40]]),
           "e_i32": np.array([7], np.int32), "f_i16": np.array([-2, 3], np.int16),
           "g_i8": np.array([-128, 127], np.int8), "h_u8": np.array([0, 255], np.uint8),
           "i_bool": np.array([True, False, True]), "j_scalar": np.array(3.5, np.float32),
           "k_empty": np.zeros((0, 4), np.float32)}


def test_port_and_library_files_read_each_other(tmp_path):
    a, b = str(tmp_path / "port.safetensors"), str(tmp_path / "lib.safetensors")
    sio.save_file(TENSORS, a, metadata={"format": "pt"})
    st_lib.save_file(TENSORS, b, metadata={"format": "pt"})
    for path in (a, b):
        for got in (sio.load_file(path), st_lib.load_file(path)):
            assert set(got) == set(TENSORS)
            for k, v in TENSORS.items():
                assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
                np.testing.assert_array_equal(got[k], v)
    header, _ = sio.read_header(a)
    assert header["__metadata__"] == {"format": "pt"}


def test_bf16_converts_as_the_jax_load_model_route(tmp_path):
    """A BF16 checkpoint converts as the JAX loader's route converts it: that
    route runs with JAX imported, which registers ``ml_dtypes``' bfloat16
    with numpy, so ``safetensors.numpy`` reads it and the converter widens it
    to f32.  The port's reader widens BF16 to f32 exactly everywhere: its
    ``convert`` writes the JAX in-process converter's GGUF byte for byte,
    and its loader gives the JAX ``load_model``'s params bit for bit.  (The
    JAX CLI's ``convert``, a process without ``ml_dtypes``, fails on the
    file: ROADMAP §3.)"""
    import subprocess
    import sys

    import jax.numpy as jnp

    from bitnet_tpu.models.loader import load_model as jload_model
    from bitnet_tpu.tools.st2gguf import convert_safetensors_to_gguf as jconvert
    from bitnet_tpu_torch.models.loader import load_model

    t, cfg = _checkpoint()
    raw = {k: (v.astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
           for k, v in t.items()}
    head, off = {}, 0
    for k in sorted(raw):
        head[k] = {"dtype": "BF16", "shape": list(raw[k].shape),
                   "data_offsets": [off, off + raw[k].nbytes]}
        off += raw[k].nbytes
    blob = json.dumps(head).encode()
    path = tmp_path / "model.safetensors"
    path.write_bytes(len(blob).to_bytes(8, "little") + blob
                     + b"".join(raw[k].tobytes() for k in sorted(raw)))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    got = sio.load_file(str(path))
    for k, v in raw.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k].view(np.uint32), v.astype(np.uint32) << 16)
    assert cli.main(["convert", "-i", str(path), "-o", str(tmp_path / "p.gguf")]) == 0
    jconvert(str(path), str(tmp_path / "j.gguf"))
    assert (tmp_path / "p.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()
    _c, p, rep = load_model(str(path), param_dtype=torch.float32, device="cpu")
    _jc, jp, jrep = jload_model(str(path), param_dtype=jnp.float32)
    assert rep.path == jrep.path
    np.testing.assert_array_equal(p.embed.numpy(), np.asarray(jp.embed))
    np.testing.assert_array_equal(p.blocks.wq.weight.numpy(), np.asarray(jp.blocks.wq.weight))
    np.testing.assert_array_equal(p.blocks.attn_norm.numpy(), np.asarray(jp.blocks.attn_norm))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "bitnet_tpu.cli", "convert", "-i",
                        str(path), "-o", str(tmp_path / "j2.gguf")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0 and "bfloat16" in r.stderr


def test_corrupt_files_are_refused(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\x05\x00\x00\x00\x00\x00\x00\x00{nope")
    with pytest.raises(ModelError, match="corrupt"):
        sio.load_file(str(bad))
    short = tmp_path / "short.safetensors"
    head = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}).encode()
    short.write_bytes(len(head).to_bytes(8, "little") + head + bytes(8))
    with pytest.raises(ModelError, match="data_offsets"):
        sio.load_file(str(short))


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize("quant", ["f16", "f32", "bitnet32", "qk256"])
@pytest.mark.parametrize("src", ["file", "dir_index", "dir_no_index"])
def test_converted_gguf_is_the_jax_converters(tmp_path, quant, src):
    from bitnet_tpu.tools.st2gguf import convert_safetensors_to_gguf as jconvert
    from bitnet_tpu_torch.tools.st2gguf import convert_safetensors_to_gguf

    if src == "file":
        path, _ = _write_file(tmp_path)
    else:
        path, _ = _write_dir(tmp_path / "ckpt", index=src == "dir_index")
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    ra = convert_safetensors_to_gguf(path, a, quant=quant)
    rb = jconvert(path, b, quant=quant)
    assert {k: v for k, v in ra.items() if k != "output"} == \
        {k: v for k, v in rb.items() if k != "output"}
    assert ra["skipped"] == ["rotary.inv_freq"] and ra["converted"] == 2 + 9 * L
    assert open(a, "rb").read() == open(b, "rb").read()


def test_st2gguf_name_map_is_the_jax_one():
    from bitnet_tpu.tools import st2gguf as jst
    from bitnet_tpu_torch.tools import st2gguf as pst

    names = ["model.embed_tokens.weight", "model.norm.weight", "lm_head.weight",
             "model.layers.3.self_attn.inner_attn_ln.weight",
             "model.layers.0.mlp.ffn_layernorm.weight", "model.layers.12.mlp.down_proj.weight",
             "model.layers.1.self_attn.rotary_emb.inv_freq", "foo"]
    assert [pst.map_hf_name(n) for n in names] == [jst.map_hf_name(n) for n in names]
    assert all(pst.is_norm_tensor(g) == jst.is_norm_tensor(g)
               for g in ("blk.0.attn_norm.weight", "output_norm.weight", "blk.0.ffn_up.weight"))


@pytest.mark.parametrize("src", ["file", "dir"])
def test_checkpoints_load_through_a_cached_gguf(tmp_path, src):
    """The JAX mtime rule: the first load converts, a second reuses the
    cache (its mtime unchanged), a newer shard reconverts; the params are
    the JAX loader's, bit for bit."""
    import jax.numpy as jnp

    from bitnet_tpu.models.loader import load_model as jload_model
    from bitnet_tpu_torch.models.loader import load_model

    if src == "file":
        path, _ = _write_file(tmp_path)
        cache = str(tmp_path / "model.converted.gguf")
        shard = path
    else:
        path, _ = _write_dir(tmp_path / "ckpt")
        cache = str(tmp_path / "ckpt.converted.gguf")
        shard = os.path.join(path, "model-00002-of-00002.safetensors")
    cfg, p, rep = load_model(path, param_dtype=torch.float32, device="cpu")
    assert rep.path == cache and os.path.exists(cache)
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.vocab_size) == (H, L, NH, NKV, D, V)
    assert set(rep.kinds.values()) == {"dense"}
    m1 = os.path.getmtime(cache)
    load_model(path, device="cpu")
    assert os.path.getmtime(cache) == m1
    _jc, jp, jrep = jload_model(path, param_dtype=jnp.float32)
    assert jrep.path == cache and os.path.getmtime(cache) == m1
    np.testing.assert_array_equal(p.blocks.w_down.weight.numpy(),
                                  np.asarray(jp.blocks.w_down.weight))
    os.utime(shard, (m1 + 10, m1 + 10))
    load_model(path, device="cpu")
    assert os.path.getmtime(cache) > m1
    with pytest.raises(ModelError, match="no .safetensors"):
        empty = tmp_path / "empty"
        empty.mkdir()
        load_model(str(empty), device="cpu")


# ------------------------------------------------------------ the CLI
ARGS = ["--prompt", "Hello world", "--prompt-template", "raw", "-n", "10", "--greedy"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("src", ["file", "dir"])
def test_cli_run_on_a_checkpoint_prints_the_jax_text(tmp_path, capsys, src):
    """``run -m`` a ``.safetensors`` file or an HF directory (the JAX
    tokenizer rule finds no tokenizer beside it: the mock) at f32: the JAX
    CLI's greedy text; then ``--sliding-window 16`` past its window."""
    path = (_write_file(tmp_path)[0] if src == "file"
            else _write_dir(tmp_path / "ckpt")[0] + "/")
    f32 = ["--compute-dtype", "f32", "--kv-cache-dtype", "f32"]
    want = _run(jcli.main, ["run", "-m", path, *ARGS, *f32, "--kernel-path", "xla"],
                capsys)
    got = _run(cli.main, ["run", "-m", path, *ARGS, *f32, "--device", "cpu"], capsys)
    assert got == want and len(got.strip()) > 0
    win = ["--sliding-window", "16", "-n", "24"]
    want = _run(jcli.main, ["run", "-m", path, *ARGS, *f32, "--kernel-path", "xla",
                            *win], capsys)
    got = _run(cli.main, ["run", "-m", path, *ARGS, *f32, "--device", "cpu", *win],
               capsys)
    assert got == want


@pytest.mark.parametrize("fixture", ["mini_gguf_f32", "mini_gguf_qk256"])
def test_cli_run_on_the_mini_ggufs_with_a_window(request, capsys, fixture):
    """``run --sliding-window 64`` on the F32 and QK256 minis prints the
    JAX CLI's greedy text (f32, past the window: 80 tokens)."""
    path = request.getfixturevalue(fixture).path
    argv = ["run", "-m", path, "--prompt", "Hello world", "--prompt-template", "raw",
            "-n", "80", "--greedy", "--compute-dtype", "f32", "--kv-cache-dtype",
            "f32", "--sliding-window", "64", "--max-seq-len", "128"]
    want = _run(jcli.main, argv + ["--kernel-path", "xla"], capsys)
    got = _run(cli.main, argv + ["--device", "cpu"], capsys)
    assert got == want


@pytest.mark.parametrize("verbose", [False, True])
def test_cli_st_inspect_is_the_jax_output(tmp_path, capsys, verbose):
    path, _ = _write_file(tmp_path)
    argv = ["st-inspect", path] + (["-v"] if verbose else [])
    want = _run(jcli.main, argv, capsys)
    got = _run(cli.main, argv, capsys)
    assert got == want
    rep = json.loads(got)
    assert rep["num_tensors"] == 2 + 9 * L + 1
    assert len(rep["tensors"]) == (rep["num_tensors"] if verbose else 11)


@pytest.mark.parametrize("how", ["dir", "index", "files"])
def test_cli_st_merge_is_the_jax_output(tmp_path, capsys, how):
    d, t = _write_dir(tmp_path / "ckpt")
    shards = sorted(os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".safetensors"))
    inputs = {"dir": [d], "index": [os.path.join(d, "model.safetensors.index.json")],
              "files": shards}[how]
    a, b = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    got = json.loads(_run(cli.main, ["st-merge", *inputs, "-o", a], capsys))
    want = json.loads(_run(jcli.main, ["st-merge", *inputs, "-o", b], capsys))
    assert got.pop("out_path") == a and want.pop("out_path") == b
    assert got == want and got["num_shards"] == 2
    for path in (a, b):
        for merged in (sio.load_file(path), st_lib.load_file(path)):
            assert set(merged) == set(t)
            for k, v in t.items():
                np.testing.assert_array_equal(merged[k], v)
    with pytest.raises(ModelError, match="duplicate"):
        cli.main(["st-merge", shards[0], shards[0], "-o", str(tmp_path / "dup.safetensors")])


@pytest.mark.parametrize("quant", ["f32", "qk256"])
def test_cli_convert_is_the_jax_output(tmp_path, capsys, quant):
    path, _ = _write_file(tmp_path)
    a, b = str(tmp_path / "port.gguf"), str(tmp_path / "jax.gguf")
    got = _run(cli.main, ["convert", "-i", path, "-o", a, "--quant", quant], capsys)
    want = _run(jcli.main, ["convert", "-i", path, "-o", b, "--quant", quant], capsys)
    assert got == f"wrote {a}\n" and want == f"wrote {b}\n"
    assert open(a, "rb").read() == open(b, "rb").read()


def test_served_hf_directory_is_the_jax_engines(tmp_path):
    """``ModelManager.load`` (``/v1/models/load``'s body) of an HF directory
    resolves it through the cached GGUF; a greedy request through its
    scheduler gives the JAX engine's tokens on the same directory (f32)."""
    from bitnet_tpu.config import EngineConfig as JEngineConfig
    from bitnet_tpu.config import GenerationConfig as JGen
    from bitnet_tpu.engine import InferenceEngine as JEngine
    from bitnet_tpu_torch.config import EngineConfig, GenerationConfig
    from bitnet_tpu_torch.serve.model_manager import ModelManager

    d, _ = _write_dir(tmp_path / "ckpt")
    kw = dict(max_seq_len=64, compute_dtype="f32", kv_cache_dtype="f32", kernel_path="xla")
    man = ModelManager(EngineConfig(**kw), num_slots=2, device="cpu")
    try:
        info = man.load("hf", d, make_default=True)
        sched = man.get("hf")
        req = sched.submit([1, 7, 20, 3], GenerationConfig(max_new_tokens=10, greedy=True))
        got = [tok for tok, _text in sched.stream(req)]
    finally:
        man.shutdown()
    assert info["name"] == "hf" and os.path.exists(str(tmp_path / "ckpt.converted.gguf"))
    want = JEngine.from_gguf(d, JEngineConfig(**kw)).generate(
        [1, 7, 20, 3], JGen(max_new_tokens=10, greedy=True)).token_ids
    assert got == want
