"""GGUF compatibility diagnosis (reference: ``bitnet-compat``
``src/lib.rs:1-26`` GgufCompatibilityFixer::diagnose).

Counterpart of ``bitnet_tpu/verify/compat.py`` on the port's own GGUF
reader and writer: checks the metadata / tensor invariants llama.cpp-family
loaders rely on and reports errors, warnings and proposed fixes.
"""

from __future__ import annotations

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFReader


REQUIRED_KEYS = ["general.architecture"]
EXPECTED_ARCH_KEYS = [
    "{a}.embedding_length",
    "{a}.block_count",
    "{a}.attention.head_count",
]


def diagnose(path: str) -> dict:
    errors: list[str] = []
    warnings: list[str] = []
    fixes: list[str] = []
    try:
        r = GGUFReader(path)
    except Exception as e:
        return {"path": path, "errors": [f"unreadable: {e}"],
                "warnings": [], "fixes": []}
    with r:
        for k in REQUIRED_KEYS:
            if k not in r.metadata:
                errors.append(f"missing metadata key {k}")
                fixes.append(f"add {k}")
        arch = r.architecture
        if arch:
            for tmpl in EXPECTED_ARCH_KEYS:
                k = tmpl.format(a=arch)
                if k not in r.metadata:
                    warnings.append(f"missing {k} (loader will use defaults)")
        if "tokenizer.ggml.tokens" not in r.metadata:
            warnings.append("no embedded tokenizer vocab; a sibling "
                            "tokenizer.json will be required")
        if "token_embd.weight" not in r.tensors and \
                "model.embed_tokens.weight" not in r.tensors:
            errors.append("no token embedding tensor")
        n_layers = r.arch_key("block_count")
        if n_layers:
            for i in range(int(n_layers)):
                if (f"blk.{i}.attn_q.weight" not in r.tensors and
                        f"model.layers.{i}.self_attn.q_proj.weight"
                        not in r.tensors):
                    errors.append(f"layer {i}: missing attention weights")
                    break
        # I2_S flavor sanity per tensor
        from ..quant.flavor import detect_i2s_flavor

        for info in r.tensors.values():
            if info.ggml_type == GGMLType.I2_S:
                try:
                    detect_i2s_flavor(info.nelems, info.nbytes,
                                      name=info.name)
                except Exception as e:
                    errors.append(str(e))
    return {"path": path, "errors": errors, "warnings": warnings,
            "fixes": fixes}


def export_fixed(path: str, out_path: str) -> dict:
    """Rewrite a GGUF with repairable metadata problems fixed
    (``GgufCompatibilityFixer::export_fixed``, bitnet-compat lib.rs:16-25).

    Fixes applied: missing ``general.architecture`` (inferred from tensor
    names), missing ``<arch>.{embedding_length, block_count,
    attention.head_count}`` (inferred from tensor shapes).  Tensor payloads
    are copied verbatim.  Returns the applied-fixes report.
    """
    import re

    from ..gguf.writer import GGUFWriter

    applied: list[str] = []
    with GGUFReader(path) as r:
        md = dict(r.metadata)

        arch = r.architecture
        if arch is None:
            arch = "llama"
            if any(n.startswith("blk.") for n in r.tensors):
                arch = "bitnet-b1.58" if any(
                    i.ggml_type == GGMLType.I2_S for i in r.tensors.values()) else "llama"
            md["general.architecture"] = arch
            applied.append(f"set general.architecture={arch}")

        emb = r.tensors.get("token_embd.weight") \
            or r.tensors.get("model.embed_tokens.weight")
        if emb is not None and f"{arch}.embedding_length" not in md:
            hidden = emb.logical_shape[-1]
            md[f"{arch}.embedding_length"] = int(hidden)
            applied.append(f"set {arch}.embedding_length={hidden}")

        if f"{arch}.block_count" not in md:
            layer_ids = set()
            for n in r.tensors:
                m = re.match(r"blk\.(\d+)\.", n)
                if m:
                    layer_ids.add(int(m.group(1)))
            if layer_ids:
                n_layers = max(layer_ids) + 1
                md[f"{arch}.block_count"] = n_layers
                applied.append(f"set {arch}.block_count={n_layers}")

        if f"{arch}.attention.head_count" not in md and emb is not None:
            q = r.tensors.get("blk.0.attn_q.weight")
            if q is not None:
                hidden = emb.logical_shape[-1]
                heads = max(1, q.logical_shape[0] // 128)
                md[f"{arch}.attention.head_count"] = int(heads)
                applied.append(
                    f"set {arch}.attention.head_count={heads} (head_dim "
                    "assumed 128)")

        w = GGUFWriter()
        for k, v in md.items():
            w.add_metadata(k, v)
        for info in r.tensors.values():
            raw = bytes(r.tensor_bytes(info.name))
            w.add_quantized_tensor(info.name, tuple(info.logical_shape),
                                   info.ggml_type, raw)
        w.write(out_path)
    return {"path": path, "out_path": out_path, "applied": applied}
