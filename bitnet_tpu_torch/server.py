"""Shim: ``python -m bitnet_tpu_torch.server`` / CLI ``serve`` entry point
(``bitnet_tpu/server.py``, plus ``--device``)."""

from .serve.server import serve

if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--kv-cache-dtype", default="bf16")
    ap.add_argument("--kernel-path", default="auto")
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--shard", default=None,
                    help="DP,TP mesh (one process a rank; on one host the "
                         "followers are started here)")
    ap.add_argument("--auth-token", default=None,
                    help="require 'Authorization: Bearer <token>' "
                         "(also via $BITNET_AUTH_TOKEN)")
    ap.add_argument("--model-dir", action="append", default=None,
                    help="whitelist dir for /v1/models/load (repeatable; "
                         "default: the started model's directory)")
    ap.add_argument("--paged", action="store_true",
                    help="back the slot pool with the shared page pool")
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain PyTorch versions)")
    a = ap.parse_args()
    serve(a.model, a.host, a.port, a.max_seq_len, a.kv_cache_dtype,
          a.kernel_path, a.num_slots, a.shard, a.auth_token, a.model_dir,
          a.paged, a.num_pages, a.page_size, device=a.device)
