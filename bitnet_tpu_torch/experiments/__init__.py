"""The port's experiment entry points: ``exp_w2a8`` (the W2A8 probes and
prototype) and ``exp_r4_attn`` (the per-layer decode-attention bench), run
with ``python -m bitnet_tpu_torch.experiments.<name>``."""
