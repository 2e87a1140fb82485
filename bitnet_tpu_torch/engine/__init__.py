"""Engine: KV cache, greedy sampling, the inference engine."""
