"""Model: config from GGUF, weight map, loader, forward pass, converter."""
