"""GGUF container: format constants and a memory-mapped reader (numpy)."""
