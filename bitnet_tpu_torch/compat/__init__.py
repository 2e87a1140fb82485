"""Drop-in API-compatibility surfaces for other frameworks' users.

``bitnet_tpu_torch.compat.llama`` mirrors the llama-cpp-python ``Llama``
class on top of the port's engine, on the card (the port of
``bitnet_tpu/compat/``).
"""

from .llama import (
    Llama,
    LlamaCache,
    LlamaGrammar,
    llama_backend_free,
    llama_backend_init,
)

__all__ = ["Llama", "LlamaCache", "LlamaGrammar",
           "llama_backend_init", "llama_backend_free"]
