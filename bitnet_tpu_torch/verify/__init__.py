"""Verification: receipts, activation tracing, logits parity, compat.

Counterpart of ``bitnet_tpu/verify/`` with the same exported names; the
crossval harness (``crossval.py``), replay (``replay.py``) and GGUF
diagnosis (``compat.py``) are imported from their modules."""

from .receipts import (
    InferenceReceipt,
    generate_receipt,
    validate_receipt,
)
from .reference import compare_logits, cosine_similarity, reference_forward
from .trace import TraceRecord, TraceSink, compare_records

__all__ = [
    "InferenceReceipt",
    "generate_receipt",
    "validate_receipt",
    "compare_logits",
    "cosine_similarity",
    "reference_forward",
    "TraceRecord",
    "TraceSink",
    "compare_records",
]
