"""Rate-limited one-shot warnings (reference ``bitnet-warn-once``).

Own copy of ``bitnet_tpu/obs/warn_once.py``: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import threading
import warnings

_seen: set[str] = set()
_lock = threading.Lock()


def warn_once(message: str, category=RuntimeWarning) -> bool:
    """Emit ``message`` at most once per process. Returns True if emitted."""
    with _lock:
        if message in _seen:
            return False
        _seen.add(message)
    warnings.warn(message, category, stacklevel=2)
    return True


def reset_warnings() -> None:
    """Test hook: forget everything warned so far."""
    with _lock:
        _seen.clear()
