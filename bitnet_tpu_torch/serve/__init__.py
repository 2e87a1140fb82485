"""Serving: continuous-batching scheduler + HTTP server."""

from .scheduler import ContinuousBatchingScheduler, Request
from .server import BitNetServer, serve

__all__ = [
    "ContinuousBatchingScheduler",
    "Request",
    "BitNetServer",
    "serve",
]
