"""Serving: the continuous-batching scheduler (``serve/scheduler.py``).

The JAX package's HTTP server, model manager and ``bitnet serve`` stand on
the scheduler and are not ported yet (ROADMAP.md queue 1 #12 (c)).
"""
