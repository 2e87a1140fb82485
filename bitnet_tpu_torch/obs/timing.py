"""Device time of one step of a chain of kernel launches.

Counterpart of ``bitnet_tpu/obs/timing.py``'s ``chain_timer``, with its
function and not its form: the JAX recipe puts N steps in one jitted loop,
varies the inputs of every call and differences the minimum times of two
loop lengths, against three traps of a TPU reached over a relay (a
blocking call that returns at submission, memoized results, round-trip
noise).  On the card the same estimate comes from CUDA graphs:

- the chain of ``n_hi`` steps and the chain of ``n_lo`` steps are each
  captured once in a CUDA graph, so no host launch cost is in the number;
- each replay runs between two CUDA events, after ``make_carry`` has put
  fresh inputs into the graph's input buffers (outside the events);
- seconds a step = (min over replays of the ``n_hi`` time − min of the
  ``n_lo`` time) / (n_hi − n_lo), which cancels the fixed cost of a replay
  as the JAX estimator cancels the relay's.

The caller keeps the working set of one chain above the card's 50 MB L2
(the weights or caches a step reads cycle with the step index ``i``), or
the time is that of a cache-resident kernel, the H100's form of the JAX
docstring's "fantasy bandwidth" trap.  On the CPU (the plain versions;
tests only) the same estimate comes from the host clock around eager
chains.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _tensors(carry) -> list[torch.Tensor]:
    return list(carry) if isinstance(carry, (tuple, list)) else [carry]


def chain_timer(step_fn: Callable,      # (carry, i) -> carry
                make_carry: Callable,   # (salt: int) -> fresh carry
                n_hi: int, n_lo: int, pairs: int = 3) -> float:
    """Seconds of device time per ``step_fn`` application.  ``make_carry``
    returns a tensor or a tuple of tensors on one device (the card's, or
    the CPU); ``step_fn(carry, i)`` launches step ``i`` of a chain and
    returns the next carry."""
    if n_hi <= n_lo:
        raise ValueError(f"n_hi {n_hi} must exceed n_lo {n_lo}")
    static = make_carry(10_001)
    dev = _tensors(static)[0].device
    if dev.type == "cpu":
        return _host_chain(step_fn, make_carry, n_hi, n_lo, max(pairs, 3))

    def capture(n: int) -> torch.cuda.CUDAGraph:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):          # warm-up: lazy init, pools
            c = static
            for i in range(min(n, 3)):
                c = step_fn(c, i)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            c = static
            for i in range(n):
                c = step_fn(c, i)
        return graph

    graphs = {n_lo: capture(n_lo), n_hi: capture(n_hi)}

    def replay_ms(n: int, salt: int) -> float:
        for dst, src in zip(_tensors(static), _tensors(make_carry(salt))):
            dst.copy_(src)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a.record()
        graphs[n].replay()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b)

    def measure(hi: int, salt: int) -> float:
        replay_ms(hi, salt - 1)                  # a first replay uploads the graph
        replay_ms(n_lo, salt - 2)
        his = [replay_ms(hi, salt + 2 * p) for p in range(max(pairs, 3))]
        los = [replay_ms(n_lo, salt + 2 * p + 1) for p in range(max(pairs, 3))]
        return (min(his) - min(los)) / (hi - n_lo) / 1e3

    est = measure(n_hi, 0)
    if est <= 0:
        # the difference drowned in the spread: once more with a 4x longer
        # high chain (the signal grows, the fixed cost of a replay does not)
        graphs[4 * n_hi] = capture(4 * n_hi)
        est = measure(4 * n_hi, 100)
    return est


def _host_chain(step_fn, make_carry, n_hi, n_lo, pairs) -> float:
    def run(n: int, salt: int) -> float:
        c = make_carry(salt)
        t0 = time.perf_counter()
        for i in range(n):
            c = step_fn(c, i)
        return time.perf_counter() - t0

    run(n_lo, 10_002)                            # warm-up
    his = [run(n_hi, 2 * p) for p in range(pairs)]
    los = [run(n_lo, 2 * p + 1) for p in range(pairs)]
    est = (min(his) - min(los)) / (n_hi - n_lo)
    return est if est > 0 else min(his) / n_hi
