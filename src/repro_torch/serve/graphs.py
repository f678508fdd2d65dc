"""Serving programs as CUDA graphs: the port's counterpart of ``jax.jit``.

The reference compiles each serving step once per static signature and
dispatches it as one program (``repro.serve.engine``: the lockstep
``_prefill`` and ``_decode``, the continuous engine's five programs).  A
``Program`` does the same for a body of eager PyTorch:

  * Its signature is what ``jit`` retraces on: each operand's shape, dtype
    and device, or its absence (``None``), never an operand's value.  So
    every operand is a tensor or ``None``: the dynamic scalars (slot, plen,
    pfx, off) are int32 device tensors, and a Python int in their place
    raises ``TypeError``.
  * ``cache_size`` is the number of distinct signatures seen: the
    program's compile count, the reference's ``_cache_size()``.
  * On the CPU, or built with ``graphs=False``, every call runs the body.
  * On the card a signature's first call runs the body (the warm-up, whose
    results are used: lazy state such as kernel libraries, kernel
    attributes and per-device constants is made there, outside any
    capture).  Its second call captures the body into a
    ``torch.cuda.CUDAGraph`` over static copies of the operands and
    replays it; capture runs nothing, so state advances once per call.
    Later calls copy their operands into the static buffers and replay.
  * A replay's outputs are the graph's static buffers, which the next
    replay overwrites: a caller that keeps an output clones it.
  * The body reads and writes the state it closes over (an engine's KV
    carry) at the addresses it had at capture: that state is allocated
    once and reset in place, never rebound.
  * Each graph gets its own memory pool (``torch.cuda.graph``'s default).
  * Launch counts: the launches recorded at capture are taken back and
    kept as the graph's delta, which each replay adds (``counted``,
    ``kernels.counters.add``).

There is no fallback: a capture or replay that fails raises.
"""
from __future__ import annotations

import inspect
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import counters


def signature(name: str, args) -> Tuple:
    """The static signature of a call: (shape, dtype, device) of each
    tensor operand, None for an absent one.  Anything else raises
    ``TypeError``: a host value would be baked into a recorded graph."""
    sig = []
    for i, a in enumerate(args):
        if a is None:
            sig.append(None)
        elif isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), a.dtype, a.device))
        else:
            raise TypeError(
                f"program {name!r}: operand {i} is a {type(a).__name__}; "
                f"pass a device tensor (an int32 scalar for slot, plen, "
                f"pfx or off) or None")
    return tuple(sig)


def counted(fn: Callable):
    """Run ``fn`` (a graph capture) and take back the launch counts it
    bumped: returns (fn's result, {kernel: launches recorded}) with every
    count as it was before the call.  A replay adds the delta back."""
    before = counters.snapshot()
    try:
        out = fn()
    finally:
        after = counters.snapshot()
        counters.reset()
        counters.add(before)
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


class _Graph:
    """One captured signature: the graph, its static operand and output
    buffers, and the launches one replay makes."""

    def __init__(self, graph, inputs: List, outputs, delta: Dict[str, int]):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.delta = delta

    def replay(self, args):
        for dst, a in zip(self.inputs, args):
            if a is not None and a is not dst:
                dst.copy_(a)
        self.graph.replay()
        counters.add(self.delta)
        return self.outputs


class Program:
    """One serving program: ``body(*operands)`` run eagerly, or (``graphs``,
    on the card) as one CUDA graph per signature after an eager first
    call.  See the module docstring."""

    def __init__(self, name: str, body: Callable, graphs: bool):
        self.name, self.graphs = name, graphs
        # an engine's method is held weakly: the engine holds its programs,
        # and a cycle would keep its weights and graph pools on the card
        # after the last reference to it is gone, until a gc pass
        self._body = (weakref.WeakMethod(body) if inspect.ismethod(body)
                      else lambda: body)
        self._sigs: Dict[Tuple, Optional[_Graph]] = {}
        self.capture_s: List[float] = []   # seconds of each capture
        self.calls = 0                     # calls, eager or replayed

    @property
    def cache_size(self) -> int:
        """Distinct signatures seen: the program's compile count."""
        return len(self._sigs)

    @property
    def captures(self) -> int:
        return len(self.capture_s)

    @torch.no_grad()
    def __call__(self, *args):
        self.calls += 1
        sig = signature(self.name, args)
        if sig not in self._sigs:          # a new signature: the warm-up
            self._sigs[sig] = None
            return self._body()(*args)
        if not self.graphs:
            return self._body()(*args)
        g = self._sigs[sig]
        if g is None:
            g = self._sigs[sig] = self._capture(args)
        return g.replay(args)

    def _capture(self, args) -> _Graph:
        t0 = time.perf_counter()
        inputs = [None if a is None else a.clone() for a in args]
        graph, body = torch.cuda.CUDAGraph(), self._body()

        def capture():
            with torch.cuda.graph(graph):
                return body(*inputs)

        outputs, delta = counted(capture)
        self.capture_s.append(time.perf_counter() - t0)
        return _Graph(graph, inputs, outputs, delta)
