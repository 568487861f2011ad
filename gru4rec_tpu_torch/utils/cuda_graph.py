"""What the port's captured CUDA graphs share.

The JAX package compiles its training chunk, its evaluation chunk and its
two serving steps into device programs. On a CUDA device the port captures
one step of each as a CUDA graph and replays it per step: the three runners
(``train/step.py::_StepRunner``, ``eval/evaluation.py::_EvalGraph`` and the
serving calls of ``models/gru4rec.py``) are :class:`ReplayLoop` objects,
and the same objects, uncaptured, are the graphs' plain versions. They
share:

* one side stream per device for every warm-up and capture
  (:func:`capture_stream`);
* :func:`run_on`, a call on that stream ordered between the current
  stream's work before and after it;
* :func:`capture`, which captures a call with the garbage collector off
  and measures the bytes the graph's private pool reserved, and returns a
  :class:`CountedGraph`, whose replays keep the launch counters true (the
  span ``gru4rec.graph.capture``);
* :class:`ReplayLoop`, the life cycle of one captured step: eager warm-up
  steps, one capture, then a copy into the input slot and a replay per
  step;
* :func:`binding`, the (pointer, shape, dtype) of every tensor a graph
  reads or writes outside its pool, and the generators it draws from: a
  graph replays only for the binding it was captured on.

A captured call must not wait on the host: no boolean-mask index,
``nonzero`` or ``.item()`` inside it, and no ``dist.barrier``. A mesh step
on NCCL captures its collectives too (``parallel/mesh.py``): their
communicators exist before the capture, since ``Mesh`` sets up each group
with a barrier and the eager warm-up steps run every collective once.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict

import torch

from gru4rec_tpu_torch.utils.profiling import span

# Eager steps on the capture stream before a training or evaluation step is
# captured (PyTorch sets up cuBLAS workspaces and autograd's streams on first
# use); they are real steps, never throwaway ones.
WARMUP_STEPS = 3

# The side stream of every warm-up and capture on a device. cuBLAS keeps a
# workspace for each stream it runs on for the life of the process (64 MiB
# on the card), so a stream of its own per graph would hold one more
# workspace for every graph ever made.
_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = torch.device("cuda", index)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(key)
    return _CAPTURE_STREAMS[key]


def run_on(stream: torch.cuda.Stream, fn):
    """``fn()`` on ``stream``, after the current stream's queued work and
    before its later work."""
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        out = fn()
    main.wait_stream(stream)
    return out


def launch_counters() -> Dict[str, Dict[str, int]]:
    """The launch counters of the port's device routes, by module: each
    wrapper adds one where it issues its kernel (``launches_by_mode``)."""
    from gru4rec_tpu_torch.ops import mixed_mm
    from gru4rec_tpu_torch.ops.kernels import score_rank, sparse_update

    return {"sparse_update": sparse_update.launches_by_mode,
            "mixed_mm": mixed_mm.launches_by_mode,
            "score_rank": score_rank.launches_by_mode}


class CountedGraph:
    """A captured graph and ``tally``, the launches its capture recorded
    ({counter: {mode: n}}, :func:`launch_counters`). The capture ran none
    of them and a replay runs them without calling the wrappers, so
    :func:`capture` takes the tally back from the counters and every
    :meth:`replay` adds it again: the counters count device runs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, tally):
        self.graph = graph
        self.tally = tally
        # the counter dicts, bound once: a replay adds its tally to them
        counters = launch_counters()
        self._adds = [(counters[name], mode, n)
                      for name, modes in tally.items() for mode, n in modes.items()]

    def replay(self) -> None:
        self.graph.replay()
        for counter, mode, n in self._adds:
            counter[mode] += n


def capture(fn, stream: torch.cuda.Stream, generators=()):
    """Capture ``fn()`` on ``stream`` (capture runs nothing): ``(graph,
    pool_bytes, fn's result)``, the graph a :class:`CountedGraph`.
    ``generators`` are registered with the graph, so that every replay
    draws what the eager call would draw next. A graph destroyed while
    another is being captured invalidates that capture (a graph that is
    cyclic garbage dies when the collector runs), so the collector is off
    until the capture ends. A failed capture raises. The whole of it is the
    span ``gru4rec.graph.capture``, which every graph of the port shares;
    its parent span tells the graph's kind."""
    with span("gru4rec.graph.capture"):
        dev = stream.device
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        counters = launch_counters()
        before = {name: dict(c) for name, c in counters.items()}
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        tally = {}
        for name, c in counters.items():
            recorded = {m: n - before[name][m] for m, n in c.items() if n != before[name][m]}
            for m, n in recorded.items():
                c[m] -= n
            if recorded:
                tally[name] = recorded
        return CountedGraph(graph, tally), torch.cuda.memory_reserved(dev) - reserved, out


def leaves(*trees):
    """The tensors of dict / list / tuple trees, in order."""
    out = []

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        else:
            out.append(tree)

    for tree in trees:
        walk(tree)
    return out


def binding(*trees):
    """(data_ptr, shape, dtype) of every tensor of ``trees``, and every
    ``torch.Generator`` among them as itself (compared by identity): two
    equal bindings put the same tensors at the same addresses and draw from
    the same generators, so a graph captured on one replays correctly on
    the other."""
    return tuple(t if isinstance(t, torch.Generator) else
                 (t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves(*trees))


def _span(name):
    return span(name) if name else contextlib.nullcontext()


class ReplayLoop:
    """One step run over the rows of a call, eagerly or as one captured CUDA
    graph replayed per row.

    ``fn(row, *args)`` is the step; a subclass may define it as a method
    instead (a step stored on its own loop would make a reference cycle,
    which keeps a dropped graph's pool until the collector runs).
    :meth:`place` gives the loop its input slot, shaped as one row, and says
    whether it captures. Where it does, the first ``warmup`` steps the
    object ever runs go eagerly on the capture stream (the span
    ``warmup_span``), the next is captured on the slot with ``generators``
    registered (every replay draws what the eager step would draw next),
    and every step from then on copies its row into the slot and replays
    (the span ``replay_span``). Where it does not (the CPU, a gloo mesh,
    ``_eager``), every step runs eagerly on the current stream, in no span.

    ``graph`` (a :class:`CountedGraph`), ``pool_bytes`` and ``out`` (the
    captured step's result, in the graph's pool: the next replay overwrites
    it) are None until the capture; ``warm`` counts the eager steps before
    it, ``replays`` the replayed ones. ``bound`` is the :func:`binding` the
    caller recorded for the graph; what a mismatch means is the caller's to
    decide."""

    def __init__(self, warmup: int, fn=None, warmup_span=None, replay_span=None):
        if fn is not None:
            self.fn = fn
        self.warmup = warmup
        self.spans = (warmup_span, replay_span)
        self.slot = self.stream = None
        self.generators = ()
        self.graph = self.pool_bytes = self.out = self.bound = None
        self.warm = 0
        self.replays = 0

    def place(self, slot: torch.Tensor, capturable: bool, generators=()) -> "ReplayLoop":
        self.slot = slot
        self.stream = capture_stream(slot.device) if capturable else None
        self.generators = tuple(generators)
        return self

    def run(self, rows, *args, order=None):
        """``fn(rows[t], *args)`` for ``t`` in ``order`` (every row by
        default); a row that is the slot itself is not copied. Returns the
        last eager step's result, or ``out`` once the step is captured."""
        steps = range(len(rows)) if order is None else order
        if self.stream is None:
            out = None
            for t in steps:
                out = self.fn(rows[t], *args)
            return out
        i, n, out = 0, len(steps), self.out
        if self.graph is None and self.warm < self.warmup and n:
            with _span(self.spans[0]):
                while self.warm < self.warmup and i < n:
                    row = rows[steps[i]]
                    out = run_on(self.stream, lambda: self.fn(row, *args))
                    self.warm += 1
                    i += 1
        if i == n:
            return out
        if self.graph is None:
            self.graph, self.pool_bytes, self.out = capture(
                lambda: self.fn(self.slot, *args), self.stream, self.generators)
        slot, graph = self.slot, self.graph
        with _span(self.spans[1]):
            for t in steps[i:]:
                row = rows[t]
                if row is not slot:
                    slot.copy_(row)
                graph.replay()
        self.replays += n - i
        return self.out
