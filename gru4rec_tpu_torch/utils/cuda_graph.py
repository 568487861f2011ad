"""What the port's captured CUDA graphs share.

The JAX package compiles its training chunk, its evaluation chunk and its
two serving steps into device programs. On a CUDA device the port captures
each as a CUDA graph (``train/step.py::_StepGraph``,
``eval/evaluation.py::_EvalGraph``, ``models/gru4rec.py::_ServeGraph``) and
keeps the eager code as the graph's plain version. They share:

* one side stream per device for every warm-up and capture
  (:func:`capture_stream`);
* :func:`run_on`, a call on that stream ordered between the current
  stream's work before and after it;
* :func:`capture`, which captures a call with the garbage collector off
  and measures the bytes the graph's private pool reserved;
* :func:`binding`, the (pointer, shape, dtype) of every tensor a graph
  reads or writes outside its pool: a graph replays only for the binding
  it was captured on.

A captured call must not wait on the host: no boolean-mask index,
``nonzero`` or ``.item()`` inside it, and no ``dist.barrier``. A mesh step
on NCCL captures its collectives too (``parallel/mesh.py``): their
communicators exist before the capture, since ``Mesh`` sets up each group
with a barrier and the eager warm-up steps run every collective once.
"""

from __future__ import annotations

import gc
from typing import Dict

import torch

# Eager steps on the capture stream before a step is captured (PyTorch sets
# up cuBLAS workspaces and autograd's streams on first use); they are real
# steps, never throwaway ones.
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


def capture(fn, stream: torch.cuda.Stream, generators=()):
    """Capture ``fn()`` on ``stream`` (capture runs nothing): ``(graph,
    pool_bytes, fn's result)``. ``generators`` are registered with the
    graph, so that every replay draws what the eager call would draw next.
    A graph destroyed while another is being captured invalidates that
    capture (a graph that is cyclic garbage dies when the collector runs),
    so the collector is off until the capture ends. A failed capture
    raises."""
    dev = stream.device
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return graph, torch.cuda.memory_reserved(dev) - reserved, out


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
    """(data_ptr, shape, dtype) of every tensor of ``trees``: two equal
    bindings put the same tensors at the same addresses, so a graph
    captured on one replays correctly on the other."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in leaves(*trees))
