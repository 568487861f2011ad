"""The (data, model) mesh of ranks and the layout of the state over it.

PyTorch counterpart of ``gru4rec_tpu/parallel/mesh.py``, over
``torch.distributed``:

* ``data`` axis: the session-parallel lanes are split into blocks, one per
  data rank; the gradients of the replicated dense parameters are summed
  over it;
* ``model`` axis: the item tables (``Wy``, ``E``, the one-hot ``Wx[0]``)
  and their row-sparse optimizer state are row-sharded over it; a row
  gather is a shard-local take (rows of other shards read as 0) summed
  over the axis, a row update is applied shard-locally with the rows of
  other shards dropped.

**One process per device.** JAX runs one process per host, and that process
drives every device of the host; here every rank is one process with one
device. So ``init_distributed``'s ``num_processes`` counts ranks, not hosts,
and a mesh of n ranks needs n processes, started by a launcher such as
``python -m torch.distributed.run --nproc_per_node n`` (``torchrun``),
which sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. A one-rank mesh
also runs in a process started without one.

Rank ``r`` sits at ``(r // n_model, r % n_model)``, the layout of JAX's
``reshape(n_data, n_model)``. The mesh holds one process group per row (the
ranks of one data index: the ``model`` axis) and one per column (the
``data`` axis). A mesh on CUDA devices takes the ``nccl`` backend and the
rank's card ``cuda:<LOCAL_RANK>``, one on ``device="cpu"`` takes ``gloo``;
a ``backend`` named by the caller is taken as it is, and nothing falls back
to another backend or device. Every group has a timeout
(:data:`DEFAULT_TIMEOUT`), so a missing or stalled peer fails a collective
instead of hanging it.

**Captured steps.** On an NCCL mesh (:attr:`Mesh.capturable`) the training
step, the evaluation step and the top-k serving call are captured as CUDA
graphs, collectives included, as on one device (``utils/cuda_graph.py``).
A gloo mesh runs them eagerly, on the CPU and on a card alike: gloo's
collectives run on host threads, which a CUDA graph cannot record. That is
by design, not a fallback: nothing else decides between the two.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)
AXES = ("data", "model")
# The single-buffer all-gather; newer PyTorch names it all_gather_single and
# deprecates all_gather_into_tensor, older ones have only the latter.
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend: str = "gloo", timeout=DEFAULT_TIMEOUT) -> None:
    """Initialize the default process group; a no-op if it already is.

    ``coordinator_address`` ("host:port") rendezvouses over ``tcp://`` with
    ``num_processes`` ranks, this one ``process_id``; without it the
    launcher's environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) is read, and a process that has neither runs
    alone, a group of one rank over an in-memory store. ``timeout`` bounds
    the rendezvous and every collective of the group."""
    if dist.is_initialized():
        return  # repeat calls are no-ops (fit() + evaluate() in one run)
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif "RANK" in os.environ or (num_processes or 1) > 1:
        dist.init_process_group(backend, init_method="env://",
                                world_size=-1 if num_processes is None else num_processes,
                                rank=-1 if process_id is None else process_id,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=timeout)


def world_size() -> int:
    """Ranks of the default group, or of the launch before it is set up."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh_device(device) -> torch.device:
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on CUDA devices needs a card, and "
                               "torch.cuda.is_available() is False; pass "
                               "device='cpu' for a gloo mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)  # "cuda" now means this rank's card
    return device


class Mesh:
    """A ``(n_data, n_model)`` grid over the ranks of the default process
    group (:func:`make_mesh` builds it). ``di`` / ``mi`` are this rank's
    indices, ``device`` its device; the collectives below run over one axis
    of the grid, on tensors on ``device``."""

    def __init__(self, n_data: int, n_model: int, device: torch.device,
                 timeout=DEFAULT_TIMEOUT):
        self.shape = {"data": n_data, "model": n_model}
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        # every rank takes part in creating every group, in one order
        rows = [dist.new_group([d * n_model + m for m in range(n_model)], timeout=timeout)
                for d in range(n_data)]
        cols = [dist.new_group([d * n_model + m for d in range(n_data)], timeout=timeout)
                for m in range(n_model)]
        if self.rank >= n_data * n_model:
            raise ValueError(f"rank {self.rank} lies outside the {n_data}x{n_model} mesh; "
                             f"start {n_data * n_model} processes")
        self.di, self.mi = divmod(self.rank, n_model)
        self._groups = {"model": rows[self.di], "data": cols[self.mi]}
        self._ranks = {"model": [self.di * n_model + m for m in range(n_model)],
                       "data": [d * n_model + self.mi for d in range(n_data)]}
        # a first collective on each group sets up its communicator here, not
        # in the first training step, and fails here when a peer is missing
        ids = {"device_ids": [device.index]} if self.backend == "nccl" else {}
        for group in self._groups.values():
            dist.barrier(group=group, **ids)

    @property
    def capturable(self) -> bool:
        """Whether the mesh's steps can be captured as CUDA graphs: NCCL on a
        CUDA device (module doc)."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def index(self, axis: str) -> int:
        return self.di if axis == "data" else self.mi

    def ranks(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        return list(self._ranks[axis])

    def all_reduce(self, t: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over ``axis``; returns it."""
        dist.all_reduce(t, op=op, group=self._groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The equal-shaped blocks ``t`` of the ranks along ``axis``,
        concatenated along dim 0 in axis order: one collective into one
        output buffer, which both backends take and a graph can capture."""
        t = t.contiguous()
        out = t.new_empty((len(self._ranks[axis]) * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather_single(out, t, group=self._groups[axis])
        return out

    def fetch_to_host(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Like :meth:`all_gather`, as a CPU tensor on every rank; the
        blocks cross one at a time (a broadcast into one block's buffer), so
        no device ever holds more than its own block and one other."""
        t = t.contiguous()
        blocks = []
        for j, src in enumerate(self._ranks[axis]):
            buf = t if j == self.index(axis) else torch.empty_like(t)
            dist.broadcast(buf, src=src, group=self._groups[axis])
            blocks.append(buf.to("cpu", copy=True))
        return torch.cat(blocks)

    def lanes(self, batch: int) -> Tuple[int, int]:
        """``(lo, n)``: this rank's block of ``batch`` lanes is
        ``[lo, lo + n)``; ``batch`` must divide over the data axis."""
        nd = self.shape["data"]
        if batch % nd:
            raise ValueError(f"batch_size {batch} must divide over data axis {nd}")
        n = batch // nd
        return self.di * n, n


def make_mesh(n_data: int, n_model: int, device=None, backend=None,
              timeout=DEFAULT_TIMEOUT) -> Mesh:
    """The ``(n_data, n_model)`` mesh over ranks ``0 .. n_data*n_model - 1``
    of the default group, initializing the group (:func:`init_distributed`)
    if needed. ``device`` defaults to ``cuda:<LOCAL_RANK>`` and ``backend``
    to ``nccl`` there, ``gloo`` on the CPU. Raises, as JAX does, when the
    world has fewer ranks than the mesh, and when the group was initialized
    with another backend."""
    n = n_data * n_model
    if n > world_size():
        raise ValueError(f"mesh {n_data}x{n_model} needs {n} ranks, have {world_size()}")
    device = _mesh_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    init_distributed(backend=backend, timeout=timeout)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {backend!r}")
    return Mesh(n_data, n_model, device, timeout)


def factor_mesh(n_devices: int) -> Tuple[int, int]:
    """Pick a (data, model) split for n devices: prefer a 2-D mesh so both
    lane parallelism and table sharding are exercised — the model axis is
    capped at 4 and the data axis kept >= 2 whenever the device count
    allows (a 1 x N mesh has zero lane parallelism)."""
    for n_model in (4, 2, 1):
        if n_devices % n_model == 0 and n_devices // n_model >= 2:
            return n_devices // n_model, n_model
    for n_model in (4, 2, 1):
        if n_devices % n_model == 0:
            return n_devices // n_model, n_model
    return n_devices, 1


def local_block(x: torch.Tensor, n_blocks: int, index: int, device) -> torch.Tensor:
    """Block ``index`` of ``x`` cut into ``n_blocks`` equal blocks along
    dim 0, as a new tensor on ``device``: every rank passes the same whole
    host tensor and keeps its own block (JAX's ``put_global``)."""
    n = x.shape[0]
    if n % n_blocks:
        raise ValueError(f"{n} rows must divide into {n_blocks} blocks; adjust "
                         f"item_pad_multiple or the mesh shape")
    rows = n // n_blocks
    return x[index * rows:(index + 1) * rows].to(device, copy=True)


def param_specs(params: Dict, mode: str) -> Dict:
    """Which parameter leaves are row-sharded over ``"model"`` (the item
    tables) and which are replicated (``None``): JAX's ``param_pspecs``,
    one entry per leaf."""
    specs = {
        "Wx": ["model" if (i == 0 and mode == "onehot") else None
               for i in range(len(params["Wx"]))],
        "Wh": [None] * len(params["Wh"]),
        "Wrz": [None] * len(params["Wrz"]),
        "Bh": [None] * len(params["Bh"]),
        "Wy": "model",
    }
    if "E" in params:
        specs["E"] = "model"
    return specs


def state_specs(opt_state: Dict) -> Dict:
    """The same for optimizer state (JAX's ``state_pspecs``): every slot of
    a sparse table's state is row-sharded, every dense slot replicated."""
    return {
        "dense": {k: [{s: None for s in st} for st in v]
                  for k, v in opt_state["dense"].items()},
        "sparse": {name: {s: "model" for s in st}
                   for name, st in opt_state["sparse"].items()},
    }
