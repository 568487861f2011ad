"""The life cycle of ``utils/cuda_graph.py::ReplayLoop``, the one the
training, evaluation and serving runners share, on the CPU: ``capture`` is
replaced by a fake graph that counts its replays (and the capture stream
and ``run_on`` by stand-ins), so the decision of which step runs eagerly,
which is captured and which replays is checked here, not only on the card.

* For warm-ups of 1 and 3 steps and calls of fewer, as many and more rows
  than the warm-up, over one and two runs: the first ``warmup`` rows the
  object ever gets run eagerly, one capture follows on the slot with the
  registered generators, every later row is copied into the slot and
  replayed, and ``warm``, ``replays``, ``pool_bytes`` and the returned
  output say so.
* ``order`` picks the rows, in its order.
* A row that is the slot itself (a serving call's) is not copied.
* Uncaptured, the same object runs every row eagerly and captures nothing.
"""

import pytest

torch = pytest.importorskip("torch")

from gru4rec_tpu_torch.utils import cuda_graph  # noqa: E402

WIDTH = 3


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def captures(monkeypatch):
    """The (graph, generators, slot) of every capture."""
    made = []

    def capture(fn, stream, generators=()):
        assert stream == "capture stream"
        graph = FakeGraph()
        made.append((graph, tuple(generators), fn))
        return graph, 4096, "captured out"

    monkeypatch.setattr(cuda_graph, "capture", capture)
    monkeypatch.setattr(cuda_graph, "capture_stream", lambda device: "capture stream")
    monkeypatch.setattr(cuda_graph, "run_on", lambda stream, fn: fn())
    return made


def recording_loop(warmup, capturable=True, generators=()):
    """A loop whose step records the first value of each row it runs on,
    and the run's tag."""
    seen = []

    def fn(row, tag):
        seen.append((int(row[0]), tag))
        return "eager out"

    loop = cuda_graph.ReplayLoop(warmup, fn).place(
        torch.zeros(WIDTH, dtype=torch.int32), capturable, generators)
    return loop, seen


def rows_of(run, n):
    """``n`` rows whose first values are ``100 * run + i``."""
    return (torch.arange(n, dtype=torch.int32)[:, None] * torch.ones(WIDTH, dtype=torch.int32)
            + 100 * run)


@pytest.mark.parametrize("runs", [1, 2])
@pytest.mark.parametrize("rows_vs_warmup", ["fewer", "equal", "more"])
@pytest.mark.parametrize("warmup", [1, 3])
def test_warmup_then_one_capture_then_replays(captures, warmup, rows_vs_warmup, runs):
    n = warmup + {"fewer": -1, "equal": 0, "more": 2}[rows_vs_warmup]
    gen = torch.Generator()
    loop, seen = recording_loop(warmup, generators=[gen])
    every, outs = [], []
    for run in range(runs):
        rows = rows_of(run, n)
        every += [(int(r[0]), run) for r in rows]
        outs.append(loop.run(rows, run))
    total = len(every)
    warm = min(total, warmup)
    assert loop.warm == warm and loop.replays == total - warm
    assert seen == every[:warm]  # only the warm-up ran the step eagerly
    if total > warmup:
        ((graph, generators, _),) = captures  # one capture per object
        assert generators == (gen,) and loop.graph is graph
        assert graph.replays == loop.replays and loop.pool_bytes == 4096
        assert int(loop.slot[0]) == every[-1][0]  # the last replayed row
        assert outs[-1] == "captured out"
    else:
        assert captures == [] and loop.graph is None and loop.pool_bytes is None
        assert torch.equal(loop.slot, torch.zeros(WIDTH, dtype=torch.int32))
        assert outs[-1] == (None if n == 0 else "eager out")


def test_order_picks_the_rows(captures):
    loop, seen = recording_loop(2)
    rows = rows_of(0, 6)
    loop.run(rows, "a", order=[5, 1, 3])
    assert seen == [(5, "a"), (1, "a")] and loop.replays == 1 and int(loop.slot[0]) == 3
    loop.run(rows, "b", order=[])
    loop.run(rows, "c", order=[0, 4])
    assert loop.replays == 3 and int(loop.slot[0]) == 4 and len(captures) == 1


def test_the_slot_as_its_own_row_is_not_copied(captures, monkeypatch):
    loop, seen = recording_loop(1)
    loop.slot.fill_(7)
    for _ in range(3):
        loop.run([loop.slot], "call")
    assert seen == [(7, "call")] and loop.warm == 1 and loop.replays == 2
    copies = []
    monkeypatch.setattr(loop, "slot", type("Slot", (), {"copy_": copies.append})())
    loop.run([loop.slot], "call")
    loop.run(["row"], "call")
    assert copies == ["row"] and loop.replays == 4


def test_uncaptured_runs_every_row_eagerly(captures):
    loop, seen = recording_loop(3, capturable=False)
    for run in range(2):
        assert loop.run(rows_of(run, 4), run) == "eager out"
    assert seen == [(100 * run + i, run) for run in range(2) for i in range(4)]
    assert loop.stream is None and loop.graph is None and captures == []
    assert loop.warm == 0 and loop.replays == 0
    assert torch.equal(loop.slot, torch.zeros(WIDTH, dtype=torch.int32))
