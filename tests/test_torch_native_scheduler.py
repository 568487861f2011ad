"""The port's native schedule builder (``data/_native_scheduler.py``) on the
CPU, against the numpy builders of both packages.

* native against numpy over the JAX package's grid
  (``tests/test_native_scheduler.py``), both equal to
  ``gru4rec_tpu.data.scheduler._build_schedule_numpy`` bit for bit;
* the ``ValueError`` on offsets or an order that the C++ builder rejects;
* ``GRU4REC_TPU_NO_NATIVE`` and a missing ``g++`` take the numpy path, a
  source that does not compile raises with the compiler's output;
* ``csrc/scheduler.cpp`` of the port is a copy of the JAX package's;
* the package data of ``pyproject.toml`` covers every file of the port's
  ``csrc/`` and every file of ``examples/`` outside its packages' modules
  (the paramfile copies);
* a ``fit`` gives the same losses with and without the native builder.
"""

import filecmp
import fnmatch
import glob
import os
import shutil
import tomllib

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gru4rec_tpu.data.scheduler import _build_schedule_numpy as jax_numpy  # noqa: E402
from gru4rec_tpu_torch.data import _native_scheduler, scheduler  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("in_idx", "out_idx", "valid", "reset")


def sessions(seed):
    rng = np.random.RandomState(seed)
    n_sessions = rng.randint(3, 120)
    lens = rng.randint(1, 10, size=n_sessions)
    offsets = np.zeros(n_sessions + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)
    items = rng.randint(0, 500, size=int(offsets[-1])).astype(np.int32)
    return items, offsets, rng.permutation(n_sessions)


def assert_same(a, b):
    assert a.n_steps == b.n_steps
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("batch_size", [1, 4, 32])
@pytest.mark.parametrize("require_two_lanes", [False, True])
def test_native_matches_numpy(seed, batch_size, require_two_lanes):
    items, offsets, order = sessions(seed)
    assert _native_scheduler.available()
    before = _native_scheduler.calls
    a = scheduler.build_schedule(items, offsets, order, batch_size, require_two_lanes)
    assert _native_scheduler.calls == before + 1
    assert_same(a, scheduler._build_schedule_numpy(items, offsets, order, batch_size,
                                                   require_two_lanes))
    assert_same(a, jax_numpy(items, offsets, order, batch_size, require_two_lanes))


@pytest.mark.parametrize("case", ["non_monotonic", "order_out_of_range", "past_the_end"])
def test_native_rejects_bad_arguments(case):
    items, offsets, order = sessions(0)
    if case == "non_monotonic":
        offsets[2], offsets[3] = offsets[3], offsets[2] - 1
    elif case == "order_out_of_range":
        order[0] = len(order)
    else:
        offsets[-1] = len(items) + 1
    with pytest.raises(ValueError, match="native scheduler rejected"):
        scheduler.build_schedule(items, offsets, order, 4)


def test_no_native_switch_takes_the_numpy_path(monkeypatch):
    items, offsets, order = sessions(1)
    native = scheduler.build_schedule(items, offsets, order, 4)
    monkeypatch.setenv("GRU4REC_TPU_NO_NATIVE", "1")
    before = _native_scheduler.calls
    assert not _native_scheduler.available()
    assert_same(scheduler.build_schedule(items, offsets, order, 4), native)
    assert_same(_native_scheduler.build_schedule(items, offsets, order, 4, False), native)
    assert _native_scheduler.calls == before


def test_missing_compiler_falls_back(monkeypatch):
    items, offsets, order = sessions(2)
    native = scheduler.build_schedule(items, offsets, order, 4)
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    before = _native_scheduler.calls
    assert not _native_scheduler.available()
    assert_same(scheduler.build_schedule(items, offsets, order, 4), native)
    assert _native_scheduler.calls == before


def test_broken_source_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "scheduler.cpp").write_text("int g4r_build_schedule( {\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path / "src"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(_native_scheduler, "_fn", None)
    items, offsets, order = sessions(3)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on .*scheduler\.cpp:\n.*error"):
        scheduler.build_schedule(items, offsets, order, 4)
    assert not os.listdir(tmp_path / "build")


def test_build_key_of_the_host_source(tmp_path, monkeypatch):
    """The library of ``scheduler.cpp`` is keyed on that source and g++'s
    flags, not on the CUDA headers."""
    for f in os.listdir(build.CSRC_DIR):
        (tmp_path / f).write_bytes(open(os.path.join(build.CSRC_DIR, f), "rb").read())
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build._lib_path("scheduler")
    assert os.path.basename(before).startswith("scheduler-")
    with open(tmp_path / "dedup.cuh", "a") as f:
        f.write("// changed\n")
    assert build._lib_path("scheduler") == before
    with open(tmp_path / "scheduler.cpp", "a") as f:
        f.write("// changed\n")
    assert build._lib_path("scheduler") != before
    assert build._command("scheduler", "x.so")[1:len(build.GXX_FLAGS) + 1] == \
        list(build.GXX_FLAGS)


def test_scheduler_source_is_a_copy_of_the_jax_packages():
    assert filecmp.cmp(os.path.join(REPO, "gru4rec_tpu_torch", "csrc", "scheduler.cpp"),
                       os.path.join(REPO, "csrc", "scheduler.cpp"), shallow=False)


def test_package_data_covers_every_native_source():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"]["gru4rec_tpu_torch"]
    files = os.listdir(os.path.join(REPO, "gru4rec_tpu_torch", "csrc"))
    assert {os.path.splitext(f)[1] for f in files} >= {".cu", ".cuh", ".cpp"}
    for f in files:
        assert any(fnmatch.fnmatch("csrc/" + f, g) for g in globs), (f, globs)
    # examples/: modules of its packages (a directory with __init__.py) or
    # files a glob of the package data names, as setuptools globs them
    pkg = os.path.join(REPO, "gru4rec_tpu_torch")
    globbed = {os.path.relpath(p, pkg) for g in globs
               for p in glob.glob(os.path.join(pkg, g))}
    examples = [os.path.relpath(os.path.join(root, f), pkg)
                for root, dirs, fs in os.walk(os.path.join(pkg, "examples"))
                if "__pycache__" not in root for f in fs]
    assert any(f.startswith("examples/paramfiles/") for f in examples)
    for f in examples:
        in_package = f.endswith(".py") and os.path.exists(
            os.path.join(pkg, os.path.dirname(f), "__init__.py"))
        assert in_package or f in globbed, (f, globs)


def markov(n_sessions, n_items=30, seed=0):
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    for s in range(n_sessions):
        i = rng.randint(n_items)
        for _ in range(rng.randint(2, 9)):
            rows.append((s, f"item_{i}", t))
            t += 1
            i = (7 * i + 3) % n_items
    return pd.DataFrame(rows, columns=["SessionId", "ItemId", "Time"])


@pytest.mark.parametrize("random_order", [False, True])
def test_fit_is_the_same_without_the_native_builder(monkeypatch, random_order):
    """The schedule cannot change a result: the losses of a markov ``fit``
    are equal with the native builder and with the switch set."""
    import gru4rec_tpu_torch

    def losses():
        m = gru4rec_tpu_torch.GRU4Rec(
            loss="bpr-max", layers=[16], batch_size=8, n_sample=8, n_epochs=2,
            chunk_size=16, item_pad_multiple=8, train_random_order=random_order,
            device="cpu")
        m.fit(markov(80))
        return [e["loss"] for e in m.epoch_stats]

    before = _native_scheduler.calls
    native = losses()
    assert _native_scheduler.calls - before == (2 if random_order else 1)
    monkeypatch.setenv("GRU4REC_TPU_NO_NATIVE", "1")
    assert losses() == native
    assert _native_scheduler.calls - before == (2 if random_order else 1)
