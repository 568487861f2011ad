"""The port's adagrad prototypes P1 and P2 against the JAX package's.

P1 is ``merged_adagrad`` (``scripts/proto_merged_kernel.py``), adagrad on a
merged ``[t | a]`` buffer; P2 is ``v3_adagrad`` (``scripts/proto_v3_kernel.py``),
adagrad over only the real row groups. Their JAX functions are loaded from
the scripts and run as Pallas kernels in interpret mode on the CPU, fed by
JAX's ``group_pack`` / the script's ``group_pack_v3``; the port's plain
versions (``ops/kernels/proto_adagrad.py``) run on the same numpy inputs
over three steps, with a repeated index and four sentinels, at widths 16,
225 and 13. Tolerance: rtol 1e-6 / atol 1e-7, the scripts' own (the
duplicate sums are added in another order). Rows no index touches stay
bit-identical.

The JAX kernels and JAX's v2 kernel (``fused_adagrad_update``) drop the
update of a row in the last 8-row group, where ``group_pack`` points its
dummy grid steps, so the comparisons with JAX draw indices below
``n_rows - 8``, as the scripts do. The port updates every row: the tests
against ``Optimizer.apply_sparse_plain`` include row ``n_rows - 1``.

The CUDA kernels are held against the plain versions on the card by the
``cuda``-marked test, which needs no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_protos.py
"""

import functools
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from gru4rec_tpu_torch.config import GRU4RecConfig  # noqa: E402
from gru4rec_tpu_torch.ops.kernels import proto_adagrad  # noqa: E402
from gru4rec_tpu_torch.train.optimizers import make_optimizer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SENTINEL = np.iinfo(np.int32).max
LR = 0.05  # the scripts' learning rate
STEPS = 3
CASES = [(64, 16, 24), (72, 225, 40), (72, 13, 32)]  # (n_rows, d, K)
RTOL, ATOL = 1e-6, 1e-7


def _inputs(n_rows, d, K, seed, top):
    """Table, accumulator and STEPS (idx, g) pairs; indices below ``top``,
    with idx[5] = idx[3], the last four the sentinel, and idx[0] the last
    row when ``top`` is ``n_rows``."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n_rows, d).astype(np.float32)
    acc = np.abs(rng.randn(n_rows, d)).astype(np.float32)
    steps = []
    for _ in range(STEPS):
        idx = rng.randint(0, top, K).astype(np.int32)
        if top == n_rows:
            idx[0] = n_rows - 1
        idx[5] = idx[3]
        idx[-4:] = SENTINEL
        steps.append((idx, (rng.randn(K, d) * 0.1).astype(np.float32)))
    return table, acc, steps


def _touched(n_rows, steps):
    touched = np.zeros(n_rows, bool)
    for idx, _ in steps:
        touched[idx[idx < n_rows]] = True
    return touched


@functools.lru_cache(maxsize=None)
def _script(name):
    """``scripts/<name>.py`` as a module (it imports JAX). The JAX package
    is imported from this checkout first, and ``sys.path`` is restored
    after the script's own insertion, so the reference is this tree's."""
    import gru4rec_tpu.ops.kernels.sparse_update  # noqa: F401

    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _jax_merged(table, acc, steps):
    jnp = pytest.importorskip("jax.numpy")
    from gru4rec_tpu.ops.kernels.sparse_update import group_pack

    mod = _script("proto_merged_kernel")
    n_rows, d = table.shape
    m = jnp.asarray(np.concatenate([table, acc], axis=1))
    for idx, g in steps:
        gblk, mask, gpad = group_pack(jnp.asarray(idx.copy()), jnp.asarray(g.copy()), n_rows)
        m = mod.merged_adagrad(m, gblk, mask, gpad, interpret=True)
    m = np.asarray(m)
    return m[:, :d], m[:, d:]


def _jax_v3(table, acc, steps):
    jnp = pytest.importorskip("jax.numpy")

    mod = _script("proto_v3_kernel")
    t, a = jnp.asarray(table.copy()), jnp.asarray(acc.copy())
    for idx, g in steps:
        gblk, mask, nreal, gpad = mod.group_pack_v3(jnp.asarray(idx.copy()),
                                                    jnp.asarray(g.copy()), table.shape[0])
        t, a = mod.v3_adagrad(t, a, gblk, mask, nreal, gpad, interpret=True)
    return np.asarray(t), np.asarray(a)


def _jax_v2(table, acc, steps):
    jnp = pytest.importorskip("jax.numpy")
    from gru4rec_tpu.ops.kernels.sparse_update import fused_adagrad_update, group_pack

    t, a = jnp.asarray(table.copy()), jnp.asarray(acc.copy())
    for idx, g in steps:
        gblk, mask, gpad = group_pack(jnp.asarray(idx.copy()), jnp.asarray(g.copy()),
                                      table.shape[0])
        t, a, _ = fused_adagrad_update(t, a, None, gblk, mask, gpad, lr=LR, momentum=0.0,
                                       lmbd=0.0, interpret=True)
    return np.asarray(t), np.asarray(a)


def _torch_p1(table, acc, steps, device="cpu", fn=proto_adagrad.merged_adagrad_plain):
    d = table.shape[1]
    m = torch.from_numpy(np.concatenate([table, acc], axis=1)).to(device)
    for idx, g in steps:
        fn(m, torch.from_numpy(idx).to(device), torch.from_numpy(g).to(device), LR)
    return m[:, :d].cpu(), m[:, d:].cpu()


def _torch_p2(table, acc, steps, device="cpu", fn=proto_adagrad.v3_adagrad_plain):
    t = torch.from_numpy(table.copy()).to(device)
    a = torch.from_numpy(acc.copy()).to(device)
    for idx, g in steps:
        fn(t, a, torch.from_numpy(idx).to(device), torch.from_numpy(g).to(device), LR)
    return t.cpu(), a.cpu()


TORCH_PLAIN = {"P1": _torch_p1, "P2": _torch_p2}


def _assert_matches(got, want, table, acc, steps):
    """(table, acc) within the scripts' tolerance of ``want``; rows no index
    touched bit-identical to the inputs."""
    for name, g, w in zip(("table", "acc"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)
    untouched = ~_touched(table.shape[0], steps)
    np.testing.assert_array_equal(got[0].numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(got[1].numpy()[untouched], acc[untouched])


@pytest.mark.parametrize("n_rows,d,K", CASES)
def test_merged_plain_matches_jax_merged_adagrad(n_rows, d, K):
    table, acc, steps = _inputs(n_rows, d, K, seed=d, top=n_rows - 8)
    _assert_matches(_torch_p1(table, acc, steps), _jax_merged(table, acc, steps),
                    table, acc, steps)


@pytest.mark.parametrize("n_rows,d,K", CASES)
def test_v3_plain_matches_jax_v3_adagrad(n_rows, d, K):
    table, acc, steps = _inputs(n_rows, d, K, seed=d, top=n_rows - 8)
    _assert_matches(_torch_p2(table, acc, steps), _jax_v3(table, acc, steps),
                    table, acc, steps)


@pytest.mark.parametrize("kernel", ["P1", "P2"])
@pytest.mark.parametrize("n_rows,d,K", CASES)
def test_plain_versions_match_jax_fused_adagrad_update(n_rows, d, K, kernel):
    table, acc, steps = _inputs(n_rows, d, K, seed=d + 1, top=n_rows - 8)
    _assert_matches(TORCH_PLAIN[kernel](table, acc, steps), _jax_v2(table, acc, steps),
                    table, acc, steps)


@pytest.mark.parametrize("n_rows,d,K", CASES)
def test_plain_versions_match_apply_sparse_plain_up_to_the_last_row(n_rows, d, K):
    """Same dedup order and formula: bit-equal, the last row updated."""
    table, acc, steps = _inputs(n_rows, d, K, seed=d + 2, top=n_rows)
    opt = make_optimizer(GRU4RecConfig(adapt="adagrad", momentum=0.0, lmbd=0.0,
                                       learning_rate=LR, opt_state_dtype="float32"))
    t = torch.from_numpy(table.copy())
    st = {"acc": torch.from_numpy(acc.copy())}
    for idx, g in steps:
        opt.apply_sparse_plain(t, torch.from_numpy(idx), torch.from_numpy(g), st)
    for kernel, run in TORCH_PLAIN.items():
        t_k, a_k = run(table, acc, steps)
        assert torch.equal(t_k, t) and torch.equal(a_k, st["acc"]), kernel
    assert not np.array_equal(t[-1].numpy(), table[-1])
    assert not np.array_equal(st["acc"][-1].numpy(), acc[-1])


def test_cpu_wrappers_take_plain_versions_and_do_not_count():
    table, acc, steps = _inputs(72, 13, 32, seed=5, top=72)
    proto_adagrad.reset_launches()
    got = {"P1": _torch_p1(table, acc, steps, fn=proto_adagrad.merged_adagrad),
           "P2": _torch_p2(table, acc, steps, fn=proto_adagrad.v3_adagrad)}
    assert proto_adagrad.launches_by_mode == {"P1": 0, "P2": 0}
    for kernel, run in TORCH_PLAIN.items():
        want = run(table, acc, steps)
        assert all(torch.equal(a, b) for a, b in zip(got[kernel], want)), kernel


def test_wrappers_reject_other_devices_and_layouts():
    meta = dict(device="meta")
    idx = torch.zeros(8, dtype=torch.int32, **meta)
    g = torch.zeros(8, 5, **meta)
    with pytest.raises(ValueError, match="device"):
        proto_adagrad.merged_adagrad(torch.zeros(16, 10, **meta), idx, g, LR)
    with pytest.raises(ValueError, match="device"):
        proto_adagrad.v3_adagrad(torch.zeros(16, 5, **meta), torch.zeros(16, 5, **meta),
                                 idx, g, LR)
    with pytest.raises(ValueError, match="gradient"):
        proto_adagrad._check((torch.zeros(16, 10, **meta),), idx, g, 4)
    with pytest.raises(ValueError, match="one index per gradient row"):
        proto_adagrad._check((torch.zeros(16, 5, **meta),), idx[:4], g, 5)


def test_scripts_leave_the_reference_and_sys_path_to_this_checkout():
    pytest.importorskip("jax")
    saved = list(sys.path)
    _script("proto_v3_kernel")
    _script("proto_merged_kernel")
    assert sys.path == saved
    ref = os.path.abspath(sys.modules["gru4rec_tpu"].__file__)
    assert ref.startswith(REPO + os.sep), ref


def test_kernel_time_sums_every_wrapper_operation():
    """P2's time per launch is its memset, record kernel and loop kernel
    together; the sort's kernels are left out; a count off raises."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    times = {"void v3_adagrad_kernel(float const*)": [40.0, 4],
             "void v3_items_kernel(int const*)": [8.0, 4],
             "Memset (Device)": [4.0, 4], "void sortKeyValueInplace<int>": [80.0, 4]}
    assert pm.kernel_us(times, pm.KERNEL_NAMES["v3"], 4) == 13.0
    assert pm.kernel_us({"sparse_update_kernel<0>": [12.0, 4]},
                        pm.KERNEL_NAMES["v2"], 4) == 3.0
    with pytest.raises(RuntimeError, match="v3_items_kernel"):
        pm.kernel_us({**times, "void v3_items_kernel(int const*)": [8.0, 3]},
                     pm.KERNEL_NAMES["v3"], 4)


@pytest.mark.parametrize("seen, ok", [(63, True), (64, True), (65, True), (59, False),
                                      (128, False), (0, False)])
def test_kernel_time_is_a_mean_over_the_launches_seen(seen, ok):
    """A record the tracer dropped leaves the time per launch a mean over
    the launches it saw; an operation run twice per launch, or never,
    raises."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    times = {"void sparse_update_kernel<0, false>": [2.5 * seen, seen]}
    if ok:
        assert pm.kernel_us(times, pm.KERNEL_NAMES["v2"], 64) == 2.5
    else:
        with pytest.raises(RuntimeError, match="sparse_update_kernel"):
            pm.kernel_us(times, pm.KERNEL_NAMES["v2"], 64)


def test_whole_call_time_admits_no_other_operation():
    """The row-sparse kernel's call is one device operation: with
    ``exclusive`` an operation that the names do not list and that ran once
    per call raises (a sort feed would); a rare one (a record of another
    step) does not, and ``ops_per_call`` counts only the former."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    kernel = {"void sparse_update_kernel<0, true>": [200.0, 64]}
    assert pm.kernel_us(kernel, pm.KERNEL_NAMES["v2"], 64, exclusive=True) == 3.125
    assert pm.ops_per_call(kernel, 64) == 1
    rare = {**kernel, "Memset (Device)": [1.0, 1]}
    assert pm.kernel_us(rare, pm.KERNEL_NAMES["v2"], 64, exclusive=True) == 3.125
    assert pm.ops_per_call(rare, 64) == 1
    sorted_feed = {**kernel, "void sortKeyValueInplace<int>": [900.0, 63]}
    assert pm.ops_per_call(sorted_feed, 64) == 2
    with pytest.raises(RuntimeError, match="sortKeyValueInplace"):
        pm.kernel_us(sorted_feed, pm.KERNEL_NAMES["v2"], 64, exclusive=True)
    assert pm.kernel_us(sorted_feed, pm.KERNEL_NAMES["v2"], 64) == 3.125
    assert set(pm.SORT_FREE) == {"separate", "v2"}


@pytest.mark.parametrize("windows, want", [
    ([{}, {"k": [64.0, 64]}], {"k": [64.0, 64]}),       # an empty window
    ([{"k": [6.0, 6]}, {"k": [63.0, 63]}], {"k": [63.0, 63]}),  # most records lost
    ([{"k": [60.0, 60]}], {"k": [60.0, 60]}),           # within 64 // 16
    ([{"k": [4.0, 4]}] * 4, {"k": [4.0, 4]}),           # the last of the tries
    ([{}] * 4, None),                                   # never a kernel: raises
])
def test_device_times_traces_a_short_window_again(windows, want, monkeypatch):
    """The tracer on the card dropped records erratically, all of a window
    once, and a measurement that raised on the first short window failed
    the whole run; a short or empty window is now traced again."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    seen = iter(windows)
    monkeypatch.setattr(pm, "_window", lambda step, steps: next(seen))
    if want is None:
        with pytest.raises(RuntimeError, match="no CUDA kernel"):
            pm.device_times(None, steps=64)
    else:
        assert pm.device_times(None, steps=64) == want


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A change to a ``csrc/*.cuh`` header rebuilds every source."""
    from gru4rec_tpu_torch.ops.kernels import build

    for f in os.listdir(build.CSRC_DIR):
        (tmp_path / f).write_bytes(open(os.path.join(build.CSRC_DIR, f), "rb").read())
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = {n: build._lib_path(n) for n in build.SOURCES}
    with open(tmp_path / "sorted_runs.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)


def test_port_imports_no_jax():
    """Every module of the port, the kernels' and the measurement's
    included, imports without JAX and without the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gru4rec_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gru4rec_tpu_torch.__path__,\n"
        "                                               'gru4rec_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gru4rec_tpu')]\n"
        "print(' '.join(names))\n"
        "print(' '.join(sorted(bad)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True).stdout.split("\n")
    names = out[0].split()
    for mod in ("ops.kernels.proto_adagrad", "ops.kernels.proto_measure",
                "ops.kernels.sparse_update", "io.convert", "models.gru4rec"):
        assert "gru4rec_tpu_torch." + mod in names
    assert out[1] == "", f"the port imported {out[1]}"


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,d,K", CASES + [(37120, 225, 2208), (43136, 513, 2304)])
def test_cuda_kernels_match_plain_versions(n_rows, d, K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    table, acc, steps = _inputs(n_rows, d, K, seed=7, top=n_rows)
    proto_adagrad.reset_launches()
    got = {"P1": _torch_p1(table, acc, steps, "cuda", proto_adagrad.merged_adagrad),
           "P2": _torch_p2(table, acc, steps, "cuda", proto_adagrad.v3_adagrad)}
    torch.cuda.synchronize()
    assert proto_adagrad.launches_by_mode == {"P1": STEPS, "P2": STEPS}
    for kernel, run in TORCH_PLAIN.items():
        _assert_matches(got[kernel], [x.numpy() for x in run(table, acc, steps)],
                        table, acc, steps)
        assert not np.array_equal(got[kernel][0][-1].numpy(), table[-1]), kernel
