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
``cuda``-marked tests (the published widths, the edges of the in-kernel
dedup, every access width, and calls under
``torch.cuda.set_sync_debug_mode("error")``), which need no JAX. There
the kernels' table and accumulator must also equal, bit for bit,
``proto_measure.exact_adagrad`` (the runs summed in ascending raw position,
the square root correctly rounded), which holds them to the stable sort's
sum order:

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


def _exact(table, acc, steps):
    """``proto_measure.exact_adagrad`` over the steps: the kernels' bits."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    t, a = table, acc
    for idx, g in steps:
        t, a = pm.exact_adagrad(t, a, idx, g, LR)
    return t, a


def _assert_exact(got, table, acc, steps):
    """(table, acc) bit-equal to the exact reference."""
    for name, g, w in zip(("table", "acc"), got, _exact(table, acc, steps)):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


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


@pytest.mark.parametrize("n_rows,d,K", CASES + [(500, 225, 3000)])
def test_exact_reference_matches_the_plain_versions(n_rows, d, K):
    """The bit-exact reference the card tests hold the kernels to: the
    plain versions' accumulator bit for bit (no square root touches it),
    their table within the scripts' tolerance, the last row updated."""
    table, acc, steps = _inputs(n_rows, d, K, seed=d + 3, top=n_rows)
    t, a = _exact(table, acc, steps)
    for kernel, run in TORCH_PLAIN.items():
        t_p, a_p = run(table, acc, steps)
        np.testing.assert_array_equal(a_p.numpy(), a, err_msg=kernel)
        np.testing.assert_allclose(t_p.numpy(), t, rtol=RTOL, atol=ATOL, err_msg=kernel)
    assert not np.array_equal(t[-1], table[-1])
    untouched = ~_touched(n_rows, steps)
    np.testing.assert_array_equal(t[untouched], table[untouched])


@pytest.mark.parametrize("n_rows,d,K", CASES + [(500, 225, 3000)])
def test_plain_versions_with_a_correctly_rounded_sqrt_are_exact(n_rows, d, K, monkeypatch):
    """The exact reference differs from the plain versions only in the
    square root: given one that is correctly rounded (float64, then
    float32), they equal it bit for bit."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    table, acc, steps = _inputs(n_rows, d, K, seed=d + 4, top=n_rows)
    for run in TORCH_PLAIN.values():
        _assert_exact(run(table, acc, steps), table, acc, steps)


@pytest.mark.parametrize("source", ["sparse_update", "proto_adagrad"])
def test_build_variants_apply_to_their_source(source):
    """Every text that a variant of ``scripts/<source>_variants.json``
    replaces is in ``csrc/<source>.cu``, so the timing script builds each
    variant of the source as it stands."""
    import json

    from gru4rec_tpu_torch.ops.kernels import build

    with open(os.path.join(REPO, "scripts", f"{source}_variants.json")) as f:
        variants = json.load(f)
    with open(os.path.join(build.CSRC_DIR, source + ".cu")) as f:
        text = f.read()
    assert variants["this design"] == []
    for name, subs in variants.items():
        for old, new in subs:
            assert old in text and old != new, (name, old)


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


@pytest.mark.parametrize("d,offset,merged,separate", [
    (12, 0, 16, 16),    # both pitches multiples of 16 bytes
    (13, 0, 8, 4),      # odd: the merged pitch 8d is 8-byte aligned, 4d is not
    (225, 0, 8, 4),
    (256, 0, 16, 16),
    (513, 0, 8, 4),
    (256, 1, 4, 4),     # a base 4 bytes off 16
    (256, 2, 8, 8),     # 8 bytes off
    (256, 4, 16, 16),   # 16 bytes off: still aligned
    (13, 2, 8, 4),
])
def test_access_width_follows_every_pitch_and_base_pointer(d, offset, merged, separate):
    """P1 copies its merged [t | a] span and P2 its rows in the widest access
    that every row pitch and base pointer allows."""
    n = 8
    flat = torch.zeros(n * 2 * d + 16)  # CPU allocations are 64-byte aligned
    assert flat.data_ptr() % 64 == 0
    m = flat[offset:offset + n * 2 * d].view(n, 2 * d)
    t = flat[offset:offset + n * d].view(n, d)
    assert proto_adagrad.access_width(m) == merged
    assert proto_adagrad.access_width(t) == separate
    assert proto_adagrad.access_width(t, torch.zeros(n, d), torch.zeros(3, d)) == separate


def test_access_width_of_a_row_sliced_buffer():
    """``big[1:]`` shifts the base by one row: aligned at even widths, 8
    bytes off 16 for an odd merged width, 4 for an odd separate one; every
    tensor given must allow the width."""
    for d, merged, separate in ((256, 16, 16), (225, 8, 4), (12, 16, 16), (13, 8, 4)):
        assert proto_adagrad.access_width(torch.zeros(9, 2 * d)[1:]) == merged
        assert proto_adagrad.access_width(torch.zeros(9, d)[1:]) == separate
    aligned = torch.zeros(8, 256)
    assert proto_adagrad.access_width(aligned, torch.zeros(9, 256)[1:]) == 16
    assert proto_adagrad.access_width(aligned, torch.zeros(8 * 256 + 1)[1:].view(8, 256)) == 4


def test_cpu_wrappers_take_int64_indices_unchanged_in_result():
    """The wrappers pass int32 and int64 indices as they are; on the CPU the
    plain versions give the same result for both."""
    table, acc, steps = _inputs(72, 13, 32, seed=6, top=72)
    wide = [(idx.astype(np.int64), g) for idx, g in steps]
    for kernel, (run, fn) in {"P1": (_torch_p1, proto_adagrad.merged_adagrad),
                              "P2": (_torch_p2, proto_adagrad.v3_adagrad)}.items():
        got32 = run(table, acc, steps, fn=fn)
        got64 = run(table, acc, wide, fn=fn)
        assert all(torch.equal(a, b) for a, b in zip(got32, got64)), kernel


def test_scripts_leave_the_reference_and_sys_path_to_this_checkout():
    pytest.importorskip("jax")
    saved = list(sys.path)
    _script("proto_v3_kernel")
    _script("proto_merged_kernel")
    assert sys.path == saved
    ref = os.path.abspath(sys.modules["gru4rec_tpu"].__file__)
    assert ref.startswith(REPO + os.sep), ref


def test_kernel_time_sums_every_wrapper_operation():
    """A variant's time per call sums the mean time of each operation its
    names list; P2's call is its one loop kernel now, so the memset and
    record kernel of its first design are no longer among its names, and a
    count off raises."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    times = {"void v3_adagrad_kernel<1>(Args)": [40.0, 4],
             "void merged_adagrad_kernel<2, 1>(Args)": [8.0, 4],
             "Memset (Device)": [4.0, 4]}
    assert pm.kernel_us(times, pm.KERNEL_NAMES["v3"], 4) == 10.0
    assert pm.kernel_us(times, ("v3_adagrad_kernel", "merged_adagrad_kernel"), 4) == 12.0
    assert pm.kernel_us({"sparse_update_kernel<0>": [12.0, 4]},
                        pm.KERNEL_NAMES["v2"], 4) == 3.0
    with pytest.raises(RuntimeError, match="v3_adagrad_kernel"):
        pm.kernel_us({**times, "void v3_adagrad_kernel<1>(Args)": [40.0, 3]},
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
    """Every variant's call is one device operation: with ``exclusive`` an
    operation that the names do not list and that ran once per call raises
    (a sort feed would, as P1's and P2's first design had); a rare one (a
    record of another step) does not, and ``ops_per_call`` counts only the
    former."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    for variant, name in (("v2", "void sparse_update_kernel<0, true>"),
                          ("merged", "void merged_adagrad_kernel<2, 1>(Args)"),
                          ("v3", "void v3_adagrad_kernel<1>(Args)")):
        kernel = {name: [200.0, 64]}
        assert pm.kernel_us(kernel, pm.KERNEL_NAMES[variant], 64, exclusive=True) == 3.125
        assert pm.ops_per_call(kernel, 64) == 1
        rare = {**kernel, "Memset (Device)": [1.0, 1]}
        assert pm.kernel_us(rare, pm.KERNEL_NAMES[variant], 64, exclusive=True) == 3.125
        assert pm.ops_per_call(rare, 64) == 1
        sorted_feed = {**kernel, "void sortKeyValueInplace<int>": [900.0, 63]}
        assert pm.ops_per_call(sorted_feed, 64) == 2
        with pytest.raises(RuntimeError, match="sortKeyValueInplace"):
            pm.kernel_us(sorted_feed, pm.KERNEL_NAMES[variant], 64, exclusive=True)
        assert pm.kernel_us(sorted_feed, pm.KERNEL_NAMES[variant], 64) == 3.125
    assert set(pm.SORT_FREE) == {"separate", "v2", "merged", "v3"}


def test_every_measurement_variant_is_one_sort_free_operation():
    """All four variants of the measurement paths are sort-free and name one
    operation each, so ``record`` holds every one of them to the whole
    call."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    assert set(pm.KERNEL_NAMES) == {"separate", "v2", "merged", "v3"}
    assert set(pm.SORT_FREE) == set(pm.KERNEL_NAMES)
    assert all(len(names) == 1 for names in pm.KERNEL_NAMES.values())
    assert pm.KERNEL_NAMES["merged"] == ("merged_adagrad_kernel",)
    assert pm.KERNEL_NAMES["v3"] == ("v3_adagrad_kernel",)


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


@pytest.mark.parametrize("first, traced", [(64, 1), (60, 1), (69, 2), (59, 2)])
def test_device_times_traces_a_window_with_extra_records_again(first, traced,
                                                                monkeypatch):
    """With the call's operation names, a window that recorded one of them
    more than ``steps // 16`` times too often (69 of 64 once on the card),
    or too rarely, is traced again; other operations may run any number of
    times per step."""
    from gru4rec_tpu_torch.ops.kernels import proto_measure as pm

    windows = [{"void k<1>": [float(first), first], "Memset": [3.0, 192]},
               {"void k<1>": [64.0, 64], "Memset": [3.0, 192]}]
    seen = iter(windows)
    calls = []
    monkeypatch.setattr(pm, "_window", lambda step, steps: calls.append(steps) or next(seen))
    assert pm.device_times(None, steps=64, names=("k<",)) == windows[traced - 1]
    assert calls == [64] * traced


def test_build_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """A change to a ``csrc/*.cuh`` header rebuilds every source."""
    from gru4rec_tpu_torch.ops.kernels import build

    for f in os.listdir(build.CSRC_DIR):
        (tmp_path / f).write_bytes(open(os.path.join(build.CSRC_DIR, f), "rb").read())
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = {n: build._lib_path(n) for n in build.SOURCES}
    (tmp_path / "shared.cuh").write_text("#pragma once\n")  # a header appears
    added = {n: build._lib_path(n) for n in build.SOURCES}
    with open(tmp_path / "shared.cuh", "a") as f:
        f.write("// changed\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    with open(tmp_path / "dedup.cuh", "a") as f:  # the header both sources include
        f.write("// changed\n")
    dedup = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(len({before[n], added[n], after[n], dedup[n]}) == 4 for n in build.SOURCES)


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
        _assert_exact(got[kernel], table, acc, steps)
        assert not np.array_equal(got[kernel][0][-1].numpy(), table[-1]), kernel


def _edge_idx(case, n_rows, rng):
    """Raw indices (int64 numpy) for one edge of the in-kernel dedup."""
    if case == "K=1":
        return np.array([n_rows - 1])
    if case == "one run":  # every position the same row
        return np.full(2208, 7)
    if case == "all sentinel":
        return np.full(40, SENTINEL)
    if case == "run of 40":  # past the 32 positions a head lists
        idx = rng.randint(0, n_rows, 500)
        idx[rng.choice(500, 40, replace=False)] = n_rows - 1
        idx[-3:] = SENTINEL
        return idx
    if case == "K=9000":  # many rounds of the dedup pass, a padding row
        idx = rng.randint(0, n_rows, 9000)
        idx[rng.choice(9000, 40, replace=False)] = n_rows - 1
        idx[rng.choice(9000, 7, replace=False)] = SENTINEL
        idx[4100] = n_rows + 5
        return idx
    raise ValueError(case)


PROTO_EDGES = ("K=1", "one run", "all sentinel", "run of 40", "K=9000")


def _on_card(x, offset):
    """``x`` copied to the card into a buffer whose base lies ``offset``
    floats past a 256-byte aligned allocation."""
    flat = torch.empty(x.size + offset, device="cuda")
    out = flat[offset:].view(x.shape)
    out.copy_(torch.from_numpy(x))
    return out


def _card_vs_plain(kernel, n_rows, d, idx, idx_dtype, offset, seed):
    """One kernel call on the card (tables ``offset`` floats off an aligned
    base) against the plain version on the CPU from the same inputs: within
    the scripts' tolerance, untouched rows bit-identical, the accumulator
    bit-equal to the plain version's, and table and accumulator bit-equal
    to the exact reference. Returns the access width that the call took and
    the kernel's (table, acc)."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n_rows, d).astype(np.float32)
    acc = np.abs(rng.randn(n_rows, d)).astype(np.float32)
    g = (rng.randn(len(idx), d) * 0.1).astype(np.float32)
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(idx_dtype)
    steps = [(idx, g)]
    proto_adagrad.reset_launches()
    if kernel == "P1":
        m = _on_card(np.concatenate([table, acc], axis=1), offset)
        width = proto_adagrad.access_width(m)
        proto_adagrad.merged_adagrad(m, idx_t.cuda(), torch.from_numpy(g).cuda(), LR)
        got = m[:, :d].cpu(), m[:, d:].cpu()
    else:
        t, a = _on_card(table, offset), _on_card(acc, offset)
        width = proto_adagrad.access_width(t, a)
        proto_adagrad.v3_adagrad(t, a, idx_t.cuda(), torch.from_numpy(g).cuda(), LR)
        got = t.cpu(), a.cpu()
    torch.cuda.synchronize()
    assert proto_adagrad.launches_by_mode[kernel] == 1
    want = TORCH_PLAIN[kernel](table, acc, steps)
    _assert_matches(got, [x.numpy() for x in want], table, acc, steps)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    _assert_exact(got, table, acc, steps)
    return width, got, table


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["P1", "P2"])
@pytest.mark.parametrize("d", [225, 256])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", PROTO_EDGES)
def test_cuda_kernels_dedup_edges(case, idx_dtype, d, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows = 1000
    idx = _edge_idx(case, n_rows, np.random.RandomState(PROTO_EDGES.index(case)))
    _, got, table = _card_vs_plain(kernel, n_rows, d, idx, idx_dtype, 0, seed=d)
    counts = np.bincount(idx[(idx >= 0) & (idx < n_rows)], minlength=n_rows)
    if counts.any():  # the most touched row moved
        r = int(counts.argmax())
        assert not np.array_equal(got[0][r].numpy(), table[r])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["P1", "P2"])
@pytest.mark.parametrize("d,offset,width", [
    (256, 0, {"P1": 16, "P2": 16}), (256, 1, {"P1": 4, "P2": 4}),
    (256, 2, {"P1": 8, "P2": 8}), (513, 0, {"P1": 8, "P2": 4}),
    (513, 1, {"P1": 4, "P2": 4}), (12, 0, {"P1": 16, "P2": 16}),
    (13, 2, {"P1": 8, "P2": 4}),
])
def test_cuda_kernels_every_access_width(d, offset, width, kernel):
    """The 16-, 8- and 4-byte paths, on rees46's 200,064 rows with the last
    row touched twice, a base pointer off 16 bytes included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n_rows = 200_064
    rng = np.random.RandomState(d + offset)
    idx = rng.randint(0, n_rows, 700)
    idx[[0, 350]] = n_rows - 1
    idx[[10, 20, 30]] = idx[5]
    idx[-4:] = SENTINEL
    got_width, got, table = _card_vs_plain(kernel, n_rows, d, idx, torch.int32, offset,
                                           seed=d)
    assert got_width == width[kernel]
    assert not np.array_equal(got[0][-1].numpy(), table[-1])


@pytest.mark.cuda
def test_cuda_kernel_calls_need_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, d, K = 37120, 225, 2208
    merged = torch.randn(n, 2 * d, device="cuda")
    table, acc = torch.randn(n, d, device="cuda"), torch.rand(n, d, device="cuda")
    idx = torch.randint(0, n, (K,), device="cuda", dtype=torch.int32)
    g = torch.randn(K, d, device="cuda")
    for i in (idx, idx.long()):  # the first calls build, load and size the grid
        proto_adagrad.merged_adagrad(merged, i, g, LR)
        proto_adagrad.v3_adagrad(table, acc, i, g, LR)
    torch.cuda.synchronize()
    proto_adagrad.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (idx, idx.long()):
            proto_adagrad.merged_adagrad(merged, i, g, LR)
            proto_adagrad.v3_adagrad(table, acc, i, g, LR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert proto_adagrad.launches_by_mode == {"P1": 2, "P2": 2}
