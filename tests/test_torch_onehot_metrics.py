"""The K4 readers of the benchmark (``sparse_update_k4.us_per_call``,
``sparse_update_k4_roofline``) and the byte count they rest on, on the CPU:

* on a synthetic trace in which K1 and K4 both ran, each reader takes K4's
  launches alone, told apart by the mode tag in the kernel's name, while
  ``sparse_update.us_per_call`` still reads every launch of the kernel;
* on a trace whose launches carry no mode tag (a program before the tag)
  or in which no K4 ran, they give nothing;
* ``benchmark/yardstick/row_bytes.py`` counts what ``chip_smoke.py::
  _row_bytes`` counts on the program's own optimizer state, for every
  optimizer and state layout;
* the tags the readers look for are the ones ``csrc/sparse_update.cu``
  gives, by the width rule of ``sparse_update.mode_of``.
"""

import importlib.util
import os
import re

import pytest

torch = pytest.importorskip("torch")

from benchmark import spec  # noqa: E402
from benchmark.yardstick import row_bytes, tracing  # noqa: E402

K1 = ("void (anonymous namespace)::sparse_update_kernel<0, true, false, float, "
      "__nv_bfloat16, 4, (anonymous namespace)::k1_width128>((anonymous namespace)::Args, "
      "(anonymous namespace)::Hyper)")
K4 = K1.replace("k1_width128", "k4_any_width")
UNTAGGED = ("void (anonymous namespace)::sparse_update_kernel<0, true, false, float, "
            "__nv_bfloat16, 4>((anonymous namespace)::Args, (anonymous namespace)::Hyper)")
# one K4 record of the job: 32 positions, Wx0 300 wide, f32 acc, bf16 velocity
K4_RECORD = {"positions": 32, "valid": [32, 30, 32], "distinct_rows": [31, 30, 29],
             "d": 300, "adapt": "adagrad", "state": {"acc": [300, 4], "velocity": [300, 2]}}


def reader(name):
    s = importlib.util.spec_from_file_location(f"m_{name}", spec.metric_path(name))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {}}


def layer(*kernels, k4=K4_RECORD):
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.REGION, "ts": 0.0,
               "dur": 10_000.0, "args": {}}] + list(kernels)
    out = {"kind": "train", "region": tracing.Region(events), "steps": 3, "events": 94}
    if k4 is not None:
        out["k4"] = k4
    return out


def both():
    """Three steps, each one K1 (8 us) and one K4 (4, 5, 6 us)."""
    ks = []
    for t, us in enumerate((4.0, 5.0, 6.0)):
        ks += [kernel(K1, 100.0 + 1000 * t, 8.0), kernel(K4, 200.0 + 1000 * t, us)]
    return layer(*ks)


def test_k1_and_k4_are_told_apart():
    got = both()
    assert reader("sparse_update_k4.us_per_call")(got) == pytest.approx(5.0)
    assert reader("sparse_update.us_per_call")(got) == pytest.approx((3 * 8 + 15) / 6)
    bytes_ = [32 * 4 + v * 300 * 4 + u * (2 * 300 * 4 + 2 * 300 * 4 + 2 * 300 * 2)
              for v, u in zip(K4_RECORD["valid"], K4_RECORD["distinct_rows"])]
    bound_s = sum(bytes_) / 3 / 3.35e12
    assert reader("sparse_update_k4_roofline")(got) == pytest.approx(100 * bound_s / 5e-6)


def test_a_dropped_record_moves_no_reading():
    """The tracer drops a K4 record: the per-launch time and the share are
    read over the launches it kept."""
    got = layer(kernel(K4, 100.0, 5.0), kernel(K4, 1100.0, 5.0))
    full = layer(kernel(K4, 100.0, 5.0), kernel(K4, 1100.0, 5.0), kernel(K4, 2100.0, 5.0))
    for name in ("sparse_update_k4.us_per_call", "sparse_update_k4_roofline"):
        assert reader(name)(got) == pytest.approx(reader(name)(full))


@pytest.mark.parametrize("names", [(UNTAGGED,), (K1,), ()])
def test_nothing_where_no_k4_ran(names):
    got = layer(*(kernel(n, 100.0 + 1000 * i, 8.0) for i, n in enumerate(names)))
    for name in ("sparse_update_k4.us_per_call", "sparse_update_k4_roofline"):
        assert reader(name)(got) is None
        assert reader(name)(None) is None and reader(name)({**got, "kind": "eval"}) is None
    # the K1 reader still reads the untagged or K1 launches
    assert (reader("sparse_update.us_per_call")(got) is None) == (not names)


def test_roofline_needs_the_jobs_record():
    assert reader("sparse_update_k4_roofline")(layer(kernel(K4, 100.0, 5.0), k4=None)) is None
    assert reader("sparse_update_k4.us_per_call")(layer(kernel(K4, 100.0, 5.0), k4=None)) == 5.0


CASES = [  # adapt, momentum, state dtype, width, SR
    ("adagrad", 0.3, "bfloat16", 300, False),   # the one-hot Wx0 (K4)
    ("adagrad", 0.3, "bfloat16", 128, False),   # the one-hot Wy (K1)
    ("adagrad", 0.0, "bfloat16", 640, False),   # rees46's Wy
    ("adagrad", 0.4, "bfloat16_sr", 256, True),
    ("adam", 0.4, "bfloat16_sr", 256, True),
    ("adam", 0.0, "float32", 48, False),
    ("adadelta", 0.2, "bfloat16", 48, False),
    ("rmsprop", 0.0, "float32", 12, False),
]


@pytest.mark.parametrize("adapt,momentum,state_dtype,d,sr", CASES)
def test_row_bytes_is_chip_smokes(adapt, momentum, state_dtype, d, sr):
    import chip_smoke
    from gru4rec_tpu_torch import GRU4RecConfig
    from gru4rec_tpu_torch.train.optimizers import make_optimizer

    opt = make_optimizer(GRU4RecConfig(adapt=adapt, momentum=momentum,
                                       opt_state_dtype=state_dtype))
    st = opt.init_state(torch.zeros((8, d)), sparse=True)
    layout = {k: (v.shape[1], v.element_size()) for k, v in st.items()}
    assert row_bytes.row_bytes(adapt, layout, d, sr) == chip_smoke._row_bytes(opt, st, d, sr)


def test_update_bytes_counts_indices_gradients_and_rows():
    state = {"acc": (300, 4), "velocity": (300, 2)}
    per_row = row_bytes.row_bytes("adagrad", state, 300)
    assert per_row == 300 * (8 + 8 + 4)
    assert row_bytes.update_bytes(32, 30, 29, 300, "adagrad", state) == \
        32 * 4 + 30 * 300 * 4 + 29 * per_row
    assert row_bytes.update_bound_s(3.35e12) == pytest.approx(1.0)


def test_the_kernel_source_gives_the_tags_the_readers_read():
    from gru4rec_tpu_torch.ops.kernels import build, sparse_update

    with open(os.path.join(build.CSRC_DIR, "sparse_update.cu")) as f:
        src = f.read()
    for tag in ("k1_width128", "k4_any_width", "k2_k3_sr"):
        assert re.search(rf"struct {tag} {{}};", src), tag
    assert "a.d % 128 == 0" in src
    # the source's width rule is the wrapper's
    assert [sparse_update.mode_of("adagrad", d, False) for d in (128, 256, 300, 48)] == \
        ["K1", "K1", "K4", "K4"]
    for name in ("sparse_update_k4.us_per_call", "sparse_update_k4_roofline"):
        with open(spec.metric_path(name)) as f:
            assert 'K4 = "k4_any_width"' in f.read()
