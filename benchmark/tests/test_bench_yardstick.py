"""The frozen copies held to their originals, the generators' determinism,
the counts against hand counts, and the rate and percentile arithmetic."""

import math
import os
import sys

import numpy as np
import pandas as pd
import pytest

from benchmark.reference import gru4rec as ref
from benchmark.yardstick import counts, generators, stats, tracing

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def test_synth_data_is_the_port_benchmarks():
    from gru4rec_tpu_torch import bench

    pd.testing.assert_frame_equal(generators.synth_data(3), bench.synth_data(3))


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_split_and_eval_sessions_are_chip_smokes(seed):
    import chip_smoke

    for a, b in zip(generators.synth_split(seed, n_items=500, n_events=6000),
                    chip_smoke.synth_split(seed, n_items=500, n_events=6000)):
        pd.testing.assert_frame_equal(a, b)
    pd.testing.assert_frame_equal(generators.eval_sessions(4000, 700, seed),
                                  chip_smoke.eval_sessions(4000, 700, seed))


def test_generators_are_deterministic_per_seed():
    a = generators.eval_sessions(3000, 400, generators.seed32(2**31 + 17, "clicks"))
    b = generators.eval_sessions(3000, 400, generators.seed32(2**31 + 17, "clicks"))
    c = generators.eval_sessions(3000, 400, generators.seed32(2**31 + 18, "clicks"))
    pd.testing.assert_frame_equal(a, b)
    assert not a["ItemId"].equals(c["ItemId"])
    assert generators.seed32(2**40, "x") == generators.seed32(2**40, "x") < 2**31
    assert generators.seed32(1, "clicks") != generators.seed32(1, "weights")


def test_synth_split_train_holds_every_item():
    train, _ = generators.synth_split(1, n_items=300, n_events=5000)
    assert set(train["ItemId"]) == set(range(300))


def test_lane_streams_follow_each_lanes_sessions():
    frame = generators.eval_sessions(2000, 50, 4)
    items, offsets = generators.sessions_csr(frame)
    sids, iids = generators.lane_streams(items, offsets, 3)
    for lane in range(3):
        want = np.concatenate([items[offsets[s]:offsets[s + 1]]
                               for s in range(lane, len(offsets) - 1, 3)])
        np.testing.assert_array_equal(iids[:, lane], want[:len(iids)])
        assert set(sids[:, lane] % 3) == {lane}


def test_tracing_copies_are_profilings():
    from gru4rec_tpu_torch.utils import profiling

    assert tracing.HOST_LAUNCHES == profiling.HOST_LAUNCHES
    ops = [{"ts": 0.0, "dur": 10.0}, {"ts": 5.0, "dur": 10.0}, {"ts": 30.0, "dur": 1.0},
           {"ts": 30.5, "dur": 0.25}]
    assert tracing.busy_ms(ops) == profiling.busy_ms(ops) == pytest.approx(0.016)
    merged = tracing.union([(0.0, 10.0), (5.0, 15.0), (30.0, 31.0)])
    assert merged == [[0.0, 15.0], [30.0, 31.0]]
    assert tracing.clipped_us(merged, 10.0, 30.5) == pytest.approx(5.5)


def test_region_reads_calls_launches_and_gaps():
    ev = [{"name": tracing.REGION, "cat": "user_annotation", "ts": 0.0, "dur": 100.0},
          {"name": tracing.CALL, "cat": "user_annotation", "ts": 0.0, "dur": 40.0},
          {"name": tracing.CALL, "cat": "user_annotation", "ts": 50.0, "dur": 40.0},
          {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 1.0, "dur": 2.0},
          {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 51.0, "dur": 2.0},
          {"name": "aten::topk", "cat": "cpu_op", "ts": 20.0, "dur": 30.0},
          {"name": "k1", "cat": "kernel", "ts": 10.0, "dur": 10.0},
          {"name": "k2", "cat": "kernel", "ts": 60.0, "dur": 20.0}]
    r = tracing.Region(ev)
    assert r.wall_s == pytest.approx(100e-6) and r.busy_s == pytest.approx(30e-6)
    assert r.launches == 2
    assert r.call_times() == [pytest.approx((40e-6, 10e-6)), pytest.approx((40e-6, 20e-6))]
    b = r.breakdown()
    assert b["device_ops"][0][0] == "k2"
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::topk"] == pytest.approx(40e-6)  # [20, 60)
    assert gaps[tracing.CALL] == pytest.approx(30e-6)  # [0, 10) and [80, 100)


def test_breakdown_names_a_gap_begun_outside_every_host_event():
    # the region opens before the program's first span: the opening gap
    # [0, 650) is split by the span innermost at each moment, [0, 5)
    # unnamed; a gap that no host event overlaps keeps no name
    def span(name, ts, dur):
        return {"name": name, "cat": "user_annotation", "ts": ts, "dur": dur}

    ev = [span(tracing.REGION, 0.0, 1000.0), span("gru4rec.evaluate", 5.0, 895.0),
          span("gru4rec.evaluate.schedule", 10.0, 590.0),
          span("gru4rec.evaluate.schedule.sort", 20.0, 380.0),
          span("gru4rec.evaluate.schedule.walk", 410.0, 180.0),
          {"name": "k1", "cat": "kernel", "ts": 650.0, "dur": 200.0},
          {"name": "k2", "cat": "kernel", "ts": 920.0, "dur": 10.0}]
    gaps = dict(tracing.Region(ev).breakdown()["idle_gaps"])
    assert gaps == {"gru4rec.evaluate.schedule.sort": pytest.approx(380e-6),
                    "gru4rec.evaluate.schedule.walk": pytest.approx(180e-6),
                    "gru4rec.evaluate.schedule": pytest.approx(30e-6),
                    "gru4rec.evaluate": pytest.approx(125e-6),    # + [850, 920)
                    "(no host event)": pytest.approx(75e-6)}      # + [930, 1000)


def test_flop_counts_against_hand_counts():
    # retailrocket training: GRU-224, batch 80, 2,048 negatives
    gates = 2 * 80 * (224 + 224) * 3 * 224             # 48,168,960
    scores = 2 * 80 * 224 * (80 + 2048)                # 76,267,520
    step = counts.train_flops_per_event(224, 224, 80, 2048) * 80
    assert step == pytest.approx(3 * (gates + scores))  # 373,309,440
    # rees46 evaluation: GRU-512, 512 lanes, 200,000 items
    ev = counts.eval_flops_per_event(512, 512, 200_000) * 512
    assert ev == pytest.approx(2 * 512 * 1024 * 1536 + 2 * 512 * 512 * 200_000)


def test_product_bound_is_chip_smokes():
    import chip_smoke

    assert counts.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert counts.BF16_PEAK_FLOP_S == chip_smoke.BF16_PEAK_FLOP_S
    # rees46's evaluation product (PERF.md's table of the product: 0.2449 ms)
    assert counts.product_bound_s(512, 512, 200_064) * 1e3 == pytest.approx(0.2449, abs=5e-5)
    # an operation-bound shape
    assert counts.product_bound_s(8192, 8192, 8192) == pytest.approx(
        2 * 8192**3 / counts.BF16_PEAK_FLOP_S)


def test_product_bound_at_bfloat16_operands():
    # bfloat16 operands read once, the float32 scores written once
    moved = 2 * (512 * 512 + 512 * 200_064) + 4 * 512 * 200_064
    assert counts.product_bound_s(512, 512, 200_064, 2) == pytest.approx(
        moved / counts.HBM_BYTES_PER_S)
    assert counts.product_bound_s(512, 512, 200_064, 2) * 1e3 == pytest.approx(0.1836, abs=5e-5)


class _Kernels:
    """A traced region holding the given kernels, for the metric readers."""

    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_time_s(self, match):
        ks = [d for name, d in self.kernels if match(name)]
        return sum(ks), len(ks)


def _roofline(kernels, steps=1):
    import importlib.util

    from benchmark import spec

    s = importlib.util.spec_from_file_location("roofline", spec.metric_path("mixed_mm_roofline"))
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    layer = {"kind": "eval", "config": spec.cell("rees46.eval").config, "steps": steps,
             "traffic": {"batch_size": 512}, "region": _Kernels(kernels)}
    return mod.read(layer)


def test_roofline_reads_past_100_and_needs_its_kernels():
    bound = sum(counts.product_bound_s(M, K, N, 2)
                for M, K, N in counts.eval_step_products(512, 512, 512, 200_064))
    # the GEMM and the table's cast, as PR 17's step ran them
    assert _roofline([("nvjet_tst_gemm", 2.486e-4), ("bfloat16_copy_kernel", 2.775e-4),
                      ("elementwise_kernel", 1e-3)]) == pytest.approx(
        100 * bound / 5.261e-4)
    # a product faster than its bound reads above 100%, uncapped
    assert _roofline([("sm90_xmma_gemm", 0.5 * bound)]) == pytest.approx(200.0)
    with pytest.raises(RuntimeError):
        _roofline([("elementwise_kernel", 1e-3)])


def test_sampler_gap_against_hand_counts():
    from benchmark.yardstick import compare

    pop = np.ones(32)
    # 16 bins of two equally likely items each: every draw of item 0 puts
    # the whole share in a bin whose probability is 1/16
    assert compare.sampler_gap(np.zeros(100, dtype=np.int64), pop, 1.0) == pytest.approx(15.0)
    assert compare.sampler_gap(np.arange(32).repeat(3), pop, 1.0) == pytest.approx(0.0)
    assert compare.sampler_gap(np.array([0, 32]), pop, 1.0) == math.inf
    # pop ** alpha: with counts 4 and 1 at alpha 0.5, item 0 is drawn 2/3 of the time
    assert compare.sampler_gap(np.array([0, 0, 1]), np.array([4, 1]), 0.5, bins=2) == \
        pytest.approx(0.0)


def test_layout_counts_are_the_programs():
    from gru4rec_tpu_torch.models import gru

    for n in (300, 36_968, 200_000):
        assert counts.pad_items(n) == gru.pad_items(n, 128)
    for w in (17, 225, 513):
        assert counts.pad_cols(w) == gru.pad_cols(w)
    assert counts.pad_items(36_968) == 36_992 and counts.pad_items(200_000) == 200_064


def test_percentile_is_over_every_value():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    # a tail of 6 slow calls among 100 is in the 95th percentile; chunk
    # medians would hide it
    calls = [1.0] * 94 + [9.0] * 6
    assert stats.percentile(calls, 95) == 9.0
    assert stats.rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_count_steps_is_the_programs_schedule():
    from gru4rec_tpu_torch.data.scheduler import _build_schedule_numpy

    frame = generators.eval_sessions(3000, 80, 2)
    items, offsets = generators.sessions_csr(frame)
    sched = _build_schedule_numpy(items.astype(np.int32), offsets,
                                  np.arange(len(offsets) - 1), 16, False)
    assert ref.count_steps(offsets, 16) == sched.n_steps
    walk = ref.LaneWalk(items, offsets, 16)
    for t in range(sched.n_steps):
        inputs, targets, live, fresh = walk.step()
        np.testing.assert_array_equal(live, sched.valid[t])
        np.testing.assert_array_equal(fresh, sched.reset[t])
        np.testing.assert_array_equal(inputs[live], sched.in_idx[t][live])
        np.testing.assert_array_equal(targets[live], sched.out_idx[t][live])
    assert walk.step() is None
    assert math.isfinite(ref.LOG_EPS)
