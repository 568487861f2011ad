"""Draws 12-23 of the differential config-surface fuzz: the checks of
``tests/test_torch_config_fuzz_diff.py``, which holds draws 0-11 (split so
that each file keeps to its time on one test worker)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_config_fuzz_diff import run_draw  # noqa: E402


@pytest.mark.parametrize("draw", range(12, 24))
def test_draw_steps_evaluate_and_archive_match_jax(draw, monkeypatch, tmp_path):
    out = run_draw(draw, monkeypatch, tmp_path)
    assert out["steps"] > 50, out
