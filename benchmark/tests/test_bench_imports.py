"""No module that the harness or the reference loads has the top-level name
jax, jaxlib, flax or gru4rec_tpu (compared whole: gru4rec_tpu_torch begins
with gru4rec_tpu), and the reference loads nothing of the program."""

import json
import subprocess
import sys
import types

from benchmark import run, spec

PROBE = """
import json, sys
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(body: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(body=body)], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax_after_a_run():
    body = """
import time, torch
import benchmark.run, benchmark.control, benchmark.sets
from benchmark.jobs import common, fit, evaluate, serve
from benchmark.tests.tiny import tiny_cell
for w in ("retailrocket.serve", "rees46.eval"):
    cell = tiny_cell(w)
    r = common.Run(seed=3, seconds=0.5, trace=False, device=torch.device("cpu"),
                   t_start=time.perf_counter())
    benchmark.run.result(cell, r, benchmark.run.execute(cell, r), "cpu")
"""
    names = _top_names(body)
    assert "gru4rec_tpu_torch" in names
    assert not names & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_names("import benchmark.reference.gru4rec, benchmark.yardstick.compare, "
                       "benchmark.yardstick.weights, benchmark.yardstick.generators")
    assert not names & (set(run.FORBIDDEN) | {"gru4rec_tpu_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gru4rec_tpu_torch_extra", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gru4rec_tpu.models", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("z"))
    assert run.forbidden_modules() == ["gru4rec_tpu", "jaxlib"]
