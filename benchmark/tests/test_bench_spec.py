"""Every entry of BENCHMARK.json resolves to its files by name, within the
contract's limits."""

import importlib.util
import json
import os
import re

import pytest

from benchmark import spec

SPEC = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
PARAMETER_FILE = re.compile(r"^(paramfiles|param_samples)/[A-Za-z0-9_.\-]+\.py")
with open(os.path.join(spec.HERE, "deferred.json")) as _f:
    DEFERRED = json.load(_f)


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [e["name"] for e in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and len(CELLS) == len(set(CELLS))


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in SPEC["end_to_end"])


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_files(name):
    conf = {c["name"]: c for c in SPEC["configs"]}[name]
    assert conf["file"].startswith("benchmark/configs/")
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        config = json.load(f)
    assert config["name"] == name
    for key in conf["reduced"]:
        assert NAME.match(key) and key in config["params"]
        assert not key.endswith(("_dim", "_rank")) and key not in ("layers", "embedding")
    # the published parameters, as the parameter file that the
    # configuration's own source names states them
    from gru4rec_tpu_torch import GRU4RecConfig

    source = PARAMETER_FILE.match(config["source"])
    assert source, config["source"]
    published = GRU4RecConfig.from_parameter_file(os.path.join(spec.ROOT, source.group(0)))
    for k, v in config["params"].items():
        assert getattr(published, k) == v, k


@pytest.mark.parametrize("cell", CELLS + [w["name"] for w in DEFERRED["workloads"]])
def test_cells_resolve(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        path = spec.metric_path(m["name"])
        s = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(s)
        s.loader.exec_module(mod)
        assert mod.read(None) is None
    assert importlib.util.find_spec(f"benchmark.jobs.{c.traffic['kind']}") is not None
    assert all(isinstance(v, float) and v > 0 for v in c.limits.values())


def test_deferred_cells_are_not_in_the_benchmark():
    names = {e["name"] for k in ("workloads", "end_to_end", "per_layer") for e in SPEC[k]}
    for k in ("workloads", "end_to_end", "per_layer"):
        for e in DEFERRED[k]:
            assert e["name"] not in names and NAME.match(e["name"])
    for m in DEFERRED["end_to_end"] + DEFERRED["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in DEFERRED["workloads"]}


def test_per_layer_names_cells_and_layers():
    for m in SPEC["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
