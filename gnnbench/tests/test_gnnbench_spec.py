"""``BENCHMARK.json`` against the contract's shape, and discovery by name:
configurations, traffic mixes and per-layer metrics are files found by
their names, so a new one is new files and entries only (CPU)."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from gnnbench import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gnnbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "-m", "gnnbench.run"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gnnbench/")
        assert (ROOT / c["file"]).is_file()
        names.add(c["name"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == names
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_cell_reports_what_its_per_layer_metrics_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        reported = {n for n, m in e2e.items() if harness.applies(m, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in SPEC["per_layer"]
                  if harness.applies(m, w["name"])]
        assert layers
        assert all(m["moves"] in reported for m in layers)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_file_states_what_the_benchmark_says(metric):
    entry = {m["name"]: m for m in SPEC["per_layer"]}[metric]
    module = harness.load_metric(metric)
    assert (module.LAYER, module.UNIT, module.SOURCE, module.MOVES,
            module.BETTER) == (entry["layer"], entry["unit"],
                               entry["source"], entry["moves"],
                               entry["better"])


@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.benchmark(held=True)["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    entry, config, traffic = harness.cell(workload,
                                          harness.benchmark(held=True))
    assert config["name"] == entry["config"]
    for part in ("drivers", "reference", "counts"):
        assert (ROOT / "gnnbench" / part / f"{config['driver']}.py").is_file()
    assert config["limits"] and set(config["limits"]) <= {
        "loss_gap", "grad_gap", "grad_gap_median", "change_gap",
        "first_change_gap"}
    assert "about" in traffic


@pytest.mark.parametrize("conf", harness.benchmark(held=True)["configs"],
                         ids=lambda c: c["name"])
def test_each_reduced_key_is_stated_in_the_configuration(conf):
    config = json.loads((ROOT / conf["file"]).read_text())
    assert config["reduced"] == conf["reduced"]
    assert config["source"] == conf["source"]
    for key in conf["reduced"]:
        assert key in config and key in config["assumed"]


def test_a_mix_of_another_size_than_its_configuration_states_is_refused():
    spec = json.loads(json.dumps(SPEC))
    scale = next(w for w in spec["workloads"] if w["name"] == "scale-hub50m")
    assert harness.cell("scale-hub50m", spec)[1]["edges"] == 50_000_000
    scale["traffic"] = "ddi-ogb"  # a mix of another size
    with pytest.raises(ValueError, match="50000000 edges"):
        harness.cell("scale-hub50m", spec)


PROBE_METRIC = '''"""A throwaway metric: steps in the window."""
LAYER = "probe"
UNIT = "steps"
SOURCE = "host_clock"
MOVES = "setup_s"
BETTER = "higher"


def read(ctx):
    return float(ctx["window_steps"])
'''

PROBE = r'''
import json, time
from gnnbench import harness
res = harness.run_cell("probe-cell", 1, 0.2, True, t_start=time.perf_counter(),
                       device="cpu", traffic=None)
print(json.dumps(res))
'''


def digest(tree: Path):
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(tree.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_config_mix_and_metric_are_files_and_entries_only(
        tmp_path):
    """In a copy of the benchmark: a configuration, a traffic mix, a cell
    and a per-layer metric added as new files and entries; every file that
    was there is byte for byte the same, and a (CPU) traced run of the new
    cell reports the new metric."""
    shutil.copytree(ROOT / "gnnbench", tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "gnnbench")
    bench = tmp_path / "gnnbench"
    (bench / "metrics" / "probe.steps.py").write_text(PROBE_METRIC)
    config = json.loads((ROOT / SPEC["configs"][0]["file"]).read_text())
    config["name"] = "probe-config"
    config["edges"] = 3000
    (bench / "configs" / "probe-config.json").write_text(json.dumps(config))
    (bench / "traffic" / "probe-mix.json").write_text(json.dumps(
        {"about": "a small hub graph", "nodes": 300, "edges": 3000,
         "senders": {"law": "uniform", "order": "sorted"},
         "receivers": {"law": "power", "alpha": 1.5}, "batch_edges": 64}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "probe-config", "source": "x",
                            "file": "gnnbench/configs/probe-config.json",
                            "reduced": [], "why": "probe"})
    spec["workloads"].append({"name": "probe-cell", "config": "probe-config",
                              "traffic": "probe-mix", "chips": 1,
                              "why": "probe"})
    spec["per_layer"].append({"name": "probe.steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "probe", "moves": "setup_s",
                              "workloads": ["probe-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = digest(tmp_path / "gnnbench")
    assert {k: after[k] for k in before} == before

    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
        text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["probe.steps"] == {"value": res["attempted"],
                                             "unit": "steps"}
    assert set(res["metrics"]) == {"probe.steps", "build_s"}
