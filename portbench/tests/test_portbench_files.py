"""BENCHMARK.json keeps to the contract's limits, every name it gives is
a file that the harness finds, and a new cell and a new metric come in as
files alone, editing none that is there."""

import argparse
import hashlib
import json
import os
import re
import statistics

import pytest

import conftest
import harness

B = conftest.bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(conftest.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        names.append(w["name"])
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for kind, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                       "source"}),
                       ("per_layer", {"name", "unit", "better", "source",
                                      "layer", "moves"})):
        for m in B[kind]:
            assert set(m) - {"workloads"} == keys
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
            if kind == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert LINE.match(m["layer"]) and m["moves"] in e2e
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        c = harness.cell(w["name"])
        got = {m["name"] for m, _ in c["metrics"]["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert c["metrics"]["per_layer"]


def test_config_files_name_their_cut():
    for c in B["configs"]:
        cfg = json.load(open(os.path.join(conftest.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(conftest.PB, "gen",
                                           cfg["family"] + ".py"))


def test_every_file_found_by_name():
    for w in B["workloads"]:
        c = harness.cell(w["name"])
        assert callable(c["gen"].make_pool)
        for kind in ("end_to_end", "per_layer"):
            for m, reader in c["metrics"][kind]:
                assert callable(reader.read), m["name"]


def digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_files_alone(mini):
    """A later change adds a configuration, a traffic mix, a cell and a
    metric: new files and new entries in BENCHMARK.json, no existing file
    of portbench/ edited, and the run reports the new metric."""
    here = mini / "portbench"
    before = digest(here)
    (here / "configs" / "dummy_random.json").write_text(json.dumps(dict(
        json.load(open(here / "configs" / "random_sparse.json")),
        n=180, m=180, density=0.04)))
    (here / "traffic" / "dummy-mix.json").write_text(json.dumps(
        {"p": 65521, "planted_rows": 3, "pool": 2}))
    (here / "metrics" / "dummy_wall_median_s.py").write_text(
        "import statistics\n\n\ndef read(record):\n"
        "    return statistics.median(record['walls'])\n")
    b = json.load(open(mini / "BENCHMARK.json"))
    b["configs"].append({"name": "dummy_random", "source": "a test",
                         "file": "portbench/configs/dummy_random.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy-cell", "config": "dummy_random",
                           "traffic": "dummy-mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].insert(0, {"name": "dummy_wall_median_s", "unit": "s",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["dummy-cell"]})
    (mini / "BENCHMARK.json").write_text(json.dumps(b))
    after = digest(here)
    assert {k: after[k] for k in before} == before

    import spasm_tpu_torch

    files = harness.cell("dummy-cell", here=str(here), root=str(mini))
    args = argparse.Namespace(workload="dummy-cell", seed=9, seconds=0.2,
                              trace=0)
    res = harness.run(args, device="cpu", program=spasm_tpu_torch,
                      cell_files=files, log=lambda msg: None)
    assert res["correct"]
    assert res["metrics"]["dummy_wall_median_s"]["value"] > 0
    assert "dummy_wall_median_s" not in files_metrics(mini, B["workloads"][0]
                                                      ["name"])


def files_metrics(mini, name):
    c = harness.cell(name, here=str(mini / "portbench"), root=str(mini))
    return {m["name"] for m, _ in c["metrics"]["end_to_end"]}


def test_p90_needs_ten_calls():
    reader = harness.load_module(os.path.join(conftest.PB, "metrics",
                                              "echelonize_s.p90.py"))
    assert reader.read({"walls": [1.0] * 9}) is None
    walls = [float(i) for i in range(1, 101)]
    assert reader.read({"walls": walls}) == pytest.approx(
        statistics.quantiles(walls, n=10, method="inclusive")[8])
