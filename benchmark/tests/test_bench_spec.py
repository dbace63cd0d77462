"""BENCHMARK.json and the files it names: the contract's keys, names and
units, one file a configuration and a traffic mix, one reader a per-layer
metric, and a cell added by files alone."""
import importlib
import json
import os
import re
import shutil

import pytest

from benchmark.core.spec import BENCH, ROOT, load_cell, load_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    spec = load_spec()
    assert set(spec) == KEYS
    assert spec["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert spec["command"][1].startswith("benchmark/")
    assert 1 <= len(spec["command"]) <= 32
    assert 1 <= spec["run_seconds"] <= 51
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_units_and_entries():
    spec = load_spec()
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["traffic"] for w in spec["workloads"]]
    assert all(NAME.match(n) for n in names), names
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert {"xrt", "setup_s"} <= {m["name"] for m in spec["end_to_end"]}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [x["name"] for x in spec[group]]
        assert len(ns) == len(set(ns))


@pytest.mark.parametrize("cell", [w["name"] for w in load_spec()["workloads"]])
def test_every_cell_loads_with_its_readers(cell):
    c = load_cell(cell)
    assert c["config"]["entry"] in ("decode", "transcode")
    assert os.path.exists(os.path.join(BENCH, "paths",
                                       c["config"]["entry"] + ".py"))
    for name in c["traffic"]["content"]:
        assert os.path.exists(os.path.join(BENCH, "data", name))
    assert c["traffic"]["lanes"] % (2 * 8) == 0
    assert [m["name"] for m in c["end_to_end"]] == ["xrt", "setup_s"]
    assert c["per_layer"], "every cell reports a per-layer metric"
    for m in c["per_layer"]:
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(reader.read)


def test_every_config_file_is_one_configuration():
    spec = load_spec()
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A new traffic mix and a new cell in a copy of the checkout load with
    no edit to an existing harness file."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(BENCH, "configs"),
                    tmp_path / "benchmark" / "configs")
    shutil.copytree(os.path.join(BENCH, "traffic"),
                    tmp_path / "benchmark" / "traffic")
    with open(os.path.join(BENCH, "traffic", "raw-4096x16.json")) as f:
        mix = json.load(f)
    mix.update(name="raw-2048x32", lanes=2048, frames_per_chunk=32)
    with open(tmp_path / "benchmark" / "traffic" / "raw-2048x32.json",
              "w") as f:
        json.dump(mix, f)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="dec51-raw-2048x32",
                                  config="atsc51_448_dec_stereo",
                                  traffic="raw-2048x32", chips=1,
                                  why="a test cell"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = load_cell("dec51-raw-2048x32", root=str(tmp_path))
    assert c["traffic"]["lanes"] == 2048
    assert c["traffic"]["frames_per_chunk"] == 32
    assert c["config"]["entry"] == "decode"
    # every per-layer metric names the cells that report it
    assert c["per_layer"] == []
    with pytest.raises(KeyError):
        load_cell("no-such-cell", root=str(tmp_path))
