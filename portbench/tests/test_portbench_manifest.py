"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks for it."""

import json
import re

import pytest

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    return common.manifest()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and LINE.match(m["layer"])
        assert m["moves"] in e2e


def test_every_moved_metric_is_reported_where_it_is_read(bench):
    """A per-layer metric's `moves` is an end-to-end metric of each cell
    the per-layer metric lists."""
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            cell = common.cell(w, bench)
            assert m["moves"] in [e["name"] for e in cell["end_to_end"]], \
                (m["name"], w)


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = common.cell(w["name"], bench)
        e2e = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]


def test_files_the_harness_finds_by_name(bench):
    for m in bench["per_layer"]:
        assert (common.HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        cell = common.cell(w["name"], bench)
        cfg = cell["config"]
        assert (common.HERE / "models" / f"{cfg['model']}.py").is_file()
        entry = common.HERE / "traffic" / f"{cell['traffic']['entry']}.py"
        assert entry.is_file()
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    for c in bench["configs"]:
        assert common.load_json(common.ROOT / c["file"])["name"] == c["name"]


def test_layers_are_named_alike(bench):
    """Metrics of one layer give one name, letter for letter."""
    by_layer = {}
    for m in bench["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("mix,refused", [
    ({"entry": "image", "why": "x"}, False),
    ({"entry": "conv", "inputs_per_layer": 2, "why": "x"}, False),
    ({"entry": "image", "loop": "open", "why": "x"}, True),
    ({"entry": "conv", "inputs_per_layer": 2, "clients": 4, "why": "x"}, True),
    ({"entry": "../run", "why": "x"}, True)])
def test_traffic_entry_found_by_name(mix, refused):
    """A mix's entry is the module ``traffic/<entry>.py``; a key the
    entry does not read is refused, not ignored."""
    from portbench import load
    if refused:
        with pytest.raises(SystemExit):
            load.entry(None, mix, None)
    else:
        e = load.entry(None, mix, None)
        assert type(e).__module__ == f"portbench.traffic.{mix['entry']}"
