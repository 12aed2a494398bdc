"""``BENCHMARK.json`` against the contract it is checked by, and discovery
by name: every file a cell needs is found from its names, and a new cell
needs new files and manifest entries only."""

import json
import re
import shutil

import pytest

from benchmark import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|"
                   r"head|expansion|width|features|per_token)")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (harness.ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    assert all(_line(w) for w in M["command"])
    assert len(json.dumps(M)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in M["configs"]] + \
        [w["name"] for w in M["workloads"]] + \
        [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len({w["name"] for w in M["workloads"]}) == len(M["workloads"])
    assert len({c["name"] for c in M["configs"]}) == len(M["configs"])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for m in M["per_layer"]:
        assert _line(m["layer"])


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(M["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)
        with open(harness.ROOT / c["file"]) as f:
            body = json.load(f)
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert all(k in body for k in c["reduced"])


def test_cells():
    ws = M["workloads"]
    assert 1 <= len(ws) <= 24
    pairs = {(w["config"], w["traffic"]) for w in ws}
    assert len(pairs) == len(ws)
    four = [w for w in ws if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in ws)
    assert len(four) <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}


def test_metrics():
    e2e = M["end_to_end"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(M["per_layer"]) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in e2e if e["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_setup_another_metric_and_a_layer(workload):
    cell = harness.find_cell(workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    harness.load_generator(cell.traffic["load"])
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_is_new_files_and_entries_only(tmp_path):
    """A copy of the benchmark's tree with one more traffic file and one
    more workload entry: the new cell is found, and the old ones are as
    they were."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(M))
    manifest["workloads"].append({
        "name": "lite.serve.b8", "config": "dbsr_lite",
        "traffic": "direct.b8.slow", "chips": 1,
        "why": "the flagship called directly"})
    e2e = next(m for m in manifest["end_to_end"]
               if m["name"] == "serve_bursts_per_s")
    e2e["workloads"].append("lite.serve.b8")
    for m in manifest["per_layer"]:
        if m["moves"] == "serve_bursts_per_s":
            m["workloads"].append("lite.serve.b8")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((harness.HERE / "traffic" / "direct.b8.json")
                         .read_text())
    traffic["batch_size"] = 4
    (root / "benchmark" / "traffic" / "direct.b8.slow.json").write_text(
        json.dumps(traffic))
    (root / "benchmark" / "limits" / "lite.serve.b8.json").write_text(
        json.dumps({"worst_rel_l2": 0.06}))
    new = harness.find_cell("lite.serve.b8", root=root)
    assert new.traffic["batch_size"] == 4 and new.config["net"]["flow_net"] \
        == "lite"
    assert {m["name"] for m in new.end_to_end} == {"serve_bursts_per_s",
                                                   "setup_s"}
    assert "serve.mfu" in {m["name"] for m in new.per_layer}
    assert new.limits == {"worst_rel_l2": 0.06}
    for w in M["workloads"]:
        old = harness.find_cell(w["name"])
        assert harness.find_cell(w["name"], root=root).traffic == old.traffic


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_every_cell_has_a_limit_for_each_number_it_compares(workload):
    cell = harness.find_cell(workload)
    want = {"train": {"pred_gap", "loss_gap", "grad_gap",
                      "grad_median_gap", "change_gap", "pool_gap",
                      "batch_gap"},
            "direct": {"worst_rel_l2"}, "http": {"worst_rel_l2"}}
    assert set(cell.limits) == want[cell.traffic["load"]]
    assert all(0 < v < 1 for v in cell.limits.values())


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no.such.cell")
