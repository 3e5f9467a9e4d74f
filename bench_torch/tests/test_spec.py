"""Discovery by name: every configuration, traffic, cell, driver, metric
and kernel count is a file of its own, and a new cell is new files and a
new entry."""

import json
import shutil

import pytest
import torch

from benchlib import spec
from tiny import full_spec, tiny_cell

SPEC = spec.load_spec()


def test_every_name_has_its_file():
    for c in SPEC["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"] == f"bench_torch/configs/{c['name']}.json"
    for w in SPEC["workloads"]:
        cell = spec.Cell(SPEC, w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.driver(), "Driver")
        for m in cell.end_to_end:
            assert hasattr(cell.reader("end_to_end", m["name"]), "read")
        for m in cell.per_layer:
            assert hasattr(cell.reader("layer_metrics", m["name"]), "read")
    for kernel in ("k1", "k2b", "k4"):
        mod = spec.module("roofline", kernel)
        assert mod.KERNEL and callable(mod.least_s)


def test_cells_report_what_their_metrics_move():
    for w in SPEC["workloads"]:
        cell = spec.Cell(SPEC, w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Cell(SPEC, "no_such.cell")


def test_a_new_cell_is_new_files_and_an_entry(tmp_path, run_module):
    harness = tmp_path / "bench_torch"
    shutil.copytree(spec.HARNESS, harness,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in harness.rglob("*") if p.is_file()}
    traffic = dict(json.loads((harness / "traffic" / "sweep_8192.json")
                              .read_text()), rollouts=128, steps=24)
    (harness / "traffic" / "sweep_128.json").write_text(json.dumps(traffic))
    check = dict(json.loads((harness / "workloads" / "ekf_mc.sweep_8192.json")
                            .read_text()), sample=128, keep_within=2)
    (harness / "workloads" / "ekf_mc.sweep_128.json").write_text(
        json.dumps(check))
    new_spec = json.loads(json.dumps(SPEC))
    new_spec["workloads"].append({"name": "ekf_mc.sweep_128",
                                  "config": "ekf_mc", "traffic": "sweep_128",
                                  "chips": 1, "why": "a test cell"})
    for m in new_spec["end_to_end"] + new_spec["per_layer"]:
        if "ekf_mc.sweep_8192" in m.get("workloads", []):
            m["workloads"].append("ekf_mc.sweep_128")
    cell = spec.Cell(new_spec, "ekf_mc.sweep_128", harness=harness)
    result = run_module.measure(cell, 7, 0.2, False, torch.device("cpu"),
                                None)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"call_ms_p95", "setup_s"}
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_tiny_cells_are_the_real_cells_resized():
    for name in ("ekf_mc.flagship", "pf_loc.single_2m"):
        cell = tiny_cell(name)
        assert cell.traffic["driver"] == spec.Cell(full_spec(), name).traffic[
            "driver"]
