"""A whole run on the CPU at a small size (the card's look skipped): the
last line's keys, and the refusal to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchlib import spec
from tiny import TINY, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_result_line(name, run_module, capsys):
    cell = tiny_cell(name)
    result = run_module.measure(cell, 2**33 + 17, 0.2, False,
                                torch.device("cpu"), None)
    assert list(result) == KEYS  # the check's numbers come last
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = result["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["check"]) == set(cell.check["limits"])
    json.dumps(result, allow_nan=False)
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(result["check"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload",
         "ekf_mc.flagship", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout == ""


def test_harness_alone_gives_no_result(tmp_path):
    shutil.copytree(spec.HARNESS, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.SPEC_PATH, tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_harness_imports_no_jax_package():
    roots = ("jax", "tpuslam", "bench", "chip_smoke")
    for path in spec.HARNESS.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in roots, (path, line)
