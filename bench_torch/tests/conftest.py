"""CPU tests of the harness: ``python -m pytest bench_torch/tests`` from the
root of the repository.  They run the program's plain paths on the CPU at
small sizes; no number they produce is a device measurement."""

import importlib.util
import pathlib
import sys

import pytest
import torch

HARNESS = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HARNESS), str(HARNESS.parent)]


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="session")
def run_module():
    path = HARNESS / "run.py"
    mod_spec = importlib.util.spec_from_file_location("bench_run", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
