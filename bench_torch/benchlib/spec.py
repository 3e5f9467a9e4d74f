"""Find a cell's data and code by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell, driver,
metric or kernel count is a file of its own under the harness directory,
named after it:

* ``configs/<config>.json`` - a configuration: the scene as it is run;
* ``traffic/<traffic>.json`` - a traffic mix: the driver it calls and the
  sizes of one call;
* ``workloads/<cell>.json`` - a cell's check: how many calls it keeps,
  how many answers of each it compares, the limits, the traced calls;
* ``drivers/<driver>.py`` - set-up and one call of an entry path, and the
  comparison of its answers with the plain reference: a class
  ``Driver(scene, traffic, check, seed, device)`` (set-up) with
  ``work_per_call``, ``inputs(i)`` and ``warmup_inputs()`` (a call's
  inputs from the seed), ``entry(inputs)`` (the program's entry, the timed
  call), ``readback(outputs)`` (the call's result on the host, a list of
  floats), ``counts(outputs)`` (data-dependent work for the rooflines),
  ``keep``/``kept_items`` (:class:`benchlib.keep.KeptCalls`), and
  ``answer(item)``, ``reference(item, dtype)``, ``compare(got, want)``
  (:mod:`benchlib.check`);
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py`` - a
  metric's reader: ``read(ctx)`` returns the value or None;
* ``roofline/<kernel>.py`` - a kernel's least time on the card.

A later cell, configuration or metric is new files and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import types

HARNESS = pathlib.Path(__file__).resolve().parent.parent
ROOT = HARNESS.parent
SPEC_PATH = ROOT / "BENCHMARK.json"


def load_spec(path: pathlib.Path = SPEC_PATH) -> dict:
    return json.loads(path.read_text())


def _json(kind: str, name: str, harness: pathlib.Path) -> dict:
    path = harness / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def module(kind: str, name: str,
           harness: pathlib.Path = HARNESS) -> types.ModuleType:
    """Load ``<kind>/<name>.py`` (names may hold dots) as a module."""
    path = harness / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its files and its metrics."""

    def __init__(self, spec: dict, name: str,
                 harness: pathlib.Path = HARNESS):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(entries)}")
        self.name, self.harness = name, harness
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = _json("configs", self.entry["config"], harness)
        self.traffic = _json("traffic", self.entry["traffic"], harness)
        self.check = _json("workloads", name, harness)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def driver(self) -> types.ModuleType:
        return module("drivers", self.traffic["driver"], self.harness)

    def reader(self, kind: str, metric: str) -> types.ModuleType:
        return module(kind, metric, self.harness)
