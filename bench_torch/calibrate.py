"""Readings that set a cell's limits: the check's numbers of sound runs of
the program over many seeds, and of the control (the plain reference in
bfloat16 put in the program's place) on a few.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--traffic '{"steps": 40}'] [--cpu]

Each seed makes the calls a run keeps (``keep_within`` calls from the
start of its window, the last standing for the window's last) at the
cell's own sizes, in one process, and prints one JSON line.  The
benchmark's runs never run this.  ``--traffic`` and ``--check`` override
entries of the cell's files and ``--cpu`` runs on the CPU, for tests at a
small size.
"""

import argparse
import json
import pathlib
import sys
import time

HARNESS = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(HARNESS), str(HARNESS.parent)]

import torch  # noqa: E402

from benchlib import check, device, loop, spec  # noqa: E402

CONTROL = torch.bfloat16


def readings(cell, seed: int, dev: torch.device, control: bool) -> dict:
    driver = cell.driver().Driver(cell.config["scene"], cell.traffic,
                                  cell.check, seed, dev)
    for i in range(cell.check["keep_within"]):
        _, inp, out, _ = loop.one_call(driver, i)
        driver.keep(i, inp, out)
    items = driver.kept_items()
    line = {"seed": seed, "program": check.numbers(driver, items)}
    if control:
        line["control"] = check.numbers(driver, items, control=CONTROL)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--traffic", default="{}")
    ap.add_argument("--check", default="{}")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_spec(), args.workload)
    cell.traffic.update(json.loads(args.traffic))
    cell.check.update(json.loads(args.check))
    dev = torch.device("cpu") if args.cpu else device.require(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        line = readings(cell, seed, dev, seed in controls)
        if seed not in seeds:
            del line["program"]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
