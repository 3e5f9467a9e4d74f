"""The benchmark of the PyTorch/CUDA port (``tpuslam_torch``) on one card.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(imports, the CUDA context, the kernel library, one warm-up call at the
cell's shape), then a closed loop of calls for ``--seconds``, then the
check of the kept calls' answers against the plain reference
(``reference/``).  ``--trace 1`` adds a profiled segment of calls after the
window and reports the cell's per-layer metrics in place of its end-to-end
ones.  The last line of standard output is one JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error and the result's last key.  Without as many CUDA devices as the cell
asks for it prints no result and exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HARNESS = pathlib.Path(__file__).resolve().parent
ROOT = HARNESS.parent
sys.path[:0] = [str(HARNESS), str(ROOT)]

# Every cache a build or a compiler keeps goes to a fixed place inside the
# checkout (the program's own library builds into <checkout>/build).
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import torch  # noqa: E402

from benchlib import check, device, loop, spec, trace  # noqa: E402

T_IMPORTS = time.perf_counter()

EXIT_NO_DEVICE = 3


class Context:
    """What a metric's reader may read."""

    def __init__(self, cell, driver, win, setup_s, seg, counts, power_w):
        self.cell, self.traffic = cell, cell.traffic
        self.work_per_call = driver.work_per_call
        self.records, self.window_s = win.records, win.window_s
        self.setup_s, self.trace, self.counts = setup_s, seg, counts
        self.power_w = power_w
        self.shares: list[str] = []

    def roofline_share(self, kernel: str):
        """A kernel's least time over its mean launch time in the traced
        segment, in percent; None where the segment ran no such launch."""
        mod = self.cell.reader("roofline", kernel)
        times = self.trace.kernel_times(mod.KERNEL) if self.trace else []
        if not times:
            return None
        least, by = mod.least_s(self.traffic, self.counts, device.PEAKS)
        mean = sum(times) / len(times)
        share = 100.0 * least / mean
        self.shares.append(
            f"{kernel}: {share:.3f}% of the H100's published peak (bound by "
            f"{by}: {1e3 * least:.4f} ms; mean launch {1e3 * mean:.4f} ms "
            f"over {len(times)}); card power limit {self.power_w} W against "
            f"the peaks' {device.PEAKS['power_w']:.0f} W")
        return share


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def measure(cell, seed: int, seconds: float, traced: bool,
            dev: torch.device, power_w) -> dict:
    """One run of ``cell`` on ``dev``: set-up, the window, the traced
    segment where asked, the metrics and the check.  Returns the result
    line's object."""
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    driver = cell.driver().Driver(cell.config["scene"], cell.traffic,
                                  cell.check, seed, dev)
    t1 = time.perf_counter()
    driver.readback(driver.entry(driver.warmup_inputs()))
    if on_card:
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    setup_s = t2 - T_START
    build_s = getattr(sys.modules.get("tpuslam_torch.ops._build"),
                      "build_seconds", None)
    print(f"setup {setup_s:.3f} s: imports {T_IMPORTS - T_START:.3f}, "
          f"device check {t0 - T_IMPORTS:.3f}, the program's import and the "
          f"driver {t1 - t0:.3f}, the warm-up call {t2 - t1:.3f} (the "
          f"kernel library's build {build_s} s in it)", file=sys.stderr)

    win = loop.window(driver, seconds)
    items = driver.kept_items()
    seg, counts = None, {}
    if traced:
        first, last = len(win.records), []

        def call(j):
            last[:] = [loop.one_call(driver, first + j, spans=True)[2]]

        seg = trace.record(call, cell.check["trace_calls"])
        counts = driver.counts(last.pop())
    mem_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    ctx = Context(cell, driver, win, setup_s, seg, counts, power_w)
    kind = "layer_metrics" if traced else "end_to_end"
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cell.reader(kind, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    for line in ctx.shares:
        print(line, file=sys.stderr)

    t_check = time.perf_counter()
    correct, held = check.judge(check.numbers(driver, items),
                                cell.check["limits"])
    print(f"check of {len(items)} kept calls against the reference: "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    dev_info = device.describe(cell.chips) if on_card else {
        "platform": dev.type, "kind": "cpu", "count": 0}
    dev_info["memory_peak_bytes"] = mem_peak
    result = {"correct": correct, "attempted": len(win.records),
              "failed": win.failed, "metrics": metrics, "device": dev_info}
    if seg is not None:
        dev_info["busy_s"] = seg.busy_s
        dev_info["window_s"] = seg.window_s
        result["breakdown"] = seg.breakdown()
    result["check"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                       for k, v in held.items()}
    for name, h in result["check"].items():
        print(f"check {name} {h['value']!r} limit {h['limit']!r}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.Cell(spec.load_spec(), args.workload)
    try:
        dev = device.require(cell.chips)
    except device.NoDevice as exc:
        print(f"no result: {exc}", file=sys.stderr)
        return EXIT_NO_DEVICE
    power_w = device.power_limit_w()
    peaks = device.PEAKS
    print(f"device {torch.cuda.get_device_name(0)}, power limit {power_w} W; "
          f"published H100 peaks at {peaks['power_w']:.0f} W: float32 "
          f"{peaks['f32_ops_per_s']:.3e} op/s, HBM "
          f"{peaks['hbm_bytes_per_s']:.3e} B/s, int32 "
          f"{peaks['int32_ops_per_s']:.3e} op/s", file=sys.stderr)
    print(json.dumps(measure(cell, args.seed, args.seconds, bool(args.trace),
                             dev, power_w)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
