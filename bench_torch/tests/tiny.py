"""The cells at sizes the CPU runs in seconds."""

from benchlib import spec

#: Each cell's traffic and check at a size the CPU runs in seconds.  The
#: PF rollouts are long enough for the bfloat16 control to lose the robot,
#: as it does at the cells' sizes.
TINY = {
    "ekf_mc.flagship": ({"rollouts": 512, "steps": 64},
                        {"sample": 512, "keep_within": 3}),
    "ekf_mc.sweep_8192": ({"rollouts": 256, "steps": 40},
                          {"sample": 256, "keep_within": 3}),
    "pf_loc.single_2m": ({"particles": 2048, "steps": 60},
                         {"keep_within": 3}),
    "pf_loc.batched_8192x1000": ({"filters": 16, "particles": 256,
                                  "steps": 60},
                                 {"sample": 16, "keep_within": 3}),
}


#: A cell whose files are in the harness and whose entry waits for a later
#: PR (PERF.md, Open questions): its host-bound rate spreads past any bound
#: the benchmark may set.
LATER = {"name": "pf_loc.single_2m", "config": "pf_loc",
         "traffic": "single_2m", "chips": 1,
         "why": "one filter of 2,097,152 particles x 400 steps a call"}


def full_spec() -> dict:
    """``BENCHMARK.json`` with the waiting cell's entry added, as a later
    PR would add it: the entry and the cell in its metrics' lists."""
    s = spec.load_spec()
    s["workloads"].append(LATER)
    for m in s["end_to_end"] + s["per_layer"]:
        if m["name"] in ("pf_particle_steps_per_s", "call_ms_p95",
                         "device.idle_pct.pf"):
            m["workloads"].append(LATER["name"])
    for name, moves in (("pf_cuda.host_us_per_step", "pf_particle_steps_per_s"),
                        ("k2b_roofline", "pf_particle_steps_per_s"),
                        ("resample.device_us_per_step",
                         "pf_particle_steps_per_s")):
        s["per_layer"].append({"name": name, "unit": "us", "better": "lower",
                               "source": "host_clock", "layer": "later",
                               "moves": moves,
                               "workloads": [LATER["name"]]})
    return s


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.Cell(full_spec(), name)
    traffic, check = TINY[name]
    cell.traffic.update(traffic)
    cell.check.update(check)
    return cell
