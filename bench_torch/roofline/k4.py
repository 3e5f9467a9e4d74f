"""K4 (``csrc/pf_batch.cu``, one launch a step of every filter): the gate,
the resample of the firing filters, predict, weight and each filter's
normalizers and MAP.  Bytes: rows and log weights read and written once
(32 a particle) and 80 a filter (observation, normalizers, estimate,
flags).  Operations: 240 float32 a particle, and 10 more a particle of a
firing filter (exp, shift, scale, round, the boundary law's two
multiplies, subtract, ceil and clip), from the traced call's firing
count."""

KERNEL = "pf_batch_kernel"


def least_s(traffic: dict, counts: dict, peaks: dict):
    b, n, steps = traffic["filters"], traffic["particles"], traffic["steps"]
    fired = counts.get("fired", 0) / steps
    times = {"bytes": (32 * b * n + 80 * b) / peaks["hbm_bytes_per_s"],
             "f32 ops": (240 * b * n + 10 * fired * n)
             / peaks["f32_ops_per_s"]}
    by = max(times, key=times.get)
    return times[by], by
