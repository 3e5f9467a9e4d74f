"""K5b (``csrc/pf_wide.cu``, ``wide_stats_kernel``, one launch a step of
every wide filter): a firing filter's take of its slot's expanded rows,
the restart, predict, weight and each filter's normalizers and MAP.

Bytes, from the kernel's loads and stores: a particle's three rows read
(12; a firing filter reads its slot's expanded rows in their place, the
same 12) and its log weight (4, which a filter that restarts, a firing
one, does not read), the rows and the log weight written (16): 32 a
particle, 28 in a firing filter.  A filter's own: its observation (8 a
landmark, 40 for the scene's five), its fire and bad flags (2) and slot
(4) read, ``lse``, ``lse2`` and the estimate written (20), and the next
step's gate written (its bad and fire flags, 2, and its ESS, 4): 72.
Operations: 240 float32 a particle, the same per-particle math as K4
(``pf_math.cuh``'s ``predict_loglik_n`` and ``stats_add``, counted as
``roofline/k4.py`` counts them); a firing filter adds none here (its
resample ran in K5a and the expand).  The firing count comes from the
traced call."""

KERNEL = "wide_stats_kernel"


def least_s(traffic: dict, counts: dict, peaks: dict):
    b, n, steps = traffic["filters"], traffic["particles"], traffic["steps"]
    fired = counts.get("fired", 0) / steps
    times = {"bytes": (32 * b * n - 4 * fired * n + 72 * b)
             / peaks["hbm_bytes_per_s"],
             "f32 ops": 240 * b * n / peaks["f32_ops_per_s"]}
    by = max(times, key=times.get)
    return times[by], by
