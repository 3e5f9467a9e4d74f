"""K2b (``csrc/pf_step.cu``, one launch a step of the single filter):
predict, the landmark log-likelihood and the step's reductions of ``n``
particles.  Bytes: the three particle rows and the log weights read and
written once (32 a particle), the observation and the statistics row
(80).  Operations: 240 float32 a particle (``_predict_loglik``'s
arithmetic with five landmarks and the reductions' five; Philox left out,
the bytes bound the kernel)."""

KERNEL = "pf_step_kernel"


def least_s(traffic: dict, counts: dict, peaks: dict):
    n = traffic["particles"]
    times = {"bytes": (32 * n + 80) / peaks["hbm_bytes_per_s"],
             "f32 ops": 240 * n / peaks["f32_ops_per_s"]}
    by = max(times, key=times.get)
    return times[by], by
