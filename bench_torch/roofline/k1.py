"""K1 (``csrc/ekf_rollout.cu``, one launch a sweep): the least time for
``rollouts x steps`` fused EKF steps.

Counted from the plain arithmetic of a step (exp, log, sqrt and a divide
one operation each): 224 float32 operations for the filter, 32 for each of
the 2.5 Box-Muller transforms a step with noise on, and 12 for the NEES
where it is asked (the determinant 3, the cross term's sum and two
products 3, the square terms 2, the two combining adds 2, the divide and
the accumulate 2).  Integer work: Philox's 39 operations a call (a round
is two 32x32->64 products and two three-input XORs, less the first
round's product by the constant counter word), 1.5 calls a step, plus the
transforms' two shifts.  Bytes: 20 output floats a rollout and the
``(steps, 5)`` truth table read once.
"""

KERNEL = "ekf_rollout_kernel"


def least_s(traffic: dict, counts: dict, peaks: dict):
    """``(seconds, bound_by)`` of one launch."""
    b, n = traffic["rollouts"], traffic["steps"]
    f32 = 224 + (2.5 * 32 if traffic["noise"] else 0) + \
        (12 if traffic["nees"] else 0)
    i32 = (1.5 * 39 + 2.5 * 2) if traffic["noise"] else 0
    times = {"bytes": (80 * b + 20 * n) / peaks["hbm_bytes_per_s"],
             "f32 ops": f32 * b * n / peaks["f32_ops_per_s"],
             "int32 ops": i32 * b * n / peaks["int32_ops_per_s"]}
    by = max(times, key=times.get)
    return times[by], by
