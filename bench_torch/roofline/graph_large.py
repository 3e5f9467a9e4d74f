"""The large solve's least time a call (``slam/tridiag.py``'s Thomas
chain, batched over the call's scenes), from the traced call's counts:
``scenes``, ``resolves`` (the GN iterations the scenes needed, summed),
``super_blocks`` (N) and ``block`` (M = 3 x the super-block's poses).

Factor, once a scene: each super-block's step as the chain computes it,
with general products: ``w = inv @ u`` and ``u^T w`` (2 M^3 each), the
Cholesky (M^3 / 3), the triangular solve against the identity (M^3) and
``li^T li`` (2 M^3): 22/3 M^3 float32 operations; it reads the diagonal
and coupling blocks and writes ``invs`` and ``ws`` (16 M^2 bytes).
Resolve, once a GN iteration of a scene: ``invs``, ``ws`` and ``up`` read
once (12 M^2 bytes a super-block, 43.2 MB a scene at M = 120, N = 250)
and 6 M^2 operations.  Each phase takes the larger of its operations and
bytes over the peaks; the call the sum of its phases."""


def least_s(traffic: dict, counts: dict, peaks: dict):
    n, m = counts["super_blocks"], counts["block"]
    f32, hbm = peaks["f32_ops_per_s"], peaks["hbm_bytes_per_s"]
    factor = n * max(22 / 3 * m**3 / f32, 16 * m**2 / hbm)
    resolve = n * max(6 * m**2 / f32, 12 * m**2 / hbm)
    return (counts["scenes"] * factor + counts["resolves"] * resolve,
            "factor f32 ops, resolve bytes")
