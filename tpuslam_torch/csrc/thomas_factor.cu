// K6: the block-Thomas factor's step chain, one launch a factor.
//
// Replaces no Pallas kernel.  The JAX package leaves this chain to
// jnp.linalg.cholesky and triangular_solve in
// tpuslam/slam/tridiag.py::block_thomas_factor, and the port's plain
// chain (slam/tridiag.py::block_thomas_factor_plain) to cuSOLVER's batched
// Cholesky, cuBLAS's batched triangular solve and products: about 40
// launches a step, each rereading its matrices from device memory, at
// about 3% of the chain's bound on an H100 (PERF.md).  K6 was added for
// that.
//
// What it computes, for each batch matrix b and step k = 0 .. N-1 (the
// reference's algebra, in its order, float32 with FMA; no TF32):
//   W   = I_{k-1} U_{k-1}            -> ws[k, b]   (0 at k = 0)
//   S   = D_k - U_{k-1}^T W
//   S   = 0.5 (S + S^T)
//   L   = chol(S), lower
//   X   = L^{-1}
//   I_k = X^T X                      -> invs[k, b]
// with D_k = diag[k, b], U_{k-1} = upper[k-1, b] and I_{-1} = eye.  Where a
// pivot of the Cholesky is not positive (or is NaN) the step's I_k is NaN,
// as the plain chain's cholesky_nan gives it, and every later step of that
// matrix follows from it; the other matrices are untouched.
//
// What bounds it on an H100: float32 operations.  The chain needs 4 M^3
// of them a step and matrix (W 2 M^3, the lower half of S M^3, the
// Cholesky, the triangular inverse and the lower half of X^T X M^3 / 3
// each), so the cell's factor (N = 250, 32 matrices of M = 120) is 55.3
// GFLOP, 0.83 ms at 67 TFLOP/s.  K6 does 5 M^3 a step (all of S: 1.03
// ms); the benchmark's roofline counts the plain chain's general products,
// 22/3 M^3 (1.51 ms).  Its bytes (the D and U blocks read, W and I
// written: 0.55 ms) are not the bound.  The steps of one matrix are
// sequential, so only 32 chains run side by side, and a step's Cholesky
// and inverse are a chain of 120 dependent pivots: latency, not rate.
//
// What the design does about that:
//   * one launch runs the whole chain: each batch matrix is owned by one
//     thread-block cluster of C CTAs, which walks the N steps in a loop.
//     The wrapper picks C (1 .. 8) as the most whose clusters for the
//     whole batch are resident at once, as the card reports it
//     (tpuslam_thomas_clusters): an H100 holds 39 clusters of 3 CTAs at
//     M = 120 but only 30 of 4, as clusters stay within a GPC, so the
//     cell's 32 matrices take 3 (96 CTAs) and one matrix 8;
//   * the state stays on chip: the previous Schur inverse I lives in every
//     CTA's shared memory from one step to the next and never makes a
//     round trip through device memory; U is brought in by cp.async during
//     the previous step's last product, D is loaded into registers before
//     the product that needs it;
//   * the products are split by columns: CTA j computes its share of the
//     columns of W and S (the column tiles [j T / C, (j+1) T / C) of T = M/4
//     tiles; 8 x 4 outputs a thread) and its share of the 4x4 tiles of the
//     lower half of X^T X, each a register-tiled FMA loop over shared
//     memory (sums in k order, one accumulator each);
//   * S is gathered into every CTA of the cluster through distributed
//     shared memory, each CTA's slab written into the others' S buffers at
//     its own columns (which they do not read), and the Cholesky and the
//     triangular inverse (about 1.2 MFLOP, bound by latency) run
//     redundantly in every CTA: that costs less than exchanging L.  They
//     are one blocked right-looking pass over 8-column panels: one thread
//     factors a panel's 8x8 diagonal block in registers, ahead, while the
//     other warps finish the previous panel's trailing update; the rows
//     below it and the panel's rows of X are forward substitutions, one
//     thread a row or column; the trailing update takes S's trailing lower
//     half and X's rows below the panel at once, in 4x4 tiles (two CTA
//     barriers a panel);
//   * I_k is written as its lower half and its mirror, to every CTA's I
//     buffer and to invs, so X^T X's two halves are equal bit for bit;
//   * two cluster barriers a step, and no atomics: equal inputs give equal
//     bits, whatever the launch.
// 256 threads a CTA; shared memory holds three M x (M + 4) float buffers
// (I; U and S, which swap each step, X taking U's place once U is read)
// and the panel's columns of L, transposed (8 x M): 182.5 KB at M = 120.
// M must be a multiple of kPanel, at most kMaxM (ops/thomas_cuda.py
// borders a chain up to a multiple of kPanel, and holds MAX_M, PANEL and
// MAX_CLUSTER to kMaxM, kPanel and kMaxCluster).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 8;
constexpr int kMaxM = 128;
// The largest cluster: the portable limit.
constexpr int kMaxCluster = 8;
// Rows of a thread's tile of W and S (its columns: 4).
constexpr int kRows = 8;
// The most S tiles a thread holds: (kMaxM / kRows) (kMaxM / 4) tiles over
// kThreads.
constexpr int kMaxHeld = (kMaxM / kRows) * (kMaxM / 4) / kThreads;
// Floats of scratch before the buffers: the panel's reciprocal pivots (8)
// and the failed-pivot flag, padded to keep the buffers 16-byte aligned.
constexpr int kScratch = 16;

__host__ __device__ constexpr int stride_of(int m) { return m + 4; }

// The scratch, the panel's columns of L below it, transposed (kPanel x m),
// and the three m x (m + 4) buffers.
size_t smem_bytes(int m) {
  return (static_cast<size_t>(3) * m * stride_of(m) + kPanel * m +
          kScratch) *
         sizeof(float);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ int tri(int x) { return x * (x + 1) / 2; }

// The row of tile g in a lower-triangular tile order (row t holds tiles
// tri(t) .. tri(t) + t).
__device__ __forceinline__ int tri_row(int g) {
  int t = static_cast<int>((sqrtf(8.0f * g + 1.0f) - 1.0f) * 0.5f);
  while (tri(t + 1) <= g) ++t;
  while (tri(t) > g) --t;
  return t;
}

// Copy an m x m row-major matrix from device memory into shared memory of
// row stride ld, asynchronously; one commit group.
__device__ void load_async(float* dst, const float* src, int m, int ld) {
  const int q = m / 4;
  for (int i = threadIdx.x; i < m * q; i += kThreads) {
    const int r = i / q;
    const int c = 4 * (i - r * q);
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + r * m + c));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[a][b] += sum_{k = k0}^{k1 - 1} A[k][r0 + a] B[k][c0 + b]: an R x 4
// tile of A^T B, both row-major in shared memory with stride ld.
template <int R>
__device__ __forceinline__ void atb(float (&acc)[R][4], const float* A,
                                    const float* B, int ld, int r0, int c0,
                                    int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float av[R];
#pragma unroll
    for (int h = 0; h < R; h += 4) {
      const float4 a = ld4(A + k * ld + r0 + h);
      av[h] = a.x;
      av[h + 1] = a.y;
      av[h + 2] = a.z;
      av[h + 3] = a.w;
    }
    const float4 b = ld4(B + k * ld + c0);
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

// One thread: the lower Cholesky factor of the 8x8 block of T at (c0, c0),
// in place, in registers; its reciprocal pivots (1 / L_jj, L_jj = piv x
// rsqrtf(piv), within 2 ulp of the IEEE root: the short MUFU sequence, as
// the pivots are the chain's critical path) into rdiag, and *bad = 1 where
// a pivot is not positive.
__device__ void factor_diag(float* T, int ld, int c0, float* rdiag,
                            int* bad) {
  float a[kPanel][kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    const float4 lo = ld4(T + (c0 + i) * ld + c0);
    const float4 hi = ld4(T + (c0 + i) * ld + c0 + 4);
    a[i][0] = lo.x;
    a[i][1] = lo.y;
    a[i][2] = lo.z;
    a[i][3] = lo.w;
    a[i][4] = hi.x;
    a[i][5] = hi.y;
    a[i][6] = hi.z;
    a[i][7] = hi.w;
  }
  bool fail = false;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float piv = a[j][j];
    fail |= !(piv > 0.0f);
    const float r = rsqrtf(piv);
    a[j][j] = __fmul_rn(piv, r);
    rdiag[j] = r;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) a[i][j] = __fmul_rn(a[i][j], r);
#pragma unroll
    for (int q = j + 1; q < kPanel; ++q) {
#pragma unroll
      for (int i = q; i < kPanel; ++i) {
        a[i][q] = __fmaf_rn(-a[i][j], a[q][j], a[i][q]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) T[(c0 + i) * ld + c0 + j] = a[i][j];
  }
  if (fail) *bad = 1;
}

// Row r below the panel: L's row r over the panel, x L_pp^T = t by forward
// substitution on T[r][c0 .. c0 + 8), into P[j][r] (P transposes the
// panel's columns of L, so the trailing update reads them as rows).
__device__ void row_solve(const float* T, float* P, int ld, int m, int c0,
                          int r, const float* rdiag) {
  const float* row = T + r * ld + c0;
  const float4 lo = ld4(row);
  const float4 hi = ld4(row + 4);
  float x[kPanel] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float* lj = T + (c0 + j) * ld + c0;
    float acc = x[j];
#pragma unroll
    for (int q = 0; q < j; ++q) acc = __fmaf_rn(-x[q], lj[q], acc);
    x[j] = __fmul_rn(acc, rdiag[j]);
  }
  // Stored after the substitution, so that no store stands between its
  // loads of L_pp and the arithmetic.
#pragma unroll
  for (int j = 0; j < kPanel; ++j) P[j * m + r] = x[j];
}

// Column s of X's panel rows: X[c0 .. c0 + 8)[s] becomes L_pp^{-1} of
// itself by forward substitution.
__device__ void col_solve(const float* T, float* X, int ld, int c0, int s,
                          const float* rdiag) {
  float x[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) x[j] = X[(c0 + j) * ld + s];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float* lj = T + (c0 + j) * ld + c0;
    float acc = x[j];
#pragma unroll
    for (int q = 0; q < j; ++q) acc = __fmaf_rn(-lj[q], x[q], acc);
    x[j] = __fmul_rn(acc, rdiag[j]);
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) X[(c0 + j) * ld + s] = x[j];
}

// The trailing update of tile (rt, ct) below panel [c0, c1): rows r0 .. r0
// + 4 of S's lower half (s0 >= c1: minus L_r L_s^T over the panel) or of X
// (s0 < c1: minus L_r X_p over the panel), L's rows read from P.
__device__ void trailing_tile(float* T, float* X, const float* P, int ld,
                              int m, int c0, int c1, int rt, int ct) {
  const int r0 = 4 * rt;
  const int s0 = 4 * ct;
  float* dst = s0 >= c1 ? T : X;
  float u[4][4];
  float l[4][kPanel];
  float v[4][kPanel];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 w = ld4(dst + (r0 + a) * ld + s0);
    u[a][0] = w.x;
    u[a][1] = w.y;
    u[a][2] = w.z;
    u[a][3] = w.w;
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float4 p = ld4(P + j * m + r0);
    l[0][j] = p.x;
    l[1][j] = p.y;
    l[2][j] = p.z;
    l[3][j] = p.w;
    const float4 q = s0 >= c1 ? ld4(P + j * m + s0)
                              : ld4(X + (c0 + j) * ld + s0);
    v[0][j] = q.x;
    v[1][j] = q.y;
    v[2][j] = q.z;
    v[3][j] = q.w;
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        u[a][b] = __fmaf_rn(-l[a][j], v[b][j], u[a][b]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    st4(dst + (r0 + a) * ld + s0, make_float4(u[a][0], u[a][1], u[a][2],
                                              u[a][3]));
  }
}

// Tile (rt, ct) of S's lower half, rt >= ct: 0.5 (S + S^T), strictly below
// the diagonal; the upper half stays S's.
__device__ void symmetrize_tile(float* S, int ld, int rt, int ct) {
  float lo[4][4];
  float up[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 x = ld4(S + (4 * rt + a) * ld + 4 * ct);
    const float4 y = ld4(S + (4 * ct + a) * ld + 4 * rt);
    lo[a][0] = x.x;
    lo[a][1] = x.y;
    lo[a][2] = x.z;
    lo[a][3] = x.w;
    up[a][0] = y.x;
    up[a][1] = y.y;
    up[a][2] = y.z;
    up[a][3] = y.w;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (rt != ct || a > b) {
        lo[a][b] = __fmul_rn(0.5f, __fadd_rn(lo[a][b], up[b][a]));
      }
    }
    st4(S + (4 * rt + a) * ld + 4 * ct, make_float4(lo[a][0], lo[a][1],
                                                    lo[a][2], lo[a][3]));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    thomas_factor_kernel(const float* __restrict__ diag,
                         const float* __restrict__ upper,
                         float* __restrict__ invs, float* __restrict__ ws,
                         int n, int batch, int m) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int mat = blockIdx.x / csize;
  const int ld = stride_of(m);
  const int nt = m / 4;
  const size_t mm = static_cast<size_t>(m) * m;
  float* rdiag = smem;
  int* bad = reinterpret_cast<int*>(smem + kPanel);
  float* panel = smem + kScratch;
  float* buf_i = panel + kPanel * m;
  // U and S swap each step; X takes U's buffer once U is read.
  float* bu = buf_i + m * ld;
  float* bs = bu + m * ld;
  // This CTA's column tiles of W and S.
  const int ct0 = nt * rank / csize;
  const int ncols = nt * (rank + 1) / csize - ct0;
  const int nslab = (m / kRows) * ncols;
  if (threadIdx.x == 0) *bad = 0;
  // Every CTA of the cluster runs before any writes into another's shared
  // memory.
  cluster.sync();

  for (int k = 0; k < n; ++k) {
    const size_t at = (static_cast<size_t>(k) * batch + mat) * mm;
    wait_async();
    __syncthreads();

    // W = I U for this CTA's columns: into bs (its columns) and ws[k].
    for (int t = threadIdx.x; t < nslab; t += kThreads) {
      const int r0 = kRows * (t / ncols);
      const int c0 = 4 * (ct0 + t % ncols);
      float acc[kRows][4] = {};
      if (k > 0) atb(acc, buf_i, bu, ld, r0, c0, 0, m);
#pragma unroll
      for (int a = 0; a < kRows; ++a) {
        const float4 v = make_float4(acc[a][0], acc[a][1], acc[a][2],
                                     acc[a][3]);
        st4(bs + (r0 + a) * ld + c0, v);
        st4(ws + at + (r0 + a) * m + c0, v);
      }
    }
    __syncthreads();

    // S = D - U^T W for the same columns, held until every thread has
    // read W, then written into every CTA's bs at these columns.
    float held[kMaxHeld][kRows][4];
#pragma unroll
    for (int h = 0; h < kMaxHeld; ++h) {
      const int t = threadIdx.x + h * kThreads;
      if (t < nslab) {
        const int r0 = kRows * (t / ncols);
        const int c0 = 4 * (ct0 + t % ncols);
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
          const float4 d = __ldg(reinterpret_cast<const float4*>(
              diag + at + (r0 + a) * m + c0));
          held[h][a][0] = d.x;
          held[h][a][1] = d.y;
          held[h][a][2] = d.z;
          held[h][a][3] = d.w;
        }
        float acc[kRows][4] = {};
        if (k > 0) atb(acc, bu, bs, ld, r0, c0, 0, m);
#pragma unroll
        for (int a = 0; a < kRows; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            held[h][a][b] = __fsub_rn(held[h][a][b], acc[a][b]);
          }
        }
      }
    }
    __syncthreads();
    for (int q = 0; q < csize; ++q) {
      float* dst = cluster.map_shared_rank(bs, q);
#pragma unroll
      for (int h = 0; h < kMaxHeld; ++h) {
        const int t = threadIdx.x + h * kThreads;
        if (t < nslab) {
          const int r0 = kRows * (t / ncols);
          const int c0 = 4 * (ct0 + t % ncols);
#pragma unroll
          for (int a = 0; a < kRows; ++a) {
            st4(dst + (r0 + a) * ld + c0,
                make_float4(held[h][a][0], held[h][a][1], held[h][a][2],
                            held[h][a][3]));
          }
        }
      }
    }
    cluster.sync();

    // Symmetrize S's lower half; X = eye in U's buffer.
    for (int g = threadIdx.x; g < tri(nt); g += kThreads) {
      const int rt = tri_row(g);
      symmetrize_tile(bs, ld, rt, g - tri(rt));
    }
    for (int i = threadIdx.x; i < m * nt; i += kThreads) {
      const int r = i / nt;
      const int q = i - r * nt;
      const int d = r - 4 * q;
      st4(bu + r * ld + 4 * q,
          make_float4(d == 0 ? 1.0f : 0.0f, d == 1 ? 1.0f : 0.0f,
                      d == 2 ? 1.0f : 0.0f, d == 3 ? 1.0f : 0.0f));
    }
    __syncthreads();

    // L = chol(S) in bs and X = L^{-1} in bu, panel by panel.  Each
    // panel's diagonal block is factored ahead, by warp 0, while the other
    // warps finish the previous panel's trailing update.
    if (threadIdx.x == 0) factor_diag(bs, ld, 0, rdiag, bad);
    __syncthreads();
    for (int c0 = 0; c0 < m; c0 += kPanel) {
      const int c1 = c0 + kPanel;
      const int nrows = m - c1;
      for (int i = threadIdx.x; i < nrows + c1; i += kThreads) {
        if (i < nrows) {
          row_solve(bs, panel, ld, m, c0, c1 + i, rdiag);
        } else {
          col_solve(bs, bu, ld, c0, i - nrows, rdiag);
        }
      }
      __syncthreads();
      if (nrows > 0) {
        // The next diagonal block is tiles (rt0, rt0), (rt0 + 1, rt0) and
        // (rt0 + 1, rt0 + 1).
        const int rt0 = c1 / 4;
        if (threadIdx.x < 32) {
          if (threadIdx.x < 3) {
            trailing_tile(bs, bu, panel, ld, m, c0, c1,
                          rt0 + (threadIdx.x > 0), rt0 + (threadIdx.x == 2));
          }
          __syncwarp();
          if (threadIdx.x == 0) factor_diag(bs, ld, c1, rdiag, bad);
        } else {
          const int g0 = tri(rt0);
          const int total = tri(nt) - g0;
          for (int t = threadIdx.x - 32; t < total; t += kThreads - 32) {
            const int rt = tri_row(g0 + t);
            const int ct = g0 + t - tri(rt);
            if (rt > rt0 + 1 || ct < rt0) {
              trailing_tile(bs, bu, panel, ld, m, c0, c1, rt, ct);
            }
          }
        }
        __syncthreads();
      }
    }

    // L is read: the next step's U comes into its buffer meanwhile.
    if (k + 1 < n) {
      load_async(bs, upper + (static_cast<size_t>(k) * batch + mat) * mm, m,
                 ld);
    }

    // I_k = X^T X: this CTA's tiles of the lower half and their mirrors,
    // into every CTA's I buffer and into invs[k].
    const bool failed = *bad != 0;
    const float nan = __int_as_float(0x7fc00000);
    for (int g = rank + csize * threadIdx.x; g < tri(nt);
         g += csize * kThreads) {
      const int rt = tri_row(g);
      const int ct = g - tri(rt);
      float acc[4][4] = {};
      atb(acc, bu, bu, ld, 4 * rt, 4 * ct, 4 * rt, m);
      if (failed) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = nan;
        }
      }
      for (int q = 0; q <= csize; ++q) {
        // q < csize: CTA q's I buffer; q == csize: invs[k].
        float* dst = q < csize ? cluster.map_shared_rank(buf_i, q)
                               : invs + at;
        const int dl = q < csize ? ld : m;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          st4(dst + (4 * rt + a) * dl + 4 * ct,
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
          if (rt != ct) {
            st4(dst + (4 * ct + a) * dl + 4 * rt,
                make_float4(acc[0][a], acc[1][a], acc[2][a], acc[3][a]));
          }
        }
      }
    }
    cluster.sync();
    float* const swap = bu;
    bu = bs;
    bs = swap;
  }
}

}  // namespace

// K6 over a batch: diag (n, batch, m, m) and upper (n - 1, batch, m, m)
// float32, contiguous (upper may be null where n == 1).  Writes invs and
// ws, each (n, batch, m, m).  cluster: CTAs a batch matrix (1 ..
// kMaxCluster).
extern "C" int tpuslam_thomas_factor(const float* diag, const float* upper,
                                     float* invs, float* ws, int n,
                                     int batch, int m, int cluster,
                                     void* stream) {
  if (diag == nullptr || invs == nullptr || ws == nullptr || n < 1 ||
      (n > 1 && upper == nullptr) || batch < 1 || m < kPanel || m > kMaxM ||
      m % kPanel != 0 ||
      cluster < 1 || cluster > kMaxCluster ||
      batch > (1 << 30) / cluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      thomas_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, thomas_factor_kernel, diag, upper, invs, ws,
                           n, batch, m);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of c CTAs (c = 1 .. kMaxCluster) that can run at once
// on the current device at super-block size m, into counts[c - 1]: the
// wrapper picks K6's cluster from them.  Sets the kernel's shared-memory
// limit.
extern "C" int tpuslam_thomas_clusters(int m, int* counts) {
  if (m < kPanel || m > kMaxM || m % kPanel != 0 || counts == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      thomas_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int c = 1; c <= kMaxCluster; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(c));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(c);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&counts[c - 1],
                                         thomas_factor_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
