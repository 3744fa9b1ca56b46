// Pseudo-inverse of a batch of small real symmetric float64 matrices (the
// lstsq solve's Gram), by two-sided cyclic Jacobi, on the device alone.
//
// Replaces no Pallas kernel: the JAX package leaves jnp.linalg.pinv to XLA
// (gigalens_tpu/simulator.py, lstsq_simulate). The port's float64 solve
// (F-ref-7, simulator.py _lstsq_coeffs) took torch.linalg.pinv, whose CUDA
// route is cuSOLVER's batched Jacobi SVD followed by a host read of its
// error codes: the host waited for the card once every MAP step and fell
// behind it. This kernel computes the same function, torch.linalg.pinv(a,
// rtol=rtol) for symmetric a, with nothing read back.
//
// What bounds it on the H100: latency. A family-L step holds 500 matrices
// of 16 x 16 (0.5 M flops a sweep each); each sweep is 15 dependent rounds
// of a square root, divisions and a rotation, so the design keeps a round
// short and every matrix resident at once. One block a matrix, one thread
// an element of the (np x np) matrix (np: the depth rounded up to even;
// the block rounded up to a power of two, at least a warp), the matrix and
// its accumulated eigenvectors V in shared memory, double-buffered so a
// round is two barriers: the round's rotations, then every element
// rotated from the old buffer into the new one. 256 threads and ~8 KB a
// block at depth 16: all 500 blocks fit on the card's 132 SMs together.
//
// The arithmetic (held line for line by ops/cuda/gram_pinv.py's twin):
//   * the symmetric part (a + a^T) / 2, scaled by a power of two that puts
//     its largest entry in [0.5, 1) (exact; no square below overflows);
//   * sweeps of the round-robin order: in round r of np - 1, index i pairs
//     with (2 r - i) mod (np - 1), and r with np - 1. A pair (p < q) takes
//     Rutishauser's rotation, tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau)
//     / (|tau| + sqrt(1 + tau^2)), c = 1 / sqrt(1 + t^2), s = t c (none
//     where a_pq = 0: vanished components, the padding index); then
//     a_pp -= t a_pq, a_qq += t a_pq, a_pq = a_qp = 0, every other entry
//     (J^T A J)_ij from the four entries of its rows' and columns' pairs,
//     and V = V J. An off-diagonal entry is computed from its upper-triangle
//     position, so A stays exactly symmetric;
//   * the test before each sweep: stop once the off-diagonal part's squared
//     norm is at or below eps^2 times the whole matrix's (eps = 2^-52), or
//     after kMaxSweeps sweeps, so every matrix ends (the sums in a fixed
//     order: a thread a row, then one thread over the rows);
//   * p = V diag(w) V^T scaled back, w_k = 1 / lam_k where |lam_k| >
//     rtol max |lam| and 0 elsewhere: a symmetric matrix's singular values
//     are its eigenvalues' magnitudes, so this is torch's cutoff, kept
//     strictly above rtol sigma_max. An input with a NaN or an inf gives a
//     NaN matrix and runs no sweep.
// Every matrix is its own block with a fixed order of operations and no
// atomics, so its bits depend neither on the batch nor on the run.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kMaxDepth = 32;
constexpr int kMaxSweeps = 40;
constexpr double kEps = 2.220446049250313e-16;  // 2^-52
constexpr double kTol2 = kEps * kEps;

// index i's partner in round r of the round-robin order on np (even) indices
__device__ __forceinline__ int partner(int i, int r, int np) {
  const int m = np - 1;
  if (i == m) return r;
  if (i == r) return m;
  int j = 2 * r - i;
  if (j < 0) j += m;
  if (j >= m) j -= m;
  return j;
}

__global__ void __launch_bounds__(1024)
gram_pinv_kernel(const double* __restrict__ a, double* __restrict__ p, int n, int np,
                 double rtol) {
  extern __shared__ double sh[];
  __shared__ int s_ex, s_bad, s_done;
  __shared__ double s_thr;
  const int nn = np * np, tid = threadIdx.x;
  double* A = sh;            // the matrix, this round's buffer
  double* An = A + nn;       // ... and the next round's
  double* V = An + nn;       // eigenvectors, likewise
  double* Vn = V + nn;
  double* cs = Vn + nn;      // np: cosine of index i's rotation this round
  double* sg = cs + np;      // np: its sine, signed as J's entry (-s at p, s at q)
  double* dt = sg + np;      // np: the diagonal's step (-t at p, t at q)
  double* w = dt + np;       // np: the inverted eigenvalues, 0 where cut
  double* row0 = w + np;     // np: per-row sums and maxima
  double* row1 = row0 + np;  // np
  int* pt = reinterpret_cast<int*>(row1 + np);  // np: index i's partner this round

  const bool live = tid < nn;
  const int i = live ? tid / np : 0, j = live ? tid % np : 0;
  const double* ab = a + (size_t)blockIdx.x * n * n;
  if (live) {
    A[tid] = (i < n && j < n) ? (ab[i * n + j] + ab[j * n + i]) * 0.5 : 0.0;
    V[tid] = i == j ? 1.0 : 0.0;
  }
  __syncthreads();
  if (tid < np) {
    double m = 0.0, bad = 0.0;
    for (int k = 0; k < np; ++k) {
      const double x = A[tid * np + k];
      m = fmax(m, fabs(x));
      if (!isfinite(x)) bad = 1.0;
    }
    row0[tid] = m;
    row1[tid] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    double m = 0.0;
    int bad = 0;
    for (int k = 0; k < np; ++k) {
      m = fmax(m, row0[k]);
      bad |= row1[k] != 0.0;
    }
    int ex = 0;
    if (!bad) frexp(m, &ex);
    s_ex = ex;
    s_bad = bad;
  }
  __syncthreads();
  if (live) A[tid] = ldexp(A[tid], -s_ex);

  for (int sweep = 0;; ++sweep) {
    __syncthreads();
    if (tid < np) {
      double off = 0.0;
      for (int k = 0; k < np; ++k) {
        const double x = A[tid * np + k];
        if (k != tid) off += x * x;
      }
      const double d = A[tid * np + tid];
      row0[tid] = off;
      row1[tid] = d * d;
    }
    __syncthreads();
    if (tid == 0) {
      double off = 0.0, diag = 0.0;
      for (int k = 0; k < np; ++k) off += row0[k];
      for (int k = 0; k < np; ++k) diag += row1[k];
      s_done = s_bad || off <= kTol2 * (off + diag) || sweep == kMaxSweeps;
    }
    __syncthreads();
    if (s_done) break;
    for (int r = 0; r < np - 1; ++r) {
      if (tid < np) {
        const int q = partner(tid, r, np);
        pt[tid] = q;
        if (tid < q) {
          const double apq = A[tid * np + q];
          double c = 1.0, s = 0.0, t = 0.0;
          if (apq != 0.0) {
            const double tau = (A[q * np + q] - A[tid * np + tid]) / (2.0 * apq);
            t = copysign(1.0, tau) / (fabs(tau) + sqrt(1.0 + tau * tau));
            c = 1.0 / sqrt(1.0 + t * t);
            s = t * c;
          }
          cs[tid] = c;
          cs[q] = c;
          sg[tid] = -s;
          sg[q] = s;
          dt[tid] = -t;
          dt[q] = t;
        }
      }
      __syncthreads();
      if (live) {
        const int pi = pt[i], pj = pt[j];
        double x;
        if (i == j) {
          x = A[i * np + i] + dt[i] * A[i * np + pi];
        } else if (j == pi) {
          x = 0.0;
        } else {
          const int r0 = min(i, j), r1 = max(i, j), p0 = pt[r0], p1 = pt[r1];
          const double c0 = cs[r0], s0 = sg[r0], c1 = cs[r1], s1 = sg[r1];
          x = c1 * (c0 * A[r0 * np + r1] + s0 * A[p0 * np + r1])
              + s1 * (c0 * A[r0 * np + p1] + s0 * A[p0 * np + p1]);
        }
        An[tid] = x;
        Vn[tid] = cs[j] * V[i * np + j] + sg[j] * V[i * np + pj];
      }
      __syncthreads();
      double* tmp = A;
      A = An;
      An = tmp;
      tmp = V;
      V = Vn;
      Vn = tmp;
    }
  }

  if (tid == 0) {
    double m = 0.0;
    for (int k = 0; k < n; ++k) m = fmax(m, fabs(A[k * np + k]));
    s_thr = rtol * m;
  }
  __syncthreads();
  if (tid < n) {
    const double lam = A[tid * np + tid];
    w[tid] = fabs(lam) > s_thr ? 1.0 / lam : 0.0;
  }
  __syncthreads();
  if (live && i < n && j < n) {
    const int r0 = min(i, j), r1 = max(i, j);
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc += (w[k] * V[r0 * np + k]) * V[r1 * np + k];
    p[(size_t)blockIdx.x * n * n + i * n + j] = s_bad ? nan("") : ldexp(acc, -s_ex);
  }
}

}  // namespace

extern "C" {

// a, p: (batch, n, n) float64, contiguous; 1 <= n <= kMaxDepth
int gl_gram_pinv(const double* a, double* p, int batch, int n, double rtol, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int np = n + (n & 1);
  int threads = 32;
  while (threads < np * np) threads *= 2;
  const size_t shm = sizeof(double) * (4 * np * np + 6 * np) + sizeof(int) * np;
  gram_pinv_kernel<<<batch, threads, shm, static_cast<cudaStream_t>(stream)>>>(a, p, n, np,
                                                                              rtol);
  return (int)cudaGetLastError();
}

}  // extern "C"
