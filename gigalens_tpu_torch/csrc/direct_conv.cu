// PSF convolution with the supersample pool folded in, as a direct strided sum.
//
// Replaces, on the main path, the Pallas TPU kernel of
// gigalens_tpu/ops/pallas/dft_conv.py (PallasDFTConv -> _run -> _dft_kernel,
// and its transposed call for the VJP). The same function, another
// algorithm: per sample,
//
//     out[i, j] = sum_{s, t} w[s, t] * x[p*i + s - oy, p*j + t - ox]
//
// with x zero outside the image and w the flipped PSF summed over the p x p
// pool box / p^2 (52x52 for the bench scene's 51-px supersampled PSF at
// p = 2). Both directions run as sums of stride-1 correlations, which this
// one kernel computes: per output phase ph and input phase q,
//
//     out[i*os + ry, j*os + rx] += sum_{u<KH, v<KW} w_q[u, v] * c_q[i + u - oy_q, j + v - ox_q]
//
// where c_q[m, n] = x[g*m + by_q, g*n + bx_q] is a polyphase component of
// the input. The forward sums the p^2 components (g = p) against the p^2
// sub-kernels w[p*u + a, p*v + b] into one output; the transpose reads the
// cotangent whole (g = 1) and writes p^2 output phases (os = p), each with
// its own sub-kernel. ops/cuda/direct_conv.py builds the sub-kernels and the
// (oy, ox, by, bx, ry, rx) table on the host.
//
// What bounds it on the H100: FP32 arithmetic. At the bench shape one
// direction is 80*80*52*52 = 17.3 M multiply-adds per sample (3.4x fewer
// than the DFT chain), 17.3 GFLOP at bs = 500 against 51 MB in and 12.8 MB
// out: 0.26 ms at 67 TFLOP/s, while the bytes need 0.02 ms. The TPU chose
// the DFT chain for its matrix unit; on this card the direct sum does less
// work and keeps every intermediate on chip.
//
// Design: a block owns one sample, one output phase and an output tile 80
// columns wide and 10 rows per warp tall (8 warps at the bench shape). Its
// sub-kernels and, one input phase at a time, the input halo of the tile go
// to dynamic shared memory (62 KB for the bench forward, above the 48 KB
// default: the attribute is raised at launch; three blocks share an SM);
// the halo is gathered with cp.async and zero-filled past the image edge,
// with no padded copy in device memory. Each thread keeps 5 rows x 5
// adjacent columns of outputs in registers and walks the input rows of its
// window once: a row is shared by every output row whose tap row lands on
// it (the first and last 4 rows of a window, which feed fewer output rows,
// are unrolled with their ranges known at compile time), four taps are one
// broadcast float4 load, and along a row an 8-word register window slides
// by four words a step, so four shared loads feed up to 100 FMAs; the last
// 1-3 taps of a row go one at a time. The 16 column lanes of a half warp, 5
// words apart, hit 16 distinct banks, and the row pitch puts the two half
// warps in the other 16. FP32 FMA only (no TF32), a fixed summation order
// and no atomics: bitwise repeatable. Measured at the bench shape
// (PERF.md) it reaches ~48% of the FP32 bound; the shared-memory pipe (a
// weight load per 20 FMAs) is the likeliest limit left, unmeasured (no
// profiler on the card).
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 5, kCols = 5, kLanesX = 16, kTileW = kLanesX * kCols;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One input row of a thread's window: output rows RLO..RHI (known at
// compile time) add taps t of row wrow - r * KWp times the row's words.
// Taps t..t+3 of output column c read window words c..c+3; an 8-word
// register window slides along the row four words a step.
template <int RLO, int RHI>
__device__ __forceinline__ void window_row(const float* xrow, const float* wrow, int KWp,
                                           int kw4, int tail, float (&acc)[kRows][kCols]) {
  float win[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) win[k] = xrow[k];
#pragma unroll 2
  for (int t = 0; t < kw4; t += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) win[4 + k] = xrow[t + 4 + k];
#pragma unroll
    for (int r = RLO; r <= RHI; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(wrow - r * KWp + t);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float a = acc[r][c];
        a = fmaf(wv.x, win[c], a);
        a = fmaf(wv.y, win[c + 1], a);
        a = fmaf(wv.z, win[c + 2], a);
        a = fmaf(wv.w, win[c + 3], a);
        acc[r][c] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) win[k] = win[4 + k];
  }
  if (tail) {  // the last 1-3 taps, one at a time
#pragma unroll
    for (int k = 0; k < 3; ++k) win[4 + k] = xrow[kw4 + 4 + k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= tail) break;
#pragma unroll
      for (int r = RLO; r <= RHI; ++r) {
        const float wk = wrow[-r * KWp + kw4 + k];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(wk, win[k + c], acc[r][c]);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads, 3)
direct_conv(const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ w,
            const int* __restrict__ table, int H, int W, int OH, int OW, int KH, int KW,
            int KWp, int HH, int PW, int LDp, int tiles_x, int n_in, int gather,
            int out_stride, int out_h, int out_w) {
  // n_in sub-kernels of KH x KWp taps, each between kRows - 1 zero rows
  // above and below (so every output row reads a tap row without a branch)
  // and zero past KW; then one input phase's halo, HH x LDp
  extern __shared__ __align__(16) float smem[];
  const int KHz = KH + 2 * (kRows - 1);
  float* ws = smem;
  float* xs = smem + n_in * KHz * KWp;
  const int b = blockIdx.z, ph = blockIdx.y;
  const int th = (blockDim.x / 32) * 2 * kRows;
  const int i0 = (blockIdx.x / tiles_x) * th, j0 = (blockIdx.x % tiles_x) * kTileW;
  const float* xg = x + (size_t)b * H * W;
  const int* tb = table + 6 * ph * n_in;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  const float* wg = w + (size_t)ph * n_in * KH * KW;
  for (int r = warp; r < n_in * KHz; r += nwarps) {
    const int q = r / KHz, u = r - q * KHz - (kRows - 1);
    const float* src = wg + (q * KH + u) * KW;
    for (int t = lane; t < KWp; t += 32) {
      const bool in = u >= 0 && u < KH && t < KW;
      cp_async4(ws + r * KWp + t, in ? src + t : wg, in);
    }
  }

  const int lx = threadIdx.x & (kLanesX - 1), ly = threadIdx.x / kLanesX;
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;

  for (int q = 0; q < n_in; ++q, tb += 6) {
    if (q > 0) __syncthreads();  // every thread is done with the last halo
    // gather the halo: component rows i0 - oy + hr, columns j0 - ox + k
    const int row0 = i0 - tb[0], col0 = j0 - tb[1], by = tb[2], bx = tb[3];
    for (int hr = warp; hr < HH; hr += nwarps) {
      const int gr = gather * (row0 + hr) + by;
      const bool row_in = gr >= 0 && gr < H;
      float* dst = xs + hr * LDp;
      for (int k = lane; k < PW; k += 32) {
        const int gc = gather * (col0 + k) + bx;
        const bool in = row_in && gc >= 0 && gc < W;
        cp_async4(dst + k, in ? xg + (size_t)gr * W + gc : xg, in);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // input row rp of this thread's window feeds output row r through tap
    // row u = rp - r; rows outside 0..KH-1 are zero. The first and last
    // kRows - 1 input rows feed fewer output rows, so they are unrolled with
    // their row ranges known at compile time and skip the zero rows.
    const float* wq = ws + (q * KHz + kRows - 1) * KWp;
    const float* x0 = xs + (kRows * ly) * LDp + kCols * lx;
    const int kw4 = KW & ~3, tail = KW - kw4;  // taps in whole quads, the rest
    static_assert(kRows == 5, "the unrolled ramps below assume 5 rows per thread");
#define GL_ROW(lo, hi, rp) window_row<lo, hi>(x0 + (rp) * LDp, wq + (rp) * KWp, KWp, kw4, tail, acc)
    if (KH >= kRows - 1) {
      GL_ROW(0, 0, 0);
      GL_ROW(0, 1, 1);
      GL_ROW(0, 2, 2);
      GL_ROW(0, 3, 3);
      for (int rp = kRows - 1; rp < KH; ++rp) GL_ROW(0, 4, rp);
      GL_ROW(1, 4, KH);
      GL_ROW(2, 4, KH + 1);
      GL_ROW(3, 4, KH + 2);
      GL_ROW(4, 4, KH + 3);
    } else {  // fewer tap rows than a window's ramp: every row, zero rows too
      for (int rp = 0; rp < kRows - 1 + KH; ++rp) GL_ROW(0, 4, rp);
    }
#undef GL_ROW
  }

  const int ry = table[6 * ph * n_in + 4], rx = table[6 * ph * n_in + 5];
  float* og = out + (size_t)b * out_h * out_w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + ly * kRows + r;
    if (i >= OH) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + kCols * lx + c;
      if (j < OW) og[(size_t)(i * out_stride + ry) * out_w + j * out_stride + rx] = acc[r][c];
    }
  }
}

// n_out output phases, each an (OH, OW) grid written every out_stride-th
// row and column of the (bs, out_h, out_w) output, summed over n_in input
// phases of the (bs, H, W) input gathered at stride `gather`. w is
// (n_out * n_in, KH, KW); table is (n_out * n_in, 6) int32 (oy, ox, by, bx,
// ry, rx). warps, HH, PW, LDp and smem are the launch plan (direct_conv.py:
// plan).
int launch(const float* x, float* out, const float* w, const int* table, int bs, int n_out,
           int n_in, int H, int W, int OH, int OW, int KH, int KW, int gather, int out_stride,
           int out_h, int out_w, int warps, int HH, int PW, int LDp, int smem, void* stream) {
  static int smem_set = 48 * 1024;  // the attribute is raised once per process
  if (warps < 1 || warps * 32 > kMaxThreads) return (int)cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(direct_conv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int th = warps * 2 * kRows;
  const int tiles_x = (OW + kTileW - 1) / kTileW, tiles_y = (OH + th - 1) / th;
  const dim3 grid(tiles_x * tiles_y, n_out, bs);
  direct_conv<<<grid, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, w, table, H, W, OH, OW, KH, KW, (KW + 3) / 4 * 4, HH, PW, LDp, tiles_x, n_in,
      gather, out_stride, out_h, out_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: (bs, H, W) images -> (bs, H/p, W/p), the pool^2 polyphase
// components of each image against the pool^2 sub-kernels w (pool^2, KH, KW).
int gl_direct_conv_fwd(const float* x, float* out, const float* w, const int* table, int bs,
                       int H, int W, int pool, int KH, int KW, int warps, int HH, int PW,
                       int LDp, int smem, void* stream) {
  return launch(x, out, w, table, bs, 1, pool * pool, H, W, H / pool, W / pool, KH, KW, pool, 1,
                H / pool, W / pool, warps, HH, PW, LDp, smem, stream);
}

// Transpose: (bs, H/p, W/p) cotangents -> (bs, H, W), one sub-kernel of w
// (pool^2, KH, KW) for each of the pool^2 output phases.
int gl_direct_conv_transpose(const float* ct, float* out, const float* w, const int* table,
                             int bs, int H, int W, int pool, int KH, int KW, int warps, int HH,
                             int PW, int LDp, int smem, void* stream) {
  return launch(ct, out, w, table, bs, pool * pool, 1, H / pool, W / pool, H / pool, W / pool,
                KH, KW, 1, pool, H, W, warps, HH, PW, LDp, smem, stream);
}

}  // extern "C"
