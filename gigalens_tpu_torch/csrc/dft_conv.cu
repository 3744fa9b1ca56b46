// PSF convolution as DFT-by-matmul: a batched real-pair tiled SGEMM.
//
// Replaces the Pallas TPU kernel of gigalens_tpu/ops/pallas/dft_conv.py
// (PallasDFTConv.__call__ -> _run -> _dft_kernel / _chain). Per sample it
// computes
//
//     out = Re[ Ih @ ((Fh @ x @ FwT) * K) @ IwT ]
//
// with the 'SAME' crop and the supersample average pool folded into Ih and
// IwT. The VJP is the same chain on the transposed factor set, so one entry
// point serves the forward and the transpose (the caller picks the set).
//
// What bounds it on the H100: at the main-path shapes (160x160 -> 216x216
// spectrum -> 80x80, bs = 500) the chain is ~59 GFLOP of FP32 multiply-adds
// per call, and the TPU kernel's single-block chain does not fit on chip:
// one (216, 216) real/imaginary pair alone is 373 KB against 227 KB of
// shared memory per block. Design (first version): one templated kernel,
// launched once per stage of the chain, computes a batched product of real
// pairs (re, im) with 64x64 output tiles, 16-deep k-tiles staged in shared
// memory and a 4x4 register tile of FP32 FMAs per thread. One operand is
// the factor shared across the batch (batch stride 0), the other is per
// sample. The spectrum product (* K) is fused into the second stage's
// epilogue and the last stage keeps only the real part. Intermediates go
// through device memory (~0.4 GB at bs = 500). Numerics are full FP32
// (never TF32): stricter than the TPU's single bf16 pass, so the TPU's
// separate "dft_hi" precision mode has no counterpart here. wgmma, TMA and
// keeping the chain on chip are later work.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, kThreads = 256;

// C[b] = A[b] @ B[b] over real pairs; a batch stride of 0 marks a shared
// operand. A is (M, K), B is (K, N), C is (M, N), all row-major.
template <bool A_CPLX, bool B_CPLX, bool OUT_CPLX, bool EPI_K>
__global__ void __launch_bounds__(kThreads)
pair_gemm(const float* __restrict__ Ar, const float* __restrict__ Ai, long long sA,
          const float* __restrict__ Br, const float* __restrict__ Bi, long long sB,
          float* __restrict__ Cr, float* __restrict__ Ci, long long sC,
          const float* __restrict__ Kr, const float* __restrict__ Ki, int M, int N, int K) {
  __shared__ float as_r[BK][BM + 1], as_i[A_CPLX ? BK : 1][BM + 1];
  __shared__ float bs_r[BK][BN], bs_i[B_CPLX ? BK : 1][BN];
  const int b = blockIdx.z;
  Ar += b * sA;
  Br += b * sB;
  if (A_CPLX) Ai += b * sA;
  if (B_CPLX) Bi += b * sB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int r = idx / BK, kk = idx % BK;
      const bool in = row0 + r < M && k0 + kk < K;
      const size_t a = (size_t)(row0 + r) * K + k0 + kk;
      as_r[kk][r] = in ? Ar[a] : 0.0f;
      if (A_CPLX) as_i[kk][r] = in ? Ai[a] : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int kk = idx / BN, c = idx % BN;
      const bool in = k0 + kk < K && col0 + c < N;
      const size_t a = (size_t)(k0 + kk) * N + col0 + c;
      bs_r[kk][c] = in ? Br[a] : 0.0f;
      if (B_CPLX) bs_i[kk][c] = in ? Bi[a] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_r[4], a_i[4], b_r[4], b_i[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a_r[i] = as_r[kk][ty + 16 * i];
        a_i[i] = A_CPLX ? as_i[kk][ty + 16 * i] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b_r[j] = bs_r[kk][tx + 16 * j];
        b_i[j] = B_CPLX ? bs_i[kk][tx + 16 * j] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_r[i][j] = fmaf(a_r[i], b_r[j], acc_r[i][j]);
          if (A_CPLX && B_CPLX) acc_r[i][j] = fmaf(-a_i[i], b_i[j], acc_r[i][j]);
          if (OUT_CPLX) {
            if (B_CPLX) acc_i[i][j] = fmaf(a_r[i], b_i[j], acc_i[i][j]);
            if (A_CPLX) acc_i[i][j] = fmaf(a_i[i], b_r[j], acc_i[i][j]);
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r >= M || c >= N) continue;
      float vr = acc_r[i][j], vi = acc_i[i][j];
      if (EPI_K) {  // spectrum product (vr + i vi) * (kr + i ki)
        const float kr = Kr[(size_t)r * N + c], ki = Ki[(size_t)r * N + c];
        const float pr = vr * kr - vi * ki;
        vi = vr * ki + vi * kr;
        vr = pr;
      }
      const size_t o = (size_t)b * sC + (size_t)r * N + c;
      Cr[o] = vr;
      if (OUT_CPLX) Ci[o] = vi;
    }
}

dim3 grid_for(int M, int N, int bs) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM, bs); }

}  // namespace

extern "C" {

// One pass of the 4-stage chain over a (bs, H, W) batch -> (bs, oh, ow).
// Factor set: Fh (fh, H), FwT (W, fw), K (fh, fw), Ih (oh, fh), IwT (fw, ow).
// Scratch (caller-allocated): t1 (bs, H, fw), z (bs, fh, fw), u (bs, oh, fw),
// each a real/imaginary pair.
int gl_dft_conv(const float* x, float* out, float* t1r, float* t1i, float* zr, float* zi,
                float* ur, float* ui, const float* fh_re, const float* fh_im,
                const float* fwt_re, const float* fwt_im, const float* k_re,
                const float* k_im, const float* ih_re, const float* ih_im,
                const float* iwt_re, const float* iwt_im, int bs, int H, int W, int fh,
                int fw, int oh, int ow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // 1. T1 = x @ FwT: (H, W) x (W, fw), x real and per sample
  pair_gemm<false, true, true, false><<<grid_for(H, fw, bs), kThreads, 0, st>>>(
      x, nullptr, (long long)H * W, fwt_re, fwt_im, 0, t1r, t1i, (long long)H * fw,
      nullptr, nullptr, H, fw, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2. Z = (Fh @ T1) * K: (fh, H) x (H, fw), spectrum product in the epilogue
  pair_gemm<true, true, true, true><<<grid_for(fh, fw, bs), kThreads, 0, st>>>(
      fh_re, fh_im, 0, t1r, t1i, (long long)H * fw, zr, zi, (long long)fh * fw, k_re, k_im,
      fh, fw, H);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 3. U = Ih @ Z: (oh, fh) x (fh, fw)
  pair_gemm<true, true, true, false><<<grid_for(oh, fw, bs), kThreads, 0, st>>>(
      ih_re, ih_im, 0, zr, zi, (long long)fh * fw, ur, ui, (long long)oh * fw, nullptr,
      nullptr, oh, fw, fh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 4. out = Re[U @ IwT]: (oh, fw) x (fw, ow), real part only
  pair_gemm<true, true, false, false><<<grid_for(oh, ow, bs), kThreads, 0, st>>>(
      ur, ui, (long long)oh * fw, iwt_re, iwt_im, 0, out, nullptr, (long long)oh * ow,
      nullptr, nullptr, oh, ow, fw);
  return (int)cudaGetLastError();
}

}  // extern "C"
