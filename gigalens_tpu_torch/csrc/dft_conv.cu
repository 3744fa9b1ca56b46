// PSF convolution as DFT-by-matmul over half of the spectrum: a batched
// real-pair SGEMM with a cp.async ring, launched once per stage.
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
// It serves the PSFs above the direct kernel's crossover (direct_conv.cu,
// ops/cuda/direct_conv.py: k4_route).
//
// What bounds it on the H100: FP32 multiply-adds. Two things are done about
// that. (1) The image and the PSF are real, so the spectrum is Hermitian and
// its columns above fw / 2 are conjugates of columns already there: the
// factor set the host builds (ops/psf.py: dft_factors(half=True)) keeps
// fw / 2 + 1 spectral columns, zero-padded to a multiple of 4, and K
// carries the weights 1 (column 0 and, for even fw, fw / 2) and 2 (the
// rest), so the real part of the last product is unchanged. That halves
// the work: 29.6 M multiply-adds a sample at the bench shape (160x160 ->
// 216x109 half spectrum -> 80x80) against 58.6 M for the whole spectrum; at a
// 177-px PSF 74 M, against 203 M for the direct sum. (2) The GEMM core is
// built for the FMA pipe: a block of 256 threads owns a (16 TM) x 64 tile of
// the product (TM = 5 or 4, whichever pads the rows less: 80, 160 and 216
// rows are 1, 2 and 3 tiles of 80); a thread keeps TM x 4 complex
// accumulators, rows 16 apart and 4 adjacent columns. The 16-deep k-tiles of
// both operands (real and imaginary planes) come in by 16-byte cp.async into
// a three-stage ring in dynamic shared memory (54 KB a block at TM = 5, two
// blocks a SM), so the loads of the next two tiles overlap the FMAs with one
// barrier a k-tile; tiles past a matrix edge are zero-filled by the copy's
// size operand (4-byte copies where a caller's rows are not 16-byte
// aligned). From shared memory a thread reads A as one float4 per row per
// four k steps (a broadcast: a warp spans two rows) and B as one float4 per k
// step: 18 16-byte loads per 320 FMAs at TM = 5 for a complex x complex
// product (a 4 x 4 tile fed by scalar loads needs one load per 4 FMAs). One
// operand is the factor shared across the batch (batch stride 0): every
// block of a stage reads it, so it stays in L2 (at most 0.6 MB). The
// spectrum product (* K) is fused into the second stage's epilogue and the
// last stage keeps only the real part. Intermediates still go through
// device memory (~0.2 GB a direction at bs = 500 after the halving, ~0.06
// ms at 3.35 TB/s, overlapped by the other blocks' arithmetic: with the
// batch cut to 125 samples, where they stay in L2, a sample takes no less
// time, so no stages are fused). Numerics are full FP32 FMA, a fixed
// summation order and no atomics: bitwise repeatable, and stricter than the
// TPU's single bf16 pass, so the TPU's separate "dft_hi" precision mode has
// no counterpart here. The tensor cores were tried and are not used: the
// same tiles on mma.sync m16n8k8 in three TF32 passes (a = hi + lo; lo*hi +
// hi*lo + hi*hi, FP32 accumulation) took the same time, the splits and
// 4-byte fragment loads eating what the matrix unit saved, at seven times
// the error (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int BN = 64, BK = 16, kThreads = 256, kStages = 3;

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies the ROWS x COLS tile at (r0, c0) of a row-major matrix with leading
// dimension ld into shared memory, zero past (nrows, ncols); 16 bytes a copy
// when the matrix's rows are 16-byte aligned (vec), else 4.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int ld,
                                          int r0, int nrows, int c0, int ncols, bool vec) {
  if (vec) {
    constexpr int kQuads = COLS / 4;
    for (int c = threadIdx.x; c < ROWS * kQuads; c += kThreads) {
      const int r = c / kQuads, q = (c % kQuads) * 4;
      const int gr = r0 + r, gc = c0 + q;
      const int n = gr < nrows ? min(max(ncols - gc, 0), 4) : 0;
      cp_async16(dst + r * COLS + q, n > 0 ? src + (size_t)gr * ld + gc : src, 4 * n);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * COLS; c += kThreads) {
      const int r = c / COLS, q = c % COLS;
      const int gr = r0 + r, gc = c0 + q;
      const bool in = gr < nrows && gc < ncols;
      cp_async4(dst + r * COLS + q, in ? src + (size_t)gr * ld + gc : src, in ? 4 : 0);
    }
  }
}

// C[b] = A[b] @ B[b] over real pairs; a batch stride of 0 marks a shared
// operand. A is (M, K), B is (K, N), C is (M, N), row-major with leading
// dimensions lda, ldb, ldc (K's: ldc). A thread owns rows ty + 16 i (i < TM)
// and columns 4 tx .. 4 tx + 3 of the block's tile.
template <int TM, bool A_CPLX, bool B_CPLX, bool OUT_CPLX, bool EPI_K>
__global__ void __launch_bounds__(kThreads, 2)
pair_gemm(const float* __restrict__ Ar, const float* __restrict__ Ai, long long sA, int lda,
          const float* __restrict__ Br, const float* __restrict__ Bi, long long sB, int ldb,
          float* __restrict__ Cr, float* __restrict__ Ci, long long sC, int ldc,
          const float* __restrict__ Kr, const float* __restrict__ Ki, int M, int N, int K,
          int a_vec, int b_vec, int c_vec) {
  constexpr int BM = 16 * TM;
  constexpr int kA = BM * BK, kB = BK * BN;  // floats of one plane of a tile
  constexpr int kStage = (A_CPLX ? 2 : 1) * kA + (B_CPLX ? 2 : 1) * kB;
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.z;
  Ar += b * sA;
  Br += b * sB;
  if (A_CPLX) Ai += b * sA;
  if (B_CPLX) Bi += b * sB;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  // k-tile kt of both operands into ring slot kt % kStages
  auto load = [&](int kt) {
    float* s = smem + (kt % kStages) * kStage;
    const int k0 = kt * BK;
    load_tile<BM, BK>(s, Ar, lda, row0, M, k0, K, a_vec);
    if (A_CPLX) load_tile<BM, BK>(s + kA, Ai, lda, row0, M, k0, K, a_vec);
    float* sb = s + (A_CPLX ? 2 : 1) * kA;
    load_tile<BK, BN>(sb, Br, ldb, k0, K, col0, N, b_vec);
    if (B_CPLX) load_tile<BK, BN>(sb + kB, Bi, ldb, k0, K, col0, N, b_vec);
  };

  float acc_r[TM][4], acc_i[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();               // everyone's have, and tile kt - 1 is consumed
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);  // into tile kt - 1's slot
    cp_async_commit();

    const float* s = smem + (kt % kStages) * kStage;
    const float* as_r = s + ty * BK;
    const float* as_i = as_r + kA;
    const float* bs_r = s + (A_CPLX ? 2 : 1) * kA + 4 * tx;
    const float* bs_i = bs_r + kB;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a_r[TM][4], a_i[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as_r + i * 16 * BK + k4);
        a_r[i][0] = v.x, a_r[i][1] = v.y, a_r[i][2] = v.z, a_r[i][3] = v.w;
        if (A_CPLX) {
          const float4 w = *reinterpret_cast<const float4*>(as_i + i * 16 * BK + k4);
          a_i[i][0] = w.x, a_i[i][1] = w.y, a_i[i][2] = w.z, a_i[i][3] = w.w;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float b_r[4], b_i[4];
        const float4 v = *reinterpret_cast<const float4*>(bs_r + (k4 + k) * BN);
        b_r[0] = v.x, b_r[1] = v.y, b_r[2] = v.z, b_r[3] = v.w;
        if (B_CPLX) {
          const float4 w = *reinterpret_cast<const float4*>(bs_i + (k4 + k) * BN);
          b_i[0] = w.x, b_i[1] = w.y, b_i[2] = w.z, b_i[3] = w.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_r[i][j] = fmaf(a_r[i][k], b_r[j], acc_r[i][j]);
            if (A_CPLX && B_CPLX) acc_r[i][j] = fmaf(-a_i[i][k], b_i[j], acc_r[i][j]);
            if (OUT_CPLX) {
              if (B_CPLX) acc_i[i][j] = fmaf(a_r[i][k], b_i[j], acc_i[i][j]);
              if (A_CPLX) acc_i[i][j] = fmaf(a_i[i][k], b_r[j], acc_i[i][j]);
            }
          }
      }
    }
  }

  const int c = col0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M || c >= N) continue;
    float vr[4], vi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vr[j] = acc_r[i][j];
      vi[j] = acc_i[i][j];
      if (EPI_K && c + j < N) {  // spectrum product (vr + i vi) * (kr + i ki)
        const float kr = Kr[(size_t)r * ldc + c + j], ki = Ki[(size_t)r * ldc + c + j];
        const float pr = vr[j] * kr - vi[j] * ki;
        vi[j] = vr[j] * ki + vi[j] * kr;
        vr[j] = pr;
      }
    }
    const size_t o = (size_t)b * sC + (size_t)r * ldc + c;
    if (c_vec && c + 3 < N) {
      *reinterpret_cast<float4*>(Cr + o) = make_float4(vr[0], vr[1], vr[2], vr[3]);
      if (OUT_CPLX) *reinterpret_cast<float4*>(Ci + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= N) break;
        Cr[o + j] = vr[j];
        if (OUT_CPLX) Ci[o + j] = vi[j];
      }
    }
  }
}

struct Mat {  // one operand: real and imaginary planes, batch stride, leading dimension
  const float *re, *im;
  long long stride;
  int ld;
};

bool aligned16(const Mat& m) {
  return m.ld % 4 == 0 && m.stride % 4 == 0 && ((size_t)m.re & 15) == 0 &&
         (m.im == nullptr || ((size_t)m.im & 15) == 0);
}

template <int TM, bool A_CPLX, bool B_CPLX, bool OUT_CPLX, bool EPI_K>
cudaError_t launch_tm(const Mat& A, const Mat& B, float* Cr, float* Ci, long long sC, int ldc,
                      const float* Kr, const float* Ki, int M, int N, int K, int bs,
                      cudaStream_t st) {
  auto kernel = pair_gemm<TM, A_CPLX, B_CPLX, OUT_CPLX, EPI_K>;
  const int smem = kStages * 4 * ((A_CPLX ? 2 : 1) * 16 * TM * BK + (B_CPLX ? 2 : 1) * BK * BN);
  static bool opted_in = false;  // one flag per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  const Mat C{Cr, Ci, sC, ldc};
  const dim3 grid((N + BN - 1) / BN, (M + 16 * TM - 1) / (16 * TM), bs);
  kernel<<<grid, kThreads, smem, st>>>(A.re, A.im, A.stride, A.ld, B.re, B.im, B.stride, B.ld, Cr,
                                       Ci, sC, ldc, Kr, Ki, M, N, K, aligned16(A), aligned16(B),
                                       aligned16(C));
  return cudaGetLastError();
}

// Rows a thread owns: the TM of {5, 4} that pads M less (ties: 5)
template <bool A_CPLX, bool B_CPLX, bool OUT_CPLX, bool EPI_K>
cudaError_t launch(const Mat& A, const Mat& B, float* Cr, float* Ci, long long sC, int ldc,
                   const float* Kr, const float* Ki, int M, int N, int K, int bs,
                   cudaStream_t st) {
  const int pad5 = (M + 79) / 80 * 80, pad4 = (M + 63) / 64 * 64;
  if (pad5 <= pad4)
    return launch_tm<5, A_CPLX, B_CPLX, OUT_CPLX, EPI_K>(A, B, Cr, Ci, sC, ldc, Kr, Ki, M, N, K,
                                                         bs, st);
  return launch_tm<4, A_CPLX, B_CPLX, OUT_CPLX, EPI_K>(A, B, Cr, Ci, sC, ldc, Kr, Ki, M, N, K, bs,
                                                       st);
}

}  // namespace

extern "C" {

// One pass of the 4-stage chain over a (bs, H, W) batch -> (bs, oh, ow), on
// hw spectral columns (half of the spectrum, padded: dft_conv.py).
// Factor set: Fh (fh, H), FwT (W, hw), K (fh, hw), Ih (oh, fh), IwT (hw, ow).
// Scratch (caller-allocated): t1 (bs, H, hw), z (bs, fh, hw), u (bs, oh, hw),
// each a real/imaginary pair.
int gl_dft_conv(const float* x, float* out, float* t1r, float* t1i, float* zr, float* zi,
                float* ur, float* ui, const float* fh_re, const float* fh_im,
                const float* fwt_re, const float* fwt_im, const float* k_re,
                const float* k_im, const float* ih_re, const float* ih_im,
                const float* iwt_re, const float* iwt_im, int bs, int H, int W, int fh,
                int hw, int oh, int ow, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const long long sx = (long long)H * W, s1 = (long long)H * hw, sz = (long long)fh * hw,
                  su = (long long)oh * hw;
  // 1. T1 = x @ FwT: (H, W) x (W, hw), x real and per sample
  err = launch<false, true, true, false>({x, nullptr, sx, W}, {fwt_re, fwt_im, 0, hw}, t1r, t1i,
                                         s1, hw, nullptr, nullptr, H, hw, W, bs, st);
  if (err != cudaSuccess) return (int)err;
  // 2. Z = (Fh @ T1) * K: (fh, H) x (H, hw), spectrum product in the epilogue
  err = launch<true, true, true, true>({fh_re, fh_im, 0, H}, {t1r, t1i, s1, hw}, zr, zi, sz, hw,
                                       k_re, k_im, fh, hw, H, bs, st);
  if (err != cudaSuccess) return (int)err;
  // 3. U = Ih @ Z: (oh, fh) x (fh, hw)
  err = launch<true, true, true, false>({ih_re, ih_im, 0, fh}, {zr, zi, sz, hw}, ur, ui, su, hw,
                                        nullptr, nullptr, oh, hw, fh, bs, st);
  if (err != cudaSuccess) return (int)err;
  // 4. out = Re[U @ IwT]: (oh, hw) x (hw, ow), real part only
  err = launch<true, true, false, false>({ur, ui, su, hw}, {iwt_re, iwt_im, 0, ow}, out, nullptr,
                                         (long long)oh * ow, ow, nullptr, nullptr, oh, ow, hw, bs,
                                         st);
  return (int)err;
}

}  // extern "C"
