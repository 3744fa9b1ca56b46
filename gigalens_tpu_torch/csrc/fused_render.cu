// Fused EPL+Shear ray-shoot + two-SersicEllipse render, forward and backward.
//
// Replaces the Pallas TPU kernels of gigalens_tpu/ops/pallas/fused_render.py:
//   K1 fused_render_fwd<false>  <- _render_primal / _fwd_kernel_primal
//   K2 fused_render_fwd<true>   <- _render_impl / _fwd_kernel (also writes
//                                  the EPL series Omega as VJP residuals)
//   K3 fused_render_bwd         <- _fused_bwd / _bwd_kernel (with
//      fused_render_bwd_epilogue, its per-sample second pass)
//
// What bounds them on the H100: arithmetic, not memory. Each (sample,
// pixel) reads 8 bytes of coordinates and writes 4 (12 with Omega; K3 reads
// 20) but runs the niter-term angular series plus two Sersic profiles:
// several hundred FP32 instructions, among them multi-instruction IEEE
// divisions and square roots and SFU transcendentals. So the design removes
// instructions, not bytes: all three kernels split the work into what
// depends on the sample alone and what depends on the pixel.
//
// A per-sample prologue, once per block, puts in shared memory the EPL
// constants (rotation, axis ratio, b, the prefactor and its reciprocals),
// each Sersic's (rotation, sqrt q and its reciprocal, b_n, 1/n, 1/R_s) and
// the series table (ratio_n, n / f, the partial sums s_t, 2n + 1). Left to
// the pixels, these are three half-angle rotations, ~15 IEEE divisions and
// ~10 square roots that are constants of the block, and one (K1/K2) or four
// (K3) divisions per series term. The pixel stage (lens_math.cuh, shared by
// the forward and the backward so they cannot drift apart) keeps only
// pixel-dependent arithmetic: one reciprocal of each radius (the EPL's
// cos/sin of the ellipse-frame angle stay IEEE quotients, which keeps
// Omega's bits), logf/expf for the powers, and the series as one complex
// multiply-add a term on the table. A block walks several 256-pixel tiles
// of its sample, which amortises the prologue (and K3's block reduction):
// K3 four; K1/K2 as many as the caller asks (ops/cuda/fused_render.py:
// fwd_tiles: eight where that still leaves every SM eight blocks, fewer for
// small batches such as the HMC's 50 chains). One pixel a thread and 4-byte
// stores, a warp's store one full 128-byte line a plane: four consecutive
// pixels a thread with 16-byte stores were 4-5% faster at equal pixels a
// block, not enough to carry a second path for ragged or unaligned planes.
// The ragged pixel edge is masked, never padded: a lane past the image
// computes nothing (a padded lane at a profile center would have R = 0 and
// turn the backward's sum into NaN).
//
// K3 reduces the cotangents of 25 per-sample quantities, not the 22
// parameter gradients: the map from those to the gradients (the half-angle
// VJP three times, the axis-ratio chains) is linear, so the epilogue kernel
// applies it once per sample, after it has summed the blocks' partials in a
// fixed order. A fixed reduction order everywhere (warp shuffles, then
// shared memory, then the epilogue's sequential sum) keeps the gradient
// bitwise repeatable from run to run, which atomics would not (HMC and the
// parity checks rely on it); the forward has no reduction at all.
#include <cuda_runtime.h>

#include "lens_math.cuh"

namespace {

using gl::EplK;
using gl::SersicK;
using gl::kMaxNiter;

constexpr int kTile = 256;
constexpr int kParams = 22;
constexpr int kSums = 25;          // K3's reduced per-sample cotangents
constexpr int kTilesPerBlock = 4;  // pixel tiles one K3 block walks
constexpr int kMaxFwdTiles = 16;   // pixel tiles a K1/K2 block walks at most
constexpr int kEpiWarps = 4;       // samples per block of K3's epilogue

// The sample's constants in shared memory, filled once per block: one
// thread per profile and one warp for the series table, each in a warp of
// its own. Ends with the barrier that publishes them.
struct SampleK {
  float p[kParams];
  EplK ek;
  SersicK sk[2];
  float4 tab[kMaxNiter];
};

__device__ __forceinline__ void sample_prologue(SampleK& k, const float* __restrict__ params,
                                                int s, int niter) {
  const int tid = threadIdx.x;
  if (tid < kParams) k.p[tid] = params[(size_t)s * kParams + tid];
  __syncthreads();
  if (tid == 0) k.ek = gl::epl_consts(k.p);
  if (tid == 64) k.sk[0] = gl::sersic_consts(k.p + 8);
  if (tid == 96) k.sk[1] = gl::sersic_consts(k.p + 15);
  if (tid >= 32 && tid < 64) gl::series_table(k.p, niter, tid - 32, k.tab);
  __syncthreads();
}

// K1/K2's pixel stage (fused_render.py: fwd_pixel): the image value and Omega
__device__ __forceinline__ float render_pixel(const SampleK& k, float x, float y, int niter,
                                              float& ox, float& oy) {
  // EPL geometry, angular series, deflection; then the shear
  const gl::EplPix g = gl::epl_pixel(k.ek, x, y);
  gl::series_fwd(g.cos_t, g.sin_t, niter, k.tab, ox, oy);
  const float g1 = k.p[6], g2 = k.p[7];
  float ax = 0.0f, ay = 0.0f;
  gl::epl_deflect(k.ek, g, ox, oy, ax, ay);
  ax = ax + g1 * x + g2 * y;
  ay = ay + g2 * x - g1 * y;
  // lens light at x, source at beta = x - alpha
  return k.sk[0].Ie * gl::sersic_fwd_pixel(x, y, k.sk[0]).E +
         k.sk[1].Ie * gl::sersic_fwd_pixel(x - ax, y - ay, k.sk[1]).E;
}

template <bool kSaveOmega>
__global__ void __launch_bounds__(kTile)
fused_render_fwd(const float* __restrict__ params, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ out,
                 float* __restrict__ oxs, float* __restrict__ oys, int npix, int niter,
                 int tiles) {
  __shared__ SampleK sm;
  const int s = blockIdx.y;
  sample_prologue(sm, params, s, niter);
  for (int j = 0; j < tiles; ++j) {
    const int i = (blockIdx.x * tiles + j) * kTile + threadIdx.x;
    if (i >= npix) break;
    const size_t o = (size_t)s * npix + i;
    float ox, oy;
    out[o] = render_pixel(sm, xs[i], ys[i], niter, ox, oy);
    if (kSaveOmega) {
      oxs[o] = ox;
      oys[o] = oy;
    }
  }
}

// Pixel stage of the whole model (fused_render.py: bwd_pixel_terms)
__device__ __forceinline__ void pixel_terms(float x, float y, float ox, float oy, float ct,
                                            int niter, const SampleK& k, float* acc) {
  const gl::EplPix g = gl::epl_pixel(k.ek, x, y);
  const float g1 = k.p[6], g2 = k.p[7];
  float ax = 0.0f, ay = 0.0f;
  gl::epl_deflect(k.ek, g, ox, oy, ax, ay);
  ax = ax + g1 * x + g2 * y;
  ay = ay + g2 * x - g1 * y;

  // light: lens light at x, source at beta = x - alpha
  float g_bx, g_by, unused_x, unused_y;
  gl::sersic_bwd_pixel(ct, x, y, k.sk[0], gl::RegAcc{acc + 9}, unused_x, unused_y);
  gl::sersic_bwd_pixel(ct, x - ax, y - ay, k.sk[1], gl::RegAcc{acc + 17}, g_bx, g_by);

  // shear, then the EPL
  const float g_ax = -g_bx, g_ay = -g_by;
  acc[7] += g_ax * x - g_ay * y;
  acc[8] += g_ax * y + g_ay * x;
  gl::epl_bwd_pixel(k.ek, g, ox, oy, g_ax, g_ay, niter, k.tab, gl::RegAcc{acc});
}

__global__ void __launch_bounds__(kTile)
fused_render_bwd(const float* __restrict__ params, const float* __restrict__ xs,
                 const float* __restrict__ ys, const float* __restrict__ oxs,
                 const float* __restrict__ oys, const float* __restrict__ cts,
                 float* __restrict__ partial, int npix, int niter) {
  __shared__ SampleK sm;
  __shared__ float red[kTile / 32][kSums];
  const int s = blockIdx.y, tid = threadIdx.x;
  sample_prologue(sm, params, s, niter);

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  for (int k = 0; k < kTilesPerBlock; ++k) {
    const int i = (blockIdx.x * kTilesPerBlock + k) * kTile + tid;
    if (i < npix) {
      const size_t o = (size_t)s * npix + i;
      pixel_terms(xs[i], ys[i], oxs[o], oys[o], cts[o], niter, sm, acc);
    }
  }

  // block reduction in a fixed order: warp shuffles, then across warps
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (tid < kSums) {
    float a = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kTile / 32; ++wi) a += red[wi][tid];
    partial[((size_t)s * gridDim.x + blockIdx.x) * kSums + tid] = a;
  }
}

// Epilogue of one sample (fused_render.py: bwd_epilogue): g = the N_SUMS
// sums -> out = the 22 parameter gradients
__device__ void bwd_epilogue(const float* p, const float* g, float* out) {
  gl::epl_epilogue(p, g, out);
  out[6] = g[7];
  out[7] = g[8];
  gl::sersic_epilogue(p + 8, g + 9, out + 8);
  gl::sersic_epilogue(p + 15, g + 17, out + 15);
}

// One warp per sample: lane k < N_SUMS sums column k of the sample's
// (n_chunks, N_SUMS) partials in chunk order; lane 0 applies the epilogue.
__global__ void __launch_bounds__(kEpiWarps * 32)
fused_render_bwd_epilogue(const float* __restrict__ params, const float* __restrict__ partial,
                          float* __restrict__ grad, int bs, int n_chunks) {
  __shared__ float sums[kEpiWarps][kSums];
  const int wl = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kEpiWarps + wl;
  if (s >= bs) return;  // uniform over the warp
  if (lane < kSums) {
    float a = 0.0f;
    for (int c = 0; c < n_chunks; ++c) a += partial[((size_t)s * n_chunks + c) * kSums + lane];
    sums[wl][lane] = a;
  }
  __syncwarp();
  if (lane == 0) bwd_epilogue(params + (size_t)s * kParams, sums[wl], grad + (size_t)s * kParams);
}

}  // namespace

extern "C" {

// tiles: pixel tiles a block walks (1..kMaxFwdTiles)
int gl_fused_render_fwd(const float* params, const float* x, const float* y, float* out,
                        float* ox, float* oy, int bs, int npix, int niter, int save_omega,
                        int tiles, void* stream) {
  if (niter < 1 || niter > kMaxNiter || tiles < 1 || tiles > kMaxFwdTiles)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((npix + kTile * tiles - 1) / (kTile * tiles), bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (save_omega)
    fused_render_fwd<true><<<grid, kTile, 0, st>>>(params, x, y, out, ox, oy, npix, niter,
                                                   tiles);
  else
    fused_render_fwd<false><<<grid, kTile, 0, st>>>(params, x, y, out, ox, oy, npix, niter,
                                                    tiles);
  return (int)cudaGetLastError();
}

int gl_fused_render_bwd(const float* params, const float* x, const float* y, const float* ox,
                        const float* oy, const float* ct, float* partial, float* grad, int bs,
                        int npix, int niter, void* stream) {
  if (niter < 1 || niter > kMaxNiter) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (npix + kTile * kTilesPerBlock - 1) / (kTile * kTilesPerBlock);
  fused_render_bwd<<<dim3(n_chunks, bs), kTile, 0, st>>>(params, x, y, ox, oy, ct, partial,
                                                         npix, niter);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_render_bwd_epilogue<<<(bs + kEpiWarps - 1) / kEpiWarps, kEpiWarps * 32, 0, st>>>(
      params, partial, grad, bs, n_chunks);
  return (int)cudaGetLastError();
}

const char* gl_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
