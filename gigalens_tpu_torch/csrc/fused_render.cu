// Fused EPL+Shear ray-shoot + two-SersicEllipse render, forward and backward.
//
// Replaces the Pallas TPU kernels of gigalens_tpu/ops/pallas/fused_render.py:
//   K1 fused_render_fwd<false>  <- _render_primal / _fwd_kernel_primal
//   K2 fused_render_fwd<true>   <- _render_impl / _fwd_kernel (also writes
//                                  the EPL series Omega as VJP residuals)
//   K3 fused_render_bwd         <- _fused_bwd / _bwd_kernel (with
//      fused_render_bwd_epilogue, its per-sample second pass)
//
// What bounds it on the H100: arithmetic, not memory. Each (sample, pixel)
// reads 8 bytes of coordinates and writes 4 (12 with Omega) but runs the
// niter-term angular series plus two Sersic profiles (~6 exp/log, ~10
// divisions, a few sqrts): several hundred FP32 instructions, many of them
// multi-instruction IEEE division/sqrt sequences and SFU transcendentals.
// Design: one thread per (sample, pixel), a block = one sample x 256
// pixels, so the sample's 22 parameters are one broadcast read per block
// (staged in shared memory) and the series carries stay in registers; the
// series depth is a runtime loop. The ragged pixel edge is masked, never
// padded: a lane past the image computes nothing (a padded lane at a
// profile center would have R = 0 and turn the backward's sum into NaN).
//
// K3 (redesigned) splits the backward into what depends on the pixel and
// what depends on the sample alone. A per-sample prologue, once per block,
// puts in shared memory the EPL constants (rotation, axis ratio, b, the
// prefactor's reciprocals), each Sersic's (rotation, sqrt q, b_n, 1/n,
// 1/R_s) and the series table (ratio_n, n / f, the partial sums s_t, 2n + 1):
// before, each pixel redid three half-angle rotations and four IEEE
// divisions per series term. The pixel stage keeps only pixel-dependent
// arithmetic (one reciprocal of each R) and reduces the cotangents of 25
// per-sample quantities, not the 22 parameter gradients: the map from those
// to the gradients (the half-angle VJP three times, the axis-ratio chains)
// is linear, so the epilogue kernel applies it once per sample, after it has
// summed the blocks' partials in a fixed order. A block walks four 256-pixel
// tiles of its sample, which amortises the prologue and the block
// reduction. A fixed reduction order everywhere (warp shuffles, then shared
// memory, then the epilogue's sequential sum) keeps the gradient bitwise
// repeatable from run to run, which atomics would not (HMC and the parity
// checks rely on it); the two launches replace the one kernel and a torch
// sum of before, so the launches per HMC leapfrog do not grow.
#include <cuda_runtime.h>

#include "lens_math.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kParams = 22;
constexpr int kSums = 25;          // K3's reduced per-sample cotangents
constexpr int kMaxNiter = 64;      // rows of K3's series table
constexpr int kTilesPerBlock = 4;  // pixel tiles one K3 block walks
constexpr int kEpiWarps = 4;       // samples per block of K3's epilogue

template <bool kSaveOmega>
__global__ void __launch_bounds__(kTile)
fused_render_fwd(const float* __restrict__ params, const float* __restrict__ xs,
                 const float* __restrict__ ys, float* __restrict__ out,
                 float* __restrict__ oxs, float* __restrict__ oys, int npix, int niter) {
  __shared__ float p[kParams];
  const int s = blockIdx.y;
  if (threadIdx.x < kParams) p[threadIdx.x] = params[(size_t)s * kParams + threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= npix) return;
  const float x = xs[i], y = ys[i];

  // geometry and angular series (_tile_geom, _omega_cs_impl)
  const gl::EplGeom g = gl::epl_geom(p, x, y);
  const float cos_t = g.qx / g.R, sin_t = g.yr / g.R;
  const float f = (1.0f - g.q) / (1.0f + g.q);
  const float t = p[1] - 1.0f;
  float ox, oy;
  gl::omega_cs(cos_t, sin_t, f, t, niter, ox, oy);

  // output map (_tile_out): EPL deflection, shear, shoot, two Sersics
  const float b = p[0] * sqrtf(g.q);
  const float pref = (2.0f * b) / (1.0f + g.q) * gl::powp(b / g.R, t - 1.0f);
  const float axr = pref * ox, ayr = pref * oy;
  const float ax = axr * g.cp - ayr * g.sp + p[6] * x + p[7] * y;
  const float ay = axr * g.sp + ayr * g.cp + p[7] * x - p[6] * y;
  const float v = gl::sersic_light(x, y, p + 8) + gl::sersic_light(x - ax, y - ay, p + 15);

  const size_t o = (size_t)s * npix + i;
  out[o] = v;
  if (kSaveOmega) {
    oxs[o] = ox;
    oys[o] = oy;
  }
}

// Per-sample constants of K3's pixel stage (fused_render.py: _epl_consts,
// _sersic_consts, _series_table), computed once per block.
struct EplK {
  float cp, sp, q, b, t, p0, ib, two_i1q, c_qb, c_qf, g1, g2, cx, cy;
};
struct SersicK {
  float cp, sp, sq, isq, half_isq, bn, k, kk, kRs, iRs, Ie, cx, cy;
};

__device__ __forceinline__ void epl_q(float e1, float e2, float& m, float& cc, float& q) {
  m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  cc = fminf(m, 1.0f);
  q = (1.0f - cc) / (1.0f + cc);
}

__device__ EplK epl_consts(const float* p) {
  EplK k;
  gl::half_angle(p[2], p[3], k.cp, k.sp);
  float m, cc;
  epl_q(p[2], p[3], m, cc, k.q);
  k.b = p[0] * sqrtf(k.q);
  k.t = p[1] - 1.0f;
  k.p0 = 2.0f * k.b / (1.0f + k.q);
  k.ib = 1.0f / k.b;
  k.two_i1q = 2.0f / (1.0f + k.q);
  const float i1q2 = 1.0f / ((1.0f + k.q) * (1.0f + k.q));
  k.c_qb = 2.0f * k.b * i1q2;
  k.c_qf = -2.0f * i1q2;
  k.g1 = p[6];
  k.g2 = p[7];
  k.cx = p[4];
  k.cy = p[5];
  return k;
}

// p = (R_s, n_s, e1, e2, cx, cy, Ie)
__device__ SersicK sersic_consts(const float* p) {
  SersicK k;
  gl::half_angle(p[2], p[3], k.cp, k.sp);
  const float c = sqrtf(p[2] * p[2] + p[3] * p[3] + 1e-24f);
  const float q = (1.0f - c) / (1.0f + c);
  k.sq = sqrtf(q);
  k.isq = 1.0f / k.sq;
  k.half_isq = 0.5f * k.isq;
  k.bn = 1.9992f * p[1] - 0.3271f;
  k.k = 1.0f / p[1];
  k.kk = k.k * k.k;
  k.kRs = k.k * p[0];
  k.iRs = 1.0f / p[0];
  k.Ie = p[6];
  k.cx = p[4];
  k.cy = p[5];
  return k;
}

// One warp fills the series table: lane l writes rows n = 2l + 1, 2l + 2
// (n < niter) as (ratio_n, n / f, s_t(n), 2n + 1); s_t is a warp scan of
// the increments 1/(2n - 2 + t) + 1/(2n + 2 - t), in a fixed order.
__device__ void series_table(const float* p, int niter, int lane, float4* tab) {
  float m, cc, q;
  epl_q(p[2], p[3], m, cc, q);
  // f32 rounds f to exactly 0 at zero ellipticity; the (n / f) partial
  // would then give inf * 0 = NaN (epl.py:131)
  const float f = fmaxf((1.0f - q) / (1.0f + q), 1e-20f);
  const float t = p[1] - 1.0f;
  float inc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float n = (float)(2 * lane + 1 + j);
    inc[j] = 2 * lane + 1 + j < niter
                 ? 1.0f / (2.0f * n - 2.0f + t) + 1.0f / (2.0f * n + 2.0f - t)
                 : 0.0f;
  }
  float scan = inc[0] + inc[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += v;
  }
  float st = __shfl_up_sync(0xffffffffu, scan, 1);
  if (lane == 0) st = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = 2 * lane + 1 + j;
    const float n = (float)i;
    st += inc[j];
    if (i < niter)
      tab[i] = make_float4(-f * (2.0f * n - (2.0f - t)) / (2.0f * n + (2.0f - t)), n / f, st,
                           2.0f * n + 1.0f);
  }
}

// Pixel stage of one Sersic at (x, y): adds its 8 cotangent terms (R_s,
// n_s, Ie, cos phi, sin phi, q, dx, dy) to acc, returns (g_x, g_y)
__device__ __forceinline__ void sersic_pixel(float g, float x, float y, const SersicK& k,
                                             float* acc, float& g_x, float& g_y) {
  const float dx = x - k.cx, dy = y - k.cy;
  const float a = k.cp * dx + k.sp * dy;
  const float bb = -k.sp * dx + k.cp * dy;
  const float xt1 = a * k.sq, xt2 = bb * k.isq;
  const float R = sqrtf(xt1 * xt1 + xt2 * xt2);
  const float iR = 1.0f / R;
  const float u = R * k.iRs;
  const float lu = logf(u);
  const float w = expf(k.k * lu);
  const float E = expf(-k.bn * (w - 1.0f));
  const float g_s = g * k.Ie * E;  // cotangent of the exponent -bn (w - 1)
  const float g_w = -g_s * k.bn;
  const float g_bn = -g_s * (w - 1.0f);
  const float g_kl = g_w * w;  // cotangent of k * log(u)
  const float g_k = g_kl * lu;
  const float g_u = g_kl * k.kRs * iR;  // k / u = k R_s / R
  const float g_r = g_u * k.iRs;
  const float g_xt1 = g_r * xt1 * iR, g_xt2 = g_r * xt2 * iR;
  const float g_a = g_xt1 * k.sq, g_b = g_xt2 * k.isq;
  g_x = g_a * k.cp - g_b * k.sp;
  g_y = g_a * k.sp + g_b * k.cp;
  acc[0] += -g_u * u * k.iRs;
  acc[1] += 1.9992f * g_bn - g_k * k.kk;
  acc[2] += g * E;
  acc[3] += g_a * dx + g_b * dy;
  acc[4] += g_a * dy - g_b * dx;
  acc[5] += (g_xt1 * a - g_xt2 * xt2 * k.isq) * k.half_isq;
  acc[6] += g_x;
  acc[7] += g_y;
}

// Pixel stage of the whole model (fused_render.py: bwd_pixel_terms)
__device__ __forceinline__ void pixel_terms(float x, float y, float ox, float oy, float ct,
                                            int niter, const EplK& e, const SersicK& ll,
                                            const SersicK& src, const float4* tab,
                                            float* acc) {
  const float dx = x - e.cx, dy = y - e.cy;
  const float xr = dx * e.cp + dy * e.sp;
  const float yr = -dx * e.sp + dy * e.cp;
  const float qx = e.q * xr;
  const float rr = sqrtf(qx * qx + yr * yr);
  const float R = fminf(fmaxf(rr, 1e-10f), 1e10f);
  const float iR = 1.0f / R;
  const float lbr = logf(e.b * iR);
  const float w = expf((e.t - 1.0f) * lbr);
  const float pref = e.p0 * w;
  const float axr = pref * ox, ayr = pref * oy;
  const float ax = axr * e.cp - ayr * e.sp + e.g1 * x + e.g2 * y;
  const float ay = axr * e.sp + ayr * e.cp + e.g2 * x - e.g1 * y;

  // light: lens light at x, source at beta = x - alpha
  float g_bx, g_by, unused_x, unused_y;
  sersic_pixel(ct, x, y, ll, acc + 9, unused_x, unused_y);
  sersic_pixel(ct, x - ax, y - ay, src, acc + 17, g_bx, g_by);

  // shear and the rotation back from the ellipse frame
  const float g_ax = -g_bx, g_ay = -g_by;
  acc[7] += g_ax * x - g_ay * y;
  acc[8] += g_ax * y + g_ay * x;
  const float g_axr = g_ax * e.cp + g_ay * e.sp;
  const float g_ayr = -g_ax * e.sp + g_ay * e.cp;
  const float g_cp = g_ax * axr + g_ay * ayr;
  const float g_sp = -g_ax * ayr + g_ay * axr;
  // prefactor (2 b / (1 + q)) (b / R)^(t - 1)
  const float g_pref = g_axr * ox + g_ayr * oy;
  const float g_ox = g_axr * pref, g_oy = g_ayr * pref;
  const float g_arg = g_pref * pref;  // cotangent of (t - 1) log(b / R)
  float g_t = g_arg * lbr;
  const float g_lbr = g_arg * (e.t - 1.0f);
  const float g_b = g_lbr * e.ib + g_pref * w * e.two_i1q;
  float g_R = -g_lbr * iR;
  float g_q = -g_pref * w * e.c_qb;

  // series backward from the per-sample table
  const float cos_t = qx * iR, sin_t = yr * iR;
  const float cos_2t = cos_t * cos_t - sin_t * sin_t;
  const float sin_2t = 2.0f * cos_t * sin_t;
  float a_x = cos_t, a_y = sin_t;
  float g_th = -g_ox * sin_t + g_oy * cos_t;
  float g_rho = g_ox * cos_t + g_oy * sin_t;
  float g_f = 0.0f, g_tt = 0.0f;
  for (int n = 1; n < niter; ++n) {
    const float4 tb = tab[n];
    const float nx = tb.x * (cos_2t * a_x - sin_2t * a_y);
    const float ny = tb.x * (sin_2t * a_x + cos_2t * a_y);
    a_x = nx;
    a_y = ny;
    const float dot = g_ox * a_x + g_oy * a_y;
    g_th += tb.w * (-g_ox * a_y + g_oy * a_x);
    g_rho += tb.w * dot;
    g_f += tb.y * dot;
    g_tt += tb.z * dot;
  }
  const float g_c = cos_t * g_rho - sin_t * g_th;
  const float g_s = sin_t * g_rho + cos_t * g_th;
  g_t = g_t + g_tt;
  g_q = g_q + g_f * e.c_qf;
  g_q = g_q + g_c * xr * iR;
  float g_xr = g_c * e.q * iR;
  float g_yr = g_s * iR;
  g_R = g_R - (g_c * cos_t + g_s * sin_t) * iR;

  // R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi); R = rr where unclipped
  const float g_rr = (rr > 1e-10f && rr < 1e10f) ? g_R : 0.0f;
  const float g_qx = g_rr * qx * iR;
  g_yr = g_yr + g_rr * yr * iR;
  g_q = g_q + g_qx * xr;
  g_xr = g_xr + g_qx * e.q;
  acc[0] += g_b;
  acc[1] += g_t;
  acc[2] += g_q;
  acc[3] += g_cp + g_xr * dx + g_yr * dy;
  acc[4] += g_sp + g_xr * dy - g_yr * dx;
  acc[5] += g_xr * e.cp - g_yr * e.sp;
  acc[6] += g_xr * e.sp + g_yr * e.cp;
}

__global__ void __launch_bounds__(kTile)
fused_render_bwd(const float* __restrict__ params, const float* __restrict__ xs,
                 const float* __restrict__ ys, const float* __restrict__ oxs,
                 const float* __restrict__ oys, const float* __restrict__ cts,
                 float* __restrict__ partial, int npix, int niter) {
  __shared__ float p[kParams];
  __shared__ EplK ek;
  __shared__ SersicK sk[2];
  __shared__ float4 tab[kMaxNiter];
  __shared__ float red[kTile / 32][kSums];
  const int s = blockIdx.y, tid = threadIdx.x;
  if (tid < kParams) p[tid] = params[(size_t)s * kParams + tid];
  __syncthreads();
  // prologue: one thread per profile and one warp for the series table,
  // each in a warp of its own
  if (tid == 0) ek = epl_consts(p);
  if (tid == 64) sk[0] = sersic_consts(p + 8);
  if (tid == 96) sk[1] = sersic_consts(p + 15);
  if (tid >= 32 && tid < 64) series_table(p, niter, tid - 32, tab);
  __syncthreads();

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
  for (int k = 0; k < kTilesPerBlock; ++k) {
    const int i = (blockIdx.x * kTilesPerBlock + k) * kTile + tid;
    if (i < npix) {
      const size_t o = (size_t)s * npix + i;
      pixel_terms(xs[i], ys[i], oxs[o], oys[o], cts[o], niter, ek, sk[0], sk[1], tab, acc);
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
  float m, cc, q;
  epl_q(p[2], p[3], m, cc, q);
  const float sq = sqrtf(q);
  const float g_q = g[2] + g[0] * p[0] * 0.5f / sq;
  const float g_cc = -2.0f * g_q / ((1.0f + cc) * (1.0f + cc));
  const float g_m = m < 1.0f ? g_cc : 0.0f;
  float g_e1 = 0.0f, g_e2 = 0.0f;
  gl::half_angle_bwd(p[2], p[3], g[3], g[4], g_e1, g_e2);
  out[0] = g[0] * sq;
  out[1] = g[1];
  out[2] = g_e1 + g_m * p[2] / m;
  out[3] = g_e2 + g_m * p[3] / m;
  out[4] = -g[5];
  out[5] = -g[6];
  out[6] = g[7];
  out[7] = g[8];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float* ps = p + 8 + 7 * j;
    const float* gs = g + 9 + 8 * j;
    float* os = out + 8 + 7 * j;
    const float c = sqrtf(ps[2] * ps[2] + ps[3] * ps[3] + 1e-24f);
    const float g_c = -2.0f * gs[5] / ((1.0f + c) * (1.0f + c));
    float h1 = 0.0f, h2 = 0.0f;
    gl::half_angle_bwd(ps[2], ps[3], gs[3], gs[4], h1, h2);
    os[0] = gs[0];
    os[1] = gs[1];
    os[2] = h1 + g_c * ps[2] / c;
    os[3] = h2 + g_c * ps[3] / c;
    os[4] = -gs[6];
    os[5] = -gs[7];
    os[6] = gs[2];
  }
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

int gl_fused_render_fwd(const float* params, const float* x, const float* y, float* out,
                        float* ox, float* oy, int bs, int npix, int niter, int save_omega,
                        void* stream) {
  const dim3 grid((npix + kTile - 1) / kTile, bs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (save_omega)
    fused_render_fwd<true><<<grid, kTile, 0, st>>>(params, x, y, out, ox, oy, npix, niter);
  else
    fused_render_fwd<false><<<grid, kTile, 0, st>>>(params, x, y, out, ox, oy, npix, niter);
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
