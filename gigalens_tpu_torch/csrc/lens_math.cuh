// Device math shared by the fused-render kernels (fused_render.cu) and the
// composable render's stages (stages.cuh).
//
// Every profile is written in two parts: what depends on the sample alone
// (*_consts, series_table: computed once per block into shared memory) and
// what depends on the pixel (epl_pixel, series_fwd, sersic_fwd_pixel for
// the forward; epl_bwd_pixel, sersic_bwd_pixel for the VJP, which reduce
// cotangents of per-sample quantities; epl_epilogue, sersic_epilogue, which
// map those sums to parameter gradients once per sample). The forward and
// the backward kernels call the same pixel functions, so they cannot drift
// apart. Each function mirrors, line for line, its torch twin in
// gigalens_tpu_torch/ops/cuda/_math.py and ops/cuda/fused_render.py, which
// in turn follow the Pallas kernel's helpers (gigalens_tpu/ops/pallas/
// _math.py: half_angle, powp; fused_render.py: _sersic_light, _tile_geom,
// _tile_out; profiles/mass/epl.py: _omega_cs_impl, _omega_cs_bwd). The
// hand-derived VJPs are checked against torch autograd of the twins on the
// CPU; the card confirms only this translation.
#pragma once

namespace gl {

constexpr int kMaxNiter = 64;  // rows of the per-sample series table

// base ** expo for strictly positive base (exp/log, as the twins compute it)
__device__ __forceinline__ float powp(float base, float expo) {
  return expf(expo * logf(base));
}

// (cos phi, sin phi) for phi = atan2(e2, e1) / 2, pure algebra. Kept from
// the TPU kernel on purpose: it keeps HMC energies smooth, unlike an
// atan2 + cos/sin round trip.
__device__ __forceinline__ void half_angle(float e1, float e2, float& cp, float& sp) {
  const float m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const bool degenerate = m <= 1e-11f;
  const float c2 = degenerate ? 1.0f : e1 / m;
  const float s2 = degenerate ? 0.0f : e2 / m;
  const float cp_pos = sqrtf(fmaxf((1.0f + c2) * 0.5f, 1e-12f));
  const float sgn = e2 >= 0.0f ? 1.0f : -1.0f;
  const float sp_neg = sgn * sqrtf(fmaxf((1.0f - c2) * 0.5f, 1e-12f));
  if (e1 >= 0.0f) {
    cp = cp_pos;
    sp = 0.5f * s2 / cp_pos;
  } else {
    cp = 0.5f * s2 / sp_neg;
    sp = sp_neg;
  }
}

// VJP of half_angle: (g_cp, g_sp) -> (g_e1, g_e2), accumulated
__device__ __forceinline__ void half_angle_bwd(float e1, float e2, float g_cp, float g_sp,
                                               float& g_e1, float& g_e2) {
  const float m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const bool degenerate = m <= 1e-11f;
  const float c2 = degenerate ? 1.0f : e1 / m;
  const float s2 = degenerate ? 0.0f : e2 / m;
  const bool pos = e1 >= 0.0f;
  const float a = (1.0f + c2) * 0.5f;
  const float cp_pos = sqrtf(fmaxf(a, 1e-12f));
  const float sgn = e2 >= 0.0f ? 1.0f : -1.0f;
  const float b = (1.0f - c2) * 0.5f;
  const float sq_b = sqrtf(fmaxf(b, 1e-12f));
  const float sp_neg = sgn * sq_b;
  const float g_cp_pos = pos ? g_cp - g_sp * 0.5f * s2 / (cp_pos * cp_pos) : 0.0f;
  const float g_sp_neg = pos ? 0.0f : g_sp - g_cp * 0.5f * s2 / (sp_neg * sp_neg);
  float g_s2 = pos ? g_sp * 0.5f / cp_pos : g_cp * 0.5f / sp_neg;
  float g_c2 = a > 1e-12f ? g_cp_pos * 0.25f / cp_pos : 0.0f;
  g_c2 = g_c2 - (b > 1e-12f ? g_sp_neg * sgn * 0.25f / sq_b : 0.0f);
  if (degenerate) {
    g_c2 = 0.0f;
    g_s2 = 0.0f;
  }
  const float g_m = -(g_c2 * e1 + g_s2 * e2) / (m * m);
  g_e1 += g_c2 / m + g_m * e1 / m;
  g_e2 += g_s2 / m + g_m * e2 / m;
}

// Where a backward pixel stage adds its terms: K3 keeps them in registers
// (the indices are compile-time constants after inlining), K7 in a
// per-thread column of shared memory (stages.cuh: SmemAcc).
struct RegAcc {
  float* a;
  __device__ __forceinline__ void add(int k, float v) const { a[k] += v; }
};

// ---------------------------------------------------------------------------
// EPL: per-sample constants, series table, pixel stages, epilogue
// ---------------------------------------------------------------------------

struct EplK {
  float cp, sp, q, b, t, p0, ib, two_i1q, c_qb, c_qf, cx, cy;
};
constexpr int kEplSums = 7;  // cotangents of b, t, q, cos phi, sin phi, dx, dy

__device__ __forceinline__ void epl_q(float e1, float e2, float& m, float& cc, float& q) {
  m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  cc = fminf(m, 1.0f);
  q = (1.0f - cc) / (1.0f + cc);
}

// p = (theta_E, gamma, e1, e2, cx, cy)
__device__ inline EplK epl_consts(const float* p) {
  EplK k;
  half_angle(p[2], p[3], k.cp, k.sp);
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
  k.cx = p[4];
  k.cy = p[5];
  return k;
}

// One warp fills the series table: lane l writes rows n = 2l + 1, 2l + 2
// (n < niter) as (ratio_n, n / f, s_t(n), 2n + 1); s_t is a warp scan of
// the increments 1/(2n - 2 + t) + 1/(2n + 2 - t), in a fixed order. The
// forward reads only ratio_n: the same expression as per pixel, so the
// series keeps its bits.
__device__ inline void series_table(const float* p, int niter, int lane, float4* tab) {
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

// What the EPL needs of one pixel, forward and backward alike
struct EplPix {
  float dx, dy, xr, yr, qx, rr, iR, cos_t, sin_t, lbr, w, pref;
};

// (cos_t, sin_t) are IEEE quotients, as the one-stage form has them (the
// series then keeps its bits); everything else takes the one reciprocal.
__device__ __forceinline__ EplPix epl_pixel(const EplK& e, float x, float y) {
  EplPix g;
  g.dx = x - e.cx;
  g.dy = y - e.cy;
  g.xr = g.dx * e.cp + g.dy * e.sp;
  g.yr = -g.dx * e.sp + g.dy * e.cp;
  g.qx = e.q * g.xr;
  g.rr = sqrtf(g.qx * g.qx + g.yr * g.yr);
  const float R = fminf(fmaxf(g.rr, 1e-10f), 1e10f);
  g.iR = 1.0f / R;
  g.cos_t = g.qx / R;
  g.sin_t = g.yr / R;
  g.lbr = logf(e.b * g.iR);
  g.w = expf((e.t - 1.0f) * g.lbr);
  g.pref = e.p0 * g.w;  // (2 b / (1 + q)) (b / R)^(t - 1)
  return g;
}

// Forward angular series Omega = sum_n a_n (epl.py:_omega_cs_impl), one
// complex multiply-add a term on the table's ratio_n
__device__ __forceinline__ void series_fwd(float cos_t, float sin_t, int niter,
                                           const float4* tab, float& ox, float& oy) {
  const float cos_2t = cos_t * cos_t - sin_t * sin_t;
  const float sin_2t = 2.0f * cos_t * sin_t;
  float ax = cos_t, ay = sin_t;
  ox = cos_t;
  oy = sin_t;
  for (int n = 1; n < niter; ++n) {
    const float ratio = tab[n].x;
    const float nx = ratio * (cos_2t * ax - sin_2t * ay);
    const float ny = ratio * (sin_2t * ax + cos_2t * ay);
    ax = nx;
    ay = ny;
    ox += ax;
    oy += ay;
  }
}

// Adds the EPL deflection of the pixel to (ax, ay)
__device__ __forceinline__ void epl_deflect(const EplK& e, const EplPix& g, float ox, float oy,
                                            float& ax, float& ay) {
  const float axr = g.pref * ox, ayr = g.pref * oy;
  ax += axr * e.cp - ayr * e.sp;
  ay += axr * e.sp + ayr * e.cp;
}

// Backward pixel stage of the EPL for the cotangent (g_ax, g_ay) on its
// deflection: adds the kEplSums cotangent terms (fused_render.py:
// epl_bwd_pixel). The series backward (epl.py:_omega_cs_bwd) runs on the
// per-sample table.
template <class Acc>
__device__ __forceinline__ void epl_bwd_pixel(const EplK& e, const EplPix& g, float ox, float oy,
                                              float g_ax, float g_ay, int niter,
                                              const float4* tab, const Acc& acc) {
  const float iR = g.iR, cos_t = g.cos_t, sin_t = g.sin_t;
  const float axr = g.pref * ox, ayr = g.pref * oy;
  // the rotation back from the ellipse frame
  const float g_axr = g_ax * e.cp + g_ay * e.sp;
  const float g_ayr = -g_ax * e.sp + g_ay * e.cp;
  const float g_cp = g_ax * axr + g_ay * ayr;
  const float g_sp = -g_ax * ayr + g_ay * axr;
  // prefactor (2 b / (1 + q)) (b / R)^(t - 1)
  const float g_pref = g_axr * ox + g_ayr * oy;
  const float g_ox = g_axr * g.pref, g_oy = g_ayr * g.pref;
  const float g_arg = g_pref * g.pref;  // cotangent of (t - 1) log(b / R)
  float g_t = g_arg * g.lbr;
  const float g_lbr = g_arg * (e.t - 1.0f);
  const float g_b = g_lbr * e.ib + g_pref * g.w * e.two_i1q;
  float g_R = -g_lbr * iR;
  float g_q = -g_pref * g.w * e.c_qb;

  // series backward from the per-sample table
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
  g_q = g_q + g_c * g.xr * iR;
  float g_xr = g_c * e.q * iR;
  float g_yr = g_s * iR;
  g_R = g_R - (g_c * cos_t + g_s * sin_t) * iR;

  // R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi); R = rr where unclipped
  const float g_rr = (g.rr > 1e-10f && g.rr < 1e10f) ? g_R : 0.0f;
  const float g_qx = g_rr * g.qx * iR;
  g_yr = g_yr + g_rr * g.yr * iR;
  g_q = g_q + g_qx * g.xr;
  g_xr = g_xr + g_qx * e.q;
  acc.add(0, g_b);
  acc.add(1, g_t);
  acc.add(2, g_q);
  acc.add(3, g_cp + g_xr * g.dx + g_yr * g.dy);
  acc.add(4, g_sp + g_xr * g.dy - g_yr * g.dx);
  acc.add(5, g_xr * e.cp - g_yr * e.sp);
  acc.add(6, g_xr * e.sp + g_yr * e.cp);
}

// Epilogue of one EPL (fused_render.py: epl_epilogue): g = its kEplSums
// sums -> out = the gradients of (theta_E, gamma, e1, e2, cx, cy). Linear
// in g: theta_E = b / sqrt q, the axis-ratio chain, the half-angle VJP.
__device__ inline void epl_epilogue(const float* p, const float* g, float* out) {
  float m, cc, q;
  epl_q(p[2], p[3], m, cc, q);
  const float sq = sqrtf(q);
  const float g_q = g[2] + g[0] * p[0] * 0.5f / sq;
  const float g_cc = -2.0f * g_q / ((1.0f + cc) * (1.0f + cc));
  const float g_m = m < 1.0f ? g_cc : 0.0f;
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(p[2], p[3], g[3], g[4], g_e1, g_e2);
  out[0] = g[0] * sq;
  out[1] = g[1];
  out[2] = g_e1 + g_m * p[2] / m;
  out[3] = g_e2 + g_m * p[3] / m;
  out[4] = -g[5];
  out[5] = -g[6];
}

// ---------------------------------------------------------------------------
// SersicEllipse: per-sample constants, pixel stages, epilogue
// ---------------------------------------------------------------------------

struct SersicK {
  float cp, sp, sq, isq, half_isq, bn, k, kk, kRs, iRs, Ie, cx, cy;
};
// cotangents of R_s, n_s, Ie, cos phi, sin phi, q, dx, dy
constexpr int kSersicSums = 8;

// p = (R_s, n_s, e1, e2, cx, cy, Ie)
__device__ inline SersicK sersic_consts(const float* p) {
  SersicK k;
  half_angle(p[2], p[3], k.cp, k.sp);
  // epsilon inside the sqrt: finite gradient at exactly zero ellipticity
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

// What a Sersic needs of one pixel; its surface brightness is Ie * E
struct SersicPix {
  float dx, dy, a, xt1, xt2, R, u, lu, w, E;
};

__device__ __forceinline__ SersicPix sersic_fwd_pixel(float x, float y, const SersicK& k) {
  SersicPix s;
  s.dx = x - k.cx;
  s.dy = y - k.cy;
  s.a = k.cp * s.dx + k.sp * s.dy;
  const float bb = -k.sp * s.dx + k.cp * s.dy;
  s.xt1 = s.a * k.sq;
  s.xt2 = bb * k.isq;
  s.R = sqrtf(s.xt1 * s.xt1 + s.xt2 * s.xt2);
  s.u = s.R * k.iRs;
  s.lu = logf(s.u);
  s.w = expf(k.k * s.lu);
  s.E = expf(-k.bn * (s.w - 1.0f));
  return s;
}

// Backward pixel stage of one Sersic at (x, y) for the cotangent g on its
// surface brightness: adds its kSersicSums terms, returns (g_x, g_y)
template <class Acc>
__device__ __forceinline__ void sersic_bwd_pixel(float g, float x, float y, const SersicK& k,
                                                 const Acc& acc, float& g_x, float& g_y) {
  const SersicPix s = sersic_fwd_pixel(x, y, k);
  const float iR = 1.0f / s.R;
  const float g_s = g * k.Ie * s.E;  // cotangent of the exponent -bn (w - 1)
  const float g_w = -g_s * k.bn;
  const float g_bn = -g_s * (s.w - 1.0f);
  const float g_kl = g_w * s.w;  // cotangent of k * log(u)
  const float g_k = g_kl * s.lu;
  const float g_u = g_kl * k.kRs * iR;  // k / u = k R_s / R
  const float g_r = g_u * k.iRs;
  const float g_xt1 = g_r * s.xt1 * iR, g_xt2 = g_r * s.xt2 * iR;
  const float g_a = g_xt1 * k.sq, g_b = g_xt2 * k.isq;
  g_x = g_a * k.cp - g_b * k.sp;
  g_y = g_a * k.sp + g_b * k.cp;
  acc.add(0, -g_u * s.u * k.iRs);
  acc.add(1, 1.9992f * g_bn - g_k * k.kk);
  acc.add(2, g * s.E);
  acc.add(3, g_a * s.dx + g_b * s.dy);
  acc.add(4, g_a * s.dy - g_b * s.dx);
  acc.add(5, (g_xt1 * s.a - g_xt2 * s.xt2 * k.isq) * k.half_isq);
  acc.add(6, g_x);
  acc.add(7, g_y);
}

// Epilogue of one Sersic: g = its kSersicSums sums -> out = the gradients
// of (R_s, n_s, e1, e2, cx, cy, Ie); p = its 7-column row
__device__ inline void sersic_epilogue(const float* p, const float* g, float* out) {
  const float c = sqrtf(p[2] * p[2] + p[3] * p[3] + 1e-24f);
  const float g_c = -2.0f * g[5] / ((1.0f + c) * (1.0f + c));
  float h1 = 0.0f, h2 = 0.0f;
  half_angle_bwd(p[2], p[3], g[3], g[4], h1, h2);
  out[0] = g[0];
  out[1] = g[1];
  out[2] = h1 + g_c * p[2] / c;
  out[3] = h2 + g_c * p[3] / c;
  out[4] = -g[6];
  out[5] = -g[7];
  out[6] = g[2];
}

}  // namespace gl
