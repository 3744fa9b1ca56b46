// Device math shared by the fused-render kernels (fused_render.cu).
//
// Each function mirrors, line for line, its torch twin in
// gigalens_tpu_torch/ops/cuda/_math.py and ops/cuda/fused_render.py, which
// in turn mirror the Pallas kernel's helpers (gigalens_tpu/ops/pallas/
// _math.py: half_angle, powp; fused_render.py: _sersic_light, _tile_geom,
// _tile_out; profiles/mass/epl.py: _omega_cs_impl, _omega_cs_bwd). The
// hand-derived VJPs (*_bwd) are checked against torch autograd of the
// twins on the CPU; the card confirms only this translation.
#pragma once

namespace gl {

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

// SersicEllipse surface brightness; p = (R_s, n_s, e1, e2, cx, cy, Ie)
__device__ __forceinline__ float sersic_light(float x, float y, const float* p) {
  float cp, sp;
  half_angle(p[2], p[3], cp, sp);
  // epsilon inside the sqrt: finite gradient at exactly zero ellipticity
  const float c = sqrtf(p[2] * p[2] + p[3] * p[3] + 1e-24f);
  const float q = (1.0f - c) / (1.0f + c);
  const float dx = x - p[4], dy = y - p[5];
  const float xt1 = (cp * dx + sp * dy) * sqrtf(q);
  const float xt2 = (-sp * dx + cp * dy) / sqrtf(q);
  const float R = sqrtf(xt1 * xt1 + xt2 * xt2);
  const float bn = 1.9992f * p[1] - 0.3271f;
  return p[6] * expf(-bn * (powp(R / p[0], 1.0f / p[1]) - 1.0f));
}

// VJP of sersic_light for cotangent g: accumulates the 7 parameter
// cotangents into gp[0..6] and returns the coordinate cotangents.
__device__ __forceinline__ void sersic_bwd(float g, float x, float y, const float* p,
                                           float* gp, float& g_x, float& g_y) {
  const float R_s = p[0], n_s = p[1], e1 = p[2], e2 = p[3], Ie = p[6];
  float cp, sp;
  half_angle(e1, e2, cp, sp);
  const float c = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const float q = (1.0f - c) / (1.0f + c);
  const float sq = sqrtf(q);
  const float dx = x - p[4], dy = y - p[5];
  const float a = cp * dx + sp * dy;
  const float b = -sp * dx + cp * dy;
  const float xt1 = a * sq;
  const float xt2 = b / sq;
  const float R = sqrtf(xt1 * xt1 + xt2 * xt2);
  const float bn = 1.9992f * n_s - 0.3271f;
  const float k = 1.0f / n_s;
  const float u = R / R_s;
  const float lu = logf(u);
  const float w = expf(k * lu);
  const float E = expf(-bn * (w - 1.0f));
  const float g_ie = g * E;
  const float g_s = g * Ie * E;  // cotangent of the exponent -bn (w - 1)
  const float g_w = -g_s * bn;
  const float g_bn = -g_s * (w - 1.0f);
  const float g_kl = g_w * w;  // cotangent of k * log(u)
  const float g_k = g_kl * lu;
  const float g_u = g_kl * k / u;
  const float g_r = g_u / R_s;
  const float g_rs = -g_u * u / R_s;
  const float g_n = 1.9992f * g_bn - g_k * k * k;
  const float g_xt1 = g_r * xt1 / R;
  const float g_xt2 = g_r * xt2 / R;
  const float g_a = g_xt1 * sq;
  const float g_b = g_xt2 / sq;
  const float g_sq = g_xt1 * a - g_xt2 * xt2 / sq;
  const float g_cp = g_a * dx + g_b * dy;
  const float g_sp = g_a * dy - g_b * dx;
  const float g_dx = g_a * cp - g_b * sp;
  const float g_dy = g_a * sp + g_b * cp;
  const float g_q = g_sq * 0.5f / sq;
  const float g_c = -2.0f * g_q / ((1.0f + c) * (1.0f + c));
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(e1, e2, g_cp, g_sp, g_e1, g_e2);
  gp[0] += g_rs;
  gp[1] += g_n;
  gp[2] += g_e1 + g_c * e1 / c;
  gp[3] += g_e2 + g_c * e2 / c;
  gp[4] += -g_dx;
  gp[5] += -g_dy;
  gp[6] += g_ie;
  g_x = g_dx;
  g_y = g_dy;
}

// EPL ellipse-frame geometry of one pixel (shared by forward and backward)
struct EplGeom {
  float cp, sp;    // rotation (cos phi, sin phi)
  float m, cc, q;  // |e| with its floor, min(|e|, 1), axis ratio
  float dx, dy, xr, yr, qx;
  float rr, R;     // raw and clipped elliptical radius
};

// p = the 22-column parameter row
__device__ __forceinline__ EplGeom epl_geom(const float* p, float x, float y) {
  EplGeom g;
  const float e1 = p[2], e2 = p[3];
  half_angle(e1, e2, g.cp, g.sp);
  g.m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  g.cc = fminf(g.m, 1.0f);
  g.q = (1.0f - g.cc) / (1.0f + g.cc);
  g.dx = x - p[4];
  g.dy = y - p[5];
  g.xr = g.dx * g.cp + g.dy * g.sp;
  g.yr = -g.dx * g.sp + g.dy * g.cp;
  g.qx = g.q * g.xr;
  g.rr = sqrtf(g.qx * g.qx + g.yr * g.yr);
  g.R = fminf(fmaxf(g.rr, 1e-10f), 1e10f);
  return g;
}

// Forward angular series Omega = sum_n a_n (epl.py:_omega_cs_impl)
__device__ __forceinline__ void omega_cs(float cos_t, float sin_t, float f, float t, int niter,
                                         float& ox, float& oy) {
  const float cos_2t = cos_t * cos_t - sin_t * sin_t;
  const float sin_2t = 2.0f * cos_t * sin_t;
  float ax = cos_t, ay = sin_t;
  ox = cos_t;
  oy = sin_t;
  for (int i = 1; i < niter; ++i) {
    const float n = (float)i;
    const float ratio = -f * (2.0f * n - (2.0f - t)) / (2.0f * n + (2.0f - t));
    const float nx = ratio * (cos_2t * ax - sin_2t * ay);
    const float ny = ratio * (sin_2t * ax + cos_2t * ay);
    ax = nx;
    ay = ny;
    ox += ax;
    oy += ay;
  }
}

// O(1)-memory series backward (epl.py:_omega_cs_bwd), one pixel
__device__ __forceinline__ void omega_cs_bwd(float cos_t, float sin_t, float f, float t,
                                             int niter, float ct_x, float ct_y, float& g_c,
                                             float& g_s, float& g_f, float& g_t) {
  // f32 rounds f to exactly 0 at zero ellipticity; the (n / f) partial
  // would then give inf * 0 = NaN (epl.py:131)
  f = fmaxf(f, 1e-20f);
  const float cos_2t = cos_t * cos_t - sin_t * sin_t;
  const float sin_2t = 2.0f * cos_t * sin_t;
  float ax = cos_t, ay = sin_t, s_t = 0.0f;
  float g_th = -ct_x * sin_t + ct_y * cos_t;
  float g_rho = ct_x * cos_t + ct_y * sin_t;
  g_f = 0.0f;
  g_t = 0.0f;
  for (int i = 1; i < niter; ++i) {
    const float n = (float)i;
    const float ratio = -f * (2.0f * n - (2.0f - t)) / (2.0f * n + (2.0f - t));
    const float nx = ratio * (cos_2t * ax - sin_2t * ay);
    const float ny = ratio * (sin_2t * ax + cos_2t * ay);
    ax = nx;
    ay = ny;
    s_t = s_t + 1.0f / (2.0f * n - 2.0f + t) + 1.0f / (2.0f * n + 2.0f - t);
    const float dot = ct_x * ax + ct_y * ay;
    g_th += (2.0f * n + 1.0f) * (-ct_x * ay + ct_y * ax);
    g_rho += (2.0f * n + 1.0f) * dot;
    g_f += (n / f) * dot;
    g_t += s_t * dot;
  }
  g_c = cos_t * g_rho - sin_t * g_th;
  g_s = sin_t * g_rho + cos_t * g_th;
}

}  // namespace gl
