// Stage device functions of the composable fused render (fused_builder.cu).
//
// Each stage mirrors, line for line, its torch twin in
// gigalens_tpu_torch/ops/cuda/fused_builder.py: the forward stages follow
// the Pallas builder's tile functions (gigalens_tpu/ops/pallas/
// fused_builder.py:98-287), the *_bwd functions the hand-derived VJPs
// (tile_backward_reference), which the CPU tests hold against torch
// autograd in float64. The EPL stage reuses K1-K3's geometry, angular
// series and its O(1)-memory backward (lens_math.cuh), with the series
// depth a runtime loop count.
#pragma once

#include "lens_math.cuh"

namespace gl {

// opcodes, as ops/cuda/fused_builder.py numbers them
enum StageOp {
  kEpl = 0, kSis = 1, kShear = 2, kNfw = 3, kNfwE = 4, kSeries = 5,
  kSersicE = 8, kSersic = 9, kCoreSersic = 10, kShapelets = 11,
};
constexpr int kShapeletCap = 10;  // largest shapelet n_max (local H_n arrays)
constexpr int kMaxStages = 32;
constexpr int kFlagLstsq = 1, kFlagSource = 2;

// One stage record: opcode, first packed column, a = EPL niter | series
// order | shapelet n_max, b = series grid's first row in the extras matrix,
// flags, first output component.
struct StageRec {
  int op, off, a, b, flags, comp;
};

struct Spec {
  StageRec st[kMaxStages];  // mass stages first, then light stages
  float pf[kShapeletCap + 1];  // shapelet prefactors 1/sqrt(2^n sqrt(pi) n!)
  int n_mass, n_light, n_cols, summed;
};

// Block-level gradient accumulator of K7: each column's per-thread values
// are summed over the warp by shuffles, then lane 0 adds the warp's sum to
// its own row of shared memory. Every thread of the block calls add() for
// the same columns in the same order (the stage program is uniform over a
// block), so the shuffles never diverge; lanes past the image add 0.
struct Reducer {
  float* red;  // [warps][n_cols] in shared memory
  int n_cols, lane, warp;
  bool active;
  __device__ __forceinline__ void add(int col, float v) const {
    v = active ? v : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp * n_cols + col] += v;
  }
};

// Where K5/K6 put each light output: summed into one value, or one image
// per component at out[(comp * bs + s) * npix + i].
struct Emit {
  float* out;
  size_t stride, base;
  bool summed;
  float total;
  __device__ __forceinline__ void operator()(int comp, float v) {
    if (summed)
      total += v;
    else
      out[comp * stride + base] = v;
  }
};

// A light output's cotangent in K7: the shared (bs, P) cotangent of the
// summed render, or the component's own plane; 0 past the image.
struct Cot {
  const float* ct;
  size_t stride, base;
  bool summed, active;
  __device__ __forceinline__ float operator()(int comp) const {
    if (!active) return 0.0f;
    return summed ? ct[base] : ct[comp * stride + base];
  }
};

// ---------------------------------------------------------------------------
// mass stages: forward (adds the deflection) and VJP (cotangent on alpha)
// ---------------------------------------------------------------------------

// q = (theta_E, gamma, e1, e2, cx, cy)
__device__ __forceinline__ void epl_fwd(const float* q, int niter, float x, float y, float& ax,
                                        float& ay) {
  const EplGeom g = epl_geom(q, x, y);
  const float t = q[1] - 1.0f;
  float ox, oy;
  omega_cs(g.qx / g.R, g.yr / g.R, (1.0f - g.q) / (1.0f + g.q), t, niter, ox, oy);
  const float b = q[0] * sqrtf(g.q);
  const float pref = (2.0f * b) / (1.0f + g.q) * powp(b / g.R, t - 1.0f);
  const float axr = pref * ox, ayr = pref * oy;
  ax += axr * g.cp - ayr * g.sp;
  ay += axr * g.sp + ayr * g.cp;
}

__device__ __forceinline__ void epl_bwd(const float* q, int niter, float x, float y, float g_ax,
                                        float g_ay, int off, const Reducer& rd) {
  const float te = q[0], e1 = q[2], e2 = q[3];
  const EplGeom g = epl_geom(q, x, y);
  const float cp = g.cp, sp = g.sp, qq = g.q, R = g.R;
  const float sq = sqrtf(qq);
  const float b = te * sq;
  const float t = q[1] - 1.0f;
  const float cos_t = g.qx / R, sin_t = g.yr / R;
  const float f = (1.0f - qq) / (1.0f + qq);
  float ox, oy;
  omega_cs(cos_t, sin_t, f, t, niter, ox, oy);
  const float p0 = 2.0f * b / (1.0f + qq);
  const float lbr = logf(b / R);
  const float w = expf((t - 1.0f) * lbr);
  const float pref = p0 * w;
  const float axr = pref * ox, ayr = pref * oy;

  // rotation back from the ellipse frame
  const float g_axr = g_ax * cp + g_ay * sp;
  const float g_ayr = -g_ax * sp + g_ay * cp;
  float g_cp = g_ax * axr + g_ay * ayr;
  float g_sp = -g_ax * ayr + g_ay * axr;
  // prefactor (2 b / (1 + q)) (b / R)^(t - 1)
  const float g_pref = g_axr * ox + g_ayr * oy;
  const float g_ox = g_axr * pref, g_oy = g_ayr * pref;
  const float g_arg = g_pref * p0 * w;  // cotangent of (t - 1) log(b / R)
  float g_t = g_arg * lbr;
  const float g_lbr = g_arg * (t - 1.0f);
  const float g_b = g_lbr / b + g_pref * w * 2.0f / (1.0f + qq);
  float g_R = -g_lbr / R;
  float g_q = -g_pref * w * 2.0f * b / ((1.0f + qq) * (1.0f + qq));
  // series backward: Omega cotangents -> (cos_t, sin_t, f, t) cotangents
  float g_c, g_s, g_f, g_tt;
  omega_cs_bwd(cos_t, sin_t, f, t, niter, g_ox, g_oy, g_c, g_s, g_f, g_tt);
  g_t = g_t + g_tt;
  g_q = g_q - 2.0f * g_f / ((1.0f + qq) * (1.0f + qq));
  g_q = g_q + g_c * g.xr / R;
  float g_xr = g_c * qq / R;
  float g_yr = g_s / R;
  g_R = g_R - (g_c * cos_t + g_s * sin_t) / R;
  // R -> (q, xr, yr) -> (dx, dy, cos phi, sin phi) -> params; a radius
  // outside the clip band (a pixel on the center) passes nothing
  const float g_rr = (g.rr > 1e-10f && g.rr < 1e10f) ? g_R / g.rr : 0.0f;
  const float g_qx = g_rr * g.qx;
  g_yr = g_yr + g_rr * g.yr;
  g_q = g_q + g_qx * g.xr;
  g_xr = g_xr + g_qx * qq;
  const float g_te = g_b * sq;
  g_q = g_q + g_b * te * 0.5f / sq;
  const float g_dx = g_xr * cp - g_yr * sp;
  const float g_dy = g_xr * sp + g_yr * cp;
  g_cp = g_cp + g_xr * g.dx + g_yr * g.dy;
  g_sp = g_sp + g_xr * g.dy - g_yr * g.dx;
  const float g_cc = -2.0f * g_q / ((1.0f + g.cc) * (1.0f + g.cc));
  const float g_m = g.m < 1.0f ? g_cc : 0.0f;
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(e1, e2, g_cp, g_sp, g_e1, g_e2);
  rd.add(off, g_te);
  rd.add(off + 1, g_t);
  rd.add(off + 2, g_e1 + g_m * e1 / g.m);
  rd.add(off + 3, g_e2 + g_m * e2 / g.m);
  rd.add(off + 4, -g_dx);
  rd.add(off + 5, -g_dy);
}

// q = (theta_E, cx, cy)
__device__ __forceinline__ void sis_fwd(const float* q, float x, float y, float& ax, float& ay) {
  const float dx = x - q[1], dy = y - q[2];
  const float R = fminf(fmaxf(sqrtf(dx * dx + dy * dy), 1e-10f), 1e10f);
  ax += q[0] * dx / R;
  ay += q[0] * dy / R;
}

__device__ __forceinline__ void sis_bwd(const float* q, float x, float y, float g_ax, float g_ay,
                                        int off, const Reducer& rd) {
  const float te = q[0];
  const float dx = x - q[1], dy = y - q[2];
  const float rr = sqrtf(dx * dx + dy * dy);
  const float R = fminf(fmaxf(rr, 1e-10f), 1e10f);
  const float g_te = (g_ax * dx + g_ay * dy) / R;
  const float g_R = -g_te * te / R;
  const float g_rr = (rr > 1e-10f && rr < 1e10f) ? g_R / rr : 0.0f;
  const float g_dx = g_ax * te / R + g_rr * dx;
  const float g_dy = g_ay * te / R + g_rr * dy;
  rd.add(off, g_te);
  rd.add(off + 1, -g_dx);
  rd.add(off + 2, -g_dy);
}

// q = (gamma1, gamma2)
__device__ __forceinline__ void shear_fwd(const float* q, float x, float y, float& ax,
                                          float& ay) {
  ax += q[0] * x + q[1] * y;
  ay += q[1] * x - q[0] * y;
}

__device__ __forceinline__ void shear_bwd(float x, float y, float g_ax, float g_ay, int off,
                                          const Reducer& rd) {
  rd.add(off, g_ax * x - g_ay * y);
  rd.add(off + 1, g_ax * y + g_ay * x);
}

// Wright & Brainerd g(x) and, for the VJP, dg/dx of the SELECTED branch
// only (so no 0 * inf from an unselected one). The bands match the JAX
// tile exactly: small-x series below 0.05, the branch-point series within
// |x - 1| < 0.03, else arccosh(1/x) = log((1+sqrt(1-x^2))/x) for x < 1 and
// arccos(1/x) = atan2(sqrt(x^2-1), 1) for x > 1 (native atan2f: the JAX
// tile's polynomial atan2 is only Mosaic's constraint).
__device__ __forceinline__ float nfw_g(float x, float& dg) {
  const float xc = fmaxf(x, 1e-6f);
  float g, d;
  if (xc < 0.05f) {
    const float L = logf(2.0f / xc);
    g = xc * xc * (0.5f * L - 0.25f) + xc * xc * xc * xc * (0.375f * L - 7.0f / 32.0f);
    d = 2.0f * xc * (0.5f * L - 0.25f) - 0.5f * xc +
        4.0f * xc * xc * xc * (0.375f * L - 7.0f / 32.0f) - 0.375f * xc * xc * xc;
  } else if (fabsf(xc - 1.0f) < 0.03f) {
    const float c0 = 0.30685281944005469f, c1 = 1.0f / 3.0f, c2 = -1.0f / 30.0f,
                c3 = -1.0f / 105.0f, c4 = 17.0f / 1260.0f;
    const float t = xc - 1.0f;
    g = c0 + t * (c1 + t * (c2 + t * (c3 + t * c4)));
    d = c1 + t * (2.0f * c2 + t * (3.0f * c3 + t * 4.0f * c4));
  } else if (xc < 1.0f) {
    const float s = sqrtf(fmaxf(1.0f - xc * xc, 1e-12f));
    const float a = logf((1.0f + s) / xc);
    g = logf(xc / 2.0f) + a / s;
    const float ds = -xc / s;
    const float da = ds / (1.0f + s) - 1.0f / xc;
    d = 1.0f / xc + da / s - a * ds / (s * s);
  } else {
    const float s = sqrtf(fmaxf(xc * xc - 1.0f, 1e-12f));
    const float at = atan2f(s, 1.0f);
    g = logf(xc / 2.0f) + at / s;
    const float ds = xc / s;
    d = 1.0f / xc + ds / (xc * xc * s) - at * ds / (s * s);
  }
  dg = x > 1e-6f ? d : 0.0f;
  return g;
}

constexpr float kOneMinusLog2 = 0.30685281944005469f;  // 1 - log 2

// a(R, Rs, rho0) of (fx, fy) = a * (vx, vy) (_nfw_alpha_radial)
__device__ __forceinline__ float nfw_radial(float R, float Rs, float rho0) {
  const float Rc = fmaxf(R, 1e-7f), Rsc = fmaxf(Rs, 1e-7f);
  const float xh = Rc / Rsc;
  float unused;
  return 4.0f * rho0 * Rsc * nfw_g(xh, unused) / (xh * xh);
}

// VJP of (fx, fy) = a(R, Rs, rho0) (vx, vy): returns a; accumulates the
// radial cotangent divided by R (0 where R's floor holds), g_Rs, g_rho0
// and the direct (vx, vy) cotangents.
__device__ __forceinline__ float nfw_radial_bwd(float R, float Rs, float rho0, float vx, float vy,
                                                float g_fx, float g_fy, float& g_Rr, float& g_Rs,
                                                float& g_rho0, float& g_vx, float& g_vy) {
  const float Rc = fmaxf(R, 1e-7f), Rsc = fmaxf(Rs, 1e-7f);
  const float xh = Rc / Rsc;
  float dgx;
  const float gx = nfw_g(xh, dgx);
  const float a = 4.0f * rho0 * Rsc * gx / (xh * xh);
  const float g_a = g_fx * vx + g_fy * vy;
  g_rho0 = g_a * 4.0f * Rsc * gx / (xh * xh);
  float g_Rsc = g_a * 4.0f * rho0 * gx / (xh * xh);
  const float g_xh = g_a * 4.0f * rho0 * Rsc * (dgx / (xh * xh) - 2.0f * gx / (xh * xh * xh));
  g_Rsc = g_Rsc - g_xh * xh / Rsc;
  g_Rr = R > 1e-7f ? g_xh / Rsc / R : 0.0f;
  g_Rs = Rs > 1e-7f ? g_Rsc : 0.0f;
  g_vx = g_fx * a;
  g_vy = g_fy * a;
  return a;
}

// q = (Rs, alpha_Rs, cx, cy)
__device__ __forceinline__ void nfw_fwd(const float* q, float x, float y, float& ax, float& ay) {
  const float rho0 = q[1] / (4.0f * q[0] * q[0] * kOneMinusLog2);
  const float dx = x - q[2], dy = y - q[3];
  const float a = nfw_radial(sqrtf(dx * dx + dy * dy), q[0], rho0);
  ax += a * dx;
  ay += a * dy;
}

// rho0 = alpha_Rs / (4 Rs^2 (1 - log 2)) -> adds to g_Rs, gives g_alpha_Rs
__device__ __forceinline__ float rho0_bwd(float Rs, float alpha_Rs, float g_rho0, float& g_Rs) {
  const float inv = 1.0f / (4.0f * Rs * Rs * kOneMinusLog2);
  const float rho0 = alpha_Rs * inv;
  g_Rs = g_Rs - 2.0f * g_rho0 * rho0 / Rs;
  return g_rho0 * inv;
}

__device__ __forceinline__ void nfw_bwd(const float* q, float x, float y, float g_ax, float g_ay,
                                        int off, const Reducer& rd) {
  const float Rs = q[0], alpha_Rs = q[1];
  const float rho0 = alpha_Rs / (4.0f * Rs * Rs * kOneMinusLog2);
  const float dx = x - q[2], dy = y - q[3];
  const float R = sqrtf(dx * dx + dy * dy);
  float g_Rr, g_Rs, g_rho0, g_dx, g_dy;
  nfw_radial_bwd(R, Rs, rho0, dx, dy, g_ax, g_ay, g_Rr, g_Rs, g_rho0, g_dx, g_dy);
  g_dx = g_dx + g_Rr * dx;
  g_dy = g_dy + g_Rr * dy;
  const float g_aRs = rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs);
  rd.add(off, g_Rs);
  rd.add(off + 1, g_aRs);
  rd.add(off + 2, -g_dx);
  rd.add(off + 3, -g_dy);
}

// NFW_ELLIPSE frame: the stretched coordinates of one pixel
struct NfwEFrame {
  float cp, sp, m, c, q, n1, d1, se1, se2, dx, dy, xr, yr, xs, ys, R;
};

// q = (Rs, alpha_Rs, e1, e2, cx, cy)
__device__ __forceinline__ NfwEFrame nfw_e_frame(const float* q, float x, float y) {
  NfwEFrame f;
  half_angle(q[2], q[3], f.cp, f.sp);
  f.m = sqrtf(q[2] * q[2] + q[3] * q[3] + 1e-24f);
  f.c = fminf(f.m, 0.9999f);
  f.q = (1.0f - f.c) / (1.0f + f.c);
  f.n1 = 1.0f - f.q * f.q;
  f.d1 = 1.0f + f.q * f.q;
  const float e = fabsf(f.n1) / f.d1;
  f.se1 = sqrtf(1.0f - e);
  f.se2 = sqrtf(1.0f + e);
  f.dx = x - q[4];
  f.dy = y - q[5];
  f.xr = f.dx * f.cp + f.dy * f.sp;
  f.yr = -f.dx * f.sp + f.dy * f.cp;
  f.xs = f.xr * f.se1;
  f.ys = f.yr * f.se2;
  f.R = sqrtf(f.xs * f.xs + f.ys * f.ys);
  return f;
}

__device__ __forceinline__ void nfw_e_fwd(const float* q, float x, float y, float& ax,
                                          float& ay) {
  const float rho0 = q[1] / (4.0f * q[0] * q[0] * kOneMinusLog2);
  const NfwEFrame f = nfw_e_frame(q, x, y);
  const float a = nfw_radial(f.R, q[0], rho0);
  const float fx = a * f.xs * f.se1, fy = a * f.ys * f.se2;
  ax += fx * f.cp - fy * f.sp;
  ay += fx * f.sp + fy * f.cp;
}

__device__ __forceinline__ void nfw_e_bwd(const float* q, float x, float y, float g_ax,
                                          float g_ay, int off, const Reducer& rd) {
  const float Rs = q[0], alpha_Rs = q[1], e1 = q[2], e2 = q[3];
  const float rho0 = alpha_Rs / (4.0f * Rs * Rs * kOneMinusLog2);
  const NfwEFrame f = nfw_e_frame(q, x, y);
  const float a = nfw_radial(f.R, Rs, rho0);
  const float fx = a * f.xs, fy = a * f.ys;
  const float ox = fx * f.se1, oy = fy * f.se2;

  // rotation back
  const float g_ox = g_ax * f.cp + g_ay * f.sp;
  const float g_oy = -g_ax * f.sp + g_ay * f.cp;
  float g_cp = g_ax * ox + g_ay * oy;
  float g_sp = -g_ax * oy + g_ay * ox;
  // axis stretch of the output
  const float g_fx = g_ox * f.se1, g_fy = g_oy * f.se2;
  float g_se1 = g_ox * fx, g_se2 = g_oy * fy;
  float g_Rr, g_Rs, g_rho0, g_xs, g_ys;
  nfw_radial_bwd(f.R, Rs, rho0, f.xs, f.ys, g_fx, g_fy, g_Rr, g_Rs, g_rho0, g_xs, g_ys);
  g_xs = g_xs + g_Rr * f.xs;
  g_ys = g_ys + g_Rr * f.ys;
  // axis stretch of the input
  const float g_xr = g_xs * f.se1, g_yr = g_ys * f.se2;
  g_se1 = g_se1 + g_xs * f.xr;
  g_se2 = g_se2 + g_ys * f.yr;
  const float g_e = -g_se1 * 0.5f / f.se1 + g_se2 * 0.5f / f.se2;
  const float sgn = f.n1 > 0.0f ? 1.0f : (f.n1 < 0.0f ? -1.0f : 0.0f);
  const float g_q =
      g_e * (sgn * (-2.0f * f.q) / f.d1 - fabsf(f.n1) * 2.0f * f.q / (f.d1 * f.d1));
  const float g_c = -2.0f * g_q / ((1.0f + f.c) * (1.0f + f.c));
  const float g_m = f.m < 0.9999f ? g_c : 0.0f;
  // rotation into the ellipse frame
  const float g_dx = g_xr * f.cp - g_yr * f.sp;
  const float g_dy = g_xr * f.sp + g_yr * f.cp;
  g_cp = g_cp + g_xr * f.dx + g_yr * f.dy;
  g_sp = g_sp + g_xr * f.dy - g_yr * f.dx;
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(e1, e2, g_cp, g_sp, g_e1, g_e2);
  const float g_aRs = rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs);
  rd.add(off, g_Rs);
  rd.add(off + 1, g_aRs);
  rd.add(off + 2, g_e1 + g_m * e1 / f.m);
  rd.add(off + 3, g_e2 + g_m * e2 / f.m);
  rd.add(off + 4, -g_dx);
  rd.add(off + 5, -g_dy);
}

// q = (dv, amp); grid = this pixel's column of the (2k, P) coefficient
// rows: [0:k] alpha_x, [k:2k] alpha_y, k = order + 1
__device__ __forceinline__ void series_fwd(const float* q, int order, const float* grid,
                                           int npix, float& ax, float& ay) {
  const int k = order + 1;
  float sx = 0.0f, sy = 0.0f, wn = 1.0f;
  for (int n = 0; n < k; ++n) {
    if (n) wn = wn * q[0] / (float)n;
    sx = sx + wn * grid[(size_t)n * npix];
    sy = sy + wn * grid[(size_t)(k + n) * npix];
  }
  ax += q[1] * sx;
  ay += q[1] * sy;
}

__device__ __forceinline__ void series_bwd(const float* q, int order, const float* grid, int npix,
                                           float g_ax, float g_ay, int off, const Reducer& rd) {
  const int k = order + 1;
  float sx = 0.0f, sy = 0.0f, dsx = 0.0f, dsy = 0.0f, wn = 1.0f;
  for (int n = 0; n < k; ++n) {
    if (n) {
      // d(dv^n / n!)/d dv = dv^(n-1) / (n-1)!, the previous weight
      dsx = dsx + wn * grid[(size_t)n * npix];
      dsy = dsy + wn * grid[(size_t)(k + n) * npix];
      wn = wn * q[0] / (float)n;
    }
    sx = sx + wn * grid[(size_t)n * npix];
    sy = sy + wn * grid[(size_t)(k + n) * npix];
  }
  rd.add(off, q[1] * (g_ax * dsx + g_ay * dsy));
  rd.add(off + 1, g_ax * sx + g_ay * sy);
}

// ---------------------------------------------------------------------------
// light stages
// ---------------------------------------------------------------------------

// The 7-column SersicEllipse row of sersic_light/sersic_bwd for a stage:
// spherical Sersic has zero ellipticity, an lstsq stage unit amplitude.
__device__ __forceinline__ void sersic_row(int op, const float* q, bool lstsq, float* r) {
  if (op == kSersicE) {
    for (int j = 0; j < 6; ++j) r[j] = q[j];
    r[6] = lstsq ? 1.0f : q[6];
  } else {
    r[0] = q[0];
    r[1] = q[1];
    r[2] = r[3] = 0.0f;
    r[4] = q[2];
    r[5] = q[3];
    r[6] = lstsq ? 1.0f : q[4];
  }
}

// CoreSersic geometry; q = (R_s, n_s, Rb, alpha, gamma, e1, e2, cx, cy[, Ie])
struct CoreGeom {
  float cp, sp, c, sq, dx, dy, a, b, xt1, xt2, rr, R;
};

__device__ __forceinline__ CoreGeom core_geom(const float* q, float x, float y) {
  CoreGeom g;
  const float e1 = q[5], e2 = q[6];
  half_angle(e1, e2, g.cp, g.sp);
  g.c = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const float qq = (1.0f - g.c) / (1.0f + g.c);
  g.sq = sqrtf(qq);
  g.dx = x - q[7];
  g.dy = y - q[8];
  g.a = g.cp * g.dx + g.sp * g.dy;
  g.b = -g.sp * g.dx + g.cp * g.dy;
  g.xt1 = g.a * g.sq;
  g.xt2 = g.b / g.sq;
  g.rr = sqrtf(g.xt1 * g.xt1 + g.xt2 * g.xt2);
  g.R = fminf(fmaxf(g.rr, 1e-10f), 1e10f);
  return g;
}

__device__ __forceinline__ float core_sersic_shape(const float* q, float x, float y) {
  const CoreGeom g = core_geom(q, x, y);
  const float R_s = q[0], n_s = q[1], Rb = q[2], al = q[3], ga = q[4];
  const float bn = 1.9992f * n_s - 0.3271f;
  const float u = (powp(g.R, al) + powp(Rb, al)) / powp(R_s, al);
  return powp(1.0f + powp(Rb / g.R, al), ga / al) *
         expf(-bn * (powp(u, 1.0f / (al * n_s)) - 1.0f));
}

__device__ __forceinline__ void core_sersic_bwd(const float* q, bool lstsq, float x, float y,
                                                float ct, int off, const Reducer& rd,
                                                float& g_x, float& g_y) {
  const float R_s = q[0], n_s = q[1], Rb = q[2], al = q[3], ga = q[4], e1 = q[5], e2 = q[6];
  const CoreGeom g = core_geom(q, x, y);
  const float R = g.R;
  const float bn = 1.9992f * n_s - 0.3271f;
  const float P1 = powp(R, al), P2 = powp(Rb, al), P3 = powp(R_s, al);
  const float u = (P1 + P2) / P3;
  const float lbr = logf(Rb / R);
  const float B = expf(al * lbr);
  const float A = 1.0f + B;
  const float r = ga / al;
  const float lA = logf(A);
  const float F = expf(r * lA);
  const float k = 1.0f / (al * n_s);
  const float lu = logf(u);
  const float W = expf(k * lu);
  const float E = expf(-bn * (W - 1.0f));
  const float g_shape = lstsq ? ct : ct * q[9];
  const float g_F = g_shape * E;
  const float g_E = g_shape * F;
  const float g_bn = -g_E * E * (W - 1.0f);
  const float g_W = -g_E * E * bn;
  const float g_k = g_W * W * lu;
  const float g_u = g_W * W * k / u;
  float g_al = -g_k * k / al;
  const float g_n = -g_k * k / n_s + 1.9992f * g_bn;
  const float g_P12 = g_u / P3;  // u = (P1 + P2) / P3
  const float g_P3 = -g_u * u / P3;
  g_al = g_al + g_P12 * P1 * logf(R) + g_P12 * P2 * logf(Rb) + g_P3 * P3 * logf(R_s);
  float g_R = g_P12 * P1 * al / R;
  float g_Rb = g_P12 * P2 * al / Rb;
  const float g_Rs = g_P3 * P3 * al / R_s;
  const float g_r = g_F * F * lA;
  const float g_B = g_F * F * r / A;
  const float g_ga = g_r / al;
  g_al = g_al - g_r * ga / (al * al) + g_B * B * lbr;
  const float g_lbr = g_B * B * al;
  g_Rb = g_Rb + g_lbr / Rb;
  g_R = g_R - g_lbr / R;
  // elliptical radius -> geometry (as sersic_bwd, with R's clip band)
  const float g_rr = (g.rr > 1e-10f && g.rr < 1e10f) ? g_R / g.rr : 0.0f;
  const float g_xt1 = g_rr * g.xt1;
  const float g_xt2 = g_rr * g.xt2;
  const float g_a = g_xt1 * g.sq;
  const float g_b = g_xt2 / g.sq;
  const float g_sq = g_xt1 * g.a - g_xt2 * g.xt2 / g.sq;
  const float g_cp = g_a * g.dx + g_b * g.dy;
  const float g_sp = g_a * g.dy - g_b * g.dx;
  const float g_dx = g_a * g.cp - g_b * g.sp;
  const float g_dy = g_a * g.sp + g_b * g.cp;
  const float g_q = g_sq * 0.5f / g.sq;
  const float g_c = -2.0f * g_q / ((1.0f + g.c) * (1.0f + g.c));
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(e1, e2, g_cp, g_sp, g_e1, g_e2);
  rd.add(off, g_Rs);
  rd.add(off + 1, g_n);
  rd.add(off + 2, g_Rb);
  rd.add(off + 3, g_al);
  rd.add(off + 4, g_ga);
  rd.add(off + 5, g_e1 + g_c * e1 / g.c);
  rd.add(off + 6, g_e2 + g_c * e2 / g.c);
  rd.add(off + 7, -g_dx);
  rd.add(off + 8, -g_dy);
  if (!lstsq) rd.add(off + 9, ct * F * E);
  g_x = g_dx;
  g_y = g_dy;
}

// Raw physicists' Hermite polynomials H_0..H_nmax at w (H[n] for n <= n_max)
__device__ __forceinline__ void hermites(float w, int n_max, float* H) {
  H[0] = 1.0f;
  H[1] = 2.0f * w;
#pragma unroll
  for (int n = 1; n < kShapeletCap; ++n) {
    if (n >= n_max) break;
    H[n + 1] = 2.0f * (w * H[n] - (float)n * H[n - 1]);
  }
}

// q = (beta, cx, cy[, amp_0..amp_L-1]); components in triangular order:
// by total order N, then (n1, n2) = (N - j, j)
__device__ __forceinline__ void shapelets_fwd(const float* q, int n_max, bool lstsq, int comp,
                                              float x, float y, const float* pf, Emit& emit) {
  const float u = (x - q[1]) / q[0];
  const float v = (y - q[2]) / q[0];
  const float gauss = expf(-(u * u + v * v) / 2.0f);
  float hu[kShapeletCap + 1], hv[kShapeletCap + 1];
  hermites(u, n_max, hu);
  hermites(v, n_max, hv);
#pragma unroll
  for (int n = 0; n <= kShapeletCap; ++n) {
    hu[n] = pf[n] * hu[n];
    hv[n] = pf[n] * hv[n];
  }
  float total = 0.0f;
  int k = 0;
#pragma unroll
  for (int N = 0; N <= kShapeletCap; ++N) {
    if (N > n_max) break;
#pragma unroll
    for (int j = 0; j <= N; ++j) {
      const float c = gauss * hu[N - j] * hv[j];
      if (lstsq)
        emit(comp + k, c);
      else
        total = total + q[3 + k] * c;
      ++k;
    }
  }
  if (!lstsq) emit(comp, total);
}

__device__ __forceinline__ void shapelets_bwd(const float* q, int n_max, bool lstsq, int comp,
                                              float x, float y, const float* pf, const Cot& cot,
                                              int off, const Reducer& rd, float& g_x,
                                              float& g_y) {
  const float beta = q[0];
  const float u = (x - q[1]) / beta;
  const float v = (y - q[2]) / beta;
  const float gauss = expf(-(u * u + v * v) / 2.0f);
  float Hu[kShapeletCap + 1], Hv[kShapeletCap + 1];
  float hu[kShapeletCap + 1], hv[kShapeletCap + 1];
  float g_hu[kShapeletCap + 1], g_hv[kShapeletCap + 1];
  hermites(u, n_max, Hu);
  hermites(v, n_max, Hv);
#pragma unroll
  for (int n = 0; n <= kShapeletCap; ++n) {
    hu[n] = pf[n] * Hu[n];
    hv[n] = pf[n] * Hv[n];
    g_hu[n] = g_hv[n] = 0.0f;
  }
  const float ct = cot(comp);
  float g_gauss = 0.0f;
  int k = 0;
#pragma unroll
  for (int N = 0; N <= kShapeletCap; ++N) {
    if (N > n_max) break;
#pragma unroll
    for (int j = 0; j <= N; ++j) {
      const int n1 = N - j, n2 = j;
      float w;
      if (lstsq) {
        w = cot(comp + k);  // cotangent of component k
      } else {
        rd.add(off + 3 + k, ct * (gauss * hu[n1] * hv[n2]));
        w = ct * q[3 + k];
      }
      g_gauss = g_gauss + w * hu[n1] * hv[n2];
      g_hu[n1] = g_hu[n1] + w * gauss * hv[n2];
      g_hv[n2] = g_hv[n2] + w * gauss * hu[n1];
      ++k;
    }
  }
  // d H_n / dw = 2 n H_{n-1}
  float g_u = -g_gauss * gauss * u;
  float g_v = -g_gauss * gauss * v;
#pragma unroll
  for (int n = 1; n <= kShapeletCap; ++n) {
    if (n > n_max) break;
    g_u = g_u + g_hu[n] * pf[n] * 2.0f * (float)n * Hu[n - 1];
    g_v = g_v + g_hv[n] * pf[n] * 2.0f * (float)n * Hv[n - 1];
  }
  g_x = g_u / beta;
  g_y = g_v / beta;
  rd.add(off, -(g_u * u + g_v * v) / beta);
  rd.add(off + 1, -g_x);
  rd.add(off + 2, -g_y);
}

}  // namespace gl
