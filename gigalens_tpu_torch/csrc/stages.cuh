// Stage device functions of the composable fused render (fused_builder.cu).
//
// Each stage is written in up to four parts, mirrored line for line by its
// torch twin in gigalens_tpu_torch/ops/cuda/fused_builder.py:
//   *_consts    what depends on the sample alone (rotation, sqrt q and its
//               reciprocal, b, 1/n, 1/R_s, ...), computed once per block into
//               the stage's slot of shared memory (stage_consts);
//   *_fwd       the pixel's forward from those constants (K5/K6, and K7's
//               recompute), following the Pallas builder's tile functions
//               (gigalens_tpu/ops/pallas/fused_builder.py:98-287);
//   *_bwd       the pixel's hand-derived VJP, which adds cotangent terms of
//               per-sample quantities to the stage's sums;
//   stage_epilogue  the map from a stage's sums to its parameter gradients,
//               once per sample (linear in the sums: the half-angle VJP, the
//               axis-ratio chains, theta_E = b / sqrt q, rho0's chain).
// The EPL and the Sersics are lens_math.cuh's, shared with K1-K3. Stages
// with nothing to hoist (SIS, Shear, NFW, the Taylor series) keep their
// per-pixel code; their sums are their gradients and the epilogue copies
// them. The CPU tests hold the twins against torch autograd in float64.
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
constexpr int kBuilderTile = 256;  // threads of a block, one pixel each
constexpr int kSlot = 24;          // floats of per-sample constants a stage may hold

// One stage record: opcode, first packed column, a = EPL niter | series
// order | shapelet n_max, b = EPL: index of its series table | series:
// its grid's first row in the extras matrix, flags, first output component,
// first column of its sums.
struct StageRec {
  int op, off, a, b, flags, comp, soff;
};

struct Spec {
  StageRec st[kMaxStages];  // mass stages first, then light stages
  float pf[kShapeletCap + 1];  // shapelet prefactors 1/sqrt(2^n sqrt(pi) n!)
  int n_mass, n_light, n_cols, n_sums, n_epl, summed;
};

// K7's accumulator: each thread owns one float of every sums column, laid
// out column-major ([column][thread]) so a warp's access is conflict-free.
// A stage adds its terms with plain shared-memory read-modify-writes (no
// shuffles in the pixel loop); the block reduces the columns once, after
// its last tile.
struct SmemAcc {
  float* base;  // this thread's float of the stage's first column
  __device__ __forceinline__ void add(int k, float v) const { base[k * kBuilderTile] += v; }
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
// summed render, or the component's own plane.
struct Cot {
  const float* ct;
  size_t stride, base;
  bool summed;
  __device__ __forceinline__ float operator()(int comp) const {
    return summed ? ct[base] : ct[comp * stride + base];
  }
};

// ---------------------------------------------------------------------------
// mass stages: forward (adds the deflection) and VJP (cotangent on alpha)
// ---------------------------------------------------------------------------

// q = (theta_E, cx, cy)
__device__ __forceinline__ void sis_fwd(const float* q, float x, float y, float& ax, float& ay) {
  const float dx = x - q[1], dy = y - q[2];
  const float R = fminf(fmaxf(sqrtf(dx * dx + dy * dy), 1e-10f), 1e10f);
  ax += q[0] * dx / R;
  ay += q[0] * dy / R;
}

__device__ __forceinline__ void sis_bwd(const float* q, float x, float y, float g_ax, float g_ay,
                                        const SmemAcc& acc) {
  const float te = q[0];
  const float dx = x - q[1], dy = y - q[2];
  const float rr = sqrtf(dx * dx + dy * dy);
  const float R = fminf(fmaxf(rr, 1e-10f), 1e10f);
  const float g_te = (g_ax * dx + g_ay * dy) / R;
  const float g_R = -g_te * te / R;
  const float g_rr = (rr > 1e-10f && rr < 1e10f) ? g_R / rr : 0.0f;
  const float g_dx = g_ax * te / R + g_rr * dx;
  const float g_dy = g_ay * te / R + g_rr * dy;
  acc.add(0, g_te);
  acc.add(1, -g_dx);
  acc.add(2, -g_dy);
}

// q = (gamma1, gamma2)
__device__ __forceinline__ void shear_fwd(const float* q, float x, float y, float& ax,
                                          float& ay) {
  ax += q[0] * x + q[1] * y;
  ay += q[1] * x - q[0] * y;
}

__device__ __forceinline__ void shear_bwd(float x, float y, float g_ax, float g_ay,
                                          const SmemAcc& acc) {
  acc.add(0, g_ax * x - g_ay * y);
  acc.add(1, g_ax * y + g_ay * x);
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
                                        const SmemAcc& acc) {
  const float Rs = q[0], alpha_Rs = q[1];
  const float rho0 = alpha_Rs / (4.0f * Rs * Rs * kOneMinusLog2);
  const float dx = x - q[2], dy = y - q[3];
  const float R = sqrtf(dx * dx + dy * dy);
  float g_Rr, g_Rs, g_rho0, g_dx, g_dy;
  nfw_radial_bwd(R, Rs, rho0, dx, dy, g_ax, g_ay, g_Rr, g_Rs, g_rho0, g_dx, g_dy);
  g_dx = g_dx + g_Rr * dx;
  g_dy = g_dy + g_Rr * dy;
  const float g_aRs = rho0_bwd(Rs, alpha_Rs, g_rho0, g_Rs);
  acc.add(0, g_Rs);
  acc.add(1, g_aRs);
  acc.add(2, -g_dx);
  acc.add(3, -g_dy);
}

// NFW_ELLIPSE: the axis stretch (1 -+ e)^(1/2) from the axis ratio
__device__ __forceinline__ void nfw_e_stretch(float e1, float e2, float& m, float& c, float& q,
                                              float& n1, float& d1, float& se1, float& se2) {
  m = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  c = fminf(m, 0.9999f);
  q = (1.0f - c) / (1.0f + c);
  n1 = 1.0f - q * q;
  d1 = 1.0f + q * q;
  const float e = fabsf(n1) / d1;
  se1 = sqrtf(1.0f - e);
  se2 = sqrtf(1.0f + e);
}

struct NfwEK {
  float cp, sp, se1, se2, Rs, rho0, cx, cy;
};
// cotangents of Rs (direct), rho0, cos phi, sin phi, se1, se2, dx, dy
constexpr int kNfwESums = 8;

// q = (Rs, alpha_Rs, e1, e2, cx, cy)
__device__ inline NfwEK nfw_e_consts(const float* q) {
  NfwEK k;
  half_angle(q[2], q[3], k.cp, k.sp);
  float m, c, qq, n1, d1;
  nfw_e_stretch(q[2], q[3], m, c, qq, n1, d1, k.se1, k.se2);
  k.Rs = q[0];
  k.rho0 = q[1] / (4.0f * q[0] * q[0] * kOneMinusLog2);
  k.cx = q[4];
  k.cy = q[5];
  return k;
}

// The stretched coordinates of one pixel
struct NfwEPix {
  float dx, dy, xr, yr, xs, ys, R;
};

__device__ __forceinline__ NfwEPix nfw_e_pixel(const NfwEK& k, float x, float y) {
  NfwEPix f;
  f.dx = x - k.cx;
  f.dy = y - k.cy;
  f.xr = f.dx * k.cp + f.dy * k.sp;
  f.yr = -f.dx * k.sp + f.dy * k.cp;
  f.xs = f.xr * k.se1;
  f.ys = f.yr * k.se2;
  f.R = sqrtf(f.xs * f.xs + f.ys * f.ys);
  return f;
}

__device__ __forceinline__ void nfw_e_fwd(const NfwEK& k, float x, float y, float& ax,
                                          float& ay) {
  const NfwEPix f = nfw_e_pixel(k, x, y);
  const float a = nfw_radial(f.R, k.Rs, k.rho0);
  const float fx = a * f.xs * k.se1, fy = a * f.ys * k.se2;
  ax += fx * k.cp - fy * k.sp;
  ay += fx * k.sp + fy * k.cp;
}

__device__ __forceinline__ void nfw_e_bwd(const NfwEK& k, float x, float y, float g_ax,
                                          float g_ay, const SmemAcc& acc) {
  const NfwEPix f = nfw_e_pixel(k, x, y);
  const float a = nfw_radial(f.R, k.Rs, k.rho0);
  const float fx = a * f.xs, fy = a * f.ys;
  const float ox = fx * k.se1, oy = fy * k.se2;

  // rotation back
  const float g_ox = g_ax * k.cp + g_ay * k.sp;
  const float g_oy = -g_ax * k.sp + g_ay * k.cp;
  float g_cp = g_ax * ox + g_ay * oy;
  float g_sp = -g_ax * oy + g_ay * ox;
  // axis stretch of the output
  const float g_fx = g_ox * k.se1, g_fy = g_oy * k.se2;
  float g_se1 = g_ox * fx, g_se2 = g_oy * fy;
  float g_Rr, g_Rs, g_rho0, g_xs, g_ys;
  nfw_radial_bwd(f.R, k.Rs, k.rho0, f.xs, f.ys, g_fx, g_fy, g_Rr, g_Rs, g_rho0, g_xs, g_ys);
  g_xs = g_xs + g_Rr * f.xs;
  g_ys = g_ys + g_Rr * f.ys;
  // axis stretch of the input
  const float g_xr = g_xs * k.se1, g_yr = g_ys * k.se2;
  g_se1 = g_se1 + g_xs * f.xr;
  g_se2 = g_se2 + g_ys * f.yr;
  // rotation into the ellipse frame
  g_cp = g_cp + g_xr * f.dx + g_yr * f.dy;
  g_sp = g_sp + g_xr * f.dy - g_yr * f.dx;
  acc.add(0, g_Rs);
  acc.add(1, g_rho0);
  acc.add(2, g_cp);
  acc.add(3, g_sp);
  acc.add(4, g_se1);
  acc.add(5, g_se2);
  acc.add(6, g_xr * k.cp - g_yr * k.sp);
  acc.add(7, g_xr * k.sp + g_yr * k.cp);
}

// g = the kNfwESums sums -> out = the gradients of (Rs, alpha_Rs, e1, e2, cx, cy)
__device__ inline void nfw_e_epilogue(const float* q, const float* g, float* out) {
  const float Rs = q[0], alpha_Rs = q[1], e1 = q[2], e2 = q[3];
  float m, c, qq, n1, d1, se1, se2;
  nfw_e_stretch(e1, e2, m, c, qq, n1, d1, se1, se2);
  const float g_e = -g[4] * 0.5f / se1 + g[5] * 0.5f / se2;
  const float sgn = n1 > 0.0f ? 1.0f : (n1 < 0.0f ? -1.0f : 0.0f);
  const float g_q = g_e * (sgn * (-2.0f * qq) / d1 - fabsf(n1) * 2.0f * qq / (d1 * d1));
  const float g_c = -2.0f * g_q / ((1.0f + c) * (1.0f + c));
  const float g_m = m < 0.9999f ? g_c : 0.0f;
  float g_e1 = 0.0f, g_e2 = 0.0f;
  half_angle_bwd(e1, e2, g[2], g[3], g_e1, g_e2);
  float g_Rs = g[0];
  const float g_aRs = rho0_bwd(Rs, alpha_Rs, g[1], g_Rs);
  out[0] = g_Rs;
  out[1] = g_aRs;
  out[2] = g_e1 + g_m * e1 / m;
  out[3] = g_e2 + g_m * e2 / m;
  out[4] = -g[6];
  out[5] = -g[7];
}

// q = (dv, amp); grid = this pixel's column of the (2k, P) coefficient
// rows: [0:k] alpha_x, [k:2k] alpha_y, k = order + 1
__device__ __forceinline__ void series_stage_fwd(const float* q, int order, const float* grid,
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

__device__ __forceinline__ void series_stage_bwd(const float* q, int order, const float* grid,
                                                 int npix, float g_ax, float g_ay,
                                                 const SmemAcc& acc) {
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
  acc.add(0, q[1] * (g_ax * dsx + g_ay * dsy));
  acc.add(1, g_ax * sx + g_ay * sy);
}

// ---------------------------------------------------------------------------
// light stages
// ---------------------------------------------------------------------------

// The 7-column SersicEllipse row of sersic_consts for a stage: spherical
// Sersic has zero ellipticity, an lstsq stage unit amplitude.
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

// A Sersic stage's sums -> its packed gradient columns
__device__ inline void sersic_stage_epilogue(int op, const float* q, bool lstsq, const float* g,
                                             float* out) {
  float row[7], t[7];
  sersic_row(op, q, lstsq, row);
  sersic_epilogue(row, g, t);
  if (op == kSersicE) {
    for (int j = 0; j < 6; ++j) out[j] = t[j];
    if (!lstsq) out[6] = t[6];
  } else {
    out[0] = t[0];
    out[1] = t[1];
    out[2] = t[4];
    out[3] = t[5];
    if (!lstsq) out[4] = t[6];
  }
}

// CoreSersic; q = (R_s, n_s, Rb, alpha, gamma, e1, e2, cx, cy[, Ie])
struct CoreK {
  float cp, sp, sq, isq, half_isq, cx, cy, bn, al, r, k, P2, P3, lRb, lRs, amp;
};
// cotangents of R_s, n_s, Rb, alpha, gamma, cos phi, sin phi, q, dx, dy, Ie
constexpr int kCoreSums = 11;

__device__ inline CoreK core_consts(const float* q, bool lstsq) {
  CoreK k;
  const float R_s = q[0], n_s = q[1], Rb = q[2], al = q[3], ga = q[4], e1 = q[5], e2 = q[6];
  half_angle(e1, e2, k.cp, k.sp);
  const float c = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const float qq = (1.0f - c) / (1.0f + c);
  k.sq = sqrtf(qq);
  k.isq = 1.0f / k.sq;
  k.half_isq = 0.5f * k.isq;
  k.cx = q[7];
  k.cy = q[8];
  k.bn = 1.9992f * n_s - 0.3271f;
  k.al = al;
  k.r = ga / al;
  k.k = 1.0f / (al * n_s);
  k.lRb = logf(Rb);
  k.lRs = logf(R_s);
  k.P2 = expf(al * k.lRb);
  k.P3 = expf(al * k.lRs);
  k.amp = lstsq ? 1.0f : q[9];
  return k;
}

// What the CoreSersic needs of one pixel; its shape is F * E
struct CorePix {
  float dx, dy, a, xt1, xt2, rr, R, lR, P1, u, lbr, B, A, lA, F, lu, W, E;
};

__device__ __forceinline__ CorePix core_pixel(const CoreK& k, float x, float y) {
  CorePix g;
  g.dx = x - k.cx;
  g.dy = y - k.cy;
  g.a = k.cp * g.dx + k.sp * g.dy;
  const float bb = -k.sp * g.dx + k.cp * g.dy;
  g.xt1 = g.a * k.sq;
  g.xt2 = bb * k.isq;
  g.rr = sqrtf(g.xt1 * g.xt1 + g.xt2 * g.xt2);
  g.R = fminf(fmaxf(g.rr, 1e-10f), 1e10f);
  g.lR = logf(g.R);
  g.P1 = expf(k.al * g.lR);
  g.u = (g.P1 + k.P2) / k.P3;
  g.lbr = k.lRb - g.lR;  // log(Rb / R)
  g.B = expf(k.al * g.lbr);
  g.A = 1.0f + g.B;
  g.lA = logf(g.A);
  g.F = expf(k.r * g.lA);
  g.lu = logf(g.u);
  g.W = expf(k.k * g.lu);
  g.E = expf(-k.bn * (g.W - 1.0f));
  return g;
}

__device__ __forceinline__ void core_sersic_bwd(const float* q, const CoreK& k, bool lstsq,
                                                float x, float y, float ct, const SmemAcc& acc,
                                                float& g_x, float& g_y) {
  const float R_s = q[0], n_s = q[1], Rb = q[2], al = q[3], ga = q[4];
  const CorePix g = core_pixel(k, x, y);
  const float g_shape = ct * k.amp;
  const float g_F = g_shape * g.E;
  const float g_E = g_shape * g.F;
  const float g_bn = -g_E * g.E * (g.W - 1.0f);
  const float g_W = -g_E * g.E * k.bn;
  const float g_k = g_W * g.W * g.lu;
  const float g_u = g_W * g.W * k.k / g.u;
  float g_al = -g_k * k.k / al;
  const float g_n = -g_k * k.k / n_s + 1.9992f * g_bn;
  const float g_P12 = g_u / k.P3;  // u = (P1 + P2) / P3
  const float g_P3 = -g_u * g.u / k.P3;
  g_al = g_al + g_P12 * g.P1 * g.lR + g_P12 * k.P2 * k.lRb + g_P3 * k.P3 * k.lRs;
  float g_R = g_P12 * g.P1 * al / g.R;
  float g_Rb = g_P12 * k.P2 * al / Rb;
  const float g_Rs = g_P3 * k.P3 * al / R_s;
  const float g_r = g_F * g.F * g.lA;
  const float g_B = g_F * g.F * k.r / g.A;
  const float g_ga = g_r / al;
  g_al = g_al - g_r * ga / (al * al) + g_B * g.B * g.lbr;
  const float g_lbr = g_B * g.B * al;
  g_Rb = g_Rb + g_lbr / Rb;
  g_R = g_R - g_lbr / g.R;
  // elliptical radius -> geometry (as the Sersic's, with R's clip band)
  const float g_rr = (g.rr > 1e-10f && g.rr < 1e10f) ? g_R / g.rr : 0.0f;
  const float g_xt1 = g_rr * g.xt1;
  const float g_xt2 = g_rr * g.xt2;
  const float g_a = g_xt1 * k.sq;
  const float g_b = g_xt2 * k.isq;
  g_x = g_a * k.cp - g_b * k.sp;
  g_y = g_a * k.sp + g_b * k.cp;
  acc.add(0, g_Rs);
  acc.add(1, g_n);
  acc.add(2, g_Rb);
  acc.add(3, g_al);
  acc.add(4, g_ga);
  acc.add(5, g_a * g.dx + g_b * g.dy);
  acc.add(6, g_a * g.dy - g_b * g.dx);
  acc.add(7, (g_xt1 * g.a - g_xt2 * g.xt2 * k.isq) * k.half_isq);
  acc.add(8, g_x);
  acc.add(9, g_y);
  if (!lstsq) acc.add(10, ct * g.F * g.E);
}

// g = the kCoreSums sums -> out = the gradients of the 9 (10) columns
__device__ inline void core_epilogue(const float* q, bool lstsq, const float* g, float* out) {
  const float e1 = q[5], e2 = q[6];
  const float c = sqrtf(e1 * e1 + e2 * e2 + 1e-24f);
  const float g_c = -2.0f * g[7] / ((1.0f + c) * (1.0f + c));
  float h1 = 0.0f, h2 = 0.0f;
  half_angle_bwd(e1, e2, g[5], g[6], h1, h2);
  for (int j = 0; j < 5; ++j) out[j] = g[j];
  out[5] = h1 + g_c * e1 / c;
  out[6] = h2 + g_c * e2 / c;
  out[7] = -g[8];
  out[8] = -g[9];
  if (!lstsq) out[9] = g[10];
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
struct ShapeletK {
  float ib, cx, cy;  // 1 / beta and the center
};

__device__ inline ShapeletK shapelet_consts(const float* q) {
  return ShapeletK{1.0f / q[0], q[1], q[2]};
}

__device__ __forceinline__ int shapelet_count(int n_max) {
  return (n_max + 1) * (n_max + 2) / 2;
}

__device__ __forceinline__ void shapelets_fwd(const float* q, const ShapeletK& sk, int n_max,
                                              bool lstsq, int comp, float x, float y,
                                              const float* pf, Emit& emit) {
  const float u = (x - sk.cx) * sk.ib;
  const float v = (y - sk.cy) * sk.ib;
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

// sums: beta, cx, cy, then the sampled amplitudes (its gradients themselves)
__device__ __forceinline__ void shapelets_bwd(const float* q, const ShapeletK& sk, int n_max,
                                              bool lstsq, int comp, float x, float y,
                                              const float* pf, const Cot& cot,
                                              const SmemAcc& acc, float& g_x, float& g_y) {
  const float u = (x - sk.cx) * sk.ib;
  const float v = (y - sk.cy) * sk.ib;
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
        acc.add(3 + k, ct * (gauss * hu[n1] * hv[n2]));
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
  g_x = g_u * sk.ib;
  g_y = g_v * sk.ib;
  acc.add(0, -(g_u * u + g_v * v) * sk.ib);
  acc.add(1, -g_x);
  acc.add(2, -g_y);
}

// ---------------------------------------------------------------------------
// the per-sample parts of a stage program
// ---------------------------------------------------------------------------

template <class K>
__device__ __forceinline__ const K& slot_as(const float* slots, int k) {
  static_assert(sizeof(K) <= kSlot * sizeof(float), "stage constants exceed their slot");
  return *reinterpret_cast<const K*>(slots + k * kSlot);
}

// Fills stage r's slot from its packed columns q (one thread)
__device__ inline void stage_consts(const StageRec& r, const float* q, float* slot) {
  const bool lstsq = r.flags & kFlagLstsq;
  switch (r.op) {
    case kEpl: *reinterpret_cast<EplK*>(slot) = epl_consts(q); break;
    case kNfwE: *reinterpret_cast<NfwEK*>(slot) = nfw_e_consts(q); break;
    case kSersicE:
    case kSersic: {
      float row[7];
      sersic_row(r.op, q, lstsq, row);
      *reinterpret_cast<SersicK*>(slot) = sersic_consts(row);
      break;
    }
    case kCoreSersic: *reinterpret_cast<CoreK*>(slot) = core_consts(q, lstsq); break;
    case kShapelets: *reinterpret_cast<ShapeletK*>(slot) = shapelet_consts(q); break;
    default: break;  // SIS, Shear, NFW, series: nothing to hoist
  }
}

// Maps stage r's sums g to its packed gradient columns out (one thread)
__device__ inline void stage_epilogue(const StageRec& r, const float* q, const float* g,
                                      float* out) {
  const bool lstsq = r.flags & kFlagLstsq;
  int n_copy = 0;
  switch (r.op) {
    case kEpl: epl_epilogue(q, g, out); break;
    case kNfwE: nfw_e_epilogue(q, g, out); break;
    case kSersicE:
    case kSersic: sersic_stage_epilogue(r.op, q, lstsq, g, out); break;
    case kCoreSersic: core_epilogue(q, lstsq, g, out); break;
    case kSis: n_copy = 3; break;
    case kShear: n_copy = 2; break;
    case kNfw: n_copy = 4; break;
    case kSeries: n_copy = 2; break;
    case kShapelets: n_copy = 3 + (lstsq ? 0 : shapelet_count(r.a)); break;
    default: break;
  }
  for (int j = 0; j < n_copy; ++j) out[j] = g[j];
}

}  // namespace gl
