// Composable fused render, forward (summed or per component) and backward.
//
// Replaces the Pallas TPU kernels of gigalens_tpu/ops/pallas/fused_builder.py:
//   K5 fused_builder_fwd, summed      <- _fwd_call(summed=True) (fused_render_sum)
//   K6 fused_builder_fwd, components  <- _fwd_call(summed=False)
//                                        (fused_render_components)
//   K7 fused_builder_bwd              <- _bwd_call (_sum_bwd, _comp_bwd)
//
// The model arrives as a short program of stage records (stages.cuh),
// passed by value in the kernel-argument struct: every thread of a block
// runs the same program, looping over the records with a switch, so nothing
// diverges. The TPU version unrolls one Mosaic kernel per model instead;
// a code generator is not needed for a correct first kernel.
//
// What bounds it on the H100: arithmetic. Each (sample, pixel) reads 8
// bytes of coordinates and writes 4 (4 x depth in components mode) but runs
// the stage chain: for the shapelet-source family an EPL series of 23 terms,
// two Sersic profiles and 28 shapelet components (~20 transcendentals and
// divisions, a few hundred FMAs). Design: one thread per (sample, pixel), a
// block = one sample x 256 pixels, so the sample's packed row is one
// broadcast read per block (staged in shared memory). The ragged pixel edge
// is masked, never padded.
//
// K7 recomputes the pixel's forward (the JAX kernel saves no residuals
// either), then runs the light stages' hand-derived VJPs, which give the
// parameter cotangents and, at the source, a cotangent on beta; beta =
// x - sum alpha, so each mass stage's VJP receives -ct_beta. Summed mode is
// components mode with one cotangent shared by every component. Each
// stage's parameter cotangents are reduced as the stage produces them (warp
// shuffles into a per-warp row of shared memory, stages.cuh Reducer), so no
// thread holds an n_cols gradient vector; the block then writes
// (bs, n_tiles, n_cols) partial sums and the caller sums the tiles in a
// second pass, in a fixed order: the gradient is bitwise repeatable.
#include <cuda_runtime.h>

#include <cstring>

#include "stages.cuh"

namespace {

constexpr int kTile = 256;
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ void mass_fwd(const gl::StageRec& r, const float* p, const float* ex,
                                         int npix, int i, float x, float y, float& ax,
                                         float& ay) {
  const float* q = p + r.off;
  switch (r.op) {
    case gl::kEpl: gl::epl_fwd(q, r.a, x, y, ax, ay); break;
    case gl::kSis: gl::sis_fwd(q, x, y, ax, ay); break;
    case gl::kShear: gl::shear_fwd(q, x, y, ax, ay); break;
    case gl::kNfw: gl::nfw_fwd(q, x, y, ax, ay); break;
    case gl::kNfwE: gl::nfw_e_fwd(q, x, y, ax, ay); break;
    case gl::kSeries: gl::series_fwd(q, r.a, ex + (size_t)r.b * npix + i, npix, ax, ay); break;
    default: break;
  }
}

__global__ void __launch_bounds__(kTile)
fused_builder_fwd(const float* __restrict__ params, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ ex,
                  float* __restrict__ out, const __grid_constant__ gl::Spec spec, int bs,
                  int npix) {
  extern __shared__ float p[];
  const int s = blockIdx.y;
  for (int c = threadIdx.x; c < spec.n_cols; c += kTile)
    p[c] = params[(size_t)s * spec.n_cols + c];
  __syncthreads();
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= npix) return;
  const float x = xs[i], y = ys[i];

  float ax = 0.0f, ay = 0.0f;
  for (int k = 0; k < spec.n_mass; ++k) mass_fwd(spec.st[k], p, ex, npix, i, x, y, ax, ay);
  const float bx = x - ax, by = y - ay;

  gl::Emit emit{out, (size_t)bs * npix, (size_t)s * npix + i, spec.summed != 0, 0.0f};
  for (int k = spec.n_mass; k < spec.n_mass + spec.n_light; ++k) {
    const gl::StageRec r = spec.st[k];
    const float* q = p + r.off;
    const bool lstsq = r.flags & gl::kFlagLstsq;
    const bool src = r.flags & gl::kFlagSource;
    const float sx = src ? bx : x, sy = src ? by : y;
    switch (r.op) {
      case gl::kSersicE:
      case gl::kSersic: {
        float row[7];
        gl::sersic_row(r.op, q, lstsq, row);
        emit(r.comp, gl::sersic_light(sx, sy, row));
        break;
      }
      case gl::kCoreSersic: {
        const float shape = gl::core_sersic_shape(q, sx, sy);
        emit(r.comp, lstsq ? shape : q[9] * shape);
        break;
      }
      case gl::kShapelets:
        gl::shapelets_fwd(q, r.a, lstsq, r.comp, sx, sy, spec.pf, emit);
        break;
      default: break;
    }
  }
  if (spec.summed) out[(size_t)s * npix + i] = emit.total;
}

__global__ void __launch_bounds__(kTile)
fused_builder_bwd(const float* __restrict__ params, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ ex,
                  const float* __restrict__ cts, float* __restrict__ partial,
                  const __grid_constant__ gl::Spec spec, int bs, int npix) {
  extern __shared__ float smem[];
  float* p = smem;                 // [n_cols] the sample's packed row
  float* red = smem + spec.n_cols;  // [kWarps][n_cols] per-warp column sums
  const int s = blockIdx.y;
  for (int c = threadIdx.x; c < spec.n_cols; c += kTile) {
    p[c] = params[(size_t)s * spec.n_cols + c];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) red[w * spec.n_cols + c] = 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool active = i < npix;
  // a lane past the image reruns the last pixel (real values, no NaN) and
  // contributes 0 to every reduction
  const int ii = active ? i : npix - 1;
  const float x = xs[ii], y = ys[ii];
  const gl::Reducer rd{red, spec.n_cols, (int)(threadIdx.x & 31), (int)(threadIdx.x >> 5),
                       active};
  const gl::Cot cot{cts, (size_t)bs * npix, (size_t)s * npix + ii, spec.summed != 0, active};

  float ax = 0.0f, ay = 0.0f;
  for (int k = 0; k < spec.n_mass; ++k) mass_fwd(spec.st[k], p, ex, npix, ii, x, y, ax, ay);
  const float bx = x - ax, by = y - ay;

  // light stages: parameter cotangents, and the source's cotangent on beta
  float g_bx = 0.0f, g_by = 0.0f;
  for (int k = spec.n_mass; k < spec.n_mass + spec.n_light; ++k) {
    const gl::StageRec r = spec.st[k];
    const float* q = p + r.off;
    const bool lstsq = r.flags & gl::kFlagLstsq;
    const bool src = r.flags & gl::kFlagSource;
    const float sx = src ? bx : x, sy = src ? by : y;
    float g_x = 0.0f, g_y = 0.0f;
    switch (r.op) {
      case gl::kSersicE:
      case gl::kSersic: {
        float row[7], g[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        gl::sersic_row(r.op, q, lstsq, row);
        gl::sersic_bwd(cot(r.comp), sx, sy, row, g, g_x, g_y);
        if (r.op == gl::kSersicE) {
          for (int j = 0; j < 6; ++j) rd.add(r.off + j, g[j]);
          if (!lstsq) rd.add(r.off + 6, g[6]);
        } else {
          rd.add(r.off, g[0]);
          rd.add(r.off + 1, g[1]);
          rd.add(r.off + 2, g[4]);
          rd.add(r.off + 3, g[5]);
          if (!lstsq) rd.add(r.off + 4, g[6]);
        }
        break;
      }
      case gl::kCoreSersic:
        gl::core_sersic_bwd(q, lstsq, sx, sy, cot(r.comp), r.off, rd, g_x, g_y);
        break;
      case gl::kShapelets:
        gl::shapelets_bwd(q, r.a, lstsq, r.comp, sx, sy, spec.pf, cot, r.off, rd, g_x, g_y);
        break;
      default: break;
    }
    if (src) {
      g_bx = g_bx + g_x;
      g_by = g_by + g_y;
    }
  }

  // mass stages: beta = x - sum alpha, so each alpha gets -ct_beta
  const float g_ax = -g_bx, g_ay = -g_by;
  for (int k = 0; k < spec.n_mass; ++k) {
    const gl::StageRec r = spec.st[k];
    const float* q = p + r.off;
    switch (r.op) {
      case gl::kEpl: gl::epl_bwd(q, r.a, x, y, g_ax, g_ay, r.off, rd); break;
      case gl::kSis: gl::sis_bwd(q, x, y, g_ax, g_ay, r.off, rd); break;
      case gl::kShear: gl::shear_bwd(x, y, g_ax, g_ay, r.off, rd); break;
      case gl::kNfw: gl::nfw_bwd(q, x, y, g_ax, g_ay, r.off, rd); break;
      case gl::kNfwE: gl::nfw_e_bwd(q, x, y, g_ax, g_ay, r.off, rd); break;
      case gl::kSeries:
        gl::series_bwd(q, r.a, ex + (size_t)r.b * npix + ii, npix, g_ax, g_ay, r.off, rd);
        break;
      default: break;
    }
  }

  // sum the warps' rows in a fixed order
  __syncthreads();
  for (int c = threadIdx.x; c < spec.n_cols; c += kTile) {
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w * spec.n_cols + c];
    partial[((size_t)s * gridDim.x + blockIdx.x) * spec.n_cols + c] = acc;
  }
}

gl::Spec make_spec(const int* recs, int n_mass, int n_light, const float* pf, int n_cols,
                   int summed) {
  gl::Spec spec;
  std::memset(&spec, 0, sizeof(spec));
  std::memcpy(spec.st, recs, sizeof(gl::StageRec) * (n_mass + n_light));
  std::memcpy(spec.pf, pf, sizeof(spec.pf));
  spec.n_mass = n_mass;
  spec.n_light = n_light;
  spec.n_cols = n_cols;
  spec.summed = summed;
  return spec;
}

}  // namespace

extern "C" {

// recs: (n_mass + n_light) x 6 ints on the host (stage records, mass
// stages first); pf: kShapeletCap + 1 floats on the host
int gl_fused_builder_fwd(const float* params, const float* x, const float* y, const float* ex,
                         float* out, const int* recs, int n_mass, int n_light, const float* pf,
                         int bs, int npix, int n_cols, int summed, void* stream) {
  if (n_mass + n_light > gl::kMaxStages) return (int)cudaErrorInvalidValue;
  const gl::Spec spec = make_spec(recs, n_mass, n_light, pf, n_cols, summed);
  const dim3 grid((npix + kTile - 1) / kTile, bs);
  const size_t shm = sizeof(float) * n_cols;
  fused_builder_fwd<<<grid, kTile, shm, static_cast<cudaStream_t>(stream)>>>(
      params, x, y, ex, out, spec, bs, npix);
  return (int)cudaGetLastError();
}

int gl_fused_builder_bwd(const float* params, const float* x, const float* y, const float* ex,
                         const float* ct, float* partial, const int* recs, int n_mass,
                         int n_light, const float* pf, int bs, int npix, int n_cols, int summed,
                         void* stream) {
  if (n_mass + n_light > gl::kMaxStages) return (int)cudaErrorInvalidValue;
  const gl::Spec spec = make_spec(recs, n_mass, n_light, pf, n_cols, summed);
  const dim3 grid((npix + kTile - 1) / kTile, bs);
  const size_t shm = sizeof(float) * n_cols * (1 + kWarps);
  fused_builder_bwd<<<grid, kTile, shm, static_cast<cudaStream_t>(stream)>>>(
      params, x, y, ex, ct, partial, spec, bs, npix);
  return (int)cudaGetLastError();
}

}  // extern "C"
