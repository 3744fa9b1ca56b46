// Composable fused render, forward (summed or per component) and backward.
//
// Replaces the Pallas TPU kernels of gigalens_tpu/ops/pallas/fused_builder.py:
//   K5 fused_builder_fwd, summed      <- _fwd_call(summed=True) (fused_render_sum)
//   K6 fused_builder_fwd, components  <- _fwd_call(summed=False)
//                                        (fused_render_components)
//   K7 fused_builder_bwd              <- _bwd_call (_sum_bwd, _comp_bwd), with
//      fused_builder_bwd_epilogue, its per-sample second pass
//
// The model arrives as a short program of stage records (stages.cuh),
// passed by value in the kernel-argument struct: every thread of a block
// runs the same program, looping over the records with a switch, so nothing
// diverges. The TPU version unrolls one Mosaic kernel per model instead.
//
// What bounds them on the H100: arithmetic and, in K7, the reduction. Each
// (sample, pixel) reads 8 bytes of coordinates and writes 4 (4 x depth in
// components mode) but runs the stage chain: for the shapelet-source family
// an EPL series of 23 terms, a Sersic and 28 shapelet components. So all
// three kernels split the work as K1-K3 do: a per-sample prologue keyed by
// the stage program fills, once per block, one slot of constants per stage
// (rotation, sqrt q and its reciprocal, b, 1/n, 1/R_s, ...: stage_consts)
// and one series table per EPL stage in dynamic shared memory, a few warps
// at a time; the pixel stages keep pixel-dependent arithmetic only; a block
// walks kTilesPerBlock 256-pixel tiles of its sample, which amortises the
// prologue. Shared memory (smem_floats) is the packed row, kSlot floats a
// stage, 1 KB a table and, for K7, 2 KB of Omega per EPL stage and 1 KB per
// sums column; above 48 KB the kernels opt in, and a program that needs more
// than a block may have (227 KB) is refused. K5/K6 keep one pixel per
// thread and their store pattern. The ragged pixel edge is masked, never
// padded.
//
// K7 recomputes the pixel's forward (the JAX kernel saves no residuals
// either), keeping each EPL stage's Omega, then runs the light stages'
// hand-derived VJPs, which give cotangents and, at the source, a cotangent
// on beta; beta = x - sum alpha, so each mass stage's VJP receives
// -ct_beta. The EPL backward runs its series once more on the table: two
// series passes a pixel, the minimum (its cotangent depends on beta, which
// needs Omega), with no division in either. Summed mode is components mode
// with one cotangent shared by every component.
//
// The reduction: a stage's cotangent terms are not parameter gradients but
// cotangents of per-sample quantities (its sums: for an EPL b, t, q, cos
// phi, sin phi, dx, dy), whose map to the gradients is linear and so runs
// once per sample, in the epilogue kernel. The column set is a runtime
// property of the program, so it cannot index registers; of the two ways
// left, per-tile warp shuffles (five shuffles and a predicated add per
// column per pixel: ~230 dependent shuffles a thread for 46 columns) and
// per-thread accumulators in shared memory, this kernel takes the second:
// every thread owns one float of every column (column-major,
// conflict-free), adds each term with one shared-memory read-modify-write,
// walks its tiles, and the block reduces each column once at the end (eight
// shared reads a lane, five shuffles), writing (bs, n_chunks, n_sums)
// partials. The epilogue kernel sums the chunks in
// a fixed order and applies every stage's map: no atomics anywhere, so the
// gradient is bitwise repeatable, in two launches a call.
#include <cuda_runtime.h>

#include <cstring>

#include "stages.cuh"

namespace {

constexpr int kTile = gl::kBuilderTile;
constexpr int kWarps = kTile / 32;
constexpr int kTilesPerBlock = 4;  // pixel tiles one block walks
constexpr int kEpiThreads = 128;   // threads of K7's epilogue block (one sample)
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may opt in to

// Dynamic shared memory of a block, in floats: the packed row (padded to a
// float4), a slot per stage, a table per EPL stage; K7 adds Omega of each
// EPL stage and the accumulator columns.
struct Smem {
  float* p;
  float* slots;
  float4* tab;
  float* om;
  float* acc;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline size_t smem_floats(const gl::Spec& spec, bool bwd) {
  size_t n = pad4(spec.n_cols) + (size_t)(spec.n_mass + spec.n_light) * gl::kSlot +
             (size_t)spec.n_epl * gl::kMaxNiter * 4;
  if (bwd) n += (size_t)spec.n_epl * 2 * kTile + (size_t)spec.n_sums * kTile;
  return n;
}

__device__ __forceinline__ Smem smem_layout(const gl::Spec& spec, float* base) {
  Smem sm;
  sm.p = base;
  sm.slots = sm.p + pad4(spec.n_cols);
  sm.tab = reinterpret_cast<float4*>(sm.slots + (spec.n_mass + spec.n_light) * gl::kSlot);
  sm.om = reinterpret_cast<float*>(sm.tab + spec.n_epl * gl::kMaxNiter);
  sm.acc = sm.om + spec.n_epl * 2 * kTile;
  return sm;
}

// The prologue: the sample's packed row, then each stage's constants (lane
// 0 of warp k mod 8 takes stage k, so the stages run side by side) and each
// EPL stage's series table (the whole warp). Ends with the barrier that
// publishes them.
__device__ __forceinline__ void stage_prologue(const gl::Spec& spec,
                                               const float* __restrict__ params, int s,
                                               const Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < spec.n_cols; c += kTile) sm.p[c] = params[(size_t)s * spec.n_cols + c];
  __syncthreads();
  for (int k = warp; k < spec.n_mass + spec.n_light; k += kWarps) {
    const gl::StageRec r = spec.st[k];
    if (lane == 0) gl::stage_consts(r, sm.p + r.off, sm.slots + k * gl::kSlot);
    if (r.op == gl::kEpl)
      gl::series_table(sm.p + r.off, r.a, lane, sm.tab + r.b * gl::kMaxNiter);
  }
  __syncthreads();
}

// Mass stage k's forward at one pixel; K7 passes ``om`` to keep an EPL
// stage's Omega for its backward
__device__ __forceinline__ void mass_fwd(const gl::Spec& spec, int k, const Smem& sm,
                                         const float* ex, int npix, int i, float x, float y,
                                         float* om, float& ax, float& ay) {
  const gl::StageRec r = spec.st[k];
  const float* q = sm.p + r.off;
  switch (r.op) {
    case gl::kEpl: {
      const gl::EplK& e = gl::slot_as<gl::EplK>(sm.slots, k);
      const gl::EplPix g = gl::epl_pixel(e, x, y);
      float ox, oy;
      gl::series_fwd(g.cos_t, g.sin_t, r.a, sm.tab + r.b * gl::kMaxNiter, ox, oy);
      gl::epl_deflect(e, g, ox, oy, ax, ay);
      if (om) {
        om[(2 * r.b) * kTile + threadIdx.x] = ox;
        om[(2 * r.b + 1) * kTile + threadIdx.x] = oy;
      }
      break;
    }
    case gl::kSis: gl::sis_fwd(q, x, y, ax, ay); break;
    case gl::kShear: gl::shear_fwd(q, x, y, ax, ay); break;
    case gl::kNfw: gl::nfw_fwd(q, x, y, ax, ay); break;
    case gl::kNfwE: gl::nfw_e_fwd(gl::slot_as<gl::NfwEK>(sm.slots, k), x, y, ax, ay); break;
    case gl::kSeries:
      gl::series_stage_fwd(q, r.a, ex + (size_t)r.b * npix + i, npix, ax, ay);
      break;
    default: break;
  }
}

__global__ void __launch_bounds__(kTile)
fused_builder_fwd(const float* __restrict__ params, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ ex,
                  float* __restrict__ out, const __grid_constant__ gl::Spec spec, int bs,
                  int npix) {
  extern __shared__ float4 smem4[];
  const Smem sm = smem_layout(spec, reinterpret_cast<float*>(smem4));
  const int s = blockIdx.y;
  stage_prologue(spec, params, s, sm);
  for (int j = 0; j < kTilesPerBlock; ++j) {
    const int i = (blockIdx.x * kTilesPerBlock + j) * kTile + threadIdx.x;
    if (i >= npix) break;
    const float x = xs[i], y = ys[i];

    float ax = 0.0f, ay = 0.0f;
    for (int k = 0; k < spec.n_mass; ++k) mass_fwd(spec, k, sm, ex, npix, i, x, y, nullptr, ax, ay);
    const float bx = x - ax, by = y - ay;

    gl::Emit emit{out, (size_t)bs * npix, (size_t)s * npix + i, spec.summed != 0, 0.0f};
    for (int k = spec.n_mass; k < spec.n_mass + spec.n_light; ++k) {
      const gl::StageRec r = spec.st[k];
      const float* q = sm.p + r.off;
      const bool lstsq = r.flags & gl::kFlagLstsq;
      const bool src = r.flags & gl::kFlagSource;
      const float sx = src ? bx : x, sy = src ? by : y;
      switch (r.op) {
        case gl::kSersicE:
        case gl::kSersic: {
          const gl::SersicK& sk = gl::slot_as<gl::SersicK>(sm.slots, k);
          emit(r.comp, sk.Ie * gl::sersic_fwd_pixel(sx, sy, sk).E);
          break;
        }
        case gl::kCoreSersic: {
          const gl::CoreK& ck = gl::slot_as<gl::CoreK>(sm.slots, k);
          const gl::CorePix g = gl::core_pixel(ck, sx, sy);
          emit(r.comp, ck.amp * (g.F * g.E));
          break;
        }
        case gl::kShapelets:
          gl::shapelets_fwd(q, gl::slot_as<gl::ShapeletK>(sm.slots, k), r.a, lstsq, r.comp, sx,
                            sy, spec.pf, emit);
          break;
        default: break;
      }
    }
    if (spec.summed) out[(size_t)s * npix + i] = emit.total;
  }
}

// K7's pixel stage: recompute, light VJPs, mass VJPs; every term goes to
// this thread's float of its stage's sums columns
__device__ __forceinline__ void bwd_pixel(const gl::Spec& spec, const Smem& sm, const float* ex,
                                          const gl::Cot& cot, int npix, int i, float x, float y) {
  const int tid = threadIdx.x;
  float ax = 0.0f, ay = 0.0f;
  for (int k = 0; k < spec.n_mass; ++k) mass_fwd(spec, k, sm, ex, npix, i, x, y, sm.om, ax, ay);
  const float bx = x - ax, by = y - ay;

  // light stages: cotangent terms, and the source's cotangent on beta
  float g_bx = 0.0f, g_by = 0.0f;
  for (int k = spec.n_mass; k < spec.n_mass + spec.n_light; ++k) {
    const gl::StageRec r = spec.st[k];
    const float* q = sm.p + r.off;
    const gl::SmemAcc acc{sm.acc + r.soff * kTile + tid};
    const bool lstsq = r.flags & gl::kFlagLstsq;
    const bool src = r.flags & gl::kFlagSource;
    const float sx = src ? bx : x, sy = src ? by : y;
    float g_x = 0.0f, g_y = 0.0f;
    switch (r.op) {
      case gl::kSersicE:
      case gl::kSersic:
        gl::sersic_bwd_pixel(cot(r.comp), sx, sy, gl::slot_as<gl::SersicK>(sm.slots, k), acc,
                             g_x, g_y);
        break;
      case gl::kCoreSersic:
        gl::core_sersic_bwd(q, gl::slot_as<gl::CoreK>(sm.slots, k), lstsq, sx, sy, cot(r.comp),
                            acc, g_x, g_y);
        break;
      case gl::kShapelets:
        gl::shapelets_bwd(q, gl::slot_as<gl::ShapeletK>(sm.slots, k), r.a, lstsq, r.comp, sx, sy,
                          spec.pf, cot, acc, g_x, g_y);
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
    const float* q = sm.p + r.off;
    const gl::SmemAcc acc{sm.acc + r.soff * kTile + tid};
    switch (r.op) {
      case gl::kEpl: {
        const gl::EplK& e = gl::slot_as<gl::EplK>(sm.slots, k);
        const gl::EplPix g = gl::epl_pixel(e, x, y);
        gl::epl_bwd_pixel(e, g, sm.om[(2 * r.b) * kTile + tid], sm.om[(2 * r.b + 1) * kTile + tid],
                          g_ax, g_ay, r.a, sm.tab + r.b * gl::kMaxNiter, acc);
        break;
      }
      case gl::kSis: gl::sis_bwd(q, x, y, g_ax, g_ay, acc); break;
      case gl::kShear: gl::shear_bwd(x, y, g_ax, g_ay, acc); break;
      case gl::kNfw: gl::nfw_bwd(q, x, y, g_ax, g_ay, acc); break;
      case gl::kNfwE:
        gl::nfw_e_bwd(gl::slot_as<gl::NfwEK>(sm.slots, k), x, y, g_ax, g_ay, acc);
        break;
      case gl::kSeries:
        gl::series_stage_bwd(q, r.a, ex + (size_t)r.b * npix + i, npix, g_ax, g_ay, acc);
        break;
      default: break;
    }
  }
}

__global__ void __launch_bounds__(kTile)
fused_builder_bwd(const float* __restrict__ params, const float* __restrict__ xs,
                  const float* __restrict__ ys, const float* __restrict__ ex,
                  const float* __restrict__ cts, float* __restrict__ partial,
                  const __grid_constant__ gl::Spec spec, int bs, int npix) {
  extern __shared__ float4 smem4[];
  const Smem sm = smem_layout(spec, reinterpret_cast<float*>(smem4));
  const int s = blockIdx.y, tid = threadIdx.x;
  // this thread's accumulators: touched by no other thread until the end
  for (int c = 0; c < spec.n_sums; ++c) sm.acc[c * kTile + tid] = 0.0f;
  stage_prologue(spec, params, s, sm);

  for (int j = 0; j < kTilesPerBlock; ++j) {
    const int i = (blockIdx.x * kTilesPerBlock + j) * kTile + tid;
    if (i >= npix) break;  // the ragged edge: a lane past the image adds nothing
    const gl::Cot cot{cts, (size_t)bs * npix, (size_t)s * npix + i, spec.summed != 0};
    bwd_pixel(spec, sm, ex, cot, npix, i, xs[i], ys[i]);
  }

  // reduce each column over the block in a fixed order: a lane's eight
  // floats, then warp shuffles
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int c = warp; c < spec.n_sums; c += kWarps) {
    const float* col = sm.acc + c * kTile;
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += col[w * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) partial[((size_t)s * gridDim.x + blockIdx.x) * spec.n_sums + c] = v;
  }
}

// One block per sample: sums the sample's (n_chunks, n_sums) partials in
// chunk order, then thread k maps stage k's sums to its gradient columns
// (fused_builder.py: builder_bwd_epilogue). Columns no stage owns get 0.
__global__ void __launch_bounds__(kEpiThreads)
fused_builder_bwd_epilogue(const float* __restrict__ params, const float* __restrict__ partial,
                           float* __restrict__ grad, const __grid_constant__ gl::Spec spec,
                           int n_chunks) {
  extern __shared__ float4 smem4[];
  float* p = reinterpret_cast<float*>(smem4);
  float* sums = p + pad4(spec.n_cols);
  const int s = blockIdx.x, tid = threadIdx.x;
  float* out = grad + (size_t)s * spec.n_cols;
  for (int c = tid; c < spec.n_cols; c += kEpiThreads) {
    p[c] = params[(size_t)s * spec.n_cols + c];
    out[c] = 0.0f;
  }
  for (int c = tid; c < spec.n_sums; c += kEpiThreads) {
    float a = 0.0f;
    for (int j = 0; j < n_chunks; ++j) a += partial[((size_t)s * n_chunks + j) * spec.n_sums + c];
    sums[c] = a;
  }
  __syncthreads();
  for (int k = tid; k < spec.n_mass + spec.n_light; k += kEpiThreads) {
    const gl::StageRec r = spec.st[k];
    gl::stage_epilogue(r, p + r.off, sums + r.soff, out + r.off);
  }
}

// recs: (n_mass + n_light) x 7 ints on the host (stage records, mass stages
// first); pf: kShapeletCap + 1 floats on the host
bool make_spec(gl::Spec& spec, const int* recs, int n_mass, int n_light, const float* pf,
               int n_cols, int n_sums, int summed) {
  if (n_mass < 0 || n_light < 0 || n_mass + n_light > gl::kMaxStages) return false;
  std::memset(&spec, 0, sizeof(spec));
  std::memcpy(spec.st, recs, sizeof(gl::StageRec) * (n_mass + n_light));
  std::memcpy(spec.pf, pf, sizeof(spec.pf));
  spec.n_mass = n_mass;
  spec.n_light = n_light;
  spec.n_cols = n_cols;
  spec.n_sums = n_sums;
  spec.summed = summed;
  for (int k = 0; k < n_mass; ++k) {
    const gl::StageRec& r = spec.st[k];
    if (r.op != gl::kEpl) continue;
    // its table index must be its rank among the EPL stages
    if (r.b != spec.n_epl || r.a < 1 || r.a > gl::kMaxNiter) return false;
    ++spec.n_epl;
  }
  return true;
}

// Opts a kernel in to the shared memory a launch needs
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

int chunks(int npix) { return (npix + kTile * kTilesPerBlock - 1) / (kTile * kTilesPerBlock); }

}  // namespace

extern "C" {

int gl_fused_builder_fwd(const float* params, const float* x, const float* y, const float* ex,
                         float* out, const int* recs, int n_mass, int n_light, const float* pf,
                         int bs, int npix, int n_cols, int n_sums, int summed, void* stream) {
  gl::Spec spec;
  if (!make_spec(spec, recs, n_mass, n_light, pf, n_cols, n_sums, summed))
    return (int)cudaErrorInvalidValue;
  const size_t shm = sizeof(float) * smem_floats(spec, false);
  const cudaError_t err = allow_smem(fused_builder_fwd, shm);
  if (err != cudaSuccess) return (int)err;
  fused_builder_fwd<<<dim3(chunks(npix), bs), kTile, shm, static_cast<cudaStream_t>(stream)>>>(
      params, x, y, ex, out, spec, bs, npix);
  return (int)cudaGetLastError();
}

// partial: (bs, n_chunks, n_sums) scratch; grad: (bs, n_cols)
int gl_fused_builder_bwd(const float* params, const float* x, const float* y, const float* ex,
                         const float* ct, float* partial, float* grad, const int* recs,
                         int n_mass, int n_light, const float* pf, int bs, int npix, int n_cols,
                         int n_sums, int summed, void* stream) {
  gl::Spec spec;
  if (!make_spec(spec, recs, n_mass, n_light, pf, n_cols, n_sums, summed))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shm = sizeof(float) * smem_floats(spec, true);
  cudaError_t err = allow_smem(fused_builder_bwd, shm);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = chunks(npix);
  fused_builder_bwd<<<dim3(n_chunks, bs), kTile, shm, st>>>(params, x, y, ex, ct, partial, spec,
                                                           bs, npix);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t shm_epi = sizeof(float) * (pad4(n_cols) + n_sums);
  fused_builder_bwd_epilogue<<<bs, kEpiThreads, shm_epi, st>>>(params, partial, grad, spec,
                                                              n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
