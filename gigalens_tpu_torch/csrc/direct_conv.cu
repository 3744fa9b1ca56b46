// PSF convolution with the supersample pool folded in, as a direct strided sum.
//
// Replaces, on the main path, the Pallas TPU kernel of
// gigalens_tpu/ops/pallas/dft_conv.py (PallasDFTConv -> _run -> _dft_kernel,
// and its transposed call for the VJP). The same function, another
// algorithm: per sample,
//
//     out[i, j] = sum_{s, t} w[s, t] * x[p*i + s - oy, p*j + t - ox]
//
// with x zero outside the image and w the flipped PSF summed over the p x p
// pool box / p^2 (52x52 for the bench scene's 51-px supersampled PSF at
// p = 2). Both directions run as sums of stride-1 correlations, which this
// one kernel computes: per output phase ph and input phase q,
//
//     out[i*os + ry, j*os + rx] += sum_{u<KH, v<KW} w_q[u, v] * c_q[i + u - oy_q, j + v - ox_q]
//
// where c_q[m, n] = x[g*m + by_q, g*n + bx_q] is a polyphase component of
// the input. The forward sums the p^2 components (g = p) against the p^2
// sub-kernels w[p*u + a, p*v + b] into one output; the transpose reads the
// cotangent whole (g = 1) and writes p^2 output phases (os = p), each with
// its own sub-kernel. ops/cuda/direct_conv.py builds the sub-kernels (padded
// with 4 zero rows above and below and zero taps to a multiple of 4), the
// (oy, ox, by, bx, ry, rx) table and the launch plan on the host.
//
// What bounds it on the H100. One direction is out pixels x pooled taps
// multiply-adds a sample: 80*80*52*52 = 17.3 M at the bench shape (0.26 ms
// of FP32 at bs 500 against 0.02 ms of bytes), down to 24*24*12*12 at the
// multi-plane demo's (128, 48, 48), 2.7 M for the whole call. Large batches
// of large outputs (bench, SVI, inversion, sie lstsq) are bound by FP32
// instruction throughput; small batches or small outputs (survey, cluster, the multi-plane
// demo) by latency: too few threads to give the card's 528 schedulers two
// warps each. Timestamps inside the blocks showed where the first version of
// this kernel (one 80 x 80 tile a block, halos gathered one 4-byte cp.async
// an element, one input phase at a time) lost its time: issuing those
// copies took 57 us of a 326 us block at the bench shape and 22 of 30 us at
// the multi-plane demo's, more than the FMAs.
//
// Design:
// * Halos by TMA. A 3-D tensor map over the (bs, H, W) input loads, with
//   one instruction completing on an mbarrier, HH raw rows g apart (the row
//   gather done by the copy engine through the map's element stride) and
//   LDp raw columns, zero past the image edge. TMA takes no element stride
//   along the innermost dimension and starts a box only on a 16-byte
//   boundary (both found on the card: a misplaced box is an illegal
//   instruction), so a load holds whole raw rows from the 4-float boundary
//   at or before the halo, and with them all g column phases of its row
//   phase: the forward's p^2 input phases come in p loads, each phase read
//   every g-th word from its own offset. The loads go into a ring of
//   `stages` buffers: the first `stages` are requested at once, a load's
//   FMAs start when its own barrier flips, with the later loads still in
//   flight, and a buffer is refilled with load u + stages once load u is
//   done. The sub-kernels of the block's output phase arrive in one bulk
//   copy beside them. Inputs whose rows TMA cannot take (not a multiple of
//   16 bytes) are loaded by 4-byte cp.async copies into the same layout.
// * Thread tiles. Each thread keeps R rows x C adjacent columns of outputs in
//   registers (R x C one of 5x5, 5x3, 5x2, 2x2, a compiled variant each for
//   each gather 1-3: 5-row tiles, the narrower ones where they leave fewer
//   dead lanes at 48-60 px outputs, and 2x2 to give grids too small to fill
//   the card more threads) and walks the input rows of its window once: a row
//   is shared by every output row whose tap row lands on it (the first and
//   last rows of a window, which feed fewer output rows, are unrolled with
//   their row ranges known at compile time, also for sub-kernels of 1-3 tap
//   rows), four taps are one broadcast float4 load, and along a row an
//   8-word register window slides by four words a step, so 4 + R shared
//   loads feed 4 R C multiply-adds. The last 1-3 taps of a row take one
//   float4 of weights too.
// * Blocks. lx column lanes x rb row lanes of threads a sample, spb samples
//   a block, tiles_x x bands tiles a sample (direct_conv.py: plan picks them
//   so that tiles are mostly live at 24-80 px outputs and the grid has two
//   blocks an SM where the batch allows). The row pitch LDp is picked on the
//   host to keep a warp's window loads off shared bank conflicts.
//
// What bounds this design (H100, scripts/torch_k4_ab.py): at the bench
// shape FP32 instruction throughput, at 54% (forward) and 52% (transpose) of the FP32 bound:
// a forward block holds 109 KB of raw rows (two blocks an SM) and reads its
// window two words apart (2-way bank conflicts); at the 48-64 px outputs
// latency, 14-34% of the bound, with 256-1,920 blocks of 1-6 warps and a
// few microseconds of each spent before the first FMA; at the multi-plane
// demo's (128, 48, 48) the launch itself, 8 us for 2.7 M multiply-adds.
//
// Numerics: each output's sum is one fmaf chain from +0 in a fixed order,
// input phase q ascending, tap row ascending, tap ascending, whatever the
// plan: the same bits at every tile shape and load path (and as the first
// version of this kernel). FP32 FMA only (no TF32), no atomics: bitwise
// repeatable.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;
constexpr int kPad = 4;  // zero rows above and below each sub-kernel (padded on the host)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of a phase, expecting `bytes` from the copies that complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// box (c0, c1, c2) of the tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_3d(float* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `pending` (0..kMaxStages - 1) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

struct Params {
  const float* x;
  float* out;
  const float* w;  // (n_out * n_in, KH + 2 kPad, KWp), zero-padded
  const int* table;
  int bs, H, W, OH, OW, KH, KW, KWp, n_in, gather, out_stride, out_h, out_w;
  // the plan: column lanes, row lanes a band, samples a block, column tiles,
  // row bands, ring stages, halo rows / columns / row pitch, floats a
  // sample's halo buffer, TMA (1) or 4-byte gathers (0)
  int lx, rb, spb, tiles_x, bands, stages, HH, PW, LDp, sb, tma;
};

// One input row of a thread's window: output rows RLO..RHI (known at
// compile time) add taps t of row wrow - r * KWp times the row's words,
// which lie G floats apart (the column phases of a raw row). Taps t..t+3
// of output column c read window words c..c+3; an 8-word register window
// slides along the row four words a step.
template <int R, int C, int G, int RLO, int RHI>
__device__ __forceinline__ void window_row(const float* xrow, const float* wrow, int KWp,
                                           int kw4, int tail, float (&acc)[R][C]) {
  static_assert(C + 2 < 8, "the register window holds C + 3 words");
  float win[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) win[k] = xrow[G * k];
#pragma unroll 2
  for (int t = 0; t < kw4; t += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) win[4 + k] = xrow[G * (t + 4 + k)];
#pragma unroll
    for (int r = RLO; r <= RHI; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(wrow - r * KWp + t);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a = acc[r][c];
        a = fmaf(wv.x, win[c], a);
        a = fmaf(wv.y, win[c + 1], a);
        a = fmaf(wv.z, win[c + 2], a);
        a = fmaf(wv.w, win[c + 3], a);
        acc[r][c] = a;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) win[k] = win[4 + k];
  }
  if (tail) {  // the last 1-3 taps: one float4 of weights (zero past KW) a row
#pragma unroll
    for (int k = 0; k < 3; ++k) win[4 + k] = xrow[G * (kw4 + 4 + k)];
#pragma unroll
    for (int r = RLO; r <= RHI; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(wrow - r * KWp + kw4);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a = fmaf(wv.x, win[c], acc[r][c]);
        if (tail > 1) a = fmaf(wv.y, win[c + 1], a);
        if (tail > 2) a = fmaf(wv.z, win[c + 2], a);
        acc[r][c] = a;
      }
    }
  }
}

// one input phase's sums for a thread: input row rp of its window feeds
// output row r through tap row u = rp - r; rows outside 0..KH-1 are zero.
// Every window row runs with its output-row range known at compile time.
template <int R, int C, int G>
__device__ __forceinline__ void phase_sums(const float* x0, const float* wq, int KH, int KWp,
                                           int LDp, int kw4, int tail, float (&acc)[R][C]) {
#define GL_ROW(lo, hi, rp) \
  window_row<R, C, G, lo, hi>(x0 + (rp) * LDp, wq + (rp) * KWp, KWp, kw4, tail, acc)
  if constexpr (R == 2) {
    GL_ROW(0, 0, 0);
    for (int rp = 1; rp < KH; ++rp) GL_ROW(0, 1, rp);
    GL_ROW(1, 1, KH);
  } else {
    static_assert(R == 5, "thread tiles of 2 or 5 rows");
    if (KH >= R - 1) {
      GL_ROW(0, 0, 0);
      GL_ROW(0, 1, 1);
      GL_ROW(0, 2, 2);
      GL_ROW(0, 3, 3);
      for (int rp = R - 1; rp < KH; ++rp) GL_ROW(0, 4, rp);
      GL_ROW(1, 4, KH);
      GL_ROW(2, 4, KH + 1);
      GL_ROW(3, 4, KH + 2);
      GL_ROW(4, 4, KH + 3);
    } else if (KH == 3) {
      GL_ROW(0, 0, 0);
      GL_ROW(0, 1, 1);
      GL_ROW(0, 2, 2);
      GL_ROW(1, 3, 3);
      GL_ROW(2, 4, 4);
      GL_ROW(3, 4, 5);
      GL_ROW(4, 4, 6);
    } else if (KH == 2) {
      GL_ROW(0, 0, 0);
      GL_ROW(0, 1, 1);
      GL_ROW(1, 2, 2);
      GL_ROW(2, 3, 3);
      GL_ROW(3, 4, 4);
      GL_ROW(4, 4, 5);
    } else {
      GL_ROW(0, 0, 0);
      GL_ROW(1, 1, 1);
      GL_ROW(2, 2, 2);
      GL_ROW(3, 3, 3);
      GL_ROW(4, 4, 4);
    }
  }
#undef GL_ROW
}

// The first raw column of load u's halo, where t is the table row of its
// first input phase q = u G (phase q + b reads columns b, b + G, ...). A
// load starts at the 16-byte boundary at or before it (TMA takes boxes
// only there) and the threads read `shift(t, j0)` words into each row.
__device__ __forceinline__ int col0(const Params& a, const int* t, int j0) {
  return a.gather * (j0 - t[1]) + t[3];
}

__device__ __forceinline__ int shift(const Params& a, const int* t, int j0) {
  return col0(a, t, j0) & 3;
}

// Load u of the block's samples into halo buffer `dst`: the raw input rows
// r0 + G hr (hr < HH) and columns c0 + k (k < PW, LDp in the TMA's box),
// with (r0, c0) the start of input phase q = u G's halo, c0 rounded down to
// a multiple of 4.
__device__ __forceinline__ void tma_load(const Params& a, const CUtensorMap* map, const int* t,
                                         float* dst, uint64_t* bar, int i0, int j0, int b0) {
  const int c0 = col0(a, t, j0) & ~3, r0 = a.gather * (i0 - t[0]) + t[2];
  mbar_expect(bar, (unsigned)(a.spb * a.HH * a.LDp * 4));
  for (int s = 0; s < a.spb; ++s) tma_load_3d(dst + s * a.sb, map, c0, r0, b0 + s, bar);
}

// the same by 4-byte cp.async copies, zero past the image edge
__device__ __forceinline__ void gather_load(const Params& a, const int* t, float* dst, int i0,
                                            int j0, int b0) {
  const int c0 = col0(a, t, j0) & ~3, r0 = a.gather * (i0 - t[0]) + t[2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int sr = warp; sr < a.spb * a.HH; sr += nwarps) {
    const int s = sr / a.HH, hr = sr - s * a.HH;
    const int b = b0 + s, gr = r0 + a.gather * hr;
    const bool row_in = b < a.bs && gr >= 0 && gr < a.H;
    const float* xg = a.x + (size_t)(row_in ? b : 0) * a.H * a.W;
    float* d = dst + s * a.sb + hr * a.LDp;
    for (int k = lane; k < a.PW; k += 32) {
      const int gc = c0 + k;
      const bool in = row_in && gc >= 0 && gc < a.W;
      cp_async4(d + k, in ? xg + (size_t)gr * a.W + gc : a.x, in);
    }
  }
}

template <int R, int C, int G>
// registers: 88 for the 5x5 tile (at 80 it spills), 80 for the other 5-row
// tiles (three blocks of 256 threads an SM), 64 for 2x2
__global__ void __launch_bounds__(kMaxThreads) __maxnreg__(R* C >= 25 ? 88 : (R == 5 ? 80 : 64))
    direct_conv(const __grid_constant__ CUtensorMap map, const Params a) {
  // mbarriers (one a halo buffer, one for the weights), then the n_in
  // sub-kernels, then `stages` halo buffers of spb samples x sb floats.
  // Input phase q = u G + b lies in load u, column phase b.
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ws = reinterpret_cast<float*>(smem + 128);
  const int KHz = a.KH + 2 * kPad;
  const int wfloats = a.n_in * KHz * a.KWp;
  float* xs = ws + ((wfloats + 31) & ~31);
  const int buf = a.spb * a.sb, n_ld = a.n_in / G;
  const int band = blockIdx.x % a.bands, rest = blockIdx.x / a.bands;
  const int tx = rest % a.tiles_x, b0 = (rest / a.tiles_x) * a.spb;
  const int ph = blockIdx.y;
  const int i0 = band * a.rb * R, j0 = tx * a.lx * C;
  const int* tb = a.table + 6 * ph * a.n_in;
  const float* wg = a.w + (size_t)ph * wfloats;
  const int npre = a.stages < n_ld ? a.stages : n_ld;
  if (a.tma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s <= a.stages; ++s) mbar_init(&bars[s]);
      mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_expect(&bars[a.stages], (unsigned)(wfloats * 4));
      bulk_load(ws, wg, (unsigned)(wfloats * 4), &bars[a.stages]);
      for (int u = 0; u < npre; ++u)
        tma_load(a, &map, tb + 6 * G * u, xs + u * buf, &bars[u], i0, j0, b0);
    }
  } else {
    for (int i = threadIdx.x; i < wfloats / 4; i += blockDim.x) cp_async16(ws + 4 * i, wg + 4 * i);
    for (int u = 0; u < npre; ++u) {  // the weights ride in load 0's group
      gather_load(a, tb + 6 * G * u, xs + u * buf, i0, j0, b0);
      cp_async_commit();
    }
  }

  // this thread's tile: sample s, row lane ly, column lane lx of the block
  const int per = a.rb * a.lx;
  const int s = threadIdx.x / per, rem = threadIdx.x - s * per;
  const int ly = rem / a.lx, lx = rem - ly * a.lx;
  const bool live = s < a.spb && b0 + s < a.bs && i0 + R * ly < a.OH && j0 + C * lx < a.OW;
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

  const int kw4 = a.KW & ~3, tail = a.KW - kw4;  // taps in whole quads, the rest
  const float* xt = xs + s * a.sb + R * ly * a.LDp + G * C * lx;
  for (int u = 0; u < n_ld; ++u) {
    const int stage = u % a.stages;
    if (a.tma) {
      if (u == 0) mbar_wait(&bars[a.stages], 0);
      mbar_wait(&bars[stage], (unsigned)(u / a.stages) & 1u);
    } else {
      const int later = n_ld - 1 - u;
      cp_async_wait(a.stages - 1 < later ? a.stages - 1 : later);
      __syncthreads();  // load u (and the weights) have landed for every thread
    }
    if (live) {
      const float* xu = xt + stage * buf + shift(a, tb + 6 * G * u, j0);
#pragma unroll
      for (int b = 0; b < G; ++b)
        phase_sums<R, C, G>(xu + b, ws + ((u * G + b) * KHz + kPad) * a.KWp, a.KH, a.KWp, a.LDp,
                            kw4, tail, acc);
    }
    if (u + a.stages < n_ld) {
      __syncthreads();  // every thread is done with this buffer
      if (a.tma) {
        if (threadIdx.x == 0)
          tma_load(a, &map, tb + 6 * G * (u + a.stages), xs + stage * buf, &bars[stage], i0, j0,
                   b0);
      } else {
        gather_load(a, tb + 6 * G * (u + a.stages), xs + stage * buf, i0, j0, b0);
        cp_async_commit();
      }
    }
  }
  if (!live) return;

  const int ry = tb[4], rx = tb[5];
  float* og = a.out + (size_t)(b0 + s) * a.out_h * a.out_w;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + R * ly + r;
    if (i >= a.OH) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + C * lx + c;
      if (j < a.OW)
        og[(size_t)(i * a.out_stride + ry) * a.out_w + j * a.out_stride + rx] = acc[r][c];
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int R, int C, int G>
int launch_variant(const CUtensorMap& map, const Params& p, int n_out, int warps, int smem,
                   cudaStream_t stream) {
  static int smem_set = 48 * 1024;  // the attribute is raised once per process and variant
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(direct_conv<R, C, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const long blocks = (long)p.bands * p.tiles_x * ((p.bs + p.spb - 1) / p.spb);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, n_out);
  direct_conv<R, C, G><<<grid, warps * 32, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

template <int R, int C>
int launch_gather(const CUtensorMap& map, const Params& p, int n_out, int warps, int smem,
                  cudaStream_t stream) {
  switch (p.gather) {
    case 1: return launch_variant<R, C, 1>(map, p, n_out, warps, smem, stream);
    case 2: return launch_variant<R, C, 2>(map, p, n_out, warps, smem, stream);
    case 3: return launch_variant<R, C, 3>(map, p, n_out, warps, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// n_out output phases, each an (OH, OW) grid written every out_stride-th
// row and column of the (bs, out_h, out_w) output, summed over n_in input
// phases of the (bs, H, W) input gathered at stride `gather` (1-3), read
// `gather` phases a load of raw rows. w is (n_out * n_in, KH + 8,
// ceil4(KW)) zero-padded; table is (n_out * n_in, 6) int32 (oy, ox, by, bx,
// ry, rx). rows ... smem are the launch plan (direct_conv.py: plan).
int launch(const float* x, float* out, const float* w, const int* table, int bs, int n_out,
           int n_in, int H, int W, int OH, int OW, int KH, int KW, int gather, int out_stride,
           int out_h, int out_w, int rows, int cols, int lx, int rb, int spb, int tiles_x,
           int bands, int stages, int warps, int HH, int PW, int LDp, int sb, int tma, int smem,
           void* stream) {
  const int KWp = (KW + 3) / 4 * 4;
  if (warps < 1 || warps * 32 > kMaxThreads || lx < 1 || lx > 32 || rb < 1 || spb < 1 ||
      spb * rb * lx > warps * 32 || stages < 1 || stages > kMaxStages || tiles_x < 1 ||
      bands < 1 || tiles_x * lx * cols < OW || bands * rb * rows < OH ||
      (spb > 1 && bands != 1) || HH < rows * rb + KH - 1 ||
      PW < gather * (cols * lx + KWp + 2) + 3 || LDp < PW || sb < HH * LDp || (sb & 3) ||
      n_in % gather)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  if (tma) {
    const EncodeTiled enc = encoder();
    if (!enc || (W & 3) || (reinterpret_cast<uintptr_t>(x) & 15) || (LDp & 3) || LDp > 256 ||
        gather * HH > 256 || (sb & 31))
      return (int)cudaErrorInvalidValue;
    // raw rows (TMA takes no element stride along the innermost dimension):
    // LDp contiguous columns, HH rows `gather` apart
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)bs};
    const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
    const cuuint32_t box[3] = {(cuuint32_t)LDp, (cuuint32_t)(gather * HH), 1};
    const cuuint32_t step[3] = {1, (cuuint32_t)gather, 1};
    if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const Params p{x,       out,  w,      table, bs,     H,      W,     OH,         OW,
                 KH,      KW,   KWp,    n_in,  gather, out_stride, out_h, out_w, lx,
                 rb,      spb,  tiles_x, bands, stages, HH,     PW,    LDp,        sb,
                 tma};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows * 8 + cols) {
    case 5 * 8 + 5: return launch_gather<5, 5>(map, p, n_out, warps, smem, s);
    case 5 * 8 + 3: return launch_gather<5, 3>(map, p, n_out, warps, smem, s);
    case 5 * 8 + 2: return launch_gather<5, 2>(map, p, n_out, warps, smem, s);
    case 2 * 8 + 2: return launch_gather<2, 2>(map, p, n_out, warps, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Forward: (bs, H, W) images -> (bs, H/p, W/p), the pool^2 polyphase
// components of each image against the pool^2 sub-kernels w (pool^2, KH + 8,
// ceil4(KW)).
int gl_direct_conv_fwd(const float* x, float* out, const float* w, const int* table, int bs,
                       int H, int W, int pool, int KH, int KW, int rows, int cols, int lx, int rb,
                       int spb, int tiles_x, int bands, int stages, int warps, int HH, int PW,
                       int LDp, int sb, int tma, int smem, void* stream) {
  return launch(x, out, w, table, bs, 1, pool * pool, H, W, H / pool, W / pool, KH, KW, pool, 1,
                H / pool, W / pool, rows, cols, lx, rb, spb, tiles_x, bands, stages, warps, HH, PW,
                LDp, sb, tma, smem, stream);
}

// Transpose: (bs, H/p, W/p) cotangents -> (bs, H, W), one sub-kernel of w
// (pool^2, KH + 8, ceil4(KW)) for each of the pool^2 output phases.
int gl_direct_conv_transpose(const float* ct, float* out, const float* w, const int* table,
                             int bs, int H, int W, int pool, int KH, int KW, int rows, int cols,
                             int lx, int rb, int spb, int tiles_x, int bands, int stages,
                             int warps, int HH, int PW, int LDp, int sb, int tma, int smem,
                             void* stream) {
  return launch(ct, out, w, table, bs, pool * pool, 1, H / pool, W / pool, H / pool, W / pool,
                KH, KW, 1, pool, H, W, rows, cols, lx, rb, spb, tiles_x, bands, stages, warps, HH,
                PW, LDp, sb, tma, smem, stream);
}

}  // extern "C"
