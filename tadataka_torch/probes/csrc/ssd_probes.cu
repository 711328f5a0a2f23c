// Probes of the SSD window search on Hopper (sm_90a): the V-read floor,
// the serial search with a tile sweep, and the two-pass search with the
// error slab in shared memory.
//
// Replace the three Pallas kernels of benchmarks/exp_ssd.py:
//   ssd_copy_floor  <- _copy_kernel   (make_copy, the DMA floor)
//   ssd_serial      <- _serial_kernel (make, the row-tile experiment)
//   ssd_par         <- _par_kernel    (make(..., scratch=True))
//
// All three read V (S, H, W) float32 once, S*H*W*4 bytes (39 MB at S=32,
// 480x640), and write a few bytes per pixel, so device memory bandwidth
// bounds them; the probes measure how close each design gets.
//
// - ssd_copy_floor sums the S planes left to right: nothing but the read
//   of V, the floor the search is held against.  Two designs:
//   * threads: one pixel or four adjacent pixels (float4) per thread,
//     over ``rows`` rows per thread, each thread's loads in flight as far
//     as its unrolled loop reaches (8 planes);
//   * bulk: a persistent grid of ``ctas`` blocks per SM, each owning
//     contiguous tiles of pixels (about 2.3k pixels a tile at one block
//     per SM at 480x640).  One thread streams the tiles' planes into a
//     ring of ``stages`` shared-memory stages with 1-D bulk copies
//     (cp.async.bulk, one mbarrier a stage, the first ``stages`` planes
//     issued at once), the block adds each stage into float4 register
//     accumulators in plane order, and once every thread has read a
//     stage the next plane goes into it.  The copies carry an L2
//     evict-first policy: V is read once, and its lines then replace one
//     another in L2 instead of the dirty lines other kernels left there,
//     whose write-back would share device memory with the read (at S=32
//     it doubled the bytes moved).  The copies need 16-byte aligned
//     planes, so the launcher refuses H * W % 4 != 0.
// - ssd_serial is ssd_search.cu's search with ``cols`` = 1, 2 or 4
//   adjacent columns per thread (float2 / float4 loads) and blocks of 32
//   threads by ``rows`` rows: more bytes in flight per thread against
//   the argmin's step-to-step dependence.  Its arithmetic is
//   ssd_search.cu's (left-to-right rounded sums, --fmad=false), so every
//   variant is bit-equal to ssd_search.
// - ssd_par removes that dependence: pass 1 writes each pixel's M
//   window errors, in the rsqrt form of exp_ssd.py:114, to a slab
//   (M, 128 pixels) in shared memory; pass 2 takes the minimum, the
//   first window that reaches it and its neighbours' errors from the
//   slab.  The slab needs M * 512 bytes (63.5 KB at S = 128), so the
//   launcher raises the dynamic shared-memory limit above 48 KB and
//   refuses an S whose slab exceeds the 227 KB a block may hold.
//
// NaN window errors (a NaN or infinite key sample, an infinite sample,
// squares that overflow) follow each form's own Pallas kernel:
// - ssd_serial, both designs, follows _serial_kernel (= sweep.py's
//   _ssd_kernel): the running minimum is taken with min.NaN (as
//   jnp.minimum), so it turns NaN at the first NaN error and no later
//   window becomes the best; a pixel with no best keeps en = window 0's
//   error: (-1, 3e38, 3e38, that error).
// - ssd_par, both designs, follows _par_kernel: the minimum over all
//   windows keeps NaN, no window equals a NaN minimum, so the first
//   window reaching it is M, the TPU kernel's own output: (M, NaN, the
//   error of window M - 1, 3e38).  Otherwise bm is the first window
//   reaching the minimum (-1 where it is >= 3e38), ep and en its
//   neighbours' errors (3e38 outside the windows), a pixel with no
//   match included.
//
// The serial kernel above is ssd_serial's "thread" design and the two-pass
// kernel ssd_par's "slab" design.  Neither keeps a load in flight under its
// arithmetic, and both pay for every window in full (the serial one the
// IEEE root and division, the slab one three scans of the slab).  The
// "tile" design of both (tile_kernel below) does two things about that:
//
// - All S planes of a tile of P consecutive pixels (H*W flattened: the
//   search has no spatial neighbourhood) sit in shared memory, with the
//   tile's K, mlo and mhi.  A persistent grid walks the tiles; one thread
//   of a producer warp loads each tile with 2-D TMA boxes of V and K seen
//   as (planes, H*W) and 1-D bulk copies of mlo and mhi, all with an L2
//   evict-first hint.  V comes in up to 8 chunks of planes, a box and an
//   mbarrier each (K, mlo and mhi with the first), so that the consumers
//   score a chunk's windows while the next chunks land; two stages a
//   block, so that one tile's loads run under the previous tile's
//   arithmetic.  Each consumer thread owns one pixel, keeps the last four
//   samples and their squares in registers (a square and a sign test per
//   sample, shared by the five windows that read it) and scores only the
//   windows m_lo .. m_hi of its bounds (sweep.py::ssd_window_bounds).
//   The block shape comes from the occupancy calculator: the largest of
//   256, 128, 64 and 32 consumer threads that gives an SM 16 consumer
//   warps, else the one with the most resident pixels an SM; P, a
//   multiple of 4, cuts the tiles to split evenly over the grid.  A
//   tensor map needs H*W % 4 == 0 and every input on the 16-byte grid;
//   the launcher refuses other inputs, and an S whose two stages do not
//   fit at P = 32 (S > 896).
// - ssd_par "tile": pass 1 keeps the running minimum of the windows in
//   bounds and the first window reaching it in registers, and stops at a
//   NaN error; the epilogue places the minimum among the windows out of
//   bounds (3e38 each, as the Pallas kernel masks them) and recomputes
//   the errors of the windows beside it from the resident samples with
//   the same instructions, so they are the same bits.  No slab and no
//   scans.
// - ssd_serial "tile": score cheaply, re-score exactly only the
//   candidates.  Pass 1 computes an approximate error a_m of every window
//   in range (fused products, rsqrt.approx, no division) and keeps the
//   least two, A1 at window m1 and A2.  |a_m - e_m| <= delta (below) for
//   the exact error e_m of ssd_search, so the first exact minimum lies
//   among {m : a_m <= A1 + 2 delta}; the code takes the candidates
//   {m : a_m <= A1 + 3 delta}, the third delta covering the rounding of
//   the cutoff itself.  Pass 2 computes e_m exactly for the candidates
//   only and takes the first exact minimum among them (strict '<' in
//   window order), then the exact errors of its neighbours.  Where A2
//   lies above the cutoff, m1 is the only candidate: three exact windows
//   instead of M.  Otherwise a second approximate sweep, the same
//   instructions on the same resident samples (so the same bits),
//   finds the candidates.  A pixel that the bound cannot certify runs
//   ssd_search's serial scan with the exact error over all its windows
//   from the resident planes: a key norm
//   outside [2^-60, 2^60] (NaN too), a valid window whose wn2 is not
//   normal or is below (2^-28 / kn)^2, or a second candidate.  Both
//   paths give the outputs of ssd_search bit for bit.
//
// No NaN error on a certified pixel.  The exact scan places NaN errors
// by _serial_kernel's rule; the candidate path has no NaN error to
// place.  Every pixel on which the approximate pass meets non-finite
// inputs or a non-finite error is sent to the scan, so every pixel whose
// exact errors hold a NaN is:
//  - a NaN or infinite key sample makes kk NaN or inf, so kn is NaN or
//    inf: outside [2^-60, 2^60];
//  - a NaN or -inf sample fails '>= 0': its windows are invalid, 3e38 in
//    both passes, whatever their arithmetic gives;
//  - a +inf sample, or finite samples whose squares overflow, give a
//    valid window wn2 = inf: above FLT_MAX, not normal;
//  - else every valid window of a certified pixel has finite samples in
//    [0, 2^64) (wn2 <= FLT_MAX) and finite key samples below 2^60 in
//    magnitude (kn <= 2^60), so |corr| <= |w| |K| (1 + 6u) < 2^125 in
//    both passes; the exact divisor d = fl(fl(sqrt(wn2)) kn) + 1e-16
//    lies in [2^-28 (1 - 4u), 2^125], the approximate factors fl(2 /
//    kn) <= 2^61 and rsqrt.approx(wn2) <= 2^64 (wn2 normal) are finite
//    and nonzero, every intermediate product is finite, and both ratios
//    are at most B <= 2 (1 + 6u) in magnitude, as derived below: the
//    errors are finite (|a|, |e| < 4.1), never NaN.
// So the certified set already excludes every such pixel, and the
// filter needs no test of its own for them.
//
// The bound delta.  u = 2^-24.  Let s = sqrt(wn2) in exact arithmetic;
// wn2 is the same left-to-right sum of rounded squares in both passes.
// Cauchy-Schwarz gives sum |w_i k_i| <= |w| |K|, and |w| <= s (1 + 3u),
// |K| <= kn (1 + 3u), so B = 2 sum |w_i k_i| / (s kn) <= 2 (1 + 6u) bounds
// both 2 |corr| / (s kn) and the ratio in each error.
//  - approximate: a = fl(2 - fl(corr_a * fl(2 / kn)) * r), corr_a the
//    fused sum (five roundings: |corr_a - C| <= 5.01u sum |w_i k_i|), r
//    = rsqrt.approx(wn2) = (1 + rho) / s with |rho| <= 2^-20 = 16u (the
//    instruction's error is below 2^-22); so |corr_a fl(2/kn) r - 2C /
//    (s kn)| <= B (5.01u + 2u + 16u).
//  - exact: e = fl(2 - fl(2 corr_e / d)), corr_e the plain sum (|corr_e
//    - C| <= 5.01u sum |w_i k_i|), d = fl(fl(fl(sqrt(wn2)) kn) + 1e-16) =
//    s kn (1 + t) with |t| <= 3.01u + lambda, lambda = 1e-16 / (s kn) <=
//    0.46u since the filter asks s kn >= 2^-28; so |2 corr_e / d - 2C /
//    (s kn)| <= B (5.01u + 4.02u + 0.46u).
//  - the two last roundings, of results below 4.05 in magnitude: 4.05u
//    each.
// So |a - e| <= 2.0001 (23.01u + 9.49u) + 8.1u < 73.2u, plus under-
// and overflow terms that the ranges above keep below 2^-80.  The code
// takes delta = 2^-17 = 128u, and fl(A1 + 3 delta) >= A1 + 2 delta
// whatever the cutoff's own rounding (<= 4u).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cfloat>
#include <climits>

namespace {

constexpr float kInf = 3.0e38f;
constexpr float kEps = 1e-16f;
constexpr int kCopyThreads = 128;
constexpr int kSerialBlockX = 32;
constexpr int kParPixels = 128;
constexpr int kMaxSharedBytes = 232448;   // 227 KB, Hopper's per-block cap
constexpr int kSharedPerSm = 233472;      // 228 KB an SM ...
constexpr int kSharedReserved = 1024;     // ... less 1 KB per resident block
constexpr int kBulkThreads = 256;
constexpr int kBulkPerThread = 4;         // float4 accumulators a thread
constexpr int kBulkMaxStages = 32;
constexpr int kBulkHeader = 8 * kBulkMaxStages;   // the stages' mbarriers
constexpr int kBulkAlign = 128;           // bytes between stage starts

// min(a, b) that keeps a NaN operand (jnp.minimum), where fminf drops it.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

template <int N> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
  const typename Vec<N>::T x = *reinterpret_cast<const typename Vec<N>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = f[i];
}

template <int N>
__device__ __forceinline__ void store(float* p, const float (&v)[N]) {
  typename Vec<N>::T x;
  float* f = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = v[i];
  *reinterpret_cast<typename Vec<N>::T*>(p) = x;
}

// ------------------------------------------------------------ V-read floor

template <int N>
__global__ void copy_floor_kernel(const float* __restrict__ V, int S, int H,
                                  int W, int rows, float* __restrict__ out) {
  const int x = (blockIdx.x * kCopyThreads + threadIdx.x) * N;
  if (x >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const int y0 = static_cast<int>(blockIdx.y) * rows;
  const int y_end = min(H, y0 + rows);
  for (int y = y0; y < y_end; ++y) {
    const size_t p = static_cast<size_t>(y) * W + x;
    float acc[N];
    load<N>(V + p, acc);
#pragma unroll 8
    for (int s = 1; s < S; ++s) {
      float v[N];
      load<N>(V + s * plane + p, v);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = acc[i] + v[i];
    }
    store<N>(out + p, acc);
  }
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" :: "r"(bar), "r"(parity) : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global ``src`` to shared ``dst`` under the L2 cache policy ``policy``,
// completing on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Item q of a block: plane q % S of its tile q / S (the block's tiles are
// blockIdx.x, blockIdx.x + gridDim.x, ...), copied into stage q % stages
// under the L2 cache policy ``policy``.
__device__ __forceinline__ void issue_plane(const float4* V, int S, int P4,
                                            int tile4, int q, int stages,
                                            int stage_bytes, uint32_t bars,
                                            uint32_t ring, uint64_t policy) {
  const int t = static_cast<int>(blockIdx.x) +
                q / S * static_cast<int>(gridDim.x);
  const int s = q % S;
  const int len4 = min(tile4, P4 - t * tile4);
  const uint32_t bar = bars + 8 * (q % stages);
  const float4* src = V + static_cast<size_t>(s) * P4 +
                      static_cast<size_t>(t) * tile4;
  // the block's reads of this stage (ordered by __syncthreads) before
  // the async proxy's write
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(len4 * 16) : "memory");
  bulk_copy(ring + (q % stages) * stage_bytes, src, len4 * 16, bar, policy);
}

__global__ void __launch_bounds__(kBulkThreads)
copy_floor_bulk_kernel(const float4* __restrict__ V, int S, int P4,
                       int tile4, int n_tiles, int stages, int stage_bytes,
                       float4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = shared_addr(smem);
  const uint32_t ring = bars + kBulkHeader;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  const int grid = static_cast<int>(gridDim.x);
  const int Q = (n_tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid
                * S;
  if (threadIdx.x == 0) {
    for (int d = 0; d < stages; ++d)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bars + 8 * d) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();                // the barriers are set up before any wait
  if (threadIdx.x == 0) {
    for (int q = 0; q < min(stages, Q); ++q)
      issue_plane(V, S, P4, tile4, q, stages, stage_bytes, bars, ring,
                  policy);
  }
  float4 acc[kBulkPerThread];
  for (int q = 0; q < Q; ++q) {
    const int t = static_cast<int>(blockIdx.x) +
                q / S * static_cast<int>(gridDim.x);
    const int s = q % S;
    const int len4 = min(tile4, P4 - t * tile4);
    const float4* stage = reinterpret_cast<const float4*>(
        smem + kBulkHeader + (q % stages) * stage_bytes);
    wait_parity(bars + 8 * (q % stages), (q / stages) & 1);
#pragma unroll
    for (int j = 0; j < kBulkPerThread; ++j) {
      const int k = static_cast<int>(threadIdx.x) + j * kBulkThreads;
      if (k < len4) {
        const float4 v = stage[k];
        if (s == 0) {
          acc[j] = v;               // not 0 + v: that would turn -0 into +0
        } else {
          acc[j].x = acc[j].x + v.x;
          acc[j].y = acc[j].y + v.y;
          acc[j].z = acc[j].z + v.z;
          acc[j].w = acc[j].w + v.w;
        }
      }
    }
    __syncthreads();              // every thread has read stage q % stages
    if (threadIdx.x == 0 && q + stages < Q)
      issue_plane(V, S, P4, tile4, q + stages, stages, stage_bytes, bars,
                  ring, policy);
    if (s == S - 1) {
#pragma unroll
      for (int j = 0; j < kBulkPerThread; ++j) {
        const int k = static_cast<int>(threadIdx.x) + j * kBulkThreads;
        if (k < len4) __stcs(out + static_cast<size_t>(t) * tile4 + k,
                             acc[j]);
      }
    }
  }
}

// ------------------------------------------------------- serial search

template <int N>
__global__ void serial_kernel(const float* __restrict__ V,
                              const float* __restrict__ K,
                              const float* __restrict__ mlo,
                              const float* __restrict__ mhi,
                              int S, int H, int W,
                              int* __restrict__ best,
                              float* __restrict__ ec,
                              float* __restrict__ ep,
                              float* __restrict__ en) {
  const int x = (blockIdx.x * kSerialBlockX + threadIdx.x) * N;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t p = static_cast<size_t>(y) * W + x;

  float k[5][N], w[5][N], lo[N], hi[N], kn[N];
#pragma unroll
  for (int j = 0; j < 5; ++j) load<N>(K + j * plane + p, k[j]);
  load<N>(mlo + p, lo);
  load<N>(mhi + p, hi);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float kk = k[0][i] * k[0][i];
    kk = kk + k[1][i] * k[1][i];
    kk = kk + k[2][i] * k[2][i];
    kk = kk + k[3][i] * k[3][i];
    kk = kk + k[4][i] * k[4][i];
    kn[i] = sqrtf(kk) + kEps;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) load<N>(V + j * plane + p, w[j]);

  int bm[N];
  float best_err[N], ecv[N], epv[N], env[N], prev[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bm[i] = -1;
    best_err[i] = ecv[i] = epv[i] = env[i] = prev[i] = kInf;
  }
  const int M = S - 4;
  for (int m = 0; m < M; ++m) {
    load<N>(V + static_cast<size_t>(m + 4) * plane + p, w[4]);
    const float mf = static_cast<float>(m);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float corr = w[0][i] * k[0][i];
      corr = corr + w[1][i] * k[1][i];
      corr = corr + w[2][i] * k[2][i];
      corr = corr + w[3][i] * k[3][i];
      corr = corr + w[4][i] * k[4][i];
      float wn2 = w[0][i] * w[0][i];
      wn2 = wn2 + w[1][i] * w[1][i];
      wn2 = wn2 + w[2][i] * w[2][i];
      wn2 = wn2 + w[3][i] * w[3][i];
      wn2 = wn2 + w[4][i] * w[4][i];
      const bool valid = w[0][i] >= 0.0f && w[1][i] >= 0.0f &&
                         w[2][i] >= 0.0f && w[3][i] >= 0.0f &&
                         w[4][i] >= 0.0f && mf >= lo[i] && mf <= hi[i];
      const float denom = sqrtf(wn2) * kn[i] + kEps;
      const float err = valid ? 2.0f - (2.0f * corr) / denom : kInf;
      if (m == bm[i] + 1) env[i] = err;
      if (err < best_err[i]) {
        epv[i] = prev[i];
        env[i] = kInf;
        ecv[i] = err;
        bm[i] = m;
      }
      best_err[i] = min_nan(best_err[i], err);   // NaN from a NaN on
      prev[i] = err;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < N; ++i) w[j][i] = w[j + 1][i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) best[p + i] = bm[i];
  store<N>(ec + p, ecv);
  store<N>(ep + p, epv);
  store<N>(en + p, env);
}

// ------------------------------------------------- two-pass search

__global__ void par_kernel(const float* __restrict__ V,
                           const float* __restrict__ K,
                           const float* __restrict__ mlo,
                           const float* __restrict__ mhi,
                           int S, int H, int W,
                           int* __restrict__ best,
                           float* __restrict__ ec,
                           float* __restrict__ ep,
                           float* __restrict__ en) {
  extern __shared__ float errs[];          // (M, kParPixels)
  const int t = threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t p = static_cast<size_t>(blockIdx.x) * kParPixels + t;
  if (p >= plane) return;                  // no barrier below: per-thread slab column
  const int M = S - 4;

  const float k0 = K[p], k1 = K[plane + p], k2 = K[2 * plane + p],
              k3 = K[3 * plane + p], k4 = K[4 * plane + p];
  float kk = k0 * k0;
  kk = kk + k1 * k1;
  kk = kk + k2 * k2;
  kk = kk + k3 * k3;
  kk = kk + k4 * k4;
  const float kn_inv = rsqrtf(kk + kEps);
  const float lo = mlo[p], hi = mhi[p];

  // pass 1: every window's error into this pixel's column of the slab
  float w0 = V[p], w1 = V[plane + p], w2 = V[2 * plane + p],
        w3 = V[3 * plane + p];
  for (int m = 0; m < M; ++m) {
    const float w4 = V[static_cast<size_t>(m + 4) * plane + p];
    float corr = w0 * k0;
    corr = corr + w1 * k1;
    corr = corr + w2 * k2;
    corr = corr + w3 * k3;
    corr = corr + w4 * k4;
    float wn2 = w0 * w0;
    wn2 = wn2 + w1 * w1;
    wn2 = wn2 + w2 * w2;
    wn2 = wn2 + w3 * w3;
    wn2 = wn2 + w4 * w4;
    const float mf = static_cast<float>(m);
    const bool valid = w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f &&
                       w3 >= 0.0f && w4 >= 0.0f && mf >= lo && mf <= hi;
    const float err = 2.0f - 2.0f * corr * rsqrtf(wn2 + kEps) * kn_inv;
    errs[m * kParPixels + t] = valid ? err : kInf;
    w0 = w1;
    w1 = w2;
    w2 = w3;
    w3 = w4;
  }

  // pass 2: the minimum (NaN as soon as one error is NaN, as
  // jnp.minimum), the first window reaching it (M for a NaN minimum),
  // its neighbours
  float b = errs[t];
  for (int m = 1; m < M; ++m) b = min_nan(b, errs[m * kParPixels + t]);
  int bm = M;
  for (int m = M - 1; m >= 0; --m) {
    if (errs[m * kParPixels + t] == b) bm = m;
  }
  best[p] = b >= kInf ? -1 : bm;
  ec[p] = b;
  ep[p] = bm >= 1 ? errs[(bm - 1) * kParPixels + t] : kInf;
  en[p] = bm + 1 < M ? errs[(bm + 1) * kParPixels + t] : kInf;
}

// ------------------------------------------------------------ "tile"

constexpr int kTileStages = 2;           // tiles in flight a block
constexpr int kTileMaxConsumers = 256;
constexpr int kTileMaxChunks = 8;        // V's boxes (and barriers) a tile
constexpr int kTileWarps = 16;           // consumer warps an SM wanted
// the stages' chunk barriers, then their empty barriers
constexpr int kTileHeader =
    (8 * kTileStages * (kTileMaxChunks + 1) + 127) / 128 * 128;
constexpr float kFilterDelta = 0x1p-17f;  // |a - e| <= delta, see the top

// Where a tile's arrays lie in its stage (bytes from the stage's start):
// V's planes first (rows of P floats in n_chunks boxes of chunk_rows
// planes, zeros past S), then K's five rows, mlo and mhi, each on a
// 128-byte boundary (a box's destination).
struct TileLayout {
  int P;
  int chunk_rows;
  int n_chunks;
  int k_off;
  int lo_off;
  int hi_off;
  int stage_bytes;
};

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// The box of ``map`` at (x, y) (pixels, planes) to shared ``dst``,
// completing on ``bar`` with the whole box's bytes (zeros past the end).
__device__ __forceinline__ void tensor_copy(uint32_t dst,
                                            const CUtensorMap* map, int x,
                                            int y, uint32_t bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Window index range [m_lo, m_hi] of bounds (lo, hi) over M windows, as
// sweep.py::ssd_window_bounds (and ssd_search.cu) compute it.
__device__ __forceinline__ void window_bounds(float lo, float hi, int M,
                                              int& m_lo, int& m_hi) {
  if (lo != lo || hi != hi) {
    m_lo = M;
    m_hi = -1;
    return;
  }
  float flo = ceilf(lo);
  flo = flo < 0.0f ? 0.0f : (flo > static_cast<float>(M)
                             ? static_cast<float>(M) : flo);
  float fhi = floorf(hi);
  fhi = fhi < -1.0f ? -1.0f : (fhi > static_cast<float>(M - 1)
                               ? static_cast<float>(M - 1) : fhi);
  m_lo = static_cast<int>(flo);
  m_hi = static_cast<int>(fhi);
}

// One stage's chunk barriers as a consumer thread waits on them: a
// thread reads plane r only after need(r).  Chunk 0 also brings K, mlo
// and mhi.
struct Chunks {
  uint32_t bars;    // chunk 0's barrier; chunk c's at bars + 8 c
  uint32_t parity;
  int rows;         // planes a chunk
  int ready;        // chunks waited on

  __device__ __forceinline__ void need(int plane) {
    while (ready * rows <= plane) {
      wait_parity(bars + 8 * ready, parity);
      ++ready;
    }
  }
};

// One pixel's column of a stage: sample r at v[r * P].
struct Column {
  const float* v;
  int P;
  __device__ __forceinline__ float operator[](int r) const {
    return v[r * P];
  }
};

// ssd_search's error of window m (3e38 when a sample is invalid): plain
// left-to-right sums of rounded products, the IEEE root and division.
__device__ __forceinline__ float exact_error(const Column& v, int m,
                                             const float (&k)[5], float kn) {
  const float a = v[m], b = v[m + 1], c = v[m + 2], d = v[m + 3],
              e = v[m + 4];
  float corr = a * k[0];
  corr = corr + b * k[1];
  corr = corr + c * k[2];
  corr = corr + d * k[3];
  corr = corr + e * k[4];
  float wn2 = a * a;
  wn2 = wn2 + b * b;
  wn2 = wn2 + c * c;
  wn2 = wn2 + d * d;
  wn2 = wn2 + e * e;
  const bool valid = a >= 0.0f && b >= 0.0f && c >= 0.0f && d >= 0.0f &&
                     e >= 0.0f;
  const float denom = sqrtf(wn2) * kn + kEps;
  return valid ? 2.0f - (2.0f * corr) / denom : kInf;
}

// ssd_par's error in the rsqrt form of par_kernel, from a window's
// correlation and norm.  wn2 + 1e-16 is a normal float, where the
// flush-to-zero root is rsqrtf's.
__device__ __forceinline__ float par_score(float corr, float wn2,
                                           float kn_inv) {
  return 2.0f - 2.0f * corr * rsqrt_approx(wn2 + kEps) * kn_inv;
}

// par_score of window m (3e38 when a sample is invalid).
__device__ __forceinline__ float par_error(const Column& v, int m,
                                           const float (&k)[5],
                                           float kn_inv) {
  const float a = v[m], b = v[m + 1], c = v[m + 2], d = v[m + 3],
              e = v[m + 4];
  float corr = a * k[0];
  corr = corr + b * k[1];
  corr = corr + c * k[2];
  corr = corr + d * k[3];
  corr = corr + e * k[4];
  float wn2 = a * a;
  wn2 = wn2 + b * b;
  wn2 = wn2 + c * c;
  wn2 = wn2 + d * d;
  wn2 = wn2 + e * e;
  const bool valid = a >= 0.0f && b >= 0.0f && c >= 0.0f && d >= 0.0f &&
                     e >= 0.0f;
  return valid ? par_score(corr, wn2, kn_inv) : kInf;
}

struct Result {
  int bm;
  float ec, ep, en;
};

// The five-sample window sliding over a pixel's planes in registers:
// each sample read, squared and tested once for the five windows that
// read it.
struct Window {
  float s0, s1, s2, s3, q0, q1, q2, q3;
  int last_bad;   // the last sample read that is not >= 0

  // samples lo .. lo + 3
  __device__ __forceinline__ void start(const Column& v, int lo) {
    s0 = v[lo];
    s1 = v[lo + 1];
    s2 = v[lo + 2];
    s3 = v[lo + 3];
    q0 = s0 * s0;
    q1 = s1 * s1;
    q2 = s2 * s2;
    q3 = s3 * s3;
    last_bad = -1;
    if (!(s0 >= 0.0f)) last_bad = lo;
    if (!(s1 >= 0.0f)) last_bad = lo + 1;
    if (!(s2 >= 0.0f)) last_bad = lo + 2;
    if (!(s3 >= 0.0f)) last_bad = lo + 3;
  }

  // window m's plain wn2 with its fifth sample s4 (square q4) read; the
  // window is valid where last_bad < m afterwards
  __device__ __forceinline__ float push(float s4, float q4, int m) {
    if (!(s4 >= 0.0f)) last_bad = m + 4;
    float wn2 = q0;
    wn2 = wn2 + q1;
    wn2 = wn2 + q2;
    wn2 = wn2 + q3;
    wn2 = wn2 + q4;
    return wn2;
  }

  __device__ __forceinline__ void shift(float s4, float q4) {
    s0 = s1;
    s1 = s2;
    s2 = s3;
    s3 = s4;
    q0 = q1;
    q1 = q2;
    q2 = q3;
    q3 = q4;
  }
};

// ssd_par "tile" for one pixel over its windows lo .. hi of M; the
// windows out of bounds are 3e38, as in _par_kernel.
__device__ __forceinline__ Result par_pixel(const Column& v,
                                            const float (&k)[5], int lo,
                                            int hi, int M, Chunks& ch) {
  float kk = k[0] * k[0];
  kk = kk + k[1] * k[1];
  kk = kk + k[2] * k[2];
  kk = kk + k[3] * k[3];
  kk = kk + k[4] * k[4];
  const float kn_inv = rsqrtf(kk + kEps);
  const float inf = __int_as_float(0x7f800000);
  float b = inf;   // the least error in bounds below +inf, or NaN
  int bm = -1;     // where it is (none: every error in bounds is +inf)
  if (lo <= hi) {
    ch.need(lo + 3);
    Window w;
    w.start(v, lo);
    int m = lo;
    while (m <= hi) {   // the windows of each chunk as it arrives
      ch.need(m + 4);
      const int stop = min(hi, ch.ready * ch.rows - 5);
#pragma unroll 4
      for (; m <= stop; ++m) {
        const float s4 = v[m + 4];
        const float q4 = s4 * s4;
        const float wn2 = w.push(s4, q4, m);
        float corr = w.s0 * k[0];
        corr = corr + w.s1 * k[1];
        corr = corr + w.s2 * k[2];
        corr = corr + w.s3 * k[3];
        corr = corr + s4 * k[4];
        const float score = par_score(corr, wn2, kn_inv);
        const float err = w.last_bad < m ? score : kInf;
        // the first minimum; a NaN error ends the search (b stays NaN)
        if (!(err >= b) && b == b) {
          b = err;
          bm = m;
        }
        w.shift(s4, q4);
      }
    }
  }
  // error of window x: scored in bounds, 3e38 out of them
  const auto at = [&](int x) {
    return x >= lo && x <= hi ? par_error(v, x, k, kn_inv) : kInf;
  };
  if (b != b) return Result{M, b, at(M - 1), kInf};   // no window equals NaN
  if (bm >= 0 && b < kInf)
    return Result{bm, b, at(bm - 1), at(bm + 1)};
  // No match: the minimum g over all M windows is >= 3e38, and the first
  // window f reaching it gives ep and en.  In bounds, the least error bi
  // is first reached at fi (bi = +inf at lo where bm < 0); out of bounds
  // every window is 3e38, the first fo.
  const bool in_bounds = lo <= hi;
  const bool out_of_bounds = lo > 0 || hi < M - 1 || !in_bounds;
  const int fo = lo > 0 || !in_bounds ? 0 : hi + 1;
  const int fi = bm >= 0 ? bm : lo;
  const float bi = bm >= 0 ? b : inf;
  const bool inner = in_bounds && (!out_of_bounds || (bi == kInf && fi < fo));
  const int f = inner ? fi : fo;
  return Result{-1, inner ? bi : kInf, f >= 1 ? at(f - 1) : kInf,
                f + 1 < M ? at(f + 1) : kInf};
}

// Pass 1's approximate error of the window of w's samples and s4, whose
// plain norm is wn2: fused products, rsqrt.approx, no division.
__device__ __forceinline__ float approx_error(const Window& w, float s4,
                                              float wn2, const float (&k)[5],
                                              float kinv2) {
  float corr = w.s0 * k[0];
  corr = __fmaf_rn(w.s1, k[1], corr);
  corr = __fmaf_rn(w.s2, k[2], corr);
  corr = __fmaf_rn(w.s3, k[3], corr);
  corr = __fmaf_rn(s4, k[4], corr);
  return __fmaf_rn(-(corr * kinv2), rsqrt_approx(wn2), 2.0f);
}

// Re-score counts of ssd_serial "tile", a thread's share.
struct Rescores {
  unsigned exact;   // windows scored exactly
  unsigned scan;    // pixels that scanned every window exactly
  unsigned sweep;   // pixels with more than one candidate
};

// ssd_serial "tile" for one pixel over its windows lo .. hi.
__device__ __forceinline__ Result serial_pixel(const Column& v,
                                               const float (&k)[5], int lo,
                                               int hi, Chunks& ch,
                                               Rescores& n) {
  float kk = k[0] * k[0];
  kk = kk + k[1] * k[1];
  kk = kk + k[2] * k[2];
  kk = kk + k[3] * k[3];
  kk = kk + k[4] * k[4];
  const float kn = sqrtf(kk) + kEps;
  if (kn >= 0x1p-60f && kn <= 0x1p60f && lo <= hi) {
    // pass 1: approximate errors, the least two and where the least is,
    // and the least and largest wn2 of the valid windows
    const float kinv2 = 2.0f / kn;
    const float tk = 0x1p-28f / kn;
    // s kn >= 2^-28 where wn2 > tk^2, and wn2 is normal
    const float thr = fmaxf(nextafterf(tk * tk, FLT_MAX), 0x1p-126f);
    float A1 = FLT_MAX, A2 = FLT_MAX, low = FLT_MAX, high = 0.0f;
    int m1 = -1;
    ch.need(lo + 3);
    Window w;
    w.start(v, lo);
    int m = lo;
    while (m <= hi) {   // the windows of each chunk as it arrives
      ch.need(m + 4);
      const int stop = min(hi, ch.ready * ch.rows - 5);
#pragma unroll 4
      for (; m <= stop; ++m) {
        const float s4 = v[m + 4];
        const float q4 = s4 * s4;
        const float wn2 = w.push(s4, q4, m);
        const float a = approx_error(w, s4, wn2, k, kinv2);
        const bool valid = w.last_bad < m;
        const float av = valid ? a : FLT_MAX;
        low = fminf(low, valid ? wn2 : FLT_MAX);
        high = fmaxf(high, valid ? wn2 : 0.0f);
        A2 = fminf(A2, fmaxf(A1, av));
        if (av < A1) m1 = m;
        A1 = fminf(A1, av);
        w.shift(s4, q4);
      }
    }
    // where wn2 lies in [thr, FLT_MAX] and kn in [2^-60, 2^60], |a - e|
    // <= delta (and |a| < 4.1) on every valid window
    if (low >= thr && high <= FLT_MAX) {
      if (m1 < 0) return Result{-1, kInf, kInf, kInf};   // no valid window
      // pass 2: the first exact minimum among the candidates, then its
      // neighbours' exact errors
      const float cutoff = A1 + 3.0f * kFilterDelta;
      int bm = m1;
      float best;
      if (A2 > cutoff) {   // m1 alone
        best = exact_error(v, m1, k, kn);
        n.exact += 1;
      } else {             // a second sweep finds the candidates
        n.sweep += 1;
        best = kInf;
        w.start(v, lo);
        for (int j = lo; j <= hi; ++j) {
          const float s4 = v[j + 4];
          const float q4 = s4 * s4;
          const float wn2 = w.push(s4, q4, j);
          if (w.last_bad < j &&
              approx_error(w, s4, wn2, k, kinv2) <= cutoff) {
            const float err = exact_error(v, j, k, kn);
            n.exact += 1;
            if (err < best) {
              best = err;
              bm = j;
            }
          }
          w.shift(s4, q4);
        }
      }
      n.exact += (bm > lo) + (bm < hi);
      return Result{bm, best, bm > lo ? exact_error(v, bm - 1, k, kn) : kInf,
                    bm < hi ? exact_error(v, bm + 1, k, kn) : kInf};
    }
  }
  // the exact scan of ssd_search (windows outside lo .. hi score 3e38 and
  // change nothing there; window 0, whose error a pixel with no best
  // keeps as en, is scanned where it is in bounds)
  n.scan += lo <= hi;
  n.exact += max(hi - lo + 1, 0);
  ch.need(hi + 4);
  Result r{-1, kInf, kInf, kInf};
  float best = kInf, prev = kInf;
  for (int m = lo; m <= hi; ++m) {
    const float err = exact_error(v, m, k, kn);
    if (m == r.bm + 1) r.en = err;
    if (err < best) {
      r.ep = prev;
      r.en = kInf;
      r.ec = err;
      r.bm = m;
    }
    best = min_nan(best, err);   // NaN from the first NaN error on
    prev = err;
  }
  return r;
}

template <bool kSerial>
__global__ void __launch_bounds__(32 + kTileMaxConsumers)
tile_kernel(const __grid_constant__ CUtensorMap map_v,
            const __grid_constant__ CUtensorMap map_k,
            const float* __restrict__ mlo, const float* __restrict__ mhi,
            int S, int N, TileLayout lay, int n_tiles,
            int* __restrict__ best, float* __restrict__ ec,
            float* __restrict__ ep, float* __restrict__ en,
            unsigned long long* __restrict__ counts) {
  extern __shared__ __align__(128) unsigned char smem[];
  // full barrier of chunk c of stage st: full0 + 8 (st kTileMaxChunks + c)
  const uint32_t full0 = shared_addr(smem);
  const uint32_t empty0 = full0 + 8 * kTileStages * kTileMaxChunks;
  const int consumer_warps = static_cast<int>(blockDim.x) / 32 - 1;
  const int P = lay.P;
  if (threadIdx.x == 0) {
    for (int d = 0; d < kTileStages; ++d) {
      for (int c = 0; c < lay.n_chunks; ++c)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(full0 + 8 * (d * kTileMaxChunks + c))
                     : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(empty0 + 8 * d), "r"(consumer_warps) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();   // the last block-wide barrier: the roles split here

  if (threadIdx.x < 32) {
    // ------------------------------------------------------ producer
    if (threadIdx.x != 0) return;
    uint64_t policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
    const uint32_t chunk_bytes = 4u * lay.chunk_rows * P;
    int j = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
      const int st = j % kTileStages;
      const int p0 = t * P;
      const int len = min(P, N - p0);
      const uint32_t full = full0 + 8 * st * kTileMaxChunks;
      const uint32_t stage = full0 + kTileHeader + st * lay.stage_bytes;
      wait_parity(empty0 + 8 * st, ((j / kTileStages) & 1) ^ 1);
      // the consumers' reads of this stage before the async writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      // chunk 0 with K, mlo and mhi, then the other chunks in plane order
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(full), "r"(chunk_bytes + 4u * (5 * P + 2 * len))
                   : "memory");
      tensor_copy(stage + lay.k_off, &map_k, p0, 0, full, policy);
      bulk_copy(stage + lay.lo_off, mlo + p0, 4 * len, full, policy);
      bulk_copy(stage + lay.hi_off, mhi + p0, 4 * len, full, policy);
      tensor_copy(stage, &map_v, p0, 0, full, policy);
      for (int c = 1; c < lay.n_chunks; ++c) {
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
            :: "r"(full + 8 * c), "r"(chunk_bytes) : "memory");
        tensor_copy(stage + c * chunk_bytes, &map_v, p0, c * lay.chunk_rows,
                    full + 8 * c, policy);
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers
  const int c = threadIdx.x - 32;
  const int M = S - 4;
  Rescores n{0, 0, 0};
  int j = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++j) {
    const int st = j % kTileStages;
    const int p0 = t * P;
    const int len = min(P, N - p0);
    const unsigned char* stage = smem + kTileHeader + st * lay.stage_bytes;
    Chunks ch{full0 + 8 * st * kTileMaxChunks,
              static_cast<uint32_t>((j / kTileStages) & 1), lay.chunk_rows,
              0};
    ch.need(0);
    if (c < len) {
      const Column v{reinterpret_cast<const float*>(stage) + c, P};
      const float* kp = reinterpret_cast<const float*>(stage + lay.k_off) + c;
      const float k[5] = {kp[0], kp[P], kp[2 * P], kp[3 * P], kp[4 * P]};
      int lo, hi;
      window_bounds(reinterpret_cast<const float*>(stage + lay.lo_off)[c],
                    reinterpret_cast<const float*>(stage + lay.hi_off)[c], M,
                    lo, hi);
      const Result r =
          kSerial ? serial_pixel(v, k, lo, hi, ch, n)
                  : par_pixel(v, k, lo, hi, M, ch);
      best[p0 + c] = r.bm;
      ec[p0 + c] = r.ec;
      ep[p0 + c] = r.ep;
      en[p0 + c] = r.en;
    }
    // every copy into the stage has landed before the stage is released
    ch.need(lay.n_chunks * lay.chunk_rows - 1);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) arrive(empty0 + 8 * st);
  }
  if (kSerial && counts != nullptr) {
    const unsigned exact = __reduce_add_sync(0xffffffffu, n.exact);
    const unsigned scan = __reduce_add_sync(0xffffffffu, n.scan);
    const unsigned sweep = __reduce_add_sync(0xffffffffu, n.sweep);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(counts, static_cast<unsigned long long>(exact));
      atomicAdd(counts + 1, static_cast<unsigned long long>(scan));
      atomicAdd(counts + 2, static_cast<unsigned long long>(sweep));
    }
  }
}

struct TilePlan {
  TileLayout lay;
  int n_tiles;
  int grid;
  int threads;
  int shared;
  int blocks_per_sm;
};

int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The stage layout of tiles of P pixels (P % 4 == 0) at S planes: V in
// up to kTileMaxChunks boxes of a multiple of 8 planes (every box's
// destination on 128 bytes).
TileLayout tile_layout(int S, int P) {
  TileLayout lay;
  lay.P = P;
  const int n = std::min(kTileMaxChunks, (S + 7) / 8);
  lay.chunk_rows = round_up((S + n - 1) / n, 8);
  lay.n_chunks = (S + lay.chunk_rows - 1) / lay.chunk_rows;
  lay.k_off = 4 * lay.n_chunks * lay.chunk_rows * P;
  lay.lo_off = lay.k_off + round_up(4 * 5 * P, 128);
  lay.hi_off = lay.lo_off + round_up(4 * P, 128);
  lay.stage_bytes = lay.hi_off + round_up(4 * P, 128);
  return lay;
}

int tile_shared_bytes(const TileLayout& lay) {
  return kTileHeader + kTileStages * lay.stage_bytes;
}

template <bool kSerial>
const void* tile_kernel_ptr() {
  return reinterpret_cast<const void*>(tile_kernel<kSerial>);
}

// The plan of S planes over N pixels on the current device: the largest
// of the consumer counts 256, 128, 64 and 32 whose blocks give an SM
// kTileWarps consumer warps, else the one with the most resident pixels
// an SM; then P <= it, a multiple of 4, that cuts N into tiles splitting
// evenly over the grid.  A box row is at most 256 pixels and a chunk at
// most 256 planes (S <= 896 fits at P = 32).  Plans are kept a device
// and shape: the occupancy query costs more host time than the launch.
int plan_tile(bool serial, int S, long N, TilePlan* plan) {
  if (S < 5 || N < 1 || N > INT_MAX / 2 || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  struct Known {
    int device, S, serial;
    long N;
    TilePlan plan;
  };
  constexpr int kKnown = 16;
  thread_local Known known[kKnown];
  thread_local int n_known = 0;
  for (int i = 0; i < std::min(n_known, kKnown); ++i) {
    const Known& k = known[i];
    if (k.device == device && k.S == S && k.N == N && k.serial == serial) {
      *plan = k.plan;
      return 0;
    }
  }
  int sms = 0;
  status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (status != cudaSuccess) return static_cast<int>(status);
  const void* kernel = serial ? tile_kernel_ptr<true>()
                              : tile_kernel_ptr<false>();
  status = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  int best_c = 0, best_occ = 0;
  for (int c = kTileMaxConsumers; c >= 32; c /= 2) {
    const int shared = tile_shared_bytes(tile_layout(S, c));
    if (shared > kMaxSharedBytes) continue;
    int occ = 0;
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                           32 + c, shared);
    if (status != cudaSuccess) return static_cast<int>(status);
    if (occ * c >= 32 * kTileWarps) {
      best_c = c;
      best_occ = occ;
      break;
    }
    if (occ * c > best_occ * best_c) {
      best_c = c;
      best_occ = occ;
    }
  }
  if (best_occ == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long blocks = static_cast<long>(sms) * best_occ;
  const long k = (N + blocks * best_c - 1) / (blocks * best_c);
  const int P = std::min(
      best_c,
      round_up(static_cast<int>((N + blocks * k - 1) / (blocks * k)), 4));
  plan->lay = tile_layout(S, P);
  plan->n_tiles = static_cast<int>((N + P - 1) / P);
  plan->grid = static_cast<int>(std::min<long>(blocks, plan->n_tiles));
  plan->threads = 32 + round_up(P, 32);
  plan->shared = tile_shared_bytes(plan->lay);
  plan->blocks_per_sm = best_occ;
  known[n_known++ % kKnown] = Known{device, S, serial ? 1 : 0, N, *plan};
  return 0;
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (this
// library does not link libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A (planes, N) float32 tensor at ``base`` read in boxes of box_y planes
// by box_x pixels.
int encode_map(CUtensorMap* map, const float* base, int N, int planes,
               int box_x, int box_y) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_x),
                             static_cast<cuuint32_t>(box_y)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult status = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return status == CUDA_SUCCESS ? 0
                                : static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool kSerial>
int tile_launch(const float* V, const float* K, const float* mlo,
                const float* mhi, int S, int H, int W, int* best, float* ec,
                float* ep, float* en, unsigned long long* counts,
                void* stream) {
  if (!(aligned16(V) && aligned16(K) && aligned16(mlo) && aligned16(mhi)))
    return static_cast<int>(cudaErrorInvalidValue);
  TilePlan plan;
  int status = plan_tile(kSerial, S, static_cast<long>(H) * W, &plan);
  if (status != 0) return status;
  const int N = H * W;
  CUtensorMap map_v{}, map_k{};
  status = encode_map(&map_v, V, N, S, plan.lay.P, plan.lay.chunk_rows);
  if (status == 0) status = encode_map(&map_k, K, N, 5, plan.lay.P, 5);
  if (status != 0) return status;
  tile_kernel<kSerial><<<plan.grid, plan.threads, plan.shared,
                         static_cast<cudaStream_t>(stream)>>>(
      map_v, map_k, mlo, mhi, S, N, plan.lay, plan.n_tiles, best, ec, ep, en,
      counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launcher runs on ``stream`` and returns cudaGetLastError() as an
// int (0 = OK); a refused configuration returns cudaErrorInvalidValue.
// Pointers are device pointers to contiguous float32 / int32 arrays:
// V (S, H, W), K (5, H, W), mlo / mhi / best / ec / ep / en / out (H, W).

extern "C" int ssd_copy_floor_launch(const float* V, int S, int H, int W,
                                     int vec, int rows, float* out,
                                     void* stream) {
  if (rows < 1 || (vec != 1 && vec != 4) || W % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W / vec + kCopyThreads - 1) / kCopyThreads,
                  (H + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    copy_floor_kernel<4><<<grid, kCopyThreads, 0, s>>>(V, S, H, W, rows, out);
  else
    copy_floor_kernel<1><<<grid, kCopyThreads, 0, s>>>(V, S, H, W, rows, out);
  return static_cast<int>(cudaGetLastError());
}

// The bulk-copy floor: ``stages`` in 1 .. 32, ``ctas`` blocks per SM in
// 1 .. 8.  A tile holds at most 1024 float4 (one to four a thread) and
// is cut so that the ring of ``ctas`` blocks fits in an SM's shared memory.
extern "C" int ssd_copy_floor_bulk_launch(const float* V, int S, int H, int W,
                                          int stages, int ctas, float* out,
                                          void* stream) {
  const long P = static_cast<long>(H) * W;
  if (S < 1 || H < 1 || W < 1 || P % 4 != 0 || P / 4 > (1L << 30) ||
      stages < 1 || stages > kBulkMaxStages || ctas < 1 || ctas > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess)
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int P4 = static_cast<int>(P / 4);
  const int blocks = sms * ctas;
  const int shared = std::min(kMaxSharedBytes,
                              kSharedPerSm / ctas - kSharedReserved);
  const int tile4 = std::min({(P4 + blocks - 1) / blocks,
                              kBulkThreads * kBulkPerThread,
                              (shared - kBulkHeader) / stages / kBulkAlign *
                                  (kBulkAlign / 16)});
  if (tile4 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int stage_bytes = (tile4 * 16 + kBulkAlign - 1) / kBulkAlign *
                          kBulkAlign;
  const int n_tiles = (P4 + tile4 - 1) / tile4;
  const int bytes = kBulkHeader + stages * stage_bytes;
  status = cudaFuncSetAttribute(copy_floor_bulk_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  copy_floor_bulk_kernel<<<std::min(blocks, n_tiles), kBulkThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(V), S, P4, tile4, n_tiles, stages,
      stage_bytes, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_serial_launch(const float* V, const float* K,
                                 const float* mlo, const float* mhi,
                                 int S, int H, int W, int cols, int rows,
                                 int* best, float* ec, float* ep, float* en,
                                 void* stream) {
  if (rows < 1 || kSerialBlockX * rows > 1024 ||
      (cols != 1 && cols != 2 && cols != 4) || W % cols != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kSerialBlockX, rows);
  const dim3 grid((W / cols + kSerialBlockX - 1) / kSerialBlockX,
                  (H + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols == 4)
    serial_kernel<4><<<grid, block, 0, s>>>(V, K, mlo, mhi, S, H, W, best,
                                            ec, ep, en);
  else if (cols == 2)
    serial_kernel<2><<<grid, block, 0, s>>>(V, K, mlo, mhi, S, H, W, best,
                                            ec, ep, en);
  else
    serial_kernel<1><<<grid, block, 0, s>>>(V, K, mlo, mhi, S, H, W, best,
                                            ec, ep, en);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory the two-pass kernel needs at S planes (0 if it cannot fit).
extern "C" int ssd_par_shared_bytes(int S) {
  const long bytes = static_cast<long>(S - 4) * kParPixels * sizeof(float);
  return S >= 5 && bytes <= kMaxSharedBytes ? static_cast<int>(bytes) : 0;
}

extern "C" int ssd_par_launch(const float* V, const float* K,
                              const float* mlo, const float* mhi,
                              int S, int H, int W,
                              int* best, float* ec, float* ep, float* en,
                              void* stream) {
  const int bytes = ssd_par_shared_bytes(S);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status = cudaFuncSetAttribute(
      par_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const size_t pixels = static_cast<size_t>(H) * W;
  const unsigned blocks =
      static_cast<unsigned>((pixels + kParPixels - 1) / kParPixels);
  par_kernel<<<blocks, kParPixels, bytes, static_cast<cudaStream_t>(stream)>>>(
      V, K, mlo, mhi, S, H, W, best, ec, ep, en);
  return static_cast<int>(cudaGetLastError());
}

// The "tile" plan of S planes at H x W on the current device for
// ssd_serial (``serial`` 1) or ssd_par (0): fills out[0..7] with P, the
// tiles, the grid, the threads a block, its dynamic shared memory, the
// blocks an SM, the chunks of V a tile and the planes a chunk.  Returns
// cudaErrorInvalidValue where H * W % 4 != 0 or where two stages do not
// fit in a block's shared memory even at P = 32 (S > 896).
extern "C" int ssd_tile_config(int S, int H, int W, int serial, int* out) {
  TilePlan plan;
  const int status = plan_tile(serial != 0, S, static_cast<long>(H) * W,
                               &plan);
  if (status != 0) return status;
  const int values[] = {plan.lay.P, plan.n_tiles, plan.grid, plan.threads,
                        plan.shared, plan.blocks_per_sm, plan.lay.n_chunks,
                        plan.lay.chunk_rows};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return 0;
}

// ssd_serial "tile".  ``counts`` (three uint64 on the device, or null)
// gains the windows scored exactly, the pixels that ran the whole exact
// scan and the pixels that swept again for more than one candidate.  Refuses (cudaErrorInvalidValue) what ssd_tile_config
// refuses and inputs off the 16-byte grid.
extern "C" int ssd_serial_tile_launch(const float* V, const float* K,
                                      const float* mlo, const float* mhi,
                                      int S, int H, int W, int* best,
                                      float* ec, float* ep, float* en,
                                      unsigned long long* counts,
                                      void* stream) {
  return tile_launch<true>(V, K, mlo, mhi, S, H, W, best, ec, ep, en, counts,
                           stream);
}

// ssd_par "tile"; refuses as ssd_serial_tile_launch does.
extern "C" int ssd_par_tile_launch(const float* V, const float* K,
                                   const float* mlo, const float* mhi,
                                   int S, int H, int W, int* best,
                                   float* ec, float* ep, float* en,
                                   void* stream) {
  return tile_launch<false>(V, K, mlo, mhi, S, H, W, best, ec, ep, en,
                            nullptr, stream);
}
