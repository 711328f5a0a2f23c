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

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
      :: "r"(ring + (q % stages) * stage_bytes), "l"(src), "r"(len4 * 16),
         "r"(bar), "l"(policy)
      : "memory");
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
        best_err[i] = err;
      }
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

  // pass 2: the minimum, the first window reaching it, its neighbours
  float b = errs[t];
  for (int m = 1; m < M; ++m) b = fminf(b, errs[m * kParPixels + t]);
  int bm = M;
  for (int m = M - 1; m >= 0; --m) {
    if (errs[m * kParPixels + t] == b) bm = m;
  }
  best[p] = b >= kInf ? -1 : bm;
  ec[p] = b;
  ep[p] = bm >= 1 ? errs[(bm - 1) * kParPixels + t] : kInf;
  en[p] = bm + 1 < M ? errs[(bm + 1) * kParPixels + t] : kInf;
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
