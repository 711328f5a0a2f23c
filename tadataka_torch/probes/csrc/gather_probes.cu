// Gather probes on Hopper (sm_90a): how fast the card gathers from an
// image that sits in L2.
//
// Replace the five Pallas kernels of benchmarks/test_dynamic_gather.py
// and benchmarks/test_pallas_gather.py:
//   take_along_axis0 <- k_axis0     (make, take_along_axis(img, idx, 0))
//   take_along_axis1 <- k_axis1     (make, take_along_axis(img, idx, 1))
//   multi_warp       <- k_multi     (f_multi, S two-pass index warps)
//   flat_take        <- kernel_take (pallas_take, take(flat, idx, "clip"))
//   flat_take_rows   <- kernel_taa  (pallas_taa, take_along_axis on an
//                                    (8, HW) broadcast, 8 rows at a time)
//
// Semantics are JAX's.  take_along_axis: an index i in [-n, 0) wraps to
// i + n, and an index outside [-n, n) gives NaN.  take(mode="clip"): a
// negative index reads element 0, an index past the end the last one.
//
// Bound: every kernel reads its index array once and writes its output
// once, 4 bytes each per element, and reads the image (1.2 MB at
// 480x640), which stays in the 50 MB L2 after its first touch; nothing
// else reaches device memory, so the index and output bytes bound them
// (3.69 MB, 1.10 us at 3.35 TB/s for the axis gathers; 158.5 MB, 47.3 us
// for the (64, 307200) flat gathers).  The first design of each kernel
// ("thread" below): one thread per output element, index and output
// accessed with consecutive threads on consecutive addresses so they
// coalesce, the image read through the read-only path (__ldg), whose
// scattered 4-byte reads are served from L2.
//
// - multi_warp fuses the two passes per pixel: r = idxr[i, j],
//   c = idxc[r, j], v = img[r, c], and accumulates acc = acc + v (1 + s)
//   for s = 0 .. S-1 in that order, so that it rounds as the plain
//   version does (--fmad=false).  The probe measures the cost of each
//   warp, so all S gather chains must run: each address adds s * stride
//   with a stride the caller passes at run time (0), which the compiler
//   cannot prove constant, so it cannot hoist the loads out of the loop.
//   Two kernels, the launcher choosing by the input:
//   * "thread" (the first kernel): one thread a pixel.  Each chain reads
//     idxc[r, j] and img[r, c] at random rows: 2 x 16 x 307200 random
//     4-byte reads at 480x640, each a 32-byte L2 sector, and the card's
//     rate of random sectors (about 1.2e11 a second) sets its time.
//   * "strip": a block of 256 threads owns 32 columns and a band of 32
//     rows, and first stages idxc[:, strip] (all H rows, 60 KB at H =
//     480) in shared memory, by 16-byte cp.async copies where every row
//     starts on the 16-byte grid (W % 4 == 0) and by plain loads
//     otherwise.  A chain's idxc[r, j] lies in the thread's own column,
//     so it is read from shared memory (bank = column: no conflict
//     within a warp): half the random L2 reads of "thread", plus the
//     strip's fill.  The shift s * stride applies to the shared-memory
//     index too.  The image is read from L2 only (__ldcg): through L1,
//     the chains of a pixel, which read one address while the stride is
//     0, hit L1, and the time then measures the cache, not S warps.
// - take_along_axis0 is column-local the same way (out[i, j] = img[idx[i,
//   j], j]).  Two kernels, the launcher choosing by the input:
//   * "thread": one thread an element; every image read is a random
//     32-byte L2 sector (307200 at 480x640), and after an L2 flush the
//     first reader of a sector waits for device memory.
//   * "strip": a block owns 32 columns and a band of rows (as many bands
//     as fit one block an SM), stages img[:, strip] and its band of idx
//     in shared memory (cp.async or plain loads, as above), gathers from
//     shared memory and writes out, 16 bytes a thread where W % 4 == 0.
//   A "strip" block needs 4 x 32 x H bytes of shared memory for
//   multi_warp and 4 x 32 x (H + band) for take_along_axis0.  Past the
//   227 KB a block may have, the "strip" launcher runs the "thread"
//   kernel: for multi_warp past H = 1816; for take_along_axis0 on 132
//   SMs past H = 1556 at 640 columns (20 strips, 6 bands: a band is H /
//   6) and past H = 908 from 2113 columns on (67 strips or more, one
//   band of all H rows).
//   The launch floor of the card (an empty kernel, about 5 us between
//   CUDA events) lies above take_along_axis0's byte bound.
// - take_along_axis1 is row-local (out[i, j] = img[i, idx[i, j]]).  Two
//   kernels:
//   * "thread" (the first): one thread an element; each warp's random
//     column reads land in L1 and L2 sector by sector.
//   * "row" (7.5% faster at 480x640, PERF.md): a block owns a band of
//     whole rows (as many bands as make two blocks an SM: 2 rows, 5 KB,
//     at 480x640 on 132 SMs), stages them in shared memory (16-byte cp.async where W % 4 == 0, plain
//     loads otherwise), reads idx straight from device memory as int4
//     with an evict-first hint, the first loads issued under the
//     staging, gathers from shared memory and writes float4 with
//     streaming stores.  A row past 227 KB (W > 58112) runs "thread".
//   Bound: 3.69 MB at 480x640, 1.10 us at 3.35 TB/s, below the launch
//   floor.
// - flat_take_rows: every index row gathers from the same image, so the
//   gather is elementwise over the S*N indices taken as one flat array,
//   and no row needs its own 16-byte head or tail (S*N % 4 elements are
//   left at the end, done one by one).  "stream": each thread loads four
//   16-byte index chunks with an evict-first hint (__ldcs), so 16
//   independent gathers are in flight a thread, reads the image through
//   __ldg (from L1 or L2) and writes four outputs at a time with
//   streaming stores (__stcs); blocks of 256 threads, several resident on
//   every SM.  Random gathers cost one 32-byte L2 sector each (19.7M at
//   64 x 307200), and those sectors, not the 158.5 MB of index and
//   output, set its time.  Holding the image in the shared memory of a
//   cluster of 8 blocks and gathering over the SM-to-SM network read
//   slower (PERF.md).
// - flat_take (take(mode="clip")) is the same gather, clamped.  Two
//   kernels:
//   * "thread" (the first): one thread an element, every gather a random
//     32-byte L2 sector: 19.7M sectors at 64 x 307200, about 1.2e11 a
//     second.  It serves HW % 4 != 0, which "band" cannot copy.
//   * "band" takes the gathers off L2.  The index chunks, not the image,
//     sit in the SMs: a persistent block of 1024 threads (a producer
//     warp and 31 consumer warps) holds 32 indices a consumer thread in
//     registers (31744, 124 KB), clipped once, and the image streams
//     past them in bands (113 KB, the largest of which two fit in a
//     block; 11 at 480x640) through a ring of two stages in shared
//     memory, every gather a predicated shared-memory load.  More,
//     smaller stages never paid for the extra bands (PERF.md).  Two
//     blocks form a cluster; each copies half of every band with one
//     bulk copy multicast to both (the only SM-to-SM traffic, in bulk),
//     so L2 serves each band once a cluster.  Clusters of 4 blocks (the
//     first form) left SMs idle, as the card's GPCs do not split into
//     fours, and took an extra round at the probe's shape.  What holds
//     it (PERF.md): every SM must take in the whole image once a
//     round, 1.2 MB for its 31744 indices, 38.7 bytes an index against
//     the 32-byte sector of a random gather, and the bulk copies into an
//     SM run no faster than the random sectors did, whatever the band
//     size, the stage count, the multicast or the pieces a band is cut
//     into; the slot tests run under the copies.  So "band" only draws
//     even with "thread" (1.6% ahead at the probe's shape).

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamChunks = 4;      // 16-byte index chunks a thread
constexpr int kMaxSharedBytes = 232448;   // 227 KB, Hopper's per-block cap
constexpr int kStrip = 32;            // columns of a "strip" block
constexpr int kStripThreads = 256;    // threads of a multi_warp block
constexpr int kStripRows = kStripThreads / kStrip;   // rows a pass
constexpr int kMultiBand = 32;        // rows of a multi_warp block's band
constexpr int kRowChunks = 4;         // int4 index loads a "row" thread
                                      // issues before the staging wait
constexpr int kBandCluster = 2;       // blocks of a "band" cluster
constexpr int kBandThreads = 1024;    // a producer warp, then consumers
constexpr int kBandConsumers = kBandThreads - 32;
constexpr int kBandSlots = 32;        // indices a consumer thread holds
constexpr int kBandChunk = kBandConsumers * kBandSlots;
constexpr int kBandStages = 2;        // stages of the ring
constexpr int kBandHeader = 256;      // full, consumed, empty barriers
// floats a band: the most of which kBandStages fit in a block (113 KB)
constexpr int kBandFloats =
    (kMaxSharedBytes - kBandHeader) / (4 * kBandStages) / 4 * 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);   // the quiet NaN of float("nan")
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// take_along_axis's index rule: true and i wrapped into [0, n) when
// -n <= i < n.
__device__ __forceinline__ bool wrap_index(int& i, int n) {
  if (i < -n || i >= n) return false;
  if (i < 0) i += n;
  return true;
}

__global__ void take_axis0_kernel(const float* __restrict__ img,
                                  const int* __restrict__ idx, int H, int W,
                                  float* __restrict__ out) {
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<size_t>(H) * W) return;
  const int j = static_cast<int>(p % W);
  int r = idx[p];
  out[p] = wrap_index(r, H) ? __ldg(img + static_cast<size_t>(r) * W + j)
                            : nan_value();
}

// ------------------------------------------------------ column strips

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(shared_addr(dst)), "l"(src) : "memory");
}

// Copy rows [0, rows) of columns [j0, j0 + w) of src (rows of W
// elements) to dst (rows of kW).  kVec: 16-byte cp.async copies (every
// row start and w a multiple of 4 elements, src 16-byte aligned),
// complete at the next staged(); else plain loads, a row's elements on
// consecutive threads.
template <int kW, bool kVec, typename T>
__device__ __forceinline__ void stage_strip(T* dst, const T* src, int rows,
                                            int W, int j0, int w) {
  if (kVec) {
    const int chunks = w / 4;
    for (int q = threadIdx.x; q < rows * chunks; q += blockDim.x) {
      const int r = q / chunks, k = q - r * chunks;
      cp_async16(dst + r * kW + 4 * k,
                 src + static_cast<size_t>(r) * W + j0 + 4 * k);
    }
  } else {
    for (int q = threadIdx.x; q < rows * w; q += blockDim.x) {
      const int r = q / w, c = q - r * w;
      dst[r * kW + c] = src[static_cast<size_t>(r) * W + j0 + c];
    }
  }
}

// Every staged element in place and seen by the whole block.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
}

// strip[wrap(r), c] of a strip of rows of kW, or NaN; an invalid r
// reads row 0, so no index outside the strip reaches shared memory.
template <int kW>
__device__ __forceinline__ float strip_take(const float* strip, int r,
                                            int H, int c) {
  const bool ok = wrap_index(r, H);
  const float v = strip[(ok ? r : 0) * kW + c];
  return ok ? v : nan_value();
}

// Shared memory: img[:, strip] (H rows of kStrip), then idx[band,
// strip].
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
take_axis0_strip_kernel(const float* __restrict__ img,
                        const int* __restrict__ idx, int H, int W, int band,
                        float* __restrict__ out) {
  constexpr int kW = kStrip;
  extern __shared__ __align__(16) float strip[];
  int* rows = reinterpret_cast<int*>(strip + H * kW);
  const int j0 = blockIdx.x * kW;
  const int w = min(kW, W - j0);
  const int i0 = blockIdx.y * band;
  const int n = min(band, H - i0);
  stage_strip<kW, kVec>(strip, img, H, W, j0, w);
  stage_strip<kW, kVec>(rows, idx + static_cast<size_t>(i0) * W, n, W, j0,
                        w);
  staged();
  if (kVec) {
    const int chunks = w / 4;
    for (int q = threadIdx.x; q < n * chunks; q += blockDim.x) {
      const int i = q / chunks, c = 4 * (q - i * chunks);
      const int4 r = *reinterpret_cast<const int4*>(rows + i * kW + c);
      *reinterpret_cast<float4*>(
          out + static_cast<size_t>(i0 + i) * W + j0 + c) =
          make_float4(strip_take<kW>(strip, r.x, H, c),
                      strip_take<kW>(strip, r.y, H, c + 1),
                      strip_take<kW>(strip, r.z, H, c + 2),
                      strip_take<kW>(strip, r.w, H, c + 3));
    }
  } else {
    for (int q = threadIdx.x; q < n * w; q += blockDim.x) {
      const int i = q / w, c = q - i * w;
      out[static_cast<size_t>(i0 + i) * W + j0 + c] =
          strip_take<kW>(strip, rows[i * kW + c], H, c);
    }
  }
}

// Shared memory: idxc[:, strip] (H rows).  Thread t takes column t % 32
// of the rows t / 32, t / 32 + kStripRows, ... of a band of kMultiBand
// rows.
template <bool kVec>
__global__ void __launch_bounds__(kStripThreads, 1536 / kStripThreads)
multi_warp_strip_kernel(const float* __restrict__ img,
                        const int* __restrict__ idxr,
                        const int* __restrict__ idxc, int H, int W, int S,
                        int stride, float* __restrict__ out) {
  extern __shared__ __align__(16) int cols[];
  const int j0 = blockIdx.x * kStrip;
  const int w = min(kStrip, W - j0);
  stage_strip<kStrip, kVec>(cols, idxc, H, W, j0, w);
  staged();
  const int c0 = threadIdx.x % kStrip;
  if (c0 >= w) return;
  const int i1 = min(H, (blockIdx.y + 1) * kMultiBand);
  for (int i = blockIdx.y * kMultiBand + threadIdx.x / kStrip; i < i1;
       i += kStripRows) {
    const size_t p = static_cast<size_t>(i) * W + j0 + c0;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const int shift = s * stride;
      int r = __ldg(idxr + p + shift);
      float v = nan_value();
      if (wrap_index(r, H)) {
        int c = cols[r * kStrip + c0 + shift];
        if (wrap_index(c, W)) {
          v = __ldcg(img + static_cast<size_t>(r) * W + c + shift);
        }
      }
      acc = acc + v * (1.0f + static_cast<float>(s));
    }
    out[p] = acc;
  }
}

__global__ void empty_kernel() {}

__global__ void take_axis1_kernel(const float* __restrict__ img,
                                  const int* __restrict__ idx, int H, int W,
                                  float* __restrict__ out) {
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<size_t>(H) * W) return;
  const size_t row = p / W * W;
  int c = idx[p];
  out[p] = wrap_index(c, W) ? __ldg(img + row + c) : nan_value();
}

// row[wrap(c)] of a row of W, or NaN; an invalid c reads element 0, so
// no index outside the row reaches shared memory.
__device__ __forceinline__ float row_take(const float* row, int c, int W) {
  const bool ok = wrap_index(c, W);
  const float v = row[ok ? c : 0];
  return ok ? v : nan_value();
}

// ------------------------------------------------ take_along_axis1, "row"

// Shared memory: img[band of rows] (n rows of W).  The gather is
// row-local, so a block stages its band of rows once and gathers every
// element of the band from shared memory; idx is read once, straight
// from device memory as int4 (its own row's chunk: W % 4 == 0 keeps a
// chunk inside a row), and out is written as float4 with streaming
// stores.  The index loads of a thread's first kRowChunks chunks are
// issued before the staging is waited on, so they overlap it.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
take_axis1_row_kernel(const float* __restrict__ img,
                      const int* __restrict__ idx, int H, int W, int band,
                      float* __restrict__ out) {
  extern __shared__ __align__(16) float band_rows[];
  const int i0 = blockIdx.x * band;
  const int n = min(band, H - i0);
  const size_t base = static_cast<size_t>(i0) * W;
  const int count = n * W;
  if (kVec) {
    for (int q = threadIdx.x; q < count / 4; q += kThreads)
      cp_async16(band_rows + 4 * q, img + base + 4 * q);
    const int4* idx4 = reinterpret_cast<const int4*>(idx + base);
    float4* out4 = reinterpret_cast<float4*>(out + base);
    for (int q0 = 0; q0 < count / 4; q0 += kRowChunks * kThreads) {
      int4 c[kRowChunks];
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        const int q = q0 + k * kThreads + threadIdx.x;
        c[k] = q < count / 4 ? __ldcs(idx4 + q) : make_int4(0, 0, 0, 0);
      }
      if (q0 == 0) staged();   // the same q0 in every thread
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        const int q = q0 + k * kThreads + threadIdx.x;
        if (q < count / 4) {
          const float* row = band_rows + (4 * q) / W * W;
          __stcs(out4 + q, make_float4(row_take(row, c[k].x, W),
                                       row_take(row, c[k].y, W),
                                       row_take(row, c[k].z, W),
                                       row_take(row, c[k].w, W)));
        }
      }
    }
  } else {
    for (int q = threadIdx.x; q < count; q += kThreads)
      band_rows[q] = img[base + q];
    staged();
    for (int q = threadIdx.x; q < count; q += kThreads)
      out[base + q] =
          row_take(band_rows + q / W * W, __ldcs(idx + base + q), W);
  }
}

__global__ void multi_warp_kernel(const float* __restrict__ img,
                                  const int* __restrict__ idxr,
                                  const int* __restrict__ idxc, int H, int W,
                                  int S, int stride, float* __restrict__ out) {
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= static_cast<size_t>(H) * W) return;
  const int j = static_cast<int>(p % W);
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    const size_t shift = static_cast<size_t>(s) * stride;
    int r = __ldg(idxr + p + shift);
    float v = nan_value();
    if (wrap_index(r, H)) {
      const size_t row = static_cast<size_t>(r) * W;
      int c = __ldg(idxc + row + j + shift);
      if (wrap_index(c, W)) v = __ldg(img + row + c + shift);
    }
    acc = acc + v * (1.0f + static_cast<float>(s));
  }
  out[p] = acc;
}

__global__ void flat_take_kernel(const float* __restrict__ flat, int HW,
                                 const int* __restrict__ idx, size_t n,
                                 float* __restrict__ out) {
  const size_t p = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const int i = min(max(idx[p], 0), HW - 1);
  out[p] = __ldg(flat + i);
}

// ------------------------------------------------ flat_take_rows, "stream"

// flat[wrap(i)], or NaN; an invalid index reads element 0, so the load
// needs no branch.
__device__ __forceinline__ float take_wrapped(const float* flat, int HW,
                                              int i) {
  const bool ok = wrap_index(i, HW);
  const float v = __ldg(flat + (ok ? i : 0));
  return ok ? v : nan_value();
}

__global__ void __launch_bounds__(kThreads)
flat_take_rows_stream_kernel(const float* __restrict__ flat, int HW,
                             const int* __restrict__ idx, size_t n,
                             float* __restrict__ out) {
  const size_t n4 = n / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads *
                      kStreamChunks + threadIdx.x;
  int4 ids[kStreamChunks];
#pragma unroll
  for (int k = 0; k < kStreamChunks; ++k) {
    const size_t p = base + static_cast<size_t>(k) * kThreads;
    ids[k] = p < n4 ? __ldcs(idx4 + p) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < kStreamChunks; ++k) {
    const size_t p = base + static_cast<size_t>(k) * kThreads;
    const float4 v = make_float4(
        take_wrapped(flat, HW, ids[k].x), take_wrapped(flat, HW, ids[k].y),
        take_wrapped(flat, HW, ids[k].z), take_wrapped(flat, HW, ids[k].w));
    if (p < n4) __stcs(out4 + p, v);
  }
  const size_t tail = n4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) out[tail] = take_wrapped(flat, HW,
                                                            idx[tail]);
}

// ----------------------------------------------------- flat_take, "band"

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Clusters of kBandCluster blocks, one block an SM, on a persistent grid.
// Every round, each block of a cluster holds one chunk of kBandChunk
// indices in registers (kBandSlots a consumer thread: int4 loads j = 0
// .. 7 at int4 j * kBandConsumers + t of the chunk, clipped into [0, HW)
// and kept as byte offsets), and the cluster sweeps the image band by
// band through a ring of kBandStages stages in every block's shared
// memory.  Warp 0
// produces: lane 0 copies the block's share of each band (1 / kBandCluster
// of it) with one bulk copy multicast to every block of the cluster
// (cp.async.bulk ... .multicast::cluster), so L2 serves a band once a
// cluster and no load of a gather crosses SMs; each block's full
// barrier expects the whole band's bytes.  The other warps consume: at
// each band a slot whose offset falls in it reads its value from shared
// memory (a slot that does not reads the stage's first word and keeps
// its register); the value takes the slot's register and a bit of
// ``served`` marks it.  After the last band of a round the thread writes
// its chunk's values as float4 with streaming stores, in the order of
// the loads.  A stage is refilled only after every block of the cluster
// has read it: each consumer warp arrives on the block's consumed
// barrier, and producer lane 1 + c, as soon as that completes, arrives
// on the stage's empty barrier in block c (mapa + mbarrier.arrive.release
// .cluster), on which lane 0 waits before it copies.  So the copies run
// ahead of the reads by the ring's depth, and no consumer waits on
// another SM.  The rounds deal the chunks kBandCluster at a time (chunk
// kBandCluster g + r of group g), so every block of a cluster sweeps
// the same bands; a block past the last chunk sweeps with no slot.
__device__ __forceinline__ void cluster_arrive(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void wait_parity_cluster(uint32_t bar,
                                                    uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, "
      "[%0], %1;\n"
      " @!done bra WAIT;\n}" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}" :: "r"(bar), "r"(parity) : "memory");
}

// Copy ``bytes`` (a multiple of 16) from ``src`` to shared ``stage`` in
// every block of the cluster, completing on ``bar`` in each.
__device__ __forceinline__ void multicast_copy(uint32_t stage,
                                               const float* src,
                                               uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;"
      :: "r"(stage), "l"(src), "r"(bytes), "r"(bar),
         "h"(static_cast<uint16_t>((1u << kBandCluster) - 1))
      : "memory");
}

struct BandPlan {
  int HW;           // image floats
  int band;         // floats a band (a multiple of 4)
  int n_bands;
  size_t n;         // indices
  int n_groups;     // groups of kBandCluster chunks
  int n_clusters;
};

// Item ``item`` of a block (round k, band b is item k * n_bands + b, in
// stage item % kBandStages): expect the band's bytes on the stage's full
// barrier and copy the block's share of the band to every block of the
// cluster.
__device__ __forceinline__ void issue_band(const float* flat,
                                           const BandPlan& p, int item,
                                           uint32_t rank, uint32_t full0,
                                           uint32_t ring) {
  const int b = item % p.n_bands;
  const int st = item % kBandStages;
  const int begin = b * p.band;
  const int len = min(p.band, p.HW - begin);
  const int share = (len / 4 + kBandCluster - 1) / kBandCluster * 4;
  const int q0 = min(len, static_cast<int>(rank) * share);
  const int q1 = min(len, q0 + share);
  const uint32_t bar = full0 + 8 * st;
  const uint32_t stage = ring + 4u * st * p.band;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(4 * len) : "memory");
  if (q1 > q0)
    multicast_copy(stage + 4u * q0, flat + begin + q0, 4u * (q1 - q0), bar);
}

__global__ void __cluster_dims__(kBandCluster, 1, 1)
__launch_bounds__(kBandThreads, 1)
flat_take_band_kernel(const float* __restrict__ flat,
                      const int* __restrict__ idx, BandPlan p,
                      float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = shared_addr(smem);
  const uint32_t consumed0 = full0 + 8 * kBandStages;
  const uint32_t empty0 = consumed0 + 8 * kBandStages;
  const uint32_t ring = full0 + kBandHeader;
  const uint32_t rank = cluster_rank();
  const int cluster = static_cast<int>(blockIdx.x) / kBandCluster;
  const int rounds = cluster < p.n_groups
                         ? (p.n_groups - cluster + p.n_clusters - 1) /
                               p.n_clusters
                         : 0;
  const int items = rounds * p.n_bands;
  if (threadIdx.x == 0) {
    for (int d = 0; d < kBandStages; ++d) {
      // full: the producer's expect-tx arrival; consumed: one a consumer
      // warp of the block; empty: one a producer of the cluster
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(full0 + 8 * d) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(consumed0 + 8 * d), "r"(kBandConsumers / 32)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(empty0 + 8 * d), "r"(kBandCluster)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every barrier of the cluster is set up

  if (threadIdx.x < 32) {
    // -------------------------------------------------------- producer
    // Lane 0 copies: item q into stage q % kBandStages once every block of
    // the cluster has read item q - kBandStages there.  Lanes 1 ..
    // kBandCluster forward: lane 1 + c tells block c that this block has
    // read an item, as soon as its consumers have, so that the copies run
    // ahead of the reads.
    const int lane = threadIdx.x;
    if (lane == 0) {
      for (int q = 0; q < items; ++q) {
        const int st = q % kBandStages;
        if (q >= kBandStages)
          wait_parity_cluster(empty0 + 8 * st, ((q / kBandStages) - 1) & 1);
        issue_band(flat, p, q, rank, full0, ring);
        const int round = q / p.n_bands;
        if (q % p.n_bands == 0 && round + 1 < rounds) {
          // the next round's chunk into L2 while this round sweeps
          const size_t next =
              (static_cast<size_t>(cluster + (round + 1) * p.n_clusters) *
                   kBandCluster + rank) * kBandChunk;
          if (next < p.n) {
            const size_t left = p.n - next;
            const size_t bytes =
                (left < kBandChunk ? left : kBandChunk) * 4 / 16 * 16;
            if (bytes > 0)
              asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                           :: "l"(idx + next),
                              "r"(static_cast<uint32_t>(bytes))
                           : "memory");
          }
        }
      }
    } else if (lane <= kBandCluster) {
      // only the items a later item's copy waits for
      for (int x = 0; x + kBandStages < items; ++x) {
        const int st = x % kBandStages;
        wait_parity(consumed0 + 8 * st, (x / kBandStages) & 1);
        cluster_arrive(empty0 + 8 * st, static_cast<uint32_t>(lane - 1));
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    const int t = threadIdx.x - 32;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    float4* out4 = reinterpret_cast<float4*>(out);
    const size_t n4 = p.n / 4;
    int v[kBandSlots];
    unsigned served = 0;
    size_t chunk4 = 0;   // the round's chunk, in int4 from the start
    for (int q = 0; q < items; ++q) {
      const int b = q % p.n_bands;
      const int st = q % kBandStages;
      if (b == 0) {   // a new round: its chunk's indices into registers
        const size_t chunk =
            static_cast<size_t>(cluster + q / p.n_bands * p.n_clusters) *
                kBandCluster + rank;
        chunk4 = chunk * (kBandChunk / 4);
        served = 0;
#pragma unroll
        for (int j = 0; j < kBandSlots / 4; ++j) {
          const size_t p4 = chunk4 +
                            static_cast<size_t>(j) * kBandConsumers + t;
          int4 c = make_int4(0, 0, 0, 0);
          if (p4 < n4) {
            c = __ldcs(idx4 + p4);
          } else {
            // past the whole int4s: the tail's indices one by one, and
            // the slots past the end served with nothing to serve
            const size_t e = 4 * p4;
            c.x = e < p.n ? idx[e] : 0;
            c.y = e + 1 < p.n ? idx[e + 1] : 0;
            c.z = e + 2 < p.n ? idx[e + 2] : 0;
            c.w = e + 3 < p.n ? idx[e + 3] : 0;
            const unsigned live = e >= p.n ? 0u : (1u << (p.n - e)) - 1u;
            served |= (~live & 0xfu) << (4 * j);
          }
          v[4 * j] = 4 * min(max(c.x, 0), p.HW - 1);
          v[4 * j + 1] = 4 * min(max(c.y, 0), p.HW - 1);
          v[4 * j + 2] = 4 * min(max(c.z, 0), p.HW - 1);
          v[4 * j + 3] = 4 * min(max(c.w, 0), p.HW - 1);
        }
      }
      wait_parity(full0 + 8 * st, (q / kBandStages) & 1);
      // slots hold byte offsets into the image until served
      const uint32_t stage = ring + 4u * st * p.band;
      const unsigned begin = 4u * b * p.band;
      const unsigned len = 4u * min(p.band, p.HW - b * p.band);
#pragma unroll
      for (int r = 0; r < kBandSlots; ++r) {
        const unsigned u = static_cast<unsigned>(v[r]) - begin;
        const bool hit = !((served >> r) & 1u) && u < len;
        float x;   // a slot that is not served reads the stage's first
        asm("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(stage + (hit ? u : 0u)));
        v[r] = hit ? __float_as_int(x) : v[r];
        served |= static_cast<unsigned>(hit) << r;
      }
      __syncwarp();   // every lane of the warp has read the stage
      if ((t & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(consumed0 + 8 * st) : "memory");
      if (b == p.n_bands - 1) {   // the round's values out
#pragma unroll
        for (int j = 0; j < kBandSlots / 4; ++j) {
          const size_t p4 = chunk4 +
                            static_cast<size_t>(j) * kBandConsumers + t;
          const float4 x = make_float4(
              __int_as_float(v[4 * j]), __int_as_float(v[4 * j + 1]),
              __int_as_float(v[4 * j + 2]), __int_as_float(v[4 * j + 3]));
          if (p4 < n4) {
            __stcs(out4 + p4, x);
          } else {
            const size_t e = 4 * p4;
            if (e < p.n) out[e] = x.x;
            if (e + 1 < p.n) out[e + 1] = x.y;
            if (e + 2 < p.n) out[e + 2] = x.z;
          }
        }
      }
    }
  }
  cluster_sync();   // no block leaves while a copy or arrival may reach it
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// The SM count of the current device, and every "strip" kernel allowed
// the 227 KB of shared memory a block may have, done once a device and
// thread: the attribute and the query cost more host time than a launch.
int strip_setup(int* sms) {
  thread_local int known_sms[kMaxDevices];
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device < kMaxDevices && known_sms[device] > 0) {
    *sms = known_sms[device];
    return 0;
  }
  const void* kernels[] = {
      reinterpret_cast<const void*>(take_axis0_strip_kernel<true>),
      reinterpret_cast<const void*>(take_axis0_strip_kernel<false>),
      reinterpret_cast<const void*>(multi_warp_strip_kernel<true>),
      reinterpret_cast<const void*>(multi_warp_strip_kernel<false>),
      reinterpret_cast<const void*>(take_axis1_row_kernel<true>),
      reinterpret_cast<const void*>(take_axis1_row_kernel<false>)};
  status = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  device);
  for (const void* kernel : kernels)
    if (status == cudaSuccess)
      status = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSharedBytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device < kMaxDevices) known_sms[device] = *sms;
  return 0;
}

}  // namespace

// Each launcher runs on ``stream`` and returns cudaGetLastError() as an
// int (0 = OK); a refused size returns cudaErrorInvalidValue.  Pointers
// are device pointers to contiguous float32 / int32 arrays: img (H, W),
// idx / idxr / idxc / out (H, W) for the axis gathers and multi_warp,
// idx / out (S, N) for the flat gathers.  The "strip" launchers take
// 16-byte aligned arrays and run the "thread" kernel where a strip does
// not fit in a block's shared memory.

// The "thread" kernels of take_along_axis along ``axis``.
extern "C" int take_along_axis_launch(const float* img, const int* idx,
                                      int H, int W, int axis, float* out,
                                      void* stream) {
  if (H < 1 || W < 1 || (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = blocks_for(static_cast<size_t>(H) * W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 0)
    take_axis0_kernel<<<blocks, kThreads, 0, s>>>(img, idx, H, W, out);
  else
    take_axis1_kernel<<<blocks, kThreads, 0, s>>>(img, idx, H, W, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int take_along_axis0_strip_launch(const float* img,
                                             const int* idx, int H, int W,
                                             float* out, void* stream) {
  int sms = 0;
  const int status = H < 1 || W < 1 ? static_cast<int>(cudaErrorInvalidValue)
                                    : strip_setup(&sms);
  if (status != 0) return status;
  // as many bands as leave one block an SM, the strip and one band of
  // idx in shared memory
  const int strips = (W + kStrip - 1) / kStrip;
  const int bands = max(1, min(H, sms / strips));
  const int band = (H + bands - 1) / bands;
  const long bytes = 4L * kStrip * (H + band);
  if (bytes > kMaxSharedBytes)
    return take_along_axis_launch(img, idx, H, W, 0, out, stream);
  const dim3 grid(strips, (H + band - 1) / band);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0)
    take_axis0_strip_kernel<true><<<grid, kThreads, bytes, s>>>(
        img, idx, H, W, band, out);
  else
    take_axis0_strip_kernel<false><<<grid, kThreads, bytes, s>>>(
        img, idx, H, W, band, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multi_warp_launch(const float* img, const int* idxr,
                                 const int* idxc, int H, int W, int S,
                                 int stride, float* out, void* stream) {
  if (H < 1 || W < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  multi_warp_kernel<<<blocks_for(static_cast<size_t>(H) * W), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      img, idxr, idxc, H, W, S, stride, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int multi_warp_strip_launch(const float* img, const int* idxr,
                                       const int* idxc, int H, int W, int S,
                                       int stride, float* out,
                                       void* stream) {
  int sms = 0;
  const int status = H < 1 || W < 1 || S < 0
                         ? static_cast<int>(cudaErrorInvalidValue)
                         : strip_setup(&sms);
  if (status != 0) return status;
  const long bytes = 4L * kStrip * H;
  if (bytes > kMaxSharedBytes)
    return multi_warp_launch(img, idxr, idxc, H, W, S, stride, out, stream);
  const dim3 grid((W + kStrip - 1) / kStrip,
                  (H + kMultiBand - 1) / kMultiBand);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0)
    multi_warp_strip_kernel<true><<<grid, kStripThreads, bytes, s>>>(
        img, idxr, idxc, H, W, S, stride, out);
  else
    multi_warp_strip_kernel<false><<<grid, kStripThreads, bytes, s>>>(
        img, idxr, idxc, H, W, S, stride, out);
  return static_cast<int>(cudaGetLastError());
}

// One empty block: the card's floor for the time of one launch.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_take_launch(const float* flat, int HW, const int* idx,
                                int S, int N, float* out, void* stream) {
  if (HW < 1 || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(S) * N;
  flat_take_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(flat, HW, idx, n,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

// The "row" design of take_along_axis1: bands of rows staged in shared
// memory, as many bands as make two blocks an SM (240 at 480 rows on 132
// SMs); the "thread" kernel where one row does not fit in a block's
// shared memory (W past 58112).
extern "C" int take_along_axis1_row_launch(const float* img, const int* idx,
                                           int H, int W, float* out,
                                           void* stream) {
  int sms = 0;
  const int status = H < 1 || W < 1 ? static_cast<int>(cudaErrorInvalidValue)
                                    : strip_setup(&sms);
  if (status != 0) return status;
  const long row_bytes = 4L * W;
  if (row_bytes > kMaxSharedBytes)
    return take_along_axis_launch(img, idx, H, W, 1, out, stream);
  const int band = min((H + 2 * sms - 1) / (2 * sms),
                       static_cast<int>(kMaxSharedBytes / row_bytes));
  const unsigned grid = static_cast<unsigned>((H + band - 1) / band);
  const long bytes = row_bytes * band;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0)
    take_axis1_row_kernel<true><<<grid, kThreads, bytes, s>>>(img, idx, H,
                                                              W, band, out);
  else
    take_axis1_row_kernel<false><<<grid, kThreads, bytes, s>>>(img, idx, H,
                                                               W, band, out);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// The plan of flat_take's "band" design for an image of HW floats (a
// multiple of 4) and S x N indices on the current device: a persistent
// grid of as many clusters as fit (one block an SM), at most one a group
// of chunks.
int plan_band(int HW, int S, int N, BandPlan* p, int* bytes) {
  if (HW < 1 || HW % 4 != 0 || HW > INT_MAX / 4 || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int band = min(kBandFloats, HW);
  *bytes = kBandHeader + 4 * kBandStages * band;
  cudaError_t status = cudaFuncSetAttribute(
      flat_take_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      *bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kBandCluster);
  config.blockDim = dim3(kBandThreads);
  config.dynamicSmemBytes = *bytes;
  int clusters = 0;
  status = cudaOccupancyMaxActiveClusters(&clusters, flat_take_band_kernel,
                                          &config);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  p->HW = HW;
  p->band = band;
  p->n_bands = (HW + band - 1) / band;
  p->n = static_cast<size_t>(S) * N;
  const size_t chunks = (p->n + kBandChunk - 1) / kBandChunk;
  p->n_groups = static_cast<int>((chunks + kBandCluster - 1) / kBandCluster);
  p->n_clusters = min(clusters, p->n_groups);
  return 0;
}

}  // namespace

// flat_take: the "band" design (see plan_band; idx and out 16-byte
// aligned), and the "thread" kernel where HW % 4 != 0 (bands are copied
// in 16-byte pieces).
extern "C" int flat_take_band_launch(const float* flat, int HW,
                                     const int* idx, int S, int N,
                                     float* out, void* stream) {
  if (HW % 4 != 0)
    return flat_take_launch(flat, HW, idx, S, N, out, stream);
  BandPlan p;
  int bytes = 0;
  const int status = plan_band(HW, S, N, &p, &bytes);
  if (status != 0) return status;
  flat_take_band_kernel<<<kBandCluster * p.n_clusters, kBandThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(flat, idx, p,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

// idx and out must be 16-byte aligned.
extern "C" int flat_take_rows_launch(const float* flat, int HW,
                                     const int* idx, int S, int N,
                                     float* out, void* stream) {
  if (HW < 1 || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(S) * N;
  const size_t n4 = n / 4;
  const size_t per_block = static_cast<size_t>(kThreads) * kStreamChunks;
  const unsigned blocks = static_cast<unsigned>(
      n4 == 0 ? 1 : (n4 + per_block - 1) / per_block);
  flat_take_rows_stream_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      flat, HW, idx, n, out);
  return static_cast<int>(cudaGetLastError());
}
