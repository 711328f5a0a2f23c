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
//   Two designs:
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
//   j], j]).  Two designs:
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
// - flat_take_rows: every index row gathers from the same image, so the
//   gather is elementwise over the S*N indices taken as one flat array,
//   and no row needs its own 16-byte head or tail (S*N % 4 elements are
//   left at the end, done one by one).  Two designs:
//   * "stream": each thread loads four 16-byte index chunks with an
//     evict-first hint (__ldcs), so 16 independent gathers are in flight
//     a thread, reads the image through __ldg (from L1 or L2) and writes
//     four outputs at a time with streaming stores (__stcs); blocks of
//     256 threads, several resident on every SM.  Random gathers cost one
//     32-byte L2 sector each (19.7M at 64 x 307200), and those sectors,
//     not the 158.5 MB of index and output, set its time.
//   * "cluster": a cluster of 8 blocks, one per SM, holds the whole image
//     in shared memory (1/8 of it each, brought in by one bulk copy per
//     block), and every gather reads the owning block's slice over the
//     SM-to-SM network (mapa + ld.shared::cluster) instead of from L2.
//     The image must fit in 8 x 227 KB.  A persistent grid of as many
//     clusters as fit walks the index chunks.  It is slower than
//     "stream" on the card and stays as the probe of the SM-to-SM
//     network's rate for random 4-byte reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStreamChunks = 4;      // 16-byte index chunks a thread
constexpr int kClusterSize = 8;       // blocks holding one image copy
constexpr int kClusterThreads = 1024;
constexpr int kClusterChunks = 4;
constexpr int kClusterHeader = 128;   // the mbarrier, then the slice
constexpr int kMaxSharedBytes = 232448;   // 227 KB, Hopper's per-block cap
constexpr int kMaxCopyBytes = 65536;      // one bulk copy's share of a slice
constexpr int kStrip = 32;            // columns of a "strip" block
constexpr int kStripThreads = 256;    // threads of a multi_warp block
constexpr int kStripRows = kStripThreads / kStrip;   // rows a pass
constexpr int kMultiBand = 32;        // rows of a multi_warp block's band
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

// ----------------------------------------------- flat_take_rows, "cluster"

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// flat[wrap(i)] from the block of the cluster that holds it, or NaN.  The
// slices are written once, before the cluster barrier that every read
// follows (its index comes from a load the barrier orders), so the read
// is a plain asm the compiler may schedule with the other gathers.
__device__ __forceinline__ float cluster_take(uint32_t part, int slice,
                                              int HW, int i) {
  const bool ok = wrap_index(i, HW);
  const uint32_t j = ok ? static_cast<uint32_t>(i) : 0u;
  const uint32_t rank = j / static_cast<uint32_t>(slice);
  const uint32_t local = part + 4u * (j - rank * static_cast<uint32_t>(slice));
  uint32_t remote;
  float v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(local), "r"(rank));
  asm("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return ok ? v : nan_value();
}

// Each block of a cluster holds flat[rank * slice, (rank + 1) * slice).
__global__ void __cluster_dims__(kClusterSize, 1, 1)
__launch_bounds__(kClusterThreads, 1)
flat_take_rows_cluster_kernel(const float* __restrict__ flat, int HW,
                              int slice, const int* __restrict__ idx,
                              size_t n, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bar = shared_addr(smem);
  const uint32_t part = bar + kClusterHeader;
  float* mine = reinterpret_cast<float*>(smem + kClusterHeader);
  const int begin = static_cast<int>(cluster_rank()) * slice;
  const int len = max(0, min(slice, HW - begin));
  const int bulk = len & ~3;              // floats in 16-byte multiples
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bulk * 4) : "memory");
    for (int off = 0; off < bulk * 4; off += kMaxCopyBytes) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(part + off), "l"(flat + begin + off / 4),
             "r"(min(kMaxCopyBytes, bulk * 4 - off)), "r"(bar)
          : "memory");
    }
  }
  if (static_cast<int>(threadIdx.x) < len - bulk)
    mine[bulk + threadIdx.x] = flat[begin + bulk + threadIdx.x];
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      " @!done bra WAIT;\n}" :: "r"(bar) : "memory");
  cluster_sync();          // every slice of the cluster is in place

  const size_t n4 = n / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  const size_t per_block = static_cast<size_t>(kClusterThreads) *
                           kClusterChunks;
  for (size_t b = blockIdx.x; b * per_block < n4; b += gridDim.x) {
    const size_t base = b * per_block + threadIdx.x;
    int4 ids[kClusterChunks];
#pragma unroll
    for (int k = 0; k < kClusterChunks; ++k) {
      const size_t p = base + static_cast<size_t>(k) * kClusterThreads;
      ids[k] = p < n4 ? __ldcs(idx4 + p) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kClusterChunks; ++k) {
      const size_t p = base + static_cast<size_t>(k) * kClusterThreads;
      const float4 v = make_float4(cluster_take(part, slice, HW, ids[k].x),
                                   cluster_take(part, slice, HW, ids[k].y),
                                   cluster_take(part, slice, HW, ids[k].z),
                                   cluster_take(part, slice, HW, ids[k].w));
      if (p < n4) __stcs(out4 + p, v);
    }
  }
  const size_t tail = n4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && tail < n)
    out[tail] = cluster_take(part, slice, HW, idx[tail]);
  cluster_sync();          // no block leaves while its slice may be read
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

// Floats of the image each block of a cluster holds (a multiple of 4, so
// every slice starts 16-byte aligned).
int cluster_slice(int HW) {
  return (HW + 4 * kClusterSize - 1) / (4 * kClusterSize) * 4;
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
      reinterpret_cast<const void*>(multi_warp_strip_kernel<false>)};
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

// Shared memory a block of flat_take_rows' "cluster" design needs for an
// image of HW floats (0 if 8 blocks cannot hold it).
extern "C" int flat_take_rows_cluster_bytes(int HW) {
  const long bytes = kClusterHeader + 4L * cluster_slice(HW);
  return HW >= 1 && bytes <= kMaxSharedBytes ? static_cast<int>(bytes) : 0;
}

// design 0: "stream", 1: "cluster".  idx and out must be 16-byte aligned.
extern "C" int flat_take_rows_launch(const float* flat, int HW,
                                     const int* idx, int S, int N,
                                     int design, float* out, void* stream) {
  if (HW < 1 || S < 1 || N < 1 || (design != 0 && design != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(S) * N;
  const size_t n4 = n / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    const size_t per_block = static_cast<size_t>(kThreads) * kStreamChunks;
    const unsigned blocks = static_cast<unsigned>(
        n4 == 0 ? 1 : (n4 + per_block - 1) / per_block);
    flat_take_rows_stream_kernel<<<blocks, kThreads, 0, s>>>(flat, HW, idx,
                                                             n, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int bytes = flat_take_rows_cluster_bytes(HW);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t status = cudaFuncSetAttribute(
      flat_take_rows_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kClusterSize);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = s;
  int clusters = 0;
  status = cudaOccupancyMaxActiveClusters(
      &clusters, flat_take_rows_cluster_kernel, &config);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t per_cluster = static_cast<size_t>(kClusterSize) *
                             kClusterThreads * kClusterChunks;
  size_t needed = (n4 + per_cluster - 1) / per_cluster;
  if (needed < 1) needed = 1;
  if (needed > static_cast<size_t>(clusters)) needed = clusters;
  const unsigned blocks = static_cast<unsigned>(kClusterSize * needed);
  flat_take_rows_cluster_kernel<<<blocks, kClusterThreads, bytes, s>>>(
      flat, HW, cluster_slice(HW), idx, n, out);
  return static_cast<int>(cudaGetLastError());
}
