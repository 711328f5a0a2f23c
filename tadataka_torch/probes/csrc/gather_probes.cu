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
// for the (64, 307200) flat gathers).  The design: one thread per output
// element, index and output accessed with consecutive threads on
// consecutive addresses so they coalesce, the image read through the
// read-only path (__ldg), whose scattered 4-byte reads are served from
// L2.
//
// - multi_warp fuses the two passes per pixel: r = idxr[i, j],
//   c = idxc[r, j], v = img[r, c], and accumulates acc = acc + v (1 + s)
//   for s = 0 .. S-1 in that order, so that it rounds as the plain
//   version does (--fmad=false).  The probe measures the cost of each
//   warp, so all S gather chains must run: each address adds s * stride
//   with a stride the caller passes at run time (0), which the compiler
//   cannot prove constant, so it cannot hoist the loads out of the loop.
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

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);   // the quiet NaN of float("nan")
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

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

}  // namespace

// Each launcher runs on ``stream`` and returns cudaGetLastError() as an
// int (0 = OK); a refused size returns cudaErrorInvalidValue.  Pointers
// are device pointers to contiguous float32 / int32 arrays: img (H, W),
// idx / idxr / idxc / out (H, W) for the axis gathers and multi_warp,
// idx / out (S, N) for the flat gathers.

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
