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
// element (flat_take_rows: per column of a 2048-column tile), index and
// output accessed with consecutive threads on consecutive addresses so
// they coalesce, the image read through the read-only path (__ldg), whose
// scattered 4-byte reads are served from L2.
//
// - multi_warp fuses the two passes per pixel: r = idxr[i, j],
//   c = idxc[r, j], v = img[r, c], and accumulates acc = acc + v (1 + s)
//   for s = 0 .. S-1 in that order, so that it rounds as the plain
//   version does (--fmad=false).  The probe measures the cost of each
//   warp, so all S gather chains must run: each address adds s * stride
//   with a stride the caller passes at run time (0), which the compiler
//   cannot prove constant, so it cannot hoist the loads out of the loop.
// - flat_take_rows walks each column's index rows in groups of eight:
//   eight independent gathers in flight per thread, against flat_take's
//   one, the card's reading of the TPU kernel's eight-sublane tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsTile = 2048;     // columns per block of flat_take_rows
constexpr int kRowsGroup = 8;       // index rows gathered together

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

__global__ void flat_take_rows_kernel(const float* __restrict__ flat, int HW,
                                      const int* __restrict__ idx, int S,
                                      int N, float* __restrict__ out) {
  const int col0 = static_cast<int>(blockIdx.x) * kRowsTile;
  const int col_end = min(col0 + kRowsTile, N);
  for (int col = col0 + static_cast<int>(threadIdx.x); col < col_end;
       col += kThreads) {
    for (int g = 0; g < S; g += kRowsGroup) {
      int ids[kRowsGroup];
#pragma unroll
      for (int k = 0; k < kRowsGroup; ++k) {
        ids[k] = g + k < S ? idx[static_cast<size_t>(g + k) * N + col] : 0;
      }
      float vals[kRowsGroup];
#pragma unroll
      for (int k = 0; k < kRowsGroup; ++k) {
        int i = ids[k];
        vals[k] = wrap_index(i, HW) ? __ldg(flat + i) : nan_value();
      }
#pragma unroll
      for (int k = 0; k < kRowsGroup; ++k) {
        if (g + k < S) out[static_cast<size_t>(g + k) * N + col] = vals[k];
      }
    }
  }
}

unsigned blocks_for(size_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
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

extern "C" int flat_take_rows_launch(const float* flat, int HW,
                                     const int* idx, int S, int N,
                                     float* out, void* stream) {
  if (HW < 1 || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((N + kRowsTile - 1) /
                                                kRowsTile);
  flat_take_rows_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      flat, HW, idx, S, N, out);
  return static_cast<int>(cudaGetLastError());
}
