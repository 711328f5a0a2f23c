// The normal equations [J^T W J | J^T W r] (B, 6, 7) of one Gauss-Newton
// step of the PnP refinement (tadataka_torch/pose_estimation/pnp.py,
// pnp_normal), bit for bit equal to its plain PyTorch version
// (pnp_normal_reference).
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA
// (a jacfwd of the residuals under vmap).  The port added it because in
// PyTorch that Jacobian and the products took some 590 dispatched
// operations a step, so the step was bound by the host's dispatch.
//
// For batch entry b, point i (row 2i its x residual, 2i+1 its y):
//     Y = R X (left to right), P = Y + t, z = P_z + 1e-16, u = P_xy / z,
//     r = u - keypoint,
// and the Jacobian row of coordinate c of the increment (w_x, w_y, w_z,
// t_x, t_y, t_z), dP = -[Y]_x for the rotation and I for the
// translation:
//     J_a = (dP_c - dP_z * u_c) / z.
// Column q = 7a + b of the output sums (J_a w) * J_b (b < 6) or
// (J_a w) * r (b = 6) over the 2n rows, every product rounded on its own
// (build with --fmad=false): rows of weight 0 are multiplied like any
// other, so a non-finite row gives the plain version's NaN.
//
// The sum is fixed_order_sum's tree (core/rounding.py): the 2n products
// padded with +0.0 to P = 2^ceil(log2 2n), and at each level element j
// of a size-s array is x[j] + x[j + s/2].  That is the pairwise tree of
// adjacent elements over the leaves taken in bit-reversed order (leaf k
// holds row bitrev(k)), so any aligned run of 2^m consecutive k is a
// subtree.  A batch entry is one block, which takes the k axis in
// aligned chunks of kChunk leaves: it stages a chunk's Jacobian rows, r
// and w in shared memory; each of the 42 columns has `lanes` threads,
// thread s summing the chunk's leaves s*per .. s*per + per - 1 as an
// unrolled tree (per is a template argument); the lanes' partials halve
// by warp shuffles (offsets 1, 2, 4, ...), and lane 0 adds the chunk's
// partial to a binary counter over the chunks (its stack in shared
// memory), whose last merge is the whole tree.
//
// What bounds it: the launch.  A step reads 6 floats a point (48 KB at
// n = 2000) and computes about 2n * 120 float operations (0.5 MFLOP):
// well under a microsecond of the card's bandwidth or instruction rate,
// against a few microseconds for a launch.  So the design keeps one
// launch a step, for any batch and point count (B = 1, n ~ 2000 for the
// VO's PnP; B = trials * 4, n = 3 for P3P's refinement), the block's
// shape and the tree's depth taken from n.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 42;        // 6 rows of 7: J^T W J and J^T W r
constexpr int kChunk = 256;      // leaves staged in shared memory at once
constexpr int kLanes = 16;       // threads of a column, at most
constexpr int kThreads = kCols * kLanes;
constexpr int kChunkLevels = 23; // log2(2^30 / kChunk) + 1: 2n <= 2^30

// Push v as leaf i of a binary counter whose stack entry l (the open
// subtree of size 2^l) is stack[l * stride]: merge it with the subtrees
// it completes, leftmost first; returns the merged value, which after
// the last of 2^m leaves is the whole tree.
__device__ __forceinline__ float push(float* stack, int stride, int i,
                                      float v) {
  int l = 0;
  for (; (i >> l) & 1; ++l) v = stack[l * stride] + v;
  stack[l * stride] = v;
  return v;
}

// The tree of the products (Ja w) Xb of the leaves at p0, p0 + stride,
// .. (kN of them), adjacent pairs first.
template <int kN>
__device__ __forceinline__ float leaf_tree(const float* Ja, const float* w,
                                           const float* Xb, int p0,
                                           int stride) {
  if constexpr (kN == 1) {
    return (Ja[p0] * w[p0]) * Xb[p0];
  } else {
    return leaf_tree<kN / 2>(Ja, w, Xb, p0, stride) +
           leaf_tree<kN / 2>(Ja, w, Xb, p0 + kN / 2 * stride, stride);
  }
}

template <int kN>
__device__ __forceinline__ float leaves_up_to(int per, const float* Ja,
                                              const float* w, const float* Xb,
                                              int s, int lanes) {
  if constexpr (kN > 1) {
    if (per < kN) return leaves_up_to<kN / 2>(per, Ja, w, Xb, s, lanes);
  }
  return leaf_tree<kN>(Ja, w, Xb, s, lanes);
}

__global__ void __launch_bounds__(kThreads)
pnp_normal_kernel(const float* __restrict__ R, const float* __restrict__ t,
                  const float* __restrict__ X,
                  const float* __restrict__ keypoints,
                  const float* __restrict__ weights, int n, int log_p,
                  int chunk, int lanes, float* __restrict__ out) {
  // leaf[0..5]: J_a, leaf[6]: r, leaf[7]: w of the staged leaves, at
  // position i * lanes + s for the i-th leaf of lane s
  __shared__ float leaf[8][kChunk];
  __shared__ float chunk_stack[kChunkLevels][kCols];
  const long long b = blockIdx.x;
  const int rows = 2 * n;
  const int per = chunk / lanes;
  const int chunks = (1 << log_p) / chunk;
  const int q = threadIdx.x / lanes;
  const int s = threadIdx.x % lanes;
  const bool live = q < kCols;
  const int a = live ? q / 7 : 0;
  const int c = live ? q % 7 : 0;

  float Rm[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) Rm[j] = R[9 * b + j];
  const float t0 = t[3 * b], t1 = t[3 * b + 1], t2 = t[3 * b + 2];

  float total = 0.0f;
  for (int ch = 0; ch < chunks; ++ch) {
    const unsigned first = static_cast<unsigned>(ch) * chunk;
    for (int p = threadIdx.x; p < chunk; p += blockDim.x) {
      const unsigned k = first + (p % lanes) * per + p / lanes;
      const int row = static_cast<int>(__brev(k) >> (32 - log_p));
      float J[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float r = 0.0f, w = 0.0f;   // a pad leaf: every product +0.0
      if (row < rows) {
        const long long i = b * n + (row >> 1);
        const int xy = row & 1;
        const float x0 = X[3 * i], x1 = X[3 * i + 1], x2 = X[3 * i + 2];
        const float y0 = x0 * Rm[0] + x1 * Rm[1] + x2 * Rm[2];
        const float y1 = x0 * Rm[3] + x1 * Rm[4] + x2 * Rm[5];
        const float y2 = x0 * Rm[6] + x1 * Rm[7] + x2 * Rm[8];
        const float z = (y2 + t2) + 1e-16f;
        const float u = (xy ? y1 + t1 : y0 + t0) / z;
        r = u - keypoints[2 * i + xy];
        w = weights[i];
        const float zero = 0.0f, one = 1.0f;
        // dP_c and dP_z of each column: -[Y]_x, then I
        const float dc[6] = {xy ? -y2 : zero, xy ? zero : y2,
                             xy ? y0 : -y1,   xy ? zero : one,
                             xy ? one : zero, zero};
        const float dz[6] = {y1, -y0, zero, zero, zero, one};
#pragma unroll
        for (int j = 0; j < 6; ++j) J[j] = (dc[j] - dz[j] * u) / z;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) leaf[j][p] = J[j];
      leaf[6][p] = r;
      leaf[7][p] = w;
    }
    __syncthreads();

    float v = live ? leaves_up_to<kChunk / kLanes>(per, leaf[a], leaf[7],
                                                   leaf[c], s, lanes)
                   : 0.0f;
    // the lanes' subtrees, adjacent pairs first; lane 0 ends with the
    // chunk's (the other lanes' values are not read)
    for (int o = 1; o < lanes; o <<= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, o, lanes);
    if (live && s == 0) total = push(&chunk_stack[0][q], kCols, ch, v);
    __syncthreads();   // the leaves are read before the next chunk
  }
  if (live && s == 0) out[kCols * b + q] = total;
}

}  // namespace

// out (B, 6, 7) from R (B, 3, 3), t (B, 3), X (B, n, 3), keypoints (B,
// n, 2), weights (B, n), all float32 and contiguous, on `stream`;
// 1 <= B < 2^31, 1 <= n <= 2^29.  Returns a CUDA error code (0 =
// launched).
extern "C" int pnp_normal_launch(const float* R, const float* t,
                                 const float* X, const float* keypoints,
                                 const float* weights, long long B,
                                 long long n, float* out, void* stream) {
  if (B < 1 || B >= (1LL << 31) || n < 1 || n > (1LL << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  int log_p = 1;
  while ((1LL << log_p) < 2 * n) ++log_p;
  const int chunk = (1 << log_p) < kChunk ? (1 << log_p) : kChunk;
  const int lanes = chunk < kLanes ? chunk : kLanes;
  const int threads = (kCols * lanes + 31) / 32 * 32;
  pnp_normal_kernel<<<static_cast<unsigned>(B), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      R, t, X, keypoints, weights, static_cast<int>(n), log_p, chunk, lanes,
      out);
  return static_cast<int>(cudaGetLastError());
}
