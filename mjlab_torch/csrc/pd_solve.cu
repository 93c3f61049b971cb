// K1: batched small dense SPD solve H x = g, one warp per env.
//
// Replaces the TPU kernel mjlab_tpu/ops/pd_solve.py:_pd_solve_kernel
// (pallas_call in _pd_solve_tpu). Same numerics: a column Cholesky with
// the pivot clamped to max(col_jj, 1e-12), then forward and back
// substitution.
//
// Bound: bytes. Per env the kernel reads H (n*n floats) and g (n) once and
// writes x (n); the n^3/6 FLOPs are far below the card's f32 rate. What
// held a one-thread-per-env kernel far above that bound on an H100 was not
// the bytes but the shape: 4096 envs were 32 blocks on 132 SMs, every lane
// read its own matrix 4*n*n bytes from its neighbour's, and the factor went
// through a global scratch on a serial chain of L2 latencies. Design: one
// warp per env, several warps a block, so a 4096-env batch fills the card
// in about one wave. The warp reads the lower triangle of its H row by row
// (neighbouring lanes on neighbouring words) into a padded triangle in
// shared memory, with g as one more row, and runs the warp-level routine of
// chol_warp.cuh on it: the factor never leaves the SM and the forward solve
// rides along with the factorization. No padding of the batch: a warp past
// the last env exits, and no block-wide barrier is used.

#include <cuda_runtime.h>

#include "chol_warp.cuh"

namespace {

constexpr int kMaxWarps = 8;

template <int ROWS>
__global__ void pd_solve_kernel(const float* __restrict__ H,
                                const float* __restrict__ g,
                                float* __restrict__ x, int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  float* A = smem + warp * chol_warp::packed_floats(n);
  const float* h = H + static_cast<size_t>(b) * n * n;
  const float* gb = g + static_cast<size_t>(b) * n;
#pragma unroll 4
  for (int i = 0; i < chol_warp::padded_rows(n); ++i) {
    // row i: the lower triangle of H, then g, then zero rows; pads zeroed
    float* row = A + chol_warp::row_off(i);
    for (int j = lane; j < chol_warp::row_len(i); j += 32) {
      float v = 0.f;
      if (i < n && j <= i) v = h[i * n + j];
      if (i == n && j < n) v = gb[j];
      row[j] = v;
    }
  }
  __syncwarp();
  chol_warp::factor_solve<ROWS>(A, n, x + static_cast<size_t>(b) * n,
                                chol_warp::PivotClamp());
}

}  // namespace

// Shared memory one env's warp needs: the padded triangle of H plus g.
extern "C" size_t pd_solve_smem_bytes(int n) {
  return sizeof(float) * chol_warp::packed_floats(n);
}

// Largest n the kernel takes: one warp's triangle within `smem_limit`, the
// bytes of shared memory a block may opt into (the caller names the card's
// limit), and the rows a lane can own.
extern "C" int pd_solve_max_n(size_t smem_limit) {
  int n = chol_warp::kMaxN;
  while (n > 0 && pd_solve_smem_bytes(n) > smem_limit) --n;
  return n;
}

extern "C" int pd_solve_launch(const float* H, const float* g, float* x,
                               int B, int n, size_t smem_limit,
                               void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const size_t per_warp = pd_solve_smem_bytes(n);
  if (n > chol_warp::kMaxN || per_warp > smem_limit)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t warps = smem_limit / per_warp;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const size_t smem = warps * per_warp;
  auto kernel = (n + 1 <= 64) ? pd_solve_kernel<2>
                              : pd_solve_kernel<chol_warp::kMaxRows>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = static_cast<int>((B + warps - 1) / warps);
  kernel<<<blocks, static_cast<int>(32 * warps), smem,
           static_cast<cudaStream_t>(stream)>>>(H, g, x, B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pd_solve_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
