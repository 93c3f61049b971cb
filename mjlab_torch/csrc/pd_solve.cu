// K1: batched small dense SPD solve H x = g (one env per thread).
//
// Replaces the TPU kernel mjlab_tpu/ops/pd_solve.py:_pd_solve_kernel
// (pallas_call in _pd_solve_tpu). Same numerics: a column Cholesky with
// the pivot clamped to max(col_jj, 1e-12), then forward and back
// substitution.
//
// Bound: bytes. Per env the kernel reads H (n*n floats) and g (n) once and
// writes x (n); the n^3/6 FLOPs are far below the card's f32 rate. Design:
// one thread per env, no padding of the batch (the TPU lane padding with
// identity H is not needed). The factor lives in a global scratch laid out
// structure-of-arrays, L[k * B + env] for packed lower-triangle entry k, so
// the threads of a warp touch consecutive words at every step.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

__global__ void pd_solve_kernel(const float* __restrict__ H,
                                const float* __restrict__ g,
                                float* __restrict__ x,
                                float* __restrict__ L, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* h = H + static_cast<size_t>(b) * n * n;
  const float* gb = g + static_cast<size_t>(b) * n;
  float* xb = x + static_cast<size_t>(b) * n;
  auto Lat = [&](int i, int j) -> float& {
    return L[static_cast<size_t>(tri(i, j)) * B + b];
  };

  // Cholesky, column by column (left-looking, as the TPU kernel)
  for (int j = 0; j < n; ++j) {
    float cjj = h[j * n + j];
    for (int k = 0; k < j; ++k) {
      const float l = Lat(j, k);
      cjj -= l * l;
    }
    const float d = sqrtf(fmaxf(cjj, 1e-12f));
    Lat(j, j) = d;
    for (int i = j + 1; i < n; ++i) {
      float c = h[i * n + j];
      for (int k = 0; k < j; ++k) c -= Lat(i, k) * Lat(j, k);
      Lat(i, j) = c / d;
    }
  }
  // forward solve L y = g (y kept in x)
  for (int j = 0; j < n; ++j) {
    float acc = gb[j];
    for (int k = 0; k < j; ++k) acc -= Lat(j, k) * xb[k];
    xb[j] = acc / Lat(j, j);
  }
  // back solve L^T x = y
  for (int j = n - 1; j >= 0; --j) {
    float acc = xb[j];
    for (int k = j + 1; k < n; ++k) acc -= Lat(k, j) * xb[k];
    xb[j] = acc / Lat(j, j);
  }
}

}  // namespace

extern "C" int pd_solve_launch(const float* H, const float* g, float* x,
                               float* L, int B, int n, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  pd_solve_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      H, g, x, L, B, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pd_solve_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
