// K2: the whole pyramidal Newton constraint solve, one env per block.
//
// Replaces the TPU kernel mjlab_tpu/ops/newton.py:_make_kernel
// (pallas_call in newton_solve_tpu). Per env it minimizes over qacc
//   0.5 (x - a0)^T M (x - a0) + friction (Huber) + limit and contact
//   (one-sided quadratic) costs,
// with the structured rows of physics/constraint.py: dof-friction rows have
// J = I, limit rows are one-hot at dof ldof[j], only contact rows are
// dense (cJ). Each iteration: forces, gradient, the Hessian
// H = M + diag(friction/limit) + cJ^T D cJ (lower triangle), a Cholesky
// with a +1e-12 ridge and pivot max(col + 1e-12, 1e-12), two triangular
// solves, a 10-point parallel linesearch bracket and `ls_polish`
// safeguarded bracket-bisect steps; a lane whose |grad|^2 <= grad_th^2
// takes a zero step. Outputs qacc, ff (n), fl (nl), fc (ncr).
//
// Bound: operations. Per iteration the Hessian build costs ncr*n*(n+1)/2
// multiply-adds (90k at the G1's ncr=144, n=35), the factor n^3/6, while
// the inputs are read once. Design: one thread block per env; M, H, L and
// cJ live in shared memory (dynamic, above 48 KB with the opt-in), the
// block's threads split the Hessian entries, the Cholesky rows and the
// linesearch sums; sums reduce by warp shuffles. The TPU's 128-lane
// structure-of-arrays layout and its unrolled loops are Mosaic constraints
// and are not carried over. The model-class fit rule is
// newton_smem_bytes() <= 227 KB (ops/newton.py).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-15f;
constexpr int kRed = 12;  // max values reduced at once

// Sum K values over the block; every thread gets the totals. `red` holds
// 32 * kRed floats. Threads must all call it (it synchronizes).
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    v[k] = s;
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * kRed + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) s += red[w * kRed + k];
    v[k] = s;
  }
}

__device__ __forceinline__ float f_oneside(float jar, float D, float act,
                                           float* quad) {
  const float q = (jar < 0.f) ? act : 0.f;
  *quad = q;
  return -D * jar * q;
}

__device__ __forceinline__ float f_friction(float jar, float D, float floss,
                                            float act, float* quad) {
  const float actf = (floss > 0.f) ? act : 0.f;
  const float dj = D * jar;
  *quad = (fabsf(dj) < floss) ? actf : 0.f;
  return -fminf(fmaxf(dj, -floss), floss) * actf;
}

__device__ __forceinline__ float c_oneside(float jar, float D, float act) {
  return (jar < 0.f) ? 0.5f * D * jar * jar * act : 0.f;
}

__device__ __forceinline__ float c_friction(float jar, float D, float floss,
                                            float act) {
  const float actf = (floss > 0.f) ? act : 0.f;
  const float quad = 0.5f * D * jar * jar;
  const float lin = floss * fabsf(jar) - 0.5f * floss * floss / fmaxf(D, kEps);
  return ((fabsf(D * jar) < floss) ? quad : lin) * actf;
}

struct Problem {
  const float *M, *a0, *ws, *cJ, *c_aref, *cD, *c_act, *l_sign, *l_aref,
      *lD, *l_act, *f_aref, *fD, *floss, *f_act;
  const int* ldof;
  float *x_out, *ff_out, *fl_out, *fc_out;
  int n, ncr, nl, iterations, ls_polish;
  float th2;
};

__global__ void newton_kernel(Problem P) {
  extern __shared__ float smem[];
  const int n = P.n, ncr = P.ncr, nl = P.nl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;

  // shared layout
  float* M = smem;                // n*n
  float* H = M + n * n;           // n*n (lower triangle used)
  float* L = H + n * n;           // n*n (lower triangle used)
  float* cJ = L + n * n;          // ncr*n
  float* x = cJ + ncr * n;        // n
  float* a0 = x + n;
  float* grad = a0 + n;
  float* dx = grad + n;
  float* Md = dx + n;
  float* jf0 = Md + n;
  float* ff = jf0 + n;
  float* diag = ff + n;
  float* fD = diag + n;
  float* floss = fD + n;
  float* f_aref = floss + n;
  float* f_act = f_aref + n;      // 12 n so far
  float* l_sign = f_act + n;      // nl
  float* l_aref = l_sign + nl;
  float* lD = l_aref + nl;
  float* l_act = lD + nl;
  float* jl0 = l_act + nl;
  float* jd_l = jl0 + nl;
  float* fl = jd_l + nl;          // 7 nl
  float* c_aref = fl + nl;        // ncr
  float* cD = c_aref + ncr;
  float* c_act = cD + ncr;
  float* jc0 = c_act + ncr;
  float* jd_c = jc0 + ncr;
  float* fc = jd_c + ncr;         // 6 ncr
  float* red = fc + ncr;          // 32 * kRed
  int* linv = reinterpret_cast<int*>(red + 32 * kRed);  // n ints

  // ---- load this env's problem ----------------------------------------
  const float* gM = P.M + b * n * n;
  for (int e = tid; e < n * n; e += nt) M[e] = gM[e];
  const float* gJ = P.cJ + b * ncr * n;
  for (int e = tid; e < ncr * n; e += nt) cJ[e] = gJ[e];
  for (int i = tid; i < n; i += nt) {
    a0[i] = P.a0[b * n + i];
    fD[i] = P.fD[b * n + i];
    floss[i] = P.floss[b * n + i];
    f_aref[i] = P.f_aref[b * n + i];
    f_act[i] = P.f_act[b * n + i];
    linv[i] = -1;
  }
  for (int j = tid; j < nl; j += nt) {
    l_sign[j] = P.l_sign[b * nl + j];
    l_aref[j] = P.l_aref[b * nl + j];
    lD[j] = P.lD[b * nl + j];
    l_act[j] = P.l_act[b * nl + j];
  }
  for (int r = tid; r < ncr; r += nt) {
    c_aref[r] = P.c_aref[b * ncr + r];
    cD[r] = P.cD[b * ncr + r];
    c_act[r] = P.c_act[b * ncr + r];
  }
  __syncthreads();
  for (int j = tid; j < nl; j += nt) linv[P.ldof[j]] = j;
  // warm start: ws or a0, whichever costs less (both costs in one pass)
  {
    const float* ws = P.ws + b * n;
    for (int i = tid; i < n; i += nt) dx[i] = ws[i];  // dx holds ws here
    __syncthreads();
    float v[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += nt) {
      float mi = 0.f;
      for (int k = 0; k < n; ++k) mi += M[i * n + k] * (dx[k] - a0[k]);
      v[0] += 0.5f * (dx[i] - a0[i]) * mi
              + c_friction(dx[i] - f_aref[i], fD[i], floss[i], f_act[i]);
      v[1] += c_friction(a0[i] - f_aref[i], fD[i], floss[i], f_act[i]);
    }
    for (int j = tid; j < nl; j += nt) {
      const int d = P.ldof[j];
      v[0] += c_oneside(l_sign[j] * dx[d] - l_aref[j], lD[j], l_act[j]);
      v[1] += c_oneside(l_sign[j] * a0[d] - l_aref[j], lD[j], l_act[j]);
    }
    for (int r = tid; r < ncr; r += nt) {
      float jw = 0.f, ja = 0.f;
      for (int k = 0; k < n; ++k) {
        jw += cJ[r * n + k] * dx[k];
        ja += cJ[r * n + k] * a0[k];
      }
      v[0] += c_oneside(jw - c_aref[r], cD[r], c_act[r]);
      v[1] += c_oneside(ja - c_aref[r], cD[r], c_act[r]);
    }
    block_sum<2>(v, red);
    const bool use_ws = v[0] < v[1];
    for (int i = tid; i < n; i += nt) x[i] = use_ws ? dx[i] : a0[i];
    __syncthreads();
  }

  const float scales[10] = {0.f, 0.125f, 0.25f, 0.5f, 0.75f,
                            1.f, 1.5f, 2.f, 4.f, 8.f};

  for (int iter = 0; iter < P.iterations; ++iter) {
    // ---- residuals and forces ------------------------------------------
    for (int i = tid; i < n; i += nt) {
      const float jf = x[i] - f_aref[i];
      float q;
      jf0[i] = jf;
      ff[i] = f_friction(jf, fD[i], floss[i], f_act[i], &q);
      diag[i] = fD[i] * q;
    }
    for (int j = tid; j < nl; j += nt) {
      const float jl = l_sign[j] * x[P.ldof[j]] - l_aref[j];
      float q;
      jl0[j] = jl;
      fl[j] = f_oneside(jl, lD[j], l_act[j], &q);
      jd_l[j] = lD[j] * q;  // Hessian diagonal term, scattered below
    }
    for (int r = tid; r < ncr; r += nt) {
      float jc = -c_aref[r];
      for (int k = 0; k < n; ++k) jc += cJ[r * n + k] * x[k];
      float q;
      jc0[r] = jc;
      fc[r] = f_oneside(jc, cD[r], c_act[r], &q);
      jd_c[r] = cD[r] * q;  // Dq_c until the linesearch reuses it
    }
    __syncthreads();
    // ---- gradient ------------------------------------------------------
    float g2[1] = {0.f};
    for (int i = tid; i < n; i += nt) {
      float mi = 0.f, jt = ff[i];
      for (int k = 0; k < n; ++k) mi += M[i * n + k] * (x[k] - a0[k]);
      for (int r = 0; r < ncr; ++r) jt += cJ[r * n + i] * fc[r];
      const int j = linv[i];
      if (j >= 0) {
        jt += l_sign[j] * fl[j];
        diag[i] += jd_l[j];
      }
      grad[i] = mi - jt;
      g2[0] += grad[i] * grad[i];
    }
    block_sum<1>(g2, red);  // also publishes grad and diag
    // ---- Hessian, lower triangle ---------------------------------------
    for (int e = tid; e < n * n; e += nt) {
      const int i = e / n, j = e - (e / n) * n;
      if (j > i) continue;
      float h = M[i * n + j];
      for (int r = 0; r < ncr; ++r)
        h += cJ[r * n + i] * jd_c[r] * cJ[r * n + j];
      if (i == j) h += diag[i];
      H[i * n + j] = h;
    }
    __syncthreads();
    // ---- Cholesky (+ ridge), column by column ---------------------------
    for (int c = 0; c < n; ++c) {
      for (int i = c + tid; i < n; i += nt) {
        float col = H[i * n + c];
        for (int k = 0; k < c; ++k) col -= L[i * n + k] * L[c * n + k];
        dx[i] = col;  // staging
      }
      __syncthreads();
      const float dd = sqrtf(fmaxf(dx[c] + 1e-12f, 1e-12f));
      for (int i = c + tid; i < n; i += nt) L[i * n + c] = dx[i] / dd;
      __syncthreads();
    }
    // ---- solve H dx = -grad (one thread: a chain of n dependent steps) --
    if (tid == 0) {
      for (int i = 0; i < n; ++i) {
        float acc = -grad[i];
        for (int k = 0; k < i; ++k) acc -= L[i * n + k] * dx[k];
        dx[i] = acc / L[i * n + i];
      }
      for (int i = n - 1; i >= 0; --i) {
        float acc = dx[i];
        for (int k = i + 1; k < n; ++k) acc -= L[k * n + i] * dx[k];
        dx[i] = acc / L[i * n + i];
      }
    }
    __syncthreads();
    // ---- linesearch directions -------------------------------------------
    float dm[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += nt) {
      float mi = 0.f;
      for (int k = 0; k < n; ++k) mi += M[i * n + k] * dx[k];
      Md[i] = mi;
      dm[0] += dx[i] * mi;
      dm[1] += (x[i] - a0[i]) * mi;
    }
    for (int j = tid; j < nl; j += nt) jd_l[j] = l_sign[j] * dx[P.ldof[j]];
    for (int r = tid; r < ncr; r += nt) {
      float s = 0.f;
      for (int k = 0; k < n; ++k) s += cJ[r * n + k] * dx[k];
      jd_c[r] = s;
    }
    block_sum<2>(dm, red);
    const float dMd = dm[0], xMd = dm[1];

    // phi'(alpha) and phi''(alpha) partial sums of this thread's rows
    auto phi_part = [&](float alpha, float* g, float* h) {
      float gs = 0.f, hs = 0.f, q;
      for (int i = tid; i < n; i += nt) {
        const float f = f_friction(jf0[i] + alpha * dx[i], fD[i], floss[i],
                                   f_act[i], &q);
        gs -= f * dx[i];
        hs += fD[i] * q * dx[i] * dx[i];
      }
      for (int j = tid; j < nl; j += nt) {
        const float f = f_oneside(jl0[j] + alpha * jd_l[j], lD[j], l_act[j],
                                  &q);
        gs -= f * jd_l[j];
        hs += lD[j] * q * jd_l[j] * jd_l[j];
      }
      for (int r = tid; r < ncr; r += nt) {
        const float f = f_oneside(jc0[r] + alpha * jd_c[r], cD[r], c_act[r],
                                  &q);
        gs -= f * jd_c[r];
        hs += cD[r] * q * jd_c[r] * jd_c[r];
      }
      *g = gs;
      *h = hs;
    };

    float gh[2];
    phi_part(0.f, &gh[0], &gh[1]);
    block_sum<2>(gh, red);
    const float g0 = xMd + gh[0], h0 = dMd + gh[1];
    const float a1 = fmaxf(-g0 / fmaxf(h0, kEps), 0.f);
    // phi' at a1 * scales[1..9], one pass
    float gs[9];
    for (int s = 0; s < 9; ++s) {
      float hh;
      phi_part(a1 * scales[s + 1], &gs[s], &hh);
    }
    block_sum<9>(gs, red);
    for (int s = 0; s < 9; ++s) gs[s] += a1 * scales[s + 1] * dMd + xMd;
    // bracket: largest grid point with phi' <= 0, smallest with phi' > 0
    float lo = 0.f, g_lo = g0;
    float hi = a1 * scales[9], g_hi = gs[8];
    bool found_hi = g_hi > 0.f;
    for (int s = 1; s < 9; ++s) {
      const float a_s = a1 * scales[s], g_s = gs[s - 1];
      const bool neg = g_s <= 0.f;
      if (neg && a_s > lo) { lo = a_s; g_lo = g_s; }
      if (!neg && (a_s < hi || !found_hi)) { hi = a_s; g_hi = g_s; }
      found_hi = found_hi || !neg;
    }
    const float denom = g_hi - g_lo;
    float alpha = (fabsf(denom) > kEps) ? lo - g_lo * (hi - lo) / denom : lo;
    if (!found_hi) alpha = a1 * scales[9];
    // safeguarded polish: keep [lo, hi] with phi'(lo) <= 0 < phi'(hi) and
    // bisect when the 1D Newton step leaves it
    for (int p = 0; p < P.ls_polish; ++p) {
      float v[2];
      phi_part(alpha, &v[0], &v[1]);
      block_sum<2>(v, red);
      const float g_p = alpha * dMd + xMd + v[0], h_p = dMd + v[1];
      const bool neg = g_p <= 0.f;
      if (neg) {
        lo = fmaxf(alpha, lo);
      } else {
        hi = found_hi ? fminf(alpha, hi) : alpha;
      }
      found_hi = found_hi || !neg;
      const float a_n = alpha - g_p / fmaxf(h_p, kEps);
      const bool inside = (a_n >= lo) && (a_n <= hi);
      alpha = (found_hi && !inside) ? 0.5f * (lo + hi) : fmaxf(a_n, lo);
    }
    alpha = fmaxf(alpha, 0.f);
    if (!(g2[0] > P.th2)) alpha = 0.f;  // converged lanes freeze
    for (int i = tid; i < n; i += nt) x[i] += alpha * dx[i];
    __syncthreads();
  }

  // ---- final forces -----------------------------------------------------
  float q;
  for (int i = tid; i < n; i += nt) {
    P.x_out[b * n + i] = x[i];
    P.ff_out[b * n + i] =
        f_friction(x[i] - f_aref[i], fD[i], floss[i], f_act[i], &q);
  }
  for (int j = tid; j < nl; j += nt)
    P.fl_out[b * nl + j] = f_oneside(l_sign[j] * x[P.ldof[j]] - l_aref[j],
                                     lD[j], l_act[j], &q);
  for (int r = tid; r < ncr; r += nt) {
    float jc = -c_aref[r];
    for (int k = 0; k < n; ++k) jc += cJ[r * n + k] * x[k];
    P.fc_out[b * ncr + r] = f_oneside(jc, cD[r], c_act[r], &q);
  }
}

}  // namespace

extern "C" size_t newton_smem_bytes(int n, int ncr, int nl) {
  return sizeof(float) *
             (3 * static_cast<size_t>(n) * n + static_cast<size_t>(ncr) * n +
              12 * static_cast<size_t>(n) + 7 * static_cast<size_t>(nl) +
              6 * static_cast<size_t>(ncr) + 32 * kRed) +
         sizeof(int) * static_cast<size_t>(n);
}

// ptrs: M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD, l_act,
//       f_aref, fD, floss, f_act, ldof, x, ff, fl, fc (device pointers)
extern "C" int newton_launch(void* const* ptrs, int B, int n, int ncr,
                             int nl, int iterations, int ls_polish,
                             float grad_th, void* stream) {
  if (B <= 0) return 0;
  Problem P;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  P.M = f[0]; P.a0 = f[1]; P.ws = f[2]; P.cJ = f[3]; P.c_aref = f[4];
  P.cD = f[5]; P.c_act = f[6]; P.l_sign = f[7]; P.l_aref = f[8];
  P.lD = f[9]; P.l_act = f[10]; P.f_aref = f[11]; P.fD = f[12];
  P.floss = f[13]; P.f_act = f[14];
  P.ldof = static_cast<const int*>(ptrs[15]);
  P.x_out = static_cast<float*>(ptrs[16]);
  P.ff_out = static_cast<float*>(ptrs[17]);
  P.fl_out = static_cast<float*>(ptrs[18]);
  P.fc_out = static_cast<float*>(ptrs[19]);
  P.n = n; P.ncr = ncr; P.nl = nl;
  P.iterations = iterations; P.ls_polish = ls_polish;
  P.th2 = grad_th * grad_th;
  const size_t smem = newton_smem_bytes(n, ncr, nl);
  cudaError_t e = cudaFuncSetAttribute(
      newton_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  newton_kernel<<<B, 128, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* newton_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
