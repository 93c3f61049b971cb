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
// safeguarded bracket-bisect steps. An env whose |grad|^2 <= grad_th^2 is
// frozen: its x can no longer change, so the block leaves the loop (the
// result does not depend on the iteration cap). Outputs qacc, ff (n),
// fl (nl), fc (ncr).
//
// Bound: operations. Per iteration the Hessian build costs na*n*(n+1)/2
// multiply-adds over the na contact rows with a non-zero weight, the
// factor n^3/6, while the inputs are read once (25 KB per env at the G1's
// n=35, ncr=144, overlapped by the other blocks of the SM; M's env stride
// of 4*n*n bytes is not a multiple of 16, so bulk asynchronous copies do
// not apply and would not help). On an H100 the kernel sits far above that
// bound because an env's iteration is a sequence of short phases, each a
// chain of dependent shared-memory reads and FMAs with a barrier at its
// end: a block alone on its SM is only 1.6x faster than one of six
// (tools/k2_phase_clocks.py), so latency, not throughput, sets the pace.
// The design shortens the chains and cuts barriers and shared-memory reads:
//  - Inactive contact rows (c_act == 0) contribute nothing anywhere, so
//    only the active rows of cJ are loaded, packed in order of r, with the
//    row stride padded to a multiple of 4 floats for 16-byte reads.
//  - The Hessian is a register-tiled SYRK: each thread owns a 2x4 tile of
//    the lower triangle and walks the packed list of rows whose weight
//    D*q is non-zero (ballot + prefix in order of r, rebuilt every
//    iteration), so one 8-byte and one 16-byte read feed 8 FMAs.
//  - Cholesky and both triangular solves run in one warp, four columns at
//    a time, on registers (chol_warp.cuh, shared with K1), with -grad
//    carried as an extra row; H is factored in place and M and H are
//    packed triangles. Two barriers frame it, none inside.
//  - The matrix-vector products (M v, cJ^T f) split their long dimension
//    over the four warps and reduce through shared memory; cJ x is one
//    thread per active row on 16-byte reads.
//  - The linesearch evaluates phi' at all nine grid points in one pass and
//    one block reduction of one barrier; the bracket logic runs
//    redundantly in every thread on the reduced values.
// The activity masks are read as the bytes of torch.bool tensors. The
// model-class fit rule is newton_smem_bytes() <= 227 KB (ops/newton.py);
// Layout below is the one owner of the shared-memory layout.

#include <cuda_runtime.h>

#include <cstdint>

#include "chol_warp.cuh"

namespace {

// entry (i, j), j <= i, of M's packed lower triangle is at tri(i) + j
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

constexpr float kEps = 1e-15f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 9;  // max values reduced at once
constexpr unsigned kFull = 0xffffffffu;

// Built with -DK2_PHASE_CLOCKS (tools/k2_phase_clocks.py), thread 0 of
// every block adds the cycles it spent in each phase of the kernel to a
// global table; otherwise PHASE() is nothing.
#ifdef K2_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long k2_phase_cycles[kPhases];
#define PHASE(k)                                                   \
  if (tid == 0) {                                                  \
    const long long now = clock64();                               \
    atomicAdd(&k2_phase_cycles[k],                                 \
              static_cast<unsigned long long>(now - phase_start)); \
    phase_start = now;                                             \
  }
#else
#define PHASE(k)
#endif

// Offsets, in floats, of one env's arrays in dynamic shared memory. The
// arrays read 16 or 8 bytes at a time come first, so they keep that
// alignment from the base.
struct Layout {
  int ld;  // row stride of cJ, x and dx: n rounded up to 4
  size_t cJ, x, dx, part, wl, Mp, Hp, a0, grad, jf0, ff, diag, fD, floss,
      f_aref, f_act, l_sign, l_aref, lD, l_act, jl0, jd_l, fl, c_aref, cD,
      jc0, jd_c, fc, red, alist, linv, ldof, counts, total;

  __host__ __device__ Layout(int n, int ncr, int nl) {
    ld = (n + 3) & ~3;
    const size_t N = n, C = ncr, Ln = nl, LD = ld;
    size_t o = 0;
    auto take = [&o](size_t k) { const size_t at = o; o += k; return at; };
    cJ = take(C * LD);
    x = take(LD);
    dx = take(LD);
    part = take(kWarps * LD);
    Hp = take(chol_warp::packed_floats(n));  // chol_warp.cuh's triangle
    wl = take(2 * C);  // (row offset, weight) pairs
    Mp = take(N * (N + 1) / 2);  // packed lower triangle, tri(i) + j
    a0 = take(N); grad = take(N); jf0 = take(N); ff = take(N);
    diag = take(N); fD = take(N); floss = take(N); f_aref = take(N);
    f_act = take(N);
    l_sign = take(Ln); l_aref = take(Ln); lD = take(Ln); l_act = take(Ln);
    jl0 = take(Ln); jd_l = take(Ln); fl = take(Ln);
    c_aref = take(C); cD = take(C); jc0 = take(C); jd_c = take(C);
    fc = take(C);
    red = take(2 * kWarps * kRed);
    alist = take(C);  // ints: the active rows, in order
    linv = take(N);   // ints: limit row of a dof, or -1
    ldof = take(Ln);  // ints
    counts = take(2);  // ints: active rows, weighted rows
    total = o;
  }
};

// Sum K values over the block; every thread gets the same totals. `red`
// holds two buffers of kWarps * kRed floats, used in turn (`flip`), so one
// barrier is enough: a buffer is written again only two calls later, after
// a barrier every thread reached with its reads of it done. All threads
// must call it (it synchronizes), in the same order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          int& flip) {
  static_assert(K <= kRed, "red is too small");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = red + flip * kWarps * kRed;
  flip ^= 1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) buf[warp * kRed + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += buf[w * kRed + k];
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

// row . v over ld floats, both 16-byte aligned and zero-padded past n; four
// partial sums keep the chain of dependent FMAs short
__device__ __forceinline__ float dot_row(const float* row, const float* v,
                                         int ld) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 3
  for (int k = 0; k < ld; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + k);
    const float4 b = *reinterpret_cast<const float4*>(v + k);
    s.x += a.x * b.x;
    s.y += a.y * b.y;
    s.z += a.z * b.z;
    s.w += a.w * b.w;
  }
  return (s.x + s.y) + (s.z + s.w);
}

// This warp's share of (M v)[i] for the symmetric M held as a packed lower
// triangle: the columns j = warp, warp + kWarps, ... ; v(j) gives v_j.
template <class V>
__device__ __forceinline__ float sym_matvec_share(const float* Mp, int n,
                                                  int i, int warp, V v) {
  const int ti = tri(i);
  float acc = 0.f;
#pragma unroll 4
  for (int j = warp; j < n; j += kWarps)
    acc += ((j <= i) ? Mp[ti + j] : Mp[tri(j) + i]) * v(j);
  return acc;
}

// Packs, in order, the indices t < count whose keep(t) holds: item(pos, t)
// stores one. Called by one whole warp; returns the number kept.
template <class Keep, class Item>
__device__ __forceinline__ int warp_compact(int count, Keep keep, Item item) {
  const int lane = threadIdx.x & 31;
  int kept = 0;
  for (int base = 0; base < count; base += 32) {
    const int t = base + lane;
    const bool on = (t < count) && keep(t);
    const unsigned m = __ballot_sync(kFull, on);
    if (on) item(kept + __popc(m & ((1u << lane) - 1u)), t);
    kept += __popc(m);
  }
  return kept;
}

// Tile `t` of the lower triangle cut into 2-row by 4-column tiles: row
// block q holds (2q + 1) / 4 + 1 tiles.
__device__ __forceinline__ void tile_coords(int t, int* rb, int* cb) {
  int q = 0;
  for (;;) {
    const int cnt = (2 * q + 1) / 4 + 1;
    if (t < cnt) break;
    t -= cnt;
    ++q;
  }
  *rb = q;
  *cb = t;
}

struct Problem {
  const float *M, *a0, *ws, *cJ, *c_aref, *cD, *l_sign, *l_aref, *lD,
      *f_aref, *fD, *floss;
  const unsigned char *c_act, *l_act, *f_act;
  const int* ldof;
  float *x_out, *ff_out, *fl_out, *fc_out;
  int n, ncr, nl, iterations, ls_polish;
  float th2;
};

// ROWS: rows of the Hessian's triangle one lane of the factorization owns.
// The kernel is bound by the latency of its serial chains, so its speed
// follows the blocks an SM holds: the two-row variant (n < 64) is kept to
// the registers that let kMinBlocks blocks share an SM.
constexpr int kMinBlocks = 6;
template <int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS <= 2 ? kMinBlocks : 1)
    newton_kernel(Problem P) {
  extern __shared__ __align__(16) float smem[];
  const int n = P.n, ncr = P.ncr, nl = P.nl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const Layout lay(n, ncr, nl);
  const int ld = lay.ld;
#ifdef K2_PHASE_CLOCKS
  long long phase_start = clock64();
#endif

  float* cJ = smem + lay.cJ;
  float* x = smem + lay.x;
  float* dx = smem + lay.dx;
  float* part = smem + lay.part;
  int2* wl = reinterpret_cast<int2*>(smem + lay.wl);
  float* Mp = smem + lay.Mp;
  float* Hp = smem + lay.Hp;
  float* a0 = smem + lay.a0;
  float* grad = smem + lay.grad;
  float* jf0 = smem + lay.jf0;
  float* ff = smem + lay.ff;
  float* diag = smem + lay.diag;
  float* fD = smem + lay.fD;
  float* floss = smem + lay.floss;
  float* f_aref = smem + lay.f_aref;
  float* f_act = smem + lay.f_act;
  float* l_sign = smem + lay.l_sign;
  float* l_aref = smem + lay.l_aref;
  float* lD = smem + lay.lD;
  float* l_act = smem + lay.l_act;
  float* jl0 = smem + lay.jl0;
  float* jd_l = smem + lay.jd_l;
  float* fl = smem + lay.fl;
  float* c_aref = smem + lay.c_aref;
  float* cD = smem + lay.cD;
  float* jc0 = smem + lay.jc0;
  float* jd_c = smem + lay.jd_c;
  float* fc = smem + lay.fc;
  float* red = smem + lay.red;
  int flip = 0;  // which half of red the next block_sum uses
  int* alist = reinterpret_cast<int*>(smem + lay.alist);
  int* linv = reinterpret_cast<int*>(smem + lay.linv);
  int* ldof = reinterpret_cast<int*>(smem + lay.ldof);
  int* counts = reinterpret_cast<int*>(smem + lay.counts);

  // ---- load this env's problem ----------------------------------------
  const unsigned char* g_act = P.c_act + b * ncr;
  if (warp == 0) {  // the active contact rows, in order of r
    const int kept = warp_compact(
        ncr, [&](int r) { return g_act[r] != 0; },
        [&](int pos, int r) { alist[pos] = r; });
    if (lane == 0) counts[0] = kept;
  }
  {  // M, lower triangle packed; (i, j) walks the row-major matrix
    const float* gM = P.M + b * n * n;
    int i = tid / n, j = tid - i * n;
    for (int e = tid; e < n * n; e += kThreads) {
      if (j <= i) Mp[tri(i) + j] = gM[e];
      j += kThreads;
      while (j >= n) { j -= n; ++i; }
    }
  }
  for (int i = tid; i < ld; i += kThreads) {
    const bool in = i < n;
    x[i] = in ? P.a0[b * n + i] : 0.f;   // x starts as a0, dx as ws
    dx[i] = in ? P.ws[b * n + i] : 0.f;
    if (in) {
      a0[i] = x[i];
      fD[i] = P.fD[b * n + i];
      floss[i] = P.floss[b * n + i];
      f_aref[i] = P.f_aref[b * n + i];
      f_act[i] = P.f_act[b * n + i] ? 1.f : 0.f;
      linv[i] = -1;
    }
  }
  // the triangle's zero rows past the right-hand side (chol_warp.cuh)
  for (int e = chol_warp::row_off(n + 1) + tid;
       e < static_cast<int>(chol_warp::packed_floats(n)); e += kThreads)
    Hp[e] = 0.f;
  for (int j = tid; j < nl; j += kThreads) {
    l_sign[j] = P.l_sign[b * nl + j];
    l_aref[j] = P.l_aref[b * nl + j];
    lD[j] = P.lD[b * nl + j];
    l_act[j] = P.l_act[b * nl + j] ? 1.f : 0.f;
    ldof[j] = P.ldof[j];
  }
  __syncthreads();
  const int nact = counts[0];
  for (int j = tid; j < nl; j += kThreads) linv[ldof[j]] = j;
  {  // one warp per active row of cJ
    const float* gJ = P.cJ + b * ncr * n;
    for (int t = warp; t < nact; t += kWarps) {
      const float* g = gJ + static_cast<size_t>(alist[t]) * n;
      for (int k = lane; k < ld; k += 32)
        cJ[t * ld + k] = (k < n) ? g[k] : 0.f;
    }
  }
  for (int t = tid; t < nact; t += kThreads) {
    c_aref[t] = P.c_aref[b * ncr + alist[t]];
    cD[t] = P.cD[b * ncr + alist[t]];
  }
  __syncthreads();

  // ---- warm start: ws or a0, whichever costs less (one pass) ------------
  for (int i = lane; i < n; i += 32)
    part[warp * ld + i] = sym_matvec_share(
        Mp, n, i, warp, [&](int j) { return dx[j] - a0[j]; });
  __syncthreads();
  {
    float v[2] = {0.f, 0.f};
    for (int i = tid; i < n; i += kThreads) {
      float mi = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mi += part[w * ld + i];
      v[0] += 0.5f * (dx[i] - a0[i]) * mi
              + c_friction(dx[i] - f_aref[i], fD[i], floss[i], f_act[i]);
      v[1] += c_friction(a0[i] - f_aref[i], fD[i], floss[i], f_act[i]);
    }
    for (int j = tid; j < nl; j += kThreads) {
      const int d = ldof[j];
      v[0] += c_oneside(l_sign[j] * dx[d] - l_aref[j], lD[j], l_act[j]);
      v[1] += c_oneside(l_sign[j] * a0[d] - l_aref[j], lD[j], l_act[j]);
    }
    for (int t = tid; t < nact; t += kThreads) {
      const float* row = cJ + t * ld;
      v[0] += c_oneside(dot_row(row, dx, ld) - c_aref[t], cD[t], 1.f);
      v[1] += c_oneside(dot_row(row, x, ld) - c_aref[t], cD[t], 1.f);
    }
    block_sum<2>(v, red, flip);
    if (v[0] < v[1])
      for (int i = tid; i < n; i += kThreads) x[i] = dx[i];
    __syncthreads();
  }
  PHASE(0)  // load and warm start

  const float scales[10] = {0.f, 0.125f, 0.25f, 0.5f, 0.75f,
                            1.f, 1.5f, 2.f, 4.f, 8.f};
  int ntile = 0;  // 2x4 tiles of the lower triangle
  for (int q = 0; q < (n + 1) / 2; ++q) ntile += (2 * q + 1) / 4 + 1;

  for (int iter = 0; iter < P.iterations; ++iter) {
    // ---- residuals and forces ------------------------------------------
    for (int i = tid; i < n; i += kThreads) {
      const float jf = x[i] - f_aref[i];
      float q;
      jf0[i] = jf;
      ff[i] = f_friction(jf, fD[i], floss[i], f_act[i], &q);
      diag[i] = fD[i] * q;
    }
    for (int j = tid; j < nl; j += kThreads) {
      const float jl = l_sign[j] * x[ldof[j]] - l_aref[j];
      float q;
      jl0[j] = jl;
      fl[j] = f_oneside(jl, lD[j], l_act[j], &q);
      jd_l[j] = lD[j] * q;  // Hessian diagonal term, scattered below
    }
    for (int t = tid; t < nact; t += kThreads) {
      const float jc = dot_row(cJ + t * ld, x, ld) - c_aref[t];
      float q;
      jc0[t] = jc;
      fc[t] = f_oneside(jc, cD[t], 1.f, &q);
      jd_c[t] = cD[t] * q;  // the row's Hessian weight, until the linesearch
    }
    __syncthreads();
    PHASE(1)  // residuals and forces
    // ---- gradient shares; warp 0 also lists the weighted rows -----------
    if (warp == 0) {
      const int kept = warp_compact(
          nact, [&](int t) { return jd_c[t] != 0.f; },
          [&](int pos, int t) {
            wl[pos] = make_int2(t * ld, __float_as_int(jd_c[t]));
          });
      if (lane == 0) counts[1] = kept;
    }
    for (int i = lane; i < n; i += 32) {
      float acc = sym_matvec_share(Mp, n, i, warp,
                                   [&](int j) { return x[j] - a0[j]; });
#pragma unroll 4
      for (int t = warp; t < nact; t += kWarps) acc -= cJ[t * ld + i] * fc[t];
      part[warp * ld + i] = acc;
    }
    __syncthreads();
    PHASE(2)  // gradient shares, weighted-row list
    float g2[1] = {0.f};
    for (int i = tid; i < n; i += kThreads) {
      float gi = -ff[i];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) gi += part[w * ld + i];
      const int j = linv[i];
      if (j >= 0) {
        gi -= l_sign[j] * fl[j];
        diag[i] += jd_l[j];
      }
      grad[i] = gi;
      g2[0] += gi * gi;
    }
    block_sum<1>(g2, red, flip);  // also publishes grad and diag
    PHASE(3)  // gradient and its norm
    if (!(g2[0] > P.th2)) break;  // frozen: block-uniform, x is final
    // ---- Hessian, lower triangle, 2x4 register tiles --------------------
    const int nw = counts[1];
    for (int tile = tid; tile < ntile; tile += kThreads) {
      int rb, cb;
      tile_coords(tile, &rb, &cb);
      const float* pa = cJ + 2 * rb;
      const float* pb = cJ + 4 * cb;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int k = 0; k < nw; ++k) {
        const int2 e = wl[k];
        const float w = __int_as_float(e.y);
        const float2 a = *reinterpret_cast<const float2*>(pa + e.x);
        const float4 c = *reinterpret_cast<const float4*>(pb + e.x);
        const float a0w = a.x * w, a1w = a.y * w;
        acc[0] += a0w * c.x; acc[1] += a0w * c.y;
        acc[2] += a0w * c.z; acc[3] += a0w * c.w;
        acc[4] += a1w * c.x; acc[5] += a1w * c.y;
        acc[6] += a1w * c.z; acc[7] += a1w * c.w;
      }
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const int i = 2 * rb + di;
        if (i >= n) continue;
#pragma unroll
        for (int dj = 0; dj < 4; ++dj) {
          const int j = 4 * cb + dj;
          if (j >= chol_warp::row_len(i)) continue;
          float h = 0.f;  // the pad slots past the diagonal hold zeros
          if (j <= i) h = Mp[tri(i) + j] + acc[4 * di + dj];
          if (i == j) h += diag[i];
          Hp[chol_warp::row_off(i) + j] = h;
        }
      }
    }
    for (int i = tid; i < chol_warp::row_len(n); i += kThreads)
      Hp[chol_warp::row_off(n) + i] = (i < n) ? -grad[i] : 0.f;
    __syncthreads();
    PHASE(4)  // Hessian
    // ---- factor and solve H dx = -grad in one warp -----------------------
    if (warp == 0)
      chol_warp::factor_solve<ROWS>(Hp, n, dx, chol_warp::PivotRidge());
    __syncthreads();
    PHASE(5)  // factor and solve
    // ---- linesearch directions -------------------------------------------
    for (int j = tid; j < nl; j += kThreads) jd_l[j] = l_sign[j] * dx[ldof[j]];
    for (int t = tid; t < nact; t += kThreads)
      jd_c[t] = dot_row(cJ + t * ld, dx, ld);
    for (int i = lane; i < n; i += 32)
      part[warp * ld + i] = sym_matvec_share(Mp, n, i, warp,
                                             [&](int j) { return dx[j]; });
    __syncthreads();
    PHASE(6)  // linesearch directions

    // phi'(alpha) and phi''(alpha) partial sums of this thread's rows
    auto phi_part = [&](float alpha, float* g, float* h) {
      float gs = 0.f, hs = 0.f, q;
      for (int i = tid; i < n; i += kThreads) {
        const float f = f_friction(jf0[i] + alpha * dx[i], fD[i], floss[i],
                                   f_act[i], &q);
        gs -= f * dx[i];
        hs += fD[i] * q * dx[i] * dx[i];
      }
      for (int j = tid; j < nl; j += kThreads) {
        const float f = f_oneside(jl0[j] + alpha * jd_l[j], lD[j], l_act[j],
                                  &q);
        gs -= f * jd_l[j];
        hs += lD[j] * q * jd_l[j] * jd_l[j];
      }
      for (int t = tid; t < nact; t += kThreads) {
        const float f = f_oneside(jc0[t] + alpha * jd_c[t], cD[t], 1.f, &q);
        gs -= f * jd_c[t];
        hs += cD[t] * q * jd_c[t] * jd_c[t];
      }
      *g = gs;
      *h = hs;
    };

    float s4[4] = {0.f, 0.f, 0.f, 0.f};  // dx.M dx, (x-a0).M dx, phi'(0) parts
    for (int i = tid; i < n; i += kThreads) {
      float mi = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mi += part[w * ld + i];
      s4[0] += dx[i] * mi;
      s4[1] += (x[i] - a0[i]) * mi;
    }
    phi_part(0.f, &s4[2], &s4[3]);
    block_sum<4>(s4, red, flip);
    const float dMd = s4[0], xMd = s4[1];
    const float g0 = xMd + s4[2], h0 = dMd + s4[3];
    const float a1 = fmaxf(-g0 / fmaxf(h0, kEps), 0.f);
    // phi' at a1 * scales[1..9]: each row read once, one reduction
    float gs[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    {
      float q;
      for (int i = tid; i < n; i += kThreads) {
        const float j0 = jf0[i], jd = dx[i], D = fD[i], fl_ = floss[i],
                    act = f_act[i];
#pragma unroll
        for (int s = 0; s < 9; ++s)
          gs[s] -= f_friction(j0 + a1 * scales[s + 1] * jd, D, fl_, act, &q)
                   * jd;
      }
      for (int j = tid; j < nl; j += kThreads) {
        const float j0 = jl0[j], jd = jd_l[j], D = lD[j], act = l_act[j];
#pragma unroll
        for (int s = 0; s < 9; ++s)
          gs[s] -= f_oneside(j0 + a1 * scales[s + 1] * jd, D, act, &q) * jd;
      }
      for (int t = tid; t < nact; t += kThreads) {
        const float j0 = jc0[t], jd = jd_c[t], D = cD[t];
#pragma unroll
        for (int s = 0; s < 9; ++s)
          gs[s] -= f_oneside(j0 + a1 * scales[s + 1] * jd, D, 1.f, &q) * jd;
      }
    }
    block_sum<9>(gs, red, flip);
#pragma unroll
    for (int s = 0; s < 9; ++s) gs[s] += a1 * scales[s + 1] * dMd + xMd;
    // bracket: largest grid point with phi' <= 0, smallest with phi' > 0
    float lo = 0.f, g_lo = g0;
    float hi = a1 * scales[9], g_hi = gs[8];
    bool found_hi = g_hi > 0.f;
#pragma unroll
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
      block_sum<2>(v, red, flip);
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
    PHASE(7)  // linesearch
    for (int i = tid; i < n; i += kThreads) x[i] += alpha * dx[i];
    __syncthreads();
    PHASE(8)  // update
  }

  // ---- final forces -----------------------------------------------------
  float q;
  for (int i = tid; i < n; i += kThreads) {
    P.x_out[b * n + i] = x[i];
    P.ff_out[b * n + i] =
        f_friction(x[i] - f_aref[i], fD[i], floss[i], f_act[i], &q);
  }
  for (int j = tid; j < nl; j += kThreads)
    P.fl_out[b * nl + j] = f_oneside(l_sign[j] * x[ldof[j]] - l_aref[j],
                                     lD[j], l_act[j], &q);
  for (int r = tid; r < ncr; r += kThreads)
    if (!g_act[r]) P.fc_out[b * ncr + r] = 0.f;
  for (int t = tid; t < nact; t += kThreads)
    P.fc_out[b * ncr + alist[t]] = f_oneside(
        dot_row(cJ + t * ld, x, ld) - c_aref[t], cD[t], 1.f, &q);
  PHASE(9)  // final forces
}

}  // namespace

#ifdef K2_PHASE_CLOCKS
// Copies the phase table to `out` (kPhases values) and clears it.
extern "C" int newton_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k2_phase_cycles,
                                       sizeof(k2_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(k2_phase_cycles, zero, sizeof(zero)));
}
#endif

// Shared memory one block needs; SIZE_MAX where n is beyond what one lane
// of the factorization can own, so that such a model never fits.
extern "C" size_t newton_smem_bytes(int n, int ncr, int nl) {
  if (n > chol_warp::kMaxN) return SIZE_MAX;
  return sizeof(float) * Layout(n, ncr, nl).total;
}

// ptrs: M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD, l_act,
//       f_aref, fD, floss, f_act, ldof, x, ff, fl, fc (device pointers);
// c_act, l_act and f_act are bytes (torch.bool), the rest float32 but ldof.
extern "C" int newton_launch(void* const* ptrs, int B, int n, int ncr,
                             int nl, int iterations, int ls_polish,
                             float grad_th, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || n > chol_warp::kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem P;
  const float* const* f = reinterpret_cast<const float* const*>(ptrs);
  auto bytes = [&](int k) {
    return static_cast<const unsigned char*>(ptrs[k]);
  };
  P.M = f[0]; P.a0 = f[1]; P.ws = f[2]; P.cJ = f[3]; P.c_aref = f[4];
  P.cD = f[5]; P.c_act = bytes(6); P.l_sign = f[7]; P.l_aref = f[8];
  P.lD = f[9]; P.l_act = bytes(10); P.f_aref = f[11]; P.fD = f[12];
  P.floss = f[13]; P.f_act = bytes(14);
  P.ldof = static_cast<const int*>(ptrs[15]);
  P.x_out = static_cast<float*>(ptrs[16]);
  P.ff_out = static_cast<float*>(ptrs[17]);
  P.fl_out = static_cast<float*>(ptrs[18]);
  P.fc_out = static_cast<float*>(ptrs[19]);
  P.n = n; P.ncr = ncr; P.nl = nl;
  P.iterations = iterations; P.ls_polish = ls_polish;
  P.th2 = grad_th * grad_th;
  const size_t smem = newton_smem_bytes(n, ncr, nl);
  auto kernel = (n + 1 <= 64) ? newton_kernel<2>
                              : newton_kernel<chol_warp::kMaxRows>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* newton_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
