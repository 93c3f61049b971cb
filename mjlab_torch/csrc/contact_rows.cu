// K4: the contact rows of the compacted pyramidal pools, one env per block.
//
// Replaces no TPU kernel: the JAX package builds these rows in plain jnp
// (mjlab_tpu/physics/constraint.py), and so does the plain version,
// physics/constraint.py:contacts_compacted_plain. It was added because
// that torch code is the largest device cost of the constraint stage on an
// H100: per pool and call it materializes several (B, K, nv, 3) tensors
// (the relative positions, the cross product, the translational and
// rotational Jacobians, both rotated into the contact frame) and rotates
// them with a batched gemm of inner dimension 3, then concatenates the
// pools.
//
// For each env, the selected slots of the frictional pool (K3, 2*A rows a
// slot: Jn + mu_a T_a, Jn - mu_a T_a for a < A, the axes t1, t2, then the
// rotational ones) and of the frictionless pool (K1, one normal row a slot)
// become the dense c block: c_J (ncr, nv), c_D (zero where inactive),
// c_aref, c_active (bytes of torch.bool) and c_pos. A slot's column of dof
// v, with d = the signed ancestor delta of the pair's bodies at v and
// croot the root com of side 2 where d > 0, else side 1, is
//   jt = (cdof_lin + cdof_ang x (pos - croot)) d,  jr = cdof_ang d,
// both rotated into the contact frame (frame rows: normal, t1, t2).
//
// Bound: bytes. Per env the kernel writes c_J (ncr*nv floats) and four row
// vectors, and reads the selected slots' contact data, cdof, subtree_com
// and qvel once (ops/work.py:contact_rows_work); its ~100 FLOPs a slot and
// dof are far below the card's rate. Design:
//  - Nothing of shape (K, nv, 3) leaves the SM. A first pass gives one
//    thread to each selected slot: it reads the slot's contact data, its
//    static pool entry (slot id, bodies, roots), computes the impedance and
//    reference coefficients and keeps the frame, both relative positions,
//    the friction and the row scalars in shared memory, beside the env's
//    cdof and qvel.
//  - Then one warp a slot, lanes over dofs: each lane forms its dof's six
//    rotated values in registers and writes the slot's rows into the env's
//    c_J block in shared memory; the six velocities J qvel are one warp
//    reduction (xor shuffles), from which lanes below the slot's row count
//    write c_D, c_aref, c_active and c_pos.
//  - Last, the block stores the c_J block, contiguous in device memory, as
//    16-byte words where its size allows: every store is coalesced and
//    every element is written once.
// Float32 throughout, no fast math; where the plain version rounds a
// product before a sum (mu T, b v), so does this kernel (__fmul_rn).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kMinImp = 0.0001f;
constexpr float kMaxImp = 0.9999f;
constexpr float kMinVal = 1e-15f;
constexpr int kThreads = 256;
constexpr int kMaxA = 5;          // friction axes of condim 6
constexpr int kTab = 5;  // a pool entry: slot, body1, body2, root1, root2
constexpr int kSlotFloats = 24;   // per slot in shared memory, as below
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* pdist;    // (B, ncon) dist - includemargin
  const int64_t* sel3;   // (B, >= K3) positions in the frictional pool
  const int64_t* sel1;   // (B, >= K1) positions in the frictionless pool
  const float* pos;      // (B, ncon, 3)
  const float* frame;    // (B, ncon, 3, 3)
  const float* friction; // (B, ncon, 5)
  const float* solref;   // (B, ncon, 2)
  const float* solimp;   // (B, ncon, 5)
  const float* cdof;     // (B, nv, 6)
  const float* com;      // (B, nbody, 3) subtree_com
  const float* qvel;     // (B, nv)
  const float* invw0;    // (nbody, 2) body_invweight0, shared
  const float* timestep; // scalar
  const float* impratio; // scalar
  const int* tab;        // (np3 + np1, kTab) pool entries, frictional first
  const int* dim;        // (np3 + np1) condim of each pool entry
  const int8_t* ancd;    // (np3 + np1, nv) signed ancestor delta
  float* cJ;             // (B, ncr, nv)
  float* cD;             // (B, ncr)
  float* caref;
  bool* cact;
  float* cpos;
  int64_t sel3_stride, sel1_stride;
  int ncon, nbody, nv, K3, K1, np3, refsafe;
};

// Per-slot values in shared memory, kSlotFloats floats a slot:
// frame [0, 9), rel1 [9, 12), rel2 [12, 15), mu [15, 20) (zero past the
// slot's condim), p 20, D 21 (unmasked), b 22, k imp p 23.
constexpr int kFrame = 0, kRel1 = 9, kRel2 = 12, kMu = 15, kP = 20, kD = 21,
              kB = 22, kKip = 23;

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// MuJoCo's impedance sigmoid, as physics/constraint.py:_impedance
__device__ float impedance(const float* si, float pos) {
  const float dmin = clampf(si[0], kMinImp, kMaxImp);
  const float dmax = clampf(si[1], kMinImp, kMaxImp);
  const float width = fmaxf(si[2], kMinVal);
  const float mid = clampf(si[3], kMinImp, kMaxImp);
  const float power = fmaxf(si[4], 1.0f);
  const float x = clampf(fabsf(pos) / width, 0.0f, 1.0f);
  float y;
  if (power <= 1.0f) {
    y = x;
  } else if (x <= mid) {
    y = mid * powf(x / fmaxf(mid, kMinVal), power);
  } else {
    y = 1.0f - __fmul_rn(1.0f - mid,
                         powf((1.0f - x) / fmaxf(1.0f - mid, kMinVal), power));
  }
  return clampf(dmin + __fmul_rn(y, dmax - dmin), kMinImp, kMaxImp);
}

// The first pass: slot k of this env, into its shared-memory record; the
// pool position of the slot into *q.
__device__ void load_slot(const Args& a, int b, int k, float* rec, int* q,
                          int* ndim) {
  const bool fric = k < a.K3;
  const int64_t pq = fric ? a.sel3[b * a.sel3_stride + k]
                          : a.np3 + a.sel1[b * a.sel1_stride + (k - a.K3)];
  const int* t = a.tab + pq * kTab;
  const size_t c = static_cast<size_t>(b) * a.ncon + t[0];
  const float p = a.pdist[c];
  const float* ps = a.pos + 3 * c;
  const float* c1 = a.com + 3 * (static_cast<size_t>(b) * a.nbody + t[3]);
  const float* c2 = a.com + 3 * (static_cast<size_t>(b) * a.nbody + t[4]);
  for (int i = 0; i < 9; ++i) rec[kFrame + i] = a.frame[9 * c + i];
  for (int i = 0; i < 3; ++i) {
    rec[kRel1 + i] = ps[i] - c1[i];
    rec[kRel2 + i] = ps[i] - c2[i];
  }
  const int nd = a.dim[pq] - 1;  // friction axes of this slot's condim
  const float* fr = a.friction + 5 * c;
  for (int i = 0; i < kMaxA; ++i) rec[kMu + i] = i < nd ? fr[i] : 0.0f;

  // reference coefficients, as physics/constraint.py:_kbi
  const float* sr = a.solref + 2 * c;
  const float* si = a.solimp + 5 * c;
  const float imp = impedance(si, p);
  const float dmax = clampf(si[1], kMinImp, kMaxImp);
  float tc = sr[0];
  const float dr = sr[1];
  if (a.refsafe) tc = fmaxf(tc, 2.0f * a.timestep[0]);
  float bc, kc;
  if (sr[0] <= 0.0f || sr[1] <= 0.0f) {
    bc = -sr[1] / dmax;
    kc = -sr[0] / (dmax * dmax);
  } else {
    bc = 2.0f / (dmax * fmaxf(tc, kMinVal));
    kc = 1.0f / fmaxf(dmax * dmax * tc * tc * dr * dr, kMinVal);
  }
  const float invw = a.invw0[2 * t[1]] + a.invw0[2 * t[2]];
  float w = invw;
  if (fric) {  // diagApprox of a pyramid row uses the first friction
    const float mu0 = fr[0];
    w = invw * __fadd_rn(1.0f, mu0 * mu0) * 2.0f * mu0 * mu0 / a.impratio[0];
  }
  rec[kP] = p;
  rec[kD] = 1.0f / fmaxf(__fmul_rn((1.0f - imp) / imp, w), kMinVal);
  rec[kB] = bc;
  rec[kKip] = __fmul_rn(__fmul_rn(kc, imp), p);
  *q = static_cast<int>(pq);
  *ndim = nd;
}

__device__ __forceinline__ float dot3(const float* f, float x, float y,
                                      float z) {
  return fmaf(f[2], z, fmaf(f[1], y, f[0] * x));
}

template <int A>
__global__ void __launch_bounds__(kThreads)
contact_rows_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int nv = a.nv, K = a.K3 + a.K1;
  const int ncr = a.K3 * 2 * A + a.K1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* sJ = smem;                              // (ncr, nv)
  float* sdof = sJ + ncr * nv;                   // (nv, 6)
  float* sqv = sdof + 6 * nv;                    // (nv)
  float* srec = sqv + nv;                        // (K, kSlotFloats)
  int* sq = reinterpret_cast<int*>(srec + K * kSlotFloats);  // (K)
  int* snd = sq + K;                             // (K)

  const float* cdof = a.cdof + static_cast<size_t>(b) * nv * 6;
  for (int i = tid; i < 6 * nv; i += kThreads) sdof[i] = cdof[i];
  for (int i = tid; i < nv; i += kThreads)
    sqv[i] = a.qvel[static_cast<size_t>(b) * nv + i];
  for (int k = tid; k < K; k += kThreads)
    load_slot(a, b, k, srec + k * kSlotFloats, sq + k, snd + k);
  __syncthreads();

  const size_t row0 = static_cast<size_t>(b) * ncr;
  for (int k = warp; k < K; k += kThreads / 32) {
    const float* rec = srec + k * kSlotFloats;
    const bool fric = k < a.K3;
    const int8_t* ad_row = a.ancd + static_cast<size_t>(sq[k]) * nv;
    const float* fr = rec + kFrame;
    float mu[A];
#pragma unroll
    for (int i = 0; i < A; ++i) mu[i] = rec[kMu + i];
    float vt[3] = {0.f, 0.f, 0.f}, vr[3] = {0.f, 0.f, 0.f};
    for (int v = lane; v < nv; v += 32) {
      const float d = static_cast<float>(ad_row[v]);
      const float* rel = rec + (d > 0.0f ? kRel2 : kRel1);
      const float* cd = sdof + 6 * v;
      const float w0 = cd[0], w1 = cd[1], w2 = cd[2];
      // cdof_lin + cdof_ang x rel, times d
      const float jx = (cd[3] + (w1 * rel[2] - w2 * rel[1])) * d;
      const float jy = (cd[4] + (w2 * rel[0] - w0 * rel[2])) * d;
      const float jz = (cd[5] + (w0 * rel[1] - w1 * rel[0])) * d;
      float tf[3], rf[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int f = 0; f < 3; ++f) tf[f] = dot3(fr + 3 * f, jx, jy, jz);
      const float qv = sqv[v];
#pragma unroll
      for (int f = 0; f < 3; ++f) vt[f] = fmaf(tf[f], qv, vt[f]);
      if (!fric) {
        sJ[(a.K3 * 2 * A + (k - a.K3)) * nv + v] = tf[0];
        continue;
      }
      if (A > 2) {
        const float rx = w0 * d, ry = w1 * d, rz = w2 * d;
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          rf[f] = dot3(fr + 3 * f, rx, ry, rz);
          vr[f] = fmaf(rf[f], qv, vr[f]);
        }
      }
      // the friction axes: t1, t2, then the rotational ones
      const float ax[kMaxA] = {tf[1], tf[2], rf[0], rf[1], rf[2]};
      float* out = sJ + (k * 2 * A) * nv + v;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float t = __fmul_rn(mu[i], ax[i]);
        out[(2 * i) * nv] = tf[0] + t;
        out[(2 * i + 1) * nv] = tf[0] - t;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        vt[f] += __shfl_xor_sync(kFull, vt[f], off);
        if (A > 2) vr[f] += __shfl_xor_sync(kFull, vr[f], off);
      }
    }
    const float p = rec[kP], bneg = -rec[kB], kip = rec[kKip];
    const bool hit = p < 0.0f;
    if (fric && lane < 2 * A) {
      const int i = lane >> 1;
      const float vaxes[kMaxA] = {vt[1], vt[2], vr[0], vr[1], vr[2]};
      float vax = 0.0f, m = 0.0f;
#pragma unroll
      for (int j = 0; j < A; ++j) {  // registers, no dynamic indexing
        if (j == i) {
          vax = vaxes[j];
          m = mu[j];
        }
      }
      const float t = __fmul_rn(m, vax);
      const float vrow = (lane & 1) ? vt[0] - t : vt[0] + t;
      const bool act = hit && i < snd[k];
      const size_t r = row0 + k * 2 * A + lane;
      a.cD[r] = act ? rec[kD] : 0.0f;
      a.caref[r] = __fmul_rn(bneg, vrow) - kip;
      a.cact[r] = act;
      a.cpos[r] = p;
    } else if (!fric && lane == 0) {
      const size_t r = row0 + a.K3 * 2 * A + (k - a.K3);
      a.cD[r] = hit ? rec[kD] : 0.0f;
      a.caref[r] = __fmul_rn(bneg, vt[0]) - kip;
      a.cact[r] = hit;
      a.cpos[r] = p;
    }
  }
  __syncthreads();

  // the env's c_J block, contiguous in device memory
  const int n = ncr * nv;
  float* dst = a.cJ + static_cast<size_t>(b) * n;
  if ((n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(sJ);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = tid; i < n / 4; i += kThreads) d4[i] = s4[i];
  } else {
    for (int i = tid; i < n; i += kThreads) dst[i] = sJ[i];
  }
}

size_t smem_bytes(int nv, int K3, int K1, int A) {
  const size_t K = static_cast<size_t>(K3) + K1;
  const size_t ncr = static_cast<size_t>(K3) * 2 * A + K1;
  return sizeof(float) * (ncr * nv + 7 * static_cast<size_t>(nv)
                          + K * kSlotFloats)
         + sizeof(int) * 2 * K;
}

}  // namespace

// Shared memory one block (one env) needs; SIZE_MAX for an A the kernel
// does not take.
extern "C" size_t contact_rows_smem_bytes(int nv, int K3, int K1, int A) {
  if (A < 1 || A > kMaxA || nv <= 0 || K3 < 0 || K1 < 0) return SIZE_MAX;
  return smem_bytes(nv, K3, K1, A);
}

// ptrs: pdist, sel3, sel1, pos, frame, friction, solref, solimp, cdof,
//       subtree_com, qvel, body_invweight0, timestep, impratio, tab, dim,
//       ancd, cJ, cD, caref, cact, cpos (device pointers; sel3 and sel1
//       int64 with row strides sel3_stride and sel1_stride, tab and dim
//       int32, ancd int8, cact bytes, the rest float32).
extern "C" int contact_rows_launch(void* const* ptrs, int B, int ncon,
                                   int nbody, int nv, int K3, int K1,
                                   int np3, int A, int refsafe,
                                   int64_t sel3_stride, int64_t sel1_stride,
                                   void* stream) {
  if (B <= 0 || K3 + K1 == 0) return 0;
  const size_t smem = contact_rows_smem_bytes(nv, K3, K1, A);
  if (smem == SIZE_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pdist = static_cast<const float*>(ptrs[0]);
  a.sel3 = static_cast<const int64_t*>(ptrs[1]);
  a.sel1 = static_cast<const int64_t*>(ptrs[2]);
  a.pos = static_cast<const float*>(ptrs[3]);
  a.frame = static_cast<const float*>(ptrs[4]);
  a.friction = static_cast<const float*>(ptrs[5]);
  a.solref = static_cast<const float*>(ptrs[6]);
  a.solimp = static_cast<const float*>(ptrs[7]);
  a.cdof = static_cast<const float*>(ptrs[8]);
  a.com = static_cast<const float*>(ptrs[9]);
  a.qvel = static_cast<const float*>(ptrs[10]);
  a.invw0 = static_cast<const float*>(ptrs[11]);
  a.timestep = static_cast<const float*>(ptrs[12]);
  a.impratio = static_cast<const float*>(ptrs[13]);
  a.tab = static_cast<const int*>(ptrs[14]);
  a.dim = static_cast<const int*>(ptrs[15]);
  a.ancd = static_cast<const int8_t*>(ptrs[16]);
  a.cJ = static_cast<float*>(ptrs[17]);
  a.cD = static_cast<float*>(ptrs[18]);
  a.caref = static_cast<float*>(ptrs[19]);
  a.cact = static_cast<bool*>(ptrs[20]);
  a.cpos = static_cast<float*>(ptrs[21]);
  a.sel3_stride = sel3_stride;
  a.sel1_stride = sel1_stride;
  a.ncon = ncon; a.nbody = nbody; a.nv = nv;
  a.K3 = K3; a.K1 = K1; a.np3 = np3; a.refsafe = refsafe;
  void (*kernel)(const Args);
  switch (A) {
    case 1: kernel = contact_rows_kernel<1>; break;
    case 2: kernel = contact_rows_kernel<2>; break;
    case 3: kernel = contact_rows_kernel<3>; break;
    case 4: kernel = contact_rows_kernel<4>; break;
    default: kernel = contact_rows_kernel<5>; break;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* contact_rows_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
