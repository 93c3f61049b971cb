// K3: fused smooth stage, one warp per env, the env's working set in
// shared memory.
//
// Replaces the TPU kernel mjlab_tpu/ops/smooth_kernel.py:_make_kernel
// (pallas_call in smooth_fused_tpu). Per env, from qpos/qvel: forward
// kinematics (xpos, xquat, xmat, xipos, ximat, xanchor, xaxis), geom and
// site frames, subtree COM, spatial inertias cinr, cdof, cvel and cdof_dot
// (with the free-joint segment rule), the CRB mass matrix with armature
// and the RNE bias force.
//
// Bound: bytes. Per env the kernel reads qpos and qvel and writes every
// output once (~18 KB at the Unitree G1's sizes); its arithmetic (a few
// thousand FLOPs per body) is small beside that. What costs time is the
// tree: every sweep over it is a chain of dependent steps, and a warp
// waits some 30 cycles for each shared-memory read on such a chain.
// Design:
//  * One warp works on one env, several envs a block. A warp never waits
//    for another: the only barrier is __syncwarp(). Warps past the end of
//    the batch stay alive, compute on the last env and store nothing.
//    (Groups of 8 and 16 lanes an env measured slower on the G1.)
//  * Everything an env reads again lives in its slice of dynamic shared
//    memory (Layout below, the one owner of that layout): qpos, qvel,
//    xpos, xquat, xipos, ximat, xanchor, xaxis, subtree_com, cinr, cdof,
//    cdof_dot, cvel, and the intermediates cacc, the body forces, the
//    subtree moments and crb * cdof. The composite inertias take cinr's
//    place once cinr has been written out. Write-only outputs with rows of
//    9 or 3 floats (xmat, geom and site frames) pass through a staging
//    buffer, so that every global store is a coalesced copy of one
//    contiguous output row: consecutive lanes, consecutive addresses.
//    qM is written straight to global memory, every entry once, zeros
//    included, from a bit mask of its sparsity.
//  * The kinematic sweep walks the tree level by level (level table in
//    the int table): the bodies of a level are independent, lanes stride
//    over them, one __syncwarp() a level. A hinge's local quaternion (its
//    sine and cosine) is computed for all joints at once before the
//    sweep, outside the chain.
//  * The backward sweeps (subtree COM; composite inertias and RNE forces,
//    36 + 6 entries a body, together) add a body into its parent,
//    component by component. There a lane owns one component of every
//    body and walks the bodies serially, children first: its column is
//    private, so the sweep needs no barrier and keeps the serial order of
//    the sums. A step's indices come from one small table (`sweep`) and
//    are loaded a step ahead, so that only the data is on the chain.
//  * cvel and cacc need no sweep at all: a body's value is the world's
//    plus the products of the dofs between the root and the body, in
//    their order. Every (body, component) adds them up on its own from the
//    list of the body's ancestor dofs: the same sums in the same order
//    without a chain from body to body. cdof_dot, which needs a body's
//    whole velocity, is a wide phase between the two.
//  * The wide phases stride over items, not envs: bodies, geoms and sites,
//    joints, dofs, the nv * nv entries of qM.
//  * The model's shared tables (1,092 floats and 824 ints for the G1) are
//    copied into shared memory once a block.
//  * Per-env constants (domain randomization), as the TPU kernel takes
//    every segment batched: a segment of the float table (bconst, jconst,
//    gconst, sconst, qpos0, armature) that the Model carries per env lives
//    in a second table in global memory, one row of `etab_len` floats an
//    env, and is left out of the shared table. A warp reads its env's row
//    there (from L2: 1,089 floats an env on the G1 with every segment per
//    env), so an env's shared-memory slice and the envs a block stay as
//    they are. Gravity stays shared: opt.gravity is no field that domain
//    randomization can name. The kernel is built twice: with every segment
//    in shared memory (the pointers stay in the shared window), and with
//    per-env segments (generic pointers, chosen per segment).
//
// Built with -DK3_PHASE_CLOCKS (tools/k3_phase_clocks.py), thread 0 of
// every block adds the cycles of each phase to a global table.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kFree = 0;
constexpr int kSlide = 2;
constexpr int kHinge = 3;
constexpr int kLanes = 32;  // one warp an env
constexpr int kCinrLd = 37;  // a body's 36 entries, padded off the banks
constexpr int kBackward = 36 + 6;  // inertia and force entries a body
static_assert(kLanes == 32 && kBackward - kLanes == 10,
              "the backward sweep gives lanes 0 to 9 a second entry");

#ifdef K3_PHASE_CLOCKS
constexpr int kPhases = 10;
__device__ unsigned long long k3_phase_cycles[kPhases];
#define PHASE(k)                                                   \
  if (threadIdx.x == 0) {                                          \
    const long long now = clock64();                               \
    atomicAdd(&k3_phase_cycles[k],                                 \
              static_cast<unsigned long long>(now - phase_start)); \
    phase_start = now;                                             \
  }
#else
#define PHASE(k)
#endif

struct Dims {
  int B, nb, nj, nv, nq, ng, ns, nlevel, gravity_off;
  int nj1, ng1, ns1;
  int itab_len, ftab_len;
  // floats an env in the per-env table, and which segments are there (bit
  // k: segment k of bconst, jconst, gconst, sconst, qpos0, armature)
  int etab_len, env_segs;
  // offsets into the int table
  int o_order, o_level_ptr, o_sweep, o_anc_ptr, o_anc_idx, o_parent,
      o_jnt_of_body, o_jnt_type, o_jnt_qposadr, o_jnt_dofadr, o_rootid,
      o_geom_body, o_site_body, o_body_dofadr, o_dof_body, o_qm_mask;
  // offsets of the segments: into the shared float table, or into an
  // env's row of the per-env table where the segment's bit is set
  int o_bconst, o_jconst, o_gconst, o_sconst, o_qpos0, o_arm, o_grav;
};

enum { kSegBody = 1, kSegJnt = 2, kSegGeom = 4, kSegSite = 8, kSegQpos0 = 16,
       kSegArm = 32 };

constexpr int kNumOut = 18;

struct Outs {
  float* p[kNumOut];
};

enum {
  XPOS, XQUAT, XMAT, XIPOS, XIMAT, XANCHOR, XAXIS, GXPOS, GXMAT, SXPOS,
  SXMAT, SCOM, CINR, CDOF, CVEL, CDOFDOT, QM, QBIAS
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int take(int& at, int n) {
  const int o = at;
  at += round4(n);
  return o;
}

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offsets, in floats, of one env's arrays in its slice of dynamic shared
// memory; every array starts on 16 bytes. Arrays whose lives do not
// overlap share room: the staging buffer (frames) with cacc and the body
// forces (velocity sweep onward); the joints' local quaternions
// (kinematic sweep) with the subtree moments (COM sweep) and crb * cdof
// (mass matrix).
struct Layout {
  int q, qd, xpos, xquat, xipos, ximat, xanchor, xaxis, scom, cinr, cdof,
      cdofdot, cvel, stage, cacc, force, qloc, mom, crbdof, total;

  __host__ __device__ explicit Layout(const Dims& D) {
    int at = 0;
    q = take(at, D.nq);
    qd = take(at, D.nv);
    xpos = take(at, 3 * D.nb);
    xquat = take(at, 4 * D.nb);
    xipos = take(at, 3 * D.nb);
    ximat = take(at, 9 * D.nb);
    xanchor = take(at, 3 * D.nj1);
    xaxis = take(at, 3 * D.nj1);
    scom = take(at, 3 * D.nb);
    cinr = take(at, kCinrLd * D.nb);
    cdof = take(at, 6 * D.nv);
    cdofdot = take(at, 6 * D.nv);
    cvel = take(at, 6 * D.nb);
    stage = cacc = at;
    force = cacc + round4(6 * D.nb);
    at += imax(round4(12 * imax(D.nb, D.ng + D.ns)), 2 * round4(6 * D.nb));
    qloc = mom = crbdof = at;
    at += imax(round4(4 * imax(D.nj1, D.nb)), round4(6 * D.nv));
    total = at;
  }
};

// One block's shared memory, in floats: its envs' slices, then the shared
// float table and the int table.
__host__ __device__ inline size_t smem_floats(const Dims& D,
                                              int envs_per_block) {
  return static_cast<size_t>(envs_per_block) * Layout(D).total +
         round4(D.ftab_len) + round4(D.itab_len);
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  const float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

__device__ __forceinline__ void qnorm(float* q) {
  const float n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const float n = sqrtf(fmaxf(n2, 1e-24f));
  if (n > 1e-12f) {
    for (int k = 0; k < 4; ++k) q[k] /= n;
  } else {
    q[0] = 1.f; q[1] = q[2] = q[3] = 0.f;
  }
}

// rotate v by unit quaternion q: v + 2 (w (u x v) + u x (u x v))
__device__ __forceinline__ void qrot(const float* v, const float* q,
                                     float* o) {
  float uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
  for (int k = 0; k < 3; ++k) o[k] = v[k] + 2.f * (q[0] * uv[k] + uuv[k]);
}

__device__ __forceinline__ void q2m(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1 - 2 * (yy + zz); m[1] = 2 * (xy - wz); m[2] = 2 * (xz + wy);
  m[3] = 2 * (xy + wz); m[4] = 1 - 2 * (xx + zz); m[5] = 2 * (yz - wx);
  m[6] = 2 * (xz - wy); m[7] = 2 * (yz + wx); m[8] = 1 - 2 * (xx + yy);
}

__device__ __forceinline__ void mot_cross(const float* v, const float* u,
                                          float* o) {
  float a[3], b[3];
  cross3(v, u, o);
  cross3(v, u + 3, a);
  cross3(v + 3, u, b);
  for (int k = 0; k < 3; ++k) o[3 + k] = a[k] + b[k];
}

__device__ __forceinline__ void frc_cross(const float* v, const float* f,
                                          float* o) {
  float a[3], b[3];
  cross3(v, f, a);
  cross3(v + 3, f + 3, b);
  for (int k = 0; k < 3; ++k) o[k] = a[k] + b[k];
  cross3(v, f + 3, o + 3);
}

__device__ __forceinline__ void i66_vec(const float* M, const float* v,
                                        float* o) {
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
    for (int k = 0; k < 6; ++k) s += M[6 * i + k] * v[k];
    o[i] = s;
  }
}

// four floats from or to a 16-byte aligned address (a quaternion's row)
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The frame of an item fixed to a body: position and rotation matrix of
// local (pos3, quat4) `c` under the body's (bpos, bquat).
__device__ __forceinline__ void local_frame(const float* c, const float* bpos,
                                            const float* bquat, float* pos,
                                            float* mat) {
  float t[3], qq[4];
  qrot(c, bquat, t);
  for (int k = 0; k < 3; ++k) pos[k] = bpos[k] + t[k];
  qmul(bquat, c + 3, qq);
  q2m(qq, mat);
}

// kPerEnv: some segments of the float table are read from the env's row of
// `etab` (Dims::env_segs); without it `etab` is not read.
template <bool kPerEnv>
__global__ void smooth_kernel(const float* __restrict__ qpos,
                              const float* __restrict__ qvel,
                              const int* __restrict__ itab,
                              const float* __restrict__ ftab,
                              const float* __restrict__ etab, Dims D,
                              Outs O) {
  extern __shared__ __align__(16) float smem[];
#ifdef K3_PHASE_CLOCKS
  long long phase_start = clock64();
#endif
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int envs_per_block = blockDim.x / kLanes;
  const Layout lay(D);
  const int nb = D.nb, nv = D.nv;

  const int env = blockIdx.x * envs_per_block + warp;
  const bool live = env < D.B;
  const size_t bb = live ? env : D.B - 1;

  float* E = smem + static_cast<size_t>(warp) * lay.total;
  float* q = E + lay.q;
  float* qd = E + lay.qd;
  float* xpos = E + lay.xpos;
  float* xquat = E + lay.xquat;
  float* xipos = E + lay.xipos;
  float* ximat = E + lay.ximat;
  float* xanchor = E + lay.xanchor;
  float* xaxis = E + lay.xaxis;
  float* scom = E + lay.scom;
  float* cinr = E + lay.cinr;  // the composite inertias, later
  float* cdof = E + lay.cdof;
  float* cdofdot = E + lay.cdofdot;
  float* cvel = E + lay.cvel;
  float* stage = E + lay.stage;
  float* cacc = E + lay.cacc;
  float* force = E + lay.force;
  float* qloc = E + lay.qloc;
  float* mom = E + lay.mom;
  float* crbdof = E + lay.crbdof;

  // ---- load: the env's state, and the model's tables once a block -----------
  for (int i = lane; i < D.nq; i += kLanes) q[i] = qpos[bb * D.nq + i];
  for (int i = lane; i < nv; i += kLanes) qd[i] = qvel[bb * nv + i];
  float* ft = smem + static_cast<size_t>(envs_per_block) * lay.total;
  int* it = reinterpret_cast<int*>(ft + round4(D.ftab_len));
#pragma unroll 4
  for (int i = threadIdx.x; i < D.ftab_len; i += blockDim.x) ft[i] = ftab[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < D.itab_len; i += blockDim.x) it[i] = itab[i];
  if (lane == 0) {
    xpos[0] = xpos[1] = xpos[2] = 0.f;
    xquat[0] = 1.f; xquat[1] = xquat[2] = xquat[3] = 0.f;
    for (int k = 0; k < 6; ++k) cvel[k] = 0.f;
  }
  __syncthreads();
  PHASE(0)  // load

  const int* order = it + D.o_order;  // the world body, then level by level
  const int* level_ptr = it + D.o_level_ptr;
  const int* sweep = it + D.o_sweep;  // (body, parent) along `order`
  // a body's dofs and its ancestors', root first
  const int* anc_ptr = it + D.o_anc_ptr;
  const int* anc_idx = it + D.o_anc_idx;
  const int* parent = it + D.o_parent;
  const int* jnt_of_body = it + D.o_jnt_of_body;
  const int* jnt_type = it + D.o_jnt_type;
  const int* jnt_qposadr = it + D.o_jnt_qposadr;
  const int* jnt_dofadr = it + D.o_jnt_dofadr;
  const int* rootid = it + D.o_rootid;
  const int* geom_body = it + D.o_geom_body;
  const int* site_body = it + D.o_site_body;
  const int* body_dofadr = it + D.o_body_dofadr;
  const int* dof_body = it + D.o_dof_body;
  const int* qm_mask = it + D.o_qm_mask;
  const float* bconst = ft + D.o_bconst;  // pos3 quat4 ipos3 iquat4 inertia3 mass
  const float* jconst = ft + D.o_jconst;  // jnt_pos3 jnt_axis3
  const float* gconst = ft + D.o_gconst;  // pos3 quat4
  const float* sconst = ft + D.o_sconst;
  const float* qpos0 = ft + D.o_qpos0;
  const float* arm = ft + D.o_arm;
  const float* grav = ft + D.o_grav;
  if (kPerEnv) {  // the env's own row for the segments it carries per env
    const float* et = etab + bb * D.etab_len;
    const int segs = D.env_segs;
    if (segs & kSegBody) bconst = et + D.o_bconst;
    if (segs & kSegJnt) jconst = et + D.o_jconst;
    if (segs & kSegGeom) gconst = et + D.o_gconst;
    if (segs & kSegSite) sconst = et + D.o_sconst;
    if (segs & kSegQpos0) qpos0 = et + D.o_qpos0;
    if (segs & kSegArm) arm = et + D.o_arm;
  }

  // one contiguous output row of this env, from shared memory
  auto copy_out = [&](int which, const float* src, int n) {
    if (!live) return;
    float* dst = O.p[which] + bb * n;
#pragma unroll 4
    for (int i = lane; i < n; i += kLanes) dst[i] = src[i];
  };

  // ---- the joints' local motion, all at once ---------------------------------
  // hinge: the quaternion of its angle about the local axis; slide: its
  // displacement
  for (int j = lane; j < D.nj; j += kLanes) {
    const int jt = jnt_type[j];
    if (jt == kFree) continue;
    const int qa = jnt_qposadr[j];
    const float delta = q[qa] - qpos0[qa];
    float v[4] = {delta, 0.f, 0.f, 0.f};
    if (jt == kHinge) {
      const float* jaxis = jconst + 6 * j + 3;
      const float half = 0.5f * delta;
      const float s = sinf(half);
      v[0] = cosf(half);
      for (int k = 0; k < 3; ++k) v[1 + k] = jaxis[k] * s;
    }
    st4(qloc + 4 * j, v);
  }
  __syncwarp();
  PHASE(1)  // joint locals

  // ---- forward kinematics, level by level -------------------------------------
  for (int l = 1; l < D.nlevel; ++l) {
    const int l1 = level_ptr[l + 1];
    for (int oi = level_ptr[l] + lane; oi < l1; oi += kLanes) {
      const int body = order[oi];
      const int p = parent[body];
      const float* bc = bconst + body * 18;
      float pq[4], pos[3], quat[4], t[3];
      ld4(xquat + 4 * p, pq);
      qrot(bc, pq, t);
      for (int k = 0; k < 3; ++k) pos[k] = xpos[3 * p + k] + t[k];
      qmul(pq, bc + 3, quat);
      const int j = jnt_of_body[body];
      if (j >= 0) {
        const int jt = jnt_type[j];
        if (jt == kFree) {
          const int qa = jnt_qposadr[j];
          for (int k = 0; k < 3; ++k) pos[k] = q[qa + k];
          for (int k = 0; k < 4; ++k) quat[k] = q[qa + 3 + k];
          qnorm(quat);
          for (int k = 0; k < 3; ++k) xanchor[3 * j + k] = pos[k];
          xaxis[3 * j] = 0.f; xaxis[3 * j + 1] = 0.f; xaxis[3 * j + 2] = 1.f;
        } else {
          const float* jpos = jconst + 6 * j;
          float anchor[3], axis_w[3], loc[4];
          qrot(jpos, quat, t);
          for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + t[k];
          qrot(jpos + 3, quat, axis_w);
          for (int k = 0; k < 3; ++k) {
            xanchor[3 * j + k] = anchor[k];
            xaxis[3 * j + k] = axis_w[k];
          }
          ld4(qloc + 4 * j, loc);
          if (jt == kSlide) {
            for (int k = 0; k < 3; ++k) pos[k] += axis_w[k] * loc[0];
          } else if (jt == kHinge) {
            float nq[4];
            qmul(quat, loc, nq);
            for (int k = 0; k < 4; ++k) quat[k] = nq[k];
            qrot(jpos, quat, t);
            for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - t[k];
          }
        }
      }
      qnorm(quat);
      for (int k = 0; k < 3; ++k) xpos[3 * body + k] = pos[k];
      st4(xquat + 4 * body, quat);
    }
    __syncwarp();
  }
  PHASE(2)  // kinematic sweep

  // ---- frames -------------------------------------------------------------------
  copy_out(XPOS, xpos, 3 * nb);
  copy_out(XQUAT, xquat, 4 * nb);
  copy_out(XANCHOR, xanchor, 3 * D.nj);
  copy_out(XAXIS, xaxis, 3 * D.nj);
  for (int body = lane; body < nb; body += kLanes) {
    const float* bc = bconst + body * 18;
    float bq[4];
    ld4(xquat + 4 * body, bq);
    q2m(bq, stage + 9 * body);
    local_frame(bc + 7, xpos + 3 * body, bq, xipos + 3 * body,
                ximat + 9 * body);
  }
  __syncwarp();
  copy_out(XMAT, stage, 9 * nb);
  copy_out(XIPOS, xipos, 3 * nb);
  copy_out(XIMAT, ximat, 9 * nb);
  __syncwarp();
  // geoms, then sites: positions at the front of the staging buffer,
  // matrices behind them
  const int nframe = D.ng + D.ns;
  for (int f = lane; f < nframe; f += kLanes) {
    const bool geom = f < D.ng;
    const int body = geom ? geom_body[f] : site_body[f - D.ng];
    const float* c = geom ? gconst + 7 * f : sconst + 7 * (f - D.ng);
    float bq[4];
    ld4(xquat + 4 * body, bq);
    local_frame(c, xpos + 3 * body, bq, stage + 3 * f,
                stage + 3 * nframe + 9 * f);
  }
  __syncwarp();
  copy_out(GXPOS, stage, 3 * D.ng);
  copy_out(GXMAT, stage + 3 * nframe, 9 * D.ng);
  copy_out(SXPOS, stage + 3 * D.ng, 3 * D.ns);
  copy_out(SXMAT, stage + 3 * nframe + 9 * D.ng, 9 * D.ns);
  PHASE(3)  // frames

  // ---- subtree COM: lane k < 4 adds component k of every body into its parent ---
  for (int body = lane; body < nb; body += kLanes) {
    const float mass = bconst[body * 18 + 17];
    const float v[4] = {mass * xipos[3 * body], mass * xipos[3 * body + 1],
                        mass * xipos[3 * body + 2], mass};
    st4(mom + 4 * body, v);
  }
  __syncwarp();
  if (lane < 4) {
    int body = sweep[2 * (nb - 1)], p = sweep[2 * (nb - 1) + 1];
    for (int oi = nb - 1; oi >= 1; --oi) {
      const int next_body = sweep[2 * (oi - 1)];
      const int next_p = sweep[2 * (oi - 1) + 1];
      mom[4 * p + lane] += mom[4 * body + lane];
      body = next_body;
      p = next_p;
    }
  }
  __syncwarp();
  for (int i = lane; i < 3 * nb; i += kLanes) {
    const int body = i / 3;
    const float v = mom[4 * body + i % 3] / fmaxf(mom[4 * body + 3], 1e-12f);
    scom[i] = v;
    if (live) O.p[SCOM][bb * 3 * nb + i] = v;
  }
  __syncwarp();
  PHASE(4)  // subtree COM

  // ---- cinr: spatial inertia in the c-frame; cdof ------------------------------
  for (int body = lane; body < nb; body += kLanes) {
    const float* bc = bconst + body * 18;
    const float* inertia = bc + 14;
    const float mass = bc[17];
    const float* R = ximat + 9 * body;
    const float* cr = scom + 3 * rootid[body];
    float h[3], icom[9];
    for (int k = 0; k < 3; ++k) h[k] = mass * (xipos[3 * body + k] - cr[k]);
    const float hhat[9] = {0.f, -h[2], h[1], h[2], 0.f, -h[0],
                           -h[1], h[0], 0.f};
    const float minv = 1.f / fmaxf(mass, 1e-12f);
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        float iw = 0.f, hh = 0.f;
        for (int k = 0; k < 3; ++k) {
          iw += R[3 * i + k] * inertia[k] * R[3 * j + k];
          hh += hhat[3 * i + k] * hhat[3 * j + k];
        }
        icom[3 * i + j] = iw + hh * minv;
      }
    }
    float* ci = cinr + kCinrLd * body;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        ci[6 * i + j] = icom[3 * i + j];
        ci[6 * i + 3 + j] = hhat[3 * i + j];
        ci[6 * (3 + i) + j] = -hhat[3 * i + j];
        ci[6 * (3 + i) + 3 + j] = (i == j) ? mass : 0.f;
      }
    }
  }
  for (int j = lane; j < D.nj; j += kLanes) {
    const int jt = jnt_type[j];
    const int da = jnt_dofadr[j];
    const int body = dof_body[da];
    const float* cr = scom + 3 * rootid[body];
    float off[3];
    for (int k = 0; k < 3; ++k) off[k] = cr[k] - xanchor[3 * j + k];
    if (jt == kFree) {
      float bq[4], R[9];
      ld4(xquat + 4 * body, bq);
      q2m(bq, R);
      for (int i = 0; i < 3; ++i) {
        float* c = cdof + 6 * (da + i);
        for (int k = 0; k < 6; ++k) c[k] = 0.f;
        c[3 + i] = 1.f;
        float* r = cdof + 6 * (da + 3 + i);
        const float ax[3] = {R[i], R[3 + i], R[6 + i]};
        for (int k = 0; k < 3; ++k) r[k] = ax[k];
        cross3(ax, off, r + 3);
      }
    } else if (jt == kSlide) {
      float* c = cdof + 6 * da;
      for (int k = 0; k < 3; ++k) {
        c[k] = 0.f;
        c[3 + k] = xaxis[3 * j + k];
      }
    } else {
      float* c = cdof + 6 * da;
      const float ax[3] = {xaxis[3 * j], xaxis[3 * j + 1], xaxis[3 * j + 2]};
      for (int k = 0; k < 3; ++k) c[k] = ax[k];
      cross3(ax, off, c + 3);
    }
  }
  __syncwarp();
  if (live) {
    float* dst = O.p[CINR] + bb * 36 * nb;
#pragma unroll 4
    for (int i = lane; i < 36 * nb; i += kLanes)
      dst[i] = cinr[kCinrLd * (i / 36) + i % 36];
  }
  copy_out(CDOF, cdof, 6 * nv);
  PHASE(5)  // cinr and cdof

  // ---- cvel, cdof_dot and cacc ---------------------------------------------------
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) {
      cacc[k] = 0.f;
      cacc[3 + k] = D.gravity_off ? 0.f : -grav[k];
    }
  }
  __syncwarp();
  // x[body] = x[world] + sum of y[dof] * qvel[dof] over the dofs between
  // the root and the body, in their order: what a sweep from parent to
  // child adds up, but every (body, component) on its own from the list of
  // the body's ancestor dofs, so there is no chain from body to body
  auto forward_sums = [&](float* x, const float* y) {
    for (int item = lane + 6; item < 6 * nb; item += kLanes) {
      const int body = item / 6, k = item % 6;
      float v = x[k];
      const int a1 = anc_ptr[body + 1];
#pragma unroll 4
      for (int a = anc_ptr[body]; a < a1; ++a) {
        const int d = anc_idx[a];
        v += y[6 * d + k] * qd[d];
      }
      x[item] = v;
    }
    __syncwarp();
  };
  forward_sums(cvel, cdof);
  // cdof_dot = v x cdof, v the velocity the dof sees: its body's parent's,
  // and for the rotational dofs of a free joint also that of the joint's
  // translational dofs, not of each other (mj_comVel works per joint
  // segment)
  for (int d = lane; d < nv; d += kLanes) {
    const int body = dof_body[d];
    const int da = body_dofadr[body];
    float v[6], u[6], dd[6];
    for (int k = 0; k < 6; ++k) {
      v[k] = cvel[6 * parent[body] + k];
      u[k] = cdof[6 * d + k];
    }
    if (jnt_type[jnt_of_body[body]] == kFree && d >= da + 3)
      for (int t = da; t < da + 3; ++t)
        for (int k = 0; k < 6; ++k) v[k] += cdof[6 * t + k] * qd[t];
    mot_cross(v, u, dd);
    for (int k = 0; k < 6; ++k) cdofdot[6 * d + k] = dd[k];
  }
  __syncwarp();
  forward_sums(cacc, cdofdot);
  copy_out(CVEL, cvel, 6 * nb);
  copy_out(CDOFDOT, cdofdot, 6 * nv);
  PHASE(6)  // cvel, cdof_dot, cacc

  // ---- RNE body forces: cinr cacc + cvel x* (cinr cvel) -------------------------
  for (int body = lane; body < nb; body += kLanes) {
    float a[6], v[6], f[6], iv[6], fc[6];
    for (int k = 0; k < 6; ++k) {
      a[k] = cacc[6 * body + k];
      v[k] = cvel[6 * body + k];
    }
    i66_vec(cinr + kCinrLd * body, a, f);
    i66_vec(cinr + kCinrLd * body, v, iv);
    frc_cross(v, iv, fc);
    for (int k = 0; k < 6; ++k) force[6 * body + k] = f[k] + fc[k];
  }
  __syncwarp();
  PHASE(7)  // RNE body forces

  // ---- composite inertias (in cinr's place) and subtree forces, backward ------
  // a lane owns one or two of a body's 36 + 6 entries (lane k the k-th of
  // the inertia, lanes 0 to 3 also its last four, lanes 4 to 9 the force)
  // in every body and adds the bodies into their parents, children first:
  // no barrier. Both entries are read before either is written.
  {
    float* second = (lane < 4) ? cinr + 32 + lane : force + (lane - 4);
    const int ld2 = (lane < 4) ? kCinrLd : 6;
    const bool two = lane < kBackward - kLanes;
    int body = sweep[2 * (nb - 1)], p = sweep[2 * (nb - 1) + 1];
    for (int oi = nb - 1; oi >= 1; --oi) {
      const int next_body = sweep[2 * (oi - 1)];
      const int next_p = sweep[2 * (oi - 1) + 1];
      if (p != 0) {  // nothing reads the world body's sums
        const float a = cinr[kCinrLd * p + lane] + cinr[kCinrLd * body + lane];
        float b = 0.f;
        if (two) b = second[ld2 * p] + second[ld2 * body];
        cinr[kCinrLd * p + lane] = a;
        if (two) second[ld2 * p] = b;
      }
      body = next_body;
      p = next_p;
    }
  }
  __syncwarp();
  PHASE(8)  // backward sweep

  // ---- mass matrix and bias -----------------------------------------------------
  for (int i = lane; i < nv; i += kLanes) {
    float u[6], t[6];
    for (int k = 0; k < 6; ++k) u[k] = cdof[6 * i + k];
    i66_vec(cinr + kCinrLd * dof_body[i], u, t);
    for (int k = 0; k < 6; ++k) crbdof[6 * i + k] = t[k];
    float v = 0.f;
    for (int k = 0; k < 6; ++k) v += u[k] * force[6 * dof_body[i] + k];
    if (live) O.p[QBIAS][bb * nv + i] = v;
  }
  __syncwarp();
  // every entry of qM once, both triangles: entry (i, j) is non-zero where
  // dof min(i, j) moves the body of dof max(i, j)
  const int words = (nv + 31) / 32;
  float* qM = O.p[QM] + bb * nv * nv;
  // four entries a lane in flight; an entry off the mask computes its
  // product all the same and stores zero, so that nothing branches
  const int entries = nv * nv;
  int i = lane / nv, j = lane % nv;
  for (int e = lane; e < entries; e += 4 * kLanes) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = e + u * kLanes < entries;
      const int r = in ? (i > j ? i : j) : 0, c = in ? (i > j ? j : i) : 0;
      const bool pair = (qm_mask[r * words + (c >> 5)] >> (c & 31)) & 1;
      float v = 0.f;
      for (int k = 0; k < 6; ++k) v += crbdof[6 * r + k] * cdof[6 * c + k];
      v = pair ? v : 0.f;
      if (r == c) v += arm[r];
      if (live && in) qM[e + u * kLanes] = v;
      for (j += kLanes; j >= nv; j -= nv) ++i;
    }
  }
  PHASE(9)  // mass matrix and bias
}

Dims read_dims(const int* dims) {
  Dims D;
  int* dst = reinterpret_cast<int*>(&D);
  for (size_t k = 0; k < sizeof(Dims) / sizeof(int); ++k) dst[k] = dims[k];
  return D;
}

}  // namespace

#ifdef K3_PHASE_CLOCKS
// Copies the phase table to `out` (kPhases values) and clears it.
extern "C" int smooth_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k3_phase_cycles,
                                       sizeof(k3_phase_cycles));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(k3_phase_cycles, zero, sizeof(zero)));
}
#endif

// Shared memory one block of `envs_per_block` envs needs.
extern "C" size_t smooth_smem_bytes(const int* dims, int envs_per_block) {
  return sizeof(float) * smem_floats(read_dims(dims), envs_per_block);
}

// One warp an env, `envs_per_block` (1 to 32) warps a block. `etab` is
// the per-env table, (B, etab_len), where Dims::env_segs is not 0.
extern "C" int smooth_launch(const float* qpos, const float* qvel,
                             const int* itab, const float* ftab,
                             const float* etab, const int* dims,
                             float* const* outs, int envs_per_block,
                             void* stream) {
  const Dims D = read_dims(dims);
  Outs O;
  for (int k = 0; k < kNumOut; ++k) O.p[k] = outs[k];
  if (D.B <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > 32)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool per_env = D.env_segs != 0;
  if (per_env && (etab == nullptr || D.etab_len <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = per_env ? smooth_kernel<true> : smooth_kernel<false>;
  const size_t smem = smooth_smem_bytes(dims, envs_per_block);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (D.B + envs_per_block - 1) / envs_per_block;
  kernel<<<blocks, kLanes * envs_per_block, smem,
           static_cast<cudaStream_t>(stream)>>>(qpos, qvel, itab, ftab, etab,
                                                D, O);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread of the kernel's shared-table form (per_env 0) or of
// its per-env form use; a negative CUDA error code on failure.
extern "C" int smooth_num_regs(int per_env) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, per_env ? reinterpret_cast<const void*>(smooth_kernel<true>)
                  : reinterpret_cast<const void*>(smooth_kernel<false>));
  return e == cudaSuccess ? a.numRegs : -static_cast<int>(e);
}

extern "C" int smooth_dims_count() {
  return static_cast<int>(sizeof(Dims) / sizeof(int));
}

extern "C" int smooth_num_outputs() { return kNumOut; }

extern "C" const char* smooth_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
