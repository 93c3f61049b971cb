// K3: fused smooth stage, one env per thread.
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
// thousand FLOPs per body) is small beside that. Design: one thread per
// env walks the static tree schedule (parent-before-child order, joint
// table, qM sparsity in CSR form) uploaded as one small int table; model
// constants come from one small float table shared by all threads. The
// thread keeps its intermediates in its own rows of the output tensors
// and a per-env scratch row, so no per-thread array is sized by the model.

#include <cuda_runtime.h>

namespace {

constexpr int kFree = 0;
constexpr int kSlide = 2;
constexpr int kHinge = 3;

struct Dims {
  int B, nb, nj, nv, nq, ng, ns, norder, gravity_off;
  int nj1, ng1, ns1;
  // offsets into the int table
  int o_order, o_parent, o_jnt_of_body, o_jnt_type, o_jnt_qposadr,
      o_jnt_dofadr, o_rootid, o_geom_body, o_site_body, o_body_dofadr,
      o_body_dofnum, o_dof_body, o_qm_ptr, o_qm_idx;
  // offsets into the float table
  int o_bconst, o_jconst, o_gconst, o_sconst, o_qpos0, o_arm, o_grav;
};

constexpr int kNumOut = 19;

struct Outs {
  float* p[kNumOut];
};

enum {
  XPOS, XQUAT, XMAT, XIPOS, XIMAT, XANCHOR, XAXIS, GXPOS, GXMAT, SXPOS,
  SXMAT, SCOM, CINR, CDOF, CVEL, CDOFDOT, QM, QBIAS, SCRATCH
};

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

__global__ void smooth_kernel(const float* __restrict__ qpos,
                              const float* __restrict__ qvel,
                              const int* __restrict__ it,
                              const float* __restrict__ ft, Dims D,
                              Outs O) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= D.B) return;
  const int nb = D.nb, nv = D.nv;
  const size_t bb = static_cast<size_t>(b);
  const float* q = qpos + bb * D.nq;
  const float* qd = qvel + bb * nv;
  float* xpos = O.p[XPOS] + bb * nb * 3;
  float* xquat = O.p[XQUAT] + bb * nb * 4;
  float* xmat = O.p[XMAT] + bb * nb * 9;
  float* xipos = O.p[XIPOS] + bb * nb * 3;
  float* ximat = O.p[XIMAT] + bb * nb * 9;
  float* xanchor = O.p[XANCHOR] + bb * D.nj1 * 3;
  float* xaxis = O.p[XAXIS] + bb * D.nj1 * 3;
  float* gxpos = O.p[GXPOS] + bb * D.ng1 * 3;
  float* gxmat = O.p[GXMAT] + bb * D.ng1 * 9;
  float* sxpos = O.p[SXPOS] + bb * D.ns1 * 3;
  float* sxmat = O.p[SXMAT] + bb * D.ns1 * 9;
  float* scom = O.p[SCOM] + bb * nb * 3;
  float* cinr = O.p[CINR] + bb * nb * 36;
  float* cdof = O.p[CDOF] + bb * nv * 6;
  float* cvel = O.p[CVEL] + bb * nb * 6;
  float* cdofdot = O.p[CDOFDOT] + bb * nv * 6;
  float* qM = O.p[QM] + bb * nv * nv;
  float* qbias = O.p[QBIAS] + bb * nv;
  float* scr = O.p[SCRATCH] + bb * nb * 52;
  float* crb = scr;                // nb * 36
  float* cacc = scr + nb * 36;     // nb * 6
  float* S = cacc + nb * 6;        // nb * 6
  float* msum = S + nb * 6;        // nb
  float* mom = msum + nb;          // nb * 3

  const int* order = it + D.o_order;
  const int* parent = it + D.o_parent;
  const int* jnt_of_body = it + D.o_jnt_of_body;
  const int* jnt_type = it + D.o_jnt_type;
  const int* jnt_qposadr = it + D.o_jnt_qposadr;
  const int* jnt_dofadr = it + D.o_jnt_dofadr;
  const int* rootid = it + D.o_rootid;
  const int* geom_body = it + D.o_geom_body;
  const int* site_body = it + D.o_site_body;
  const int* body_dofadr = it + D.o_body_dofadr;
  const int* body_dofnum = it + D.o_body_dofnum;
  const int* dof_body = it + D.o_dof_body;
  const int* qm_ptr = it + D.o_qm_ptr;
  const int* qm_idx = it + D.o_qm_idx;
  const float* bconst = ft + D.o_bconst;  // pos3 quat4 ipos3 iquat4 inertia3 mass
  const float* jconst = ft + D.o_jconst;  // jnt_pos3 jnt_axis3
  const float* gconst = ft + D.o_gconst;  // pos3 quat4
  const float* sconst = ft + D.o_sconst;
  const float* qpos0 = ft + D.o_qpos0;
  const float* arm = ft + D.o_arm;
  const float* grav = ft + D.o_grav;

  // ---- forward kinematics -------------------------------------------
  for (int k = 0; k < 3; ++k) xpos[k] = 0.f;
  xquat[0] = 1.f; xquat[1] = xquat[2] = xquat[3] = 0.f;
  for (int oi = 0; oi < D.norder; ++oi) {
    const int body = order[oi];
    const int p = parent[body];
    const float* bc = bconst + body * 18;
    float pos[3], quat[4], t[3];
    qrot(bc, xquat + 4 * p, t);
    for (int k = 0; k < 3; ++k) pos[k] = xpos[3 * p + k] + t[k];
    qmul(xquat + 4 * p, bc + 3, quat);
    const int j = jnt_of_body[body];
    if (j >= 0) {
      const int jt = jnt_type[j];
      const int qa = jnt_qposadr[j];
      if (jt == kFree) {
        for (int k = 0; k < 3; ++k) pos[k] = q[qa + k];
        for (int k = 0; k < 4; ++k) quat[k] = q[qa + 3 + k];
        qnorm(quat);
        for (int k = 0; k < 3; ++k) xanchor[3 * j + k] = pos[k];
        xaxis[3 * j] = 0.f; xaxis[3 * j + 1] = 0.f; xaxis[3 * j + 2] = 1.f;
      } else {
        const float* jpos = jconst + 6 * j;
        const float* jaxis = jpos + 3;
        float anchor[3], axis_w[3];
        qrot(jpos, quat, t);
        for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + t[k];
        qrot(jaxis, quat, axis_w);
        for (int k = 0; k < 3; ++k) {
          xanchor[3 * j + k] = anchor[k];
          xaxis[3 * j + k] = axis_w[k];
        }
        const float delta = q[qa] - qpos0[qa];
        if (jt == kSlide) {
          for (int k = 0; k < 3; ++k) pos[k] += axis_w[k] * delta;
        } else if (jt == kHinge) {
          const float half = 0.5f * delta;
          const float s = sinf(half);
          const float qloc[4] = {cosf(half), jaxis[0] * s, jaxis[1] * s,
                                 jaxis[2] * s};
          float nq[4];
          qmul(quat, qloc, nq);
          for (int k = 0; k < 4; ++k) quat[k] = nq[k];
          qrot(jpos, quat, t);
          for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - t[k];
        }
      }
    }
    qnorm(quat);
    for (int k = 0; k < 3; ++k) xpos[3 * body + k] = pos[k];
    for (int k = 0; k < 4; ++k) xquat[4 * body + k] = quat[k];
  }

  for (int body = 0; body < nb; ++body) {
    const float* bc = bconst + body * 18;
    float t[3], qq[4];
    q2m(xquat + 4 * body, xmat + 9 * body);
    qrot(bc + 7, xquat + 4 * body, t);
    for (int k = 0; k < 3; ++k) xipos[3 * body + k] = xpos[3 * body + k] + t[k];
    qmul(xquat + 4 * body, bc + 10, qq);
    q2m(qq, ximat + 9 * body);
  }
  for (int g = 0; g < D.ng; ++g) {
    const int body = geom_body[g];
    float t[3], qq[4];
    qrot(gconst + 7 * g, xquat + 4 * body, t);
    for (int k = 0; k < 3; ++k) gxpos[3 * g + k] = xpos[3 * body + k] + t[k];
    qmul(xquat + 4 * body, gconst + 7 * g + 3, qq);
    q2m(qq, gxmat + 9 * g);
  }
  for (int st = 0; st < D.ns; ++st) {
    const int body = site_body[st];
    float t[3], qq[4];
    qrot(sconst + 7 * st, xquat + 4 * body, t);
    for (int k = 0; k < 3; ++k) sxpos[3 * st + k] = xpos[3 * body + k] + t[k];
    qmul(xquat + 4 * body, sconst + 7 * st + 3, qq);
    q2m(qq, sxmat + 9 * st);
  }

  // ---- subtree com (backward) ---------------------------------------
  for (int body = 0; body < nb; ++body) {
    const float mass = bconst[body * 18 + 17];
    msum[body] = mass;
    for (int k = 0; k < 3; ++k) mom[3 * body + k] = mass * xipos[3 * body + k];
  }
  for (int oi = D.norder - 1; oi >= 0; --oi) {
    const int body = order[oi];
    const int p = parent[body];
    msum[p] += msum[body];
    for (int k = 0; k < 3; ++k) mom[3 * p + k] += mom[3 * body + k];
  }
  for (int body = 0; body < nb; ++body) {
    const float m = fmaxf(msum[body], 1e-12f);
    for (int k = 0; k < 3; ++k) scom[3 * body + k] = mom[3 * body + k] / m;
  }

  // ---- cinr: spatial inertia in the c-frame -------------------------
  for (int body = 0; body < nb; ++body) {
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
    float* ci = cinr + 36 * body;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        ci[6 * i + j] = icom[3 * i + j];
        ci[6 * i + 3 + j] = hhat[3 * i + j];
        ci[6 * (3 + i) + j] = -hhat[3 * i + j];
        ci[6 * (3 + i) + 3 + j] = (i == j) ? mass : 0.f;
      }
    }
  }

  // ---- cdof -----------------------------------------------------------
  for (int j = 0; j < D.nj; ++j) {
    const int jt = jnt_type[j];
    const int da = jnt_dofadr[j];
    const int body = dof_body[da];
    const float* cr = scom + 3 * rootid[body];
    float off[3];
    for (int k = 0; k < 3; ++k) off[k] = cr[k] - xanchor[3 * j + k];
    if (jt == kFree) {
      const float* R = xmat + 9 * body;
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
      for (int k = 0; k < 3; ++k) c[k] = xaxis[3 * j + k];
      cross3(c, off, c + 3);
    }
  }

  // ---- com_vel: cvel and cdof_dot, by joint segment --------------------
  for (int k = 0; k < 6; ++k) cvel[k] = 0.f;
  for (int oi = 0; oi < D.norder; ++oi) {
    const int body = order[oi];
    float v[6];
    for (int k = 0; k < 6; ++k) v[k] = cvel[6 * parent[body] + k];
    const int da = body_dofadr[body], dn = body_dofnum[body];
    const int j = jnt_of_body[body];
    // a free joint's rotational dofs see the parent plus translational
    // velocity, not each other (mj_comVel works per joint segment)
    const int split = (j >= 0 && jnt_type[j] == kFree) ? 3 : dn;
    int seg0 = 0;
    while (seg0 < dn) {
      const int seg1 = (seg0 < split) ? split : dn;
      for (int d = da + seg0; d < da + seg1; ++d)
        mot_cross(v, cdof + 6 * d, cdofdot + 6 * d);
      for (int d = da + seg0; d < da + seg1; ++d)
        for (int k = 0; k < 6; ++k) v[k] += cdof[6 * d + k] * qd[d];
      seg0 = seg1;
    }
    for (int k = 0; k < 6; ++k) cvel[6 * body + k] = v[k];
  }

  // ---- CRB mass matrix --------------------------------------------------
  for (int e = 0; e < nb * 36; ++e) crb[e] = cinr[e];
  for (int oi = D.norder - 1; oi >= 0; --oi) {
    const int body = order[oi];
    const int p = parent[body];
    for (int e = 0; e < 36; ++e) crb[36 * p + e] += crb[36 * body + e];
  }
  for (int e = 0; e < nv * nv; ++e) qM[e] = 0.f;
  for (int i = 0; i < nv; ++i) {
    float t[6];
    i66_vec(crb + 36 * dof_body[i], cdof + 6 * i, t);
    for (int e = qm_ptr[i]; e < qm_ptr[i + 1]; ++e) {
      const int j = qm_idx[e];
      float v = 0.f;
      for (int k = 0; k < 6; ++k) v += t[k] * cdof[6 * j + k];
      qM[i * nv + j] = v;
      qM[j * nv + i] = v;
    }
  }
  for (int i = 0; i < nv; ++i) qM[i * nv + i] += arm[i];

  // ---- RNE bias -----------------------------------------------------------
  for (int k = 0; k < 3; ++k) {
    cacc[k] = 0.f;
    cacc[3 + k] = D.gravity_off ? 0.f : -grav[k];
  }
  for (int oi = 0; oi < D.norder; ++oi) {
    const int body = order[oi];
    float a[6];
    for (int k = 0; k < 6; ++k) a[k] = cacc[6 * parent[body] + k];
    for (int d = body_dofadr[body]; d < body_dofadr[body] + body_dofnum[body];
         ++d)
      for (int k = 0; k < 6; ++k) a[k] += cdofdot[6 * d + k] * qd[d];
    for (int k = 0; k < 6; ++k) cacc[6 * body + k] = a[k];
  }
  for (int body = 0; body < nb; ++body) {
    float f[6], iv[6], fc[6];
    i66_vec(cinr + 36 * body, cacc + 6 * body, f);
    i66_vec(cinr + 36 * body, cvel + 6 * body, iv);
    frc_cross(cvel + 6 * body, iv, fc);
    for (int k = 0; k < 6; ++k) S[6 * body + k] = f[k] + fc[k];
  }
  for (int oi = D.norder - 1; oi >= 0; --oi) {
    const int body = order[oi];
    const int p = parent[body];
    for (int k = 0; k < 6; ++k) S[6 * p + k] += S[6 * body + k];
  }
  for (int i = 0; i < nv; ++i) {
    float v = 0.f;
    for (int k = 0; k < 6; ++k) v += cdof[6 * i + k] * S[6 * dof_body[i] + k];
    qbias[i] = v;
  }
}

}  // namespace

extern "C" int smooth_launch(const float* qpos, const float* qvel,
                             const int* itab, const float* ftab,
                             const int* dims, float* const* outs,
                             void* stream) {
  Dims D;
  int* dst = reinterpret_cast<int*>(&D);
  for (size_t k = 0; k < sizeof(Dims) / sizeof(int); ++k) dst[k] = dims[k];
  Outs O;
  for (int k = 0; k < kNumOut; ++k) O.p[k] = outs[k];
  if (D.B <= 0) return 0;
  const int threads = 64;
  const int blocks = (D.B + threads - 1) / threads;
  smooth_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, itab, ftab, D, O);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smooth_dims_count() {
  return static_cast<int>(sizeof(Dims) / sizeof(int));
}

extern "C" const char* smooth_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
