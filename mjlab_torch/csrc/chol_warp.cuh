// One warp factors a small SPD matrix and solves one right-hand side with it.
//
// Shared by K1 (pd_solve.cu) and K2 (newton.cu), which differ only in the
// pivot rule they hand in. The matrix is the lower triangle of an
// (n+1)-row matrix in shared memory, row after row, each row padded to a
// multiple of 4 floats so that it starts on 16 bytes (row_off(i)). Rows
// 0..n-1 are A, and row n holds the right-hand side b in its first n slots.
// Carrying b as one more row folds the forward solve into the
// factorization: when column c completes, slot c of row n is y_c of
// L y = b. The caller zeroes every pad slot and the rows n+1 .. up to the
// next multiple of 4, which the last block of columns reads.
//
// Lane l owns rows l, l + 32, ... (at most ROWS of them; n + 1 <= 32 * ROWS).
// What bounds the routine is the chain of dependent steps from column to
// column, not the arithmetic (one warp, a few thousand FMAs), so it trades
// arithmetic for a shorter chain. Columns go four at a time, left-looking:
// for the block c..c+3 every lane owning a row i >= c accumulates the four
// sums A[i][c+j] - sum_k L[i][k] L[c+j][k] in registers, reading 16 bytes of
// its own row and of rows c..c+3 at a time; the latter are the same address
// for the whole warp (broadcasts). The ten sums among rows c..c+3 come by
// shuffle from the four lanes that own those rows, and every lane factors
// the 4x4 diagonal block from them for itself, so the pivots and
// multipliers of four columns cost one round of exchange. A column is scaled by rsqrtf(pivot), and that reciprocal also sits
// on the diagonal of L, so neither solve divides. L overwrites A in place.
// The back solve L^T x = y keeps y in registers and goes four columns at a
// time too: four shuffles fetch the block's y, every lane solves the 4x4
// triangle for itself, and the lanes i < c subtract the block's columns,
// contiguous reads of rows c..c+3. The only synchronization is
// __syncwarp(). Rows are picked by comparing on the lane, never by indexing
// a per-lane array with a loop variable, which would move the array from
// registers to local memory.

#pragma once

namespace chol_warp {

constexpr int kMaxRows = 11;      // rows per lane of the general variant
constexpr int kMaxN = 32 * kMaxRows - 1;  // largest n it takes

// offset of row i: rows 0..i-1, each rounded up to 4 floats
__host__ __device__ __forceinline__ int row_off(int i) {
  const int m = i >> 2, r = i & 3;
  return 4 * (m + 1) * (2 * m + r);
}

// slots of row i, pad included
__host__ __device__ __forceinline__ int row_len(int i) {
  return (i + 4) & ~3;
}

// rows of the triangle of an n x n system: A, the right-hand side, and
// zero rows up to a multiple of 4
__host__ __device__ __forceinline__ int padded_rows(int n) {
  return (n + 4) & ~3;
}

// floats of shared memory for an n x n system and its right-hand side
__host__ __device__ __forceinline__ size_t packed_floats(int n) {
  return static_cast<size_t>(row_off(padded_rows(n)));
}

// K1's pivot: the column value clamped from below.
struct PivotClamp {
  __device__ __forceinline__ float operator()(float c) const {
    return fmaxf(c, 1e-12f);
  }
};

// K2's pivot: a 1e-12 ridge on the diagonal, then the clamp.
struct PivotRidge {
  __device__ __forceinline__ float operator()(float c) const {
    return fmaxf(c + 1e-12f, 1e-12f);
  }
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Called by all 32 lanes of one warp. A: the padded triangle in shared
// memory as above, 16-byte aligned, overwritten by L (reciprocals on the
// diagonal) and y. x: n floats (shared or global), written by the owning
// lanes. pivot(col) is the value whose square root is the diagonal of L.
template <int ROWS, class Pivot>
__device__ __forceinline__ void factor_solve(float* A, int n, float* x,
                                             Pivot pivot) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  auto vec = [](const float* p) {
    return *reinterpret_cast<const float4*>(p);
  };

  for (int c = 0; c < n; c += 4) {
    const float* R0 = A + row_off(c);
    const float* R1 = A + row_off(c + 1);
    const float* R2 = A + row_off(c + 2);
    const float* R3 = A + row_off(c + 3);
    const float* rp[ROWS];  // this lane's rows; row c where it has none
    float4 own[ROWS];
    float d0[ROWS], d1[ROWS], d2[ROWS], d3[ROWS];
    bool on[ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      on[s] = (i >= c) && (i <= n);
      rp[s] = on[s] ? A + row_off(i) : R0;
      own[s] = vec(rp[s] + c);
      d0[s] = d1[s] = d2[s] = d3[s] = 0.f;
    }
    const float4 a0 = vec(R0 + c), a1 = vec(R1 + c), a2 = vec(R2 + c),
                 a3 = vec(R3 + c);  // the diagonal block of A
    for (int k = 0; k < c; k += 4) {
      const float4 b0 = vec(R0 + k), b1 = vec(R1 + k), b2 = vec(R2 + k),
                   b3 = vec(R3 + k);
#pragma unroll
      for (int s = 0; s < ROWS; ++s) {
        const float4 a = vec(rp[s] + k);
        d0[s] += dot4(a, b0); d1[s] += dot4(a, b1);
        d2[s] += dot4(a, b2); d3[s] += dot4(a, b3);
      }
    }
    // the ten sums among rows c..c+3 are the sums of the four lanes that
    // own these rows (consecutive lanes, c is a multiple of 4): fetch them
    float e0 = 0.f, e1 = 0.f, e2 = 0.f, e3 = 0.f;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const bool mine = static_cast<unsigned>(lane + 32 * s - c) < 4u;
      e0 = mine ? d0[s] : e0; e1 = mine ? d1[s] : e1;
      e2 = mine ? d2[s] : e2; e3 = mine ? d3[s] : e3;
    }
    const int o = c & 31;
    const float s00 = __shfl_sync(kFull, e0, o);
    const float s10 = __shfl_sync(kFull, e0, o + 1);
    const float s11 = __shfl_sync(kFull, e1, o + 1);
    const float s20 = __shfl_sync(kFull, e0, o + 2);
    const float s21 = __shfl_sync(kFull, e1, o + 2);
    const float s22 = __shfl_sync(kFull, e2, o + 2);
    const float s30 = __shfl_sync(kFull, e0, o + 3);
    const float s31 = __shfl_sync(kFull, e1, o + 3);
    const float s32 = __shfl_sync(kFull, e2, o + 3);
    const float s33 = __shfl_sync(kFull, e3, o + 3);
    // the 4x4 diagonal block, in every lane; a column past n scales by 0
    const float i0 = rsqrtf(pivot(a0.x - s00));
    const float l10 = (a1.x - s10) * i0, l20 = (a2.x - s20) * i0,
                l30 = (a3.x - s30) * i0;
    const float i1 =
        (c + 1 < n) ? rsqrtf(pivot(a1.y - s11 - l10 * l10)) : 0.f;
    const float l21 = (a2.y - s21 - l20 * l10) * i1,
                l31 = (a3.y - s31 - l30 * l10) * i1;
    const float i2 =
        (c + 2 < n) ? rsqrtf(pivot(a2.z - s22 - l20 * l20 - l21 * l21)) : 0.f;
    const float l32 = (a3.z - s32 - l30 * l20 - l31 * l21) * i2;
    const float i3 =
        (c + 3 < n)
            ? rsqrtf(pivot(a3.w - s33 - l30 * l30 - l31 * l31 - l32 * l32))
            : 0.f;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int j = lane + 32 * s - c;  // 0..3 inside the diagonal block
      float4 v;
      v.x = (own[s].x - d0[s]) * i0;
      v.y = (own[s].y - d1[s] - v.x * l10) * i1;
      v.z = (own[s].z - d2[s] - v.x * l20 - v.y * l21) * i2;
      v.w = (own[s].w - d3[s] - v.x * l30 - v.y * l31 - v.z * l32) * i3;
      // a row of the block: the reciprocal on its diagonal, zeros after it
      v.x = (j == 0) ? i0 : v.x;
      v.y = (j == 1) ? i1 : (j < 1) ? 0.f : v.y;
      v.z = (j == 2) ? i2 : (j < 2) ? 0.f : v.z;
      v.w = (j == 3) ? i3 : (j < 3) ? 0.f : v.w;
      if (on[s])
        *reinterpret_cast<float4*>(A + row_off(lane + 32 * s) + c) = v;
    }
    __syncwarp();
  }

  // back solve L^T x = y, y in registers, four columns at a time
  const float* yrow = A + row_off(n);
  float y[ROWS];
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = lane + 32 * s;
    y[s] = (i < n) ? yrow[i] : 0.f;
  }
  for (int c = (n - 1) & ~3; c >= 0; c -= 4) {
    const float* R0 = A + row_off(c);
    const float* R1 = A + row_off(c + 1);
    const float* R2 = A + row_off(c + 2);
    const float* R3 = A + row_off(c + 3);
    const float4 a0 = vec(R0 + c), a1 = vec(R1 + c), a2 = vec(R2 + c),
                 a3 = vec(R3 + c);  // the diagonal block of L
    float l0[ROWS], l1[ROWS], l2[ROWS], l3[ROWS];  // columns c..c+3, rows < c
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int i = lane + 32 * s;
      const bool below = i < c;
      l0[s] = below ? R0[i] : 0.f;
      l1[s] = below ? R1[i] : 0.f;
      l2[s] = below ? R2[i] : 0.f;
      l3[s] = below ? R3[i] : 0.f;
      t0 = (i == c) ? y[s] : t0;  // the owners of rows c..c+3
      t1 = (i == c + 1) ? y[s] : t1;
      t2 = (i == c + 2) ? y[s] : t2;
      t3 = (i == c + 3) ? y[s] : t3;
    }
    t0 = __shfl_sync(kFull, t0, c & 31);
    t1 = __shfl_sync(kFull, t1, (c + 1) & 31);
    t2 = __shfl_sync(kFull, t2, (c + 2) & 31);
    t3 = __shfl_sync(kFull, t3, (c + 3) & 31);
    // a column past n has a zero on the diagonal, so its x is zero
    const float x3 = t3 * a3.w;
    const float x2 = (t2 - a3.z * x3) * a2.z;
    const float x1 = (t1 - a2.y * x2 - a3.y * x3) * a1.y;
    const float x0 = (t0 - a1.x * x1 - a2.x * x2 - a3.x * x3) * a0.x;
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      const int j = lane + 32 * s - c;
      y[s] -= l0[s] * x0 + l1[s] * x1 + l2[s] * x2 + l3[s] * x3;
      y[s] = (j == 0) ? x0 : (j == 1) ? x1 : (j == 2) ? x2 : (j == 3) ? x3
                                                                      : y[s];
    }
  }
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
    const int i = lane + 32 * s;
    if (i < n) x[i] = y[s];
  }
}

}  // namespace chol_warp
