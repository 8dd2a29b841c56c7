// The inverse of a small square float32 matrix in one thread's registers:
// the device form of core/numerics.py:inv, shared by pose_inv
// (numerics.cu), the raycast's splat bounds (raycast.cu), which inverts its
// view inside its own launch, and the fusion's frustum selection
// (integrate.cu), which inverts the pose inside its own.  The same code
// built with the same flags (--fmad=false) gives the same bits in all.
//
// The steps, as numerics.inv transcribes them from the OpenBLAS that XLA's
// CPU jnp.linalg.inv calls (LAPACK's getrf, then getrs on the identity):
// - getrf, left-looking, column by column: the previous pivots applied to
//   the column, its unit-lower triangular solve (each dot product a fmaf
//   chain from 0, from the last term to the first), the column update (a
//   fmaf chain from 0, from the first term), the pivot as OpenBLAS's isamax
//   picks it (the first largest |pivot|, but for a NaN: see max_sse), the
//   row swap of the columns so far, and the column below the pivot scaled
//   by the pivot's reciprocal (when the pivot is neither 0 nor NaN);
// - getrs: the identity's rows permuted by the pivots, then for each column
//   the forward solve (axpys of fmaf, x[k] = fmaf(-x[i], L[k][i], x[k])) and
//   the backward solve (x[i] times the reciprocal of U[i][i], then the same
//   axpys).
// XLA runs its CPU code with flush-to-zero and denormals-are-zero set, so
// every operation reads a subnormal operand as a signed zero and flushes a
// subnormal result to one: the .ftz forms of PTX's fma, mul, sub and div,
// and the flushed value in the pivot's comparisons (a subnormal pivot is a
// zero pivot).  Two more of OpenBLAS's rules: a zero result of the
// triangular solve's dot product is +0 (its sum over vector lanes), and a
// column scaled by a reciprocal of 0 (a huge or infinite pivot) is set to 0,
// as BLAS scal by 0 does.
// These are XLA's bits at 1, 2 and 4 rows only: at 3 and above 4 rows
// OpenBLAS's triangular solve takes the rows in blocks of 1, 2 and 4 with a
// rounded product between blocks.  So lu_inverse is instantiated at those
// three sizes only (core/numerics.py INV_SIZES).
//
// Every loop runs over compile-time bounds and is unrolled, so that every
// array index is a constant and the matrix, the pivots and the solves live
// in registers (`-Xptxas -v`: no stack frame, no spills).  The row swaps
// that the pivots pick at run time are predicated selects over the rows
// they may pick (a pivot of column j lies in rows j..n-1).  Rounding: every
// product, sum and quotient rounds on its own (IEEE division) but the
// multiply-adds, which round once.

#pragma once

#include <float.h>

namespace lu {

// the flush-to-zero forms: subnormal operands and results as signed zeros
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float d;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(d) : "f"(a), "f"(b), "f"(c));
  return d;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float d;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float d;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float div_ftz(float a, float b) {
  float d;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}

// x86's maxss d, s: the second operand where either is NaN
__device__ __forceinline__ float max_sse(float d, float s) {
  return d > s ? d : s;
}

// v[i] and v[piv] swapped (piv >= i) by selects over the rows piv may
// be, so that every index stays a constant.
template <int N, typename T>
__device__ __forceinline__ void swap_rows(T (&v)[N], int i, int piv) {
  const T t = v[i];
#pragma unroll
  for (int r = i + 1; r < N; ++r) {
    const bool s = piv == r;
    v[i] = s ? v[r] : v[i];
    v[r] = s ? t : v[r];
  }
}

// X = inv(A); A is overwritten by its LU factors.
template <int N>
__device__ __forceinline__ void lu_inverse(float (&A)[N][N],
                                           float (&X)[N][N]) {
  static_assert(N == 1 || N == 2 || N == 4,
                "XLA's inverse is transcribed at 1, 2 and 4 rows only");
  int piv[N];

  // getrf
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float b[N];
#pragma unroll
    for (int i = 0; i < N; ++i) b[i] = A[i][j];
#pragma unroll
    for (int i = 0; i < j; ++i) swap_rows<N>(b, i, piv[i]);
#pragma unroll
    for (int i = 1; i < j; ++i) {
      float t = 0.0f;
#pragma unroll
      for (int k = i - 1; k >= 0; --k) t = fma_ftz(A[i][k], b[k], t);
      b[i] = sub_ftz(b[i], __fadd_rn(t, 0.0f));
    }
#pragma unroll
    for (int i = j; i < N; ++i) {
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) t = fma_ftz(A[i][k], b[k], t);
      b[i] = sub_ftz(b[i], t);
    }
    // the pivot as OpenBLAS's isamax picks it (numerics._isamax): the
    // magnitudes in 4 lanes padded with 0, their largest as maxps pairs
    // them (lane 2 with 0, 3 with 1, then the two; the second operand
    // where either is NaN), then the first entry not below that largest
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = j + i < N ? fabsf(flush(b[j + i])) : 0.0f;
    const float m = max_sse(max_sse(v[2], v[0]), max_sse(v[3], v[1]));
    int p = j;
    bool found = false;
#pragma unroll
    for (int i = j; i < N; ++i) {
      const bool hit = !found && !(v[i - j] < m);
      p = hit ? i : p;
      found = found || hit;
    }
    piv[j] = p;
    float pivot = b[j];
#pragma unroll
    for (int i = 0; i < N; ++i) A[i][j] = b[i];
#pragma unroll
    for (int r = j + 1; r < N; ++r) pivot = p == r ? b[r] : pivot;
    pivot = flush(pivot);
    if (pivot != 0.0f && pivot == pivot) {
      const float r = div_ftz(1.0f, pivot);
#pragma unroll
      for (int c = 0; c <= j; ++c) {
        float col[N];
#pragma unroll
        for (int i = 0; i < N; ++i) col[i] = A[i][c];
        swap_rows<N>(col, j, p);
#pragma unroll
        for (int i = j; i < N; ++i) A[i][c] = col[i];
      }
#pragma unroll
      for (int i = j + 1; i < N; ++i)
        A[i][j] = r == 0.0f ? 0.0f : mul_ftz(A[i][j], r);
    }
  }

  // getrs on the identity: row i of the permuted identity is e_perm[i]
  int perm[N];
#pragma unroll
  for (int i = 0; i < N; ++i) perm[i] = i;
#pragma unroll
  for (int i = 0; i < N; ++i) swap_rows<N>(perm, i, piv[i]);
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = perm[i] == c ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = i + 1; k < N; ++k) x[k] = fma_ftz(-x[i], A[k][i], x[k]);
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      x[i] = mul_ftz(x[i], div_ftz(1.0f, A[i][i]));
#pragma unroll
      for (int k = 0; k < i; ++k) x[k] = fma_ftz(-x[i], A[k][i], x[k]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) X[i][c] = x[i];
  }
}

}  // namespace lu
