// The inverse of a small square float32 matrix in one thread's registers:
// the device form of core/numerics.py:inv, shared by pose_inv
// (numerics.cu) and the raycast's splat bounds (raycast.cu), which inverts
// its view inside its own launch.  The same code built with the same flags
// (--fmad=false) gives the same bits in both.
//
// The steps, as numerics.inv transcribes them from the OpenBLAS that XLA's
// CPU jnp.linalg.inv calls (LAPACK's getrf, then getrs on the identity):
// - getrf, left-looking, column by column: the previous pivots applied to
//   the column, its unit-lower triangular solve (each dot product a fmaf
//   chain from 0, from the last term to the first), the column update (a
//   fmaf chain from 0, from the first term), the first largest |pivot|, the
//   row swap of the columns so far, and the column below the pivot scaled
//   by the pivot's reciprocal (when the pivot is neither 0 nor NaN);
// - getrs: the identity's rows permuted by the pivots, then for each column
//   the forward solve (axpys of fmaf, x[k] = fmaf(-x[i], L[k][i], x[k])) and
//   the backward solve (x[i] times the reciprocal of U[i][i], then the same
//   axpys).
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
// product and sum other than the fmaf calls rounds on its own, and / is
// IEEE division.

#pragma once

namespace lu {

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
      for (int k = i - 1; k >= 0; --k) t = fmaf(A[i][k], b[k], t);
      b[i] = b[i] - t;
    }
#pragma unroll
    for (int i = j; i < N; ++i) {
      float t = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) t = fmaf(A[i][k], b[k], t);
      b[i] = b[i] - t;
    }
    // the first largest |pivot| (a NaN never wins)
    int p = j;
    float best = fabsf(b[j]);
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const bool more = fabsf(b[i]) > best;
      best = more ? fabsf(b[i]) : best;
      p = more ? i : p;
    }
    piv[j] = p;
    float pivot = b[j];
#pragma unroll
    for (int i = 0; i < N; ++i) A[i][j] = b[i];
#pragma unroll
    for (int r = j + 1; r < N; ++r) pivot = p == r ? b[r] : pivot;
    if (pivot != 0.0f && pivot == pivot) {
      const float r = 1.0f / pivot;
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
      for (int i = j + 1; i < N; ++i) A[i][j] = A[i][j] * r;
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
      for (int k = i + 1; k < N; ++k) x[k] = fmaf(-x[i], A[k][i], x[k]);
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      x[i] = x[i] * (1.0f / A[i][i]);
#pragma unroll
      for (int k = 0; k < i; ++k) x[k] = fmaf(-x[i], A[k][i], x[k]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) X[i][c] = x[i];
  }
}

}  // namespace lu
