// The inverse of a small square float32 matrix on the card, for Hopper
// (sm_90a): pose_inv.
//
// What it replaces.  core/numerics.py:inv, which computes XLA's CPU
// jnp.linalg.inv (supereight_tpu/pipeline/integration.py:109 and :503, the
// tracking view) on the host: LAPACK's getrf and getrs with an identity
// right-hand side, as the OpenBLAS that the JAX package calls computes them.
// Its host form reads the matrix back from the card; this kernel takes the
// same steps on the card, so the pose's inverse needs no host read.
//
// What bounds it: neither bytes (128) nor operations (about 200) but the
// latency of one dependent chain and the launch.  One thread does
// everything: a second thread would only change the order of the sums,
// and the bits are the point.  So the chain must not go through memory:
// the kernel is a template on n, instantiated for 1..kMaxN and chosen by
// the C entry, and every loop runs over compile-time bounds and is
// unrolled, so that every array index is a constant and the matrix, the
// pivots and the solves live in registers (`-Xptxas -v`: no stack frame,
// no spills).  The row swaps that the pivots pick at run time are
// predicated selects over the rows they may pick (a pivot of column j
// lies in rows j..n-1).  The matrix is read and the inverse written with
// 16-byte accesses where n * n is a multiple of 4 and both are aligned.
// The steps, as numerics.inv transcribes them:
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
// Rounding: the build uses --fmad=false, so every product and sum other
// than the fmaf calls rounds on its own, and / is IEEE division.  The host
// form computes each fmaf in float64 rounded to odd, which rounds as fmaf
// does, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the largest matrix the kernel takes
constexpr int kMaxN = 8;

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

template <int N>
__device__ __forceinline__ void load(const float* __restrict__ m,
                                     float (&A)[N][N], bool vec) {
  if constexpr ((N * N) % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N * N / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(m)[q];
        A[(4 * q) / N][(4 * q) % N] = v.x;
        A[(4 * q + 1) / N][(4 * q + 1) % N] = v.y;
        A[(4 * q + 2) / N][(4 * q + 2) % N] = v.z;
        A[(4 * q + 3) / N][(4 * q + 3) % N] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) A[i][j] = m[i * N + j];
}

template <int N>
__device__ __forceinline__ void store(float* __restrict__ out,
                                      const float (&X)[N][N], bool vec) {
  if constexpr ((N * N) % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N * N / 4; ++q)
        reinterpret_cast<float4*>(out)[q] = make_float4(
            X[(4 * q) / N][(4 * q) % N], X[(4 * q + 1) / N][(4 * q + 1) % N],
            X[(4 * q + 2) / N][(4 * q + 2) % N],
            X[(4 * q + 3) / N][(4 * q + 3) % N]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) out[i * N + j] = X[i][j];
}

template <int N>
__global__ void __launch_bounds__(1)
inverse_kernel(const float* __restrict__ m, float* __restrict__ out) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  float A[N][N];
  int piv[N];
  load<N>(m, A, vec);

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
  float X[N][N];
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
  store<N>(out, X, vec);
}

template <int N>
int launch(const void* m, void* out, void* stream) {
  inverse_kernel<N><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: [n, n] row-major float32 on the device, 1 <= n <= kMaxN; out
// must not overlap m.
extern "C" int pose_inv(const void* m, void* out, int n, void* stream) {
  switch (n) {
    case 1: return launch<1>(m, out, stream);
    case 2: return launch<2>(m, out, stream);
    case 3: return launch<3>(m, out, stream);
    case 4: return launch<4>(m, out, stream);
    case 5: return launch<5>(m, out, stream);
    case 6: return launch<6>(m, out, stream);
    case 7: return launch<7>(m, out, stream);
    case 8: return launch<8>(m, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
