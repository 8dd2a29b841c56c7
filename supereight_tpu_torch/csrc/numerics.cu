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
// and the bits are the point.  The steps, as numerics.inv transcribes
// them:
// - getrf, left-looking, column by column: the previous pivots applied to
//   the column, its unit-lower triangular solve (each dot product a fmaf
//   chain from 0, from the last term to the first), the column update (a
//   fmaf chain from 0, from the first term), the first largest |pivot|, the
//   row swap of the columns so far, and the column below the pivot scaled
//   by the pivot's reciprocal (when the pivot is not 0);
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

__global__ void __launch_bounds__(1)
inverse_kernel(const float* __restrict__ m, float* __restrict__ out, int n) {
  float A[kMaxN][kMaxN];
  float b[kMaxN];
  int piv[kMaxN];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) A[i][j] = m[i * n + j];

  // getrf
  for (int j = 0; j < n; ++j) {
    for (int i = 0; i < n; ++i) b[i] = A[i][j];
    for (int i = 0; i < j; ++i) {
      const float t = b[i];
      b[i] = b[piv[i]];
      b[piv[i]] = t;
    }
    for (int i = 1; i < j; ++i) {
      float t = 0.0f;
      for (int k = i - 1; k >= 0; --k) t = fmaf(A[i][k], b[k], t);
      b[i] = b[i] - t;
    }
    for (int i = j; i < n; ++i) {
      float t = 0.0f;
      for (int k = 0; k < j; ++k) t = fmaf(A[i][k], b[k], t);
      b[i] = b[i] - t;
    }
    // the first largest |pivot| (a NaN never wins)
    int p = j;
    float best = fabsf(b[j]);
    for (int i = j + 1; i < n; ++i) {
      if (fabsf(b[i]) > best) {
        best = fabsf(b[i]);
        p = i;
      }
    }
    piv[j] = p;
    for (int i = 0; i < n; ++i) A[i][j] = b[i];
    if (A[p][j] != 0.0f) {
      const float r = 1.0f / A[p][j];
      for (int c = 0; c <= j; ++c) {
        const float t = A[j][c];
        A[j][c] = A[p][c];
        A[p][c] = t;
      }
      for (int i = j + 1; i < n; ++i) A[i][j] = A[i][j] * r;
    }
  }

  // getrs on the identity: row i of the permuted identity is e_perm[i]
  int perm[kMaxN];
  for (int i = 0; i < n; ++i) perm[i] = i;
  for (int i = 0; i < n; ++i) {
    const int t = perm[i];
    perm[i] = perm[piv[i]];
    perm[piv[i]] = t;
  }
  for (int c = 0; c < n; ++c) {
    float x[kMaxN];
    for (int i = 0; i < n; ++i) x[i] = perm[i] == c ? 1.0f : 0.0f;
    for (int i = 0; i < n; ++i)
      for (int k = i + 1; k < n; ++k) x[k] = fmaf(-x[i], A[k][i], x[k]);
    for (int i = n - 1; i >= 0; --i) {
      x[i] = x[i] * (1.0f / A[i][i]);
      for (int k = 0; k < i; ++k) x[k] = fmaf(-x[i], A[k][i], x[k]);
    }
    for (int i = 0; i < n; ++i) out[i * n + c] = x[i];
  }
}

}  // namespace

// m, out: [n, n] row-major float32 on the device, 1 <= n <= kMaxN; out
// must not overlap m.
extern "C" int pose_inv(const void* m, void* out, int n, void* stream) {
  if (n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  inverse_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
