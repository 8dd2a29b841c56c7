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
// lu_inverse.cuh's template on n (shared with the raycast's splat bounds)
// keeps the matrix, the pivots and the solves in registers, and the kernel
// is instantiated at the sizes where the steps are XLA's, n = 1, 2 and 4,
// chosen by the C entry (another n is refused).  The matrix is read and
// the inverse written with 16-byte accesses where n * n is a multiple of 4
// and both are aligned.  The host form computes each fmaf in float64
// rounded to odd, which rounds as fmaf does, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lu_inverse.cuh"

namespace {

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
  float A[N][N], X[N][N];
  load<N>(m, A, vec);
  lu::lu_inverse<N>(A, X);
  store<N>(out, X, vec);
}

template <int N>
int launch(const void* m, void* out, void* stream) {
  inverse_kernel<N><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: [n, n] row-major float32 on the device, n = 1, 2 or 4; out
// must not overlap m.
extern "C" int pose_inv(const void* m, void* out, int n, void* stream) {
  switch (n) {
    case 1: return launch<1>(m, out, stream);
    case 2: return launch<2>(m, out, stream);
    case 4: return launch<4>(m, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
