// One ICP trip of a pyramid level on the card, for Hopper (sm_90a):
// icp_track_reduce (association, residuals, IRLS weights and the normal
// equations' sums) and icp_update (the solve and the pose update).
//
// What they replace.  No Pallas kernel: together they are the body of the
// JAX package's per-level `lax.while_loop`,
// supereight_tpu/pipeline/tracking.py:_level_loop (`body`, :235-258), which
// XLA fused on the TPU, with the loop's carry (pose, error2, count,
// converged, iteration) on the device.  icp_track_reduce is `_project`,
// `_gather_ref` (nearest or bilinear), `rotate_vectors`, `_residuals` (plain,
// symmetric or gated symmetric) and `reduce_kernel` (none, Huber or Tukey
// weights); icp_update is `solve_normal_equations`, `se3_exp`, the pose
// product and the convergence test.  The plain PyTorch twins are
// supereight_tpu_torch/ops/icp_kernel.py's, which run the port's own
// pipeline/tracking.py functions.
//
// The loop.  The host queues every trip of a level (n_iters of them) and
// never reads the carry back: once `converged` is set or `iteration` has
// reached n_iters, both kernels return at once and write nothing, so the
// carry and the status image stay those of the last trip that ran, as
// `lax.while_loop` leaves them.  Sharded, one all_reduce of the sums runs
// between the two kernels on the device tensor.
//
// What bounds them on the H100.  At the headline's level 0 the work is the
// 160x120 pixels of the decimated 320x240 level, gathering from the 320x240
// reference maps: at most 19200 x 24 bytes of input maps, the reference rows
// they reach (at most 1.8 MB, less where pixels land on the same rows), the
// 77 kB status image and 116 bytes of sums, about 1-1.5 MB: under half a
// microsecond at 3.35 TB/s, and about 250 float operations a pixel, under
// 0.1 us at 67 TFLOP/s.  icp_update moves 200 bytes and does about 400
// dependent float operations on one thread.  So the launch floor (~5 us)
// binds both, not bytes or operations.  What the design does about that:
// - One launch a kernel a trip, two a trip in all: association, residuals,
//   weights and the 29 sums of a pixel are one thread's registers, and the
//   sums never leave the chip but as one partial a CTA.
// - The cross-CTA sum is in the same launch: each CTA writes its partial,
//   __threadfence, and the CTA that draws the last ticket sums the partials
//   in a fixed order and resets the ticket, so no second launch and no
//   atomics on the sums (which would also make them vary run to run).
// - The strided finest level and a rank's row strip are read in place
//   through a base pointer and row / column strides: no copy of the level.
// - The solve, the exponential and the pose product run on one thread of
//   one warp: 6x6 and 4x4 are too small to split, and a second kernel keeps
//   the all_reduce of the sharded frame between the two.
//
// Rounding.  Built with --fmad=false and IEEE division and square root; the
// projections, norms and cross products are explicit fmaf chains in the
// order the twins' `numerics.matvec`, `preprocessing.norm` and
// `preprocessing.cross` use, so the status image equals the twin's bit for
// bit.  The sums add in another order than PyTorch's reductions (warp
// shuffles, then CTA partials in order), within float32 rounding of the
// twin's; the 6x6 Cholesky is a plain left-looking one in float32, within
// float32 rounding of torch.linalg's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // pixels a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;              // error2, JTe[6], JTJ[21], count
constexpr float kInvalid = -2.0f;      // the invalid-normal marker
constexpr unsigned kFull = 0xffffffffu;

// row r of T[:3, :3] @ p + T[:3, 3], a multiply-add chain (numerics.matvec)
__device__ __forceinline__ float affine_row(const float* T, int r, float x,
                                            float y, float z) {
  float a = T[4 * r] * x;
  a = fmaf(T[4 * r + 1], y, a);
  a = fmaf(T[4 * r + 2], z, a);
  return a + T[4 * r + 3];
}

__device__ __forceinline__ float linear_row(const float* T, int r, float x,
                                            float y, float z) {
  float a = T[4 * r] * x;
  a = fmaf(T[4 * r + 1], y, a);
  return fmaf(T[4 * r + 2], z, a);
}

// preprocessing.norm: a multiply-add chain, then a correctly rounded root
__device__ __forceinline__ float norm3(float a, float b, float c) {
  float s = a * a;
  s = fmaf(b, b, s);
  s = fmaf(c, c, s);
  return __fsqrt_rn(s);
}

// torch.clamp(v, 0, 1): NaN stays NaN
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// numerics.trunc_i32(v).clamp(0, hi) of an integral or any float: NaN -> 0
__device__ __forceinline__ int index_of(float v, int hi) {
  return __float2int_rz(fminf(fmaxf(v, 0.0f), static_cast<float>(hi)));
}

struct Level {
  const float* in_vertex;
  const float* in_normal;
  long long row_stride, col_stride;    // floats
  int rows, cols;
  const float* ref_vertex;
  const float* ref_normal;
  int rH, rW;
};

struct Knobs {
  int symmetric;                       // 0 off, 1 on, 2 the gate's value
  const uint8_t* gate;
  int robust;                          // 0 none, 1 Huber, 2 Tukey
  float delta, tukey_inv;              // float32 delta and 1 / delta
  int bilinear;
  float dist_threshold, normal_threshold;
};

// The 29 terms of pixel p (zeros where it is not ok) and its status.
__device__ int pixel_terms(const Level& L, const Knobs& k, const float* T,
                           const float* view, int p, float v[kSums]) {
  const int r = p / L.cols, c = p - r * L.cols;
  const long long off = r * L.row_stride + c * L.col_stride;
  const float* iv = L.in_vertex + off;
  const float* in = L.in_normal + off;

  // _project
  float pv[3], pp[3];
  for (int i = 0; i < 3; ++i) pv[i] = affine_row(T, i, iv[0], iv[1], iv[2]);
  for (int i = 0; i < 3; ++i)
    pp[i] = affine_row(view, i, pv[0], pv[1], pv[2]);
  const float zs = pp[2] == 0.0f ? 1.0f : pp[2];
  const float px = __fdiv_rn(pp[0], zs) + 0.5f;
  const float py = __fdiv_rn(pp[1], zs) + 0.5f;
  const bool in_frame = px >= 0.0f && px <= static_cast<float>(L.rW - 1) &&
                        py >= 0.0f && py <= static_cast<float>(L.rH - 1);
  const bool no_in_normal = in[0] == kInvalid;

  // _gather_ref
  float rv[3], rn[3];
  if (!k.bilinear) {
    const long long q = static_cast<long long>(index_of(py, L.rH - 1)) * L.rW
                        + index_of(px, L.rW - 1);
    for (int i = 0; i < 3; ++i) {
      rv[i] = L.ref_vertex[3 * q + i];
      rn[i] = L.ref_normal[3 * q + i];
    }
  } else {
    const float pxc = px - 0.5f, pyc = py - 0.5f;
    const int x0 = index_of(floorf(pxc), L.rW - 1);
    const int y0 = index_of(floorf(pyc), L.rH - 1);
    const int x1 = min(x0 + 1, L.rW - 1), y1 = min(y0 + 1, L.rH - 1);
    const float wx = clamp01(pxc - static_cast<float>(x0));
    const float wy = clamp01(pyc - static_cast<float>(y0));
    const float ux = 1.0f - wx, uy = 1.0f - wy;
    const long long q[4] = {static_cast<long long>(y0) * L.rW + x0,
                            static_cast<long long>(y0) * L.rW + x1,
                            static_cast<long long>(y1) * L.rW + x0,
                            static_cast<long long>(y1) * L.rW + x1};
    float t[4][6];
    for (int j = 0; j < 4; ++j)
      for (int i = 0; i < 3; ++i) {
        t[j][i] = L.ref_vertex[3 * q[j] + i];
        t[j][3 + i] = L.ref_normal[3 * q[j] + i];
      }
    float b[6];
    for (int i = 0; i < 6; ++i) {
      // the four-term blend as XLA contracts it
      float s = fmaf(t[0][i] * ux, uy, (t[1][i] * wx) * uy);
      s = fmaf(t[2][i] * ux, wy, s);
      b[i] = fmaf(t[3][i] * wx, wy, s);
    }
    const float nn = norm3(b[3], b[4], b[5]);
    const float d = nn == 0.0f ? 1.0f : nn;
    for (int i = 3; i < 6; ++i) b[i] = __fdiv_rn(b[i], d);
    const bool valid4 = t[0][3] != kInvalid && t[1][3] != kInvalid &&
                        t[2][3] != kInvalid && t[3][3] != kInvalid;
    // >= : the int cast of px (= pxc + 0.5) rounds half up
    const bool right = wx >= 0.5f, down = wy >= 0.5f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float nearest = down ? (right ? t[3][i] : t[2][i])
                                 : (right ? t[1][i] : t[0][i]);
      const float pick = valid4 ? b[i] : nearest;
      if (i < 3) rv[i] = pick; else rn[i - 3] = pick;
    }
  }

  // rotate_vectors, _residuals
  float pn[3];
  for (int i = 0; i < 3; ++i) pn[i] = linear_row(T, i, in[0], in[1], in[2]);
  const bool no_ref_normal = rn[0] == kInvalid;
  float diff[3];
  for (int i = 0; i < 3; ++i) diff[i] = rv[i] - pv[i];
  const bool too_far = norm3(diff[0], diff[1], diff[2]) > k.dist_threshold;
  float dot = pn[0] * rn[0];
  dot = dot + pn[1] * rn[1];
  dot = dot + pn[2] * rn[2];
  const bool bad_normal = dot < k.normal_threshold;
  const int status = no_in_normal ? -1 : !in_frame ? -2 : no_ref_normal ? -3
                     : too_far ? -4 : bad_normal ? -5 : 1;

  const bool sym = k.symmetric == 2 ? *k.gate != 0 : k.symmetric == 1;
  float nc[3] = {rn[0], rn[1], rn[2]};
  if (sym) {
    float ns[3];
    for (int i = 0; i < 3; ++i) ns[i] = rn[i] + pn[i];
    const float nn = norm3(ns[0], ns[1], ns[2]);
    const float d = nn == 0.0f ? 1.0f : nn;
    for (int i = 0; i < 3; ++i) nc[i] = __fdiv_rn(ns[i], d);
  }
  const bool ok = status == 1;
  float e = nc[0] * diff[0];
  e = e + nc[1] * diff[1];
  e = e + nc[2] * diff[2];
  float J[6] = {nc[0], nc[1], nc[2],
                fmaf(pv[1], nc[2], -(pv[2] * nc[1])),
                fmaf(pv[2], nc[0], -(pv[0] * nc[2])),
                fmaf(pv[0], nc[1], -(pv[1] * nc[0]))};
  if (!ok) {
    e = 0.0f;
    for (int i = 0; i < 6; ++i) J[i] = 0.0f;
  }

  // robust_weights, reduce_kernel's per-pixel terms
  const float okf = ok ? 1.0f : 0.0f;
  float w = okf;
  if (k.robust == 1) {
    const float ae = fabsf(e);
    const float m = isnan(ae) ? ae : fmaxf(ae, 1e-12f);
    w = okf * (ae > k.delta ? __fdiv_rn(k.delta, m) : 1.0f);
  } else if (k.robust == 2) {
    const float rr = e * k.tukey_inv;
    const float r2 = rr * rr;
    w = okf * (r2 < 1.0f ? (1.0f - r2) * (1.0f - r2) : 0.0f);
  }
  v[0] = (okf * e) * e;
  const float we = w * e;
#pragma unroll
  for (int i = 0; i < 6; ++i) v[1 + i] = we * J[i];
  int n = 7;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) v[n++] = (w * J[b]) * J[a];
  v[kSums - 1] = okf;
  return status;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
  return x;
}

__global__ void __launch_bounds__(kThreads)
icp_track_reduce_kernel(Level L, Knobs k, const float* __restrict__ view,
                        const float* __restrict__ pose,
                        const uint8_t* __restrict__ converged,
                        const int* __restrict__ iteration, int n_iters,
                        int* __restrict__ result, float* partials,
                        unsigned int* ticket, float* __restrict__ sums) {
  // the level has ended: leave the status image and the sums as they are
  if (*converged || *iteration >= n_iters) return;
  __shared__ float T[16], V[16];
  __shared__ float warp_part[kWarps][kSums];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 16) {
    T[tid] = pose[tid];
    V[tid] = view[tid];
  }
  __syncthreads();

  const int n_px = L.rows * L.cols;
  const int p = blockIdx.x * kThreads + tid;
  float v[kSums];
  if (p < n_px) {
    result[p] = pixel_terms(L, k, T, V, p, v);
  } else {
#pragma unroll
    for (int i = 0; i < kSums; ++i) v[i] = 0.0f;
  }

  // this CTA's partial: warp trees, then the warps in order
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) warp_part[warp][i] = s;
  }
  __syncthreads();
  if (tid < kSums) {
    float s = warp_part[0][tid];
    for (int w = 1; w < kWarps; ++w) s += warp_part[w][tid];
    partials[blockIdx.x * kSums + tid] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last CTA: each warp sums its values over the CTAs in a fixed order
  const int n_blocks = gridDim.x;
  for (int i = warp; i < kSums; i += kWarps) {
    float s = 0.0f;
    for (int b = lane; b < n_blocks; b += 32)
      s += __ldcg(partials + b * kSums + i);
    s = warp_sum(s);
    if (lane == 0) sums[i] = s;
  }
  if (tid == 0) *ticket = 0u;
}

__global__ void icp_update_kernel(const float* __restrict__ sums,
                                  float* __restrict__ pose,
                                  float* __restrict__ error2,
                                  float* __restrict__ count,
                                  uint8_t* __restrict__ converged,
                                  int* __restrict__ iteration, int n_iters,
                                  float icp_threshold, float* twist) {
  if (threadIdx.x != 0 || *converged || *iteration >= n_iters) return;

  // JTJ made symmetric from its 21 sums (a <= b, row by row)
  float M[6][6], g[6];
  int n = 7;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) M[a][b] = M[b][a] = sums[n++];
  for (int i = 0; i < 6; ++i) g[i] = sums[1 + i];

  // Cholesky M = L L^T, then L y = g and L^T x = y
  float L[6][6];
  bool bad = false;
  for (int j = 0; j < 6; ++j) {
    float s = M[j][j];
    for (int q = 0; q < j; ++q) s = fmaf(-L[j][q], L[j][q], s);
    bad = bad || !(s > 0.0f);
    const float d = __fsqrt_rn(s);
    L[j][j] = d;
    for (int i = j + 1; i < 6; ++i) {
      float t = M[i][j];
      for (int q = 0; q < j; ++q) t = fmaf(-L[i][q], L[j][q], t);
      L[i][j] = __fdiv_rn(t, d);
    }
  }
  float x[6];
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
    for (int q = 0; q < i; ++q) t = fmaf(-L[i][q], x[q], t);
    x[i] = __fdiv_rn(t, L[i][i]);
  }
  for (int i = 5; i >= 0; --i) {
    float t = x[i];
    for (int q = i + 1; q < 6; ++q) t = fmaf(-L[q][i], x[q], t);
    x[i] = __fdiv_rn(t, L[i][i]);
  }
  for (int i = 0; i < 6; ++i) bad = bad || !isfinite(x[i]);
  if (bad)
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;

  // se3_exp(x), with camera.se3_exp's small-angle branches
  const float w0 = x[3], w1 = x[4], w2 = x[5];
  const float theta2 = fmaf(w2, w2, fmaf(w1, w1, w0 * w0));
  const float theta = __fsqrt_rn(theta2);
  const bool small = theta < 1e-6f;
  const float a = small ? 1.0f - theta2 / 6.0f : __fdiv_rn(sinf(theta), theta);
  const float b = small ? 0.5f - theta2 / 24.0f
                        : __fdiv_rn(1.0f - cosf(theta), theta2);
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : __fdiv_rn(theta - sinf(theta), theta2 * theta);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      float W2 = W[i][0] * W[0][j];
      W2 = fmaf(W[i][1], W[1][j], W2);
      W2 = fmaf(W[i][2], W[2][j], W2);
      const float id = i == j ? 1.0f : 0.0f;
      E[i][j] = (id + a * W[i][j]) + b * W2;
      t = fmaf((id + b * W[i][j]) + c * W2, x[j], t);
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;

  // pose = exp(x) @ pose
  float P[16], out[16];
  for (int i = 0; i < 16; ++i) P[i] = pose[i];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float t = E[i][0] * P[j];
      for (int q = 1; q < 4; ++q) t = fmaf(E[i][q], P[4 * q + j], t);
      out[4 * i + j] = t;
    }
  for (int i = 0; i < 16; ++i) pose[i] = out[i];

  float xx = x[0] * x[0];
  for (int i = 1; i < 6; ++i) xx = fmaf(x[i], x[i], xx);
  *converged = __fsqrt_rn(xx) < icp_threshold;
  *iteration += 1;
  *error2 = sums[0];
  *count = sums[kSums - 1];
  if (twist != nullptr)
    for (int i = 0; i < 6; ++i) twist[i] = x[i];
}

}  // namespace

extern "C" {

// The CTAs kernel A needs for n_px pixels (the partials' rows).
int icp_track_reduce_blocks(int n_px) {
  return (n_px + kThreads - 1) / kThreads;
}

int icp_track_reduce(const float* in_vertex, const float* in_normal,
                     long long row_stride, long long col_stride, int rows,
                     int cols, const float* ref_vertex,
                     const float* ref_normal, int rH, int rW,
                     const float* view, const float* pose,
                     const uint8_t* converged, const int* iteration,
                     int n_iters, int symmetric, const uint8_t* gate,
                     int robust, float delta, float tukey_inv, int bilinear,
                     float dist_threshold, float normal_threshold,
                     int* result, float* partials, unsigned int* ticket,
                     float* sums, cudaStream_t stream) {
  const int n_px = rows * cols;
  if (n_px <= 0) return 0;
  Level L{in_vertex, in_normal, row_stride, col_stride, rows, cols,
          ref_vertex, ref_normal, rH, rW};
  Knobs k{symmetric, gate, robust, delta, tukey_inv, bilinear,
          dist_threshold, normal_threshold};
  icp_track_reduce_kernel<<<icp_track_reduce_blocks(n_px), kThreads, 0,
                            stream>>>(L, k, view, pose, converged, iteration,
                                      n_iters, result, partials, ticket,
                                      sums);
  return static_cast<int>(cudaGetLastError());
}

int icp_update(const float* sums, float* pose, float* error2, float* count,
               uint8_t* converged, int* iteration, int n_iters,
               float icp_threshold, float* twist, cudaStream_t stream) {
  icp_update_kernel<<<1, 32, 0, stream>>>(sums, pose, error2, count,
                                          converged, iteration, n_iters,
                                          icp_threshold, twist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
