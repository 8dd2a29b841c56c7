// ICP tracking on the card, for Hopper (sm_90a).  icp_track_levels runs
// every trip of every pyramid level of a tracked frame in one launch (the
// one-device frame); icp_track_reduce runs one trip of the
// sharded frame, whose sums are all-reduced between trips: the previous trip's
// update (the solve and the pose update), then the association,
// residuals, IRLS weights and the normal equations' sums; icp_update
// applies a level's last update alone.
//
// What they replace.  No Pallas kernel: the JAX package's per-level
// `lax.while_loop`, supereight_tpu/pipeline/tracking.py:_level_loop (`body`,
// :235-258), which XLA fused on the TPU, with the loop's carry (pose,
// error2, count, converged, iteration) on the device, and for
// icp_track_levels also `track`'s loop over the levels (:309-330).  A trip
// is `_project`, `_gather_ref` (nearest or bilinear), `rotate_vectors`,
// `_residuals` (plain, symmetric or gated symmetric) and `reduce_kernel`
// (none, Huber or Tukey weights), then `solve_normal_equations`,
// `se3_exp`, the pose product and the convergence test.  The plain
// PyTorch twins are supereight_tpu_torch/ops/icp_kernel.py's, which run
// the port's own pipeline/tracking.py functions.
//
// The exit.  The sharded frame: the host queues every trip of a level
// (n_iters of them, then one icp_update) and never reads the carry back:
// once `converged` is set or `iteration` has reached n_iters, a launch
// writes nothing, so the carry and the status image stay those of the
// last trip that ran, as `lax.while_loop` leaves them.  icp_track_levels:
// every CTA computes the exit from the same sums, so all leave a level at
// the same trip, and CTA 0 writes the carry at the end.
//
// What bounds them on the H100.  At the headline's level 0 the work is the
// 160x120 pixels of the decimated 320x240 level, gathering from the 320x240
// reference maps: at most 19200 x 24 bytes of input maps, the reference rows
// they reach (at most 1.8 MB, less where pixels land on the same rows), the
// 77 kB status image and 116 bytes of sums, about 1-1.5 MB: under half a
// microsecond at 3.35 TB/s, and about 250 float operations a pixel, under
// 0.1 us at 67 TFLOP/s.  A trip's solve is about 400 dependent float
// operations.  So a launch a trip is bound by the launch floor (~5 us), not
// bytes or operations, and a sharded frame of 19 trips by the host's
// enqueue of its launches; one launch a frame by the chain of its trips,
// each a pixel pass, a cross-CTA exchange and a solve in a row.  What the
// designs do about that:
// - icp_track_levels: one launch a frame, the tracking view K @
//   inv(raycast_pose) computed inside it (lu_inverse.cuh, as pose_inv).  A
//   fixed grid owns fixed pixels of every level and keeps up to kOwn pixels
//   a thread in registers over a level's trips; a warp sums its 29 sums by
//   a reduce-scatter butterfly (31 shuffles, not 29 trees of 5); no grid
//   barrier: the exchange carries the barrier with the data; and every
//   CTA's warp 0 solves, the independent elements of the solve on separate
//   lanes (warp_solve).  The reference maps stay in the 50 MB L2.
// - icp_track_reduce: one launch a trip, the previous trip's solve at its
//   start and the cross-CTA sum at its end in a fixed order (a last-CTA
//   ticket), so no second launch and no atomics on the sums (which would
//   also make them vary run to run).
// - The strided finest level and a rank's row strip are read in place
//   through a base pointer and row / column strides: no copy of the level.
// - icp_track_reduce and icp_update solve on one thread (solve_step);
//   icp_track_levels' warp_solve gives solve_step's bits.
//
// Rounding.  Built with --fmad=false and IEEE division and square root; the
// projections, norms and cross products are explicit fmaf chains in the
// order the twins' `numerics.matvec`, `preprocessing.norm` and
// `preprocessing.cross` use, so the status image of a trip from a given
// pose equals the twin's bit for bit.  The sums add in another order than
// PyTorch's reductions, within float32 rounding of the twin's, and in the
// same order in every run on a given card: a thread's pixels in order, then
// the warp's butterfly (lane l ends with sum l: at each width w = 16, 8, 4,
// 2, 1 the two lanes w apart add the halves they keep and receive), the
// warps in order, then the CTAs' partials in rank order (a fixed grid and
// fixed pixels a CTA).  The 6x6 Cholesky is a plain left-looking one in
// float32, within float32 rounding of torch.linalg's.

#include <cuda_runtime.h>
#include <stddef.h>
#include <math.h>
#include <stdint.h>

#include "lu_inverse.cuh"

namespace {

constexpr int kThreads = 256;          // pixels a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;              // error2, JTe[6], JTJ[21], count
constexpr float kInvalid = -2.0f;      // the invalid-normal marker
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 8;          // pyramid levels icp_track_levels takes
constexpr int kSumSlots = 32;          // the sums padded to a warp's lanes
constexpr int kLevelThreads = 256;     // icp_track_levels' CTAs
constexpr int kLevelWarps = kLevelThreads / 32;

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

struct Levels {
  Level level[kMaxLevels];             // level 0 the finest
  int iters[kMaxLevels];
  int n_levels;
};

struct Knobs {
  int symmetric;                       // 0 off, 1 on, 2 the gate's value
  const uint8_t* gate;
  int robust;                          // 0 none, 1 Huber, 2 Tukey
  float delta, tukey_inv;              // float32 delta and 1 / delta
  int bilinear;
  float dist_threshold, normal_threshold;
};

// Pixel p's input vertex (x[0:3]) and normal (x[3:6]).
__device__ __forceinline__ void load_input(const Level& L, int p,
                                           float x[6]) {
  const int r = p / L.cols, c = p - r * L.cols;
  const long long off = r * L.row_stride + c * L.col_stride;
  for (int i = 0; i < 3; ++i) {
    x[i] = __ldg(L.in_vertex + off + i);
    x[3 + i] = __ldg(L.in_normal + off + i);
  }
}

// The 29 terms of the pixel whose input vertex and normal are x (zeros
// where it is not ok) and its status.
__device__ __forceinline__ int pixel_terms(const Level& L, const Knobs& k,
                                           const float* T, const float* view,
                                           const float x[6],
                                           float v[kSums]) {
  const float* iv = x;
  const float* in = x + 3;

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

// One thread: the twist x of the normal equations in ``sums``, ``pose =
// se3_exp(x) @ pose`` in place, and whether |x| < icp_threshold.
__device__ bool solve_step(const float* sums, float* pose,
                           float icp_threshold, float x[6]) {
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
  return __fsqrt_rn(xx) < icp_threshold;
}

__global__ void icp_update_kernel(const float* __restrict__ sums,
                                  float* __restrict__ pose,
                                  float* __restrict__ error2,
                                  float* __restrict__ count,
                                  uint8_t* __restrict__ converged,
                                  int* __restrict__ iteration, int n_iters,
                                  float icp_threshold, float* twist) {
  if (threadIdx.x != 0 || *converged || *iteration >= n_iters) return;
  float x[6];
  *converged = solve_step(sums, pose, icp_threshold, x);
  *iteration += 1;
  *error2 = sums[0];
  *count = sums[kSums - 1];
  if (twist != nullptr)
    for (int i = 0; i < 6; ++i) twist[i] = x[i];
}

// ---------------------------------------------------------------------
// icp_track_reduce: one trip of the sharded frame, with the previous
// trip's update inside its launch
// ---------------------------------------------------------------------
//
// Trip t's launch (1) applies trip t-1's update from that trip's
// all-reduced sums (`pending`; none at a level's first trip): the same
// solve_step as icp_update_kernel, on one thread of every CTA into the
// CTA's shared copy of the carry, so every CTA holds the same bits; (2)
// runs trip t's pixel pass from that pose (the status image) and (3) sums
// its 29 sums into `sums`, which is never `pending`.  The carry is written
// once, by the CTA that finishes the reduction, after every CTA has read
// the old one.  lax.while_loop's exit: where the pending update sets
// `converged` or takes `iteration` to n_iters, the launch writes the carry
// and skips the pass, leaving the status image and the sums as they were;
// a launch that finds the level ended writes nothing.  After a level's
// last trip icp_update applies that trip's update alone, so a level of n
// trips takes n + 1 launches.
//
// The cross-CTA sum: a CTA of kThreads threads, a pixel each; each CTA
// writes its partial, __threadfence, and the CTA that draws the last ticket
// sums the partials in a fixed order, writes the carry and resets the
// ticket.  (A one-cluster form summing over distributed shared memory was
// slower on an H100: see PERF.md.)

struct Carry {
  float* pose;                         // [4, 4]
  float* error2;
  float* count;
  uint8_t* converged;
  int* iteration;
};

// A trip's carry in shared memory: the pose after the pending update, the
// update's outputs, and what the launch does.
struct TripState {
  float T[16];
  float error2, count;
  int iteration;
  int converged;
  int ran;                             // the level ran at the launch's start
  int pass;                            // this trip's pixel pass runs
  int updated;                         // the pending update was applied
};

// Thread 0: the carry as the launch finds it, then the pending update.
__device__ void trip_start(TripState& S, const Carry& c, int n_iters,
                           float icp_threshold,
                           const float* __restrict__ pending) {
  const bool conv = *c.converged != 0;
  const int it = *c.iteration;
  for (int i = 0; i < 16; ++i) S.T[i] = c.pose[i];
  S.ran = !conv && it < n_iters;
  S.pass = S.ran;
  S.updated = 0;
  if (S.ran && pending != nullptr) {
    float x[6];
    const bool now = solve_step(pending, S.T, icp_threshold, x);
    S.converged = now;
    S.iteration = it + 1;
    S.error2 = pending[0];
    S.count = pending[kSums - 1];
    S.updated = 1;
    S.pass = !now && it + 1 < n_iters;
  }
}

// The CTA that finishes the reduction: the new carry.
__device__ __forceinline__ void write_carry(const TripState& S,
                                            const Carry& c, int tid) {
  if (!S.updated) return;
  if (tid < 16) c.pose[tid] = S.T[tid];
  if (tid == 0) {
    *c.error2 = S.error2;
    *c.count = S.count;
    *c.converged = static_cast<uint8_t>(S.converged);
    *c.iteration = S.iteration;
  }
}

__global__ void __launch_bounds__(kThreads)
icp_track_reduce_kernel(Level L, Knobs k, const float* __restrict__ view,
                        Carry c, int n_iters, float icp_threshold,
                        const float* __restrict__ pending,
                        int* __restrict__ result, float* partials,
                        unsigned int* ticket, float* __restrict__ sums) {
  __shared__ TripState S;
  __shared__ float V[16];
  __shared__ float warp_part[kWarps][kSums];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) trip_start(S, c, n_iters, icp_threshold, pending);
  if (tid >= 32 && tid < 48) V[tid - 32] = view[tid - 32];
  __syncthreads();
  // the level had ended: every CTA leaves, and nothing is written
  if (!S.ran) return;

  if (S.pass) {
    const int n_px = L.rows * L.cols;
    const int p = blockIdx.x * kThreads + tid;
    float v[kSums];
    if (p < n_px) {
      float x[6];
      load_input(L, p, x);
      result[p] = pixel_terms(L, k, S.T, V, x, v);
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
  }
  // every CTA has read the carry (and written its partial) before its
  // ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last CTA: each warp sums its values over the CTAs in a fixed
  // order; the carry
  if (S.pass) {
    const int n_blocks = gridDim.x;
    for (int i = warp; i < kSums; i += kWarps) {
      float s = 0.0f;
      for (int b = lane; b < n_blocks; b += 32)
        s += __ldcg(partials + b * kSums + i);
      s = warp_sum(s);
      if (lane == 0) sums[i] = s;
    }
  }
  write_carry(S, c, tid);
  if (tid == 0) *ticket = 0u;
}

// ---------------------------------------------------------------------
// icp_track_levels: every level's loop of a tracked frame in one launch
// ---------------------------------------------------------------------
//
// A cooperative grid of the CTAs that own pixels at the largest level that
// runs a trip (75 of 256 threads at the headline's decimated 160x120), all
// resident.  A CTA owns the pixels blockIdx.x * kLevelThreads + tid + j *
// (gridDim.x * kLevelThreads) of each level and keeps the first kOwn of a
// thread's in registers for the level's trips.  A trip: the pixel pass,
// each warp's 29 sums by a reduce-scatter butterfly (warp_reduce_scatter),
// the warps' sums in warp order into the CTA's partial, then the exchange
// (level_exchange): no grid barrier, the barrier and the data travel
// together, and every CTA sums every CTA's partial in CTA order, the same
// order in every CTA.  Then warp 0 of every CTA solves (warp_solve) into
// its own shared copy of the carry, so every CTA holds the same bits and
// takes the same exit, and no second barrier is needed.  (A one-cluster
// form, 16 CTAs of 512 threads reading the partials over distributed
// shared memory after a cluster barrier, was slower on an H100: see
// PERF.md.)

// The index in the sums of JTJ's entry (a, b), a <= b (row by row).
__host__ __device__ constexpr int jtj_index(int a, int b) {
  return 7 + a * 6 - a * (a - 1) / 2 + (b - a);
}

// One step of the warp's reduce-scatter butterfly at width w: a lane keeps
// the half of its 2w-wide window that its bit w names, sends the other half
// to the lane w away and adds what it receives (keep + received).
template <int w>
__device__ __forceinline__ void butterfly(float (&v)[kSumSlots], int lane) {
  const bool up = (lane & w) != 0;
#pragma unroll
  for (int i = 0; i < w; ++i) {
    const float send = up ? v[i] : v[i + w];
    const float keep = up ? v[i + w] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, w);
  }
}

// The warp's sums of v (the 29 sums padded to a warp) by a reduce-scatter
// butterfly of widths 16, 8, 4, 2, 1: 31 shuffles.  Lane l ends with the
// sum of v[l] over the warp, in a fixed tree.
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[kSumSlots],
                                                     int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// W = [x]_x of the rotation twist (w0, w1, w2), entry (i, j) by selects
__device__ __forceinline__ float skew(float w0, float w1, float w2, int i,
                                      int j) {
  const float r0 = j == 0 ? 0.0f : j == 1 ? -w2 : w1;
  const float r1 = j == 0 ? w2 : j == 1 ? 0.0f : -w0;
  const float r2 = j == 0 ? -w1 : j == 1 ? w0 : 0.0f;
  return i == 0 ? r0 : i == 1 ? r1 : r2;
}

// solve_step over one warp, with solve_step's bits: every element is the
// same fmaf chain in the same order, and the independent ones run on
// separate lanes.  The sums S (shared, >= 29) in, the pose P (shared [16])
// updated in place; every lane returns |x| < icp_threshold and, where x is
// not null, lane 0 writes the twist.  Every lane computes the Cholesky's
// diagonal and the two triangular solves (serial, the same bits on every
// lane); lane i computes L[i][j] below the diagonal, broadcast by shuffles;
// lane 0 sinf(theta) (once: solve_step computes it twice) and lane 1
// cosf(theta); lane 3i + j E[i][j] and its translation term; lane i E[i][3];
// lane 4i + j the pose product's entry (i, j).
__device__ bool warp_solve(const float* S, float* P, float icp_threshold,
                           int lane, float* x_out) {
  const int r = lane < 6 ? lane : 5;       // this lane's row of L
  // the sums this lane reads, loaded together: JTJ's diagonal, JTe, and
  // column j's entry of row r (M[r][j] = the sums' (j, r))
  float Md[6], Mr[6], g[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    Md[j] = S[jtj_index(j, j)];
    Mr[j] = S[jtj_index(j, r > j ? r : j)];
    g[j] = S[1 + j];
  }
  float L[6][6], R[6];                     // L on every lane, R: row r
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = Md[j];
#pragma unroll
    for (int q = 0; q < j; ++q) s = fmaf(-L[j][q], L[j][q], s);
    bad = bad || !(s > 0.0f);
    const float d = __fsqrt_rn(s);
    L[j][j] = d;
    // lane r > j: L[r][j]; other lanes' values are never read
    float t = Mr[j];
#pragma unroll
    for (int q = 0; q < j; ++q) t = fmaf(-R[q], L[j][q], t);
    R[j] = __fdiv_rn(t, d);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) L[i][j] = __shfl_sync(kFull, R[j], i);
  }
  float x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
#pragma unroll
    for (int q = 0; q < i; ++q) t = fmaf(-L[i][q], x[q], t);
    x[i] = __fdiv_rn(t, L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = x[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) t = fmaf(-L[q][i], x[q], t);
    x[i] = __fdiv_rn(t, L[i][i]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) bad = bad || !isfinite(x[i]);
  if (bad)
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  if (x_out != nullptr && lane == 0)
    for (int i = 0; i < 6; ++i) x_out[i] = x[i];

  // se3_exp(x), with camera.se3_exp's small-angle branches
  const float w0 = x[3], w1 = x[4], w2 = x[5];
  const float theta2 = fmaf(w2, w2, fmaf(w1, w1, w0 * w0));
  const float theta = __fsqrt_rn(theta2);
  const bool small = theta < 1e-6f;
  float sc = 0.0f;
  if (lane == 0) sc = sinf(theta);
  else if (lane == 1) sc = cosf(theta);
  const float sn = __shfl_sync(kFull, sc, 0);
  const float cs = __shfl_sync(kFull, sc, 1);
  const float a = small ? 1.0f - theta2 / 6.0f : __fdiv_rn(sn, theta);
  const float b = small ? 0.5f - theta2 / 24.0f : __fdiv_rn(1.0f - cs, theta2);
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : __fdiv_rn(theta - sn, theta2 * theta);
  // lane e = 3i + j (e < 9): E[i][j] and (id + b W + c W^2)[i][j]
  const int e = lane < 9 ? lane : 0, ei = e / 3, ej = e - 3 * ei;
  float W2 = skew(w0, w1, w2, ei, 0) * skew(w0, w1, w2, 0, ej);
  W2 = fmaf(skew(w0, w1, w2, ei, 1), skew(w0, w1, w2, 1, ej), W2);
  W2 = fmaf(skew(w0, w1, w2, ei, 2), skew(w0, w1, w2, 2, ej), W2);
  const float id = ei == ej ? 1.0f : 0.0f;
  const float Wij = skew(w0, w1, w2, ei, ej);
  const float Eij = (id + a * Wij) + b * W2;
  const float Vij = (id + b * Wij) + c * W2;
  // lane i (< 3): E[i][3] = V[i] . x, a fmaf chain from 0
  const int ti = lane < 3 ? lane : 0;
  float et = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    et = fmaf(__shfl_sync(kFull, Vij, 3 * ti + j), x[j], et);
  // lane 4i + j (< 16): (E @ P)[i][j]
  const int pi = (lane >> 2) & 3, pj = lane & 3, si = pi < 3 ? pi : 2;
  float Er[4];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float v = __shfl_sync(kFull, Eij, 3 * si + q);
    Er[q] = pi < 3 ? v : 0.0f;
  }
  const float v3 = __shfl_sync(kFull, et, si);
  Er[3] = pi < 3 ? v3 : 1.0f;
  float t = Er[0] * P[pj];
#pragma unroll
  for (int q = 1; q < 4; ++q) t = fmaf(Er[q], P[4 * q + pj], t);
  __syncwarp();
  if (lane < 16) P[lane] = t;
  __syncwarp();

  float xx = x[0] * x[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) xx = fmaf(x[i], x[i], xx);
  return __fsqrt_rn(xx) < icp_threshold;
}

// view = camera_matrix(k) @ inv(rpose) on one thread, with the bits the
// card gives that product in PyTorch: the inverse of lu_inverse.cuh
// (pose_inv's), then each entry the products K[i][q] * X[q][j] rounded one
// by one and added in q order, ((p0 + p1) + p2) + p3 (held to the card's
// `@` on every raycast pose of the smoke and a fuzz of poses: see
// tests/test_torch_gpu.py).
__device__ __forceinline__ void tracking_view(const float* rpose,
                                              const float* k, float* V) {
  float A[4][4], X[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) A[i][j] = rpose[4 * i + j];
  lu::lu_inverse<4>(A, X);
  const float K[4][4] = {{k[0], 0.0f, k[2], 0.0f},
                         {0.0f, k[1], k[3], 0.0f},
                         {0.0f, 0.0f, 1.0f, 0.0f},
                         {0.0f, 0.0f, 0.0f, 1.0f}};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = K[i][0] * X[0][j];
#pragma unroll
      for (int q = 1; q < 4; ++q) s = s + K[i][q] * X[q][j];
      V[4 * i + j] = s;
    }
}

#ifdef ICP_TRIP_CLOCKS
// The trip-parts build (probes/icp_times.py trip_parts): CTA 0's thread 0
// stamps clock64 at each part's end into trip_clocks (set by
// icp_set_trip_clocks; kClockTrips trips of kClockStamps stamps, then the
// launch's clock64 and globaltimer at its start and end).
constexpr int kClockTrips = 64;
constexpr int kClockStamps = 5;
__device__ unsigned long long* trip_clocks = nullptr;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRIP_STAMP(trip, i)                                              \
  do {                                                                   \
    if (blockIdx.x == 0 && tid == 0 && trip_clocks != nullptr &&         \
        (trip) < kClockTrips)                                            \
      trip_clocks[(trip) * kClockStamps + (i)] = clock64();              \
  } while (0)
#define TRIP_SYNC() __syncthreads()
#define LAUNCH_STAMP(i)                                                  \
  do {                                                                   \
    if (blockIdx.x == 0 && tid == 0 && trip_clocks != nullptr) {         \
      trip_clocks[kClockTrips * kClockStamps + (i)] = clock64();         \
      trip_clocks[kClockTrips * kClockStamps + (i) + 1] = global_ns();   \
    }                                                                    \
  } while (0)
#else
#define TRIP_STAMP(trip, i) \
  do {                      \
  } while (0)
#define TRIP_SYNC() \
  do {              \
  } while (0)
#define LAUNCH_STAMP(i) \
  do {                  \
  } while (0)
#endif

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// The exchange of a trip.  Each CTA publishes its 29 partials as 64-bit
// words {value, tag} (one store each, so a word is read whole or not at
// all) into words[trip & 1][cta], the tag base + trip + 1; every warp w of
// every CTA loads the words of CTAs w, w + kLevelWarps, ... together,
// reloads together those that do not carry the trip's tag yet until all
// do, and sums them in CTA order; then warp 0 sums the warps' sums in
// order into S.  The barrier and the data travel together: one L2 round
// trip.  Every CTA publishes every trip (zeros at a level where it owns no
// pixel), so no CTA writes trip t + 2's words before every CTA has
// published trip t + 1, which it does after reading trip t's.  `base` is
// read from *epoch at the launch's start, and CTA 0 adds the launch's
// trips at its end (every CTA has read it by then: each published at
// least once), so no word left by an earlier launch carries a tag this
// launch waits for, also in a replayed CUDA graph.
constexpr int kGather = 17;            // words a lane loads at once

__device__ __forceinline__ void level_exchange(
    unsigned long long* __restrict__ words, unsigned base, int trip,
    const float (&wp)[kLevelWarps][kSumSlots],
    float (&gp)[kLevelWarps][kSumSlots], float* S, int tid) {
  const int lane = tid & 31, warp = tid >> 5, n = gridDim.x;
  const unsigned tag32 = base + trip + 1;
  const unsigned long long tag = static_cast<unsigned long long>(tag32)
                                 << 32;
  unsigned long long* slot =
      words + static_cast<size_t>(trip & 1) * n * kSumSlots;
  if (tid < kSums) {
    float s = wp[0][lane];
#pragma unroll
    for (int w = 1; w < kLevelWarps; ++w) s += wp[w][lane];
    st_relaxed(slot + blockIdx.x * kSumSlots + lane, tag | __float_as_uint(s));
  }
  if (lane < kSums) {
    float s = 0.0f;
    for (int b0 = warp; b0 < n; b0 += kLevelWarps * kGather) {
      unsigned long long v[kGather];
#pragma unroll
      for (int c = 0; c < kGather; ++c) {
        const int b = b0 + kLevelWarps * c;
        v[c] = b < n ? ld_relaxed(slot + b * kSumSlots + lane) : tag;
      }
      for (;;) {
        bool ready = true;
#pragma unroll
        for (int c = 0; c < kGather; ++c)
          ready = ready && static_cast<unsigned>(v[c] >> 32) == tag32;
        if (ready) break;
#pragma unroll
        for (int c = 0; c < kGather; ++c)
          if (static_cast<unsigned>(v[c] >> 32) != tag32)
            v[c] = ld_relaxed(slot + (b0 + kLevelWarps * c) * kSumSlots +
                              lane);
      }
#pragma unroll
      for (int c = 0; c < kGather; ++c) {
        const int b = b0 + kLevelWarps * c;
        if (b < n) {
          const float x = __uint_as_float(static_cast<unsigned>(v[c]));
          s = b == warp ? x : s + x;
        }
      }
    }
    gp[warp][lane] = s;
  }
  __syncthreads();
  if (tid < 32) {
    const int m = min(kLevelWarps, n);
    float s = gp[0][lane];
    for (int w = 1; w < m; ++w) s += gp[w][lane];
    S[lane] = s;
  }
  __syncwarp();
}

struct LevelsOut {
  float* pose;
  float* error2;
  float* count;
  uint8_t* converged;
  int* iteration;
  int* result;                         // level 0's status image
  float* sums;                         // the last trip's sums, or null
  float* view;                         // the view used, or null
};

// words: [2][gridDim.x][kSumSlots], epoch: see level_exchange
__global__ void __launch_bounds__(kLevelThreads, 1)
icp_track_levels_kernel(Levels P, Knobs k, const float* __restrict__ rpose,
                        const float* __restrict__ kvec,
                        const float* __restrict__ pose_in,
                        float icp_threshold,
                        unsigned long long* __restrict__ words,
                        unsigned* __restrict__ epoch, LevelsOut o) {
  constexpr int kOwn = 2;                // 76800 / (132 x 256) = 2.3
  __shared__ float Tp[16], V[16];
  __shared__ float warp_part[kLevelWarps][kSumSlots];
  __shared__ float gather_part[kLevelWarps][kSumSlots];
  __shared__ float S[kSumSlots];
  __shared__ int conv_s;
  __shared__ unsigned base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cta = gridDim.x, stride = n_cta * kLevelThreads;
  const int g = blockIdx.x * kLevelThreads + tid;
  LAUNCH_STAMP(0);
  // the tracking view on thread 0 while the others load the carry
  if (tid == 0) tracking_view(rpose, kvec, V);
  if (tid == 32) base = ld_relaxed(epoch);
  if (tid >= 48 && tid < 64) Tp[tid - 48] = pose_in[tid - 48];
  if (tid >= 64 && tid < 64 + kSumSlots) S[tid - 64] = 0.0f;  // no trip yet
  int trip = 0, trips = 0;
  bool conv = false;
  for (int l = P.n_levels - 1; l >= 0; --l) {
    const Level L = P.level[l];
    const int n_px = L.rows * L.cols, n_iters = P.iters[l];
    int* res = l == 0 ? o.result : nullptr;
    float own[kOwn][6];
#pragma unroll
    for (int j = 0; j < kOwn; ++j)
      if (g + j * stride < n_px) load_input(L, g + j * stride, own[j]);
    if (res != nullptr && n_iters == 0)          // no trip: zeros
      for (int p = g; p < n_px; p += stride) res[p] = 0;
    trips = 0;
    conv = false;
    __syncthreads();
    while (trips < n_iters && !conv) {
      TRIP_STAMP(trip, 0);
      float acc[kSumSlots], v[kSums];
#pragma unroll
      for (int i = 0; i < kSumSlots; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int p = g + j * stride;
        if (p < n_px) {
          const int status = pixel_terms(L, k, Tp, V, own[j], v);
          if (res != nullptr) res[p] = status;
#pragma unroll
          for (int i = 0; i < kSums; ++i) acc[i] += v[i];
        }
      }
      for (int p = g + kOwn * stride; p < n_px; p += stride) {
        float in[6];
        load_input(L, p, in);
        const int status = pixel_terms(L, k, Tp, V, in, v);
        if (res != nullptr) res[p] = status;
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] += v[i];
      }
      TRIP_SYNC();
      TRIP_STAMP(trip, 1);
      warp_part[warp][lane] = warp_reduce_scatter(acc, lane);
      __syncthreads();
      TRIP_STAMP(trip, 2);
      level_exchange(words, base, trip, warp_part, gather_part, S, tid);
      TRIP_STAMP(trip, 3);
      if (warp == 0) {
        const bool c = warp_solve(S, Tp, icp_threshold, lane, nullptr);
        if (lane == 0) conv_s = c;
      }
      __syncthreads();
      TRIP_STAMP(trip, 4);
      conv = conv_s;           // warp 0 writes it again only after the
      ++trip;                  // next trip's barriers
      ++trips;
    }
  }
  if (blockIdx.x == 0 && tid == 0 && trip > 0) st_relaxed(epoch, base + trip);
  LAUNCH_STAMP(2);
  if (blockIdx.x != 0) return;
  if (tid < 16) o.pose[tid] = Tp[tid];
  if (o.view != nullptr && tid < 16) o.view[tid] = V[tid];
  if (o.sums != nullptr && tid < kSums) o.sums[tid] = S[tid];
  if (tid == 0) {
    *o.error2 = S[0];
    *o.count = S[kSums - 1];
    *o.converged = conv;
    *o.iteration = trips;
  }
}

// The warp solve against solve_step on the same sums and pose: CTA i (one
// warp) runs both on system i (the GPU tests hold them bit for bit).
__global__ void __launch_bounds__(32)
solve_check_kernel(const float* __restrict__ sums,
                   const float* __restrict__ poses, float icp_threshold,
                   float* __restrict__ warp_pose, float* __restrict__ warp_x,
                   uint8_t* __restrict__ warp_conv,
                   float* __restrict__ one_pose, float* __restrict__ one_x,
                   uint8_t* __restrict__ one_conv) {
  __shared__ float S[kSumSlots], Pw[16];
  const int i = blockIdx.x, lane = threadIdx.x;
  S[lane] = lane < kSums ? sums[i * kSums + lane] : 0.0f;
  if (lane < 16) Pw[lane] = poses[i * 16 + lane];
  __syncwarp();
  const bool c = warp_solve(S, Pw, icp_threshold, lane, warp_x + 6 * i);
  if (lane < 16) warp_pose[i * 16 + lane] = Pw[lane];
  if (lane == 0) {
    warp_conv[i] = c;
    float Po[16], xo[6];
    for (int q = 0; q < 16; ++q) Po[q] = poses[i * 16 + q];
    one_conv[i] = solve_step(sums + i * kSums, Po, icp_threshold, xo);
    for (int q = 0; q < 16; ++q) one_pose[i * 16 + q] = Po[q];
    for (int q = 0; q < 6; ++q) one_x[6 * i + q] = xo[q];
  }
}

}  // namespace

extern "C" {

// The CTAs of icp_track_reduce for n_px pixels (the partials' rows).
int icp_track_reduce_blocks(int n_px) {
  return (n_px + kThreads - 1) / kThreads;
}

// One trip of the sharded frame (see icp_track_reduce_kernel): pending
// (the previous trip's all-reduced sums, or null at a level's first
// trip), the status image `result`, the sums `sums` (not `pending`), the
// carry (pose, error2, count, converged, iteration) in place; partials:
// icp_track_reduce_blocks(n_px) x 29 floats; ticket zero, left zero.
int icp_track_reduce(const float* in_vertex, const float* in_normal,
                     long long row_stride, long long col_stride, int rows,
                     int cols, const float* ref_vertex,
                     const float* ref_normal, int rH, int rW,
                     const float* view, float* pose, float* error2,
                     float* count, uint8_t* converged, int* iteration,
                     int n_iters, float icp_threshold, const float* pending,
                     int symmetric, const uint8_t* gate, int robust,
                     float delta, float tukey_inv, int bilinear,
                     float dist_threshold, float normal_threshold,
                     int* result, float* partials,
                     unsigned int* ticket, float* sums,
                     cudaStream_t stream) {
  const int n_px = rows * cols;
  if (n_px <= 0) return 0;
  if (pending == sums) return static_cast<int>(cudaErrorInvalidValue);
  Level L{in_vertex, in_normal, row_stride, col_stride, rows, cols,
          ref_vertex, ref_normal, rH, rW};
  Knobs k{symmetric, gate, robust, delta, tukey_inv, bilinear,
          dist_threshold, normal_threshold};
  Carry c{pose, error2, count, converged, iteration};
  icp_track_reduce_kernel<<<icp_track_reduce_blocks(n_px), kThreads, 0,
                            stream>>>(L, k, view, c, n_iters, icp_threshold,
                                      pending, result, partials, ticket,
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

// The most CTAs icp_track_levels may launch on the current device: those
// the card holds at once (an SM's times the SMs), as a cooperative launch
// needs.
int icp_track_levels_grid(int* n_cta) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icp_track_levels_kernel, kLevelThreads, 0);
  *n_cta = per_sm * sms;
  return static_cast<int>(err);
}

// Every level's loop of a tracked frame, coarsest (n_levels - 1) to
// finest (0): level l's input maps at in_vertex[l] / in_normal[l] with row
// and column strides (floats), rows[l] x cols[l] pixels, iters[l] trips at
// most, against the reference maps seen through view = K @ inv(rpose), K
// the intrinsics kvec = (fx, fy, cx, cy), computed in the launch.  Writes
// the final carry, level 0's status image of its last trip (zeros where it
// ran none) and, where not null, the last trip's 29 sums and the view.  A
// cooperative grid of n_cta CTAs (at most icp_track_levels_grid's), with
// words (2 x n_cta x 32 uint64) and epoch (a uint32), both zero before the
// first launch on them: each launch leaves them fit for the next.
int icp_track_levels(int n_cta, int n_levels, const float* const* in_vertex,
                     const float* const* in_normal,
                     const long long* row_stride,
                     const long long* col_stride, const int* rows,
                     const int* cols, const int* iters,
                     const float* ref_vertex, const float* ref_normal,
                     int rH, int rW, const float* rpose, const float* kvec,
                     const float* pose_in, float icp_threshold,
                     int symmetric, const uint8_t* gate, int robust,
                     float delta, float tukey_inv, int bilinear,
                     float dist_threshold, float normal_threshold,
                     unsigned long long* words, unsigned* epoch, float* pose,
                     float* error2, float* count, uint8_t* converged,
                     int* iteration, int* result, float* sums, float* view,
                     cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_cta < 1 ||
      words == nullptr || epoch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels P{};
  P.n_levels = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    P.level[l] = Level{in_vertex[l], in_normal[l], row_stride[l],
                       col_stride[l], rows[l], cols[l], ref_vertex,
                       ref_normal, rH, rW};
    P.iters[l] = iters[l];
  }
  Knobs k{symmetric, gate, robust, delta, tukey_inv, bilinear,
          dist_threshold, normal_threshold};
  LevelsOut o{pose, error2, count, converged, iteration, result, sums, view};
  void* args[] = {&P, &k, &rpose, &kvec, &pose_in, &icp_threshold, &words,
                  &epoch, &o};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(icp_track_levels_kernel), dim3(n_cta),
      dim3(kLevelThreads), args, 0, stream);
  // read (and clear) the error a refused launch records, so that the next
  // launch does not report it
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The warp solve and solve_step on n systems (sums [n, 29], poses [n, 16]):
// each one's pose, twist and exit test.
int icp_solve_check(const float* sums, const float* poses, int n,
                    float icp_threshold, float* warp_pose, float* warp_x,
                    uint8_t* warp_conv, float* one_pose, float* one_x,
                    uint8_t* one_conv, cudaStream_t stream) {
  if (n < 1) return 0;
  solve_check_kernel<<<n, 32, 0, stream>>>(sums, poses, icp_threshold,
                                           warp_pose, warp_x, warp_conv,
                                           one_pose, one_x, one_conv);
  return static_cast<int>(cudaGetLastError());
}

#ifdef ICP_TRIP_CLOCKS
// The trip-parts build: where CTA 0 stamps its clocks (kClockTrips x
// kClockStamps uint64), or null to stop.
int icp_set_trip_clocks(unsigned long long* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(trip_clocks, &buf, sizeof(buf)));
}
#endif

}  // extern "C"
