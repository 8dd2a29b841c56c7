// ICP tracking on the card, for Hopper (sm_90a).  icp_track_levels runs
// every trip of every pyramid level of a tracked frame in one cooperative
// launch (the one-device frame); icp_track_reduce runs one trip of the
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
// operations on one thread.  So a launch a trip is bound by the launch
// floor (~5 us), not bytes or operations, and a sharded frame of 19 trips
// by the host's enqueue of its launches.  What the designs do about that:
// - icp_track_levels: one launch a frame.  A fixed grid (the CTAs an SM
//   holds times the SMs) owns fixed pixels of every level, keeps the input
//   maps of up to kOwn pixels a thread in registers over a level's trips,
//   and a trip costs its pixel pass, one grid barrier, every CTA's sum of
//   the CTAs' partials (the same fixed order in every CTA) and one thread's
//   solve.  The reference maps stay in the 50 MB L2.
// - icp_track_reduce: one launch a trip, the previous trip's solve at its
//   start and the cross-CTA sum at its end in a fixed order (a last-CTA
//   ticket), so no second launch and no atomics on the sums (which would also make them vary run
//   to run).
// - The strided finest level and a rank's row strip are read in place
//   through a base pointer and row / column strides: no copy of the level.
// - The solve, the exponential and the pose product run on one thread: 6x6
//   and 4x4 are too small to split.
//
// Rounding.  Built with --fmad=false and IEEE division and square root; the
// projections, norms and cross products are explicit fmaf chains in the
// order the twins' `numerics.matvec`, `preprocessing.norm` and
// `preprocessing.cross` use, so the status image of a trip from a given
// pose equals the twin's bit for bit.  The sums add in another order than
// PyTorch's reductions (a thread's pixels, warp shuffles, then CTA partials
// in order), within float32 rounding of the twin's, and in the same order
// in every run on a given card (a fixed grid, fixed pixels a CTA); the 6x6
// Cholesky is a plain left-looking one in float32, within float32 rounding
// of torch.linalg's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // pixels a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 29;              // error2, JTe[6], JTJ[21], count
constexpr float kInvalid = -2.0f;      // the invalid-normal marker
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 8;          // pyramid levels icp_track_levels takes
constexpr int kOwn = 4;                // pixels a thread keeps in registers
constexpr int kChunk = 4;              // partials a lane loads at once
constexpr int kSumsPerWarp = (kSums + kWarps - 1) / kWarps;

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

// Every level's loop of a tracked frame in one cooperative launch of a
// fixed grid (every CTA resident).  A CTA owns the pixels blockIdx.x *
// kThreads + tid + j * (gridDim.x * kThreads) of each level, and keeps the
// first kOwn of a thread's in registers for the level's trips.  A trip:
// each CTA that owns pixels at the level writes its partial of the 29 sums
// to partials[trip & 1] (warp trees, then the warps in order), one grid
// barrier, then every CTA sums those partials in the same fixed order and
// runs the solve on one thread into its own shared copy of the carry.  Every CTA so holds the same bits and
// takes the same exit, and the double buffer keeps the next trip's
// partials off the ones a slower CTA may still be reading.
__global__ void __launch_bounds__(kThreads)
icp_track_levels_kernel(Levels P, Knobs k, const float* __restrict__ view,
                        const float* __restrict__ pose_in,
                        float icp_threshold, float* partials,
                        float* __restrict__ pose, float* __restrict__ error2,
                        float* __restrict__ count,
                        uint8_t* __restrict__ converged,
                        int* __restrict__ iteration, int* __restrict__ result,
                        float* __restrict__ sums_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float T[16], V[16];
  __shared__ float warp_part[kWarps][kSums];
  __shared__ float S[kSums];
  __shared__ bool solved_conv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cta = gridDim.x, stride = n_cta * kThreads;
  const int g = blockIdx.x * kThreads + tid;
  if (tid < 16) {
    T[tid] = pose_in[tid];
    V[tid] = view[tid];
  }
  if (tid < kSums) S[tid] = 0.0f;    // error2 and count before any trip
  int trip = 0, trips = 0;
  bool conv = false;
  for (int l = P.n_levels - 1; l >= 0; --l) {
    const Level L = P.level[l];
    const int n_px = L.rows * L.cols, n_iters = P.iters[l];
    // the CTAs that own pixels at this level (the others' partials are 0)
    const int n_act = min(n_cta, (n_px + kThreads - 1) / kThreads);
    int* res = l == 0 ? result : nullptr;
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
      float acc[kSums], v[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int p = g + j * stride;
        if (p < n_px) {
          const int status = pixel_terms(L, k, T, V, own[j], v);
          if (res != nullptr) res[p] = status;
#pragma unroll
          for (int i = 0; i < kSums; ++i) acc[i] += v[i];
        }
      }
      for (int p = g + kOwn * stride; p < n_px; p += stride) {
        float x[6];
        load_input(L, p, x);
        const int status = pixel_terms(L, k, T, V, x, v);
        if (res != nullptr) res[p] = status;
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] += v[i];
      }

      // this CTA's partial, then the barrier
      float* part = partials + (trip & 1) * n_cta * kSums;
#pragma unroll
      for (int i = 0; i < kSums; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) warp_part[warp][i] = s;
      }
      __syncthreads();
      if (tid < kSums && static_cast<int>(blockIdx.x) < n_act) {
        float s = warp_part[0][tid];
        for (int w = 1; w < kWarps; ++w) s += warp_part[w][tid];
        part[blockIdx.x * kSums + tid] = s;
      }
      grid.sync();

      // every CTA: the active CTAs' partials in a fixed order (warp w sums
      // w, w + kWarps, ...; lane l the CTAs l, l + 32, ... in turn, loading
      // kChunk of them at once), then the solve
      float acc_s[kSumsPerWarp];
#pragma unroll
      for (int q = 0; q < kSumsPerWarp; ++q) acc_s[q] = 0.0f;
      for (int b0 = lane; b0 < n_act; b0 += 32 * kChunk) {
        float ld[kSumsPerWarp][kChunk];
#pragma unroll
        for (int q = 0; q < kSumsPerWarp; ++q)
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const int i = warp + q * kWarps, b = b0 + 32 * c;
            ld[q][c] = i < kSums && b < n_act
                           ? __ldcg(part + b * kSums + i) : 0.0f;
          }
#pragma unroll
        for (int q = 0; q < kSumsPerWarp; ++q)
#pragma unroll
          for (int c = 0; c < kChunk; ++c)
            if (b0 + 32 * c < n_act) acc_s[q] += ld[q][c];
      }
#pragma unroll
      for (int q = 0; q < kSumsPerWarp; ++q) {
        const float s = warp_sum(acc_s[q]);
        if (lane == 0 && warp + q * kWarps < kSums) S[warp + q * kWarps] = s;
      }
      __syncthreads();
      if (tid == 0) {
        float x[6];
        solved_conv = solve_step(S, T, icp_threshold, x);
      }
      __syncthreads();
      conv = solved_conv;      // tid 0 writes it again only after the
      ++trip;                  // next trip's barriers
      ++trips;
    }
  }
  if (blockIdx.x != 0) return;
  if (tid < 16) pose[tid] = T[tid];
  if (sums_out != nullptr && tid < kSums) sums_out[tid] = S[tid];
  if (tid == 0) {
    *error2 = S[0];
    *count = S[kSums - 1];
    *converged = conv;
    *iteration = trips;
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

// The fixed grid of icp_track_levels on the current device: the CTAs an
// SM holds at once times the SMs (every CTA resident, as a cooperative
// launch needs).
int icp_track_levels_grid(int* n_cta) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icp_track_levels_kernel, kThreads, 0);
  *n_cta = per_sm * sms;
  return static_cast<int>(err);
}

// Every level's loop of a tracked frame, coarsest (n_levels - 1) to
// finest (0): level l's input maps at in_vertex[l] / in_normal[l] with row
// and column strides (floats), rows[l] x cols[l] pixels, iters[l] trips at
// most.  Writes the final carry, level 0's status image of its last trip
// (zeros where it ran none) and, if sums is not null, the last trip's 29
// sums.  partials: 2 x n_cta x 29 floats of workspace.
int icp_track_levels(int n_levels, const float* const* in_vertex,
                     const float* const* in_normal,
                     const long long* row_stride,
                     const long long* col_stride, const int* rows,
                     const int* cols, const int* iters,
                     const float* ref_vertex, const float* ref_normal,
                     int rH, int rW, const float* view, const float* pose_in,
                     float icp_threshold, int symmetric, const uint8_t* gate,
                     int robust, float delta, float tukey_inv, int bilinear,
                     float dist_threshold, float normal_threshold,
                     float* partials, int n_cta, float* pose, float* error2,
                     float* count, uint8_t* converged, int* iteration,
                     int* result, float* sums, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_cta < 1)
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
  void* args[] = {&P, &k, &view, &pose_in, &icp_threshold, &partials,
                  &pose, &error2, &count, &converged, &iteration, &result,
                  &sums};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(icp_track_levels_kernel), dim3(n_cta),
      dim3(kThreads), args, 0, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
