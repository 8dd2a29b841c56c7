// One level of the tracking pyramid on the card, for Hopper (sm_90a):
// build_pyramid launches pyramid_level once a level.
//
// What it replaces.  pipeline/preprocessing.py:build_pyramid's chain of
// small PyTorch operations (half_sample_robust, depth_to_vertex,
// vertex_to_normal: about fifty launches a frame at three levels, bound by
// the host's enqueue), the counterpart of supereight_tpu/pipeline/
// preprocessing.py:74-150, which XLA fuses.  For each pixel of level l:
// - its depth: the input itself at level 0, else the edge-preserving 2x
//   half sample of level l-1 (the 2x2 neighbours within e_d of the centre
//   sample, averaged), which the previous launch wrote;
// - its vertex: depth * (invK row . (x, y, 1)), with the intrinsics k
//   (fx, fy, cx, cy) scaled by 2^-l and inverted as
//   camera.inverse_camera_matrix does, 0 where the depth is not > 0;
// - its normal: the cross product of the right-minus-left and
//   up-minus-down vertex differences (edge-clamped neighbours; neg_y swaps
//   up and down), normalised, or (INVALID, 0, 0) where the pixel or one of
//   its four neighbours has no depth.
// A thread computes one pixel.  It needs the vertices of its four
// neighbours, so it computes their depths itself (at level l > 0 four
// half samples more, 16 loads that the L1 serves): no second pass and no
// grid-wide barrier, one launch a level.  The bytes are the level's depth
// read once and its depth, vertex and normal images written once (1.9 MB
// at 320x240); the launch, not the bytes, is what it costs.
//
// Rounding.  The build uses --fmad=false, so every product and sum rounds
// on its own except the fmaf calls, which stand where the twin calls
// numerics.fma: the ray coordinate invK00 * x + invK02, each component of
// the cross product (fma(a_i, b_j, -(a_j * b_i))), and the squared norm's
// chain.  The half sample adds in the twin's loop order from 0, the root
// is the correctly rounded sqrtf, / is IEEE division, and the clamps keep
// torch.clamp's NaN.  The kernel equals its twin bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr float kInvalid = -2.0f;   // pipeline/constants.py INVALID

struct Level {
  const float* src;   // level l-1's depth [Hs, Ws], or the input at level 0
  float* depth;       // [H, W] (null at level 0: the input is level 0's)
  float* vertex;      // [H, W, 3]
  float* normal;      // [H, W, 3]
  const float* k;     // (fx, fy, cx, cy) at level 0
  int Hs, Ws, H, W, level, half;
  float e_d;          // the half sample's range, float32(3 * E_DELTA)
  int neg_y;
};

// max(x, lo) as torch.clamp computes it: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// Level l's depth at (y, x) (already clamped to the level).
__device__ __forceinline__ float level_depth(const Level& L, int y, int x) {
  if (!L.half) return L.src[y * L.Ws + x];
  const float center = L.src[(2 * y) * L.Ws + 2 * x];
  float t = 0.0f, s = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float cur = L.src[min(2 * y + i, L.Hs - 1) * L.Ws +
                              min(2 * x + j, L.Ws - 1)];
      const bool ok = fabsf(cur - center) < L.e_d;
      t = t + (ok ? cur : 0.0f);
      s = s + (ok ? 1.0f : 0.0f);
    }
  }
  return t / clamp_min(s, 1e-20f);
}

struct Vec3 {
  float x, y, z;
};

// The inverse intrinsics' entries that a vertex takes.
struct InvK {
  float k00, k02, k11, k12;
};

__device__ __forceinline__ Vec3 vertex_of(const InvK& ik, float d, int y,
                                          int x) {
  if (!(d > 0.0f)) return Vec3{0.0f, 0.0f, 0.0f};
  return Vec3{d * fmaf(ik.k00, static_cast<float>(x), ik.k02),
              d * fmaf(ik.k11, static_cast<float>(y), ik.k12), d};
}

__device__ __forceinline__ Vec3 vertex_at(const Level& L, const InvK& ik,
                                          int y, int x) {
  return vertex_of(ik, level_depth(L, y, x), y, x);
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
level_kernel(const Level L) {
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y = blockIdx.y * kThreadsY + threadIdx.y;
  if (x >= L.W || y >= L.H) return;

  // camera.inverse_camera_matrix(k / 2^l)
  const float scale = static_cast<float>(1 << L.level);
  const float fx = L.k[0] / scale, fy = L.k[1] / scale;
  const float cx = L.k[2] / scale, cy = L.k[3] / scale;
  const InvK ik{1.0f / fx, -cx / fx, 1.0f / fy, -cy / fy};

  const float d = level_depth(L, y, x);
  const Vec3 v = vertex_of(ik, d, y, x);
  const int p = y * L.W + x;
  if (L.depth != nullptr) L.depth[p] = d;
  L.vertex[3 * p] = v.x;
  L.vertex[3 * p + 1] = v.y;
  L.vertex[3 * p + 2] = v.z;

  const Vec3 left = vertex_at(L, ik, y, max(x - 1, 0));
  const Vec3 right = vertex_at(L, ik, y, min(x + 1, L.W - 1));
  const int yu = L.neg_y ? max(y - 1, 0) : min(y + 1, L.H - 1);
  const int yd = L.neg_y ? min(y + 1, L.H - 1) : max(y - 1, 0);
  const Vec3 up = vertex_at(L, ik, yu, x);
  const Vec3 down = vertex_at(L, ik, yd, x);

  float n0 = kInvalid, n1 = 0.0f, n2 = 0.0f;
  if (v.z != 0.0f && left.z != 0.0f && right.z != 0.0f && up.z != 0.0f &&
      down.z != 0.0f) {
    const float a0 = right.x - left.x, a1 = right.y - left.y,
                a2 = right.z - left.z;
    const float b0 = up.x - down.x, b1 = up.y - down.y, b2 = up.z - down.z;
    const float c0 = fmaf(a1, b2, -(a2 * b1));
    const float c1 = fmaf(a2, b0, -(a0 * b2));
    const float c2 = fmaf(a0, b1, -(a1 * b0));
    float acc = c0 * c0;
    acc = fmaf(c1, c1, acc);
    acc = fmaf(c2, c2, acc);
    const float len = clamp_min(sqrtf(acc), 1e-20f);
    n0 = c0 / len;
    n1 = c1 / len;
    n2 = c2 / len;
  }
  L.normal[3 * p] = n0;
  L.normal[3 * p + 1] = n1;
  L.normal[3 * p + 2] = n2;
}

}  // namespace

// One level: src [Hs, Ws] float32 (the input depth at level 0, level l-1's
// depth after), depth [H, W] (null at level 0), vertex and normal
// [H, W, 3], k float32[4] (fx, fy, cx, cy) at level 0, all on the device.
// half: 1 for a half-sampled level (H = ceil(Hs / 2), W = ceil(Ws / 2)),
// 0 for level 0 (H = Hs, W = Ws).
extern "C" int pyramid_level(const void* src, void* depth, void* vertex,
                             void* normal, const void* k, int Hs, int Ws,
                             int H, int W, int level, int half, float e_d,
                             int neg_y, void* stream) {
  if (H <= 0 || W <= 0 || level < 0 || level > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const Level L{static_cast<const float*>(src), static_cast<float*>(depth),
                static_cast<float*>(vertex), static_cast<float*>(normal),
                static_cast<const float*>(k), Hs, Ws, H, W, level, half,
                e_d, neg_y};
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((W + kThreadsX - 1) / kThreadsX,
                  (H + kThreadsY - 1) / kThreadsY);
  level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
