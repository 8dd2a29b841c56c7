// The tracking pyramid on the card, for Hopper (sm_90a): build_pyramid
// builds every level in one launch of pyramid_kernel.
//
// What it replaces.  pipeline/preprocessing.py:build_pyramid's chain of
// small PyTorch operations (half_sample_robust, depth_to_vertex,
// vertex_to_normal: about fifty launches a frame at three levels, bound by
// the host's enqueue), the counterpart of supereight_tpu/pipeline/
// preprocessing.py:74-150, which XLA fuses.  For each pixel of level l:
// - its depth: the input itself at level 0, else the edge-preserving 2x
//   half sample of level l-1 (the 2x2 neighbours within e_d of the centre
//   sample, averaged);
// - its vertex: depth * (invK row . (x, y, 1)), with the intrinsics k
//   (fx, fy, cx, cy) scaled by 2^-l and inverted as
//   camera.inverse_camera_matrix does, 0 where the depth is not > 0;
// - its normal: the cross product of the right-minus-left and
//   up-minus-down vertex differences (edge-clamped neighbours; neg_y swaps
//   up and down), normalised, or (INVALID, 0, 0) where the pixel or one of
//   its four neighbours has no depth.
//
// What bounds it: neither bytes (2.8 MB at 320x240 and three levels, under
// a microsecond) nor operations, but the launch and the chain of dependent
// steps from level 0 to the coarsest level.  So one launch builds all the
// levels, with no second pass and no grid-wide barrier (a grid.sync costs
// more than the launches it would save).  A CTA owns a kTile x kTile tile
// of the coarsest level L-1 and the tiles above it at every finer level,
// kTile * 2^(L-1-l) square at level l.  A pixel's normal needs its four
// neighbours (a halo of 1 at every level), and a halo of h cells at level
// l+1 needs 2h cells of level l, so the CTA holds level l's tile with a
// halo of 2^(L-1-l) cells: at three levels a 24 x 24 region of level 0,
// 12 x 12 of level 1 and 6 x 6 of level 2 (3 KB), and the headline's
// 320x240 takes 300 CTAs of 256 threads.  A CTA stages level 0's region
// from device memory once (16-byte loads where the row allows; level 0's
// columns are widened to multiples of four), half-samples each coarser
// level's region from the one before in shared memory (a barrier each),
// then computes the pixels it owns at every level in one pass, so that
// the coarse levels' few pixels do not each wait for a phase of their
// own: depth (levels >= 1), vertices and normals.  Rows and columns
// outside the image take the edge's value, as the twin's clamps do: level
// 0 is staged clamped, and every read of a level goes through that
// level's clamped coordinate, so no cell outside the image is read past
// level 0.  tile_plan in ops/pyramid_kernel.py computes the same
// geometry, and the CPU tests run it (tests/test_torch_glue.py).
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

// a CTA's tile of the coarsest level is kTile x kTile pixels
constexpr int kTile = 4;
// the most levels one launch builds
constexpr int kMaxLevels = 5;
// a CTA's threads at most (fewer where its level-0 tile has fewer pixels)
constexpr int kThreads = 1024;
// a CTA's shared memory at kMaxLevels, in floats: level 0's region 96 x
// 96, then 48^2, 24^2, 12^2 and 6^2, and each level's inverse intrinsics
constexpr int kSmemFloats = 12296;
constexpr float kInvalid = -2.0f;   // pipeline/constants.py INVALID

constexpr int ceil4(int x) { return (x + 3) / 4 * 4; }

// A level's tile side, its halo, and its region's rows and columns (level
// 0's columns widened to whole 16-byte loads).
struct Geometry {
  int side, halo_y, halo_x, rows, cols;
};

constexpr Geometry geometry(int levels, int l) {
  const int side = kTile << (levels - 1 - l);
  const int halo = 1 << (levels - 1 - l);
  if (l > 0) return Geometry{side, halo, halo, side + 2 * halo,
                             side + 2 * halo};
  return Geometry{side, halo, ceil4(halo), side + 2 * halo,
                  ceil4(side + halo) + ceil4(halo)};
}

// the regions, then 4 floats a level of the inverse intrinsics
constexpr int smem_floats(int levels) {
  int n = 4 * levels;
  for (int l = 0; l < levels; ++l)
    n += geometry(levels, l).rows * geometry(levels, l).cols;
  return n;
}

static_assert(kTile % 4 == 0, "level 0's tiles start at a 16-byte load");
static_assert(smem_floats(kMaxLevels) == kSmemFloats,
              "kSmemFloats is the shared memory of kMaxLevels levels");

struct Plan {
  int levels, vec, neg_y;
  float e_d;              // the half sample's range, float32(3 * E_DELTA)
  int H[kMaxLevels], W[kMaxLevels];
  // each level's depth (from level 1), vertex and normal images in the
  // output, offsets in floats
  int64_t depth[kMaxLevels], vertex[kMaxLevels], normal[kMaxLevels];
  int smem[kMaxLevels];   // each level's region in shared memory (floats)
  int ik;                 // the inverse intrinsics in shared memory
  int first[kMaxLevels + 1];  // a CTA's owned pixels before level l
  int shift[kMaxLevels];  // log2 of the tile's side
  int halo_y[kMaxLevels], halo_x[kMaxLevels], rows[kMaxLevels],
      cols[kMaxLevels];
};

// max(x, lo) as torch.clamp computes it: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return min(max(v, 0), hi);
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

// A level's region in shared memory: the depth at a pixel of the level
// (inside the image) by its global coordinates.
struct Region {
  const float* s;
  int y0, x0, pitch;
  __device__ __forceinline__ float at(int y, int x) const {
    return s[(y - y0) * pitch + (x - x0)];
  }
};

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const float* __restrict__ depth, float* __restrict__ out,
               const float* __restrict__ k, const Plan P) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int by = blockIdx.y, bx = blockIdx.x;
  const int L = P.levels;

  // level 0's region, clamped to the image
  {
    const int H = P.H[0], W = P.W[0];
    const int y0 = (by << P.shift[0]) - P.halo_y[0];
    const int x0 = (bx << P.shift[0]) - P.halo_x[0];
    const int quads = P.cols[0] / 4;
    for (int i = tid; i < P.rows[0] * quads; i += nt) {
      const int r = i / quads, c = 4 * (i - r * quads);
      const float* row = depth + static_cast<int64_t>(clamp_to(y0 + r, H - 1))
                                     * W;
      const int x = x0 + c;
      float4 v;
      if (P.vec && x >= 0 && x + 3 < W) {
        v = __ldg(reinterpret_cast<const float4*>(row + x));
      } else {
        v.x = row[clamp_to(x, W - 1)];
        v.y = row[clamp_to(x + 1, W - 1)];
        v.z = row[clamp_to(x + 2, W - 1)];
        v.w = row[clamp_to(x + 3, W - 1)];
      }
      *reinterpret_cast<float4*>(sm + r * P.cols[0] + c) = v;
    }
  }
  // each level's camera.inverse_camera_matrix(k / 2^l)
  if (tid < L) {
    const float scale = static_cast<float>(1 << tid);
    const float fx = k[0] / scale, fy = k[1] / scale;
    const float cx = k[2] / scale, cy = k[3] / scale;
    float* const ik = sm + P.ik + 4 * tid;
    ik[0] = 1.0f / fx;
    ik[1] = -cx / fx;
    ik[2] = 1.0f / fy;
    ik[3] = -cy / fy;
  }
  __syncthreads();

  // each coarser level's region: the half sample of the level before at
  // each cell inside the image
  for (int m = 1; m < L; ++m) {
    const int l = m - 1, H = P.H[l], W = P.W[l];
    const Region src{sm + P.smem[l],
                     (by << P.shift[l]) - P.halo_y[l],
                     (bx << P.shift[l]) - P.halo_x[l], P.cols[l]};
    const int cols = P.cols[m];
    const int y0 = (by << P.shift[m]) - P.halo_y[m];
    const int x0 = (bx << P.shift[m]) - P.halo_x[m];
    float* const dst = sm + P.smem[m];
    for (int i = tid; i < P.rows[m] * cols; i += nt) {
      const int r = i / cols, c = i - r * cols;
      const int y = y0 + r, x = x0 + c;
      if (y < 0 || y >= P.H[m] || x < 0 || x >= P.W[m]) continue;
      const float center = src.at(2 * y, 2 * x);
      float t = 0.0f, s = 0.0f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float v = src.at(min(2 * y + a, H - 1), min(2 * x + b, W - 1));
          const bool ok = fabsf(v - center) < P.e_d;
          t = t + (ok ? v : 0.0f);
          s = s + (ok ? 1.0f : 0.0f);
        }
      }
      dst[r * cols + c] = t / clamp_min(s, 1e-20f);
    }
    __syncthreads();
  }

  // the pixels the CTA owns at every level, in one pass
  for (int i = tid; i < P.first[L]; i += nt) {
    int l = 0;
    while (i >= P.first[l + 1]) ++l;
    const int H = P.H[l], W = P.W[l], shift = P.shift[l];
    const int j = i - P.first[l];
    const int oy = by << shift, ox = bx << shift;
    const int y = oy + (j >> shift), x = ox + (j & ((1 << shift) - 1));
    if (y >= H || x >= W) continue;
    const Region cur{sm + P.smem[l], oy - P.halo_y[l], ox - P.halo_x[l],
                     P.cols[l]};
    const float* const ikp = sm + P.ik + 4 * l;
    const InvK ik{ikp[0], ikp[1], ikp[2], ikp[3]};
    const float d = cur.at(y, x);
    const Vec3 v = vertex_of(ik, d, y, x);
    const int64_t p = static_cast<int64_t>(y) * W + x;
    if (l > 0) out[P.depth[l] + p] = d;
    float* const vo = out + P.vertex[l] + 3 * p;
    vo[0] = v.x;
    vo[1] = v.y;
    vo[2] = v.z;

    const int xl = max(x - 1, 0), xr = min(x + 1, W - 1);
    const int yu = P.neg_y ? max(y - 1, 0) : min(y + 1, H - 1);
    const int yd = P.neg_y ? min(y + 1, H - 1) : max(y - 1, 0);
    const Vec3 left = vertex_of(ik, cur.at(y, xl), y, xl);
    const Vec3 right = vertex_of(ik, cur.at(y, xr), y, xr);
    const Vec3 up = vertex_of(ik, cur.at(yu, x), yu, x);
    const Vec3 down = vertex_of(ik, cur.at(yd, x), yd, x);

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
    float* const no = out + P.normal[l] + 3 * p;
    no[0] = n0;
    no[1] = n1;
    no[2] = n2;
  }
}

}  // namespace

// Every level of the pyramid in one launch: depth [H, W] float32 (level
// 0's depth), k float32[4] (fx, fy, cx, cy) at level 0, and out, out_floats
// float32 on the device that take, level by level, the level's depth (from
// level 1 on; H_l = ceil(H_{l-1} / 2), W_l likewise), then its vertices
// and its normals ([H_l, W_l, 3] each), 1 <= levels <= kMaxLevels.
extern "C" int build_pyramid(const void* depth, void* out, int64_t out_floats,
                             const void* k, int H, int W, int levels,
                             float e_d, int neg_y, void* stream) {
  if (H <= 0 || W <= 0 || levels < 1 || levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan P{};
  P.levels = levels;
  P.e_d = e_d;
  P.neg_y = neg_y;
  P.vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(depth) % 16 == 0;
  int64_t off = 0;
  int smem = 0;
  P.first[0] = 0;
  for (int l = 0; l < levels; ++l) {
    P.H[l] = l ? (P.H[l - 1] + 1) / 2 : H;
    P.W[l] = l ? (P.W[l - 1] + 1) / 2 : W;
    const int64_t px = static_cast<int64_t>(P.H[l]) * P.W[l];
    if (l) {
      P.depth[l] = off;
      off += px;
    }
    P.vertex[l] = off;
    P.normal[l] = off + 3 * px;
    off += 6 * px;
    const Geometry g = geometry(levels, l);
    P.shift[l] = __builtin_ctz(g.side);
    P.halo_y[l] = g.halo_y;
    P.halo_x[l] = g.halo_x;
    P.rows[l] = g.rows;
    P.cols[l] = g.cols;
    P.smem[l] = smem;
    smem += g.rows * g.cols;
    P.first[l + 1] = P.first[l] + g.side * g.side;
  }
  P.ik = smem;
  smem += 4 * levels;
  if (off != out_floats) return static_cast<int>(cudaErrorInvalidValue);
  const int last = levels - 1;
  const dim3 grid((P.W[last] + kTile - 1) / kTile,
                  (P.H[last] + kTile - 1) / kTile);
  // a thread for each owned pixel of every level, in whole warps
  const int owned = (P.first[levels] + 31) / 32 * 32;
  const int threads = owned < kThreads ? owned : kThreads;
  const size_t bytes = sizeof(float) * static_cast<size_t>(smem);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float) * kSmemFloats));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pyramid_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), static_cast<float*>(out),
      static_cast<const float*>(k), P);
  return static_cast<int>(cudaGetLastError());
}
