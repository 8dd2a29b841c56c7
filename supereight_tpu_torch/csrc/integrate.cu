// Fused projective map updates over compacted block rows, for Hopper
// (sm_90a): SDF (fuse_sdf) and OFusion (fuse_ofusion).
//
// fuse_sdf replaces supereight_tpu/ops/integrate_kernel.py:_kernel /
// fused_integrate (the Pallas TPU kernel K1) and, like fuse_ofusion, the body
// of supereight_tpu/pipeline/integration.py:fuse_rows (the XLA path the JAX
// pipeline runs; K1 never covered OFusion).  Both compute fuse_rows' function:
// for each voxel of each row, world position -> T_cw -> K projection ->
// in-frame test -> the block's footprint level and patch origin -> nearest
// depth sample (project_voxel, shared) -> the field's update (fields/sdf.py or
// fields/ofusion.py), plus the per-row any-voxel-visible flag.
//
// Design.  One CTA per block row, one thread per voxel (512 threads, voxel
// index x + 8y + 64z).  The TPU versions gathered a 16x16 depth patch per
// block from a stride-2^lvl atlas, because per-voxel gathers were slow
// there; the patch test bounds each voxel's level-lvl pixel to the patch
// inside the level's extent, so the sample is exactly
// depth[(iy>>lvl)<<lvl, (ix>>lvl)<<lvl] and is read straight from the depth
// image: no atlas, no one-hot contractions, no lane rolls.  Each thread
// recomputes the block centre's projection (cheaper than a shared-memory
// round trip).  `visible` is a block-wide OR of in-frame & in-patch
// (__syncthreads_or), the XLA path's semantics.  Rows that are not live come
// back unchanged.  Float-to-int casts use __float2int_rz, which truncates and
// saturates like XLA's convert.  The projections are explicit fmaf chains,
// the order XLA's CPU dot evaluates the JAX einsums in; everything else is
// built with --fmad=false, so every product and sum rounds as the plain
// PyTorch twins' do.  fuse_sdf and its twin agree bit for bit.  OFusion's
// log-odds take a logarithm: jnp.log2 is log(x) / log(2), so the kernel
// computes logf(x) / ln2 (not log2f, and not the approximate __logf) with
// the twin's float32 ln2; `visible` and `timestamp` match the twin exactly,
// `occupancy` to the last bits of logf.
//
// What bounds it on the H100.  Per row it reads and writes 8 KB of the two
// channels: about 25 MB a frame at the headline budget of 3072 rows, well
// under 10 us of HBM time.  The depth image (300 KB) stays in L2.  At this
// size the kernel is bound by launch latency and the one-wave tail, so a
// simple kernel is right.  Later work: update the [capacity, 512] table in
// place by slot (dropping the caller's gather and scatter), and CUDA graphs
// over the frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockSide = 8;
constexpr int kBlockVoxels = 512;
constexpr float kLn2 = 0.693147182f;   // float32(log(2)), as jnp.log2 uses

struct VoxelSample {
  float cx, cy, cz;   // camera coordinates
  float zs;           // cz, with 0 -> 1
  bool valid;         // in frame and in the block's patch
  bool fuse;          // valid and the row is live
  float ds;           // depth sample (0 unless fuse)
};

// Projection, footprint level, patch test and depth sample of voxel v of
// block row `row` (fuse_rows' formulas; integration.py:408-464).
__device__ __forceinline__ VoxelSample project_voxel(
    const int32_t* __restrict__ bc, const uint8_t* __restrict__ live,
    const float* __restrict__ depth, const float* __restrict__ t_cw,
    const float* __restrict__ k, int row, int v, int H, int W,
    float voxel_size, float diag, int patch) {
  const float T00 = t_cw[0], T01 = t_cw[1], T02 = t_cw[2], T03 = t_cw[3];
  const float T10 = t_cw[4], T11 = t_cw[5], T12 = t_cw[6], T13 = t_cw[7];
  const float T20 = t_cw[8], T21 = t_cw[9], T22 = t_cw[10], T23 = t_cw[11];
  const float K00 = k[0], K02 = k[2], K11 = k[5], K12 = k[6];

  const float bx = static_cast<float>(bc[3 * row + 0] * kBlockSide);
  const float by = static_cast<float>(bc[3 * row + 1] * kBlockSide);
  const float bz = static_cast<float>(bc[3 * row + 2] * kBlockSide);

  // voxel: world -> camera -> pixel (+0.5 so the int cast rounds)
  VoxelSample s;
  const float wx = (bx + static_cast<float>(v & 7)) * voxel_size;
  const float wy = (by + static_cast<float>((v >> 3) & 7)) * voxel_size;
  const float wz = (bz + static_cast<float>(v >> 6)) * voxel_size;
  s.cx = fmaf(T02, wz, fmaf(T01, wy, T00 * wx)) + T03;
  s.cy = fmaf(T12, wz, fmaf(T11, wy, T10 * wx)) + T13;
  s.cz = fmaf(T22, wz, fmaf(T21, wy, T20 * wx)) + T23;
  s.zs = (s.cz == 0.0f) ? 1.0f : s.cz;
  const float px = fmaf(K02, s.cz, K00 * s.cx) / s.zs + 0.5f;
  const float py = fmaf(K12, s.cz, K11 * s.cy) / s.zs + 0.5f;
  bool valid = (s.cz >= 1e-4f) && (px >= 0.5f) &&
               (px <= static_cast<float>(W) - 1.5f) && (py >= 0.5f) &&
               (py <= static_cast<float>(H) - 1.5f);

  // block centre: footprint level and patch origin
  const float gx = (bx + 4.0f) * voxel_size;
  const float gy = (by + 4.0f) * voxel_size;
  const float gz = (bz + 4.0f) * voxel_size;
  const float ccx = fmaf(T02, gz, fmaf(T01, gy, T00 * gx)) + T03;
  const float ccy = fmaf(T12, gz, fmaf(T11, gy, T10 * gx)) + T13;
  const float ccz = fmaf(T22, gz, fmaf(T21, gy, T20 * gx)) + T23;
  const float foot = fabsf(K00) * diag / fmaxf(ccz, 1e-3f);
  const float ratio = foot / static_cast<float>(patch);
  // clip(ceil(log2(max(ratio, 1))), 0, 3) without a log
  const int lvl = (ratio > 1.0f) + (ratio > 2.0f) + (ratio > 4.0f);
  const float czs = (ccz == 0.0f) ? 1.0f : ccz;
  const float cpx = fmaf(K02, ccz, K00 * ccx) / czs + 0.5f;
  const float cpy = fmaf(K12, ccz, K11 * ccy) / czs + 0.5f;
  const float stride = static_cast<float>(1 << lvl);
  // jnp.clip(x, lo, hi) is min(max(x, lo), hi): hi wins when lo > hi
  const int p0r = min(max(__float2int_rz(cpy / stride) - patch / 2, 0),
                      (H >> lvl) - patch);
  const int p0c = min(max(__float2int_rz(cpx / stride) - patch / 2, 0),
                      (W >> lvl) - patch);

  const int ix = __float2int_rz(px);
  const int iy = __float2int_rz(py);
  const int lr = (iy >> lvl) - p0r;
  const int lc = (ix >> lvl) - p0c;
  s.valid = valid && lr >= 0 && lr < patch && lc >= 0 && lc < patch;
  s.fuse = s.valid && live[row] != 0;
  s.ds = s.fuse ? depth[static_cast<size_t>((iy >> lvl) << lvl) * W +
                        ((ix >> lvl) << lvl)]
                : 0.0f;
  return s;
}

// Integral of the cubic bspline sensor kernel (fields/ofusion.py); x ** 3 is
// x * (x * x), as lax.integer_pow multiplies
__device__ __forceinline__ float bspline_cdf(float t) {
  const float a = 3.0f + t;
  const float b = 3.0f - t;
  const float v1 = (a * (a * a)) / 48.0f;
  const float v2 = 0.5f + ((t * a) * b) / 24.0f;
  const float v3 = 1.0f - (b * (b * b)) / 48.0f;
  return t <= -3.0f ? 0.0f
       : t <= -1.0f ? v1
       : t <= 1.0f  ? v2
       : t <= 3.0f  ? v3
                    : 1.0f;
}

__global__ void __launch_bounds__(kBlockVoxels)
fuse_sdf_kernel(const int32_t* __restrict__ bc,
                const uint8_t* __restrict__ live,
                const float* __restrict__ tsdf,
                const float* __restrict__ weight,
                const float* __restrict__ depth,
                const float* __restrict__ t_cw,   // [4,4] row-major
                const float* __restrict__ k,      // [4,4] row-major
                float* __restrict__ tsdf_out,
                float* __restrict__ weight_out,
                uint8_t* __restrict__ visible,
                int H, int W, float mu, float max_weight, float voxel_size,
                float diag, int patch) {
  const int row = blockIdx.x;
  const int v = threadIdx.x;
  const VoxelSample s = project_voxel(bc, live, depth, t_cw, k, row, v, H, W,
                                      voxel_size, diag, patch);
  const int any_valid = __syncthreads_or(s.valid);
  if (v == 0) visible[row] = any_valid != 0;

  // SDF update (fields/sdf.py)
  const size_t idx = static_cast<size_t>(row) * kBlockVoxels + v;
  const float t0 = tsdf[idx];
  const float w0 = weight[idx];
  const float nx = s.cx / s.zs;
  const float ny = s.cy / s.zs;
  const float norm = sqrtf((1.0f + nx * nx) + ny * ny);
  const float diff = (s.ds - s.cz) * norm;
  float t = t0;
  float w = w0;
  if (s.fuse && s.ds > 0.0f && diff > -mu) {
    const float sdf = fminf(diff / mu, 1.0f);
    t = fminf(fmaxf((w0 * t0 + sdf) / (w0 + 1.0f), -1.0f), 1.0f);
    w = fminf(w0 + 1.0f, max_weight);
  }
  tsdf_out[idx] = t;
  weight_out[idx] = w;
}

__global__ void __launch_bounds__(kBlockVoxels)
fuse_ofusion_kernel(const int32_t* __restrict__ bc,
                    const uint8_t* __restrict__ live,
                    const float* __restrict__ occupancy,
                    const float* __restrict__ timestamp,
                    const float* __restrict__ depth,
                    const float* __restrict__ t_cw,   // [4,4] row-major
                    const float* __restrict__ k,      // [4,4] row-major
                    float* __restrict__ occupancy_out,
                    float* __restrict__ timestamp_out,
                    uint8_t* __restrict__ visible,
                    int H, int W, float mu, float sigma_lo, float now,
                    float voxel_size, float diag, int patch) {
  const int row = blockIdx.x;
  const int v = threadIdx.x;
  const VoxelSample s = project_voxel(bc, live, depth, t_cw, k, row, v, H, W,
                                      voxel_size, diag, patch);
  const int any_valid = __syncthreads_or(s.valid);
  if (v == 0) visible[row] = any_valid != 0;

  // log-odds update (fields/ofusion.py)
  const size_t idx = static_cast<size_t>(row) * kBlockVoxels + v;
  const float occ0 = occupancy[idx];
  const float ts0 = timestamp[idx];
  const float nx = s.cx / s.zs;
  const float ny = s.cy / s.zs;
  const float norm = sqrtf((1.0f + nx * nx) + ny * ny);
  const float diff = (s.cz - s.ds) * norm;
  // max(lo, min(v, hi)): the lower bound wins when lo > hi
  const float sigma = fmaxf(fminf((mu * s.cz) * s.cz, 0.05f), sigma_lo);
  const float t = diff / sigma;
  const float h = bspline_cdf(t) - 0.5f * bspline_cdf(t - 3.0f);
  float occ = occ0;
  float ts = ts0;
  if (s.fuse && s.ds > 0.0f && h != 0.5f) {
    const float p = fminf(fmaxf(h, 0.03f), 0.97f);
    const float frac = fmaxf(1.0f / (1.0f + (now - ts0) / 4.0f), 0.5f);
    occ = fminf(fmaxf(occ0 * frac + logf(p / (1.0f - p)) / kLn2, -1000.0f),
                1000.0f);
    ts = now;
  }
  occupancy_out[idx] = occ;
  timestamp_out[idx] = ts;
}

}  // namespace

extern "C" int fuse_sdf(const void* bc, const void* live, const void* tsdf,
                        const void* weight, const void* depth,
                        const void* t_cw, const void* k, void* tsdf_out,
                        void* weight_out, void* visible, int n, int H, int W,
                        float mu, float max_weight, float voxel_size,
                        float diag, int patch, void* stream) {
  fuse_sdf_kernel<<<n, kBlockVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bc), static_cast<const uint8_t*>(live),
      static_cast<const float*>(tsdf), static_cast<const float*>(weight),
      static_cast<const float*>(depth), static_cast<const float*>(t_cw),
      static_cast<const float*>(k), static_cast<float*>(tsdf_out),
      static_cast<float*>(weight_out), static_cast<uint8_t*>(visible), H, W,
      mu, max_weight, voxel_size, diag, patch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fuse_ofusion(const void* bc, const void* live,
                            const void* occupancy, const void* timestamp,
                            const void* depth, const void* t_cw,
                            const void* k, void* occupancy_out,
                            void* timestamp_out, void* visible, int n, int H,
                            int W, float mu, float sigma_lo, float now,
                            float voxel_size, float diag, int patch,
                            void* stream) {
  fuse_ofusion_kernel<<<n, kBlockVoxels, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bc), static_cast<const uint8_t*>(live),
      static_cast<const float*>(occupancy),
      static_cast<const float*>(timestamp), static_cast<const float*>(depth),
      static_cast<const float*>(t_cw), static_cast<const float*>(k),
      static_cast<float*>(occupancy_out), static_cast<float*>(timestamp_out),
      static_cast<uint8_t*>(visible), H, W, mu, sigma_lo, now, voxel_size,
      diag, patch);
  return static_cast<int>(cudaGetLastError());
}
