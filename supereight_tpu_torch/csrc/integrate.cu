// Projective map updates in place on the block table, for Hopper (sm_90a):
// SDF (fuse_sdf) and OFusion (fuse_ofusion).
//
// What they replace.  fuse_sdf replaces supereight_tpu/ops/integrate_kernel.py:
// _kernel / fused_integrate (the Pallas TPU kernel K1) and, like fuse_ofusion,
// the body of supereight_tpu/pipeline/integration.py:fuse_rows (the XLA path
// the JAX pipeline runs; K1 never covered OFusion) together with the row
// gather before it and the row scatter after it (integrate's
// `.at[tgt].set`).  For each voxel of each fused block: world position ->
// T_cw -> K projection -> in-frame test -> the block's footprint level and
// patch origin -> nearest depth sample -> the field's update (fields/sdf.py
// or fields/ofusion.py), and the block's any-voxel-visible flag, which
// becomes its `active` flag.
//
// The operands are the map's own tables: the two [capacity, 512] float32
// channels and `active`, all updated in place, the int64 Morton keys and the
// device count n_blocks.  On the budget branch CTA i fuses slot slots[i]
// (ascending and unique, so no two CTAs touch one row; a slot outside the
// table returns at once); on the whole-table branch CTA i is slot i, and a
// slot that is not live (i >= n_blocks or !active[i]) returns before any
// load or store of its row.  The block coordinates are decoded from the key
// in the kernel: the map holds keys, not coordinates, so this reads 8 bytes
// a row and saves the caller a [capacity, 3] decode.  With a held SDF view,
// which holds the bf16 encoding of the table's rows (weight != 0 ? tsdf :
// NaN, rounded to nearest even as PyTorch rounds) in view row
// (bx * B + by) * B + bz, fuse_sdf rewrites the entries of the voxels it
// updates, so the view stays that encoding.
//
// What bounds it on the H100.  Bytes: whether a voxel updates depends on
// the pose, the depth image and the field's parameters, never on the stored
// values, so the function needs only the channel bytes of the voxels it
// updates, read and written (at most 8 KB a row: 25 MB a frame at the
// headline budget of 3072 rows, 7.5 us at 3.35 TB/s), the keys, `active`
// and the 300 KB depth image, which stays in L2.  Instructions: parity with
// the twins needs IEEE division (six a voxel for the SDF, about ten and a
// logarithm for OFusion) and unfused multiply-adds, so a fused voxel takes
// a few hundred instructions, and issuing them can take longer than moving
// the bytes (probes/sass_count.py counts them in the compiled code).  What
// the design does about both:
// - 128 threads a row, each owning 4 x-consecutive voxels of each channel:
//   one 16-byte load and one 16-byte store a channel.  A thread loads them
//   only when one of its voxels is in frame and in the patch, and stores
//   them only when one of them was updated: a row that is not visible moves
//   none of its channel bytes.
// - Everything that is the same for a whole row (the key's decode, T_cw
//   and K, the block corner, the centre's projection, footprint level and
//   patch origin) is computed once, by thread 0, and read from shared
//   memory: the per-voxel work is only the voxel's own.
// - A thread projects its four voxels, then issues its channel loads and
//   the four depth loads together, then updates them; a voxel that does
//   not fuse skips its update arithmetic; bspline_cdf divides once, for the
//   branch it returns.
// - `visible` is __syncthreads_or of each thread's four in-frame &
//   in-patch flags, as the XLA path computes it.
// - 12 resident CTAs an SM (__launch_bounds__(128, 12)): the dependent
//   chains of divisions need warps to hide them.
// A persistent grid that loads the next row while fusing the current one
// was tried and was no faster, so the grid is one CTA per row.
// The TPU version gathered a 16x16 depth patch per block from a stride-2^lvl
// atlas; the patch test bounds each voxel's level-lvl pixel to the patch,
// so the sample is exactly depth[(iy>>lvl)<<lvl, (ix>>lvl)<<lvl] and is read
// straight from the depth image.
//
// Rounding.  Float-to-int casts use __float2int_rz, which truncates and
// saturates like XLA's convert.  The projections are explicit fmaf chains,
// the order XLA's CPU dot evaluates the JAX einsums in; everything else is
// built with --fmad=false and IEEE division, so every product and sum
// rounds as the plain PyTorch twins' do (x / 4 is computed as x * 0.25,
// which is exact).  fuse_sdf and its twin agree bit for bit.  OFusion's
// log-odds take a logarithm: jnp.log2 is log(x) / log(2), so the kernel
// computes logf(x) / ln2 (not log2f, and not the approximate __logf) with
// the twin's float32 ln2; `visible` and `timestamp` match the twin exactly,
// `occupancy` to the last bits of logf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockVoxels = 512;
constexpr int kVoxelsPerThread = 4;
constexpr int kThreads = kBlockVoxels / kVoxelsPerThread;   // 128 a row
// CTAs an SM keeps resident (1536 threads, 40 registers each)
constexpr int kMinBlocksPerSM = 12;
constexpr float kLn2 = 0.693147182f;   // float32(log(2)), as jnp.log2 uses
constexpr uint16_t kBf16NaN = 0x7FC0;  // a quiet bf16 NaN

// What every voxel of a row shares, computed once by thread 0.
struct RowParams {
  float T[12];                  // T_cw rows 0-2, row-major
  float K00, K02, K11, K12;
  float bx, by, bz;             // block corner in voxels, as float
  int lvl, p0r, p0c;            // footprint level and patch origin
  int64_t view_row;             // (bx * B + by) * B + bz, in blocks
};

// A launch's operands (the map's tables, the frame, the sizes).
struct Table {
  const int32_t* slots;         // [n_rows] or null: slot = row
  const int64_t* keys;          // [capacity] block Morton keys
  const int32_t* n_blocks;      // [] live slots are a prefix below it
  uint8_t* active;              // [capacity], updated
  float* a;                     // [capacity, 512] channel 0, updated
  float* b;                     // [capacity, 512] channel 1, updated
  uint16_t* view;               // [B^3, 512] bf16 held view, or null
  const float* depth;           // [H, W]
  const float* t_cw;            // [4, 4] row-major
  const float* k;               // [4, 4] row-major
  int n_rows, capacity, H, W, B;
  float voxel_size, diag;
  int patch;
};

// Collect every 3rd bit of v into the low 10 (morton.compact_bits).
__device__ __forceinline__ int compact_bits(uint32_t v) {
  v &= 0x09249249u;
  v = (v ^ (v >> 2)) & 0x030C30C3u;
  v = (v ^ (v >> 4)) & 0x0300F00Fu;
  v = (v ^ (v >> 8)) & 0x030000FFu;
  v = (v ^ (v >> 16)) & 0x000003FFu;
  return static_cast<int>(v);
}

// The row's shared parameters (fuse_rows' formulas; integration.py:408-433).
__device__ void row_params(RowParams& p, int64_t key, const Table& tb) {
  for (int i = 0; i < 12; ++i) p.T[i] = tb.t_cw[i];
  p.K00 = tb.k[0];
  p.K02 = tb.k[2];
  p.K11 = tb.k[5];
  p.K12 = tb.k[6];
  const uint32_t kk = static_cast<uint32_t>(key);
  const int cx = compact_bits(kk), cy = compact_bits(kk >> 1),
            cz = compact_bits(kk >> 2);
  p.view_row = (static_cast<int64_t>(cx) * tb.B + cy) * tb.B + cz;
  p.bx = static_cast<float>(cx * 8);
  p.by = static_cast<float>(cy * 8);
  p.bz = static_cast<float>(cz * 8);

  const float* T = p.T;
  const float gx = (p.bx + 4.0f) * tb.voxel_size;
  const float gy = (p.by + 4.0f) * tb.voxel_size;
  const float gz = (p.bz + 4.0f) * tb.voxel_size;
  const float ccx = fmaf(T[2], gz, fmaf(T[1], gy, T[0] * gx)) + T[3];
  const float ccy = fmaf(T[6], gz, fmaf(T[5], gy, T[4] * gx)) + T[7];
  const float ccz = fmaf(T[10], gz, fmaf(T[9], gy, T[8] * gx)) + T[11];
  const float foot = fabsf(p.K00) * tb.diag / fmaxf(ccz, 1e-3f);
  const float ratio = foot / static_cast<float>(tb.patch);
  // clip(ceil(log2(max(ratio, 1))), 0, 3) without a log
  const int lvl = (ratio > 1.0f) + (ratio > 2.0f) + (ratio > 4.0f);
  const float czs = (ccz == 0.0f) ? 1.0f : ccz;
  const float cpx = fmaf(p.K02, ccz, p.K00 * ccx) / czs + 0.5f;
  const float cpy = fmaf(p.K12, ccz, p.K11 * ccy) / czs + 0.5f;
  const float stride = static_cast<float>(1 << lvl);
  // jnp.clip(x, lo, hi) is min(max(x, lo), hi): hi wins when lo > hi
  p.lvl = lvl;
  p.p0r = min(max(__float2int_rz(cpy / stride) - tb.patch / 2, 0),
              (tb.H >> lvl) - tb.patch);
  p.p0c = min(max(__float2int_rz(cpx / stride) - tb.patch / 2, 0),
              (tb.W >> lvl) - tb.patch);
}

struct VoxelSample {
  float cx, cy, cz;   // camera coordinates
  float zs;           // cz, with 0 -> 1
  bool valid;         // in frame and in the block's patch
  int pixel;          // the depth sample's index, where valid
  float ds;           // depth sample (0 unless valid)
};

// Projection and patch test of voxel v of the row, and the index of its
// depth sample (integration.py:408-464).
__device__ __forceinline__ VoxelSample project_voxel(const RowParams& p,
                                                     const Table& tb, int v) {
  const float* T = p.T;
  VoxelSample s;
  const float wx = (p.bx + static_cast<float>(v & 7)) * tb.voxel_size;
  const float wy = (p.by + static_cast<float>((v >> 3) & 7)) * tb.voxel_size;
  const float wz = (p.bz + static_cast<float>(v >> 6)) * tb.voxel_size;
  s.cx = fmaf(T[2], wz, fmaf(T[1], wy, T[0] * wx)) + T[3];
  s.cy = fmaf(T[6], wz, fmaf(T[5], wy, T[4] * wx)) + T[7];
  s.cz = fmaf(T[10], wz, fmaf(T[9], wy, T[8] * wx)) + T[11];
  s.zs = (s.cz == 0.0f) ? 1.0f : s.cz;
  // +0.5 so that the int cast rounds
  const float px = fmaf(p.K02, s.cz, p.K00 * s.cx) / s.zs + 0.5f;
  const float py = fmaf(p.K12, s.cz, p.K11 * s.cy) / s.zs + 0.5f;
  const bool in_frame = (s.cz >= 1e-4f) && (px >= 0.5f) &&
                        (px <= static_cast<float>(tb.W) - 1.5f) &&
                        (py >= 0.5f) &&
                        (py <= static_cast<float>(tb.H) - 1.5f);
  const int lvl = p.lvl;
  const int iy = __float2int_rz(py) >> lvl;
  const int ix = __float2int_rz(px) >> lvl;
  const int lr = iy - p.p0r;
  const int lc = ix - p.p0c;
  s.valid = in_frame && lr >= 0 && lr < tb.patch && lc >= 0 &&
            lc < tb.patch;
  s.pixel = s.valid ? (iy << lvl) * tb.W + (ix << lvl) : 0;
  return s;
}

// SDF update of one voxel (fields/sdf.py), for a sample with ds > 0.
struct SdfUpdate {
  float mu, max_weight;
  static constexpr bool kView = true;
  // returns whether the voxel was updated
  __device__ __forceinline__ bool operator()(const VoxelSample& s, float& t,
                                             float& w) const {
    const float nx = s.cx / s.zs;
    const float ny = s.cy / s.zs;
    const float norm = sqrtf((1.0f + nx * nx) + ny * ny);
    const float diff = (s.ds - s.cz) * norm;
    if (!(diff > -mu)) return false;
    const float sdf = fminf(diff / mu, 1.0f);
    t = fminf(fmaxf((w * t + sdf) / (w + 1.0f), -1.0f), 1.0f);
    w = fminf(w + 1.0f, max_weight);
    return true;
  }
};

// Integral of the cubic bspline sensor kernel (fields/ofusion.py); x ** 3 is
// x * (x * x), as lax.integer_pow multiplies.  The branches' values are
//   v1 = (a * (a * a)) / 48, v2 = 0.5 + ((t * a) * b) / 24,
//   v3 = 1 - (b * (b * b)) / 48;
// only the returned one is divided.
__device__ __forceinline__ float bspline_cdf(float t) {
  const float a = 3.0f + t;
  const float b = 3.0f - t;
  const bool mid = t > -1.0f && t <= 1.0f;
  const float num = t <= -1.0f ? a * (a * a) : mid ? (t * a) * b : b * (b * b);
  const float q = num / (mid ? 24.0f : 48.0f);
  return t <= -3.0f ? 0.0f
       : t <= -1.0f ? q
       : t <= 1.0f  ? 0.5f + q
       : t <= 3.0f  ? 1.0f - q
                    : 1.0f;
}

// Log-odds update of one voxel (fields/ofusion.py), for a sample with
// ds > 0.
struct OFusionUpdate {
  float mu, sigma_lo, now;
  static constexpr bool kView = false;
  // returns whether the voxel was updated
  __device__ __forceinline__ bool operator()(const VoxelSample& s,
                                             float& occ, float& ts) const {
    const float nx = s.cx / s.zs;
    const float ny = s.cy / s.zs;
    const float norm = sqrtf((1.0f + nx * nx) + ny * ny);
    const float diff = (s.cz - s.ds) * norm;
    // max(lo, min(v, hi)): the lower bound wins when lo > hi
    const float sigma = fmaxf(fminf((mu * s.cz) * s.cz, 0.05f), sigma_lo);
    const float t = diff / sigma;
    const float h = bspline_cdf(t) - 0.5f * bspline_cdf(t - 3.0f);
    if (h == 0.5f) return false;
    const float pr = fminf(fmaxf(h, 0.03f), 0.97f);
    const float frac = fmaxf(1.0f / (1.0f + (now - ts) * 0.25f), 0.5f);
    occ = fminf(fmaxf(occ * frac + logf(pr / (1.0f - pr)) / kLn2, -1000.0f),
                1000.0f);
    ts = now;
    return true;
  }
};

// float -> bf16 rounded to nearest even, as PyTorch's CPU cast rounds.
__device__ __forceinline__ uint32_t to_bf16(float x) {
  if (x != x) return kBf16NaN;
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float4 load4(const float* base, int slot, int v0) {
  return *reinterpret_cast<const float4*>(
      base + static_cast<size_t>(slot) * kBlockVoxels + v0);
}

__device__ __forceinline__ void store4(float* base, int slot, int v0,
                                       const float (&x)[4]) {
  *reinterpret_cast<float4*>(base + static_cast<size_t>(slot) * kBlockVoxels +
                             v0) = make_float4(x[0], x[1], x[2], x[3]);
}

// One CTA per row: row i fuses slots[i] (a slot outside the table returns
// at once), or slot i on the whole-table branch, where a slot that is not
// live returns at once.  A thread's channel bytes move only where one of
// its voxels is in the patch (loads) or was updated (stores; see above).
template <class Update>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
fuse_kernel(const Table tb, const Update up) {
  __shared__ RowParams p;
  int slot = blockIdx.x;
  if (tb.slots != nullptr) {
    slot = tb.slots[slot];
    if (static_cast<unsigned>(slot) >= static_cast<unsigned>(tb.capacity))
      return;
  } else if (slot >= *tb.n_blocks || tb.active[slot] == 0) {
    return;
  }
  if (threadIdx.x == 0) row_params(p, tb.keys[slot], tb);
  __syncthreads();

  // the four projections, then the channel loads and the four depth loads
  // together, then the updates
  const int v0 = threadIdx.x * kVoxelsPerThread;
  VoxelSample s[kVoxelsPerThread];
  bool any_valid = false;
#pragma unroll
  for (int j = 0; j < kVoxelsPerThread; ++j) {
    s[j] = project_voxel(p, tb, v0 + j);
    any_valid |= s[j].valid;
  }
  float4 ca = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cb = ca;
  if (any_valid) {
    ca = load4(tb.a, slot, v0);
    cb = load4(tb.b, slot, v0);
  }
#pragma unroll
  for (int j = 0; j < kVoxelsPerThread; ++j)
    s[j].ds = s[j].valid ? tb.depth[s[j].pixel] : 0.0f;
  float a[4] = {ca.x, ca.y, ca.z, ca.w};
  float b[4] = {cb.x, cb.y, cb.z, cb.w};
  bool updated = false;
#pragma unroll
  for (int j = 0; j < kVoxelsPerThread; ++j)
    if (s[j].valid && s[j].ds > 0.0f) updated |= up(s[j], a[j], b[j]);
  const int visible = __syncthreads_or(any_valid);
  if (threadIdx.x == 0) tb.active[slot] = visible != 0;
  if (!updated) return;
  store4(tb.a, slot, v0, a);
  store4(tb.b, slot, v0, b);
  if (Update::kView && tb.view != nullptr) {
    uint32_t e[4];
#pragma unroll
    for (int j = 0; j < kVoxelsPerThread; ++j)
      e[j] = b[j] != 0.0f ? to_bf16(a[j]) : kBf16NaN;
    *reinterpret_cast<uint2*>(tb.view + p.view_row * kBlockVoxels + v0) =
        make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
}

template <class Update>
int launch(const Table& tb, const Update& up, void* stream) {
  if (tb.n_rows <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  fuse_kernel<Update><<<tb.n_rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(tb, up);
  return static_cast<int>(cudaGetLastError());
}

Table make_table(const void* slots, const void* keys, const void* n_blocks,
                 void* active, void* a, void* b, void* view,
                 const void* depth, const void* t_cw, const void* k,
                 int n_rows, int capacity, int H, int W, int B,
                 float voxel_size, float diag, int patch) {
  return Table{static_cast<const int32_t*>(slots),
               static_cast<const int64_t*>(keys),
               static_cast<const int32_t*>(n_blocks),
               static_cast<uint8_t*>(active),
               static_cast<float*>(a),
               static_cast<float*>(b),
               static_cast<uint16_t*>(view),
               static_cast<const float*>(depth),
               static_cast<const float*>(t_cw),
               static_cast<const float*>(k),
               n_rows, capacity, H, W, B, voxel_size, diag, patch};
}

}  // namespace

// n_rows: the length of `slots`, or the capacity when slots is null (the
// whole-table branch).  `view` may be null; a given view must hold the
// encoding of the table's rows (a held view does), since only the entries
// of updated voxels are written.  Repeated slots race.
extern "C" int fuse_sdf(const void* slots, const void* keys,
                        const void* n_blocks, void* active, void* tsdf,
                        void* weight, void* view, const void* depth,
                        const void* t_cw, const void* k, int n_rows,
                        int capacity, int H, int W, int B, float mu,
                        float max_weight, float voxel_size, float diag,
                        int patch, void* stream) {
  return launch(make_table(slots, keys, n_blocks, active, tsdf, weight, view,
                           depth, t_cw, k, n_rows, capacity, H, W, B,
                           voxel_size, diag, patch),
                SdfUpdate{mu, max_weight}, stream);
}

extern "C" int fuse_ofusion(const void* slots, const void* keys,
                            const void* n_blocks, void* active,
                            void* occupancy, void* timestamp,
                            const void* depth, const void* t_cw,
                            const void* k, int n_rows, int capacity, int H,
                            int W, float mu, float sigma_lo, float now,
                            float voxel_size, float diag, int patch,
                            void* stream) {
  return launch(make_table(slots, keys, n_blocks, active, occupancy,
                           timestamp, nullptr, depth, t_cw, k, n_rows,
                           capacity, H, W, 0, voxel_size, diag, patch),
                OFusionUpdate{mu, sigma_lo, now}, stream);
}
