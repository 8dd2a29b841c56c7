// Projective map updates in place on the block table, for Hopper (sm_90a):
// SDF (fuse_sdf) and OFusion (fuse_ofusion), each launch also running the
// coarse node pyramid's update (node_cells) where the caller asks, and the
// fusion's frustum selection (frustum_select), which shares the
// projection.
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

#include "look_back.cuh"
#include "lu_inverse.cuh"

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

// SDF update of one voxel (fields/sdf.py), for a sample with ds > 0, rounded
// as XLA rounds the JAX update: multiply-adds, and the division by mu a
// product with its reciprocal.
struct SdfUpdate {
  float mu, max_weight;
  static constexpr bool kView = true;
  // returns whether the voxel was updated
  __device__ __forceinline__ bool operator()(const VoxelSample& s, float& t,
                                             float& w) const {
    const float nx = s.cx / s.zs;
    const float ny = s.cy / s.zs;
    const float norm = sqrtf(fmaf(ny, ny, fmaf(nx, nx, 1.0f)));
    const float diff = (s.ds - s.cz) * norm;
    if (!(diff > -mu)) return false;
    const float sdf = fminf(diff * (1.0f / mu), 1.0f);
    t = fminf(fmaxf(fmaf(w, t, sdf) / (w + 1.0f), -1.0f), 1.0f);
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

struct Projected {
  float cx, cy, cz, zs, px, py;
};

// integrate_kernel.project: T_cw then K's first two rows, multiply-add
// chains as numerics.matvec, the pixel +0.5.
__device__ __forceinline__ Projected project_point(const float* T,
                                                   const float* K, float wx,
                                                   float wy, float wz) {
  Projected q;
  q.cx = fmaf(T[2], wz, fmaf(T[1], wy, T[0] * wx)) + T[3];
  q.cy = fmaf(T[6], wz, fmaf(T[5], wy, T[4] * wx)) + T[7];
  q.cz = fmaf(T[10], wz, fmaf(T[9], wy, T[8] * wx)) + T[11];
  q.zs = q.cz == 0.0f ? 1.0f : q.cz;
  const float h0 = fmaf(K[2], q.cz, fmaf(K[1], q.cy, K[0] * q.cx));
  const float h1 = fmaf(K[6], q.cz, fmaf(K[5], q.cy, K[4] * q.cx));
  q.px = h0 / q.zs + 0.5f;
  q.py = h1 / q.zs + 0.5f;
  return q;
}

// ---------------------------------------------------------------------
// The coarse node pyramid's update, inside the fusion's launch
// ---------------------------------------------------------------------
//
// What it replaces.  The port's node update in PyTorch (about 25
// launches a level, 5 levels at 256^3 and 7 at 1024^3), the counterpart of
// supereight_tpu/pipeline/integration.py:581-600: every cell of node
// levels 1..block_level projects its corner (the cell's index times its
// edge), and an allocated cell whose corner lands in the frame takes its
// depth sample (the nearest pixel, int-truncated and clamped) through the
// field's update, the same device code as the fusion's.  The values go to
// new tables (the map's node tables are not written in place).  It reads
// only the node tables, their allocation flags, the depth, T_cw and K, and
// the fusion writes none of them, so the fusion's launch runs it: its grid
// gets node_ctas(N) CTAs after its row CTAs, a cell a thread, through
// node_cells.  What bounds it: nothing but the launch at 256^3 (37448
// cells, 0.6 MB), which it now shares with the fusion; the bytes at 1024^3
// (2.4 M cells, 41 MB read and written once): a thread's loads (its cell's
// two channels and flag, its depth sample) are issued together before the
// update.  Two cells a thread spilled under the fusion's 40 registers.

constexpr int kMaxNodeLevels = 12;

struct Nodes {
  const float* a[kMaxNodeLevels];       // channel 0 of each level [s^3]
  const float* b[kMaxNodeLevels];       // channel 1
  const uint8_t* alloc[kMaxNodeLevels];
  float* out_a[kMaxNodeLevels];
  float* out_b[kMaxNodeLevels];
  float cell[kMaxNodeLevels];           // the level's cell edge in m
  int first[kMaxNodeLevels + 1];        // the level's first cell
  int n_levels;                         // 0: no node update
};

// Cell cta * kThreads + threadIdx.x of the node update.  Level l (of edge
// s = 2 << l cells) holds the cells first[l] .. first[l + 1] - 1.
template <class Update>
__device__ __forceinline__ void node_cells(const Table& tb, const Nodes& N,
                                           const Update& up, int cta) {
  // T_cw and K in shared memory, read where the projection needs them
  __shared__ float t_cw[12], k[8];
  if (threadIdx.x < 12) t_cw[threadIdx.x] = tb.t_cw[threadIdx.x];
  if (threadIdx.x < 7) k[threadIdx.x] = tb.k[threadIdx.x];
  __syncthreads();
  const int g = cta * kThreads + threadIdx.x;
  if (g >= N.first[N.n_levels]) return;
  int l = 0;
  while (g >= N.first[l + 1]) ++l;
  const int idx = g - N.first[l];
  const float a0 = N.a[l][idx], b0 = N.b[l][idx];
  const bool alloc = N.alloc[l][idx] != 0;
  const int s = 2 << l;
  const float c = N.cell[l];
  const Projected q = project_point(
      t_cw, k, static_cast<float>(idx / (s * s)) * c,
      static_cast<float>((idx / s) % s) * c, static_cast<float>(idx % s) * c);
  // integration._pixel_valid
  VoxelSample v;
  v.cx = q.cx;
  v.cy = q.cy;
  v.cz = q.cz;
  v.zs = q.zs;
  v.valid = q.cz >= 1e-4f && q.px >= 0.5f &&
            q.px <= static_cast<float>(tb.W) - 1.5f && q.py >= 0.5f &&
            q.py <= static_cast<float>(tb.H) - 1.5f;
  // integration._sample_depth: int-truncated, clamped
  const int ix = min(max(__float2int_rz(q.px), 0), tb.W - 1);
  const int iy = min(max(__float2int_rz(q.py), 0), tb.H - 1);
  v.pixel = iy * tb.W + ix;
  v.ds = v.valid ? tb.depth[v.pixel] : 0.0f;
  float a = a0, b = b0;
  // the cell takes its sample where it is allocated and in the frame
  if (alloc && v.valid && v.ds > 0.0f) up(v, a, b);
  N.out_a[l][idx] = a;
  N.out_b[l][idx] = b;
}

__host__ __device__ __forceinline__ int node_ctas(const Nodes& N) {
  return (N.first[N.n_levels] + kThreads - 1) / kThreads;
}

// One CTA per row: row i fuses slots[i] (a slot outside the table returns
// at once), or slot i on the whole-table branch, where a slot that is not
// live returns at once.  A thread's channel bytes move only where one of
// its voxels is in the patch (loads) or was updated (stores; see above).
// The CTAs after the n_rows rows update the node pyramid (node_cells).
// Under the 40 registers the node path adds spill stores to fuse_ofusion
// (-Xptxas -v: 48 bytes where the fusion alone had 28; fuse_sdf keeps its
// 20).  __grid_constant__ operands avoided them, but measured slower on
// the rows than the spills cost.
template <class Update>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
fuse_kernel(const Table tb, const Update up, const Nodes N) {
  __shared__ RowParams p;
  if (static_cast<int>(blockIdx.x) >= tb.n_rows) {
    node_cells(tb, N, up, blockIdx.x - tb.n_rows);
    return;
  }
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
int launch(const Table& tb, const Update& up, const Nodes& N,
           void* stream) {
  const int ctas = tb.n_rows + node_ctas(N);
  if (tb.n_rows < 0 || ctas <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  fuse_kernel<Update><<<ctas, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(tb, up, N);
  return static_cast<int>(cudaGetLastError());
}

// Nodes from the host's pointers: ptrs holds 3 x n_levels (each level's
// channel 0, then each's channel 1, then each's alloc), out the new tables,
// 2 x cells float32 (each level's new channel 0, then its channel 1, level
// after level), cell each level's cell edge in m; level l (0-based) is node level
// l + 1, of (2 << l)^3 cells.  n_levels 0: no node update.  Returns false
// for a level count or a size the kernel does not take.
bool make_nodes(Nodes& N, void* const* ptrs, void* out, const float* cell,
                int n_levels) {
  if (n_levels < 0 || n_levels > kMaxNodeLevels) return false;
  N.n_levels = n_levels;
  N.first[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    N.a[l] = static_cast<const float*>(ptrs[l]);
    N.b[l] = static_cast<const float*>(ptrs[n_levels + l]);
    N.alloc[l] = static_cast<const uint8_t*>(ptrs[2 * n_levels + l]);
    N.cell[l] = cell[l];
    const long long s = 2LL << l;
    if (N.first[l] + s * s * s > 0x3fffffffLL - kThreads) return false;
    N.first[l + 1] = N.first[l] + static_cast<int>(s * s * s);
  }
  for (int l = 0; l < n_levels; ++l) {
    N.out_a[l] = static_cast<float*>(out) + 2 * N.first[l];
    N.out_b[l] = N.out_a[l] + (N.first[l + 1] - N.first[l]);
  }
  return true;
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

// ---------------------------------------------------------------------
// frustum_select: the budget branch's slots and T_cw, on the card
// ---------------------------------------------------------------------
//
// What it replaces.  pipeline/integration.py:frustum_candidates and the
// compaction of fusion_operands (about twenty launches over the whole slot
// table, then torch.nonzero and a host read of the count), the counterpart
// of supereight_tpu/pipeline/integration.py:515-536, and the fusion's
// inverse before it (:503, T_cw = jnp.linalg.inv(pose), which the port ran
// as its own launch of pose_inv): a live active slot is a candidate when
// its block's centre projects into the frame dilated by the block's
// footprint and the block is not wholly behind the camera; the first
// `budget` candidates in ascending slot order are the slots (-1 past the
// count, jnp.nonzero's fill), and max(count - budget, 0) adds to the map's
// overflow.
//
// One launch, a tile of kSelectTile slots a CTA (kSelectSlots consecutive
// slots a thread).  Thread 0 of every CTA inverts the pose in registers
// (lu_inverse.cuh, as pose_inv and R1 do: the same code and flags, so T_cw
// is pose_inv's bit for bit) while the other threads load their slots'
// keys, `active` flags and partition counts; tile 0's CTA writes T_cw.
// Each thread tests its slots (the projection is the twin's: fmaf chains
// as numerics.matvec, the full K rows), a warp scan of the threads'
// counts ranks them in the tile, and a decoupled look-back over the tiles
// before it (look_back.cuh; the tile drawn from a ticket) gives the
// tile's first rank: a candidate writes its slot there if that is below
// the budget.  The -1 fill is spread over the tiles, though only the last
// knows the total: with `before` the candidates of the tiles before tile
// t and `count` its own, no candidate lands at or past L(t) = before +
// count + the slots after tile t, so tile t writes -1 to [L(t), L(t - 1))
// below the budget (L(-1) the budget): disjoint ranges, each at most the
// tile's non-candidates, whose union is [total, budget).  The last tile
// writes the overflow.  Every number is an integer sum, so the result does
// not depend on the order the tiles run in; the status words and the
// tickets start zero and the last tile to end its look-back leaves them
// zero.  What bounds it: the launch, the one thread's inverse and the
// look-back (the bytes, `active` and the live slots' keys, are 70 KB at
// 6144 slots, 20 ns at 3.35 TB/s).
// The tile's shape, timed on an H100 (700 W) among 1024 x 1, 1024 x 2,
// 1024 x 4, 512 x 1, 256 x 4 threads x slots and 1024 threads held to two
// CTAs an SM: 512 x 2 (46 registers, two CTAs an SM, so 196608 slots are
// one wave of 192 tiles) was the fastest or within 0.4 us of it at 6144,
// 24576 and 196608 slots.

constexpr int kSelectThreads = 512;       // threads a tile (a CTA)
constexpr int kSelectSlots = 2;           // consecutive slots a thread
constexpr int kSelectTile = kSelectThreads * kSelectSlots;   // slots a tile
constexpr int kWarps = kSelectThreads / 32;

struct Select {
  const int64_t* keys;          // [capacity]
  const uint8_t* active;        // [capacity]
  const int32_t* counts;        // [partitions] live slots of each range
  const float* pose;            // [4, 4]
  const float* k;               // [4, 4]
  int32_t* slots;               // [budget] out
  float* t_cw;                  // [4, 4] out: inv(pose)
  unsigned long long* status;   // [>= tiles] the look-back's words, zero
  uint32_t* ctl;                // [2] tickets drawn, look-backs ended; zero
  const int32_t* overflow_in;   // []
  int32_t* overflow_out;        // [] out: overflow_in + dropped
  int capacity, per_cap, H, W, budget;
  float voxel_size, diag;
};

// frustum_candidates' test of one slot with T_cw (shared memory) and K;
// kk the slot's key, read while the pose is inverted.
__device__ __forceinline__ bool candidate(const Select& S, const float* T,
                                          const float* K, bool live,
                                          uint32_t kk) {
  if (!live) return false;
  const float vs = S.voxel_size;
  const float wx = (static_cast<float>(compact_bits(kk) * 8) + 4.0f) * vs;
  const float wy = (static_cast<float>(compact_bits(kk >> 1) * 8) + 4.0f) * vs;
  const float wz = (static_cast<float>(compact_bits(kk >> 2) * 8) + 4.0f) * vs;
  const Projected q = project_point(T, K, wx, wy, wz);
  // torch.clamp(z, min=1e-3) keeps a NaN
  const float zc = q.cz < 1e-3f ? 1e-3f : q.cz;
  const float foot = fabsf(K[0]) * S.diag / zc;
  return q.cz > -0.5f * S.diag && q.px >= -foot &&
         q.px <= static_cast<float>(S.W - 1) + foot && q.py >= -foot &&
         q.py <= static_cast<float>(S.H - 1) + foot;
}

// Slot `slot`'s live test and key: a live active slot of its partition.
__device__ __forceinline__ bool live_slot(const Select& S, int slot,
                                          uint32_t* kk) {
  const bool live = slot < S.capacity && S.active[slot] != 0 &&
                    slot % S.per_cap < S.counts[slot / S.per_cap];
  *kk = live ? static_cast<uint32_t>(S.keys[slot]) : 0u;
  return live;
}

__global__ void __launch_bounds__(kSelectThreads)
frustum_select_kernel(const Select S) {
  __shared__ float T[16], Ks[16];
  __shared__ int tile_s, before_s, count_w[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    // tiles in ticket order: every tile before this one has started
    tile_s = static_cast<int>(atomicAdd(S.ctl, 1u));
    float A[4][4], X[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[i][j] = S.pose[i * 4 + j];
    lu::lu_inverse<4>(A, X);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) T[i * 4 + j] = X[i][j];
  } else if (threadIdx.x < 32 + 16 && threadIdx.x >= 32) {
    Ks[threadIdx.x - 32] = S.k[threadIdx.x - 32];
  }
  // this thread's kSelectSlots consecutive slots by blockIdx (the tile is
  // known only after the barrier): their loads go out while thread 0
  // inverts
  const int first = (blockIdx.x * kSelectThreads + threadIdx.x) *
                    kSelectSlots;
  bool live[kSelectSlots];
  uint32_t kk[kSelectSlots];
#pragma unroll
  for (int j = 0; j < kSelectSlots; ++j)
    live[j] = live_slot(S, first + j, &kk[j]);
  __syncthreads();
  const int tile = tile_s;
  const int base = (tile * kSelectThreads + threadIdx.x) * kSelectSlots;
  if (tile != static_cast<int>(blockIdx.x)) {
#pragma unroll
    for (int j = 0; j < kSelectSlots; ++j)
      live[j] = live_slot(S, base + j, &kk[j]);
  }
  if (tile == 0 && threadIdx.x < 16) S.t_cw[threadIdx.x] = T[threadIdx.x];
  bool flag[kSelectSlots];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kSelectSlots; ++j) {
    flag[j] = candidate(S, T, Ks, live[j], kk[j]);
    mine += flag[j];
  }

  // the thread's first rank among the tile's candidates (the warps before
  // its own, the lanes before it), the tile's count
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) count_w[warp] = incl;
  __syncthreads();
  int count = 0, rank = incl - mine;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    count += count_w[i];
    rank += i < warp ? count_w[i] : 0;
  }
  if (warp == 0) {
    // the candidates of the tiles before this one
    const int before = lb::look_back(S.status, tile, count, lane);
    if (lane == 0) before_s = before;
    lb::end_look_back(S.status, S.ctl, lane);
  }
  __syncthreads();
  const int before = before_s;
#pragma unroll
  for (int j = 0; j < kSelectSlots; ++j) {
    if (flag[j] && before + rank < S.budget) S.slots[before + rank] = base + j;
    rank += flag[j];
  }
  // this tile's share of jnp.nonzero's fill past the count: [L(t),
  // L(t - 1)) below the budget
  const int start = tile * kSelectTile;
  const int end = min(S.capacity, start + kSelectTile);
  const int lo = min(before + count + (S.capacity - end), S.budget);
  const int hi = tile == 0 ? S.budget
                           : min(before + (S.capacity - start), S.budget);
  for (int q = lo + static_cast<int>(threadIdx.x); q < hi;
       q += kSelectThreads)
    S.slots[q] = -1;
  if (tile == static_cast<int>(gridDim.x) - 1 && threadIdx.x == 0)
    S.overflow_out[0] = S.overflow_in[0] + max(before + count - S.budget, 0);
}

}  // namespace

// n_rows: the length of `slots`, or the capacity when slots is null (the
// whole-table branch); 0 with nodes alone.  `view` may be null; a given
// view must hold the encoding of the table's rows (a held view does),
// since only the entries of updated voxels are written.  Repeated slots
// race.  node_ptrs, node_out, node_cell, n_levels: the node pyramid's
// levels 1..n_levels and their new tables (make_nodes), updated in the
// same launch; n_levels 0 for none.
extern "C" int fuse_sdf(const void* slots, const void* keys,
                        const void* n_blocks, void* active, void* tsdf,
                        void* weight, void* view, const void* depth,
                        const void* t_cw, const void* k, int n_rows,
                        int capacity, int H, int W, int B, float mu,
                        float max_weight, float voxel_size, float diag,
                        int patch, void* const* node_ptrs, void* node_out,
                        const float* node_cell, int n_levels, void* stream) {
  Nodes N;
  if (!make_nodes(N, node_ptrs, node_out, node_cell, n_levels))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(make_table(slots, keys, n_blocks, active, tsdf, weight, view,
                           depth, t_cw, k, n_rows, capacity, H, W, B,
                           voxel_size, diag, patch),
                SdfUpdate{mu, max_weight}, N, stream);
}

extern "C" int fuse_ofusion(const void* slots, const void* keys,
                            const void* n_blocks, void* active,
                            void* occupancy, void* timestamp,
                            const void* depth, const void* t_cw,
                            const void* k, int n_rows, int capacity, int H,
                            int W, float mu, float sigma_lo, float now,
                            float voxel_size, float diag, int patch,
                            void* const* node_ptrs, void* node_out,
                            const float* node_cell, int n_levels,
                            void* stream) {
  Nodes N;
  if (!make_nodes(N, node_ptrs, node_out, node_cell, n_levels))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(make_table(slots, keys, n_blocks, active, occupancy,
                           timestamp, nullptr, depth, t_cw, k, n_rows,
                           capacity, H, W, 0, voxel_size, diag, patch),
                OFusionUpdate{mu, sigma_lo, now}, N, stream);
}

// keys, active: the map's [capacity]; counts: [capacity / per_cap] live
// slots of each partition's range (n_blocks for one); pose, k: [4, 4];
// slots: [budget] out; t_cw: [4, 4] out (inv(pose));
// status: [>= ceil(capacity / kSelectTile)] uint64 and ctl: [2] uint32,
// zero and left zero; overflow_in, overflow_out: int32[] (may not alias).
// 0 < budget.
extern "C" int frustum_select(const void* keys, const void* active,
                              const void* counts, const void* pose,
                              const void* k, void* slots, void* t_cw,
                              void* status, void* ctl,
                              const void* overflow_in, void* overflow_out,
                              int capacity, int per_cap, int H, int W,
                              int budget, float voxel_size, float diag,
                              void* stream) {
  if (capacity <= 0 || per_cap <= 0 || budget <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (capacity + kSelectTile - 1) / kSelectTile;
  const Select S{static_cast<const int64_t*>(keys),
                 static_cast<const uint8_t*>(active),
                 static_cast<const int32_t*>(counts),
                 static_cast<const float*>(pose),
                 static_cast<const float*>(k),
                 static_cast<int32_t*>(slots),
                 static_cast<float*>(t_cw),
                 static_cast<unsigned long long*>(status),
                 static_cast<uint32_t*>(ctl),
                 static_cast<const int32_t*>(overflow_in),
                 static_cast<int32_t*>(overflow_out),
                 capacity, per_cap, H, W, budget, voxel_size, diag};
  frustum_select_kernel<<<tiles, kSelectThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(S);
  return static_cast<int>(cudaGetLastError());
}
