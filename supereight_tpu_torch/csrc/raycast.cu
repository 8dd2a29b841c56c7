// The raycast on the card, for Hopper (sm_90a): pipeline/raycast.py's
// phases as three hand-written kernels, each held bit for bit against its
// plain PyTorch twin.
//
// What it replaces.  The raycast of pipeline/raycast.py (about three
// hundred small PyTorch launches a raycast and two host reads: the second
// window's torch.nonzero and, where no view is held, pack_view's n_blocks),
// the counterpart of supereight_tpu/pipeline/raycast.py:254-712, which XLA
// fuses:
// - R1 splat_bounds (one launch; twin _splat_bounds_twin, JAX :254-350):
//   each CTA inverts the view in registers (lu_inverse.cuh, the template
//   pose_inv runs, so numerics.inv's bits), then a half-warp a slot: the
//   slot's inside-voxel flag (a reduction of its 512 voxels, or the given
//   inside_any), its block centre through inv(view) (numerics.matvec's
//   multiply-add chain), the in-view test, and the 3x3 footprint cells'
//   start and far depths by atomicMax on encoded float bits (start depths
//   >= near > 0 and far depths > 0, so the bits order as the floats; min and
//   max do not depend on the order, so this is scatter_reduce's result).
//   The CTA that draws the last ticket (after a __threadfence, as CUDA's
//   threadFenceReduction sample does) pools the grid (in shared memory up to
//   kPoolSmemCells cells, else in a scratch the wrapper gives): the two 3x3
//   pools, and with near_rescue the 25x25 min pool and the blind-zone
//   fallback, each separable (a row pass, then a column pass); it reads
//   the encoded grid from L2 (__ldcg) and leaves it and the ticket zero, so
//   the next launch on the stream needs no memset.
// - R2 with R3, ray_scan (twins ray_scan_twin, then ray_scan_second_twin:
//   _fine_scan, JAX :358-419, the second window :545-566, _midsolve
//   :470-487), a thread a scan ray: its direction as ray_directions
//   computes it (at half resolution the 2x2 mean in the twin's order), its
//   start and far bound from its splat cell, the n_fine + 1 samples of the
//   first window from the tiled view (bf16 or float32) with the last valid
//   sample carried forward (the twin's cummax), the first valid outside ->
//   inside crossing solved linearly.  With the second window, each flagged
//   ray's rank in raster order comes from a single-pass decoupled
//   look-back (Merrill & Garland 2016) over the tiles before its own (a
//   CTA takes its tile from a ticket, so every earlier tile has started)
//   and warp ballots.  The tile's flagged rays are compacted; while warp 0
//   looks back, the other warps scan one window deeper those that can rank
//   below the budget (the tile's first `budget`), and those that do
//   (exactly nonzero(...)[:budget]) take that window's hit; then the
//   midsolve of every hit.
// - R4 ray_refine_normals (twin ray_refine_normals_twin, JAX :376-441), a
//   thread a full-resolution pixel: its parent's hit and depth, the secant
//   re-solve at +/- 0.7 thickness from nearest or trilinear taps, the
//   vertex and ray distance, and the volume (6 taps at the vertex) or
//   hybrid (6 taps at the decimated half-resolution parent's vertex plus
//   the along-ray correction) normal, negated for an SDF, normalised,
//   (INVALID, 0, 0) where it is not valid.  A pixel whose parent missed
//   writes the miss at once: the twin's re-solve may move such a pixel's
//   depth, but nothing reads that depth.
//
// What bounds them.  Not bytes: R2 and R4 gather a few hundred thousand
// 2-4 byte view entries (a few MB of 32-byte sectors at 320x240) and R1
// reads the in-view slots' voxels (2 MB at the headline), a few
// microseconds of bytes against the launch floor of ~0.005 ms each.  What
// is left is latency: in R1 the view's inverse (one thread's dependent
// chain), the slowest CTA's voxel reads, the ticket and the last CTA's
// passes over the grid on one SM; in the scan a thread's window of
// gathers and the look-back's wait for the slowest tile before it.  So
// the design keeps one thread a ray, no host read from the splat to the
// maps and three launches a raycast; a window's samples are gathered a
// chunk of kChunk at a time, in one branch-free block, before its carry
// logic runs over them, so the early exit at the first crossing waits on
// one chunk's latency, not on a chain of dependent loads; the second
// window runs while warp 0 looks back.  The look-back's status words and
// the tiles' tickets live in a scratch the wrapper zeroes once: the last
// CTA to end its look-back leaves them zero for the next launch, as R1's
// last CTA leaves its grid.
//
// Rounding.  The build uses --fmad=false, so every product and sum rounds
// on its own except the fmaf calls, which stand where the twin calls
// numerics.fma (the block centre's projection, the norms' squared sums).
// Divisions are IEEE (the twin divides by the power-of-two cell, which
// CUDA's reciprocal keeps exact, or through numerics.div), roots correctly
// rounded, float -> int conversions __float2int_rz (saturating, NaN -> 0:
// numerics.trunc_i32), the clamps keep torch.clamp's NaN, and the hybrid
// normal's three-term dot product adds (x + y) + z, as the twin's
// numerics.dot3.  Every output equals its twin's bit for bit, on the card
// and on the CPU.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "lu_inverse.cuh"

namespace {

constexpr int kSplatThreads = 1024;    // a CTA of R1
constexpr int kSlotLanes = 16;         // R1's lanes a slot
constexpr int kSplatSlots = kSplatThreads / kSlotLanes;
constexpr int kPoolSmemCells = 3072;   // grids pooled in shared memory
constexpr int kScanThreads = 256;      // rays a tile (a CTA) of R2 with R3
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kChunk = 4;              // samples gathered before the carry
constexpr int kPixelThreads = 256;     // pixels a CTA of R4
constexpr int kBlockVoxels = 512;
constexpr float kInvalid = -2.0f;      // pipeline/constants.py INVALID

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// max(x, lo) and min(x, hi) as torch.clamp computes them: a NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// Collect every 3rd bit of v into the low 10 (morton.compact_bits).
__device__ __forceinline__ int compact_bits(uint32_t v) {
  v &= 0x09249249u;
  v = (v ^ (v >> 2)) & 0x030C30C3u;
  v = (v ^ (v >> 4)) & 0x0300F00Fu;
  v = (v ^ (v >> 8)) & 0x030000FFu;
  v = (v ^ (v >> 16)) & 0x000003FFu;
  return static_cast<int>(v);
}

// The tiled read view [B^3, 512] (bf16 or float32) and its volume.
struct Volume {
  const void* F;
  int bf16;
  int size;       // voxels an edge
  int B;          // blocks an edge
  float inv_vs;   // float32(1 / voxel size)
};

// The field's surface test (field.is_inside): f < surf (SDF) or f > surf
// (OFusion).
struct Field {
  float surf;
  int below;
};

__device__ __forceinline__ bool is_inside(const Field fd, float f) {
  return fd.below ? f < fd.surf : f > fd.surf;
}

__device__ __forceinline__ float view_value(const Volume V, int64_t i) {
  if (V.bf16)
    return __uint_as_float(
        static_cast<uint32_t>(static_cast<const uint16_t*>(V.F)[i]) << 16);
  return static_cast<const float*>(V.F)[i];
}

// trunc_i32(floor(p))
__device__ __forceinline__ int voxel_of(float p) {
  return __float2int_rz(floorf(p));
}

__device__ __forceinline__ bool in_volume(const Volume V, int x, int y,
                                          int z) {
  return x >= 0 && x < V.size && y >= 0 && y < V.size && z >= 0 &&
         z < V.size;
}

// _tiled_index of an in-volume voxel, flattened
__device__ __forceinline__ int64_t tiled(const Volume V, int x, int y,
                                         int z) {
  const int64_t row =
      (static_cast<int64_t>(x >> 3) * V.B + (y >> 3)) * V.B + (z >> 3);
  return row * kBlockVoxels + ((x & 7) + (y & 7) * 8 + (z & 7) * 64);
}

// _sample_volume: the nearest voxel's value, `fill` outside the volume
__device__ __forceinline__ float sample(const Volume V, const float p[3],
                                        float fill) {
  const int x = voxel_of(p[0]), y = voxel_of(p[1]), z = voxel_of(p[2]);
  if (!in_volume(V, x, y, z)) return fill;
  return view_value(V, tiled(V, x, y, z));
}

// int32 addition as PyTorch's (wrapping)
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// _sample_volume_interp: the 8 corners in the twin's order, NaN and
// out-of-volume taps reading `sub`
__device__ float sample_interp(const Volume V, const float p[3],
                               float sub) {
  const int b[3] = {voxel_of(p[0]), voxel_of(p[1]), voxel_of(p[2])};
  float fr[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) fr[a] = p[a] - static_cast<float>(b[a]);
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o[3] = {i & 1, (i >> 1) & 1, (i >> 2) & 1};
    const int x = add_wrap(b[0], o[0]), y = add_wrap(b[1], o[1]),
              z = add_wrap(b[2], o[2]);
    float val = sub;
    if (in_volume(V, x, y, z)) {
      const float v = view_value(V, tiled(V, x, y, z));
      if (!isnan(v)) val = v;
    }
    float w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) w[a] = o[a] ? fr[a] : 1.0f - fr[a];
    out = out + val * ((w[0] * w[1]) * w[2]);
  }
  return out;
}

// (origin + dir * z) * inv_vs
__device__ __forceinline__ void ray_point(const Volume V, const float o[3],
                                          const float d[3], float z,
                                          float p[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = (o[a] + d[a] * z) * V.inv_vs;
}

// ray_directions at pixel (x, y) of view = pose @ inv(K) [4, 4]
__device__ __forceinline__ void pixel_dir(const float* M, int xi, int yi,
                                          float d[3]) {
  const float x = static_cast<float>(xi), y = static_cast<float>(yi);
  d[0] = (M[0] * x + M[1] * y) + M[2];
  d[1] = (M[4] * x + M[5] * y) + M[6];
  d[2] = (M[8] * x + M[9] * y) + M[10];
}

__device__ __forceinline__ void view_origin(const float* M, float o[3]) {
  o[0] = M[3];
  o[1] = M[7];
  o[2] = M[11];
}

// A scan ray's direction: the pixel's, or at half resolution the mean of
// its 2x2 pixels, summed in the twin's order (rows first, then columns).
__device__ __forceinline__ void scan_dir(const float* M, int half, int x,
                                         int y, float d[3]) {
  if (!half) {
    pixel_dir(M, x, y, d);
    return;
  }
  float a[3], b[3], c[3], e[3];
  pixel_dir(M, 2 * x, 2 * y, a);
  pixel_dir(M, 2 * x, 2 * y + 1, b);
  pixel_dir(M, 2 * x + 1, 2 * y, c);
  pixel_dir(M, 2 * x + 1, 2 * y + 1, e);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = 0.25f * (((a[k] + b[k]) + c[k]) + e[k]);
}

// preprocessing.norm: a multiply-add chain, then the rounded root
__device__ __forceinline__ float norm3(const float v[3]) {
  return __fsqrt_rn(fmaf(v[2], v[2], fmaf(v[1], v[1], v[0] * v[0])));
}

// 1 / fx from the view's first column: fx = 1 / max(|view[:3, 0]|, 1e-9)
__device__ __forceinline__ float fx_of(const float* M) {
  const float c[3] = {M[0], M[4], M[8]};
  return 1.0f / clamp_lo(norm3(c), 1e-9f);
}

// _fine_scan over one window: nF samples from z0 by dz; the last valid
// sample's index, outside bit and value carried forward; the first valid
// outside -> inside crossing solved linearly.  Returns the hit and writes
// its depth (0 on a miss).  The samples are gathered kChunk at a time
// before the carry runs over them, in one branch-free block (a sample
// past the window or outside the volume reads row 0 and is then NaN, which
// the carry skips), so that the chunk's address arithmetic interleaves and
// its loads are in flight together; each sample's depth is z0 + dz * j,
// recomputed where the crossing is solved.
__device__ bool scan_window(const Volume V, const Field fd, const float o[3],
                            const float d[3], float z0, float dz, int nF,
                            float* z_hit) {
  int prev = -1;           // 2 * index + outside bit of the last valid
  float f_prev = 0.0f;
  for (int j0 = 0; j0 < nF; j0 += kChunk) {
    int64_t at[kChunk];
    bool ok[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      float p[3];
      ray_point(V, o, d, z0 + dz * static_cast<float>(j0 + c), p);
      const int x = voxel_of(p[0]), y = voxel_of(p[1]), z = voxel_of(p[2]);
      ok[c] = j0 + c < nF && in_volume(V, x, y, z);
      at[c] = ok[c] ? tiled(V, x, y, z) : 0;
    }
    float f[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float v = view_value(V, at[c]);
      f[c] = ok[c] ? v : nan_f();
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (isnan(f[c])) continue;
      const int j = j0 + c;
      const bool in = is_inside(fd, f[c]);
      if (in && prev >= 0 && (prev & 1)) {
        const float z = z0 + dz * static_cast<float>(j);
        const float z_lo = z0 + dz * static_cast<float>(prev >> 1);
        float denom = f_prev - f[c];
        if (fabsf(denom) < 1e-12f) denom = -1e-12f;
        const float frac = (f[c] - fd.surf) / denom;
        *z_hit = z + (z - z_lo) * frac;
        return true;
      }
      prev = 2 * j + (in ? 0 : 1);
      f_prev = f[c];
    }
  }
  *z_hit = 0.0f;
  return false;
}

// _refine's / _midsolve's two samples at z -/+ delta and their re-solve
struct Secant {
  float lo, hi, z_new;
  bool pair, crossing;
};

__device__ Secant secant(const Volume V, const Field fd, const float o[3],
                         const float d[3], float z, float delta,
                         float two_delta, int interp, float sub) {
  float p[3];
  Secant s;
  ray_point(V, o, d, z - delta, p);
  s.lo = interp ? sample_interp(V, p, sub) : sample(V, p, nan_f());
  ray_point(V, o, d, z + delta, p);
  s.hi = interp ? sample_interp(V, p, sub) : sample(V, p, nan_f());
  s.pair = !isnan(s.lo) && !isnan(s.hi);
  s.crossing = s.pair && !is_inside(fd, s.lo) && is_inside(fd, s.hi);
  float denom = s.lo - s.hi;
  if (fabsf(denom) < 1e-12f) denom = -1e-12f;
  const float frac = (s.hi - fd.surf) / denom;
  s.z_new = (z + delta) + two_delta * frac;
  return s;
}

// _grad6 at b (voxel units): 6 nearest taps (+x, -x, +y, -y, +z, -z),
// out-of-volume taps `empty`, NaN taps `init` (torch.nan_to_num, which
// also maps the infinities to the largest floats)
__device__ void grad6(const Volume V, const float b[3], float empty,
                      float init, float g[3]) {
  float t[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float p[3] = {b[0], b[1], b[2]};
    p[k >> 1] = p[k >> 1] + ((k & 1) ? -1.0f : 1.0f);
    float v = sample(V, p, empty);
    if (isnan(v))
      v = init;
    else if (isinf(v))
      v = v > 0.0f ? FLT_MAX : -FLT_MAX;
    t[k] = v;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = (t[2 * a] - t[2 * a + 1]) * 0.5f;
}

// ---------------------------------------------------------------------
// R1 splat_bounds
// ---------------------------------------------------------------------

struct Splat {
  const int64_t* keys;          // [capacity]
  const int32_t* counts;        // [partitions] live slots of each range
  const float* voxels;          // [capacity, 512] select channel, or null
  const uint8_t* inside_any;    // [capacity], or null
  const float* view;            // [4, 4] pose @ inv(K)
  uint32_t* enc;                // [2, cells]: 0x7f800000 - bits(tmin),
                                // bits(tmax); then the ticket.  Zero
                                // before the launch and after it
  float* tmin;                  // [gh, gw] out
  float* tmax;                  // [gh, gw] out
  float* scratch;               // [4, cells], or null: shared memory
  Field field;
  int capacity, per_cap, g, gh, gw, near_rescue;
  float block_m;                // float32(8 * voxel size)
  float half_diag;              // float32(0.5 * diag)
  float diag;                   // float32(diag)
  float near;
  float marg, xmax, ymax;       // float32(2g), W - 1 + 2g, H - 1 + 2g
  float thr[3];                 // footprint radius thresholds, |d| 0, 1, 2
  float zb_div;                 // float32(2.4 * g)
};

// A half-warp's live slot (key kk): its 3x3 footprint cells' start and
// far depths into enc.  M = inv(view); lane: 0..15 in the half, whose
// lanes are `half` of the warp.
__device__ __forceinline__ void splat_slot(const Splat S, const float* M,
                                           int slot, uint32_t kk, int lane,
                                           unsigned half) {
  const float cx = (static_cast<float>(compact_bits(kk)) + 0.5f) * S.block_m;
  const float cy =
      (static_cast<float>(compact_bits(kk >> 1)) + 0.5f) * S.block_m;
  const float cz =
      (static_cast<float>(compact_bits(kk >> 2)) + 0.5f) * S.block_m;
  const float hx = fmaf(M[2], cz, fmaf(M[1], cy, M[0] * cx)) + M[3];
  const float hy = fmaf(M[6], cz, fmaf(M[5], cy, M[4] * cx)) + M[7];
  const float z = fmaf(M[10], cz, fmaf(M[9], cy, M[8] * cx)) + M[11];
  const float zs = z == 0.0f ? 1.0f : z;
  const float px = hx / zs, py = hy / zs;
  if (!(z > 1e-3f && px >= -S.marg && px <= S.xmax && py >= -S.marg &&
        py <= S.ymax))
    return;
  bool inside;
  if (S.inside_any != nullptr) {
    inside = S.inside_any[slot] != 0;
  } else {
    const float4* row = reinterpret_cast<const float4*>(
        S.voxels + static_cast<int64_t>(slot) * kBlockVoxels);
    bool any = false;
#pragma unroll
    for (int k = 0; k < kBlockVoxels / 4 / kSlotLanes; ++k) {
      const float4 v = row[k * kSlotLanes + lane];
      any |= is_inside(S.field, v.x) | is_inside(S.field, v.y) |
             is_inside(S.field, v.z) | is_inside(S.field, v.w);
    }
    inside = __any_sync(half, any);
  }
  if (!inside || lane >= 9) return;

  // lane = the footprint cell (dx, dy) in -1..1
  const int dy = lane / 3 - 1, dx = lane % 3 - 1;
  const float gf = static_cast<float>(S.g);
  const float foot = ((S.half_diag * fx_of(S.view)) / clamp_lo(z, 1e-3f)) / gf;
  if (!(foot >= S.thr[abs(dx) + abs(dy)])) return;
  const int c = min(max(__float2int_rz(px / gf + static_cast<float>(dx)), 0),
                    S.gw - 1);
  const int r = min(max(__float2int_rz(py / gf + static_cast<float>(dy)), 0),
                    S.gh - 1);
  const float z_lo = clamp_lo(z - S.half_diag, S.near);
  const float z_hi = z + S.half_diag;
  const int cell = r * S.gw + c;
  atomicMax(&S.enc[cell], 0x7f800000u - __float_as_uint(z_lo));
  atomicMax(&S.enc[S.gh * S.gw + cell], __float_as_uint(z_hi));
}

// The last CTA's pools over the whole grid: a, b, p, q are four [cells]
// float arrays (shared memory or the scratch).  The encoded grid is read
// once from L2, where every CTA's atomics landed, decoded into a (start
// depths) and b (far depths), and left zero with the ticket.  One CTA on
// one SM does every pass, so the passes are issue-bound and cut to few
// instructions: a warp a grid row and a lane a column (no division),
// every window a fixed number of taps at indices clamped to the grid (an
// edge tap read twice changes no min or max), and each 25-wide min a
// 5-wide min of 5-wide mins at stride 5 (their clamped windows cover
// exactly the 25).  A min is exact, so the grids are the twin's in any
// order.
__device__ __forceinline__ void splat_pool(const Splat S, float* a) {
  const int gh = S.gh, gw = S.gw, cells = gh * gw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* b = a + cells;
  float* p = b + cells;
  float* q = p + cells;
  // the column / row k steps from (r, c), clamped to the grid
  const auto col = [gw](int c, int k) { return min(max(c + k, 0), gw - 1); };
  const auto row = [gh, gw](int r, int k) {
    return min(max(r + k, 0), gh - 1) * gw;
  };
#define FOR_CELLS                                        \
  for (int r = warp; r < gh; r += kSplatThreads / 32)    \
    for (int c = lane, i = r * gw + lane; c < gw; c += 32, i += 32)
  FOR_CELLS {
    a[i] = __uint_as_float(0x7f800000u - __ldcg(S.enc + i));
    const uint32_t em = __ldcg(S.enc + cells + i);
    b[i] = em == 0u ? -inf_f() : __uint_as_float(em);
  }
  __syncthreads();
  // the grid read: clean it and the ticket for the next launch
  for (int i = threadIdx.x; i <= 2 * cells; i += kSplatThreads) S.enc[i] = 0u;
  // the 3-wide rows
  FOR_CELLS {
    const int o = r * gw;
    p[i] = fminf(fminf(a[o + col(c, -1)], a[i]), a[o + col(c, 1)]);
    q[i] = fmaxf(fmaxf(b[o + col(c, -1)], b[i]), b[o + col(c, 1)]);
  }
  __syncthreads();
  // the 3-tall columns: the 3x3 pools (the pooled start depths into a)
  FOR_CELLS {
    const float mn =
        fminf(fminf(p[row(r, -1) + c], p[i]), p[row(r, 1) + c]);
    a[i] = mn;
    S.tmax[i] = fmaxf(fmaxf(q[row(r, -1) + c], q[i]), q[row(r, 1) + c]);
    if (!S.near_rescue) S.tmin[i] = mn;
  }
  if (!S.near_rescue) return;
  __syncthreads();
  // the near-field blind zone: the 25x25 min pool of the pooled start
  // depths, rows then columns, each 5 of 5
  FOR_CELLS {
    const int o = r * gw;
    float mn = a[i];
#pragma unroll
    for (int k = -2; k <= 2; ++k) mn = fminf(mn, a[o + col(c, k)]);
    p[i] = mn;
  }
  __syncthreads();
  FOR_CELLS {
    const int o = r * gw;
    float mn = p[i];
#pragma unroll
    for (int k = -10; k <= 10; k += 5) mn = fminf(mn, p[o + col(c, k)]);
    b[i] = mn;
  }
  __syncthreads();
  FOR_CELLS {
    float mn = b[i];
#pragma unroll
    for (int k = -2; k <= 2; ++k) mn = fminf(mn, b[row(r, k) + c]);
    q[i] = mn;
  }
  __syncthreads();
  const float z_blind = (S.half_diag * fx_of(S.view)) / S.zb_div;
  FOR_CELLS {
    float wide = q[i];
#pragma unroll
    for (int k = -10; k <= 10; k += 5) wide = fminf(wide, q[row(r, k) + c]);
    const bool fallback = !isfinite(a[i]) && wide < z_blind;
    S.tmin[i] = fallback ? wide : a[i];
    if (fallback) S.tmax[i] = wide + S.diag;
  }
#undef FOR_CELLS
}

// R1 in one launch.  Dynamic shared memory: the inverse's 16 floats while
// the slots splat, then the pools' four grids (unless they go to the
// scratch).  A half-warp a slot, so that the headline's 6144 slots are one
// wave of 96 CTAs; each reads its slot's key while thread 0 inverts.
__global__ void __launch_bounds__(kSplatThreads)
splat_bounds_kernel(const Splat S) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kSlotLanes;
  const unsigned half = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
  const int slot = blockIdx.x * kSplatSlots + threadIdx.x / kSlotLanes;
  const bool live = slot < S.capacity &&
                    slot % S.per_cap < S.counts[slot / S.per_cap];
  const uint32_t kk = live ? static_cast<uint32_t>(S.keys[slot]) : 0u;
  if (threadIdx.x == 0) {
    float A[4][4], X[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) A[i][j] = S.view[i * 4 + j];
    lu::lu_inverse<4>(A, X);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) smem[i * 4 + j] = X[i][j];
  }
  __syncthreads();
  if (live) splat_slot(S, smem, slot, kk, lane, half);
  // this CTA's atomics before its ticket (the barrier, then one thread's
  // fence, as cooperative groups' grid sync orders them); the last ticket
  // pools
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&S.enc[2 * S.gh * S.gw], 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  if (!__syncthreads_or(last)) return;
  if (S.scratch == nullptr)
    splat_pool(S, smem);       // shared memory: 32-bit addressing
  else
    splat_pool(S, S.scratch);
}

// ---------------------------------------------------------------------
// R2 with R3: ray_scan
// ---------------------------------------------------------------------

// A tile's status word: flag (2 bits) | count (32 bits); 0 is not ready.
constexpr unsigned kAggregate = 1u;    // the tile's own flagged rays
constexpr unsigned kInclusive = 2u;    // those of the tiles up to it too

__device__ __forceinline__ unsigned long long status_word(unsigned flag,
                                                          uint32_t count) {
  return (static_cast<unsigned long long>(flag) << 32) | count;
}

// A status word carries its own count, so it is stored and polled
// relaxed, at the card's scope (in L2, past each SM's L1): nothing else
// is published through it, so no fence orders other writes before it.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

struct Rays {
  const float* view;            // [4, 4]
  Volume V;
  Field field;
  int half;                     // scan at half resolution
  int r0s;                      // the strip's first scan row
  int h, w;                     // the strip's scan rays
  int rep, gw;                  // scan rays a splat cell's edge; grid width
  const float* tmin;            // [gh, gw]
  const float* tmax;            // [gh, gw]
  float near, far, span, dz, diag;
  int nF;                       // samples a window
  int second, budget, midsolve; // the second window (its budget), midsolve
  float m_delta, m_two_delta;   // the midsolve's float32(delta), (2 delta)
  unsigned long long* status;   // [tiles] the look-back's words, zero
  uint32_t* ctl;                // tickets drawn, look-backs ended; zero
  uint8_t* hit;                 // [h, w] out
  float* z;                     // [h, w] out
};

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Warp 0 of tile `tile`: publishes the tile's count, looks back over the
// tiles before it 32 at a time (the nearest first) until one whose
// inclusive count is out, and publishes its own.  Returns the flagged rays
// of the tiles before this one.  (The kernel's parameters come in as
// values: a reference to them would be read from memory after every
// barrier and in every trip of the spin.)
__device__ int look_back(unsigned long long* st, int tile, int count,
                         int lane) {
  if (lane == 0)
    store_status(st + tile, status_word(tile == 0 ? kInclusive : kAggregate,
                                        static_cast<uint32_t>(count)));
  if (tile == 0) return 0;
  int before = 0;
  for (int end = tile - 1;; end -= 32) {
    const int t = end - lane;
    unsigned flag = kInclusive;
    uint32_t value = 0;
    if (t >= 0) {
      unsigned long long w;
      do {
        w = load_status(st + t);
        flag = static_cast<unsigned>(w >> 32) & 3u;
      } while (flag == 0u);
      value = static_cast<uint32_t>(w);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, flag == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    before += warp_sum(lane <= stop ? static_cast<int>(value) : 0);
    if (incl) break;
  }
  if (lane == 0)
    store_status(st + tile, status_word(kInclusive,
                                        static_cast<uint32_t>(before + count)));
  return before;
}

// Warp 0 of a tile whose look-back has ended: the last tile to get here
// (every other one has published its words and read its last) zeroes the
// status words and the counters for the next launch on the stream.
__device__ void end_look_back(unsigned long long* st, uint32_t* ctl,
                              int lane) {
  bool last = false;
  if (lane == 0) {
    __threadfence();
    last = atomicAdd(ctl + 1, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  for (int t = lane; t < static_cast<int>(gridDim.x); t += 32)
    store_status(st + t, 0ull);
  if (lane == 0) {
    ctl[0] = 0u;
    ctl[1] = 0u;
  }
}

__global__ void __launch_bounds__(kScanThreads)
ray_scan_kernel(const Rays R) {
  __shared__ int tile_s, before_s, count_w[kScanWarps];
  __shared__ int redo_ray[kScanThreads];     // compacted: the tile's ray
  __shared__ float redo_z0[kScanThreads];    // its second window's start
  __shared__ float redo_z[kScanThreads];     // by the tile's ray: its depth
  __shared__ uint8_t redo_hit[kScanThreads]; // and hit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int tile = blockIdx.x;
  if (R.second) {
    // tiles in ticket order: every tile before this one has started
    if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(R.ctl, 1u));
    __syncthreads();
    tile = tile_s;
  }
  const int ray = tile * kScanThreads + threadIdx.x;
  const bool in = ray < R.h * R.w;
  const int yl = in ? ray / R.w : 0, x = in ? ray - yl * R.w : 0;
  float o[3], d[3];
  view_origin(R.view, o);
  scan_dir(R.view, R.half, x, R.r0s + yl, d);
  bool need = false, hit = false;
  float z = 0.0f, zs = 0.0f;
  if (in) {
    const int cell = ((R.r0s + yl) / R.rep) * R.gw + x / R.rep;
    const float t0 = R.tmin[cell], t1 = R.tmax[cell];
    const bool active = isfinite(t0);
    zs = clamp_hi(clamp_lo(active ? t0 : R.near, R.near), R.far);
    if (active) hit = scan_window(R.V, R.field, o, d, zs, R.dz, R.nF, &z);
    need = active && !hit && (zs + R.span < t1 + R.diag);
  }
  if (R.second) {
    // the ray's place among the tile's flagged rays (the warps before its
    // own, the lanes before it); the tile's count
    const unsigned ballot = __ballot_sync(0xffffffffu, need);
    if (lane == 0) count_w[warp] = __popc(ballot);
    __syncthreads();
    int count = 0, rank = __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
    for (int i = 0; i < kScanWarps; ++i) {
      count += count_w[i];
      rank += i < warp ? count_w[i] : 0;
    }
    // the flagged rays compacted in that order
    if (need) {
      redo_ray[rank] = threadIdx.x;
      redo_z0[rank] = zs + R.span;
    }
    __syncthreads();
    if (warp == 0) {
      // the flagged rays of the tiles before this one: the look-back
      const int before = look_back(R.status, tile, count, lane);
      if (lane == 0) before_s = before;
      end_look_back(R.status, R.ctl, lane);
    } else {
      // meanwhile the other warps scan one window deeper the flagged rays
      // that can rank below the budget (at most its first `budget`)
      const int spec = min(count, R.budget);
      for (int i = threadIdx.x - 32; i < spec; i += kScanThreads - 32) {
        const int t = redo_ray[i];
        const int r = tile * kScanThreads + t;
        const int yr = r / R.w;
        float dr[3], zr;
        scan_dir(R.view, R.half, r - yr * R.w, R.r0s + yr, dr);
        redo_hit[t] = scan_window(R.V, R.field, o, dr, redo_z0[i], R.dz,
                                  R.nF, &zr);
        redo_z[t] = zr;
      }
    }
    __syncthreads();
    // exactly nonzero(need2)[:budget]: a flagged ray has no first-window
    // hit, so one ranked below the budget takes its second window's
    if (need && rank < R.budget - before_s) {
      hit = redo_hit[threadIdx.x] != 0;
      z = redo_z[threadIdx.x];
    }
  }
  if (!in) return;
  if (R.midsolve && hit) {
    const Secant s = secant(R.V, R.field, o, d, z, R.m_delta, R.m_two_delta,
                            0, 0.0f);
    if (s.crossing) z = s.z_new;
  }
  R.hit[ray] = hit;
  R.z[ray] = z;
}

// ---------------------------------------------------------------------
// R4 ray_refine_normals
// ---------------------------------------------------------------------

struct Finish {
  const float* view;            // [4, 4]
  Volume V;
  Field field;
  int W, r0, rows;              // the strip: image rows [r0, r0 + rows)
  int hs, ws;                   // the strip's scan rays (z_in's grid if up)
  const float* z_in;            // [hs, ws] if up, else [rows, W]
  const uint8_t* hit_in;
  int up;                       // z_in, hit_in at half resolution
  int resolve;                  // 0 none, 1 nearest, 2 trilinear taps
  float delta, two_delta;       // float32(0.7 thickness), (1.4 thickness)
  float sub;                    // the trilinear taps' unobserved value
  int normals;                  // 0 none, 1 volume, 2 hybrid
  int gd;                       // the hybrid gradient's decimation
  float empty, init;            // _grad6's out-of-volume and NaN values
  int invert;                   // negate the gradient (SDF)
  float* vertex;                // [rows, W, 3] out
  float* normal;                // [rows, W, 3] out (normals != 0)
  float* t_hit;                 // [rows, W] out
  uint8_t* hit;                 // [rows, W] out
};

__device__ __forceinline__ void write3(float* out, int i, float x, float y,
                                       float z) {
  out[3 * i] = x;
  out[3 * i + 1] = y;
  out[3 * i + 2] = z;
}

__global__ void __launch_bounds__(kPixelThreads)
ray_refine_normals_kernel(const Finish P) {
  const int pix = blockIdx.x * kPixelThreads + threadIdx.x;
  if (pix >= P.rows * P.W) return;
  const int yl = pix / P.W, x = pix - yl * P.W;
  const int src = P.up ? (yl >> 1) * P.ws + (x >> 1) : pix;
  bool hit = P.hit_in[src] != 0;
  float z = P.z_in[src];
  float o[3], d[3];
  view_origin(P.view, o);
  pixel_dir(P.view, x, P.r0 + yl, d);
  Secant s{0.0f, 0.0f, 0.0f, false, false};
  if (hit && P.resolve) {
    s = secant(P.V, P.field, o, d, z, P.delta, P.two_delta, P.resolve == 2,
               P.sub);
    if (s.crossing) z = s.z_new;
    if (s.pair && !s.crossing) hit = false;
  }
  P.hit[pix] = hit;
  if (!hit) {
    write3(P.vertex, pix, 0.0f, 0.0f, 0.0f);
    P.t_hit[pix] = 0.0f;
    if (P.normals) write3(P.normal, pix, kInvalid, 0.0f, 0.0f);
    return;
  }
  const float v[3] = {o[0] + d[0] * z, o[1] + d[1] * z, o[2] + d[2] * z};
  const float ray_norm = norm3(d);
  write3(P.vertex, pix, v[0], v[1], v[2]);
  P.t_hit[pix] = z * ray_norm;
  if (!P.normals) return;

  float g[3];
  if (P.normals == 1) {
    const float b[3] = {v[0] * P.V.inv_vs, v[1] * P.V.inv_vs,
                        v[2] * P.V.inv_vs};
    grad6(P.V, b, P.empty, P.init, g);
  } else {
    // the lateral gradient at the half-resolution parent's vertex (of its
    // decimated parent), then the along-ray correction
    const int yh = yl >> 1, xh = x >> 1;
    int yq = yh, xq = xh;
    if (P.gd > 1 && P.hs % P.gd == 0 && P.ws % P.gd == 0) {
      yq -= yh % P.gd;
      xq -= xh % P.gd;
      if (!P.hit_in[yq * P.ws + xq]) {
        write3(P.normal, pix, kInvalid, 0.0f, 0.0f);
        return;
      }
    }
    const float zq = P.z_in[yq * P.ws + xq];
    float fq[3];
    scan_dir(P.view, 1, xq, (P.r0 >> 1) + yq, fq);
    float b[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) b[a] = (o[a] + fq[a] * zq) * P.V.inv_vs;
    float gq[3];
    grad6(P.V, b, P.empty, P.init, gq);
#pragma unroll
    for (int a = 0; a < 3; ++a) gq[a] = gq[a] * P.V.inv_vs;
    const float rn = clamp_lo(ray_norm, 1e-12f);
    const float rh[3] = {d[0] / rn, d[1] / rn, d[2] / rn};
    const float d_ray = (s.hi - s.lo) / (P.two_delta * rn);
    // the pixel hits, so its parent did: the pair alone decides.  The dot
    // product adds as the twin's numerics.dot3: (x + y) + z
    const float dot = (gq[0] * rh[0] + gq[1] * rh[1]) + gq[2] * rh[2];
    const float corr = s.pair ? d_ray - dot : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = gq[a] + corr * rh[a];
  }
  if (P.invert) {
#pragma unroll
    for (int a = 0; a < 3; ++a) g[a] = -g[a];
  }
  const float gn = norm3(g);
  if (gn == 0.0f) {
    write3(P.normal, pix, kInvalid, 0.0f, 0.0f);
    return;
  }
  const float n = clamp_lo(gn, 1e-12f);
  write3(P.normal, pix, g[0] / n, g[1] / n, g[2] / n);
}

Volume make_volume(const void* F, int bf16, int size, float inv_vs) {
  return Volume{F, bf16, size, size / 8, inv_vs};
}

}  // namespace

// R1.  keys [capacity] int64, counts [capacity / per_cap] int32, voxels
// [capacity, 512] float32 (the select channel; null with inside_any),
// inside_any [capacity] bool or null, view [4, 4], enc [2 * gh * gw + 1]
// uint32 scratch (zero, and left zero), tmin and tmax [gh, gw] out,
// scratch [4, gh * gw] float32 or null (then gh * gw <= kPoolSmemCells).
// thr: the footprint thresholds at |dx| + |dy| = 0, 1, 2.  0 < near.
extern "C" int splat_bounds(const void* keys, const void* counts,
                            const void* voxels, const void* inside_any,
                            const void* view, void* enc, void* tmin,
                            void* tmax, void* scratch, int capacity,
                            int per_cap, int g, int gh, int gw,
                            int near_rescue, float surf, int below,
                            float block_m, float half_diag, float diag,
                            float near, float marg, float xmax, float ymax,
                            float thr0, float thr1, float thr2, float zb_div,
                            void* stream) {
  const int cells = gh * gw;
  if (capacity <= 0 || per_cap <= 0 || g <= 0 || cells <= 0 ||
      (scratch == nullptr && cells > kPoolSmemCells) ||
      (voxels == nullptr && inside_any == nullptr) || !(near > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  Splat S;
  S.keys = static_cast<const int64_t*>(keys);
  S.counts = static_cast<const int32_t*>(counts);
  S.voxels = static_cast<const float*>(voxels);
  S.inside_any = static_cast<const uint8_t*>(inside_any);
  S.view = static_cast<const float*>(view);
  S.enc = static_cast<uint32_t*>(enc);
  S.tmin = static_cast<float*>(tmin);
  S.tmax = static_cast<float*>(tmax);
  S.scratch = static_cast<float*>(scratch);
  S.field = Field{surf, below};
  S.capacity = capacity;
  S.per_cap = per_cap;
  S.g = g;
  S.gh = gh;
  S.gw = gw;
  S.near_rescue = near_rescue;
  S.block_m = block_m;
  S.half_diag = half_diag;
  S.diag = diag;
  S.near = near;
  S.marg = marg;
  S.xmax = xmax;
  S.ymax = ymax;
  S.thr[0] = thr0;
  S.thr[1] = thr1;
  S.thr[2] = thr2;
  S.zb_div = zb_div;
  // the inverse's 16 floats, then (without the scratch) the pools' grids
  const size_t smem =
      sizeof(float) * (scratch == nullptr && 4 * cells > 16 ? 4 * cells : 16);
  splat_bounds_kernel<<<(capacity + kSplatSlots - 1) / kSplatSlots,
                        kSplatThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(S);
  return static_cast<int>(cudaGetLastError());
}

// R2 with R3.  view [4, 4]; F the tiled view [(size/8)^3, 512] (bf16 when
// bf16, else float32); tmin, tmax [gh, gw]; hit [h, w] bool and z [h, w]
// float32 out.  second: scan the
// flagged rays of rank < budget one window deeper, ranked by the
// look-back over status [>= ceil(h * w / kScanThreads)] uint64 with the
// tiles drawn from ctl[0] (ctl [2] uint32; status and ctl zero, and left
// so); midsolve: re-solve every hit at +/- m_delta.
extern "C" int ray_scan(const void* view, const void* F, int bf16, int size,
                        float inv_vs, float surf, int below, int half,
                        int r0s, int h, int w, int rep, int gw,
                        const void* tmin, const void* tmax, float near,
                        float far, float span, float dz, float diag, int nF,
                        int second, int budget, int midsolve, float m_delta,
                        float m_two_delta, void* status, void* ctl,
                        void* hit, void* z, void* stream) {
  if (h <= 0 || w <= 0 || rep <= 0 || nF <= 0 || size % 8 || budget < 0 ||
      (second && (status == nullptr || ctl == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Rays R;
  R.view = static_cast<const float*>(view);
  R.V = make_volume(F, bf16, size, inv_vs);
  R.field = Field{surf, below};
  R.half = half;
  R.r0s = r0s;
  R.h = h;
  R.w = w;
  R.rep = rep;
  R.gw = gw;
  R.tmin = static_cast<const float*>(tmin);
  R.tmax = static_cast<const float*>(tmax);
  R.near = near;
  R.far = far;
  R.span = span;
  R.dz = dz;
  R.diag = diag;
  R.nF = nF;
  R.second = second;
  R.budget = budget;
  R.midsolve = midsolve;
  R.m_delta = m_delta;
  R.m_two_delta = m_two_delta;
  R.status = static_cast<unsigned long long*>(status);
  R.ctl = static_cast<uint32_t*>(ctl);
  R.hit = static_cast<uint8_t*>(hit);
  R.z = static_cast<float*>(z);
  const int tiles_n = (h * w + kScanThreads - 1) / kScanThreads;
  ray_scan_kernel<<<tiles_n, kScanThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(R);
  return static_cast<int>(cudaGetLastError());
}

// R4.  z_in, hit_in: [hs, ws] scan rays when up, else [rows, W] pixels;
// vertex, normal [rows, W, 3] float32 out (normal unused when normals is
// 0), t_hit [rows, W] float32 out, hit [rows, W] bool out.  resolve: 0
// none, 1 nearest, 2 trilinear (up only); normals: 0 none, 1 volume, 2
// hybrid (up and resolve only).
extern "C" int ray_refine_normals(const void* view, const void* F, int bf16,
                                  int size, float inv_vs, float surf,
                                  int below, int W, int r0, int rows, int hs,
                                  int ws, const void* z_in,
                                  const void* hit_in, int up, int resolve,
                                  float delta, float two_delta, float sub,
                                  int normals, int gd, float empty,
                                  float init, int invert, void* vertex,
                                  void* normal, void* t_hit, void* hit,
                                  void* stream) {
  if (W <= 0 || rows <= 0 || size % 8 || (resolve && !up) ||
      (normals == 2 && !resolve) || (normals && normal == nullptr) ||
      (up && (hs * 2 != rows || ws * 2 != W)))
    return static_cast<int>(cudaErrorInvalidValue);
  Finish P;
  P.view = static_cast<const float*>(view);
  P.V = make_volume(F, bf16, size, inv_vs);
  P.field = Field{surf, below};
  P.W = W;
  P.r0 = r0;
  P.rows = rows;
  P.hs = hs;
  P.ws = ws;
  P.z_in = static_cast<const float*>(z_in);
  P.hit_in = static_cast<const uint8_t*>(hit_in);
  P.up = up;
  P.resolve = resolve;
  P.delta = delta;
  P.two_delta = two_delta;
  P.sub = sub;
  P.normals = normals;
  P.gd = gd;
  P.empty = empty;
  P.init = init;
  P.invert = invert;
  P.vertex = static_cast<float*>(vertex);
  P.normal = static_cast<float*>(normal);
  P.t_hit = static_cast<float*>(t_hit);
  P.hit = static_cast<uint8_t*>(hit);
  const int blocks = (rows * W + kPixelThreads - 1) / kPixelThreads;
  ray_refine_normals_kernel<<<blocks, kPixelThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
