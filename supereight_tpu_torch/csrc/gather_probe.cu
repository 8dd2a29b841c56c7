// Gather-rate probe kernels for Hopper (sm_90a): the port of the two Pallas
// kernels of scripts/pallas_gather_probe.py.
//
// lane_shuffle_sum replaces scripts/pallas_gather_probe.py:shuffle_kernel
// (K2): out[s, l] = sum_{i<krep} src[s, (idx[s, l] + i) & 127], summed in
// order i = 0, 1, ...  On the TPU this timed the per-lane dynamic gather
// (take_along_axis over a [S, 128] VMEM tile); here it is a gather from
// shared memory.  The 32 lanes of a warp start their windows at random
// lanes, so with one copy of the row in shared memory two lanes whose
// windows start 32, 64 or 96 lanes apart hit the same bank on every step
// (3-4 way conflicts on a random row).  So each row is stored 32 times, one
// copy per bank: element e of the row sits at word e * 32 + b of the table
// in every bank b, and lane l reads only bank l.  Every gather of a warp is
// then one conflict-free 128-byte shared load; the copies cost half as many
// shared-memory bytes again as the gathers (16 KB written, 32 KB read per
// row).  A persistent grid of 128-thread CTAs walks the rows, with two
// tables so that one barrier a row suffices, and each thread's src and idx
// values of its next two rows are loaded while the current row is summed.
// krep = 64 is unrolled at compile time; any other krep >= 0 takes a loop
// (windows longer than 128 wrap as they do on the TPU).  The lane index is
// computed in uint32, because the caller adds a growing carry to idx and
// signed overflow is undefined in C++; the low 7 bits are those of the
// int32 arithmetic of the TPU kernel.
//
// slab_row_sum replaces scripts/pallas_gather_probe.py:rows_kernel (K3):
// out = ((a0 + a1) + a2) + a3 with a_j = sum_{i<n/4} f32(table[rows[4i+j] :
// rows[4i+j] + 8, :]), each a_j summed in order i = 0, 1, ...  On the TPU
// this timed random 8-row slab loads from a VMEM-resident bf16 brick table;
// on the H100 the [6144, 512] bf16 table (6 MB) stays resident in the 50 MB
// L2.  The 8 x wide outputs times four accumulators are independent ordered
// chains, so they spread over the card without changing the rounding: a
// CTA owns one chain j of one slab row r and a 64-column tile, so that each
// slab it reads is one 128-byte line; 8 rows x 8 tiles x 4 chains = 256
// CTAs of 64 threads at wide = 512.  It stages its indices rows[4i+j] in
// shared memory once, then keeps seven stages of 32 slabs (28 KB) in flight
// with cp.async into a ring in shared memory while its threads, one per
// output, add the arrived slabs in order.  The four CTAs (chains) of a tile
// form a cluster; CTA 0 reads a1, a2 and a3 from its peers' shared memory
// and writes ((a0 + a1) + a2) + a3.  A tile past the width is masked; a
// width that is not a multiple of 8 (or a table not 16-byte aligned) is
// copied element by element.
//
// What bounds them (chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 6 has the table).  A launch costs ~0.005 ms however
// empty, so K2 at the probe's 256 rows (~0.006 ms) is its launch.  At 65536
// rows K2 takes 0.122 ms: 1.9x its shared-memory bound (0.064 ms: 4 bytes
// a gather at 128 bytes a clock an SM), where the copies add half again,
// and 1.5x the issue lower bound of its row loop (326 instructions a warp,
// probes/sass_count.py); with one copy of a row and its 3-4 way conflicts
// the earlier design took 0.19 ms there.  K3 takes 0.0143 ms at 2048 slabs
// and 0.0358 ms at 8192: ~0.007 ms fixed (the launch's 0.005 ms with it)
// and ~14 ns a chain step, whatever the card does besides (one 64-column
// tile, 32 CTAs and 1/8 of the bytes, takes 0.0132 ms), so each CTA's
// stream of steps, not the card's L2, sets its time.  An earlier layout of
// 8 rows x 16 columns a CTA (one 32-byte sector a row, 16-slab stages) took
// 0.0170 ms.
//
// Built with --fmad=false like the rest of the package; there are only
// additions here, so every sum rounds as the plain versions' do and kernel
// and plain version agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kBanks = 32;
constexpr int kSlabRows = 8;

// ---- K2 ------------------------------------------------------------------

constexpr int kTableWords = kLanes * kBanks;      // one row, one copy a bank
// CTAs an SM holds: 32 KB of tables each (the persistent grid's size)
constexpr int kShuffleCtasPerSm = 6;
constexpr int kAhead = 2;                         // rows whose loads fly

// Sum of krep gathers from a row's table for the window starting at lane b:
// word ((b + i) & 127) * 32 + bank of the table at word `buf` (0 or
// kTableWords), addressed in bytes so that a gather is an add, a mask (with
// the table's offset or-ed in) and a load.
template <int KREP>
__device__ __forceinline__ float window_sum(const float* table, uint32_t b,
                                            uint32_t bank, uint32_t buf,
                                            int krep) {
  const char* base = reinterpret_cast<const char*>(table);
  const uint32_t o = (b * kBanks + bank) * 4;
  const uint32_t bufb = buf * 4;
  constexpr uint32_t kMask = kTableWords * 4 - 1;
  auto at = [&](int i) {
    return *reinterpret_cast<const float*>(
        base + (((o + kBanks * 4 * static_cast<uint32_t>(i)) & kMask)
                | bufb));
  };
  float acc = 0.0f;
  if (KREP >= 0) {
#pragma unroll
    for (int i = 0; i < KREP; ++i) acc += at(i);
  } else {
    for (int i = 0; i < krep; ++i) acc += at(i);
  }
  return acc;
}

template <int KREP>
__global__ void __launch_bounds__(kLanes, kShuffleCtasPerSm)
lane_shuffle_sum_kernel(const float* __restrict__ src,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, int s_rows, int krep) {
  __shared__ __align__(16) float table[2 * kTableWords];      // 32 KB
  const int t = threadIdx.x;
  const uint32_t lane = t & (kBanks - 1);
  // this thread's src value and lane index of its CTA's next kAhead rows
  float v[kAhead];
  uint32_t b[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int s = blockIdx.x + k * gridDim.x;
    v[k] = 0.0f;
    b[k] = 0;
    if (s < s_rows) {
      v[k] = src[static_cast<size_t>(s) * kLanes + t];
      b[k] = static_cast<uint32_t>(idx[static_cast<size_t>(s) * kLanes + t]);
    }
  }
  uint32_t buf = 0;
#pragma unroll 1
  for (int s = blockIdx.x; s < s_rows; s += gridDim.x) {
    // element t into every bank: eight 16-byte stores, rotated by lane so
    // that the eight lanes of a store phase hit eight bank groups
    const float4 q = make_float4(v[0], v[0], v[0], v[0]);
    float4* row = reinterpret_cast<float4*>(table + buf + t * kBanks);
#pragma unroll
    for (int k = 0; k < kBanks / 4; ++k) {
      row[(k + lane) & (kBanks / 4 - 1)] = q;
    }
    const uint32_t base = b[0];
#pragma unroll
    for (int k = 0; k + 1 < kAhead; ++k) {
      v[k] = v[k + 1];
      b[k] = b[k + 1];
    }
    const int ahead = s + kAhead * gridDim.x;
    if (ahead < s_rows) {
      v[kAhead - 1] = src[static_cast<size_t>(ahead) * kLanes + t];
      b[kAhead - 1] = static_cast<uint32_t>(
          idx[static_cast<size_t>(ahead) * kLanes + t]);
    }
    // the other table was last read before this barrier's previous round
    __syncthreads();
    out[static_cast<size_t>(s) * kLanes + t] =
        window_sum<KREP>(table, base, lane, buf, krep);
    buf ^= kTableWords;
  }
}

__global__ void empty_kernel() {}

// ---- K3 ------------------------------------------------------------------

constexpr int kTileCols = 64;            // a tile: 64 columns of one slab row
constexpr int kChains = 4;               // a0..a3: the cluster's four CTAs
constexpr int kPieces = kTileCols / 8;   // 16-byte pieces of a slab's tile
constexpr int kStageSlabs = 32;          // slabs a stage (4 KB)
constexpr int kStages = 8;               // ring slots, 7 stages in flight
constexpr int kIndexChunk = 2048;        // indices staged at a time
// a thread's copies a stage: the CTA's kTileCols threads copy kPieces
// pieces of each of the stage's slabs
constexpr int kCopies = kStageSlabs * kPieces / kTileCols;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __cluster_dims__(kChains, 1, 1) __launch_bounds__(kTileCols)
slab_row_sum_kernel(const int32_t* __restrict__ rows,
                    const uint16_t* __restrict__ table,
                    float* __restrict__ out, int n_rows, int wide, int vec) {
  __shared__ int32_t rows_s[kIndexChunk];                         // 8 KB
  __shared__ __align__(16) uint16_t ring[kStages * kStageSlabs
                                         * kTileCols];            // 32 KB
  __shared__ float part[kTileCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int j = static_cast<int>(cluster.block_rank());
  // the cluster's tile: slab row r, columns c0 ...
  const int tile = blockIdx.x / kChains;
  const int col_tiles = (wide + kTileCols - 1) / kTileCols;
  const int r = tile / col_tiles, c0 = tile % col_tiles * kTileCols;
  const int t = threadIdx.x;
  const int steps = n_rows / 4;
  // this thread's 16-byte piece (8 columns from col) of the slabs t / 8,
  // t / 8 + 8, ... of a stage
  const int piece = 8 * (t % kPieces), col = c0 + piece;
  const bool whole_piece = vec && col + 8 <= wide;
  float acc = 0.0f;
#pragma unroll 1
  for (int i0 = 0; i0 < steps; i0 += kIndexChunk) {
    const int m = min(kIndexChunk, steps - i0);
    __syncthreads();                // the last chunk is consumed
    for (int k = t; k < m; k += kTileCols) {
      rows_s[k] = rows[4 * (i0 + k) + j];
    }
    __syncthreads();
    // copy stage st into its ring slot
    auto issue = [&](int st) {
      const int slot = st % kStages;
#pragma unroll
      for (int u = 0; u < kCopies; ++u) {
        const int k = t / kPieces + kTileCols / kPieces * u;
        const int i = st * kStageSlabs + k;
        if (i >= m) break;
        uint16_t* dst = ring + (slot * kStageSlabs + k) * kTileCols + piece;
        const uint16_t* src = table
            + static_cast<size_t>(rows_s[i] + r) * wide;
        if (whole_piece) {
          cp_async16(dst, src + col);
        } else {
          for (int e = 0; e < 8; ++e) {
            dst[e] = col + e < wide ? src[col + e] : 0;
          }
        }
      }
    };
    // add the slabs of ring slot `slot` to this thread's output, in order
    auto consume = [&](int slot, int count) {
      const uint16_t* slab = ring + slot * kStageSlabs * kTileCols + t;
#pragma unroll
      for (int k = 0; k < kStageSlabs; ++k) {
        if (k >= count) break;
        acc += __uint_as_float(static_cast<uint32_t>(slab[k * kTileCols])
                               << 16);
      }
    };
    const int n_st = (m + kStageSlabs - 1) / kStageSlabs;
    const int whole = m / kStageSlabs;
#pragma unroll 1
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_st) issue(st);
      cp_async_commit();
    }
#pragma unroll 1
    for (int st = 0; st < whole; ++st) {
      if (st + kStages - 1 < n_st) issue(st + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();   // this thread's copies of stage st
      __syncthreads();                // and every thread's
      consume(st % kStages, kStageSlabs);
      __syncthreads();                // before the slot is copied into
    }
    if (whole < n_st) {               // the last stage, not whole
      cp_async_wait<0>();
      __syncthreads();
      consume(whole % kStages, m - whole * kStageSlabs);
    }
  }
  // ((a0 + a1) + a2) + a3 on the cluster's CTA 0, from its peers' part[]
  part[t] = acc;
  cluster.sync();
  if (j == 0) {
    float sum = acc;
#pragma unroll
    for (int q = 1; q < kChains; ++q) {
      sum += cluster.map_shared_rank(part, q)[t];
    }
    if (c0 + t < wide) out[r * wide + c0 + t] = sum;
  }
  cluster.sync();                     // peers stay until CTA 0 has read
}

}  // namespace

// The launches compute their own grids from the constants above.
extern "C" int lane_shuffle_sum(const void* src, const void* idx, void* out,
                                int s, int krep, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: as many CTAs as the card holds at once, at most one a row
  const int grid = min(s, kShuffleCtasPerSm * sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(src);
  const int32_t* b = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  if (krep == 64) {
    lane_shuffle_sum_kernel<64><<<grid, kLanes, 0, st>>>(a, b, o, s, krep);
  } else {
    lane_shuffle_sum_kernel<-1><<<grid, kLanes, 0, st>>>(a, b, o, s, krep);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_row_sum(const void* rows, const void* table, void* out,
                            int n_rows, int wide, void* stream) {
  const int vec = wide % 8 == 0
      && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  // one cluster of four CTAs (the chains) a tile of each slab row
  const int grid = kChains * kSlabRows
      * ((wide + kTileCols - 1) / kTileCols);
  slab_row_sum_kernel<<<grid, kTileCols, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows),
      static_cast<const uint16_t*>(table), static_cast<float*>(out), n_rows,
      wide, vec);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: the fixed cost of a launch, timed as the kernels are.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
