// Gather-rate probe kernels for Hopper (sm_90a): the port of the two Pallas
// kernels of scripts/pallas_gather_probe.py.
//
// lane_shuffle_sum replaces scripts/pallas_gather_probe.py:shuffle_kernel
// (K2): out[s, l] = sum_{i<krep} src[s, (idx[s, l] + i) & 127], summed in
// order i = 0, 1, ...  On the TPU this timed the per-lane dynamic gather
// (take_along_axis over a [S, 128] VMEM tile).  Its Hopper counterpart is a
// gather from shared memory: one CTA per row stages the row's 128 floats in
// shared memory and each thread (one per output element) does its krep
// gathers there.  The lane index is computed in uint32, because the caller
// adds a growing carry to idx and signed overflow is undefined in C++; the
// low 7 bits are the same as the int32 arithmetic of the TPU kernel.
//
// slab_row_sum replaces scripts/pallas_gather_probe.py:rows_kernel (K3):
// out = ((a0 + a1) + a2) + a3 with a_j = sum_{i<n/4} f32(table[rows[4i+j] :
// rows[4i+j] + 8, :]), each a_j summed in order i = 0, 1, ...  On the TPU
// this timed random 8-row slab loads from a VMEM-resident bf16 brick table.
// On the H100 the [6144, 512] bf16 table (6 MB) stays resident in the 50 MB
// L2, which is the counterpart of "VMEM-resident".  One thread per output
// element keeps the four accumulators in the kernel's order;
// __bfloat162float is exact.
//
// What bounds them on the card.  K2 is 256 x 128 x 64 = 2.1M shared-memory
// gathers, a few microseconds of shared-memory bandwidth: it is bound by
// its launch (~6 us on an H100).  K3 reads 2048 slabs x 8 KB = 16 MB from
// L2, but its summation order pins one thread per output: 4096 threads in
// 16 CTAs, each walking 512 steps of four loads, so it is bound by L2 load
// latency (~0.12 ms, ~140 GB/s).  Splitting the sums over more threads
// would change the rounding.  A simple design is deliberate: the kernels
// exist to be held against their plain versions and to time the card's
// gather paths.
//
// Built with --fmad=false like the rest of the package; there are only
// additions here, so every sum rounds as the plain versions' do and kernel
// and plain version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSlabRows = 8;

__global__ void __launch_bounds__(kLanes)
lane_shuffle_sum_kernel(const float* __restrict__ src,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, int krep) {
  __shared__ float row[kLanes];
  const size_t at = static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x;
  row[threadIdx.x] = src[at];
  __syncthreads();
  const uint32_t base = static_cast<uint32_t>(idx[at]);
  float acc = 0.0f;
  for (int i = 0; i < krep; ++i) {
    acc += row[(base + static_cast<uint32_t>(i)) & (kLanes - 1)];
  }
  out[at] = acc;
}

__global__ void slab_row_sum_kernel(const int32_t* __restrict__ rows,
                                    const __nv_bfloat16* __restrict__ table,
                                    float* __restrict__ out, int n_rows,
                                    int wide) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kSlabRows * wide) return;
  const int r = e / wide;
  const int c = e - r * wide;
  const __nv_bfloat16* col = table + static_cast<size_t>(r) * wide + c;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int i = 0; i < n_rows / 4; ++i) {
    a0 += __bfloat162float(col[static_cast<size_t>(rows[4 * i + 0]) * wide]);
    a1 += __bfloat162float(col[static_cast<size_t>(rows[4 * i + 1]) * wide]);
    a2 += __bfloat162float(col[static_cast<size_t>(rows[4 * i + 2]) * wide]);
    a3 += __bfloat162float(col[static_cast<size_t>(rows[4 * i + 3]) * wide]);
  }
  out[e] = ((a0 + a1) + a2) + a3;
}

}  // namespace

extern "C" int lane_shuffle_sum(const void* src, const void* idx, void* out,
                                int s, int krep, void* stream) {
  lane_shuffle_sum_kernel<<<s, kLanes, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), krep);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slab_row_sum(const void* rows, const void* table, void* out,
                            int n_rows, int wide, void* stream) {
  constexpr int kThreads = 256;
  const int n_out = kSlabRows * wide;
  slab_row_sum_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows),
      static_cast<const __nv_bfloat16*>(table), static_cast<float*>(out),
      n_rows, wide);
  return static_cast<int>(cudaGetLastError());
}
