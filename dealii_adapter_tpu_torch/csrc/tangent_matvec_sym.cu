// K2, K2b: per-cell tangent matvec from block-symmetric storage.
//
//   out[d] = sum_{e >= d} K[d][e] u[e] + sum_{e < d} K[e][d]^T u[e]
//
// from the n_b = dim (dim + 1) / 2 upper component blocks K[d][e], d <= e,
// each (npc, npc, n_cells), in `upper_blocks` order ((0,0), (0,1), ...).
//
// Replaces (dealii_adapter_tpu/ops/assembled_tangent.py):
//   K2  apply_packed_tangents_sym_pallas (_matvec_sym_kernel_body): the
//       blocks packed as one (n_b * npc, npc, n_cells) buffer;
//   K2b apply_sym_block_tangents_pallas (_matvec_sym_blocks_kernel_body):
//       the n_b blocks as separate buffers (no pack pass).
//   The two differ only in where the blocks live: one kernel serves both,
//   given one pointer per block.
//
// What bounds it on an H100: device-memory bandwidth. The stored blocks
//   are 2/3 of the full tangent's bytes in 3D (6 of 9 blocks: 0.69 GB at
//   the 1,018,875-DoF Q2 flap, ~0.21 ms at 3.35 TB/s) and 3/4 in 2D.
//
// What the design does about it: the byte saving exists only if every
//   stored entry is loaded once and applied to both of its outputs
//   (out[d, i] += K u[e, j] and, off the diagonal, out[e, j] += K u[d, i]).
//   So one thread owns one cell: its dim * npc inputs and accumulators sit
//   in shared memory, laid out [row][thread] so that the threads of a warp
//   hit 32 different banks. Cells run across the threads of a warp, so each
//   load of a tangent entry is a coalesced 128-byte line per warp, and each
//   entry is loaded exactly once. A thread issues the loads of a whole row
//   (up to 27 entries; 16 or 25 for Q3/Q4) before it consumes them, so
//   enough loads are in flight at the low occupancy that the shared-memory
//   footprint allows. A row's plain sum runs in a register (j in order)
//   and is added to its accumulator once; the transposed products are
//   added to the accumulators of the block's columns as they come. The
//   order is fixed, so results are deterministic; no atomics. The cell
//   count needs no padding (the TPU kernels padded to 512 lanes).
//   Element sizes: Q1-Q4 in 2D and 3D (npc 4, 9, 16, 25 and 8, 27, 64,
//   125); others return cudaErrorInvalidValue.

#include <cuda_runtime.h>

#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBlocks = 6;  // dim (dim + 1) / 2, dim <= 3

struct SymTable {
  const float* ptr[kMaxBlocks];
};

template <int DIM, int NPC>
__global__ void __launch_bounds__(kThreads)
tangent_matvec_sym_kernel(const SymTable t, const float* __restrict__ u,
                          float* __restrict__ out, long long n_cells) {
  constexpr int kRows = DIM * NPC;
  // loads in flight per thread: a whole row up to Q2, else 16 or 25
  constexpr int kChunk = NPC <= 27 ? NPC : (NPC % 16 == 0 ? 16 : 25);
  static_assert(NPC % kChunk == 0, "rows split into whole chunks");
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (c >= n_cells) return;  // no barrier below: each thread owns its cell
  float* us = smem;                    // us[r * kThreads + tid]
  float* acc = smem + kRows * kThreads;  // acc[r * kThreads + tid]
  for (int r = 0; r < kRows; ++r) {
    us[r * kThreads + tid] = __ldg(u + static_cast<long long>(r) * n_cells + c);
    acc[r * kThreads + tid] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
#pragma unroll
    for (int e = d; e < DIM; ++e) {
      // block index of (d, e) in upper_blocks order: a constant here
      const int b = d * DIM - d * (d - 1) / 2 + (e - d);
      const float* k = t.ptr[b] + c;
      const float* ue = us + e * NPC * kThreads + tid;
      float* acc_e = acc + e * NPC * kThreads + tid;
      for (int i = 0; i < NPC; ++i) {
        const float* ki = k + static_cast<long long>(i) * NPC * n_cells;
        const float ud = us[(d * NPC + i) * kThreads + tid];
        float a = 0.0f;
        for (int j0 = 0; j0 < NPC; j0 += kChunk) {
          // issue the chunk's loads together, then consume them in order
          float kv[kChunk];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            kv[jj] = __ldg(ki + static_cast<long long>(j0 + jj) * n_cells);
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            const int j = j0 + jj;
            a = fmaf(kv[jj], ue[j * kThreads], a);
            if (d != e) acc_e[j * kThreads] = fmaf(kv[jj], ud, acc_e[j * kThreads]);
          }
        }
        acc[(d * NPC + i) * kThreads + tid] += a;
      }
    }
  }
  for (int r = 0; r < kRows; ++r)
    out[static_cast<long long>(r) * n_cells + c] = acc[r * kThreads + tid];
}

template <int DIM, int NPC>
cudaError_t launch(const SymTable& t, const float* u, float* out,
                   long long n_cells, cudaStream_t stream) {
  constexpr int kBytes = 2 * DIM * NPC * kThreads * sizeof(float);
  // above 48 KB only after opting in (3D Q3 and Q4)
  static unsigned long long configured = 0;
  const cudaError_t err = dat::max_dynamic_smem_once(
      tangent_matvec_sym_kernel<DIM, NPC>, kBytes, configured);
  if (err != cudaSuccess) return err;
  const unsigned blocks =
      static_cast<unsigned>((n_cells + kThreads - 1) / kThreads);
  tangent_matvec_sym_kernel<DIM, NPC>
      <<<blocks, kThreads, kBytes, stream>>>(t, u, out, n_cells);
  return cudaGetLastError();
}

}  // namespace

// K2 and K2b: ptrs[b] is upper block b, a contiguous (npc, npc, n_cells)
// f32 array (for K2, a slice of the pack).
extern "C" cudaError_t dat_tangent_matvec_sym_f32(const void* const* ptrs,
                                                  const void* u, void* out,
                                                  int dim, int npc,
                                                  long long n_cells,
                                                  void* stream) {
  if (n_cells <= 0 || dim < 2 || dim > 3) return cudaErrorInvalidValue;
  SymTable t;
  const int n_b = dim * (dim + 1) / 2;
  for (int b = 0; b < n_b; ++b) t.ptr[b] = static_cast<const float*>(ptrs[b]);
  const float* uu = static_cast<const float*>(u);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    switch (npc) {
      case 4: return launch<2, 4>(t, uu, o, n_cells, s);
      case 9: return launch<2, 9>(t, uu, o, n_cells, s);
      case 16: return launch<2, 16>(t, uu, o, n_cells, s);
      case 25: return launch<2, 25>(t, uu, o, n_cells, s);
    }
  } else {
    switch (npc) {
      case 8: return launch<3, 8>(t, uu, o, n_cells, s);
      case 27: return launch<3, 27>(t, uu, o, n_cells, s);
      case 64: return launch<3, 64>(t, uu, o, n_cells, s);
      case 125: return launch<3, 125>(t, uu, o, n_cells, s);
    }
  }
  return cudaErrorInvalidValue;
}
