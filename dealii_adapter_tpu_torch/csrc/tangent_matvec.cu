// K1, K1b, K1c: per-cell assembled-tangent matvec over full storage.
//
//   out[(d,i), c] = sum_(e,j) K[d][e][i, j, c] * u[(e,j), c]
//                                   (i, j < npc, d, e < dim, c < n_cells)
//
// Replaces (dealii_adapter_tpu/ops/assembled_tangent.py):
//   K1  apply_packed_tangents_T_pallas (_matvec_kernel_T): the column-major
//       pack KT[(e,j), (d,i), c];
//   K1b apply_packed_tangents_pallas (_matvec_kernel): the row-major pack
//       K[(d,i), (e,j), c];
//   K1c apply_block_tangents_pallas (_matvec_blocks_kernel_body): the dim^2
//       separate (npc, npc, c) blocks, no pack.
//   The CG of every Newton iteration applies one of them per iteration.
//
// What bounds them on an H100: device-memory bandwidth. At the
//   1,018,875-DoF Q2 flap (edofs 81, 39,366 cells) the tangent is 1.03 GB
//   of f32 and every entry is read exactly once for one FMA, so the floor
//   is ~0.31 ms at 3.35 TB/s; the 81 x C vectors u and out are 1/81 of
//   that traffic.
//
// What the design does about it: one thread per (output row, cell c),
//   with c fastest across the threads of a warp, so each load of a tangent
//   entry is a fully coalesced 128-byte line per warp and the whole tangent
//   streams through once with no reuse to exploit. The three layouts differ
//   only in the strides of the row and column index: K1 and K1b are one
//   kernel with those strides swapped; K1c walks dim^2 block pointers, each
//   with its own strides, so the lower blocks, which the port keeps as
//   transposed views of the upper ones, are read through their strides
//   with no copy. u[(e,j), c] is the same address for every row of a cell
//   column and is served from L1/L2. The kernels bounds-check c
//   themselves, so the cell count needs no padding (the TPU kernels padded
//   to 512 lanes). The column index runs in order (e, then j) with f32 FMA,
//   the order of the TPU kernels.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBlocks = 9;  // dim^2, dim <= 3

struct BlockTable {
  const float* ptr[kMaxBlocks];
  long long stride_i[kMaxBlocks];  // row stride of block (d, e), in floats
  long long stride_j[kMaxBlocks];  // column stride
};

__global__ void tangent_matvec_kernel(const float* __restrict__ K,
                                      const float* __restrict__ u,
                                      float* __restrict__ out, int edofs,
                                      long long n_cells, long long stride_i,
                                      long long stride_j) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n_cells) return;
  const int i = blockIdx.y;
  const float* k = K + static_cast<long long>(i) * stride_i + c;
  const float* v = u + c;
  float acc = 0.0f;
  for (int j = 0; j < edofs; ++j) {
    acc = fmaf(__ldg(k), __ldg(v), acc);
    k += stride_j;
    v += n_cells;
  }
  out[static_cast<long long>(i) * n_cells + c] = acc;
}

__global__ void tangent_matvec_blocks_kernel(const BlockTable t,
                                             const float* __restrict__ u,
                                             float* __restrict__ out,
                                             int dim, int npc,
                                             long long n_cells) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n_cells) return;
  const int row = blockIdx.y;
  const int d = row / npc;
  const int i = row - d * npc;
  const float* v = u + c;
  float acc = 0.0f;
  for (int e = 0; e < dim; ++e) {
    const int b = d * dim + e;
    const float* k = t.ptr[b] + static_cast<long long>(i) * t.stride_i[b] + c;
    const long long sj = t.stride_j[b];
    for (int j = 0; j < npc; ++j) {
      acc = fmaf(__ldg(k), __ldg(v), acc);
      k += sj;
      v += n_cells;
    }
  }
  out[static_cast<long long>(row) * n_cells + c] = acc;
}

dim3 grid_of(long long n_cells, int rows) {
  return dim3(static_cast<unsigned>((n_cells + kThreads - 1) / kThreads),
              static_cast<unsigned>(rows));
}

}  // namespace

// K1: KT[(e,j), (d,i), c], contiguous (edofs, edofs, n_cells).
extern "C" cudaError_t dat_tangent_matvec_f32(const void* KT, const void* u,
                                              void* out, int edofs,
                                              long long n_cells,
                                              void* stream) {
  if (edofs <= 0 || edofs > 65535 || n_cells <= 0) return cudaErrorInvalidValue;
  tangent_matvec_kernel<<<grid_of(n_cells, edofs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(KT), static_cast<const float*>(u),
      static_cast<float*>(out), edofs, n_cells, n_cells,
      static_cast<long long>(edofs) * n_cells);
  return cudaGetLastError();
}

// K1b: K[(d,i), (e,j), c], contiguous (edofs, edofs, n_cells).
extern "C" cudaError_t dat_tangent_matvec_rows_f32(const void* K,
                                                   const void* u, void* out,
                                                   int edofs,
                                                   long long n_cells,
                                                   void* stream) {
  if (edofs <= 0 || edofs > 65535 || n_cells <= 0) return cudaErrorInvalidValue;
  tangent_matvec_kernel<<<grid_of(n_cells, edofs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(K), static_cast<const float*>(u),
      static_cast<float*>(out), edofs, n_cells,
      static_cast<long long>(edofs) * n_cells, n_cells);
  return cudaGetLastError();
}

// K1c: dim^2 blocks K[d][e] (row-major order of (d, e)), block b's entry
// (i, j, c) at ptrs[b] + i * strides_i[b] + j * strides_j[b] + c.
extern "C" cudaError_t dat_tangent_matvec_blocks_f32(
    const void* const* ptrs, const long long* strides_i,
    const long long* strides_j, const void* u, void* out, int dim, int npc,
    long long n_cells, void* stream) {
  if (dim <= 0 || dim * dim > kMaxBlocks || npc <= 0 || dim * npc > 65535 ||
      n_cells <= 0)
    return cudaErrorInvalidValue;
  BlockTable t;
  for (int b = 0; b < dim * dim; ++b) {
    t.ptr[b] = static_cast<const float*>(ptrs[b]);
    t.stride_i[b] = strides_i[b];
    t.stride_j[b] = strides_j[b];
  }
  tangent_matvec_blocks_kernel<<<grid_of(n_cells, dim * npc), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const float*>(u), static_cast<float*>(out), dim, npc,
      n_cells);
  return cudaGetLastError();
}
