// K1: per-cell assembled-tangent matvec over the column-major pack.
//
//   out[i, c] = sum_j KT[j, i, c] * u[j, c]      (i, j < edofs, c < n_cells)
//
// Replaces: dealii_adapter_tpu/ops/assembled_tangent.py,
//   apply_packed_tangents_T_pallas (kernel body _matvec_kernel_T). The CG
//   of every Newton iteration applies it once per iteration.
//
// What bounds it on an H100: device-memory bandwidth. At the 1,018,875-DoF
//   Q2 flap (edofs 81, 39,366 cells) KT is 1.03 GB of f32 and every entry
//   is read exactly once for one FMA, so the floor is ~0.31 ms at
//   3.35 TB/s; the 81 x C vectors u and out are 1/81 of that traffic.
//
// What the design does about it: one thread per (output row i, cell c),
//   with c fastest across the threads of a warp, so each load of
//   KT[j, i, c] is a fully coalesced 128-byte line per warp and the whole
//   tangent streams through once with no reuse to exploit. u[j, c] is the
//   same address for the 81 row-blocks of a cell column and is served from
//   L1/L2. The kernel bounds-checks c itself, so the cell count needs no
//   padding to a block multiple (the TPU kernel padded to 512 lanes). The
//   j loop runs in order with f32 FMA, the same order as the TPU kernel and
//   the plain einsum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void tangent_matvec_kernel(const float* __restrict__ KT,
                                      const float* __restrict__ u,
                                      float* __restrict__ out, int edofs,
                                      long long n_cells) {
  const long long c =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= n_cells) return;
  const int i = blockIdx.y;
  const float* k = KT + static_cast<long long>(i) * n_cells + c;
  const float* v = u + c;
  const long long k_stride = static_cast<long long>(edofs) * n_cells;
  float acc = 0.0f;
  for (int j = 0; j < edofs; ++j) {
    acc = fmaf(__ldg(k), __ldg(v), acc);
    k += k_stride;
    v += n_cells;
  }
  out[static_cast<long long>(i) * n_cells + c] = acc;
}

}  // namespace

extern "C" cudaError_t dat_tangent_matvec_f32(const void* KT, const void* u,
                                              void* out, int edofs,
                                              long long n_cells,
                                              void* stream) {
  if (edofs <= 0 || edofs > 65535 || n_cells <= 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((n_cells + kThreads - 1) / kThreads),
                  static_cast<unsigned>(edofs));
  tangent_matvec_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(KT), static_cast<const float*>(u),
      static_cast<float*>(out), edofs, n_cells);
  return cudaGetLastError();
}
