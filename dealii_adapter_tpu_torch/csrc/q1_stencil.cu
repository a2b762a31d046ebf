// K6: the assembled Q1 stencil operator y = A u on a 3D (27-point) or 2D
// (9-point) nodal lattice, the multigrid level operator of the `stencil*`
// level backends.
//
// Replaces: dealii_adapter_tpu/ops/stencil.py:_vmem_pass (the
//   whole-field-in-VMEM Pallas interior pass of StencilQ1Operator,
//   strategy "vmem", 3D) together with the inclusion-exclusion boundary
//   corrections that StencilQ1Operator.apply adds around it as 26 separate
//   XLA slice-and-add pieces, and the XLA `shift` pass the JAX package runs
//   in 2D.
//
//   y[n, d] = sum_{delta in {-1,0,1}^NDIM, n+delta in the lattice}
//             sum_e T[class(n)][delta][d][e] * u[n + delta, e]
//
// The lattice is (nz, ny, nx) nodes in 3D and (ny, nx) in 2D (passed as
// nz = 1), x fastest, NDIM components per node stored node-major (the
// (n_nodes, NDIM) layout of the rest of the package). class(n) has one
// digit per axis, slowest first: 0 on the low face, 1 inside, 2 on the high
// face. T (3^NDIM classes x 3^NDIM offsets x NDIM x NDIM, f32) is built on
// the host (ops/stencil.py:class_tables): the interior stencil S3 with the
// face, edge and corner corrections of the node's class folded in, so the
// boundary is exact in the same launch and an out-of-lattice neighbour is
// simply skipped (the zero padding of the plain version).
//
// What bounds it on an H100: at the largest 3D level, the (19, 325, 55)
//   FEM-SEM lattice, 339,625 nodes x 243 FMA is 0.165 GFLOP, 2.5 us at the
//   card's 67 TFLOP/s f32 rate, against u read once and y written once
//   (4.1 MB in bf16, 1.2 us at 3.35 TB/s): operations.
//
// What the design does about it: one thread per output node (a
//   grid-stride loop over at most 8 blocks per SM), each reading its 27 (9)
//   neighbours straight from the node-major field, x fastest so a warp's
//   neighbour reads are contiguous and served from L1; no padded or
//   transposed copy of the field (the JAX wrapper's moveaxis/pad/transpose
//   is TPU layout work). The tables are a runtime argument staged once per
//   block into shared memory (26 KB in 3D), since every level has its own
//   anisotropic element matrix; threads of one class read one address (a
//   broadcast). f32 accumulation in a fixed order (offsets, then source
//   components), no atomics: bitwise reproducible from run to run. The
//   TPU kernel's sequential z-plane loop and lane-major layout are not
//   carried over.

#include "structured_gather.cuh"

namespace {

constexpr int kStencilThreads = 256;
constexpr int kStencilBlocksPerSM = 8;

template <int NDIM, typename T>
__global__ void __launch_bounds__(kStencilThreads)
    q1_stencil_kernel(const T* __restrict__ u, T* __restrict__ y,
                      const float* __restrict__ tables, int nz, int ny,
                      int nx) {
  static_assert(NDIM == 2 || NDIM == 3, "2D or 3D lattices");
  constexpr int NOFF = NDIM == 3 ? 27 : 9;  // offsets, also classes
  constexpr int TAB = NOFF * NOFF * NDIM * NDIM;
  constexpr int ZR = NDIM == 3 ? 1 : 0;  // z offsets run over [-ZR, ZR]
  __shared__ float Ts[TAB];
  for (int k = threadIdx.x; k < TAB; k += blockDim.x) Ts[k] = tables[k];
  __syncthreads();

  const long long n_nodes = static_cast<long long>(nz) * ny * nx;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long node = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
       node < n_nodes; node += stride) {
    const int ix = static_cast<int>(node % nx);
    const int iy = static_cast<int>((node / nx) % ny);
    const int iz = static_cast<int>(node / (static_cast<long long>(nx) * ny));
    const int cx = ix == 0 ? 0 : (ix == nx - 1 ? 2 : 1);
    const int cy = iy == 0 ? 0 : (iy == ny - 1 ? 2 : 1);
    const int cz = NDIM == 3 ? (iz == 0 ? 0 : (iz == nz - 1 ? 2 : 1)) : 0;
    const int cls = NDIM == 3 ? (cz * 3 + cy) * 3 + cx : cy * 3 + cx;
    const float* tc = Ts + cls * NOFF * NDIM * NDIM;

    float acc[NDIM];
#pragma unroll
    for (int d = 0; d < NDIM; ++d) acc[d] = 0.0f;
#pragma unroll
    for (int dz = -ZR; dz <= ZR; ++dz) {
      const int jz = iz + dz;
      if (jz < 0 || jz >= nz) continue;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const int jy = iy + dy;
        if (jy < 0 || jy >= ny) continue;
        const long long row = (static_cast<long long>(jz) * ny + jy) * nx;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int jx = ix + dx;
          if (jx < 0 || jx >= nx) continue;
          const int off = ((dz + ZR) * 3 + (dy + 1)) * 3 + (dx + 1);
          const T* up = u + (row + jx) * NDIM;
          float uv[NDIM];
#pragma unroll
          for (int e = 0; e < NDIM; ++e) uv[e] = dat::load_f32(up + e);
          const float* w = tc + off * NDIM * NDIM;
#pragma unroll
          for (int d = 0; d < NDIM; ++d) {
#pragma unroll
            for (int e = 0; e < NDIM; ++e)
              acc[d] = fmaf(w[d * NDIM + e], uv[e], acc[d]);
          }
        }
      }
    }
    T* yp = y + node * NDIM;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) dat::store_f32(yp + d, acc[d]);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        count <= 0)
      count = 132;  // an H100 SXM
  }
  return count;
}

template <int NDIM>
cudaError_t launch_q1_stencil(const void* u, void* y, const void* tables,
                              int nz, int ny, int nx, int io_bf16,
                              void* stream) {
  const bool z_ok = NDIM == 3 ? nz >= 2 : nz == 1;
  if (!z_ok || ny < 2 || nx < 2) return cudaErrorInvalidValue;
  const long long n_nodes = static_cast<long long>(nz) * ny * nx;
  const long long want = (n_nodes + kStencilThreads - 1) / kStencilThreads;
  const long long cap = static_cast<long long>(kStencilBlocksPerSM) * sm_count();
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Tf = static_cast<const float*>(tables);
  if (io_bf16) {
    q1_stencil_kernel<NDIM, __nv_bfloat16><<<blocks, kStencilThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
        Tf, nz, ny, nx);
  } else {
    q1_stencil_kernel<NDIM, float><<<blocks, kStencilThreads, 0, s>>>(
        static_cast<const float*>(u), static_cast<float*>(y), Tf, nz, ny, nx);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dat_q1_stencil(const void* u, void* y,
                                      const void* tables, int nz, int ny,
                                      int nx, int ndim, int io_bf16,
                                      void* stream) {
  if (ndim == 3)
    return launch_q1_stencil<3>(u, y, tables, nz, ny, nx, io_bf16, stream);
  if (ndim == 2)
    return launch_q1_stencil<2>(u, y, tables, nz, ny, nx, io_bf16, stream);
  return cudaErrorInvalidValue;
}
