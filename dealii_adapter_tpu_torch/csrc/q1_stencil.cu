// K6's first design: the pointwise assembled Q1 stencil y = A u on a 3D
// (27-point) or 2D (9-point) nodal lattice, one thread a node. K6 itself,
// the level operator of the `stencil*` multigrid backends
// (ops/stencil.py:StencilQ1Operator, entry dat_q1_stencil), now launches
// the folded level kernels of q1_structured.cu (K3's q1_level_kernel in 3D,
// q1_level_kernel_2d in 2D) with the same per-node-class tables; this
// kernel stays as the entry point dat_q1_stencil_pointwise, which only
// chip_smoke.py's timing calls, so that the two designs can be timed side
// by side.
//
// Replaced, in dealii_adapter_tpu/: ops/stencil.py:_vmem_pass (the
//   whole-field-in-VMEM Pallas interior pass, pallas_call at :244)
//   together with the inclusion-exclusion boundary corrections that
//   StencilQ1Operator.apply adds around it, and the XLA `shift` pass the
//   JAX package runs in 2D.
//
//   y[n, d] = sum_{delta in {-1,0,1}^NDIM, n+delta in the lattice}
//             sum_e T[class(n)][delta][d][e] * u[n + delta, e]
//
// The lattice is (nz, ny, nx) nodes in 3D and (ny, nx) in 2D (passed as
// nz = 1), x fastest, NDIM components per node stored node-major. T (3^NDIM
// classes x 3^NDIM offsets x NDIM x NDIM, f32) is ops/stencil.py:
// class_tables, unpadded.
//
// What bounds the function on an H100: operations in 3D (243 FMA a node,
//   2.5 us at the (19, 325, 55) level), bytes in 2D (2.39 us in f32 at the
//   (1729, 289) level).
//
// What held this design at ~10% of that bound in 3D (0.0259 ms at the
//   (19, 325, 55) level on an NVIDIA H100 80GB HBM3, 700.00 W): one
//   thread per output node on a grid-stride loop with 64-bit `%` and `/`
//   for its coordinates, 27 (9) neighbours x NDIM scalar global loads each
//   behind a bounds branch, one scalar shared-memory coefficient load per
//   FMA, and every block staging the whole 26 KB table: the
//   instruction-issue profile of K3's gather design. f32 accumulation in a
//   fixed order, no atomics.

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
          for (int e = 0; e < NDIM; ++e) uv[e] = dat::load(up + e);
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
    for (int d = 0; d < NDIM; ++d) dat::store(yp + d, acc[d]);
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
  if (!z_ok || ny < 2 || nx < 2 || (io_bf16 != 0 && io_bf16 != 1))
    return cudaErrorInvalidValue;
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

extern "C" cudaError_t dat_q1_stencil_pointwise(const void* u, void* y,
                                                const void* tables, int nz,
                                                int ny, int nx, int ndim,
                                                int io_bf16, void* stream) {
  if (ndim == 3)
    return launch_q1_stencil<3>(u, y, tables, nz, ny, nx, io_bf16, stream);
  if (ndim == 2)
    return launch_q1_stencil<2>(u, y, tables, nz, ny, nx, io_bf16, stream);
  return cudaErrorInvalidValue;
}
