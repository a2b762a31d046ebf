// Gather-form structured Q_P element operator on a 2D or 3D nodal lattice:
// K4b (q1_structured.cu) and the first designs of K3 and K5, kept as the
// entry points dat_q1_structured_gather and dat_q2_structured_gather that
// chip_smoke.py times beside the redesigned kernels; and the I/O helpers
// the package's kernels share.
//
//   y[n, d] = sum over cells C containing node n (local slot s of n in C)
//             sum_{t, e} E[(s, d), (t, e)] * u[node(C, t), e]
//
// The lattice is (nz, ny, nx) nodes in 3D and (ny, nx) in 2D (passed as
// nz = 1), x fastest, DIM components per node stored node-major (the
// (n_nodes, DIM) layout of the rest of the package). Cells of degree P
// cover P + 1 nodes per axis and are P nodes apart, so a lattice of nc
// cells per axis has nc * P + 1 nodes. E is the (npc * DIM)^2 element
// matrix in node-major order (row = output dof), npc = (P + 1)^DIM, local
// slots lexicographic with x fastest.
//
// One thread owns one output node: it visits the 1 to 2^DIM cells that
// contain it, skips cell indices outside the lattice (the ghost-cell mask
// of the TPU kernels), and sums in f32 in a fixed order (cells, then
// slots t, then components e, per output component). Every output is
// written once by one thread: no atomics, and the result is bitwise
// reproducible from run to run. E is a runtime argument staged into
// shared memory once per block, so one compiled kernel serves every
// multigrid level (each level has its own anisotropic E).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dat {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

constexpr int kGatherThreads = 128;

template <int DIM, int P, typename T>
__global__ void structured_gather_kernel(const T* __restrict__ u,
                                         T* __restrict__ y,
                                         const float* __restrict__ E,
                                         int nz, int ny, int nx) {
  static_assert(DIM == 2 || DIM == 3, "2D or 3D lattices");
  constexpr int K = P + 1;                  // nodes per cell per axis
  constexpr int KZ = DIM == 3 ? K : 1;      // a 2D lattice is one z plane
  constexpr int NPC = KZ * K * K;           // nodes per cell
  constexpr int ED = NPC * DIM;             // element dofs
  __shared__ float Es[ED * ED];
  for (int k = threadIdx.x; k < ED * ED; k += blockDim.x) Es[k] = E[k];
  __syncthreads();

  const long long n_nodes = static_cast<long long>(nz) * ny * nx;
  const long long node =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const int ix = static_cast<int>(node % nx);
  const int iy = static_cast<int>((node / nx) % ny);
  const int iz = static_cast<int>(node / (static_cast<long long>(nx) * ny));
  const int ncz = (nz - 1) / P, ncy = (ny - 1) / P, ncx = (nx - 1) / P;

  float acc[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) acc[d] = 0.0f;
  for (int lz = 0; lz < KZ; ++lz) {
    const int bz = iz - lz;  // lattice index of the cell's first z node
    if (DIM == 3 && (bz < 0 || bz % P != 0 || bz / P >= ncz)) continue;
    for (int ly = 0; ly < K; ++ly) {
      const int by = iy - ly;
      if (by < 0 || by % P != 0 || by / P >= ncy) continue;
      for (int lx = 0; lx < K; ++lx) {
        const int bx = ix - lx;
        if (bx < 0 || bx % P != 0 || bx / P >= ncx) continue;
        const int s = (lz * K + ly) * K + lx;  // this node's local slot
        const float* es = Es + s * DIM * ED;   // its DIM rows of E
        int t = 0;
        for (int tz = 0; tz < KZ; ++tz) {
          for (int ty = 0; ty < K; ++ty) {
            const long long row =
                (static_cast<long long>(bz + tz) * ny + (by + ty)) * nx + bx;
            for (int tx = 0; tx < K; ++tx, ++t) {
              const T* up = u + (row + tx) * DIM;
              float uv[DIM];
#pragma unroll
              for (int e = 0; e < DIM; ++e) uv[e] = load_f32(up + e);
              const int col = t * DIM;
#pragma unroll
              for (int d = 0; d < DIM; ++d) {
#pragma unroll
                for (int e = 0; e < DIM; ++e)
                  acc[d] = fmaf(es[d * ED + col + e], uv[e], acc[d]);
              }
            }
          }
        }
      }
    }
  }
  T* yp = y + node * DIM;
#pragma unroll
  for (int d = 0; d < DIM; ++d) store_f32(yp + d, acc[d]);
}

// nz must be 1 for DIM == 2.
template <int DIM, int P>
cudaError_t launch_structured_gather(const void* u, void* y, const void* E,
                                     int nz, int ny, int nx, int io_bf16,
                                     void* stream) {
  const bool z_ok = DIM == 3 ? (nz >= P + 1 && (nz - 1) % P == 0) : nz == 1;
  if (!z_ok || ny < P + 1 || nx < P + 1 || (ny - 1) % P || (nx - 1) % P)
    return cudaErrorInvalidValue;
  const long long n_nodes = static_cast<long long>(nz) * ny * nx;
  const unsigned blocks =
      static_cast<unsigned>((n_nodes + kGatherThreads - 1) / kGatherThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Ef = static_cast<const float*>(E);
  if (io_bf16) {
    structured_gather_kernel<DIM, P, __nv_bfloat16>
        <<<blocks, kGatherThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(u),
            static_cast<__nv_bfloat16*>(y), Ef, nz, ny, nx);
  } else {
    structured_gather_kernel<DIM, P, float><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const float*>(u), static_cast<float*>(y), Ef, nz, ny, nx);
  }
  return cudaGetLastError();
}

}  // namespace dat
