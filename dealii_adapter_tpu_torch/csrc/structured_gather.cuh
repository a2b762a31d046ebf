// Gather-form structured Q_P element operator on a 3D nodal lattice,
// shared by the Q1 (K3, q1_structured.cu) and Q2 (K5, q2_structured.cu)
// entry points.
//
//   y[n, d] = sum over cells C containing node n (local slot s of n in C)
//             sum_{t, e} E[(s, d), (t, e)] * u[node(C, t), e]
//
// The lattice is (nz, ny, nx) nodes, x fastest, 3 components per node
// stored node-major (the (n_nodes, 3) layout of the rest of the package).
// Cells of degree P cover P + 1 nodes per axis and are P nodes apart, so a
// lattice of nc cells per axis has nc * P + 1 nodes. E is the (npc * 3)^2
// element matrix in node-major order (row = output dof), npc = (P + 1)^3,
// local slots lexicographic with x fastest.
//
// One thread owns one output node: it visits the 1 to 8 cells that
// contain it, skips cell indices outside the lattice (the ghost-cell mask
// of the TPU kernel), and sums in f32 in a fixed order. Every output is
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

template <int P, typename T>
__global__ void structured_gather_kernel(const T* __restrict__ u,
                                         T* __restrict__ y,
                                         const float* __restrict__ E,
                                         int nz, int ny, int nx) {
  constexpr int K = P + 1;           // nodes per cell per axis
  constexpr int NPC = K * K * K;     // nodes per cell
  constexpr int ED = NPC * 3;        // element dofs
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

  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  for (int lz = 0; lz < K; ++lz) {
    const int bz = iz - lz;  // lattice index of the cell's first z node
    if (bz < 0 || bz % P != 0 || bz / P >= ncz) continue;
    for (int ly = 0; ly < K; ++ly) {
      const int by = iy - ly;
      if (by < 0 || by % P != 0 || by / P >= ncy) continue;
      for (int lx = 0; lx < K; ++lx) {
        const int bx = ix - lx;
        if (bx < 0 || bx % P != 0 || bx / P >= ncx) continue;
        const int s = (lz * K + ly) * K + lx;  // this node's local slot
        const float* e0 = Es + (s * 3 + 0) * ED;
        const float* e1 = e0 + ED;
        const float* e2 = e1 + ED;
        int t = 0;
        for (int tz = 0; tz < K; ++tz) {
          for (int ty = 0; ty < K; ++ty) {
            const long long row =
                (static_cast<long long>(bz + tz) * ny + (by + ty)) * nx + bx;
            for (int tx = 0; tx < K; ++tx, ++t) {
              const T* up = u + (row + tx) * 3;
              const float u0 = load_f32(up);
              const float u1 = load_f32(up + 1);
              const float u2 = load_f32(up + 2);
              const int col = t * 3;
              acc0 = fmaf(e0[col], u0, acc0);
              acc0 = fmaf(e0[col + 1], u1, acc0);
              acc0 = fmaf(e0[col + 2], u2, acc0);
              acc1 = fmaf(e1[col], u0, acc1);
              acc1 = fmaf(e1[col + 1], u1, acc1);
              acc1 = fmaf(e1[col + 2], u2, acc1);
              acc2 = fmaf(e2[col], u0, acc2);
              acc2 = fmaf(e2[col + 1], u1, acc2);
              acc2 = fmaf(e2[col + 2], u2, acc2);
            }
          }
        }
      }
    }
  }
  T* yp = y + node * 3;
  store_f32(yp, acc0);
  store_f32(yp + 1, acc1);
  store_f32(yp + 2, acc2);
}

template <int P>
cudaError_t launch_structured_gather(const void* u, void* y, const void* E,
                                     int nz, int ny, int nx, int io_bf16,
                                     void* stream) {
  if (nz < P + 1 || ny < P + 1 || nx < P + 1 || (nz - 1) % P ||
      (ny - 1) % P || (nx - 1) % P)
    return cudaErrorInvalidValue;
  const long long n_nodes = static_cast<long long>(nz) * ny * nx;
  const unsigned blocks =
      static_cast<unsigned>((n_nodes + kGatherThreads - 1) / kGatherThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Ef = static_cast<const float*>(E);
  if (io_bf16) {
    structured_gather_kernel<P, __nv_bfloat16><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
        Ef, nz, ny, nx);
  } else {
    structured_gather_kernel<P, float><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const float*>(u), static_cast<float*>(y), Ef, nz, ny, nx);
  }
  return cudaGetLastError();
}

}  // namespace dat
