// K3 and K4b: Q1 structured element operator y = A u on a 3D (K3) or 2D
// (K4b) nodal lattice.
//
// Replaces: dealii_adapter_tpu/ops/pallas_structured.py,
//   K3: PallasQ1SlabOperator._apply with _make_slab_kernel_3d(nch=3);
//   K4b: PallasQ1Operator._apply in 2D with _make_kernel_2d (row at a time,
//   the next row's contributions carried in scratch). Each is the operator
//   of every Q1 multigrid level (the FEM-SEM level on the Q2 node lattice
//   and the semi-coarsened levels below it) in its dimension.
//
// What bounds it on an H100: at the largest 3D level, the (19, 325, 55)
//   FEM-SEM lattice, the field is 339,625 nodes x 3 components (2 MB in
//   bf16), so one apply must read u and write y once: ~4 MB, about 1.2 us
//   at 3.35 TB/s. The arithmetic is 8 cells x 72 FMA per node (~196 M FMA
//   per apply), a few us at the card's f32 rate. In 2D, at the (1729, 289)
//   FEM-SEM lattice of the 999,362-DoF flap, u and y are 499,681 nodes x 2
//   (2 MB each in bf16) and the arithmetic 4 cells x 16 FMA per node
//   (~32 M FMA). In practice both are bound by the latency of their
//   L1-served gathers and by launch cost.
//
// What the design does about it: the deterministic gather form of
//   structured_gather.cuh, one thread per node with x fastest, so the
//   gathered neighbours of a warp are contiguous and come from L1. The
//   element matrix (24 x 24 or 8 x 8) is a runtime argument in shared
//   memory (the TPU kernels baked it into the program as constants, which
//   would need one compiled kernel per level). The TPU kernels' sequential
//   row / z-slab grid with a carried row or plane, and the in-plane axis
//   swap, exist for the TPU's sequential grid and lane width and are not
//   carried over: a thread gathers from the (at most 4 or 8) cells of its
//   node instead of scattering into the next row.

//
// K4: the same 3D Q1 operator, marching along z one node plane at a time.
//
// Replaces: dealii_adapter_tpu/ops/pallas_structured.py:PallasQ1Operator.
//   _apply in 3D (_make_kernel_3d: grid step k consumes node planes k and
//   k+1, i.e. cell plane k, writes node plane k and carries the cell
//   plane's contributions to node plane k+1 in VMEM scratch). Reached
//   through make_q1_plane_operator, as the JAX package reaches it through
//   make_pallas_q1_operator on a 3D space; no model path selects it (the
//   level operators stay on K3), so it is measured beside K3.
//
// What bounds it: the same work as K3 (8 cells x 72 FMA per node, u read
//   once, y written once).
//
// What the design does about it: one block of 16 x 8 threads owns a (y, x)
//   tile of output nodes and marches along z: each node plane of the tile
//   plus a one-node halo is read once from device memory into a two-plane
//   ring in shared memory; a thread applies the (at most 4) cells of cell
//   plane k around its node, adds the lower-slot rows (its node in plane
//   k) to the carry from cell plane k-1 and writes node plane k once, and
//   keeps the upper-slot rows (its node in plane k+1) in registers as the
//   next carry: the TPU kernel's `carry` scratch. E is staged into shared
//   memory once per block. Blocks run in parallel over (y, x) tiles, since
//   no order across blocks exists on the card; the z order lives inside
//   the block. f32 accumulation in a fixed order, no atomics.

#include "structured_gather.cuh"

namespace {

constexpr int kPlaneTX = 16;  // tile width (x), nodes
constexpr int kPlaneTY = 8;   // tile height (y), nodes
constexpr int kPlaneHX = kPlaneTX + 2;
constexpr int kPlaneHY = kPlaneTY + 2;

// Node plane k of the tile with its one-node halo into ring buffer `buf`
// (zeros outside the lattice; only cells outside the lattice read them).
template <typename T>
__device__ void load_plane(float (*planes)[3][kPlaneHY][kPlaneHX], int buf,
                           const T* __restrict__ u, int k, int ny, int nx,
                           int y0, int x0) {
  for (int i = threadIdx.x; i < kPlaneHY * kPlaneHX; i += blockDim.x) {
    const int hy = i / kPlaneHX, hx = i % kPlaneHX;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
    const T* p = u + ((static_cast<long long>(k) * ny + gy) * nx + gx) * 3;
#pragma unroll
    for (int e = 0; e < 3; ++e)
      planes[buf][e][hy][hx] = in ? dat::load_f32(p + e) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kPlaneTX * kPlaneTY)
    q1_plane_kernel(const T* __restrict__ u, T* __restrict__ y,
                    const float* __restrict__ E, int nz, int ny, int nx) {
  constexpr int ED = 24;  // 8 nodes x 3 components
  __shared__ float Es[ED * ED];
  __shared__ float planes[2][3][kPlaneHY][kPlaneHX];
  for (int k = threadIdx.x; k < ED * ED; k += blockDim.x) Es[k] = E[k];

  const int y0 = blockIdx.y * kPlaneTY, x0 = blockIdx.x * kPlaneTX;
  const int iy = y0 + threadIdx.x / kPlaneTX;
  const int ix = x0 + threadIdx.x % kPlaneTX;
  const bool active = iy < ny && ix < nx;
  const long long plane_nodes = static_cast<long long>(ny) * nx;
  const long long col = static_cast<long long>(iy) * nx + ix;

  float carry[3] = {0.0f, 0.0f, 0.0f};
  load_plane(planes, 0, u, 0, ny, nx, y0, x0);
  for (int k = 0; k < nz - 1; ++k) {  // cell plane k
    const int cur = k & 1, nxt = cur ^ 1;
    load_plane(planes, nxt, u, k + 1, ny, nx, y0, x0);
    __syncthreads();
    float low[3] = {0.0f, 0.0f, 0.0f}, high[3] = {0.0f, 0.0f, 0.0f};
    if (active) {
      for (int ly = 0; ly < 2; ++ly) {  // this node's y slot in the cell
        const int by = iy - ly;
        if (by < 0 || by > ny - 2) continue;
        for (int lx = 0; lx < 2; ++lx) {
          const int bx = ix - lx;
          if (bx < 0 || bx > nx - 2) continue;
          float uc[ED];  // the cell's 8 nodes (x fastest), 3 components
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int tz = t >> 2, ty = (t >> 1) & 1, tx = t & 1;
            const int hy = by + ty - y0 + 1, hx = bx + tx - x0 + 1;
#pragma unroll
            for (int e = 0; e < 3; ++e)
              uc[t * 3 + e] = planes[tz ? nxt : cur][e][hy][hx];
          }
          const float* el = Es + ((ly * 2 + lx) * 3) * ED;      // slot z=0
          const float* eh = Es + (((2 + ly) * 2 + lx) * 3) * ED;  // slot z=1
#pragma unroll
          for (int d = 0; d < 3; ++d) {
#pragma unroll
            for (int c = 0; c < ED; ++c) {
              low[d] = fmaf(el[d * ED + c], uc[c], low[d]);
              high[d] = fmaf(eh[d * ED + c], uc[c], high[d]);
            }
          }
        }
      }
      T* yp = y + (k * plane_nodes + col) * 3;
#pragma unroll
      for (int d = 0; d < 3; ++d) dat::store_f32(yp + d, carry[d] + low[d]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) carry[d] = high[d];
    __syncthreads();  // the next step overwrites buffer `cur`
  }
  if (active) {
    T* yp = y + ((nz - 1) * plane_nodes + col) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) dat::store_f32(yp + d, carry[d]);
  }
}

cudaError_t launch_q1_plane(const void* u, void* y, const void* E, int nz,
                            int ny, int nx, int io_bf16, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2) return cudaErrorInvalidValue;
  const dim3 grid((nx + kPlaneTX - 1) / kPlaneTX,
                  (ny + kPlaneTY - 1) / kPlaneTY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Ef = static_cast<const float*>(E);
  if (io_bf16) {
    q1_plane_kernel<__nv_bfloat16><<<grid, kPlaneTX * kPlaneTY, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
        Ef, nz, ny, nx);
  } else {
    q1_plane_kernel<float><<<grid, kPlaneTX * kPlaneTY, 0, s>>>(
        static_cast<const float*>(u), static_cast<float*>(y), Ef, nz, ny, nx);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t dat_q1_plane(const void* u, void* y, const void* E,
                                    int nz, int ny, int nx, int io_bf16,
                                    void* stream) {
  return launch_q1_plane(u, y, E, nz, ny, nx, io_bf16, stream);
}

extern "C" cudaError_t dat_q1_structured(const void* u, void* y, const void* E,
                                         int nz, int ny, int nx, int io_bf16,
                                         void* stream) {
  return dat::launch_structured_gather<3, 1>(u, y, E, nz, ny, nx, io_bf16,
                                             stream);
}

extern "C" cudaError_t dat_q1_structured_2d(const void* u, void* y,
                                            const void* E, int ny, int nx,
                                            int io_bf16, void* stream) {
  return dat::launch_structured_gather<2, 1>(u, y, E, 1, ny, nx, io_bf16,
                                             stream);
}
