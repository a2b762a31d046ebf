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

#include "structured_gather.cuh"

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
