// K3: Q1 structured element operator y = A u on a 3D nodal lattice.
//
// Replaces: dealii_adapter_tpu/ops/pallas_structured.py,
//   PallasQ1SlabOperator._apply with _make_slab_kernel_3d(nch=3): the
//   operator of every Q1 multigrid level (the FEM-SEM level on the Q2 node
//   lattice and the semi-coarsened levels below it).
//
// What bounds it on an H100: at the largest level, the (19, 325, 55)
//   FEM-SEM lattice, the field is 339,625 nodes x 3 components (2 MB in
//   bf16), so one apply must read u and write y once: ~4 MB, about 1.2 us
//   at 3.35 TB/s. The arithmetic is 8 cells x 72 FMA per node (~196 M FMA
//   per apply), well under the card's f32 rate, so in practice the kernel
//   is bound by the latency of its L1-served gathers and by launch cost.
//
// What the design does about it: the deterministic gather form of
//   structured_gather.cuh, one thread per node with x fastest, so the
//   gathered neighbours of a warp are contiguous and come from L1. The
//   24 x 24 element matrix is a runtime argument in shared memory (the TPU
//   kernel baked it into the program as constants, which would need one
//   compiled kernel per level). The TPU kernel's sequential z-slab grid,
//   carried plane and in-plane axis swap exist for the TPU's sequential
//   grid and lane width and are not carried over.

#include "structured_gather.cuh"

extern "C" cudaError_t dat_q1_structured(const void* u, void* y, const void* E,
                                         int nz, int ny, int nx, int io_bf16,
                                         void* stream) {
  return dat::launch_structured_gather<1>(u, y, E, nz, ny, nx, io_bf16, stream);
}
