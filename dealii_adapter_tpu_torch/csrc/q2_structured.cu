// K5: Q2 structured element operator y = A u on a 3D nodal lattice, the
// multigrid fine-level proxy (81 x 81 element matrix).
//
// Replaces: dealii_adapter_tpu/ops/pallas_phase.py,
//   PallasQ2PhaseOperator._apply (the phase-split 24-channel reuse of
//   _make_slab_kernel_3d with _phase_element_matrix), and at degree 2 the
//   XLA StructuredOperator it was tuned against.
//
// What bounds it on an H100: at the (19, 325, 55) lattice of the
//   1,018,875-DoF flap the field is 2 MB in bf16, so memory traffic is a
//   few microseconds. The arithmetic is 243 FMA per (node, owning cell):
//   1.5 cells per axis on average, ~3.4 in 3D, ~280 M FMA per apply. The
//   kernel is bound by the instruction rate of the FMAs and the gathered
//   loads from L1, not by device memory.
//
// What the design does about it: the node-parallel gather form of
//   structured_gather.cuh with P = 2, computed directly on the nodal
//   lattice. A node's parity along each axis decides its cells (an even
//   index lies in two cells as local node 0 and 2, an odd one in one cell
//   as local node 1), so no phase split, no 24-channel relayout and no
//   stride-2 access pattern is needed: those existed because Pallas on the
//   TPU could not read stride-2 windows. The 81 x 81 f32 element matrix
//   (26 KB) sits in shared memory; I/O is bf16 or f32, accumulation f32.

#include "structured_gather.cuh"

extern "C" cudaError_t dat_q2_structured(const void* u, void* y, const void* E,
                                         int nz, int ny, int nx, int io_bf16,
                                         void* stream) {
  return dat::launch_structured_gather<2>(u, y, E, nz, ny, nx, io_bf16, stream);
}
