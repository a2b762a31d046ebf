// K5: Q2 structured element operator y = A u on a 3D nodal lattice, the
// multigrid fine-level proxy (81 x 81 element matrix).
//
// Replaces: dealii_adapter_tpu/ops/pallas_phase.py,
//   PallasQ2PhaseOperator._apply (the phase-split 24-channel reuse of
//   _make_slab_kernel_3d with _phase_element_matrix), and at degree 2 the
//   XLA StructuredOperator it was tuned against.
//
//   y[n, d] = sum over cells C containing node n (local slot s of n in C)
//             sum_{t, e} E[(s, d), (t, e)] * u[node(C, t), e]
//
// What bounds it on an H100: at the (19, 325, 55) lattice of the
//   1,018,875-DoF flap (39,366 cells) the work is one product Y = U E^T of
//   the 39,366 x 81 cell vectors U with the 81 x 81 element matrix, 258 M
//   FMA: 7.7 us at the card's 67 TFLOP/s f32 rate, under 1 us at its
//   989 TFLOP/s bf16 tensor-core rate; u read once and y written once is
//   ~4 MB in bf16, 1.2 us at 3.35 TB/s. chip_smoke.py holds the bf16 path
//   against this design's bound (the bytes; its tensor-core products, E_hi
//   and E_lo, take ~1 us) with the f32-FMA bound beside it, and the f32
//   path against the f32-FMA bound.
//
// What held the first design back (the gather template of
//   structured_gather.cuh, kept as dat_q2_structured_gather so that the two
//   can be timed side by side; 0.19 ms, 4% of the bound): one thread per
//   node and 128 per block, each block first staging the whole 26 KB E from
//   L2 (~69 MB of L2 traffic per apply, ~8 blocks per SM); neighbouring
//   lanes alternate x parity, so warps diverged and read different E rows
//   (no shared-memory broadcast); ~3.4 x 27 scattered 3-component loads per
//   node with 64-bit `%` and `/` per cell.
//
// What the design does about it (q2_tile_kernel): a block of 128 threads
//   owns a tile of TZ x TY x TX = 9 x 4 x 3 cells and computes them plus the
//   one-cell halo on the low side of each axis that lies in the lattice (on
//   the main path: z spans the lattice, so 9 x 5 x 4 cells for 9 x 4 x 3
//   owned; halo cells are recomputed by both neighbours, so no atomics).
//   1. The cells' node patch (x rows contiguous in device memory) is read
//      once into shared memory in the I/O dtype: a warp copies whole rows,
//      8 rows' loads in flight per lane.
//   2. bf16 I/O: Y = U E^T on the tensor cores, `mma.sync` m16n8k16 bf16
//      with f32 accumulation, cells as M (16 per tile), E^T padded to 96 x 88
//      as K x N. The A fragments are read straight from the node patch
//      through a per-thread table of dof offsets (no U copy). Each of the 4
//      warps keeps the B fragments of its 2-3 of the 11 n-tiles in
//      registers for the whole block, loaded once from a fragment-ordered
//      array built on the host (ops/q2_structured.py:q2_mma_fragments).
//      Error budget: E is split on the host into two bf16 terms, E = E_hi +
//      E_lo + r with |r| <= 2^-17 |E| (E_hi rounds E to 8 bits, E_lo rounds
//      the f32 remainder to 8 more); u is exact in bf16 on this path, so
//      each product E_hi u and E_lo u is exact in f32 and the sums carry f32
//      rounding only: ~2^-17 relative per product, 256x under the bf16
//      output's own rounding (2^-9), which dominates the error against the
//      plain f32 version.
//      f32 I/O: the same tiling with f32 FMA (a bf16 split of an f32 u is
//      not exact, and TF32 keeps ~10 bits: Krylov operators need true f32),
//      E in shared memory read as float4 broadcasts; every 3D path runs K5
//      in bf16, so this variant is kept simple.
//   3. Y (f32, one row of 81 per cell) stays in shared memory; each thread
//      then sums its owned nodes' 1 to 8 cell contributions in a fixed order
//      (cells by z, y, x) and writes each output node once: deterministic,
//      bitwise reproducible from run to run.
//   32-bit index arithmetic inside the block; 73.5 KB of shared memory on
//   the main path, so three blocks per SM.

#include <cstdint>

#include "smem_attr.cuh"
#include "structured_gather.cuh"

namespace {

constexpr int kQ2TZ = 9, kQ2TY = 4, kQ2TX = 3;  // owned cells per block
constexpr int kQ2Threads = 128;                 // 4 warps
constexpr int kED = 81;                         // element dofs
constexpr int kKSteps = 6;                      // K = 96 = 6 x 16
constexpr int kNTiles = 11;                     // N = 88 = 11 x 8
constexpr int kEPitch = 84;                     // f32 path: E row, float4s

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// offset of element dof k (slot k / 3, component k % 3) in a node patch
// with row stride sy and plane stride sz; -1 for the padding (k >= 81)
__device__ __forceinline__ int dof_offset(int k, int sy, int sz) {
  if (k >= kED) return -1;
  const int slot = k / 3, e = k - 3 * slot;
  return (slot / 9) * sz + ((slot / 3) % 3) * sy + (slot % 3) * 3 + e;
}

// the cells of node i along one axis: (local cell, slot), lower cell first;
// every entry is written at a fixed index, so the lists stay in registers
__device__ __forceinline__ int axis_cells(int i, int lo, int nc, int (&c)[2],
                                          int (&s)[2]) {
  const int h = i >> 1;
  if (i & 1) {  // inside cell h, as its local node 1
    c[0] = c[1] = h - lo;
    s[0] = s[1] = 1;
    return 1;
  }
  const bool below = h >= 1, above = h < nc;  // cells h - 1 and h
  c[0] = (below ? h - 1 : h) - lo;
  s[0] = below ? 2 : 0;
  c[1] = h - lo;
  s[1] = 0;
  return below && above ? 2 : 1;
}

template <typename T, typename TO, bool kMMA>
__global__ void __launch_bounds__(kQ2Threads)
    q2_tile_kernel(const T* __restrict__ u, TO* __restrict__ y,
                   const uint2* __restrict__ frag, const float* __restrict__ E,
                   int nz, int ny, int nx) {
  extern __shared__ __align__(16) unsigned char q2_smem[];
  const int ncz = (nz - 1) / 2, ncy = (ny - 1) / 2, ncx = (nx - 1) / 2;
  const int c0z = blockIdx.z * kQ2TZ, c0y = blockIdx.y * kQ2TY,
            c0x = blockIdx.x * kQ2TX;
  // computed cells: the owned ones and the low-side halo, in the lattice
  const int loz = max(c0z - 1, 0), loy = max(c0y - 1, 0), lox = max(c0x - 1, 0);
  const int mz = min(c0z + kQ2TZ, ncz) - loz, my = min(c0y + kQ2TY, ncy) - loy,
            mx = min(c0x + kQ2TX, ncx) - lox;
  const int rows = mz * my * mx, rows_p = (rows + 15) & ~15;
  const int PX = 2 * mx + 1, PY = 2 * my + 1, PZ = 2 * mz + 1;
  const int sy = 3 * PX, sz = sy * PY;

  // [Y: rows_p x 81 f32][f32 path: E 81 x 84 f32, the 84 dof offsets][patch]
  float* Y = reinterpret_cast<float*>(q2_smem);
  float* Es = Y + rows_p * kED;
  int* doff_s = reinterpret_cast<int*>(Es + (kMMA ? 0 : kED * kEPitch));
  T* patch = reinterpret_cast<T*>(doff_s + (kMMA ? 0 : kEPitch));

  // 1. the node patch [PZ][PY][PX][3]: PZ * PY rows of 3 * PX <= 27
  // contiguous elements, one row per warp and one element per lane, 8 rows'
  // loads in flight before any is stored
  {
    static_assert(3 * (2 * (kQ2TX + 1) + 1) <= 32, "a patch row fits a warp");
    constexpr int R = 8, WARPS = kQ2Threads / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rowlen = 3 * PX, rows = PZ * PY;
    const bool lane_ok = lane < rowlen;
    const T* base = u + (static_cast<long long>(2 * loz) * ny + 2 * loy) * nx * 3 +
                    2 * lox * 3 + lane;
    for (int r0 = warp; r0 < rows; r0 += WARPS * R) {
      T v[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + q * WARPS, pz = r / PY, py = r - pz * PY;
        if (r < rows && lane_ok)
          v[q] = base[(static_cast<long long>(pz) * ny + py) * nx * 3];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int r = r0 + q * WARPS;
        if (r < rows && lane_ok) patch[r * rowlen + lane] = v[q];
      }
    }
  }
  if constexpr (!kMMA) {
    for (int k = threadIdx.x; k < kED * kEPitch; k += kQ2Threads) {
      const int n = k / kEPitch, c = k - n * kEPitch;
      Es[k] = c < kED ? E[n * kED + c] : 0.0f;
    }
    for (int k = threadIdx.x; k < kEPitch; k += kQ2Threads)
      doff_s[k] = dof_offset(k, sy, sz);
  }

  auto row_base = [&](int r) {  // patch offset of cell row r's first node
    if (r >= rows) return -1;
    const int cx = r % mx, t = r / mx, cy = t % my, cz = t / my;
    return 2 * cz * sz + 2 * cy * sy + 6 * cx;
  };

  if constexpr (kMMA) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int nj = warp + 8 < kNTiles ? 3 : 2;  // n-tiles warp, warp+4, warp+8
    uint2 bh[3][kKSteps], bl[3][kKSteps];
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) {
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const int j = jj < nj ? warp + 4 * jj : warp;
        bh[jj][s] = __ldg(frag + ((0 * kNTiles + j) * kKSteps + s) * 32 + lane);
        bl[jj][s] = __ldg(frag + ((1 * kNTiles + j) * kKSteps + s) * 32 + lane);
      }
    }
    int doff[kKSteps][4];  // this lane's A columns 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        doff[s][q] = dof_offset(16 * s + 2 * t + (q & 1) + (q >> 1) * 8, sy, sz);
    }
    __syncthreads();  // the patch is in
    // 2. Y = U E^T, the A fragments read straight from the patch (a U tile
    // in shared memory for ldmatrix needs 40 KB more per block: 2 blocks per
    // SM instead of 3, and a slower kernel)
    const uint16_t* pb = reinterpret_cast<const uint16_t*>(patch);
    auto ld = [&](int base, int off) -> uint32_t {
      return (base < 0 || off < 0) ? 0u : static_cast<uint32_t>(pb[base + off]);
    };
    for (int mt = 0; mt < rows_p / 16; ++mt) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      const int b0 = row_base(r0), b1 = row_base(r1);
      float acc[3][4];
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[jj][q] = 0.0f;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const uint32_t a[4] = {
            ld(b0, doff[s][0]) | (ld(b0, doff[s][1]) << 16),
            ld(b1, doff[s][0]) | (ld(b1, doff[s][1]) << 16),
            ld(b0, doff[s][2]) | (ld(b0, doff[s][3]) << 16),
            ld(b1, doff[s][2]) | (ld(b1, doff[s][3]) << 16)};
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          if (jj < nj) {
            mma_bf16(acc[jj], a, bh[jj][s]);
            mma_bf16(acc[jj], a, bl[jj][s]);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const int col = 8 * (warp + 4 * jj) + 2 * t;
        if (jj < nj && col < kED) {
          Y[r0 * kED + col] = acc[jj][0];
          Y[r1 * kED + col] = acc[jj][2];
          if (col + 1 < kED) {
            Y[r0 * kED + col + 1] = acc[jj][1];
            Y[r1 * kED + col + 1] = acc[jj][3];
          }
        }
      }
    }
  } else {
    __syncthreads();  // patch, E and the offsets are in
    for (int r = threadIdx.x; r < rows; r += kQ2Threads) {
      const int b = row_base(r);
      float uc[kEPitch];
#pragma unroll
      for (int k = 0; k < kEPitch; ++k) {
        const int off = doff_s[k];
        uc[k] = off < 0 ? 0.0f : patch[b + off];  // T is float here
      }
      for (int n = 0; n < kED; ++n) {
        const float4* e4 = reinterpret_cast<const float4*>(Es + n * kEPitch);
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < kEPitch / 4; ++q) {
          const float4 e = e4[q];
          acc = fmaf(e.x, uc[4 * q], acc);
          acc = fmaf(e.y, uc[4 * q + 1], acc);
          acc = fmaf(e.z, uc[4 * q + 2], acc);
          acc = fmaf(e.w, uc[4 * q + 3], acc);
        }
        Y[r * kED + n] = acc;
      }
    }
  }
  __syncthreads();  // Y is complete

  // 3. owned nodes: [2 c0, 2 (c0 + T)) per axis, the last block up to n
  const int oz0 = 2 * c0z, oy0 = 2 * c0y, ox0 = 2 * c0x;
  const int wz = (c0z + kQ2TZ >= ncz ? nz : 2 * (c0z + kQ2TZ)) - oz0;
  const int wy = (c0y + kQ2TY >= ncy ? ny : 2 * (c0y + kQ2TY)) - oy0;
  const int wx = (c0x + kQ2TX >= ncx ? nx : 2 * (c0x + kQ2TX)) - ox0;
  for (int i = threadIdx.x; i < wz * wy * wx; i += kQ2Threads) {
    const int gx = ox0 + i % wx, gy = oy0 + (i / wx) % wy,
              gz = oz0 + i / (wx * wy);
    int cz[2], sz_[2], cy[2], sy_[2], cx[2], sx_[2];
    const int kz = axis_cells(gz, loz, ncz, cz, sz_);
    const int ky = axis_cells(gy, loy, ncy, cy, sy_);
    const int kx = axis_cells(gx, lox, ncx, cx, sx_);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {  // fixed trip counts: the lists stay in registers
      if (a >= kz) break;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (b >= ky) break;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (c >= kx) break;
          const float* yr = Y + ((cz[a] * my + cy[b]) * mx + cx[c]) * kED +
                            ((sz_[a] * 3 + sy_[b]) * 3 + sx_[c]) * 3;
          a0 += yr[0];
          a1 += yr[1];
          a2 += yr[2];
        }
      }
    }
    TO* yp = y + ((static_cast<long long>(gz) * ny + gy) * nx + gx) * 3;
    dat::store(yp, a0);
    dat::store(yp + 1, a1);
    dat::store(yp + 2, a2);
  }
}

template <typename T, typename TO, bool kMMA>
cudaError_t launch_q2_tile(const void* u, void* y, const void* frag,
                           const void* E, int nz, int ny, int nx,
                           cudaStream_t s) {
  static unsigned long long attr_set = 0;
  constexpr int kMaxSmem = 200 * 1024;
  const cudaError_t err =
      dat::max_dynamic_smem_once(q2_tile_kernel<T, TO, kMMA>, kMaxSmem, attr_set);
  if (err != cudaSuccess) return err;
  const int ncz = (nz - 1) / 2, ncy = (ny - 1) / 2, ncx = (nx - 1) / 2;
  // the largest block: the owned cells and the low-side halo
  const int mz = ncz > kQ2TZ ? kQ2TZ + 1 : ncz, my = ncy > kQ2TY ? kQ2TY + 1 : ncy,
            mx = ncx > kQ2TX ? kQ2TX + 1 : ncx;
  const size_t rows_p = (mz * my * mx + 15) & ~15;
  const size_t smem =
      rows_p * kED * sizeof(float) +
      (kMMA ? 0 : (kED * kEPitch + kEPitch) * sizeof(float)) +
      static_cast<size_t>(2 * mz + 1) * (2 * my + 1) * (2 * mx + 1) * 3 * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const dim3 grid((ncx + kQ2TX - 1) / kQ2TX, (ncy + kQ2TY - 1) / kQ2TY,
                  (ncz + kQ2TZ - 1) / kQ2TZ);
  q2_tile_kernel<T, TO, kMMA><<<grid, kQ2Threads, smem, s>>>(
      static_cast<const T*>(u), static_cast<TO*>(y),
      static_cast<const uint2*>(frag), static_cast<const float*>(E), nz, ny, nx);
  return cudaGetLastError();
}

}  // namespace

// K5: `frag` is the (2, 11, 6, 32, 4) bf16 array of the split E's mma B
// fragments (ops/q2_structured.py:q2_mma_fragments), read by the bf16-input
// paths; `E` the 81 x 81 f32 element matrix (row = output dof), read by the
// f32 path; `io` a dat::IoMode
extern "C" cudaError_t dat_q2_structured(const void* u, void* y,
                                         const void* frag, const void* E,
                                         int nz, int ny, int nx, int io,
                                         void* stream) {
  if (nz < 3 || ny < 3 || nx < 3 || !(nz & 1) || !(ny & 1) || !(nx & 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (io) {
    case dat::kIoF32:
      return launch_q2_tile<float, float, false>(u, y, frag, E, nz, ny, nx, s);
    case dat::kIoBf16:
      return launch_q2_tile<bf16, bf16, true>(u, y, frag, E, nz, ny, nx, s);
    case dat::kIoBf16InF32Out:
      return launch_q2_tile<bf16, float, true>(u, y, frag, E, nz, ny, nx, s);
  }
  return cudaErrorInvalidValue;
}

// K5's first design (structured_gather.cuh): only chip_smoke.py's kernel
// phase calls it, to time it beside K5
extern "C" cudaError_t dat_q2_structured_gather(const void* u, void* y,
                                                const void* E, int nz, int ny,
                                                int nx, int io_bf16,
                                                void* stream) {
  return dat::launch_structured_gather<3, 2>(u, y, E, nz, ny, nx, io_bf16,
                                             stream);
}
