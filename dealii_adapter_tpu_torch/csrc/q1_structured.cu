// K3: the 3D Q1 level operator y = A u on a (nz, ny, nx) nodal lattice, in
// the folded (assembled 27-point) form, and K4b, the same operator on a 2D
// (ny, nx) lattice in the cell-wise gather form of structured_gather.cuh.
//
// Replaces: dealii_adapter_tpu/ops/pallas_structured.py,
//   K3: PallasQ1SlabOperator._apply with _make_slab_kernel_3d(nch=3);
//   K4b: PallasQ1Operator._apply in 2D with _make_kernel_2d (row at a time,
//   the next row's contributions carried in scratch). Each is the operator
//   of every Q1 multigrid level (the FEM-SEM level on the Q2 node lattice
//   and the semi-coarsened levels below it) in its dimension.
//
// What bounds K3 on an H100: at the largest level, the (19, 325, 55)
//   FEM-SEM lattice (339,625 nodes x 3 components, 2 MB in bf16), u read
//   once and y written once is ~4 MB, 1.2 us at 3.35 TB/s; the assembled
//   stencil is 27 neighbours x 9 FMA = 243 FMA per node, 82.5 M FMA, 2.5 us
//   at the card's 67 TFLOP/s f32 rate: operations.
//
// What held the first design back (the gather template, kept as the entry
//   point dat_q1_structured_gather so that the two can be timed side by
//   side): one thread per node applied each of its 8 cells' 24 x 24 element
//   matrix, 576 FMA per node where the function needs 243; it gathered 64
//   3-component neighbours (27 distinct) from global memory with 64-bit
//   index arithmetic and `%`, `/` per cell, after a __syncthreads staging of
//   E; it was instruction-issue bound at ~8% of the bound (0.032 ms).
//
// What the design does about it (q1_level_kernel): the element matrix is
//   folded on the host, in f64, into the per-node-class tables that K6
//   reads (ops/stencil.py:class_tables): a node's class has one digit per
//   axis (0 on the low face, 1 inside, 2 on the high face), and class c's
//   27 x 3 x 3 coefficients are the assembled operator's blocks between a
//   class-c node and its neighbours, so the lattice boundary is exact in
//   the same launch and out-of-lattice neighbours are zeros. A block of 128 threads
//   owns a TX x TY column tile of (y, x) nodes and a chunk of z planes; each
//   thread marches its column along z. The chunk's node planes with a
//   one-node halo are read from device memory up front, consecutive
//   threads on consecutive addresses and 16 loads in flight per thread, so
//   that the block waits on memory a few times and passes one
//   __syncthreads (a first version loaded one plane per step with one load
//   in flight and ran no faster than the gather design: latency-bound);
//   they are kept in f32 in shared memory as float4 per node (one 16-byte
//   load per neighbour, conflict-free). The block stages only the coefficient
//   classes its nodes use (2 x 2 x 2 at most on the largest level, 27 when
//   a tile spans an axis) as float4 rows, read as warp-wide broadcasts.
//   Per node: 27 neighbour loads, 81 coefficient loads and 243 FMA, 32-bit
//   index arithmetic, no atomics, a fixed summation order (offsets dz, dy,
//   dx, then source components): bitwise reproducible from run to run. The
//   result agrees with the cell-wise plain version to f32 roundoff (the
//   sums are taken in another order and the folded coefficients are
//   rounded once to f32), not bitwise. The tile width follows nx (8, 16 or
//   32 nodes) and the z chunk shrinks (8, 4, 2 planes) until the grid has
//   two blocks per SM, so every level shape, 2-node axes included, runs.
//
// K4b keeps the gather form: one thread per node with x fastest, so the
//   gathered neighbours of a warp are contiguous and come from L1; the
//   8 x 8 element matrix is a runtime argument in shared memory. The TPU
//   kernels' sequential row / z-slab grid with a carried row or plane, and
//   the in-plane axis swap, exist for the TPU's sequential grid and lane
//   width and are not carried over.

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

// ---------------------------------------------------------------- K3 ----

constexpr int kLevelThreads = 128;
constexpr int kLevelCoefRows = 81;  // float4 rows per class: 27 offsets x 3

__device__ __forceinline__ int node_class(int i, int n) {
  return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

// Node planes z0 - 1 .. z0 + np - 2 of the tile (TY + 2 rows of TX + 2
// nodes with the halo) as float4 per node (w unused) into `dst`, zeros
// outside the lattice. A warp copies whole halo rows (contiguous in device
// memory); each lane's column offsets are computed once, and 32 loads per
// lane (32 / KJ rows) are in flight before any is stored.
template <int TX, typename T>
__device__ __forceinline__ void level_load_planes(float* dst,
                                                  const T* __restrict__ u,
                                                  int z0, int np, int nz,
                                                  int ny, int nx, int y0,
                                                  int x0) {
  constexpr int TY = kLevelThreads / TX, HX = TX + 2, HY = TY + 2;
  constexpr int ROW = 3 * HX;            // elements of one halo row
  constexpr int KJ = (ROW + 31) / 32;    // elements per lane and row
  constexpr int WARPS = kLevelThreads / 32, R = 32 / KJ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int goff[KJ], soff[KJ];
  bool ok[KJ];
#pragma unroll
  for (int k = 0; k < KJ; ++k) {
    const int j = lane + 32 * k, hx = j / 3, gx = x0 - 1 + hx;
    ok[k] = j < ROW && gx >= 0 && gx < nx;
    goff[k] = (x0 - 1) * 3 + j;
    soff[k] = hx * 4 + (j - 3 * hx);
  }
  const int rows = np * HY;
  for (int r0 = warp; r0 < rows; r0 += WARPS * R) {
    float v[R][KJ];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q * WARPS, p = r / HY, hy = r - p * HY;
      const int z = z0 - 1 + p, gy = y0 - 1 + hy;
      const bool row_ok = r < rows && z >= 0 && z < nz && gy >= 0 && gy < ny;
      const T* src = u + (static_cast<long long>(row_ok ? z : 0) * ny +
                          (row_ok ? gy : 0)) * nx * 3;
#pragma unroll
      for (int k = 0; k < KJ; ++k)
        v[q][k] = row_ok && ok[k] ? dat::load_f32(src + goff[k]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q * WARPS;
      if (r < rows) {
#pragma unroll
        for (int k = 0; k < KJ; ++k)
          if (lane + 32 * k < ROW) dst[r * HX * 4 + soff[k]] = v[q][k];
      }
    }
  }
}

// B consecutive nodes (z .. z + B - 1) of one thread's column, all of one
// class: each coefficient row and each neighbour is read once for the B
// nodes (a z column of B + 2 planes per in-plane offset).
template <int B, int TX, typename T>
__device__ __forceinline__ void level_nodes(const float4* __restrict__ tc,
                                            const float4* planes, int p0,
                                            int plast, int col,
                                            T* __restrict__ y, long long node,
                                            long long plane_nodes, int cnt) {
  constexpr int TY = kLevelThreads / TX, HX = TX + 2, HY = TY + 2;
  constexpr int PLANE = HY * HX;
  float acc[B][3];
#pragma unroll
  for (int q = 0; q < B; ++q) acc[q][0] = acc[q][1] = acc[q][2] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float4 v[B + 2];  // planes p0 .. p0 + B + 1 (node z - 1 .. z + B)
#pragma unroll
      for (int q = 0; q < B + 2; ++q)
        v[q] = planes[min(p0 + q, plast) * PLANE + col + dy * HX + dx];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float4* c = tc + ((dz * 3 + dy) * 3 + dx) * 3;
        const float4 c0 = c[0], c1 = c[1], c2 = c[2];
#pragma unroll
        for (int q = 0; q < B; ++q) {
          const float4 w = v[q + dz];
          acc[q][0] = fmaf(c0.x, w.x, acc[q][0]);
          acc[q][0] = fmaf(c0.y, w.y, acc[q][0]);
          acc[q][0] = fmaf(c0.z, w.z, acc[q][0]);
          acc[q][1] = fmaf(c1.x, w.x, acc[q][1]);
          acc[q][1] = fmaf(c1.y, w.y, acc[q][1]);
          acc[q][1] = fmaf(c1.z, w.z, acc[q][1]);
          acc[q][2] = fmaf(c2.x, w.x, acc[q][2]);
          acc[q][2] = fmaf(c2.y, w.y, acc[q][2]);
          acc[q][2] = fmaf(c2.z, w.z, acc[q][2]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < B; ++q) {
    if (q < cnt) {
      T* yp = y + (node + q * plane_nodes) * 3;
      dat::store_f32(yp, acc[q][0]);
      dat::store_f32(yp + 1, acc[q][1]);
      dat::store_f32(yp + 2, acc[q][2]);
    }
  }
}

template <int TX, typename T>
__global__ void __launch_bounds__(kLevelThreads)
    q1_level_kernel(const T* __restrict__ u, T* __restrict__ y,
                    const float4* __restrict__ coef, int nz, int ny, int nx,
                    int zc) {
  constexpr int TY = kLevelThreads / TX, HX = TX + 2, HY = TY + 2;
  constexpr int PLANE = HY * HX;  // float4 per node plane of the tile
  extern __shared__ float4 level_smem[];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * zc;
  const int z1 = min(z0 + zc, nz);
  float4* planes = level_smem;  // [z1 - z0 + 2][HY][HX]
  // the classes of this block's nodes form a range per axis
  const int cxl = node_class(x0, nx), cxh = node_class(min(x0 + TX, nx) - 1, nx);
  const int cyl = node_class(y0, ny), cyh = node_class(min(y0 + TY, ny) - 1, ny);
  const int czl = node_class(z0, nz), czh = node_class(z1 - 1, nz);
  const int ncx = cxh - cxl + 1, ncy = cyh - cyl + 1;
  // the classes used: the first 8 float4 per thread are loaded before the
  // node planes and stored after them, so both wait on memory together
  float4* tabs = level_smem + (z1 - z0 + 2) * PLANE;  // [classes used][81]
  const int ntab = ncx * ncy * (czh - czl + 1) * kLevelCoefRows;
  auto tab_src = [&](int k) {
    const int l = k / kLevelCoefRows, r = k - l * kLevelCoefRows;
    const int lx = l % ncx, ly = (l / ncx) % ncy, lz = l / (ncx * ncy);
    return coef[(((czl + lz) * 3 + (cyl + ly)) * 3 + (cxl + lx)) *
                    kLevelCoefRows + r];
  };
  constexpr int CK = 8;
  float4 cv[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int i = k * kLevelThreads + threadIdx.x;
    if (i < ntab) cv[k] = tab_src(i);
  }
  level_load_planes<TX>(reinterpret_cast<float*>(planes), u, z0, z1 - z0 + 2,
                        nz, ny, nx, y0, x0);
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int i = k * kLevelThreads + threadIdx.x;
    if (i < ntab) tabs[i] = cv[k];
  }
  for (int i = CK * kLevelThreads + threadIdx.x; i < ntab; i += kLevelThreads)
    tabs[i] = tab_src(i);  // tiles that span an axis: up to 27 classes
  __syncthreads();

  const int ix = x0 + tx, iy = y0 + ty;
  if (ix >= nx || iy >= ny) return;
  const int cx = node_class(ix, nx), cy = node_class(iy, ny);
  const int col = ty * HX + tx, plast = z1 - z0 + 1;
  const long long plane_nodes = static_cast<long long>(ny) * nx;
  // runs of planes of one class: {0}, [1, nz - 2], {nz - 1}; each run in
  // batches of 4, 2 and 1 nodes
  for (int z = z0; z < z1;) {
    const int cz = node_class(z, nz);
    const int run_end = cz == 1 ? min(z1, nz - 1) : z + 1;
    const float4* tc =
        tabs + (((cz - czl) * ncy + (cy - cyl)) * ncx + (cx - cxl)) * kLevelCoefRows;
    while (z < run_end) {
      const int left = run_end - z, p0 = z - z0;
      const long long node = z * plane_nodes + static_cast<long long>(iy) * nx + ix;
      if (left >= 4) {
        level_nodes<4, TX>(tc, planes, p0, plast, col, y, node, plane_nodes, 4);
        z += 4;
      } else if (left >= 2) {
        level_nodes<2, TX>(tc, planes, p0, plast, col, y, node, plane_nodes, 2);
        z += 2;
      } else {
        level_nodes<1, TX>(tc, planes, p0, plast, col, y, node, plane_nodes, 1);
        z += 1;
      }
    }
  }
}

// classes a block along an axis of n nodes, tiles of t nodes, may use
int level_axis_classes(int n, int t) { return n <= t ? 3 : 2; }

constexpr int kLevelMaxSmem = 96 * 1024;

template <int TX>
cudaError_t launch_q1_level_tx(const void* u, void* y, const void* coef,
                               int nz, int ny, int nx, int io_bf16,
                               cudaStream_t s) {
  constexpr int TY = kLevelThreads / TX;
  static bool attr_set = false;  // > 48 KB only when a tile spans each axis
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        q1_level_kernel<TX, float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kLevelMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(q1_level_kernel<TX, __nv_bfloat16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kLevelMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long blocks_yx =
      static_cast<long long>((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  int zc = 8;  // shrink the z chunk until the grid has ~2 blocks per SM
  while (zc > 2 && blocks_yx * ((nz + zc - 1) / zc) < 264) zc /= 2;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + zc - 1) / zc);
  const int ncls = level_axis_classes(nx, TX) * level_axis_classes(ny, TY) *
                   level_axis_classes(nz, zc);
  const size_t smem = ((min(zc, nz) + 2) * (TY + 2) * (TX + 2) +
                       ncls * kLevelCoefRows) * sizeof(float4);
  if (smem > static_cast<size_t>(kLevelMaxSmem)) return cudaErrorInvalidValue;
  const float4* c = static_cast<const float4*>(coef);
  if (io_bf16) {
    q1_level_kernel<TX, __nv_bfloat16><<<grid, kLevelThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(y),
        c, nz, ny, nx, zc);
  } else {
    q1_level_kernel<TX, float><<<grid, kLevelThreads, smem, s>>>(
        static_cast<const float*>(u), static_cast<float*>(y), c, nz, ny, nx,
        zc);
  }
  return cudaGetLastError();
}

cudaError_t launch_q1_level(const void* u, void* y, const void* coef, int nz,
                            int ny, int nx, int io_bf16, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nx <= 8) return launch_q1_level_tx<8>(u, y, coef, nz, ny, nx, io_bf16, s);
  if (nx <= 16) return launch_q1_level_tx<16>(u, y, coef, nz, ny, nx, io_bf16, s);
  return launch_q1_level_tx<32>(u, y, coef, nz, ny, nx, io_bf16, s);
}

// ---------------------------------------------------------------- K4 ----


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

// K3: `coef` is the (27 classes, 27 offsets, 3, 4) f32 table of
// ops/stencil.py:class_tables, each row padded to a float4
// (ops/q1_structured.py:Q1StructuredOperator._coefficients)
extern "C" cudaError_t dat_q1_structured(const void* u, void* y,
                                         const void* coef, int nz, int ny,
                                         int nx, int io_bf16, void* stream) {
  return launch_q1_level(u, y, coef, nz, ny, nx, io_bf16, stream);
}

// K3's first design (structured_gather.cuh, E the 24 x 24 element matrix):
// only chip_smoke.py's kernel phase calls it, to time it beside K3
extern "C" cudaError_t dat_q1_structured_gather(const void* u, void* y,
                                                const void* E, int nz, int ny,
                                                int nx, int io_bf16,
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
