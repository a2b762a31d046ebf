// The Q1 level operator y = A u of every multigrid level, in the folded
// (assembled-stencil) form: K3 on a 3D (nz, ny, nx) nodal lattice
// (27-point), the 2D kernel on a (ny, nx) lattice (9-point); K4 launches
// K3's kernel, and its first design marches along z (below).
//
// Replaces, in dealii_adapter_tpu/:
//   K3: ops/pallas_structured.py:PallasQ1SlabOperator._apply with
//     _make_slab_kernel_3d(nch=3) (pallas_call at :345), the 3D Q1 level
//     operator of the default level backends;
//   K6 in 3D: ops/stencil.py:_vmem_pass (pallas_call at :244) with the
//     inclusion-exclusion boundary corrections StencilQ1Operator.apply
//     adds around it (:389), the level operator of the `stencil*`
//     backends: the same function, so dat_q1_stencil with ndim 3 launches
//     K3's q1_level_kernel (K6 keeps its own entry point and launch count);
//   K4: ops/pallas_structured.py:PallasQ1Operator._apply in 3D
//     (_make_kernel_3d, pallas_call at :445), reached through
//     make_q1_plane_operator: K3's function, so dat_q1_plane launches K3's
//     q1_level_kernel with K3's tables (K4 keeps its own entry point and
//     launch count);
//   K4b: ops/pallas_structured.py:PallasQ1Operator._apply in 2D with
//     _make_kernel_2d (:131, pallas_call at :488), and K6 in 2D (the JAX
//     package's XLA `shift` pass): both launch q1_level_kernel_2d.
//   The TPU kernels' sequential row / z-slab grid with a carried row or
//   plane, and the in-plane axis swap, exist for the TPU's sequential grid
//   and lane width and are not carried over.
//
// The coefficients: the element matrix is folded on the host, in f64, into
//   per-node-class tables (ops/stencil.py:class_tables, laid out by
//   ops/stencil.py:kernel_table): a node's class has one digit per axis (0
//   on the low face, 1 inside, 2 on the high face), and class c's
//   coefficients are the assembled operator's blocks between a class-c node
//   and its 3^ndim neighbours, so the lattice boundary is exact in the same
//   launch and an out-of-lattice neighbour is a zero in shared memory. One
//   float4 a row: in 3D (27 classes, 27 offsets, 3 output components) rows
//   of 3 source components and a zero; in 2D (9 classes, 9 offsets) rows
//   holding the 2 x 2 block (d0e0, d0e1, d1e0, d1e1). An f64 operator's
//   table holds the same rows in f64, four doubles a row (32 bytes).
//
// The f64 instantiation (io mode 3, dat::kIoF64: an f64 multigrid
//   hierarchy, which the JAX package runs outside its Pallas kernels, on
//   XLA): the same tiles, classes and boundary handling with the compute
//   type, the shared-memory node records and the table rows in f64 (Level
//   below), FMA in double. Twice the bytes a node plane and a table class:
//   the 3D f64 form raises its shared-memory cap so that every lattice
//   launches (kLevelMaxSmemF64). Its result agrees with the plain version
//   to f64 roundoff (the sums in another order, the folded coefficients
//   exact in f64).
//
// What bounds them on an H100 (3.35 TB/s, 67 TFLOP/s f32):
//   K3 at the largest 3D level, the (19, 325, 55) FEM-SEM lattice: 339,625
//   nodes x 243 FMA is 0.165 GFLOP, 2.5 us, against u read once and y
//   written once (4.1 MB in bf16, 1.2 us): operations.
//   The 2D kernel at the largest 2D level, the (1729, 289) FEM-SEM lattice:
//   499,681 nodes x 36 FMA is 0.54 us, against 8.0 MB in f32 (2.39 us) and
//   4.0 MB in bf16 (1.19 us): bytes. Its aim is to move each byte once.
//   In f64 (34 TFLOP/s outside the tensor cores, half the f32 rate): K3 at
//   (19, 325, 55) moves 16.3 MB (4.87 us) and does 0.165 GFLOP (4.86 us),
//   both at once; the 2D kernel at (1729, 289) moves 16.0 MB (4.77 us)
//   against 0.036 GFLOP (1.06 us): bytes.
//
// What held the first designs back (kept as entry points that only
//   chip_smoke.py's timing calls: dat_q1_structured_gather and
//   dat_q1_structured_2d_gather, structured_gather.cuh; dat_q1_stencil_
//   pointwise, q1_stencil.cu; dat_q1_plane_marching, K4's, below): the
//   gather form applied each cell's element
//   matrix, 576 FMA a node in 3D (64 in 2D) where the function needs 243
//   (36), gathered 64 (16) neighbour loads, 27 (9) distinct, from global
//   memory with 64-bit `%` and `/` a cell and read E from shared memory
//   once an FMA; the pointwise K6 ran one thread a node with 64-bit `%` and
//   `/`, 3^ndim neighbour loads behind bounds branches and one scalar
//   shared-memory coefficient load an FMA, after staging the whole 26 KB
//   table in every block. All were instruction-issue bound (K3's gather at
//   ~8% of its bound).
//
// What the designs do about it. Both: a block of 128 threads owns a column
//   tile (TX nodes in x, the tile width following nx: 8, 16 or 32, so that
//   2-node axes and narrow coarse levels run) and a chunk of the slowest
//   axis; it reads the chunk's nodes with a one-node halo from device
//   memory up front, consecutive threads on consecutive addresses and all
//   of a thread's loads in flight before the first store to shared memory,
//   together with the coefficient classes its nodes use (at most 2 per
//   axis on a large level, 3 when the tile spans an axis), then passes one
//   __syncthreads. The nodes are kept in f32 (f64) in shared memory. A thread
//   computes up to 4 nodes of its column along the slowest axis, split into
//   runs of one class, so each coefficient row and each neighbour column is
//   read once for all of them. Accumulation in f32 (f64) in a fixed order
//   (offsets, then source components), 32-bit lattice arithmetic inside a
//   block, no atomics: two launches give the same bits. The result agrees
//   with the cell-wise plain version to f32 roundoff (the sums are taken
//   in another order and the folded coefficients are rounded once to f32),
//   not bitwise. The chunk shrinks (8, 4, 2 planes in 3D; 4, 2, 1 rows a
//   thread in 2D) until the grid has about two blocks per SM.
//   K3 (q1_level_kernel): TX x TY (TX * TY = 128) columns of (y, x) nodes,
//   the chunk's z planes (float4 a node: one 16-byte shared-memory load a
//   neighbour, conflict-free), a warp loading whole halo rows with 32
//   loads in flight a lane. Per node: 27 neighbour loads, 81 coefficient
//   loads (warp-wide broadcasts) and 243 FMA. (A first version loaded one
//   plane a step with one load in flight and ran no faster than the
//   gather design: latency-bound.)
//   The 2D kernel (q1_level_kernel_2d) is K3's design carried to the
//   9-point stencil, not K3 with nz = 1: TX columns x TY row groups, each
//   thread owning up to 4 consecutive rows of its column; the tile's TY * 4
//   + 2 halo rows as one float2 a node, read with the flattened
//   (row, node) index over the block's threads (5-6 loads a thread in
//   flight). Per node: 36 FMA from 9 float4 coefficient rows and 3 float2
//   neighbour columns read once for the thread's run. It does not use
//   cp.async: the register path already keeps every load of the tile in
//   flight at once and serves bf16 I/O, which has to be widened to f32
//   before it is stored, with the same code as f32.

//
// K4's first design (dat_q1_plane_marching): the same 3D Q1 operator,
// marching along z one node plane at a time, as the TPU kernel
// (_make_kernel_3d: grid step k consumes node planes k and k+1, i.e. cell
// plane k, writes node plane k and carries the cell plane's contributions
// to node plane k+1 in VMEM scratch). No model path selects K4 (the level
// operators stay on K3, as in the JAX package), so it is measured beside
// K3; at (19, 325, 55) it took 0.0546 ms against K3's 0.0186 (PERF.md),
// applying each cell's element matrix (576 FMA a node where the folded
// stencil needs 243), so K4 now launches K3's kernel.
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

#include "smem_attr.cuh"
#include "structured_gather.cuh"

namespace {

// The level kernels' compute type and its vectors, chosen by the input
// type: f32 (float4 node records and table rows, float2 2D nodes) for the
// f32 and bf16 modes, f64 (32-byte node records and table rows, double2 2D
// nodes) for f64 I/O.
struct alignas(32) Double4 {
  double x, y, z, w;
};
template <typename T>
struct Level {
  using C = float;
  using V4 = float4;
  using V2 = float2;
};
template <>
struct Level<double> {
  using C = double;
  using V4 = Double4;
  using V2 = double2;
};
__device__ __forceinline__ float fma_c(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_c(double a, double b, double c) {
  return fma(a, b, c);
}

// ---------------------------------------------------------------- K3 ----

constexpr int kLevelThreads = 128;
constexpr int kLevelCoefRows = 81;  // V4 rows per class: 27 offsets x 3

__device__ __forceinline__ int node_class(int i, int n) {
  return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

// Node planes z0 - 1 .. z0 + np - 2 of the tile (TY + 2 rows of TX + 2
// nodes with the halo) as a V4 per node (w unused) into `dst`, zeros
// outside the lattice. A warp copies whole halo rows (contiguous in device
// memory); each lane's column offsets are computed once, and 32 loads per
// lane (32 / KJ rows) are in flight before any is stored.
template <int TX, typename T, typename C = typename Level<T>::C>
__device__ __forceinline__ void level_load_planes(C* dst,
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
    C v[R][KJ];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = r0 + q * WARPS, p = r / HY, hy = r - p * HY;
      const int z = z0 - 1 + p, gy = y0 - 1 + hy;
      const bool row_ok = r < rows && z >= 0 && z < nz && gy >= 0 && gy < ny;
      const T* src = u + (static_cast<long long>(row_ok ? z : 0) * ny +
                          (row_ok ? gy : 0)) * nx * 3;
#pragma unroll
      for (int k = 0; k < KJ; ++k)
        v[q][k] = row_ok && ok[k] ? dat::load(src + goff[k]) : C(0);
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
template <int B, int TX, typename T, typename TO,
          typename V4 = typename Level<T>::V4, typename C = typename Level<T>::C>
__device__ __forceinline__ void level_nodes(const V4* __restrict__ tc,
                                            const V4* planes, int p0,
                                            int plast, int col,
                                            TO* __restrict__ y, long long node,
                                            long long plane_nodes, int cnt) {
  constexpr int TY = kLevelThreads / TX, HX = TX + 2, HY = TY + 2;
  constexpr int PLANE = HY * HX;
  C acc[B][3];
#pragma unroll
  for (int q = 0; q < B; ++q) acc[q][0] = acc[q][1] = acc[q][2] = C(0);
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      V4 v[B + 2];  // planes p0 .. p0 + B + 1 (node z - 1 .. z + B)
#pragma unroll
      for (int q = 0; q < B + 2; ++q)
        v[q] = planes[min(p0 + q, plast) * PLANE + col + dy * HX + dx];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const V4* c = tc + ((dz * 3 + dy) * 3 + dx) * 3;
        const V4 c0 = c[0], c1 = c[1], c2 = c[2];
#pragma unroll
        for (int q = 0; q < B; ++q) {
          const V4 w = v[q + dz];
          acc[q][0] = fma_c(c0.x, w.x, acc[q][0]);
          acc[q][0] = fma_c(c0.y, w.y, acc[q][0]);
          acc[q][0] = fma_c(c0.z, w.z, acc[q][0]);
          acc[q][1] = fma_c(c1.x, w.x, acc[q][1]);
          acc[q][1] = fma_c(c1.y, w.y, acc[q][1]);
          acc[q][1] = fma_c(c1.z, w.z, acc[q][1]);
          acc[q][2] = fma_c(c2.x, w.x, acc[q][2]);
          acc[q][2] = fma_c(c2.y, w.y, acc[q][2]);
          acc[q][2] = fma_c(c2.z, w.z, acc[q][2]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < B; ++q) {
    if (q < cnt) {
      TO* yp = y + (node + q * plane_nodes) * 3;
      dat::store(yp, acc[q][0]);
      dat::store(yp + 1, acc[q][1]);
      dat::store(yp + 2, acc[q][2]);
    }
  }
}

template <int TX, typename T, typename TO>
__global__ void __launch_bounds__(kLevelThreads)
    q1_level_kernel(const T* __restrict__ u, TO* __restrict__ y,
                    const typename Level<T>::V4* __restrict__ coef, int nz,
                    int ny, int nx, int zc) {
  using V4 = typename Level<T>::V4;
  constexpr int TY = kLevelThreads / TX, HX = TX + 2, HY = TY + 2;
  constexpr int PLANE = HY * HX;  // V4 per node plane of the tile
  extern __shared__ __align__(32) unsigned char level_smem[];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * zc;
  const int z1 = min(z0 + zc, nz);
  V4* planes = reinterpret_cast<V4*>(level_smem);  // [z1 - z0 + 2][HY][HX]
  // the classes of this block's nodes form a range per axis
  const int cxl = node_class(x0, nx), cxh = node_class(min(x0 + TX, nx) - 1, nx);
  const int cyl = node_class(y0, ny), cyh = node_class(min(y0 + TY, ny) - 1, ny);
  const int czl = node_class(z0, nz), czh = node_class(z1 - 1, nz);
  const int ncx = cxh - cxl + 1, ncy = cyh - cyl + 1;
  // the classes used: the first 128 bytes of rows per thread (8 float4, 4
  // in f64) are loaded before the node planes and stored after them, so
  // both wait on memory together
  V4* tabs = planes + (z1 - z0 + 2) * PLANE;  // [classes used][81]
  const int ntab = ncx * ncy * (czh - czl + 1) * kLevelCoefRows;
  auto tab_src = [&](int k) {
    const int l = k / kLevelCoefRows, r = k - l * kLevelCoefRows;
    const int lx = l % ncx, ly = (l / ncx) % ncy, lz = l / (ncx * ncy);
    return coef[(((czl + lz) * 3 + (cyl + ly)) * 3 + (cxl + lx)) *
                    kLevelCoefRows + r];
  };
  constexpr int CK = 128 / sizeof(V4);
  V4 cv[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int i = k * kLevelThreads + threadIdx.x;
    if (i < ntab) cv[k] = tab_src(i);
  }
  level_load_planes<TX>(reinterpret_cast<typename Level<T>::C*>(planes), u,
                        z0, z1 - z0 + 2, nz, ny, nx, y0, x0);
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
    const V4* tc =
        tabs + (((cz - czl) * ncy + (cy - cyl)) * ncx + (cx - cxl)) * kLevelCoefRows;
    while (z < run_end) {
      const int left = run_end - z, p0 = z - z0;
      const long long node = z * plane_nodes + static_cast<long long>(iy) * nx + ix;
      if (left >= 4) {
        level_nodes<4, TX, T>(tc, planes, p0, plast, col, y, node, plane_nodes, 4);
        z += 4;
      } else if (left >= 2) {
        level_nodes<2, TX, T>(tc, planes, p0, plast, col, y, node, plane_nodes, 2);
        z += 2;
      } else {
        level_nodes<1, TX, T>(tc, planes, p0, plast, col, y, node, plane_nodes, 1);
        z += 1;
      }
    }
  }
}

// classes a block along an axis of n nodes, tiles of t nodes, may use
int level_axis_classes(int n, int t) { return n <= t ? 3 : 2; }

constexpr int kLevelMaxSmem = 96 * 1024;
// f64: twice the bytes a node and a row. The most any lattice needs, the
// widest tile's 10 node planes (6 x 34 nodes) and all 27 classes' tables:
// 135,264 bytes (a block may have 227 KB), so no lattice is refused for
// its shared memory; the largest main-path level, (19, 325, 55), takes 86
// KB (10 planes and 8 classes).
constexpr int kLevelMaxSmemF64 =
    (10 * 6 * 34 + 27 * kLevelCoefRows) * static_cast<int>(sizeof(Double4));

template <int TX, typename T, typename TO>
cudaError_t launch_q1_level_tx(const void* u, void* y, const void* coef,
                               int nz, int ny, int nx, cudaStream_t s) {
  using V4 = typename Level<T>::V4;
  constexpr int TY = kLevelThreads / TX;
  constexpr int max_smem =
      sizeof(V4) == sizeof(float4) ? kLevelMaxSmem : kLevelMaxSmemF64;
  static unsigned long long attr_set = 0;  // > 48 KB only when a tile spans each axis
  const cudaError_t err =
      dat::max_dynamic_smem_once(q1_level_kernel<TX, T, TO>, max_smem, attr_set);
  if (err != cudaSuccess) return err;
  const long long blocks_yx =
      static_cast<long long>((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  int zc = 8;  // shrink the z chunk until the grid has ~2 blocks per SM
  while (zc > 2 && blocks_yx * ((nz + zc - 1) / zc) < 264) zc /= 2;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + zc - 1) / zc);
  const int ncls = level_axis_classes(nx, TX) * level_axis_classes(ny, TY) *
                   level_axis_classes(nz, zc);
  const size_t smem = ((min(zc, nz) + 2) * (TY + 2) * (TX + 2) +
                       ncls * kLevelCoefRows) * sizeof(V4);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  q1_level_kernel<TX, T, TO><<<grid, kLevelThreads, smem, s>>>(
      static_cast<const T*>(u), static_cast<TO*>(y),
      static_cast<const V4*>(coef), nz, ny, nx, zc);
  return cudaGetLastError();
}

template <int TX>
cudaError_t launch_q1_level_io(const void* u, void* y, const void* coef,
                               int nz, int ny, int nx, int io,
                               cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (io) {
    case dat::kIoF32:
      return launch_q1_level_tx<TX, float, float>(u, y, coef, nz, ny, nx, s);
    case dat::kIoBf16:
      return launch_q1_level_tx<TX, bf16, bf16>(u, y, coef, nz, ny, nx, s);
    case dat::kIoBf16InF32Out:
      return launch_q1_level_tx<TX, bf16, float>(u, y, coef, nz, ny, nx, s);
    case dat::kIoF64:
      return launch_q1_level_tx<TX, double, double>(u, y, coef, nz, ny, nx, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_q1_level(const void* u, void* y, const void* coef, int nz,
                            int ny, int nx, int io, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nx <= 8) return launch_q1_level_io<8>(u, y, coef, nz, ny, nx, io, s);
  if (nx <= 16) return launch_q1_level_io<16>(u, y, coef, nz, ny, nx, io, s);
  return launch_q1_level_io<32>(u, y, coef, nz, ny, nx, io, s);
}

// ------------------------------------------------- 2D level operator ----

constexpr int kLevel2dRows = 9;    // V4 rows per class: 9 offsets
constexpr int kLevel2dMaxRun = 4;  // rows a thread computes, at most

// The tile's halo rows y0 - 1 .. y0 + rows - 2 (HX = TX + 2 nodes each,
// zeros outside the lattice) as a V2 per node into `dst`. The flattened
// (row, node) index runs over the block's threads, so consecutive threads
// read consecutive addresses of a row, and every load of a thread is
// issued before its first store.
template <int TX, typename T, typename V2 = typename Level<T>::V2>
__device__ __forceinline__ void level2d_load_rows(V2* dst,
                                                  const T* __restrict__ u,
                                                  int rows, int ny, int nx,
                                                  int y0, int x0) {
  using C = typename Level<T>::C;
  constexpr int TY = kLevelThreads / TX, HX = TX + 2;
  constexpr int K =
      ((TY * kLevel2dMaxRun + 2) * HX + kLevelThreads - 1) / kLevelThreads;
  const int total = rows * HX;
  V2 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * kLevelThreads + threadIdx.x;
    const int r = i / HX, hx = i - r * HX;
    const int gy = y0 - 1 + r, gx = x0 - 1 + hx;
    v[k] = V2{C(0), C(0)};
    if (i < total && gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
      const T* p = u + (gy * nx + gx) * 2;
      v[k] = V2{dat::load(p), dat::load(p + 1)};
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * kLevelThreads + threadIdx.x;
    if (i < total) dst[i] = v[k];
  }
}

// B consecutive nodes (y .. y + B - 1) of one thread's column, all of one
// class, whose first node sits in halo row r0 + 1: each coefficient row and
// each neighbour column (B + 2 halo rows) is read once for the B nodes.
template <int B, int TX, typename T, typename TO,
          typename L = Level<T>>
__device__ __forceinline__ void level2d_nodes(
    const typename L::V4* __restrict__ tc, const typename L::V2* rows, int r0,
    int col, TO* __restrict__ y, int node, int nx) {
  using C = typename L::C;
  constexpr int HX = TX + 2;
  C acc[B][2];
#pragma unroll
  for (int q = 0; q < B; ++q) acc[q][0] = acc[q][1] = C(0);
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    typename L::V2 v[B + 2];  // halo rows r0 .. r0 + B + 1 (nodes y - 1 .. y + B)
#pragma unroll
    for (int q = 0; q < B + 2; ++q) v[q] = rows[(r0 + q) * HX + col + dx];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const typename L::V4 c = tc[dy * 3 + dx];
#pragma unroll
      for (int q = 0; q < B; ++q) {
        const typename L::V2 w = v[q + dy];
        acc[q][0] = fma_c(c.x, w.x, acc[q][0]);
        acc[q][0] = fma_c(c.y, w.y, acc[q][0]);
        acc[q][1] = fma_c(c.z, w.x, acc[q][1]);
        acc[q][1] = fma_c(c.w, w.y, acc[q][1]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < B; ++q) {
    TO* yp = y + (node + q * nx) * 2;
    dat::store(yp, acc[q][0]);
    dat::store(yp + 1, acc[q][1]);
  }
}

template <int TX, typename T, typename TO>
__global__ void __launch_bounds__(kLevelThreads)
    q1_level_kernel_2d(const T* __restrict__ u, TO* __restrict__ y,
                       const typename Level<T>::V4* __restrict__ coef, int ny,
                       int nx, int yc) {
  using V4 = typename Level<T>::V4;
  constexpr int TY = kLevelThreads / TX, HX = TX + 2;
  __shared__ typename Level<T>::V2 rows[(TY * kLevel2dMaxRun + 2) * HX];
  __shared__ V4 tabs[9 * kLevel2dRows];  // [classes used][9 offsets]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * (TY * yc);
  const int y1 = min(y0 + TY * yc, ny);
  // the classes of this block's nodes form a range per axis; one load per
  // thread (at most 81 rows), issued before the node rows and stored after
  const int cxl = node_class(x0, nx), cxh = node_class(min(x0 + TX, nx) - 1, nx);
  const int cyl = node_class(y0, ny), cyh = node_class(y1 - 1, ny);
  const int ncx = cxh - cxl + 1;
  const int ntab = ncx * (cyh - cyl + 1) * kLevel2dRows;
  V4 cv;
  if (static_cast<int>(threadIdx.x) < ntab) {
    const int l = threadIdx.x / kLevel2dRows;
    const int r = threadIdx.x - l * kLevel2dRows;
    const int lx = l % ncx, ly = l / ncx;
    cv = coef[((cyl + ly) * 3 + (cxl + lx)) * kLevel2dRows + r];
  }
  level2d_load_rows<TX>(rows, u, TY * yc + 2, ny, nx, y0, x0);
  if (static_cast<int>(threadIdx.x) < ntab) tabs[threadIdx.x] = cv;
  __syncthreads();

  const int ix = x0 + tx;
  if (ix >= nx) return;
  const int cx = node_class(ix, nx);
  const int ys = y0 + ty * yc, ye = min(ys + yc, ny);
  // runs of rows of one class: {0}, [1, ny - 2], {ny - 1}; each run in
  // batches of 4, 2 and 1 nodes
  for (int iy = ys; iy < ye;) {
    const int cy = node_class(iy, ny);
    const int run_end = cy == 1 ? min(ye, ny - 1) : iy + 1;
    const V4* tc = tabs + ((cy - cyl) * ncx + (cx - cxl)) * kLevel2dRows;
    while (iy < run_end) {
      const int left = run_end - iy, r0 = iy - y0, node = iy * nx + ix;
      if (left >= 4) {
        level2d_nodes<4, TX, T>(tc, rows, r0, tx, y, node, nx);
        iy += 4;
      } else if (left >= 2) {
        level2d_nodes<2, TX, T>(tc, rows, r0, tx, y, node, nx);
        iy += 2;
      } else {
        level2d_nodes<1, TX, T>(tc, rows, r0, tx, y, node, nx);
        iy += 1;
      }
    }
  }
}

template <int TX, typename T, typename TO>
cudaError_t launch_q1_level_2d_tx(const void* u, void* y, const void* coef,
                                  int ny, int nx, cudaStream_t s) {
  constexpr int TY = kLevelThreads / TX;
  const int bx = (nx + TX - 1) / TX;
  int yc = kLevel2dMaxRun;  // shrink the run until the grid has ~2 blocks per SM
  while (yc > 1 && static_cast<long long>(bx) *
                           ((ny + TY * yc - 1) / (TY * yc)) < 264)
    yc /= 2;
  const dim3 grid(bx, (ny + TY * yc - 1) / (TY * yc));
  q1_level_kernel_2d<TX, T, TO><<<grid, kLevelThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<TO*>(y),
      static_cast<const typename Level<T>::V4*>(coef), ny, nx, yc);
  return cudaGetLastError();
}

template <int TX>
cudaError_t launch_q1_level_2d_io(const void* u, void* y, const void* coef,
                                  int ny, int nx, int io, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  switch (io) {
    case dat::kIoF32:
      return launch_q1_level_2d_tx<TX, float, float>(u, y, coef, ny, nx, s);
    case dat::kIoBf16:
      return launch_q1_level_2d_tx<TX, bf16, bf16>(u, y, coef, ny, nx, s);
    case dat::kIoBf16InF32Out:
      return launch_q1_level_2d_tx<TX, bf16, float>(u, y, coef, ny, nx, s);
    case dat::kIoF64:
      return launch_q1_level_2d_tx<TX, double, double>(u, y, coef, ny, nx, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_q1_level_2d(const void* u, void* y, const void* coef,
                               int ny, int nx, int io, void* stream) {
  // 32-bit node indices inside the kernel
  if (ny < 2 || nx < 2 || static_cast<long long>(ny) * nx >= (1LL << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nx <= 8) return launch_q1_level_2d_io<8>(u, y, coef, ny, nx, io, s);
  if (nx <= 16) return launch_q1_level_2d_io<16>(u, y, coef, ny, nx, io, s);
  return launch_q1_level_2d_io<32>(u, y, coef, ny, nx, io, s);
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
      planes[buf][e][hy][hx] = in ? dat::load(p + e) : 0.0f;
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
      for (int d = 0; d < 3; ++d) dat::store(yp + d, carry[d] + low[d]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) carry[d] = high[d];
    __syncthreads();  // the next step overwrites buffer `cur`
  }
  if (active) {
    T* yp = y + ((nz - 1) * plane_nodes + col) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) dat::store(yp + d, carry[d]);
  }
}

cudaError_t launch_q1_plane(const void* u, void* y, const void* E, int nz,
                            int ny, int nx, int io_bf16, void* stream) {
  if (nz < 2 || ny < 2 || nx < 2) return cudaErrorInvalidValue;
  if (io_bf16 != dat::kIoF32 && io_bf16 != dat::kIoBf16)
    return cudaErrorInvalidValue;
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

// K4 (Q1PlaneOperator): K3's function, so K3's q1_level_kernel with K3's
// tables (`coef` as in dat_q1_structured), under K4's own entry point
extern "C" cudaError_t dat_q1_plane(const void* u, void* y, const void* coef,
                                    int nz, int ny, int nx, int io,
                                    void* stream) {
  return launch_q1_level(u, y, coef, nz, ny, nx, io, stream);
}

// K4's first (plane-marching) design, E the 24 x 24 element matrix: only
// chip_smoke.py calls it, to time it beside K4
extern "C" cudaError_t dat_q1_plane_marching(const void* u, void* y,
                                             const void* E, int nz, int ny,
                                             int nx, int io_bf16,
                                             void* stream) {
  return launch_q1_plane(u, y, E, nz, ny, nx, io_bf16, stream);
}

// K3: `coef` is the (27 classes, 27 offsets, 3, 4) table of
// ops/stencil.py:kernel_table (Q1StructuredOperator._coefficients), f64 for
// io mode 3 and f32 otherwise; `io`, here and in K4, K4b and K6, a
// dat::IoMode
extern "C" cudaError_t dat_q1_structured(const void* u, void* y,
                                         const void* coef, int nz, int ny,
                                         int nx, int io, void* stream) {
  return launch_q1_level(u, y, coef, nz, ny, nx, io, stream);
}

// K4b: `coef` is the (9 classes, 9 offsets, 4) table of
// ops/stencil.py:kernel_table (Q1StructuredOperator2D._coefficients), f64
// for io mode 3 and f32 otherwise
extern "C" cudaError_t dat_q1_structured_2d(const void* u, void* y,
                                            const void* coef, int ny, int nx,
                                            int io, void* stream) {
  return launch_q1_level_2d(u, y, coef, ny, nx, io, stream);
}

// K6 (StencilQ1Operator): the same kernels and tables as K3 (ndim 3) and
// K4b (ndim 2, nz 1), under K6's own entry point
extern "C" cudaError_t dat_q1_stencil(const void* u, void* y, const void* coef,
                                      int nz, int ny, int nx, int ndim,
                                      int io, void* stream) {
  if (ndim == 3) return launch_q1_level(u, y, coef, nz, ny, nx, io, stream);
  if (ndim == 2 && nz == 1)
    return launch_q1_level_2d(u, y, coef, ny, nx, io, stream);
  return cudaErrorInvalidValue;
}

// The first (gather) designs of K3 and K4b (structured_gather.cuh, E the
// 24 x 24 or 8 x 8 element matrix): only chip_smoke.py calls them, to time
// them beside K3 and K4b
extern "C" cudaError_t dat_q1_structured_gather(const void* u, void* y,
                                                const void* E, int nz, int ny,
                                                int nx, int io_bf16,
                                                void* stream) {
  return dat::launch_structured_gather<3, 1>(u, y, E, nz, ny, nx, io_bf16,
                                             stream);
}

extern "C" cudaError_t dat_q1_structured_2d_gather(const void* u, void* y,
                                                   const void* E, int ny,
                                                   int nx, int io_bf16,
                                                   void* stream) {
  return dat::launch_structured_gather<2, 1>(u, y, E, 1, ny, nx, io_bf16,
                                             stream);
}
