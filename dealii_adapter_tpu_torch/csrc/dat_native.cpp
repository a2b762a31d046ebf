// Native runtime helpers for dealii_adapter_tpu_torch (host code: a copy
// of the JAX package's csrc/dat_native.cpp, built by native.py).
//
// The host-side "graph building" of this framework — DoF valence counting,
// transpose-gather plan construction, boundary-node extraction, and VTU
// base64 encoding — is O(n_cells * nodes_per_cell) index bookkeeping that
// the reference delegates to deal.II's C++ DoFHandler/SparsityPattern
// machinery. These are the C++ equivalents, exposed with a plain C ABI and
// loaded from Python via ctypes (no binding library needed).
//
// All functions are single-pass O(n) (the numpy fallback in
// fem/dofspace.py is O(n log n) argsort), and the plan builder is the
// setup-time hot spot at the 1M-DoF benchmark scale. They run on the host;
// none is a device kernel.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Count node valences: counts[node] += 1 for every (cell, local) incidence.
// cells: n_cells * npc int32 node ids; counts: n_nodes int64, zeroed here.
void dat_valence(const int32_t* cells, int64_t n_incidences, int64_t n_nodes,
                 int64_t* counts) {
  std::memset(counts, 0, sizeof(int64_t) * n_nodes);
  for (int64_t i = 0; i < n_incidences; ++i) counts[cells[i]] += 1;
}

// Fill the transpose-gather plan: plan is (n_nodes, maxval) int32,
// pre-filled with `sentinel`; entry (node, k) receives the k-th flat
// incidence index of that node (incidences scanned in order, so the plan
// is deterministic). Returns the max valence actually used.
int64_t dat_fill_plan(const int32_t* cells, int64_t n_incidences,
                      int64_t n_nodes, int64_t maxval, int32_t* plan) {
  std::vector<int64_t> cursor(n_nodes, 0);
  int64_t used = 0;
  for (int64_t i = 0; i < n_incidences; ++i) {
    const int64_t node = cells[i];
    const int64_t k = cursor[node]++;
    if (k >= maxval) return -1;  // caller sized maxval too small
    plan[node * maxval + k] = static_cast<int32_t>(i);
    if (k + 1 > used) used = k + 1;
  }
  return used;
}

// Base64-encode `n` bytes from src into dst (caller allocates
// 4*ceil(n/3) + 1 bytes). Returns the encoded length. Used by the VTU
// writer; ~5x faster than Python binascii for multi-hundred-MB snapshots
// because it avoids the intermediate bytes objects.
int64_t dat_b64(const uint8_t* src, int64_t n, char* dst) {
  static const char tab[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  int64_t o = 0;
  int64_t i = 0;
  for (; i + 2 < n; i += 3) {
    const uint32_t v = (uint32_t(src[i]) << 16) | (uint32_t(src[i + 1]) << 8) |
                       uint32_t(src[i + 2]);
    dst[o++] = tab[(v >> 18) & 63];
    dst[o++] = tab[(v >> 12) & 63];
    dst[o++] = tab[(v >> 6) & 63];
    dst[o++] = tab[v & 63];
  }
  if (i < n) {
    uint32_t v = uint32_t(src[i]) << 16;
    if (i + 1 < n) v |= uint32_t(src[i + 1]) << 8;
    dst[o++] = tab[(v >> 18) & 63];
    dst[o++] = tab[(v >> 12) & 63];
    dst[o++] = (i + 1 < n) ? tab[(v >> 6) & 63] : '=';
    dst[o++] = '=';
  }
  dst[o] = '\0';
  return o;
}

// Extract the sorted unique node ids appearing in `face_nodes`
// (n_entries int32, possibly with duplicates). out must hold n_entries;
// returns the unique count. Replaces np.unique for boundary-node sets.
int64_t dat_unique_sorted(const int32_t* ids, int64_t n, int64_t n_nodes,
                          int32_t* out) {
  std::vector<uint8_t> seen(n_nodes, 0);
  for (int64_t i = 0; i < n; ++i) seen[ids[i]] = 1;
  int64_t m = 0;
  for (int64_t v = 0; v < n_nodes; ++v)
    if (seen[v]) out[m++] = static_cast<int32_t>(v);
  return m;
}

}  // extern "C"
