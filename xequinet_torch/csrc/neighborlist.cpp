// Cell-list neighbour search: the host-side core of the port's neighbour
// lists (ops/radius_graph.py, through the ctypes binding of
// ops/native.py).
//
// Copy of xequinet_tpu/native/neighborlist.cpp (same C ABI, same edge
// order).  O(N) cell lists, free and periodic; the device rebuild of the
// free Calculator is ops/radius_graph.radius_graph_fixed.  Edges are
// emitted center-major sorted.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Non-PBC cell-list neighbor search.
// pos: [n,3] doubles; edges_out: [2*max_edges] int64 (center,neighbor pairs
// written as columns edges_out[k], edges_out[max_edges+k]).
// Returns the number of edges found (may exceed max_edges: caller must
// re-allocate and retry; only max_edges are written).
int64_t xeq_radius_graph(const double* pos, int64_t n, double cutoff,
                         int64_t* edges_out, int64_t max_edges) {
  if (n <= 0) return 0;
  const double c2 = cutoff * cutoff;

  // bounding box
  double lo[3], hi[3];
  for (int d = 0; d < 3; ++d) { lo[d] = pos[d]; hi[d] = pos[d]; }
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      double v = pos[3 * i + d];
      if (v < lo[d]) lo[d] = v;
      if (v > hi[d]) hi[d] = v;
    }
  int64_t nb[3];
  double inv_cell = 1.0 / cutoff;
  for (int d = 0; d < 3; ++d) {
    nb[d] = (int64_t)std::floor((hi[d] - lo[d]) * inv_cell) + 1;
    if (nb[d] < 1) nb[d] = 1;
  }
  const int64_t ncells = nb[0] * nb[1] * nb[2];

  // bucket atoms into cells (counting sort for cache-friendly sweep)
  std::vector<int64_t> cell_of(n), count(ncells + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    int64_t cx = (int64_t)((pos[3 * i] - lo[0]) * inv_cell);
    int64_t cy = (int64_t)((pos[3 * i + 1] - lo[1]) * inv_cell);
    int64_t cz = (int64_t)((pos[3 * i + 2] - lo[2]) * inv_cell);
    if (cx >= nb[0]) cx = nb[0] - 1;
    if (cy >= nb[1]) cy = nb[1] - 1;
    if (cz >= nb[2]) cz = nb[2] - 1;
    cell_of[i] = (cx * nb[1] + cy) * nb[2] + cz;
    count[cell_of[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) count[c + 1] += count[c];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[cell_of[i]]++] = i;
  }

  int64_t n_edges = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    int64_t cx = (int64_t)((xi - lo[0]) * inv_cell);
    int64_t cy = (int64_t)((yi - lo[1]) * inv_cell);
    int64_t cz = (int64_t)((zi - lo[2]) * inv_cell);
    if (cx >= nb[0]) cx = nb[0] - 1;
    if (cy >= nb[1]) cy = nb[1] - 1;
    if (cz >= nb[2]) cz = nb[2] - 1;
    for (int64_t dx = -1; dx <= 1; ++dx) {
      int64_t ax = cx + dx;
      if (ax < 0 || ax >= nb[0]) continue;
      for (int64_t dy = -1; dy <= 1; ++dy) {
        int64_t ay = cy + dy;
        if (ay < 0 || ay >= nb[1]) continue;
        for (int64_t dz = -1; dz <= 1; ++dz) {
          int64_t az = cz + dz;
          if (az < 0 || az >= nb[2]) continue;
          const int64_t c = (ax * nb[1] + ay) * nb[2] + az;
          for (int64_t s = count[c]; s < count[c + 1]; ++s) {
            const int64_t j = order[s];
            if (j == i) continue;
            const double ddx = xi - pos[3 * j];
            const double ddy = yi - pos[3 * j + 1];
            const double ddz = zi - pos[3 * j + 2];
            const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < c2) {
              if (n_edges < max_edges) {
                edges_out[n_edges] = i;
                edges_out[max_edges + n_edges] = j;
              }
              ++n_edges;
            }
          }
        }
      }
    }
  }
  return n_edges;
}

// PBC neighbor search: ghost-expansion + cell list, O(N + E).
// cell: [3,3] row-major lattice vectors; replication counts reps[3];
// positions must be wrapped into the cell by the caller
// (ops/radius_graph.radius_graph_pbc_np wraps them and corrects the
// offsets).  Emits center-major sorted edges with integer cell offsets
// [3*max_edges].
int64_t xeq_radius_graph_pbc(const double* pos, int64_t n,
                             const double* cell, const int64_t* reps,
                             double cutoff, int64_t* edges_out,
                             int64_t* offs_out, int64_t max_edges) {
  if (n <= 0) return 0;
  const double c2 = cutoff * cutoff;

  // primary bounding box, expanded by the cutoff: only images that can
  // reach a primary atom are kept
  double lo[3], hi[3];
  for (int d = 0; d < 3; ++d) { lo[d] = pos[d]; hi[d] = pos[d]; }
  for (int64_t i = 1; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      const double v = pos[3 * i + d];
      if (v < lo[d]) lo[d] = v;
      if (v > hi[d]) hi[d] = v;
    }
  double elo[3], ehi[3];
  for (int d = 0; d < 3; ++d) { elo[d] = lo[d] - cutoff; ehi[d] = hi[d] + cutoff; }

  // extended point set: primary atoms (offset 0) + reachable images
  std::vector<double> ex, ey, ez;
  std::vector<int64_t> esrc;          // owning primary atom
  std::vector<int32_t> eox, eoy, eoz; // integer image offset
  ex.reserve(2 * n); ey.reserve(2 * n); ez.reserve(2 * n);
  esrc.reserve(2 * n);
  eox.reserve(2 * n); eoy.reserve(2 * n); eoz.reserve(2 * n);
  for (int64_t i = 0; i < n; ++i) {
    ex.push_back(pos[3 * i]); ey.push_back(pos[3 * i + 1]);
    ez.push_back(pos[3 * i + 2]);
    esrc.push_back(i); eox.push_back(0); eoy.push_back(0); eoz.push_back(0);
  }
  const int64_t rx = reps[0], ry = reps[1], rz = reps[2];
  for (int64_t ox = -rx; ox <= rx; ++ox)
    for (int64_t oy = -ry; oy <= ry; ++oy)
      for (int64_t oz = -rz; oz <= rz; ++oz) {
        if (ox == 0 && oy == 0 && oz == 0) continue;
        const double sx = ox * cell[0] + oy * cell[3] + oz * cell[6];
        const double sy = ox * cell[1] + oy * cell[4] + oz * cell[7];
        const double sz = ox * cell[2] + oy * cell[5] + oz * cell[8];
        for (int64_t j = 0; j < n; ++j) {
          const double px = pos[3 * j] + sx;
          const double py = pos[3 * j + 1] + sy;
          const double pz = pos[3 * j + 2] + sz;
          if (px < elo[0] || px > ehi[0] || py < elo[1] || py > ehi[1] ||
              pz < elo[2] || pz > ehi[2])
            continue;
          ex.push_back(px); ey.push_back(py); ez.push_back(pz);
          esrc.push_back(j);
          eox.push_back((int32_t)ox); eoy.push_back((int32_t)oy);
          eoz.push_back((int32_t)oz);
        }
      }
  const int64_t m = (int64_t)ex.size();

  // cell list over the extended bbox (bin size = cutoff)
  int64_t nb[3];
  const double inv_cell = 1.0 / cutoff;
  for (int d = 0; d < 3; ++d) {
    nb[d] = (int64_t)std::floor((ehi[d] - elo[d]) * inv_cell) + 1;
    if (nb[d] < 1) nb[d] = 1;
  }
  const int64_t ncells = nb[0] * nb[1] * nb[2];
  auto bin_of = [&](double x, double y, double z) {
    int64_t cx = (int64_t)((x - elo[0]) * inv_cell);
    int64_t cy = (int64_t)((y - elo[1]) * inv_cell);
    int64_t cz = (int64_t)((z - elo[2]) * inv_cell);
    if (cx >= nb[0]) cx = nb[0] - 1; if (cx < 0) cx = 0;
    if (cy >= nb[1]) cy = nb[1] - 1; if (cy < 0) cy = 0;
    if (cz >= nb[2]) cz = nb[2] - 1; if (cz < 0) cz = 0;
    return (cx * nb[1] + cy) * nb[2] + cz;
  };
  std::vector<int64_t> cell_of(m), count(ncells + 1, 0);
  for (int64_t k = 0; k < m; ++k) {
    cell_of[k] = bin_of(ex[k], ey[k], ez[k]);
    count[cell_of[k] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) count[c + 1] += count[c];
  std::vector<int64_t> order(m);
  {
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t k = 0; k < m; ++k) order[cursor[cell_of[k]]++] = k;
  }

  int64_t n_edges = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
    int64_t cx = (int64_t)((xi - elo[0]) * inv_cell);
    int64_t cy = (int64_t)((yi - elo[1]) * inv_cell);
    int64_t cz = (int64_t)((zi - elo[2]) * inv_cell);
    for (int64_t dx = -1; dx <= 1; ++dx) {
      const int64_t ax = cx + dx;
      if (ax < 0 || ax >= nb[0]) continue;
      for (int64_t dy = -1; dy <= 1; ++dy) {
        const int64_t ay = cy + dy;
        if (ay < 0 || ay >= nb[1]) continue;
        for (int64_t dz = -1; dz <= 1; ++dz) {
          const int64_t az = cz + dz;
          if (az < 0 || az >= nb[2]) continue;
          const int64_t c = (ax * nb[1] + ay) * nb[2] + az;
          for (int64_t s = count[c]; s < count[c + 1]; ++s) {
            const int64_t k = order[s];
            if (k == i) continue;  // primary self (offset 0)
            const double ddx = xi - ex[k];
            const double ddy = yi - ey[k];
            const double ddz = zi - ez[k];
            const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < c2) {
              if (n_edges < max_edges) {
                edges_out[n_edges] = i;
                edges_out[max_edges + n_edges] = esrc[k];
                offs_out[3 * n_edges] = eox[k];
                offs_out[3 * n_edges + 1] = eoy[k];
                offs_out[3 * n_edges + 2] = eoz[k];
              }
              ++n_edges;
            }
          }
        }
      }
    }
  }
  return n_edges;
}

}  // extern "C"
