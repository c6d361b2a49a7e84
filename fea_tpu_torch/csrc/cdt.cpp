// cdt.cpp — constrained-Delaunay-style triangle mesher for plate domains.
//
// The port's own copy of fea_tpu/mesh/cdt/cdt.cpp (the code is the same,
// so the two libraries give the same meshes). Native replacement for the
// reference's gmsh dependency
// (reference datagen/mesh_generator.py:246-317): polygon-with-holes ->
// uniform unstructured triangle mesh at a target edge length.
//
// Strategy (deterministic for fixed inputs):
//   1. Subdivide every boundary edge into ~equal segments of length <= h.
//   2. Scatter a hexagonal interior lattice at spacing h, keeping points
//      with >= 0.6h clearance from all boundary segments and inside the
//      domain (inside exterior, outside holes).
//   3. Incremental Bowyer-Watson Delaunay over all points (boundary points
//      first — node ids 0..P-1 are the polygon corner vertices, mirroring
//      gmsh's geometry-points-first tag contract).
//   4. Drop super-triangle triangles; keep triangles whose centroid lies in
//      the domain.
//   5. Verify every boundary sub-edge is present (conformity); report if not.
//
// Exposed as a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

static inline double orient2d(const P2& a, const P2& b, const P2& c) {
  return (b.x - a.x) * (c.y - a.y) - (b.y - a.y) * (c.x - a.x);
}

// In-circumcircle test for CCW triangle (a,b,c); positive => d inside.
static inline double incircle(const P2& a, const P2& b, const P2& c,
                              const P2& d) {
  double adx = a.x - d.x, ady = a.y - d.y;
  double bdx = b.x - d.x, bdy = b.y - d.y;
  double cdx = c.x - d.x, cdy = c.y - d.y;
  double ad2 = adx * adx + ady * ady;
  double bd2 = bdx * bdx + bdy * bdy;
  double cd2 = cdx * cdx + cdy * cdy;
  return adx * (bdy * cd2 - bd2 * cdy) - ady * (bdx * cd2 - bd2 * cdx) +
         ad2 * (bdx * cdy - bdy * cdx);
}

struct Tri {
  int v[3];   // vertex ids, CCW
  int n[3];   // neighbor across edge opposite v[i]; -1 = hull
  bool alive;
};

class Delaunay {
 public:
  std::vector<P2> pts;
  std::vector<Tri> tris;
  int last_alive = 0;

  void init_super(double minx, double miny, double maxx, double maxy) {
    double cx = 0.5 * (minx + maxx), cy = 0.5 * (miny + maxy);
    double r = std::max(maxx - minx, maxy - miny) * 16.0 + 1.0;
    pts.push_back({cx - 2.0 * r, cy - r});
    pts.push_back({cx + 2.0 * r, cy - r});
    pts.push_back({cx, cy + 2.0 * r});
    tris.push_back({{0, 1, 2}, {-1, -1, -1}, true});
    last_alive = 0;
  }

  // Walk from a known triangle toward p. Returns containing triangle id.
  int locate(const P2& p) const {
    int t = last_alive;
    if (!tris[t].alive) {
      for (int i = (int)tris.size() - 1; i >= 0; --i)
        if (tris[i].alive) {
          t = i;
          break;
        }
    }
    int guard = (int)tris.size() * 4 + 64;
    while (guard-- > 0) {
      const Tri& tr = tris[t];
      bool moved = false;
      for (int e = 0; e < 3; ++e) {
        const P2& a = pts[tr.v[(e + 1) % 3]];
        const P2& b = pts[tr.v[(e + 2) % 3]];
        if (orient2d(a, b, p) < -1e-14) {
          int nt = tr.n[e];
          if (nt < 0) return t;  // outside hull; shouldn't happen with super tri
          t = nt;
          moved = true;
          break;
        }
      }
      if (!moved) return t;
    }
    return t;  // fallback (degenerate walk); cavity search still validates
  }

  // Bowyer-Watson insertion. Returns new vertex id.
  int insert(const P2& p) {
    int vid = (int)pts.size();
    pts.push_back(p);

    int t0 = locate(p);

    // BFS cavity of triangles whose circumcircle contains p.
    std::vector<int> cavity;
    std::vector<char> in_cavity(tris.size(), 0);
    std::vector<int> stack{t0};
    in_cavity[t0] = 1;
    while (!stack.empty()) {
      int t = stack.back();
      stack.pop_back();
      cavity.push_back(t);
      for (int e = 0; e < 3; ++e) {
        int nt = tris[t].n[e];
        if (nt < 0 || in_cavity[nt]) continue;
        const Tri& tr = tris[nt];
        if (incircle(pts[tr.v[0]], pts[tr.v[1]], pts[tr.v[2]], p) > 1e-14) {
          in_cavity[nt] = 1;
          stack.push_back(nt);
        }
      }
    }

    // Boundary edges of the cavity: (a, b, outside-neighbor).
    struct BEdge {
      int a, b, out;
    };
    std::vector<BEdge> bedges;
    for (int t : cavity) {
      for (int e = 0; e < 3; ++e) {
        int nt = tris[t].n[e];
        if (nt >= 0 && in_cavity[nt]) continue;
        bedges.push_back({tris[t].v[(e + 1) % 3], tris[t].v[(e + 2) % 3], nt});
      }
      tris[t].alive = false;
    }

    // Create new triangles (vid, a, b) and wire adjacency.
    std::unordered_map<int64_t, int> edge_owner;  // directed (a<<32|b) -> tri
    std::vector<int> fresh;
    fresh.reserve(bedges.size());
    for (const BEdge& be : bedges) {
      int id = (int)tris.size();
      tris.push_back({{vid, be.a, be.b}, {be.out, -1, -1}, true});
      if (be.out >= 0) {
        Tri& ot = tris[be.out];
        for (int e = 0; e < 3; ++e) {
          if ((ot.v[(e + 1) % 3] == be.b && ot.v[(e + 2) % 3] == be.a)) {
            ot.n[e] = id;
            break;
          }
        }
      }
      edge_owner[((int64_t)be.a << 32) | (uint32_t)be.b] = id;
      fresh.push_back(id);
    }
    // Adjacency between new triangles: the cavity boundary is a closed loop,
    // so tri (vid,a,b) neighbors tri (vid,b,c) across edge (b,vid) and tri
    // (vid,c,a) across edge (vid,a).
    std::unordered_map<int, int> by_first, by_second;  // loop vertex -> tri
    for (const BEdge& be : bedges) {
      int id = edge_owner[((int64_t)be.a << 32) | (uint32_t)be.b];
      by_first[be.a] = id;
      by_second[be.b] = id;
    }
    for (int id : fresh) {
      Tri& tr = tris[id];
      int a = tr.v[1], b = tr.v[2];
      tr.n[1] = by_first[b];   // across edge (b, vid) -> tri (vid, b, c)
      tr.n[2] = by_second[a];  // across edge (vid, a) -> tri (vid, c, a)
    }
    last_alive = fresh.empty() ? last_alive : fresh.back();
    return vid;
  }
};

static bool point_in_ring(const P2& p, const double* ring, int n) {
  bool inside = false;
  for (int i = 0, j = n - 1; i < n; j = i++) {
    double xi = ring[2 * i], yi = ring[2 * i + 1];
    double xj = ring[2 * j], yj = ring[2 * j + 1];
    if (((yi > p.y) != (yj > p.y)) &&
        (p.x < (xj - xi) * (p.y - yi) / (yj - yi) + xi))
      inside = !inside;
  }
  return inside;
}

static double dist_point_seg(const P2& p, const P2& a, const P2& b) {
  double dx = b.x - a.x, dy = b.y - a.y;
  double l2 = dx * dx + dy * dy;
  double t = l2 > 0 ? ((p.x - a.x) * dx + (p.y - a.y) * dy) / l2 : 0.0;
  t = t < 0 ? 0 : (t > 1 ? 1 : t);
  double px = a.x + t * dx - p.x, py = a.y + t * dy - p.y;
  return std::sqrt(px * px + py * py);
}

// Deterministic tiny jitter from point index to break co-circularity.
static inline double jitter(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7feb352dU;
  h ^= h >> 15;
  h *= 0x846ca68bU;
  h ^= h >> 16;
  return ((double)h / 4294967296.0 - 0.5);
}

}  // namespace

extern "C" {

// Returns 0 on success; negative error codes otherwise:
//  -1 capacity exceeded, -2 bad input, -3 boundary edge missing (non-conforming)
int fea_triangulate(const double* exterior, int n_exterior,
                    const double* holes, const int* hole_sizes, int n_holes,
                    double mesh_size,
                    double* out_coords, int max_nodes,
                    int* out_tris, int max_tris,
                    int* out_n_nodes, int* out_n_tris) {
  if (n_exterior < 3 || mesh_size <= 0) return -2;

  // ---- Gather rings -------------------------------------------------------
  std::vector<const double*> rings;
  std::vector<int> ring_sizes;
  rings.push_back(exterior);
  ring_sizes.push_back(n_exterior);
  {
    const double* hp = holes;
    for (int i = 0; i < n_holes; ++i) {
      rings.push_back(hp);
      ring_sizes.push_back(hole_sizes[i]);
      hp += 2 * hole_sizes[i];
    }
  }

  // ---- 1. Corner vertices first (tag contract), then boundary subdivision -
  std::vector<P2> nodes;
  int n_corners = 0;
  for (size_t r = 0; r < rings.size(); ++r) {
    for (int i = 0; i < ring_sizes[r]; ++i)
      nodes.push_back({rings[r][2 * i], rings[r][2 * i + 1]});
    n_corners += ring_sizes[r];
  }

  // boundary sub-edges as (node_id, node_id) for conformity check
  std::vector<std::pair<int, int>> bseg;
  std::vector<int> corner_base(rings.size());
  {
    int base = 0;
    for (size_t r = 0; r < rings.size(); ++r) {
      corner_base[r] = base;
      base += ring_sizes[r];
    }
  }
  for (size_t r = 0; r < rings.size(); ++r) {
    int m = ring_sizes[r];
    for (int i = 0; i < m; ++i) {
      int c0 = corner_base[r] + i;
      int c1 = corner_base[r] + (i + 1) % m;
      P2 a = nodes[c0], b = nodes[c1];
      double len = std::hypot(b.x - a.x, b.y - a.y);
      int nseg = (int)std::ceil(len / mesh_size - 1e-9);
      if (nseg < 1) nseg = 1;
      int prev = c0;
      for (int s = 1; s < nseg; ++s) {
        double t = (double)s / nseg;
        int id = (int)nodes.size();
        nodes.push_back({a.x + t * (b.x - a.x), a.y + t * (b.y - a.y)});
        bseg.push_back({prev, id});
        prev = id;
      }
      bseg.push_back({prev, c1});
    }
  }
  int n_boundary = (int)nodes.size();

  // ---- 2. Hexagonal interior lattice --------------------------------------
  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  for (int i = 0; i < n_exterior; ++i) {
    minx = std::min(minx, exterior[2 * i]);
    maxx = std::max(maxx, exterior[2 * i]);
    miny = std::min(miny, exterior[2 * i + 1]);
    maxy = std::max(maxy, exterior[2 * i + 1]);
  }
  {
    double h = mesh_size;
    double row_h = h * 0.8660254037844386;  // sqrt(3)/2
    double clearance = 0.6 * h;
    int row = 0;
    for (double y = miny + row_h * 0.75; y < maxy; y += row_h, ++row) {
      double x0 = minx + ((row & 1) ? 0.75 * h : 0.25 * h);
      for (double x = x0; x < maxx; x += h) {
        P2 p{x + 1e-4 * h * jitter((uint32_t)nodes.size() * 2654435761U),
             y + 1e-4 * h * jitter((uint32_t)nodes.size() * 2246822519U + 1)};
        if (!point_in_ring(p, exterior, n_exterior)) continue;
        bool in_hole = false;
        for (int hI = 1; hI < (int)rings.size(); ++hI)
          if (point_in_ring(p, rings[hI], ring_sizes[hI])) {
            in_hole = true;
            break;
          }
        if (in_hole) continue;
        // clearance from boundary segments
        bool close = false;
        for (size_t r = 0; r < rings.size() && !close; ++r) {
          int m = ring_sizes[r];
          for (int i = 0; i < m; ++i) {
            P2 a{rings[r][2 * i], rings[r][2 * i + 1]};
            P2 b{rings[r][2 * ((i + 1) % m)], rings[r][2 * ((i + 1) % m) + 1]};
            // quick bbox reject
            if (p.x < std::min(a.x, b.x) - clearance ||
                p.x > std::max(a.x, b.x) + clearance ||
                p.y < std::min(a.y, b.y) - clearance ||
                p.y > std::max(a.y, b.y) + clearance)
              continue;
            if (dist_point_seg(p, a, b) < clearance) {
              close = true;
              break;
            }
          }
        }
        if (close) continue;
        nodes.push_back(p);
      }
    }
  }

  if ((int)nodes.size() > max_nodes) return -1;

  // ---- 3. Delaunay --------------------------------------------------------
  Delaunay dt;
  dt.pts.reserve(nodes.size() + 3);
  dt.tris.reserve(4 * nodes.size());
  dt.init_super(minx, miny, maxx, maxy);
  for (const P2& p : nodes) dt.insert(p);
  // dt vertex id = node id + 3 (super vertices 0..2)

  // ---- 3b. Boundary recovery: conforming-Delaunay midpoint insertion ------
  // A constrained sub-edge absent from the triangulation is split at its
  // midpoint until every piece appears (bounded number of rounds).
  for (int round = 0; round < 24; ++round) {
    std::unordered_set<int64_t> edges;
    edges.reserve(dt.tris.size() * 3);
    for (const Tri& tr : dt.tris) {
      if (!tr.alive) continue;
      for (int e = 0; e < 3; ++e) {
        int a = tr.v[e], b = tr.v[(e + 1) % 3];
        int lo = a < b ? a : b, hi = a < b ? b : a;
        edges.insert(((int64_t)lo << 32) | (uint32_t)hi);
      }
    }
    std::vector<std::pair<int, int>> next_bseg;
    bool all_ok = true;
    for (auto& s : bseg) {
      int a3 = s.first + 3, b3 = s.second + 3;
      int lo = a3 < b3 ? a3 : b3, hi = a3 < b3 ? b3 : a3;
      if (edges.count(((int64_t)lo << 32) | (uint32_t)hi)) {
        next_bseg.push_back(s);
        continue;
      }
      all_ok = false;
      const P2& pa = nodes[s.first];
      const P2& pb = nodes[s.second];
      P2 mid{0.5 * (pa.x + pb.x), 0.5 * (pa.y + pb.y)};
      int id = (int)nodes.size();
      if (id >= max_nodes) return -1;
      nodes.push_back(mid);
      dt.insert(mid);
      next_bseg.push_back({s.first, id});
      next_bseg.push_back({id, s.second});
    }
    bseg.swap(next_bseg);
    if (all_ok) break;
  }

  int n_total = (int)nodes.size();

  // ---- 4. Filter triangles ------------------------------------------------
  std::vector<int> kept;
  for (size_t t = 0; t < dt.tris.size(); ++t) {
    const Tri& tr = dt.tris[t];
    if (!tr.alive) continue;
    if (tr.v[0] < 3 || tr.v[1] < 3 || tr.v[2] < 3) continue;  // super
    P2 c{(dt.pts[tr.v[0]].x + dt.pts[tr.v[1]].x + dt.pts[tr.v[2]].x) / 3.0,
         (dt.pts[tr.v[0]].y + dt.pts[tr.v[1]].y + dt.pts[tr.v[2]].y) / 3.0};
    if (!point_in_ring(c, exterior, n_exterior)) continue;
    bool in_hole = false;
    for (int hI = 1; hI < (int)rings.size(); ++hI)
      if (point_in_ring(c, rings[hI], ring_sizes[hI])) {
        in_hole = true;
        break;
      }
    if (in_hole) continue;
    kept.push_back((int)t);
  }
  if ((int)kept.size() > max_tris) return -1;

  // ---- 5. Conformity check ------------------------------------------------
  std::unordered_set<int64_t> mesh_edges;
  mesh_edges.reserve(kept.size() * 3);
  for (int t : kept) {
    const Tri& tr = dt.tris[t];
    for (int e = 0; e < 3; ++e) {
      int a = tr.v[e] - 3, b = tr.v[(e + 1) % 3] - 3;
      int lo = a < b ? a : b, hi = a < b ? b : a;
      mesh_edges.insert(((int64_t)lo << 32) | (uint32_t)hi);
    }
  }
  for (auto& s : bseg) {
    int lo = s.first < s.second ? s.first : s.second;
    int hi = s.first < s.second ? s.second : s.first;
    if (!mesh_edges.count(((int64_t)lo << 32) | (uint32_t)hi)) return -3;
  }

  // ---- Output -------------------------------------------------------------
  for (int i = 0; i < n_total; ++i) {
    out_coords[2 * i] = nodes[i].x;
    out_coords[2 * i + 1] = nodes[i].y;
  }
  for (size_t k = 0; k < kept.size(); ++k) {
    const Tri& tr = dt.tris[kept[k]];
    // ensure CCW output
    int a = tr.v[0] - 3, b = tr.v[1] - 3, c = tr.v[2] - 3;
    if (orient2d(dt.pts[tr.v[0]], dt.pts[tr.v[1]], dt.pts[tr.v[2]]) < 0) {
      int tmp = b;
      b = c;
      c = tmp;
    }
    out_tris[3 * k] = a;
    out_tris[3 * k + 1] = b;
    out_tris[3 * k + 2] = c;
  }
  *out_n_nodes = n_total;
  *out_n_tris = (int)kept.size();
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Structural hinge detector (articulation-point mechanism check).
//
// Companion to fem.StaticProblem.structurally_singular: ">= 2
// Dirichlet-fixed nodes per stiff component" kills the component-level
// rigid modes but NOT internal hinges — two stiff sub-bodies sharing
// exactly one node (a cut vertex of the stiff edge graph) leave a
// zero-energy rotation of whichever side carries no fixed node. The
// reference's direct solver hits these as LU NaNs (fea_analysis.py:
// 455-461) and resamples; catching them host-side saves a full
// restarts x max_iters lockstep dispatch. Pure Python Tarjan costs
// ~100 ms at production mesh sizes (x ~12 sampled conditions/plate it
// would double the host pipeline), so it lives here: O(V+E), ~1 ms.
//
// Returns 1 if a hinge mechanism exists, 0 if none, -1 on bad input.

extern "C" int fea_hinge_singular(const int32_t* tris, int m, int n,
                                  const uint8_t* fixed_mask) {
  if (m <= 0 || n <= 0) return -1;
  // CSR adjacency from triangle edges (each undirected edge stored once
  // per incident triangle; duplicates are fine for DFS — the parent
  // edge is skipped exactly once so a duplicated parent edge correctly
  // acts as a cycle).
  std::vector<int> deg(n, 0);
  for (int t = 0; t < m; ++t) {
    int a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
    if (a < 0 || a >= n || b < 0 || b >= n || c < 0 || c >= n) return -1;
    deg[a] += 2;
    deg[b] += 2;
    deg[c] += 2;
  }
  std::vector<int64_t> off(n + 1, 0);
  for (int i = 0; i < n; ++i) off[i + 1] = off[i] + deg[i];
  std::vector<int> adj(off[n]);
  std::vector<int64_t> cur(off.begin(), off.end() - 1);
  auto add_edge = [&](int a, int b) {
    adj[cur[a]++] = b;
    adj[cur[b]++] = a;
  };
  for (int t = 0; t < m; ++t) {
    int a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
    add_edge(a, b);
    add_edge(b, c);
    add_edge(c, a);
  }

  std::vector<int> disc(n, -1), low(n, 0), parent(n, -1);
  std::vector<int> fixcnt(n, 0), subsize(n, 0);
  std::vector<char> parent_skipped(n, 0);
  // (v, sub_fixed, sub_size): child subtree separated at vertex v
  struct Split { int v; int sub_fixed; int sub_size; };
  std::vector<Split> splits;
  std::vector<Split> root_splits;  // children of the current DFS root
  std::vector<std::pair<int, int64_t>> stack;
  int timer = 0;

  for (int s = 0; s < n; ++s) {
    if (disc[s] != -1 || deg[s] == 0) continue;
    splits.clear();
    root_splits.clear();
    disc[s] = low[s] = timer++;
    fixcnt[s] = fixed_mask[s] ? 1 : 0;
    subsize[s] = 1;
    stack.clear();
    stack.push_back({s, off[s]});
    while (!stack.empty()) {
      int v = stack.back().first;
      int64_t& it = stack.back().second;
      if (it < off[v + 1]) {
        int u = adj[it++];
        if (disc[u] == -1) {
          parent[u] = v;
          parent_skipped[u] = 0;
          disc[u] = low[u] = timer++;
          fixcnt[u] = fixed_mask[u] ? 1 : 0;
          subsize[u] = 1;
          stack.push_back({u, off[u]});
        } else if (u == parent[v] && !parent_skipped[v]) {
          parent_skipped[v] = 1;  // skip the tree edge ONCE; a second
                                  // copy (shared interior edge) is a
                                  // genuine cycle closing through it
        } else {
          if (disc[u] < low[v]) low[v] = disc[u];
        }
      } else {
        stack.pop_back();
        int p = parent[v];
        if (p != -1) {
          if (low[v] < low[p]) low[p] = low[v];
          if (p == s) {
            root_splits.push_back({p, fixcnt[v], subsize[v]});
          } else if (low[v] >= disc[p]) {
            splits.push_back({p, fixcnt[v], subsize[v]});
          }
          fixcnt[p] += fixcnt[v];
          subsize[p] += subsize[v];
        }
      }
    }
    const int comp_fixed = fixcnt[s];
    const int comp_size = subsize[s];
    // A separated part P (attached to the rest only via v) has a
    // zero-energy rotation about v iff P carries no fixed node; the
    // remainder (everything but P and v) likewise.
    auto hinged = [&](const Split& sp) {
      int rem_fixed = comp_fixed - sp.sub_fixed - (fixed_mask[sp.v] ? 1 : 0);
      int rem_size = comp_size - 1 - sp.sub_size;
      return sp.sub_fixed == 0 || (rem_size > 0 && rem_fixed == 0);
    };
    for (const Split& sp : splits)
      if (hinged(sp)) return 1;
    if ((int)root_splits.size() >= 2)
      for (const Split& sp : root_splits)
        if (hinged(sp)) return 1;
  }
  return 0;
}
