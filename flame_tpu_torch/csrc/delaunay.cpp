// The port's copy of flame_tpu/native/delaunay.cpp, built by
// flame_tpu_torch/mesh/delaunay.py. Its output (the triangles, their
// order, the neighbours and the edges) is held bit for bit to the JAX
// package's core: keep the insertion order, the jitter, the predicates,
// the cavity search, the fan linking and the compaction the same as there.
// Point location differs (below), and so does the bookkeeping of an
// insertion, which allocates nothing.
//
// Host-side 2D Delaunay triangulation for flame_tpu.
//
// A from-scratch incremental Bowyer-Watson triangulator replacing the
// reference's vendored Shewchuk Triangle
// (the reference's src/flame/external/triangle/triangle.cpp, invoked with
// switches "zneQB" at src/flame/utils/delaunay.cc:67).
// Output contract matches the reference wrapper: 0-indexed triangles,
// unique undirected edges, and per-triangle neighbor ids (-1 on the hull).
// Triangle winding is positive signed area in (x right, y down) image
// coordinates (visually clockwise), matching the reference's convention
// (flame.cc:2221 "Triangle spits out points in clock-wise order").
//
// Robustness: all predicates evaluate in double with a static error filter
// escalating to long double; exact ties (cocircular pixel grids are common)
// are broken by a deterministic index-based symbolic jitter, giving a valid
// triangulation for any input without exact arithmetic. The three bounding
// "super" vertices are handled SYMBOLICALLY as points at infinity in fixed
// directions (predicates use the R->infinity limit of orient/incircle), so
// arbitrarily thin hull slivers are kept — a finite super-triangle at any
// distance silently eats them.
//
// Insertion order is a deterministic shuffle for expected O(n log n).
// Point location jumps, then walks: a coarse grid over the points' bounding
// box keeps the last vertex inserted in each cell, and the walk starts from
// a live triangle of the nearest such vertex to the point (the JAX package's
// core walks from the last-inserted triangle, O(sqrt n) steps a point in a
// shuffled order). Where the point lies strictly inside one triangle the
// walk's end does not depend on its start; where it lies on an edge (an
// orientation exactly 0) two triangles qualify, and the walk is made again
// from the last-inserted triangle so that the JAX package's choice stands.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Tri {
  int v[3];   // vertex indices (into the working point array)
  int n[3];   // neighbor triangle ids; n[i] is across the edge opposite v[i]
  bool alive;
};

struct Ctx {
  std::vector<double> px, py;
  std::vector<Tri> tris;
  int n_real = 0;  // vertices >= n_real are symbolic points at infinity
  int last_alive = -1;
};

// Directions of the three symbolic super-vertices (at infinity). Chosen so
// (s0, s1, s2) has positive orientation under the limit predicates.
constexpr double kSuperDir[3][2] = {
    {0.0, 1.0},
    {-0.8660254037844386, -0.5},
    {0.8660254037844386, -0.5},
};

inline bool is_super(const Ctx& c, int v) { return v >= c.n_real; }

inline long double cross_ld(long double ax, long double ay, long double bx,
                            long double by) {
  return ax * by - ay * bx;
}

// Generalized orient2d(a, b, c): sign of cross(b - a, c - a), with super
// vertices treated as points at infinity (R -> inf limit, lower-order term
// as tie-break). Positive = canonical winding (visual CW in y-down coords).
double orient2d(const Ctx& c, int a, int b, int p) {
  const bool sa = is_super(c, a), sb = is_super(c, b), sp = is_super(c, p);
  const int n_super = (sa ? 1 : 0) + (sb ? 1 : 0) + (sp ? 1 : 0);
  // Cyclic (parity-preserving) rotations so super vertices come last.
  if (n_super == 1) {
    if (sa) { int t = a; a = b; b = p; p = t; }        // (b, p, a)
    else if (sb) { int t = p; p = b; b = a; a = t; }   // (p, a, b)
  } else if (n_super == 2) {
    if (!sb) { int t = a; a = b; b = p; p = t; }       // real b -> first
    else if (!sp) { int t = p; p = b; b = a; a = t; }  // real p -> first
  }

  if (n_super == 0) {
    double ax = c.px[a], ay = c.py[a];
    double bx = c.px[b], by = c.py[b];
    double cx = c.px[p], cy = c.py[p];
    double detleft = (bx - ax) * (cy - ay);
    double detright = (by - ay) * (cx - ax);
    double det = detleft - detright;
    double detsum = std::fabs(detleft) + std::fabs(detright);
    if (std::fabs(det) > 1e-12 * detsum) return det;
    long double d = (static_cast<long double>(bx) - ax) *
                        (static_cast<long double>(cy) - ay) -
                    (static_cast<long double>(by) - ay) *
                        (static_cast<long double>(cx) - ax);
    return static_cast<double>(d);
  }

  if (n_super == 1) {
    // p = R*d: cross(b - a, R*d - a) = R*cross(b - a, d) + cross(a, b).
    const double* d = kSuperDir[p - c.n_real];
    long double bax = (long double)c.px[b] - c.px[a];
    long double bay = (long double)c.py[b] - c.py[a];
    long double lead = cross_ld(bax, bay, d[0], d[1]);
    if (lead != 0) return static_cast<double>(lead);
    return static_cast<double>(
        cross_ld(c.px[a], c.py[a], c.px[b], c.py[b]));
  }

  if (n_super == 2) {
    // b = R*d1, p = R*d2: leading term R^2 * cross(d1, d2).
    const double* d1 = kSuperDir[b - c.n_real];
    const double* d2 = kSuperDir[p - c.n_real];
    long double lead = cross_ld(d1[0], d1[1], d2[0], d2[1]);
    if (lead != 0) return static_cast<double>(lead);
    long double ax = c.px[a], ay = c.py[a];
    return static_cast<double>(cross_ld(ax, ay, d1[0] - d2[0],
                                        d1[1] - d2[1]));
  }

  // All three super: orientation of the direction triangle.
  {
    const double* d0 = kSuperDir[a - c.n_real];
    const double* d1 = kSuperDir[b - c.n_real];
    const double* d2 = kSuperDir[p - c.n_real];
    return static_cast<double>(
        cross_ld(d1[0] - d0[0], d1[1] - d0[1], d2[0] - d0[0], d2[1] - d0[1]));
  }
}

// Generalized incircle: > 0 iff real point p is strictly inside the
// (generalized) circumcircle of positively-oriented triangle (a, b, d).
// Super vertices give half-plane limits; query p is always real.
double incircle(const Ctx& c, int a, int b, int d, int p) {
  const bool sa = is_super(c, a), sb = is_super(c, b), sd = is_super(c, d);
  const int n_super = (sa ? 1 : 0) + (sb ? 1 : 0) + (sd ? 1 : 0);
  // Cyclic (parity-preserving) rotations so super vertices come last; even
  // permutations preserve the incircle sign of an oriented triangle.
  if (n_super == 1) {
    if (sa) { int t = a; a = b; b = d; d = t; }        // (b, d, a)
    else if (sb) { int t = d; d = b; b = a; a = t; }   // (d, a, b)
  } else if (n_super == 2) {
    if (!sb) { int t = a; a = b; b = d; d = t; }       // real b -> first
    else if (!sd) { int t = d; d = b; b = a; a = t; }  // real d -> first
  }

  long double pxl = c.px[p], pyl = c.py[p];

  if (n_super == 0) {
    long double adx = c.px[a] - pxl, ady = c.py[a] - pyl;
    long double bdx = c.px[b] - pxl, bdy = c.py[b] - pyl;
    long double cdx = c.px[d] - pxl, cdy = c.py[d] - pyl;
    long double ad = adx * adx + ady * ady;
    long double bd = bdx * bdx + bdy * bdy;
    long double cd = cdx * cdx + cdy * cdy;
    long double det = adx * (bdy * cd - bd * cdy) -
                      ady * (bdx * cd - bd * cdx) +
                      ad * (bdx * cdy - bdy * cdx);
    return static_cast<double>(det);
  }

  if (n_super == 1) {
    // Triangle (a, b, s): circumcircle -> half-plane left of (a, b).
    // Leading term R^2 * cross(a - p, b - p); tie-break with the R^1 term
    // det[(a-p, |a-p|^2), (b-p, |b-p|^2), (dir, -2 dir.p)].
    const double* dir = kSuperDir[d - c.n_real];
    long double adx = c.px[a] - pxl, ady = c.py[a] - pyl;
    long double bdx = c.px[b] - pxl, bdy = c.py[b] - pyl;
    long double lead = cross_ld(adx, ady, bdx, bdy);
    if (lead != 0) return static_cast<double>(lead);
    long double A = adx * adx + ady * ady;
    long double B = bdx * bdx + bdy * bdy;
    long double m = -2.0L * (dir[0] * pxl + dir[1] * pyl);
    long double det = adx * (bdy * m - B * dir[1]) -
                      ady * (bdx * m - B * dir[0]) +
                      A * (bdx * dir[1] - bdy * dir[0]);
    return static_cast<double>(det);
  }

  if (n_super == 2) {
    // Triangle (a, s1, s2): leading term R^3 * cross(a - p, d1 - d2);
    // tie-break R^2 * |a - p|^2 * cross(d1, d2).
    const double* d1 = kSuperDir[b - c.n_real];
    const double* d2 = kSuperDir[d - c.n_real];
    long double adx = c.px[a] - pxl, ady = c.py[a] - pyl;
    long double lead = cross_ld(adx, ady, d1[0] - d2[0], d1[1] - d2[1]);
    if (lead != 0) return static_cast<double>(lead);
    long double A = adx * adx + ady * ady;
    return static_cast<double>(A * cross_ld(d1[0], d1[1], d2[0], d2[1]));
  }

  // All-super triangle contains everything.
  return 1.0;
}

// Locate a triangle containing point p by walking. Returns triangle id.
// Adds the triangles visited to *steps; *on_edge says whether p lies on an
// edge of the returned triangle (an orientation exactly 0).
int locate(const Ctx& c, int start, int p, int max_steps, int64_t* steps,
           bool* on_edge) {
  int t = start;
  for (int step = 0; step < max_steps; ++step) {
    ++*steps;
    const Tri& tri = c.tris[t];
    bool moved = false, zero = false;
    for (int e = 0; e < 3; ++e) {
      int a = tri.v[(e + 1) % 3];
      int b = tri.v[(e + 2) % 3];
      double o = orient2d(c, a, b, p);
      if (o < 0) {
        int nb = tri.n[e];
        if (nb < 0) return -1;  // walked off the hull: with a
                                // super-triangle this means the
                                // predicates are inconsistent — fail
                                // loudly (caller falls back) rather
                                // than dig a cavity around a triangle
                                // that does not contain p
        t = nb;
        moved = true;
        break;
      }
      if (o == 0) zero = true;
    }
    if (!moved) {  // containment verified (all orients >= 0)
      *on_edge = zero;
      return t;
    }
  }
  return -1;  // walk did not terminate: signal failure, never hand the
              // caller an arbitrary triangle to corrupt the cavity with
}

// The jump of point location: a grid of g x g cells over the points'
// bounding box, each holding the last vertex inserted in it (-1: none).
struct Grid {
  int g = 1;
  double x0 = 0, y0 = 0, fx = 0, fy = 0;  // origin; cells per unit
  std::vector<int> last;
  int filled = 0;

  Grid(int n, double minx, double miny, double maxx, double maxy) {
    g = std::min(128, std::max(1, static_cast<int>(std::lround(
                                      0.5 * std::sqrt(static_cast<double>(n))))));
    x0 = minx;
    y0 = miny;
    fx = maxx > minx ? g / (maxx - minx) : 0.0;
    fy = maxy > miny ? g / (maxy - miny) : 0.0;
    last.assign(static_cast<size_t>(g) * g, -1);
  }
  int cell(double v, double v0, double f) const {
    double i = (v - v0) * f;  // clamped before the cast: NaN goes to 0
    if (!(i >= 0)) return 0;
    return i >= g ? g - 1 : static_cast<int>(i);
  }
  void insert(const Ctx& c, int v) {
    int& slot = last[cell(c.py[v], y0, fy) * g + cell(c.px[v], x0, fx)];
    filled += slot < 0;
    slot = v;
  }
  // The vertex recorded nearest to p in p's cell or, failing that, in the
  // nearest ring of cells around it that holds one; -1 while none is.
  int nearest(const Ctx& c, int p) const {
    if (filled == 0) return -1;
    const int cx = cell(c.px[p], x0, fx), cy = cell(c.py[p], y0, fy);
    for (int r = 0; r < g; ++r) {
      int best = -1;
      double best_d = 0;
      auto visit = [&](int x, int y) {
        if (x < 0 || y < 0 || x >= g || y >= g) return;
        int v = last[y * g + x];
        if (v < 0) return;
        double dx = c.px[v] - c.px[p], dy = c.py[v] - c.py[p];
        double d = dx * dx + dy * dy;
        if (best < 0 || d < best_d) { best = v; best_d = d; }
      };
      if (r == 0) {
        visit(cx, cy);
      } else {
        for (int x = cx - r; x <= cx + r; ++x) {
          visit(x, cy - r);
          visit(x, cy + r);
        }
        for (int y = cy - r + 1; y <= cy + r - 1; ++y) {
          visit(cx - r, y);
          visit(cx + r, y);
        }
      }
      if (best >= 0) return best;
    }
    return -1;
  }
};

// Deterministic pseudo-random permutation (xorshift), reproducible builds.
uint64_t xs64(uint64_t& s) {
  s ^= s << 13;
  s ^= s >> 7;
  s ^= s << 17;
  return s;
}

}  // namespace

extern "C" {

// Returns 0 on success. Outputs are 0-indexed into the input point array.
//   tri_out:   capacity >= 3 * (2*n + 8)
//   neigh_out: capacity >= 3 * (2*n + 8), -1 where no neighbor
//   edge_out:  capacity >= 2 * (3*n + 8)
//   walk_steps: if not null, receives the triangles the point-location
//               walks visited over all insertions
int delaunay_triangulate_ex(const float* pts, int n,
                            int* tri_out, int* n_tri_out,
                            int* edge_out, int* n_edge_out,
                            int* neigh_out, int64_t* walk_steps) {
  *n_tri_out = 0;
  *n_edge_out = 0;
  if (walk_steps) *walk_steps = 0;
  if (n < 3) return 1;

  Ctx c;
  c.px.resize(n + 3);
  c.py.resize(n + 3);

  double minx = 1e300, miny = 1e300, maxx = -1e300, maxy = -1e300;
  for (int i = 0; i < n; ++i) {
    double x = pts[2 * i], y = pts[2 * i + 1];
    minx = std::min(minx, x);
    miny = std::min(miny, y);
    maxx = std::max(maxx, x);
    maxy = std::max(maxy, y);
  }
  double span = std::max(maxx - minx, maxy - miny);
  if (span <= 0) span = 1.0;

  // Symbolic jitter: breaks exact collinearity/cocircularity (pixel grids)
  // deterministically; magnitude ~1e-9 of the bbox is geometrically inert.
  for (int i = 0; i < n; ++i) {
    uint64_t h = 0x9e3779b97f4a7c15ull * (static_cast<uint64_t>(i) + 1);
    h ^= h >> 29;
    h *= 0xbf58476d1ce4e5b9ull;
    h ^= h >> 32;
    double j1 = ((h & 0xffffffu) / double(0xffffffu) - 0.5);
    double j2 = (((h >> 24) & 0xffffffu) / double(0xffffffu) - 0.5);
    c.px[i] = pts[2 * i] + j1 * span * 1e-9;
    c.py[i] = pts[2 * i + 1] + j2 * span * 1e-9;
  }

  // Symbolic super-triangle: vertices n, n+1, n+2 are points at infinity in
  // the kSuperDir directions (positions below are placeholders, never read
  // by the predicates). kSuperDir is chosen positively oriented and its
  // half-plane orients contain every finite point.
  c.n_real = n;
  int s0 = n, s1 = n + 1, s2 = n + 2;
  c.px[s0] = c.py[s0] = 0.0;
  c.px[s1] = c.py[s1] = 0.0;
  c.px[s2] = c.py[s2] = 0.0;

  // About 6 triangles are made per insertion of a shuffled order.
  c.tris.reserve(7 * static_cast<size_t>(n) + 16);
  c.tris.push_back({{s0, s1, s2}, {-1, -1, -1}, true});
  c.last_alive = 0;

  // Deterministic shuffled insertion order.
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  uint64_t seed = 0x853c49e6748fea9bull ^ (uint64_t)n;
  for (int i = n - 1; i > 0; --i) {
    int j = static_cast<int>(xs64(seed) % static_cast<uint64_t>(i + 1));
    std::swap(order[i], order[j]);
  }

  std::vector<int> cavity;        // triangle ids forming the cavity
  std::vector<char> in_cavity;    // per-triangle flag
  std::vector<int> stack;
  // Boundary edges of the cavity: (va, vb, outer neighbor id).
  struct BEdge { int a, b, outer; };
  std::vector<BEdge> boundary, bfinal;
  // The fan's triangle by its boundary edge's start / end vertex (-1:
  // none), reset entry by entry after each insertion.
  std::vector<int> by_a(n + 3, -1), by_b(n + 3, -1);
  // A live triangle incident to each vertex (-1: not inserted yet).
  std::vector<int> vtri(n + 3, -1);
  Grid grid(n, minx, miny, maxx, maxy);
  int64_t steps = 0;

  in_cavity.resize(c.tris.capacity() + 16, 0);

  for (int oi = 0; oi < n; ++oi) {
    int p = order[oi];
    const int max_steps = 4 * (int)c.tris.size() + 64;
    int t0 = -1;
    bool on_edge = false;
    int v = grid.nearest(c, p);
    if (v >= 0 && vtri[v] >= 0 && c.tris[vtri[v]].alive)
      t0 = locate(c, vtri[v], p, max_steps, &steps, &on_edge);
    if (t0 < 0 || on_edge)  // no jump, a failed walk, or a tie
      t0 = locate(c, c.last_alive, p, max_steps, &steps, &on_edge);
    if (t0 < 0) return 2;  // point location failed (inconsistent
                           // predicates / non-terminating walk): report
                           // instead of corrupting the triangulation

    // Grow cavity: BFS over neighbors whose circumcircle contains p.
    cavity.clear();
    boundary.clear();
    stack.clear();
    if (in_cavity.size() < c.tris.size()) in_cavity.resize(c.tris.size() * 2, 0);
    stack.push_back(t0);
    in_cavity[t0] = 1;
    while (!stack.empty()) {
      int t = stack.back();
      stack.pop_back();
      cavity.push_back(t);
      const Tri tri = c.tris[t];
      for (int e = 0; e < 3; ++e) {
        int nb = tri.n[e];
        int a = tri.v[(e + 1) % 3];
        int b = tri.v[(e + 2) % 3];
        if (nb >= 0 && !in_cavity[nb]) {
          const Tri& nt = c.tris[nb];
          if (incircle(c, nt.v[0], nt.v[1], nt.v[2], p) > 0) {
            in_cavity[nb] = 1;
            stack.push_back(nb);
            continue;
          }
        }
        if (nb < 0 || !in_cavity[nb]) {
          boundary.push_back({a, b, nb});
        }
      }
    }
    // NOTE: boundary edges collected above may include edges whose outer
    // neighbor later joined the cavity (stack order). Filter them now.
    bfinal.clear();
    for (const BEdge& be : boundary) {
      if (be.outer < 0 || !in_cavity[be.outer]) bfinal.push_back(be);
    }

    // Remove cavity triangles.
    for (int t : cavity) {
      c.tris[t].alive = false;
      in_cavity[t] = 0;
    }

    // Create new triangles (p, a, b) for each boundary edge; a->b keeps the
    // cavity's outward orientation so (p, a, b) is positively oriented.
    int first_new = static_cast<int>(c.tris.size());
    int m = static_cast<int>(bfinal.size());
    for (int k = 0; k < m; ++k) {
      const BEdge& be = bfinal[k];
      Tri nt;
      nt.v[0] = p; nt.v[1] = be.a; nt.v[2] = be.b;
      nt.n[0] = be.outer;  // across edge (a, b), opposite p
      nt.n[1] = -1;        // set below
      nt.n[2] = -1;
      nt.alive = true;
      c.tris.push_back(nt);
      vtri[p] = vtri[be.a] = vtri[be.b] = first_new + k;
      if (in_cavity.size() < c.tris.size())
        in_cavity.resize(c.tris.size() * 2, 0);
      // Fix outer neighbor's back-pointer: the slot of ot opposite the
      // vertex not on edge (a, b). An outer triangle can border the cavity
      // on two edges, so match the edge explicitly.
      if (be.outer >= 0) {
        Tri& ot = c.tris[be.outer];
        for (int e = 0; e < 3; ++e) {
          int oa = ot.v[(e + 1) % 3];
          int ob = ot.v[(e + 2) % 3];
          if ((oa == be.a && ob == be.b) || (oa == be.b && ob == be.a)) {
            ot.n[e] = first_new + k;
            break;
          }
        }
      }
    }
    // Link the new fan triangles to each other: triangle k has edges
    // (p, a) and (p, b); neighbor across (p, b) is the triangle whose a ==
    // this b, etc. Vertex-indexed tables from boundary START / END vertex
    // -> triangle make this O(m); a later edge overwrites an earlier one.
    for (int k = 0; k < m; ++k) {
      by_a[bfinal[k].a] = k;
      by_b[bfinal[k].b] = k;
    }
    for (int k = 0; k < m; ++k) {
      const BEdge& bk = bfinal[k];
      int ka = by_a[bk.b];  // triangle sharing edge (p, bk.b)
      if (ka >= 0 && ka != k) c.tris[first_new + k].n[1] = first_new + ka;
      int kb = by_b[bk.a];  // triangle sharing edge (p, bk.a)
      if (kb >= 0 && kb != k) c.tris[first_new + k].n[2] = first_new + kb;
    }
    for (int k = 0; k < m; ++k) by_a[bfinal[k].a] = by_b[bfinal[k].b] = -1;
    c.last_alive = first_new;
    grid.insert(c, p);
  }
  if (walk_steps) *walk_steps = steps;

  // Neighbor convention check: for triangle (v0=p, v1=a, v2=b):
  //   n[0] across (a, b)  [set to outer]
  //   n[1] across (p... ) opposite v1=a, i.e. edge (v0, v2) = (p, b)
  //   n[2] opposite v2=b, i.e. edge (v0, v1) = (p, a)
  // The linking loop above set n[1] for shared (p, bk.b) and n[2] for
  // shared (p, bk.a) accordingly.

  // Compact output: drop triangles touching the super-triangle, and drop
  // triangles that are degenerate in the ORIGINAL (unjittered) coordinates
  // — the symbolic jitter triangulates exactly-collinear runs (pixel-grid
  // hull edges) into zero-area slivers that an exact-arithmetic
  // triangulator would never emit.
  std::vector<int> remap(c.tris.size(), -1);
  int ntri = 0;
  for (size_t t = 0; t < c.tris.size(); ++t) {
    const Tri& tri = c.tris[t];
    if (!tri.alive) continue;
    if (tri.v[0] >= n || tri.v[1] >= n || tri.v[2] >= n) continue;
    long double ax = pts[2 * tri.v[0]], ay = pts[2 * tri.v[0] + 1];
    long double bx = pts[2 * tri.v[1]], by = pts[2 * tri.v[1] + 1];
    long double cx2 = pts[2 * tri.v[2]], cy2 = pts[2 * tri.v[2] + 1];
    long double area2 = (bx - ax) * (cy2 - ay) - (by - ay) * (cx2 - ax);
    if (area2 <= 0) continue;
    remap[t] = ntri++;
  }

  for (size_t t = 0; t < c.tris.size(); ++t) {
    if (remap[t] < 0) continue;
    const Tri& tri = c.tris[t];
    tri_out[3 * remap[t] + 0] = tri.v[0];
    tri_out[3 * remap[t] + 1] = tri.v[1];
    tri_out[3 * remap[t] + 2] = tri.v[2];
    for (int e = 0; e < 3; ++e) {
      int nb = tri.n[e];
      neigh_out[3 * remap[t] + e] =
          (nb >= 0 && remap[nb] >= 0) ? remap[nb] : -1;
    }
  }
  *n_tri_out = ntri;

  // Unique undirected edges from the triangle list.
  int ne = 0;
  for (int t = 0; t < ntri; ++t) {
    for (int e = 0; e < 3; ++e) {
      int a = tri_out[3 * t + (e + 1) % 3];
      int b = tri_out[3 * t + (e + 2) % 3];
      int nb = neigh_out[3 * t + e];
      // Emit each edge once: hull edges always; interior edges from the
      // lower-id triangle.
      if (nb < 0 || nb > t) {
        edge_out[2 * ne + 0] = a;
        edge_out[2 * ne + 1] = b;
        ++ne;
      }
    }
  }
  *n_edge_out = ne;
  return 0;
}

int delaunay_triangulate(const float* pts, int n,
                         int* tri_out, int* n_tri_out,
                         int* edge_out, int* n_edge_out,
                         int* neigh_out) {
  return delaunay_triangulate_ex(pts, n, tri_out, n_tri_out, edge_out,
                                 n_edge_out, neigh_out, nullptr);
}

}  // extern "C"
