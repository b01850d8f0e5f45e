// Native host-side reference engine for nbody.
//
// Role: where the reference implements its golden semantics natively
// (C++/CUDA host tree build project.cu:575-591, CPU traversal 593-675,
// dump writer 504-534), this library provides the same semantics as a
// fast C library used for large-N parity testing and dump generation.
// The device compute path (Pallas/XLA) never calls this; it exists so the
// framework's conformance oracle runs at reference speed on 40K+ bodies
// instead of Python speed.
//
// This is a fresh implementation of the documented semantics (SURVEY.md
// sections 2.3/2.4): insertion-order adaptive quadtree with child order
// BL,BR,TL,TR and ">= goes high" midpoint splits; depth-capped
// aggregation of co-located bodies into mass-weighted pseudo-bodies with
// the -index-2 single-occupant encoding; post-order COM aggregation;
// per-body DFS with theta acceptance (node_size/d < theta, d softened by
// +1e-15) and zero-mass skip at 1e-15; semi-implicit Euler update.
//
// Exposed C ABI (consumed by nbody/utils/native.py via ctypes):
//   nbody_bh_accelerations   — build + traverse, acc out
//   nbody_naive_accelerations— O(N^2) no-softening reference
//   nbody_tree_dump          — pre-order dump text (plot_quadtree format)
//   nbody_simulate           — full step loop, final positions out

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr double kMassSkip = 1e-15;
constexpr double kSoftening = 1e-15;

struct Node {
  int32_t child[4] = {-1, -1, -1, -1};
  double com_x = 0.0;
  double com_y = 0.0;
  double mass = 0.0;
  double x0 = 0.0, x1 = 0.0, y0 = 0.0, y1 = 0.0;
  int32_t occupant = -1;  // body index, or -idx-2 single-body-at-cap, or -1

  bool leaf() const { return child[0] == -1; }
};

class Quadtree {
 public:
  Quadtree(int max_depth, size_t max_nodes)
      : max_depth_(max_depth), max_nodes_(max_nodes) {}

  // Insertion-order build: bodies 0..n-1, recursive midpoint subdivision.
  void build(const double* pos, const double* mass, int n) {
    nodes_.clear();
    double x0 = std::numeric_limits<double>::infinity(), x1 = -x0;
    double y0 = x0, y1 = -x0;
    for (int i = 0; i < n; ++i) {
      x0 = std::min(x0, pos[2 * i]);
      x1 = std::max(x1, pos[2 * i]);
      y0 = std::min(y0, pos[2 * i + 1]);
      y1 = std::max(y1, pos[2 * i + 1]);
    }
    double span = std::max(x1 - x0, y1 - y0);
    double pad = span == 0.0 ? 1e-6 : 0.1 * span;
    Node root;
    root.x0 = x0 - pad;
    root.x1 = x1 + pad;
    root.y0 = y0 - pad;
    root.y1 = y1 + pad;
    nodes_.push_back(root);
    for (int i = 0; i < n; ++i) insert(i, pos, mass);
    aggregate(0);
  }

  // Per-body stack DFS with theta acceptance; writes acc[2*i..2*i+1].
  void accelerations(const double* pos, const double* mass, int n, double g,
                     double theta, double* acc) const {
    std::vector<int32_t> stack;
    stack.reserve(256);
    for (int i = 0; i < n; ++i) {
      const double px = pos[2 * i], py = pos[2 * i + 1];
      double ax = 0.0, ay = 0.0;
      stack.clear();
      stack.push_back(0);
      while (!stack.empty()) {
        const Node& nd = nodes_[stack.back()];
        stack.pop_back();
        if (nd.mass <= kMassSkip) continue;
        const double dx = nd.com_x - px;
        const double dy = nd.com_y - py;
        const double r2 = dx * dx + dy * dy;
        const double r = std::sqrt(r2) + kSoftening;
        const double extent = std::max(nd.x1 - nd.x0, nd.y1 - nd.y0);
        if (nd.leaf() || extent / r < theta) {
          if (nd.leaf() &&
              (nd.occupant == i || nd.occupant + 2 == -i)) {
            continue;  // self (incl. the -idx-2 single-at-cap encoding)
          }
          const double mag = g * nd.mass / r2;  // force/m_i
          ax += mag * dx / r;
          ay += mag * dy / r;
        } else {
          for (int c = 0; c < 4; ++c) {
            // push ascending 0..3 like the reference, so the LIFO pop
            // order is 3..0 and the fp summation order matches exactly
            if (nd.child[c] != -1) stack.push_back(nd.child[c]);
          }
        }
      }
      acc[2 * i] = ax;
      acc[2 * i + 1] = ay;
    }
  }

  // Pre-order dump in the plot_quadtree.py line format.
  std::string dump(const double* pos) const {
    std::string out;
    out.reserve(nodes_.size() * 64);
    dump_node(0, 0, pos, &out);
    return out;
  }

  size_t size() const { return nodes_.size(); }

 private:
  void insert(int body, const double* pos, const double* mass) {
    const double bx = pos[2 * body], by = pos[2 * body + 1];
    const double bm = mass[body];
    int32_t node = 0;
    int depth = 1;  // the root is depth 1 in insertion terms
    for (;;) {
      if (depth >= max_depth_ + 1) {
        // depth cap: fold into a mass-weighted pseudo-body
        Node& nd = nodes_[node];
        const double m0 = nd.mass;
        nd.com_x = (m0 * nd.com_x + bm * bx) / (m0 + bm);
        nd.com_y = (m0 * nd.com_y + bm * by) / (m0 + bm);
        nd.mass += bm;
        nd.occupant = (m0 == 0.0) ? -body - 2 : -1;
        return;
      }
      {
        Node& nd = nodes_[node];
        if (nd.leaf() && nd.mass == 0.0) {
          // empty leaf: claim it
          nd.com_x = bx;
          nd.com_y = by;
          nd.mass = bm;
          nd.occupant = body;
          return;
        }
      }
      if (nodes_[node].leaf()) {
        // occupied leaf: split, relocate the occupant one level down
        if (!split(node)) return;  // capacity guard
        Node& nd = nodes_[node];
        const int prev = nd.occupant;
        const double ox = nd.com_x, oy = nd.com_y;
        const double om = nd.mass;
        nd.com_x = nd.com_y = nd.mass = 0.0;
        nd.occupant = -1;
        const int32_t dest = nd.child[quadrant_of(nd, ox, oy)];
        Node& dn = nodes_[dest];
        dn.com_x = ox;
        dn.com_y = oy;
        dn.mass = om;
        // The relocated occupant lands in an empty child, so the
        // single-step move is equivalent to a recursive re-insert — except
        // that a re-insert into a depth-capped child goes through the
        // aggregation branch, which encodes a first arrival as -idx-2.
        dn.occupant = (depth + 1 >= max_depth_ + 1) ? -prev - 2 : prev;
      }
      node = nodes_[node].child[quadrant_of(nodes_[node], bx, by)];
      ++depth;
    }
  }

  // Child order BL, BR, TL, TR with >= sent to the high half.
  static int quadrant_of(const Node& nd, double x, double y) {
    const double mx = (nd.x0 + nd.x1) / 2;
    const double my = (nd.y0 + nd.y1) / 2;
    return (y >= my ? 2 : 0) + (x >= mx ? 1 : 0);
  }

  bool split(int32_t node) {
    if (nodes_.size() + 4 > max_nodes_) {
      std::fprintf(stderr, "quadtree capacity %zu reached\n", max_nodes_);
      return false;
    }
    const double x0 = nodes_[node].x0, x1 = nodes_[node].x1;
    const double y0 = nodes_[node].y0, y1 = nodes_[node].y1;
    const double mx = (x0 + x1) / 2, my = (y0 + y1) / 2;
    const double bounds[4][4] = {
        {x0, mx, y0, my}, {mx, x1, y0, my}, {x0, mx, my, y1}, {mx, x1, my, y1}};
    for (int c = 0; c < 4; ++c) {
      Node kid;
      kid.x0 = bounds[c][0];
      kid.x1 = bounds[c][1];
      kid.y0 = bounds[c][2];
      kid.y1 = bounds[c][3];
      nodes_[node].child[c] = static_cast<int32_t>(nodes_.size());
      nodes_.push_back(kid);
    }
    return true;
  }

  // Post-order total-mass / COM fill for internal nodes.
  void aggregate(int32_t node) {
    Node& nd = nodes_[node];
    if (nd.leaf()) return;
    double m = 0.0, cx = 0.0, cy = 0.0;
    for (int c = 0; c < 4; ++c) {
      aggregate(nd.child[c]);
      const Node& kid = nodes_[nd.child[c]];
      m += kid.mass;
      cx += kid.mass * kid.com_x;
      cy += kid.mass * kid.com_y;
    }
    if (m > 0.0) {
      cx /= m;
      cy /= m;
    }
    nd.mass = m;
    nd.com_x = cx;
    nd.com_y = cy;
  }

  static void append_g6(std::string* out, double v) {
    char buf[32];
    std::snprintf(buf, sizeof buf, "%.6g", v);
    *out += buf;
  }

  void dump_node(int32_t node, int depth, const double* pos,
                 std::string* out) const {
    const Node& nd = nodes_[node];
    *out += std::to_string(depth);
    for (double v : {nd.x0, nd.x1, nd.y0, nd.y1, nd.mass}) {
      *out += ' ';
      append_g6(out, v);
    }
    double ox = nd.com_x, oy = nd.com_y;
    bool print_occ = false;
    if (nd.occupant != -1) {
      print_occ = true;
      const int body = nd.occupant >= 0 ? nd.occupant : -nd.occupant - 2;
      ox = pos[2 * body];
      oy = pos[2 * body + 1];
    } else if (nd.mass > 0) {
      print_occ = true;  // internal / aggregated: COM as the position
    }
    if (print_occ) {
      *out += " occupantIndex=" + std::to_string(nd.occupant) +
              " occupantPos=(";
      append_g6(out, ox);
      *out += ',';
      append_g6(out, oy);
      *out += ')';
    }
    *out += '\n';
    if (!nd.leaf()) {
      for (int c = 0; c < 4; ++c) dump_node(nd.child[c], depth + 1, pos, out);
    }
  }

  const int max_depth_;
  const size_t max_nodes_;
  std::vector<Node> nodes_;
};

size_t max_nodes_for(int max_depth) {
  // complete-tree bound (4^(d+1)-1)/3, the reference's QUADTREE_MAX_SIZE
  size_t total = 0, level = 1;
  for (int d = 0; d <= max_depth; ++d, level *= 4) total += level;
  return total;
}

}  // namespace

extern "C" {

int nbody_bh_accelerations(const double* masses, const double* positions,
                           int n, double g, double theta, int max_depth,
                           double* out_acc) {
  if (n <= 0 || max_depth < 0) return -1;
  Quadtree tree(max_depth, max_nodes_for(max_depth));
  tree.build(positions, masses, n);
  tree.accelerations(positions, masses, n, g, theta, out_acc);
  return static_cast<int>(tree.size());
}

int nbody_naive_accelerations(const double* masses, const double* positions,
                              int n, double g, double* out_acc) {
  if (n <= 0) return -1;
  for (int i = 0; i < n; ++i) {
    double ax = 0.0, ay = 0.0;
    const double px = positions[2 * i], py = positions[2 * i + 1];
    for (int j = 0; j < n; ++j) {
      if (j == i) continue;
      const double dx = positions[2 * j] - px;
      const double dy = positions[2 * j + 1] - py;
      const double r2 = dx * dx + dy * dy;
      const double r = std::sqrt(r2);
      const double w = g * masses[j] / (r2 * r);
      ax += w * dx;
      ay += w * dy;
    }
    out_acc[2 * i] = ax;
    out_acc[2 * i + 1] = ay;
  }
  return 0;
}

long nbody_tree_dump(const double* masses, const double* positions, int n,
                     int max_depth, char* buf, long capacity) {
  if (n <= 0) return -1;
  Quadtree tree(max_depth, max_nodes_for(max_depth));
  tree.build(positions, masses, n);
  const std::string text = tree.dump(positions);
  const long needed = static_cast<long>(text.size());
  if (buf != nullptr && capacity >= needed) {
    std::memcpy(buf, text.data(), text.size());
  }
  return needed;
}

// engine: 0 = naive all-pairs, 1 = Barnes-Hut
int nbody_simulate(double* masses, double* positions, double* velocities,
                   int n, int steps, double dt, double g, double theta,
                   int max_depth, int engine) {
  if (n <= 0) return -1;
  std::vector<double> acc(2 * n);
  for (int s = 0; s < steps; ++s) {
    if (engine == 0) {
      if (nbody_naive_accelerations(masses, positions, n, g, acc.data()))
        return -2;
    } else {
      if (nbody_bh_accelerations(masses, positions, n, g, theta, max_depth,
                                 acc.data()) < 0)
        return -2;
    }
    for (int i = 0; i < 2 * n; ++i) {
      velocities[i] += acc[i] * dt;
      positions[i] += velocities[i] * dt;
    }
  }
  return 0;
}

}  // extern "C"
