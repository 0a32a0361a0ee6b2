// Arithmetic-operation counts of kernels K1 (ip_solve.cu), K2 (riccati.cu)
// and K3 (irk_step.cu): the work each scenario's (K3: each row's) inputs
// need.
//
// Host-only C++ (g++ -std=c++17 -O2 -shared -fPIC -pthread). It builds each
// kernel's __host__ __device__ body with a number type F that records one
// scenario's computation as a graph, and runs it as one lane per scenario on
// the given inputs:
// - each distinct operation is one node: an operation on operands that the
//   scenario has already combined the same way is the node made then, so a
//   value the body computes twice (a pair's deltas in the step-bound pass and
//   again in the update pass, C dx in every pass) counts once;
// - an operation with a literal zero or one (x + 0, x - 0, x * 0, x * 1,
//   x / 1) is no operation: a product the code starts from T(0) adds nothing,
//   and K3's products with the entries its blocks hold at 0 or 1 outside Jf's
//   corner (which it computes by the dense expression) are none;
// - only the nodes that the outputs depend on are counted, through their
//   values or through a comparison that steers the solve (the freeze test,
//   the sign test of each step bound); the last iteration's dual updates,
//   which no output reads, are not.
// Counted: add, subtract, multiply, divide, square root, sine, cosine (an
// FMA is two). Not counted: min, max, abs, negation, comparisons. chip_smoke.py uses the
// counts for each kernel's bound_ms.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace opc {

enum Op : uint8_t { LEAF, LIT, ADD, SUB, MUL, DIV, SQRT, SIN, COS, NEG, ABS, MAX, MIN };

struct Node {
  uint32_t a, b;
  uint8_t op, live;
};

// One scenario's graph (one per thread). Node 0 is the literal 0, node 1 the
// literal 1; every operand is older than the node that uses it.
struct Graph {
  std::vector<Node> nodes;
  std::vector<uint64_t> keys;     // open addressing: (op, a, b) -> node + 1
  std::vector<uint32_t> vals;
  std::vector<size_t> used;
  std::unordered_map<uint64_t, uint32_t> lits;

  void reset() {
    for (size_t s : used) vals[s] = 0;
    used.clear();
    nodes.clear();
    lits.clear();
    if (vals.empty()) { keys.assign(1 << 16, 0); vals.assign(1 << 16, 0); }
    lit(0.0);
    lit(1.0);
  }
  static uint64_t mix(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    return x ^ (x >> 33);
  }
  uint32_t node(Op op, uint32_t a, uint32_t b) {
    nodes.push_back({a, b, op, 0});
    return (uint32_t)nodes.size() - 1;
  }
  uint32_t lit(double v) {
    if (v == 0.0 && !nodes.empty()) return 0;
    uint64_t bits;
    std::memcpy(&bits, &v, sizeof bits);
    auto it = lits.find(bits);
    if (it != lits.end()) return it->second;
    return lits[bits] = node(LIT, 0, 0);
  }
  void grow() {
    std::vector<uint64_t> k2(keys.size() * 2, 0);
    std::vector<uint32_t> v2(vals.size() * 2, 0);
    std::vector<size_t> u2;
    size_t mask = v2.size() - 1;
    for (size_t s : used) {
      size_t t = mix(keys[s]) & mask;
      while (v2[t]) t = (t + 1) & mask;
      k2[t] = keys[s]; v2[t] = vals[s]; u2.push_back(t);
    }
    keys.swap(k2); vals.swap(v2); used.swap(u2);
  }
  uint32_t intern(Op op, uint32_t a, uint32_t b) {
    if (2 * (used.size() + 1) > vals.size()) grow();
    uint64_t key = (uint64_t)op << 56 | (uint64_t)a << 28 | b;
    size_t mask = vals.size() - 1, s = mix(key) & mask;
    while (vals[s]) {
      if (keys[s] == key) return vals[s] - 1;
      s = (s + 1) & mask;
    }
    uint32_t id = node(op, a, b);
    keys[s] = key; vals[s] = id + 1; used.push_back(s);
    return id;
  }
  void root(uint32_t id) { nodes[id].live = 1; }
  // operations among the nodes the roots depend on
  long long count() {
    long long n = 0;
    for (size_t i = nodes.size(); i-- > 0;) {
      Node& d = nodes[i];
      if (!d.live || d.op == LEAF || d.op == LIT) continue;
      nodes[d.a].live = nodes[d.b].live = 1;
      n += d.op == ADD || d.op == SUB || d.op == MUL || d.op == DIV || d.op == SQRT ||
           d.op == SIN || d.op == COS;
    }
    return n;
  }
};

thread_local Graph g;

struct F {
  double v;
  uint32_t id;
  F() = default;                       // value-initialized: the literal 0
  F(double x) : v(x), id(g.lit(x)) {}
  F(double x, uint32_t i) : v(x), id(i) {}
  static F leaf(double x) { return F(x, g.node(LEAF, 0, 0)); }
};

inline bool is0(F a) { return a.id == 0; }
inline bool is1(F a) { return a.id == 1; }
inline F op2(Op op, double v, F a, F b, bool commutes) {
  uint32_t x = a.id, y = b.id;
  if (commutes && x > y) std::swap(x, y);
  return F(v, g.intern(op, x, y));
}
inline F operator+(F a, F b) {
  if (is0(a)) return b;
  if (is0(b)) return a;
  return op2(ADD, a.v + b.v, a, b, true);
}
inline F operator-(F a) { return is0(a) ? a : F(-a.v, g.intern(NEG, a.id, 0)); }
inline F operator-(F a, F b) {
  if (is0(b)) return a;
  if (is0(a)) return -b;
  return op2(SUB, a.v - b.v, a, b, false);
}
inline F operator*(F a, F b) {
  if (is0(a) || is0(b)) return F(0.0, 0);
  if (is1(a)) return b;
  if (is1(b)) return a;
  return op2(MUL, a.v * b.v, a, b, true);
}
inline F operator/(F a, F b) {
  if (is1(b) || is0(a)) return a;
  return op2(DIV, a.v / b.v, a, b, false);
}
inline F& operator+=(F& a, F b) { return a = a + b; }
inline F vsqrt(F a) { return F(std::sqrt(a.v), g.intern(SQRT, a.id, 0)); }
// K3's sine and cosine (found by ADL)
inline F sin_(F a) { return F(std::sin(a.v), g.intern(SIN, a.id, 0)); }
inline F cos_(F a) { return F(std::cos(a.v), g.intern(COS, a.id, 0)); }
inline F vabs(F a) { return F(std::fabs(a.v), g.intern(ABS, a.id, 0)); }
// the kernels' NaN-propagating max / min, as selections (found by ADL)
inline F pmax(F a, F b) { return op2(MAX, (a.v != a.v || a.v > b.v) ? a.v : b.v, a, b, false); }
inline F pmin(F a, F b) { return op2(MIN, (a.v != a.v || a.v < b.v) ? a.v : b.v, a, b, false); }
// a comparison that steers the solve makes its operands needed
inline bool cmp(F a, F b, bool r) { g.root(a.id); g.root(b.id); return r; }
inline bool operator<(F a, F b) { return cmp(a, b, a.v < b.v); }
inline bool operator>(F a, F b) { return cmp(a, b, a.v > b.v); }
inline bool operator==(F a, F b) { return cmp(a, b, a.v == b.v); }
inline bool operator!=(F a, F b) { return cmp(a, b, a.v != b.v); }

std::vector<F> leaves(const double* a, long long n) {
  std::vector<F> out;
  out.reserve(n);
  for (long long i = 0; i < n; ++i) out.push_back(F::leaf(a[i]));
  return out;
}
void roots(const std::vector<F>& v) {
  for (const F& x : v) g.root(x.id);
}

}  // namespace opc

#include "ip_solve.cu"
#include "riccati.cu"
#include "irk_step.cu"

// K1 on B batch-first f64 QPs (already cost-normalized, the 17 OcpQp fields
// in order), structure 0 generic / 1 unicycle: the sum over the scenarios of
// each one's count, on as many threads as the host has cores.
extern "C" long long count_ip_solve(const double** in, int B, int N, int M, int iters,
                                    double reg, double tau, double tol, double stat_tol,
                                    double sigma_max, int structure) {
  using opc::F;
  const long long n1 = N + 1;
  const long long per[17] = {N * 25, N * 10, N * 5, 5, n1 * 25, n1 * 5, N * 4, N * 2, N * 10,
                             N * 2, N * 2, n1 * 4, n1 * 4, n1 * M * 5, n1 * M, n1 * M, n1 * M};
  int nt = (int)std::max(1u, std::min(std::thread::hardware_concurrency(), (unsigned)B));
  std::vector<long long> part(nt, 0);
  auto work = [&](int t) {
    for (int b = t; b < B; b += nt) {
      opc::g.reset();
      std::vector<std::vector<F>> qp;
      for (int i = 0; i < 17; ++i) qp.push_back(opc::leaves(in[i] + b * per[i], per[i]));
      std::vector<F> dx(n1 * 5), du(N * 2), s(n1 * M), mu(1), stat(1);
      ipk::Params<F> p{qp[0].data(), qp[1].data(), qp[2].data(), qp[3].data(), qp[4].data(),
                       qp[5].data(), qp[6].data(), qp[7].data(), qp[8].data(), qp[9].data(),
                       qp[10].data(), qp[11].data(), qp[12].data(), qp[13].data(),
                       qp[14].data(), qp[15].data(), qp[16].data(),
                       dx.data(), du.data(), s.data(), mu.data(), stat.data(), 1, N, M, iters,
                       F(reg), F(tau), F(tol), F(stat_tol), F(sigma_max)};
      ipk::host_solve<F>(p, structure);
      for (auto* v : {&dx, &du, &s, &mu, &stat}) opc::roots(*v);
      part[t] += opc::g.count();
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
  long long n = 0;
  for (long long x : part) n += x;
  return n;
}

// K2 on one seeded LQR of horizon N (its work does not depend on the data).
extern "C" long long count_riccati(int N) {
  using opc::F;
  const int n1 = N + 1;
  opc::g.reset();
  std::vector<double> Q(n1 * 25), R(N * 4), S(N * 10, 0.1), A(N * 25), Bm(N * 10),
      q(n1 * 5, 1.0), r(N * 2, 1.0), d(N * 5, 1.0), x0(5, 1.0);
  for (int k = 0; k < n1; ++k)
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) {
        Q[(k * 5 + i) * 5 + j] = i == j ? 2.0 : 0.1;
        if (k < N) A[(k * 5 + i) * 5 + j] = i == j ? 0.9 : 0.05;
      }
  for (int e = 0; e < N * 10; ++e) Bm[e] = 0.1 * (e % 7 + 1);
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) R[(k * 2 + i) * 2 + j] = i == j ? 1.0 : 0.1;
  std::vector<F> fQ = opc::leaves(Q.data(), Q.size()), fR = opc::leaves(R.data(), R.size()),
                 fS = opc::leaves(S.data(), S.size()), fA = opc::leaves(A.data(), A.size()),
                 fB = opc::leaves(Bm.data(), Bm.size()), fq = opc::leaves(q.data(), q.size()),
                 fr = opc::leaves(r.data(), r.size()), fd = opc::leaves(d.data(), d.size()),
                 fx = opc::leaves(x0.data(), x0.size());
  std::vector<F> xo(n1 * 5), uo(N * 2), no(N * 5);
  rck::Params<F> p{fQ.data(), fR.data(), fS.data(), fA.data(), fB.data(), fq.data(), fr.data(),
                   fd.data(), fx.data(), xo.data(), uo.data(), no.data(), 1, N, F(1e-6)};
  rck::host_solve<F>(p, true);
  for (auto* v : {&xo, &uo, &no}) opc::roots(*v);
  return opc::g.count();
}

// K3 on one row: s stages, newton_iter iterations, num_steps substeps, with
// or without D. The tableau (A, its (-h) A, b, h) is a leaf like the row's
// x and u: the kernel forms (-h) A per block, work the launch needs once,
// not per row. Its work does not depend on the data.
template <int S, bool SENS>
long long count_irk_row(int newton_iter, int num_steps) {
  using opc::F;
  opc::g.reset();
  irks::Tab<F> tb;
  for (int i = 0; i < S; ++i) {
    for (int j = 0; j < S; ++j) {
      tb.A[i][j] = F::leaf(0.1 + 0.01 * (i * S + j));
      tb.hA[i][j] = F::leaf(-0.01 - 0.001 * (i * S + j));
    }
    tb.b[i] = F::leaf(1.0 / S);
  }
  tb.h = F::leaf(0.1);
  std::vector<double> xu = {0.3, -0.2, 0.7, 1.1, 0.05, 0.4, -0.6};
  std::vector<F> x = opc::leaves(xu.data(), 5), u = opc::leaves(xu.data() + 5, 2);
  std::vector<F> phi(5), D(SENS ? 35 : 0);
  auto* m = new irks::Row<F, S, SENS>();
  irks::Step<F, S, SENS> st{*m, tb, irks::Team{0, 0u, false}};
  st.run(x.data(), u.data(), newton_iter, num_steps, phi.data(), SENS ? D.data() : nullptr);
  delete m;
  opc::roots(phi);
  opc::roots(D);
  return opc::g.count();
}

extern "C" long long count_irk_step(int s, int newton_iter, int num_steps, int sens) {
  if (newton_iter < 0 || num_steps < 1) return -1;
  switch (s * 2 + (sens ? 1 : 0)) {
    case 2: return count_irk_row<1, false>(newton_iter, num_steps);
    case 3: return count_irk_row<1, true>(newton_iter, num_steps);
    case 4: return count_irk_row<2, false>(newton_iter, num_steps);
    case 5: return count_irk_row<2, true>(newton_iter, num_steps);
    case 6: return count_irk_row<3, false>(newton_iter, num_steps);
    case 7: return count_irk_row<3, true>(newton_iter, num_steps);
    case 8: return count_irk_row<4, false>(newton_iter, num_steps);
    case 9: return count_irk_row<4, true>(newton_iter, num_steps);
    default: return -1;
  }
}
