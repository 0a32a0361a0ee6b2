// Whole-solve interior-point kernel for batches of soft-constrained OCP QPs.
//
// Replaces doa_mpc_tpu/ops/ip_pallas.py::_ip_solve_kernel (the TPU kernel):
// one launch runs the initialization and every Mehrotra predictor-corrector
// iteration of every scenario -- residuals, barrier sigmas with the
// soft-constraint elimination sigma_eff = sh (Zl + ss) / (Zl + sh + ss), the
// condensed stage Hessians, one backward Riccati factorization shared by
// predictor and corrector, the affine solve with
// mu_aff = sum(t l) + ap S1 + ad S2 + ap ad S3, centering (mu_aff / mu)^3,
// the corrector solve, the fraction-to-boundary step min(1, tau min(v / -dv))
// and the masked update (freeze when converged or non-finite, floor 1e-30).
// A frozen scenario leaves the loop: every later iteration would recompute
// the same mu and stat from an iterate that no longer moves.
//
// What bounds it on the H100: latency. Its bytes (each read or written
// once) and its operations (csrc/op_count.cpp counts them from this code,
// each distinct operation once) would take tens of microseconds at the
// card's memory and f32 rates (chip_smoke.py computes the bound; PERF.md
// has it); each scenario's solve is instead a chain of four stage-serial
// recursions per iteration, small dependent mat-vecs, divisions and square
// roots. The first design (one thread per scenario, every value in device
// memory) took 11 ms at B = 4096; the design below cuts the chain's steps
// and keeps their operands on chip.
//
// Design:
// - A team of kTeam = 16 lanes (a cooperative_groups tile) owns one
//   scenario; a block is one warp, so it holds two. The stage-local phases
//   run with lanes over stages (residuals, mu and stat, sigmas, the
//   condensed Hessians Qbar and Rbar, the right-hand sides with their
//   betas, the step-length bounds, S1..S3, chk, the masked update); their
//   reductions are tile shuffles, and min / max stay NaN-propagating (fminf
//   drops NaN and would break the freeze).
//   The stage-serial recursions run with lanes over matrix entries: the
//   Riccati factorization (every lane forms P B, Huu and its Cholesky
//   factor, lane j column j of P A, Hux and K, then the lanes share the 15
//   entries of the symmetrized P: two tile syncs per stage), the
//   back-substitution and the rollout of (dx, du) (one sync per stage each);
//   the per-stage deltas of a rollout are then recomputed stage-parallel, as
//   the plain version does. A frozen row leaves the iteration loop, and the
//   break is uniform across the tile (mu, stat, chk and the steps are tile
//   reductions). A team of 32 was built and measured too: slower at B = 4096
//   (PERF.md), so only 16 is built.
// - State on chip for the whole solve. Each scenario's IP state (the t / l
//   pairs, nu, dx, du, s), its work arrays (Qbar then P, K, L, Rbar, kff, the
//   right-hand sides / costates, rx, the dynamics gaps, one direction at a
//   time, and the affine product dt * dl of every pair, from which the
//   corrector's betas come) and its dynamics A, B (and S, generic) live in
//   dynamic shared memory, sized from N and M at launch (smem_floats below:
//   13.3 KB per scenario at N = 20, M = 5 unicycle, 14.9 KB generic, 29.1 KB
//   at N = 40, M = 8). A and B are read once into shared memory because all
//   four serial recursions read them on their critical path. The other QP
//   fields (Q, q, R, r, c, bounds, C, h, zl, Zl) are read in place through
//   L1 / L2 in the stage-parallel phases, where the independent stages hide
//   the latency; at B = 4096 they are 17 MB (unicycle), inside the 50 MB L2.
//   Copying them too would cost 4.3 KB more per scenario and a third wave.
// - Any N and M: when a block's shared memory cannot hold its two
//   scenarios' arrays (beyond about N = 180 at M = 5), a second
//   instantiation of the same body keeps them in a device-memory workspace
//   the caller passes, one slice per tile of the grid, read and written
//   through L1 / L2.
// - Residency and the hand-out: a block of two unicycle scenarios at N = 20,
//   M = 5 needs 26.7 KB plus the 1 KB the runtime reserves, so 8 blocks (16
//   scenarios) fit an SM, 2,112 tiles on the card. The grid is every
//   resident tile, never more than B needs (plan below). Each tile solves
//   the scenario of its own index first and then takes the next one from a
//   counter in device memory that the launch zeroes on its stream. Rows
//   differ widely in the iterations they need (a median of 6, a few at the
//   cap of 100 on a campaign tick), so a fixed stride would make a launch
//   of two passes last the sum of the two slowest rows of one tile; taken
//   from the counter, a long row holds one tile while the others drain the
//   rest. Registers are not the limit (ptxas figures in PERF.md).
// - Rows the caller skips: the closed loop freezes a done row's state and
//   discards its answer, yet a row done while at the cap would get the same
//   QP from the same start on every later tick and run all its iterations
//   again. A per-row mask marks such rows; a marked row gets no init and no
//   iteration, only defined outputs (skip_row), and its tile takes the next
//   row at once.
// - The structure at compile time: Generic reads the QP densely and is right
//   for any QP; Unicycle (ops/ip_fused.UNICYCLE_QP_STRUCTURE: diagonal Q and
//   R, S = 0, C only in columns 0 and 1, identity columns 0 and 1 of A,
//   Zl == zl) neither loads nor multiplies what the structure makes zero or
//   one. The caller asserts the declaration.
// - Batch-first I/O: the OcpQp fields are read as they come, one scenario's
//   fields one contiguous run each; dx, du and s are written batch-first.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: the 1e-30 floors, the chk == chk NaN test and the 3e38
// finite bound need IEEE division, sqrt and comparisons.
//
// The solve body is __host__ __device__ and has no CUDA dependency outside
// the team's tile operations and the launcher: on the host the team is one
// lane that walks every stage and every entry, so the same file compiles as
// plain C++ (float or double) for host-side tests of the arithmetic.

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <vector>
#define HD inline
#endif

#include <stddef.h>

namespace ipk {

constexpr int NX = 5;
constexpr int NU = 2;
constexpr int NBX = 4;
constexpr int NTRI_P = NX * (NX + 1) / 2;   // upper triangle of P
constexpr int NSCR = 48;                    // per-scenario scratch floats
constexpr int kWarp = 32;                   // threads per block
constexpr int kTeam = 16;                   // lanes per scenario
constexpr int kPerBlock = kWarp / kTeam;    // scenarios per block

HD int idxbx(int i) { return i < 2 ? i : i + 1; }   // IDXBX = (0, 1, 3, 4)
HD int tri(int i, int j) {                          // upper-triangle slot
  if (i > j) { int t = i; i = j; j = t; }
  return i * (2 * NX - i + 1) / 2 + (j - i);
}

HD float vsqrt(float x) { return sqrtf(x); }
HD double vsqrt(double x) { return sqrt(x); }
HD float vabs(float x) { return fabsf(x); }
HD double vabs(double x) { return fabs(x); }
// NaN-propagating max/min (torch.maximum / torch.minimum semantics)
template <typename T> HD T pmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T> HD T pmin(T a, T b) { return (a != a || a < b) ? a : b; }

#ifdef __CUDACC__
template <typename T> HD T ld(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}
#else
template <typename T> HD T ld(const T* p) { return *p; }
#endif

// ---- the team that owns one scenario -----------------------------------
// On the device: a tile of kTeam lanes of one warp. On the host: one lane.
struct DevTeam {
  int lane;
  HD int rank() const { return lane; }
  HD static constexpr int size() { return kTeam; }
#ifdef __CUDACC__
  __device__ static cooperative_groups::thread_block_tile<kTeam> tile() {
    return cooperative_groups::tiled_partition<kTeam>(cooperative_groups::this_thread_block());
  }
#endif
  HD void sync() const {
#ifdef __CUDA_ARCH__
    tile().sync();
#endif
  }
  HD int bcast(int v) const {        // lane 0's v on every lane
#ifdef __CUDA_ARCH__
    v = tile().shfl(v, 0);
#endif
    return v;
  }
  template <typename T> HD T sum(T v) const {
#ifdef __CUDA_ARCH__
    auto g = tile();
#pragma unroll
    for (int o = kTeam / 2; o > 0; o /= 2) v = v + g.shfl_xor(v, o);
#endif
    return v;
  }
  template <typename T> HD T max(T v) const {
#ifdef __CUDA_ARCH__
    auto g = tile();
#pragma unroll
    for (int o = kTeam / 2; o > 0; o /= 2) v = pmax(v, g.shfl_xor(v, o));
#endif
    return v;
  }
  template <typename T> HD T min(T v) const {
#ifdef __CUDA_ARCH__
    auto g = tile();
#pragma unroll
    for (int o = kTeam / 2; o > 0; o /= 2) v = pmin(v, g.shfl_xor(v, o));
#endif
    return v;
  }
};

struct HostTeam {
  HD int rank() const { return 0; }
  HD static constexpr int size() { return 1; }
  HD void sync() const {}
  HD int bcast(int v) const { return v; }
  template <typename T> HD T sum(T v) const { return v; }
  template <typename T> HD T max(T v) const { return v; }
  template <typename T> HD T min(T v) const { return v; }
};

// ---- the QP structure, fixed at compile time -----------------------------
struct Generic { static constexpr bool kUni = false; };
struct Unicycle { static constexpr bool kUni = true; };

template <typename T>
struct Params {
  const T *A, *Bm, *c, *dx0, *Q, *q, *R, *r, *S, *lbu, *ubu, *lbx, *ubx,
      *C, *h, *zl, *Zl;
  T *dx, *du, *s, *mu, *stat;
  int B, N, M, iters;
  T reg, tau, tol, stat_tol, sigma_max;
  int* iters_used;    // per row, the iterations that updated it; may be null
  int* end;           // per row, the iterations its tile had run in this
                      // launch when the row was done, the row's own included;
                      // may be null
  const bool* skip;   // per row, true where the caller discards the row's
                      // answer (skip_row); may be null
  int* skipped;       // the rows skipped in this launch; may be null
};

// Shared-memory floats per scenario (state, work arrays, A and B, scratch).
HD long long smem_floats(int N, int M, bool uni) {
  long long N1 = N + 1, na = uni ? NX - 2 : NX;
  long long state = N1 * (NX + M + 4 * NBX + 3 * M) + (long long)N * (NU + NX + 4 * NU);
  long long work = N1 * (NTRI_P + 3 * NX + 2 * M + 2 * NBX)
                   + (long long)N * (NU * NX + 3 + NX + 3 * NU + 3 + 2 * NU)
                   + (long long)N * NX * (na + NU) + (uni ? 0 : (long long)N * NU * NX);
  return state + work + NSCR;
}

template <typename T, class ST, class TM>
struct Solver {
  static constexpr double T_FLOOR = 1e-12;
  static constexpr double ZL_FLOOR = 1e-6;
  static constexpr bool U = ST::kUni;
  static constexpr int NA = U ? NX - 2 : NX;   // stored columns of A

  // the structure: columns 0, 1 of A are e_0, e_1; C lives in columns 0, 1
  HD static constexpr bool a_unit(int j) { return U && j < 2; }
  HD static constexpr int acol(int j) { return U ? j - 2 : j; }
  HD static constexpr bool c_col(int j) { return !U || j < 2; }

  const Params<T>& p;
  TM tm;
  int b, N, M, N1;
  // this scenario's QP in device memory, batch-first
  const T *gc, *gQ, *gq, *gR, *gr, *gS, *glbu, *gubu, *glbx, *gubx, *gC, *gh, *gzl, *gZl;
  // shared memory, every array [entry][stage]
  T *dx, *du, *ss, *nu, *tul, *lul, *tuu, *luu, *txl, *lxl, *txu, *lxu, *th, *lh, *ls;
  T *W, *KK, *LL, *dd, *qv, *rv, *kf, *cx, *cu, *rx, *rb, *sA, *sB, *sS, *scr;
  T *ph, *ps, *pxl, *pxu, *pul, *puu;   // affine dt * dl of each pair

  HD Solver(const Params<T>& p_, int b_, T* sm, TM tm_)
      : p(p_), tm(tm_), b(b_), N(p_.N), M(p_.M), N1(p_.N + 1) {
    size_t n = N, n1 = N1;
    gc = p.c + b * n * NX;
    gQ = p.Q + b * n1 * NX * NX;
    gq = p.q + b * n1 * NX;
    gR = p.R + b * n * NU * NU;
    gr = p.r + b * n * NU;
    gS = p.S + b * n * NU * NX;
    glbu = p.lbu + b * n * NU;
    gubu = p.ubu + b * n * NU;
    glbx = p.lbx + b * n1 * NBX;
    gubx = p.ubx + b * n1 * NBX;
    gC = p.C + b * n1 * M * NX;
    gh = p.h + b * n1 * M;
    gzl = p.zl + b * n1 * M;
    gZl = p.Zl + b * n1 * M;
    T* w = sm;
    auto take = [&](int width, int stages) { T* o = w; w += (size_t)width * stages; return o; };
    dx = take(NX, N1); du = take(NU, N); ss = take(M, N1); nu = take(NX, N);
    tul = take(NU, N); lul = take(NU, N); tuu = take(NU, N); luu = take(NU, N);
    txl = take(NBX, N1); lxl = take(NBX, N1); txu = take(NBX, N1); lxu = take(NBX, N1);
    th = take(M, N1); lh = take(M, N1); ls = take(M, N1);
    W = take(NTRI_P, N1); KK = take(NU * NX, N); LL = take(3, N); dd = take(NX, N);
    qv = take(NX, N1); rv = take(NU, N); kf = take(NU, N);
    cx = take(NX, N1); cu = take(NU, N);
    ph = take(M, N1); ps = take(M, N1); pxl = take(NBX, N1); pxu = take(NBX, N1);
    pul = take(NU, N); puu = take(NU, N);
    rx = take(NX, N1); rb = take(3, N);
    sA = take(NX * NA, N); sB = take(NX * NU, N); sS = take(U ? 0 : NU * NX, N);
    scr = take(NSCR, 1);
  }

  // [entry][stage] arrays over stages 0..N (a1) and 0..N-1 (a0)
  HD T& a1(T* a, int i, int k) const { return a[i * N1 + k]; }
  HD T& a0(T* a, int i, int k) const { return a[i * N + k]; }

  // ---- QP data -----------------------------------------------------------
  HD T A(int k, int i, int j) const { return sA[(i * NA + acol(j)) * N + k]; }  // j not unit
  HD T Bm(int k, int i, int j) const { return sB[(i * NU + j) * N + k]; }
  HD T c(int k, int i) const { return ld(gc + k * NX + i); }
  HD T Q(int k, int i, int j) const { return ld(gQ + (k * NX + i) * NX + j); }
  HD T q(int k, int i) const { return ld(gq + k * NX + i); }
  HD T R(int k, int i, int j) const { return ld(gR + (k * NU + i) * NU + j); }
  HD T r(int k, int i) const { return ld(gr + k * NU + i); }
  HD T S(int k, int i, int j) const { return ld(gS + (k * NU + i) * NX + j); }
  HD T Ss(int k, int i, int j) const { return sS[(i * NX + j) * N + k]; }   // S in shared memory
  HD T lbu(int k, int i) const { return ld(glbu + k * NU + i); }
  HD T ubu(int k, int i) const { return ld(gubu + k * NU + i); }
  HD T lbx(int k, int i) const { return ld(glbx + k * NBX + i); }
  HD T ubx(int k, int i) const { return ld(gubx + k * NBX + i); }
  HD T C(int k, int m, int j) const { return ld(gC + (k * M + m) * NX + j); }
  HD T h(int k, int m) const { return ld(gh + k * M + m); }
  HD T zl(int k, int m) const { return ld(gzl + k * M + m); }
  HD T Zl(int k, int m) const { return pmax(U ? zl(k, m) : ld(gZl + k * M + m), T(ZL_FLOOR)); }
  // Q and R entries that the structure may make zero (callers skip those)
  HD static constexpr bool q_ent(int i, int j) { return !U || i == j; }
  HD static constexpr bool r_ent(int i, int j) { return !U || i == j; }

  // ---- small products that skip the structural zeros and ones --------------
  HD T Ax(int k, int i, const T x[NX]) const {            // (A_k x)_i
    T acc = T(0);
    for (int j = 0; j < NX; ++j) {
      if (a_unit(j)) { if (j == i) acc = acc + x[j]; }
      else acc = acc + A(k, i, j) * x[j];
    }
    return acc;
  }
  HD T Atv(int k, int i, const T v[NX]) const {           // (A_k' v)_i
    if (a_unit(i)) return v[i];
    T acc = T(0);
    for (int l = 0; l < NX; ++l) acc = acc + A(k, l, i) * v[l];
    return acc;
  }
  HD T Bu(int k, int i, const T u[NU]) const {            // (B_k u)_i
    T acc = T(0);
    for (int j = 0; j < NU; ++j) acc = acc + Bm(k, i, j) * u[j];
    return acc;
  }
  HD T Btv(int k, int j, const T v[NX]) const {           // (B_k' v)_j
    T acc = T(0);
    for (int l = 0; l < NX; ++l) acc = acc + Bm(k, l, j) * v[l];
    return acc;
  }
  HD T Cdot(int k, int m, const T x[NX]) const {          // (C_k x)_m
    T acc = T(0);
    for (int j = 0; j < NX; ++j)
      if (c_col(j)) acc = acc + C(k, m, j) * x[j];
    return acc;
  }
  HD T Pw(int k, int i, int j) const { return W[tri(i, j) * N1 + k]; }  // P (or Qbar) at slot k

  HD void load1(T* a, int width, int k, T* out) const {
    for (int i = 0; i < width; ++i) out[i] = a1(a, i, k);
  }
  HD void load0(T* a, int width, int k, T* out) const {
    for (int i = 0; i < width; ++i) out[i] = a0(a, i, k);
  }

  // ---- stage-local arithmetic ----------------------------------------------
  HD T sig(T l, T t) const {
    return pmin(pmax(l / pmax(t, T(T_FLOOR)), T(0)), p.sigma_max);
  }
  HD static T bc2(T t, T l, T prod, T mu_t) {
    return (mu_t - t * l - prod) / pmax(t, T(T_FLOOR));
  }
  HD static T ftb(T a, T v, T dv) {
    bool neg = dv < T(0);
    T denom = neg ? -dv : T(1);
    T ratio = neg ? v / denom : T(2);
    return pmin(a, ratio);
  }
  HD static T upd(T old, T a, T step, bool positive) {
    T v = old + a * step;
    return positive ? pmax(v, T(1e-30)) : v;
  }
  // Cholesky of the 2x2 Huu (H00, H10, H11) with reg and a 1e-30 floor
  HD void chol(T H00, T H10, T H11, T Lf[3]) const {
    T L00 = vsqrt(pmax(H00 + p.reg, T(1e-30)));
    T L10 = H10 / L00;
    T acc = H11 + p.reg;
    acc = acc - L10 * L10;
    Lf[0] = L00; Lf[1] = L10; Lf[2] = vsqrt(pmax(acc, T(1e-30)));
  }
  HD static void chol_solve(const T Lf[3], const T bb[NU], T x[NU]) {
    T y0 = bb[0] / Lf[0];
    T y1 = (bb[1] - Lf[1] * y0) / Lf[2];
    x[1] = y1 / Lf[2];
    x[0] = (y0 - Lf[1] * x[1]) / Lf[0];
  }

  // soft row m at stage k, given Cdx = (C dx_k)[m] of the current iterate and
  // CD = (C D)[m] of the direction
  HD void soft_delta(int k, int m, T Cdx, T CD, T b_h, T b_s,
                     T& ds, T& dth, T& dlh, T& dls) const {
    T t_h = a1(th, m, k), l_h = a1(lh, m, k), s = a1(ss, m, k), l_s = a1(ls, m, k);
    T sh = sig(l_h, t_h), sgs = sig(l_s, s);
    T Z = Zl(k, m);
    T zeta = Z + sh + sgs;
    T rh = h(k, m) + Cdx + s - t_h;
    T rs = Z * s + zl(k, m) - l_h - l_s;
    T rho = -rs + b_h + b_s - sh * rh;
    ds = (rho - sh * CD) / zeta;
    dth = CD + ds + rh;
    dlh = b_h - sh * dth;
    dls = b_s - sgs * ds;
  }
  // betas: -l for the predictor; for the corrector
  // (mu_t - t l - dt_aff dl_aff) / t with the stored affine products
  HD void beta_soft(int k, int m, bool corr, T mu_t, T& b_h, T& b_s) const {
    if (!corr) { b_h = -a1(lh, m, k); b_s = -a1(ls, m, k); return; }
    b_h = bc2(a1(th, m, k), a1(lh, m, k), a1(ph, m, k), mu_t);
    b_s = bc2(a1(ss, m, k), a1(ls, m, k), a1(ps, m, k), mu_t);
  }
  HD void box_delta(int k, int i, const T dxk[NX], T xi, T b_xl, T b_xu,
                    T& dtxl, T& dtxu, T& dlxl, T& dlxu) const {
    int d = idxbx(i);
    T rxl = dxk[d] - lbx(k, i) - a1(txl, i, k);
    T rxu = ubx(k, i) - dxk[d] - a1(txu, i, k);
    dtxl = xi + rxl;
    dtxu = -xi + rxu;
    dlxl = b_xl - sig(a1(lxl, i, k), a1(txl, i, k)) * dtxl;
    dlxu = b_xu - sig(a1(lxu, i, k), a1(txu, i, k)) * dtxu;
  }
  HD void beta_box(int k, int i, bool corr, T mu_t, T& b_xl, T& b_xu) const {
    if (!corr) { b_xl = -a1(lxl, i, k); b_xu = -a1(lxu, i, k); return; }
    b_xl = bc2(a1(txl, i, k), a1(lxl, i, k), a1(pxl, i, k), mu_t);
    b_xu = bc2(a1(txu, i, k), a1(lxu, i, k), a1(pxu, i, k), mu_t);
  }
  HD void u_delta(int k, int i, const T duk[NU], T ui, T b_ul, T b_uu,
                  T& dtul, T& dtuu, T& dlul, T& dluu) const {
    T rul = duk[i] - lbu(k, i) - a0(tul, i, k);
    T ruu = ubu(k, i) - duk[i] - a0(tuu, i, k);
    dtul = ui + rul;
    dtuu = -ui + ruu;
    dlul = b_ul - sig(a0(lul, i, k), a0(tul, i, k)) * dtul;
    dluu = b_uu - sig(a0(luu, i, k), a0(tuu, i, k)) * dtuu;
  }
  HD void beta_u(int k, int i, bool corr, T mu_t, T& b_ul, T& b_uu) const {
    if (!corr) { b_ul = -a0(lul, i, k); b_uu = -a0(luu, i, k); return; }
    b_ul = bc2(a0(tul, i, k), a0(lul, i, k), a0(pul, i, k), mu_t);
    b_uu = bc2(a0(tuu, i, k), a0(luu, i, k), a0(puu, i, k), mu_t);
  }

  // Every complementarity pair (t, dt, l, dl) of stage k along the direction
  // (xk, uk), with the predictor's betas (corr false) or the corrector's, and
  // the slot of the pair's affine product. Each group's deltas are computed
  // from the old values before f sees it, so f may update t and l in place.
  template <class F>
  HD void visit(int k, const T xk[NX], const T uk[NU], bool corr, T mu_t, F&& f) const {
    T dxk[NX];
    load1(dx, NX, k, dxk);
    for (int m = 0; m < M; ++m) {
      T Cdx = Cdot(k, m, dxk);
      T b_h, b_s, ds, dth, dlh, dls;
      beta_soft(k, m, corr, mu_t, b_h, b_s);
      soft_delta(k, m, Cdx, Cdot(k, m, xk), b_h, b_s, ds, dth, dlh, dls);
      f(&a1(th, m, k), dth, &a1(lh, m, k), dlh, &a1(ph, m, k));
      f(&a1(ss, m, k), ds, &a1(ls, m, k), dls, &a1(ps, m, k));
    }
    for (int i = 0; i < NBX; ++i) {
      T b_xl, b_xu, dtxl, dtxu, dlxl, dlxu;
      beta_box(k, i, corr, mu_t, b_xl, b_xu);
      box_delta(k, i, dxk, xk[idxbx(i)], b_xl, b_xu, dtxl, dtxu, dlxl, dlxu);
      f(&a1(txl, i, k), dtxl, &a1(lxl, i, k), dlxl, &a1(pxl, i, k));
      f(&a1(txu, i, k), dtxu, &a1(lxu, i, k), dlxu, &a1(pxu, i, k));
    }
    if (k < N) {
      T duk[NU];
      load0(du, NU, k, duk);
      for (int i = 0; i < NU; ++i) {
        T b_ul, b_uu, dtul, dtuu, dlul, dluu;
        beta_u(k, i, corr, mu_t, b_ul, b_uu);
        u_delta(k, i, duk, uk[i], b_ul, b_uu, dtul, dtuu, dlul, dluu);
        f(&a0(tul, i, k), dtul, &a0(lul, i, k), dlul, &a0(pul, i, k));
        f(&a0(tuu, i, k), dtuu, &a0(luu, i, k), dluu, &a0(puu, i, k));
      }
    }
  }

  // ---- stage-local residuals and right-hand sides ------------------------
  // u stationarity at stage k < N
  HD void res_u(int k, const T dxk[NX], const T duk[NU], T ru[NU]) const {
    T nuk[NX];
    load0(nu, NX, k, nuk);
    for (int i = 0; i < NU; ++i) {
      T Ru = T(0);
      for (int j = 0; j < NU; ++j)
        if (r_ent(i, j)) Ru = Ru + R(k, i, j) * duk[j];
      T acc = Ru + r(k, i);
      if (!U) {
        T Sx = T(0);
        for (int j = 0; j < NX; ++j) Sx = Sx + S(k, i, j) * dxk[j];
        acc = acc + Sx;
      }
      ru[i] = acc - Btv(k, i, nuk) - (a0(lul, i, k) - a0(luu, i, k));
    }
  }

  // x stationarity at stage k -> rx; returns the max |rx| over k >= 1
  HD T rx_at(int k, const T dxk[NX], T stat) const {
    T acc[NX];
    for (int i = 0; i < NX; ++i) {
      T v = T(0);
      for (int j = 0; j < NX; ++j)
        if (q_ent(i, j)) v = v + Q(k, i, j) * dxk[j];
      acc[i] = v + q(k, i);
    }
    if (k < N) {
      if (!U) {
        for (int i = 0; i < NX; ++i) {
          T v = T(0);
          for (int j = 0; j < NU; ++j) v = v + S(k, j, i) * a0(du, j, k);
          acc[i] = acc[i] + v;
        }
      }
      T nuk[NX];
      load0(nu, NX, k, nuk);
      for (int i = 0; i < NX; ++i) acc[i] = acc[i] - Atv(k, i, nuk);
    }
    if (k > 0)
      for (int i = 0; i < NX; ++i) acc[i] = acc[i] + a0(nu, i, k - 1);
    for (int i = 0; i < NBX; ++i)
      acc[idxbx(i)] = acc[idxbx(i)] - (a1(lxl, i, k) - a1(lxu, i, k));
    for (int i = 0; i < NX; ++i) {
      T v = acc[i];
      if (c_col(i) && M > 0) {
        T Ctl = T(0);
        for (int m = 0; m < M; ++m) Ctl = Ctl + C(k, m, i) * a1(lh, m, k);
        v = v - Ctl;
      }
      a1(rx, i, k) = v;
      if (k > 0) stat = pmax(stat, vabs(v));
    }
    return stat;
  }

  // Qbar(k) = Q + diag(sxl + sxu) on IDXBX + C' diag(seff) C, upper triangle -> W slot k
  HD void qbar_mat(int k) const {
    T Qk[NTRI_P];
    for (int i = 0; i < NX; ++i)
      for (int j = i; j < NX; ++j) Qk[tri(i, j)] = q_ent(i, j) ? Q(k, i, j) : T(0);
    for (int i = 0; i < NBX; ++i) {
      int d = idxbx(i);
      Qk[tri(d, d)] = Qk[tri(d, d)] + sig(a1(lxl, i, k), a1(txl, i, k))
                      + sig(a1(lxu, i, k), a1(txu, i, k));
    }
    for (int m = 0; m < M; ++m) {
      T sh = sig(a1(lh, m, k), a1(th, m, k));
      T sgs = sig(a1(ls, m, k), a1(ss, m, k));
      T Z = Zl(k, m);
      T seff = sh * (Z + sgs) / (Z + sh + sgs);
      T Cm[NX];
      for (int j = 0; j < NX; ++j) Cm[j] = c_col(j) ? C(k, m, j) : T(0);
      for (int i = 0; i < NX; ++i)
        for (int j = i; j < NX; ++j)
          if (c_col(i) && c_col(j)) Qk[tri(i, j)] = Qk[tri(i, j)] + (Cm[i] * seff) * Cm[j];
    }
    for (int t = 0; t < NTRI_P; ++t) W[t * N1 + k] = Qk[t];
  }

  // the Newton right-hand sides of stage k -> qv (and rv for k < N)
  HD void rhs(int k, bool corr, T mu_t) const {
    T dxk[NX];
    load1(dx, NX, k, dxk);
    T acc[NX];
    for (int i = 0; i < NX; ++i) acc[i] = a1(rx, i, k);
    for (int i = 0; i < NBX; ++i) {
      int d = idxbx(i);
      T b_xl, b_xu;
      beta_box(k, i, corr, mu_t, b_xl, b_xu);
      T rxl = dxk[d] - lbx(k, i) - a1(txl, i, k);
      T rxu = ubx(k, i) - dxk[d] - a1(txu, i, k);
      acc[d] = acc[d] - (b_xl - sig(a1(lxl, i, k), a1(txl, i, k)) * rxl)
                      + (b_xu - sig(a1(lxu, i, k), a1(txu, i, k)) * rxu);
    }
    T Ctb[NX] = {0, 0, 0, 0, 0};
    for (int m = 0; m < M; ++m) {
      T Cdx = Cdot(k, m, dxk);
      T b_h, b_s;
      beta_soft(k, m, corr, mu_t, b_h, b_s);
      T t_h = a1(th, m, k), l_h = a1(lh, m, k), s = a1(ss, m, k), l_s = a1(ls, m, k);
      T sh = sig(l_h, t_h), sgs = sig(l_s, s);
      T Z = Zl(k, m);
      T zeta = Z + sh + sgs;
      T rh = h(k, m) + Cdx + s - t_h;
      T rs = Z * s + zl(k, m) - l_h - l_s;
      T rho = -rs + b_h + b_s - sh * rh;
      T bh_hat = b_h - sh * rh - sh * rho / zeta;
      for (int i = 0; i < NX; ++i)
        if (c_col(i)) Ctb[i] = Ctb[i] + C(k, m, i) * bh_hat;
    }
    for (int i = 0; i < NX; ++i) a1(qv, i, k) = (c_col(i) && M > 0) ? acc[i] - Ctb[i] : acc[i];
    if (k == N) return;
    T duk[NU], ru[NU];
    load0(du, NU, k, duk);
    res_u(k, dxk, duk, ru);
    for (int i = 0; i < NU; ++i) {
      T b_ul, b_uu;
      beta_u(k, i, corr, mu_t, b_ul, b_uu);
      T rul = duk[i] - lbu(k, i) - a0(tul, i, k);
      T ruu = ubu(k, i) - duk[i] - a0(tuu, i, k);
      a0(rv, i, k) = ru[i] - (b_ul - sig(a0(lul, i, k), a0(tul, i, k)) * rul)
                           + (b_uu - sig(a0(luu, i, k), a0(tuu, i, k)) * ruu);
    }
  }

  // phase 0 of an iteration at stage k: mu and stat terms, rx, Qbar, the
  // dynamics gap d_k and the predictor's right-hand sides
  HD void setup_stage(int k, T& mu, T& stat) const {
    T dxk[NX];
    load1(dx, NX, k, dxk);
    for (int i = 0; i < NBX; ++i)
      mu = mu + a1(txl, i, k) * a1(lxl, i, k) + a1(txu, i, k) * a1(lxu, i, k);
    for (int m = 0; m < M; ++m)
      mu = mu + a1(th, m, k) * a1(lh, m, k) + a1(ss, m, k) * a1(ls, m, k);
    stat = rx_at(k, dxk, stat);
    if (k < N) {
      T duk[NU], ru[NU];
      load0(du, NU, k, duk);
      for (int i = 0; i < NU; ++i)
        mu = mu + a0(tul, i, k) * a0(lul, i, k) + a0(tuu, i, k) * a0(luu, i, k);
      res_u(k, dxk, duk, ru);
      for (int i = 0; i < NU; ++i) stat = pmax(stat, vabs(ru[i]));
      // Rbar = R + diag(sul + suu): the factorization's Huu before B' P B
      for (int e = 0; e < 3; ++e) {
        int i = e == 0 ? 0 : 1, j = e == 2 ? 1 : 0;
        T Rv = r_ent(i, j) ? R(k, i, j) : T(0);
        if (i == j)
          Rv = Rv + (sig(a0(lul, i, k), a0(tul, i, k)) + sig(a0(luu, i, k), a0(tuu, i, k)));
        a0(rb, e, k) = Rv;
      }
      // d_k = -(dx_{k+1} - A dx_k - B du_k - c_k)
      for (int i = 0; i < NX; ++i)
        a0(dd, i, k) = -(a1(dx, i, k + 1) - Ax(k, i, dxk) - Bu(k, i, duk) - c(k, i));
    }
    qbar_mat(k);
    rhs(k, false, T(0));
  }

  // ---- stage-serial recursions, lanes over matrix entries ---------------
  // backward Riccati factorization: W slot k holds Qbar_k on entry and P_k
  // on exit (so P_{k+1}, the P of stage k's solves, stays at slot k + 1).
  // Two tile syncs per stage: every lane forms P B, Huu and its Cholesky
  // factor itself; lane j forms column j of P A, of Hux and of K; then the
  // lanes share the 15 entries of the symmetrized P_k.
  HD void factorize() const {
    T* PA = scr;            // [5][5], columns that are not unit columns of A
    T* Hux = scr + 25;      // [2][5]
    for (int k = N - 1; k >= 0; --k) {
      T Pm[NX][NX];
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) Pm[i][j] = Pw(k + 1, i, j);
      T PBc[NU][NX];        // columns of P B
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NU; ++j) PBc[j][i] = Btv(k, j, Pm[i]);
      T Lf[3];
      chol(a0(rb, 0, k) + Btv(k, 0, PBc[0]), a0(rb, 1, k) + Btv(k, 1, PBc[0]),
           a0(rb, 2, k) + Btv(k, 1, PBc[1]), Lf);
      if (tm.rank() == 0)
        for (int t = 0; t < 3; ++t) a0(LL, t, k) = Lf[t];
      for (int j = tm.rank(); j < NX; j += tm.size()) {
        T col[NX];
        for (int l = 0; l < NX; ++l) {
          col[l] = a_unit(j) ? Pm[l][j] : Atv(k, j, Pm[l]);        // (P A)_{lj}
          if (!a_unit(j)) PA[l * NX + j] = col[l];
        }
        T hx[NU], sol[NU];
        for (int i = 0; i < NU; ++i) {
          T v = Btv(k, i, col);
          hx[i] = U ? v : Ss(k, i, j) + v;
          Hux[i * NX + j] = hx[i];
        }
        chol_solve(Lf, hx, sol);
        for (int i = 0; i < NU; ++i) a0(KK, i * NX + j, k) = -sol[i];
      }
      tm.sync();
      for (int t = tm.rank(); t < NTRI_P; t += tm.size()) {
        int i = 0, rem = t;
        while (rem >= NX - i) { rem -= NX - i; ++i; }
        int j = i + rem;
        T Pij[2];
        for (int s2 = 0; s2 < 2; ++s2) {
          int a = s2 ? j : i, c2 = s2 ? i : j;        // entry (a, c2)
          T col[NX];
          for (int l = 0; l < NX; ++l) col[l] = a_unit(c2) ? Pw(k + 1, l, c2) : PA[l * NX + c2];
          T atpa = Atv(k, a, col);
          T hk = T(0);
          for (int l = 0; l < NU; ++l) hk = hk + Hux[l * NX + a] * a0(KK, l * NX + c2, k);
          Pij[s2] = W[t * N1 + k] + (atpa + hk);
        }
        W[t * N1 + k] = T(0.5) * (Pij[0] + Pij[1]);
      }
      tm.sync();
    }
  }

  // back-substitution: qv slot k holds the right-hand side qbar_k on entry and
  // the costate p_k on exit; rv holds rbar; kf gets the feedforward
  HD void backward() const {
    for (int k = N - 1; k >= 0; --k) {
      T* buf = scr + 35 + (k & 1) * NX;     // P_{k+1} d_k + p_{k+1}
      for (int i = tm.rank(); i < NX; i += tm.size()) {
        T v = T(0);
        for (int j = 0; j < NX; ++j) v = v + Pw(k + 1, i, j) * a0(dd, j, k);
        buf[i] = v + a1(qv, i, k + 1);
      }
      tm.sync();
      T pd[NX], m[NU], sol[NU], Lf[3];
      for (int i = 0; i < NX; ++i) pd[i] = buf[i];
      for (int j = 0; j < NU; ++j) m[j] = a0(rv, j, k) + Btv(k, j, pd);
      for (int t = 0; t < 3; ++t) Lf[t] = a0(LL, t, k);
      for (int i = tm.rank(); i < NX; i += tm.size()) {   // the chain: p_k
        T ktm = T(0);
        for (int j = 0; j < NU; ++j) ktm = ktm + a0(KK, j * NX + i, k) * m[j];
        a1(qv, i, k) = a1(qv, i, k) + (Atv(k, i, pd) + ktm);
      }
      chol_solve(Lf, m, sol);                            // off the chain: kff_k
      for (int j = tm.rank(); j < NU; j += tm.size()) a0(kf, j, k) = -sol[j];
    }
    tm.sync();
  }

  // forward rollout u_k = K_k x_k + kff_k, x_{k+1} = A x_k + B u_k + d_k
  HD void rollout(T* xo, T* uo) const {
    for (int i = tm.rank(); i < NX; i += tm.size()) a1(xo, i, 0) = T(0);
    tm.sync();
    for (int k = 0; k < N; ++k) {
      T x[NX], u[NU];
      load1(xo, NX, k, x);
      for (int j = 0; j < NU; ++j) {
        T v = T(0);
        for (int l = 0; l < NX; ++l) v = v + a0(KK, j * NX + l, k) * x[l];
        u[j] = v + a0(kf, j, k);
      }
      for (int j = tm.rank(); j < NU; j += tm.size()) a0(uo, j, k) = u[j];
      for (int i = tm.rank(); i < NX; i += tm.size())
        a1(xo, i, k + 1) = Ax(k, i, x) + Bu(k, i, u) + a0(dd, i, k);
      tm.sync();
    }
  }

  // ---- the corrector's costate term at stage k < N: P_{k+1} dx_{k+1} + p_{k+1}
  HD T pxn(int k, int i) const {
    T v = T(0);
    for (int j = 0; j < NX; ++j) v = v + Pw(k + 1, i, j) * a1(cx, j, k + 1);
    return v + a1(qv, i, k + 1);
  }

  // ---- the whole solve ---------------------------------------------------
  HD void init() const {
    const T t_min = T(0.1), mu0 = T(1);
    const T* gA = p.A + (size_t)b * N * NX * NX;
    const T* gB = p.Bm + (size_t)b * N * NX * NU;
    for (int e = tm.rank(); e < N * NX * NA; e += tm.size()) {
      int k = e % N, f = e / N, i = f / NA, jc = f % NA;
      sA[e] = ld(gA + (k * NX + i) * NX + (U ? jc + 2 : jc));
    }
    for (int e = tm.rank(); e < N * NX * NU; e += tm.size()) {
      sB[e] = ld(gB + (e % N) * NX * NU + e / N);
      if (!U) sS[e] = ld(gS + (e % N) * NU * NX + e / N);
    }
    for (int i = tm.rank(); i < NX; i += tm.size())
      a1(dx, i, 0) = ld(p.dx0 + (size_t)b * NX + i);
    tm.sync();
    for (int k = 0; k < N; ++k) {
      T x[NX];
      load1(dx, NX, k, x);
      for (int i = tm.rank(); i < NX; i += tm.size()) a1(dx, i, k + 1) = Ax(k, i, x) + c(k, i);
      tm.sync();
    }
    for (int k = tm.rank(); k <= N; k += tm.size()) {
      T dxk[NX];
      load1(dx, NX, k, dxk);
      for (int m = 0; m < M; ++m) {
        T g = h(k, m) + Cdot(k, m, dxk);
        T s0 = pmax(t_min, t_min - g);
        a1(ss, m, k) = s0;
        T t = pmax(g + s0, t_min);
        a1(th, m, k) = t;
        a1(lh, m, k) = mu0 / t;
        a1(ls, m, k) = mu0 / s0;
      }
      for (int i = 0; i < NBX; ++i) {
        T t = pmax(dxk[idxbx(i)] - lbx(k, i), t_min);
        a1(txl, i, k) = t;
        a1(lxl, i, k) = mu0 / t;
        t = pmax(ubx(k, i) - dxk[idxbx(i)], t_min);
        a1(txu, i, k) = t;
        a1(lxu, i, k) = mu0 / t;
      }
      if (k == N) continue;
      for (int i = 0; i < NU; ++i) {
        a0(du, i, k) = T(0);
        T t = pmax(-lbu(k, i), t_min);
        a0(tul, i, k) = t;
        a0(lul, i, k) = mu0 / t;
        t = pmax(ubu(k, i), t_min);
        a0(tuu, i, k) = t;
        a0(luu, i, k) = mu0 / t;
      }
      for (int i = 0; i < NX; ++i) a0(nu, i, k) = T(0);
    }
    tm.sync();
  }

  // ran: the iterations the tile has run in this launch before this row;
  // returns them with this row's
  HD int solve(int ran) const {
    init();
    const T n_pairs = T(2 * N * NU + 2 * (N + 1) * NBX + 2 * (N + 1) * M);
    T mu = T(0), stat = T(0);
    int used = 0;           // iterations that updated this row
    for (int it = 0; it < p.iters; ++it) {
      // residuals of the pre-update iterate, Qbar, d, predictor right-hand sides
      mu = T(0);
      stat = T(0);
      for (int k = tm.rank(); k <= N; k += tm.size()) setup_stage(k, mu, stat);
      mu = tm.sum(mu) / n_pairs;
      stat = tm.max(stat);
      tm.sync();

      factorize();

      // predictor
      backward();
      rollout(cx, cu);
      T ap_raw = T(2), ad_raw = T(2), S1 = T(0), S2 = T(0), S3 = T(0);
      for (int k = tm.rank(); k <= N; k += tm.size()) {
        T xk[NX], uk[NU] = {0, 0};
        load1(cx, NX, k, xk);
        if (k < N) load0(cu, NU, k, uk);
        visit(k, xk, uk, false, T(0), [&](T* t, T dt, T* l, T dl, T* prod) {
          ap_raw = ftb(ap_raw, *t, dt);
          ad_raw = ftb(ad_raw, *l, dl);
          S1 = S1 + dt * *l;
          S2 = S2 + *t * dl;
          *prod = dt * dl;
          S3 = S3 + *prod;
        });
      }
      T ap_aff = pmin(tm.min(ap_raw), T(1)), ad_aff = pmin(tm.min(ad_raw), T(1));
      S1 = tm.sum(S1);
      S2 = tm.sum(S2);
      S3 = tm.sum(S3);
      T mu_aff = (mu * n_pairs + ap_aff * S1 + ad_aff * S2 + ap_aff * ad_aff * S3) / n_pairs;
      T ratio = mu_aff / pmax(mu, T(T_FLOOR));
      T sig_c = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
      T mu_t = sig_c * mu;

      // corrector
      for (int k = tm.rank(); k <= N; k += tm.size()) rhs(k, true, mu_t);
      tm.sync();
      backward();
      rollout(cx, cu);
      ap_raw = T(2);
      ad_raw = T(2);
      T chk = T(0);
      for (int k = tm.rank(); k <= N; k += tm.size()) {
        T xk[NX], uk[NU] = {0, 0};
        load1(cx, NX, k, xk);
        if (k < N) load0(cu, NU, k, uk);
        visit(k, xk, uk, true, mu_t, [&](T* t, T dt, T* l, T dl, T*) {
          ap_raw = ftb(ap_raw, *t, dt);
          ad_raw = ftb(ad_raw, *l, dl);
          chk = chk + dt + dl;
        });
        for (int i = 0; i < NX; ++i) chk = chk + xk[i];
        if (k < N) {
          for (int i = 0; i < NU; ++i) chk = chk + uk[i];
          for (int i = 0; i < NX; ++i) chk = chk + pxn(k, i);
        }
      }
      chk = tm.sum(chk);
      T a_p = pmin(p.tau * tm.min(ap_raw), T(1));
      T a_d = pmin(p.tau * tm.min(ad_raw), T(1));

      bool converged = (mu < p.tol) && (stat < p.stat_tol);
      bool finite = (vabs(chk) < T(3.0e38)) && (chk == chk) && (a_p == a_p) && (a_d == a_d);
      // a frozen row keeps its iterate, so every later iteration would give
      // the same mu and stat: the whole tile leaves the loop
      if (converged || !finite) break;
      ++used;
      for (int k = tm.rank(); k <= N; k += tm.size()) {
        T xk[NX], uk[NU] = {0, 0}, pn[NX];
        load1(cx, NX, k, xk);
        if (k < N) {
          load0(cu, NU, k, uk);
          for (int i = 0; i < NX; ++i) pn[i] = pxn(k, i);
        }
        visit(k, xk, uk, true, mu_t, [&](T* t, T dt, T* l, T dl, T*) {
          *t = upd(*t, a_p, dt, true);
          *l = upd(*l, a_d, dl, true);
        });
        for (int i = 0; i < NX; ++i) a1(dx, i, k) = upd(a1(dx, i, k), a_p, xk[i], false);
        if (k < N) {
          for (int i = 0; i < NU; ++i) a0(du, i, k) = upd(a0(du, i, k), a_p, uk[i], false);
          for (int i = 0; i < NX; ++i) a0(nu, i, k) = upd(a0(nu, i, k), a_d, -pn[i], false);
        }
      }
      tm.sync();
    }
    ran += used < p.iters ? used + 1 : used;     // the iteration that froze it too
    // outputs, batch-first; mu / stat of the last iteration's pre-update iterate
    for (int e = tm.rank(); e < N1 * NX; e += tm.size())
      p.dx[(size_t)b * N1 * NX + e] = a1(dx, e % NX, e / NX);
    for (int e = tm.rank(); e < N * NU; e += tm.size())
      p.du[(size_t)b * N * NU + e] = a0(du, e % NU, e / NU);
    for (int e = tm.rank(); e < N1 * M; e += tm.size())
      p.s[(size_t)b * N1 * M + e] = a1(ss, e % M, e / M);
    if (tm.rank() == 0) {
      p.mu[b] = mu;
      p.stat[b] = stat;
      if (p.iters_used != nullptr) p.iters_used[b] = used;
      if (p.end != nullptr) p.end[b] = ran;
    }
    tm.sync();              // the tile's arrays are free for its next scenario
    return ran;
  }
};

// A row the caller marks in skip (a done row of the closed loop, whose
// answer it discards) gets no init and no iteration: its tile writes zeros
// for dx, du, s, mu and stat, 0 for iters_used and the tile's count so far
// for end, counts the row in skipped, and takes its next row.
template <typename T>
HD bool skips(const Params<T>& p, int b) { return p.skip != nullptr && p.skip[b]; }

template <typename T, class TM>
HD void skip_row(const Params<T>& p, int b, TM tm, int ran) {
  int N = p.N, N1 = p.N + 1, M = p.M;
  for (int e = tm.rank(); e < N1 * NX; e += tm.size()) p.dx[(size_t)b * N1 * NX + e] = T(0);
  for (int e = tm.rank(); e < N * NU; e += tm.size()) p.du[(size_t)b * N * NU + e] = T(0);
  for (int e = tm.rank(); e < N1 * M; e += tm.size()) p.s[(size_t)b * N1 * M + e] = T(0);
  if (tm.rank() == 0) {
    p.mu[b] = T(0);
    p.stat[b] = T(0);
    if (p.iters_used != nullptr) p.iters_used[b] = 0;
    if (p.end != nullptr) p.end[b] = ran;
    if (p.skipped != nullptr) {
#ifdef __CUDA_ARCH__
      atomicAdd(p.skipped, 1);
#else
      ++*p.skipped;
#endif
    }
  }
}

}  // namespace ipk

#ifndef __CUDACC__

namespace ipk {
// The same body on the host: one lane per scenario, scenario after scenario,
// with its shared-memory arrays in a vector (NaN-filled, so a read of an
// entry that was never written shows up in the result).
template <typename T>
void host_solve(const Params<T>& p, int structure) {
  std::vector<T> sm(smem_floats(p.N, p.M, structure == 1), (T)NAN);
  int ran = 0;
  for (int b = 0; b < p.B; ++b) {
    if (skips(p, b)) skip_row(p, b, HostTeam{}, ran);
    else if (structure == 1) ran = Solver<T, Unicycle, HostTeam>(p, b, sm.data(), HostTeam{}).solve(ran);
    else ran = Solver<T, Generic, HostTeam>(p, b, sm.data(), HostTeam{}).solve(ran);
  }
}
}  // namespace ipk

#else

// One warp per block, two tiles of one scenario each at a time. A tile
// solves the scenario of its own index, then takes scenario tiles + n from
// the n-th ticket of `next` (zeroed before the launch) until they run out.
// A scenario marked in p.skip costs its tile a few stores (skip_row); every
// lane reads the same mask byte, so the tile stays together.
// Each tile's arrays are in dynamic shared memory (ON_CHIP) or in its slice
// of the device-memory workspace `work`. Where they live is a template
// parameter: a pointer that may be either makes every access a generic one,
// which cost 77 more registers per thread and a third more time on the card
// (PERF.md).
template <class ST, bool ON_CHIP>
__global__ void __launch_bounds__(ipk::kWarp)
ip_solve_kernel(ipk::Params<float> p, int per, float* work, int* next) {
  extern __shared__ float smem[];
  int tile = threadIdx.x / ipk::kTeam;
  int tiles = gridDim.x * ipk::kPerBlock;
  int own = blockIdx.x * ipk::kPerBlock + tile;
  float* arrays = ON_CHIP ? smem + (size_t)tile * per : work + (size_t)own * per;
  ipk::DevTeam tm{(int)(threadIdx.x % ipk::kTeam)};
  int ran = 0;                              // iterations this tile has run
  for (int b = own; b < p.B;) {             // the whole tile moves together
    if (ipk::skips(p, b)) ipk::skip_row(p, b, tm, ran);
    else ran = ipk::Solver<float, ST, ipk::DevTeam>(p, b, arrays, tm).solve(ran);
    b = tiles + tm.bcast(tm.rank() == 0 ? atomicAdd(next, 1) : 0);
  }
}

namespace {

// How launches of B scenarios run on the current device, into out[5]: the
// grid's blocks; the dynamic shared memory of a block; the floats of one
// scenario's arrays; the floats of device-memory workspace; the scenarios
// resident per SM that the occupancy API reports. The arrays live in shared
// memory when a block can hold two scenarios' worth (workspace 0), else in
// the workspace, one slice per tile (shared memory 0). The grid: with R
// blocks resident per SM, min(ceil(B / 2), SMs R) blocks, so every tile is
// resident at once and none is launched without a scenario. The on-chip
// kernel's shared-memory limit on the current device is raised to what the
// plan needs, never lowered, so a plan stays valid once made: the wrapper
// makes it once per device, structure, B, N and M.
template <class ST>
cudaError_t plan(int B, int N, int M, long long* out) {
  long long f = ipk::smem_floats(N, M, ST::kUni);
  if (f > (1LL << 30)) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  size_t chip = (size_t)f * sizeof(float) * ipk::kPerBlock;
  bool on_chip = chip <= (size_t)optin;
  size_t bytes = on_chip ? chip : 0;
  if (on_chip) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, ip_solve_kernel<ST, true>);
    if (e == cudaSuccess && (size_t)fa.maxDynamicSharedSizeBytes < bytes)
      e = cudaFuncSetAttribute(ip_solve_kernel<ST, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (e == cudaSuccess)
    e = on_chip ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, ip_solve_kernel<ST, true>, ipk::kWarp, bytes)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, ip_solve_kernel<ST, false>, ipk::kWarp, 0);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (B + ipk::kPerBlock - 1) / ipk::kPerBlock;
  if (blocks > (long long)sms * resident) blocks = (long long)sms * resident;
  out[0] = blocks;
  out[1] = (long long)bytes;
  out[2] = f;
  out[3] = on_chip ? 0 : blocks * ipk::kPerBlock * f;
  out[4] = resident * ipk::kPerBlock;
  return cudaSuccess;
}

// A launch on a plan: the on-chip instantiation when work is null, else the
// device-memory one. cudaErrorInvalidValue when there is no counter, or no
// workspace and less shared memory than two scenarios' arrays. The counter
// (and p.skipped, where set) is zeroed on the launch's stream, so launches
// on other streams keep theirs apart and the launch can be captured in a
// CUDA graph.
template <class ST>
int launch(const ipk::Params<float>& p, long long blocks, long long bytes, float* work,
           int* next, cudaStream_t stream) {
  int per = (int)ipk::smem_floats(p.N, p.M, ST::kUni);
  long long chip = (long long)per * (long long)sizeof(float) * ipk::kPerBlock;
  if (next == nullptr || (work == nullptr && bytes < chip)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (e == cudaSuccess && p.skipped != nullptr)
    e = cudaMemsetAsync(p.skipped, 0, sizeof(int), stream);
  if (e != cudaSuccess) return (int)e;
  if (work == nullptr)
    ip_solve_kernel<ST, true><<<(unsigned)blocks, ipk::kWarp, (size_t)bytes, stream>>>(
        p, per, nullptr, next);
  else
    ip_solve_kernel<ST, false><<<(unsigned)blocks, ipk::kWarp, (size_t)bytes, stream>>>(
        p, per, work, next);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a launch of B scenarios, see plan(): out[0] blocks, out[1]
// shared-memory bytes per block, out[2] floats per scenario, out[3]
// workspace floats, out[4] scenarios resident per SM. structure: 0 generic,
// 1 unicycle. Returns a cudaError_t.
extern "C" int ip_solve_plan(int structure, int B, int N, int M, long long* out) {
  if (structure == 0) return (int)plan<ipk::Generic>(B, N, M, out);
  if (structure == 1) return (int)plan<ipk::Unicycle>(B, N, M, out);
  return (int)cudaErrorInvalidValue;
}

// blocks, bytes: out[0] and out[1] of ip_solve_plan for this structure, B,
// N and M; work: device memory of its out[3] floats, or null when that is 0.
// next: one int of device memory for the hand-out counter, the launch's own.
// skip: B bools, or null (no row skipped); skipped: one int, or null.
// end and iters_used: B ints each (Params), or null.
extern "C" int ip_solve_f32(
    const float* A, const float* Bm, const float* c, const float* dx0,
    const float* Q, const float* q, const float* R, const float* r, const float* S,
    const float* lbu, const float* ubu, const float* lbx, const float* ubx,
    const float* C, const float* h, const float* zl, const float* Zl,
    float* dx, float* du, float* s, float* mu, float* stat,
    int B, int N, int M, int iters,
    float reg, float tau, float tol, float stat_tol, float sigma_max,
    int structure, long long blocks, long long bytes, float* work, int* next,
    const bool* skip, int* skipped, int* end, int* iters_used, void* stream) {
  ipk::Params<float> p{A, Bm, c, dx0, Q, q, R, r, S, lbu, ubu, lbx, ubx, C, h, zl, Zl,
                       dx, du, s, mu, stat, B, N, M, iters,
                       reg, tau, tol, stat_tol, sigma_max, iters_used, end, skip, skipped};
  cudaStream_t st = (cudaStream_t)stream;
  if (structure == 0) return launch<ipk::Generic>(p, blocks, bytes, work, next, st);
  if (structure == 1) return launch<ipk::Unicycle>(p, blocks, bytes, work, next, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory that one block's two scenarios need on chip.
extern "C" long long ip_solve_smem_bytes(int structure, int N, int M) {
  return ipk::smem_floats(N, M, structure == 1) * (long long)sizeof(float) * ipk::kPerBlock;
}

extern "C" const char* ip_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif
