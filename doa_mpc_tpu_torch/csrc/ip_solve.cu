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
//
// Design (first Hopper version, simple and right before fast):
// - One CUDA thread per scenario. nx = 5, nu = 2, nbx = 4 are compile-time
//   constants; N, M and the iteration count are runtime ints. No per-M local
//   arrays: every loop over the M soft rows consumes its values at once.
// - Every stage array (QP fields, IP state, work arrays) lives in device
//   memory batch-last, [stage][field][B], so the 32 threads of a warp touch
//   32 consecutive floats: the same layout the TPU kernel uses for its lanes,
//   coalesced here. The wrapper (ops/ip_fused.py) allocates outputs and the
//   work buffer; the kernel allocates nothing.
// - What bounds it on the H100: latency of the stage-serial dependency chains
//   (Riccati factorization, two back-substitutions and three forward
//   rollouts per iteration), not bytes. At N = 20, M = 5 each scenario
//   carries 7,444 B of IP state and work arrays (work_floats below),
//   11,372 B of dense QP data and 1,008 B of outputs: 81.2 MB at B = 4096,
//   more than the 50 MB L2, and every iteration re-reads it, so the first
//   limiter after latency is L2 misses.
// - One thread per scenario puts B = 4096 on only 32 blocks of 128 threads,
//   which leaves 100 of 132 SMs idle; blocks of 32 threads give 128 blocks,
//   so nearly every SM gets work (kThreadsPerBlock below). On an H100 at
//   B = 4096, 32 threads per block measured fastest of 32, 64, 128 and 256
//   (about 10% ahead of 256; PERF.md).
// - The QP data is dense (the generic structure); specializing to the
//   unicycle structure (diagonal Q/R, S = 0, C's x/y columns, identity A
//   columns) is later performance work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: the 1e-30 floors, the chk == chk NaN test and the 3e38
// finite bound need IEEE division, sqrt and comparisons.
//
// The solve body is __host__ __device__ and has no CUDA dependency outside
// the launcher, so the same file also compiles as plain C++ (float or double)
// for host-side tests of the arithmetic.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define HD inline
#endif

#include <stddef.h>

namespace ipk {

constexpr int NX = 5;
constexpr int NU = 2;
constexpr int NBX = 4;
constexpr int NTRI_P = NX * (NX + 1) / 2;   // upper triangle of P
constexpr int NTRI_U = NU * (NU + 1) / 2;   // lower Cholesky factor of Huu
constexpr int kThreadsPerBlock = 32;

HD int idxbx(int i) { return i < 2 ? i : i + 1; }   // IDXBX = (0, 1, 3, 4)
HD int tri(int i, int j) { return i * (2 * NX - i + 1) / 2 + (j - i); }  // i <= j

HD float vsqrt(float x) { return sqrtf(x); }
HD double vsqrt(double x) { return sqrt(x); }
HD float vabs(float x) { return fabsf(x); }
HD double vabs(double x) { return fabs(x); }
// NaN-propagating max/min (jnp.maximum / jnp.minimum semantics)
template <typename T> HD T pmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T> HD T pmin(T a, T b) { return (a != a || a < b) ? a : b; }

template <typename T>
struct Params {
  const T *A, *Bm, *c, *dx0, *Q, *q, *R, *r, *S, *lbu, *ubu, *lbx, *ubx,
      *C, *h, *zl, *Zl;
  T *dx, *du, *s, *mu, *stat, *work;
  int B, N, M, iters;
  T reg, tau, tol, stat_tol, sigma_max;
};

// Floats of work buffer per scenario (IP state beyond dx/du/s + work arrays).
HD long long work_floats(int N, int M) {
  return (long long)N * (NX + 4 * NU + NTRI_P + NU * NX + NTRI_U + NU + NX + NU)
       + (long long)(N + 1) * (4 * NBX + 3 * M + 2 * NX);
}

template <typename T>
struct Solver {
  static constexpr double T_FLOOR = 1e-12;
  static constexpr double ZL_FLOOR = 1e-6;

  const Params<T>& p;
  int b, N, M, nb;
  // work buffer sub-arrays, each [stages][width][B]
  T *nu, *tul, *lul, *tuu, *luu, *txl, *lxl, *txu, *lxu, *th, *lh, *ls;
  T *P, *K, *L, *kff, *pn, *rx, *ax, *au;

  HD Solver(const Params<T>& p_, int b_) : p(p_), b(b_), N(p_.N), M(p_.M), nb(p_.B) {
    T* w = p.work;
    auto take = [&](int stages, int width) {
      T* out = w;
      w += (size_t)stages * width * nb;
      return out;
    };
    nu = take(N, NX);
    tul = take(N, NU); lul = take(N, NU); tuu = take(N, NU); luu = take(N, NU);
    txl = take(N + 1, NBX); lxl = take(N + 1, NBX);
    txu = take(N + 1, NBX); lxu = take(N + 1, NBX);
    th = take(N + 1, M); lh = take(N + 1, M); ls = take(N + 1, M);
    P = take(N, NTRI_P); K = take(N, NU * NX); L = take(N, NTRI_U);
    kff = take(N, NU); pn = take(N, NX);
    rx = take(N + 1, NX); ax = take(N + 1, NX); au = take(N, NU);
  }

  HD size_t ix(int w, int k, int f) const { return ((size_t)k * w + f) * nb + b; }
  // QP data
  HD T A(int k, int i, int j) const { return p.A[ix(NX * NX, k, i * NX + j)]; }
  HD T Bm(int k, int i, int j) const { return p.Bm[ix(NX * NU, k, i * NU + j)]; }
  HD T c(int k, int i) const { return p.c[ix(NX, k, i)]; }
  HD T Q(int k, int i, int j) const { return p.Q[ix(NX * NX, k, i * NX + j)]; }
  HD T q(int k, int i) const { return p.q[ix(NX, k, i)]; }
  HD T R(int k, int i, int j) const { return p.R[ix(NU * NU, k, i * NU + j)]; }
  HD T r(int k, int i) const { return p.r[ix(NU, k, i)]; }
  HD T S(int k, int i, int j) const { return p.S[ix(NU * NX, k, i * NX + j)]; }
  HD T lbu(int k, int i) const { return p.lbu[ix(NU, k, i)]; }
  HD T ubu(int k, int i) const { return p.ubu[ix(NU, k, i)]; }
  HD T lbx(int k, int i) const { return p.lbx[ix(NBX, k, i)]; }
  HD T ubx(int k, int i) const { return p.ubx[ix(NBX, k, i)]; }
  HD T C(int k, int m, int j) const { return p.C[ix(M * NX, k, m * NX + j)]; }
  HD T h(int k, int m) const { return p.h[ix(M, k, m)]; }
  HD T zl(int k, int m) const { return p.zl[ix(M, k, m)]; }
  HD T Zl(int k, int m) const { return pmax(p.Zl[ix(M, k, m)], T(ZL_FLOOR)); }
  // state
  HD T& DX(int k, int i) const { return p.dx[ix(NX, k, i)]; }
  HD T& DU(int k, int i) const { return p.du[ix(NU, k, i)]; }
  HD T& SS(int k, int m) const { return p.s[ix(M, k, m)]; }
  HD T& NUd(int k, int i) const { return nu[ix(NX, k, i)]; }
  HD T& TUL(int k, int i) const { return tul[ix(NU, k, i)]; }
  HD T& LUL(int k, int i) const { return lul[ix(NU, k, i)]; }
  HD T& TUU(int k, int i) const { return tuu[ix(NU, k, i)]; }
  HD T& LUU(int k, int i) const { return luu[ix(NU, k, i)]; }
  HD T& TXL(int k, int i) const { return txl[ix(NBX, k, i)]; }
  HD T& LXL(int k, int i) const { return lxl[ix(NBX, k, i)]; }
  HD T& TXU(int k, int i) const { return txu[ix(NBX, k, i)]; }
  HD T& LXU(int k, int i) const { return lxu[ix(NBX, k, i)]; }
  HD T& TH(int k, int m) const { return th[ix(M, k, m)]; }
  HD T& LH(int k, int m) const { return lh[ix(M, k, m)]; }
  HD T& LS(int k, int m) const { return ls[ix(M, k, m)]; }
  HD T& Pu(int k, int t) const { return P[ix(NTRI_P, k, t)]; }
  HD T& KK(int k, int i, int j) const { return K[ix(NU * NX, k, i * NX + j)]; }
  HD T& LL(int k, int t) const { return L[ix(NTRI_U, k, t)]; }
  HD T& KFF(int k, int i) const { return kff[ix(NU, k, i)]; }
  HD T& PN(int k, int i) const { return pn[ix(NX, k, i)]; }
  HD T& RX(int k, int i) const { return rx[ix(NX, k, i)]; }
  HD T& AX(int k, int i) const { return ax[ix(NX, k, i)]; }
  HD T& AU(int k, int i) const { return au[ix(NU, k, i)]; }

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

  HD void load_dx(int k, T x[NX]) const { for (int i = 0; i < NX; ++i) x[i] = DX(k, i); }
  HD void load_du(int k, T u[NU]) const { for (int i = 0; i < NU; ++i) u[i] = DU(k, i); }
  HD void load_P(int k, T Pk[NX][NX]) const {
    for (int i = 0; i < NX; ++i)
      for (int j = i; j < NX; ++j) { T v = Pu(k, tri(i, j)); Pk[i][j] = v; Pk[j][i] = v; }
  }
  HD T Cdot(int k, int m, const T x[NX]) const {
    T acc = C(k, m, 0) * x[0];
    for (int j = 1; j < NX; ++j) acc = acc + C(k, m, j) * x[j];
    return acc;
  }

  // ---- Cholesky of the 2x2 Huu with reg and a 1e-30 floor ---------------
  HD void chol(const T H[NU][NU], T Lf[NTRI_U]) const {
    T acc = H[0][0] + p.reg;
    T L00 = vsqrt(pmax(acc, T(1e-30)));
    T L10 = H[1][0] / L00;
    acc = H[1][1] + p.reg;
    acc = acc - L10 * L10;
    T L11 = vsqrt(pmax(acc, T(1e-30)));
    Lf[0] = L00; Lf[1] = L10; Lf[2] = L11;
  }
  HD static void chol_solve(const T Lf[NTRI_U], const T bb[NU], T x[NU]) {
    T y0 = bb[0] / Lf[0];
    T y1 = (bb[1] - Lf[1] * y0) / Lf[2];
    x[1] = y1 / Lf[2];
    x[0] = (y0 - Lf[1] * x[1]) / Lf[0];
  }

  // ---- stage-local residual pieces ---------------------------------------
  HD void res_u(int k, const T dxk[NX], const T duk[NU], T ru[NU]) const {
    for (int i = 0; i < NU; ++i) {
      T Ru = R(k, i, 0) * duk[0];
      for (int j = 1; j < NU; ++j) Ru = Ru + R(k, i, j) * duk[j];
      T Sx = S(k, i, 0) * dxk[0];
      for (int j = 1; j < NX; ++j) Sx = Sx + S(k, i, j) * dxk[j];
      T acc = Ru + r(k, i) + Sx;
      T Btn = Bm(k, 0, i) * NUd(k, 0);
      for (int j = 1; j < NX; ++j) Btn = Btn + Bm(k, j, i) * NUd(k, j);
      ru[i] = acc - Btn - (LUL(k, i) - LUU(k, i));
    }
  }

  // stationarity wrt x_k -> RX; returns the updated stat norm
  HD T rx_at(int k, bool with_next, bool with_prev, T stat, bool count) const {
    T dxk[NX];
    load_dx(k, dxk);
    T acc[NX];
    for (int i = 0; i < NX; ++i) {
      T v = Q(k, i, 0) * dxk[0];
      for (int j = 1; j < NX; ++j) v = v + Q(k, i, j) * dxk[j];
      acc[i] = v + q(k, i);
    }
    if (with_next) {
      for (int i = 0; i < NX; ++i) {
        T v = S(k, 0, i) * DU(k, 0);
        for (int j = 1; j < NU; ++j) v = v + S(k, j, i) * DU(k, j);
        acc[i] = acc[i] + v;
      }
      for (int i = 0; i < NX; ++i) {
        T v = A(k, 0, i) * NUd(k, 0);
        for (int j = 1; j < NX; ++j) v = v + A(k, j, i) * NUd(k, j);
        acc[i] = acc[i] - v;
      }
    }
    if (with_prev)
      for (int i = 0; i < NX; ++i) acc[i] = acc[i] + NUd(k - 1, i);
    for (int i = 0; i < NBX; ++i)
      acc[idxbx(i)] = acc[idxbx(i)] - (LXL(k, i) - LXU(k, i));
    T Ctl[NX] = {0, 0, 0, 0, 0};
    for (int m = 0; m < M; ++m) {
      T l = LH(k, m);
      for (int i = 0; i < NX; ++i) Ctl[i] = (m == 0) ? C(k, m, i) * l : Ctl[i] + C(k, m, i) * l;
    }
    for (int i = 0; i < NX; ++i) {
      T v = (M > 0) ? acc[i] - Ctl[i] : acc[i];
      RX(k, i) = v;
      if (count) stat = pmax(stat, vabs(v));
    }
    return stat;
  }

  // Qbar(k) = Q + diag(sxl + sxu) on IDXBX + C' diag(seff) C (upper triangle, mirrored)
  HD void qbar_mat(int k, T Qk[NX][NX]) const {
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) Qk[i][j] = Q(k, i, j);
    for (int i = 0; i < NBX; ++i) {
      int d = idxbx(i);
      Qk[d][d] = Qk[d][d] + sig(LXL(k, i), TXL(k, i)) + sig(LXU(k, i), TXU(k, i));
    }
    for (int m = 0; m < M; ++m) {
      T sh = sig(LH(k, m), TH(k, m));
      T ss = sig(LS(k, m), SS(k, m));
      T Z = Zl(k, m);
      T zeta = Z + sh + ss;
      T seff = sh * (Z + ss) / zeta;
      T Cm[NX];
      for (int j = 0; j < NX; ++j) Cm[j] = C(k, m, j);
      for (int i = 0; i < NX; ++i)
        for (int j = i; j < NX; ++j) Qk[i][j] = Qk[i][j] + (Cm[i] * seff) * Cm[j];
    }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < i; ++j) Qk[i][j] = Qk[j][i];
  }

  // ---- betas (predictor: -l; corrector: from the stored affine direction)
  // soft row m at stage k, given Cdx = (C dx_k)[m] of the current iterate
  HD void soft_delta(int k, int m, T Cdx, T CD, T b_h, T b_s,
                     T& ds, T& dth, T& dlh, T& dls) const {
    T t_h = TH(k, m), l_h = LH(k, m), s = SS(k, m), l_s = LS(k, m);
    T sh = sig(l_h, t_h), ss = sig(l_s, s);
    T Z = Zl(k, m);
    T zeta = Z + sh + ss;
    T rh = h(k, m) + Cdx + s - t_h;
    T rs = Z * s + zl(k, m) - l_h - l_s;
    T rho = -rs + b_h + b_s - sh * rh;
    ds = (rho - sh * CD) / zeta;
    dth = CD + ds + rh;
    dlh = b_h - sh * dth;
    dls = b_s - ss * ds;
  }
  HD void beta_soft(int k, int m, T Cdx, bool corr, T mu_t, T& b_h, T& b_s) const {
    if (!corr) { b_h = -LH(k, m); b_s = -LS(k, m); return; }
    T axk[NX];
    for (int i = 0; i < NX; ++i) axk[i] = AX(k, i);
    T ds, dth, dlh, dls;
    soft_delta(k, m, Cdx, Cdot(k, m, axk), -LH(k, m), -LS(k, m), ds, dth, dlh, dls);
    b_h = bc2(TH(k, m), LH(k, m), dth * dlh, mu_t);
    b_s = bc2(SS(k, m), LS(k, m), ds * dls, mu_t);
  }
  HD void box_delta(int k, int i, const T dxk[NX], T xi, T b_xl, T b_xu,
                    T& dtxl, T& dtxu, T& dlxl, T& dlxu) const {
    int d = idxbx(i);
    T rxl = dxk[d] - lbx(k, i) - TXL(k, i);
    T rxu = ubx(k, i) - dxk[d] - TXU(k, i);
    dtxl = xi + rxl;
    dtxu = -xi + rxu;
    dlxl = b_xl - sig(LXL(k, i), TXL(k, i)) * dtxl;
    dlxu = b_xu - sig(LXU(k, i), TXU(k, i)) * dtxu;
  }
  HD void beta_box(int k, int i, const T dxk[NX], bool corr, T mu_t, T& b_xl, T& b_xu) const {
    if (!corr) { b_xl = -LXL(k, i); b_xu = -LXU(k, i); return; }
    T dtxl, dtxu, dlxl, dlxu;
    box_delta(k, i, dxk, AX(k, idxbx(i)), -LXL(k, i), -LXU(k, i), dtxl, dtxu, dlxl, dlxu);
    b_xl = bc2(TXL(k, i), LXL(k, i), dtxl * dlxl, mu_t);
    b_xu = bc2(TXU(k, i), LXU(k, i), dtxu * dlxu, mu_t);
  }
  HD void u_delta(int k, int i, const T duk[NU], T ui, T b_ul, T b_uu,
                  T& dtul, T& dtuu, T& dlul, T& dluu) const {
    T rul = duk[i] - lbu(k, i) - TUL(k, i);
    T ruu = ubu(k, i) - duk[i] - TUU(k, i);
    dtul = ui + rul;
    dtuu = -ui + ruu;
    dlul = b_ul - sig(LUL(k, i), TUL(k, i)) * dtul;
    dluu = b_uu - sig(LUU(k, i), TUU(k, i)) * dtuu;
  }
  HD void beta_u(int k, int i, const T duk[NU], bool corr, T mu_t, T& b_ul, T& b_uu) const {
    if (!corr) { b_ul = -LUL(k, i); b_uu = -LUU(k, i); return; }
    T dtul, dtuu, dlul, dluu;
    u_delta(k, i, duk, AU(k, i), -LUL(k, i), -LUU(k, i), dtul, dtuu, dlul, dluu);
    b_ul = bc2(TUL(k, i), LUL(k, i), dtul * dlul, mu_t);
    b_uu = bc2(TUU(k, i), LUU(k, i), dtuu * dluu, mu_t);
  }

  // ---- right-hand sides of the Newton LQR ---------------------------------
  HD void qbar_at(int k, bool corr, T mu_t, T out[NX]) const {
    T dxk[NX];
    load_dx(k, dxk);
    T acc[NX];
    for (int i = 0; i < NX; ++i) acc[i] = RX(k, i);
    for (int i = 0; i < NBX; ++i) {
      int d = idxbx(i);
      T b_xl, b_xu;
      beta_box(k, i, dxk, corr, mu_t, b_xl, b_xu);
      T rxl = dxk[d] - lbx(k, i) - TXL(k, i);
      T rxu = ubx(k, i) - dxk[d] - TXU(k, i);
      acc[d] = acc[d] - (b_xl - sig(LXL(k, i), TXL(k, i)) * rxl)
                      + (b_xu - sig(LXU(k, i), TXU(k, i)) * rxu);
    }
    T Ctb[NX] = {0, 0, 0, 0, 0};
    for (int m = 0; m < M; ++m) {
      T Cdx = Cdot(k, m, dxk);
      T b_h, b_s;
      beta_soft(k, m, Cdx, corr, mu_t, b_h, b_s);
      T t_h = TH(k, m), l_h = LH(k, m), s = SS(k, m), l_s = LS(k, m);
      T sh = sig(l_h, t_h), ss = sig(l_s, s);
      T Z = Zl(k, m);
      T zeta = Z + sh + ss;
      T rh = h(k, m) + Cdx + s - t_h;
      T rs = Z * s + zl(k, m) - l_h - l_s;
      T rho = -rs + b_h + b_s - sh * rh;
      T bh_hat = b_h - sh * rh - sh * rho / zeta;
      for (int i = 0; i < NX; ++i)
        Ctb[i] = (m == 0) ? C(k, m, i) * bh_hat : Ctb[i] + C(k, m, i) * bh_hat;
    }
    for (int i = 0; i < NX; ++i) out[i] = (M > 0) ? acc[i] - Ctb[i] : acc[i];
  }

  HD void rbar_at(int k, bool corr, T mu_t, T out[NU]) const {
    T dxk[NX], duk[NU], ru[NU];
    load_dx(k, dxk);
    load_du(k, duk);
    res_u(k, dxk, duk, ru);
    for (int i = 0; i < NU; ++i) {
      T b_ul, b_uu;
      beta_u(k, i, duk, corr, mu_t, b_ul, b_uu);
      T rul = duk[i] - lbu(k, i) - TUL(k, i);
      T ruu = ubu(k, i) - duk[i] - TUU(k, i);
      out[i] = ru[i] - (b_ul - sig(LUL(k, i), TUL(k, i)) * rul)
                     + (b_uu - sig(LUU(k, i), TUU(k, i)) * ruu);
    }
  }

  // d_k = -(dx_{k+1} - A dx_k - B du_k - c_k), from the given (old) stage values
  HD void dyn_gap(int k, const T dxk[NX], const T duk[NU], T d[NX]) const {
    for (int i = 0; i < NX; ++i) {
      T Ax = A(k, i, 0) * dxk[0];
      for (int j = 1; j < NX; ++j) Ax = Ax + A(k, i, j) * dxk[j];
      T Bu = Bm(k, i, 0) * duk[0];
      for (int j = 1; j < NU; ++j) Bu = Bu + Bm(k, i, j) * duk[j];
      d[i] = -(DX(k + 1, i) - Ax - Bu - c(k, i));
    }
  }

  HD void roll(int k, const T xk[NX], const T uk[NU], const T d[NX], T xn[NX]) const {
    for (int i = 0; i < NX; ++i) {
      T Ax = A(k, i, 0) * xk[0];
      for (int j = 1; j < NX; ++j) Ax = Ax + A(k, i, j) * xk[j];
      T Bu = Bm(k, i, 0) * uk[0];
      for (int j = 1; j < NU; ++j) Bu = Bu + Bm(k, i, j) * uk[j];
      xn[i] = Ax + Bu + d[i];
    }
  }

  HD void control(int k, const T xk[NX], T uk[NU]) const {
    for (int i = 0; i < NU; ++i) {
      T v = KK(k, i, 0) * xk[0];
      for (int j = 1; j < NX; ++j) v = v + KK(k, i, j) * xk[j];
      uk[i] = v + KFF(k, i);
    }
  }

  // ---- phase 1: backward Riccati factorization ----------------------------
  HD void factorize() const {
    T Pm[NX][NX];
    qbar_mat(N, Pm);                       // P_N = Qbar(N)
    for (int k = N - 1; k >= 0; --k) {
      for (int i = 0; i < NX; ++i)
        for (int j = i; j < NX; ++j) Pu(k, tri(i, j)) = Pm[i][j];
      T PB[NX][NU], PA[NX][NX];
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NU; ++j) {
          T v = Pm[i][0] * Bm(k, 0, j);
          for (int l = 1; l < NX; ++l) v = v + Pm[i][l] * Bm(k, l, j);
          PB[i][j] = v;
        }
        for (int j = 0; j < NX; ++j) {
          T v = Pm[i][0] * A(k, 0, j);
          for (int l = 1; l < NX; ++l) v = v + Pm[i][l] * A(k, l, j);
          PA[i][j] = v;
        }
      }
      T Huu[NU][NU], Hux[NU][NX];
      for (int i = 0; i < NU; ++i) {
        for (int j = 0; j < NU; ++j) {
          T Rv = R(k, i, j);
          if (i == j) Rv = Rv + sig(LUL(k, i), TUL(k, i)) + sig(LUU(k, i), TUU(k, i));
          T v = Bm(k, 0, i) * PB[0][j];
          for (int l = 1; l < NX; ++l) v = v + Bm(k, l, i) * PB[l][j];
          Huu[i][j] = Rv + v;
        }
        for (int j = 0; j < NX; ++j) {
          T v = Bm(k, 0, i) * PA[0][j];
          for (int l = 1; l < NX; ++l) v = v + Bm(k, l, i) * PA[l][j];
          Hux[i][j] = S(k, i, j) + v;
        }
      }
      T Lf[NTRI_U];
      chol(Huu, Lf);
      for (int t = 0; t < NTRI_U; ++t) LL(k, t) = Lf[t];
      T Kk[NU][NX];
      for (int j = 0; j < NX; ++j) {
        T col[NU] = {Hux[0][j], Hux[1][j]}, sol[NU];
        chol_solve(Lf, col, sol);
        for (int i = 0; i < NU; ++i) { Kk[i][j] = -sol[i]; KK(k, i, j) = -sol[i]; }
      }
      T Qk[NX][NX];
      qbar_mat(k, Qk);
      T Pk[NX][NX];
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) {
          T atpa = A(k, 0, i) * PA[0][j];
          for (int l = 1; l < NX; ++l) atpa = atpa + A(k, l, i) * PA[l][j];
          T hk = Hux[0][i] * Kk[0][j];
          for (int l = 1; l < NU; ++l) hk = hk + Hux[l][i] * Kk[l][j];
          Pk[i][j] = Qk[i][j] + (atpa + hk);
        }
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) Pm[i][j] = T(0.5) * (Pk[i][j] + Pk[j][i]);
    }
  }

  // ---- back-substitution (feedforward kff and p_{k+1}) -------------------
  HD void backward(bool corr, T mu_t) const {
    T pv[NX];
    qbar_at(N, corr, mu_t, pv);
    for (int k = N - 1; k >= 0; --k) {
      for (int i = 0; i < NX; ++i) PN(k, i) = pv[i];
      T Pk1[NX][NX];
      load_P(k, Pk1);
      T dxk[NX], duk[NU], d[NX];
      load_dx(k, dxk);
      load_du(k, duk);
      dyn_gap(k, dxk, duk, d);
      T Pd_p[NX];
      for (int i = 0; i < NX; ++i) {
        T v = Pk1[i][0] * d[0];
        for (int j = 1; j < NX; ++j) v = v + Pk1[i][j] * d[j];
        Pd_p[i] = v + pv[i];
      }
      T rb[NU], mv[NU];
      rbar_at(k, corr, mu_t, rb);
      for (int i = 0; i < NU; ++i) {
        T v = Bm(k, 0, i) * Pd_p[0];
        for (int j = 1; j < NX; ++j) v = v + Bm(k, j, i) * Pd_p[j];
        mv[i] = rb[i] + v;
      }
      T Lf[NTRI_U] = {LL(k, 0), LL(k, 1), LL(k, 2)}, sol[NU];
      chol_solve(Lf, mv, sol);
      for (int i = 0; i < NU; ++i) KFF(k, i) = -sol[i];
      T qb[NX];
      qbar_at(k, corr, mu_t, qb);
      for (int i = 0; i < NX; ++i) {
        T atp = A(k, 0, i) * Pd_p[0];
        for (int j = 1; j < NX; ++j) atp = atp + A(k, j, i) * Pd_p[j];
        T ktm = KK(k, 0, i) * mv[0];
        for (int j = 1; j < NU; ++j) ktm = ktm + KK(k, j, i) * mv[j];
        pv[i] = qb[i] + (atp + ktm);
      }
    }
  }

  // ---- affine recovery: step bounds, S1..S3, stored affine (dx, du) -------
  HD void x_part_affine(int k, const T xk[NX], T& ap, T& ad, T& S1, T& S2, T& S3) const {
    T dxk[NX];
    load_dx(k, dxk);
    for (int i = 0; i < NX; ++i) AX(k, i) = xk[i];
    for (int m = 0; m < M; ++m) {
      T ds, dth, dlh, dls;
      soft_delta(k, m, Cdot(k, m, dxk), Cdot(k, m, xk), -LH(k, m), -LS(k, m), ds, dth, dlh, dls);
      ap = ftb(ftb(ap, TH(k, m), dth), SS(k, m), ds);
      ad = ftb(ftb(ad, LH(k, m), dlh), LS(k, m), dls);
      S1 = S1 + dth * LH(k, m) + ds * LS(k, m);
      S2 = S2 + TH(k, m) * dlh + SS(k, m) * dls;
      S3 = S3 + dth * dlh + ds * dls;
    }
    for (int i = 0; i < NBX; ++i) {
      T dtxl, dtxu, dlxl, dlxu;
      box_delta(k, i, dxk, xk[idxbx(i)], -LXL(k, i), -LXU(k, i), dtxl, dtxu, dlxl, dlxu);
      ap = ftb(ftb(ap, TXL(k, i), dtxl), TXU(k, i), dtxu);
      ad = ftb(ftb(ad, LXL(k, i), dlxl), LXU(k, i), dlxu);
      S1 = S1 + dtxl * LXL(k, i) + dtxu * LXU(k, i);
      S2 = S2 + TXL(k, i) * dlxl + TXU(k, i) * dlxu;
      S3 = S3 + dtxl * dlxl + dtxu * dlxu;
    }
  }

  HD void forward_affine(T& ap, T& ad, T& S1, T& S2, T& S3) const {
    T xk[NX] = {0, 0, 0, 0, 0};
    ap = T(2); ad = T(2); S1 = T(0); S2 = T(0); S3 = T(0);
    for (int k = 0; k < N; ++k) {
      x_part_affine(k, xk, ap, ad, S1, S2, S3);
      T uk[NU], dxk[NX], duk[NU], d[NX], xn[NX];
      control(k, xk, uk);
      load_dx(k, dxk);
      load_du(k, duk);
      for (int i = 0; i < NU; ++i) {
        T dtul, dtuu, dlul, dluu;
        u_delta(k, i, duk, uk[i], -LUL(k, i), -LUU(k, i), dtul, dtuu, dlul, dluu);
        ap = ftb(ftb(ap, TUL(k, i), dtul), TUU(k, i), dtuu);
        ad = ftb(ftb(ad, LUL(k, i), dlul), LUU(k, i), dluu);
        AU(k, i) = uk[i];
        S1 = S1 + dtul * LUL(k, i) + dtuu * LUU(k, i);
        S2 = S2 + TUL(k, i) * dlul + TUU(k, i) * dluu;
        S3 = S3 + dtul * dlul + dtuu * dluu;
      }
      dyn_gap(k, dxk, duk, d);
      roll(k, xk, uk, d, xn);
      for (int i = 0; i < NX; ++i) xk[i] = xn[i];
    }
    x_part_affine(N, xk, ap, ad, S1, S2, S3);
  }

  // ---- corrector: step bounds and the finiteness probe --------------------
  HD void x_part_collect(int k, const T xk[NX], T mu_t, T& ap, T& ad, T& chk) const {
    T dxk[NX];
    load_dx(k, dxk);
    for (int m = 0; m < M; ++m) {
      T Cdx = Cdot(k, m, dxk);
      T b_h, b_s, ds, dth, dlh, dls;
      beta_soft(k, m, Cdx, true, mu_t, b_h, b_s);
      soft_delta(k, m, Cdx, Cdot(k, m, xk), b_h, b_s, ds, dth, dlh, dls);
      ap = ftb(ftb(ap, TH(k, m), dth), SS(k, m), ds);
      ad = ftb(ftb(ad, LH(k, m), dlh), LS(k, m), dls);
      chk = chk + ds + dth + dlh + dls;
    }
    for (int i = 0; i < NBX; ++i) {
      T b_xl, b_xu, dtxl, dtxu, dlxl, dlxu;
      beta_box(k, i, dxk, true, mu_t, b_xl, b_xu);
      box_delta(k, i, dxk, xk[idxbx(i)], b_xl, b_xu, dtxl, dtxu, dlxl, dlxu);
      ap = ftb(ftb(ap, TXL(k, i), dtxl), TXU(k, i), dtxu);
      ad = ftb(ftb(ad, LXL(k, i), dlxl), LXU(k, i), dlxu);
      chk = chk + dtxl + dtxu + dlxl + dlxu;
    }
    for (int i = 0; i < NX; ++i) chk = chk + xk[i];
  }

  HD void forward_collect(T mu_t, T& ap, T& ad, T& chk) const {
    T xk[NX] = {0, 0, 0, 0, 0};
    ap = T(2); ad = T(2); chk = T(0);
    for (int k = 0; k < N; ++k) {
      x_part_collect(k, xk, mu_t, ap, ad, chk);
      T uk[NU], dxk[NX], duk[NU], d[NX], xn[NX];
      control(k, xk, uk);
      load_dx(k, dxk);
      load_du(k, duk);
      for (int i = 0; i < NU; ++i) {
        T b_ul, b_uu, dtul, dtuu, dlul, dluu;
        beta_u(k, i, duk, true, mu_t, b_ul, b_uu);
        u_delta(k, i, duk, uk[i], b_ul, b_uu, dtul, dtuu, dlul, dluu);
        ap = ftb(ftb(ap, TUL(k, i), dtul), TUU(k, i), dtuu);
        ad = ftb(ftb(ad, LUL(k, i), dlul), LUU(k, i), dluu);
        chk = chk + dtul + dtuu + dlul + dluu;
      }
      for (int i = 0; i < NU; ++i) chk = chk + uk[i];
      dyn_gap(k, dxk, duk, d);
      roll(k, xk, uk, d, xn);
      T Pk1[NX][NX];
      load_P(k, Pk1);
      for (int i = 0; i < NX; ++i) {
        T v = Pk1[i][0] * xn[0];
        for (int j = 1; j < NX; ++j) v = v + Pk1[i][j] * xn[j];
        chk = chk + v + PN(k, i);
      }
      for (int i = 0; i < NX; ++i) xk[i] = xn[i];
    }
    x_part_collect(N, xk, mu_t, ap, ad, chk);
  }

  // ---- apply: recompute the corrector deltas from the OLD stage values, then
  // update stage k (stage k+1 is still untouched when the next step reads it)
  HD static T upd(T old, T a, T step, bool positive) {
    T v = old + a * step;
    return positive ? pmax(v, T(1e-30)) : v;
  }

  HD void x_apply(int k, const T xk[NX], const T dxk[NX], T mu_t, T a_p, T a_d) const {
    for (int m = 0; m < M; ++m) {
      T Cdx = Cdot(k, m, dxk);
      T b_h, b_s, ds, dth, dlh, dls;
      beta_soft(k, m, Cdx, true, mu_t, b_h, b_s);
      soft_delta(k, m, Cdx, Cdot(k, m, xk), b_h, b_s, ds, dth, dlh, dls);
      SS(k, m) = upd(SS(k, m), a_p, ds, true);
      TH(k, m) = upd(TH(k, m), a_p, dth, true);
      LH(k, m) = upd(LH(k, m), a_d, dlh, true);
      LS(k, m) = upd(LS(k, m), a_d, dls, true);
    }
    for (int i = 0; i < NBX; ++i) {
      T b_xl, b_xu, dtxl, dtxu, dlxl, dlxu;
      beta_box(k, i, dxk, true, mu_t, b_xl, b_xu);
      box_delta(k, i, dxk, xk[idxbx(i)], b_xl, b_xu, dtxl, dtxu, dlxl, dlxu);
      TXL(k, i) = upd(TXL(k, i), a_p, dtxl, true);
      LXL(k, i) = upd(LXL(k, i), a_d, dlxl, true);
      TXU(k, i) = upd(TXU(k, i), a_p, dtxu, true);
      LXU(k, i) = upd(LXU(k, i), a_d, dlxu, true);
    }
    for (int i = 0; i < NX; ++i) DX(k, i) = upd(dxk[i], a_p, xk[i], false);
  }

  HD void forward_apply(T mu_t, T a_p, T a_d) const {
    T xk[NX] = {0, 0, 0, 0, 0};
    for (int k = 0; k < N; ++k) {
      T uk[NU], dxk[NX], duk[NU], d[NX], xn[NX];
      load_dx(k, dxk);
      load_du(k, duk);
      control(k, xk, uk);
      dyn_gap(k, dxk, duk, d);          // reads dx_{k+1}: not updated yet
      roll(k, xk, uk, d, xn);
      T Pk1[NX][NX], Px[NX];
      load_P(k, Pk1);
      for (int i = 0; i < NX; ++i) {
        T v = Pk1[i][0] * xn[0];
        for (int j = 1; j < NX; ++j) v = v + Pk1[i][j] * xn[j];
        Px[i] = v;
      }
      // the u-box deltas read the stored affine du and the old u pairs
      T dt_ul[NU], dt_uu[NU], dl_ul[NU], dl_uu[NU];
      for (int i = 0; i < NU; ++i) {
        T b_ul, b_uu;
        beta_u(k, i, duk, true, mu_t, b_ul, b_uu);
        u_delta(k, i, duk, uk[i], b_ul, b_uu, dt_ul[i], dt_uu[i], dl_ul[i], dl_uu[i]);
      }
      x_apply(k, xk, dxk, mu_t, a_p, a_d);
      for (int i = 0; i < NU; ++i) {
        DU(k, i) = upd(duk[i], a_p, uk[i], false);
        TUL(k, i) = upd(TUL(k, i), a_p, dt_ul[i], true);
        LUL(k, i) = upd(LUL(k, i), a_d, dl_ul[i], true);
        TUU(k, i) = upd(TUU(k, i), a_p, dt_uu[i], true);
        LUU(k, i) = upd(LUU(k, i), a_d, dl_uu[i], true);
      }
      for (int i = 0; i < NX; ++i) NUd(k, i) = upd(NUd(k, i), a_d, -(Px[i] + PN(k, i)), false);
      for (int i = 0; i < NX; ++i) xk[i] = xn[i];
    }
    T dxN[NX];
    load_dx(N, dxN);
    x_apply(N, xk, dxN, mu_t, a_p, a_d);
  }

  // ---- the whole solve ---------------------------------------------------
  HD void init() const {
    const T t_min = T(0.1), mu0 = T(1);
    T x[NX];
    for (int i = 0; i < NX; ++i) { x[i] = p.dx0[ix(NX, 0, i)]; DX(0, i) = x[i]; }
    for (int k = 0; k < N; ++k) {
      T xn[NX];
      for (int i = 0; i < NX; ++i) {
        T v = A(k, i, 0) * x[0];
        for (int j = 1; j < NX; ++j) v = v + A(k, i, j) * x[j];
        xn[i] = v + c(k, i);
      }
      for (int i = 0; i < NX; ++i) { x[i] = xn[i]; DX(k + 1, i) = xn[i]; }
    }
    for (int k = 0; k <= N; ++k) {
      T dxk[NX];
      load_dx(k, dxk);
      for (int m = 0; m < M; ++m) {
        T g = h(k, m) + Cdot(k, m, dxk);
        T s0 = pmax(t_min, t_min - g);
        SS(k, m) = s0;
        T t = pmax(g + s0, t_min);
        TH(k, m) = t;
        LH(k, m) = mu0 / t;
        LS(k, m) = mu0 / s0;
      }
      for (int i = 0; i < NBX; ++i) {
        T t = pmax(dxk[idxbx(i)] - lbx(k, i), t_min);
        TXL(k, i) = t;
        LXL(k, i) = mu0 / t;
        t = pmax(ubx(k, i) - dxk[idxbx(i)], t_min);
        TXU(k, i) = t;
        LXU(k, i) = mu0 / t;
      }
    }
    for (int k = 0; k < N; ++k) {
      for (int i = 0; i < NU; ++i) {
        DU(k, i) = T(0);
        T t = pmax(-lbu(k, i), t_min);
        TUL(k, i) = t;
        LUL(k, i) = mu0 / t;
        t = pmax(ubu(k, i), t_min);
        TUU(k, i) = t;
        LUU(k, i) = mu0 / t;
      }
      for (int i = 0; i < NX; ++i) NUd(k, i) = T(0);
    }
  }

  HD void solve() const {
    init();
    const T n_pairs = T(2 * N * NU + 2 * (N + 1) * NBX + 2 * (N + 1) * M);
    T mu = T(0), stat = T(0);
    for (int it = 0; it < p.iters; ++it) {
      // phase 0: duality measure + stationarity residual
      mu = T(0);
      for (int k = 0; k <= N; ++k) {
        for (int i = 0; i < NBX; ++i) mu = mu + TXL(k, i) * LXL(k, i) + TXU(k, i) * LXU(k, i);
        for (int m = 0; m < M; ++m) mu = mu + TH(k, m) * LH(k, m) + SS(k, m) * LS(k, m);
      }
      stat = T(0);
      rx_at(0, true, false, stat, false);        // stored, excluded from stat
      for (int k = 1; k < N; ++k) stat = rx_at(k, true, true, stat, true);
      stat = rx_at(N, false, true, stat, true);
      for (int k = 0; k < N; ++k) {
        for (int i = 0; i < NU; ++i) mu = mu + TUL(k, i) * LUL(k, i) + TUU(k, i) * LUU(k, i);
        T dxk[NX], duk[NU], ru[NU];
        load_dx(k, dxk);
        load_du(k, duk);
        res_u(k, dxk, duk, ru);
        for (int i = 0; i < NU; ++i) stat = pmax(stat, vabs(ru[i]));
      }
      mu = mu / n_pairs;

      factorize();

      // predictor
      backward(false, T(0));
      T ap_raw, ad_raw, S1, S2, S3;
      forward_affine(ap_raw, ad_raw, S1, S2, S3);
      T ap_aff = pmin(ap_raw, T(1)), ad_aff = pmin(ad_raw, T(1));
      T mu_aff = (mu * n_pairs + ap_aff * S1 + ad_aff * S2 + ap_aff * ad_aff * S3) / n_pairs;
      T ratio = mu_aff / pmax(mu, T(T_FLOOR));
      T sig_c = pmin(pmax(ratio * ratio * ratio, T(0)), T(1));
      T mu_t = sig_c * mu;

      // corrector
      backward(true, mu_t);
      T chk;
      forward_collect(mu_t, ap_raw, ad_raw, chk);
      T a_p = pmin(p.tau * ap_raw, T(1));
      T a_d = pmin(p.tau * ad_raw, T(1));

      bool converged = (mu < p.tol) && (stat < p.stat_tol);
      bool finite = (vabs(chk) < T(3.0e38)) && (chk == chk) && (a_p == a_p) && (a_d == a_d);
      // a frozen row keeps its iterate: skipping the apply pass is the select
      if (!(converged || !finite)) forward_apply(mu_t, a_p, a_d);
    }
    // mu/stat of the last iteration's pre-update iterate
    p.mu[b] = mu;
    p.stat[b] = stat;
  }
};

template <typename T>
HD void ip_solve_one(const Params<T>& p, int b) {
  Solver<T> s(p, b);
  s.solve();
}

}  // namespace ipk

extern "C" long long ip_solve_work_floats(int N, int M) { return ipk::work_floats(N, M); }

#ifdef __CUDACC__

__global__ void __launch_bounds__(ipk::kThreadsPerBlock)
ip_solve_kernel_f32(ipk::Params<float> p) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  ipk::ip_solve_one<float>(p, b);
}

extern "C" int ip_solve_f32(
    const float* A, const float* Bm, const float* c, const float* dx0,
    const float* Q, const float* q, const float* R, const float* r, const float* S,
    const float* lbu, const float* ubu, const float* lbx, const float* ubx,
    const float* C, const float* h, const float* zl, const float* Zl,
    float* dx, float* du, float* s, float* mu, float* stat, float* work,
    int B, int N, int M, int iters,
    float reg, float tau, float tol, float stat_tol, float sigma_max,
    void* stream) {
  ipk::Params<float> p{A, Bm, c, dx0, Q, q, R, r, S, lbu, ubu, lbx, ubx, C, h, zl, Zl,
                       dx, du, s, mu, stat, work, B, N, M, iters,
                       reg, tau, tol, stat_tol, sigma_max};
  int blocks = (B + ipk::kThreadsPerBlock - 1) / ipk::kThreadsPerBlock;
  ip_solve_kernel_f32<<<blocks, ipk::kThreadsPerBlock, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* ip_solve_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif
