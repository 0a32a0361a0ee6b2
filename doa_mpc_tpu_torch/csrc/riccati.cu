// Batched Riccati factorize + solve of LQR problems (kernel K2).
//
// Replaces doa_mpc_tpu/ops/riccati_pallas.py::_riccati_kernel (the TPU
// kernel). Per scenario, in one launch:
// - backward: P_N = Q_N, p_N = q_N; per stage k = N-1..0, Huu = R + B'PB,
//   Hux = S + B'PA, the 2x2 Cholesky of Huu with reg added to both diagonal
//   entries (l22^2 floored at 1e-30), K = -Huu^-1 Hux,
//   kff = -Huu^-1 (r + B'(P d + p)), then P <- sym(Q + A'PA + Hux'K) and
//   p <- q + A'(P d + p) + K'(r + B'(P d + p));
// - forward: u_k = K_k x_k + kff_k, x_{k+1} = A_k x_k + B_k u_k + d_k and the
//   costate nu_k = -(P_{k+1} x_{k+1} + p_{k+1}).
// The interior-point solver (ops/ip_qp.py, backend "riccati") calls it once
// per Newton right-hand side.
//
// What bounds it on the H100: bytes. At N = 20 each scenario reads 1,755
// input values and writes 245 outputs: 32.8 MB in f32 at B = 4096, 9.8 us
// at 3.35 TB/s; its 22,750 operations per scenario (csrc/op_count.cpp) take
// less at the f32 rate. The stage recursion is serial, so what stands
// between the kernel and that bound is each stage's stream of dependent
// instructions: at B = 1 its latency, at B = 4096 the SM's issue slots
// (0.049 ms, about 5x the bound; the first design, one thread per scenario
// with batch-last arrays and the scratch in device memory, took 0.10 ms).
//
// Design:
// - A team of kTeam lanes (a tile of one warp) owns one scenario; a block
//   is one warp. In the backward pass every lane forms P B, Huu, its
//   Cholesky factor, P d + p and m itself; lane j < 5 forms column j of P A,
//   of Hux and of K and entry j of the new p, and lane 5 solves for kff
//   beside them, so the team runs the 2x2 solves once; then the lanes share
//   the 15 entries of the symmetrized P. Two tile syncs per stage. The
//   forward pass runs lanes over entries too: lanes 0-4 form x_{k+1}, the
//   next lanes the costate of the stage before, which so leaves the chain.
//   One tile sync per stage.
// - Stage data on chip ahead of use: each stage's inputs do not depend on
//   the recursion, so the team copies them with cp.async (4 or 8 bytes each:
//   a scenario's runs are not 16-byte aligned) into a ring of kRing stages
//   in shared memory, kRing - 1 stages ahead of the stage it computes. The
//   forward pass reads A, B and d through the same ring. Every input value
//   is read from device memory once in the backward pass and, for A, B and
//   d, once more in the forward pass (L2 hits at these sizes). Staging a
//   whole scenario instead (kRing = N = 20) measured 37% slower at
//   B = 4096, where its 10.4 KB per scenario takes two waves, and 2% faster
//   at B = 1 (PERF.md); the ring's size does not grow with N.
// - Scratch on chip: P_{k+1}, K, kff and p_{k+1} of every stage (42 values a
//   stage, [stage][entry]) live in dynamic shared memory after the ring and
//   the exchange buffers. Where a block cannot hold its scenarios' scratch
//   (past N = 682 in f32 and 336 in f64 at kTeam = 16), a second
//   instantiation keeps it in a device-memory workspace the wrapper
//   allocates, one slice per tile of the grid. Where it lives is a template
//   parameter: a pointer that may be either makes every access generic.
// - Residency and waves: the grid is cut to balanced waves (plan below), so
//   every block walks the same number of scenarios and no SM holds more
//   blocks than the waves need.
// - Batch-first I/O: the inputs are read as the solver holds them, one
//   scenario's field one contiguous run; dx, du and nu are written so.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: the 1e-30 floor and the NaN propagation that the solver's
// non-finite guard relies on need IEEE sqrt, division and comparisons.
//
// The body is __host__ __device__ and has no CUDA dependency outside the
// team's tile operations, the copies and the launcher: on the host the team
// is one lane and a copy is an assignment, so the same file compiles as
// plain C++ (float or double) for host-side tests of the arithmetic.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <math.h>
#include <vector>
#define HD inline
#endif

#include <stddef.h>

namespace rck {

constexpr int NX = 5;
constexpr int NU = 2;
constexpr int kWarp = 32;                    // threads per block
constexpr int kTeam = 16;                    // lanes per scenario (8 was slower; PERF.md)
constexpr int kPerBlock = kWarp / kTeam;     // scenarios per block
constexpr int kRing = 4;                     // stages of inputs on chip

// one stage of inputs in the ring; A, B, d first: the forward pass copies
// only those
constexpr int oA = 0, oB = 25, od = 35, oS = 40, oR = 50, oQ = 54, oq = 79, orr = 84;
constexpr int kStage = 86, kStageFwd = 40;
// per tile, always in shared memory: the ring, P A and Hux of the stage, x
constexpr int kFixed = kRing * kStage + NX * NX + NU * NX + 2 * NX;
// per tile and stage: P_{k+1}, K, kff, p_{k+1}
constexpr int kScr = NX * NX + NU * NX + NU + NX;

HD long long scratch_values(int N) { return (long long)N * kScr; }

HD float vsqrt(float x) { return sqrtf(x); }
HD double vsqrt(double x) { return sqrt(x); }
// NaN-propagating max (jnp.maximum semantics)
template <typename T> HD T pmax(T a, T b) { return (a != a || a > b) ? a : b; }

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

// copy one value from device to shared memory without waiting for it; the
// copies started between two commits form a group, and wait_copies<n> waits
// until at most n groups are pending
template <typename T> HD void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}
HD void commit_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int n> HD void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

// ---- the team that owns one scenario -----------------------------------
// On the device: a tile of kTeam lanes of one warp, whose sync is a
// __syncwarp over the tile's lanes (a cooperative_groups tiled_partition
// built at each sync compiled to a MATCH.ANY / REDUX sequence). On the host:
// one lane.
struct DevTeam {
  int lane;
  unsigned mask;          // the tile's lanes within the warp
  HD int rank() const { return lane; }
  HD static constexpr int size() { return kTeam; }
  HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }
};

struct HostTeam {
  HD int rank() const { return 0; }
  HD static constexpr int size() { return 1; }
  HD void sync() const {}
};

template <typename T>
struct Params {
  // inputs, batch-first and contiguous: Q (B, N+1, NX, NX), R (B, N, NU, NU),
  // S (B, N, NU, NX), A (B, N, NX, NX), Bm (B, N, NX, NU), q (B, N+1, NX),
  // r (B, N, NU), d (B, N, NX), x0 (B, NX)
  const T *Q, *R, *S, *A, *Bm, *q, *r, *d, *x0;
  // outputs: dx (B, N+1, NX), du (B, N, NU), nu (B, N, NX)
  T *dx, *du, *nu;
  int B, N;
  T reg;
};

// Where a tile's arrays live: the fixed part always in shared memory; the
// scratch after it (ON_CHIP) or in slice `slot` of the device-memory
// workspace `work`.
template <typename T> struct Slices { T* fixed; T* scratch; };

template <typename T, bool ON_CHIP>
HD Slices<T> slices(T* smem, T* work, long long slot, int tile, long long scr) {
  if (ON_CHIP) {
    T* f = smem + (size_t)tile * (kFixed + scr);
    return {f, f + kFixed};
  }
  return {smem + (size_t)tile * kFixed, work + (size_t)slot * scr};
}

template <typename T, class TM>
struct Lqr {
  const Params<T>& p;
  TM tm;
  int b, N;
  const T *gQ, *gR, *gS, *gA, *gB, *gq, *gr, *gd;
  T *ring, *PA, *Hux, *xb;        // shared memory
  T *Ps, *Ks, *kfs, *pns;         // scratch, [stage][entry]

  HD Lqr(const Params<T>& p_, int b_, Slices<T> sl, TM tm_) : p(p_), tm(tm_), b(b_), N(p_.N) {
    size_t n = N, n1 = N + 1;
    gQ = p.Q + b * n1 * NX * NX;
    gR = p.R + b * n * NU * NU;
    gS = p.S + b * n * NU * NX;
    gA = p.A + b * n * NX * NX;
    gB = p.Bm + b * n * NX * NU;
    gq = p.q + b * n1 * NX;
    gr = p.r + b * n * NU;
    gd = p.d + b * n * NX;
    ring = sl.fixed;
    PA = ring + kRing * kStage;
    Hux = PA + NX * NX;
    xb = Hux + NU * NX;
    Ps = sl.scratch;
    Ks = Ps + n * NX * NX;
    kfs = Ks + n * NU * NX;
    pns = kfs + n * NU;
  }

  // Copy the n values at src into dst, lanes over values.
  template <int n> HD void copy_run(T* dst, const T* src) const {
    for (int e = tm.rank(); e < n; e += tm.size()) copy_async(dst + e, src + e);
  }

  // Copy stage s's inputs (only A, B, d in the forward pass) into its ring
  // slot, then close the group; a stage outside 0..N-1 gives an empty group.
  // One loop per field: a lane stays on one field at a time, so the copies
  // do not diverge.
  template <bool FWD> HD void fetch(int s) const {
    if (s >= 0 && s < N) {
      T* dst = ring + (s % kRing) * kStage;
      copy_run<NX * NX>(dst + oA, gA + s * NX * NX);
      copy_run<NX * NU>(dst + oB, gB + s * NX * NU);
      copy_run<NX>(dst + od, gd + s * NX);
      if (!FWD) {
        copy_run<NU * NX>(dst + oS, gS + s * NU * NX);
        copy_run<NU * NU>(dst + oR, gR + s * NU * NU);
        copy_run<NX * NX>(dst + oQ, gQ + s * NX * NX);
        copy_run<NX>(dst + oq, gq + s * NX);
        copy_run<NU>(dst + orr, gr + s * NU);
      }
    }
    commit_copies();
  }

  // Solve (L L') x = b for the factor L = (l11, l21, l22).
  HD static void chol2_solve(T l11, T l21, T l22, T b0, T b1, T& x0, T& x1) {
    T y1 = b0 / l11;
    T y2 = (b1 - l21 * y1) / l22;
    x1 = y2 / l22;
    x0 = (y1 - l21 * x1) / l11;
  }

  // stage k of the backward pass: reads P_{k+1}, p_{k+1} (scratch slot k)
  // and the stage's inputs (ring); writes K_k, kff_k and, for k > 0, P_k and
  // p_k (scratch slot k - 1)
  HD void backward_stage(int k, const T* st) const {
    const int rk = tm.rank(), sz = tm.size();
    T P[NX][NX], Bm[NX][NU], pv[NX];
    for (int i = 0; i < NX; ++i) {
      for (int j = 0; j < NX; ++j) P[i][j] = Ps[k * NX * NX + i * NX + j];
      for (int j = 0; j < NU; ++j) Bm[i][j] = st[oB + i * NU + j];
      pv[i] = pns[k * NX + i];
    }
    T PB[NX][NU];
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
        for (int l = 0; l < NX; ++l) acc += P[i][l] * Bm[l][j];
        PB[i][j] = acc;
      }
    T Huu[NU][NU];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) {
        T acc = T(0);
        for (int l = 0; l < NX; ++l) acc += Bm[l][i] * PB[l][j];
        Huu[i][j] = st[oR + i * NU + j] + acc;
      }
    // 2x2 Cholesky of Huu (reads the lower entry H[1][0], as the TPU kernel)
    T l11 = vsqrt(Huu[0][0] + p.reg);
    T l21 = Huu[1][0] / l11;
    T l22 = vsqrt(pmax(Huu[1][1] + p.reg - l21 * l21, T(1e-30)));

    T Pdp[NX], m[NU];
    for (int i = 0; i < NX; ++i) {
      T acc = T(0);
      for (int l = 0; l < NX; ++l) acc += P[i][l] * st[od + l];
      Pdp[i] = acc + pv[i];
    }
    for (int i = 0; i < NU; ++i) {
      T acc = T(0);
      for (int l = 0; l < NX; ++l) acc += Bm[l][i] * Pdp[l];
      m[i] = st[orr + i] + acc;
    }
    // lane j < NX: column j of P A, Hux and K, and entry j of p_k. Lane NX:
    // kff, from the same 2x2 solves on m (it forms a column of P A that it
    // discards), so the team runs the divisions once.
    for (int j = rk; j <= NX; j += sz) {
      const int jc = j < NX ? j : NX - 1;
      T pa[NX], hx[NU], kc[NU];
      for (int l = 0; l < NX; ++l) {
        T acc = T(0);
        for (int c = 0; c < NX; ++c) acc += P[l][c] * st[oA + c * NX + jc];
        pa[l] = acc;
      }
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
        for (int l = 0; l < NX; ++l) acc += Bm[l][i] * pa[l];
        hx[i] = j < NX ? st[oS + i * NX + jc] + acc : m[i];
      }
      chol2_solve(l11, l21, l22, hx[0], hx[1], kc[0], kc[1]);
      if (j == NX) {
        for (int i = 0; i < NU; ++i) kfs[k * NU + i] = -kc[i];
        continue;
      }
      for (int l = 0; l < NX; ++l) PA[l * NX + j] = pa[l];
      for (int i = 0; i < NU; ++i) {
        Hux[i * NX + j] = hx[i];
        kc[i] = -kc[i];
        Ks[k * NU * NX + i * NX + j] = kc[i];
      }
      if (k > 0) {
        T ap = T(0), km = T(0);
        for (int l = 0; l < NX; ++l) ap += st[oA + l * NX + j] * Pdp[l];
        for (int l = 0; l < NU; ++l) km += kc[l] * m[l];
        pns[(k - 1) * NX + j] = st[oq + j] + (ap + km);
      }
    }
    tm.sync();
    if (k == 0) return;
    // the 15 entries of P_k = sym(Q + (A'PA + Hux'K))
    for (int t = rk; t < NX * (NX + 1) / 2; t += sz) {
      // row i of the upper triangle starts at slot i (2 NX - i + 1) / 2
      int i = (t >= NX) + (t >= 2 * NX - 1) + (t >= 3 * NX - 3) + (t >= 4 * NX - 6);
      int j = i + t - i * (2 * NX - i + 1) / 2;
      T vij = pk_entry(k, st, i, j);
      T vji = i == j ? vij : pk_entry(k, st, j, i);
      T pij = T(0.5) * (vij + vji);
      Ps[(k - 1) * NX * NX + i * NX + j] = pij;
      Ps[(k - 1) * NX * NX + j * NX + i] = pij;
    }
  }

  // entry (a, c) of Q + (A'PA + Hux'K) at stage k, before symmetrizing
  HD T pk_entry(int k, const T* st, int a, int c) const {
    T aa = T(0), hk = T(0);
    for (int l = 0; l < NX; ++l) aa += st[oA + l * NX + a] * PA[l * NX + c];
    for (int l = 0; l < NU; ++l) hk += Hux[l * NX + a] * Ks[k * NU * NX + l * NX + c];
    return st[oQ + a * NX + c] + (aa + hk);
  }

  HD void run() const {
    const int rk = tm.rank(), sz = tm.size();
    // P_N = Q_N and p_N = q_N: the P_{k+1}, p_{k+1} of stage N - 1
    for (int e = rk; e < NX * NX; e += sz) Ps[(N - 1) * NX * NX + e] = ld(gQ + N * NX * NX + e);
    for (int e = rk; e < NX; e += sz) pns[(N - 1) * NX + e] = ld(gq + N * NX + e);
    for (int s = N - 1; s > N - kRing; --s) fetch<false>(s);
    wait_copies<kRing - 2>();
    tm.sync();

    // ---- backward: factorization and gradient pass -------------------------
    for (int k = N - 1; k >= 0; --k) {
      fetch<false>(k - kRing + 1);
      backward_stage(k, ring + (k % kRing) * kStage);
      wait_copies<kRing - 2>();
      tm.sync();
    }

    // ---- forward rollout and costate ---------------------------------------
    // The ring holds stages 0..kRing-1 from the backward pass; stage
    // k + kRing - 1 goes into the slot of stage k - 1.
    for (int i = rk; i < NX; i += sz) {
      T v = ld(p.x0 + (size_t)b * NX + i);
      xb[i] = v;
      p.dx[(size_t)b * (N + 1) * NX + i] = v;
    }
    tm.sync();
    for (int k = 0; k < N; ++k) {
      fetch<true>(k > 0 ? k + kRing - 1 : -1);
      const T* st = ring + (k % kRing) * kStage;
      T x[NX], u[NU];
      for (int i = 0; i < NX; ++i) x[i] = xb[(k & 1) * NX + i];
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
        for (int j = 0; j < NX; ++j) acc += Ks[k * NU * NX + i * NX + j] * x[j];
        u[i] = acc + kfs[k * NU + i];
      }
      for (int i = rk; i < NU; i += sz) p.du[((size_t)b * N + k) * NU + i] = i == 0 ? u[0] : u[1];
      // entries 0..4: x_{k+1} = (A x + B u) + d; entries 5..9: the costate
      // of stage k - 1, -(P_k x + p_k). One dot product for both, so the
      // lanes do not diverge before it.
      for (int e = rk; e < 2 * NX; e += sz) {
        const bool xe = e < NX;
        const int i = xe ? e : e - NX;
        const T* row = xe ? st + oA + i * NX : Ps + ((k > 0 ? k : 1) - 1) * NX * NX + i * NX;
        T acc = T(0);
        for (int j = 0; j < NX; ++j) acc += row[j] * x[j];
        if (xe) {
          T bu = T(0);
          for (int j = 0; j < NU; ++j) bu += st[oB + i * NU + j] * u[j];
          T xn = (acc + bu) + st[od + i];
          xb[((k + 1) & 1) * NX + i] = xn;
          p.dx[((size_t)b * (N + 1) + k + 1) * NX + i] = xn;
        } else if (k > 0) {
          p.nu[((size_t)b * N + k - 1) * NX + i] = -(acc + pns[(k - 1) * NX + i]);
        }
      }
      wait_copies<kRing - 2>();
      tm.sync();
    }
    // the costate of stage N - 1
    for (int i = rk; i < NX; i += sz) {
      T acc = T(0);
      for (int j = 0; j < NX; ++j)
        acc += Ps[(N - 1) * NX * NX + i * NX + j] * xb[(N & 1) * NX + j];
      p.nu[((size_t)b * N + N - 1) * NX + i] = -(acc + pns[(N - 1) * NX + i]);
    }
    tm.sync();              // the tile's arrays are free for its next scenario
  }
};

}  // namespace rck

#ifndef __CUDACC__

namespace rck {
// The same body on the host: one lane per scenario, scenario after scenario.
// Its shared-memory arrays are a vector; the scratch is the same vector
// (on_chip) or a workspace slice per scenario, as the device-memory
// instantiation lays it out. Both are NaN-filled, so a read of an entry that
// was never written shows up in the result.
template <typename T>
void host_solve(const Params<T>& p, bool on_chip) {
  long long scr = scratch_values(p.N);
  std::vector<T> sm(kFixed + scr, (T)NAN);
  std::vector<T> work(on_chip ? 0 : (size_t)p.B * scr, (T)NAN);
  for (int b = 0; b < p.B; ++b) {
    Slices<T> sl = on_chip ? slices<T, true>(sm.data(), nullptr, 0, 0, scr)
                           : slices<T, false>(sm.data(), work.data(), b, 0, scr);
    Lqr<T, HostTeam>(p, b, sl, HostTeam{}).run();
  }
}
}  // namespace rck

#else

// One warp per block, kPerBlock scenarios at a time; a block walks the
// scenarios gridDim.x * kPerBlock apart, so the grid can be sized to the
// waves the card needs (plan below).
template <typename T, bool ON_CHIP>
__global__ void __launch_bounds__(rck::kWarp) riccati_kernel(rck::Params<T> p, T* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int tile = threadIdx.x / rck::kTeam;
  long long slot = (long long)blockIdx.x * rck::kPerBlock + tile;
  rck::Slices<T> sl = rck::slices<T, ON_CHIP>(reinterpret_cast<T*>(smem_raw), work, slot, tile,
                                               rck::scratch_values(p.N));
  const unsigned first = threadIdx.x % rck::kWarp / rck::kTeam * rck::kTeam;  // tile's lane 0
  rck::DevTeam tm{(int)(threadIdx.x % rck::kTeam), ((1u << rck::kTeam) - 1) << first};
  for (long long b = slot; b < p.B; b += (long long)gridDim.x * rck::kPerBlock)
    rck::Lqr<T, rck::DevTeam>(p, (int)b, sl, tm).run();   // the whole tile moves together
}

namespace {

// How a launch of B scenarios runs, into out[5]: the grid's blocks, the
// shared memory of a block (its scenarios' ring and exchange buffers, and
// their scratch when on chip), the values of one scenario's scratch, the
// values of device-memory workspace (0 when the scratch is on chip) and the
// scenarios resident per SM that the occupancy API reports. The grid is cut
// to balanced waves: with R blocks resident per SM the blocks B needs take
// waves = ceil(blocks / (SMs R)), and a grid of ceil(blocks / waves) blocks
// gives every block the same number of scenarios. The on-chip kernel's
// shared-memory limit on the current device is raised to what the plan
// needs, never lowered, so a plan stays valid once made: the wrapper makes it
// once per device, dtype, B and N.
template <typename T>
cudaError_t plan(int B, int N, long long* out) {
  long long scr = rck::scratch_values(N);
  if (scr > (1LL << 30)) return cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  size_t chip = (size_t)(rck::kFixed + scr) * sizeof(T) * rck::kPerBlock;
  bool on_chip = chip <= (size_t)optin;
  size_t bytes = on_chip ? chip : (size_t)rck::kFixed * sizeof(T) * rck::kPerBlock;
  if (on_chip) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, riccati_kernel<T, true>);
    if (e == cudaSuccess && (size_t)fa.maxDynamicSharedSizeBytes < bytes)
      e = cudaFuncSetAttribute(riccati_kernel<T, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (e == cudaSuccess)
    e = on_chip ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, riccati_kernel<T, true>, rck::kWarp, bytes)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, riccati_kernel<T, false>, rck::kWarp, bytes);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (B + rck::kPerBlock - 1) / rck::kPerBlock;
  long long waves = (blocks + (long long)sms * resident - 1) / ((long long)sms * resident);
  out[0] = (blocks + waves - 1) / waves;
  out[1] = (long long)bytes;
  out[2] = scr;
  out[3] = on_chip ? 0 : out[0] * rck::kPerBlock * scr;
  out[4] = resident * rck::kPerBlock;
  return cudaSuccess;
}

// A launch on a plan: the on-chip instantiation when work is null, else the
// device-memory one.
template <typename T>
int launch(const rck::Params<T>& p, T* work, long long blocks, long long bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (work == nullptr)
    riccati_kernel<T, true><<<(unsigned)blocks, rck::kWarp, (size_t)bytes, st>>>(p, nullptr);
  else
    riccati_kernel<T, false><<<(unsigned)blocks, rck::kWarp, (size_t)bytes, st>>>(p, work);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan of a launch of B scenarios of value_bytes (4 or 8), see plan():
// out[0] blocks, out[1] shared-memory bytes per block, out[2] scratch values
// per scenario, out[3] workspace values, out[4] scenarios resident per SM.
// Returns a cudaError_t.
extern "C" int riccati_plan(int value_bytes, int B, int N, long long* out) {
  if (value_bytes == 4) return (int)plan<float>(B, N, out);
  if (value_bytes == 8) return (int)plan<double>(B, N, out);
  return (int)cudaErrorInvalidValue;
}

// blocks, bytes: out[0] and out[1] of riccati_plan for this B and N; work:
// device memory of out[3] values, or null when that is 0.
extern "C" int riccati_f32(const float* Q, const float* R, const float* S, const float* A,
                           const float* Bm, const float* q, const float* r, const float* d,
                           const float* x0, float* dx, float* du, float* nu, float* work,
                           int B, int N, float reg, long long blocks, long long bytes,
                           void* stream) {
  return launch<float>({Q, R, S, A, Bm, q, r, d, x0, dx, du, nu, B, N, reg}, work, blocks,
                       bytes, stream);
}

extern "C" int riccati_f64(const double* Q, const double* R, const double* S,
                           const double* A, const double* Bm, const double* q,
                           const double* r, const double* d, const double* x0, double* dx,
                           double* du, double* nu, double* work, int B, int N, double reg,
                           long long blocks, long long bytes, void* stream) {
  return launch<double>({Q, R, S, A, Bm, q, r, d, x0, dx, du, nu, B, N, reg}, work, blocks,
                        bytes, stream);
}

// Shared memory that one block's scenarios need with their scratch on chip.
extern "C" long long riccati_smem_bytes(int value_bytes, int N) {
  return (rck::kFixed + rck::scratch_values(N)) * (long long)value_bytes * rck::kPerBlock;
}

extern "C" const char* riccati_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif
