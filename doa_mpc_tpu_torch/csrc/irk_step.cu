// One implicit Runge-Kutta step of the unicycle per row (kernel K3).
//
// Replaces the JAX package's IRK step, doa_mpc_tpu/ops/integrators.py::
// irk_step with its custom_jvp rule (:150-190) and the block LU it calls,
// _newton_blocks, _block_lu, _inv_small, _block_solve (:192-256): plain JAX
// functions, not a Pallas kernel, which XLA fuses into one program on the
// TPU. Specialized to the unicycle f(s, u) = (v cos psi, v sin psi, omega,
// u_a, u_alpha) (models/unicycle.py), whose Jacobians are closed-form. Per
// row (a plant row, or one stage point of the controller's linearization),
// in one launch, for each of num_steps substeps of size h:
// - K_i = f(x, u) for the s stages;
// - newton_iter times: Z_i = x + h sum_j A_ij K_j (summed in the order
//   j = 0, 1, ...), R = K - f(Z, u), the blocks M_ij = delta_ij I
//   + (-h A_ij) Jf(Z_i), their block LU without pivoting in JAX's order
//   (for k = 0..s-1 the Gauss-Jordan inverse of M_kk, each pivot row
//   divided by its pivot; L_ik = M_ik inv_k; M_ij -= L_ik M_kj), the
//   block-triangular solve of M dK = R and K -= dK;
// - with sensitivities: at the converged stage states one more
//   factorization and the 7-column solve M dK = [Jf | Ju], the substep's
//   D = [I | 0] + h sum_j b_j dK_j, chained over the substeps
//   (D <- [Ds_x D_x | Ds_x D_u + Ds_u], each entry a sum in a fixed order);
// - Phi = x + h sum_j b_j K_j, the next substep's x.
// Pivoting is unnecessary because M = I - h (A (x) Jf) is close to the
// identity (h ||A Jf|| << 1).
//
// What bounds it on the H100: bytes. A row reads 7 values and writes 5, or
// 40 with D: 15.4 MB at the linearization's 81,920 rows, 0.0046 ms at 3.35
// TB/s. Jf vanishes outside rows 0-2 x columns 2-4, so every block of M is
// delta_ij I outside that 3 x 3 corner, before and after the factorization;
// the kernel computes the corner only (the Gauss-Jordan inverse comes down
// to pivot 2 and two columns), each entry by the dense block LU's own
// expression, so it gives the dense computation's bits. Those expressions
// multiply and add the blocks' known zeros and ones, so the code does
// several times the operations its outputs need: 1,987 a row at s = 4 with 3
// Newton iterations and D (csrc/op_count.cpp), 0.0024 ms at 67 TFLOP/s. The
// design: a team of kTeam lanes per row, the row's blocks, the Gauss-Jordan
// buffer (aliased with the right-hand sides), the stages and D in shared
// memory, one warp per block holding 32 / kTeam rows. Every phase is a
// set of work items (an output element, a row of a block product, a column
// of a pivot step or of a solve) that the team's lanes share, followed by
// __syncwarp over the team. Lanes split outputs, never a sum: each output
// is computed by the chain of operations one thread would run, so a row
// gives the same bits whatever batch it runs in and whatever the team size
// (kTeam = 8 was the fastest of 1-32 on the H100, scripts/k3_team.py).
// What stands between it and the bound: the dependent chain of phases per
// row (104 at s = 4 with 3 Newton iterations and D; a factorization is 14)
// and shared-memory traffic.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: divisions by the pivots are IEEE divisions and sin/cos
// the precise ones, as in the plain version (ops/integrators.py).
//
// The row's body is __host__ __device__ and has no CUDA dependency outside
// the kernel and its launcher; on the host a team is one lane and the sync
// is empty, so the same file compiles as plain C++ (float or double) for
// host-side tests (irks::host_step), which can also walk each phase's items
// in reverse to show that no item reads what another item of its phase
// writes.

#include <math.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

#ifndef IRK_TEAM
#define IRK_TEAM 8
#endif

namespace irks {

constexpr int NX = 5, NU = 2, NC = NX + NU;  // state, control, D's columns
constexpr int kMaxStages = 4;
constexpr int kP = 3, kQ0 = 2;               // Jf's rows 0-2, columns 2-4
constexpr int kTeam = IRK_TEAM;              // lanes per row
constexpr int kThreads = 32;                 // one warp per block
constexpr int kRows = kThreads / kTeam;      // rows per block
constexpr int kUnsupported = -1;             // stage count, batch or team not built
static_assert(kTeam >= 1 && kTeam <= 32 && 32 % kTeam == 0,
              "a team is a power of two up to a warp");

HD float sin_(float a) { return sinf(a); }
HD float cos_(float a) { return cosf(a); }
HD double sin_(double a) { return sin(a); }
HD double cos_(double a) { return cos(a); }

// The tableau, shared by a block's rows: A, (-h) A as the plain version
// forms it (a T(-h) times A_ij), b and h, in T.
template <typename T>
struct Tab {
  T A[kMaxStages][kMaxStages], hA[kMaxStages][kMaxStages], b[kMaxStages], h;
};

template <typename T>
HD void fill_tab(Tab<T>& tb, const T* A, const T* b, double h, int s, int lane, int size) {
  for (int e = lane; e < s * s; e += size) {
    const int i = e / s, j = e % s;
    tb.A[i][j] = A[e];
    tb.hA[i][j] = T(-h) * A[e];
  }
  for (int e = lane; e < s; e += size) tb.b[e] = b[e];
  if (lane == 0) tb.h = T(h);
}

// One row's working set in shared memory.
template <typename T, int S, bool SENS>
struct Row {
  static constexpr int KC = SENS ? NC : 1;             // widest right-hand side
  static constexpr int kAug = NX * 2 * NX;             // [M_kk | I] after pivot 2
  static constexpr int kX = S * NX * KC;
  static constexpr int kW = kAug > kX ? kAug : kX;
  // the Newton blocks; after a factorization L_ij below the diagonal, U_ij
  // above it and inv(M_kk) on it (the solve reads no M_kk). Every block
  // is delta_ij I outside rows 0-2 x columns 2-4 (kP x kQ), before and
  // after the factorization: Jf vanishes there, and the products, sums and
  // inverses below keep that support. Those entries are set once per row
  // and only the kP x kQ ones are computed; each is computed by the same
  // expression over all NX terms as in a dense block LU, so the bits are
  // those of the dense computation.
  T M[S][S][NX][NX];
  // the Gauss-Jordan buffer during a factorization, the right-hand sides
  // (solved in place) after it
  T W[kW];
  T K[S][NX], Z[S][NX], cs[S], sn[S];                  // stages, cos/sin of psi at Z
  T x[NX], u[NU];
  T D[SENS ? NX : 1][NC];                              // chained sensitivities
  HD T& aug(int r, int q) { return W[r * 2 * NX + q]; }
  HD T& X(int i, int r, int c) { return W[(i * NX + r) * KC + c]; }
};

// A row's lanes. On the card: this lane's place in the team, the team's
// lanes in the warp. On the host one lane, which may walk items backwards.
struct Team {
  int lane;
  unsigned mask;
  bool reverse;
};

// (on the card the item loops stay loops: unrolled, f32 s=1 with D spilled)
#ifdef __CUDA_ARCH__
#define FOR_ITEMS(e, n) _Pragma("unroll 1") for (int e = t.lane; e < (n); e += kTeam)
#else
#define FOR_ITEMS(e, n)                                                    \
  for (int e##_i = 0, e##_n = (n); e##_i < e##_n; ++e##_i)                 \
    for (int e = t.reverse ? e##_n - 1 - e##_i : e##_i, e##_1 = 1; e##_1; \
         e##_1 = 0)
#endif

template <typename T, int S, bool SENS>
struct Step {
  Row<T, S, SENS>& m;
  const Tab<T>& tb;
  const Team t;

  HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(t.mask);
#endif
  }

  // f_n at state z, with c = cos(z_2), s = sin(z_2) where f_n needs them
  HD T f(int n, const T* z, T c, T s) const {
    switch (n) {
      case 0: return z[3] * c;
      case 1: return z[3] * s;
      case 2: return z[4];
      default: return m.u[n - 3];
    }
  }

  // d f_r / d z_q at stage state Z_i (the values jacfwd gives)
  HD T jf(int i, int r, int q) const {
    const T v = m.Z[i][3];
    if (r == 0) return q == 2 ? -(v * m.sn[i]) : q == 3 ? m.cs[i] : T(0);
    if (r == 1) return q == 2 ? v * m.cs[i] : q == 3 ? m.sn[i] : T(0);
    if (r == 2) return q == 4 ? T(1) : T(0);
    return T(0);
  }

  // K_i = f(x, u)
  HD void init_stages() {
    FOR_ITEMS(e, S * NX) {
      const int i = e / NX, n = e % NX;
      const T c = n == 0 ? cos_(m.x[2]) : T(0), s = n == 1 ? sin_(m.x[2]) : T(0);
      m.K[i][n] = f(n, m.x, c, s);
    }
    sync();
  }

  // Z_i = x + h sum_j A_ij K_j, then cos/sin of psi there (a phase of its
  // own: computed in the first one, the f32 s=1 instantiation spilled)
  HD void stage_states() {
    FOR_ITEMS(e, S * NX) {
      const int i = e / NX, n = e % NX;
      T acc = tb.A[i][0] * m.K[0][n];
      for (int j = 1; j < S; ++j) acc = acc + tb.A[i][j] * m.K[j][n];
      m.Z[i][n] = m.x[n] + tb.h * acc;
    }
    sync();
    FOR_ITEMS(i, 2 * S) {
      if (i < S) m.cs[i] = cos_(m.Z[i][2]);
      else m.sn[i - S] = sin_(m.Z[i - S][2]);
    }
    sync();
  }

  // delta_ij I in every block (the entries outside kP x kQ keep it)
  HD void init_blocks() {
    FOR_ITEMS(e, S * S * NX) {
      const int r = e % NX, j = (e / NX) % S, i = e / (NX * S);
#pragma unroll
      for (int q = 0; q < NX; ++q) m.M[i][j][r][q] = i == j && q == r ? T(1) : T(0);
    }
    sync();
  }

  // M_ij = (-h A_ij) Jf(Z_i) + delta_ij I on kP x kQ, one block row per item
  HD void blocks() {
    FOR_ITEMS(e, S * S * kP) {
      const int r = e % kP, j = (e / kP) % S, i = e / (kP * S);
      const T a = tb.hA[i][j];
#pragma unroll
      for (int q = kQ0; q < NX; ++q) {
        T v = a * jf(i, r, q);
        if (i == j && q == r) v = v + T(1);
        m.M[i][j][r][q] = v;
      }
    }
    sync();
  }

  // [M_kk | I]'s entry (r, q)
  HD T gj(int k, int r, int q) const {
    return q < NX ? m.M[k][k][r][q] : (q - NX == r ? T(1) : T(0));
  }

  // the entry (r, q) after pivot 2, which changes columns 3, 4 and 7 only
  HD T gj2(int k, int r, int q) {
    return q == 3 || q == 4 || q == NX + 2 ? m.aug(r, q) : gj(k, r, q);
  }

  // inv(M_kk) by Gauss-Jordan on [M_kk | I] without pivoting (JAX's
  // _inv_small), into M_kk. Pivot p divides row p by its pivot and takes
  // (entry in column p) x (divided row p) from every other row. M_kk is the
  // identity outside kP x kQ, so pivots 0 and 1 (pivot 1, column p = e_p)
  // leave every entry as it was (x / 1, x - 0 d); pivot 2 changes columns 3,
  // 4 and 7 (the divided row is 0 elsewhere), pivot 3 only column 8 and
  // pivot 4 only column 9 (row p = e_p), and those two read nothing the
  // other writes. An item is one column, with the dense step's expression
  // for each of its NX entries; the right half is the inverse, which is the
  // identity in columns 5 and 6.
  HD void invert(int k) {
    FOR_ITEMS(e, 3) {
      const int q = e < 2 ? 3 + e : NX + 2;
      const T d = gj(k, 2, q) / gj(k, 2, 2);
#pragma unroll
      for (int r = 0; r < NX; ++r) m.aug(r, q) = r == 2 ? d : gj(k, r, q) - gj(k, r, 2) * d;
    }
    sync();
    FOR_ITEMS(e, 3) {
      if (e == 0) {
#pragma unroll
        for (int r = 0; r < NX; ++r) m.M[k][k][r][2] = m.aug(r, NX + 2);
      } else {
        const int p = 2 + e, q = NX + p;
        const T d = gj2(k, p, q) / gj2(k, p, p);
#pragma unroll
        for (int r = 0; r < NX; ++r)
          m.M[k][k][r][p] = r == p ? d : gj2(k, r, q) - gj2(k, r, p) * d;
      }
    }
    sync();
  }

  // block LU without pivoting (JAX's _block_lu): for k = 0..S-1, inv_k,
  // then L_ik = M_ik inv_k (i > k), then M_ij += (-L_ik) M_kj (i, j > k);
  // an item is one row of one block, its kQ columns
  HD void factor() {
#pragma unroll 1
    for (int k = 0; k < S; ++k) {
      invert(k);
      const int n = S - 1 - k;
      if (n == 0) break;
      FOR_ITEMS(e, n * kP) {
        const int i = k + 1 + e / kP, r = e % kP;
        T row[NX];
#pragma unroll
        for (int c = 0; c < NX; ++c) row[c] = m.M[i][k][r][c];
#pragma unroll
        for (int q = kQ0; q < NX; ++q) {
          T acc = row[0] * m.M[k][k][0][q];
#pragma unroll
          for (int c = 1; c < NX; ++c) acc = acc + row[c] * m.M[k][k][c][q];
          m.M[i][k][r][q] = acc;
        }
      }
      sync();
      FOR_ITEMS(e, n * n * kP) {
        const int r = e % kP, j = k + 1 + (e / kP) % n, i = k + 1 + e / (kP * n);
        T l[NX];
#pragma unroll
        for (int c = 0; c < NX; ++c) l[c] = -m.M[i][k][r][c];
#pragma unroll
        for (int q = kQ0; q < NX; ++q) {
          T acc = l[0] * m.M[k][j][0][q];
#pragma unroll
          for (int c = 1; c < NX; ++c) acc = acc + l[c] * m.M[k][j][c][q];
          m.M[i][j][r][q] = m.M[i][j][r][q] + acc;
        }
      }
      sync();
    }
  }

  // the Newton right-hand side R_i = K_i - f(Z_i, u)
  HD void residual() {
    FOR_ITEMS(e, S * NX) {
      const int i = e / NX, n = e % NX;
      m.X(i, n, 0) = m.K[i][n] - f(n, m.Z[i], m.cs[i], m.sn[i]);
    }
    sync();
  }

  // the sensitivities' right-hand sides [Jf_i | Ju_i]
  HD void jacobians() {
    FOR_ITEMS(e, S * NX) {
      const int i = e / NX, r = e % NX;
#pragma unroll
      for (int q = 0; q < NX; ++q) m.X(i, r, q) = jf(i, r, q);
#pragma unroll
      for (int q = 0; q < NU; ++q) m.X(i, r, NX + q) = r == NX - NU + q ? T(1) : T(0);
    }
    sync();
  }

  // the block-triangular solve of the factored M for kc columns, in place
  // (JAX's _block_solve, each column as it solves one vector): forward
  // y_i = r_i - sum_{j<i} L_ij y_j, an item per entry; backward
  // x_k = inv_k (y_k - sum_{j>k} U_kj x_j), an item per column. With
  // newton, K_k -= x_k as each x_k is found. Rows kP.. of L_ij, U_kj and
  // inv_k - I are 0, so there y and x are r (the dense sums add zeros).
  HD void solve(int kc, bool newton) {
#pragma unroll 1
    for (int i = 1; i < S; ++i) {
      FOR_ITEMS(e, kP * kc) {
        const int r = e / kc, c = e % kc;
        T acc = m.X(i, r, c);
        for (int j = 0; j < i; ++j) {
          T s = m.M[i][j][r][0] * m.X(j, 0, c);
#pragma unroll
          for (int q = 1; q < NX; ++q) s = s + m.M[i][j][r][q] * m.X(j, q, c);
          acc = acc - s;
        }
        m.X(i, r, c) = acc;
      }
      sync();
    }
#pragma unroll 1
    for (int k = S - 1; k >= 0; --k) {
      FOR_ITEMS(c, kc) {
        T acc[NX];
#pragma unroll
        for (int r = 0; r < NX; ++r) {
          acc[r] = m.X(k, r, c);
          if (r >= kP) continue;
          for (int j = k + 1; j < S; ++j) {
            T s = m.M[k][j][r][0] * m.X(j, 0, c);
#pragma unroll
            for (int q = 1; q < NX; ++q) s = s + m.M[k][j][r][q] * m.X(j, q, c);
            acc[r] = acc[r] - s;
          }
        }
#pragma unroll
        for (int r = 0; r < NX; ++r) {
          T s = acc[r];
          if (r < kP) {
            s = m.M[k][k][r][0] * acc[0];
#pragma unroll
            for (int q = 1; q < NX; ++q) s = s + m.M[k][k][r][q] * acc[q];
            m.X(k, r, c) = s;
          }
          if (newton) m.K[k][r] = m.K[k][r] - s;
        }
      }
      sync();
    }
  }

  // the substep's Ds = [I | 0] + h sum_j b_j dK_j; D = Ds on the first
  // substep, else D <- [Ds_x D_x | Ds_x D_u + Ds_u], an item per column
  HD void sensitivities(bool first) {
    FOR_ITEMS(e, NX * NC) {
      const int r = e / NC, c = e % NC;
      T acc = tb.b[0] * m.X(0, r, c);
      for (int j = 1; j < S; ++j) acc = acc + tb.b[j] * m.X(j, r, c);
      const T v = (r == c ? T(1) : T(0)) + tb.h * acc;
      if (first) m.D[r][c] = v;
      else m.X(0, r, c) = v;
    }
    sync();
    if (first) return;
    FOR_ITEMS(c, NC) {
      T col[NX];
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        T s = m.X(0, r, 0) * m.D[0][c];
#pragma unroll
        for (int q = 1; q < NX; ++q) s = s + m.X(0, r, q) * m.D[q][c];
        col[r] = c < NX ? s : s + m.X(0, r, c);
      }
#pragma unroll
      for (int r = 0; r < NX; ++r) m.D[r][c] = col[r];
    }
    sync();
  }

  // x <- Phi = x + h sum_j b_j K_j
  HD void advance() {
    FOR_ITEMS(n, NX) {
      T acc = tb.b[0] * m.K[0][n];
      for (int j = 1; j < S; ++j) acc = acc + tb.b[j] * m.K[j][n];
      m.x[n] = m.x[n] + tb.h * acc;
    }
    sync();
  }

  HD void run(const T* x, const T* u, int newton_iter, int num_steps, T* phi, T* D) {
    FOR_ITEMS(e, NX + NU) {
      if (e < NX) m.x[e] = x[e];
      else m.u[e - NX] = u[e - NX];
    }
    init_blocks();
#pragma unroll 1
    for (int step = 0; step < num_steps; ++step) {
      init_stages();
#pragma unroll 1
      for (int it = 0; it < newton_iter; ++it) {
        stage_states();
        blocks();
        factor();
        residual();
        solve(1, true);
      }
      if constexpr (SENS) {
        stage_states();
        blocks();
        factor();
        jacobians();
        solve(NC, false);
        sensitivities(step == 0);
      }
      advance();
    }
    FOR_ITEMS(e, NX) phi[e] = m.x[e];
    if constexpr (SENS) {
      FOR_ITEMS(e, NX * NC) D[e] = m.D[e / NC][e % NC];
    }
  }
};

// bytes of shared memory: the tableau, then one row after another at a
// stride of 8 (mod 32) values, so that the 32 / kTeam teams of a warp start
// in different banks
template <typename T>
HD constexpr size_t tab_bytes() {
  return (sizeof(Tab<T>) + 15) / 16 * 16;
}

template <typename T, int S, bool SENS>
HD constexpr size_t row_stride() {
  return ((sizeof(Row<T, S, SENS>) / sizeof(T) + 31) / 32 * 32 + 8) * sizeof(T);
}

template <typename T, int S, bool SENS>
HD constexpr size_t smem_bytes() {
  return tab_bytes<T>() + kRows * row_stride<T, S, SENS>();
}

#ifdef __CUDACC__
extern __shared__ double k3_smem[];

template <typename T, int S, bool SENS>
__global__ void __launch_bounds__(kThreads)
irk_step_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ A,
                const T* __restrict__ b, double h, int newton_iter, int num_steps,
                T* __restrict__ phi, T* __restrict__ D, long long rows) {
  unsigned char* base = reinterpret_cast<unsigned char*>(k3_smem);
  Tab<T>& tb = *reinterpret_cast<Tab<T>*>(base);
  fill_tab(tb, A, b, h, S, threadIdx.x, kThreads);
  __syncthreads();
  const int slot = threadIdx.x / kTeam;
  const long long row = (long long)blockIdx.x * kRows + slot;
  if (row >= rows) return;
  Row<T, S, SENS>& m = *reinterpret_cast<Row<T, S, SENS>*>(
      base + tab_bytes<T>() + slot * row_stride<T, S, SENS>());
  const unsigned mask =
      (kTeam == 32 ? 0xffffffffu : ((1u << kTeam) - 1u)) << (threadIdx.x % 32 / kTeam * kTeam);
  Step<T, S, SENS> st{m, tb, Team{(int)(threadIdx.x % kTeam), mask, false}};
  st.run(x + row * NX, u + row * NU, newton_iter, num_steps, phi + row * NX,
         SENS ? D + row * NX * NC : nullptr);
}

template <typename T, int S, bool SENS>
int launch(const void* x, const void* u, const void* A, const void* b, double h,
           int newton_iter, int num_steps, void* phi, void* D, long long rows, void* stream) {
  constexpr size_t smem = smem_bytes<T, S, SENS>();
  const long long blocks = (rows + kRows - 1) / kRows;
  irk_step_kernel<T, S, SENS><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)u, (const T*)A, (const T*)b, h, newton_iter, num_steps, (T*)phi,
      (T*)D, rows);
  return (int)cudaGetLastError();
}

template <typename T, bool SENS>
int dispatch_s(int s, const void* x, const void* u, const void* A, const void* b, double h,
               int newton_iter, int num_steps, void* phi, void* D, long long rows,
               void* stream) {
  switch (s) {
    case 1: return launch<T, 1, SENS>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
    case 2: return launch<T, 2, SENS>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
    case 3: return launch<T, 3, SENS>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
    case 4: return launch<T, 4, SENS>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch(int s, const void* x, const void* u, const void* A, const void* b, double h,
             int newton_iter, int num_steps, void* phi, void* D, long long rows, void* stream) {
  if (rows < 1 || newton_iter < 0 || num_steps < 1) return kUnsupported;
  if (D) return dispatch_s<T, true>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
  return dispatch_s<T, false>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
}

// shared memory per block and blocks resident per SM (occupancy API); the
// instantiation's shared-memory limit is set to what it needs, which its
// launches rely on above the default 48 KB (a team under 4): the wrapper
// makes the plan once per device and instantiation, before its first launch
template <typename T, bool SENS>
int plan_s(int s, size_t* smem, int* per_sm) {
  switch (s) {
#define K3_PLAN(S_)                                                                       \
  case S_: {                                                                             \
    *smem = smem_bytes<T, S_, SENS>();                                                   \
    cudaError_t rc = cudaFuncSetAttribute(irk_step_kernel<T, S_, SENS>,                  \
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                                          (int)*smem);                                   \
    if (rc == cudaSuccess)                                                               \
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, irk_step_kernel<T, S_, SENS>, \
                                                         kThreads, *smem);               \
    return (int)rc;                                                                      \
  }
    K3_PLAN(1) K3_PLAN(2) K3_PLAN(3) K3_PLAN(4)
#undef K3_PLAN
    default: return kUnsupported;
  }
}
#else
// the kernel's body on the host: one lane per row, one row after another,
// in a working set filled with NaN before each row (a read of an entry no
// phase wrote shows in the output)
template <typename T, int S, bool SENS>
void host_rows(const T* x, const T* u, const T* A, const T* b, double h, int newton_iter,
               int num_steps, T* phi, T* D, long long rows, bool reverse) {
  Tab<T> tb;
  fill_tab(tb, A, b, h, S, 0, 1);
  Row<T, S, SENS>* m = new Row<T, S, SENS>;
  for (long long row = 0; row < rows; ++row) {
    memset((void*)m, 0xff, sizeof(*m));
    Step<T, S, SENS> st{*m, tb, Team{0, 0u, reverse}};
    st.run(x + row * NX, u + row * NU, newton_iter, num_steps, phi + row * NX,
           SENS ? D + row * NX * NC : nullptr);
  }
  delete m;
}

template <typename T>
int host_step(int s, const T* x, const T* u, const T* A, const T* b, double h, int newton_iter,
              int num_steps, T* phi, T* D, long long rows, bool reverse) {
  if (rows < 1 || newton_iter < 0 || num_steps < 1) return kUnsupported;
#define K3_HOST(S_)                                                                        \
  case S_:                                                                                \
    if (D) host_rows<T, S_, true>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, reverse); \
    else host_rows<T, S_, false>(x, u, A, b, h, newton_iter, num_steps, phi, D, rows, reverse); \
    return 0;
  switch (s) {
    K3_HOST(1) K3_HOST(2) K3_HOST(3) K3_HOST(4)
    default: return kUnsupported;
  }
#undef K3_HOST
}
#endif

}  // namespace irks

#ifdef __CUDACC__
extern "C" int irk_step_f32(const void* x, const void* u, const void* A, const void* b, double h,
                            int newton_iter, int num_steps, void* phi, void* D, long long rows,
                            int s, void* stream) {
  return irks::dispatch<float>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
}

extern "C" int irk_step_f64(const void* x, const void* u, const void* A, const void* b, double h,
                            int newton_iter, int num_steps, void* phi, void* D, long long rows,
                            int s, void* stream) {
  return irks::dispatch<double>(s, x, u, A, b, h, newton_iter, num_steps, phi, D, rows, stream);
}

// shared memory per block (bytes) and blocks resident per SM of the
// instantiation for (s, sensitivities, f64), see plan_s; the team and rows
// per block
extern "C" int irk_step_plan(int s, int sens, int f64, long long* smem, int* per_sm) {
  size_t bytes = 0;
  const int rc = f64 ? (sens ? irks::plan_s<double, true>(s, &bytes, per_sm)
                             : irks::plan_s<double, false>(s, &bytes, per_sm))
                     : (sens ? irks::plan_s<float, true>(s, &bytes, per_sm)
                             : irks::plan_s<float, false>(s, &bytes, per_sm));
  *smem = (long long)bytes;
  return rc;
}

extern "C" int irk_step_team() { return irks::kTeam; }
extern "C" int irk_step_rows_per_block() { return irks::kRows; }

extern "C" const char* irk_step_error_string(int rc) {
  if (rc == irks::kUnsupported)
    return "no instantiation for this stage count (1-4), or an empty batch, a negative "
           "Newton iteration count or no substep";
  return cudaGetErrorString((cudaError_t)rc);
}
#endif
