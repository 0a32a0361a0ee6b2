// Batched Riccati factorize + solve of LQR problems (kernel K2).
//
// Replaces doa_mpc_tpu/ops/riccati_pallas.py::_riccati_kernel (the TPU
// kernel). Per scenario, in one pass over device memory:
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
// Design (first Hopper version, simple and right before fast):
// - One CUDA thread per scenario; nx = 5 and nu = 2 are compile-time
//   constants (the wrapper checks the shapes), N is a runtime int. The stage
//   matrices live in registers; nothing is carried over from the TPU kernel's
//   128-lane tiles or its padding.
// - Every array is batch-last in device memory, [stage][field][B], so the 32
//   threads of a warp read 32 consecutive values. The per-stage scratch that
//   the forward pass needs (P_{k+1}, K, kff, p_{k+1}: 42 values a stage) goes
//   to a work buffer that the wrapper allocates; the kernel allocates nothing.
// - What bounds it on the H100: at N = 20 each scenario reads 1,755 input
//   values, writes 245 outputs and writes and re-reads 840 scratch values,
//   about 14.7 KB in f32, 60 MB at B = 4096: 18 us at the 3.35 TB/s peak.
//   The stage recursion is serial, so with one warp per SM at B = 4096 the
//   kernel is bound by the latency of each stage's loads and dependent
//   arithmetic, not by bytes. Blocks of 32 threads spread B = 4096 over 128
//   SMs (kThreadsPerBlock), as for K1.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: the 1e-30 floor and the NaN propagation that the solver's
// non-finite guard relies on need IEEE sqrt, division and comparisons.
//
// The body is __host__ __device__ and has no CUDA dependency outside the
// launchers, so the same file compiles as plain C++ (float or double) for
// host-side tests of the arithmetic.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#include <math.h>
#define HD inline
#endif

#include <stddef.h>

namespace rck {

constexpr int NX = 5;
constexpr int NU = 2;
constexpr int kThreadsPerBlock = 32;

HD float vsqrt(float x) { return sqrtf(x); }
HD double vsqrt(double x) { return sqrt(x); }
// NaN-propagating max (jnp.maximum semantics)
template <typename T> HD T pmax(T a, T b) { return (a != a || a > b) ? a : b; }

template <typename T>
struct Params {
  // inputs, batch-last: Q (N+1, NX*NX, B), R (N, NU*NU, B), S (N, NU*NX, B),
  // A (N, NX*NX, B), Bm (N, NX*NU, B), q (N+1, NX, B), r (N, NU, B),
  // d (N, NX, B), x0 (NX, B)
  const T *Q, *R, *S, *A, *Bm, *q, *r, *d, *x0;
  // outputs: dx (N+1, NX, B), du (N, NU, B), nu (N, NX, B)
  T *dx, *du, *nu;
  T* work;  // work_values(N) * B
  int B, N;
  T reg;
};

// Scratch values per scenario: P_{k+1}, K, kff and p_{k+1} for every stage.
HD long long work_values(int N) { return (long long)N * (NX * NX + NU * NX + NU + NX); }

template <typename T>
struct Lqr {
  const Params<T>& p;
  int b;
  T *Ps, *Ks, *kffs, *pns;

  HD Lqr(const Params<T>& p_, int b_) : p(p_), b(b_) {
    size_t nb = (size_t)p.B, N = (size_t)p.N;
    Ps = p.work;
    Ks = Ps + N * NX * NX * nb;
    kffs = Ks + N * NU * NX * nb;
    pns = kffs + N * NU * nb;
  }

  // element f of stage k of a batch-last array whose stages hold w values
  HD size_t ix(int w, int k, int f) const { return ((size_t)k * w + f) * p.B + b; }

  // Solve (L L') x = b for the factor L = (l11, l21, l22).
  HD void chol2_solve(T l11, T l21, T l22, T b0, T b1, T& x0, T& x1) const {
    T y1 = b0 / l11;
    T y2 = (b1 - l21 * y1) / l22;
    x1 = y2 / l22;
    x0 = (y1 - l21 * x1) / l11;
  }

  HD void run() const {
    const int N = p.N;
    T P[NX][NX], pv[NX];
    for (int i = 0; i < NX; ++i) {
      for (int j = 0; j < NX; ++j) P[i][j] = p.Q[ix(NX * NX, N, i * NX + j)];
      pv[i] = p.q[ix(NX, N, i)];
    }

    // ---- backward: factorization and gradient pass -------------------------
    for (int k = N - 1; k >= 0; --k) {
      T A[NX][NX], Bm[NX][NU], dk[NX];
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NX; ++j) {
          Ps[ix(NX * NX, k, i * NX + j)] = P[i][j];          // P_{k+1}
          A[i][j] = p.A[ix(NX * NX, k, i * NX + j)];
        }
        for (int j = 0; j < NU; ++j) Bm[i][j] = p.Bm[ix(NX * NU, k, i * NU + j)];
        pns[ix(NX, k, i)] = pv[i];                            // p_{k+1}
        dk[i] = p.d[ix(NX, k, i)];
      }

      T PB[NX][NU], PA[NX][NX];
      for (int i = 0; i < NX; ++i) {
        for (int j = 0; j < NU; ++j) {
          T acc = T(0);
          for (int l = 0; l < NX; ++l) acc += P[i][l] * Bm[l][j];
          PB[i][j] = acc;
        }
        for (int j = 0; j < NX; ++j) {
          T acc = T(0);
          for (int l = 0; l < NX; ++l) acc += P[i][l] * A[l][j];
          PA[i][j] = acc;
        }
      }
      T Huu[NU][NU], Hux[NU][NX];
      for (int i = 0; i < NU; ++i) {
        for (int j = 0; j < NU; ++j) {
          T acc = T(0);
          for (int l = 0; l < NX; ++l) acc += Bm[l][i] * PB[l][j];
          Huu[i][j] = p.R[ix(NU * NU, k, i * NU + j)] + acc;
        }
        for (int j = 0; j < NX; ++j) {
          T acc = T(0);
          for (int l = 0; l < NX; ++l) acc += Bm[l][i] * PA[l][j];
          Hux[i][j] = p.S[ix(NU * NX, k, i * NX + j)] + acc;
        }
      }
      // 2x2 Cholesky of Huu (reads the lower entry H[1][0], as the TPU kernel)
      T l11 = vsqrt(Huu[0][0] + p.reg);
      T l21 = Huu[1][0] / l11;
      T l22 = vsqrt(pmax(Huu[1][1] + p.reg - l21 * l21, T(1e-30)));

      T K[NU][NX];
      for (int j = 0; j < NX; ++j) {
        T x0, x1;
        chol2_solve(l11, l21, l22, Hux[0][j], Hux[1][j], x0, x1);
        K[0][j] = -x0;
        K[1][j] = -x1;
        Ks[ix(NU * NX, k, j)] = K[0][j];
        Ks[ix(NU * NX, k, NX + j)] = K[1][j];
      }

      T Pdp[NX], m[NU];
      for (int i = 0; i < NX; ++i) {
        T acc = T(0);
        for (int l = 0; l < NX; ++l) acc += P[i][l] * dk[l];
        Pdp[i] = acc + pv[i];
      }
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
        for (int l = 0; l < NX; ++l) acc += Bm[l][i] * Pdp[l];
        m[i] = p.r[ix(NU, k, i)] + acc;
      }
      T kf0, kf1;
      chol2_solve(l11, l21, l22, m[0], m[1], kf0, kf1);
      kffs[ix(NU, k, 0)] = -kf0;
      kffs[ix(NU, k, 1)] = -kf1;

      // P <- sym(Q + (A'PA + Hux'K)),  p <- q + (A'Pdp + K'm)
      T Pk[NX][NX];
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) {
          T aa = T(0), hk = T(0);
          for (int l = 0; l < NX; ++l) aa += A[l][i] * PA[l][j];
          for (int l = 0; l < NU; ++l) hk += Hux[l][i] * K[l][j];
          Pk[i][j] = p.Q[ix(NX * NX, k, i * NX + j)] + (aa + hk);
        }
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NX; ++j) P[i][j] = T(0.5) * (Pk[i][j] + Pk[j][i]);
      for (int i = 0; i < NX; ++i) {
        T ap = T(0), km = T(0);
        for (int l = 0; l < NX; ++l) ap += A[l][i] * Pdp[l];
        for (int l = 0; l < NU; ++l) km += K[l][i] * m[l];
        pv[i] = p.q[ix(NX, k, i)] + (ap + km);
      }
    }

    // ---- forward rollout and costate ---------------------------------------
    T x[NX];
    for (int i = 0; i < NX; ++i) {
      x[i] = p.x0[(size_t)i * p.B + b];
      p.dx[ix(NX, 0, i)] = x[i];
    }
    for (int k = 0; k < N; ++k) {
      T u[NU];
      for (int i = 0; i < NU; ++i) {
        T acc = T(0);
        for (int j = 0; j < NX; ++j) acc += Ks[ix(NU * NX, k, i * NX + j)] * x[j];
        u[i] = acc + kffs[ix(NU, k, i)];
        p.du[ix(NU, k, i)] = u[i];
      }
      T xn[NX];
      for (int i = 0; i < NX; ++i) {
        T ax = T(0), bu = T(0);
        for (int j = 0; j < NX; ++j) ax += p.A[ix(NX * NX, k, i * NX + j)] * x[j];
        for (int j = 0; j < NU; ++j) bu += p.Bm[ix(NX * NU, k, i * NU + j)] * u[j];
        xn[i] = (ax + bu) + p.d[ix(NX, k, i)];
      }
      for (int i = 0; i < NX; ++i) {
        x[i] = xn[i];
        p.dx[ix(NX, k + 1, i)] = x[i];
      }
      for (int i = 0; i < NX; ++i) {
        T acc = T(0);
        for (int j = 0; j < NX; ++j) acc += Ps[ix(NX * NX, k, i * NX + j)] * x[j];
        p.nu[ix(NX, k, i)] = -(acc + pns[ix(NX, k, i)]);
      }
    }
  }
};

template <typename T>
HD void riccati_one(const Params<T>& p, int b) {
  Lqr<T>(p, b).run();
}

}  // namespace rck

extern "C" long long riccati_work_values(int N) { return rck::work_values(N); }

#ifdef __CUDACC__

template <typename T>
__global__ void __launch_bounds__(rck::kThreadsPerBlock) riccati_kernel(rck::Params<T> p) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  rck::riccati_one<T>(p, b);
}

template <typename T>
static int launch(const T* Q, const T* R, const T* S, const T* A, const T* Bm,
                  const T* q, const T* r, const T* d, const T* x0,
                  T* dx, T* du, T* nu, T* work, int B, int N, T reg, void* stream) {
  rck::Params<T> p{Q, R, S, A, Bm, q, r, d, x0, dx, du, nu, work, B, N, reg};
  int blocks = (B + rck::kThreadsPerBlock - 1) / rck::kThreadsPerBlock;
  riccati_kernel<T><<<blocks, rck::kThreadsPerBlock, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int riccati_f32(const float* Q, const float* R, const float* S, const float* A,
                           const float* Bm, const float* q, const float* r, const float* d,
                           const float* x0, float* dx, float* du, float* nu, float* work,
                           int B, int N, float reg, void* stream) {
  return launch<float>(Q, R, S, A, Bm, q, r, d, x0, dx, du, nu, work, B, N, reg, stream);
}

extern "C" int riccati_f64(const double* Q, const double* R, const double* S,
                           const double* A, const double* Bm, const double* q,
                           const double* r, const double* d, const double* x0, double* dx,
                           double* du, double* nu, double* work, int B, int N, double reg,
                           void* stream) {
  return launch<double>(Q, R, S, A, Bm, q, r, d, x0, dx, du, nu, work, B, N, reg, stream);
}

extern "C" const char* riccati_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif
