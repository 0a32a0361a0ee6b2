// The IRK collocation Newton solve by block LU without pivoting (kernel K3).
//
// Replaces doa_mpc_tpu/ops/integrators.py::_newton_blocks, _block_lu,
// _inv_small and _block_solve (:192-256): plain JAX functions, not a Pallas
// kernel, which XLA fuses into the IRK step on the TPU. Per row (one stage
// point of the controller's linearization, or one plant row), in one launch:
// - the Newton blocks M_ij = (-h A_ij) Jf_i + delta_ij I of the collocation
//   residual R_i = K_i - f(Z_i), an s x s grid of nx x nx blocks;
// - their block LU without pivoting, in JAX's order: for k = 0..s-1 the
//   Gauss-Jordan inverse of M_kk (no pivoting, each pivot row divided by
//   its pivot), then for i > k L_ik = M_ik inv_k and M_ij -= L_ik M_kj;
// - the block-triangular solve of M X = R for the k right-hand-side
//   columns (k = 1 for a Newton step, nx + nu for the sensitivities):
//   forward y_i = r_i - sum_{j<i} L_ij y_j, backward
//   x_k = inv_k (y_k - sum_{j>k} U_kj x_j).
// Pivoting is unnecessary because M = I - h (A (x) Jf) is close to the
// identity (h ||A Jf|| << 1).
//
// Why a kernel: the library's batched pivoted LU (cuSOLVER/MAGMA's
// getrf/getrs through torch.linalg.lu_factor_ex and lu_solve) picks its
// kernel by batch count, and the block LU written out in eager PyTorch is
// about 145 launches per factor-and-solve on a tick whose cost is host
// dispatch. Here each row's arithmetic is one thread's fixed sequence of
// operations: no cross-row reduction and no choice of algorithm by batch
// size or grid, so a row gives the same bits whatever batch it runs in.
//
// What bounds it on the H100: bytes. A row reads s nx^2 + s nx k values and
// writes s nx k: at s = 4, nx = 5, k = 7 that is 380 values, 125 MB in f32
// at the linearization's 81,920 rows, 37 us at 3.35 TB/s; its about 7,000
// multiply-adds take less at the f32 rate. The design is the simple one:
// one thread per row, the s^2 blocks, the inverses and one column of the
// solve in thread-local arrays (local memory past the registers), the
// right-hand-side columns solved one after another. What stands between it
// and the bound is that local-memory traffic and one thread's dependent
// chain (PERF.md).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and without
// --use_fast_math: the divisions by the pivots are IEEE divisions, as in
// the plain version.
//
// The body is __host__ __device__ and has no CUDA dependency outside the
// kernel and its launcher, so the same file compiles as plain C++ (float
// or double) for host-side tests of the arithmetic (irkn::host_solve).

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace irkn {

constexpr int NX = 5;
constexpr int kBlock = 128;                  // threads (rows) per block
constexpr int kUnsupported = -1;             // stage count or width not built

// Gauss-Jordan inverse of one diagonal block without pivoting, on [D | I]
// (JAX's _inv_small): each pivot row divided by its pivot, then every other
// row minus its entry in the pivot column times the pivot row.
template <typename T>
HD void inv_small(const T (&D)[NX][NX], T (&inv)[NX][NX]) {
  T aug[NX][2 * NX];
#pragma unroll
  for (int r = 0; r < NX; ++r) {
#pragma unroll
    for (int q = 0; q < NX; ++q) {
      aug[r][q] = D[r][q];
      aug[r][NX + q] = r == q ? T(1) : T(0);
    }
  }
#pragma unroll
  for (int p = 0; p < NX; ++p) {
    const T piv = aug[p][p];
#pragma unroll
    for (int q = 0; q < 2 * NX; ++q) aug[p][q] = aug[p][q] / piv;
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      if (r == p) continue;
      const T col = aug[r][p];
#pragma unroll
      for (int q = 0; q < 2 * NX; ++q) aug[r][q] = aug[r][q] - col * aug[p][q];
    }
  }
#pragma unroll
  for (int r = 0; r < NX; ++r) {
#pragma unroll
    for (int q = 0; q < NX; ++q) inv[r][q] = aug[r][NX + q];
  }
}

// One row: jf (S, NX, NX), a (S, S), rhs and out (S, NX, K), all
// contiguous; mh = -h in T.
template <typename T, int S, int K>
HD void solve_row(const T* __restrict__ jf, const T* __restrict__ a, T mh,
                  const T* __restrict__ rhs, T* __restrict__ out) {
  T M[S][S][NX][NX];
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = 0; r < NX; ++r) {
#pragma unroll
      for (int q = 0; q < NX; ++q) {
        const T v = jf[(i * NX + r) * NX + q];
        for (int j = 0; j < S; ++j) M[i][j][r][q] = (mh * a[i * S + j]) * v;
      }
    }
  }
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int r = 0; r < NX; ++r) M[k][k][r][r] = M[k][k][r][r] + T(1);
  }

  // block LU: M_ik <- L_ik = M_ik inv_k, M_ij <- M_ij - L_ik M_kj (j > k)
  T inv[S][NX][NX];
  for (int k = 0; k < S; ++k) {
    inv_small(M[k][k], inv[k]);
    for (int i = k + 1; i < S; ++i) {
      T L[NX][NX];
#pragma unroll
      for (int r = 0; r < NX; ++r) {
#pragma unroll
        for (int q = 0; q < NX; ++q) {
          T t = M[i][k][r][0] * inv[k][0][q];
#pragma unroll
          for (int m = 1; m < NX; ++m) t = t + M[i][k][r][m] * inv[k][m][q];
          L[r][q] = t;
        }
      }
#pragma unroll
      for (int r = 0; r < NX; ++r) {
#pragma unroll
        for (int q = 0; q < NX; ++q) M[i][k][r][q] = L[r][q];
      }
      for (int j = k + 1; j < S; ++j) {
#pragma unroll
        for (int r = 0; r < NX; ++r) {
#pragma unroll
          for (int q = 0; q < NX; ++q) {
            T t = (-L[r][0]) * M[k][j][0][q];
#pragma unroll
            for (int m = 1; m < NX; ++m) t = t + (-L[r][m]) * M[k][j][m][q];
            M[i][j][r][q] = M[i][j][r][q] + t;
          }
        }
      }
    }
  }

  // the solve, one right-hand-side column at a time (the columns are
  // independent; each gets the same operations as a lone vector would)
  for (int c = 0; c < K; ++c) {
    T y[S][NX];
    for (int i = 0; i < S; ++i) {             // forward, unit-block-lower
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        T acc = rhs[(i * NX + r) * K + c];
        for (int j = 0; j < i; ++j) {
          T t = M[i][j][r][0] * y[j][0];
#pragma unroll
          for (int m = 1; m < NX; ++m) t = t + M[i][j][r][m] * y[j][m];
          acc = acc - t;
        }
        y[i][r] = acc;
      }
    }
    for (int k = S - 1; k >= 0; --k) {        // backward, block-upper
      T acc[NX];
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        acc[r] = y[k][r];
        for (int j = k + 1; j < S; ++j) {
          T t = M[k][j][r][0] * y[j][0];
#pragma unroll
          for (int m = 1; m < NX; ++m) t = t + M[k][j][r][m] * y[j][m];
          acc[r] = acc[r] - t;
        }
      }
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        T t = inv[k][r][0] * acc[0];
#pragma unroll
        for (int m = 1; m < NX; ++m) t = t + inv[k][r][m] * acc[m];
        y[k][r] = t;                          // x_k, read by the rows above
        out[(k * NX + r) * K + c] = t;
      }
    }
  }
}

template <typename T, int S, int K>
HD void solve_rows(const T* jf, const T* a, double h, const T* rhs, T* out,
                   long long row) {
  solve_row<T, S, K>(jf + row * (S * NX * NX), a, T(-h), rhs + row * (S * NX * K),
                     out + row * (S * NX * K));
}

#ifdef __CUDACC__
template <typename T, int S, int K>
__global__ void __launch_bounds__(kBlock)
irk_newton_kernel(const T* __restrict__ jf, const T* __restrict__ a, double h,
                  const T* __restrict__ rhs, T* __restrict__ out, long long rows) {
  const long long row = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (row < rows) solve_rows<T, S, K>(jf, a, h, rhs, out, row);
}

template <typename T, int S, int K>
int launch(const void* jf, const void* a, double h, const void* rhs, void* out,
           long long rows, void* stream) {
  const long long blocks = (rows + kBlock - 1) / kBlock;
  irk_newton_kernel<T, S, K><<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const T*)jf, (const T*)a, h, (const T*)rhs, (T*)out, rows);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int dispatch_s(int s, const void* jf, const void* a, double h, const void* rhs,
               void* out, long long rows, void* stream) {
  switch (s) {
    case 1: return launch<T, 1, K>(jf, a, h, rhs, out, rows, stream);
    case 2: return launch<T, 2, K>(jf, a, h, rhs, out, rows, stream);
    case 3: return launch<T, 3, K>(jf, a, h, rhs, out, rows, stream);
    case 4: return launch<T, 4, K>(jf, a, h, rhs, out, rows, stream);
    default: return kUnsupported;
  }
}

template <typename T>
int dispatch(int s, int k, const void* jf, const void* a, double h, const void* rhs,
             void* out, long long rows, void* stream) {
  if (rows < 1) return kUnsupported;
  switch (k) {
    case 1: return dispatch_s<T, 1>(s, jf, a, h, rhs, out, rows, stream);
    case 7: return dispatch_s<T, 7>(s, jf, a, h, rhs, out, rows, stream);
    default: return kUnsupported;
  }
}
#else
// the kernel's body on the host, one row after another
template <typename T, int K>
void host_rows_s(int s, const T* jf, const T* a, double h, const T* rhs, T* out,
                 long long rows) {
  for (long long row = 0; row < rows; ++row) {
    switch (s) {
      case 1: solve_rows<T, 1, K>(jf, a, h, rhs, out, row); break;
      case 2: solve_rows<T, 2, K>(jf, a, h, rhs, out, row); break;
      case 3: solve_rows<T, 3, K>(jf, a, h, rhs, out, row); break;
      case 4: solve_rows<T, 4, K>(jf, a, h, rhs, out, row); break;
    }
  }
}

template <typename T>
int host_solve(int s, int k, const T* jf, const T* a, double h, const T* rhs, T* out,
               long long rows) {
  if (s < 1 || s > 4 || rows < 1) return kUnsupported;
  if (k == 1) host_rows_s<T, 1>(s, jf, a, h, rhs, out, rows);
  else if (k == 7) host_rows_s<T, 7>(s, jf, a, h, rhs, out, rows);
  else return kUnsupported;
  return 0;
}
#endif

}  // namespace irkn

#ifdef __CUDACC__
extern "C" int irk_newton_f32(const void* jf, const void* a, double h, const void* rhs,
                              void* out, long long rows, int s, int k, void* stream) {
  return irkn::dispatch<float>(s, k, jf, a, h, rhs, out, rows, stream);
}

extern "C" int irk_newton_f64(const void* jf, const void* a, double h, const void* rhs,
                              void* out, long long rows, int s, int k, void* stream) {
  return irkn::dispatch<double>(s, k, jf, a, h, rhs, out, rows, stream);
}

extern "C" const char* irk_newton_error_string(int rc) {
  if (rc == irkn::kUnsupported)
    return "no instantiation for this stage count (1-4), right-hand-side width (1 or 7) "
           "or an empty batch";
  return cudaGetErrorString((cudaError_t)rc);
}
#endif
