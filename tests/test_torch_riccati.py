"""The Riccati modules of the PyTorch port: ``ops/riccati.py`` (the plain
sweep, the JAX package's ``xla`` path) and ``ops/riccati_fused.py`` (kernel
K2 and its plain version).

- ``riccati_factorize`` / ``riccati_solve`` against JAX's in float64 at
  1e-10, and against the dense-KKT oracle of ``tests/test_riccati.py``.
- ``riccati_solve_fused_ref`` against JAX's K2 in Pallas interpret mode in
  float64 at 1e-12 (one call: the interpreter takes about 25 s here).
- The CUDA source ``csrc/riccati.cu`` compiled with g++ as host C++ (its
  body is ``__host__ __device__``) against the plain version in float64 at
  1e-10, with its scratch laid out as each instantiation keeps it (shared
  memory, device-memory workspace), and on a non-symmetric Q_N. Its launches
  on a card are tested in ``tests/test_torch_cuda.py``.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from doa_mpc_tpu.ops.riccati import riccati_factorize as j_factorize
from doa_mpc_tpu.ops.riccati import riccati_solve as j_solve
from doa_mpc_tpu.ops.riccati_pallas import riccati_solve_fused as j_solve_fused
from doa_mpc_tpu_torch.ops import riccati_fused
from doa_mpc_tpu_torch.ops.riccati import (
    RiccatiFactors, riccati_factorize, riccati_solve)
from doa_mpc_tpu_torch.ops.riccati_fused import riccati_solve_fused, riccati_solve_fused_ref
from test_riccati import _dense_solve, _random_lqr

# argument order of the fused solve; _random_lqr returns A, B, Q, R, S, q, r, d, x0
FUSED_ORDER = (2, 3, 4, 0, 1, 5, 6, 7, 8)


def _batch(n, N, seed=0):
    """``n`` seeded LQRs (``tests/test_riccati._random_lqr``) stacked on a
    leading axis, float64 numpy, in ``_random_lqr``'s order."""
    rng = np.random.default_rng(seed)
    lqrs = [_random_lqr(rng, N=N) for _ in range(n)]
    return [np.stack([lq[i] for lq in lqrs]) for i in range(9)]


def _t(arrays, dtype=torch.float64):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _fused_args(arrays):
    return [arrays[i] for i in FUSED_ORDER]


def test_factorize_and_solve_match_jax_f64():
    A, B, Q, R, S, q, r, d, x0 = _batch(3, N=8)
    reg = 1e-7
    fac = riccati_factorize(*_t((Q, R, S, A, B)), reg=reg)
    assert isinstance(fac, RiccatiFactors)
    x, u, nu = riccati_solve(fac, *_t((q, r, d, x0)))
    jfac = jax.vmap(lambda *a: j_factorize(*a, reg=reg))(*map(jnp.asarray, (Q, R, S, A, B)))
    jx, ju, jnu = jax.vmap(j_solve)(jfac, *map(jnp.asarray, (q, r, d, x0)))
    for got, want, name in ((fac.P, jfac.P, "P"), (fac.Luu, jfac.Luu, "Luu"),
                            (fac.K, jfac.K, "K"), (x, jx, "x"), (u, ju, "u"),
                            (nu, jnu, "nu_dyn")):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10,
                                   err_msg=name)


def test_matches_dense_kkt_and_unbatched_call():
    A, B, Q, R, S, q, r, d, x0 = _batch(2, N=8, seed=1)
    fac = riccati_factorize(*_t((Q, R, S, A, B)))
    x, u, nu = riccati_solve(fac, *_t((q, r, d, x0)))
    for i in range(2):
        x_ref, u_ref, lam_ref = _dense_solve(A[i], B[i], Q[i], R[i], S[i], q[i], r[i],
                                             d[i], x0[i])
        np.testing.assert_allclose(x[i].numpy(), x_ref, atol=1e-8)
        np.testing.assert_allclose(u[i].numpy(), u_ref, atol=1e-8)
        np.testing.assert_allclose(nu[i].numpy(), lam_ref, atol=1e-7)
    # one scenario without a batch axis gives that row of the batch
    fac1 = riccati_factorize(*_t((Q[1], R[1], S[1], A[1], B[1])))
    x1, u1, nu1 = riccati_solve(fac1, *_t((q[1], r[1], d[1], x0[1])))
    for got, want in ((x1, x[1]), (u1, u[1]), (nu1, nu[1])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)


def test_multiple_rhs_on_one_factorization():
    """Factorize once, solve three right-hand sides (the Mehrotra reuse
    pattern): each equals an independent dense solve."""
    A, B, Q, R, S, q, r, d, x0 = _batch(2, N=5, seed=2)
    fac = riccati_factorize(*_t((Q, R, S, A, B)))
    for seed in range(3):
        rng = np.random.default_rng(10 + seed)
        q2, r2 = rng.standard_normal(q.shape), rng.standard_normal(r.shape)
        x, u, _ = riccati_solve(fac, *_t((q2, r2, d, x0)))
        for i in range(2):
            x_ref, u_ref, _ = _dense_solve(A[i], B[i], Q[i], R[i], S[i], q2[i], r2[i],
                                           d[i], x0[i])
            np.testing.assert_allclose(x[i].numpy(), x_ref, atol=1e-8)
            np.testing.assert_allclose(u[i].numpy(), u_ref, atol=1e-8)


def test_failed_cholesky_gives_nan_factor():
    """A Huu that is not positive definite makes a NaN factor (JAX's
    ``cho_factor`` behaviour) instead of raising or returning a partial one."""
    A, B, Q, R, S, q, r, d, x0 = _batch(2, N=3, seed=3)
    R = R.copy()
    R[1, 2] = -1e3 * np.eye(2)
    fac = riccati_factorize(*_t((Q, R, S, A, B)))
    assert torch.isnan(fac.Luu[1, 2]).all()
    assert torch.isfinite(fac.Luu[0]).all()


def test_fused_ref_matches_jax_interpret_f64():
    """The plain version of K2 against JAX's K2 itself (Pallas interpret
    mode on the CPU), float64, Bt = 4, N = 3."""
    arrays = _fused_args(_batch(4, N=3, seed=0))
    want = j_solve_fused(*map(jnp.asarray, arrays), reg=1e-8, interpret=True)
    got = riccati_solve_fused_ref(*_t(arrays), reg=1e-8)
    for g, w, name in zip(got, want, ("x", "u", "nu_dyn")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("N", [1, 8, 20])
def test_fused_ref_matches_plain_sweep_f64(N):
    """K2's formulas (unsymmetrized P_N and Huu, closed-form 2x2 Cholesky)
    solve the same LQR as ``ops/riccati.py``."""
    A, B, Q, R, S, q, r, d, x0 = _batch(3, N=N, seed=N)
    fac = riccati_factorize(*_t((Q, R, S, A, B)), reg=1e-8)
    want = riccati_solve(fac, *_t((q, r, d, x0)))
    got = riccati_solve_fused_ref(*_t((Q, R, S, A, B, q, r, d, x0)), reg=1e-8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


def test_cpu_tensors_run_plain_version_and_count_no_launch():
    arrays = _t(_fused_args(_batch(3, N=4)), torch.float32)
    before = riccati_solve_fused.launches
    got = riccati_solve_fused(*arrays, reg=1e-6)
    assert riccati_solve_fused.launches == before
    want = riccati_solve_fused_ref(*arrays, reg=1e-6)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_cuda_wrapper_validates_inputs():
    """The checks that run before any build or launch on a card."""
    names = ("Q", "R", "S", "A", "B", "q", "r", "d", "x0")
    args = dict(zip(names, _t(_fused_args(_batch(2, N=3)))))
    riccati_fused._check_cuda_inputs(args)
    riccati_fused._check_cuda_inputs({k: v.float() for k, v in args.items()})
    with pytest.raises(TypeError, match="float32 or float64"):
        riccati_fused._check_cuda_inputs({k: v.half() for k, v in args.items()})
    with pytest.raises(TypeError, match="q is torch.float32"):
        riccati_fused._check_cuda_inputs(dict(args, q=args["q"].float()))
    with pytest.raises(ValueError, match="d has shape"):
        riccati_fused._check_cuda_inputs(dict(args, d=args["d"][:, :-1]))
    with pytest.raises(ValueError, match="nx=5"):
        riccati_fused._check_cuda_inputs(dict(args, A=args["A"][..., :4, :4]))
    with pytest.raises(ValueError, match="nu = 2"):
        riccati_solve_fused_ref(*[a[..., :1] if n in ("B",) else a
                                  for n, a in args.items()])


_HARNESS = r"""
#include "riccati.cu"
extern "C" void host_riccati_f64(const double** in, double** out, int B, int N, double reg,
                                 int on_chip) {
  rck::Params<double> p{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8],
                        out[0], out[1], out[2], B, N, reg};
  rck::host_solve<double>(p, on_chip != 0);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    d = tmp_path_factory.mktemp("host_riccati")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libhost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", os.path.dirname(riccati_fused.KERNEL_SOURCE),
                    "-o", str(lib), str(src)], check=True, timeout=120)
    so = ctypes.CDLL(str(lib))
    so.host_riccati_f64.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                                    + [ctypes.c_double, ctypes.c_int])
    return so


def _host_solve(host_kernel, arrays, storage, reg=1e-8):
    """The kernel's body on the host, batch-first in and out, with its
    scratch where the instantiation ``storage`` keeps it."""
    nb, N = arrays[3].shape[:2]
    ins = [a.contiguous() for a in arrays]
    f64 = dict(dtype=torch.float64)
    outs = [torch.full((nb, N + 1, 5), np.nan, **f64), torch.full((nb, N, 2), np.nan, **f64),
            torch.full((nb, N, 5), np.nan, **f64)]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    host_kernel.host_riccati_f64(ptrs(ins), ptrs(outs), nb, N, reg, int(storage == "on_chip"))
    return outs


STORAGE = pytest.mark.parametrize("storage", ["on_chip", "workspace"])


@STORAGE
@pytest.mark.parametrize("N", [1, 2, 3, 20])
def test_kernel_source_on_host_matches_plain_f64(host_kernel, N, storage):
    """The body, built by g++ as one lane per scenario with its scratch in
    the tile's own arrays (the shared-memory instantiation) or in a
    per-scenario workspace slice (the device-memory one), against the plain
    version in float64. N = 1, 2, 3 have fewer stages than the input ring."""
    arrays = _t(_fused_args(_batch(5, N=N, seed=7)))
    want = riccati_solve_fused_ref(*arrays, reg=1e-8)
    for got, w in zip(_host_solve(host_kernel, arrays, storage), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-10)


@STORAGE
def test_kernel_source_keeps_q_n_unsymmetrized(host_kernel, storage):
    """P_N = Q_N as given: the last stage's gains and the costate of stage
    N-1 use the non-symmetric Q_N, as the plain version (and the TPU kernel)
    do; symmetrizing it would change the answer."""
    N = 4
    arrays = _t(_fused_args(_batch(3, N=N, seed=11)))
    Q = arrays[0].clone()
    skew = torch.tensor(np.random.default_rng(12).standard_normal((3, 5, 5)))
    Q[:, N] += 0.5 * (skew - skew.mT)
    arrays[0] = Q
    want = riccati_solve_fused_ref(*arrays, reg=1e-8)
    sym = riccati_solve_fused_ref(*[0.5 * (Q + Q.mT)] + arrays[1:], reg=1e-8)
    assert float((sym[2] - want[2]).abs().max()) > 1e-3
    for got, w in zip(_host_solve(host_kernel, arrays, storage), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-10)


def test_cuda_wrapper_checks_shape_and_dtype_before_contiguity():
    """An input that is both non-contiguous and of the wrong dtype or shape
    gets the dtype or shape message; one that is only non-contiguous is
    refused for that."""
    names = ("Q", "R", "S", "A", "B", "q", "r", "d", "x0")
    args = dict(zip(names, _t(_fused_args(_batch(2, N=3)))))
    strided = args["A"].mT.contiguous().mT
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="A is not contiguous"):
        riccati_fused._check_cuda_inputs(dict(args, A=strided))
    with pytest.raises(TypeError, match="float32 or float64"):
        riccati_fused._check_cuda_inputs(dict(args, A=strided.half()))
    with pytest.raises(TypeError, match="q is torch.float32"):
        riccati_fused._check_cuda_inputs(dict(args, A=strided, q=args["q"].float()))
    with pytest.raises(ValueError, match="d has shape"):
        riccati_fused._check_cuda_inputs(dict(args, A=strided, d=args["d"][:, :-1]))
