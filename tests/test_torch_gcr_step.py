"""K7's step (operators/cuda_gcr.gcr_step: the whole GCR iteration after
the operator apply) on the CPU, where the wrapper takes its plain version,
gcr_step_plain:

  (a) step by step against one restart of the JAX package's device_gcr
      (ddalphaamg_tpu/solvers/device_gmres.py:100-152) on the same
      numpy-seeded right-hand side and dense operator: after iterations
      j = 0, 1, m // 2 and m - 1, x, r (against b - A x of the JAX
      iterate), |r| and the iteration count against the JAX restart of
      length j + 1, and rows W_j / Q_j against the JAX body's einsum
      Gram-Schmidt (device_gmres.py:111-119) of the same w and earlier
      rows; complex64 (1e-5) and complex128 (1e-12);
  (b) a frozen lane (converged, or masked off by `active`) keeps x, r,
      |r|, its iteration count and its aux sum bit for bit, enters the
      preconditioner as zeros and gets zero rows, while the other lane
      iterates;
  (c) under the stand-in capture (tests/torch_graph_stub.StubGraph, which
      refuses every host read) the step reads nothing from the device, at
      batch 1 and batch 2 with aux counters, and gives the host loop's
      bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_graph_stub import StubGraph
from torch_parity import rel_err

from ddalphaamg_tpu import cplx
from ddalphaamg_tpu.solvers.device_gmres import device_gcr as jax_device_gcr
from ddalphaamg_tpu_torch.operators import cuda_gcr
from ddalphaamg_tpu_torch.solvers.device_gmres import GCRLanes

torch.set_num_threads(1)

N, M = 48, 8
DTYPES = {"complex64": (np.complex64, 1e-5), "complex128": (np.complex128, 1e-12)}


def _problem(dtype, seed=3):
    """A well-conditioned dense operator A = 1 + 0.3 G / sqrt(N) and a
    right-hand side b, complex numpy arrays from a seed."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(N, N)) + 1j * rng.normal(size=(N, N))
    A = (np.eye(N) + 0.3 * G / np.sqrt(N)).astype(dtype)
    b = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(dtype)
    return A, b


def _jax_rows(W, Q, w, q, j):
    """Rows j of the JAX body (device_gmres.py:111-119) from the earlier
    rows W, Q [j, n] and w, q [n]."""
    Wc, Qc = jnp.asarray(W[:j]), jnp.asarray(Q[:j])
    wf, qf = jnp.asarray(w), jnp.asarray(q)
    h = cplx.einsum("in,n->i", cplx.conj(Wc), wf, karatsuba=False, precision="highest")
    wf = wf - cplx.einsum("i,in->n", h, Wc, karatsuba=False, precision="highest")
    qf = qf - cplx.einsum("i,in->n", h, Qc, karatsuba=False, precision="highest")
    wn2 = cplx.norm2(wf)
    inv = jax.lax.rsqrt(jnp.where(wn2 == 0, 1.0, wn2))
    return np.asarray(wf * inv), np.asarray(qf * inv)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_step_matches_the_jax_restart(dtype):
    npdt, tol = DTYPES[dtype]
    A, b = _problem(npdt)
    tA = torch.as_tensor(A)

    def apply_op(v):                                    # [1, N]
        return v @ tA.T

    st = GCRLanes(torch.as_tensor(b)[None], M, 0.0)
    st.restart(apply_op)
    Aj = jnp.asarray(A)
    for j in range(M):
        W0, Q0 = st.W[0].clone().numpy(), st.Q[0].clone().numpy()
        q = st.r.clone()
        w = apply_op(q)
        st.step(j, apply_op)
        if j not in (0, 1, M // 2, M - 1):
            continue
        ww, wq = _jax_rows(W0, Q0, w[0].numpy(), q[0].numpy(), j)
        assert rel_err(st.W[0, j].numpy(), ww) < tol and rel_err(st.Q[0, j].numpy(), wq) < tol
        x, iters, relres2, _ = jax_device_gcr(lambda v: Aj @ v, jnp.asarray(b), j + 1, 0.0)
        x = np.asarray(x)
        assert rel_err(st.x[0].numpy(), x) < tol
        # the residuals against |b|: both recurrences carry rounding of |b|
        bn = np.linalg.norm(b)
        true_r = b.astype(np.complex128) - A.astype(np.complex128) @ x.astype(np.complex128)
        assert np.abs(st.r[0].numpy() - true_r).max() < tol * np.abs(b).max()
        assert abs(float(st.rn[0]) - np.sqrt(float(relres2)) * bn) <= tol * bn
        assert int(st.iters[0]) == int(iters) == j + 1 and bool(st.go[0])


def _lanes_problem(dtype=torch.complex128):
    """Three lanes of one operator: lane 0 iterates, lane 1 has converged
    (a tolerance above 1), lane 2 is masked off."""
    A, _ = _problem(np.complex128, seed=5)
    tA = torch.as_tensor(A).to(dtype)
    rng = np.random.default_rng(6)
    b = torch.as_tensor(rng.normal(size=(3, N)) + 1j * rng.normal(size=(3, N))).to(dtype)
    tol = torch.tensor([1e-12, 10.0, 1e-12], dtype=torch.float64)
    active = torch.tensor([True, True, False])
    return tA, b, tol, active


def _prec(v):
    """A preconditioner with counters: z = 2 v, aux = [1, |v|^2 > 0, 0]."""
    aux = torch.stack([torch.ones(v.shape[0], dtype=torch.float64),
                       (v.abs() ** 2).sum(dim=-1).gt(0).double(),
                       torch.zeros(v.shape[0], dtype=torch.float64)], dim=1)
    return 2 * v, aux


def test_frozen_lanes_keep_their_bits():
    tA, b, tol, active = _lanes_problem()

    def apply_op(v):
        return v @ tA.T

    st = GCRLanes(b, M, tol, active=active, n_aux=3)
    st.restart(apply_op)
    assert st.go.tolist() == [True, False, False]
    before = [t[1:].clone() for t in (st.x, st.r, st.rn, st.iters, st.aux_sum)]
    assert not st.rz[1:].any() and torch.equal(st.rz[0], st.r[0])
    for j in range(4):
        st.step(j, apply_op, _prec)
    after = [t[1:] for t in (st.x, st.r, st.rn, st.iters, st.aux_sum)]
    assert all(torch.equal(a, c) for a, c in zip(before, after))
    assert not st.W[1:, :4].any() and not st.Q[1:, :4].any() and not st.rz[1:].any()
    assert st.iters.tolist() == [4, 0, 0] and st.aux_sum[0].tolist() == [4.0, 4.0, 0.0]
    assert torch.equal(st.rz[0], st.r[0])


@pytest.mark.parametrize("B", [1, 2])
def test_step_reads_nothing_from_the_device_under_capture(B):
    tA, b, tol, _ = _lanes_problem()

    def apply_op(v):
        return v @ tA.T

    prec = _prec if B > 1 else None
    host = GCRLanes(b[:B], M, tol[:B], n_aux=3 if B > 1 else 0)
    host.restart(apply_op)
    for j in range(3):
        host.step(j, apply_op, prec)
    st = GCRLanes(b[:B], M, tol[:B], n_aux=3 if B > 1 else 0)
    st.restart(apply_op)
    with StubGraph("cpu")._capturing():
        for j in range(3):
            st.step(torch.tensor(j), apply_op, prec)
        with pytest.raises(RuntimeError, match="host"):
            bool(st.go[0])
    for name in ("x", "r", "rn", "iters", "go", "W", "Q", "aux_sum", "rz"):
        a, c = getattr(host, name), getattr(st, name)
        assert (a is None and c is None) or torch.equal(a, c), name


def test_plain_step_is_the_torch_sequence():
    """gcr_step on CPU tensors is gcr_step_plain, and j's rows from j + 1
    on (another restart's) are neither read nor written."""
    rng = np.random.default_rng(9)

    def c(*shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(
            torch.complex64)

    B, m, n, j = 2, 6, 40, 3
    W, Q = c(B, m, n), c(B, m, n)
    W[:, :j] /= n ** 0.5
    state = dict(w=c(B, n), q=c(B, n), x=c(B, n), r=c(B, n))
    rz = state["r"].clone()
    go, stop = torch.tensor([True, True]), torch.tensor([0.0, 1e9])
    rn, iters = torch.ones(B), torch.zeros(B, dtype=torch.long)
    args = [W.clone(), Q.clone(), torch.tensor(j), *state.values(), rz, go, stop, None, rn,
            iters]
    want = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    cuda_gcr.gcr_step(*args)
    cuda_gcr.gcr_step_plain(*want)
    for got, ref in zip(args, want):
        assert (got is None and ref is None) or torch.equal(got, ref)
    W1 = args[0]
    assert torch.equal(W1[:, j + 1:], W[:, j + 1:]) and torch.equal(W1[:, :j], W[:, :j])
    go, rz, iters = args[8], args[7], args[12]
    assert go.tolist() == [True, False] and not rz[1].any() and torch.equal(rz[0], args[6][0])
    assert iters.tolist() == [1, 1]
