"""The JAX package's accelerator production path in the port, on the CPU:

  (a) the defaults of the three options (api.accelerator_options) against
      the JAX package's Solver._mg_config() with DDAAMG_FORCE_SPLIT=1 (its
      rule for an accelerator that is not a TPU), on both sides of 16,384
      and 8,192 coarsest unknowns, with the Schur gate on and off (odd-even
      off, an odd coarsest extent); the CPU branch leaves all three off,
      mixed precision 0 leaves bf16 off on the card branch, and an ini key
      decides wherever it is set; a cuda Solver's MGConfig takes the rule;
  (b) api.adapt_clip on hand-worked cases of the JAX package's adapt_clip
      (api.py:705-716): no learning, learning, the 5e-2 cap, lanes that
      have converged;
  (c) the outer loop against the JAX package's _solve_df_multi (the loop
      of its forced-split solve and solve_multi) on one 4^4 right-hand side
      and two: both loops run with the inner restart replaced by one
      product with the operator's dense inverse that leaves min(1/2, 20 x
      its target) of the residual, so that every sweep falls short, the
      clip learns and each clip shows in the next residual (the same
      complex128 arithmetic on both sides), and the JAX loop with its
      double-float residual replaced by the complex128 one, so that it
      traces in seconds (the real forced-split path took ~90 s to trace
      its double-float residual, ~140 s its multigrid restart and ~56 s
      its setup at 4^4 on a CPU): equal iterations and caps per lane, the
      same target (the clip where it binds) and relative residual at every
      restart and the same last clip, with the clip taking effect one
      restart after it was learned, as the JAX package's fused step does
      at this size; the port's timing above api.CLIP_LAG_SITES (at once,
      as the JAX loop runs there, too large for this test) against its
      own resvec run through api.adapt_clip; then
      the port's own multigrid solve and two-lane solve_multi with a tight
      DDAAMG_INNER_BASIS_BUDGET (tests/test_multi_rhs.py:122-141): the cap
      is 5 per lane, no restart runs longer, both converge; the card's
      budget (15 % of its memory for both bases) on an 80 GB card;
  (d) slim_for_solve: the next solve has the same iterations and the same
      x bits, also when it ran before the inverses were built, and every
      setup-only call raises until setup() again;
  (e) tools.rough_su3(device="cpu") equals the numpy field to 1e-12.

Fields come from the JAX package's tools (tests/torch_parity.py) and the
port's, from one seed, never the reference conf files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_spinor, rough_field

import ddalphaamg_tpu.operators.dfloat as jdfm
from ddalphaamg_tpu import api as japi
from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import cplx
from ddalphaamg_tpu import tools as jtools
from ddalphaamg_tpu_torch import api, config, tools
from ddalphaamg_tpu_torch.geometry import Geometry
from ddalphaamg_tpu_torch.operators import fast
from ddalphaamg_tpu_torch.operators.stencil import WilsonStencilSoA
from ddalphaamg_tpu_torch.operators.wilson import WilsonOperator

torch.set_num_threads(1)

OPTIONS = api.OPTIONS
LAT = (4, 4, 4, 4)

INI = """configuration: none
number of levels: {levels}
d0 global lattice: {lattice}
d0 block lattice: 2 2 2 2
d0 test vectors: {n0}
d0 setup iter: 1
d1 test vectors: {n1}
d1 setup iter: 1
odd even preconditioning: {oe}
m0: -0.5
csw: 1.0
tolerance for relative residual: 1E-10
iterations between restarts: 50
maximum of restarts: 20
method: 2
mixed precision: {mp}
"""


def _ini(lattice="8 8 8 8", levels=2, n0=28, n1=28, oe=1, mp=1, extra=""):
    return INI.format(lattice=lattice, levels=levels, n0=n0, n1=n1, oe=oe, mp=mp) + extra


# ---------------------------------------------------------------------------
# (a) the defaults
# ---------------------------------------------------------------------------

# (ini, coarsest unknowns, Schur form): 8^4 with 2^4 blocks has a 4^4
# coarsest level (256 sites, 2N unknowns a site); 6 8 8 8 an odd (3) one
RULE_CASES = [
    (_ini(n0=28), 14336, True),                   # rough16's coarsest n
    (_ini(n0=32), 16384, True),                   # at the Schur limit
    (_ini(n0=33), 16896, True),                   # above it
    (_ini(n0=16, oe=0), 8192, False),             # odd-even off: at 8,192
    (_ini(n0=17, oe=0), 8704, False),             # above it
    (_ini(lattice="6 8 8 8", n0=20), 7680, False),   # odd extent, below 8,192
    (_ini(lattice="6 8 8 8", n0=24), 9216, False),   # odd extent: Schur's limit would pass
    (_ini(lattice="16 16 16 16", levels=3, n0=8, n1=28), 14336, True),
    (_ini(n0=28, extra="coarse block bf16: 0\ncoarsest direct: 0\nsmoother direct: 1\n"),
     14336, True),                                # ini keys decide
    (_ini(n0=40, extra="coarsest direct: 1\n"), 20480, True),
]


@pytest.mark.parametrize("text,n,schur", RULE_CASES)
def test_default_rule_matches_jax_accelerator_rule(monkeypatch, text, n, schur):
    monkeypatch.setenv("DDAAMG_FORCE_SPLIT", "1")
    jcfg = japi.Solver(jconfig.parse_ini(text))._mg_config()
    p = config.parse_ini(text)
    assert (api.coarsest_n(p), api.coarsest_schur_ok(p)) == (n, schur)
    card = api.accelerator_options(p, accelerator=True)
    assert {k: v[0] for k, v in card.items()} == {k: getattr(jcfg, k) for k in OPTIONS}
    cpu = api.accelerator_options(p, accelerator=False)
    for key in OPTIONS:
        set_in_ini = getattr(p, key) is not None
        assert cpu[key] == (card[key] if set_in_ini else (False, "default off on the CPU"))
        assert (card[key][1] == "ini") == set_in_ini
    # parse_ini and validate keep "not set" as None
    assert all((getattr(p, k) is None) == (k.replace("_", " ") + ":" not in text)
               for k in OPTIONS)


def test_mixed_precision_0_keeps_bf16_off_on_the_card(monkeypatch):
    monkeypatch.setenv("DDAAMG_FORCE_SPLIT", "1")
    text = _ini(n0=28, mp=0)
    jcfg = japi.Solver(jconfig.parse_ini(text))._mg_config()
    card = api.accelerator_options(config.parse_ini(text), accelerator=True)
    assert card["coarse_block_bf16"][0] is False and jcfg.coarse_block_bf16
    assert card["coarsest_direct"][0] == jcfg.coarsest_direct is True
    assert card["smoother_direct"][0] == jcfg.smoother_direct is False


def test_solver_config_takes_the_rule_of_its_device():
    """A cuda Solver's MGConfig (no card needed to build it) has the card's
    defaults, a cpu Solver's all off; mixed precision 0 does not raise."""
    for mp in (1, 0):
        p = config.parse_ini(_ini(n0=28, mp=mp))
        want = api.accelerator_options(p, accelerator=True)
        cuda = api.Solver(p, device="cuda")
        cfg = cuda._mg_config()
        assert {k: getattr(cfg, k) for k in OPTIONS} == {k: v[0] for k, v in want.items()}
        assert cuda.options == want
        cfg = api.Solver(config.parse_ini(_ini(n0=28, mp=mp)), device="cpu")._mg_config()
        assert not any(getattr(cfg, k) for k in OPTIONS)


# ---------------------------------------------------------------------------
# (b) adapt_clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip,prev,cur,tol,want", [
    # the sweep met what it was asked (1e-5 of 1e-1): no learning
    (1e-5, [1e-1], [1e-6], 1e-10, 1e-5),
    # asked 1e-5, achieved 1e-3: the floor shows, clip 0.7e-3
    (1e-5, [1.0], [1e-3], 1e-10, 7e-4),
    # within 3x of the request (req = max(tol/prev, clip) = 1e-3): no learning
    (1e-5, [1e-7], [2.9e-10], 1e-10, 1e-5),
    # a reduction of 0.5 learns 0.35, capped at 5e-2
    (1e-5, [1e-2], [5e-3], 1e-10, 5e-2),
    # no reduction at all (ach >= 1): no learning
    (1e-5, [1e-2], [1e-2], 1e-10, 1e-5),
    # the clip never falls: 0.7 * 1e-4 < 1e-3
    (1e-3, [1.0], [1e-4], 1e-10, 1e-3),
    # lanes already converged (prev < tol) do not count; the worst lane wins
    (1e-5, [1e-11, 1.0, 1.0], [1e-12, 2e-3, 1e-4], 1e-10, 1.4e-3),
    (1e-5, [1e-11, 1e-11], [1e-12, 1e-13], 1e-10, 1e-5),
])
def test_adapt_clip_hand_worked(clip, prev, cur, tol, want):
    got = api.adapt_clip(clip, np.array(prev), np.array(cur), tol)
    assert got == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# (c) the outer loop against the JAX package's
# ---------------------------------------------------------------------------

SHORTFALL = 20            # the stand-in sweep leaves min(1/2, 20 x its target)
BUDGET = 4 ** 4 * 12 * 20  # complex elements of one basis: cap 20 at batch 1, 10 at 2


def _dense(U):
    """The complex128 operator D of the 4^4 field as a dense matrix over
    logical spinor fields [T, Z, Y, X, 4, 3] flattened, and its inverse."""
    n = int(np.prod(LAT)) * 12
    s = WilsonStencilSoA.build(WilsonOperator.from_gauge(torch.as_tensor(U), -0.5, 1.0),
                               Geometry(LAT, (2, 2, 2, 2)), dtype=torch.complex128)
    E = torch.eye(n, dtype=torch.complex128).reshape(n, *LAT, 4, 3)
    D = fast.spinor_from_soa(s.full_op(fast.spinor_to_soa(E)), LAT).reshape(n, n).T.numpy()
    return D, np.linalg.inv(D)


def _stand_in(Dinv_r, target):
    """The stand-in inner sweep: x + (1 - f) D^-1 r leaves f r, f =
    min(1/2, SHORTFALL x target): short of every target, by a factor that
    makes the clip learn, and dependent on the target, so that a clip shows
    in the next residual."""
    return (1 - np.minimum(0.5, SHORTFALL * target)) * Dinv_r


class _PortStub:
    """The port's Multigrid as _solve_mp calls it, the sweep _stand_in."""

    def __init__(self, Dinv):
        self.Dinv = torch.as_tensor(Dinv)
        self.stats = {}
        self.targets = []       # [B] a restart, inf for a lane masked off

    def _levels(self):
        return []

    def inner_restart(self, r, rel_tol, m, active=None, wrap=None, op=None):
        B = r.shape[0]
        self.targets.append(np.where(active.numpy(), rel_tol.numpy(), np.inf))
        flat = fast.spinor_from_soa(r.to(torch.complex128), LAT).reshape(B, -1)
        z = _stand_in((flat @ self.Dinv.T).numpy(), rel_tol.numpy()[:, None])
        z = torch.where(active[:, None], torch.as_tensor(z), 0)
        z = fast.spinor_to_soa(z.reshape(B, *LAT, 4, 3)).to(r.dtype)
        return z, active.to(torch.float64)


class _JaxStub:
    """The JAX package's Multigrid as _solve_df_multi calls it."""

    def __init__(self, Dinv):
        self.Dinv = jnp.asarray(Dinv)
        self.stats = dict(coarse_iterations=0.0, coarse_matvecs=0.0,
                          coarsest_inverse_applies=0.0)
        self.targets = []       # one a lane and restart, in call order

    def _level_data(self):
        return ()

    _level_data_batched = _level_data

    def _inner_restart_impl(self, data, r, target, m):
        v = (r.re.astype(jnp.float64) + 1j * r.im.astype(jnp.float64)).reshape(-1)
        go = target < 1.0
        jax.debug.callback(lambda t: self.targets.append(np.asarray(t)), target)
        f = jnp.minimum(0.5, SHORTFALL * target.astype(jnp.float64))
        z = jnp.where(go, (1 - f) * (self.Dinv @ v), 0).reshape(r.re.shape)
        return (cplx.CArray(z.real.astype(jnp.float32), z.imag.astype(jnp.float32)),
                go.astype(jnp.float32), jnp.zeros(3, jnp.float32))


def _complex128_outer(monkeypatch, D):
    """The JAX loop's double-float pieces (operators/dfloat.py) as complex128
    arrays in its SoA layout [4, 3, T, Z, Y*X], D the operator there."""
    t, z, y, x = LAT

    def to_log(a):
        return a.reshape(4, 3, t, z, y, x).transpose(2, 3, 4, 5, 0, 1)

    def residual(w, b, xx):
        r = b - (w @ xx.reshape(-1)).reshape(xx.shape)
        return r, jnp.stack([jnp.vdot(r, r).real, 0.0])

    def extract_r32(r):
        lg = to_log(r)
        return cplx.CArray(lg.real.astype(jnp.float32), lg.imag.astype(jnp.float32))

    def axpy(xx, zl):
        zz = (zl.re.astype(jnp.float64) + 1j * zl.im.astype(jnp.float64))
        return xx + zz.transpose(4, 5, 0, 1, 2, 3).reshape(xx.shape)

    monkeypatch.setattr(jdfm, "build_outer_fns", lambda lat: (residual, extract_r32, axpy))
    monkeypatch.setattr(jdfm, "cdf_from64", lambda a: jnp.asarray(a, jnp.complex128))
    monkeypatch.setattr(jdfm, "DF", lambda hi, lo: hi)
    monkeypatch.setattr(jdfm, "CDF", lambda re, im: (re + 1j * im).astype(jnp.complex128))
    monkeypatch.setattr(jdfm, "cdf_to64", np.asarray)
    # D in the SoA order: position k of the SoA field is logical entry idx[k]
    idx = np.arange(D.shape[0]).reshape(*LAT, 4, 3).transpose(4, 5, 0, 1, 2, 3).reshape(-1)
    return jnp.asarray(D[np.ix_(idx, idx)])


@pytest.fixture(scope="module")
def dense():
    U = rough_field(LAT, seed=3)
    return (U, *_dense(U))


def _port_solver(text, U, Dinv):
    s = api.Solver(config.parse_ini(text), device="cpu")
    s.set_conf(U, links_have_bc=True)
    s.mg = _PortStub(Dinv)
    return s


def _rhs_cases():
    ones = np.ones((*LAT, 4, 3), np.complex128)
    return ((ones[None], 20), (np.stack([ones, random_spinor((*LAT, 4, 3), 31)]), 10))


def test_outer_loop_matches_jax_forced_split_loop(monkeypatch, dense):
    U, D, Dinv = dense
    monkeypatch.setenv("DDAAMG_FORCE_SPLIT", "1")
    monkeypatch.setenv("DDAAMG_INNER_BASIS_BUDGET", str(BUDGET))
    text = _ini(lattice="4 4 4 4")
    js = japi.Solver(jconfig.parse_ini(text))
    js.set_conf(U, links_have_bc=True)
    js.mg = _JaxStub(Dinv)
    D_soa = _complex128_outer(monkeypatch, D)
    monkeypatch.setattr(js, "_wilson_df", lambda: (D_soa, None))
    s = _port_solver(text, U, Dinv)
    for rhs, cap in _rhs_cases():
        js.mg.targets.clear()
        s.mg.targets.clear()
        jx, jits, jrel, jconv, jres = js._solve_df_multi(rhs, 1e-10)
        jax.effects_barrier()
        x, infos = s.solve_multi(rhs)
        assert js._last_m_cap == cap and all(i.inner_restart_cap == cap for i in infos)
        assert js._last_inner_clip > api.CLIP_START        # the clip learned
        # the targets of every restart: the JAX loop's converged lanes ask
        # for 2, and its last step runs with every lane converged
        jt = np.concatenate([np.ravel(t) for t in js.mg.targets]).reshape(-1, len(rhs))
        jt = np.where(jt < 1.0, jt, np.inf)
        pt = np.array(s.mg.targets)
        assert len(jt) == len(pt) + 1 and np.isinf(jt[-1]).all()
        np.testing.assert_allclose(pt, jt[:-1], rtol=1e-6)
        assert np.isclose(pt[1:], js._last_inner_clip, rtol=1e-6).any()   # it binds
        for i, info in enumerate(infos):
            assert info.iterations == int(jits[i]) and info.converged and jconv[i]
            # JAX's resvec repeats the last (verified) residual
            assert len(info.resvec) == len(jres) - 1
            np.testing.assert_allclose(info.resvec, [r[i] for r in jres[:-1]], rtol=1e-6)
            assert info.inner_tol_clip == pytest.approx(js._last_inner_clip, rel=1e-6)
            np.testing.assert_allclose(x[i], jx[i], rtol=0, atol=1e-9 * np.abs(jx[i]).max())


def test_outer_loop_applies_the_clip_at_once_above_the_lag_size(monkeypatch, dense):
    """Above CLIP_LAG_SITES a learned clip sets the same restart's targets
    (the JAX package's loop with the residual apart, api.py:734-760): the
    targets and the last clip follow from the port's own resvec through
    adapt_clip, and differ from the lagged loop's."""
    U, D, Dinv = dense
    monkeypatch.setenv("DDAAMG_INNER_BASIS_BUDGET", str(BUDGET))
    text = _ini(lattice="4 4 4 4")
    lagged = _port_solver(text, U, Dinv)
    lag_its = [[i.iterations for i in lagged.solve_multi(rhs)[1]] for rhs, _ in _rhs_cases()]
    monkeypatch.setattr(api, "CLIP_LAG_SITES", 0)
    now = _port_solver(text, U, Dinv)
    tol = now.p.tol
    for (rhs, _), lag in zip(_rhs_cases(), lag_its):
        now.mg.targets.clear()
        _, infos = now.solve_multi(rhs)
        rel = np.array([i.resvec for i in infos]).T      # [restart, lane]
        clip, want = api.CLIP_START, []
        for k in range(len(now.mg.targets)):
            if k:
                clip = api.adapt_clip(clip, rel[k - 1], rel[k], tol)
            want.append(np.where(rel[k] >= tol, np.maximum(tol / rel[k], clip), np.inf))
        np.testing.assert_allclose(now.mg.targets, want, rtol=1e-12)
        last = api.adapt_clip(clip, rel[-2], rel[-1], tol)
        assert all(i.converged and i.inner_tol_clip == last > api.CLIP_START for i in infos)
        assert [i.iterations for i in infos] != lag


SOLVE_INI = _ini(lattice="4 4 4 4", n0=4)


def test_port_solve_keeps_the_cap(monkeypatch):
    """A tight budget caps the inner GCR at 5 per lane (the JAX floor) in
    solve and solve_multi; no restart runs longer, and both converge."""
    monkeypatch.setenv("DDAAMG_INNER_BASIS_BUDGET", "1")
    U = rough_field(LAT, seed=3)
    s = api.Solver(config.parse_ini(SOLVE_INI), device="cpu")
    s.set_conf(U, links_have_bc=True)
    s.setup()
    lengths = []
    inner = s.mg.inner_restart

    def recording(r, rel_tol, m, **kw):
        lengths.append(m)
        z, it = inner(r, rel_tol, m, **kw)
        assert int(it.max()) <= m
        return z, it

    s.mg.inner_restart = recording
    rhs = np.stack([np.ones((*LAT, 4, 3)), random_spinor((*LAT, 4, 3), 31)])
    _, info = s.solve(rhs[0])
    x, infos = s.solve_multi(rhs)
    assert set(lengths) == {5}
    for i, inf in enumerate([info] + infos):
        assert inf.inner_restart_cap == 5 and inf.converged
        assert inf.inner_tol_clip >= api.CLIP_START
        assert inf.iterations <= 5 * (len(inf.resvec) - 1)
    for i in range(2):
        assert s.true_residual(x[i], rhs[i]) < 1e-10


def test_card_budget_is_a_share_of_its_memory(monkeypatch):
    """On an 80 GB card (85,520,809,984 bytes) both bases may take 15 %:
    rough16 and a single 32^4 solve run uncapped at 50, a 12-source batch
    at 32^4 is capped; the environment still decides where it is set."""
    monkeypatch.delenv("DDAAMG_INNER_BASIS_BUDGET", raising=False)
    monkeypatch.delenv("DDAAMG_INNER_M_CAP", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (0, 85_520_809_984))
    n16, n32 = 16 ** 4 * 12, 32 ** 4 * 12
    assert api.inner_restart_cap(50, n16, 12, "cuda") == 50
    assert api.inner_restart_cap(50, n32, 1, "cuda") == 50
    assert api.inner_restart_cap(50, n32, 12, "cuda") == 5
    assert api.inner_restart_cap(50, n32, 12, "cpu") == 5           # 150M elements
    assert api.inner_restart_cap(50, n16, 12, "cpu") == 15
    monkeypatch.setenv("DDAAMG_INNER_M_CAP", "7")
    assert api.inner_restart_cap(50, n32, 1, "cuda") == 7


# ---------------------------------------------------------------------------
# (d) slim_for_solve
# ---------------------------------------------------------------------------

SLIM_INI = SOLVE_INI + "coarse block bf16: 1\ncoarsest direct: 1\n"


def _set_up(U):
    s = api.Solver(config.parse_ini(SLIM_INI), device="cpu")
    s.set_conf(U, links_have_bc=True)
    s.setup()
    return s


def test_slim_for_solve_keeps_the_solve_and_refuses_the_setup_calls(tmp_path):
    U = rough_field(LAT, seed=3)
    rhs = np.ones((*LAT, 4, 3))
    s = _set_up(U)
    x, info = s.solve(rhs)
    full = s.mg._levels()[1].stencil
    s.slim_for_solve()
    lvl = s.mg._levels()[1]
    assert lvl.stencil is lvl.cycle_stencil and lvl.stencil.Pk.dtype == torch.bfloat16
    assert full.Pk.dtype == torch.complex64
    assert all(v.test_vectors is None for v in s.mg._levels())
    x2, info2 = s.solve(rhs)
    assert info2.iterations == info.iterations and np.array_equal(x2, x)
    for call in (lambda: s.update_setup(1), lambda: s.shift_update(-0.49),
                 lambda: s.write_test_vectors(str(tmp_path / "tv")),
                 lambda: s.mg.re_setup(s.mg.fine)):
        with pytest.raises(ValueError, match=r"call setup\(\) first"):
            call()
    assert s.p.m0 == -0.5                 # the refused shift_update moved nothing
    # slimmed before any solve: the inverses are built from the full
    # stencils first, so the solve is the unslimmed one's
    s2 = _set_up(U)
    s2.slim_for_solve()
    x3, info3 = s2.solve(rhs)
    assert info3.iterations == info.iterations and np.array_equal(x3, x)
    # setup() builds the whole hierarchy anew
    s2.setup()
    assert not s2.mg.slim and s2.mg.fine.test_vectors is not None
    s2.update_setup(1)


# ---------------------------------------------------------------------------
# (e) the rough field on a device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lattice", [(4, 4, 4, 4), (4, 2, 4, 6)])
def test_rough_su3_on_a_device_equals_numpy(lattice):
    want = jtools.rough_su3(lattice, seed=0)
    assert np.array_equal(tools.rough_su3(lattice, seed=0), want)
    got = tools.rough_su3(lattice, seed=0, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.complex128
    assert np.abs(got - want).max() < 1e-12
    assert abs(tools._plaquette(torch.as_tensor(got)) - jtools._plaquette(want)) < 1e-12
