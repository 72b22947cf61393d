"""The accelerator options through the whole port (the slice): the
multigrid preconditioner and the solve with coarsest direct and smoother
direct against the JAX package's default CPU path, and the three options on
a t/z process grid of spawned ranks.

  (e) a 3-level 8^4 hierarchy with the coarsest dense Schur inverse and the
      depth-1 block inverses, the same injected test vectors on both sides
      (tests/test_torch_mg.py), mixed precision 0: one preconditioner cycle
      agrees with JAX Multigrid to 1e-9, and the outer iteration counts are
      equal;
  (f) the port's own solve with all three options, mixed precision 1,
      takes at most 2 outer iterations more than with f32 blocks (the JAX
      package's bound for bf16, tests/test_split_mode.py:192; the bf16
      hierarchy itself is held to the JAX split path in
      tests/test_torch_direct_split.py); each option alone converges
      within 2 of the count with none;
  (g) the same solve on a (1, 2, 1, 1) grid of two gloo ranks with depth 1
      sharded (K5-bf16's plain version, block inverses of the slab, the
      replicated coarsest level's dense inverse built on every rank): every
      rank agrees, the exact relres is below 1e-10 and the iterations are
      within 1 of one rank's.
(f) and (g) run a 4x8x4x4 lattice whose coarsest level (1, 2, 1, 1) has odd
extents, so they take the full dense inverse where (e) takes the Schur one.
Their inner restarts are clipped at 1e-4 (SolverParams.inner_tol_clip): at
the default 1e-5 a restart can stall on the f32 floor just above the clip
(1.3e-5 here) and run its 50 iterations, so counts would hinge on rounding.
"""

import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_mg import _compare, _run_pair
from torch_parity import rough_field

from ddalphaamg_tpu_torch.parallel import launch

torch.set_num_threads(1)

DIRECT = "coarsest direct: 1\nsmoother direct: 1\n"
GRID_BASE = """number of levels: 3
d0 global lattice: 4 8 4 4
d0 block lattice: 2 2 2 2
d0 test vectors: 4
d0 setup iter: 2
d1 test vectors: 4
d1 setup iter: 1
m0: -0.5
csw: 1.0
tolerance for relative residual: 1e-10
method: 2
mixed precision: 1
"""
GRID_INI = GRID_BASE + DIRECT
BF16 = "coarse block bf16: 1\n"
CLIP = 1e-4


def test_three_level_direct_matches_jax():
    lat, js, jmg, s, mg = _run_pair(L=8, levels=3, n=4, s0=1, s1=1, seed=31, extra=DIRECT)
    assert jmg.cfg.coarsest_direct and jmg.cfg.smoother_direct
    info = _compare(lat, js, jmg, s, mg)
    coarsest = mg._levels()[-1]
    assert isinstance(coarsest.dense_inv, tuple)           # Schur variant
    assert mg._levels()[1].block_inv.shape == (16, 16 * 8, 16 * 8)
    # one dense apply per coarsest solve, no coarsest GCR
    assert info.coarse_matvec_average == 0 and info.coarsest_inverse_applies > 0


@pytest.fixture(scope="module")
def grid_field():
    return rough_field((4, 8, 4, 4), seed=41)


@pytest.fixture(scope="module")
def single_bf16(grid_field):
    return ranks.solve_sharded_levels(None, GRID_INI + BF16, grid_field, CLIP)


def test_bf16_blocks_cost_at_most_two_iterations(grid_field, single_bf16):
    _, it16, exact16, levels = single_bf16
    _, it32, exact32, _ = ranks.solve_sharded_levels(None, GRID_INI, grid_field, CLIP)
    assert exact16 < 1e-10 and exact32 < 1e-10
    assert levels == [(False, None, None, "NoneType"),
                      (False, "torch.bfloat16", "torch.bfloat16", "NoneType"),
                      (False, "torch.bfloat16", None, "Tensor")]
    assert it16 <= it32 + 2, (it16, it32)


@pytest.fixture(scope="module")
def single_off(grid_field):
    return ranks.solve_sharded_levels(None, GRID_BASE, grid_field, CLIP)


@pytest.mark.parametrize("option", [BF16, "coarsest direct: 1\n", "smoother direct: 1\n"],
                         ids=["bf16", "coarsest", "smoother"])
def test_each_option_alone_converges(grid_field, single_off, option):
    it_off = single_off[1]
    _, it, exact, levels = ranks.solve_sharded_levels(None, GRID_BASE + option, grid_field,
                                                      CLIP)
    assert exact < 1e-10 and it <= it_off + 2, (it, it_off)
    _, view, binv, dense = levels[1]
    assert (view is not None) == (option == BF16)
    assert (binv is not None) == (option.startswith("smoother"))
    assert (levels[2][3] == "Tensor") == (option.startswith("coarsest"))


def test_options_on_a_process_grid_match_one_rank(grid_field, single_bf16):
    _, it1, _, levels1 = single_bf16
    res = launch.run_ranks(ranks.run, (1, 2, 1, 1), "gloo", ["cpu"] * 2,
                           {"solve": ("solve_sharded_levels",
                                      dict(ini=GRID_INI + BF16, U=grid_field,
                                           inner_tol_clip=CLIP))})
    x0, it0, _, levels0 = res[0]["solve"]
    assert [lv[0] for lv in levels0] == [True, True, False]     # depth 1 sharded
    assert [lv[1:] for lv in levels0] == [lv[1:] for lv in levels1]
    for r in res:
        x, it, exact, _ = r["solve"]
        assert it == it0 and exact < 1e-10
        np.testing.assert_array_equal(x, x0)
    assert abs(it0 - it1) <= 1, (it0, it1)
