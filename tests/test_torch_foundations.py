"""Port foundations vs the JAX package: ini parsing, gauge IO and plaquette,
gamma tables (including the ones baked into the CUDA source)."""

import ast
import dataclasses
import os
import re

import numpy as np
import torch

from ddalphaamg_tpu import config as jconfig
from ddalphaamg_tpu import gamma as jgamma
from ddalphaamg_tpu_torch import config, gamma, gauge
from ddalphaamg_tpu_torch import io as dio
from ddalphaamg_tpu_torch import kernels

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "bench_assets")
INI = os.path.join(ASSETS, "rough16.ini")


def test_rough16_ini_parses_like_jax():
    got = dataclasses.asdict(config.parse_ini(INI))
    want = dataclasses.asdict(jconfig.parse_ini(INI))
    assert got == want
    assert got["num_levels"] == 3 and got["depth"][0]["test_vectors"] == 28


def test_configuration_resolves_beside_ini():
    p = config.parse_ini(INI)
    p.configuration = "/nonexistent/dir/rough16.cnfg"
    config.resolve_configuration(p, INI)
    assert os.path.samefile(p.configuration, os.path.join(ASSETS, "rough16.cnfg"))


def test_rough16_plaquette():
    U, header = dio.read_gauge_field(os.path.join(ASSETS, "rough16.cnfg"))
    assert U.shape == (4, 16, 16, 16, 16, 3, 3)
    plaq = gauge.average_plaquette(torch.as_tensor(U))
    assert abs(plaq - 1.7878261039088) < 1e-10
    assert abs(header - 1.7878261039088) < 1e-10


def _gamma_tables_in_source():
    """The (co, val) gamma tables baked into csrc/dslash.cu."""
    text = (kernels.CSRC / "dslash.cu").read_text()

    def table(name):
        m = re.search(rf"#define {name} (\{{.*\}})", text)
        return ast.literal_eval(m.group(1).replace("{", "[").replace("}", "]"))

    re_, im_ = table("GAMMA_VAL_RE"), table("GAMMA_VAL_IM")
    val = [[complex(re_[mu][s], im_[mu][s]) for s in range(4)] for mu in range(4)]
    return table("GAMMA_CO"), val


def test_gamma_tables_identical():
    mine, ref = gamma.get_basis(), jgamma.get_basis()
    np.testing.assert_array_equal(mine.co, ref.co)
    np.testing.assert_array_equal(mine.val, ref.val)
    co, val = _gamma_tables_in_source()
    np.testing.assert_array_equal(np.array(co), ref.co)
    np.testing.assert_array_equal(np.array(val), ref.val)
