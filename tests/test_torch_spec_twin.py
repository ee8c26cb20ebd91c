"""The port's NumPy copies (varanneal_tpu_torch/ops/spec.py, twin.py,
parallel/ensemble.random_ensemble_inits) give exactly what the JAX
package's originals give: specs field by field, twins and ensemble draws
bit for bit."""

import dataclasses

import numpy as np
import pytest

from varanneal_tpu.models import lorenz96 as lorenz96_jax
from varanneal_tpu.ops import build_spec as build_spec_jax
from varanneal_tpu.twin import lorenz96_twin as twin_jax
from varanneal_tpu.parallel import random_ensemble_inits as inits_jax

from varanneal_tpu_torch.models import lorenz96
from varanneal_tpu_torch.ops import build_spec, spec_from_reference
from varanneal_tpu_torch.twin import lorenz96_twin
from varanneal_tpu_torch.parallel import random_ensemble_inits


def _assert_specs_equal(a, b):
    for fld in dataclasses.fields(a):
        if fld.name == "f":
            continue
        va, vb = getattr(a, fld.name), getattr(b, fld.name)
        if va is None or vb is None:
            assert va is None and vb is None, fld.name
        else:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=fld.name)
    assert (a.n_dof, a.n_par, a.L, a.NP) == (b.n_dof, b.n_par, b.L, b.NP)


def test_twin_bit_identical():
    a = lorenz96_twin(D=10, N_data=41, n_obs=4, spin=200)
    b = twin_jax(D=10, N_data=41, n_obs=4, spin=200)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("disc,dt_model,RM,P", [
    ("trapezoid", None, 4.0, [4.0]),
    ("SimpsonHermite", None, "diag", [4.0]),
    ("euler", 0.0125, "diag", [4.0]),
    ("forwardmap", None, 2.0, "time"),
])
def test_specs_equal(disc, dt_model, RM, P):
    tw = twin_jax(D=6, N_data=13, n_obs=3, spin=50)
    rng = np.random.default_rng(1)
    if isinstance(RM, str):
        RM = rng.uniform(0.5, 2.0, (13, 3))
    if isinstance(P, str):
        P = rng.uniform(7.0, 9.0, (13, 1))
    kw = dict(disc=disc, P=np.asarray(P), pidx=[0], dt_model=dt_model)
    sj = build_spec_jax(lorenz96_jax, 6, tw["Y"], tw["t"], tw["Lidx"], RM,
                        **kw)
    st = build_spec(lorenz96, 6, tw["Y"], tw["t"], tw["Lidx"], RM, **kw)
    _assert_specs_equal(st, sj)
    assert st.f is lorenz96
    # the same problem carried across from the JAX spec's fields
    sr = spec_from_reference(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)},
        lorenz96)
    _assert_specs_equal(sr, sj)
    assert sr.f is lorenz96


def test_random_ensemble_inits_bit_identical():
    tw = twin_jax(D=8, N_data=21, n_obs=3, spin=50)
    kw = dict(disc="trapezoid", P=np.array([4.0]), pidx=[0])
    sj = build_spec_jax(lorenz96_jax, 8, tw["Y"], tw["t"], tw["Lidx"],
                        tw["RM"], **kw)
    st = build_spec(lorenz96, 8, tw["Y"], tw["t"], tw["Lidx"], tw["RM"],
                    **kw)
    for dtype in (np.float32, np.float64):
        a = random_ensemble_inits(st, 3, seed=3, dtype=dtype)
        b = inits_jax(sj, 3, seed=3, dtype=dtype)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
