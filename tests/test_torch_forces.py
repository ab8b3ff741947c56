"""The port's force models against the JAX package's jnp functions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from force2vec_tpu.models import forces as jf
from force2vec_tpu_torch.models import forces as tf

MODELS = sorted(jf.FORCE_MODELS)
D = 16
STEP = 0.02
RTOL = 1e-5


def _inputs(seed=0, rows=12, k=6):
    """xi [rows, 1, D], xj [rows, k, D], inv_deg [rows, 1, 1]; row 0's
    first slot coincides with its vertex (r = 0) and row 1's first slot is
    masked off."""
    rng = np.random.default_rng(seed)
    xi = rng.standard_normal((rows, 1, D)).astype(np.float32)
    xj = rng.standard_normal((rows, k, D)).astype(np.float32)
    xj[0, 0] = xi[0, 0]
    invd = (1.0 / rng.integers(1, 20, (rows, 1, 1))).astype(np.float32)
    mask = np.ones((rows, k, 1), dtype=bool)
    mask[1, 0] = False
    return xi, xj, invd, mask


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-6)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("masked", [False, True])
def test_edge_force_matches_jax(name, masked):
    xi, xj, invd, mask = _inputs()
    (ji, jj, jd, jm), (ti, tj, td, tm) = _both(xi, xj, invd, mask)
    want = jf.get_model(name).edge_force(ji, jj, jd, STEP,
                                         mask=jm if masked else None)
    got = tf.get_model(name).edge_force(ti, tj, td, STEP,
                                        mask=tm if masked else None)
    _close(got, want)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("masked", [False, True])
def test_sample_force_matches_jax(name, masked):
    xi, s, _, mask = _inputs(seed=1)
    (ji, js, jm), (ti, ts, tm) = _both(xi, s, mask)
    want = jf.get_model(name).sample_force(ji, js, STEP,
                                           mask=jm if masked else None)
    got = tf.get_model(name).sample_force(ti, ts, STEP,
                                          mask=tm if masked else None)
    _close(got, want)
    if name in ("tdist", "fr"):  # the r = 0 guard: zero, not NaN
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("name", [m for m in MODELS
                                  if jf.FORCE_MODELS[m].edge_coeff])
def test_edge_coeff_matches_jax(name):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(64) * 3).astype(np.float32)
    if jf.FORCE_MODELS[name].a_kind == "dist2":
        a = np.abs(a)
    a[0] = 0.0  # the a = 0 guards
    invd = (1.0 / rng.integers(1, 20, 64)).astype(np.float32)
    want = jf.FORCE_MODELS[name].edge_coeff(jnp.asarray(a), jnp.asarray(invd),
                                            STEP)
    got = tf.FORCE_MODELS[name].edge_coeff(torch.from_numpy(a),
                                           torch.from_numpy(invd), STEP)
    _close(got, want)


@pytest.mark.parametrize("name", [m for m in MODELS
                                  if jf.FORCE_MODELS[m].edge_coeff])
def test_edge_force_is_coeff_times_vec(name):
    """The separable form the CUDA edge kernel evaluates equals edge_force."""
    xi, xj, invd, _ = _inputs(seed=3)
    model = tf.get_model(name)
    ti, tj, td = map(torch.from_numpy, (xi, xj, invd))
    if model.a_kind == "dist2":
        a = ((ti - tj) ** 2).sum(-1, keepdim=True)
    else:
        a = (ti * tj).sum(-1, keepdim=True)
    vec = {"xi_minus_xj": ti - tj, "xj_minus_xi": tj - ti,
           "xj": tj}[model.edge_vec]
    torch.testing.assert_close(model.edge_coeff(a, td, STEP) * vec,
                               model.edge_force(ti, tj, td, STEP),
                               rtol=RTOL, atol=1e-6)


def test_model_metadata_matches_jax():
    assert sorted(tf.FORCE_MODELS) == sorted(jf.FORCE_MODELS)
    callables = {"edge_force", "sample_force", "edge_coeff"}
    for name, jm in jf.FORCE_MODELS.items():
        tm = tf.FORCE_MODELS[name]
        for field in dataclasses.fields(jm):
            if field.name in callables:
                assert (getattr(tm, field.name) is None) == (
                    getattr(jm, field.name) is None)
            else:
                assert getattr(tm, field.name) == getattr(jm, field.name)
    assert tf.OPTION_TO_MODEL == jf.OPTION_TO_MODEL
    assert tf.MAXBOUND == jf.MAXBOUND
    for opt, name in jf.OPTION_TO_MODEL.items():
        assert tf.get_model(opt).name == name


def test_sm_table_is_not_ported():
    with pytest.raises(NotImplementedError):
        tf.get_model("sigmoid", sm_table=True)
