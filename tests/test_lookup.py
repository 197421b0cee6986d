"""Lookup-table tests (model: reference tests/test_lookup.py semantics)."""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from theia_jax.lookup import lookup, lookup2d, lookup_dx, sample_table1d


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

def test_lookup_linear(rng):
    table = jnp.asarray(rng.random(64, dtype=np.float32))
    u = rng.random(256, dtype=np.float32)
    got = np.asarray(lookup(table, jnp.asarray(u)))
    exp = np.interp(u * 63, np.arange(64), np.asarray(table))
    assert np.allclose(got, exp, atol=1e-5)


def test_lookup_clamps_and_null():
    table = jnp.asarray([1.0, 2.0, 3.0])
    assert float(lookup(table, -0.5)) == 1.0
    assert float(lookup(table, 1.5)) == 3.0
    assert float(lookup(None, 0.3, 42.0)) == 42.0


def test_lookup_dx_matches_grad():
    # interior derivative should match AD of the interpolant on smooth data
    x = np.linspace(0, 1, 128)
    table = jnp.asarray(np.sin(2 * np.pi * x), jnp.float32)
    u = jnp.asarray([0.25, 0.5, 0.71])
    val, dx = lookup_dx(table, u)
    exp = np.sin(2 * np.pi * np.asarray(u))
    dexp = 2 * np.pi * np.cos(2 * np.pi * np.asarray(u))
    assert np.allclose(np.asarray(val), exp, atol=1e-3)
    assert np.allclose(np.asarray(dx), dexp, rtol=1e-2, atol=1e-2)


def test_lookup2d(rng):
    table = jnp.asarray(rng.random((8, 16), dtype=np.float32))
    # exact grid points
    got = lookup2d(table, 3 / 7, 5 / 15)
    assert np.isclose(float(got), float(table[3, 5]), atol=1e-6)
    # bilinear midpoint
    got = lookup2d(table, 3.5 / 7, 5 / 15)
    assert np.isclose(
        float(got), float((table[3, 5] + table[4, 5]) / 2), atol=1e-6
    )


def test_table_grad_flows():
    table = jnp.asarray([0.0, 1.0, 4.0])

    def f(t):
        return lookup(t, 0.75)

    g = jax.grad(f)(table)
    assert np.allclose(np.asarray(g), [0.0, 0.5, 0.5])


def test_sample_table1d():
    data = np.stack([np.linspace(0, 2, 16), np.linspace(5, 9, 16)], axis=-1)
    t = sample_table1d(data, nx=33)
    assert t.shape == (33,)
    assert np.allclose(t, np.linspace(5, 9, 33), atol=1e-5)


def test_sample_table2d_reference_axis_order_and_hull_fill():
    """sample_table2d keeps the reference's meshgrid-'xy' axis order
    (values[i_y, i_x]; pinned by the reference's own bounds test,
    ref tests/test_lookup.py:117-131) and fills grid points outside the
    data's convex hull by nearest neighbor instead of baking NaN."""
    import warnings as _warnings

    from theia_jax.lookup import sample_table2d

    x = np.array([0.0, 0.0, 10.0, 10.0])
    y = np.array([0.0, 10.0, 0.0, 10.0])
    data = np.stack([x, y, x + y], axis=-1)
    sample = sample_table2d(data, 100, 100, boundaries=(None, (3.0, 8.0)))
    assert sample.shape == (100, 100)
    flat = sample.flatten()
    # first row: y = 3 fixed, x spans [0, 10] -> z in [3, 13]
    assert abs(flat[:100].min() - 3.0) < 1e-5
    assert abs(flat[:100].max() - 13.0) < 1e-5
    # first column: x = 0 fixed, y spans [3, 8] -> z in [3, 8]
    assert abs(flat[::100].min() - 3.0) < 1e-5
    assert abs(flat[::100].max() - 8.0) < 1e-5

    # scattered data whose hull misses the bbox corners: no NaN in the
    # output, and a warning tells the user extrapolation happened
    rng = np.random.default_rng(5)
    pts = rng.random((40, 2))
    pts = pts[np.abs(pts - 0.5).sum(-1) < 0.45]  # diamond: corners outside
    dat = np.stack([pts[:, 0], pts[:, 1], pts.sum(-1)], axis=-1)
    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        table = sample_table2d(dat, 32, 32)
    assert np.isfinite(table).all()
    assert any("convex hull" in str(x.message) for x in w)
