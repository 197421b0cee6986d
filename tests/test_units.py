"""Unit machinery (reference: src/theia/units.py:62-231)."""

import pytest

import math

import numpy as np
import jax.numpy as jnp

import theia_jax.units as u


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

def test_scales_match_reference_conventions():
    # internal units: m / ns / nm / GeV / rad (reference units.py:190-223)
    assert float(u.m) == 1.0 and float(u.ns) == 1.0 and float(u.nm) == 1.0
    assert float(u.km) == 1e3 and float(u.cm) == 1e-2
    assert float(u.s) == 1e9 and float(u.ps) == 1e-3
    assert float(u.um) == 1e3  # wavelength micron
    assert float(u.deg) == math.pi / 180.0
    assert float(u.GeV) == 1.0 and float(u.TeV) == 1e3
    # physically correct energy scales (reference has eV=1e-6: a bug)
    assert float(u.eV) == 1e-9 and float(u.MeV) == 1e-3
    # imperial lengths
    assert float(u.inch) == 0.0254 and float(u.mi) == 1609.344
    assert abs(float(u.c) - 0.299792458) < 1e-12
    assert u.speed_of_light == float(u.c)


def test_annotation_and_roundtrip():
    assert 5.0 * u.cm == 0.05
    assert u.convert(0.05, u.cm) == 5.0
    x = 123.456
    for unit in (u.km, u.cm, u.inch, u.us, u.deg, u.PeV):
        assert np.isclose(u.convert(x * unit, unit), x)


def test_inverse_units():
    # value * per_cm == value / cm (reference units.py:108-137)
    assert 2.0 * u.per_cm == 2.0 / u.cm == 200.0
    assert u.per_m.base is u.m
    assert u.per_km.dimension == "length"


def test_compound_unit():
    assert u.c.dimension == "compound"
    mps = u.CompoundUnit(1.0, [u.m], [u.s])
    assert np.isclose(float(mps), 1e-9)
    assert np.isclose(3e8 * mps, 0.3)


def test_tuple_annotation():
    pos = (1.0, 2.0, 3.0) * u.cm
    assert pos == (0.01, 0.02, 0.03)
    assert (0.01, 0.02) / u.cm == (1.0, 2.0)


def test_dimension_metadata():
    assert u.m.dimension == "length"
    assert u.ns.dimension == "time"
    assert u.nm.dimension == "wavelength"
    assert u.GeV.dimension == "energy"
    assert u.rad.dimension == "angle"


def test_units_work_with_arrays_and_jit():
    # float-subclass design: exact float semantics with numpy and jax
    a = np.array([1.0, 2.0]) * u.cm
    assert isinstance(a, np.ndarray) and np.allclose(a, [0.01, 0.02])
    b = jnp.array([1.0, 2.0]) * u.cm
    assert np.allclose(np.asarray(b), [0.01, 0.02])
    assert np.allclose(np.asarray(b / u.cm), [1.0, 2.0])
