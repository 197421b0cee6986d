"""Medium-model physics validation against published data plus store/
serialization round-trips (model: reference tests/test_material.py)."""

import io
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import quad

import theia_jax.units as u
from theia_jax.material import (
    BK7Model,
    DispersionFreeMedium,
    FournierForandPhaseFunction,
    HenyeyGreensteinPhaseFunction,
    KokhanovskyOceanWaterPhaseMatrix,
    Material,
    MaterialFlags,
    MaterialStore,
    Medium,
    MediumModel,
    MediumStore,
    WaterBaseModel,
    loadMaterials,
    medium_constants,
    packed_medium_constants,
    parseMaterialFlags,
    saveMaterials,
)

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

DATA = Path(__file__).parent / "data"


class WaterPhaseModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
    ModelName = "water"

    def __init__(self, g: float = 0.9) -> None:
        WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
        HenyeyGreensteinPhaseFunction.__init__(self, g)


def test_bk7_model():
    model = BK7Model()
    n_exp = np.loadtxt(DATA / "bk7_refractive_index.csv", delimiter=",", skiprows=2)
    assert np.abs(n_exp[:, 1] - model.refractive_index(n_exp[:, 0] * u.nm)).max() < 5e-5

    l = np.linspace(300.0, 800.0, 200) * u.nm
    n = model.refractive_index(l)
    vg_exp = 1.0 / (n - l * np.gradient(n, 500 / (len(l) - 1))) * u.c
    assert np.abs((vg_exp - model.group_velocity(l)) / vg_exp).max() < 1e-3

    trans = np.loadtxt(
        Path(__file__).parents[1] / "theia_jax/data/bk7_transmission.csv",
        delimiter=",",
        skiprows=2,
    )
    mu_a = model.absorption_coef(trans[:, 0] * u.nm)
    t_10mm = np.exp(-mu_a * 10.0 * u.mm)
    t_25mm = np.exp(-mu_a * 25.0 * u.mm)
    assert np.abs(t_10mm - trans[:, 1]).max() < 0.1
    assert np.abs(t_25mm - trans[:, 2]).max() < 0.01


def test_water_model():
    model = WaterBaseModel(10.0, 0.0, 35.0)
    data = np.loadtxt(DATA / "water_n_10C_35S.csv", delimiter=",", skiprows=3)
    assert np.abs(data[:, 1] - model.refractive_index(data[:, 0] * u.nm)).max() < 0.005

    l = np.linspace(300.0, 800.0, 200) * u.nm
    n = model.refractive_index(l)
    vg_exp = 1.0 / (n - l * np.gradient(n, 500 / (len(l) - 1))) * u.c
    assert np.abs((vg_exp - model.group_velocity(l)) / vg_exp).max() < 5e-3

    smith = np.loadtxt(
        Path(__file__).parents[1] / "theia_jax/data/water_smith81.csv",
        delimiter=",",
        skiprows=2,
    )
    assert np.abs(smith[:, 1] - model.absorption_coef(smith[:, 0] * u.nm)).max() < 1e-6
    assert np.abs(smith[:, 2] - model.scattering_coef(smith[:, 0] * u.nm)).max() < 1e-6


def _sampling_error(rng, model, bins=50, N=int(1e6)):
    eta = rng.random(N)
    samples = model.phase_sampling(eta)
    h, edges = np.histogram(samples, bins=bins)
    p_bin = h / N

    def f(x):
        return np.exp(model.log_phase_function(x))

    exp_bin = [quad(f, edges[i], edges[i + 1])[0] * 2 * np.pi for i in range(bins)]
    return np.abs(p_bin - exp_bin).max()


def _integrate_phase(model):
    def f(x):
        return np.exp(model.log_phase_function(x))

    return quad(f, -1.0, 1.0)[0] * 2 * np.pi


def test_henyey_greenstein(rng):
    data = np.loadtxt(DATA / "log_phase_hg.csv", delimiter=",", skiprows=1)
    for col, g in ((1, 0.3), (2, 0.0), (3, -0.5), (4, 0.99)):
        hg = HenyeyGreensteinPhaseFunction(g)
        assert np.abs(data[:, col] - hg.log_phase_function(data[:, 0])).max() < 1e-6
        assert _sampling_error(rng, hg) < 5e-4
        assert abs(_integrate_phase(hg) - 1.0) < 1e-5


def test_fournier_forand(rng):
    model = FournierForandPhaseFunction(1.175, 4.065)
    data = np.loadtxt(DATA / "log_phase_ff.csv", delimiter=",", skiprows=1)
    assert np.abs(data[:, 1] - model.log_phase_function(data[:, 0])).max() < 1e-6
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert _sampling_error(rng, model, 70, int(1e7)) < 0.01
    assert abs(_integrate_phase(model) - 1.0) < 1e-4


def test_kokhanovsky_bounds():
    model = KokhanovskyOceanWaterPhaseMatrix(
        p90=0.66, theta0=0.25, alpha=0.55, xi=0.04
    )
    ct = np.linspace(-1.0, 1.0, 512)
    assert np.all(np.abs(model.phase_m12(ct)) <= 1.0)
    assert np.all(np.abs(model.phase_m22(ct)) <= 1.0 + 1e-6)
    assert np.all(np.abs(model.phase_m33(ct)) <= 1.0 + 1e-6)


def test_medium_constants_vacuum():
    const = medium_constants(None, jnp.float32(500.0))
    assert float(const.n) == 1.0
    assert np.isclose(float(const.vg), u.c)
    assert float(const.mu_s) == 0.0
    assert float(const.mu_e) == 0.0


def test_medium_constants_model():
    model = DispersionFreeMedium(n=1.5, ng=1.6, mu_a=0.3, mu_s=0.7)
    medium = model.createMedium(400.0, 600.0, num_lambda=64, num_theta=8)
    const = medium_constants(medium, jnp.float32(500.0))
    assert np.isclose(float(const.n), 1.5, atol=1e-6)
    assert np.isclose(float(const.vg), u.c / 1.6, atol=1e-6)
    assert np.isclose(float(const.mu_s), 0.7, atol=1e-6)
    assert np.isclose(float(const.mu_e), 1.0, atol=1e-6)


def test_medium_store_matches_single():
    water = WaterPhaseModel().createMedium(num_lambda=128, num_theta=64)
    glass = BK7Model().createMedium(300.0, 700.0, num_lambda=96, num_theta=4)
    store = MediumStore.pack([water, glass])
    lam = jnp.asarray(np.linspace(310.0, 690.0, 33), jnp.float32)
    for name, medium in (("water", water), ("bk7", glass)):
        h = store.handle(name)
        got = packed_medium_constants(store, jnp.full(33, h, jnp.int32), lam)
        exp = medium_constants(medium, lam)
        for f in ("n", "vg", "mu_s", "mu_e"):
            assert np.allclose(
                np.asarray(getattr(got, f)), np.asarray(getattr(exp, f)), atol=1e-6
            ), (name, f)
    # vacuum row
    got = packed_medium_constants(store, jnp.zeros(3, jnp.int32), lam[:3])
    assert np.allclose(np.asarray(got.n), 1.0)
    assert np.allclose(np.asarray(got.mu_e), 0.0)


def test_material_flags_parse():
    assert parseMaterialFlags("T") == MaterialFlags.NO_REFLECT
    assert parseMaterialFlags("R") == MaterialFlags.NO_TRANSMIT
    assert parseMaterialFlags("TR") == MaterialFlags(0)
    assert (
        parseMaterialFlags("DB")
        == MaterialFlags.DETECTOR
        | MaterialFlags.BLACK_BODY
        | MaterialFlags.NO_REFLECT
        | MaterialFlags.NO_TRANSMIT
    )


def test_medium_serialization_roundtrip(tmp_path):
    medium = WaterPhaseModel().createMedium(num_lambda=64, num_theta=32)
    buf = io.BytesIO()
    medium.save(buf)
    buf.seek(0)
    restored = Medium.load(buf, name="water")
    assert float(restored.lambda_min) == float(medium.lambda_min)
    assert np.allclose(
        np.asarray(restored.scattering_coef), np.asarray(medium.scattering_coef)
    )
    assert restored.phase_m34 is None


def test_material_store_and_zip_roundtrip(tmp_path):
    water = WaterPhaseModel().createMedium(num_lambda=32, num_theta=16)
    mat = Material("det", water, None, flags=("DB", "T"))
    store = MaterialStore.pack([mat])
    h = store.material_handle("det")
    assert int(store.inside[h]) == store.media.handle("water")
    assert int(store.outside[h]) == 0
    assert int(store.flags_inward[h]) == int(parseMaterialFlags("DB"))

    path = tmp_path / "mats.zip"
    saveMaterials(path, [mat])
    mats, media = loadMaterials(path)
    assert "det" in mats and "water" in media
    assert mats["det"].flagsInward == parseMaterialFlags("DB")
    assert np.allclose(
        np.asarray(media["water"].absorption_coef),
        np.asarray(water.absorption_coef),
    )


def test_load_materials_validates_schema(tmp_path):
    """loadMaterials validates material.json against its schema and
    rejects dangling medium references (reference material.py:697-712,
    855-869)."""
    import json
    from zipfile import ZipFile

    import pytest

    water = WaterPhaseModel().createMedium(num_lambda=8, num_theta=8)
    good = tmp_path / "good.zip"
    saveMaterials(good, [Material("det", water, None, flags="DB")])

    def rewrite(src, dst, entries):
        with ZipFile(src) as zin, ZipFile(dst, "w") as zout:
            for info in zin.infolist():
                if info.filename == "material.json":
                    zout.writestr(info.filename, json.dumps(entries))
                else:
                    zout.writestr(info.filename, zin.read(info))

    # malformed entry: missing required key
    bad = tmp_path / "bad_schema.zip"
    rewrite(good, bad, [{"name": "det", "inside": "water"}])
    with pytest.raises(ValueError, match="missing keys"):
        loadMaterials(bad)
    # skipValidation bypasses the schema check (reference parity) but the
    # missing keys then surface as a KeyError downstream
    with pytest.raises(KeyError):
        loadMaterials(bad, skipValidation=True)

    # unknown medium reference must be a clear error, not silently vacuum
    dangling = tmp_path / "dangling.zip"
    rewrite(
        good,
        dangling,
        [
            {
                "name": "det",
                "inside": "missing_medium",
                "outside": None,
                "flagsInward": 0,
                "flagsOutward": 0,
            }
        ],
    )
    with pytest.raises(ValueError, match="unknown medium"):
        loadMaterials(dangling)

    # duplicate names rejected
    dup = tmp_path / "dup.zip"
    entry = {
        "name": "det",
        "inside": "water",
        "outside": None,
        "flagsInward": 0,
        "flagsOutward": 0,
    }
    rewrite(good, dup, [entry, entry])
    with pytest.raises(ValueError, match="duplicate"):
        loadMaterials(dup)


_ENTRY = {
    "name": "det",
    "inside": "water",
    "outside": None,
    "flagsInward": 3,
    "flagsOutward": 0.0,
}


@pytest.mark.parametrize(
    "entries,match",
    [
        ({"det": _ENTRY}, "list of materials"),
        (["det"], "not an object"),
        ([{**_ENTRY, "color": "red"}], "unknown keys"),
        ([{**_ENTRY, "name": 7}], "'name' has type int"),
        ([{**_ENTRY, "outside": 1.0}], "'outside' has type float"),
        ([{**_ENTRY, "flagsInward": True}], "'flagsInward' has type bool"),
        ([{**_ENTRY, "flagsOutward": -1}], "negative flags"),
    ],
    ids=["not_list", "not_object", "extra_key", "name_type", "medium_type",
         "bool_flags", "negative_flags"],
)
def test_material_json_schema_rejects(entries, match):
    """The schema check alone, case by case (a valid entry passes)."""
    from theia_jax.material import _validate_entries

    _validate_entries([_ENTRY, dict(_ENTRY, name="other", inside=None)])
    with pytest.raises(ValueError, match=match):
        _validate_entries(entries)
