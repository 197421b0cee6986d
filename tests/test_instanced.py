"""Two-level instanced traversal tests (ops.instanced).

The accel backend for the domain's scaling scenario — detector arrays of
instanced modules. Contract: identical hits to the brute scan (up to
shared-edge fp ties), correct auto selection, end-to-end tracing, and
gradients (selection runs under stop_gradient, the winner t/barycentrics
are recomputed differentiably in accel.intersect_scene).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from theia_jax.material import Material, MaterialStore
from theia_jax.mesh import Mesh, icosphere, lobed_sphere
from theia_jax.scene import (
    AUTO_INSTANCED_THRESHOLD,
    MeshStore,
    Scene,
    Transform,
)


def array_scene(n=3, accel="instanced", mixed=False):
    """n^3 grid of instanced spheres (plus a lobed sphere when mixed)."""
    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore(
        {"sphere": icosphere(), "lobed": lobed_sphere()}
    )
    insts = [
        meshes.createInstance(
            "sphere",
            "m",
            Transform.TRS(scale=0.4, translate=(2.0 * i, 2.0 * j, 2.0 * k)),
        )
        for i in range(n)
        for j in range(n)
        for k in range(n)
    ]
    if mixed:
        insts.append(
            meshes.createInstance(
                "lobed", "m", Transform.TRS(translate=(-3.0, 0.0, 0.0))
            )
        )
    return Scene(insts, store, medium=None, accel=accel)


def random_rays(n, lo=-4.0, hi=7.0, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    o = jax.random.uniform(ks[0], (n, 3), jnp.float32, lo, hi)
    d = jax.random.normal(ks[1], (n, 3), jnp.float32)
    return o, d / jnp.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("mixed", [False, True])
def test_matches_bruteforce(mixed):
    from theia_jax.accel import _nearest, _nearest_triangle

    scene = array_scene(3, "instanced", mixed=mixed)
    assert scene.pack.instanced is not None
    o, d = random_rays(4096)

    t_b, i_b = _nearest_triangle(scene.pack, o, d, jnp.inf, 256)
    t_i, i_i = _nearest(scene.pack, o, d, jnp.inf, 256)

    t_b, i_b, t_i, i_i = map(np.asarray, (t_b, i_b, t_i, i_i))
    hit_b = i_b >= 0
    assert hit_b.any() and (~hit_b).any()
    assert (hit_b == (i_i >= 0)).mean() > 0.999
    both = hit_b & (i_i >= 0)
    # nearest t must agree; winning index may differ on exact shared edges
    assert np.allclose(t_i[both], t_b[both], rtol=1e-4, atol=1e-5)
    assert (i_i[both] == i_b[both]).mean() > 0.995


def test_respects_t_max():
    from theia_jax.accel import _nearest

    scene = array_scene(2, "instanced")
    o, d = random_rays(2048, seed=3)
    t_far, i_far = _nearest(scene.pack, o, d, jnp.inf, 256)
    cap = 1.5
    t_cap, i_cap = _nearest(scene.pack, o, d, cap, 256)
    t_far, i_far, t_cap, i_cap = map(np.asarray, (t_far, i_far, t_cap, i_cap))
    beyond = (i_far >= 0) & (t_far >= cap)
    assert beyond.any()
    assert (i_cap[beyond] == -1).all()
    within = (i_far >= 0) & (t_far < cap)
    np.testing.assert_array_equal(i_cap[within], i_far[within])


def test_auto_selects_instanced():
    scene = array_scene(3, "auto")  # 27 x 1280 = 34560 flattened tris
    assert scene.accel == "instanced"
    # a single instance must NOT pick the two-level path
    single = array_scene(1, "auto")
    assert single.accel == "brute"
    assert 27 * 1280 > AUTO_INSTANCED_THRESHOLD


def test_end_to_end_energy():
    """Ground-truth energy check with accel='instanced' (mirrors the BVH
    end-to-end test): absorbing spheres around a source — every photon
    either escapes through gaps or is detected; detected fraction must
    match the brute-backend run exactly on identical RNG streams."""
    import theia_jax.units as u
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import Material as M, MaterialStore as MS
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace.scene import SceneForwardTracer

    def run(accel):
        medium = WaterTestModel(mu_a=0.0, mu_s=0.02, g=0.0).createMedium()
        # photons arrive from the surrounding water -> water is the
        # *outside* medium of the detector shells
        mat = M("det", None, medium, flags="DB")
        store = MS.pack([mat])
        meshes = MeshStore({"sphere": icosphere()})
        insts = [
            meshes.createInstance(
                "sphere",
                "det",
                Transform.TRS(scale=0.5, translate=(2.0 * i - 1.0, 2.0 * j - 1.0, 0.0)),
            )
            for i in range(2)
            for j in range(2)
        ]
        scene = Scene(insts, store, medium="water_test", accel=accel)
        tracer = SceneForwardTracer(
            8 * 1024,
            SphericalLightSource(
                position=(0.0, 0.0, 0.0), timeRange=(0.0, 0.0), budget=1e6
            ),
            UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
            HistogramHitResponse(nBins=40, t0=0.0, binSize=2.0),
            PhiloxRNG(key=0xFEED),
            scene,
            maxPathLength=6,
            maxTime=80.0 * u.ns,
        )
        curve, _ = tracer.run()
        return np.asarray(curve)

    a = run("instanced")
    b = run("brute")
    assert a.sum() > 0
    # same RNG streams + same hit semantics -> identical light curves up
    # to fp noise from the object-space vs world-space triangle tests
    np.testing.assert_allclose(a, b, rtol=5e-3)


def test_gradient_through_instanced():
    """jax.grad through a scene trace with the while_loop-based backend:
    selection is stop_gradiented, winner t recomputed differentiably."""
    from theia_jax.accel import intersect_scene

    scene = array_scene(2, "instanced")
    pack = scene.pack
    o, d = random_rays(256, seed=5)

    def loss(shift):
        hit = intersect_scene(
            pack, jnp.full(256, -1, jnp.int32), o + shift, d, jnp.inf
        )
        return jnp.where(hit.valid, hit.t, 0.0).sum()

    g = jax.grad(loss)(jnp.zeros(3, jnp.float32))
    assert np.isfinite(np.asarray(g)).all()
    # FD check along x
    eps = 1e-3
    lp = loss(jnp.array([eps, 0.0, 0.0], jnp.float32))
    lm = loss(jnp.array([-eps, 0.0, 0.0], jnp.float32))
    fd = (lp - lm) / (2 * eps)
    assert np.isclose(float(g[0]), float(fd), rtol=5e-2, atol=1e-1)


def test_auto_bvh_fallback_for_huge_noninstanced(monkeypatch):
    """auto must still route huge NON-instanced scenes to the BVH (the
    instanced path would brute-scan the giant prototype per candidate)."""
    import theia_jax.scene as scene_mod

    monkeypatch.setattr(scene_mod, "AUTO_BVH_THRESHOLD", 1000)
    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})  # 1280 tris
    one = [meshes.createInstance("sphere", "m", Transform.TRS(scale=0.4))]
    scene = Scene(one, store, medium=None)
    assert scene.accel == "bvh" and scene.pack.bvh is not None
    # instanced copies of the same too-big prototype also fall through
    two = one + [
        meshes.createInstance(
            "sphere", "m", Transform.TRS(scale=0.4, translate=(2.0, 0, 0))
        )
    ]
    monkeypatch.setattr(scene_mod, "AUTO_INSTANCED_THRESHOLD", 100)
    scene2 = Scene(two, store, medium=None)
    assert scene2.accel == "bvh"


@pytest.mark.parametrize("scale", [0.02, 50.0])
def test_matches_bruteforce_extreme_scales(scale):
    """The scale-normalized prototype keeps the object-space degeneracy
    epsilon equivalent to the brute scan's world-space one even for
    instances far from unit scale."""
    from theia_jax.accel import _nearest, _nearest_triangle

    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    insts = [
        meshes.createInstance(
            "sphere",
            "m",
            Transform.TRS(
                scale=0.4 * scale, translate=(2.0 * scale * i, 0.0, 0.0)
            ),
        )
        for i in range(3)
    ]
    scene = Scene(insts, store, medium=None, accel="instanced")
    o, d = random_rays(4096, lo=-2.0 * scale, hi=6.0 * scale, seed=11)

    t_b, i_b = _nearest_triangle(scene.pack, o, d, jnp.inf, 256)
    t_i, i_i = _nearest(scene.pack, o, d, jnp.inf, 256)
    t_b, i_b, t_i, i_i = map(np.asarray, (t_b, i_b, t_i, i_i))
    hit_b = i_b >= 0
    assert hit_b.any()
    assert (hit_b == (i_i >= 0)).mean() > 0.999
    both = hit_b & (i_i >= 0)
    assert np.allclose(t_i[both], t_b[both], rtol=1e-4, atol=1e-5 * scale)
    assert (i_i[both] == i_b[both]).mean() > 0.995


def test_any_hit_occlusion_matches_nearest():
    """is_visible's any-hit fast paths (instanced, brute scan, BVH) must
    agree with ground-truth visibility from the brute nearest-hit query."""
    from theia_jax.accel import _nearest_triangle, is_visible
    from theia_jax.ops.math3d import dot

    scene_b = array_scene(3, "brute")
    ks = jax.random.split(jax.random.PRNGKey(21), 2)
    n = 4096
    obs = jax.random.uniform(ks[0], (n, 3), jnp.float32, -1.0, 5.0)
    tgt = jax.random.uniform(ks[1], (n, 3), jnp.float32, -1.0, 5.0)

    # ground truth: nearest hit strictly before the connection distance
    d = tgt - obs
    dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-30))
    _, tri = _nearest_triangle(scene_b.pack, obs, d / dist[:, None], dist, 256)
    vis_ref = np.asarray(tri < 0)
    assert vis_ref.any() and (~vis_ref).any()

    for accel in ("brute", "instanced", "bvh"):
        scene = array_scene(3, accel)
        vis = np.asarray(is_visible(scene.pack, obs, tgt))
        # identical up to rays exactly grazing shared edges
        assert (vis == vis_ref).mean() > 0.999, accel


@pytest.mark.parametrize(
    "ladder",
    [
        "",  # compaction disabled
        "0.375:1,0.0625:-1",  # the shipped default two-stage ladder
        "0.375:1,0.125:2,0.03125:-1",  # the shipped large-group ladder
        "0.004:-1",  # the capacity-overflow fallback on every stage
        "0.5:1,0.25:2,0.0625:-1",  # a deeper ladder
    ],
)
def test_midwalk_compaction_bit_identical(ladder, monkeypatch):
    """The compaction ladder is bit-identical to the
    plain while_loop walk in every branch: disabled, the staged
    compacted continuation, and the capacity-overflow fallback."""
    import theia_jax.ops.instanced as inst
    from theia_jax.ops.instanced import nearest_triangle_instanced

    scene = array_scene(3, "instanced", mixed=True)
    pack = scene.pack.instanced
    ks = jax.random.split(jax.random.PRNGKey(31), 2)
    n = 4096
    o = jax.random.uniform(ks[0], (n, 3), jnp.float32, -4.0, 6.0)
    d = jax.random.normal(ks[1], (n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    monkeypatch.setattr(inst, "COMPACT_MIN_BOXES", 1)  # force the gate open
    monkeypatch.setattr(inst, "COMPACT_LADDER", ())
    t_ref, i_ref = jax.jit(
        lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    )(o, d)

    monkeypatch.setattr(inst, "COMPACT_LADDER", inst._parse_ladder(ladder))
    t, i = jax.jit(
        lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    )(o, d)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref))


def test_sphere_pretest_gate_and_bit_identity(monkeypatch):
    """The bounding-sphere candidate pretest packs
    spheres only for sphere-like prototypes (tightness gate) and never
    changes results: a sphere-module group packs them, a box group
    (box-filling mesh) does not, and forcing the pretest off is
    bit-identical on a sphere-packed scene."""
    import theia_jax.ops.instanced as inst
    from theia_jax.ops.instanced import nearest_triangle_instanced

    scene = array_scene(3, "instanced", mixed=True)
    groups = scene.pack.instanced.groups
    by_size = sorted(groups, key=lambda g: int(g.base.shape[0]))
    spheres = by_size[-1]
    assert int(spheres.base.shape[0]) == 27 and spheres.sph is not None

    # a cube fills its AABB: bounding sphere == circumsphere -> no pack
    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    corners = np.array(list(np.ndindex(2, 2, 2)), np.float64) - 0.5
    box_faces = [
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
        (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),
    ]
    meshes = MeshStore({"cube": Mesh.from_geometry(corners, box_faces)})
    cubes = [
        meshes.createInstance(
            "cube", "m", Transform.TRS(translate=(3.0 * i, 0.0, 0.0))
        )
        for i in range(2)
    ]
    cube_scene = Scene(cubes, store, medium=None, accel="instanced")
    assert all(g.sph is None for g in cube_scene.pack.instanced.groups)

    o, d = random_rays(4096, seed=7)
    pack = scene.pack.instanced
    t_on, i_on = jax.jit(
        lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    )(o, d)
    # strip the packed spheres -> the plain slab-only scan
    import dataclasses

    stripped = dataclasses.replace(
        pack,
        groups=tuple(dataclasses.replace(g, sph=None) for g in pack.groups),
    )
    t_off, i_off = jax.jit(
        lambda o, d: nearest_triangle_instanced(stripped, o, d, jnp.inf, 256)
    )(o, d)
    np.testing.assert_array_equal(np.asarray(i_on), np.asarray(i_off))
    np.testing.assert_array_equal(np.asarray(t_on), np.asarray(t_off))

    # all init placements of the pretest are result-identical (the
    # rescans always filter; init-off/hybrid just scan supersets)
    monkeypatch.setattr(inst, "COMPACT_MIN_BOXES", 1)  # ladder on
    for mode in ("on", "off", "hybrid"):
        monkeypatch.setattr(inst, "SPHERE_INIT_MODE", mode)
        t_m, i_m = jax.jit(
            lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
        )(o, d)
        np.testing.assert_array_equal(np.asarray(i_m), np.asarray(i_on), mode)
        np.testing.assert_array_equal(np.asarray(t_m), np.asarray(t_on), mode)


def test_ladder_selection_by_group_size(monkeypatch):
    """Groups at/above LADDER_LARGE_MIN_BOXES use the deeper ladder;
    smaller ones the default — both bit-identical to the plain walk."""
    import theia_jax.ops.instanced as inst
    from theia_jax.ops.instanced import nearest_triangle_instanced

    scene = array_scene(3, "instanced")
    pack = scene.pack.instanced
    o, d = random_rays(2048, seed=11)

    monkeypatch.setattr(inst, "COMPACT_MIN_BOXES", 1)
    monkeypatch.setattr(inst, "COMPACT_LADDER", ())
    monkeypatch.setattr(inst, "COMPACT_LADDER_LARGE", ())
    t_ref, i_ref = jax.jit(
        lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    )(o, d)

    # force the 27-instance group through the LARGE ladder
    monkeypatch.setattr(inst, "LADDER_LARGE_MIN_BOXES", 16)
    monkeypatch.setattr(
        inst, "COMPACT_LADDER", inst._parse_ladder("0.375:1,0.0625:-1")
    )
    monkeypatch.setattr(
        inst,
        "COMPACT_LADDER_LARGE",
        inst._parse_ladder("0.375:1,0.125:2,0.03125:-1"),
    )
    t, i = jax.jit(
        lambda o, d: nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    )(o, d)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_ref))
    np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref))


def test_sphere_pretest_anisotropic_and_grazing():
    """The sphere pretest must stay conservative for non-uniform-scale
    instances (ellipsoids: the bound comes from transformed world
    vertices, not the object-space sphere) and for rays grazing the
    module surface — both compared against the brute scan."""
    from theia_jax.accel import _nearest, _nearest_triangle

    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    # a generic rotation keeps the icosphere's edges out of the axis
    # planes the grazing bundle travels in (an edge-on ray has two
    # equally valid winners)
    sphere = icosphere()
    pos = Transform.Rotation(1.0, 2.0, 3.0, 37.0).apply(sphere.vertices[:, :3])
    sphere = Mesh.from_geometry(pos, sphere.indices)
    top = pos[np.argmax(pos[:, 1])]  # the module's topmost vertex
    meshes = MeshStore({"sphere": sphere})
    insts = [
        meshes.createInstance(
            "sphere",
            "m",
            Transform.TRS(
                scale=(0.4, 0.15, 0.7),  # ellipsoid modules
                translate=(2.0 * i, 2.0 * j, 0.0),
            ),
        )
        for i in range(3)
        for j in range(3)
    ]
    scene = Scene(insts, store, medium=None, accel="instanced")
    assert all(
        g.sph is not None for g in scene.pack.instanced.groups
    )  # ellipsoid world bounds are still sphere-tight enough to pack

    # grazing bundle: rays in +x aimed at the topmost vertex of each
    # module (y = cy + 0.15*y_top, z = 0.7*z_top), offset by tiny +-eps
    eps = np.float32([0.0, -1e-5, 1e-5, -1e-4, 1e-4, -1e-3, 1e-3])
    ys = []
    for j in range(3):
        ys.extend(2.0 * j + 0.15 * top[1] + eps)
    o = np.stack(
        [
            np.full(len(ys), -1.0, np.float32),
            np.asarray(ys, np.float32),
            np.full(len(ys), 0.7 * top[2], np.float32),
        ],
        axis=1,
    )
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (len(ys), 1))
    # plus a random bundle over the array
    o_r, d_r = random_rays(4096, lo=-1.5, hi=5.5, seed=23)
    o = jnp.concatenate([jnp.asarray(o), o_r])
    d = jnp.concatenate([jnp.asarray(d), d_r])

    t_b, i_b = _nearest_triangle(scene.pack, o, d, jnp.inf, 256)
    t_i, i_i = _nearest(scene.pack, o, d, jnp.inf, 256)
    t_b, i_b, t_i, i_i = map(np.asarray, (t_b, i_b, t_i, i_i))
    hit_b = i_b >= 0
    assert hit_b.any() and (~hit_b).any()
    assert (hit_b == (i_i >= 0)).mean() > 0.999
    both = hit_b & (i_i >= 0)
    assert np.allclose(t_i[both], t_b[both], rtol=1e-4, atol=1e-5)
    assert (i_i[both] == i_b[both]).mean() > 0.995


def test_query_profile_disables_ladder_for_primary(monkeypatch):
    """Guide-less (pure-primary) traces skip the compaction ladder via
    the trace-time query_profile contextvar (the ladder does not pay on
    photon-mode arrays); the default MIS
    profile engages it. Pinned by poisoning the front-pack helper."""
    import theia_jax.accel as accel_mod
    import theia_jax.ops.instanced as inst
    from theia_jax.ops.instanced import (
        nearest_triangle_instanced,
        query_profile,
    )

    scene = array_scene(3, "instanced")
    pack = scene.pack.instanced
    o, d = random_rays(1024, seed=13)
    monkeypatch.setattr(inst, "COMPACT_MIN_BOXES", 1)

    def boom(*a, **k):
        raise AssertionError("ladder engaged")

    monkeypatch.setattr(accel_mod, "_frontpack_sel", boom)
    with query_profile("primary"):
        t, i = nearest_triangle_instanced(pack, o, d, jnp.inf, 256)
    assert (np.asarray(i) >= 0).any()
    with pytest.raises(AssertionError, match="ladder engaged"):
        nearest_triangle_instanced(pack, o, d, jnp.inf, 256)


def test_photon_tracer_traces_under_primary_profile():
    """ScenePhotonTracer's monolithic AND ladder-chunk programs trace
    with the ladder disabled (photon mode is always guide-less), and
    produce finite histograms on an instanced array scene."""
    import theia_jax.accel as accel_mod
    import theia_jax.units as u
    from unittest import mock

    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HistogramHitResponse
    from theia_jax.trace.photon import ScenePhotonTracer

    mat = Material("det", None, None, flags="DB")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    insts = [
        meshes.createInstance(
            "sphere",
            "det",
            Transform.TRS(scale=0.4, translate=(2.0 * i, 2.0 * j, 0.0)),
            detectorId=0,
        )
        for i in range(2)
        for j in range(2)
    ]
    scene = Scene(insts, store, medium=None, accel="instanced")
    tracer = ScenePhotonTracer(
        2048,
        SphericalLightSource(
            position=(1.0, 1.0, 0.0), timeRange=(0.0, 1.0), budget=1e5
        ),
        UniformWavelengthSource(lambdaRange=(400.0, 500.0)),
        HistogramHitResponse(nBins=20, t0=0.0, binSize=5.0 * u.ns),
        PhiloxRNG(key=5),
        scene,
        nScatteringPerRun=2,
        nRuns=2,
        targetId=-1,
    )
    import theia_jax.ops.instanced as inst

    with mock.patch.object(inst, "COMPACT_MIN_BOXES", 1), mock.patch.object(
        accel_mod,
        "_frontpack_sel",
        side_effect=AssertionError("ladder engaged in photon trace"),
    ):
        hist, _ = tracer.run()
        hist2 = tracer.run_compacted(min_lanes=64)
    assert np.isfinite(np.asarray(hist)).all()
    assert np.isfinite(np.asarray(hist2)).all()
