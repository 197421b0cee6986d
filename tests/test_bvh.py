"""BVH builder (C++ + numpy) and traversal tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from theia_jax.mesh import icosphere, lobed_sphere
from theia_jax.native import BVH, build_bvh, native_available
from theia_jax.ops.bvh_traverse import nearest_triangle_bvh, pack_bvh

pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers


def sphere_tris():
    m = icosphere()
    pos = m.vertices[:, :3]
    idx = m.indices
    v0 = pos[idx[:, 0]]
    e1 = pos[idx[:, 1]] - v0
    e2 = pos[idx[:, 2]] - v0
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def check_invariants(bvh: BVH, n_tri: int, leaf_size: int):
    # every triangle appears exactly once in order
    assert sorted(bvh.order.tolist()) == list(range(n_tri))
    # leaves cover [0, n) contiguously and respect leaf_size
    leaves = bvh.start >= 0
    spans = sorted(
        zip(bvh.start[leaves].tolist(), bvh.count[leaves].tolist())
    )
    pos = 0
    for s, c in spans:
        assert s == pos and 1 <= c <= leaf_size
        pos += c
    assert pos == n_tri
    # node bounds contain their triangles
    pts = np.stack(
        [bvh.bmin, bvh.bmax], axis=1
    )
    v0, e1, e2 = sphere_tris() if n_tri == 1280 else (None, None, None)
    # miss links: valid range or -1, and point forward (DFS order)
    assert ((bvh.miss == -1) | (bvh.miss > np.arange(len(bvh.miss)))).all()


def test_builder_numpy_invariants():
    v0, e1, e2 = sphere_tris()
    bvh = build_bvh(v0, e1, e2, leaf_size=4, force_numpy=True)
    check_invariants(bvh, len(v0), 4)


@pytest.mark.skipif(not native_available(), reason="no C++ toolchain")
def test_builder_native_matches_numpy():
    """Same tree topology; contents may differ where centroid ties are
    partitioned differently (both are valid BVHs) — functional equivalence
    is covered by the traversal-vs-bruteforce test."""
    v0, e1, e2 = sphere_tris()
    a = build_bvh(v0, e1, e2, leaf_size=4, force_numpy=True)
    b = build_bvh(v0, e1, e2, leaf_size=4)
    check_invariants(b, len(v0), 4)
    assert len(a.miss) == len(b.miss)
    assert np.array_equal(a.miss, b.miss)
    assert np.array_equal(a.start, b.start)
    assert np.array_equal(a.count, b.count)


def test_traversal_matches_bruteforce():
    from theia_jax.accel import _nearest_triangle
    from theia_jax.material import Material, MaterialStore
    from theia_jax.scene import MeshStore, Scene, Transform

    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere(), "lobed": lobed_sphere()})
    insts = [
        meshes.createInstance("sphere", "m", Transform.TRS(scale=2.0)),
        meshes.createInstance(
            "lobed", "m", Transform.TRS(scale=1.0, translate=(4.0, 0.0, 0.0))
        ),
    ]
    scene = Scene(insts, store, medium=None)
    pack = scene.pack
    v0 = np.asarray(pack.w_v0)
    e1 = np.asarray(pack.w_e1)
    e2 = np.asarray(pack.w_e2)
    bvh = build_bvh(v0, e1, e2, leaf_size=4)
    packed = pack_bvh(bvh, v0, e1, e2, 4)

    n = 2048
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    o = jax.random.uniform(ks[0], (n, 3), jnp.float32, -3.0, 6.0)
    d = jax.random.normal(ks[1], (n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    t_b, i_b = _nearest_triangle(pack, o, d, jnp.inf, 256)
    t_v, i_v = nearest_triangle_bvh(packed, o, d, jnp.inf)

    t_b, i_b, t_v, i_v = map(np.asarray, (t_b, i_b, t_v, i_v))
    hit_b = i_b >= 0
    assert (hit_b == (i_v >= 0)).mean() > 0.999
    both = hit_b & (i_v >= 0)
    # same nearest t everywhere; indices may differ on exact shared edges
    assert np.allclose(t_b[both], t_v[both], rtol=1e-4, atol=1e-5)
    assert (i_b[both] == i_v[both]).mean() > 0.995


def test_scene_bvh_accel_end_to_end():
    """Ground-truth energy test with the BVH accel backend."""
    import theia_jax.units as u
    from theia_jax.light import SphericalLightSource, UniformWavelengthSource
    from theia_jax.material import Material, MaterialStore
    from theia_jax.random import PhiloxRNG
    from theia_jax.response import HitRecorder
    from theia_jax.scene import MeshStore, Scene, Transform
    from theia_jax.testing import WaterTestModel
    from theia_jax.trace.scene import SceneForwardTracer

    medium = WaterTestModel(mu_a=0.0, mu_s=0.005, g=0.0).createMedium()
    mat = Material("det", medium, None, flags="DB")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    inst = meshes.createInstance(
        "sphere", "det", Transform.TRS(scale=100.0, translate=(12.0, 15.0, 0.2))
    )
    scene = Scene([inst], store, medium="water_test", accel="bvh")
    assert scene.pack.bvh is not None
    rec = HitRecorder()
    tracer = SceneForwardTracer(
        8 * 1024,
        SphericalLightSource(
            position=(12.0, 15.0, 0.2), timeRange=(10.0, 10.0), budget=1e9
        ),
        UniformWavelengthSource(lambdaRange=(400.0, 400.0)),
        rec,
        PhiloxRNG(key=0xC0FFEE),
        scene,
        maxPathLength=10,
        scatterCoefficient=0.05,
        maxTime=float("inf"),
    )
    total = 0.0
    for _ in range(2):
        hits, _ = tracer.run()
        v = np.asarray(hits["valid"])
        total += np.asarray(hits["contrib"])[v].sum()
    estimate = total / (2 * 8 * 1024)
    assert np.abs(estimate / 1e9 - 1.0) < 0.08


def test_accel_auto_selects_by_scene_shape():
    """accel='auto': brute for small scenes, the two-level instanced
    traversal once instancing meaningfully shrinks per-candidate work;
    explicit accel= overrides."""
    from theia_jax.material import Material, MaterialStore
    from theia_jax.render import SceneTemplate
    from theia_jax.scene import (
        AUTO_INSTANCED_THRESHOLD,
        MeshStore,
        Scene,
        Transform,
    )

    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance("sphere", "m", Transform.TRS(scale=0.4))
    template = SceneTemplate([proto])

    n_tri = len(proto.mesh.indices)
    small_n = 2
    big_n = AUTO_INSTANCED_THRESHOLD // n_tri + 1
    small = template.createScene(
        [Transform.TRS(translate=(2.0 * i, 0, 0)) for i in range(small_n)],
        store,
    )
    big = template.createScene(
        [Transform.TRS(translate=(2.0 * i, 0, 0)) for i in range(big_n)],
        store,
    )
    assert small.accel == "brute" and small.pack.instanced is None
    assert big.accel == "instanced" and big.pack.instanced is not None
    # explicit accel + leaf_size are honored
    custom = template.createScene(
        [Transform.TRS(translate=(2.0 * i, 0, 0)) for i in range(big_n)],
        store,
        accel="bvh",
        leaf_size=16,
    )
    assert custom.pack.bvh.leaf_size == 16


def test_stamped_array_bvh_matches_brute():
    """Detector-array scene (template stamping): BVH and brute agree on
    nearest hits — the large-scene parity leg of the crossover story."""
    from theia_jax.accel import _nearest_triangle
    from theia_jax.material import Material, MaterialStore
    from theia_jax.render import SceneTemplate
    from theia_jax.scene import MeshStore, Transform

    mat = Material("m", None, None, flags="B")
    store = MaterialStore.pack([mat])
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance("sphere", "m", Transform.TRS(scale=0.4))
    template = SceneTemplate([proto])
    transforms = [
        Transform.TRS(translate=(2.0 * i, 2.0 * j, 0.0))
        for i in range(3)
        for j in range(3)
    ]
    brute = template.createScene(transforms, store, accel="brute")
    bvh = template.createScene(transforms, store, accel="bvh")

    n = 4096
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    o = jax.random.uniform(ks[0], (n, 3), jnp.float32, -1.0, 5.0)
    d = jax.random.normal(ks[1], (n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    t_b, i_b = _nearest_triangle(brute.pack, o, d, jnp.inf, 256)
    t_v, i_v = nearest_triangle_bvh(bvh.pack.bvh, o, d, jnp.inf)
    t_b, i_b, t_v, i_v = map(np.asarray, (t_b, i_b, t_v, i_v))
    hit_b = i_b >= 0
    assert hit_b.sum() > 100  # the array actually gets hit
    assert (hit_b == (i_v >= 0)).mean() > 0.999
    both = hit_b & (i_v >= 0)
    assert np.allclose(t_b[both], t_v[both], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("accel", ["mt", "woop", "pallas"])
def test_unknown_accel_raises(accel):
    """Only the brute, bvh and instanced backends (and auto) exist."""
    from theia_jax.material import Material, MaterialStore
    from theia_jax.scene import MeshStore, Scene

    store = MaterialStore.pack([Material("m", None, None, flags="B")])
    inst = MeshStore({"sphere": icosphere()}).createInstance("sphere", "m")
    with pytest.raises(ValueError, match="accel must be"):
        Scene([inst], store, accel=accel)
