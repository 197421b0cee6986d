"""Culled brute queries (accel.nearest_culled / anyhit_culled).

Contract: per-instance bounding-sphere culling + fixed-capacity lane
compaction is *bit-identical* to the plain full-soup scan — for the
primary nearest query, the MIS shadow split, and visibility — in both
cond branches (compacted and the count-overflow fallback). The cull is
conservative (the sphere test carries an |oc|^2-scaled f32 slack), so a
culled-out lane provably cannot hit the instance
(reference analogue: per-instance TLAS culling by the hardware ray
query, scene.intersect.glsl:23-46).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import theia_jax.accel as accel
from theia_jax.accel import intersect_scene, intersect_target, is_visible
from theia_jax.material import Material, MaterialStore
from theia_jax.mesh import icosphere
from theia_jax.scene import MeshStore, Scene, Transform

pytestmark = pytest.mark.core


def multi_scene(cull=True, detector=True):
    """Three instanced spheres: two occluders + one detector."""
    mats = MaterialStore.pack(
        [
            Material("wall", None, None, flags="TR"),
            Material("det", None, None, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": icosphere()})
    insts = [
        meshes.createInstance(
            "sphere", "wall", Transform.TRS(scale=0.8, translate=(3.0, 0, 0))
        ),
        meshes.createInstance(
            "sphere", "wall", Transform.TRS(scale=0.5, translate=(0, 0, 2.0))
        ),
        meshes.createInstance(
            "sphere",
            "det" if detector else "wall",
            Transform.TRS(scale=0.6, translate=(0, 3.0, 0)),
            detectorId=1,
        ),
    ]
    return Scene(insts, mats, medium=None, accel="brute", cull=cull)


def random_rays(n, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    o = jax.random.uniform(ks[0], (n, 3), jnp.float32, -2.0, 5.0)
    d = jax.random.normal(ks[1], (n, 3), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    t = jax.random.uniform(ks[2], (n,), jnp.float32, 0.1, 30.0)
    return o, d, t


def _hits_equal(a, b, mask=None):
    for f in ("valid", "t", "instance", "custom_id", "flags", "world_pos"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if mask is not None:
            x, y = x[mask], y[mask]
        assert np.array_equal(x, y, equal_nan=True), f
    # winner fields only meaningful on valid lanes
    v = np.asarray(a.valid)
    if mask is not None:
        v = v & mask
    for f in ("ray_nrm", "obj_pos", "medium_tr"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.array_equal(x[v], y[v], equal_nan=True), f


@pytest.fixture(scope="module")
def packs():
    return multi_scene(cull=True).pack, multi_scene(cull=False).pack


def test_cull_tables_built(packs):
    pc, pf = packs
    assert pf.cull is None
    cull = pc.cull
    assert cull is not None
    assert len(cull.spans) == 3 and cull.is_det == (False, False, True)
    # spans tile the soup contiguously
    assert cull.spans[0][0] == 0
    assert all(
        cull.spans[k][1] == cull.spans[k + 1][0] for k in range(2)
    )
    assert cull.spans[-1][1] == pc.w_v0.shape[0]
    # spheres contain their instance's triangles (conservative)
    tri_inst = np.asarray(pc.tri_data[:, 27]).astype(np.int32)
    verts = np.concatenate(
        [
            np.asarray(pc.w_v0),
            np.asarray(pc.w_v0) + np.asarray(pc.w_e1),
            np.asarray(pc.w_v0) + np.asarray(pc.w_e2),
        ]
    )
    vinst = np.concatenate([tri_inst] * 3)
    for k in range(3):
        r = np.linalg.norm(
            verts[vinst == k] - np.asarray(pc.cull.centers[k]), axis=1
        ).max()
        assert r <= float(pc.cull.radii[k])


@pytest.mark.parametrize("cap_frac", [1.0, 0.25, 0.004])
def test_nearest_culled_bit_identical(packs, cap_frac, monkeypatch):
    """cap 1.0 = no compaction; 0.25 = compacted branch; 0.004 = the
    count-overflow fallback branch. All bit-identical to the full scan.
    (CULL_MODE forced to "all" — the default "shadow" leaves the primary
    nearest un-culled.)"""
    monkeypatch.setattr(accel, "CULL_MODE", "all")
    monkeypatch.setattr(accel, "CULL_CAP_FRAC", cap_frac)
    pc, pf = packs
    o, d, t = random_rays(4096)
    med = jnp.zeros((4096,), jnp.int32)
    h_c = jax.jit(lambda o, d, t: intersect_scene(pc, med, o, d, t))(o, d, t)
    h_f = jax.jit(lambda o, d, t: intersect_scene(pf, med, o, d, t))(o, d, t)
    _hits_equal(h_c, h_f)


@pytest.mark.parametrize("cap_frac", [0.25, 0.004])
def test_intersect_target_culled(packs, cap_frac, monkeypatch):
    monkeypatch.setattr(accel, "CULL_CAP_FRAC", cap_frac)
    pc, pf = packs
    o, d, t = random_rays(4096, seed=1)
    med = jnp.zeros((4096,), jnp.int32)
    active = jax.random.uniform(jax.random.PRNGKey(5), (4096,)) < 0.7
    s_c = jax.jit(
        lambda o, d, t: intersect_target(pc, med, o, d, t, active=active)
    )(o, d, t)
    s_f = jax.jit(lambda o, d, t: intersect_target(pf, med, o, d, t))(o, d, t)
    # identical wherever the result is consumed (active lanes)
    _hits_equal(s_c, s_f, mask=np.asarray(active))


def array_scene(cull=True):
    """Detector array: 5 detector modules + 2 occluders — enough
    detector groups (>= 4) to engage intersect_target's culled
    det-array branch (nearest_culled over per-module groups)."""
    mats = MaterialStore.pack(
        [
            Material("wall", None, None, flags="TR"),
            Material("det", None, None, flags="DB"),
        ]
    )
    meshes = MeshStore({"sphere": icosphere()})
    det_pos = [
        (0.0, 3.0, 0.0),
        (3.0, 3.0, 0.0),
        (-3.0, 3.0, 0.0),
        (0.0, 3.0, 3.0),
        (0.0, -3.0, 0.0),
    ]
    insts = [
        meshes.createInstance(
            "sphere", "wall", Transform.TRS(scale=0.8, translate=(3.0, 0, 0))
        ),
        meshes.createInstance(
            "sphere", "wall", Transform.TRS(scale=0.5, translate=(0, 0, 2.0))
        ),
    ] + [
        meshes.createInstance(
            "sphere", "det", Transform.TRS(scale=0.6, translate=p),
            detectorId=i + 1,
        )
        for i, p in enumerate(det_pos)
    ]
    return Scene(insts, mats, medium=None, accel="brute", cull=cull)


@pytest.mark.parametrize("cap_det", [0.25, 0.002])
def test_intersect_target_detector_array(cap_det, monkeypatch):
    """The >= 4-detector culled branch (per-module nearest_culled det
    groups + active masking) is bit-identical to the un-culled pack on
    active lanes — in the compacted branch (cap 0.25) and the
    count-overflow fallback (cap 0.002)."""
    monkeypatch.setattr(accel, "CULL_CAP_DET", cap_det)
    pc = array_scene(cull=True).pack
    pf = array_scene(cull=False).pack
    det_groups = [k for k, d in enumerate(pc.cull.is_det) if d]
    assert len(det_groups) == 5  # branch precondition
    n = 4096
    o, d, t = random_rays(n, seed=7)
    med = jnp.zeros((n,), jnp.int32)
    active = jax.random.uniform(jax.random.PRNGKey(11), (n,)) < 0.7
    h_c = jax.jit(
        lambda o, d, t: intersect_target(pc, med, o, d, t, active=active)
    )(o, d, t)
    h_f = jax.jit(lambda o, d, t: intersect_target(pf, med, o, d, t))(o, d, t)
    _hits_equal(h_c, h_f, mask=np.asarray(active))
    # inactive lanes are uniformly invalid (never garbage-but-plausible)
    assert not np.asarray(h_c.valid)[~np.asarray(active)].any()


def test_is_visible_culled(packs, monkeypatch):
    monkeypatch.setattr(accel, "CULL_MODE", "all")
    pc, pf = packs
    o, d, t = random_rays(4096, seed=2)
    tgt = o + d * (t * 0.5)[:, None]
    v_c = jax.jit(lambda o, tgt: is_visible(pc, o, tgt))(o, tgt)
    v_f = jax.jit(lambda o, tgt: is_visible(pf, o, tgt))(o, tgt)
    assert np.array_equal(np.asarray(v_c), np.asarray(v_f))


def test_translate_instance_updates_cull(packs, monkeypatch):
    monkeypatch.setattr(accel, "CULL_MODE", "all")
    pc, _ = packs
    moved = pc.translate_instance(1, jnp.asarray([0.5, -0.25, 1.0]))
    # sphere follows the instance; radius unchanged
    assert np.allclose(
        np.asarray(moved.cull.centers[1]),
        np.asarray(pc.cull.centers[1]) + np.asarray([0.5, -0.25, 1.0]),
    )
    assert np.array_equal(
        np.asarray(moved.cull.radii), np.asarray(pc.cull.radii)
    )
    # and the culled query still matches a from-scratch rebuilt scene
    o, d, t = random_rays(2048, seed=3)
    med = jnp.zeros((2048,), jnp.int32)
    h_m = jax.jit(lambda o, d, t: intersect_scene(moved, med, o, d, t))(o, d, t)
    # reference: cull disabled on the same moved pack
    from dataclasses import replace

    h_f = jax.jit(
        lambda o, d, t: intersect_scene(replace(moved, cull=None), med, o, d, t)
    )(o, d, t)
    _hits_equal(h_m, h_f)


def test_cull_conservative_slack():
    """Rays exactly grazing the bounding sphere stay needed (slack)."""
    scene = multi_scene(cull=True)
    pack = scene.pack
    c = np.asarray(pack.cull.centers[0])
    r = float(pack.cull.radii[0])
    # tangent ray in the xy-plane at exactly the sphere radius
    o = jnp.asarray([[c[0] - 5.0, c[1] + r, c[2]]], jnp.float32)
    d = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    need = accel._seg_hits_sphere(
        o, d, jnp.asarray([100.0], jnp.float32), pack.cull.centers[0],
        pack.cull.radii[0],
    )
    assert bool(need[0])
