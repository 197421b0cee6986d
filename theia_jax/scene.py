"""Scenes: transforms, mesh instances and the packed device representation.

Semantics follow the reference (reference: src/theia/scene.py, docs/scene.md):
meshes are *interfaces between media* (not solids), normals point outward,
materials assign media and flags to both sides, detectors are selected by a
``detectorId`` carried per instance, and hits are reported in object space
so responses are independent of the detector's pose.

Array representation: instead of Vulkan BLAS/TLAS handles, a Scene
packs into a :class:`ScenePack` pytree of flat arrays — world-space
triangles (for intersection), object-space vertex data (for hit
reconstruction), per-triangle instance ids and per-instance transform/
material/flag tables. Traversal lives in :mod:`theia_jax.accel`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from . import units as u
from .material import MaterialStore, MediumStore
from .mesh import Mesh, loadMesh

__all__ = [
    "Transform",
    "RectBBox",
    "SphereBBox",
    "MeshInstance",
    "MeshStore",
    "Scene",
    "ScenePack",
    "ShadowSplit",
    "CullTables",
    "AUTO_BVH_THRESHOLD",
    "AUTO_INSTANCED_THRESHOLD",
]

#: triangle count above which ``accel="auto"`` switches from the chunked
#: brute-force scan to the threaded BVH. No crossover has been measured
#: on the GPU yet (tools/bench_bvh_crossover.py sweeps it), so auto keeps
#: brute (or instanced) and the BVH remains opt-in (``accel="bvh"``).
AUTO_BVH_THRESHOLD = 1 << 62

#: flattened triangle count above which ``accel="auto"`` prefers the
#: two-level instanced traversal (ops.instanced) when the scene actually
#: instances its meshes (flattened >= 2x unique prototype triangles).
#: Below it the plain brute scan is already cheap enough that the box
#: pass + while_loop overhead is not worth carrying.
AUTO_INSTANCED_THRESHOLD = 8 * 1024


class Transform:
    """3x4 affine transformation (reference: src/theia/scene.py:42-296)."""

    def __init__(self, matrix=None) -> None:
        self._arr = np.identity(4)
        if matrix is not None:
            matrix = np.asarray_chkfinite(matrix)
            if matrix.shape != (3, 4):
                raise ValueError("matrix must be of shape (3,4)!")
            self._arr[:3, :] = matrix

    def apply(self, points):
        return np.asarray(points) @ self._arr[:3, :3].T + self._arr[:3, 3]

    def applyVec(self, vectors):
        return np.asarray(vectors) @ self._arr[:3, :3].T

    def copy(self) -> "Transform":
        return Transform(self._arr[:3, :].copy())

    def inverse(self) -> "Transform":
        inv = Transform()
        inv._arr = np.linalg.inv(self._arr)
        return inv

    def numpy(self) -> np.ndarray:
        return np.ascontiguousarray(self._arr[:3, :], dtype=np.float32)

    @property
    def innerMatrix(self) -> np.ndarray:
        return self.numpy()[:3, :3]

    @property
    def offset(self) -> np.ndarray:
        return self.numpy()[:3, 3]

    def __matmul__(self, other: "Transform") -> "Transform":
        res = Transform()
        res._arr = self._arr @ other._arr
        return res

    @staticmethod
    def Rotation(dx, dy, dz, angle) -> "Transform":
        """Rotation around axis (dx,dy,dz) by ``angle`` degrees."""
        length = np.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx / length, dy / length, dz / length
        K = np.array([[0.0, -dz, dy], [dz, 0.0, -dx], [-dy, dx, 0.0]])
        res = Transform()
        a = np.deg2rad(angle)
        res._arr[:3, :3] += np.sin(a) * K + (1.0 - np.cos(a)) * (K @ K)
        return res

    @staticmethod
    def Scale(x, y=None, z=None) -> "Transform":
        if y is None:
            y = z = x
        res = Transform()
        res._arr[0, 0], res._arr[1, 1], res._arr[2, 2] = x, y, z
        return res

    @staticmethod
    def Translation(x, y, z) -> "Transform":
        res = Transform()
        res._arr[:3, 3] = (x, y, z)
        return res

    @staticmethod
    def TRS(*, scale=1.0, rotate=None, translate=(0.0, 0.0, 0.0)) -> "Transform":
        """translate @ rotate @ scale (scale first)."""
        t = Transform.Scale(scale, scale, scale) if np.isscalar(scale) else Transform.Scale(*scale)
        if rotate is not None:
            t = rotate @ t
        return Transform.Translation(*translate) @ t

    @staticmethod
    def View(*, direction=(0.0, 0.0, 1.0), up=(0.0, 1.0, 0.0), position=(0.0, 0.0, 0.0)) -> "Transform":
        """Orient +z onto ``direction`` with the given up vector and move to
        position (reference: src/theia/scene.py View)."""
        d = np.asarray(direction, np.float64)
        d = d / np.linalg.norm(d)
        upv = np.asarray(up, np.float64)
        x = np.cross(upv, d)
        if np.linalg.norm(x) < 1e-12:
            # pick any perpendicular
            upv = (
                np.array([0.0, 1.0, 0.0])
                if abs(d[1]) < 0.9
                else np.array([1.0, 0.0, 0.0])
            )
            x = np.cross(upv, d)
        x = x / np.linalg.norm(x)
        y = np.cross(d, x)
        res = Transform()
        res._arr[:3, 0] = x
        res._arr[:3, 1] = y
        res._arr[:3, 2] = d
        res._arr[:3, 3] = position
        return res

    @staticmethod
    def LookAt(*, position=(0.0, 0.0, 0.0), target=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> "Transform":
        direction = np.asarray(target, np.float64) - np.asarray(position, np.float64)
        return Transform.View(direction=direction, up=up, position=position)


class RectBBox:
    """Axis-aligned bounding box (reference: src/theia/scene.py:299-380)."""

    def __init__(self, lowerCorner, upperCorner) -> None:
        self.lowerCorner = tuple(float(c) for c in lowerCorner)
        self.upperCorner = tuple(float(c) for c in upperCorner)

    @property
    def diagonal(self) -> float:
        d = np.subtract(self.upperCorner, self.lowerCorner)
        return float(np.sqrt(np.square(d).sum()))

    def transform(self, trafo: Transform) -> "RectBBox":
        corners = np.array(
            [
                [
                    (self.lowerCorner, self.upperCorner)[b][k]
                    for k, b in enumerate(bits)
                ]
                for bits in np.ndindex(2, 2, 2)
            ]
        )
        pts = trafo.apply(corners)
        return RectBBox(tuple(pts.min(0)), tuple(pts.max(0)))


class SphereBBox:
    """Spherical bounds (reference: src/theia/scene.py:383-431)."""

    def __init__(self, center, radius: float) -> None:
        self.center = tuple(float(c) for c in center)
        self.radius = float(radius)


class MeshInstance:
    """A placed mesh with material name, transform and detector id
    (reference: src/theia/scene.py:454-528)."""

    def __init__(
        self,
        key: str,
        mesh: Mesh,
        material: str,
        transform: Transform,
        detectorId: int = 0,
    ) -> None:
        self.key = key
        self.mesh = mesh
        self.material = material
        self.transform = transform
        self.detectorId = detectorId

    @property
    def bbox(self) -> RectBBox:
        pts = self.transform.apply(self.mesh.vertices[:, :3])
        return RectBBox(tuple(pts.min(0)), tuple(pts.max(0)))


class MeshStore:
    """Named mesh registry (reference: src/theia/scene.py:529-605)."""

    def __init__(self, meshes: dict) -> None:
        self._meshes = {
            k: (loadMesh(v) if isinstance(v, (str,)) or hasattr(v, "__fspath__") else v)
            for k, v in meshes.items()
        }

    def createInstance(
        self,
        key: str,
        material: str,
        transform: Transform | None = None,
        *,
        detectorId: int = 0,
        scale: float | None = None,
    ) -> MeshInstance:
        mesh = self._meshes[key]
        if scale is None:
            scale = 1.0 * u.m
        trafo = Transform.Scale(scale, scale, scale)
        if transform is not None:
            trafo = transform @ trafo
        return MeshInstance(key, mesh, material, trafo, detectorId)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShadowSplit:
    """Detector-triangle subsoup for MIS shadow rays.

    Shadow rays only ever *respond* on detector-flagged instances, so
    ``accel.intersect_target`` finds the nearest hit on this small soup
    and reduces the rest of the scene to a cheap any-hit occlusion query
    bounded by that distance (the reference's volume-mode pattern,
    scene.traverse.glsl:234-269). ``det_idx`` maps subsoup rows back to
    global ``tri_data`` rows. Instance-id columns keep ``translate_instance`` working."""

    det_v0: jax.Array  # (Td, 3) world-space detector triangles
    det_e1: jax.Array
    det_e2: jax.Array
    det_idx: jax.Array  # (Td,) i32 global tri_data rows
    det_inst: jax.Array  # (Td,) f32 instance ids
    nd_v0: jax.Array  # (Tn, 3) every other triangle (occluders)
    nd_e1: jax.Array
    nd_e2: jax.Array
    nd_inst: jax.Array  # (Tn,) f32


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CullTables:
    """Per-instance conservative world bounding spheres + static soup
    spans, enabling *culled* brute queries (accel.nearest_culled /
    anyhit_culled): lanes whose ray segment provably misses an
    instance's bounding sphere skip its triangle tests via fixed-capacity
    lane compaction — the wavefront stand-in for the per-ray BLAS
    culling the reference gets from hardware TLAS traversal
    (reference: scene.intersect.glsl:23-46 rayQuery over instances).

    ``spans`` are static (start, end) rows into the pack's brute soup
    (one contiguous span per instance), so the group triangles are free
    XLA slices of ``w_v0``/``w_e1``/``w_e2`` and stay consistent under
    ``translate_instance``. ``radii`` are conservative: max vertex
    distance from the instance's AABB center, inflated for f32 slack
    (the query test adds its own |origin-center|^2-scaled margin)."""

    centers: jax.Array  # (I, 3) f32
    radii: jax.Array  # (I,) f32, conservative
    spans: tuple = field(metadata=dict(static=True), default=())
    is_det: tuple = field(metadata=dict(static=True), default=())


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ScenePack:
    """Flat device arrays describing the scene (the BLAS/TLAS analogue).

    Layout is gather-aware: the intersection scan streams the SoA
    world-triangle arrays linearly, while everything needed to
    *reconstruct* the single winning hit per lane lives in two wide
    row-tables (``tri_data``/``inst_data``) so the per-lane random access
    is two row gathers instead of ~14."""

    # world-space triangle soup (T, 3) each — scanned, never gathered
    w_v0: jax.Array
    w_e1: jax.Array  # v1 - v0
    w_e2: jax.Array  # v2 - v0
    # per-triangle reconstruction rows (T, 32) f32, see accel.py TRI_* cols:
    # object-space v0/e1/e2, vertex normals n0/n1/n2, world v0/e1/e2,
    # instance id (as float; exact below 2^24)
    tri_data: jax.Array
    # per-instance rows (K, 32) f32, see accel.py INST_* cols: world_to_obj
    # (3x4), obj_to_world (3x4), inside/outside medium handle, inward/
    # outward flags, detector id (ints stored as exact small floats)
    inst_data: jax.Array
    # media tables
    media: MediumStore
    # scene-global
    medium: jax.Array  # i32 handle of the surrounding medium
    lower_bbox: jax.Array  # f32 (3,)
    upper_bbox: jax.Array
    # optional threaded-BVH acceleration data (see theia_jax.native)
    bvh: "object | None" = None
    # optional two-level instanced traversal tables (ops.instanced)
    instanced: "object | None" = None
    # optional detector subsoup for MIS shadow rays (accel.intersect_target)
    shadow_split: "ShadowSplit | None" = None
    # optional per-instance culling tables for brute queries (CullTables)
    cull: "CullTables | None" = None

    def translate_instance(self, instance_id: int, delta) -> "ScenePack":
        """Return a pack with instance ``instance_id`` rigidly shifted by
        ``delta`` (world space) — jit-safe and differentiable, enabling
        detector-geometry calibration: ``jax.grad`` of a light curve with
        respect to a module's position (the geometry arrays live in the
        params pytree, and ``intersect_scene`` recomputes the winning
        hit differentiably; geometric distances are gradient-reattached,
        see trace/core.reattach_geometry).

        Only the brute-scan tables are rewritten; accelerated packs
        (bvh/instanced) bake world geometry into their own structures and
        would go stale."""
        if self.bvh is not None or self.instanced is not None:
            raise ValueError(
                "translate_instance requires accel='brute' (accelerated "
                "packs bake world-space geometry)"
            )
        delta = jnp.asarray(delta, jnp.float32)
        tri_mask = (self.tri_data[:, 27] == float(instance_id))[:, None]
        w_v0 = self.w_v0 + tri_mask * delta
        tri_data = self.tri_data.at[:, 18:21].add(tri_mask * delta)

        inst = self.inst_data
        row = inst[instance_id]
        # obj_to_world [R|t] rows flat at 12:24 -> t entries 15, 19, 23
        o2w_t = jnp.array([15, 19, 23])
        row = row.at[o2w_t].add(delta)
        # world_to_obj [R'|t']: new t' = t' - R' @ delta
        r_w2o = row[0:12].reshape(3, 4)[:, :3]
        w2o_t = jnp.array([3, 7, 11])
        row = row.at[w2o_t].add(-(r_w2o @ delta))
        inst_data = inst.at[instance_id].set(row)
        from dataclasses import replace as _dc_replace

        split = self.shadow_split
        if split is not None:
            dmask = (split.det_inst == float(instance_id))[:, None]
            nmask = (split.nd_inst == float(instance_id))[:, None]
            split = _dc_replace(
                split,
                det_v0=split.det_v0 + dmask * delta,
                nd_v0=split.nd_v0 + nmask * delta,
            )
        cull = self.cull
        if cull is not None:
            # rigid translation: the bounding sphere moves, radius unchanged
            cull = _dc_replace(
                cull, centers=cull.centers.at[instance_id].add(delta)
            )
        return _dc_replace(
            self,
            w_v0=w_v0,
            tri_data=tri_data,
            inst_data=inst_data,
            shadow_split=split,
            cull=cull,
        )


class Scene:
    """Scene = instances + material store + surrounding medium
    (reference: src/theia/scene.py:608-710).

    ``material_store``: a MaterialStore (or it is built from the media of the
    given materials); ``medium``: name of the surrounding medium or None.
    """

    def __init__(
        self,
        instances: list[MeshInstance],
        materials: "dict | MaterialStore",
        *,
        medium: str | None = None,
        bbox: RectBBox | None = None,
        accel: str = "auto",
        leaf_size: int = 8,
        cull: bool = True,
    ) -> None:
        if not isinstance(materials, MaterialStore):
            materials = MaterialStore.pack(list(materials.values()))
        if accel not in ("auto", "brute", "bvh", "instanced"):
            raise ValueError(
                "accel must be 'auto', 'brute', 'bvh' or 'instanced'"
            )
        if accel == "auto":
            # on *instanced* scenes (detector arrays) the two-level
            # traversal scans only each lane's candidate prototypes —
            # pick it once instancing meaningfully shrinks the
            # per-candidate work
            n_tri = sum(len(i.mesh.indices) for i in instances)
            protos = {id(i.mesh): i.mesh for i in instances}.values()
            unique = sum(len(m.indices) for m in protos)
            max_proto = max((len(m.indices) for m in protos), default=0)
            # instanced scans one *prototype* per candidate instance, so
            # it only helps while the largest prototype itself stays in
            # the brute-friendly regime
            if (
                n_tri >= AUTO_INSTANCED_THRESHOLD
                and n_tri >= 2 * unique
                and max_proto < AUTO_BVH_THRESHOLD
            ):
                accel = "instanced"
            else:
                accel = "brute" if n_tri < AUTO_BVH_THRESHOLD else "bvh"
        self.instances = instances
        self.materials = materials
        self.medium = medium
        self.accel = accel
        self.leaf_size = leaf_size
        self.cullEnabled = cull
        self.bbox = bbox if bbox is not None else RectBBox(
            (-1.0 * u.km,) * 3, (1.0 * u.km,) * 3
        )
        self._pack = self._build()

    @property
    def pack(self) -> ScenePack:
        return self._pack

    def _build(self) -> ScenePack:
        store = self.materials
        w_v0, w_e1, w_e2 = [], [], []
        o_v0, o_e1, o_e2 = [], [], []
        o_n0, o_n1, o_n2 = [], [], []
        tri_inst = []
        w2o, o2w = [], []
        ins_med, out_med, fl_in, fl_out, det = [], [], [], [], []
        for k, inst in enumerate(self.instances):
            mesh = inst.mesh
            pos = mesh.vertices[:, :3]
            nrm = mesh.vertices[:, 3:]
            idx = mesh.indices
            wpos = inst.transform.apply(pos).astype(np.float32)
            for dst, src in (
                (w_v0, wpos[idx[:, 0]]),
                (w_e1, wpos[idx[:, 1]] - wpos[idx[:, 0]]),
                (w_e2, wpos[idx[:, 2]] - wpos[idx[:, 0]]),
                (o_v0, pos[idx[:, 0]]),
                (o_e1, pos[idx[:, 1]] - pos[idx[:, 0]]),
                (o_e2, pos[idx[:, 2]] - pos[idx[:, 0]]),
                (o_n0, nrm[idx[:, 0]]),
                (o_n1, nrm[idx[:, 1]]),
                (o_n2, nrm[idx[:, 2]]),
            ):
                dst.append(np.asarray(src, np.float32))
            tri_inst.append(np.full(len(idx), k, np.int32))
            o2w.append(inst.transform.numpy())
            w2o.append(inst.transform.inverse().numpy())
            mat = store.material_handle(inst.material)
            ins_med.append(int(store.inside[mat]))
            out_med.append(int(store.outside[mat]))
            fl_in.append(int(store.flags_inward[mat]))
            fl_out.append(int(store.flags_outward[mat]))
            det.append(inst.detectorId)

        catn = lambda xs: np.concatenate(xs, axis=0)

        instanced_pack = None
        if self.accel == "instanced":
            from .ops.instanced import pack_instanced

            instanced_pack = pack_instanced(self.instances, w2o)

        bvh_pack = None
        if self.accel == "bvh":
            from .native import build_bvh
            from .ops.bvh_traverse import pack_bvh

            cv0 = catn(w_v0)
            ce1 = catn(w_e1)
            ce2 = catn(w_e2)
            leaf = self.leaf_size
            bvh = build_bvh(cv0, ce1, ce2, leaf_size=leaf)
            bvh_pack = pack_bvh(bvh, cv0, ce1, ce2, leaf)

        # wide reconstruction rows (see ScenePack docstring / accel.py cols)
        n_tri = sum(len(a) for a in tri_inst)
        tri_data = np.zeros((n_tri, 32), np.float32)
        tri_data[:, 0:3] = catn(o_v0)
        tri_data[:, 3:6] = catn(o_e1)
        tri_data[:, 6:9] = catn(o_e2)
        tri_data[:, 9:12] = catn(o_n0)
        tri_data[:, 12:15] = catn(o_n1)
        tri_data[:, 15:18] = catn(o_n2)
        tri_data[:, 18:21] = catn(w_v0)
        tri_data[:, 21:24] = catn(w_e1)
        tri_data[:, 24:27] = catn(w_e2)
        tri_data[:, 27] = catn(tri_inst).astype(np.float32)

        n_inst = len(self.instances)
        inst_data = np.zeros((n_inst, 32), np.float32)
        inst_data[:, 0:12] = np.stack(w2o).reshape(n_inst, 12)
        inst_data[:, 12:24] = np.stack(o2w).reshape(n_inst, 12)
        inst_data[:, 24] = np.asarray(ins_med, np.float32)
        inst_data[:, 25] = np.asarray(out_med, np.float32)
        inst_data[:, 26] = np.asarray(fl_in, np.float32)
        inst_data[:, 27] = np.asarray(fl_out, np.float32)
        inst_data[:, 28] = np.asarray(det, np.float32)

        # detector subsoup for MIS shadow rays (see ShadowSplit); det_idx
        # rows index tri_data
        from .material import MaterialFlags

        det_bit = int(MaterialFlags.DETECTOR)
        inst_is_det = np.asarray(
            [(fi | fo) & det_bit != 0 for fi, fo in zip(fl_in, fl_out)]
        )
        all_inst = catn(tri_inst)
        tri_is_det = inst_is_det[all_inst]
        shadow_split = None
        if tri_is_det.any():
            cv0, ce1, ce2 = catn(w_v0), catn(w_e1), catn(w_e2)
            didx = np.nonzero(tri_is_det)[0].astype(np.int32)
            nidx = np.nonzero(~tri_is_det)[0].astype(np.int32)
            shadow_split = ShadowSplit(
                det_v0=jnp.asarray(cv0[didx]),
                det_e1=jnp.asarray(ce1[didx]),
                det_e2=jnp.asarray(ce2[didx]),
                det_idx=jnp.asarray(didx),
                det_inst=jnp.asarray(all_inst[didx].astype(np.float32)),
                nd_v0=jnp.asarray(cv0[nidx]),
                nd_e1=jnp.asarray(ce1[nidx]),
                nd_e2=jnp.asarray(ce2[nidx]),
                nd_inst=jnp.asarray(all_inst[nidx].astype(np.float32)),
            )

        # per-instance culling tables for brute queries (CullTables): the
        # brute soup keeps instances contiguous, so each group is a static
        # span; bounding spheres are conservative over the world vertices
        cull = None
        if self.accel == "brute" and self.cullEnabled and n_inst >= 2:
            counts = [len(a) for a in tri_inst]
            starts = np.concatenate([[0], np.cumsum(counts)])
            centers, radii = [], []
            for k in range(n_inst):
                verts = np.concatenate(
                    [w_v0[k], w_v0[k] + w_e1[k], w_v0[k] + w_e2[k]], axis=0
                )
                c = 0.5 * (verts.min(axis=0) + verts.max(axis=0))
                r = float(np.linalg.norm(verts - c, axis=1).max())
                centers.append(c)
                radii.append(r * 1.001 + 1e-5)
            cull = CullTables(
                centers=jnp.asarray(np.stack(centers), jnp.float32),
                radii=jnp.asarray(np.asarray(radii), jnp.float32),
                spans=tuple(
                    (int(starts[k]), int(starts[k + 1])) for k in range(n_inst)
                ),
                is_det=tuple(bool(b) for b in inst_is_det),
            )

        return ScenePack(
            w_v0=jnp.asarray(catn(w_v0)),
            w_e1=jnp.asarray(catn(w_e1)),
            w_e2=jnp.asarray(catn(w_e2)),
            tri_data=jnp.asarray(tri_data),
            inst_data=jnp.asarray(inst_data),
            media=store.media,
            medium=jnp.asarray(store.media.handle(self.medium), jnp.int32),
            lower_bbox=jnp.asarray(self.bbox.lowerCorner, jnp.float32),
            upper_bbox=jnp.asarray(self.bbox.upperCorner, jnp.float32),
            bvh=bvh_pack,
            instanced=instanced_pack,
            shadow_split=shadow_split,
            cull=cull,
        )
