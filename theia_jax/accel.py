"""Ray/scene intersection over the packed triangle soup.

Replaces the reference's Vulkan ray-query hardware traversal
(reference: src/theia/shader/scene.intersect.glsl:23-124) with wavefront
intersection: a ``lax.scan`` over triangle chunks keeps every lane busy
with a running nearest-hit reduction, sized so each chunk's
intermediates stay small. Scenes in this domain are small (10^2..10^4
triangles — instanced detector modules), so chunked brute force is
compute-dense and needs no divergent BVH walk; a kernel with the same
contract can slot in underneath for larger scenes.

Hit reconstruction reproduces the reference exactly: object-space position
from barycentrics, geometric normal sign-matched to interpolated vertex
normals, inward test, media-mismatch check, world position via the
object-to-world transform, and the bit-offset to avoid self-intersection
(reference: scene.intersect.glsl:47-99, ray.surface.glsl:22-36).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from .ops.math3d import (
    dot,
    matvec,
    moeller_trumbore_rowwise,
    normalize,
    sign_bit,
)
from .scene import ScenePack
from .trace.core import EventResultCode

__all__ = [
    "SurfaceHit",
    "anyhit_culled",
    "anyhit_in_soup",
    "intersect_scene",
    "intersect_target",
    "is_visible",
    "nearest_culled",
    "offset_ray",
]

import os

#: triangles per scan chunk; intermediates are (N, CHUNK) f32
DEFAULT_CHUNK = int(os.environ.get("THEIA_CHUNK", "256"))
_SCAN_UNROLL = int(os.environ.get("THEIA_SCAN_UNROLL", "1"))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SurfaceHit:
    """Wavefront surface-hit description
    (reference: src/theia/shader/scene.types.glsl:31-57)."""

    valid: jax.Array  # bool[N]
    t: jax.Array  # f32[N] ray parameter (inf on miss)
    instance: jax.Array  # i32[N]
    custom_id: jax.Array  # i32[N] detectorId
    flags: jax.Array  # u32[N] material flags for the hit side
    inward: jax.Array  # bool[N]
    medium_in: jax.Array  # i32[N] medium handle on the incident side
    medium_tr: jax.Array  # i32[N] medium handle on the transmitted side
    world_pos: jax.Array  # f32[N,3]
    ray_nrm: jax.Array  # f32[N,3] normal opposing the ray
    obj_pos: jax.Array  # f32[N,3]
    obj_nrm: jax.Array  # f32[N,3] outward geometric normal (object space)
    obj_dir: jax.Array  # f32[N,3]
    world_to_obj: jax.Array  # f32[N,3,3]
    error: jax.Array  # i32[N] media-mismatch error code or 0


def nearest_in_soup(v0, e1, e2, origin, direction, t_max, chunk: int):
    """Scan a (T, 3) triangle soup keeping the nearest hit per lane.

    Layout: all intermediates are (N, C), structure-of-arrays over the
    xyz components, so the minor axis is the chunk axis and never the
    3-wide component axis.

    ``direction`` need not be normalized (the instanced backend passes
    object-space rays whose unnormalized direction preserves the world
    ray parameter). Returns (t, tri_idx); tri_idx == -1 on miss."""
    n_tri = v0.shape[0]
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri

    def comp(a, fill):
        """(T,3) -> three (n_chunks, C) component arrays."""
        a = jnp.pad(a, ((0, pad), (0, 0)), constant_values=fill)
        return tuple(a[:, i].reshape(n_chunks, chunk) for i in range(3))

    v0x, v0y, v0z = comp(v0, 3.0e38)  # padded tris can never be hit
    e1x, e1y, e1z = comp(e1, 0.0)
    e2x, e2y, e2z = comp(e2, 0.0)

    N = origin.shape[0]
    ox, oy, oz = (origin[:, i : i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i : i + 1] for i in range(3))

    def body(carry, tris):
        best_t, best_i = carry
        (cv0x, cv0y, cv0z, ce1x, ce1y, ce1z, ce2x, ce2y, ce2z, base) = tris
        cv0x, cv0y, cv0z = cv0x[None], cv0y[None], cv0z[None]
        ce1x, ce1y, ce1z = ce1x[None], ce1y[None], ce1z[None]
        ce2x, ce2y, ce2z = ce2x[None], ce2y[None], ce2z[None]
        # Moeller-Trumbore, fully scalarized per component; no backface
        # culling (meshes are media interfaces, hit from both sides)
        px = dy * ce2z - dz * ce2y
        py = dz * ce2x - dx * ce2z
        pz = dx * ce2y - dy * ce2x
        det = ce1x * px + ce1y * py + ce1z * pz
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tx = ox - cv0x
        ty = oy - cv0y
        tz = oz - cv0z
        b1 = (tx * px + ty * py + tz * pz) * inv
        qx = ty * ce1z - tz * ce1y
        qy = tz * ce1x - tx * ce1z
        qz = tx * ce1y - ty * ce1x
        b2 = (dx * qx + dy * qy + dz * qz) * inv
        t = (ce2x * qx + ce2y * qy + ce2z * qz) * inv
        # small negative tolerance: rays through shared edges/vertices must
        # not fall through both adjacent triangles (watertightness)
        hit = (
            (inv != 0.0)
            & (b1 >= -1e-6)
            & (b2 >= -1e-6)
            & (b1 + b2 <= 1.0 + 1e-6)
            & (t > 0.0)
        )
        t = jnp.where(hit, t, jnp.inf)
        # gather-free reduction: ONE variadic lexicographic reduce gives
        # (min t, lowest index at min) in a single pass. Two separate
        # reductions (min, then masked index-min against the broadcast
        # minimum) let XLA rematerialize the whole (N, C) t matrix —
        # i.e. redo the Moeller-Trumbore math — for the second pass.
        local = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)

        def lexi_min(a, b):
            at, ai = a
            bt, bi = b
            take_b = (bt < at) | ((bt == at) & (bi < ai))
            return (
                jnp.where(take_b, bt, at),
                jnp.where(take_b, bi, ai),
            )

        # selection is piecewise-constant in the inputs: stop_gradient
        # keeps the variadic reduce off the AD path (it has no JVP rule
        # for mixed zero tangents); the winner's differentiable t is
        # recomputed from its triangle row in _reconstruct_hit
        tt, idx_c = lax.reduce(
            (lax.stop_gradient(t), local),
            (jnp.float32(jnp.inf), jnp.int32(0x7FFFFFFF)),
            lexi_min,
            (1,),
        )
        better = tt < best_t
        best_i = jnp.where(better, idx_c + base, best_i)
        best_t = jnp.where(better, tt, best_t)
        return (best_t, best_i), None

    init = (
        jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,)),
        jnp.full((N,), -1, jnp.int32),
    )
    bases = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (t, idx), _ = lax.scan(
        body,
        init,
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, bases),
        unroll=_SCAN_UNROLL,
    )
    miss = idx < 0
    t = jnp.where(miss, jnp.inf, t)
    return t, idx


def _nearest_triangle(pack: ScenePack, origin, direction, t_max, chunk: int):
    """Nearest hit over the scene's world-space triangle soup."""
    return nearest_in_soup(
        pack.w_v0, pack.w_e1, pack.w_e2, origin, direction, t_max, chunk
    )


def anyhit_in_soup(
    v0, e1, e2, origin, direction, t_max, chunk: int, *, early_exit: bool = False
):
    """Any-hit occlusion over a (T, 3) triangle soup: True where some
    triangle blocks the ray strictly before ``t_max``.

    Visibility queries never need the winner: dropping the nearest-hit
    bookkeeping (min-t + masked index reduce per chunk) leaves only the
    Moeller-Trumbore test and a single OR-reduce. ``early_exit=True``
    swaps the chunk loop for a ``while_loop`` that stops once every lane
    is occluded (the reference's hardware any-hit early-out,
    scene.intersect.glsl:104-124, at chunk granularity) — but its
    all-lanes AND-reduce per chunk is itself a full-wavefront pass that
    rarely triggers on MIS shadow rays; default off."""
    n_tri = v0.shape[0]
    if n_tri == 0:  # e.g. a scene whose every triangle is a detector
        return jnp.zeros((origin.shape[0],), bool)
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri

    def comp(a, fill):
        a = jnp.pad(a, ((0, pad), (0, 0)), constant_values=fill)
        return tuple(a[:, i].reshape(n_chunks, chunk) for i in range(3))

    v0x, v0y, v0z = comp(v0, 3.0e38)
    e1x, e1y, e1z = comp(e1, 0.0)
    e2x, e2y, e2z = comp(e2, 0.0)

    N = origin.shape[0]
    ox, oy, oz = (origin[:, i : i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i : i + 1] for i in range(3))
    bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))[:, None]

    def chunk_occludes(k, occ):
        cv = lambda a: lax.dynamic_index_in_dim(a, k, 0, keepdims=False)[None]
        cv0x, cv0y, cv0z = cv(v0x), cv(v0y), cv(v0z)
        ce1x, ce1y, ce1z = cv(e1x), cv(e1y), cv(e1z)
        ce2x, ce2y, ce2z = cv(e2x), cv(e2y), cv(e2z)
        px = dy * ce2z - dz * ce2y
        py = dz * ce2x - dx * ce2z
        pz = dx * ce2y - dy * ce2x
        det = ce1x * px + ce1y * py + ce1z * pz
        inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
        tx = ox - cv0x
        ty = oy - cv0y
        tz = oz - cv0z
        b1 = (tx * px + ty * py + tz * pz) * inv
        qx = ty * ce1z - tz * ce1y
        qy = tz * ce1x - tx * ce1z
        qz = tx * ce1y - ty * ce1x
        b2 = (dx * qx + dy * qy + dz * qz) * inv
        t = (ce2x * qx + ce2y * qy + ce2z * qz) * inv
        hit = (
            (inv != 0.0)
            & (b1 >= -1e-6)
            & (b2 >= -1e-6)
            & (b1 + b2 <= 1.0 + 1e-6)
            & (t > 0.0)
            & (t < bound)
        )
        return occ | jnp.any(hit, axis=-1)

    occ0 = jnp.zeros((N,), bool)
    if not early_exit:
        return lax.fori_loop(0, n_chunks, chunk_occludes, occ0)

    def cond(carry):
        k, occ = carry
        return (k < n_chunks) & ~jnp.all(occ)

    def body(carry):
        k, occ = carry
        return k + 1, chunk_occludes(k, occ)

    _, occ = lax.while_loop(cond, body, (jnp.int32(0), occ0))
    return occ


#: lane-compaction capacity for culled brute queries, as a fraction of the
#: wavefront; lanes beyond it fall back to the full-width scan at runtime
#: (lax.cond), so any value is correct — smaller is faster on the segments
#: where few rays reach an instance, but falls back earlier
CULL_CAP_FRAC = float(os.environ.get("THEIA_CULL_CAP", "0.125"))

#: which brute queries use the culled path: "all" (+ primary nearest and
#: is_visible), "shadow" (MIS shadow split only), "primary", or "off"
#: (diagnostic knob; results are bit-identical in every mode). Default
#: "shadow": the primary nearest's early segments (every ray starts
#: inside the source module) always fall back, so culling it only adds
#: the cond boundary and compaction overhead
CULL_MODE = os.environ.get("THEIA_CULL_MODE", "shadow")

#: capacity fraction for the shadow query's detector-nearest pass. Guide
#: shadow rays aim at a detector by construction, so ~the guide half of
#: the fused 2N-lane pair always needs its detector's group; compacting
#: that many lanes pays the full gather/expand cost for a small pair
#: reduction, so the default keeps the shared fallback-happy capacity
CULL_CAP_DET = float(os.environ.get("THEIA_CULL_CAP_DET", "0.125"))

#: minimum number of detector cull groups before intersect_target uses the
#: per-module culled det-nearest instead of the plain subsoup nearest.
#: Default 4 (compaction cannot win when a single detector is needed by
#: about half the lanes); diagnostic knob — setting 1 forces the
#: compacted path for A/B measurement
CULL_DET_MIN_GROUPS = int(os.environ.get("THEIA_CULL_DET_MIN_GROUPS", "4"))

#: audit hook: when set to a list, every culled query appends its cond
#: predicate (True = compacted branch ran, False = count-overflow
#: fallback) via a host callback. Diagnostic only (bench.py BENCH_AUDIT
#: uses it to discharge the "no fallback fired" assumption behind the
#: static pairs-tested accounting); None in production — zero cost.
CULL_AUDIT: list | None = None


def _audit_cond(ok_all) -> None:
    if CULL_AUDIT is not None:
        jax.debug.callback(
            lambda ok: CULL_AUDIT.append(bool(ok)), ok_all
        )


#: capacity fraction for the shadow query's occluder any-hit pass. With
#: the live-lane (miss) mask few lanes need the occluders (shadow rays
#: originate at water scatter points, far from the source module), and
#: a compacted scan's cost is its static capacity — so a tight cap pays
#: directly; the cond falls back to the full scan on scenes/segments
#: that exceed it
CULL_CAP_OCC = float(os.environ.get("THEIA_CULL_CAP_OCC", "0.03125"))


def _seg_hits_sphere(origin, direction, t_max, center, radius):
    """Conservative: True unless the ray segment [0, t_max] provably
    misses the sphere. ``direction`` need not be unit length (the true
    closest-approach parameter is -<oc,d>/|d|^2 — matching
    nearest_in_soup's unnormalized-direction contract). The slack term
    covers the f32 rounding of the closest-approach chain (error <=
    ~1e-6 |oc|^2, margin 1e-5 |oc|^2)."""
    oc = origin - center
    b = jnp.sum(oc * direction, axis=-1)
    d2 = jnp.sum(direction * direction, axis=-1)
    tc = jnp.clip(-b / jnp.maximum(d2, 1e-30), 0.0, t_max)
    p = oc + tc[..., None] * direction
    s = jnp.sum(p * p, axis=-1)
    oc2 = jnp.sum(oc * oc, axis=-1)
    return s <= radius * radius * 1.003 + oc2 * 1e-5 + 1e-9


def _frontpack_sel(need, pos, capacity: int):
    """Fixed-capacity stable lane compaction: ``sel[j]`` = lane index of
    the j-th needed lane (arbitrary past the count). ``pos`` is the
    running cumsum-1 of ``need`` (see callers — computed outside so the
    fallback branch never pays the scatter)."""
    n = need.shape[0]
    slot = jnp.where(need & (pos < capacity), pos, capacity)
    return jnp.zeros((capacity,), jnp.int32).at[slot].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )


def _cull_capacity(n_lanes: int) -> int:
    cap = int(n_lanes * CULL_CAP_FRAC)
    return max(128, min(n_lanes, cap))


def _group_soups(pack: ScenePack, groups):
    """Static (v0, e1, e2, start) slices for the given cull groups."""
    out = []
    for k in groups:
        start, end = pack.cull.spans[k]
        out.append((
            lax.slice_in_dim(pack.w_v0, start, end),
            lax.slice_in_dim(pack.w_e1, start, end),
            lax.slice_in_dim(pack.w_e2, start, end),
            start,
        ))
    return out


def nearest_culled(
    pack: ScenePack, origin, direction, t_max, chunk: int, *,
    groups=None, active=None, full_fallback=None, cap_frac=None,
):
    """Nearest hit over the brute soup with per-instance bounding-sphere
    culling + lane compaction (the wavefront equivalent of the
    reference's hardware per-instance TLAS culling,
    scene.intersect.glsl:23-46).

    Only lanes whose segment can reach an instance's bounding sphere run
    its triangle tests; they are packed to a fixed-capacity front
    (``_frontpack_sel``) and the per-instance results merge
    lexicographically — *bit-identical* to the single full scan (same
    per-pair f32 math on the same triangles; the global (min t, lowest
    index) reduction is partition-invariant). ONE ``lax.cond`` guards the
    whole query: when any instance's needed-lane count exceeds the
    capacity (e.g. early segments where every ray starts inside the
    source module), the fallback runs ``full_fallback`` — by default the
    plain single-soup scan, i.e. exactly the un-culled code path — so
    throughput adapts per segment while results never change, and the
    per-query cost never exceeds one cond boundary."""
    cull = pack.cull
    n = origin.shape[0]
    cap = _cull_capacity(n) if cap_frac is None else max(
        128, min(n, int(n * cap_frac))
    )
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    which = list(range(len(cull.spans))) if groups is None else list(groups)
    soups = _group_soups(pack, which)

    needs, poss = [], []
    ok_all = True
    for k in which:
        need = _seg_hits_sphere(
            origin, direction, t_max_b, cull.centers[k], cull.radii[k]
        )
        if active is not None:
            need = need & active
        pos = jnp.cumsum(need.astype(jnp.int32)) - 1
        needs.append(need)
        poss.append(pos)
        ok_all = ok_all & (pos[-1] + 1 <= cap)

    def compacted(_):
        best_t = t_max_b
        best_i = jnp.full((n,), -1, jnp.int32)
        for (v0, e1, e2, start), need, pos in zip(soups, needs, poss):
            sel = _frontpack_sel(need, pos, cap)
            og = jnp.take(origin, sel, axis=0)
            dg = jnp.take(direction, sel, axis=0)
            tg = jnp.take(t_max_b, sel, axis=0)
            t_c, i_c = nearest_in_soup(v0, e1, e2, og, dg, tg, chunk)
            p = jnp.clip(pos, 0, cap - 1)
            t_k = jnp.where(need, jnp.take(t_c, p), jnp.inf)
            i_k = jnp.where(need, jnp.take(i_c, p), -1)
            i_k = jnp.where(i_k >= 0, i_k + start, -1)
            take = (t_k < best_t) | (
                (t_k == best_t) & (i_k >= 0) & ((best_i < 0) | (i_k < best_i))
            )
            best_t = jnp.where(take, t_k, best_t)
            best_i = jnp.where(take, i_k, best_i)
        return jnp.where(best_i < 0, jnp.inf, best_t), best_i

    def full(_):
        if full_fallback is not None:
            return full_fallback()
        t_f, i_f = _masked_group_scan(
            soups, needs, origin, direction, t_max_b, chunk
        )
        return t_f, i_f

    _audit_cond(ok_all)
    return lax.cond(ok_all, compacted, full, None)


def _masked_group_scan(soups, needs, origin, direction, t_max_b, chunk):
    """Un-compacted per-group nearest (the culled query's fallback when no
    ``full_fallback`` is given): full-width scans, results masked by the
    (conservative) need tests so both cond branches agree bit-for-bit."""
    n = origin.shape[0]
    best_t = t_max_b
    best_i = jnp.full((n,), -1, jnp.int32)
    for (v0, e1, e2, start), need in zip(soups, needs):
        t_f, i_f = nearest_in_soup(
            v0, e1, e2, origin, direction, t_max_b, chunk
        )
        t_k = jnp.where(need, t_f, jnp.inf)
        i_k = jnp.where(need & (i_f >= 0), i_f + start, -1)
        take = (t_k < best_t) | (
            (t_k == best_t) & (i_k >= 0) & ((best_i < 0) | (i_k < best_i))
        )
        best_t = jnp.where(take, t_k, best_t)
        best_i = jnp.where(take, i_k, best_i)
    return jnp.where(best_i < 0, jnp.inf, best_t), best_i


def anyhit_culled(
    pack: ScenePack, origin, direction, t_max, chunk: int, *,
    groups=None, active=None, full_fallback=None, cap_frac=None,
):
    """Occlusion over the brute soup with the same per-instance culling +
    compaction as :func:`nearest_culled` (boolean OR merge; one cond for
    the whole query). ``active`` masks lanes whose result is never
    consumed downstream (their output is False)."""
    cull = pack.cull
    n = origin.shape[0]
    cap = _cull_capacity(n) if cap_frac is None else max(
        128, min(n, int(n * cap_frac))
    )
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    which = list(range(len(cull.spans))) if groups is None else list(groups)
    soups = _group_soups(pack, which)

    needs, poss = [], []
    ok_all = True
    for k in which:
        need = _seg_hits_sphere(
            origin, direction, t_max_b, cull.centers[k], cull.radii[k]
        )
        if active is not None:
            need = need & active
        pos = jnp.cumsum(need.astype(jnp.int32)) - 1
        needs.append(need)
        poss.append(pos)
        ok_all = ok_all & (pos[-1] + 1 <= cap)

    def compacted(_):
        occ = jnp.zeros((n,), bool)
        for (v0, e1, e2, _s), need, pos in zip(soups, needs, poss):
            sel = _frontpack_sel(need, pos, cap)
            og = jnp.take(origin, sel, axis=0)
            dg = jnp.take(direction, sel, axis=0)
            tg = jnp.take(t_max_b, sel, axis=0)
            occ_c = anyhit_in_soup(v0, e1, e2, og, dg, tg, chunk)
            occ = occ | (jnp.take(occ_c, jnp.clip(pos, 0, cap - 1)) & need)
        return occ

    def full(_):
        if full_fallback is not None:
            return full_fallback()
        occ = jnp.zeros((n,), bool)
        for (v0, e1, e2, _s), need in zip(soups, needs):
            occ = occ | (
                anyhit_in_soup(v0, e1, e2, origin, direction, t_max_b, chunk)
                & need
            )
        return occ

    _audit_cond(ok_all)
    return lax.cond(ok_all, compacted, full, None)


def _nearest(pack: ScenePack, origin, direction, t_max, chunk: int):
    """Nearest-hit query via the scene's chosen acceleration backend.

    All backends share the contract (t, tri_idx) with t=inf / idx=-1 on
    miss and indices into the pack's triangle tables."""
    if pack.instanced is not None:
        from .ops.instanced import nearest_triangle_instanced

        return nearest_triangle_instanced(
            pack.instanced, origin, direction, t_max, chunk
        )
    if pack.bvh is not None:
        from .ops.bvh_traverse import nearest_triangle_bvh

        return nearest_triangle_bvh(pack.bvh, origin, direction, t_max)
    if pack.cull is not None and CULL_MODE in ("all", "primary"):
        # fallback = exactly the un-culled scan (bit-identical partition
        # merge, see nearest_culled docstring)
        return nearest_culled(
            pack, origin, direction, t_max, chunk,
            full_fallback=lambda: _nearest_triangle(
                pack, origin, direction, t_max, chunk
            ),
        )
    return _nearest_triangle(pack, origin, direction, t_max, chunk)


def offset_ray(p: jax.Array, n: jax.Array) -> jax.Array:
    """Self-intersection-safe offset of position ``p`` along normal ``n``
    ("Ray Tracing Gems" ch. 6; reference: ray.surface.glsl:22-36)."""
    of_i = (256.0 * n).astype(jnp.int32)
    p_i_bits = p.view(jnp.int32) + jnp.where(p < 0.0, -of_i, of_i)
    p_i = p_i_bits.view(jnp.float32)
    return jnp.where(
        jnp.abs(p) < (1.0 / 32.0), p + (1.0 / 65536.0) * n, p_i
    )


def intersect_scene(
    pack: ScenePack,
    medium_handle: jax.Array,
    origin: jax.Array,
    direction: jax.Array,
    t_max,
    *,
    chunk: int = DEFAULT_CHUNK,
) -> SurfaceHit:
    """Trace the wavefront against the scene and reconstruct full hits.

    ``medium_handle``: i32[N] — the medium each lane believes it is in;
    mismatches against the hit material's expectation raise the
    media-mismatch error exactly like the reference.

    Reconstruction reads exactly two wide rows per lane (triangle row +
    instance row); barycentrics AND the ray parameter for the single
    winner are recomputed from the world triangle in the row. The *selection* (which triangle wins) runs
    under ``stop_gradient``: it is piecewise constant in the ray, so away
    from visibility boundaries the winner's recomputed t/b1/b2 carry the
    exact derivative — and backends that traverse with ``lax.while_loop``
    (bvh, instanced) become usable under ``jax.grad``."""
    t_sel, tri = _nearest(
        pack,
        lax.stop_gradient(origin),
        lax.stop_gradient(direction),
        lax.stop_gradient(jnp.asarray(t_max, jnp.float32)),
        chunk,
    )
    return _reconstruct_hit(pack, medium_handle, origin, direction, t_sel, tri)


def _reconstruct_hit(
    pack: ScenePack, medium_handle, origin, direction, t_sel, tri
) -> SurfaceHit:
    """Rebuild the full SurfaceHit for per-lane winning triangles ``tri``
    (global ``tri_data`` rows, -1 on miss) — the shared back half of
    :func:`intersect_scene` and :func:`intersect_target`."""
    valid = tri >= 0
    tri_safe = jnp.maximum(tri, 0)

    row = jnp.take(pack.tri_data, tri_safe, axis=0)  # (N, 32)
    o_v0, o_e1, o_e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    wv0, we1, we2 = row[:, 18:21], row[:, 21:24], row[:, 24:27]
    inst = row[:, 27].astype(jnp.int32)

    # winner barycentrics (Moeller-Trumbore on the world triangle)
    b1, b2, t_win, inv = moeller_trumbore_rowwise(
        origin, direction, wv0, we1, we2
    )
    # differentiable winner t (equals the selected backend t up to fp);
    # if the world-space det underflows the degeneracy cutoff for a hit
    # the backend validly selected (possible for extreme grazing hits —
    # the instanced backend tests in scale-normalized object space whose
    # det can sit on the other side of the absolute epsilon), fall back
    # to the backend's own t instead of emitting a corrupted t = 0
    t = jnp.where(valid, jnp.where(inv != 0.0, t_win, t_sel), jnp.inf)

    bb1, bb2 = b1[:, None], b2[:, None]
    obj_pos = o_v0 + bb1 * o_e1 + bb2 * o_e2
    obj_nrm = jnp.cross(o_e1, o_e2)
    int_nrm = n0 + bb1 * (n1 - n0) + bb2 * (n2 - n0)
    # match sign of the geometric normal to the authored vertex normals
    obj_nrm = obj_nrm * sign_bit(dot(obj_nrm, int_nrm))[:, None]
    obj_nrm = normalize(obj_nrm)

    irow = jnp.take(pack.inst_data, inst, axis=0)  # (N, 32)
    w2o = irow[:, 0:12].reshape(-1, 3, 4)
    o2w = irow[:, 12:24].reshape(-1, 3, 4)
    lin_w2o = w2o[:, :, :3]
    obj_dir = normalize(matvec(lin_w2o, direction))
    inward = dot(obj_dir, obj_nrm) <= 0.0

    flags = jnp.where(inward, irow[:, 26], irow[:, 27]).astype(jnp.uint32)
    # medium on the ray's side vs transmitted side
    inside = irow[:, 24].astype(jnp.int32)
    outside = irow[:, 25].astype(jnp.int32)
    medium_expected = jnp.where(inward, outside, inside)
    medium_tr = jnp.where(inward, inside, outside)
    mismatch = valid & (medium_handle != medium_expected)
    error = jnp.where(
        mismatch,
        jnp.int32(EventResultCode.ERROR_MEDIA_MISMATCH),
        jnp.int32(0),
    )

    # world normal: n_w = n_o @ W2O_linear (covariant transform)
    world_nrm = normalize(matvec(jnp.swapaxes(lin_w2o, -1, -2), obj_nrm))
    ray_nrm = world_nrm * jnp.where(inward, 1.0, -1.0)[:, None]
    # world pos via object-to-world to minimize error (reference:
    # scene.intersect.glsl:90-95)
    world_pos = (
        matvec(o2w[:, :, :3], obj_pos) + o2w[:, :, 3]
    )

    return SurfaceHit(
        valid=valid,
        t=t,
        instance=inst,
        custom_id=irow[:, 28].astype(jnp.int32),
        flags=flags,
        inward=inward,
        medium_in=medium_handle,
        medium_tr=medium_tr,
        world_pos=world_pos,
        ray_nrm=ray_nrm,
        obj_pos=obj_pos,
        obj_nrm=obj_nrm,
        obj_dir=obj_dir,
        world_to_obj=lin_w2o,
        error=error,
    )


def intersect_target(
    pack: ScenePack,
    medium_handle: jax.Array,
    origin: jax.Array,
    direction: jax.Array,
    t_max,
    *,
    chunk: int = DEFAULT_CHUNK,
    active: jax.Array | None = None,
) -> SurfaceHit:
    """Shadow-ray query: nearest hit *on a detector instance*, invalid if
    any other geometry blocks the ray first.

    Exploits that MIS shadow rays only respond on detector-flagged
    instances (the reference's volume-mode target+occlusion split,
    scene.traverse.glsl:234-269): nearest-hit ordering runs over the small
    detector subsoup only, and the rest of the scene is a cheap any-hit
    occlusion query bounded by the winner's distance (strictly before —
    the winner itself can never re-trigger, its own t is not < t).
    Only the pure brute backend uses the split: the
    occlusion soup excludes detector triangles, so exactness needs the
    occluders tested with bit-identical math to the subsoup nearest —
    an accelerated occlusion query (bvh/instanced) recomputes t
    with different fusions and can land an ulp below the bound on the
    winner itself, falsely occluding it (observed on bvh). Accelerated
    packs fall back to :func:`intersect_scene`.

    ``active``: optional bool[N] — lanes whose result is never consumed
    downstream (e.g. non-miss lanes of the MIS block). Inactive lanes
    are masked out of the culled queries *and* report ``valid=False``
    uniformly, so their (otherwise skipped/garbage) hits can never leak
    into a caller that forgets to re-mask."""
    split = pack.shadow_split
    if split is None or pack.instanced is not None or pack.bvh is not None:
        return intersect_scene(
            pack, medium_handle, origin, direction, t_max, chunk=chunk
        )
    og = lax.stop_gradient(origin)
    dg = lax.stop_gradient(direction)
    tg = lax.stop_gradient(jnp.asarray(t_max, jnp.float32))
    cull = pack.cull if CULL_MODE in ("all", "shadow") else None
    if cull is not None:
        # per-instance culled + compacted split: nearest over the detector
        # groups, any-hit over the occluder groups bounded by the winner.
        # ``active`` masks lanes whose hit is never consumed (non-miss
        # lanes of the MIS block) out of both queries.
        det_groups = [k for k, d in enumerate(cull.is_det) if d]
        occ_groups = [k for k, d in enumerate(cull.is_det) if not d]
        tg_b = jnp.broadcast_to(tg, (og.shape[0],))
        if len(det_groups) >= CULL_DET_MIN_GROUPS and CULL_CAP_DET > 0:
            # detector arrays: each guide ray aims at ONE module, so the
            # per-module needed fractions are ~1/G and compaction pays
            t_t, tri_d = nearest_culled(
                pack, og, dg, tg_b, chunk, groups=det_groups, active=active,
                cap_frac=CULL_CAP_DET,
            )
        else:
            # few detectors: ~the guide half always needs them, so
            # compaction cannot win — but the masked per-group scan
            # avoids the subsoup path's gather: group spans are
            # contiguous, so the winner's global row is ``local + start``
            # — pure arithmetic — where the subsoup path pays a 2N-lane
            # ``det_idx`` gather. Run it directly, without the
            # compaction pretest/cond.
            needs = []
            for k in det_groups:
                need = _seg_hits_sphere(
                    og, dg, tg_b, cull.centers[k], cull.radii[k]
                )
                if active is not None:
                    need = need & active
                needs.append(need)
            t_t, tri_d = _masked_group_scan(
                _group_soups(pack, det_groups), needs, og, dg, tg_b, chunk
            )
        bound = jnp.minimum(t_t, tg_b)
        occ = anyhit_culled(
            pack, og, dg, bound, chunk, groups=occ_groups, active=active,
            cap_frac=CULL_CAP_OCC,
            # fallback = the full occluder-subsoup any-hit
            full_fallback=lambda: anyhit_in_soup(
                split.nd_v0, split.nd_e1, split.nd_e2, og, dg, bound, chunk
            ),
        )
        valid = (tri_d >= 0) & ~occ
        if active is not None:
            # inactive lanes skipped the occlusion query (occ forced
            # False) — force them invalid so both cond branches agree
            valid = valid & active
        tri = jnp.where(valid, tri_d, -1)
        t_sel = jnp.where(valid, t_t, jnp.inf)
        return _reconstruct_hit(
            pack, medium_handle, origin, direction, t_sel, tri
        )
    t_t, i_loc = nearest_in_soup(
        split.det_v0, split.det_e1, split.det_e2, og, dg, tg, chunk
    )
    bound = jnp.minimum(t_t, jnp.broadcast_to(tg, t_t.shape))
    occ = anyhit_in_soup(
        split.nd_v0, split.nd_e1, split.nd_e2, og, dg, bound, chunk
    )
    valid = (i_loc >= 0) & ~occ
    tri = jnp.where(
        valid, jnp.take(split.det_idx, jnp.maximum(i_loc, 0)), -1
    )
    t_sel = jnp.where(valid, t_t, jnp.inf)
    return _reconstruct_hit(pack, medium_handle, origin, direction, t_sel, tri)


def is_visible(
    pack: ScenePack,
    observer: jax.Array,
    target: jax.Array,
    *,
    chunk: int = DEFAULT_CHUNK,
) -> jax.Array:
    """True where observer and target see each other
    (reference: scene.intersect.glsl:104-124)."""
    d = target - observer
    dist = jnp.sqrt(jnp.maximum(dot(d, d), 1e-30))
    direction = d / dist[:, None]
    # boolean query: selection only, never differentiated — stop_gradient
    # keeps while_loop backends (bvh, instanced) jax.grad-compatible
    observer = lax.stop_gradient(observer)
    direction = lax.stop_gradient(direction)
    dist = lax.stop_gradient(dist)
    if pack.instanced is not None:
        # occlusion needs no nearest-hit ordering: the any-hit query lets
        # each lane stop at its first blocking candidate
        from .ops.instanced import occluded_instanced

        return ~occluded_instanced(
            pack.instanced, observer, direction, dist, chunk
        )
    if pack.bvh is not None:
        from .ops.bvh_traverse import occluded_bvh

        return ~occluded_bvh(pack.bvh, observer, direction, dist)
    # culled visibility is opt-in (CULL_MODE=all): backward/direct
    # tracers connect to a light that typically sits INSIDE a source
    # module, so that instance's cull can never fire and the pretest is
    # pure overhead
    if pack.cull is not None and CULL_MODE == "all":
        return ~anyhit_culled(pack, observer, direction, dist, chunk)
    return ~anyhit_in_soup(
        pack.w_v0, pack.w_e1, pack.w_e2, observer, direction, dist, chunk
    )
