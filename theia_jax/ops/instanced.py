"""Two-level instanced traversal: TLAS over instance AABBs, prototype scan.

The domain's scaling scenario is a detector array — hundreds of copies of
a handful of module meshes (reference: instanced BLAS under a TLAS,
src/theia/scene.py:454-528 + hardware ray queries). Instead of gathering
per-lane BLAS nodes, every lane scans the SAME prototype triangle table
(uniform access, zero gathers, fully vectorized) after transforming its
ray into the candidate instance's object space with one small gather of
the (K, 12) transform table.

Per mesh group the query runs a ``lax.while_loop`` over *candidate
instances in per-lane nearest-entry order*:

1. ``_next_candidate``: a fused chunked scan over the K instance AABBs
   returns each lane's nearest unprocessed box entry (monotonic
   ``(t_entry, k)`` cursor — no per-lane visited set needed).
2. Transform the ray by the candidate's world-to-object row; the
   direction is NOT normalized, so the object-space ray parameter equals
   the world one.
3. ``nearest_in_soup`` over the prototype's object-space triangles
   (same Moeller-Trumbore + tolerances as the brute backend).
4. A lane is done once every remaining box entry lies beyond its current
   nearest hit; the loop ends when all lanes are done. Iteration count is
   the worst lane's number of boxes closer than its first hit —
   typically 1-3 for solid modules, ~n_side for array-crossing misses —
   each iteration costing one prototype scan instead of the brute path's
   full flattened-soup scan.

Worst case (every lane crosses every box with no hit) degrades to
K * T_proto tests — the same count as brute force — so the backend is
never catastrophically wrong, just pays the box scans on top.

Two work reducers wrap the walk (both bit-identical):
a compaction LADDER front-packs the lanes that have any candidate
(25-40% of the wavefront) to a static capacity before the first
iteration and shrinks again for the tail (``COMPACT_LADDER`` /
``COMPACT_LADDER_LARGE``), and the candidate scan rejects instances
whose conservative world bounding sphere the segment provably misses
(``SPHERE_PRETEST`` — sphere-like modules fill only ~pi/6 of a
corner-crossing box candidate's cross-section).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .math3d import matvec

__all__ = [
    "GroupPack",
    "InstancedPack",
    "pack_instanced",
    "nearest_triangle_instanced",
    "occluded_instanced",
]

#: instance AABBs per fused scan chunk ((N, C) intermediates)
BOX_CHUNK = 64

import os

#: compaction ladder for the candidate walk: comma-separated
#: ``cap_frac:iters`` stages. Lanes with a live candidate front-pack to
#: ``cap_frac`` of the wavefront (one lax.cond per stage falls back to
#: full width when they don't fit), run ``iters`` candidate iterations
#: (-1 = to completion; the final stage must be -1), and scatter back.
#: Rationale: on the MIS query mix only 25-40% of lanes have ANY
#: candidate, so even iteration 0 compacts under a 0.5 cap; from
#: iteration 2 the live fraction is 2-6% and a tight cap pays directly.
#: Empty string disables compaction entirely (diagnostic; results
#: bit-identical either way). Stage-A cap 0.375: the live fraction is
#: 25-40%, so 0.375 usually fits (a tighter cap overflows into the
#: fallback). The caps are not yet tuned on the GPU.
COMPACT_LADDER_SPEC = os.environ.get(
    "THEIA_INSTANCED_LADDER", "0.375:1,0.0625:-1"
)

#: deeper ladder for groups with >= LADDER_LARGE_MIN_BOXES instances:
#: their walks have a longer tail (worst lane crosses ~n_side boxes), so
#: an extra mid shrink can pay (results bit-identical either way)
COMPACT_LADDER_LARGE_SPEC = os.environ.get(
    "THEIA_INSTANCED_LADDER_LARGE", "0.375:1,0.125:2,0.03125:-1"
)
LADDER_LARGE_MIN_BOXES = int(
    os.environ.get("THEIA_INSTANCED_LADDER_LARGE_MIN", "256")
)


def _parse_ladder(spec: str) -> tuple:
    try:
        if not spec:
            return ()
        stages = []
        for part in spec.split(","):
            cap, iters = part.split(":")
            stages.append((float(cap), int(iters)))
    except ValueError as e:
        raise ValueError(
            f"bad ladder spec {spec!r} (THEIA_INSTANCED_LADDER[_LARGE]): "
            "expected comma-separated cap_frac:iters stages"
        ) from e
    # only the FINAL stage may run to completion (-1); a negative iters
    # earlier would silently truncate the ladder at _group_query's break
    for cap, iters in stages[:-1]:
        if iters < 1:
            raise ValueError(
                f"bad ladder spec {spec!r}: non-final stage "
                f"{cap}:{iters} must have iters >= 1 (-1 only last)"
            )
    if stages and stages[-1][1] != -1:
        stages.append((stages[-1][0], -1))
    return tuple(stages)


COMPACT_LADDER = _parse_ladder(COMPACT_LADDER_SPEC)
COMPACT_LADDER_LARGE = _parse_ladder(COMPACT_LADDER_LARGE_SPEC)

#: minimum instances in a group before the mid-walk compaction engages:
#: walks are short on small arrays, so the pack/unpack overhead can
#: exceed what it saves; tune with tools/bench_detector_array.py +
#: THEIA_INSTANCED_LADDER=...
COMPACT_MIN_BOXES = int(os.environ.get("THEIA_INSTANCED_COMPACT_MIN", "100"))

#: per-instance bounding-sphere pretest in the candidate scan: a ray can
#: cross a module's AABB near a corner yet provably miss the module's
#: bounding sphere — for sphere-like modules (the domain's detector
#: arrays) ~half of box-crossing rays do (Cauchy projected areas:
#: pi/6 of a cube-crossing bundle hits the inscribed-diameter sphere), and
#: each false candidate otherwise costs a full prototype scan. The test
#: adds ~31 flops/box to the ~25-flop slab test, so it is packed only for
#: groups whose spheres are actually tighter than the boxes' circumspheres
#: (mean radius < SPHERE_TIGHT x half-diagonal); results are bit-identical
#: either way (the sphere is conservative over the instance's world
#: vertices with the same slack as accel._seg_hits_sphere). 0 disables.
SPHERE_PRETEST = os.environ.get("THEIA_INSTANCED_SPHERE", "1") != "0"
SPHERE_TIGHT = 0.95

#: sphere pretest placement for the INITIAL full-width candidate scan
#: (the compacted rescans always apply it; a sphere-off scan visits a
#: strict superset of candidates, so any mix is result-identical):
#:   "on"     — test in the initial scan too (smaller live set for the
#:              ladder, no wasted first prototype scan)
#:   "off"    — slab-only initial scan (cheaper per box, but the
#:              larger live set costs the ladder more)
#:   "hybrid" — slab-only initial scan, then re-derive the first
#:              sphere-valid candidate at the ladder's stage-A width
#:              (cursor reset to -inf on the compacted lanes): the
#:              O(N x K) scan pays slab-only cost and the sphere filter
#:              runs at 0.375 N
_SIM = os.environ.get("THEIA_INSTANCED_SPHERE_INIT", "1")
SPHERE_INIT_MODE = {"1": "on", "0": "off"}.get(_SIM, _SIM)
if SPHERE_INIT_MODE not in ("on", "off", "hybrid"):
    raise ValueError(
        f"THEIA_INSTANCED_SPHERE_INIT={_SIM!r}: expected 1/on, 0/off, "
        "or hybrid"
    )

from contextlib import contextmanager
from contextvars import ContextVar

#: trace-time query profile: the compaction ladder pays for the MIS
#: tracer's query mix (25-40% of lanes live) but not on pure-primary
#: wavefronts where nearly every lane is live (ScenePhotonTracer on an
#: array) — tracers that issue only primary nearest queries wrap their
#: trace in ``query_profile("primary")`` to skip the ladder (any-hit
#: occlusion walks keep it: their done-lanes retire immediately, so the
#: live fraction drops fast). Read at
#: TRACE time (contextvar -> thread-safe under the dispatch worker);
#: results are bit-identical either way.
QUERY_PROFILE: ContextVar = ContextVar(
    "theia_instanced_query_profile", default="mis"
)


@contextmanager
def query_profile(profile: str):
    """Set the instanced-walk query profile while tracing a program."""
    if profile not in ("mis", "primary"):
        raise ValueError(f"unknown query profile {profile!r}")
    tok = QUERY_PROFILE.set(profile)
    try:
        yield
    finally:
        QUERY_PROFILE.reset(tok)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GroupPack:
    """One prototype mesh + its K placed instances.

    The prototype lives in *scale-normalized* object space: vertices and
    the world-to-object rows are both multiplied by the group's median
    instance scale, so transformed rays and triangles sit at world
    magnitude and the Moeller-Trumbore degeneracy epsilon (an absolute
    |det| cutoff) means the same thing it does for the world-space brute
    scan. Ray parameters are unaffected (a uniform scale of both cancels
    in t). ``box`` holds the instance AABBs pre-packed as six
    (n_chunks, BOX_CHUNK) SoA component arrays (lo xyz, hi xyz) with
    inverted-box padding."""

    v0: jax.Array  # f32 (T, 3) scale-normalized object triangle soup
    e1: jax.Array
    e2: jax.Array
    w2o: jax.Array  # f32 (K, 12) scale-normalized world-to-object rows
    box: tuple  # 6x f32 (n_chunks, BOX_CHUNK): lox, loy, loz, hix, hiy, hiz
    base: jax.Array  # i32 (K,) global triangle row base per instance
    #: 4x f32 (n_chunks, BOX_CHUNK) world bounding spheres (cx, cy, cz,
    #: r^2 incl. build slack), or None when the spheres are no tighter
    #: than the boxes (SPHERE_PRETEST / SPHERE_TIGHT)
    sph: tuple | None = None


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class InstancedPack:
    groups: tuple  # tuple[GroupPack, ...]
    n_boxes: int = field(metadata=dict(static=True))  # total instances


def pack_instanced(instances, w2o_rows) -> InstancedPack:
    """Group scene instances by prototype mesh.

    ``instances``: the Scene's MeshInstance list (build order defines the
    global triangle row layout: each instance's triangles contiguous).
    ``w2o_rows``: (K, 3, 4) world-to-object transforms in the same order.
    """
    groups: dict[int, dict] = {}
    base = 0
    for k, inst in enumerate(instances):
        mesh = inst.mesh
        gid = id(mesh)
        if gid not in groups:
            pos = np.asarray(mesh.vertices[:, :3], np.float32)
            idx = np.asarray(mesh.indices)
            groups[gid] = dict(
                v0=pos[idx[:, 0]],
                e1=pos[idx[:, 1]] - pos[idx[:, 0]],
                e2=pos[idx[:, 2]] - pos[idx[:, 0]],
                # object-space vertices referenced by any triangle — the
                # per-instance sphere bound transforms this subset once
                used=pos[np.unique(idx.ravel())],
                w2o=[],
                blo=[],
                bhi=[],
                base=[],
                sc=[],
                sr=[],
            )
        g = groups[gid]
        bb = inst.bbox
        g["w2o"].append(np.asarray(w2o_rows[k], np.float64).reshape(3, 4))
        g["blo"].append(np.asarray(bb.lowerCorner, np.float32))
        g["bhi"].append(np.asarray(bb.upperCorner, np.float32))
        g["base"].append(base)
        base += len(inst.mesh.indices)
        if SPHERE_PRETEST:
            # conservative world bounding sphere over the instance's
            # referenced vertices (same slack recipe as CullTables)
            wv = np.asarray(inst.transform.apply(g["used"]), np.float32)
            c = 0.5 * (wv.min(axis=0) + wv.max(axis=0))
            r = float(np.linalg.norm(wv - c, axis=1).max()) * 1.001 + 1e-5
            g["sc"].append(c)
            g["sr"].append(r)

    packed = []
    for g in groups.values():
        w2o = np.stack(g["w2o"])  # (K, 3, 4) f64
        # median instance scale: |det(w2o_lin)|^(-1/3) is the world size
        # of a unit object length under instance k
        det = np.abs(np.linalg.det(w2o[:, :, :3]))
        scale = float(np.median(np.where(det > 0, det, 1.0) ** (-1.0 / 3.0)))
        blo, bhi = np.stack(g["blo"]), np.stack(g["bhi"])
        sph = None
        if SPHERE_PRETEST:
            # pack spheres only when tighter than the boxes' circumspheres
            half_diag = 0.5 * np.linalg.norm(bhi - blo, axis=1)
            radii = np.asarray(g["sr"], np.float32)
            if float(np.mean(radii)) < SPHERE_TIGHT * float(
                np.mean(half_diag)
            ):
                sph = _pack_spheres(np.stack(g["sc"]), radii)
        packed.append(
            GroupPack(
                v0=jnp.asarray(g["v0"] * scale),
                e1=jnp.asarray(g["e1"] * scale),
                e2=jnp.asarray(g["e2"] * scale),
                w2o=jnp.asarray(
                    (w2o * scale).reshape(len(g["base"]), 12), jnp.float32
                ),
                box=_pack_boxes(blo, bhi),
                base=jnp.asarray(np.asarray(g["base"], np.int32)),
                sph=sph,
            )
        )
    return InstancedPack(groups=tuple(packed), n_boxes=len(instances))


def _pack_boxes(blo: "np.ndarray", bhi: "np.ndarray") -> tuple:
    """(K, 3) lo/hi corners -> six (n_chunks, BOX_CHUNK) SoA component
    arrays; padded slots are inverted far boxes the slab scan rejects."""
    K = blo.shape[0]
    n_chunks = -(-K // BOX_CHUNK)
    pad = n_chunks * BOX_CHUNK - K
    blo = np.pad(blo, ((0, pad), (0, 0)), constant_values=3.0e38)
    bhi = np.pad(bhi, ((0, pad), (0, 0)), constant_values=-3.0e38)
    return tuple(
        jnp.asarray(a[:, i].reshape(n_chunks, BOX_CHUNK))
        for a in (blo, bhi)
        for i in range(3)
    )


def _pack_spheres(centers: "np.ndarray", radii: "np.ndarray") -> tuple:
    """(K, 3) centers + (K,) radii -> four (n_chunks, BOX_CHUNK) SoA
    arrays (cx, cy, cz, r^2); padded slots never matter (the box slab
    test already rejects them)."""
    K = centers.shape[0]
    n_chunks = -(-K // BOX_CHUNK)
    pad = n_chunks * BOX_CHUNK - K
    centers = np.pad(centers, ((0, pad), (0, 0)))
    r2 = np.pad(radii.astype(np.float64) ** 2, (0, pad)).astype(np.float32)
    return tuple(
        jnp.asarray(a.reshape(n_chunks, BOX_CHUNK))
        for a in (centers[:, 0], centers[:, 1], centers[:, 2], r2)
    )


def _next_candidate(
    g: GroupPack, origin, direction, inv_dir, last_tn, last_k, t_best,
    use_sph: bool = True,
):
    """Per lane: the nearest instance box strictly after the ``(last_tn,
    last_k)`` cursor whose entry is closer than the current best hit.
    Returns (tn, k); (inf, -1) when exhausted. When the group packs
    bounding spheres, candidates whose sphere the segment provably misses
    are rejected here (conservative — same math and slack as
    accel._seg_hits_sphere, component-wise over the chunk)."""
    lox, loy, loz, hix, hiy, hiz = g.box  # pre-packed SoA, padded
    n_chunks = lox.shape[0]
    sph = g.sph if use_sph else None

    ox, oy, oz = (origin[:, i : i + 1] for i in range(3))
    ivx, ivy, ivz = (inv_dir[:, i : i + 1] for i in range(3))
    if sph is not None:
        dx, dy, dz = (direction[:, i : i + 1] for i in range(3))
        d2 = dx * dx + dy * dy + dz * dz
        neg_inv_d2 = -1.0 / jnp.maximum(d2, 1e-30)

    def body(carry, chunk):
        best_tn, best_k = carry
        if sph is not None:
            clox, cloy, cloz, chix, chiy, chiz, kbase, scx, scy, scz, sr2 = (
                chunk
            )
        else:
            clox, cloy, cloz, chix, chiy, chiz, kbase = chunk  # (C,) each
        t1x = (clox[None] - ox) * ivx  # (N, C)
        t2x = (chix[None] - ox) * ivx
        t1y = (cloy[None] - oy) * ivy
        t2y = (chiy[None] - oy) * ivy
        t1z = (cloz[None] - oz) * ivz
        t2z = (chiz[None] - oz) * ivz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        ks = kbase + jax.lax.broadcasted_iota(jnp.int32, tn.shape, 1)
        ok = (
            (chix[None] >= clox[None])  # reject padding
            & (tf >= jnp.maximum(tn, 0.0))
            & (tn < t_best[:, None])
            # strictly after the cursor, (tn, k) lexicographic
            & (
                (tn > last_tn[:, None])
                | ((tn == last_tn[:, None]) & (ks > last_k[:, None]))
            )
        )
        if sph is not None:
            # segment-vs-bounding-sphere rejection (conservative; NaNs
            # from degenerate lanes compare False and only clear ok)
            ocx = ox - scx[None]
            ocy = oy - scy[None]
            ocz = oz - scz[None]
            b = ocx * dx + ocy * dy + ocz * dz
            tc = jnp.clip(b * neg_inv_d2, 0.0, t_best[:, None])
            px = ocx + tc * dx
            py = ocy + tc * dy
            pz = ocz + tc * dz
            s = px * px + py * py + pz * pz
            oc2 = ocx * ocx + ocy * ocy + ocz * ocz
            ok &= s <= sr2[None] * 1.003 + oc2 * 1e-5 + 1e-9
        tn = jnp.where(ok, tn, jnp.inf)
        # single lexicographic reduce: separate (min, masked index-min)
        # reductions made XLA rematerialize the slab math for the second
        # pass (same fix as accel.nearest_in_soup)

        def lexi_min(a, b):
            at, ai = a
            bt, bi = b
            take_b = (bt < at) | ((bt == at) & (bi < ai))
            return jnp.where(take_b, bt, at), jnp.where(take_b, bi, ai)

        # selection only — keep the variadic reduce off the AD path
        # (no JVP rule for mixed zero tangents; see accel.nearest_in_soup)
        cand_tn, cand_k = lax.reduce(
            (lax.stop_gradient(tn), ks),
            (jnp.float32(jnp.inf), jnp.int32(0x7FFFFFFF)),
            lexi_min,
            (1,),
        )
        better = (cand_tn < best_tn) | (
            (cand_tn == best_tn) & (cand_k < best_k)
        )
        best_k = jnp.where(better, cand_k, best_k)
        best_tn = jnp.where(better, cand_tn, best_tn)
        return (best_tn, best_k), None

    N = origin.shape[0]
    init = (
        jnp.full((N,), jnp.inf, jnp.float32),
        jnp.full((N,), jnp.int32(0x7FFFFFFF)),
    )
    kbases = jnp.arange(n_chunks, dtype=jnp.int32) * BOX_CHUNK
    xs = (lox, loy, loz, hix, hiy, hiz, kbases)
    if sph is not None:
        xs = xs + sph
    (tn, k), _ = lax.scan(body, init, xs)
    return tn, jnp.where(jnp.isfinite(tn), k, -1)


def _group_query(
    g: GroupPack, origin, direction, t_best, idx_best, chunk, any_hit=False
):
    from ..accel import nearest_in_soup

    # preserve the component's sign when clamping: replacing -1e-13 by
    # +1e-12 would flip the slab interval and cull a true candidate
    inv_dir = 1.0 / jnp.where(
        jnp.abs(direction) > 1e-12,
        direction,
        jnp.where(direction < 0.0, -1e-12, 1e-12),
    )
    neg_inf = jnp.full(origin.shape[:1], -jnp.inf, jnp.float32)

    def clamp(t_best, idx_best):
        # any-hit mode: a lane with a hit is DONE — a -inf bound makes
        # every remaining box entry fail `tn < t_best`, so the lane stops
        # contributing loop iterations (occlusion needs no ordering)
        if any_hit:
            return jnp.where(idx_best >= 0, -jnp.inf, t_best)
        return t_best

    init_sph = SPHERE_INIT_MODE == "on"
    tn0, k0 = _next_candidate(
        g, origin, direction, inv_dir, neg_inf,
        jnp.full_like(idx_best, -1), clamp(t_best, idx_best),
        use_sph=init_sph,
    )

    def make_body(origin, direction, inv_dir):
        """Candidate-iteration body over an (possibly compacted) ray set."""

        def body(carry):
            tn, k, t_best, idx_best = carry
            active = k >= 0
            row = jnp.take(g.w2o, jnp.maximum(k, 0), axis=0)  # (N, 12)
            lin = row.reshape(-1, 3, 4)[:, :, :3]
            off = row.reshape(-1, 3, 4)[:, :, 3]
            o_obj = matvec(lin, origin) + off
            d_obj = matvec(lin, direction)  # NOT normalized
            t_loc, j_loc = nearest_in_soup(
                g.v0, g.e1, g.e2, o_obj, d_obj, t_best, chunk
            )
            better = active & (j_loc >= 0) & (t_loc < t_best)
            tri_base = jnp.take(g.base, jnp.maximum(k, 0))
            idx_best = jnp.where(better, tri_base + j_loc, idx_best)
            t_best = jnp.where(better, t_loc, t_best)
            tn, k = _next_candidate(
                g, origin, direction, inv_dir, tn, k,
                clamp(t_best, idx_best),
            )
            return tn, k, t_best, idx_best

        return body

    body = make_body(origin, direction, inv_dir)

    def run_to_done(body_fn, state):
        def cond_w(carry):
            _, k, _, _ = carry
            return jnp.any(k >= 0)

        return lax.while_loop(cond_w, body_fn, state)

    n_boxes = int(g.base.shape[0])
    ladder = (
        COMPACT_LADDER_LARGE
        if n_boxes >= LADDER_LARGE_MIN_BOXES and COMPACT_LADDER_LARGE
        else COMPACT_LADDER
    )
    if QUERY_PROFILE.get() == "primary" and not any_hit:
        ladder = ()  # pure-primary wavefronts: ~all lanes live (see above)
    if not ladder or n_boxes < COMPACT_MIN_BOXES:
        _, _, t_best, idx_best = run_to_done(
            body, (tn0, k0, t_best, idx_best)
        )
        return t_best, idx_best

    # Live-lane compaction ladder: only 25-40% of
    # lanes have ANY candidate, and the live fraction drops to 2-6%
    # after one iteration — so every stage front-packs the live cursors
    # to its static capacity, runs its iterations there, and scatters
    # back; one lax.cond per stage falls back to full width when the
    # live count exceeds the capacity. Per-lane math is identical on
    # gathered values and the merge is a pure scatter of the same
    # results, so every branch is bit-identical to the uncompacted walk.
    from ..accel import _frontpack_sel

    N = origin.shape[0]
    state = (tn0, k0, t_best, idx_best)

    def run_n(body_fn, state, iters):
        def cond_n(carry):
            i, st = carry
            return (i < iters) & jnp.any(st[1] >= 0)

        def body_n(carry):
            i, st = carry
            return i + 1, body_fn(st)

        _, st = lax.while_loop(cond_n, body_n, (jnp.int32(0), state))
        return st

    hybrid = SPHERE_INIT_MODE == "hybrid" and g.sph is not None
    for si, (cap_frac, iters) in enumerate(ladder):
        live = state[1] >= 0
        pos = jnp.cumsum(live.astype(jnp.int32)) - 1
        cap = max(128, min(N, int(N * cap_frac)))
        fits = pos[-1] + 1 <= cap

        def compacted(
            state, cap=cap, iters=iters, live=live, pos=pos,
            rederive=hybrid and si == 0,
        ):
            sel = _frontpack_sel(live, pos, cap)
            take = lambda a: jnp.take(a, sel, axis=0)
            o_c, d_c, iv_c = take(origin), take(direction), take(inv_dir)
            body_c = make_body(o_c, d_c, iv_c)
            st_c = tuple(take(a) for a in state)
            if rederive:
                # hybrid init: the full-width scan was slab-only; find
                # the first SPHERE-valid candidate here at stage width
                # (cursor reset revisits nothing the walk has processed)
                _, k_c, tb_c, ib_c = st_c
                tn_c, k_c = _next_candidate(
                    g, o_c, d_c, iv_c,
                    jnp.full(o_c.shape[:1], -jnp.inf, jnp.float32),
                    jnp.full_like(k_c, -1), clamp(tb_c, ib_c),
                )
                st_c = (tn_c, k_c, tb_c, ib_c)
            st_c = (
                run_to_done(body_c, st_c)
                if iters < 0
                else run_n(body_c, st_c, iters)
            )
            p = jnp.clip(pos, 0, cap - 1)
            return tuple(
                jnp.where(live, jnp.take(c, p), a)
                for a, c in zip(state, st_c)
            )

        def full(state, iters=iters):
            return (
                run_to_done(body, state)
                if iters < 0
                else run_n(body, state, iters)
            )

        state = lax.cond(fits, compacted, full, state)
        if iters < 0:
            break
    _, _, t_best, idx_best = state
    return t_best, idx_best


def occluded_instanced(
    pack: InstancedPack, origin, direction, t_max, chunk: int
):
    """Any-hit occlusion query: True where something blocks the ray
    before ``t_max``. Cheaper than the nearest query — each lane stops
    at its FIRST hit instead of ordering all candidates."""
    N = origin.shape[0]
    t_best = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    idx_best = jnp.full((N,), -1, jnp.int32)
    for g in pack.groups:
        t_best, idx_best = _group_query(
            g, origin, direction, t_best, idx_best, chunk, any_hit=True
        )
    return idx_best >= 0


def nearest_triangle_instanced(
    pack: InstancedPack, origin, direction, t_max, chunk: int
):
    """Nearest-hit query with the accel backend contract: returns
    (t, tri_idx) with t = inf / idx = -1 on miss; indices are global
    flattened triangle rows (instances contiguous in build order)."""
    N = origin.shape[0]
    t_best = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))
    idx_best = jnp.full((N,), -1, jnp.int32)
    for g in pack.groups:  # static: a handful of prototype meshes
        t_best, idx_best = _group_query(
            g, origin, direction, t_best, idx_best, chunk
        )
    return jnp.where(idx_best < 0, jnp.inf, t_best), idx_best
