"""Stackless threaded-BVH traversal on the wavefront.

Per lane the traversal state is a single node index: on AABB hit continue
at node+1 (interior) or test the leaf's triangles and jump to the miss
link; on miss jump to the miss link; -1 terminates. All lanes advance in
lock-step inside a ``lax.while_loop`` — node data is fetched with gathers.

Gather-count discipline (the whole path is gather-bound): each
node visit costs exactly ONE row gather — nodes are packed as (M, 8)
f32 rows ``[bmin xyz, bmax xyz, miss, start*32+count]`` with the two
link fields bit-cast from int32 — and each leaf triangle costs one
(T, 9) row gather ``[v0, e1, e2]`` (a SoA layout would pay 5 gathers
per node and 3 per triangle).

This replaces the reference's hardware ray-query traversal
(scene.intersect.glsl rayQueryEXT) with a software BVH suited to SIMD
wavefronts. The default accel path remains the brute-force scan; the
BVH path is the scaling story for large non-instanced scenes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
from jax import lax

from .math3d import moeller_trumbore_rowwise

__all__ = ["PackedBVH", "nearest_triangle_bvh", "pack_bvh"]

#: bits reserved for the leaf triangle count in the packed start/count
#: field; leaf_size must stay below this and start below 2**26 (~67M
#: triangles), both far beyond current scenes.
_COUNT_BITS = 5


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PackedBVH:
    """Device-resident threaded BVH; ``leaf_size`` is static metadata so
    the traversal's leaf unroll stays a Python constant under jit.

    ``nodes``: (M, 8) f32 rows ``[bmin xyz, bmax xyz, bits(miss),
    bits(start*2^5 + count)]`` — start = -1 marks interior nodes (the
    packed field keeps the sign). ``tri``: (T, 9) f32 rows
    ``[v0, e1, e2]`` in leaf order; ``order`` maps back to original ids.
    """

    nodes: jax.Array
    tri: jax.Array
    order: jax.Array
    leaf_size: int = field(metadata=dict(static=True))


def pack_bvh(bvh, w_v0, w_e1, w_e2, leaf_size: int) -> PackedBVH:
    """Device arrays for traversal: node row table + triangles in leaf
    order (one gather per node / per triangle, see module docstring)."""
    import numpy as np

    assert leaf_size < (1 << _COUNT_BITS), leaf_size
    order = bvh.order
    m = len(bvh.miss)
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = np.asarray(bvh.bmin, np.float32)
    nodes[:, 3:6] = np.asarray(bvh.bmax, np.float32)
    start = np.asarray(bvh.start, np.int64)
    count = np.asarray(bvh.count, np.int64)
    assert start.max(initial=0) < (1 << 26), "BVH too large for packed links"
    # interior nodes keep start=-1 -> packed field stays negative
    packed = np.where(start >= 0, start << _COUNT_BITS | count, -1)
    nodes[:, 6] = np.asarray(bvh.miss, np.int32).view(np.float32)
    nodes[:, 7] = packed.astype(np.int32).view(np.float32)

    tri = np.concatenate(
        [
            np.asarray(w_v0, np.float32)[order],
            np.asarray(w_e1, np.float32)[order],
            np.asarray(w_e2, np.float32)[order],
        ],
        axis=1,
    )
    return PackedBVH(
        nodes=jnp.asarray(nodes),
        tri=jnp.asarray(tri),
        order=jnp.asarray(order),
        leaf_size=leaf_size,
    )


def nearest_triangle_bvh(packed, origin, direction, t_max):
    """Nearest-hit query with the same contract as accel._nearest_triangle:
    returns (t, tri_idx), idx = -1 on miss (original triangle ids)."""
    n = origin.shape[0]
    leaf_size = packed.leaf_size
    # sign-preserving clamp (see ops/instanced.py): a flipped sign would
    # invert the slab interval and cull a true node
    inv_dir = 1.0 / jnp.where(
        jnp.abs(direction) > 1e-12,
        direction,
        jnp.where(direction < 0.0, -1e-12, 1e-12),
    )

    t_best = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    idx_best = jnp.full((n,), -1, jnp.int32)
    node = jnp.zeros((n,), jnp.int32)

    tri_tab = packed.tri

    def tri_test(base, k, origin, direction, t_best, idx_best, active):
        tri = base + k
        row = jnp.take(tri_tab, tri, axis=0, mode="clip")  # (N, 9)
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        b1, b2, t, inv = moeller_trumbore_rowwise(
            origin, direction, v0, e1, e2
        )
        # shared-edge tolerance matching accel._nearest_triangle
        hit = (
            active
            & (inv != 0.0)
            & (b1 >= -1e-6)
            & (b2 >= -1e-6)
            & (b1 + b2 <= 1.0 + 1e-6)
            & (t > 0.0)
            & (t < t_best)
        )
        idx_best = jnp.where(hit, tri, idx_best)
        t_best = jnp.where(hit, t, t_best)
        return t_best, idx_best

    def cond(carry):
        node, _, _ = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, t_best, idx_best = carry
        live = node >= 0
        safe = jnp.maximum(node, 0)
        row = jnp.take(packed.nodes, safe, axis=0)  # (N, 8) — ONE gather
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        miss = lax.bitcast_convert_type(row[:, 6], jnp.int32)
        sc = lax.bitcast_convert_type(row[:, 7], jnp.int32)
        is_leaf = sc >= 0
        start = sc >> _COUNT_BITS
        count = sc & ((1 << _COUNT_BITS) - 1)

        # slab test
        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        tn = jnp.minimum(t0, t1).max(axis=-1)
        tf = jnp.maximum(t0, t1).min(axis=-1)
        hit = live & (tf >= jnp.maximum(tn, 0.0)) & (tn <= t_best)

        # leaf: test up to leaf_size triangles (static unroll)
        leaf_active = hit & is_leaf
        for k in range(leaf_size):
            t_best, idx_best = tri_test(
                start, k, origin, direction, t_best, idx_best,
                leaf_active & (k < count),
            )

        next_node = jnp.where(hit & ~is_leaf, node + 1, miss)
        next_node = jnp.where(live, next_node, node)
        return next_node, t_best, idx_best

    node, t_best, idx_best = lax.while_loop(
        cond, body, (node, t_best, idx_best)
    )

    # map the winner back to original triangle ids; barycentrics are NOT
    # returned — callers (accel.intersect_scene) reconstruct them for the
    # single winner from the tri_data row they gather anyway, so computing
    # them here would cost three extra per-lane gathers for nothing
    found = idx_best >= 0
    safe = jnp.maximum(idx_best, 0)
    orig = jnp.where(found, jnp.take(packed.order, safe), -1)
    return jnp.where(found, t_best, jnp.inf), orig


def occluded_bvh(packed, origin, direction, t_max):
    """Any-hit query: True where some triangle blocks the ray strictly
    before ``t_max``. A lane TERMINATES at its first accepted hit (node
    := -1) instead of tightening t and walking on — visibility queries
    need no ordering, so the traversal visits only the prefix of the
    threaded order up to the first blocker (the reference's
    terminateOnFirstHit ray flag, scene.intersect.glsl:104-124)."""
    n = origin.shape[0]
    leaf_size = packed.leaf_size
    inv_dir = 1.0 / jnp.where(
        jnp.abs(direction) > 1e-12,
        direction,
        jnp.where(direction < 0.0, -1e-12, 1e-12),
    )
    bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    node = jnp.zeros((n,), jnp.int32)
    occ = jnp.zeros((n,), bool)
    tri_tab = packed.tri

    def cond(carry):
        node, _ = carry
        return jnp.any(node >= 0)

    def body(carry):
        node, occ = carry
        live = node >= 0
        safe = jnp.maximum(node, 0)
        row = jnp.take(packed.nodes, safe, axis=0)  # ONE gather per node
        bmin, bmax = row[:, 0:3], row[:, 3:6]
        miss = lax.bitcast_convert_type(row[:, 6], jnp.int32)
        sc = lax.bitcast_convert_type(row[:, 7], jnp.int32)
        is_leaf = sc >= 0
        start = sc >> _COUNT_BITS
        count = sc & ((1 << _COUNT_BITS) - 1)

        t0 = (bmin - origin) * inv_dir
        t1 = (bmax - origin) * inv_dir
        tn = jnp.minimum(t0, t1).max(axis=-1)
        tf = jnp.maximum(t0, t1).min(axis=-1)
        hit = live & (tf >= jnp.maximum(tn, 0.0)) & (tn <= bound)

        leaf_active = hit & is_leaf
        found = jnp.zeros((n,), bool)
        for k in range(leaf_size):
            tri = start + k
            trow = jnp.take(tri_tab, tri, axis=0, mode="clip")
            v0, e1, e2 = trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
            b1, b2, t, inv = moeller_trumbore_rowwise(
                origin, direction, v0, e1, e2
            )
            found |= (
                leaf_active
                & (k < count)
                & (inv != 0.0)
                & (b1 >= -1e-6)
                & (b2 >= -1e-6)
                & (b1 + b2 <= 1.0 + 1e-6)
                & (t > 0.0)
                & (t < bound)
            )
        occ = occ | found
        next_node = jnp.where(hit & ~is_leaf, node + 1, miss)
        next_node = jnp.where(found, -1, next_node)  # first hit terminates
        next_node = jnp.where(live, next_node, node)
        return next_node, occ

    _, occ = lax.while_loop(cond, body, (node, occ))
    return occ
