"""Brute-scan vs threaded-BVH crossover on a detector-array scene.

Builds the domain's scaling scenario — a grid of sphere modules stamped
from a SceneTemplate — at several sizes, and times
one `intersect_scene` wavefront call per backend in the same session.
Rays are sampled inside the array's bbox with random directions (the
worst, least-coherent case for a BVH).

Usage: python tools/bench_bvh_crossover.py [--rays 65536]
Writes a markdown table to stdout.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def consume(out):
    leaves = jax.tree_util.tree_leaves(out)
    acc = 0.0
    for l in leaves:
        if l.size <= 1024:
            acc += float(np.asarray(l).ravel()[0])
        else:
            jax.block_until_ready(l)
    return acc


def timed(fn, make_args, reps=3):
    consume(fn(*make_args(0)))
    ts = []
    for r in range(1, reps + 1):
        a = make_args(r)
        t0 = time.perf_counter()
        consume(fn(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def build_array_scene(n_side, accel, leaf_size=8):
    """n_side^3 sphere modules on a grid, BK7 shells in water."""
    from theia_jax.material import (
        BK7Model,
        HenyeyGreensteinPhaseFunction,
        Material,
        MaterialStore,
        MediumModel,
        WaterBaseModel,
    )
    from theia_jax.render import SceneTemplate
    from theia_jax.mesh import icosphere
    from theia_jax.scene import MeshStore, Transform

    class WaterModel(WaterBaseModel, HenyeyGreensteinPhaseFunction, MediumModel):
        ModelName = "water"

        def __init__(self):
            WaterBaseModel.__init__(self, 10.0, 0.0, 35.0)
            HenyeyGreensteinPhaseFunction.__init__(self, 0.9)

    water = WaterModel().createMedium(num_lambda=32, num_theta=32)
    glass = BK7Model().createMedium(num_lambda=32, num_theta=4)
    mats = MaterialStore.pack(
        [Material("det_water", glass, water, flags="DB")]
    )
    meshes = MeshStore({"sphere": icosphere()})
    proto = meshes.createInstance(
        "sphere", "det_water", Transform.TRS(scale=0.4), detectorId=0
    )
    template = SceneTemplate([proto])
    spacing = 2.0
    transforms = [
        Transform.TRS(translate=(i * spacing, j * spacing, k * spacing))
        for i in range(n_side)
        for j in range(n_side)
        for k in range(n_side)
    ]
    scene = template.createScene(
        transforms, mats, medium="water", leaf_size=leaf_size, accel=accel
    )
    return scene, spacing * n_side


def bench_backend(scene, extent, n_ray, key):
    from theia_jax.accel import intersect_scene

    pack = scene.pack
    n_tri = int(pack.w_v0.shape[0])

    @jax.jit
    def kernel(o, d, med):
        hit = intersect_scene(pack, med, o, d, jnp.full(n_ray, 1e4))
        return (
            jnp.sum(jnp.where(hit.valid, hit.t, 0.0)),
            jnp.sum(hit.valid.astype(jnp.int32)),
        )

    def args(r):
        k = jax.random.fold_in(key, r)
        o = jax.random.uniform(k, (n_ray, 3), jnp.float32, -1.0, extent)
        d = jax.random.normal(jax.random.fold_in(k, 1), (n_ray, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        return o, d, jnp.zeros(n_ray, jnp.int32)

    t = timed(kernel, args)
    return t, n_tri


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=65536)
    ap.add_argument("--sides", type=int, nargs="*", default=[1, 2, 3, 4, 5])
    ap.add_argument("--leaf", type=int, nargs="*", default=[8])
    args = ap.parse_args()

    key = jax.random.PRNGKey(7)
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}, rays per call: {args.rays}")
    print("| modules | tris | brute ms | instanced ms | bvh ms (leaf) | winner |")
    print("|---|---|---|---|---|---|")
    for n_side in args.sides:
        scene_b, extent = build_array_scene(n_side, "brute")
        tb, n_tri = bench_backend(scene_b, extent, args.rays, key)
        del scene_b
        scene_i, _ = build_array_scene(n_side, "instanced")
        ti, _ = bench_backend(scene_i, extent, args.rays, key)
        del scene_i
        bvh_times = []
        for leaf in args.leaf:
            scene_v, _ = build_array_scene(n_side, "bvh", leaf_size=leaf)
            tv, _ = bench_backend(scene_v, extent, args.rays, key)
            bvh_times.append((leaf, tv))
            del scene_v
        best_leaf, best_tv = min(bvh_times, key=lambda x: x[1])
        times = {"brute": tb, "instanced": ti, f"bvh(leaf={best_leaf})": best_tv}
        winner = min(times, key=times.get)
        bvh_str = ", ".join(f"{tv*1e3:.0f} (l{leaf})" for leaf, tv in bvh_times)
        print(
            f"| {n_side**3} | {n_tri} | {tb*1e3:.0f} | {ti*1e3:.0f} "
            f"| {bvh_str} | {winner} |",
            flush=True,
        )


if __name__ == "__main__":
    main()
