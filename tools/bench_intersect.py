"""Parity + performance of the plain XLA brute scan (accel.nearest_in_soup).

Triangles: the bench scene's 3840-triangle soup (three icospheres).
Parity: a float64 numpy Moeller-Trumbore on 2048 rays. Performance (GPU
only): ray-triangle tests per second at 524,288 rays, inputs varied per
rep, each call ended by block_until_ready.

Usage: python tools/bench_intersect.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as entry  # noqa: E402
from theia_jax.accel import nearest_in_soup  # noqa: E402


def brute(v0, e1, e2, o, d, tmax):
    """Reference MT in plain vectorized numpy f64 (small sizes only)."""
    p = np.cross(d[:, None], e2[None])
    det = np.einsum("nti,ti->nt", p, e1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = o[:, None] - v0[None]
    b1 = np.einsum("nti,nti->nt", tv, p) * inv
    q = np.cross(tv, e1[None])
    b2 = np.einsum("nti,ni->nt", q, d) * inv
    t = np.einsum("nti,ti->nt", q, e2) * inv
    hit = (inv != 0) & (b1 >= -1e-6) & (b2 >= -1e-6) & (b1 + b2 <= 1 + 1e-6) & (t > 0)
    t = np.where(hit, t, np.inf)
    ti = t.min(1)
    ii = np.where(np.isfinite(ti), t.argmin(1), -1)
    ti = np.where(ti < tmax, ti, np.inf)
    ii = np.where(np.isfinite(ti), ii, -1)
    return ti, ii


def rays(rng, n):
    o = rng.uniform(-2, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def main():
    rng = np.random.default_rng(7)
    pack = entry._build_scene_tracer(1).scene.pack
    v0, e1, e2 = (np.asarray(a) for a in (pack.w_v0, pack.w_e1, pack.w_e2))
    n_tri, tmax = len(v0), 100.0
    print(f"{n_tri} triangles")

    @jax.jit
    def scan(o, d):
        return nearest_in_soup(pack.w_v0, pack.w_e1, pack.w_e2, o, d, tmax, 256)

    o, d = rays(rng, 2048)
    t_ref, i_ref = brute(v0, e1, e2, o.astype(np.float64), d.astype(np.float64), tmax)
    t_s, i_s = (np.asarray(x) for x in scan(jnp.asarray(o), jnp.asarray(d)))
    both = (i_ref >= 0) & (i_s >= 0)
    rel = np.abs(t_s[both] - t_ref[both]) / np.maximum(t_ref[both], 1e-6)
    print(
        f"parity: hit-agree {((i_ref >= 0) == (i_s >= 0)).mean()*100:.3f}%  "
        f"idx-agree {(i_ref[both] == i_s[both]).mean()*100:.3f}%  "
        f"max rel t err {rel.max():.2e}"
    )

    if jax.devices()[0].platform != "gpu":
        print("no GPU; skipping perf")
        return
    n_big = 524_288
    oj, dj = (jnp.asarray(x) for x in rays(rng, n_big))
    run = jax.jit(lambda o, d: jnp.where(jnp.isfinite(s := scan(o, d)[0]), s, 0.0).sum())
    jax.block_until_ready(run(oj, dj))
    ts = []
    for rep in range(5):
        o2 = oj + rep * 1e-4
        jax.block_until_ready(o2)
        t0 = time.perf_counter()
        jax.block_until_ready(run(o2, dj))
        ts.append(time.perf_counter() - t0)
    dt = float(np.median(ts))
    print(f"brute scan: {dt*1e3:.3f} ms  {n_big * n_tri / dt:.6g} tests/s ({jax.devices()[0].device_kind})")


if __name__ == "__main__":
    main()
