"""Probe: Baldwin-Weber precomputed-row selection vs Moeller-Trumbore.

The brute scan only needs *selection* (which triangle wins / does any
triangle occlude) — the winner's differentiable t/b1/b2 are recomputed
rowwise afterwards. MT pays two cross products per (ray, tri) pair
(~54 flops); Baldwin-Weber precomputes per-triangle plane + barycentric
rows (12 floats) so the per-pair test is den/num dots + P + two affine
barycentrics (~39 ops). Rows derive from the same world triangles at
trace time (hoisted as loop-invariant by XLA).

Measures, same session: nearest (MT) vs nearest (BW), anyhit (MT) vs
anyhit (BW), plus selection agreement.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import __graft_entry__ as g
from theia_jax.accel import anyhit_in_soup, nearest_in_soup

CHUNK = 256


def bw_rows(v0, e1, e2):
    """Per-triangle Baldwin-Weber rows: plane (n, d9) + barycentric
    affine rows (U, u0), (V, v0off); degenerate tris map to never-hit."""
    n = jnp.cross(e1, e2)
    nn = jnp.sum(n * n, axis=1, keepdims=True)
    ok = nn > 0.0
    inv_nn = jnp.where(ok, 1.0 / jnp.where(ok, nn, 1.0), 0.0)
    U = jnp.cross(e2, n) * inv_nn
    V = jnp.cross(n, e1) * inv_nn
    d9 = jnp.sum(n * v0, axis=1)
    u0 = -jnp.sum(U * v0, axis=1)
    v0off = -jnp.sum(V * v0, axis=1)
    n = jnp.where(ok, n, 0.0)
    return n, d9, U, u0, V, v0off


def _comp(a, pad, chunk, fill=0.0):
    a = jnp.pad(a, ((0, pad), (0, 0)), constant_values=fill)
    return tuple(a[:, i].reshape(-1, chunk) for i in range(3))


def _comp1(a, pad, chunk, fill=0.0):
    a = jnp.pad(a, ((0, pad),), constant_values=fill)
    return a.reshape(-1, chunk)


def nearest_bw(v0, e1, e2, origin, direction, t_max, chunk):
    from jax import lax

    n_tri = v0.shape[0]
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri
    n, d9, U, u0, V, v0off = bw_rows(v0, e1, e2)
    nx, ny, nz = _comp(n, pad, chunk)
    Ux, Uy, Uz = _comp(U, pad, chunk)
    Vx, Vy, Vz = _comp(V, pad, chunk)
    d9c = _comp1(d9, pad, chunk)
    u0c = _comp1(u0, pad, chunk)
    v0c = _comp1(v0off, pad, chunk)

    N = origin.shape[0]
    ox, oy, oz = (origin[:, i : i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i : i + 1] for i in range(3))

    def body(carry, tris):
        best_t, best_i = carry
        (cnx, cny, cnz, cd9, cUx, cUy, cUz, cu0, cVx, cVy, cVz, cv0, base) = (
            t[None] for t in tris
        )
        den = dx * cnx + dy * cny + dz * cnz
        num = cd9 - (ox * cnx + oy * cny + oz * cnz)
        inv = jnp.where(den != 0.0, 1.0 / jnp.where(den != 0.0, den, 1.0), 0.0)
        t = num * inv
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        b1 = px * cUx + py * cUy + pz * cUz + cu0
        b2 = px * cVx + py * cVy + pz * cVz + cv0
        hit = (
            (inv != 0.0)
            & (b1 >= -1e-6)
            & (b2 >= -1e-6)
            & (b1 + b2 <= 1.0 + 1e-6)
            & (t > 0.0)
        )
        t = jnp.where(hit, t, jnp.inf)
        local = lax.broadcasted_iota(jnp.int32, t.shape, 1)

        def lexi_min(a, b):
            at, ai = a
            bt, bi = b
            take_b = (bt < at) | ((bt == at) & (bi < ai))
            return (jnp.where(take_b, bt, at), jnp.where(take_b, bi, ai))

        tt, idx_c = lax.reduce(
            (lax.stop_gradient(t), local),
            (jnp.float32(jnp.inf), jnp.int32(0x7FFFFFFF)),
            lexi_min,
            (1,),
        )
        better = tt < best_t
        base0 = tris[-1]
        best_i = jnp.where(better, idx_c + base0, best_i)
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
        (nx, ny, nz, d9c, Ux, Uy, Uz, u0c, Vx, Vy, Vz, v0c, bases),
    )
    miss = idx < 0
    return jnp.where(miss, jnp.inf, t), idx


def anyhit_bw(v0, e1, e2, origin, direction, t_max, chunk):
    from jax import lax

    n_tri = v0.shape[0]
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri
    n, d9, U, u0, V, v0off = bw_rows(v0, e1, e2)
    nx, ny, nz = _comp(n, pad, chunk)
    Ux, Uy, Uz = _comp(U, pad, chunk)
    Vx, Vy, Vz = _comp(V, pad, chunk)
    d9c = _comp1(d9, pad, chunk)
    u0c = _comp1(u0, pad, chunk)
    v0c = _comp1(v0off, pad, chunk)

    N = origin.shape[0]
    ox, oy, oz = (origin[:, i : i + 1] for i in range(3))
    dx, dy, dz = (direction[:, i : i + 1] for i in range(3))
    bound = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (N,))[:, None]

    def chunk_occ(k, occ):
        cv = lambda a: lax.dynamic_index_in_dim(a, k, 0, keepdims=False)[None]
        den = dx * cv(nx) + dy * cv(ny) + dz * cv(nz)
        num = cv(d9c) - (ox * cv(nx) + oy * cv(ny) + oz * cv(nz))
        inv = jnp.where(den != 0.0, 1.0 / jnp.where(den != 0.0, den, 1.0), 0.0)
        t = num * inv
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        b1 = px * cv(Ux) + py * cv(Uy) + pz * cv(Uz) + cv(u0c)
        b2 = px * cv(Vx) + py * cv(Vy) + pz * cv(Vz) + cv(v0c)
        hit = (
            (inv != 0.0)
            & (b1 >= -1e-6)
            & (b2 >= -1e-6)
            & (b1 + b2 <= 1.0 + 1e-6)
            & (t > 0.0)
            & (t < bound)
        )
        return occ | jnp.any(hit, axis=-1)

    return lax.fori_loop(0, n_chunks, chunk_occ, jnp.zeros((N,), bool))


def min_time(fn, args, runs=5):
    jax.block_until_ready(fn(*args))
    ts = []
    for r in range(runs):
        a = (args[0] + np.float32(r * 1e-5),) + args[1:]
        jax.block_until_ready(a)
        t0 = time.perf_counter()
        out = fn(*a)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    tracer = g._build_scene_tracer(1024, max_path=2)
    pack = tracer.scene.pack
    v0, e1, e2 = pack.w_v0, pack.w_e1, pack.w_e2
    n_tri = int(v0.shape[0])

    N = 256 * 1024
    rng = np.random.default_rng(7)
    o = rng.uniform(-2.0, 5.0, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    tmax = jnp.float32(100.0)

    mt_n = jax.jit(lambda o, d: nearest_in_soup(v0, e1, e2, o, d, tmax, CHUNK))
    bw_n = jax.jit(lambda o, d: nearest_bw(v0, e1, e2, o, d, tmax, CHUNK))
    mt_a = jax.jit(
        lambda o, d: anyhit_in_soup(v0, e1, e2, o, d, jnp.float32(3.0), CHUNK)
    )
    bw_a = jax.jit(lambda o, d: anyhit_bw(v0, e1, e2, o, d, jnp.float32(3.0), CHUNK))

    t_mt, i_mt = mt_n(oj, dj)
    t_bw, i_bw = bw_n(oj, dj)
    agree = float(np.mean(np.asarray(i_mt) == np.asarray(i_bw)))
    tdiff = np.asarray(
        jnp.where(
            jnp.isfinite(t_mt) & jnp.isfinite(t_bw), jnp.abs(t_mt - t_bw), 0.0
        )
    ).max()
    a_mt = np.asarray(mt_a(oj, dj))
    a_bw = np.asarray(bw_a(oj, dj))
    a_agree = float(np.mean(a_mt == a_bw))

    dt_mt = min_time(mt_n, (oj, dj))
    dt_bw = min_time(bw_n, (oj, dj))
    da_mt = min_time(mt_a, (oj, dj))
    da_bw = min_time(bw_a, (oj, dj))
    rate = lambda dt: N * n_tri / dt / 1e9
    print(f"nearest  MT {dt_mt*1e3:7.2f} ms ({rate(dt_mt):5.1f} Gt/s)  "
          f"BW {dt_bw*1e3:7.2f} ms ({rate(dt_bw):5.1f} Gt/s)  "
          f"speedup {dt_mt/dt_bw:.2f}x  idx agree {agree:.6f}  max|dt| {tdiff:.2e}")
    print(f"anyhit   MT {da_mt*1e3:7.2f} ms ({rate(da_mt):5.1f} Gt/s)  "
          f"BW {da_bw*1e3:7.2f} ms ({rate(da_bw):5.1f} Gt/s)  "
          f"speedup {da_mt/da_bw:.2f}x  occ agree {a_agree:.6f}")


if __name__ == "__main__":
    main()
