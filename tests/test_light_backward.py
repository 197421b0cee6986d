"""Backward light-sample contribution formulas at reference depth.

Model: reference tests/test_light.py:282-338 (cone backward), :415-453
(spherical backward), :521-599 (Cherenkov backward). Each backward sample
toward a randomly placed observer must carry the analytic contribution —
budget-normalized emission divided by the sampling pdf, converted to the
observer's area measure via |cos|/d^2 (shader/lightsource.common.glsl:40-56).
The Cherenkov case additionally pins the emission point to the track, the
Cherenkov cone angle cos(theta) = 1/n, and the Frank-Tamm factor in both
photon-count and energy units (shader/lightsource.cherenkov.common.glsl,
lightsource.cherenkov.simple.glsl backward branch).
"""

import numpy as np

import theia_jax.units as u
from theia_jax.light import (
    CherenkovLightSource,
    ConeLightSource,
    SphericalLightSource,
)
from theia_jax.random import PhiloxRNG
from theia_jax.testing import WaterTestModel, sampleBackwardLight

N = 4096


def _observers(rng, n=N, scale=20.0):
    return (rng.random((n, 3)) * 2.0 - 1.0) * scale


def _normals(rng, n=N):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_spherical_backward_contrib(rng):
    light_pos = np.array([14.0, -2.0, 3.0], np.float32)
    budget = 1e6
    light = SphericalLightSource(
        position=tuple(light_pos), timeRange=(10.0 * u.ns, 10.0 * u.ns), budget=budget
    )
    obs = _observers(rng)
    nrm = _normals(rng)
    ray = sampleBackwardLight(
        light, obs, N, normal=nrm, rng=PhiloxRNG(key=0xC0FFEE)
    )
    assert np.all(ray.position == light_pos)
    d_vec = obs - light_pos
    d = np.linalg.norm(d_vec, axis=-1)
    assert np.allclose(ray.direction, d_vec / d[:, None], atol=1e-6)
    assert np.allclose(ray.start_time, 10.0 * u.ns, atol=1e-5)
    cos_nrm = np.abs((ray.direction * nrm).sum(-1))
    expected = budget * cos_nrm / (4.0 * np.pi * d**2)
    assert np.allclose(ray.contrib, expected, rtol=1e-5, atol=1e-5)
    # a zero normal marks a volume point: cos factor drops out
    ray_vol = sampleBackwardLight(light, obs, N, rng=PhiloxRNG(key=1))
    assert np.allclose(
        ray_vol.contrib, budget / (4.0 * np.pi * d**2), rtol=1e-5
    )


def test_cone_backward_contrib(rng):
    light_pos = np.array([14.0, -2.0, 3.0], np.float32)
    light_dir = np.array([0.8, 0.36, 0.48], np.float32)
    cos_open = 0.33
    budget = 12.0
    light = ConeLightSource(
        position=tuple(light_pos),
        direction=tuple(light_dir),
        cosOpeningAngle=cos_open,
        timeRange=(10.0 * u.ns, 10.0 * u.ns),
        budget=budget,
        stokes=(1.0, 0.9, 0.1, -0.5),
        polarizationRef=(0.0, 0.48, -0.36),
    )
    obs = _observers(rng)
    nrm = _normals(rng)
    ray = sampleBackwardLight(
        light, obs, N, normal=nrm, rng=PhiloxRNG(key=0xC0FFEE)
    )
    assert np.all(ray.position == light_pos)
    d_vec = obs - light_pos
    d = np.linalg.norm(d_vec, axis=-1)
    assert np.allclose(ray.direction, d_vec / d[:, None], atol=1e-6)
    assert np.allclose(ray.start_time, 10.0 * u.ns, atol=1e-5)
    cos_nrm = np.abs((ray.direction * nrm).sum(-1))
    cos_angle = (ray.direction * light_dir).sum(-1)
    expected = budget * cos_nrm / ((1.0 - cos_open) * 2.0 * np.pi * d**2)
    expected = np.where(cos_angle > cos_open, expected, 0.0)
    assert np.allclose(ray.contrib, expected, rtol=1e-5, atol=1e-6)
    # both gated and un-gated lanes must be exercised
    assert 0 < (expected > 0).sum() < N
    # constant polarization: unit polRef perpendicular to the ray, not
    # rotated around the ray (zero triple product with the input ref)
    assert np.allclose(ray.stokes, (1.0, 0.9, 0.1, -0.5))
    assert np.abs((ray.pol_ref**2).sum(-1) - 1.0).max() < 1e-5
    assert np.abs((ray.pol_ref * ray.direction).sum(-1)).max() < 1e-5
    vol = (np.cross(ray.direction, (0.0, 0.48, -0.36)) * ray.pol_ref).sum(-1)
    assert np.abs(vol).max() < 1e-5


def _cherenkov_case(rng, use_photons: bool):
    track_dir = np.array([0.36, 0.48, 0.8], np.float32)
    dist = 200.0
    start_pos = -track_dir * 0.5 * dist
    end_pos = track_dir * 0.5 * dist
    t0, t1 = -0.5 * dist / u.c, 0.5 * dist / u.c
    model = WaterTestModel()
    medium = model.createMedium()
    light = CherenkovLightSource(
        trackStart=tuple(start_pos),
        trackEnd=tuple(end_pos),
        startTime=t0,
        endTime=t1,
        usePhotonCount=use_photons,
    )
    obs = _observers(rng, scale=40.0)
    nrm = _normals(rng)
    lam = 450.0
    ray = sampleBackwardLight(
        light, obs, N,
        normal=nrm, wavelength=lam, medium=medium, rng=PhiloxRNG(key=7),
    )
    mask = np.asarray(ray.contrib) != 0.0
    assert mask.sum() > 100
    # emission point lies on the track
    dist_a = np.linalg.norm(ray.position - start_pos, axis=-1)
    dist_b = np.linalg.norm(ray.position - end_pos, axis=-1)
    assert np.allclose((dist_a + dist_b)[mask], dist, rtol=1e-4)
    # emission time interpolates the track times
    frac = dist_a / dist
    t_exp = (1.0 - frac) * t0 + frac * t1
    assert np.allclose(ray.start_time[mask], t_exp[mask], atol=5e-4)
    # ray points at the observer under the Cherenkov angle cos = 1/n
    d_vec = obs - ray.position
    d_ray = np.linalg.norm(d_vec, axis=-1)
    assert np.allclose(
        ray.direction[mask], (d_vec / d_ray[:, None])[mask], atol=1e-5
    )
    n = float(np.asarray(model.refractive_index(np.array([lam]))).ravel()[0])
    cos_theta = (ray.direction * track_dir).sum(-1)
    assert np.allclose(cos_theta[mask], 1.0 / n, atol=1e-5)
    # contribution: Frank-Tamm per (m nm radian) x cos+ / perpendicular dist
    sin_theta = np.sqrt(1.0 - 1.0 / n**2)
    if use_photons:
        # alpha*1e3 / lambda_um^2 * sin^2(theta) in photons/(m nm), radial
        ft = 7.2973525693 / (lam * 1e-3) ** 2 * sin_theta**2
    else:
        # 0.5 e c^2 mu_0 / lambda_um^3 * sin^2(theta) in eV/(m nm), radial
        ft = 9.04756408986352 / (lam * 1e-3) ** 3 * sin_theta**2
    cos_nrm = np.maximum((ray.direction * nrm).sum(-1), 0.0)
    expected = ft * cos_nrm / (sin_theta * d_ray)
    assert np.allclose(ray.contrib[mask], expected[mask], rtol=1e-4, atol=1e-7)
    # off-track or back-facing lanes carry zero
    mu = ((ray.position - start_pos) * track_dir).sum(-1)
    on_track = (mu >= 0.0) & (mu <= dist) & (cos_nrm > 0.0)
    assert np.all(ray.contrib[~on_track] == 0.0)
    # linear polarization in the (ray, track) plane
    pol_exp = np.cross(track_dir[None, :], ray.direction)
    pol_exp /= np.maximum(np.linalg.norm(pol_exp, axis=-1, keepdims=True), 1e-12)
    align = np.abs((ray.pol_ref * pol_exp).sum(-1))
    assert np.allclose(align[mask], 1.0, atol=1e-5)
    assert np.allclose(ray.stokes[mask][:, :2], 1.0)


def test_cherenkov_backward_photons(rng):
    _cherenkov_case(rng, True)


def test_cherenkov_backward_energy(rng):
    _cherenkov_case(rng, False)


def _track_candidates(track, obs, nrm, n_refr, ft):
    """Numpy oracle: per-segment Cherenkov backward candidates."""
    v0, v1 = track[:-1], track[1:]
    seg_vec = v1[:, :3] - v0[:, :3]
    seg_len = np.linalg.norm(seg_vec, axis=-1)
    seg_dir = seg_vec / seg_len[:, None]
    cos_t, sin_t = 1.0 / n_refr, np.sqrt(1.0 - 1.0 / n_refr**2)
    rel = obs[:, None, :] - v0[None, :, :3]
    mu = (rel * seg_dir[None]).sum(-1)
    c_point = v0[None, :, :3] + mu[..., None] * seg_dir[None]
    d_perp = np.linalg.norm(obs[:, None, :] - c_point, axis=-1)
    mu = mu - cos_t / sin_t * d_perp
    pos = v0[None, :, :3] + mu[..., None] * seg_dir[None]
    ray_dir = obs[:, None, :] - pos
    ray_dir /= np.linalg.norm(ray_dir, axis=-1, keepdims=True)
    cos_nrm = np.maximum((ray_dir * nrm[:, None, :]).sum(-1), 0.0)
    on = (mu >= 0.0) & (mu <= seg_len[None])
    contrib = ft * cos_nrm / d_perp * on
    frac = mu / seg_len[None]
    time = v0[None, :, 3] * (1 - frac) + v1[None, :, 3] * frac
    return contrib, pos, time


def test_cherenkov_track_backward(rng):
    """Backward mode for the track source — a capability the reference
    leaves unimplemented (lightsource.cherenkov.track.glsl:78-79 TODO).
    Total contrib must equal the sum of the per-segment analytic
    candidates (numpy oracle), the returned candidate must be one of them,
    and selection frequencies must follow the contributions."""
    from theia_jax.light import CherenkovTrackLightSource, ParticleTrack

    # bent track: two segments at an angle, beta = 1 timing
    verts = np.array(
        [
            [-60.0, 0.0, 0.0, -60.0 / u.c],
            [0.0, 0.0, 0.0, 0.0],
            [30.0, 40.0, 0.0, 50.0 / u.c],
        ],
        np.float32,
    )
    track = ParticleTrack(verts)
    src = CherenkovTrackLightSource(track, usePhotonCount=True)
    model = WaterTestModel()
    medium = model.createMedium()
    lam = 450.0
    n_refr = float(np.asarray(model.refractive_index(np.array([lam]))).ravel()[0])

    obs = _observers(rng, scale=30.0).astype(np.float32)
    nrm = _normals(rng).astype(np.float32)
    ray = sampleBackwardLight(
        src, obs, N, normal=nrm, wavelength=lam, medium=medium,
        rng=PhiloxRNG(key=0xFACE),
    )
    sin_t = np.sqrt(1.0 - 1.0 / n_refr**2)
    ft = 7.2973525693 / (lam * 1e-3) ** 2 * sin_t**2
    contrib, pos, time = _track_candidates(verts, obs, nrm, n_refr, ft)

    total = contrib.sum(-1)
    assert np.allclose(ray.contrib, total, rtol=2e-4, atol=1e-7)
    live = total > 0
    assert live.sum() > N // 4
    # the returned sample is one of the analytic candidates (same lane)
    d_pos = np.linalg.norm(pos - np.asarray(ray.position)[:, None, :], axis=-1)
    match = np.argmin(d_pos, axis=-1)
    lane = np.arange(N)
    assert d_pos[lane, match][live].max() < 1e-3
    assert np.allclose(
        np.asarray(ray.start_time)[live], time[lane, match][live], atol=1e-3
    )
    # candidates with zero contribution are never selected
    assert (contrib[lane, match][live] > 0).all()
    # selection frequency follows the contribution split (both-segment lanes)
    both = (contrib > 0).all(-1)
    if both.sum() > 200:
        p0 = contrib[both, 0] / total[both]
        took0 = match[both] == 0
        # aggregated Bernoulli with per-lane p: 5 sigma
        mean, var = p0.sum(), (p0 * (1 - p0)).sum()
        assert abs(took0.sum() - mean) < 5 * np.sqrt(var) + 1.0
    # straight-line degenerate track must reproduce the simple source
    from theia_jax.light import CherenkovLightSource

    straight = np.array(
        [
            [-100.0, 0.0, 0.0, -100.0 / u.c],
            [0.0, 0.0, 0.0, 0.0],
            [100.0, 0.0, 0.0, 100.0 / u.c],
        ],
        np.float32,
    )
    src2 = CherenkovTrackLightSource(ParticleTrack(straight), usePhotonCount=True)
    simple = CherenkovLightSource(
        trackStart=(-100.0, 0.0, 0.0),
        trackEnd=(100.0, 0.0, 0.0),
        startTime=-100.0 / u.c,
        endTime=100.0 / u.c,
        usePhotonCount=True,
    )
    r_t = sampleBackwardLight(
        src2, obs, N, normal=nrm, wavelength=lam, medium=medium,
        rng=PhiloxRNG(key=5),
    )
    r_s = sampleBackwardLight(
        simple, obs, N, normal=nrm, wavelength=lam, medium=medium,
        rng=PhiloxRNG(key=5),
    )
    assert np.allclose(r_t.contrib, r_s.contrib, rtol=2e-4, atol=1e-7)
    ok = np.asarray(r_s.contrib) > 0
    assert np.allclose(
        np.asarray(r_t.position)[ok], np.asarray(r_s.position)[ok], atol=1e-3
    )
    assert np.allclose(
        np.asarray(r_t.start_time)[ok], np.asarray(r_s.start_time)[ok], atol=1e-3
    )
