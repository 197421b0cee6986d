"""Particle-cascade parameterizations (Raedel fits).

Converts particles (PDG-numbered) into light-source parameterizations:
muon-like particles map to :class:`~theia_jax.light.MuonTrackLightSource`,
shower primaries to :class:`~theia_jax.light.ParticleCascadeLightSource`
(reference: src/theia/cascades.py; fits from L. Raedel's thesis and
arXiv:1206.5530 / arXiv:1210.5140).

NOTE: the reference computes the angular fit parameters as
``a_angular = a_shift * logE + a_shift`` and ``b_angular = b_slope * logE
+ a_shift`` (src/theia/cascades.py:188-192) — an apparent slope/shift mixup;
we implement the fit as documented (``slope * logE + shift``).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import Final

import numpy as np
from scipy.stats import norm

from . import units as u
from .light import MuonTrackLightSource, ParticleCascadeLightSource

__all__ = [
    "CascadeLightYield",
    "CascadeParameters",
    "CascadePrimaryParticle",
    "EMinus", "EPlus", "Gamma", "K0_Long", "Neutron",
    "Particle", "ParticleType", "PiMinus", "PiPlus", "PMinus", "PPlus",
    "X0_ice", "X0_water", "rho_ice", "rho_water",
    "createCascadeParameters",
    "createParamsFromParticle",
    "getCascadeParamsFromParticleType",
]

X0_ice: Final[float] = 39.75 * u.cm
X0_water: Final[float] = 36.08 * u.cm
rho_ice: Final[float] = 0.91
rho_water: Final[float] = 1.039


class ParticleType(IntEnum):
    """PDG Monte Carlo particle numbering."""

    UNKNOWN = 0
    GAMMA = 22
    E_PLUS = -11
    E_MINUS = 11
    MU_PLUS = -13
    MU_MINUS = 13
    TAU_PLUS = -15
    TAU_MINUS = 15
    PI_0 = 111
    PI_PLUS = 211
    PI_MINUS = -211
    K0_LONG = 130
    NEUTRON = 2112
    P_PLUS = 2212
    P_MINUS = -2212


@dataclass
class Particle:
    particleType: ParticleType
    position: tuple
    direction: tuple
    energy: float
    startTime: float = 0.0
    length: float = float("nan")
    speed: float = 1.0 * u.c


@dataclass
class CascadeLightYield:
    effectiveLength: float
    effectiveLengthStd: float = 0.0


@dataclass
class CascadeParameters:
    a_long: float
    b_long: float
    effectiveLength: float
    effectiveLengthStd: float = 0.0
    a_angular: float = 0.5375
    b_angular: float = 3.302


@dataclass(frozen=True)
class CascadePrimaryParticle:
    alpha_long: float
    beta_long: float
    b_long: float
    alpha_length: float = 5.321
    beta_length: float = 1.0
    alpha_length_std: float = 5.727e-2
    beta_length_std: float = 0.5
    a_angular_shift: float = 0.5375
    a_angular_slope: float = 0.0
    b_angular_shift: float = 3.302
    b_angular_slope: float = 0.0


def createCascadeParameters(
    p: CascadePrimaryParticle,
    E: float,
    X0: float = X0_water,
    density: float = rho_water,
) -> CascadeParameters:
    """Cascade parameters for a primary of energy E in a medium with
    radiation length X0 (reference: src/theia/cascades.py:163-208)."""
    logE = max(0.0, np.log10(E))
    a_long = p.alpha_long + p.beta_long * logE
    b_long = X0 / p.b_long
    a_angular = p.a_angular_slope * logE + p.a_angular_shift
    b_angular = p.b_angular_slope * logE + p.b_angular_shift
    rho_scale = 0.91 / density  # eq. (9) in arXiv:1210.5140
    effective_length = p.alpha_length * rho_scale * (E**p.beta_length)
    effective_length_std = p.alpha_length_std * rho_scale * (E**p.beta_length_std)
    return CascadeParameters(
        a_long, b_long, effective_length, effective_length_std,
        a_angular, b_angular,
    )


# fit constants (reference: src/theia/cascades.py:211-345)
EMinus = CascadePrimaryParticle(2.01849, 1.45469, 0.63207, 5.3207078881, 1.00000211, 0.0578170887, 0.5, 0.53734995, 0.0, 3.30382993, 0.0)
EPlus = CascadePrimaryParticle(2.00035, 1.45501, 0.63008, 5.3211320598, 0.99999254, 0.0573419669, 0.5, 0.5367158, 0.0, 3.30484209, 0.0)
Gamma = CascadePrimaryParticle(2.83923, 1.45501, 0.64526, 5.3208540905, 0.99999877, 0.0566586567, 0.5, 0.53841841, 0.0, 3.29619817, 0.0)
PiPlus = CascadePrimaryParticle(1.58357292, 0.96447937, 0.33833116, 3.3355182722, 1.03662217, 1.1920455395, 0.80772057, 1.0299732199972658, -0.08806219920032332, 3.102713004779744, -0.12229465620485062)
PiMinus = CascadePrimaryParticle(1.69176636, 0.93953506, 0.34108075, 3.3584489578, 1.03584394, 1.2250188073, 0.80322520, 1.0412256610000645, -0.09187703681909758, 3.086039699134421, -0.11874011144663844)
K0_Long = CascadePrimaryParticle(1.95948974, 0.80440041, 0.34535151, 3.2600450524, 1.03931457, 1.2141970572, 0.80779629, 1.0591474180300977, -0.09635256670474648, 3.2258115113151793, -0.15816716921465757)
PPlus = CascadePrimaryParticle(1.92249171, 0.77601150, 0.34969748, 2.8737183922, 1.05172118, 0.8804581378, 0.82445572, 1.1574216500437113, -0.11090280215147694, 3.5079727644060794, -0.22892116764330248)
PMinus = CascadePrimaryParticle(1.92249171, 0.77601150, 0.34969748, 3.0333074914, 1.04322206, 1.1323088104, 0.77134060, 1.1574216500437113, -0.11090280215147694, 3.5079727644060794, -0.22892116764330248)
Neutron = CascadePrimaryParticle(1.57739060, 0.93556570, 0.35269455, 2.7843854660, 1.05582906, 0.9322787137, 0.81776503, 1.1292267334081203, -0.10876633838986713, 3.4157386880981093, -0.20638832466150736)

_cascadeParticlesMap = {
    ParticleType.GAMMA: Gamma,
    ParticleType.E_MINUS: EMinus,
    ParticleType.E_PLUS: EPlus,
    ParticleType.PI_0: Gamma,  # decays immediately to two gammas
    ParticleType.PI_PLUS: PiPlus,
    ParticleType.PI_MINUS: PiMinus,
    ParticleType.K0_LONG: K0_Long,
    ParticleType.P_PLUS: PPlus,
    ParticleType.P_MINUS: PMinus,
    ParticleType.NEUTRON: Neutron,
}


def getCascadeParamsFromParticleType(t: ParticleType):
    return _cascadeParticlesMap.get(t)


_trackParticles = {
    ParticleType.MU_PLUS,
    ParticleType.MU_MINUS,
    ParticleType.TAU_PLUS,
    ParticleType.TAU_MINUS,
}


def _createTrackParams(particle, *, name="lightSource", uRand=None, **kwargs):
    if particle.particleType not in _trackParticles:
        return None
    if not particle.length > 0.0:  # also catches NaN
        raise ValueError("particle is muon like, but no track length was specified!")
    x, y, z = particle.position
    dx, dy, dz = particle.direction
    l = particle.length / np.sqrt(dx**2 + dy**2 + dz**2)
    end_pos = (x + l * dx, y + l * dy, z + l * dz)
    end_time = particle.startTime + particle.length / particle.speed
    scale = 1.1880 + 0.0206 * np.log(particle.energy)
    length = particle.length * scale
    std = np.sqrt(particle.length * 0.1 * u.m) * scale
    if uRand is not None:
        length += norm.ppf(uRand).item() * std
        length = max(length, particle.length)
        std = 0.0
    if name:
        name += "__"
    params = {
        f"{name}startPosition": particle.position,
        f"{name}startTime": particle.startTime,
        f"{name}endPosition": end_pos,
        f"{name}endTime": end_time,
        f"{name}muonEnergy": particle.energy,
    }
    return MuonTrackLightSource, params, CascadeLightYield(length, std)


def _createCascadeParams(
    particle, *, name="lightSource", x0=X0_water, density=rho_water, uRand=None, **kwargs
):
    primary = getCascadeParamsFromParticleType(particle.particleType)
    if primary is None:
        return None
    cp = createCascadeParameters(primary, particle.energy, x0, density)
    effective_length = cp.effectiveLength
    effective_std = cp.effectiveLengthStd
    if uRand is not None:
        effective_length += norm.ppf(uRand).item() * effective_std
        effective_length = max(0.0, effective_length)
        effective_std = 0.0
    light_yield = CascadeLightYield(
        effective_length,
        effective_std / effective_length if effective_length else 0.0,
    )
    dx, dy, dz = particle.direction
    l = np.sqrt(dx**2 + dy**2 + dz**2)
    direction = (dx / l, dy / l, dz / l)
    if name:
        name += "__"
    params = {
        f"{name}startPosition": particle.position,
        f"{name}startTime": particle.startTime,
        f"{name}direction": direction,
        f"{name}effectiveLength": effective_length,
        f"{name}a_angular": cp.a_angular,
        f"{name}b_angular": cp.b_angular,
        f"{name}a_long": cp.a_long,
        f"{name}b_long": cp.b_long,
    }
    return ParticleCascadeLightSource, params, light_yield


_converters = [_createTrackParams, _createCascadeParams]


def createParamsFromParticle(
    particle: Particle,
    *,
    x0: float = X0_water,
    density: float = rho_water,
    lightSourceName: str = "lightSource",
    uRand: float | None = None,
):
    """Light source class + parameterization + yield for a particle
    (reference: src/theia/cascades.py:481-530)."""
    kwargs = {
        "x0": x0, "density": density, "name": lightSourceName, "uRand": uRand,
    }
    for convert in _converters:
        if (res := convert(particle, **kwargs)) is not None:
            return res
    raise ValueError(f"Could not create params from particle '{particle}'!")
