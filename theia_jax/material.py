"""Media, materials and medium models.

A :class:`Medium` describes the optical properties of a medium as lookup
tables over a wavelength range — refractive index, group velocity,
absorption/scattering coefficients, phase function (log + inverse CDF for
sampling) and the four independent Mueller phase-matrix elements
(reference: src/theia/material.py:61-438, src/theia/shader/material.glsl:11-97).

Array design: media are parameter *pytrees* — there are no device
pointers. A tracer operating in a single medium closes over the Medium
pytree directly (differentiable w.r.t. every table). Scenes with multiple
materials pack all media into a :class:`MediumStore` of stacked, padded
tables addressed by integer handles (the analogue of the reference's
``MaterialStore`` device-address packing, src/theia/material.py:884-1117).
"""

from __future__ import annotations

import functools
import importlib.resources
import json
import re
import warnings
from dataclasses import dataclass, field
from enum import IntFlag
from io import TextIOBase
from pathlib import Path
from typing import Final
from zipfile import ZipFile

import jax
import jax.numpy as jnp
import numpy as np
from scipy.interpolate import CubicSpline

from . import units as u
from .lookup import lookup

__all__ = [
    "speed_of_light",
    "Medium",
    "MediumConstants",
    "medium_constants",
    "MaterialFlags",
    "parseMaterialFlags",
    "Material",
    "MediumStore",
    "MaterialStore",
    "packed_medium_constants",
    "lookup_packed",
    "loadMaterials",
    "saveMaterials",
    "serializeMedium",
    "MediumModel",
    "SellmeierEquation",
    "BK7Model",
    "HenyeyGreensteinPhaseFunction",
    "FournierForandPhaseFunction",
    "DispersionFreeMedium",
    "WaterBaseModel",
    "KokhanovskyOceanWaterPhaseMatrix",
]

speed_of_light: Final[float] = 1.0 * u.c
"""speed of light in internal units [m/ns]"""

_TABLE_PROPS = (
    "refractive_index",
    "group_velocity",
    "absorption_coef",
    "scattering_coef",
    "log_phase_function",
    "phase_sampling",
    "phase_m12",
    "phase_m22",
    "phase_m33",
    "phase_m34",
)


def _as_table(a) -> jax.Array | None:
    if a is None:
        return None
    return jnp.asarray(a, jnp.float32)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Medium:
    """Optical properties of a medium as tables over [lambda_min, lambda_max].

    All table fields are optional; ``None`` selects the physical default
    (n=1, vg=c, mu_a=mu_s=0, isotropic phase function). The pytree leaves
    are the tables plus the wavelength range, so gradients w.r.t. medium
    properties flow through any simulation consuming it.
    """

    lambda_min: jax.Array
    lambda_max: jax.Array
    refractive_index: jax.Array | None = None
    group_velocity: jax.Array | None = None
    absorption_coef: jax.Array | None = None
    scattering_coef: jax.Array | None = None
    log_phase_function: jax.Array | None = None
    phase_sampling: jax.Array | None = None
    phase_m12: jax.Array | None = None
    phase_m22: jax.Array | None = None
    phase_m33: jax.Array | None = None
    phase_m34: jax.Array | None = None
    name: str = field(default="unnamed", metadata=dict(static=True))

    # NOTE: no __post_init__ conversion — jit unflattening rebuilds the
    # dataclass with tracer leaves, so leaves must pass through untouched.
    # numpy arrays / python floats are valid pytree leaves for jit.

    # -- serialization (npz format compatible with the reference,
    #    src/theia/material.py:389-438) --

    def save(self, file) -> None:
        if isinstance(file, TextIOBase):
            raise ValueError("file must be opened in binary mode!")
        arrays = {
            p: np.asarray(getattr(self, p))
            for p in _TABLE_PROPS
            if getattr(self, p) is not None
        }
        arrays["lambda_range"] = np.array(
            [float(self.lambda_min), float(self.lambda_max)]
        )
        np.savez(file, **arrays)

    @staticmethod
    def load(file, *, name: str = "unnamed") -> "Medium":
        if isinstance(file, TextIOBase):
            raise ValueError("file must be opened in binary mode!")
        data = np.load(file)
        lam = data.get("lambda_range")
        if lam is None or lam.shape != (2,):
            raise ValueError("File does not contain valid lambda range!")
        tables = {p: data.get(p) for p in _TABLE_PROPS if p in data}
        return Medium(lam[0], lam[1], name=name, **tables)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MediumConstants:
    """Wavelength-resolved medium properties used along a ray
    (reference: src/theia/shader/material.glsl:46-74)."""

    n: jax.Array
    vg: jax.Array
    mu_s: jax.Array
    mu_e: jax.Array


def normalize_lambda(medium: Medium, wavelength) -> jax.Array:
    return jnp.clip(
        (wavelength - medium.lambda_min) / (medium.lambda_max - medium.lambda_min),
        0.0,
        1.0,
    )


def medium_constants(medium: Medium | None, wavelength) -> MediumConstants:
    """Look up the medium constants at the given wavelength.

    ``None`` means vacuum (the reference's null-pointer medium)."""
    wavelength = jnp.asarray(wavelength, jnp.float32)
    if medium is None:
        one = jnp.ones_like(wavelength)
        zero = jnp.zeros_like(wavelength)
        return MediumConstants(
            n=one, vg=one * speed_of_light, mu_s=zero, mu_e=zero
        )
    t = normalize_lambda(medium, wavelength)
    mu_a = lookup(medium.absorption_coef, t, 0.0)
    mu_s = lookup(medium.scattering_coef, t, 0.0)
    return MediumConstants(
        n=lookup(medium.refractive_index, t, 1.0),
        vg=lookup(medium.group_velocity, t, speed_of_light),
        mu_s=mu_s,
        mu_e=mu_a + mu_s,
    )


#################################### MATERIAL ##################################


class MaterialFlags(IntFlag):
    """Bit flags specifying ray behavior at a material boundary
    (reference: src/theia/material.py:441-511, material.glsl:79-86)."""

    BLACK_BODY = 0x01
    DETECTOR = 0x02
    LIGHT_SOURCE = 0x04
    NO_REFLECT_FWD = 0x08
    NO_REFLECT_BWD = 0x10
    NO_REFLECT = 0x18
    NO_TRANSMIT_FWD = 0x20
    NO_TRANSMIT_BWD = 0x40
    NO_TRANSMIT = 0x60
    VOLUME_BORDER = 0x80


_materialFlagsMap = {
    "B": MaterialFlags.BLACK_BODY,
    "D": MaterialFlags.DETECTOR,
    "L": MaterialFlags.LIGHT_SOURCE,
    "R": MaterialFlags.NO_REFLECT,
    "Rbf": MaterialFlags.NO_REFLECT,
    "Rfb": MaterialFlags.NO_REFLECT,
    "Rb": MaterialFlags.NO_REFLECT_BWD,
    "Rf": MaterialFlags.NO_REFLECT_FWD,
    "T": MaterialFlags.NO_TRANSMIT,
    "Tbf": MaterialFlags.NO_TRANSMIT,
    "Tfb": MaterialFlags.NO_TRANSMIT,
    "Tb": MaterialFlags.NO_TRANSMIT_BWD,
    "Tf": MaterialFlags.NO_TRANSMIT_FWD,
    "V": MaterialFlags.VOLUME_BORDER,
}


def parseMaterialFlags(flags: str) -> MaterialFlags:
    """Parse a material-flag string; see the reference grammar
    (src/theia/material.py:532-557): starts from NO_REFLECT|NO_TRANSMIT and
    each token XORs its flag, so "T" *enables* transmission etc."""
    tokens = re.findall(r"[A-Z][a-z]*", flags)
    result = MaterialFlags.NO_REFLECT | MaterialFlags.NO_TRANSMIT
    for token in tokens:
        if token in _materialFlagsMap:
            result ^= _materialFlagsMap[token]
        else:
            raise ValueError(f"Unknown material flag '{token}'")
    return result


class Material:
    """Assigns media to the two sides of a geometry plus per-direction flags.

    ``inside``/``outside`` may be a Medium, a medium name (resolved by the
    store) or None (vacuum)."""

    def __init__(
        self,
        name: str,
        inside: Medium | str | None,
        outside: Medium | str | None,
        *,
        flags=MaterialFlags(0),
    ) -> None:
        self.name = name
        self.inside = inside
        self.outside = outside
        if isinstance(flags, tuple):
            self.flagsInward = self._parse(flags[0])
            self.flagsOutward = self._parse(flags[1])
        else:
            self.flagsInward = self._parse(flags)
            self.flagsOutward = self._parse(flags)

    @staticmethod
    def _parse(f) -> MaterialFlags:
        return parseMaterialFlags(f) if isinstance(f, str) else MaterialFlags(f)


################################# MEDIUM STORE #################################

#: handle of the vacuum pseudo-medium inside every store
VACUUM_HANDLE: Final[int] = 0


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MediumStore:
    """All media packed into stacked, padded tables addressed by handle.

    Row 0 is always vacuum (all tables null). ``sizes[kind][m] == 0`` marks
    a null table, reproducing the reference's null-pointer defaults.
    """

    lambda_min: jax.Array  # f32[M]
    lambda_max: jax.Array  # f32[M]
    tables: dict[str, jax.Array]  # kind -> f32[M, Lmax]
    sizes: dict[str, jax.Array]  # kind -> i32[M]
    names: tuple[str, ...] = field(metadata=dict(static=True))
    #: every medium's four constants tables (mu_a, mu_s, n, vg) share one
    #: length (or are null) -> packed_medium_constants may fuse them into
    #: a single 4-wide row lookup (2 row gathers instead of 12 scalar
    #: gathers per lane). Static so the
    #: traced program can branch on it.
    const4_ok: bool = field(default=False, metadata=dict(static=True))

    @staticmethod
    def pack(media: list[Medium]) -> "MediumStore":
        names = ["vacuum"] + [m.name for m in media]
        if len(set(names)) != len(names):
            raise ValueError("duplicate medium names")
        M = len(media) + 1
        lam_min = np.zeros(M, np.float32)
        lam_max = np.ones(M, np.float32)
        tables: dict[str, np.ndarray] = {}
        sizes: dict[str, np.ndarray] = {}
        for kind in _TABLE_PROPS:
            lens = [
                0 if getattr(m, kind) is None else int(getattr(m, kind).shape[0])
                for m in media
            ]
            lmax = max([2, *lens])
            vals = np.zeros((M, lmax), np.float32)
            sz = np.zeros(M, np.int32)
            for i, m in enumerate(media):
                t = getattr(m, kind)
                if t is not None:
                    n = t.shape[0]
                    vals[i + 1, :n] = np.asarray(t)
                    sz[i + 1] = n
            tables[kind] = vals
            sizes[kind] = sz
        for i, m in enumerate(media):
            lam_min[i + 1] = float(m.lambda_min)
            lam_max[i + 1] = float(m.lambda_max)
        const4_ok = all(
            len({int(sizes[k][i]) for k in _CONST4_KINDS} - {0}) <= 1
            for i in range(M)
        )
        return MediumStore(
            lambda_min=jnp.asarray(lam_min),
            lambda_max=jnp.asarray(lam_max),
            tables={k: jnp.asarray(v) for k, v in tables.items()},
            sizes={k: jnp.asarray(v) for k, v in sizes.items()},
            names=tuple(names),
            const4_ok=const4_ok,
        )

    def handle(self, name: str | None) -> int:
        """Integer handle of the medium with the given name (None = vacuum)."""
        if name is None:
            return VACUUM_HANDLE
        return self.names.index(name)

    def medium(self, name: str) -> Medium:
        """Reconstruct a standalone Medium pytree from the store."""
        i = self.handle(name)
        if i == VACUUM_HANDLE:
            raise ValueError("cannot extract vacuum")
        kwargs = {}
        for kind in _TABLE_PROPS:
            n = int(self.sizes[kind][i])
            kwargs[kind] = self.tables[kind][i, :n] if n > 0 else None
        return Medium(
            self.lambda_min[i], self.lambda_max[i], name=name, **kwargs
        )


def lookup_packed(
    values: jax.Array, sizes: jax.Array, handle: jax.Array, t, null_value=0.0
) -> jax.Array:
    """Per-lane linear interpolation in packed tables.

    values: f32[M, Lmax]; sizes: i32[M]; handle: i32[...]; t in [0,1].
    Lanes whose table is null (size 0) return ``null_value``.

    The interpolation gathers ONE (value, slope) pair row per lane from a
    table derived in-trace (loop-invariant — hoisted by XLA; grads and
    runtime table patches flow through), instead of two scalar gathers at
    lo/hi (lookups are the largest cost outside intersection). ``v + l*dv`` differs from
    the two-gather lerp by at most one ulp (slope pre-rounded once)."""
    n = jnp.take(sizes, handle)
    tt = jnp.clip(jnp.asarray(t, jnp.float32), 0.0, 1.0) * jnp.maximum(
        n - 1, 1
    ).astype(jnp.float32)
    lo = jnp.floor(tt).astype(jnp.int32)
    l = tt - jnp.floor(tt)
    lmax = values.shape[-1]
    # pair rows [v_j, v_{j+1} - v_j]; the last column's slope is 0, which
    # matches the legacy clip-to-last behavior (l = 0 exactly there)
    dv = jnp.pad(jnp.diff(values, axis=-1), ((0, 0), (0, 1)))
    pairs = jnp.stack([values, dv], axis=-1).reshape(-1, 2)
    base = handle * lmax
    row = jnp.take(pairs, base + jnp.clip(lo, 0, lmax - 1), axis=0)
    res = row[..., 0] + l * row[..., 1]
    return jnp.where(n == 0, jnp.float32(null_value), res)


#: the four constants tables fused by packed_medium_constants, with their
#: null-table default values (reference null-pointer semantics)
_CONST4_KINDS = (
    "absorption_coef",
    "scattering_coef",
    "refractive_index",
    "group_velocity",
)
_CONST4_NULLS = (0.0, 0.0, 1.0, speed_of_light)


def packed_medium_constants(
    store: MediumStore, handle: jax.Array, wavelength
) -> MediumConstants:
    """Per-lane medium constants by handle (handle 0 = vacuum).

    When the store's four constants tables share one length per medium
    (``const4_ok``, the createMedium default), they are stacked into a
    single (M, Lmax, 4) table *inside the traced program* — loop-invariant,
    so XLA hoists it, and gradients/runtime patches on the individual
    tables still flow — and each lane pays 2 four-wide row gathers instead
    of 12 scalar gathers (bit-identical arithmetic)."""
    wavelength = jnp.asarray(wavelength, jnp.float32)
    lmin = jnp.take(store.lambda_min, handle)
    lmax = jnp.take(store.lambda_max, handle)
    t = jnp.clip((wavelength - lmin) / (lmax - lmin), 0.0, 1.0)
    if store.const4_ok:
        sz = [store.sizes[k] for k in _CONST4_KINDS]
        eff = [
            jnp.where(
                (s == 0)[:, None], jnp.float32(null), store.tables[k]
            )
            for k, s, null in zip(_CONST4_KINDS, sz, _CONST4_NULLS)
        ]
        pad = max(e.shape[1] for e in eff)
        eff = [jnp.pad(e, ((0, 0), (0, pad - e.shape[1]))) for e in eff]
        stacked = jnp.stack(eff, axis=-1)  # (M, pad, 4), hoisted
        # pair-pack (values, slopes) -> ONE 8-wide row gather per lane
        # (see lookup_packed)
        dv = jnp.pad(jnp.diff(stacked, axis=1), ((0, 0), (0, 1), (0, 0)))
        n4 = functools.reduce(jnp.maximum, sz)
        n = jnp.take(n4, handle)
        tt = t * jnp.maximum(n - 1, 1).astype(jnp.float32)
        lo = jnp.floor(tt).astype(jnp.int32)
        l = (tt - jnp.floor(tt))[..., None]
        rows = jnp.concatenate([stacked, dv], axis=-1).reshape(-1, 8)
        base = handle * pad
        row = jnp.take(rows, base + jnp.clip(lo, 0, pad - 1), axis=0)
        res = row[..., :4] + l * row[..., 4:]
        res = jnp.where(
            (n == 0)[..., None], jnp.asarray(_CONST4_NULLS, jnp.float32), res
        )
        mu_a, mu_s = res[..., 0], res[..., 1]
        return MediumConstants(
            n=res[..., 2], vg=res[..., 3], mu_s=mu_s, mu_e=mu_a + mu_s
        )
    mu_a = lookup_packed(
        store.tables["absorption_coef"], store.sizes["absorption_coef"], handle, t, 0.0
    )
    mu_s = lookup_packed(
        store.tables["scattering_coef"], store.sizes["scattering_coef"], handle, t, 0.0
    )
    return MediumConstants(
        n=lookup_packed(
            store.tables["refractive_index"],
            store.sizes["refractive_index"],
            handle,
            t,
            1.0,
        ),
        vg=lookup_packed(
            store.tables["group_velocity"],
            store.sizes["group_velocity"],
            handle,
            t,
            speed_of_light,
        ),
        mu_s=mu_s,
        mu_e=mu_a + mu_s,
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MaterialStore:
    """Packed media plus per-material medium handles and flags.

    The analogue of the reference's MaterialStore: materials become rows
    of integer arrays indexed by a material handle carried on geometry
    (reference: src/theia/material.py:884-1117)."""

    media: MediumStore
    inside: jax.Array  # i32[K] medium handle
    outside: jax.Array  # i32[K]
    flags_inward: jax.Array  # u32[K]
    flags_outward: jax.Array  # u32[K]
    material_names: tuple[str, ...] = field(metadata=dict(static=True))

    @staticmethod
    def pack(
        materials: list[Material], media: list[Medium] | None = None
    ) -> "MaterialStore":
        # collect media from materials and the extra list
        med: dict[str, Medium] = {}

        def add(m):
            if isinstance(m, Medium):
                if m.name in med and med[m.name] is not m:
                    raise ValueError(f"duplicate medium name {m.name}")
                med[m.name] = m

        for mat in materials:
            add(mat.inside)
            add(mat.outside)
        for m in media or []:
            add(m)
        store = MediumStore.pack(list(med.values()))

        def handle_of(m) -> int:
            if m is None:
                return VACUUM_HANDLE
            name = m.name if isinstance(m, Medium) else m
            return store.handle(name)

        names = tuple(m.name for m in materials)
        if len(set(names)) != len(names):
            raise ValueError("duplicate material names")
        return MaterialStore(
            media=store,
            inside=jnp.asarray([handle_of(m.inside) for m in materials], jnp.int32),
            outside=jnp.asarray([handle_of(m.outside) for m in materials], jnp.int32),
            flags_inward=jnp.asarray(
                [int(m.flagsInward) for m in materials], jnp.uint32
            ),
            flags_outward=jnp.asarray(
                [int(m.flagsOutward) for m in materials], jnp.uint32
            ),
            material_names=names,
        )

    def material_handle(self, name: str) -> int:
        return self.material_names.index(name)


# -- persistence (zip of media/*.npz + material.json, format-compatible with
#    the reference, src/theia/material.py:715-881) --


def saveMaterials(path, materials: list[Material], *, media: list[Medium] = []):
    med: dict[str, Medium] = {m.name: m for m in media}

    def name_of(x):
        if x is None:
            return None
        if isinstance(x, Medium):
            med[x.name] = x
            return x.name
        return x

    entries = [
        {
            "name": m.name,
            "inside": name_of(m.inside),
            "outside": name_of(m.outside),
            "flagsInward": int(m.flagsInward),
            "flagsOutward": int(m.flagsOutward),
        }
        for m in materials
    ]
    with ZipFile(path, "w") as zf:
        zf.writestr("material.json", json.dumps(entries))
        for name, medium in med.items():
            with zf.open(f"media/{name}.npz", "w") as f:
                medium.save(f)


# material.json is a list of entries with exactly these keys and types;
# loading checks it like the reference's JSON schema
# (src/theia/material.py:697-712, 855-857)
_ENTRY_TYPES = {
    "name": (str,),
    "inside": (str, type(None)),
    "outside": (str, type(None)),
    "flagsInward": (int, float),
    "flagsOutward": (int, float),
}


def _validate_entries(entries) -> None:
    """Raise ValueError unless ``entries`` follows material.json's schema."""
    if not isinstance(entries, list):
        raise ValueError('"material.json" must hold a list of materials')
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(f"material entry {i} is not an object")
        if e.keys() != _ENTRY_TYPES.keys():
            missing = sorted(_ENTRY_TYPES.keys() - e.keys())
            unknown = sorted(e.keys() - _ENTRY_TYPES.keys())
            raise ValueError(
                f"material entry {i}: missing keys {missing}, "
                f"unknown keys {unknown}"
            )
        for key, types in _ENTRY_TYPES.items():
            # bool is an int subclass, but JSON true/false is no number
            if isinstance(e[key], bool) or not isinstance(e[key], types):
                raise ValueError(
                    f"material entry {i}: {key!r} has type "
                    f"{type(e[key]).__name__}"
                )
        if e["flagsInward"] < 0 or e["flagsOutward"] < 0:
            raise ValueError(f"material entry {i}: negative flags")


def loadMaterials(
    path, *, skipValidation: bool = False
) -> tuple[dict[str, Material], dict[str, Medium]]:
    media: dict[str, Medium] = {}
    materials: dict[str, Material] = {}
    with ZipFile(path) as zf:
        for info in zf.infolist():
            p = Path(info.filename)
            if p.parts[0] == "media" and p.suffix == ".npz":
                with zf.open(info) as f:
                    media[p.stem] = Medium.load(f, name=p.stem)
        try:
            entries = json.loads(zf.read("material.json"))
        except KeyError:
            raise ValueError('missing "material.json" in material archive')
        except json.JSONDecodeError as ex:
            raise ValueError(f'invalid "material.json": {ex}') from ex
    if not skipValidation:
        _validate_entries(entries)

    def resolve(mat: str, name: str | None) -> Medium | None:
        if name is None:
            return None
        if name not in media:
            raise ValueError(
                f"material {mat!r} references unknown medium {name!r}"
            )
        return media[name]

    for e in entries:
        if e["name"] in materials:
            raise ValueError(f"duplicate material {e['name']!r}")
        materials[e["name"]] = Material(
            e["name"],
            resolve(e["name"], e["inside"]),
            resolve(e["name"], e["outside"]),
            flags=(
                MaterialFlags(e["flagsInward"]),
                MaterialFlags(e["flagsOutward"]),
            ),
        )
    return materials, media


################################ MEDIUM MODELS #################################


def _data_file(name: str):
    return importlib.resources.files("theia_jax").joinpath("data").joinpath(name)


class MediumModel:
    """Base class for medium models: sampling functions -> Medium tables
    (reference: src/theia/material.py:1123-1256)."""

    ModelName = "noname"

    def refractive_index(self, wavelength):
        return None

    def group_velocity(self, wavelength):
        return None

    def absorption_coef(self, wavelength):
        return None

    def scattering_coef(self, wavelength):
        return None

    def log_phase_function(self, cos_theta):
        return None

    def phase_sampling(self, eta):
        return None

    def phase_m12(self, cos_theta):
        return None

    def phase_m22(self, cos_theta):
        return None

    def phase_m33(self, cos_theta):
        return None

    def phase_m34(self, cos_theta):
        return None

    def createMedium(
        self,
        lambda_min=200.0 * u.nm,
        lambda_max=800.0 * u.nm,
        num_lambda=1024,
        num_theta=1024,
        *,
        name: str | None = None,
    ) -> Medium:
        l = np.linspace(lambda_min, lambda_max, num_lambda)
        t = np.linspace(-1.0, 1.0, num_theta)
        e = np.linspace(0.0, 1.0, num_theta)

        def f32(x):
            return None if x is None else np.asarray(x, np.float32)

        return Medium(
            np.float32(lambda_min),
            np.float32(lambda_max),
            refractive_index=f32(self.refractive_index(l)),
            group_velocity=f32(self.group_velocity(l)),
            absorption_coef=f32(self.absorption_coef(l)),
            scattering_coef=f32(self.scattering_coef(l)),
            log_phase_function=f32(self.log_phase_function(t)),
            phase_sampling=f32(self.phase_sampling(e)),
            phase_m12=f32(self.phase_m12(t)),
            phase_m22=f32(self.phase_m22(t)),
            phase_m33=f32(self.phase_m33(t)),
            phase_m34=f32(self.phase_m34(t)),
            name=name if name is not None else self.ModelName,
        )


class SellmeierEquation:
    """Empirical dispersion model n^2 = 1 + sum_i B_i λ² / (λ² - C_i)
    with λ in nm (reference: src/theia/material.py:1259-1303)."""

    def __init__(self, B1, B2, B3, C1, C2, C3) -> None:
        self.B1, self.B2, self.B3 = B1, B2, B3
        self.C1, self.C2, self.C3 = C1, C2, C3

    def refractive_index(self, wavelength):
        L2 = np.square(np.asarray(wavelength) / u.nm)
        S = (
            self.B1 * L2 / (L2 - self.C1)
            + self.B2 * L2 / (L2 - self.C2)
            + self.B3 * L2 / (L2 - self.C3)
        )
        return np.sqrt(1.0 + S)

    def group_velocity(self, wavelength):
        wavelength = np.asarray(wavelength)
        n = self.refractive_index(wavelength)
        L = wavelength / u.nm
        L2 = np.square(wavelength)
        S = (
            self.B1 * self.C1 * L / np.square(L2 - self.C1)
            + self.B2 * self.C2 * L / np.square(L2 - self.C2)
            + self.B3 * self.C3 * L / np.square(L2 - self.C3)
        )
        grad = -S / n
        return 1.0 / (n - wavelength * grad) * u.c


class BK7Model(SellmeierEquation, MediumModel):
    """Schott N-BK7 glass: Sellmeier refractive index plus absorption from
    published transmission measurements (data: Schott N-BK7 datasheet;
    reference: src/theia/material.py:1305-1358)."""

    ModelName = "bk7"
    TransmissionTable = None

    def __init__(self) -> None:
        super().__init__(
            1.03961212,
            0.231792344,
            1.010469450,
            0.00600069867e6,
            0.0200179144e6,
            103.5606530e6,
        )
        if BK7Model.TransmissionTable is None:
            BK7Model.TransmissionTable = np.loadtxt(
                _data_file("bk7_transmission.csv"), delimiter=",", skiprows=2
            )

    def absorption_coef(self, wavelength):
        # Beer-Lambert on the two probe thicknesses; average the absorption
        # *lengths* weighted by thickness (thicker probe = better estimate)
        wavelength = np.asarray(wavelength)
        tbl = BK7Model.TransmissionTable
        with np.errstate(divide="ignore"):
            tau_10mm = -0.010 / np.log(tbl[:, 1])
            tau_25mm = -0.025 / np.log(tbl[:, 2])
            tau_avg = (10.0 * tau_10mm + 25.0 * tau_25mm) / 35.0
            tau = np.interp(wavelength / u.nm, tbl[:, 0], tau_avg)
            return np.reciprocal(tau) / u.m


class HenyeyGreensteinPhaseFunction:
    """Henyey-Greenstein phase function with analytic inverse-CDF sampling
    (reference: src/theia/material.py:1361-1419)."""

    def __init__(self, g: float = 0.0) -> None:
        if not -1.0 < g < 1.0:
            warnings.warn(
                "Asymmetry parameter outside the valid range (-1,1)!",
                RuntimeWarning,
            )
        self.g = g

    def log_phase_function(self, cos_theta):
        cos_theta = np.asarray(cos_theta)
        g = self.g
        return np.log(
            (1.0 - g**2) / np.power(1.0 + g**2 - 2 * g * cos_theta, 1.5) / (4.0 * np.pi)
        )

    def phase_sampling(self, eta):
        eta = np.asarray(eta)
        g = self.g
        if abs(g) < 1e-7:
            return 1.0 - 2.0 * eta
        return (1.0 + g**2 - ((1.0 - g**2) / (1 + g - 2.0 * g * eta)) ** 2) / (
            2.0 * g
        )


class FournierForandPhaseFunction:
    """Fournier-Forand phase function for a hyperbolic particle-size
    distribution; sampled by inverting the analytic CDF with a spline
    (reference: src/theia/material.py:1420-1514)."""

    def __init__(self, n: float, mu: float) -> None:
        self._n = n
        self._mu = mu
        self._update()

    @property
    def n(self):
        return self._n

    @n.setter
    def n(self, value):
        self._n = value
        self._update()

    @property
    def mu(self):
        return self._mu

    @mu.setter
    def mu(self, value):
        self._mu = value
        self._update()

    def log_phase_function(self, cos_theta):
        x = np.clip(cos_theta, -1.0, 1.0 - 1e-7)
        nu = 0.5 * (3.0 - self.mu)
        d = 2.0 * (1.0 - x) / (3.0 * (self.n - 1.0) ** 2)
        d_nu = np.float_power(d, nu)
        d180 = 4.0 / (3.0 * (self.n - 1.0) ** 2)
        d180_nu = np.float_power(d180, nu)
        A = nu * (1 - d) - (1 - d_nu) + 2 * (d * (1 - d_nu) - nu * (1 - d)) / (1 - x)
        B = 4 * np.pi * (1 - d) ** 2 * d_nu
        C = (1 - d180_nu) * (3 * x**2 - 1)
        D = 16 * np.pi * (d180 - 1) * d180_nu
        return np.log(A / B + C / D)

    def phase_sampling(self, eta):
        return self._sample_spline(np.asarray(eta))

    def _update(self) -> None:
        # evaluate the analytic CDF on a fine grid and spline-invert it
        cos_theta = np.linspace(1.0 - 1e-7, -1.0, 2048)
        nu = 0.5 * (3.0 - self.mu)
        d = 2.0 * (1.0 - cos_theta) / (3.0 * (self.n - 1.0) ** 2)
        d_nu = np.float_power(d, nu)
        d180 = 4.0 / (3.0 * (self.n - 1.0) ** 2)
        d180_nu = np.float_power(d180, nu)
        A = ((1 - d_nu * d) - 0.5 * (1 - d_nu) * (1 - cos_theta)) / ((1 - d) * d_nu)
        B = ((1 - d180_nu) * (1 - cos_theta) * cos_theta) / (
            16 * (d180 - 1) * d180_nu
        )
        cdf = A + B
        self._sample_spline = CubicSpline(cdf, cos_theta)


class DispersionFreeMedium(MediumModel):
    """Constant optical properties regardless of wavelength (debugging)
    (reference: src/theia/material.py:1517-1593)."""

    ModelName = "dispersion-free"

    def __init__(self, *, n=1.0, ng=1.0, mu_a=0.0, mu_s=0.0) -> None:
        self.n = n
        self.ng = ng
        self.mu_a = mu_a
        self.mu_s = mu_s

    def refractive_index(self, wavelength):
        return np.ones_like(wavelength) * self.n

    def group_velocity(self, wavelength):
        return np.ones_like(wavelength) / self.ng * u.c

    def absorption_coef(self, wavelength):
        return np.ones_like(wavelength) * self.mu_a

    def scattering_coef(self, wavelength):
        return np.ones_like(wavelength) * self.mu_s


class WaterBaseModel:
    """Optical properties of (sea) water: refractive index after the
    Millard & Seaver fit [MS90], absorption/scattering from Smith & Baker
    1981 measurements (data: tests vs published tables; reference:
    src/theia/material.py:1596-1790)."""

    DataTable = None

    # [MS90] fit coefficients
    A0 = 1.3280657
    L2 = -0.0045536802
    LM2 = 0.0025471707
    LM4 = 0.000007501966
    LM6 = 0.000002802632
    T1 = -0.0000052883907
    T2 = -0.0000030738272
    T3 = 0.000000030124687
    T4 = -2.0863178e-10
    TL = 0.000010508621
    T2L = 0.00000021282248
    T3L = -0.000000001705881
    S0 = 0.00019029121
    S1LM2 = 0.0000024239607
    S1T = -0.00000073960297
    S1T2 = 0.0000000089818478
    S1T3 = 1.2078804e-10
    STL = -0.0000003589495
    P1 = 0.0000015868363
    P2 = -1.574074e-11
    PLM2 = 0.000000010712063
    PT = -0.0000000094634486
    PT2 = 1.0100326e-10
    P2T2 = 5.8085198e-15
    P1S = -0.0000000011177517
    PTS = 5.7311268e-11
    PT2S = -1.5460458e-12

    def __init__(self, temperature: float, pressure: float, salinity: float) -> None:
        if not 0.0 <= temperature <= 30.0:
            warnings.warn(
                "Temperature is outside the models valid range of 0°-30°C",
                RuntimeWarning,
            )
        if not 0.0 <= pressure <= 11_000:
            warnings.warn(
                "Pressure is outside the models valid range of 0-11.000 dbar",
                RuntimeWarning,
            )
        if not 0.0 <= salinity <= 40.0:
            warnings.warn(
                "Salinity is outside the models valid range of 0-40 psu",
                RuntimeWarning,
            )
        self.temperature = temperature
        self.pressure = pressure
        self.salinity = salinity
        if WaterBaseModel.DataTable is None:
            WaterBaseModel.DataTable = np.loadtxt(
                _data_file("water_smith81.csv"), delimiter=",", skiprows=1
            )

    def refractive_index(self, wavelength):
        L = np.asarray(wavelength) / 1e3  # nm -> um (formula expects um)
        T, p, S = self.temperature, self.pressure, self.salinity
        N1 = (
            self.A0
            + self.L2 * L**2
            + self.LM2 / L**2
            + self.LM4 / L**4
            + self.LM6 / L**6
            + self.T1 * T
            + self.T2 * T**2
            + self.T3 * T**3
            + self.T4 * T**4
            + self.TL * T * L
            + self.T2L * T**2 * L
            + self.T3L * T**3 * L
        )
        N2 = (
            self.S0 * S
            + self.S1LM2 * S / L**2
            + self.S1T * S * T
            + self.S1T2 * S * T**2
            + self.S1T3 * S * T**3
            + self.STL * S * T * L
        )
        N3 = (
            self.P1 * p
            + self.P2 * p**2
            + self.PLM2 * p / L**2
            + self.PT * p * T
            + self.PT2 * p * T**2
            + self.P2T2 * p**2 * T**2
        )
        N4 = self.P1S * p * S + self.PTS * p * T * S + self.PT2S * p * T**2 * S
        return N1 + N2 + N3 + N4

    def group_velocity(self, wavelength):
        L = np.asarray(wavelength) / 1e3  # nm -> um
        T, p, S = self.temperature, self.pressure, self.salinity
        G1 = (
            2.0 * self.L2 * L
            - 2.0 * self.LM2 / L**3
            - 4.0 * self.LM4 / L**5
            - 6.0 * self.LM6 / L**7
            + self.TL * T
            + self.T2L * T**2
            + self.T3L * T**3
        )
        G2 = -2.0 * self.S1LM2 * S / L**3 + self.STL * S * T
        G3 = -2.0 * self.PLM2 * p / L**3
        G = G1 + G2 + G3
        n = self.refractive_index(wavelength)
        return 1.0 / (n - L * G) * u.c

    def absorption_coef(self, wavelength):
        tbl = WaterBaseModel.DataTable
        return np.interp(np.asarray(wavelength) / u.nm, tbl[:, 0], tbl[:, 1]) / u.m

    def scattering_coef(self, wavelength):
        tbl = WaterBaseModel.DataTable
        return np.interp(np.asarray(wavelength) / u.nm, tbl[:, 0], tbl[:, 2]) / u.m


class KokhanovskyOceanWaterPhaseMatrix:
    """Empirical parameterization of the oceanic-water Mueller phase matrix
    (Kokhanovsky 2003; reference: src/theia/material.py:1793-1878)."""

    def __init__(self, p90, theta0, alpha, xi) -> None:
        self.p90 = p90
        self.theta0 = theta0
        self.alpha = alpha
        self.xi = xi

    def phase_m12(self, cos_theta):
        ct2 = np.square(cos_theta)
        st2 = 1.0 - ct2
        return -self.p90 * st2 / (1.0 + self.p90 * ct2)

    def phase_m22(self, cos_theta):
        theta = np.arccos(cos_theta)
        z = theta - self.theta0
        cz2 = np.square(np.cos(z))
        e = self.xi * np.exp(-self.alpha * theta)
        return (self.p90 * (1.0 + cz2) + e) / (1.0 + self.p90 * cz2 + e)

    def phase_m33(self, cos_theta):
        cos_theta = np.asarray(cos_theta)
        theta = np.arccos(cos_theta)
        ct2 = np.square(cos_theta)
        e = self.xi * np.exp(-self.alpha * theta)
        return (2 * self.p90 * cos_theta + e) / (1.0 + self.p90 * ct2 + e)


def serializeMedium(med) -> str | None:
    """Medium -> its registry name for (de)serialization; names and None
    pass through (reference: src/theia/material.py:775-779)."""
    return med.name if isinstance(med, Medium) else med
