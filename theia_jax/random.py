"""Counter-based random number generation.

Implements the Philox 4x32-10 generator with the exact stream/dimension
addressing scheme of the reference implementation so that random sequences
(and therefore whole simulations) can be verified bit-for-bit against it
(reference: src/theia/shader/random.philox.glsl:15-94, src/theia/random.py:228-282).

Addressing scheme
-----------------
Every light path owns one *stream* (its global path index). Within a stream,
draws are indexed by a *dimension* counter that each sampling routine
advances. Draw ``i`` of stream ``s`` under base key ``K`` (64 bit) and base
offset ``C`` (128 bit) is computed as::

    block = philox4x32_10(key = K + s  (mod 2^64, carry rolls into low word),
                          ctr = C + 4*i (mod 2^128, carry rolls into low word))
    value = normalize(block[i mod 4])

where ``normalize(x) = min(1 - 2^-24f, float(x) * 2^-32)`` yields a float32
in ``[0, 1)``. The factor 4 in the counter and the ``i mod 4`` word-select
mirror the reference's (partially redundant) buffering scheme and are kept
for bit-exactness.

The host advances ``C`` between batches by ``4 * nRNGSamples`` *draws*
(i.e. ``offset`` counts draws; the counter stores ``4*offset``)... see
:class:`PhiloxRNG`.

All generator math is pure ``jnp`` on ``uint32`` and therefore runs
vectorized inside the tracers; 32x32->64 bit multiplies are emulated with
16-bit limbs, so no 64-bit integer mode is needed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from os import urandom
import warnings

import jax
import jax.numpy as jnp

__all__ = [
    "Key",
    "Counter",
    "RNGBufferSink",
    "philox4x32",
    "philox_uniform",
    "uniform_from_bits",
    "PhiloxRNG",
    "RNGState",
    "RNG",
    "SobolQRNG",
    "SobolState",
    "sobol_owen_uniform",
]

# Philox 4x32 round multipliers and Weyl key schedule constants
_M0 = jnp.uint32(0xD2511F53)
_M1 = jnp.uint32(0xCD9E8D57)
_W0 = jnp.uint32(0x9E3779B9)
_W1 = jnp.uint32(0xBB67AE85)

#: largest float32 < 1.0
ONE_MINUS_EPSILON = float(jnp.asarray(0x3F7FFFFF, jnp.uint32).view(jnp.float32))
#: 2^-32 as float32
_EPSILON = float(jnp.asarray(0x2F800000, jnp.uint32).view(jnp.float32))


def _u32(x) -> jax.Array:
    return jnp.asarray(x, jnp.uint32)


def _umul32wide(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """32x32 -> 64 bit unsigned multiply via 16-bit limbs; returns (hi, lo)."""
    mask = jnp.uint32(0xFFFF)
    a_lo, a_hi = a & mask, a >> 16
    b_lo, b_hi = b & mask, b >> 16
    ll = a_lo * b_lo
    hl = a_hi * b_lo
    lh = a_lo * b_hi
    hh = a_hi * b_hi
    # middle partial sum; each term < 2^16 so no overflow in uint32
    mid = (ll >> 16) + (hl & mask) + (lh & mask)
    lo = (ll & mask) | (mid << 16)
    hi = hh + (hl >> 16) + (lh >> 16) + (mid >> 16)
    return hi, lo


def _add_carry(a: jax.Array, b: jax.Array) -> tuple[jax.Array, jax.Array]:
    """uint32 add with carry-out (0/1)."""
    s = a + b
    return s, (s < b).astype(jnp.uint32)


def philox4x32(key0, key1, c0, c1, c2, c3, rounds: int = 10):
    """Philox 4x32 block cipher on uint32 words (vectorized over any shape).

    Word order follows the reference: counter words are little-endian
    (c0 = lowest). Returns the four output words.
    """
    k0, k1 = _u32(key0), _u32(key1)
    x, y, z, w = _u32(c0), _u32(c1), _u32(c2), _u32(c3)
    for _ in range(rounds):
        hi0, lo0 = _umul32wide(_M0, x)
        hi1, lo1 = _umul32wide(_M1, z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0 = k0 + _W0
        k1 = k1 + _W1
    return x, y, z, w


def uniform_from_bits(bits: jax.Array) -> jax.Array:
    """Map uint32 bits to float32 in [0, 1) exactly like the reference
    (reference: src/theia/shader/random.util.glsl:8-13)."""
    return jnp.minimum(
        jnp.float32(ONE_MINUS_EPSILON), bits.astype(jnp.float32) * jnp.float32(_EPSILON)
    )


@jax.jit
def philox_uniform(
    key: jax.Array, counter: jax.Array, stream: jax.Array, draw: jax.Array
) -> jax.Array:
    """Draw ``draw`` of stream ``stream`` as float32 in [0, 1).

    Parameters
    ----------
    key: uint32[2]
        base key words (lo, hi)
    counter: uint32[4]
        base counter words (little-endian)
    stream, draw:
        uint32 arrays (broadcastable); the per-path stream id and the
        per-path dimension/draw index
    """
    stream = _u32(stream)
    draw = _u32(draw)
    # 128-bit counter += 4*draw, final carry rolls over into lowest word
    inc = draw << 2
    c0, carry = _add_carry(_u32(counter[0]), inc)
    c1, carry = _add_carry(_u32(counter[1]), carry)
    c2, carry = _add_carry(_u32(counter[2]), carry)
    c3, carry = _add_carry(_u32(counter[3]), carry)
    c0 = c0 + carry
    # 64-bit key += stream, carry rolls over into low word
    k0, carry = _add_carry(_u32(key[0]), stream)
    k1, carry = _add_carry(_u32(key[1]), carry)
    k0 = k0 + carry

    x, y, z, w = philox4x32(k0, k1, c0, c1, c2, c3)
    idx = draw & jnp.uint32(3)
    word = jnp.where(idx == 0, x, jnp.where(idx == 1, y, jnp.where(idx == 2, z, w)))
    return uniform_from_bits(word)


def _tree_dataclass(cls):
    return jax.tree_util.register_dataclass(cls)


@_tree_dataclass
@dataclass(frozen=True)
class RNGState:
    """Traceable per-lane RNG cursor: base key/counter plus (stream, dim).

    Immutable; drawing returns the value(s) and an advanced state, emulating
    the GLSL ``random(idx, inout dim)`` idiom functionally::

        u, rng = rng.uniform()
        (u1, u2), rng = rng.uniform2d()
    """

    key: jax.Array  # uint32[2]
    counter: jax.Array  # uint32[4]
    stream: jax.Array  # uint32 scalar (per lane)
    dim: jax.Array  # uint32 scalar (per lane)

    def uniform(self) -> tuple[jax.Array, "RNGState"]:
        u = philox_uniform(self.key, self.counter, self.stream, self.dim)
        return u, replace(self, dim=self.dim + jnp.uint32(1))

    def uniform2d(self) -> tuple[tuple[jax.Array, jax.Array], "RNGState"]:
        u1 = philox_uniform(self.key, self.counter, self.stream, self.dim)
        u2 = philox_uniform(
            self.key, self.counter, self.stream, self.dim + jnp.uint32(1)
        )
        return (u1, u2), replace(self, dim=self.dim + jnp.uint32(2))

    def skip(self, n: int) -> "RNGState":
        """Advance the dimension counter without drawing."""
        return replace(self, dim=self.dim + jnp.uint32(n))


class RNG:
    """Base class for random number generators (component interface).

    Concrete generators provide :meth:`state` building the traceable state
    consumed by tracers, mirroring the reference's RNG pipeline-stage
    contract (reference: src/theia/random.py:28-41).
    """

    def state(self, stream, dim=0) -> RNGState:  # pragma: no cover - interface
        raise NotImplementedError

    def state_for(self, counter: jax.Array, streams: jax.Array) -> "RNGState":
        """Build the traced per-lane state from the jitted step's
        (counter, streams) arguments — called inside ``_trace_batch``."""
        raise NotImplementedError

    def configure(self, n_draws: int, n_streams: int) -> None:
        """Called once by the tracer with its per-path draw budget and lane
        capacity; sets the default batch advance."""
        if getattr(self, "autoAdvance", 0) == 0:
            self.autoAdvance = n_draws


@dataclass
class PhiloxRNG(RNG):
    """Philox 4x32-10 generator with host-side offset bookkeeping.

    Parameters
    ----------
    key: int | None
        64-bit base key; consecutive streams use key+stream. Randomly
        generated (with a warning) if None.
    offset: int
        Number of draws to skip in every stream; used to advance the
        generator between batches.
    autoAdvance: int
        Amount ``offset`` is incremented by on every :meth:`advance` call
        (typically the tracer's ``nRNGSamples``).
    """

    key: int | None = None
    offset: int = 0
    autoAdvance: int = 0

    def __post_init__(self) -> None:
        if self.key is None:
            self.key = int.from_bytes(urandom(8), "big")
            warnings.warn(f"Random RNG key generated: 0x{self.key:016X}")

    @property
    def key_words(self) -> jax.Array:
        k = self.key & 0xFFFFFFFFFFFFFFFF
        return jnp.array([k & 0xFFFFFFFF, (k >> 32) & 0xFFFFFFFF], jnp.uint32)

    @property
    def counter_words(self) -> jax.Array:
        # the 128-bit counter advances 4 per draw (one philox block per draw)
        c = (4 * self.offset) & (2**128 - 1)
        return jnp.array(
            [(c >> (32 * i)) & 0xFFFFFFFF for i in range(4)], jnp.uint32
        )

    def state(self, stream, dim=0) -> RNGState:
        """Build the traceable state for the given stream id array."""
        stream = _u32(stream)
        return RNGState(
            key=self.key_words,
            counter=self.counter_words,
            stream=stream,
            dim=_u32(jnp.broadcast_to(_u32(dim), stream.shape)),
        )

    def state_for(self, counter: jax.Array, streams: jax.Array) -> RNGState:
        return RNGState(
            key=self.key_words,
            counter=counter,
            stream=streams,
            dim=jnp.zeros_like(streams),
        )

    def advance(self, n: int | None = None) -> None:
        """Advance ``offset`` by n draws (default: ``autoAdvance``)."""
        self.offset += self.autoAdvance if n is None else n


def rng_buffer(
    rng: "PhiloxRNG",
    n_streams: int,
    n_draws: int,
    *,
    base_stream: int = 0,
    base_count: int = 0,
) -> jax.Array:
    """Fill a (n_streams, n_draws) buffer with uniform samples for host-side
    statistical tests (reference: src/theia/random.py:44-199 RNGBufferSink).

    Generators without the Philox key/counter interface (e.g.
    :class:`SobolQRNG`) are dispatched to their own ``sample`` method,
    whose per-stream draw count is bounded by ``dims`` — requesting more
    raises instead of silently truncating."""
    if not hasattr(rng, "key_words"):
        import numpy as np

        buf = np.asarray(rng.sample(base_stream + n_streams))
        if base_count + n_draws > buf.shape[1]:
            raise ValueError(
                f"generator provides {buf.shape[1]} draws per stream but "
                f"{base_count + n_draws} were requested (raise dims=)"
            )
        return jnp.asarray(
            buf[base_stream:, base_count : base_count + n_draws]
        )
    streams = (
        jnp.arange(n_streams, dtype=jnp.uint32)[:, None]
        + jnp.uint32(base_stream)
    )
    draws = (
        jnp.arange(n_draws, dtype=jnp.uint32)[None, :] + jnp.uint32(base_count)
    )
    return philox_uniform(rng.key_words, rng.counter_words, streams, draws)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol (on-device)
# ---------------------------------------------------------------------------
#
# The reference ships a GPU Sobol sampler that is documented broken
# (reference: src/theia/random.py:285-352 SobolQRNG, shader/random.sobol.glsl,
# docs/pipeline/components.md:195-197). This is a working on-device
# replacement following Burley, "Practical Hash-based Owen Scrambling"
# (JCGT 2020): per lane, the sample index is shuffled with a nested uniform
# scramble, the Sobol value for the requested dimension is an XOR-fold of
# direction numbers (vendored from scipy's Joe-Kuo tables at build time),
# and the result is Owen-scrambled with a per-dimension hash seed. All
# integer math is uint32 jnp -> runs vectorized inside tracers.

_LK1 = jnp.uint32(0x6C50B47C)
_LK2 = jnp.uint32(0xB82F1E52)
_LK3 = jnp.uint32(0xC7AFE638)
_LK4 = jnp.uint32(0x8D22F6E6)


def _reverse_bits32(x: jax.Array) -> jax.Array:
    x = ((x >> 1) & jnp.uint32(0x55555555)) | ((x & jnp.uint32(0x55555555)) << 1)
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & jnp.uint32(0x00FF00FF)) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def _laine_karras(x: jax.Array, seed: jax.Array) -> jax.Array:
    """Hash whose output bit i depends only on input bits <= i — a random
    permutation of each dyadic residue class (Laine & Karras 2011 as hashed
    by Burley 2020)."""
    x = x + seed
    x = x ^ (x * _LK1)
    x = x ^ (x * _LK2)
    x = x ^ (x * _LK3)
    x = x ^ (x * _LK4)
    return x


def _nested_uniform_scramble(x: jax.Array, seed: jax.Array) -> jax.Array:
    """Owen scramble of the binary radical-inverse domain (Burley 2020 §3)."""
    return _reverse_bits32(_laine_karras(_reverse_bits32(x), seed))


def _hash32(x: jax.Array) -> jax.Array:
    """Finalizing integer hash (Burley 2020, listing 5)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0xD35A2D97)
    x = x ^ (x >> 15)
    return x


_SOBOL_DIR_CACHE: dict[int, "object"] = {}  # numpy, so jit tracing never leaks


def sobol_direction_numbers(dims: int) -> jax.Array:
    """(dims, 32) uint32 direction-number table (Joe-Kuo, via scipy)."""
    if dims not in _SOBOL_DIR_CACHE:
        from scipy.stats import qmc

        eng = qmc.Sobol(dims, scramble=False, bits=32)
        import numpy as np

        _SOBOL_DIR_CACHE[dims] = np.asarray(eng._sv, dtype=np.uint32)
    return jnp.asarray(_SOBOL_DIR_CACHE[dims])


def sobol_owen_uniform(
    dirs: jax.Array, seed: jax.Array, index: jax.Array, dim: jax.Array
) -> jax.Array:
    """Draw dimension ``dim`` of Owen-scrambled Sobol sample ``index``.

    Dimensions beyond the table fall back to a Philox draw keyed on the
    scramble seed — plain (but well-distributed) Monte Carlo for the tail
    dims, QMC where it matters (the first draws dominate path geometry).
    """
    n_dims = dirs.shape[0]
    index = _u32(index)
    dim = _u32(dim)
    # decorrelate paths: shuffle the sample index (aligned 2^m blocks map
    # to aligned 2^m blocks, preserving elementary intervals)
    idx = _nested_uniform_scramble(index, _hash32(seed ^ jnp.uint32(0xA511E9B3)))
    # Sobol value: XOR-fold direction numbers over the set bits of idx
    dim_safe = jnp.minimum(dim, jnp.uint32(n_dims - 1))
    rows = jnp.take(dirs, dim_safe, axis=0)  # (..., 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (idx[..., None] >> shifts) & jnp.uint32(1)
    masked = jnp.where(bits == 1, rows, jnp.uint32(0))
    value = jax.lax.reduce(
        masked, jnp.uint32(0), jax.lax.bitwise_xor, (masked.ndim - 1,)
    )
    # per-dimension Owen scramble
    value = _nested_uniform_scramble(value, _hash32(dim ^ _hash32(seed)))
    # tail dimensions: hash-based uniform keyed on (seed, shuffled index, dim)
    tail = philox_uniform(
        jnp.stack([seed, _hash32(seed)]),
        jnp.zeros(4, jnp.uint32),
        idx,
        dim,
    )
    return jnp.where(dim < n_dims, uniform_from_bits(value), tail)


@_tree_dataclass
@dataclass(frozen=True)
class SobolState:
    """Traceable per-lane cursor of the Owen-scrambled Sobol generator.

    Drop-in for :class:`RNGState` inside tracers: ``stream`` is the pure
    lane id (same contract as :class:`RNGState` — Host* buffer components
    index host rows with it), ``offset`` the batch offset, and the Sobol
    sample index is their sum; ``dim`` is the Sobol dimension."""

    dirs: jax.Array  # uint32[D, 32]
    seed: jax.Array  # uint32 scalar
    offset: jax.Array  # uint32 scalar (batch offset in sample indices)
    stream: jax.Array  # uint32 per lane (lane id, like RNGState.stream)
    dim: jax.Array  # uint32 per lane

    @property
    def index(self) -> jax.Array:
        """Global Sobol sample index per lane (lane + batch offset)."""
        return self.stream + self.offset

    def uniform(self) -> tuple[jax.Array, "SobolState"]:
        u = sobol_owen_uniform(self.dirs, self.seed, self.index, self.dim)
        return u, replace(self, dim=self.dim + jnp.uint32(1))

    def uniform2d(self) -> tuple[tuple[jax.Array, jax.Array], "SobolState"]:
        u1 = sobol_owen_uniform(self.dirs, self.seed, self.index, self.dim)
        u2 = sobol_owen_uniform(
            self.dirs, self.seed, self.index, self.dim + jnp.uint32(1)
        )
        return (u1, u2), replace(self, dim=self.dim + jnp.uint32(2))

    def skip(self, n: int) -> "SobolState":
        return replace(self, dim=self.dim + jnp.uint32(n))


class SobolQRNG(RNG):
    """Owen-scrambled Sobol quasi-random generator — usable as the ``rng``
    of any tracer (fixes what the reference documents broken:
    src/theia/random.py:285-352, shader/random.sobol.glsl).

    Each light path consumes one Sobol point; successive batches use
    successive blocks of ``capacity`` sample indices (keep the lane
    capacity a power of two for exact elementary-interval alignment).
    Dimensions beyond ``dims`` fall back to hash-based uniforms.
    """

    def __init__(self, *, seed: int = 0, dims: int = 64) -> None:
        self.seed = seed
        self.dims = dims
        self.offset = 0
        self.autoAdvance = 0

    def configure(self, n_draws: int, n_streams: int) -> None:
        if self.autoAdvance == 0:
            self.autoAdvance = n_streams
        if n_draws > self.dims:
            warnings.warn(
                f"tracer draws up to {n_draws} dims/path but SobolQRNG has "
                f"{self.dims} Sobol dims; the tail falls back to hash-based "
                "uniforms (increase dims= to extend QMC coverage)"
            )

    @property
    def counter_words(self) -> jax.Array:
        """Batch offset + scramble seed, encoded like a Philox counter
        (word 0 = offset, word 1 = seed, words 2-3 unused). Carrying the
        seed in the runtime counter keeps the traced program seed-free:
        independent Owen randomizations (fresh seeds) re-use one compiled
        executable — the replicate structure QMC error estimation needs."""
        return jnp.array(
            [self.offset & 0xFFFFFFFF, self.seed & 0xFFFFFFFF, 0, 0],
            jnp.uint32,
        )

    def state_for(self, counter: jax.Array, streams: jax.Array) -> SobolState:
        return SobolState(
            dirs=sobol_direction_numbers(self.dims),
            seed=_u32(counter[1]),
            offset=_u32(counter[0]),
            stream=streams,
            dim=jnp.zeros_like(streams),
        )

    def state(self, stream, dim=0) -> SobolState:
        stream = _u32(stream)
        return SobolState(
            dirs=sobol_direction_numbers(self.dims),
            seed=jnp.uint32(self.seed & 0xFFFFFFFF),
            offset=jnp.uint32(self.offset & 0xFFFFFFFF),
            stream=stream,
            dim=_u32(jnp.broadcast_to(_u32(dim), stream.shape)),
        )

    def sample(self, n: int) -> "np.ndarray":
        """Host-side (n, dims) buffer of the same sequence (RNGBufferSink
        analogue)."""
        import numpy as np

        st = self.state(jnp.arange(n, dtype=jnp.uint32)[:, None])
        dims = jnp.arange(self.dims, dtype=jnp.uint32)[None, :]
        return np.asarray(
            sobol_owen_uniform(
                sobol_direction_numbers(self.dims),
                jnp.uint32(self.seed & 0xFFFFFFFF),
                st.index,
                dims,
            )
        )

    def advance(self, n: int | None = None) -> None:
        self.offset += self.autoAdvance if n is None else n


# ---------------------------------------------------------------------------
# reference-style key/counter views and buffer sink
# ---------------------------------------------------------------------------


class Key:
    """64-bit Philox key split into (lo, hi) 32-bit words
    (reference: src/theia/random.py:200-211)."""

    def __init__(self, value: int = 0) -> None:
        self.value = value

    @property
    def value(self) -> int:
        return self.lo + (self.hi << 32)

    @value.setter
    def value(self, value: int) -> None:
        self.lo = value & 0xFFFFFFFF
        self.hi = (value >> 32) & 0xFFFFFFFF

    @property
    def words(self) -> jax.Array:
        """uint32[2] device view (what the tracers consume)."""
        return jnp.array([self.lo, self.hi], jnp.uint32)


class Counter:
    """128-bit Philox counter as four 32-bit words
    (reference: src/theia/random.py:214-224)."""

    def __init__(self, value: int = 0) -> None:
        self.value = value

    @property
    def value(self) -> int:
        return sum(self.word[i] << (32 * i) for i in range(4))

    @value.setter
    def value(self, value: int) -> None:
        self.word = [(value >> (32 * i)) & 0xFFFFFFFF for i in range(4)]

    @property
    def words(self) -> jax.Array:
        """uint32[4] device view (what the tracers consume)."""
        return jnp.array(self.word, jnp.uint32)


class RNGBufferSink:
    """Fills a (streams, samples[, sampleDim]) buffer from a generator,
    consecutive numbers in consecutive streams
    (reference: src/theia/random.py:44-199).

    ``run()`` draws the next block and advances the generator; use
    :attr:`buffer` for the last result."""

    def __init__(
        self,
        generator: RNG,
        streams: int,
        samples: int,
        *,
        baseStream: int = 0,
        baseCount: int = 0,
        sampleDim: int = 1,
    ) -> None:
        if sampleDim not in (1, 2):
            raise ValueError("only sampleDim of 1 or 2 supported")
        self.generator = generator
        self.streams = streams
        self.samples = samples
        self.baseStream = baseStream
        self.baseCount = baseCount
        self.sampleDim = sampleDim
        self.buffer = None

    def run(self):
        import numpy as np

        draws = self.samples * self.sampleDim
        gen = self.generator
        out = rng_buffer(
            gen,
            self.streams,
            draws,
            base_stream=self.baseStream,
            base_count=self.baseCount,
        )
        if self.sampleDim == 2:
            out = out.reshape(self.streams, self.samples, 2)
        self.buffer = np.asarray(out)
        # fresh block next run: Philox offsets count draws per stream;
        # sample-index generators (Sobol) count rows, so the next block
        # of `streams` rows is the fresh one
        gen.advance(draws if hasattr(gen, "key_words") else self.streams)
        return self.buffer
