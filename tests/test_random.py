"""RNG tests: bit-exactness of the Philox draw scheme against an
independent pure-Python oracle implementing the reference's addressing
(reference: src/theia/shader/random.philox.glsl:15-94) plus statistical
checks mirroring the reference's test strategy (tests/test_random.py)."""

import numpy as np
import pytest
from scipy.stats import kstest

import jax.numpy as jnp

from theia_jax.random import PhiloxRNG, philox_uniform, philox4x32

M32 = 0xFFFFFFFF


pytestmark = pytest.mark.core  # fast smoke tier, see pyproject markers

def philox_oracle(key64: int, counter128: int, rounds: int = 10) -> list[int]:
    """Slow integer-math philox4x32 for cross-checking."""
    M0, M1 = 0xD2511F53, 0xCD9E8D57
    W0, W1 = 0x9E3779B9, 0xBB67AE85
    k0, k1 = key64 & M32, (key64 >> 32) & M32
    x = counter128 & M32
    y = (counter128 >> 32) & M32
    z = (counter128 >> 64) & M32
    w = (counter128 >> 96) & M32
    for _ in range(rounds):
        p0 = M0 * x
        p1 = M1 * z
        hi0, lo0 = (p0 >> 32) & M32, p0 & M32
        hi1, lo1 = (p1 >> 32) & M32, p1 & M32
        x, y, z, w = (hi1 ^ y ^ k0), lo1, (hi0 ^ w ^ k1), lo0
        k0 = (k0 + W0) & M32
        k1 = (k1 + W1) & M32
    return [x, y, z, w]


def draw_oracle(base_key: int, offset: int, stream: int, draw: int) -> float:
    """The reference's draw addressing: counter = 4*offset + ((4*draw) mod 2^32)
    with 128-bit wraparound-carry, key = base_key + stream with 64-bit
    wraparound-carry; select word draw%4 and normalize."""
    inc = (draw << 2) & M32
    ctr = 4 * offset
    # ripple add with final carry rollover into lowest word
    words = [(ctr >> (32 * i)) & M32 for i in range(4)]
    carry = inc
    out = []
    for wd in words:
        s = wd + carry
        out.append(s & M32)
        carry = s >> 32
    out[0] = (out[0] + carry) & M32
    ctr128 = sum(v << (32 * i) for i, v in enumerate(out))

    k = [base_key & M32, (base_key >> 32) & M32]
    s = k[0] + (stream & M32)
    k0 = s & M32
    carry = s >> 32
    s = k[1] + carry
    k1 = s & M32
    carry = s >> 32
    k0 = (k0 + carry) & M32
    key64 = k0 | (k1 << 32)

    block = philox_oracle(key64, ctr128)
    word = block[draw % 4]
    val = np.float32(np.float32(word) * np.float32(2**-32))
    return float(min(np.float32(1.0 - 2**-24), val))


def test_philox_block_matches_oracle():
    keys = [0, 1, 0xDEADBEEFCAFEBABE, (1 << 64) - 1]
    ctrs = [0, 1, 123456789, (1 << 128) - 1, 1 << 96]
    combos = [(k, c) for k in keys for c in ctrs]
    args = np.array(
        [
            [
                k & M32,
                (k >> 32) & M32,
                c & M32,
                (c >> 32) & M32,
                (c >> 64) & M32,
                (c >> 96) & M32,
            ]
            for k, c in combos
        ],
        np.uint32,
    )
    got = philox4x32(*(jnp.asarray(args[:, i]) for i in range(6)))
    got = np.stack([np.asarray(g) for g in got], axis=-1)
    for row, (k, c) in enumerate(combos):
        assert list(got[row].astype(np.uint64)) == philox_oracle(k, c), (k, c)


@pytest.mark.parametrize("offset", [0, 17, 2**40])
@pytest.mark.parametrize("key", [0x903245870ABCDEF1, 5])
def test_draw_addressing_matches_oracle(key, offset):
    rng = PhiloxRNG(key=key, offset=offset)
    streams = np.array([0, 1, 2, 77, 2**31, M32], np.uint32)
    draws = np.array([0, 1, 2, 3, 4, 5], np.uint32)
    got = np.asarray(
        philox_uniform(
            rng.key_words,
            rng.counter_words,
            jnp.asarray(streams)[:, None],
            jnp.asarray(draws)[None, :],
        )
    )
    for i, s in enumerate(streams):
        for j, d in enumerate(draws):
            exp = draw_oracle(key, offset, int(s), int(d))
            assert got[i, j] == np.float32(exp), (s, d)


def test_uniformity():
    rng = PhiloxRNG(key=0xABCDEF)
    streams = jnp.arange(256, dtype=jnp.uint32)
    draws = jnp.arange(64, dtype=jnp.uint32)
    samples = np.asarray(
        philox_uniform(
            rng.key_words, rng.counter_words, streams[:, None], draws[None, :]
        )
    ).ravel()
    assert samples.min() >= 0.0 and samples.max() < 1.0
    assert kstest(samples, "uniform").pvalue > 0.01


def test_state_draw_sequence():
    rng = PhiloxRNG(key=42)
    state = rng.state(jnp.arange(4, dtype=jnp.uint32))
    u0, state = state.uniform()
    (u1, u2), state = state.uniform2d()
    assert int(state.dim[0]) == 3
    for s in range(4):
        assert float(u0[s]) == np.float32(draw_oracle(42, 0, s, 0))
        assert float(u1[s]) == np.float32(draw_oracle(42, 0, s, 1))
        assert float(u2[s]) == np.float32(draw_oracle(42, 0, s, 2))


def test_offset_advance():
    rng = PhiloxRNG(key=7, offset=0, autoAdvance=10)
    rng.advance()
    assert rng.offset == 10
    # advancing the offset by n shifts the counter base by 4n: draw i of the
    # new batch reads philox block ctr=4*(offset+i), word i%4 — disjoint from
    # (but not identical to) draw offset+i of the old batch, exactly like the
    # reference's scheme.
    assert [int(w) for w in rng.counter_words] == [40, 0, 0, 0]
    s1 = rng.state(jnp.zeros(1, jnp.uint32))
    u_new, _ = s1.uniform()
    assert float(u_new[0]) == np.float32(draw_oracle(7, 10, 0, 0))
