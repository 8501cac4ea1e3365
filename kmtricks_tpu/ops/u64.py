"""uint64 arithmetic emulated as (hi, lo) uint32 pairs.

Every 64-bit quantity in the device pipeline — packed k-mers, XXH64
state, window hashes — is carried as a pair of uint32 arrays, so the
device programs run without jax's x64 mode (whether native uint64 is
faster on the GPU is an open measurement). These helpers
are shape-polymorphic and jit-friendly (all shifts/constants static).

The same functions run under numpy for golden tests (jnp and np share the
API surface used here).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

U32 = jnp.uint32
MASK16 = np.uint32(0xFFFF)


def u(x: int):
    return jnp.uint32(x & 0xFFFFFFFF)


def from_u64_np(arr: np.ndarray):
    """numpy uint64 array -> (hi, lo) uint32 arrays (host-side)."""
    arr = np.asarray(arr, dtype=np.uint64)
    return ((arr >> np.uint64(32)).astype(np.uint32),
            (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def to_u64_np(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 arrays -> numpy uint64 (host-side)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
        lo, dtype=np.uint64)


def const64(x: int):
    return u(x >> 32), u(x)


# -- bitwise ----------------------------------------------------------------

def xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def or64(a, b):
    return a[0] | b[0], a[1] | b[1]


def and64(a, b):
    return a[0] & b[0], a[1] & b[1]


def not64(a):
    return ~a[0], ~a[1]


def shl64(a, s: int):
    """Static left shift by s in [0, 64)."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return (hi << u(s)) | (lo >> u(32 - s)), lo << u(s)
    if s == 32:
        return lo, jnp.zeros_like(lo)
    return lo << u(s - 32), jnp.zeros_like(lo)


def shr64(a, s: int):
    """Static logical right shift by s in [0, 64)."""
    hi, lo = a
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> u(s), (lo >> u(s)) | (hi << u(32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> u(s - 32)


def rotl64(a, s: int):
    return or64(shl64(a, s % 64), shr64(a, (64 - s) % 64))


def shl64_dyn2(a, s2):
    """Dynamic left shift by an EVEN amount ``s2*2`` in [0, 64) (used for
    k-mer alignment where shifts are always 2-bit multiples)."""
    hi, lo = a
    sh = (s2 * 2).astype(U32)
    big = sh >= 32
    shs = jnp.where(big, sh - 32, sh)
    # lo >> (32 - sh) is UB when sh == 0 -> guard with two-step shift
    carry = jnp.where(shs > 0, lo >> (u(32) - shs), jnp.zeros_like(lo))
    nhi = jnp.where(big, lo << shs, (hi << shs) | carry)
    nlo = jnp.where(big, jnp.zeros_like(lo), lo << shs)
    return nhi, nlo


def shr64_dyn2(a, s2):
    """Dynamic logical right shift by ``s2*2`` in [0, 64)."""
    hi, lo = a
    sh = (s2 * 2).astype(U32)
    big = sh >= 32
    shs = jnp.where(big, sh - 32, sh)
    carry = jnp.where(shs > 0, hi << (u(32) - shs), jnp.zeros_like(hi))
    nlo = jnp.where(big, hi >> shs, (lo >> shs) | carry)
    nhi = jnp.where(big, jnp.zeros_like(hi), hi >> shs)
    return nhi, nlo


# -- arithmetic ---------------------------------------------------------------

def add64(a, b):
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)
    return a[0] + b[0] + carry, lo


def sub64(a, b):
    lo = a[1] - b[1]
    borrow = (a[1] < b[1]).astype(U32)
    return a[0] - b[0] - borrow, lo


def mul32x32(a, b):
    """Full 32x32 -> 64 product of uint32 arrays, via 16-bit limbs."""
    al, ah = a & MASK16, a >> u(16)
    bl, bh = b & MASK16, b >> u(16)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # combine: ll + (lh + hl) << 16  with carries into hh
    mid = lh + hl
    mid_carry = (mid < lh).astype(U32)  # wrapped past 2^32
    lo = ll + (mid << u(16))
    lo_carry = (lo < ll).astype(U32)
    hi = hh + (mid >> u(16)) + (mid_carry << u(16)) + lo_carry
    return hi, lo


def mul64(a, b):
    """Low 64 bits of a*b."""
    hi, lo = mul32x32(a[1], b[1])
    hi = hi + a[1] * b[0] + a[0] * b[1]
    return hi, lo


def mul64_const(a, c: int):
    return mul64(a, const64(c))


def mulhi64(a, b):
    """High 64 bits of the full 128-bit product a*b."""
    # partial products
    h_ll, l_ll = mul32x32(a[1], b[1])
    h_lh, l_lh = mul32x32(a[1], b[0])
    h_hl, l_hl = mul32x32(a[0], b[1])
    h_hh, l_hh = mul32x32(a[0], b[0])
    # bits [32, 96): l_lh + l_hl + h_ll
    m = l_lh + l_hl
    c0 = (m < l_lh).astype(U32)
    m2 = m + h_ll
    c1 = (m2 < m).astype(U32)
    # bits [64, 128): h_lh + h_hl + l_hh (+carries), h_hh in top
    lo_out = l_hh + h_lh
    c2 = (lo_out < l_hh).astype(U32)
    lo_out2 = lo_out + h_hl
    c3 = (lo_out2 < lo_out).astype(U32)
    lo_out3 = lo_out2 + c0 + c1
    c4 = (lo_out3 < lo_out2).astype(U32)
    hi_out = h_hh + c2 + c3 + c4
    return hi_out, lo_out3


# -- comparisons --------------------------------------------------------------

def lt64(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le64(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def eq64(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def min64(a, b):
    t = lt64(a, b)
    return jnp.where(t, a[0], b[0]), jnp.where(t, a[1], b[1])


def select64(pred, a, b):
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


# -- modulo by a host-known constant (Barrett reduction) ----------------------

def barrett_magic(w: int) -> int:
    """floor(2^64 / w) for the Barrett reduction. Requires 2 <= w < 2^63."""
    assert 2 <= w < (1 << 63)
    return (1 << 64) // w


def mod_const(a, w: int):
    """a % w for host-known w (2 <= w < 2^63).

    Barrett with M = floor(2^64/w): q = mulhi64(a, M) satisfies
    floor(a/w) - 2 <= q <= floor(a/w), so at most two conditional
    subtractions correct the remainder.
    """
    m = const64(barrett_magic(w))
    q = mulhi64(a, m)
    r = sub64(a, mul64(q, const64(w)))
    wc = const64(w)
    for _ in range(2):
        ge = ~lt64(r, wc)
        r = select64(ge, sub64(r, wc), r)
    return r


def msb_words_to_u64_pairs(keys):
    """msb-first u32 word tuple (device key layout) -> list of (hi, lo)
    u64 pairs in little-endian u64 word order (least significant first) —
    the reference's uint64_t[] Kmer storage order (kmer.hpp:164-630)."""
    nw = len(keys)
    assert nw % 2 == 0
    return [(keys[nw - 2 - 2 * i], keys[nw - 1 - 2 * i])
            for i in range(nw // 2)]


def msb_words_to_u64_rows_np(words) -> np.ndarray:
    """msb-first u32 numpy word list -> (N, slots) little-endian u64 rows."""
    nw = len(words)
    return np.stack([to_u64_np(words[nw - 2 - 2 * i], words[nw - 1 - 2 * i])
                     for i in range(nw // 2)], axis=1)
