"""Bit-matrix transpose (vertical BF windows -> horizontal per-sample rows).

Reference: include/kmtricks/bitmatrix.hpp:75-289 — a byte-addressed bit
matrix (bit j of byte b = bit 8b+j, LSB-first) with an SSE2 16x8 blockwise
transpose. Here: a vectorized numpy transpose for the host path and a JAX
version for on-device transposes; both reproduce BitMatrix::transpose
byte-for-byte (including the row padding to multiples of 8).
"""

from __future__ import annotations

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def transpose_bits(rows: np.ndarray, nrows: int | None = None) -> np.ndarray:
    """Transpose a bit matrix given as (N, nbytes) uint8 rows.

    Output: (nbytes*8, ROUND_UP(N, 8)/8) uint8 — bit (i, j) of the input
    becomes bit (j, i) of the output; input rows are zero-padded to a
    multiple of 8 (BitMatrix ctor + transpose semantics).
    """
    n, nb = rows.shape
    n8 = round_up(max(n, nrows or 0), 8)
    bits = np.unpackbits(rows, axis=1, bitorder="little")        # (n, nb*8)
    if n8 != n:
        bits = np.vstack([bits, np.zeros((n8 - n, nb * 8), np.uint8)])
    return np.packbits(bits.T, axis=1, bitorder="little")


def transpose_bits_device(rows, nrows: int | None = None):
    """JAX twin of :func:`transpose_bits` (jnp arrays in/out): instead of
    transposing an (N, S) u8 cell matrix (large u8 transposes lower
    poorly), unpack each 8-ROW group's bits and reduce
    them into output bytes — the only real transpose left is the small
    (N/8, S) byte matrix (the reference needs an SSE 16x8 block kernel
    for the same reason, bitmatrix.hpp:238-289)."""
    import jax.numpy as jnp

    n, nb = rows.shape
    n8 = round_up(max(n, nrows or 0), 8)
    if n8 != n:
        rows = jnp.concatenate(
            [rows, jnp.zeros((n8 - n, nb), jnp.uint8)], axis=0)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    # bit s of input row r (LSB-first within bytes), grouped 8 rows/byte:
    # out[8*b + s, g] = sum_j bit(rows[8g + j], 8*b + s) << j
    grp = rows.reshape(n8 // 8, 8, nb)                     # (G, 8, nb)
    bits = (grp[:, :, :, None] >> shifts) & jnp.uint8(1)   # (G, 8, nb, 8)
    packed = jnp.sum(bits.astype(jnp.uint16)
                     << shifts[None, :, None, None], axis=1)  # (G, nb, 8)
    out = packed.reshape(n8 // 8, nb * 8).T                # (nb*8, G)
    return out.astype(jnp.uint8)
