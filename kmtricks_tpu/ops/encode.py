"""Device encode kernel: ASCII read batches -> canonical k-mers, minimizers,
partitions — the device replacement for the reference's streaming
superkmerization (gatb/fill_partitions.hpp + Sequence2SuperKmer).

Superkmers are a disk-era shuffling artifact; on the device we produce
(canonical k-mer, partition) tuples directly from fixed-shape read batches
with validity masks. All semantics are byte-identical to the reference:

* codes via ``(ascii >> 1) & 3`` (A=0,C=1,T=2,G=3), valid iff in "ACGTacgt"
* canonical k-mer = min(fwd, revcomp) over the 2-bit polynomial packing
* minimizer = min over the window's masked canonical m-mers (sentinel
  4^m - 1 for forbidden "AA-after-front" m-mers)
* partition = repart_table[minimizer]

k <= 32 on this path (uint32-pair k-mers); larger k runs on the host path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmtricks_tpu.ops import u64 as U

U32 = jnp.uint32


def ascii_to_codes(batch):
    """(B, L) uint8 ASCII -> (codes uint32, valid bool)."""
    codes = (batch.astype(U32) >> U32(1)) & U32(3)
    b = batch
    valid = ((b == 65) | (b == 67) | (b == 71) | (b == 84)
             | (b == 97) | (b == 99) | (b == 103) | (b == 116))
    return codes, valid


def unpack_2bit(packed, vbits, L: int):
    """Host-packed reads -> (codes uint32 (L, B), valid bool (L, B)).

    ``packed``: (L/4, B) uint8, position 4*q + j in bits [2j, 2j+2);
    ``vbits``: (L/8, B) uint8, position 8*q + j in bit j (LSB-first),
    or None for a chunk with no interior non-ACGT byte (the common
    case): ``valid`` is then None — every char is valid and the
    read-length mask of :func:`_window_validity` is the only constraint
    (an all-True plane would make XLA constant-fold its prefix sum at
    compile time). The validity plane then stays off the host link (a
    third of the chunk upload bytes); the packed upload is 0.375
    bytes/base vs 1 for ASCII.
    """
    p = packed.astype(U32)
    codes = jnp.stack([(p >> U32(2 * j)) & U32(3) for j in range(4)],
                      axis=1).reshape(L, -1)
    if vbits is None:
        valid = None
    else:
        v = vbits.astype(U32)
        valid = jnp.stack([(v >> U32(j)) & U32(1) for j in range(8)],
                          axis=1).reshape(L, -1).astype(bool)
    return codes, valid


def pack_2bit_host(batch: np.ndarray, pad: int = ord("N")):
    """Host twin of :func:`unpack_2bit`: (B, L) ASCII rows ->
    (packed (B, L/4) u8, vbits (B, L/8) u8). L must be a multiple of 8
    (row chunks are 128-aligned)."""
    B, L = batch.shape
    assert L % 8 == 0
    codes = ((batch >> 1) & 3).astype(np.uint8)
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2)
              | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
    valid = ((batch == 65) | (batch == 67) | (batch == 71) | (batch == 84)
             | (batch == 97) | (batch == 99) | (batch == 103)
             | (batch == 116))
    vbits = np.packbits(valid, axis=1, bitorder="little")
    return packed, vbits


def pack_2bit_host_clean(batch: np.ndarray, lengths: np.ndarray):
    """:func:`pack_2bit_host` + a cleanliness check: returns
    (packed, vbits, clean) where ``clean`` means every in-length byte is
    ACGT (rows are 'N'-padded past their length, so the per-row valid
    count equals the length exactly when there is no interior N). Clean
    chunks skip the vbits upload — the device derives validity from
    ``lengths`` alone (see :func:`unpack_2bit` with vbits=None)."""
    B, L = batch.shape
    assert L % 8 == 0
    codes = ((batch >> 1) & 3).astype(np.uint8)
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2)
              | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
    valid = ((batch == 65) | (batch == 67) | (batch == 71) | (batch == 84)
             | (batch == 97) | (batch == 99) | (batch == 103)
             | (batch == 116))
    clean = bool((valid.sum(axis=1, dtype=np.int64)
                  == lengths.astype(np.int64)).all())
    vbits = None if clean else np.packbits(valid, axis=1,
                                           bitorder="little")
    return packed, vbits, clean


def _rev2bit32(x):
    """Reverse the sixteen 2-bit groups of each uint32."""
    x = ((x >> U32(2)) & U32(0x33333333)) | ((x & U32(0x33333333)) << U32(2))
    x = ((x >> U32(4)) & U32(0x0F0F0F0F)) | ((x & U32(0x0F0F0F0F)) << U32(4))
    x = ((x >> U32(8)) & U32(0x00FF00FF)) | ((x & U32(0x00FF00FF)) << U32(8))
    x = (x >> U32(16)) | (x << U32(16))
    return x


def revcomp64(kmer, k: int):
    """Reverse complement of packed k-mers (k <= 32), (hi, lo) pairs.

    Mirrors Kmer<32>::rev_comp (kmer.hpp:773-785): reverse all 32 2-bit
    groups, complement (XOR 0b10 per group), shift right to realign.
    """
    hi, lo = kmer
    rhi = _rev2bit32(lo) ^ U32(0xAAAAAAAA)
    rlo = _rev2bit32(hi) ^ U32(0xAAAAAAAA)
    return U.shr64((rhi, rlo), 2 * (32 - k))


def canonical64(kmer, k: int):
    rc = revcomp64(kmer, k)
    return U.min64(kmer, rc), rc


def mmer_canonical(v, m: int):
    """Canonical value of m-mer uint32 values (m <= 15)."""
    rc = (_rev2bit32(v) ^ U32(0xAAAAAAAA)) >> U32(32 - 2 * m)
    return jnp.minimum(v, rc)


def mmer_allowed(v, m: int):
    """GATB is_allowed bit trick on uint32 m-mer values."""
    if m < 3:
        return jnp.ones_like(v, dtype=bool)
    mask1 = U32((1 << (2 * m - 4)) - 1)
    mask00 = U32(0x55555555) & mask1
    a = ~(v | (v >> U32(2)))
    a = ((a >> U32(1)) & a) & mask00
    return a == 0


def _slice_seq(x, off: int, n: int, axis: int):
    return jax.lax.dynamic_slice_in_dim(x, off, n, axis=axis)


def sliding_min(x, w: int, seq_axis: int = -1):
    """Windowed min of width w along ``seq_axis`` (prefix-doubling:
    O(log w) vector ops). Output length = n - w + 1."""
    c = 1
    y = x
    while c < w:
        s = min(c, w - c)
        n = y.shape[seq_axis] - s
        y = jnp.minimum(_slice_seq(y, 0, n, seq_axis),
                        _slice_seq(y, s, n, seq_axis))
        c += s
    return y


def _window_validity(char_valid, lengths, k: int, seq_axis: int,
                     codes_shape=None):
    """(.., W, ..) bool — window has k valid chars and fits the read.
    ``char_valid`` None means every char is valid (then ``codes_shape``
    gives the batch shape) and only the read lengths bound windows."""
    assert seq_axis in (0, 1), "seq_axis must be 0 (L, B) or 1 (B, L)"
    shape = char_valid.shape if char_valid is not None else codes_shape
    W = shape[seq_axis] - k + 1
    wshape = list(shape)
    wshape[seq_axis] = W
    pos = jax.lax.broadcasted_iota(jnp.int32, tuple(wshape), seq_axis)
    lb = lengths[:, None] if seq_axis == 1 else lengths[None, :]
    fits = pos + k <= lb
    if char_valid is None:
        return fits
    bad = (~char_valid).astype(jnp.int32)
    cs = jnp.cumsum(bad, axis=seq_axis)
    pad = [(0, 0), (0, 0)]
    pad[seq_axis] = (1, 0)
    csz = jnp.pad(cs, pad)
    win_clean = (_slice_seq(csz, k, W, seq_axis)
                 - _slice_seq(csz, 0, W, seq_axis)) == 0
    return win_clean & fits


def _minimizer_partitions(codes, repart_table, k: int, m: int,
                          static_parts: int | None, seq_axis: int,
                          canonical_mmers: bool = True):
    """Per-window minimizers -> partition ids (shared by both key widths).

    ``canonical_mmers=False`` skips the m-mer canonicalization —
    ModelMinimizer<ModelDirect>, what fill_partitions.hpp:20's
    NONCANONICAL define intends; that define is DEAD in the reference
    binary (include order + #pragma once, see README), which routes
    canonical. True (default) therefore matches the reference binary
    AND its committed fixtures. GATB-executed goldens pin both
    (tests/test_ref_exec_golden.py)."""
    Wm = codes.shape[seq_axis] - m + 1
    mv = jnp.zeros_like(_slice_seq(codes, 0, Wm, seq_axis))
    for j in range(m):
        mv = (mv << U32(2)) | _slice_seq(codes, j, Wm, seq_axis)
    mc = mmer_canonical(mv, m) if canonical_mmers else mv
    sentinel = U32((1 << (2 * m)) - 1)
    masked = jnp.where(mmer_allowed(mc, m), mc, sentinel)
    minim = sliding_min(masked, k - m + 1, seq_axis)
    if static_parts is not None:
        from kmtricks_tpu.ops.xxh64 import static_partitions
        parts = static_partitions(minim, static_parts)
    else:
        parts = repart_table[minim.astype(jnp.int32)]
    return parts.astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "m", "static_parts", "seq_axis",
                                   "mmer_canonical"))
@jax.named_scope("encode")
def encode_batch(batch, lengths, repart_table, k: int, m: int,
                 static_parts: int | None = None, seq_axis: int = 1,
                 mmer_canonical: bool = True):
    """Encode a read batch into routed canonical k-mers.

    Parameters
    ----------
    batch : (B, L) uint8 ASCII (padded arbitrarily past ``lengths``), or
        (L, B) with ``seq_axis=0`` (the "lb" layout the mesh paths use)
    lengths : (B,) int32 actual read lengths
    repart_table : (4^m,) int32 minimizer -> partition
    k, m : static sizes (k <= 32, m <= 15)
    static_parts : if set (= nb_partitions), compute the --static-repart
        partition XXH64(minimizer) %% P arithmetically instead of the table
        gather
    seq_axis : which batch axis is the sequence (1 for (B, L), 0 for (L, B));
        outputs use the same layout

    Returns
    -------
    (hi, lo) : uint32 canonical k-mer words, W = L - k + 1 along seq_axis
    parts : int32 partition per window
    valid : bool — window contains only ACGT and fits the read
    """
    if isinstance(batch, tuple):
        # pre-unpacked (codes, char_valid) from the 2-bit upload path
        codes, char_valid = batch
        L = codes.shape[seq_axis]
    else:
        L = batch.shape[seq_axis]
        codes, char_valid = ascii_to_codes(batch)
    W = L - k + 1
    valid = _window_validity(char_valid, lengths, k, seq_axis,
                             codes.shape)

    # packed forward k-mers, rolled in over k static slices
    hi = jnp.zeros_like(_slice_seq(codes, 0, W, seq_axis))
    lo = jnp.zeros_like(hi)
    for j in range(k):
        hi, lo = U.shl64((hi, lo), 2)
        lo = lo | _slice_seq(codes, j, W, seq_axis)
    cano, _ = canonical64((hi, lo), k)

    parts = _minimizer_partitions(codes, repart_table, k, m, static_parts,
                                  seq_axis, mmer_canonical)
    return cano[0], cano[1], parts, valid


# ---------------------------------------------------------------------------
# Wide keys: 32 < k <= 64 (4 x uint32 words)
# ---------------------------------------------------------------------------

def _shl2_words(words):
    """Shift a lsb-first u32 word list left by one 2-bit code."""
    out = []
    for i, w in enumerate(words):
        v = w << U32(2)
        if i > 0:
            v = v | (words[i - 1] >> U32(30))
        out.append(v)
    return out


def _shr_words(words, s: int):
    """Static logical right shift of a lsb-first u32 word list by s bits."""
    nw = len(words)
    ws, bs = divmod(s, 32)
    out = []
    for i in range(nw):
        src = words[i + ws] if i + ws < nw else None
        if src is None:
            out.append(jnp.zeros_like(words[0]))
            continue
        v = src >> U32(bs) if bs else src
        if bs and i + ws + 1 < nw:
            v = v | (words[i + ws + 1] << U32(32 - bs))
        out.append(v)
    return out


def _lt_words(a, b):
    """Lexicographic a < b over lsb-first word lists."""
    lt = jnp.zeros_like(a[0], dtype=bool)
    for x, y in zip(a, b):   # least significant first: later words override
        lt = jnp.where(x != y, x < y, lt)
    return lt


def device_key_words(k: int) -> int:
    """Number of msb-first u32 key words on the device path: the span is the
    smallest of {32, 64, 96, 128} holding k (loop_executor.hpp:23-70 /
    KMER_LIST), two u32 words per 32-nt span word."""
    assert k <= 128
    span = next(s for s in (32, 64, 96, 128) if k <= s)
    return span // 16


@partial(jax.jit, static_argnames=("k", "m", "static_parts", "seq_axis",
                                   "mmer_canonical"))
@jax.named_scope("encode")
def encode_batch_wide(batch, lengths, repart_table, k: int, m: int,
                      static_parts: int | None = None, seq_axis: int = 1,
                      mmer_canonical: bool = True):
    """Encode for 32 < k <= 128: canonical k-mers as lsb-first u32 word
    lists — 4 words for k <= 64 (the reference's Kmer<64> __uint128_t
    storage, kmer.hpp:909-1172), 6 for k <= 96 and 8 for k <= 128 (the
    generic uint64_t[] backend, kmer.hpp:164-630). Same routing and
    layout semantics as :func:`encode_batch`."""
    assert 32 < k <= 128
    nw = device_key_words(k)
    span_nt = 16 * nw
    if isinstance(batch, tuple):
        # pre-unpacked (codes, char_valid) from the 2-bit upload path
        codes, char_valid = batch
        L = codes.shape[seq_axis]
    else:
        L = batch.shape[seq_axis]
        codes, char_valid = ascii_to_codes(batch)
    W = L - k + 1
    valid = _window_validity(char_valid, lengths, k, seq_axis,
                             codes.shape)

    zero = jnp.zeros_like(_slice_seq(codes, 0, W, seq_axis))
    fwd = [zero for _ in range(nw)]
    for j in range(k):
        fwd = _shl2_words(fwd)
        fwd[0] = fwd[0] | _slice_seq(codes, j, W, seq_axis)
    # revcomp: reverse 2-bit groups of the span storage, complement,
    # realign right by 2*(span - k) (kmer.hpp rev_comp semantics)
    rc = [_rev2bit32(fwd[nw - 1 - i]) ^ U32(0xAAAAAAAA) for i in range(nw)]
    rc = _shr_words(rc, 2 * (span_nt - k))
    take_rc = _lt_words(rc, fwd)
    cano = tuple(jnp.where(take_rc, r, f) for r, f in zip(rc, fwd))

    parts = _minimizer_partitions(codes, repart_table, k, m, static_parts,
                                  seq_axis, mmer_canonical)
    # msb-first word order for sorting (keys[0] most significant)
    return (tuple(cano[nw - 1 - i] for i in range(nw)), parts, valid)
