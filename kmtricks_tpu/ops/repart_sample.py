"""Device repartition sampler: the SampleRepart kx-mer tally on the device.

The reference samples the bank and tallies KX-MER STARTS per minimizer to
weight the LPT bin packing (RepartitionAlgorithm.cpp:157-243): within each
superkmer (maximal run of consecutive valid k-mer windows sharing a
minimizer), a new kx-mer starts when the canonical strand flips or every
4th k-mer of a same-strand run.  The host twin
(`runtime.pipeline._tally_kxmer_starts`) is vectorized numpy; this module
is the device version: whole read batches ride the 2-bit packed
upload, every per-window quantity (minimizer, strand, run break, kx
start) is computed as a (W, B) array pass, and one scatter-add lands the
tally in a device-resident (4^m,) table that accumulates across chunks —
only the final 4^m counters ever cross the device link.

Bit-exactness: minimizers via the same canonical-m-mer + is_allowed +
sliding-min algebra as the encode kernel (executed-golden pinned there);
strand via the GATB comparator (forward iff NOT revcomp < forward);
breaks/starts identical to the host tally, proven by
tests/test_repart_sampler.py parity over random banks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmtricks_tpu.ops import u64 as U
from kmtricks_tpu.ops.encode import (
    _lt_words,
    _rev2bit32,
    _shl2_words,
    _shr_words,
    _slice_seq,
    _window_validity,
    device_key_words,
    mmer_allowed,
    mmer_canonical,
    revcomp64,
    unpack_2bit,
)

U32 = jnp.uint32
I32 = jnp.int32


def _sliding_min_pair(r, v, w: int, seq_axis: int = 0):
    """Windowed lexicographic min of (rank, value) pairs along
    ``seq_axis`` — the --minimizer-type 1 comparator
    (ComparatorMinimizerFrequencyOrLex, Model.hpp:911-976). Same
    prefix-doubling shape as :func:`ops.encode.sliding_min`."""
    def pmin(ar, av, br, bv):
        take_b = (br < ar) | ((br == ar) & (bv < av))
        return jnp.where(take_b, br, ar), jnp.where(take_b, bv, av)

    c = 1
    while c < w:
        s = min(c, w - c)
        n = r.shape[seq_axis] - s
        r, v = pmin(_slice_seq(r, 0, n, seq_axis),
                    _slice_seq(v, 0, n, seq_axis),
                    _slice_seq(r, s, n, seq_axis),
                    _slice_seq(v, s, n, seq_axis))
        c += s
    return r, v


def _window_minimizer_values(codes, k: int, m: int, freq_table,
                             use_freq: bool, seq_axis: int = 0):
    """Per-window minimizer VALUES (not partitions): min over the window's
    masked canonical m-mers; with ``use_freq`` m-mers compare by sampled
    frequency rank first, value second. Mirrors
    `core.kmer.window_minimizers` exactly."""
    from kmtricks_tpu.ops.encode import sliding_min

    Wm = codes.shape[seq_axis] - m + 1
    mv = jnp.zeros_like(_slice_seq(codes, 0, Wm, seq_axis))
    for j in range(m):
        mv = (mv << U32(2)) | _slice_seq(codes, j, Wm, seq_axis)
    mc = mmer_canonical(mv, m)
    sentinel = U32((1 << (2 * m)) - 1)
    masked = jnp.where(mmer_allowed(mc, m), mc, sentinel)
    if not use_freq:
        return sliding_min(masked, k - m + 1, seq_axis)
    ranks = freq_table[masked.astype(I32)].astype(U32)
    _, minim = _sliding_min_pair(ranks, masked, k - m + 1, seq_axis)
    return minim


def _strand_forward(codes, k: int, seq_axis: int = 0):
    """(W, B) bool — True iff the canonical strand of each k-mer window is
    the forward one (GATB comparator: NOT revcomp < forward;
    core.kmer.strand_is_forward twin)."""
    W = codes.shape[seq_axis] - k + 1
    if k <= 32:
        hi = jnp.zeros_like(_slice_seq(codes, 0, W, seq_axis))
        lo = jnp.zeros_like(hi)
        for j in range(k):
            hi, lo = U.shl64((hi, lo), 2)
            lo = lo | _slice_seq(codes, j, W, seq_axis)
        rc = revcomp64((hi, lo), k)
        return ~U.lt64(rc, (hi, lo))
    nw = device_key_words(k)
    zero = jnp.zeros_like(_slice_seq(codes, 0, W, seq_axis))
    fwd = [zero for _ in range(nw)]
    for j in range(k):
        fwd = _shl2_words(fwd)
        fwd[0] = fwd[0] | _slice_seq(codes, j, W, seq_axis)
    rc = [_rev2bit32(fwd[nw - 1 - i]) ^ U32(0xAAAAAAAA) for i in range(nw)]
    rc = _shr_words(rc, 2 * (16 * nw - k))
    return ~_lt_words(rc, fwd)


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("k", "m", "L", "use_freq"))
def tally_step(bins, packed, vbits, lengths, freq_table, *,
               k: int, m: int, L: int, use_freq: bool = False):
    """Accumulate one read chunk's kx-mer-start tally into ``bins``.

    bins : (4^m,) int32, device-resident, DONATED (accumulates in place)
    packed : (L/4, B) uint8 2-bit codes (sequence along sublanes)
    vbits : (L/8, B) uint8 per-char validity bits
    lengths : (B,) int32 read lengths (padding rows use 0)
    freq_table : (4^m,) int32 frequency ranks (--minimizer-type 1),
        or a (1,) dummy when ``use_freq`` is False
    """
    codes, char_valid = unpack_2bit(packed, vbits, L)
    W = L - k + 1
    wv = _window_validity(char_valid, lengths, k, seq_axis=0,
                          codes_shape=codes.shape)          # (W, B)
    minim = _window_minimizer_values(codes, k, m, freq_table,
                                     use_freq)[:W]
    which = _strand_forward(codes, k)                              # (W, B)

    # run breaks per read (reads are columns; row 0 always breaks — the
    # host twin's flat stream gets the same break from the 'N' separator)
    def shift_pad_false(x):
        # (W-1, B) row-i-vs-i-1 comparisons -> (W, B) with row 0 False
        return jnp.pad(x, ((1, 0), (0, 0))).astype(bool)

    same_min = shift_pad_false((minim[1:] == minim[:-1])
                               & wv[1:] & wv[:-1])
    sk_break = ~same_min
    same_strand = shift_pad_false(which[1:] == which[:-1])
    wb = sk_break | ~same_strand

    idx = jax.lax.broadcasted_iota(I32, wv.shape, 0)
    run_start = jax.lax.cummax(jnp.where(wb, idx, 0), axis=0)
    kx_start = (wb | (((idx - run_start) & 3) == 0)) & wv
    return bins.at[minim.astype(I32).ravel()].add(
        kx_start.ravel().astype(I32), mode="drop")


def make_bins(m: int):
    """Fresh device-resident (4^m,) int32 tally table."""
    return jnp.zeros(4 ** m, dtype=I32)
