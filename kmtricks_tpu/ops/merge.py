"""Device merge kernel: cross-sample k-way merge with low-abundance rescue.

The device reformulation of the reference's streaming N-way heap merge
(merge.hpp:183-260 / 441-517): co-sort (key, sample, count) triples, then
express the rescue semantics as segmented reductions —

  solid        = count >= abundance_min[sample]
  solid_in_row = per-key segment total of solid
  rescued      = present & !solid & save_if>0 & solid_in_row >= save_if
  final count  = count if solid|rescued else 0
  keep row     = solid_in_row >= recurrence_min

Fixed shapes: padded flat inputs + validity mask; outputs are full-size with
head masks (compaction happens on host or downstream). Keys are tuples of
u32 words (msb-first), so packed k-mers up to k = 64 and window hashes share
one kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from kmtricks_tpu.host.ops import MergeResult, MergeStats
from kmtricks_tpu.ops import u64 as U

U32 = jnp.uint32
I32 = jnp.int32


@partial(jax.jit, static_argnames=("nsamp", "rmin", "save_if"))
def merge_keys(keys, samp, count, valid, amin_vec,
               nsamp: int, rmin: int, save_if: int):
    """Merge flat (key, sample, count) triples.

    Parameters
    ----------
    keys : tuple of (N,) uint32 key words, MOST significant first
    samp : (N,) int32 sample ids in [0, nsamp)
    count : (N,) uint32 pre-merge counts
    valid : (N,) bool padding mask
    amin_vec : (nsamp,) uint32 per-sample soft-min thresholds

    Returns (all sorted by key, padding at the end):
    keys_s (tuple), samp, final_count : (N,)
    head : (N,) bool distinct-key marks
    keep : (N,) bool at head positions — recurrence verdict for the row
    row_of : (N,) int32 segment id of each element
    stats : (6, nsamp) uint32 — NON_SOLID, RESCUED, UNIQ_WO, UNIQ_W,
            TOTAL_WO, TOTAL_W per sample
    """
    from kmtricks_tpu.ops.count_merge import _per_sample, _seg_total

    n = keys[0].shape[0]
    nw = len(keys)
    inv = (~valid).astype(U32)
    sorted_ops = jax.lax.sort(
        (inv,) + tuple(keys) + (samp.astype(U32), count),
        dimension=0, num_keys=1 + nw)
    inv_s = sorted_ops[0]
    keys_s = sorted_ops[1:1 + nw]
    samp_s = sorted_ops[1 + nw].astype(I32)
    cnt_s = sorted_ops[2 + nw]
    valid_s = inv_s == 0

    d = keys_s[0][1:] != keys_s[0][:-1]
    for w in keys_s[1:]:
        d = d | (w[1:] != w[:-1])
    diff = jnp.ones((n,), dtype=bool).at[1:].set(d)
    head = diff & valid_s
    row_of = jnp.cumsum(head.astype(I32)) - 1

    amin = jnp.asarray(amin_vec, dtype=U32)
    if nsamp <= 16:
        amin_of = jnp.zeros((n,), dtype=U32)
        for s in range(nsamp):
            amin_of = jnp.where(samp_s == s, amin[s], amin_of)
    else:
        amin_of = amin[samp_s]
    solid = valid_s & (cnt_s >= amin_of)
    # per-key solid count via cumulative-primitive segmented totals
    solid_in = _seg_total(solid, diff)

    if save_if > 0:
        rescued = valid_s & ~solid & (solid_in >= save_if)
    else:
        rescued = jnp.zeros_like(solid)
    final = jnp.where(solid | rescued, cnt_s, U32(0))
    keep = head & (solid_in >= rmin)

    # per-sample statistics (merge.hpp:49-100)
    stats = jnp.stack([
        _per_sample(valid_s & ~solid, samp_s, nsamp),     # NON_SOLID
        _per_sample(rescued, samp_s, nsamp),              # RESCUED
        _per_sample(solid, samp_s, nsamp),                # UNIQUE_WO_RESCUE
        _per_sample(solid | rescued, samp_s, nsamp),      # UNIQUE_W_RESCUE
        _per_sample(jnp.where(solid, cnt_s, U32(0)), samp_s,
                    nsamp),                               # TOTAL_WO
        _per_sample(final, samp_s, nsamp),                # TOTAL_W
    ])
    return keys_s, samp_s, final, head, keep, row_of, stats


def _words_from_u64_rows(rows: np.ndarray) -> tuple:
    """(N, slots) little-endian u64 rows -> msb-first u32 word tuple."""
    out = []
    for s in range(rows.shape[1] - 1, -1, -1):
        hi, lo = U.from_u64_np(rows[:, s])
        out += [hi, lo]
    return tuple(out)


def merge_partition_device(keys_list, counts_list, amin_vec,
                           rmin: int, save_if: int) -> MergeResult:
    """Drop-in device-backed replacement for host.ops.merge_partition.

    Accepts (N_i,) uint64 hash keys or (N_i, slots) packed k-mer keys per
    sample (slots <= 2, i.e. k <= 64 on this path).
    """
    nsamp = len(keys_list)
    multiword = keys_list[0].ndim == 2
    slots = keys_list[0].shape[1] if multiword else 1
    rows = np.concatenate(
        [kk.reshape(len(kk), slots) for kk in keys_list]).astype(np.uint64)
    cnts = np.concatenate(counts_list).astype(np.uint32)
    samp = np.concatenate([np.full(len(keys_list[i]), i, dtype=np.int32)
                           for i in range(nsamp)])
    n = len(rows)
    if n == 0:
        z = np.zeros(nsamp, dtype=np.uint64)
        return MergeResult(
            keys=np.zeros((0, slots) if multiword else (0,),
                          dtype=np.uint64),
            counts=np.zeros((0, nsamp), dtype=np.uint32),
            keep=np.zeros(0, dtype=bool),
            stats=MergeStats(z.copy(), z.copy(), z.copy(), z.copy(),
                             z.copy(), z.copy()))

    words = tuple(jnp.asarray(w) for w in _words_from_u64_rows(rows))
    out = merge_keys(words, jnp.asarray(samp), jnp.asarray(cnts),
                     jnp.ones(n, dtype=bool),
                     np.asarray(amin_vec, dtype=np.uint32),
                     nsamp, int(rmin), int(save_if))
    keys_s, samp_s, final, head, keep, row_of, stats = out
    keys_s = [np.asarray(w) for w in keys_s]
    samp_s, final, head, keep, row_of, stats = map(
        np.asarray, (samp_s, final, head, keep, row_of, stats))
    head = head.astype(bool)

    cols = []
    for s in range(slots):           # little-endian u64 word s
        hi = keys_s[2 * (slots - 1 - s)]
        lo = keys_s[2 * (slots - 1 - s) + 1]
        cols.append(U.to_u64_np(hi, lo))
    urows = np.stack(cols, axis=1)[head]
    nrows = len(urows)
    mat = np.zeros((nrows, nsamp), dtype=np.uint32)
    mat[row_of, samp_s] = final
    st = stats.astype(np.uint64)
    return MergeResult(
        keys=urows if multiword else urows[:, 0],
        counts=mat,
        keep=keep[head],
        stats=MergeStats(st[0], st[1], st[2], st[3], st[4], st[5]))
