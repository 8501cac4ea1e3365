"""Device-resident count tables: per-chunk pair extraction + sorted merge.

The streaming engine (runtime/stream_engine.py) processes a collection as
fixed-shape chunks. Each chunk's occurrences reduce ON DEVICE to sorted,
unique (packed key, count) pairs; chunk pair streams then merge into a
device-resident table by concatenate -> sort -> collapse-equal-runs ->
compact. The table IS the cross-chunk aggregation state — nothing
N-sized ever rides the device link (the reference's per-partition count
FILES play this role, kmer_file.hpp; here the "files" live in HBM).

Packed words are the count_merge.py sort layouts ("h1"/"h2"/"k2"/"k3"/
"kw"): (valid | partition | key | sample) msb-first u32 words, all-ones
sentinel for empty slots — so tables and pair streams need no separate
validity channel and merging keeps partition-major order.

Counts are 32-bit with saturating accumulation (the reference saturates
at the count-type maximum, count_processor.hpp:61-72; saturating at u32
here is exact for any count_bytes because the host clamps to count_max
after aggregation, like the chunked host path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32
FF = jnp.uint32(0xFFFFFFFF)


def _words_equal_next(ws):
    """(N-1,) mask: entry i equals entry i+1 across every word."""
    eq = ws[0][1:] == ws[0][:-1]
    for w in ws[1:]:
        eq = eq & (w[1:] == w[:-1])
    return eq


def _sat_add(a, b):
    """Saturating u32 add."""
    s = a + b
    return jnp.where(s < a, FF, s)


def merged_sorted_ops(streams):
    """Globally sorted (ws..., cnt) across R sorted pair runs.

    Each stream is (words tuple, cnt), ascending with all-ones sentinel
    word tails (cnt pads are 0). The runs are concatenated and re-sorted
    by ``lax.sort`` on the key words, carrying ``cnt`` as a value."""
    nw = len(streams[0][0])
    cat_w = tuple(jnp.concatenate([s[0][j] for s in streams])
                  for j in range(nw))
    cat_c = jnp.concatenate([s[1] for s in streams])
    with jax.named_scope("sort"):
        sorted_ops = jax.lax.sort(cat_w + (cat_c,), dimension=0,
                                  num_keys=nw)
    return sorted_ops[:nw], sorted_ops[nw]


def chunk_count_pairs(ws, pair_cap: int):
    """SORTED packed words -> unique (packed, count) pairs, compacted.

    ``ws``: tuple of sorted u32 word arrays (sentinel tail = invalid).
    Returns (pair_words tuple (pair_cap,), pair_cnt (pair_cap,) u32,
    n_pairs () i32). Pairs beyond pair_cap are DROPPED — callers check
    n_pairs and re-run the chunk with a bigger cap.
    """
    n = ws[0].shape[0]
    assert n < (1 << 31)
    valid = (ws[0] >> U32(31)) == 0
    eq = _words_equal_next(ws)
    head = jnp.ones((n,), dtype=bool).at[1:].set(~eq) & valid

    # run length per head: distance to the next head-or-invalid boundary
    # (a suffix min)
    idx = jax.lax.broadcasted_iota(I32, (n,), 0)
    mark = jnp.ones((n,), dtype=bool).at[1:].set(~eq) | ~valid
    bound = jnp.where(mark, idx, n)
    nxt = jnp.concatenate([bound[1:], jnp.full((1,), n, dtype=I32)])
    nxt = jax.lax.cummin(nxt, reverse=True)
    cnt = jnp.where(head, (nxt - idx).astype(U32), U32(0))

    # compact heads to the front: 1-key sort on (~head | position),
    # carrying the packed words + count as values (no gathers: carried
    # values ride the sort's existing passes)
    iota = jax.lax.broadcasted_iota(U32, (n,), 0)
    poskey = ((~head).astype(U32) << U32(31)) | iota
    sorted_ops = jax.lax.sort((poskey,) + tuple(ws) + (cnt,), dimension=0,
                              num_keys=1)
    take = min(pair_cap, n)
    kvalid = (sorted_ops[0][:take] >> U32(31)) == 0
    pair_words = tuple(
        _pad_to(jnp.where(kvalid, w[:take], FF), pair_cap, FF)
        for w in sorted_ops[1:-1])
    pair_cnt = _pad_to(jnp.where(kvalid, sorted_ops[-1][:take], U32(0)),
                       pair_cap, U32(0))
    n_pairs = jnp.sum(head.astype(I32))
    return pair_words, pair_cnt, n_pairs


def _pad_to(x, size: int, fill):
    if x.shape[0] == size:
        return x
    pad = jnp.full((size - x.shape[0],), fill, dtype=x.dtype)
    return jnp.concatenate([x, pad])


def run_sum_bounded(ws, cnt, R: int):
    """Per-run saturating total of ``cnt`` over equal-key runs of the
    merged sorted words ``ws``; runs have length <= R (entries come from
    R merged streams each with unique keys).

    Log-doubling (Hillis-Steele) with an explicit "no run boundary in
    (i, i+s]" mask that itself doubles (no full-width ``cumsum`` of run
    ids to compare). After step k, total[i] covers
    cnt[i .. min(i + 2^k - 1, run end)], so each run's FIRST entry ends
    with the whole run's sum. Returns (run_start bool, total)."""
    n = cnt.shape[0]
    eq_prev = jnp.zeros((n,), dtype=bool).at[1:].set(_words_equal_next(ws))
    # nc[i] = "i+1 continues i's run" = eq_prev[i + 1]
    nc = jnp.concatenate([eq_prev[1:], jnp.zeros((1,), dtype=bool)])
    total = cnt
    shift = 1
    while shift < R:
        fwd = jnp.concatenate([total[shift:],
                               jnp.zeros((shift,), dtype=total.dtype)])
        total = jnp.where(nc, _sat_add(total, fwd), total)
        shift *= 2
        if shift < R:     # extend the mask: nc_2s[i] = nc_s[i] & nc_s[i+s]
            half = shift // 2
            nc = nc & jnp.concatenate(
                [nc[half:], jnp.zeros((half,), dtype=bool)])
    return ~eq_prev, total


def merge_pair_streams(streams, out_cap: int):
    """Merge R sorted unique (packed, count) pair streams into one.

    ``streams``: list of (words tuple, cnt) — each sorted ascending with
    sentinel tails, unique keys WITHIN each stream. A key appearing in
    r <= R streams becomes one entry with the saturating sum of its
    counts. Returns (words tuple (out_cap,), cnt (out_cap,), n () i32).
    Entries beyond out_cap are dropped (callers check n).
    """
    R = len(streams)
    ws, cnt = merged_sorted_ops(streams)
    n = ws[0].shape[0]
    run_start, total = run_sum_bounded(ws, cnt, R)
    head = run_start & ((ws[0] >> U32(31)) == 0)
    summed = jnp.where(head, total, U32(0))

    # compact heads to the front (same carry-sort as chunk_count_pairs)
    iota = jax.lax.broadcasted_iota(U32, (n,), 0)
    poskey = ((~head).astype(U32) << U32(31)) | iota
    sorted2 = jax.lax.sort((poskey,) + tuple(ws) + (summed,), dimension=0,
                           num_keys=1)
    take = min(out_cap, n)
    kvalid = (sorted2[0][:take] >> U32(31)) == 0
    out_w = tuple(_pad_to(jnp.where(kvalid, w[:take], FF), out_cap, FF)
                  for w in sorted2[1:-1])
    out_c = _pad_to(jnp.where(kvalid, sorted2[-1][:take], U32(0)), out_cap,
                    U32(0))
    n_out = jnp.sum(head.astype(I32))
    return out_w, out_c, n_out
