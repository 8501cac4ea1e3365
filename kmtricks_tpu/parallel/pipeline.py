"""Multi-chip SPMD pipeline: encode -> all_to_all shuffle -> count+merge.

The device replacement for the reference's filesystem-mediated
parallelism (SURVEY.md §2.5): where kmtricks routes superkmers to
per-partition FILES (gatb/fill_partitions.hpp) and later N-way-merges
per-sample files per partition (merge.hpp), we
 - shard read batches across devices (data parallelism over samples/reads),
 - route each (canonical k-mer | window hash, sample) occurrence to the
   device owning its partition with ONE ``jax.lax.all_to_all``
   (the minimizer shuffle — the all-to-all IS the per-partition file set),
 - run the fused count+merge segment kernel per device on its partitions
   (partitions are disjoint across devices, so no further collective),
 - ``psum`` the per-sample merge statistics across the mesh.

Everything is fixed-shape: each device sends at most ``cap`` occurrences to
each peer; overflow is counted and reported (``dropped``) so callers can
re-run with a bigger cap (the reference's PartiInfo pre-sizing plays the
same role, SURVEY.md §7.4).
"""

from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from kmtricks_tpu.ops.count_merge import (count_merge_keys,
                                          count_merge_packed,
                                          pack_words, packed_layout,
                                          part_of_sorted, sort_packed)
from kmtricks_tpu.ops.encode import encode_batch, encode_batch_wide
from kmtricks_tpu.ops.xxh64 import window_hash

U32 = jnp.uint32
I32 = jnp.int32
SENT = np.uint32(0xFFFFFFFF)   # sentinel sample id marking empty slots


def make_mesh(n_devices: int | None = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def partition_to_device(nb_parts: int, ndev: int) -> np.ndarray:
    """Contiguous block mapping partition -> owning device."""
    return (np.arange(nb_parts, dtype=np.int64) * ndev // nb_parts).astype(
        np.int32)


def _bucket_and_route(keys, samp, part, valid, dest, ndev: int, cap: int,
                      axis: str):
    """Scatter occurrences into per-destination fixed slots and all_to_all.

    ``keys`` is a tuple of u32 word arrays (msb-first). Returns received
    (keys, samp, part, valid) flat arrays of length ndev*cap plus the local
    dropped-occurrence count.
    """
    n = keys[0].shape[0]
    nw = len(keys)
    group = jnp.where(valid, dest, ndev)
    order = jnp.argsort(group, stable=True)
    group_s = group[order]
    counts = jnp.bincount(group, length=ndev + 1)
    starts = jnp.cumsum(counts) - counts
    pos = jnp.arange(n, dtype=I32) - starts[group_s].astype(I32)
    in_range = (group_s < ndev) & (pos < cap)
    slot = jnp.where(in_range, group_s * cap + pos, ndev * cap)
    dropped = jnp.sum((group_s < ndev) & (pos >= cap))

    payload = jnp.stack(list(keys) + [samp.astype(U32), part.astype(U32)],
                        axis=1)[order]
    buf = jnp.full((ndev * cap, nw + 2), SENT, dtype=U32)
    buf = buf.at[slot].set(payload, mode="drop")

    recv = jax.lax.all_to_all(buf.reshape(ndev, cap, nw + 2), axis,
                              split_axis=0, concat_axis=0, tiled=False)
    recv = recv.reshape(ndev * cap, nw + 2)
    r_samp = recv[:, nw]
    r_valid = r_samp != SENT
    r_part = jnp.where(r_valid, recv[:, nw + 1], U32(0)).astype(I32)
    r_samp = jnp.where(r_valid, r_samp, U32(0)).astype(I32)
    return (tuple(recv[:, i] for i in range(nw)), r_samp, r_part, r_valid,
            dropped)


def _route_sorted(layout: str, words, ndev: int, cap: int, axis: str,
                  nsamp: int, window_bits, nb_parts: int):
    """Sort-based shuffle: packed words sort by (valid | partition | key |
    sample), so destination devices (contiguous partition blocks) are
    contiguous runs of the LOCALLY SORTED array — routing is slicing, not
    scattering (the sort is already paid by the count kernel's algebra). The all-ones sentinel
    doubles as the packed invalid encoding, so receivers need no
    separate validity channel. Returns received packed words
    (ndev*cap each) + the local dropped count."""
    ws = sort_packed(layout, words)
    valid_s = (ws[0] >> U32(31)) == 0
    part_s = part_of_sorted(layout, ws, nsamp, window_bits)
    dest = jnp.where(valid_s, (part_s * ndev) // nb_parts, ndev)
    # dest is non-decreasing (the sort is partition-major, invalid last):
    # block boundaries via binary search instead of ndev full reductions
    bounds = jnp.searchsorted(dest, jnp.arange(ndev + 1, dtype=dest.dtype),
                              side="left").astype(I32)
    counts = bounds[1:] - bounds[:-1]
    starts = bounds[:-1]
    dropped = jnp.sum(jnp.maximum(counts - cap, 0))
    pos = jnp.arange(cap, dtype=I32)
    sent = jnp.full((cap,), SENT, dtype=U32)
    bufs = []
    for i, w in enumerate(ws):
        padded = jnp.concatenate([w, sent])
        rows = []
        for d in range(ndev):
            seg = jax.lax.dynamic_slice(padded, (starts[d],), (cap,))
            rows.append(jnp.where(pos < counts[d], seg, SENT))
        bufs.append(jnp.stack(rows))                   # (ndev, cap)
    buf = jnp.stack(bufs, axis=2)                      # (ndev, cap, nwords)
    recv = jax.lax.all_to_all(buf, axis, split_axis=0, concat_axis=0,
                              tiled=False)
    recv = recv.reshape(ndev * cap, len(ws))
    return tuple(recv[:, i] for i in range(len(ws))), dropped


def _encode_flat(batch, lengths, samp, repart_table, k: int, m: int,
                 mode: str, window_bits, encode_impl: str = "auto",
                 static_parts: int | None = None,
                 batch_layout: str = "bl",
                 mmer_canonical: bool = True):
    if isinstance(batch, tuple) and len(batch) == 2 \
            and batch[0].dtype == jnp.uint8:
        # 2-bit packed upload (0.375 B/base over the device link):
        # unpack to (codes, valid) once, then the shared encode runs.
        # vbits may be None (clean chunk): validity derives from lengths
        from kmtricks_tpu.ops.encode import unpack_2bit
        assert batch_layout == "lb"
        packed, vbits = batch
        batch = unpack_2bit(packed, vbits, packed.shape[0] * 4)
    """Shared encode stage -> flat (keys tuple, samp, part, valid)
    occurrences. Keys: 2 msb-first u32 words for k <= 32, 4 for k <= 64;
    in hash mode always the 2-word window hash.

    ``batch_layout``: "bl" = batch is (B, L); "lb" = (L, B) transposed
    (the flat occurrence order differs but everything downstream
    sorts)."""
    seq_axis = 1 if batch_layout == "bl" else 0
    if k > 32:
        keys, parts, valid = encode_batch_wide(
            batch, lengths, repart_table, k, m, static_parts=static_parts,
            seq_axis=seq_axis, mmer_canonical=mmer_canonical)
    else:
        hi, lo, parts, valid = encode_batch(batch, lengths, repart_table,
                                            k, m, static_parts=static_parts,
                                            seq_axis=seq_axis,
                                            mmer_canonical=mmer_canonical)
        keys = (hi, lo)
    keys = tuple(w.ravel() for w in keys)
    shape = parts.shape
    parts, valid = parts.ravel(), valid.ravel()
    samp_2d = samp[:, None] if seq_axis == 1 else samp[None, :]
    sampw = jnp.broadcast_to(samp_2d, shape).ravel()
    if mode == "hash":
        # hash the packed k-mer: little-endian u64 words (hi, lo) pairs
        from kmtricks_tpu.ops.u64 import msb_words_to_u64_pairs
        keys = window_hash(msb_words_to_u64_pairs(keys), parts, window_bits)
    return keys, sampw, parts, valid


def build_sharded_pipeline(mesh: Mesh, *, k: int, m: int, nb_parts: int,
                           cap: int, nsamp: int, hard_min: int = 1,
                           rmin: int = 1, save_if: int = 0,
                           mode: str = "kmer", window_bits: int | None = None,
                           count_max: int = 0xFFFFFFFF,
                           encode_impl: str = "auto",
                           static_repart: bool = False,
                           with_stats: bool = True,
                           hard_min_vec=None,
                           batch_layout: str = "bl",
                           mmer_canonical: bool = True,
                           compact_rows: int | None = None,
                           compact_pre_cap: int | None = None):
    """Build the jitted SPMD pipeline step over ``mesh``.

    The returned function takes GLOBAL arrays (batch axis divisible by the
    mesh size): ``step(batch (B,L) u8 — or (L,B) with batch_layout="lb",
    lengths (B,) i32, samp (B,) i32,
    repart_table (4^m,) i32, amin_vec (nsamp,) u32)`` and returns
    (part, hi, lo, samp, final, cnt, present, row_head, row_keep, stats, dropped)
    where the per-occurrence outputs are sharded by device (each device's
    slice covers its own partitions, sorted) and stats/dropped are global.

    With ``compact_rows`` (per-device row capacity), the step instead ends
    with device-side row compaction (ops/compact.py) and returns
    (rows (ndev*rc, nw [+1 part col in kmer mode]) u32,
    pre (ndev*rc, nsamp) u32 pre-merge counts, nrows (ndev,), maxc (),
    npres (ndev,), dropped ()) — the fetch-light path (only compacted
    rows leave the device); rescue/keep/stats are reconstructed on host
    from ``pre`` (host/ops.py merge_dense).
    """
    (axis,) = mesh.axis_names
    ndev = mesh.shape[axis]
    assert mode in ("kmer", "hash")
    if mode == "hash":
        assert window_bits is not None

    from kmtricks_tpu.ops.encode import device_key_words
    nw = 2 if mode == "hash" else device_key_words(k)
    key_bits = ((window_bits * nb_parts - 1).bit_length()
                if mode == "hash" else None)

    part_bits = (nb_parts - 1).bit_length()
    layout = packed_layout(
        nsamp, nw, mode == "hash",
        key_bits if mode == "hash" else 2 * k,
        part_bits if mode == "kmer" else None)

    def step(batch, lengths, samp, repart_table, amin_vec):
        keys, sampw, parts, valid = _encode_flat(
            batch, lengths, samp, repart_table, k, m, mode, window_bits,
            encode_impl, nb_parts if static_repart else None,
            batch_layout, mmer_canonical)
        hmv = (None if hard_min_vec is None
               else jnp.asarray(hard_min_vec, dtype=jnp.uint32))
        if layout is not None:
            # sort-based route: no scatter, packed words through the
            # all_to_all, receiver re-sorts its ndev sorted runs
            words = pack_words(layout, parts, keys, sampw, valid, nsamp)
            rwords, dropped = _route_sorted(
                layout, words, ndev, cap, axis, nsamp,
                window_bits if mode == "hash" else None, nb_parts)
            (part_s, keys_s, samp_s, final, cnt, present, key_head,
             row_keep, _row_of, stats) = count_merge_packed(
                rwords, amin_vec, layout=layout, nsamp=nsamp,
                hard_min=hard_min, rmin=rmin, save_if=save_if,
                count_max=count_max, with_stats=with_stats,
                key_bits=key_bits,
                window_bits=window_bits if mode == "hash" else None,
                hard_min_vec=hmv, sorted_runs=ndev)
        else:
            # contiguous-block partition->device map, computed
            # arithmetically (no table gather)
            dest = (parts * ndev) // nb_parts
            rkeys, rsamp, rpart, rvalid, dropped = _bucket_and_route(
                keys, sampw, parts, valid, dest, ndev, cap, axis)
            (part_s, keys_s, samp_s, final, cnt, present, key_head,
             row_keep, _row_of, stats) = count_merge_keys(
                rpart, rkeys, rsamp, rvalid, amin_vec, nsamp=nsamp,
                hard_min=hard_min, rmin=rmin, save_if=save_if,
                count_max=count_max, with_stats=with_stats,
                part_follows_keys=(mode == "hash"), key_bits=key_bits,
                window_bits=window_bits if mode == "hash" else None,
                hard_min_vec=hmv)
        dropped = jax.lax.psum(dropped, axis)
        if compact_rows is not None:
            from kmtricks_tpu.ops.compact import compact_count_rows
            rows, pre, nrows, maxc, npres = compact_count_rows(
                part_s, keys_s, samp_s, cnt, present, key_head,
                rows_cap=compact_rows, nsamp=nsamp,
                with_part=(mode == "kmer"),   # hash part = key // window
                pre_cap=compact_pre_cap)
            maxc = jax.lax.pmax(maxc, axis)
            return (rows, pre, nrows.reshape(1), maxc,
                    npres.reshape(1), dropped)
        stats = jax.lax.psum(stats, axis)
        return (part_s, keys_s, samp_s, final, cnt, present, key_head,
                row_keep, stats, dropped)

    sh = P(axis)
    rep = P()
    batch_spec = sh if batch_layout == "bl" else P(None, axis)
    if compact_rows is not None:
        out_specs = (sh, sh, sh, rep, sh, rep)
    else:
        out_specs = (sh, tuple(sh for _ in range(nw)), sh, sh, sh, sh, sh,
                     sh, rep, rep)
    # check_vma=False: outputs are byte-validated against the host path
    # in tests
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(batch_spec, sh, sh, rep, rep),
        out_specs=out_specs, check_vma=False))


def stream_layout(k: int, m: int, nb_parts: int, nsamp: int, mode: str,
                  window_bits: int | None) -> str | None:
    """Packed sort layout used by the streaming table engine (None = not
    packable; callers fall back to the host-aggregation chunked path)."""
    from kmtricks_tpu.ops.encode import device_key_words
    nw = 2 if mode == "hash" else device_key_words(k)
    key_bits = ((window_bits * nb_parts - 1).bit_length()
                if mode == "hash" else 2 * k)
    part_bits = (nb_parts - 1).bit_length()
    return packed_layout(nsamp, nw, mode == "hash", key_bits,
                         part_bits if mode == "kmer" else None)


@lru_cache(maxsize=64)   # keyed on (mesh, params): re-building a jit
# wrapper per pipeline run re-TRACES the whole graph (~0.5-1 s for the
# big streaming programs) even when the compile itself is cached
def build_chunk_pairs_step(mesh: Mesh, *, k: int, m: int, nb_parts: int,
                           cap: int, nsamp: int, mode: str = "kmer",
                           window_bits: int | None = None,
                           static_repart: bool = False,
                           batch_layout: str = "lb",
                           mmer_canonical: bool = True,
                           pair_cap: int = 1 << 20,
                           encode_impl: str = "auto",
                           packed_input: bool = False,
                           with_vbits: bool = True):
    """Streaming-engine chunk step: encode one read chunk, route packed
    occurrences over the mesh, and reduce each device's slice to sorted
    unique (packed word, count) pairs (ops/table.py).

    Returns step(batch, lengths, samp, repart_table) ->
    (pair_words tuple of (ndev*pair_cap,) u32, pair_cnt (ndev*pair_cap,),
    n_pairs (ndev,) i32, dropped () i32). Requires a packed layout
    (stream_layout(...) is not None).
    """
    (axis,) = mesh.axis_names
    ndev = mesh.shape[axis]
    assert mode in ("kmer", "hash")
    layout = stream_layout(k, m, nb_parts, nsamp, mode, window_bits)
    assert layout is not None, "streaming engine needs a packed layout"
    from kmtricks_tpu.ops.table import chunk_count_pairs

    def step(*args):
        if packed_input and not with_vbits:
            # clean chunk: no validity plane crossed the link — per-char
            # validity is all-True, window validity comes from lengths
            packed, lengths, samp, repart_table = args
            batch = (packed, None)
        elif packed_input:
            packed, vbits, lengths, samp, repart_table = args
            batch = (packed, vbits)
        else:
            batch, lengths, samp, repart_table = args
        keys, sampw, parts, valid = _encode_flat(
            batch, lengths, samp, repart_table, k, m, mode, window_bits,
            encode_impl, nb_parts if static_repart else None,
            batch_layout, mmer_canonical)
        words = pack_words(layout, parts, keys, sampw, valid, nsamp)
        if ndev == 1:
            ws = sort_packed(layout, words)
            dropped = jnp.int32(0)
        else:
            rwords, dropped = _route_sorted(
                layout, words, ndev, cap, axis, nsamp,
                window_bits if mode == "hash" else None, nb_parts)
            ws = sort_packed(layout, tuple(rwords))
            dropped = jax.lax.psum(dropped, axis)
        pw, pc, n_pairs = chunk_count_pairs(ws, pair_cap)
        # replicate the per-device pair counts (tiny): multi-process
        # hosts can then device_get them without owning every shard
        return pw, pc, jax.lax.all_gather(n_pairs, axis), dropped

    sh = P(axis)
    rep = P()
    batch_spec = sh if batch_layout == "bl" else P(None, axis)
    nw_packed = _layout_words(layout, nsamp)
    if packed_input and not with_vbits:
        in_specs = (batch_spec, sh, sh, rep)
    elif packed_input:
        in_specs = (batch_spec, batch_spec, sh, sh, rep)
    else:
        in_specs = (batch_spec, sh, sh, rep)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=in_specs,
        out_specs=(tuple(sh for _ in range(nw_packed)), sh, rep, rep),
        check_vma=False))


def _layout_words(layout: str, nsamp: int) -> int:
    if layout == "h1":
        return 1
    if layout == "h2" or layout.startswith("k2."):
        return 2
    if layout == "k3":
        return 3
    if layout.startswith("kw."):
        from kmtricks_tpu.ops.count_merge import _kw_params
        return _kw_params(layout, nsamp)[3]
    raise ValueError(layout)


@lru_cache(maxsize=64)   # keyed on (mesh, params): re-building a jit
# wrapper per pipeline run re-TRACES the whole graph (~0.5-1 s for the
# big streaming programs) even when the compile itself is cached
def build_table_merge(mesh: Mesh, *, nw: int, out_cap: int, n_streams: int,
                      in_caps: tuple):
    """Merge ``n_streams`` per-device sorted pair streams (first is the
    table, shapes ndev*in_caps[i]) into a new per-device table
    (ndev*out_cap). Returns (words tuple, cnt, n (ndev,))."""
    (axis,) = mesh.axis_names
    from kmtricks_tpu.ops.table import merge_pair_streams

    def step(*flat):
        streams = []
        i = 0
        for _ in range(n_streams):
            streams.append((tuple(flat[i:i + nw]), flat[i + nw]))
            i += nw + 1
        ws, cnt, n = merge_pair_streams(streams, out_cap)
        return ws, cnt, jax.lax.all_gather(n, axis)

    sh = P(axis)
    n_args = n_streams * (nw + 1)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=tuple(sh for _ in range(n_args)),
        out_specs=(tuple(sh for _ in range(nw)), sh, P()),
        check_vma=False))


@lru_cache(maxsize=64)   # keyed on (mesh, params): re-building a jit
# wrapper per pipeline run re-TRACES the whole graph (~0.5-1 s for the
# big streaming programs) even when the compile itself is cached
def build_table_sort_collapse(mesh: Mesh, *, layout: str, nsamp: int,
                              hard_min: int, n_runs: int,
                              key_bits: int | None = None,
                              window_bits: int | None = None,
                              nb_parts: int | None = None):
    """Phase A of the table finalize: concatenate ``n_runs`` per-device
    pair runs, sort, collapse duplicate (key, sample) entries (a pair
    split across chunk runs sums here — suffix-sum doubling over at most
    n_runs duplicates; later duplicates become count-0 shadows), and
    count the EXACT distinct rows (keys present in >= 1 sample at
    ``hard_min``) so phase B sizes its buffers without retries. Returns
    step(w0...,cnt0, ...) -> (ws tuple, cnt, nrows (ndev,), maxc ()).
    With ``nb_parts`` set, also emits the per-partition row histogram
    (ndev*nb_parts,) — phase A then carries EVERYTHING the host needs to
    size and slice the fetch, so phase B's outputs never require a
    host round-trip and the fetch overlaps phase B's compute."""
    (axis,) = mesh.axis_names
    from kmtricks_tpu.ops.count_merge import unpack_sorted
    from kmtricks_tpu.ops.table import _sat_add, _words_equal_next
    nw = _layout_words(layout, nsamp)

    def step(*flat):
        runs = []
        for i in range(n_runs):
            base = i * (nw + 1)
            runs.append((flat[base:base + nw], flat[base + nw]))
        if n_runs == 1:
            ws, cnt = tuple(runs[0][0]), runs[0][1]
        else:
            from kmtricks_tpu.ops.table import (merged_sorted_ops,
                                                run_sum_bounded)
            ws, cnt = merged_sorted_ops(runs)
            run_start, total = run_sum_bounded(ws, cnt, n_runs)
            cnt = jnp.where(run_start, total, U32(0))
        present, row_head, _key_head = _table_presence(
            layout, ws, cnt, nsamp, hard_min, key_bits, window_bits)
        nrows = jnp.sum(row_head.astype(I32))
        maxc = jax.lax.pmax(
            jnp.max(jnp.where(present, cnt, U32(0))), axis)
        nrows_g = jax.lax.all_gather(nrows, axis)
        if nb_parts is None:
            return ws, cnt, nrows_g, maxc
        ups = unpack_sorted(layout, ws, nsamp, key_bits, window_bits)
        phist = _sorted_part_hist(ups[0], ups[3], row_head, nb_parts)
        return ws, cnt, nrows_g, maxc, jax.lax.all_gather(phist, axis)

    sh = P(axis)
    outs = (tuple(sh for _ in range(nw)), sh, P(), P())
    if nb_parts is not None:
        outs = outs + (P(),)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=tuple(sh for _ in range(n_runs * (nw + 1))),
        out_specs=outs,
        check_vma=False))


def _sorted_part_hist(part_s, valid_s, row_head, nb_parts: int):
    """Per-partition row-head counts over entries SORTED by partition.

    Partitions are contiguous runs of the sort order, so boundary
    searchsorted + a row-head cumsum replace a full-width scatter-add
    (scripts/profile_phase_a_parts.py times both). unpack_sorted
    zeroes the part field of sentinel entries — they sort to the TAIL,
    so clamping them to ``nb_parts`` restores monotonicity (they carry
    row_head=False either way)."""
    part_m = jnp.where(valid_s, part_s.astype(U32), U32(nb_parts))
    cum = jnp.cumsum(row_head.astype(I32))
    q = jnp.arange(0, nb_parts + 1, dtype=U32)
    b = jnp.searchsorted(part_m, q, side="left")
    cum_at = jnp.where(b > 0, cum[jnp.maximum(b - 1, 0)], I32(0))
    return cum_at[1:] - cum_at[:-1]


def _table_presence(layout, ws, cnt, nsamp, hard_min, key_bits,
                    window_bits):
    """Presence + row-head masks over a sorted collapsed table."""
    from kmtricks_tpu.ops.count_merge import unpack_sorted
    _p, _k, _s, valid_s, _occ, kd = unpack_sorted(layout, ws, nsamp,
                                                  key_bits, window_bits)
    n = cnt.shape[0]
    present = valid_s & (cnt >= U32(hard_min))
    key_diff = jnp.ones((n,), dtype=bool).at[1:].set(kd)
    key_head = key_diff & valid_s
    excl = jnp.cumsum(present.astype(I32)) - present.astype(I32)
    group_base = jax.lax.cummax(jnp.where(key_head, excl, 0))
    row_head = present & (excl == group_base)
    return present, row_head, key_head


@lru_cache(maxsize=64)   # keyed on (mesh, params): re-building a jit
# wrapper per pipeline run re-TRACES the whole graph (~0.5-1 s for the
# big streaming programs) even when the compile itself is cached
def build_table_compact(mesh: Mesh, *, layout: str, nsamp: int,
                        key_bits: int | None, window_bits: int | None,
                        hard_min: int, rows_cap: int, mode: str,
                        nb_parts: int | None = None):
    """Phase B: dense compaction of the sorted collapsed table at the
    EXACT row capacity phase A reported. Per-sample hard-min refinement
    and count_max clamping happen on host, matching the host chunked
    path. Returns step(ws..., cnt) -> (rows, pre, nrows (ndev,),
    maxc (), npres (ndev,)[, part_rows (ndev*nb_parts,)]). The per-
    partition row histogram lets the host pipeline per-partition fetches
    against merge work without first fetching the key columns."""
    (axis,) = mesh.axis_names
    from kmtricks_tpu.ops.compact import compact_count_rows
    from kmtricks_tpu.ops.count_merge import unpack_sorted
    nw = _layout_words(layout, nsamp)

    def step(*flat):
        ws, cnt = tuple(flat[:-1]), flat[-1]
        part_s, keys_s, samp_s, valid_s, _occ_d, kd = unpack_sorted(
            layout, ws, nsamp, key_bits, window_bits)
        present, row_head, _ = _table_presence(
            layout, ws, cnt, nsamp, hard_min, key_bits, window_bits)
        rows, pre, nrows, maxc, npres = compact_count_rows(
            part_s, keys_s, samp_s, cnt, present, row_head,
            rows_cap=rows_cap, nsamp=nsamp, with_part=(mode == "kmer"))
        maxc = jax.lax.pmax(maxc, axis)
        out = (rows, pre, nrows.reshape(1), maxc, npres.reshape(1))
        if nb_parts is not None:
            out = out + (_sorted_part_hist(part_s, valid_s, row_head,
                                           nb_parts),)
        return out

    sh = P(axis)
    outs = (sh, sh, sh, P(), sh)
    if nb_parts is not None:
        outs = outs + (sh,)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=tuple(sh for _ in range(nw + 1)),
        out_specs=outs,
        check_vma=False))


def shape_bucket(n: int) -> int:
    """Round ``n`` up to 8 buckets per octave (step = 2^(b-3) of its
    power-of-two ceiling: 700 -> 768, 1000 -> 1024, 5000 -> 5120).

    Program shapes quantized this way repeat across nearby runs (every
    fresh shape is a fresh compile) at <= 1/8 padding overhead.
    Rounding never crosses the next power of two, so bit-width-derived
    quantities (samp_bits, packed layouts) are bucket-stable."""
    b = max(1, (n - 1).bit_length())
    step = 1 << max(0, b - 3)
    return -(-n // step) * step


@lru_cache(maxsize=64)
def build_rows_narrow(mesh: Mesh):
    """Split compacted kmer-mode rows into (key words u32, partition u8)
    on device: the partition id occupies a full u32 column of every
    fetched row (12 -> 9 B/row at k <= 32)."""
    (axis,) = mesh.axis_names
    return jax.jit(jax.shard_map(
        lambda a: (a[:, :-1], a[:, -1].astype(jnp.uint8)),
        mesh=mesh, in_specs=P(axis), out_specs=(P(axis), P(axis)),
        check_vma=False))


@lru_cache(maxsize=64)
def build_col_slice(mesh: Mesh, ncols: int):
    """Per-device column slice ``a[:, :ncols]`` — strips the padded
    sample columns of a shape-bucketed dense matrix BEFORE it rides the
    device link (fetching a 1024-bucket matrix for 700 real samples
    would cost ~46% extra link bytes). Compiles per (shape, ncols) but
    is a trivial program — the expensive engine programs stay at the
    bucketed shape."""
    (axis,) = mesh.axis_names
    return jax.jit(jax.shard_map(
        lambda a: a[:, :ncols], mesh=mesh, in_specs=P(axis),
        out_specs=P(axis), check_vma=False))


@lru_cache(maxsize=64)
def build_merge_finalize_bits(mesh: Mesh, *, nsamp: int, rows_cap: int,
                              rmin: int, save_if: int, count_max: int,
                              nb_parts: int, count_bytes: int):
    """Device merge finalize for presence/absence outputs: the exact
    merge.hpp:183-260 semantics (per-sample hard-min, soft-min/solid,
    rescue via share_min, recurrence keep) evaluated ON DEVICE over the
    dense pre-merge count matrix, emitting

      - packed pa bit rows (rows_cap, ceil(nsamp/8)) u8, LSB-first per
        byte (utils.hpp BITSET order — byte-compatible with
        io.formats.pack_pa_bits),
      - keep flags (rows_cap,) u8 (recurrence >= rmin),
      - per-(partition, sample) merge statistics, exact in u32 planes:
        4 count-stat planes (non_solid, rescued, uniq_wo, uniq_w) and
        2*count_bytes value-stat byte planes (total_wo, total_rescued;
        total_w = total_wo + total_rescued) — byte planes keep every
        segment sum < 2^32 for rows_cap <= 2^24.

    Per-partition segmentation uses the caller-provided row bounds
    (cumulated phase-A histogram): partitions are contiguous row runs,
    so a column cumsum + two boundary gathers replaces any scatter.

    This collapses the many-sample host tail (a rows x nsamp dense
    matrix fetch + 6 host passes — ~20 s at 100k x 1000) to a
    bits-plus-stats fetch ~30x smaller (the
    reference's merge streams N files without materializing N columns,
    merge.hpp:102-361)."""
    (axis,) = mesh.axis_names
    nb8 = (nsamp + 7) // 8
    pad = nb8 * 8 - nsamp

    def step(pre, amin, hmv, bounds):
        present = pre >= jnp.maximum(hmv, U32(1))[None, :]
        sat = jnp.minimum(pre, U32(count_max))
        solid = present & (sat >= amin[None, :])
        solid_in = solid.sum(axis=1, dtype=I32)
        keep = (solid_in >= rmin).astype(jnp.uint8)
        if save_if > 0:
            rescued = present & ~solid & (solid_in >= save_if)[:, None]
        else:
            rescued = jnp.zeros_like(solid)
        finalb = solid | rescued

        fb = finalb
        if pad:
            fb = jnp.concatenate(
                [fb, jnp.zeros((rows_cap, pad), dtype=bool)], axis=1)
        w8 = (U32(1) << jnp.arange(8, dtype=U32))[None, None, :]
        packed = (fb.reshape(rows_cap, nb8, 8).astype(U32)
                  * w8).sum(axis=2).astype(jnp.uint8)

        def seg(valmat):
            # contiguous-partition segment sums: cumsum + boundary gather
            c = jnp.cumsum(valmat.astype(U32), axis=0)
            cz = jnp.concatenate(
                [jnp.zeros((1, nsamp), U32), c], axis=0)
            return cz[bounds[1:]] - cz[bounds[:-1]]

        # save_if == 0: rescued is a constant zero matrix — emitting its
        # segment sums as literal zeros avoids XLA constant-folding five
        # (rows_cap x nsamp) cumsums at compile time (minutes at 5000
        # samples)
        zseg = jnp.zeros((nb_parts, nsamp), U32)
        planes = [seg(present & ~solid),
                  seg(rescued) if save_if > 0 else zseg,
                  seg(solid),
                  seg(finalb) if save_if > 0 else seg(solid)]
        for shift in range(0, 8 * count_bytes, 8):
            planes.append(seg(jnp.where(
                solid, (sat >> U32(shift)) & U32(0xFF), U32(0))))
        for shift in range(0, 8 * count_bytes, 8):
            planes.append(seg(jnp.where(
                rescued, (sat >> U32(shift)) & U32(0xFF), U32(0)))
                if save_if > 0 else zseg)
        return packed, keep, jnp.stack(planes)

    sh = P(axis)
    rep = P()
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(sh, rep, rep, sh),
        out_specs=(sh, sh, sh),
        check_vma=False))


def build_single_chip_step(*, k: int, m: int, nsamp: int, hard_min: int = 1,
                           rmin: int = 1, save_if: int = 0,
                           mode: str = "kmer", window_bits: int | None = None,
                           count_max: int = 0xFFFFFFFF,
                           encode_impl: str = "auto",
                           static_repart_parts: int | None = None,
                           nb_parts: int | None = None,
                           with_stats: bool = True,
                           batch_layout: str = "bl",
                           mmer_canonical: bool = True,
                           compact_rows: int | None = None,
                           compact_pre_cap: int | None = None):
    """Single-device fused forward step (no collectives): encode -> hash ->
    sort -> count+merge. Jittable; used by ``__graft_entry__.entry`` and the
    benchmark. ``batch_layout="lb"`` takes the batch transposed (L, B).

    With ``compact_rows``, ends with device-side row compaction and
    returns (rows, pre, nrows, maxc, npres) — see ops/compact.py."""
    assert mode in ("kmer", "hash")
    known_parts = nb_parts or static_repart_parts
    key_bits = ((window_bits * known_parts - 1).bit_length()
                if (mode == "hash" and known_parts) else None)

    def step(batch, lengths, samp, repart_table, amin_vec):
        keys, sampw, parts, valid = _encode_flat(
            batch, lengths, samp, repart_table, k, m, mode, window_bits,
            encode_impl, static_repart_parts, batch_layout,
            mmer_canonical)
        out = count_merge_keys(
            parts, keys, sampw, valid, amin_vec, nsamp=nsamp,
            hard_min=hard_min, rmin=rmin, save_if=save_if,
            count_max=count_max, with_stats=with_stats,
            part_follows_keys=(mode == "hash"),
            key_bits=key_bits if mode == "hash" else 2 * k,
            window_bits=window_bits if mode == "hash" else None,
            part_bits=(((known_parts - 1).bit_length())
                       if (mode == "kmer" and known_parts) else None))
        if compact_rows is not None:
            from kmtricks_tpu.ops.compact import compact_count_rows
            (part_s, keys_s, samp_s, final, cnt, present, row_head,
             row_keep, _row_of, _stats) = out
            return compact_count_rows(
                part_s, keys_s, samp_s, cnt, present, row_head,
                rows_cap=compact_rows, nsamp=nsamp,
                with_part=(mode == "kmer"), pre_cap=compact_pre_cap)
        return out

    return step
