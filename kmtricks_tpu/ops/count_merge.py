"""Fused device kernel: raw k-mer occurrences -> merged matrix rows.

Fuses the reference's per-sample counting (gatb/sorting_count.hpp sort+RLE +
count_processor.hpp hard-min/saturate) with the cross-sample merge + rescue
(merge.hpp:183-260) into ONE sort + segmented-scan program:

  sort (partition, key, sample) occurrence tuples
  -> (key, sample) run lengths           = per-sample counts
  -> hard-min filter                      (count_processor.hpp:61-72)
  -> per-key solid tally + rescue/zeroing (merge.hpp:234-247)
  -> per-sample statistics                (merge.hpp:49-100)

Everything is fixed-shape with validity masks; invalid/padded entries sort to
the end and never form segments. Compaction happens on host (or downstream).

Performance note: all per-segment quantities are computed with native
cumulative primitives (cumsum/cummax/cummin) instead of scatters
(``segment_sum`` with millions of segments) or large gathers; only the
tiny per-sample statistics use masked reductions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32


def _next_boundary(mark, idx, n):
    """First index strictly greater than i where ``mark`` holds (else n).

    Implemented with the native cumulative-min primitive (one fused
    pass, unlike generic associative_scan with custom operators)."""
    bound = jnp.where(mark, idx, n)
    nxt = jnp.concatenate([bound[1:], jnp.full((1,), n, dtype=I32)])
    return jax.lax.cummin(nxt, reverse=True)


def _seg_total(x, head):
    """Per-segment total of ``x`` broadcast to every member.

    Segments start at ``head`` positions (head[0] must be True). Uses the
    monotonicity of exclusive prefix sums: the running total at a position's
    segment START forward-fills with cummax, and the running total at its
    segment END back-fills with reverse cummin of head-anchored values.
    Only native cumsum/cummax/cummin primitives — no scatters, gathers or
    tuple scans.
    """
    n = x.shape[0]
    incl = jnp.cumsum(x.astype(I32))
    excl = incl - x.astype(I32)
    start_val = jax.lax.cummax(jnp.where(head, excl, 0))
    big = incl[-1] + 1
    anchored = jnp.where(head, excl, big)
    nxt_val = jnp.concatenate([anchored[1:], jnp.full((1,), big, dtype=I32)])
    end_val = jax.lax.cummin(nxt_val, reverse=True)
    end_val = jnp.where(end_val == big, incl[-1], end_val)
    return end_val - start_val


def _per_sample(value, samp, nsamp):
    """Per-sample totals. Masked reductions (no scatter) for small sample
    counts; segment_sum (tiny output, acceptable scatter) beyond that to
    bound compile size."""
    v = value.astype(U32)
    if nsamp <= 16:
        return jnp.stack([jnp.sum(jnp.where(samp == s, v, U32(0)))
                          for s in range(nsamp)])
    return jax.ops.segment_sum(v, samp, num_segments=nsamp)


def _samp_bits(nsamp: int) -> int:
    return max(1, (nsamp - 1).bit_length())


# ---------------------------------------------------------------------------
# Packed sort layouts. Each packs (valid, partition, key, sample) into the
# fewest u32 sort operands (fewer operands, less sort traffic) with
# all-ones sentinel for invalid entries — which is also the all_to_all
# padding sentinel, so routed buffers need no separate validity channel.
# ---------------------------------------------------------------------------

def packed_layout(nsamp: int, nw: int, part_follows_keys: bool,
                  key_bits: int | None,
                  part_bits: int | None = None) -> str | None:
    """Choose a packed sort layout: "h1" (hash, 1 word), "h2" (hash,
    2 words), "k2.<pb>.<kb>" (k-mer, 2 words — fits when
    1 + part_bits + 2k + samp_bits <= 64, i.e. k <= ~27 at typical
    partition/sample widths), "k3" (k-mer <= 32, 3 words),
    "kw.<pb>.<kb>.<nw>" (k-mer, wide keys — (valid|part|key|sample)
    left-justified in the fewest u32 words, e.g. 3 words for k <= 40
    vs the generic path's 6 operands), or None (generic path)."""
    sb = _samp_bits(nsamp)
    if part_follows_keys and key_bits is not None and nw == 2:
        if 1 + key_bits + sb <= 32:
            return "h1"
        if 1 + key_bits + sb <= 64:
            return "h2"
    if not part_follows_keys:
        if nw == 2:
            if (part_bits is not None and key_bits is not None
                    and 1 + part_bits + key_bits + sb <= 64):
                return f"k2.{part_bits}.{key_bits}"
            # k3's partition field is 16 bits — wider partition counts (or
            # an unknown width) must take the generic multi-operand path
            if sb <= 15 and part_bits is not None and part_bits <= 16:
                return "k3"
        # wide keys: beat the generic (part, keys..., sample) operand list
        # whenever the packed word count is smaller (sort cost scales with
        # operand count); part must sit entirely in word0 for the router
        if (part_bits is not None and key_bits is not None
                and part_bits <= 31):
            nwords = -(-(1 + part_bits + key_bits + sb) // 32)
            if nwords < 2 + nw:
                return f"kw.{part_bits}.{key_bits}.{nw}"
    return None


def _k2_params(layout: str, nsamp: int):
    """(part_bits, key_bits, left-shift) of a "k2.<pb>.<kb>" layout."""
    _, pb, kb = layout.split(".")
    pb, kb = int(pb), int(kb)
    shift = 64 - (1 + pb + kb + _samp_bits(nsamp))
    return pb, kb, shift


def _kw_params(layout: str, nsamp: int):
    """(part_bits, key_bits, key_words, packed_words, lsb_pad) of a
    "kw.<pb>.<kb>.<nw>" layout."""
    _, pb, kb, nw = layout.split(".")
    pb, kb, nw = int(pb), int(kb), int(nw)
    total = 1 + pb + kb + _samp_bits(nsamp)
    nwords = -(-total // 32)
    return pb, kb, nw, nwords, 32 * nwords - total


def _mw_fit(words, nwords: int):
    """Fit an msb-first u32 word tuple to exactly ``nwords`` words:
    zero-extend at the top, or drop top words (the caller guarantees any
    dropped words are zero — the packed value is bounded by the layout's
    field widths)."""
    if len(words) >= nwords:
        return tuple(words[len(words) - nwords:])
    z = jnp.zeros_like(words[0])
    return (z,) * (nwords - len(words)) + tuple(words)


def _mw_shl(words, s: int):
    """Constant left shift of an msb-first u32 word tuple (top overflow
    dropped, zeros shifted in)."""
    nwords = len(words)
    q, r = divmod(s, 32)
    z = jnp.zeros_like(words[0])

    def get(j):
        return words[j] if 0 <= j < nwords else z

    if r == 0:
        return tuple(get(i + q) for i in range(nwords))
    return tuple((get(i + q) << U32(r)) | (get(i + q + 1) >> U32(32 - r))
                 for i in range(nwords))


def _mw_shr(words, s: int):
    """Constant logical right shift of an msb-first u32 word tuple."""
    nwords = len(words)
    q, r = divmod(s, 32)
    z = jnp.zeros_like(words[0])

    def get(j):
        return words[j] if 0 <= j < nwords else z

    if r == 0:
        return tuple(get(i - q) for i in range(nwords))
    return tuple((get(i - q) >> U32(r)) | (get(i - q - 1) << U32(32 - r))
                 for i in range(nwords))


def pack_words(layout: str, part, keys, samp, valid, nsamp: int):
    """Pack occurrences into the layout's msb-first u32 sort words."""
    sb = _samp_bits(nsamp)
    s32 = samp.astype(U32) & U32((1 << sb) - 1)
    ff = U32(0xFFFFFFFF)
    if layout == "h1":
        w = (keys[1] << U32(sb)) | s32
        return (jnp.where(valid, w, ff),)
    if layout == "h2":
        from kmtricks_tpu.ops import u64 as U
        packed = U.shl64((keys[0], keys[1]), sb)
        return (jnp.where(valid, packed[0], ff),
                jnp.where(valid, packed[1] | s32, ff))
    if layout.startswith("k2."):
        from kmtricks_tpu.ops import u64 as U
        pb, kb, shift = _k2_params(layout, nsamp)
        v = U.or64(U.shl64((keys[0], keys[1]), sb),
                   (jnp.zeros_like(s32), s32))
        v = U.or64(v, U.shl64((jnp.zeros_like(s32), part.astype(U32)),
                              kb + sb))
        v = U.shl64(v, shift)
        return (jnp.where(valid, v[0], ff), jnp.where(valid, v[1], ff))
    if layout == "k3":
        p32 = part.astype(U32)
        w0 = (p32 << U32(15)) | (keys[0] >> U32(17))
        w1 = (keys[0] << U32(15)) | (keys[1] >> U32(17))
        w2 = (keys[1] << U32(15)) | s32
        return (jnp.where(valid, w0, ff), jnp.where(valid, w1, ff),
                jnp.where(valid, w2, ff))
    if layout.startswith("kw."):
        pb, kb, _nw, nwords, pad = _kw_params(layout, nsamp)
        key_w = _mw_shl(_mw_fit(keys, nwords), sb + pad)
        part_w = _mw_shl(_mw_fit((part.astype(U32),), nwords),
                         kb + sb + pad)
        samp_w = _mw_shl(_mw_fit((s32,), nwords), pad)
        return tuple(jnp.where(valid, kw | pw | sw, ff)
                     for kw, pw, sw in zip(key_w, part_w, samp_w))
    raise ValueError(layout)


def unpack_sorted(layout: str, ws, nsamp: int, key_bits, window_bits):
    """Sorted packed words -> (part_s, keys_s, samp_s, valid_s, occ_d, kd)."""
    sb = _samp_bits(nsamp)
    if layout == "h1":
        (w_s,) = ws
        valid_s = (w_s >> U32(31)) == 0
        samp_s = jnp.where(valid_s, w_s & U32((1 << sb) - 1), U32(0))
        klo = jnp.where(valid_s,
                        (w_s >> U32(sb)) & U32((1 << key_bits) - 1), U32(0))
        keys_s = (jnp.zeros_like(klo), klo)
        part_s = (klo // U32(window_bits)) if window_bits else \
            jnp.zeros_like(klo)
        occ_d = w_s[1:] != w_s[:-1]
        kd = (w_s[1:] >> U32(sb)) != (w_s[:-1] >> U32(sb))
        return part_s, keys_s, samp_s, valid_s, occ_d, kd
    if layout == "h2":
        from kmtricks_tpu.ops import u64 as U
        w0_s, w1_s = ws
        valid_s = (w0_s >> U32(31)) == 0
        samp_s = jnp.where(valid_s, w1_s & U32((1 << sb) - 1), U32(0))
        khi, klo = U.shr64((w0_s, w1_s), sb)
        mask_hi = U32((1 << max(key_bits - 32, 0)) - 1) if key_bits > 32 \
            else U32(0)
        khi = jnp.where(valid_s, khi & mask_hi, U32(0))
        klo = jnp.where(valid_s,
                        klo & (U32((1 << min(key_bits, 32)) - 1)
                               if key_bits < 32 else U32(0xFFFFFFFF)),
                        U32(0))
        keys_s = (khi, klo)
        if window_bits:
            q = U.mulhi64((khi, klo), U.const64(U.barrett_magic(
                window_bits)))
            r = U.sub64((khi, klo), U.mul64(q, U.const64(window_bits)))
            for _ in range(2):
                ge = ~U.lt64(r, U.const64(window_bits))
                q = (q[0], q[1] + ge.astype(U32))
                r = U.select64(ge, U.sub64(r, U.const64(window_bits)), r)
            part_s = q[1]
        else:
            part_s = jnp.zeros_like(klo)
        occ_d = (w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
        kd = ((khi[1:] != khi[:-1]) | (klo[1:] != klo[:-1])
              | (valid_s[1:] != valid_s[:-1]))
        return part_s, keys_s, samp_s, valid_s, occ_d, kd
    if layout.startswith("k2."):
        from kmtricks_tpu.ops import u64 as U
        pb, kb, shift = _k2_params(layout, nsamp)
        w0_s, w1_s = ws
        valid_s = (w0_s >> U32(31)) == 0
        v = U.shr64((w0_s, w1_s), shift)
        samp_s = jnp.where(valid_s, v[1] & U32((1 << sb) - 1), U32(0))
        khi, klo = U.shr64(v, sb)
        if kb > 32:
            khi = khi & U32((1 << (kb - 32)) - 1)
        else:
            khi = jnp.zeros_like(khi)
            klo = klo & U32((1 << kb) - 1)
        keys_s = (jnp.where(valid_s, khi, U32(0)),
                  jnp.where(valid_s, klo, U32(0)))
        part_s = jnp.where(valid_s, (w0_s >> U32(31 - pb))
                           & U32((1 << pb) - 1), U32(0))
        occ_d = (w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
        # key granularity: ignore the sample bits (and the zero padding
        # below them) — everything from bit sb+shift up
        t = sb + shift
        if t == 0:
            kd = occ_d
        elif t < 32:
            kd = ((w0_s[1:] != w0_s[:-1])
                  | ((w1_s[1:] >> U32(t)) != (w1_s[:-1] >> U32(t))))
        else:
            kd = (w0_s[1:] >> U32(t - 32)) != (w0_s[:-1] >> U32(t - 32))
        return part_s, keys_s, samp_s, valid_s, occ_d, kd
    if layout == "k3":
        w0_s, w1_s, w2_s = ws
        valid_s = (w0_s >> U32(31)) == 0
        m15 = U32(0x7FFF)
        part_s = jnp.where(valid_s, (w0_s >> U32(15)) & U32(0xFFFF), U32(0))
        k0 = ((w0_s & m15) << U32(17)) | (w1_s >> U32(15))
        k1 = ((w1_s & m15) << U32(17)) | (w2_s >> U32(15))
        keys_s = (jnp.where(valid_s, k0, U32(0)),
                  jnp.where(valid_s, k1, U32(0)))
        samp_s = jnp.where(valid_s, w2_s & U32((1 << sb) - 1), U32(0))
        occ_d = ((w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
                 | (w2_s[1:] != w2_s[:-1]))
        kd = ((w0_s[1:] != w0_s[:-1]) | (w1_s[1:] != w1_s[:-1])
              | ((w2_s[1:] >> U32(15)) != (w2_s[:-1] >> U32(15))))
        return part_s, keys_s, samp_s, valid_s, occ_d, kd
    if layout.startswith("kw."):
        pb, kb, nw, nwords, pad = _kw_params(layout, nsamp)
        valid_s = (ws[0] >> U32(31)) == 0
        part_s = jnp.where(valid_s, (ws[0] >> U32(31 - pb))
                           & U32((1 << pb) - 1), U32(0))
        # bits above the sample field: valid|part|key, key at the LSB end
        hi = _mw_shr(ws, sb + pad)
        kws = list(_mw_fit(hi, nw))
        for j in range(nw):
            b = kb - 32 * (nw - 1 - j)   # key bits available in word j
            if b <= 0:
                kws[j] = jnp.zeros_like(kws[j])
            elif b < 32:
                kws[j] = kws[j] & U32((1 << b) - 1)
        keys_s = tuple(jnp.where(valid_s, w, U32(0)) for w in kws)
        sv = _mw_shr(ws, pad)[-1] if pad else ws[-1]
        samp_s = jnp.where(valid_s, sv & U32((1 << sb) - 1), U32(0))
        occ_d = ws[0][1:] != ws[0][:-1]
        for w in ws[1:]:
            occ_d = occ_d | (w[1:] != w[:-1])
        kd = hi[0][1:] != hi[0][:-1]
        for w in hi[1:]:
            kd = kd | (w[1:] != w[:-1])
        return part_s, keys_s, samp_s, valid_s, occ_d, kd
    raise ValueError(layout)


@jax.named_scope("sort")
def sort_packed(layout: str, words):
    """Sort packed words (all operands are keys) with ``lax.sort``: XLA
    picks the GPU sort (a radix sort for one operand, its own
    multi-operand sort otherwise)."""
    return jax.lax.sort(words, dimension=0, num_keys=len(words))


def part_of_sorted(layout: str, ws, nsamp: int, window_bits):
    """Partition id of each sorted packed entry (cheap partial unpack,
    used by the router to derive destinations)."""
    sb = _samp_bits(nsamp)
    if layout == "h1":
        return ((ws[0] >> U32(sb)) // U32(window_bits)).astype(I32)
    if layout == "h2":
        from kmtricks_tpu.ops import u64 as U
        khi, klo = U.shr64((ws[0] & U32(0x7FFFFFFF), ws[1]), sb)
        q = U.mulhi64((khi, klo), U.const64(U.barrett_magic(window_bits)))
        r = U.sub64((khi, klo), U.mul64(q, U.const64(window_bits)))
        for _ in range(2):
            ge = ~U.lt64(r, U.const64(window_bits))
            q = (q[0], q[1] + ge.astype(U32))
            r = U.select64(ge, U.sub64(r, U.const64(window_bits)), r)
        return q[1].astype(I32)
    if layout.startswith("k2."):
        pb, _, _ = _k2_params(layout, nsamp)
        return ((ws[0] >> U32(31 - pb)) & U32((1 << pb) - 1)).astype(I32)
    if layout == "k3":
        return ((ws[0] >> U32(15)) & U32(0xFFFF)).astype(I32)
    if layout.startswith("kw."):
        pb = _kw_params(layout, nsamp)[0]
        return ((ws[0] >> U32(31 - pb)) & U32((1 << pb) - 1)).astype(I32)
    raise ValueError(layout)


@partial(jax.jit, static_argnames=("nsamp", "hard_min", "rmin", "save_if",
                                   "count_max", "with_stats",
                                   "part_follows_keys", "key_bits",
                                   "window_bits", "part_bits"))
def count_merge_keys(part, keys, samp, valid, amin_vec, *, nsamp: int,
                     hard_min: int, rmin: int, save_if: int,
                     count_max: int = 0xFFFFFFFF, with_stats: bool = True,
                     part_follows_keys: bool = False,
                     key_bits: int | None = None,
                     window_bits: int | None = None,
                     part_bits: int | None = None,
                     hard_min_vec=None):
    """Count and merge raw occurrences in one pass — variable key width.

    Parameters
    ----------
    part : (N,) int32 partition id of each occurrence
    keys : tuple of (N,) uint32 key words, MOST significant first (a packed
        canonical k-mer — 2 words for k <= 32, 4 for k <= 64 — or a window
        hash)
    samp : (N,) int32 sample ids in [0, nsamp)
    valid : (N,) bool padding mask
    amin_vec : (nsamp,) uint32 per-sample soft-min (merge abundance)
        thresholds

    Returns (all length N, sorted by (partition, key, sample), padding last)
    -------
    part_s : (N,) int32; keys_s : tuple like ``keys``; samp_s : (N,) int32
    final : (N,) uint32 post-hard-min, post-rescue-zeroing counts
            (meaningful at ``present`` positions)
    cnt : (N,) uint32 saturated pre-zeroing counts at ``present`` positions
          (what the per-sample .kmer/.hash files would contain)
    present : (N,) bool — (key, sample) run head that survived hard-min
    row_head : (N,) bool — first PRESENT entry of each distinct (part, key);
               keys entirely below hard-min produce no row (they never reach
               the reference's merge inputs)
    row_keep : (N,) bool at row_head positions — recurrence >= rmin verdict
    row_of : (N,) int32 — dense row index of each position's key
    stats : (6, nsamp) uint32 — NON_SOLID, RESCUED, UNIQUE_WO_RESCUE,
            UNIQUE_W_RESCUE, TOTAL_WO_RESCUE, TOTAL_W_RESCUE
    """
    n = keys[0].shape[0]
    nw = len(keys)
    inv = (~valid).astype(U32)
    top = U32(1 << 31)
    sb = _samp_bits(nsamp)
    # Packed fast path (hash mode): the window hash is bounded by
    # window_bits * nb_parts = 2^key_bits, so (valid | hash | sample) packs
    # into ONE u32 sort operand when 1 + key_bits + sb <= 32 (two when
    # <= 64) — fewer sort operands, less sort traffic — and the
    # partition is recomputed afterwards as hash // window_bits instead of
    # riding the sort.
    layout = packed_layout(nsamp, nw, part_follows_keys, key_bits,
                           part_bits)
    if layout is not None:
        words = pack_words(layout, part, keys, samp, valid, nsamp)
        ws = sort_packed(layout, words)
        part_s, keys_s, samp_s, valid_s, occ_d, kd = unpack_sorted(
            layout, ws, nsamp, key_bits, window_bits)
        return _segment_stage(
            part_s, keys_s, samp_s, valid_s, occ_d, kd, amin_vec,
            nsamp=nsamp, hard_min=hard_min, rmin=rmin, save_if=save_if,
            count_max=count_max, with_stats=with_stats,
            hard_min_vec=hard_min_vec)
    if part_follows_keys:
        # the key ordering already implies the partition ordering (window
        # hashes embed the partition, h = h%w + w*p), and the high key word
        # is < 2^31 (HashWindow bounds bloom_size below 2^63) — so the
        # validity bit folds into keys[0] and part rides as a sorted VALUE:
        # 3 sort operands instead of 5
        k0 = (inv * top) | keys[0]
        with jax.named_scope("sort"):
            sorted_ops = jax.lax.sort(
                (k0,) + tuple(keys[1:]) + (samp.astype(U32),
                                           part.astype(U32)),
                dimension=0, num_keys=1 + nw)
        k0_s = sorted_ops[0]
        keys_s = (k0_s & (top - U32(1)),) + sorted_ops[1:nw]
        samp_s = sorted_ops[nw]
        part_s = sorted_ops[1 + nw]
        valid_s = (k0_s & top) == 0
    else:
        # partition ids are u16 — fold the validity bit into the partition
        # operand (one fewer sort key)
        p0 = (inv * top) | part.astype(U32)
        with jax.named_scope("sort"):
            sorted_ops = jax.lax.sort(
                (p0,) + tuple(keys) + (samp.astype(U32),),
                dimension=0, num_keys=2 + nw)
        p0_s = sorted_ops[0]
        part_s = p0_s & (top - U32(1))
        keys_s = sorted_ops[1:1 + nw]
        samp_s = sorted_ops[1 + nw]
        valid_s = (p0_s & top) == 0
    kd = keys_s[0][1:] != keys_s[0][:-1]
    for w in keys_s[1:]:
        kd = kd | (w[1:] != w[:-1])
    if not part_follows_keys:
        kd = kd | (part_s[1:] != part_s[:-1])
    occ_d = kd | (samp_s[1:] != samp_s[:-1])
    return _segment_stage(
        part_s, keys_s, samp_s, valid_s, occ_d, kd, amin_vec,
        nsamp=nsamp, hard_min=hard_min, rmin=rmin, save_if=save_if,
        count_max=count_max, with_stats=with_stats,
        hard_min_vec=hard_min_vec)


def _per_position(vec_or_scalar, samp_i, nsamp, default_scalar):
    """Per-position threshold: a (nsamp,) vector gathered by sample id
    (select chain for small nsamp), or a broadcast scalar."""
    if vec_or_scalar is None:
        return jnp.full(samp_i.shape, default_scalar, dtype=U32)
    vec = jnp.asarray(vec_or_scalar, dtype=U32)
    if nsamp <= 16:
        out = jnp.zeros(samp_i.shape, dtype=U32)
        for s in range(nsamp):
            out = jnp.where(samp_i == s, vec[s], out)
        return out
    return vec[samp_i]


@jax.named_scope("segment_stage")
def _segment_stage(part_s, keys_s, samp_s, valid_s, occ_d, kd, amin_vec, *,
                   nsamp: int, hard_min: int, rmin: int, save_if: int,
                   count_max: int, with_stats: bool, hard_min_vec=None):
    """Post-sort segmented count+merge logic shared by every sort layout.

    ``occ_d`` / ``kd``: (N-1,) diffs of adjacent sorted entries at the
    (key, sample) occurrence / distinct-key granularity."""
    n = part_s.shape[0]
    samp_i = samp_s.astype(I32)

    ones = jnp.ones((n,), dtype=bool)
    key_diff = ones.at[1:].set(kd)
    occ_diff = ones.at[1:].set(occ_d | kd)

    amin_of = _per_position(amin_vec, samp_i, nsamp, 0)
    hmin_of = _per_position(hard_min_vec, samp_i, nsamp, hard_min)

    idx = jnp.arange(n, dtype=I32)
    occ_head = occ_diff & valid_s
    key_head = key_diff & valid_s

    # (key, sample) run length at occ heads: distance to the next
    # occurrence boundary (next occ head or first invalid entry)
    nxt_occ = _next_boundary(occ_diff | ~valid_s, idx, n)
    cnt_raw = jnp.where(occ_head, nxt_occ - idx, 0).astype(U32)
    present = occ_head & (cnt_raw >= hmin_of)   # count-stage hard-min
    cnt = jnp.minimum(cnt_raw, U32(count_max))  # saturating store

    # A matrix row exists only for keys present (post hard-min) in
    # >= 1 sample; its head is the FIRST present entry of the key.
    excl = jnp.cumsum(present.astype(I32)) - present.astype(I32)
    group_base = jax.lax.cummax(jnp.where(key_head, excl, 0))
    row_head = present & (excl == group_base)
    row_of = jnp.maximum(jnp.cumsum(row_head.astype(I32)) - 1, 0)

    solid = present & (cnt >= amin_of)

    # per-key solid count. Invalid tail entries merge into the final
    # key segment but contribute 0, so the totals stay correct.
    solid_in = _seg_total(solid, key_diff)

    if save_if > 0:
        rescued = present & ~solid & (solid_in >= save_if)
    else:
        rescued = jnp.zeros_like(solid)
    final = jnp.where(solid | rescued, cnt, U32(0))
    row_keep = row_head & (solid_in >= rmin)

    if with_stats:
        stats = jnp.stack([
            _per_sample(present & ~solid, samp_i, nsamp),   # NON_SOLID
            _per_sample(rescued, samp_i, nsamp),            # RESCUED
            _per_sample(solid, samp_i, nsamp),            # UNIQUE_WO_RESCUE
            _per_sample(solid | rescued, samp_i, nsamp),  # UNIQUE_W_RESCUE
            _per_sample(jnp.where(solid, cnt, U32(0)), samp_i,
                        nsamp),                           # TOTAL_WO_RESCUE
            _per_sample(final, samp_i, nsamp),            # TOTAL_W_RESCUE
        ])
    else:
        # callers that rebuild per-partition stats on host (the mesh
        # runtime) skip the device reductions
        stats = jnp.zeros((6, nsamp), dtype=U32)
    return (part_s.astype(I32), keys_s, samp_i, final, cnt,
            present, row_head, row_keep, row_of, stats)


@partial(jax.jit, static_argnames=("layout", "nsamp", "hard_min", "rmin",
                                   "save_if", "count_max", "with_stats",
                                   "key_bits", "window_bits", "sorted_runs"))
def count_merge_packed(words, amin_vec, *, layout: str, nsamp: int,
                       hard_min: int, rmin: int, save_if: int,
                       count_max: int = 0xFFFFFFFF,
                       with_stats: bool = True,
                       key_bits: int | None = None,
                       window_bits: int | None = None,
                       hard_min_vec=None,
                       sorted_runs: int | None = None):
    """count_merge_keys over ALREADY-PACKED sort words (the mesh path
    routes packed words through the all_to_all; sentinel-padded entries
    are the packed invalid encoding, so they need no separate mask).

    ``sorted_runs``: the words are a concatenation of this many ascending
    equal-length runs (the all_to_all delivers one sorted run per peer,
    sentinel-tail-padded). One run needs no re-ordering at all; more runs
    are re-sorted whole by ``sort_packed``."""
    if sorted_runs == 1:
        ws = tuple(words)
    else:
        ws = sort_packed(layout, tuple(words))
    part_s, keys_s, samp_s, valid_s, occ_d, kd = unpack_sorted(
        layout, ws, nsamp, key_bits, window_bits)
    return _segment_stage(
        part_s, keys_s, samp_s, valid_s, occ_d, kd, amin_vec,
        nsamp=nsamp, hard_min=hard_min, rmin=rmin, save_if=save_if,
        count_max=count_max, with_stats=with_stats,
        hard_min_vec=hard_min_vec)
