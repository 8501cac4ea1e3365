"""Device-side row compaction: full-N kernel outputs -> dense count rows.

The fused count+merge kernel (ops/count_merge.py) returns N-sized sorted
occurrence arrays with validity masks. Fetching those to host costs
N * ~40 bytes over the device link — orders of magnitude more than the
information content (the distinct rows). This module compacts ON DEVICE to
the minimum the host needs (the reference streams the same compact rows
straight out of its merge loop, merge.hpp:262-316):

  - ``rows`` (rows_cap, nw+1) u32 — each distinct key's words plus its
    partition id, scattered in ONE multi-column pass
  - ``pre``  (rows_cap, nsamp) u32 — dense PRE-merge saturated counts
    (what the per-sample .kmer/.hash files would contain)
  - ``nrows`` () i32, ``maxc`` () u32 — actual row count (callers re-run
    with a bigger ``rows_cap`` if nrows > rows_cap) and the max count
    (hosts fetch the matrices as u8/u16 when everything fits)

Everything else — rescue zeroing, recurrence keep verdicts, per-partition
merge statistics — is EXACTLY reconstructible from ``pre`` alone
(host/ops.py merge_dense): solid = pre >= amin, a zero cell = absent
(present cells always hold count >= 1). Keeping those off the device
removes ~9 full-N scatter passes from the step.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32


def compact_count_rows(part_s, keys_s, samp_s, cnt, present, row_head, *,
                       rows_cap: int, nsamp: int, with_part: bool = True,
                       pre_cap: int | None = None):
    """Compact one device's sorted count output to dense rows (see module
    docstring). Inputs are count_merge_* outputs; jit-traceable.

    Returns (rows (rows_cap, nw [+1 if with_part]) u32, pre
    (rows_cap, nsamp) u32, nrows () i32, maxc () u32, npres () i32).
    ``with_part=False`` skips the partition column (hash mode:
    part = key // window_bits is host-computable). ``pre_cap`` bounds the
    intermediate compacted present stream (defaults to rows_cap * nsamp,
    never needed larger); callers re-run with bigger caps if
    nrows > rows_cap or npres > pre_cap.

    Implementation: rather than a direct scatter of all N occurrences
    (and a multi-column row scatter), the present entries are COMPACTED FIRST with a 3-operand sort
    keyed on ((~present) << 31 | position) — present positions come out
    first, in order, with (count, head|sample) carried as values — and
    the dense matrix is scattered from the ~density-times-smaller stream.
    """
    n = part_s.shape[0]
    assert n < (1 << 31), "position packing needs n < 2^31"
    if pre_cap is None:
        pre_cap = min(n, rows_cap * nsamp)
    pre_cap = min(pre_cap, n)
    samp_i = samp_s.astype(U32)
    present = present.astype(bool)
    row_head = row_head.astype(bool)

    iota = jax.lax.broadcasted_iota(U32, (n,), 0)
    poskey = ((~present).astype(U32) << U32(31)) | iota
    hs = (row_head.astype(U32) << U32(31)) | samp_i
    ks, cnt_c, hs_c = jax.lax.sort((poskey, cnt.astype(U32), hs),
                                   dimension=0, num_keys=1)
    ks, cnt_c, hs_c = ks[:pre_cap], cnt_c[:pre_cap], hs_c[:pre_cap]
    pvalid = (ks >> U32(31)) == 0          # tail = non-present positions
    pos_p = (ks & U32(0x7FFFFFFF)).astype(I32)
    head_c = ((hs_c >> U32(31)) == 1) & pvalid
    samp_c = (hs_c & U32(0x7FFFFFFF)).astype(I32)

    # row index of each present entry: heads are the first present entry
    # of their row and present entries stay in (part, key, sample) order
    row_c = jnp.cumsum(head_c.astype(I32)) - 1
    oob_flat = rows_cap * nsamp
    flat = jnp.where(pvalid & (row_c >= 0) & (row_c < rows_cap),
                     row_c * nsamp + samp_c, oob_flat)
    pre = jnp.zeros((rows_cap * nsamp,), dtype=U32).at[flat].set(
        cnt_c, mode="drop").reshape(rows_cap, nsamp)

    # head ORIGINAL positions, ascending: second (tiny) compaction sort
    iota2 = jax.lax.broadcasted_iota(U32, (pre_cap,), 0)
    hkey = ((~head_c).astype(U32) << U32(31)) | iota2
    hkey_s, hpos = jax.lax.sort((hkey, pos_p), dimension=0, num_keys=1)
    take = min(rows_cap, pre_cap)
    hvalid = jnp.zeros((rows_cap,), dtype=bool).at[:take].set(
        (hkey_s[:take] >> U32(31)) == 0)
    hpos = jnp.zeros((rows_cap,), dtype=hpos.dtype).at[:take].set(
        hpos[:take])
    safe = jnp.where(hvalid, hpos, 0)
    cols = [jnp.where(hvalid, w[safe].astype(U32), U32(0))
            for w in keys_s]
    if with_part:
        cols.append(jnp.where(hvalid, part_s[safe].astype(U32), U32(0)))
    rows = jnp.stack(cols, axis=1)

    nrows = jnp.sum(row_head.astype(I32))
    npres = jnp.sum(present.astype(I32))
    maxc = jnp.max(jnp.where(present, cnt.astype(U32), U32(0)))
    return rows, pre, nrows, maxc, npres


# --- host-side fetch helpers -------------------------------------------

_TILE = 1 << 17


@partial(jax.jit, static_argnames=("tile",))
def _slice_rows_u8(a, start, tile: int = _TILE):
    return jax.lax.dynamic_slice_in_dim(a, start, tile).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("tile",))
def _slice_rows_u16(a, start, tile: int = _TILE):
    return jax.lax.dynamic_slice_in_dim(a, start, tile).astype(jnp.uint16)


@partial(jax.jit, static_argnames=("tile",))
def _slice_rows(a, start, tile: int = _TILE):
    return jax.lax.dynamic_slice_in_dim(a, start, tile)


def _pick_tile(nrows: int) -> int:
    """Tile size balancing dispatch round-trips (~4 tiles) against the
    final tile's overfetch; power of two for compile-cache hits."""
    t = 1 << max(0, (max(1, nrows // 4) - 1).bit_length())
    return max(1 << 16, min(_TILE, t))


def _prepare_fetch(arr, nrows: int, cast: str | None,
                   tile: int | None, offset: int):
    """Dispatch the tile slices + async host copies for one array; return
    a thunk that materializes the numpy result."""
    import numpy as np

    if nrows <= 0:
        shape = (0,) + arr.shape[1:]
        dt = {"u8": np.uint8, "u16": np.uint16}.get(cast, arr.dtype)
        return lambda: np.zeros(shape, dtype=dt)
    n = arr.shape[0]
    nrows = min(nrows, n - offset)
    tile = min(tile or _pick_tile(nrows), n)
    fn = {"u8": _slice_rows_u8, "u16": _slice_rows_u16}.get(
        cast, _slice_rows)
    tiles = []
    for s in range(offset, offset + nrows, tile):
        start = min(s, max(0, n - tile))   # clamp: final tile overlaps
        tiles.append((start, fn(arr, start, tile)))
    for _, td in tiles:
        td.copy_to_host_async()

    def materialize():
        out = []
        prev_end = offset
        for start, td in tiles:
            h = np.asarray(td)
            out.append(h[prev_end - start:])
            prev_end = start + tile
        res = np.concatenate(out, axis=0) if len(out) > 1 else out[0]
        return res[:nrows]
    return materialize


def fetch_rows(arr, nrows: int, cast: str | None = None,
               tile: int | None = None, offset: int = 0):
    """Fetch ``arr[offset:offset+nrows]`` over the device link in
    fixed-shape tiles.

    Tiles are dispatched and ``copy_to_host_async()``'d up front so the
    link streams continuously (each blocking device_get would otherwise
    pay a round-trip of latency); the tile slice compiles ONCE per array
    shape (dynamic_slice start is a traced scalar). ``cast``: "u8"/"u16"
    narrow the payload before it rides the link (callers check ``maxc``).
    """
    return _prepare_fetch(arr, nrows, cast, tile, offset)()


def fetch_many(specs):
    """Fetch several arrays with ALL tile copies in flight together —
    one call per (arr, nrows, cast, offset) spec, returning the arrays in
    order. Avoids serializing each array's final round-trip behind the
    previous array's materialization."""
    thunks = [_prepare_fetch(arr, nrows, cast, None, offset)
              for arr, nrows, cast, offset in specs]
    return [t() for t in thunks]


def narrow_cast(maxc: int) -> str | None:
    """Smallest fetch cast that holds ``maxc``."""
    return "u8" if maxc <= 0xFF else ("u16" if maxc <= 0xFFFF else None)


def fetch_matrix(mat_dev, nrows: int, maxc: int, offset: int = 0,
                 tile: int | None = None):
    """Fetch a dense count-matrix block, narrowed to the smallest dtype
    that holds ``maxc`` (the device returns the max count as a scalar so
    the link never carries u32 zeros for u8 data). The NARROW dtype is
    returned as-is — widening a 1000-sample dense matrix costs seconds
    of host time and 4x the RSS, and merge_dense is dtype-aware."""
    return fetch_rows(mat_dev, nrows, cast=narrow_cast(maxc),
                      offset=offset, tile=tile)
