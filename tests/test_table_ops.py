"""Device count tables (ops/table.py): pair extraction + stream merging
against a numpy reference."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from kmtricks_tpu.ops.table import chunk_count_pairs, merge_pair_streams

FF = np.uint32(0xFFFFFFFF)


def pack2(vals64):
    """u64 -> 2 msb-first u32 words."""
    v = np.asarray(vals64, dtype=np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), \
        (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def ref_pairs(vals):
    u, c = np.unique(vals, return_counts=True)
    return u, c.astype(np.uint32)


@pytest.mark.parametrize("n,npad", [(4096, 0), (4096, 777), (256, 255)])
def test_chunk_count_pairs(n, npad):
    rng = np.random.default_rng(n + npad)
    vals = np.sort(rng.integers(0, 1 << 40, n).astype(np.uint64))
    hi, lo = pack2(vals)
    hi = np.concatenate([hi, np.full(npad, FF)])
    lo = np.concatenate([lo, np.full(npad, FF)])
    pw, pc, npairs = jax.jit(
        lambda a, b: chunk_count_pairs((a, b), pair_cap=n))(
        jnp.asarray(hi), jnp.asarray(lo))
    u, c = ref_pairs(vals)
    npairs = int(npairs)
    assert npairs == len(u)
    got = (np.asarray(pw[0])[:npairs].astype(np.uint64) << np.uint64(32)) \
        | np.asarray(pw[1])[:npairs]
    np.testing.assert_array_equal(got, u)
    np.testing.assert_array_equal(np.asarray(pc)[:npairs], c)
    # sentinel tail
    assert (np.asarray(pw[0])[npairs:] == FF).all()
    assert (np.asarray(pc)[npairs:] == 0).all()


def test_chunk_count_pairs_overflow_reports():
    vals = np.arange(100, dtype=np.uint64) * 7
    hi, lo = pack2(np.sort(vals))
    pw, pc, npairs = chunk_count_pairs(
        (jnp.asarray(hi), jnp.asarray(lo)), pair_cap=32)
    assert int(npairs) == 100          # exact even though 68 dropped


@pytest.mark.parametrize("nstreams", [2, 3, 5, 8])
def test_merge_pair_streams(nstreams):
    rng = np.random.default_rng(nstreams)
    cap = 2048
    streams, all_vals, all_cnts = [], [], []
    for s in range(nstreams):
        nv = rng.integers(10, cap // 2)
        u = np.unique(rng.integers(0, 5000, nv).astype(np.uint64))
        c = rng.integers(1, 1000, len(u)).astype(np.uint32)
        hi, lo = pack2(u)
        hi = np.concatenate([hi, np.full(cap - len(u), FF)])
        lo = np.concatenate([lo, np.full(cap - len(u), FF)])
        cc = np.concatenate([c, np.zeros(cap - len(u), np.uint32)])
        streams.append(((jnp.asarray(hi), jnp.asarray(lo)),
                        jnp.asarray(cc)))
        all_vals.append(u)
        all_cnts.append(c)
    out_w, out_c, n = merge_pair_streams(streams, out_cap=nstreams * cap)
    # numpy reference
    cat = np.concatenate(all_vals)
    cnt = np.concatenate(all_cnts).astype(np.uint64)
    u = np.unique(cat)
    ref = np.zeros(len(u), dtype=np.uint64)
    np.add.at(ref, np.searchsorted(u, cat), cnt)
    n = int(n)
    assert n == len(u)
    got = (np.asarray(out_w[0])[:n].astype(np.uint64) << np.uint64(32)) \
        | np.asarray(out_w[1])[:n]
    np.testing.assert_array_equal(got, u)
    np.testing.assert_array_equal(np.asarray(out_c)[:n],
                                  np.minimum(ref, 0xFFFFFFFF))
    assert (np.asarray(out_w[0])[n:] == FF).all()


def test_merge_saturates():
    big = np.uint32(0xF0000000)
    hi, lo = pack2(np.array([5], dtype=np.uint64))
    s = ((jnp.asarray(hi), jnp.asarray(lo)),
         jnp.asarray(np.array([big], np.uint32)))
    out_w, out_c, n = merge_pair_streams([s, s, s], out_cap=4)
    assert int(n) == 1
    assert int(np.asarray(out_c)[0]) == 0xFFFFFFFF


def test_merged_sorted_ops_lexsort_parity():
    """merged_sorted_ops returns the globally sorted (words, cnt) stream
    of the concatenated runs (== np.lexsort) — including uneven run caps,
    three runs and zero-cnt sentinel tails."""
    from kmtricks_tpu.ops.table import merged_sorted_ops

    rng = np.random.default_rng(7)
    caps = (1 << 13, 1 << 13, 1 << 12)
    streams, cat = [], []
    for i, cap in enumerate(caps):
        nvalid = cap - (i + 1) * 100
        vals = np.sort(rng.choice(1 << 40, nvalid, replace=False)
                       .astype(np.uint64))
        hi, lo = pack2(vals)
        hi = np.concatenate([hi, np.full(cap - nvalid, FF)])
        lo = np.concatenate([lo, np.full(cap - nvalid, FF)])
        cnt = np.concatenate([
            rng.integers(1, 100, nvalid).astype(np.uint32),
            np.zeros(cap - nvalid, np.uint32)])
        streams.append(((jnp.asarray(hi), jnp.asarray(lo)),
                        jnp.asarray(cnt)))
        cat.append((hi, lo, cnt))
    hi, lo, cnt = (np.concatenate([c[j] for c in cat]) for j in range(3))
    # keys are unique across runs except the sentinels, whose cnt is 0:
    # the expected order is fully determined
    order = np.lexsort((cnt, lo, hi))
    ws, got_c = jax.jit(lambda: merged_sorted_ops(streams))()
    np.testing.assert_array_equal(np.asarray(ws[0]), hi[order])
    np.testing.assert_array_equal(np.asarray(ws[1]), lo[order])
    np.testing.assert_array_equal(np.asarray(got_c), cnt[order])
