"""Post-sort segment stage (ops/count_merge._segment_stage) vs a direct
numpy reference.

The numpy reference implements the stage's definitions literally: run
lengths, hard-min presence, count saturation, solid/rescue per key, row
heads, recurrence keep verdicts and the dense row index."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmtricks_tpu.ops.count_merge import _segment_stage

TILE = 8192    # sizes straddle multiples of this block width


def ref_segment_stage(occ_diff, key_diff, valid, amin_of, hard_min, rmin,
                      save_if, count_max):
    n = len(occ_diff)
    occ_head = occ_diff & valid
    mark = occ_diff | ~valid
    nxt = np.full(n, n, dtype=np.int64)
    nb = n
    for i in range(n - 1, -1, -1):
        nxt[i] = nb
        if mark[i]:
            nb = i
    cnt_raw = np.where(occ_head, nxt - np.arange(n), 0)
    present = occ_head & (cnt_raw >= hard_min)
    cnt = np.minimum(cnt_raw, count_max)
    solid = present & (cnt >= amin_of)
    # per-key segment totals of solid
    seg = np.cumsum(key_diff) - 1
    solid_in = np.zeros(n, dtype=np.int64)
    for s in np.unique(seg):
        m = seg == s
        solid_in[m] = solid[m].sum()
    rescued = (present & ~solid & (solid_in >= save_if)) if save_if > 0 \
        else np.zeros(n, dtype=bool)
    final = np.where(solid | rescued, cnt, 0)
    row_head = np.zeros(n, dtype=bool)
    for s in np.unique(seg):
        idx = np.where((seg == s) & present)[0]
        if len(idx):
            row_head[idx[0]] = True
    row_keep = row_head & (solid_in >= rmin)
    row_of = np.maximum(np.cumsum(row_head) - 1, 0)
    return cnt, present, solid, rescued, final, row_head, row_keep, row_of


def make_case(rng, n, nsamp=4, invalid_tail=200):
    """Random sorted-like segment structure: keys with random run counts,
    a sample id per entry and a per-sample soft-min."""
    key_diff = np.zeros(n, dtype=bool)
    key_diff[0] = True
    key_diff[1:] = rng.random(n - 1) < 0.3
    occ_diff = key_diff | (rng.random(n) < 0.5)
    occ_diff[0] = True
    valid = np.ones(n, dtype=bool)
    if invalid_tail:
        valid[n - invalid_tail:] = False
    samp = rng.integers(0, nsamp, n).astype(np.int32)
    amin_vec = rng.integers(1, 4, nsamp).astype(np.uint32)
    return occ_diff, key_diff, valid, samp, amin_vec


def run_stage(occ_diff, key_diff, valid, samp, amin_vec, *, hard_min,
              rmin, save_if, count_max, hard_min_vec=None):
    """The XLA segment stage on one case (adjacent-entry diffs as the
    sort layouts produce them)."""
    n = len(occ_diff)
    nsamp = len(amin_vec)
    fn = jax.jit(partial(
        _segment_stage, nsamp=nsamp, hard_min=hard_min, rmin=rmin,
        save_if=save_if, count_max=count_max, with_stats=True))
    out = fn(jnp.zeros(n, jnp.int32), (jnp.zeros(n, jnp.uint32),),
             jnp.asarray(samp, jnp.uint32), jnp.asarray(valid),
             jnp.asarray(occ_diff[1:]), jnp.asarray(key_diff[1:]),
             jnp.asarray(amin_vec),
             hard_min_vec=(None if hard_min_vec is None
                           else jnp.asarray(hard_min_vec, jnp.uint32)))
    (_part, _keys, samp_i, final, cnt, present, row_head, row_keep, row_of,
     stats) = out
    return dict(cnt=np.asarray(cnt), present=np.asarray(present),
                final=np.asarray(final), row_head=np.asarray(row_head),
                row_keep=np.asarray(row_keep), row_of=np.asarray(row_of),
                stats=np.asarray(stats))


def check(got, exp, samp, nsamp):
    cnt, present, solid, rescued, final, row_head, row_keep, row_of = exp
    for name, e in (("cnt", cnt), ("present", present), ("final", final),
                    ("row_head", row_head), ("row_keep", row_keep)):
        assert (got[name].astype(np.int64) == e.astype(np.int64)).all(), \
            name
    # row_of is only meaningful at/after the first row head
    first = np.argmax(row_head) if row_head.any() else len(row_of)
    assert (got["row_of"][first:] == row_of[first:]).all(), "row_of"

    def per_sample(v):
        return np.bincount(samp, weights=v.astype(np.float64),
                           minlength=nsamp).astype(np.uint64)

    want = np.stack([per_sample(present & ~solid), per_sample(rescued),
                     per_sample(solid), per_sample(solid | rescued),
                     per_sample(np.where(solid, cnt, 0)),
                     per_sample(final)])
    np.testing.assert_array_equal(got["stats"].astype(np.uint64), want)


@pytest.mark.parametrize("n", [TILE // 2, TILE, TILE + 3, 3 * TILE + 1111])
@pytest.mark.parametrize("params", [(1, 1, 0, 0xFFFFFFFF),
                                    (2, 2, 3, 255)])
def test_segscan_matches_reference(n, params):
    hard_min, rmin, save_if, count_max = params
    rng = np.random.default_rng(n + hard_min)
    occ_diff, key_diff, valid, samp, amin_vec = make_case(
        rng, n, invalid_tail=min(200, n // 4))
    exp = ref_segment_stage(occ_diff, key_diff, valid, amin_vec[samp],
                            hard_min, rmin, save_if, count_max)
    got = run_stage(occ_diff, key_diff, valid, samp, amin_vec,
                    hard_min=hard_min, rmin=rmin, save_if=save_if,
                    count_max=count_max)
    check(got, exp, samp, len(amin_vec))


def test_segscan_long_runs_cross_tiles():
    """A single key run spanning several block widths."""
    n = 3 * TILE
    occ_diff = np.zeros(n, dtype=bool)
    occ_diff[0] = True
    key_diff = occ_diff.copy()
    valid = np.ones(n, dtype=bool)
    samp = np.zeros(n, np.int32)
    amin_vec = np.array([2], np.uint32)
    exp = ref_segment_stage(occ_diff, key_diff, valid, amin_vec[samp], 1, 1,
                            0, 0xFFFFFFFF)
    got = run_stage(occ_diff, key_diff, valid, samp, amin_vec, hard_min=1,
                    rmin=1, save_if=0, count_max=0xFFFFFFFF)
    check(got, exp, samp, 1)
    assert int(got["cnt"][0]) == n


def test_segscan_alternating_and_all_invalid():
    n = TILE + 77
    occ_diff = np.ones(n, dtype=bool)          # every entry its own run
    key_diff = np.ones(n, dtype=bool)
    valid = np.zeros(n, dtype=bool)            # all invalid
    samp = np.zeros(n, np.int32)
    got = run_stage(occ_diff, key_diff, valid, samp,
                    np.ones(1, np.uint32), hard_min=1, rmin=1, save_if=0,
                    count_max=255)
    assert not got["present"].any()            # nothing present
    assert not got["row_head"].any()           # no rows
    assert not got["stats"].any()


def test_segscan_per_position_hard_min():
    """Per-sample hard-min thresholds (fof ``! amin`` overrides)."""
    n = TILE
    rng = np.random.default_rng(3)
    occ_diff, key_diff, valid, samp, amin_vec = make_case(
        rng, n, invalid_tail=64)
    hmin_vec = np.array([1, 2, 3, 1], np.uint32)
    exp = ref_segment_stage(occ_diff, key_diff, valid, amin_vec[samp],
                            hmin_vec[samp], 1, 0, 255)
    got = run_stage(occ_diff, key_diff, valid, samp, amin_vec, hard_min=1,
                    rmin=1, save_if=0, count_max=255,
                    hard_min_vec=hmin_vec)
    check(got, exp, samp, 4)
    # with a hard-min above every count, nothing is present
    got_hi = run_stage(occ_diff, key_diff, valid, samp, amin_vec,
                       hard_min=1, rmin=1, save_if=0, count_max=255,
                       hard_min_vec=np.full(4, 10**6, np.uint32))
    assert not got_hi["present"].any()
