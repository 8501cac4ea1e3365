"""Re-ordering of sorted runs (the mesh receiver: ndev sorted runs from
the all_to_all -> one sorted array; the streaming engine's pair-run
merges) vs np.sort / np.lexsort, and the mesh wiring that uses it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmtricks_tpu.ops.count_merge import count_merge_packed
from kmtricks_tpu.ops.table import merged_sorted_ops

TILE = 8192          # run lengths straddle multiples of this width
NSAMP = 4            # h1 layout: (valid | key | 2 sample bits)
KEY_BITS = 29


def _runs(rng, nruns, cap, fill_frac=0.8):
    """Sentinel-tail-padded ascending runs, uneven fill per run."""
    x = np.full((nruns, cap), 0xFFFFFFFF, dtype=np.uint32)
    for i in range(nruns):
        n = int(rng.integers(0, int(cap * fill_frac) + 1))
        x[i, :n] = np.sort(
            rng.integers(0, 1 << 31, n, dtype=np.uint64).astype(np.uint32))
    return x


def _h1_stage(words, sorted_runs):
    """count_merge_packed on one-word "h1" words, with the re-order
    chosen by ``sorted_runs`` (1 = already globally sorted)."""
    out = count_merge_packed(
        (jnp.asarray(words),), jnp.ones(NSAMP, jnp.uint32), layout="h1",
        nsamp=NSAMP, hard_min=1, rmin=1, save_if=0, key_bits=KEY_BITS,
        window_bits=1 << 26, sorted_runs=sorted_runs)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


def _check_h1_runs(x):
    nruns = x.shape[0]
    got = _h1_stage(x.reshape(-1), nruns)
    want = _h1_stage(np.sort(x.reshape(-1)), 1)
    for i, (g, e) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, e, err_msg=f"output {i}")


@pytest.mark.parametrize("nruns,cap", [
    (2, TILE), (4, TILE), (8, TILE),
    (2, TILE + 1000),          # non-pow2 run length
    (4, 2 * TILE - 512),
])
def test_merge_runs_matches_sort(nruns, cap):
    rng = np.random.default_rng(nruns * 100 + cap)
    _check_h1_runs(_runs(rng, nruns, cap))


def test_merge_runs_fallbacks():
    rng = np.random.default_rng(0)
    # short runs, non-pow2 run counts and a single run
    for nruns, cap in ((4, 100), (3, TILE), (1, TILE)):
        x = _runs(rng, nruns, cap)
        if nruns == 1:
            x = np.sort(x, axis=1)
        _check_h1_runs(x)


def _word_runs(rng, nruns, cap, nw, fill_frac=0.8):
    """Sentinel-tail-padded ascending multi-word runs (msb-first words;
    word0's top bit clear on valid entries, like the packed layouts)."""
    ws = [np.full((nruns, cap), 0xFFFFFFFF, dtype=np.uint32)
          for _ in range(nw)]
    for i in range(nruns):
        n = int(rng.integers(0, int(cap * fill_frac) + 1))
        cols = [rng.integers(0, 1 << 31, n, dtype=np.uint64)
                .astype(np.uint32)] + \
               [rng.integers(0, 1 << 32, n, dtype=np.uint64)
                .astype(np.uint32) for _ in range(nw - 1)]
        # duplicate some rows to exercise tie handling
        if n > 8:
            src = rng.integers(0, n, n // 4)
            dst = rng.integers(0, n, n // 4)
            for c in cols:
                c[dst] = c[src]
        order = np.lexsort(tuple(reversed(cols)))
        for w in range(nw):
            ws[w][i, :n] = cols[w][order]
    return tuple(ws)


def _lex_sorted(ws):
    """Flat lexicographic sort of a multi-word tuple (numpy oracle)."""
    flat = [w.reshape(-1) for w in ws]
    order = np.lexsort(tuple(reversed(flat)))
    return tuple(f[order] for f in flat)


def _check_word_runs(ws):
    """merged_sorted_ops over the runs == lexsort of their concatenation;
    the carried count is a function of the key so ties are unambiguous."""
    nruns = ws[0].shape[0]
    streams = []
    for i in range(nruns):
        words = tuple(jnp.asarray(w[i]) for w in ws)
        cnt = jnp.asarray(ws[-1][i] & np.uint32(0xFF))
        streams.append((words, cnt))
    got_w, got_c = jax.jit(lambda: merged_sorted_ops(streams))()
    want = _lex_sorted(ws)
    for w, (g, e) in enumerate(zip(got_w, want)):
        np.testing.assert_array_equal(np.asarray(g), e, err_msg=f"word {w}")
    np.testing.assert_array_equal(np.asarray(got_c),
                                  want[-1] & np.uint32(0xFF))


@pytest.mark.parametrize("nw", [2, 3])
@pytest.mark.parametrize("nruns,cap", [
    (2, TILE), (4, TILE), (2, TILE + 1000),
])
def test_merge_word_runs_matches_lexsort(nw, nruns, cap):
    rng = np.random.default_rng(nw * 1000 + nruns * 10 + cap)
    _check_word_runs(_word_runs(rng, nruns, cap, nw))


def test_merge_word_runs_fallbacks():
    rng = np.random.default_rng(7)
    # short runs, non-pow2 run counts, one run, one word
    for nruns, cap, nw in ((4, 128, 2), (3, TILE, 3), (1, TILE, 2),
                           (4, TILE, 1)):
        _check_word_runs(_word_runs(rng, nruns, cap, nw))


def test_one_device_mesh_skips_resort_correctly():
    """sorted_runs == 1 skips the receiver re-sort; a 1-device mesh step
    must still equal the single-chip step on the valid prefix."""
    import jax.numpy as jnp

    from kmtricks_tpu.parallel.pipeline import (build_sharded_pipeline,
                                                build_single_chip_step,
                                                make_mesh)

    rng = np.random.default_rng(9)
    B, L, K, M, NSAMP, NB = 64, 160, 31, 10, 4, 16
    batch = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=(B, L))
    lengths = rng.integers(K, L + 1, B).astype(np.int32)
    samp = (np.arange(B, dtype=np.int32) * NSAMP) // B
    args = (jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(samp),
            jnp.asarray(np.zeros(4 ** M, np.int32)),
            jnp.asarray(np.full(NSAMP, 2, np.uint32)))
    kw = dict(k=K, m=M, nsamp=NSAMP, hard_min=1, rmin=1, save_if=1,
              mode="hash", window_bits=4096)
    cap = B * (L - K + 1)
    mesh_out = build_sharded_pipeline(
        make_mesh(1), nb_parts=NB, cap=cap, static_repart=True, **kw)(*args)
    chip_out = build_single_chip_step(static_repart_parts=NB, **kw)(*args)
    # both are sorted with invalid entries (sentinels) at the tail; the
    # valid prefixes must agree element for element
    m_final, c_final = np.asarray(mesh_out[3]), np.asarray(chip_out[3])
    m_pres, c_pres = (np.asarray(mesh_out[5]).astype(bool),
                      np.asarray(chip_out[5]).astype(bool))
    n = c_pres.sum()
    assert m_pres.sum() == n
    for mi, ci in ((1, 1), (2, 2), (3, 3), (4, 4)):
        mv = mesh_out[mi]
        cv = chip_out[ci]
        if isinstance(mv, tuple):
            for a, b in zip(mv, cv):
                assert np.array_equal(np.asarray(a)[m_pres],
                                      np.asarray(b)[c_pres])
        else:
            assert np.array_equal(np.asarray(mv)[m_pres],
                                  np.asarray(cv)[c_pres])


@pytest.mark.parametrize("layout_case", [
    "h1",    # hash, 1 packed word
    "h2",    # hash, > 31 bits of window space -> 2 packed words
    "k3",    # kmer k=31 -> 3 packed words
    "kw",    # kmer k=33 -> wide-key packed layout (3 words)
])
def test_mesh_step_routed_runs_match_host(tmp_path, layout_case):
    """The fused sharded step over the 8-device CPU mesh (all_to_all,
    then the receiver re-sorts the 8 routed runs) == the host golden
    path, byte for byte — for every packed layout family the mesh
    router produces."""
    from kmtricks_tpu.ops.count_merge import packed_layout
    from kmtricks_tpu.runtime.pipeline import PipelineOptions, run_pipeline

    rng = np.random.default_rng(3)
    K = {"h1": 31, "h2": 31, "k3": 31, "kw": 33}[layout_case]
    NB, nsamp = 8, 3
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    lines = []
    for s in range(nsamp):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for i in range(60):
                st = int(rng.integers(0, len(genome) - 150))
                f.write(b">r\n" + genome[st:st + 150].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")
    kw = dict(fof=str(fof), kmer_size=K, hard_min=1, soft_min="2",
              share_min=1, static_repart=True, nb_partitions=NB)
    if layout_case in ("h1", "h2"):
        bloom = 1 << 20 if layout_case == "h1" else 1 << 34
        kw.update(mode="hash:count:bin", bloom_size=bloom)
        key_bits = ((bloom // NB) * NB - 1).bit_length()
    else:
        kw.update(mode="kmer:count:bin")
        key_bits = 2 * K
    from kmtricks_tpu.ops.encode import device_key_words
    nw = 2 if layout_case in ("h1", "h2") else device_key_words(K)
    lay = packed_layout(nsamp, nw, layout_case in ("h1", "h2"), key_bits,
                        (NB - 1).bit_length())
    assert lay is not None and lay.split(".")[0] == {
        "h1": "h1", "h2": "h2", "k3": "k3", "kw": "kw"}[layout_case]

    host = run_pipeline(PipelineOptions(run_dir=str(tmp_path / "host"),
                                        backend="host", **kw))
    mesh = run_pipeline(PipelineOptions(run_dir=str(tmp_path / "mesh"),
                                        backend="mesh", **kw))
    assert jax.device_count() == 8
    cf = kw["mode"].split(":")[0]
    for p in range(NB):
        a = open(host.get_matrix_path(p, "count", "bin", cf, False),
                 "rb").read()
        b = open(mesh.get_matrix_path(p, "count", "bin", cf, False),
                 "rb").read()
        assert a == b, f"partition {p} matrix differs ({layout_case})"
        assert (open(host.get_merge_info_path(p)).read()
                == open(mesh.get_merge_info_path(p)).read())
