"""chip_smoke.py's CPU-testable parts: its comparison helpers, its numpy
golden count (checked against the host k-mer codec), its synthetic reads,
its case table, its placement and balance checks, its probe, and its
refusal to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def _tree(root, files):
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)


def test_compare_runs_equal_and_different(tmp_path):
    files = {"matrices/matrix_0.count": b"abc",
             "merge_infos/partition0.merge_info": b"N\t1\t",
             "hash.info": b"x", "counts/partition_0/S0.kmer": b"only-host"}
    _tree(tmp_path / "g", files)
    same = dict(files)
    del same["counts/partition_0/S0.kmer"]     # not a compared name
    _tree(tmp_path / "t", same)
    n, bad = cs.compare_runs(str(tmp_path / "g"), str(tmp_path / "t"))
    assert (n, bad) == (3, [])

    (tmp_path / "t" / "matrices" / "matrix_0.count").write_bytes(b"abd")
    (tmp_path / "t" / "hash.info").unlink()
    n, bad = cs.compare_runs(str(tmp_path / "g"), str(tmp_path / "t"))
    assert bad == ["matrices/matrix_0.count: bytes differ",
                   "hash.info: missing"]

    (tmp_path / "t" / "merge_infos" / "extra").write_bytes(b"")
    _n, bad = cs.compare_runs(str(tmp_path / "g"), str(tmp_path / "t"))
    assert any(b.startswith("merge_infos: files") for b in bad)


def test_canonical_kmers_match_host_codec():
    from kmtricks_tpu.core import kmer as K
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (5, 60)).astype(np.uint8)
    k = 31
    got = cs.canonical_kmers(codes, k).reshape(5, -1)
    for r in range(5):
        s = "".join("ACTG"[c] for c in codes[r])
        words = K.strings_to_kmers([s[i:i + k]
                                    for i in range(len(s) - k + 1)], k)
        want = K.canonical(words, k)[:, 0]
        np.testing.assert_array_equal(got[r], want)


def test_read_codes_split_at_non_acgt(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_text(">a\nACGTN\nacg\n>b\nTTTT\n")
    got = cs.read_codes(str(p))
    assert [c.tolist() for c in got] == [[0, 1, 3, 2], [0, 1, 3],
                                         [2, 2, 2, 2]]
    u, c = cs.numpy_counts(got, 3)
    # windows: ACG, CGT | (N) | ACG | TTT, TTT -> canonical values
    assert int(c.sum()) == 5


def test_synthetic_fastq_roundtrip(tmp_path):
    from kmtricks_tpu.io.sequences import iter_sequences
    from gen_synth_bank import BASES
    col = cs.gen_bank(str(tmp_path), nsamp=2, genome=5000, coverage=1.2,
                      read_len=150, seed=3, error_rate=0.005, fastq=True,
                      gzip_first=True, keep_codes=True)
    assert col["fof"].endswith("bank.fof") and col["reads"] == 40
    paths = sorted(os.listdir(tmp_path))
    assert "S0.fastq.gz" in paths and "S1.fastq" in paths
    for s, ext in ((0, ".fastq.gz"), (1, ".fastq")):
        seqs = list(iter_sequences(str(tmp_path / f"S{s}{ext}")))
        assert len(seqs) == 40
        want = [BASES[r].tobytes() for r in col["codes"][s]]
        assert seqs == want


def test_phase_b_case_table():
    one = cs.phase_b_cases(four_cards=False)
    four = cs.phase_b_cases(four_cards=True)
    names = [c[0] for c in one]
    assert len(set(names)) == len(names)
    routes = {c[3] for c in one}
    assert routes == {"stage_mesh_count_merge", "stage_mesh_chunked",
                      "stage_mesh_stream", None}
    assert {c[4] for c in one} >= {"h1", "k2", "k3", "kw"}
    # the device pa finalize runs on one card and on four, twice
    pa = [c for c in one if "kmer:pa:bin" in c.args]
    assert len(pa) == 1 and pa[0].history_rerun and pa[0] in four
    assert pa[0].route == "stage_mesh_stream"
    # four cards: only the sharded fused step and streaming engine
    assert {c.route for c in four} == {"stage_mesh_count_merge",
                                       "stage_mesh_stream"}
    assert all("mesh" in c.args for c in four)
    assert {c.name for c in four} <= set(names)


def test_check_placement():
    cs.check_placement([4, 4, 4], 4, "x")
    cs.check_placement([], 4, "x", required=False)
    for spans in ([4, 1, 4], []):
        with pytest.raises(cs.SmokeFailure):
            cs.check_placement(spans, 4, "x")


@pytest.mark.parametrize("peaks,ok", [
    ([800 << 20, 780 << 20, 790 << 20, 780 << 20], True),
    ([9 << 30, 8 << 30, 8 << 30, 8 << 30], True),
    ([12 << 30, 8 << 30, 8 << 30, 8 << 30], False),   # a table on card 0
    ([800 << 20, 0, 790 << 20, 780 << 20], False),    # an idle card
])
def test_check_device_balance(peaks, ok):
    if ok:
        cs.check_device_balance(peaks)
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check_device_balance(peaks)


def test_probe_records_routes_and_fetch_spans(monkeypatch):
    """The probe sees a fetch's device span and a route call (the
    wrapped module attributes are restored after the test)."""
    import jax.numpy as jnp

    from kmtricks_tpu.ops import compact
    from kmtricks_tpu.parallel import pipeline as pp
    from kmtricks_tpu.runtime import device_pipeline as dp
    from kmtricks_tpu.runtime import stream_engine as se
    for mod, name in ((dp, "stage_mesh_count_merge"),
                      (dp, "stage_mesh_chunked"),
                      (se, "stage_mesh_stream"),
                      (pp, "build_merge_finalize_bits"),
                      (compact, "_prepare_fetch")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    monkeypatch.setattr(dp, "stage_mesh_chunked", lambda *a, **kw: "ran")
    probe = cs.Probe()
    x = jnp.arange(64, dtype=jnp.uint32).reshape(16, 4)
    np.testing.assert_array_equal(compact.fetch_rows(x, 5), np.asarray(x)[:5])
    compact.fetch_rows(x, 0)
    assert probe.fetch_spans == [1]
    assert dp.stage_mesh_chunked() == "ran"
    assert probe.routes == ["stage_mesh_chunked"]
    assert probe.mark() == (1, 1, 0)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_gpu(tmp_path, alone):
    """On a CPU platform, and alone in a directory without the rest of
    the repository, the script exits non-zero and prints no result."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), "--work",
                          str(tmp_path / "w")], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
