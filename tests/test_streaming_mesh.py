"""Streaming mesh input (bounded host RSS), shuffle self-healing, and
long-read splitting."""

import numpy as np
import pytest

from kmtricks_tpu.io import formats as F
from kmtricks_tpu.runtime.pipeline import PipelineOptions, run_pipeline


def write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")


def random_reads(rng, n, lo, hi):
    return ["".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
            for _ in range(n)]


@pytest.fixture()
def small_fof(tmp_path):
    rng = np.random.default_rng(77)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        write_fasta(p, random_reads(rng, 40, 80, 160))
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


def _opts(fof, run_dir, **kw):
    d = dict(fof=fof, run_dir=str(run_dir), kmer_size=31, hard_min=1,
             soft_min="2", share_min=2, mode="kmer:count:bin",
             static_repart=True, nb_partitions=8)
    d.update(kw)
    return PipelineOptions(**d)


def _matrices(kmdir, nb=8):
    return [open(kmdir.get_matrix_path(p, "count", "bin", "kmer", False),
                 "rb").read() for p in range(nb)]


def test_streaming_chunked_equals_host(small_fof, tmp_path):
    """use_stream chunked path == host backend, byte for byte."""
    from kmtricks_tpu.runtime.device_pipeline import stage_mesh_chunked
    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)

    host = run_pipeline(_opts(small_fof, tmp_path / "host", backend="host"))

    opts = _opts(small_fof, tmp_path / "stream")
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    # tiny chunk budget: forces many chunks + trailing padded chunk
    stage_mesh_chunked(kmdir, config, opts, repart, amin,
                       chunk_windows=3000, use_stream=True)
    assert _matrices(kmdir) == _matrices(host)

    # sample-parallel decode (-t > 1): samples interleave across chunks
    # in nondeterministic order, but the aggregated matrices are
    # order-free — byte-equal to the serial run
    opts_t = _opts(small_fof, tmp_path / "stream_t", threads=4)
    kmdir_t, config_t = stage_config(opts_t)
    repart_t = stage_repart(kmdir_t, config_t, opts_t)
    stage_mesh_chunked(kmdir_t, config_t, opts_t, repart_t, amin,
                       chunk_windows=3000, use_stream=True)
    assert _matrices(kmdir_t) == _matrices(host)


def test_streaming_splits_long_reads(tmp_path):
    """Reads longer than the streaming segment length L are split with
    k-1 overlap — matrices equal the host backend's."""
    from kmtricks_tpu.runtime.device_pipeline import (
        stage_mesh_chunked, stream_row_chunks)
    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)

    rng = np.random.default_rng(5)
    p = tmp_path / "L.fasta"
    write_fasta(p, random_reads(rng, 6, 5000, 6000))   # long reads
    fof = tmp_path / "t.fof"
    fof.write_text(f"S0 : {p}\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host"))

    opts = _opts(str(fof), tmp_path / "stream")
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, 1)
    stage_mesh_chunked(kmdir, config, opts, repart, amin,
                       chunk_windows=50_000, use_stream=True)
    assert _matrices(kmdir) == _matrices(host)
    # sanity: the stream really does split (L is capped at 4096)
    chunks = list(stream_row_chunks(kmdir, opts, 31, 4096, 64))
    assert sum((c[1] > 0).sum() for c in chunks) > 6   # more rows than reads


def test_adversarial_skew_self_heals(tmp_path, caplog):
    """All reads identical -> every occurrence routes to a handful of
    partitions. The skew-sized cap + doubling retry must converge with no
    RuntimeError and produce host-identical output."""
    rng = np.random.default_rng(13)
    read = "".join(rng.choice(list("ACGT"), size=150))
    p = tmp_path / "A.fasta"
    write_fasta(p, [read] * 64)
    fof = tmp_path / "t.fof"
    fof.write_text(f"S0 : {p}\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host"))
    mesh = run_pipeline(_opts(str(fof), tmp_path / "mesh", backend="mesh"))
    assert _matrices(mesh) == _matrices(host)


def test_skew_estimator_uniformish(small_fof, tmp_path):
    from kmtricks_tpu.runtime.device_pipeline import estimate_dest_skew
    from kmtricks_tpu.runtime.pipeline import stage_config, stage_repart

    opts = _opts(small_fof, tmp_path / "sk")
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    skew = estimate_dest_skew(kmdir, opts, config, repart, ndev=4)
    assert 0.25 <= skew <= 1.0


def test_per_sample_hard_min_in_fused_kernel(tmp_path):
    """fof `! amin` overrides ride the fused mesh kernel (not just the
    chunked host path) — output equals the host backend's."""
    rng = np.random.default_rng(21)
    lines = []
    for s, amin in ((0, 1), (1, 2), (2, 3)):
        p = tmp_path / f"S{s}.fasta"
        rs = random_reads(rng, 20, 100, 180)
        rs += rs[:8]            # duplicates -> counts >= 2 for some kmers
        write_fasta(p, rs)
        lines.append(f"S{s} : {p} ! {amin}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host",
                              soft_min="1"))
    mesh = run_pipeline(_opts(str(fof), tmp_path / "mesh", backend="mesh",
                              soft_min="1"))
    assert _matrices(mesh) == _matrices(host)


def test_prefetched_propagates_generator_errors():
    """A decode failure on the prefetch thread must fail the run, not
    silently truncate the stream (regression: the worker's finally put
    the END sentinel and the consumer saw a clean end-of-stream)."""
    from kmtricks_tpu.runtime.device_pipeline import prefetched

    def boom():
        yield 1
        yield 2
        raise OSError("truncated gzip")

    got = []
    with pytest.raises(OSError, match="truncated gzip"):
        for x in prefetched(boom(), depth=1):
            got.append(x)
    assert got == [1, 2]


def test_streaming_bam_input(tmp_path):
    """BAM banks stream through the native record-batch parser in
    iter_batches (record-iterator fallback without the native lib); the
    streaming chunked path over a BAM sample equals the host backend."""
    import pathlib

    from kmtricks_tpu.runtime.device_pipeline import stage_mesh_chunked
    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)

    bam = pathlib.Path("/root/reference/test.bam")
    if not bam.exists():
        pytest.skip("test.bam not available")
    fof = tmp_path / "t.fof"
    fof.write_text(f"S0 : {bam}\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host",
                              soft_min="1", share_min=0))

    opts = _opts(str(fof), tmp_path / "stream", soft_min="1", share_min=0)
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, 1)
    stage_mesh_chunked(kmdir, config, opts, repart, amin,
                       chunk_windows=2000, use_stream=True)
    assert _matrices(kmdir) == _matrices(host)


def test_stream_engine_mixed_clean_and_n_chunks(tmp_path):
    """Streaming ENGINE (device-resident tables) with chunks that
    alternate between clean (no validity plane uploaded — derived from
    lengths on device) and N-containing (full vbits upload): byte-equal
    to the host backend. Covers both chunk-program variants in one run."""
    rng = np.random.default_rng(123)
    genome = rng.choice(list("ACGT"), size=6000)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        reads = []
        for r in range(150):
            start = int(rng.integers(0, len(genome) - 120))
            read = list(genome[start:start + 120])
            # sample 1: sprinkle interior Ns so some chunks are dirty
            if s == 1 and r % 3 == 0:
                read[int(rng.integers(5, 110))] = "N"
            reads.append("".join(read))
        write_fasta(p, reads)
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "n.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host"))
    mesh = run_pipeline(_opts(str(fof), tmp_path / "mesh", backend="mesh",
                              max_memory_mb=1))
    assert _matrices(mesh) == _matrices(host)


def _engine_run(fof, run_dir, mode, nsamp_env=None, **kw):
    d = dict(fof=fof, run_dir=str(run_dir), kmer_size=31, hard_min=1,
             soft_min="2", share_min=2, recurrence_min=2, mode=mode,
             static_repart=True, nb_partitions=8, backend="mesh",
             max_memory_mb=1)
    d.update(kw)
    return run_pipeline(PipelineOptions(**d))


def test_stream_engine_pa_device_bits_parity(tmp_path):
    """pa:bin through the engine: the DEVICE merge finalize (packed bit
    rows + keep + exact per-partition stats, build_merge_finalize_bits)
    must byte-equal both the dense-fetch engine path and the host
    backend — matrices AND merge_infos, with rescue enabled."""
    import os

    rng = np.random.default_rng(7)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=5000)
    lines = []
    for s in range(5):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for r in range(120):
                start = int(rng.integers(0, len(genome) - 100))
                f.write(b">r%d\n" % r)
                f.write(genome[start:start + 100].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "pa.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = _engine_run(str(fof), tmp_path / "host", "kmer:pa:bin",
                       backend="host", max_memory_mb=8192)
    dev = _engine_run(str(fof), tmp_path / "dev", "kmer:pa:bin")
    os.environ["KMTRICKS_PA_DEVICE"] = "0"
    try:
        dense = _engine_run(str(fof), tmp_path / "dense", "kmer:pa:bin")
    finally:
        del os.environ["KMTRICKS_PA_DEVICE"]

    for p in range(8):
        fa = open(host.get_matrix_path(p, "pa", "bin", "kmer", False),
                  "rb").read()
        fb = open(dev.get_matrix_path(p, "pa", "bin", "kmer", False),
                  "rb").read()
        fc = open(dense.get_matrix_path(p, "pa", "bin", "kmer", False),
                  "rb").read()
        assert fa == fb == fc, f"partition {p} pa matrices differ"
        sa = open(host.get_merge_info_path(p)).read()
        sb = open(dev.get_merge_info_path(p)).read()
        sc = open(dense.get_merge_info_path(p)).read()
        assert sa == sb == sc, f"partition {p} merge stats differ"


def test_stream_engine_pa_5000_samples(tmp_path):
    """5000-sample collection through the engine's device pa finalize:
    sample ids need 13 bits in the packed layout, the stats planes cover 5000 columns, and the bits path must agree
    with the dense-fetch path."""
    import os

    rng = np.random.default_rng(17)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=2000)
    nsamp = 5000
    lines = []
    fdir = tmp_path / "banks"
    fdir.mkdir()
    for s in range(nsamp):
        p = fdir / f"S{s}.fasta"
        start = int(rng.integers(0, len(genome) - 90))
        with open(p, "wb") as f:
            f.write(b">r0\n" + genome[start:start + 90].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "big.fof"
    fof.write_text("\n".join(lines) + "\n")

    dev = _engine_run(str(fof), tmp_path / "dev", "kmer:pa:bin",
                      soft_min="1", share_min=0, recurrence_min=1)
    os.environ["KMTRICKS_PA_DEVICE"] = "0"
    try:
        dense = _engine_run(str(fof), tmp_path / "dense", "kmer:pa:bin",
                            soft_min="1", share_min=0, recurrence_min=1)
    finally:
        del os.environ["KMTRICKS_PA_DEVICE"]
    n_nonempty = 0
    for p in range(8):
        fb = open(dev.get_matrix_path(p, "pa", "bin", "kmer", False),
                  "rb").read()
        fc = open(dense.get_matrix_path(p, "pa", "bin", "kmer", False),
                  "rb").read()
        assert fb == fc, f"partition {p} pa matrices differ"
        n_nonempty += len(fb) > 64
        sb = open(dev.get_merge_info_path(p)).read()
        sc = open(dense.get_merge_info_path(p)).read()
        assert sb == sc, f"partition {p} merge stats differ"
    assert n_nonempty > 0


def test_streaming_prologue_and_tail_quarters(tmp_path, monkeypatch):
    """Chunk sizes large enough for the striped prologue: the four
    quarter chunks, the DEFERRED consolidation fold (incl. its overflow
    re-merge at a doubled cap: the pinned pair cap holds one quarter's
    pairs but not the merged four), full-cap chunks, and the
    quarter-shaped tail re-emission all byte-match the host backend.
    CPU tests otherwise never reach these paths (their chunk budgets
    are far below the 1024-row quarter minimum)."""
    from kmtricks_tpu.runtime.device_pipeline import stage_mesh_chunked
    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)

    rng = np.random.default_rng(11)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        write_fasta(p, random_reads(rng, 4200, 64, 81))
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host",
                              soft_min="1", share_min=0))

    # caps are PER-DEVICE (8-device test mesh): one quarter holds ~5.4k
    # pairs/device — under the pinned 8k cap; the merged four quarters
    # (~21k/device) exceed it, so resolve_fold must re-merge at a
    # doubled cap (the deferred-overflow path)
    monkeypatch.setenv("KMTRICKS_STREAM_PAIR_CAP", str(1 << 13))
    opts = _opts(str(fof), tmp_path / "stream", soft_min="1", share_min=0,
                 threads=2)
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream
    stage_mesh_stream(kmdir, config, opts, repart, amin,
                      chunk_windows=401_408, use_stream=True)
    assert _matrices(kmdir) == _matrices(host)


def test_shape_bucket_program_reuse(tmp_path):
    """Sample-count shape bucketing: a 10-sample collection reuses every
    big program a 9-sample run compiled (both bucket to 10; the packed
    layouts are bucket-stable) — without bucketing each nsamp recompiled
    the whole engine."""
    from kmtricks_tpu.parallel import pipeline as pp
    from kmtricks_tpu.runtime.device_pipeline import run_mesh_pipeline

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 1000))

    def mk(n_samp, reads_each, d):
        d.mkdir()
        lines = []
        for s in range(n_samp):
            p = d / f"S{s}.fasta"
            starts = rng.integers(0, 900, reads_each)
            write_fasta(p, [genome[st:st + 100] for st in starts])
            lines.append(f"S{s} : {p}")
        fof = d / "t.fof"
        fof.write_text("\n".join(lines) + "\n")
        return str(fof)

    builders = (pp.build_chunk_pairs_step, pp.build_table_sort_collapse,
                pp.build_table_compact, pp.build_table_merge)
    # equal TOTAL rows (270) so chunking and run counts match exactly
    for i, (ns, each) in enumerate(((9, 30), (10, 27))):
        fof = mk(ns, each, tmp_path / f"b{i}")
        opts = _opts(fof, tmp_path / f"run{i}", soft_min="1", share_min=0)
        run_mesh_pipeline(opts)
        if i == 0:
            before = [b.cache_info().misses for b in builders]
    after = [b.cache_info().misses for b in builders]
    assert after == before, (
        "shape bucketing failed: builders re-traced for nsamp=10 after "
        f"nsamp=9 (misses {before} -> {after})")


def test_compile_prefetch_predictions_hit(tmp_path, monkeypatch, capfd):
    """The compile-ahead simulation (_sim_final_caps + the initial
    chunk/fold shapes) must track the engine's real chunking: every
    prefetched program is consumed by its real call site (trace lines
    'compile-prefetch hit'). Guards the replayed arithmetic against
    drifting from stream_row_chunks/fold behavior. The pinned pair cap
    is generous so no overflow re-run perturbs the predicted shapes."""
    from kmtricks_tpu.runtime.device_pipeline import run_mesh_pipeline

    rng = np.random.default_rng(17)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        write_fasta(p, random_reads(rng, 4200, 64, 81))
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    monkeypatch.setenv("KMTRICKS_STREAM_TRACE", "1")
    monkeypatch.setenv("KMTRICKS_STREAM_PAIR_CAP", str(1 << 16))
    monkeypatch.setenv("KMTRICKS_STREAM_CHUNK_WINDOWS", "401408")
    # earlier tests in this worker may have warmed the same shape
    # family, which would (correctly) suppress the prefetch dummies —
    # this test asserts the dummies fire, so reset the per-process set
    from kmtricks_tpu.runtime import stream_engine as _se
    _se._warmed_sigs.clear()
    from kmtricks_tpu.runtime.pipeline import stage_config, stage_repart
    from kmtricks_tpu.runtime.pipeline import resolve_soft_min
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream

    opts = _opts(str(fof), tmp_path / "run", soft_min="1", share_min=0,
                 threads=2)
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    stage_mesh_stream(kmdir, config, opts, repart, amin,
                      chunk_windows=401_408, use_stream=True)
    out = capfd.readouterr().out
    hits = [ln for ln in out.splitlines() if "compile-prefetch hit" in ln]
    for kind in ("chunk", "fold4", "phaseA"):
        assert any(kind in h for h in hits), (kind, hits)

def test_adaptive_pair_cap_no_overflow_reruns(tmp_path, caplog):
    """Adaptive (un-pinned) pair-cap sizing: high-diversity reads make
    every full chunk's distinct-pair count exceed the r4 first-chunk
    starting cap, so the old policy paid mid-stream overflow re-runs on
    EVERY such run (the r4 bench tail). The consolidation-time bump
    (pow2ceil of the quarters' pair-count sum) must absorb them: zero
    'chunk pair overflow' warnings, output byte-equal to the host
    backend."""
    import logging

    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream

    rng = np.random.default_rng(23)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        write_fasta(p, random_reads(rng, 4200, 64, 81))
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host",
                              soft_min="1", share_min=0))

    opts = _opts(str(fof), tmp_path / "stream", soft_min="1", share_min=0,
                 threads=2)
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    with caplog.at_level(logging.WARNING, logger="kmtricks_tpu"):
        stage_mesh_stream(kmdir, config, opts, repart, amin,
                          chunk_windows=401_408, use_stream=True)
    overflow = [r for r in caplog.records
                if "chunk pair overflow" in r.getMessage()]
    assert not overflow, [r.getMessage() for r in overflow]
    assert _matrices(kmdir) == _matrices(host)

def test_shape_history_recorded_and_prefetched(tmp_path, monkeypatch,
                                               capfd):
    """The engine records its data-dependent program shapes (pair cap,
    phase-A caps, phase-B rows_cap, consolidation fold in_cap) in the
    shape-history file, and a later same-family run fires the recorded
    phase-B program at t=0 (cold-start economy)."""
    import json

    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)
    from kmtricks_tpu.runtime import stream_engine as se

    hist_file = tmp_path / "hist.json"
    monkeypatch.setenv("KMTRICKS_SHAPE_HISTORY", str(hist_file))
    monkeypatch.setenv("KMTRICKS_STREAM_TRACE", "1")

    rng = np.random.default_rng(29)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        write_fasta(p, random_reads(rng, 4200, 64, 81))
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    def run(d):
        opts = _opts(str(fof), tmp_path / d, soft_min="1", share_min=0,
                     threads=2)
        kmdir, config = stage_config(opts)
        repart = stage_repart(kmdir, config, opts)
        amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
        se.stage_mesh_stream(kmdir, config, opts, repart, amin,
                             chunk_windows=401_408, use_stream=True)

    run("r1")
    h = json.loads(hist_file.read_text())
    assert len(h) == 1
    (rec,) = h.values()
    assert set(rec) >= {"pair_cap", "caps", "rows_cap", "fold_in"}
    assert rec["pair_cap"] >= 1 << 14 and rec["rows_cap"] >= 1 << 12
    assert all(isinstance(c, int) for c in rec["caps"])

    # second run in a FRESH warmed-sig state (simulate a new process):
    # the history wave must fire phase B at t=0 with the recorded shape
    se._warmed_sigs.clear()
    capfd.readouterr()
    run("r2")
    out = capfd.readouterr().out
    fired = [ln for ln in out.splitlines()
             if "compile-prefetch fire: ('phaseB'" in ln]
    assert fired, "history did not fire the phase-B prefetch"
    assert f"{rec['rows_cap']})" in fired[0]

def test_adaptive_pair_cap_deep_coverage_no_overflow(tmp_path, caplog):
    """Deep-coverage adaptive sizing (the soak regime, CPU-scale): high
    duplicate structure makes quarter pair counts genome-bound rather
    than window-bound — the consolidation bump must still absorb the
    full chunks with zero overflow re-runs, byte-equal to the host
    backend."""
    import logging

    from kmtricks_tpu.runtime.pipeline import (
        resolve_soft_min, stage_config, stage_repart)
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream

    rng = np.random.default_rng(31)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        starts = rng.integers(0, len(genome) - 80, 4200)   # ~100x depth
        write_fasta(p, [genome[st:st + 80] for st in starts])
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")

    host = run_pipeline(_opts(str(fof), tmp_path / "host", backend="host",
                              soft_min="1", share_min=0))

    opts = _opts(str(fof), tmp_path / "stream", soft_min="1", share_min=0,
                 threads=2)
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
    with caplog.at_level(logging.WARNING, logger="kmtricks_tpu"):
        stage_mesh_stream(kmdir, config, opts, repart, amin,
                          chunk_windows=401_408, use_stream=True)
    overflow = [r for r in caplog.records
                if "chunk pair overflow" in r.getMessage()]
    assert not overflow, [r.getMessage() for r in overflow]
    assert _matrices(kmdir) == _matrices(host)


@pytest.mark.parametrize("max_memory,device_slots,want_slots,want_src", [
    # left at its default: the device's share wins when it is larger
    (8192, 1 << 28, 1 << 28, "an eighth of the device memory"),
    (8192, 0, 1 << 27, "the default --max-memory 8192 MB"),
    # an explicit --max-memory decides, whatever the device holds
    (16000, 1 << 30, 1 << 28, "--max-memory 16000 MB"),
    (256, 1 << 28, 1 << 25, "--max-memory 256 MB"),
])
def test_table_budget_honours_max_memory(monkeypatch, max_memory,
                                         device_slots, want_slots,
                                         want_src):
    from kmtricks_tpu.runtime import stream_engine as se
    monkeypatch.setattr(se, "_device_table_slots",
                        lambda mesh, nw: device_slots)
    assert se._table_budget(max_memory, None, 3) == (want_slots, want_src)
