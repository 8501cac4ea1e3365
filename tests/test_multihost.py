"""REAL multi-process mesh test: two OS processes, 4 CPU devices each,
jax.distributed over localhost with gloo collectives (the DCN analogue),
running the fused sharded pipeline step on an 8-device global mesh.
Outputs must be bit-identical to a single-process 8-device run — the
device counterpart of the reference's multi-machine module runs
against a shared filesystem (SURVEY.md §2.5 multi-node)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_matches_single_process(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=570)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]

    loaded = [np.load(tmp_path / f"proc{pid}.npz") for pid in range(2)]

    # single-process reference on the same 8 (forced) devices
    import jax.numpy as jnp

    from kmtricks_tpu.parallel.pipeline import (build_sharded_pipeline,
                                                make_mesh)

    K, M, NB, NSAMP, B, L = 31, 10, 16, 4, 64, 160
    rng = np.random.default_rng(11)      # identical to the workers
    genome = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8),
                        size=B * L // 4)
    starts = rng.integers(0, len(genome) - L, B)
    batch = genome[starts[:, None] + np.arange(L)]
    lengths = rng.integers(K, L + 1, B).astype(np.int32)
    samp = (np.arange(B, dtype=np.int32) * NSAMP) // B
    step = build_sharded_pipeline(
        make_mesh(8), k=K, m=M, nb_parts=NB, cap=B * (L - K + 1),
        nsamp=NSAMP, hard_min=1, rmin=1, save_if=1, mode="kmer",
        static_repart=True)
    out = step(jnp.asarray(batch), jnp.asarray(lengths), jnp.asarray(samp),
               jnp.asarray(np.zeros(4 ** M, np.int32)),
               jnp.asarray(np.full(NSAMP, 2, np.uint32)))

    names = ("part", "k0", "k1", "samp", "final", "cnt", "present", "head",
             "keep")
    refs = (out[0], out[1][0], out[1][1], out[2], out[3], out[4], out[5],
            out[6], out[7])
    for name, ref in zip(names, refs):
        ref = np.asarray(ref)
        got = np.empty_like(ref)
        seen = 0
        for d in loaded:
            for key in d.files:
                if key.rsplit("_", 1)[0] == name:
                    start = int(key.rsplit("_", 1)[1])
                    piece = d[key]
                    got[start:start + len(piece)] = piece
                    seen += len(piece)
        assert seen == len(ref), name
        assert np.array_equal(got, ref), name
    for d in loaded:
        assert np.array_equal(d["stats"], np.asarray(out[8]))
        assert int(d["dropped"]) == int(np.asarray(out[9]))


def test_two_process_streaming_engine_matches_single_process(tmp_path):
    """The PRODUCTION streaming engine (stage_mesh_stream: chunked input,
    device-resident table, forced mid-stream folds) over a real
    two-process gloo mesh, coordinating through a SHARED run directory.
    The run-dir matrices and merge stats must byte-equal a
    single-process 8-device run of the same engine."""
    rng = np.random.default_rng(99)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=9000)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for r in range(200):
                start = int(rng.integers(0, len(genome) - 130))
                f.write(b">r%d\n" % r)
                f.write(genome[start:start + 130].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "s.fof"
    fof.write_text("\n".join(lines) + "\n")

    # two-process run against a shared run dir
    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_stream_worker.py")
    port = _free_port()
    run_mp = tmp_path / "run_mp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(fof),
         str(run_mp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=570)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # single-process 8-device run of the same engine + parameters
    from kmtricks_tpu.runtime.pipeline import (PipelineOptions,
                                               resolve_soft_min,
                                               stage_config, stage_repart)
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream

    os.environ["KMTRICKS_STREAM_TABLE_CAP"] = "4096"
    try:
        opts = PipelineOptions(
            fof=str(fof), run_dir=str(tmp_path / "run_sp"), kmer_size=31,
            hard_min=1, soft_min="2", share_min=2, mode="kmer:count:bin",
            static_repart=True, nb_partitions=8, backend="mesh",
            max_memory_mb=64)
        kmdir, config = stage_config(opts)
        repart = stage_repart(kmdir, config, opts)
        amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
        stage_mesh_stream(kmdir, config, opts, repart, amin,
                          chunk_windows=3000, use_stream=True,
                          n_devices=8)
    finally:
        del os.environ["KMTRICKS_STREAM_TABLE_CAP"]

    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.count", "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" / f"matrix_{p}.count",
                 "rb").read()
        assert a == b, f"partition {p}: multi-process != single-process"
        sa = open(run_mp / "merge_infos" / f"partition{p}.merge_info").read()
        sb = open(tmp_path / "run_sp" / "merge_infos" /
                  f"partition{p}.merge_info").read()
        assert sa == sb, f"partition {p} stats differ"

def _gen_bank(tmp_path, seed=99):
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=9000)
    lines = []
    for s in range(3):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for r in range(200):
                start = int(rng.integers(0, len(genome) - 130))
                f.write(b">r%d\n" % r)
                f.write(genome[start:start + 130].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "s.fof"
    fof.write_text("\n".join(lines) + "\n")
    return fof


def _spawn_two_proc(fof, run_mp, mode, soft_min, hist):
    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_stream_worker.py")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(fof),
         str(run_mp), mode, soft_min, hist],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=570)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    # sharded decode: each worker parsed PART of the collection; every
    # read was parsed exactly once across workers
    shares = [int(open(run_mp / f"decode_rows_{pid}.txt").read())
              for pid in range(2)]
    assert all(0 < s < 600 for s in shares), shares
    assert sum(shares) == 600, shares


def _single_proc_engine(fof, run_dir, mode, soft_min, hist):
    from kmtricks_tpu.runtime.device_pipeline import _is_float_quantile
    from kmtricks_tpu.runtime.pipeline import (PipelineOptions,
                                               resolve_soft_min,
                                               stage_config, stage_repart)
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream

    os.environ["KMTRICKS_STREAM_TABLE_CAP"] = "4096"
    try:
        opts = PipelineOptions(
            fof=str(fof), run_dir=str(run_dir), kmer_size=31, hard_min=1,
            soft_min=soft_min, share_min=2, mode=mode, static_repart=True,
            nb_partitions=8, backend="mesh", max_memory_mb=64,
            hist=hist == "1", threads=2)
        if _is_float_quantile(soft_min):
            opts.hist = True
        kmdir, config = stage_config(opts)
        repart = stage_repart(kmdir, config, opts)
        amin = (None if _is_float_quantile(soft_min)
                else resolve_soft_min(opts.soft_min, kmdir,
                                      len(kmdir.fof)))
        stage_mesh_stream(kmdir, config, opts, repart, amin,
                          chunk_windows=3000, use_stream=True,
                          n_devices=8)
    finally:
        del os.environ["KMTRICKS_STREAM_TABLE_CAP"]


def test_two_process_hist_and_float_softmin(tmp_path):
    """Cross-process histograms + float-quantile soft-min: two gloo processes histogram their addressable
    partitions, merge the clones through the shared run dir
    (histogram.hpp:77-135 semantics), resolve identical quantile
    thresholds, and produce matrices, stats, histograms and the
    thresholds file byte-equal to a single-process 8-device run."""
    fof = _gen_bank(tmp_path)
    run_mp = tmp_path / "run_mp"
    _spawn_two_proc(fof, run_mp, "kmer:count:bin", "0.6", "1")
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin",
                        "0.6", "1")

    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.count", "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" / f"matrix_{p}.count",
                 "rb").read()
        assert a == b, f"partition {p}: multi-process != single-process"
        sa = open(run_mp / "merge_infos" / f"partition{p}.merge_info").read()
        sb = open(tmp_path / "run_sp" / "merge_infos" /
                  f"partition{p}.merge_info").read()
        assert sa == sb, f"partition {p} stats differ"
    for s in range(3):
        ha = open(run_mp / "histograms" / f"S{s}.hist", "rb").read()
        hb = open(tmp_path / "run_sp" / "histograms" / f"S{s}.hist",
                  "rb").read()
        assert ha == hb, f"sample {s} histogram differs"
    ta = open(run_mp / "merge_amin.txt").read()
    tb = open(tmp_path / "run_sp" / "merge_amin.txt").read()
    assert ta == tb


def test_two_process_pa_device_bits(tmp_path):
    """Multi-process pa:bin rides the device pa-bits finalize
    (build_merge_finalize_bits) — the r4 multi-process tail skipped
    it. Matrices + stats byte-equal a
    single-process 8-device run."""
    fof = _gen_bank(tmp_path)
    run_mp = tmp_path / "run_mp"
    _spawn_two_proc(fof, run_mp, "kmer:pa:bin", "2", "0")
    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:pa:bin", "2", "0")

    n_nonempty = 0
    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.pa", "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" / f"matrix_{p}.pa",
                 "rb").read()
        assert a == b, f"partition {p}: multi-process != single-process"
        n_nonempty += len(a) > 64
        sa = open(run_mp / "merge_infos" / f"partition{p}.merge_info").read()
        sb = open(tmp_path / "run_sp" / "merge_infos" /
                  f"partition{p}.merge_info").read()
        assert sa == sb, f"partition {p} stats differ"
    assert n_nonempty > 0


def test_two_process_heterogeneous_banks(tmp_path):
    """Sample-striped decode with WILDLY uneven banks: the LPT
    assignment gives one worker the big bank and the other the small
    ones; the small-side worker exhausts its stripe chunks earlier and
    must contribute padding shards through the continuation consensus.
    One bank carries interior 'N' bytes, so the validity-plane program
    variant must be agreed per chunk even when only one process's shard
    needs it. Byte parity vs a single-process 8-device run."""
    rng = np.random.default_rng(123)
    genome = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=9000)
    sizes = [500, 60, 40]
    lines = []
    for s, nreads in enumerate(sizes):
        p = tmp_path / f"S{s}.fasta"
        with open(p, "wb") as f:
            for r in range(nreads):
                start = int(rng.integers(0, len(genome) - 130))
                seq = bytearray(genome[start:start + 130].tobytes())
                if s == 1 and r % 3 == 0:
                    seq[50] = ord("N")     # interior invalid byte
                f.write(b">r%d\n" % r)
                f.write(bytes(seq) + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "s.fof"
    fof.write_text("\n".join(lines) + "\n")

    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_stream_worker.py")
    port = _free_port()
    run_mp = tmp_path / "run_mp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["KMTRICKS_TEST_TOTAL_READS"] = str(sum(sizes))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), str(fof),
         str(run_mp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    outs = [p.communicate(timeout=570)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    shares = sorted(int(open(run_mp / f"decode_rows_{pid}.txt").read())
                    for pid in range(2))
    # LPT: the small banks (60+40) go to one worker, the big one to the
    # other — each parsed exactly its stripe
    assert shares == [100, 500], shares

    _single_proc_engine(fof, tmp_path / "run_sp", "kmer:count:bin", "2",
                        "0")
    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.count", "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" / f"matrix_{p}.count",
                 "rb").read()
        assert a == b, f"partition {p}: multi-process != single-process"


def test_three_process_streaming_engine(tmp_path):
    """Three gloo processes (12 global devices, more devices than the 8
    partitions — some devices own no partition): the continuation
    consensus, LPT striping and the shared-run-dir write contract must
    hold for non-power-of-two process counts too. Byte parity vs
    single-process."""
    fof = _gen_bank(tmp_path, seed=201)
    worker = os.path.join(os.path.dirname(__file__),
                          "multihost_stream_worker.py")
    port = _free_port()
    run_mp = tmp_path / "run_mp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "3", str(port), str(fof),
         str(run_mp)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(3)]
    outs = [p.communicate(timeout=570)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    shares = [int(open(run_mp / f"decode_rows_{pid}.txt").read())
              for pid in range(3)]
    assert sorted(shares) == [200, 200, 200], shares

    from kmtricks_tpu.runtime.pipeline import (PipelineOptions,
                                               resolve_soft_min,
                                               stage_config, stage_repart)
    from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream
    os.environ["KMTRICKS_STREAM_TABLE_CAP"] = "4096"
    try:
        opts = PipelineOptions(
            fof=str(fof), run_dir=str(tmp_path / "run_sp"), kmer_size=31,
            hard_min=1, soft_min="2", share_min=2, mode="kmer:count:bin",
            static_repart=True, nb_partitions=8, backend="mesh",
            max_memory_mb=64, threads=2)
        kmdir, config = stage_config(opts)
        repart = stage_repart(kmdir, config, opts)
        amin = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
        # 12 virtual devices is beyond the 8-device conftest mesh;
        # compare against the canonical 8-device single-process run —
        # matrices are device-count-invariant (order-free sums)
        stage_mesh_stream(kmdir, config, opts, repart, amin,
                          chunk_windows=3000, use_stream=True,
                          n_devices=8)
    finally:
        del os.environ["KMTRICKS_STREAM_TABLE_CAP"]
    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.count", "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" / f"matrix_{p}.count",
                 "rb").read()
        assert a == b, f"partition {p}: 3-process != single-process"


def test_two_process_hash_mode(tmp_path):
    """Two-process hash-mode run (h2 packed layout, window hashes):
    the sharded decode + device table + multi-process tail must be
    byte-equal to single-process for the hash count format too (the
    other gloo suites all run kmer mode)."""
    fof = _gen_bank(tmp_path, seed=303)
    run_mp = tmp_path / "run_mp"
    _spawn_two_proc(fof, run_mp, "hash:count:bin", "2", "0")
    _single_proc_engine(fof, tmp_path / "run_sp", "hash:count:bin", "2",
                        "0")
    for p in range(8):
        a = open(run_mp / "matrices" / f"matrix_{p}.count_hash",
                 "rb").read()
        b = open(tmp_path / "run_sp" / "matrices" /
                 f"matrix_{p}.count_hash", "rb").read()
        assert a == b, f"partition {p}: multi-process != single-process"
        sa = open(run_mp / "merge_infos" / f"partition{p}.merge_info").read()
        sb = open(tmp_path / "run_sp" / "merge_infos" /
                  f"partition{p}.merge_info").read()
        assert sa == sb, f"partition {p} stats differ"
