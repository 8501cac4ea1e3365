"""Device SampleRepart tally parity: the device kx-mer-start sampler
(ops/repart_sample.py) must produce bit-identical bins to the host numpy
tally for any bank — same minimizers, strand flips, run breaks and mod-4
starts (RepartitionAlgorithm.cpp:157-243 semantics)."""

import os
import types

import numpy as np
import pytest

from kmtricks_tpu.runtime import pipeline as P

rng = np.random.default_rng(20260820)


def _random_reads(n, lmin, lmax, n_frac=0.05):
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    reads = []
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        s = rng.choice(alphabet, size=ln)
        nmask = rng.random(ln) < n_frac
        s[nmask] = ord("N")
        reads.append(bytes(s.astype(np.uint8)))
    return reads


def _fake_run(tmp_path, reads, k, m, name="s"):
    p = tmp_path / f"{name}.fasta"
    with open(p, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.decode()}\n")
    entry = types.SimpleNamespace(paths=[str(p)])
    kmdir = types.SimpleNamespace(fof=[entry])
    config = types.SimpleNamespace(kmer_size=k, minim_size=m,
                                   seq_number=len(reads))
    return kmdir, config


def _both_backends(kmdir, config, freq_order=None):
    old = os.environ.get("KMTRICKS_REPART_SAMPLER")
    try:
        os.environ["KMTRICKS_REPART_SAMPLER"] = "host"
        host = P.sample_minimizer_bins(kmdir, config,
                                       freq_order=freq_order)
        os.environ["KMTRICKS_REPART_SAMPLER"] = "device"
        dev = P.sample_minimizer_bins(kmdir, config,
                                      freq_order=freq_order)
    finally:
        if old is None:
            os.environ.pop("KMTRICKS_REPART_SAMPLER", None)
        else:
            os.environ["KMTRICKS_REPART_SAMPLER"] = old
    return host, dev


@pytest.mark.parametrize("k,m", [(17, 6), (31, 8), (31, 6), (45, 6),
                                 (65, 6)])
def test_tally_parity_random_bank(tmp_path, k, m):
    reads = _random_reads(400, k - 3, 3 * k)   # incl. too-short reads
    kmdir, config = _fake_run(tmp_path, reads, k, m)
    host, dev = _both_backends(kmdir, config)
    assert host.sum() > 0
    np.testing.assert_array_equal(host, dev)


def test_tally_parity_freq_order(tmp_path):
    k, m = 31, 6
    reads = _random_reads(300, 40, 120)
    kmdir, config = _fake_run(tmp_path, reads, k, m)
    rg = 4 ** m
    # a plausible freq table: random ranks, unseen stay at rg, top pinned
    freq = np.full(rg, rg, dtype=np.uint64)
    seen = rng.choice(rg, size=rg // 2, replace=False)
    freq[seen] = rng.permutation(len(seen)).astype(np.uint64)
    freq[rg - 1] = rg - 1
    host, dev = _both_backends(kmdir, config, freq_order=freq)
    assert host.sum() > 0
    np.testing.assert_array_equal(host, dev)


def test_tally_parity_homopolymer_strand_flips(tmp_path):
    # palindromes/homopolymers stress the strand-flip run breaks
    k, m = 21, 4
    reads = [b"A" * 60, b"ACGT" * 20, b"AT" * 40,
             b"ACGTACGTNNACGTACGTACGTAC" * 3]
    kmdir, config = _fake_run(tmp_path, reads, k, m)
    host, dev = _both_backends(kmdir, config)
    np.testing.assert_array_equal(host, dev)


def test_stage_repart_device_byte_identical(tmp_path):
    """stage_repart under the device sampler writes a byte-identical
    repartition table."""
    from kmtricks_tpu.io.fof import Fof
    from kmtricks_tpu.runtime.kmdir import KmDir
    from kmtricks_tpu.runtime.pipeline import PipelineOptions, stage_config

    reads = _random_reads(500, 60, 140)
    fasta = tmp_path / "b.fasta"
    with open(fasta, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r.decode()}\n")
    fof = tmp_path / "b.fof"
    fof.write_text(f"D1 : {fasta}\n")

    tables = {}
    old = os.environ.get("KMTRICKS_REPART_SAMPLER")
    try:
        for mode in ("host", "device"):
            os.environ["KMTRICKS_REPART_SAMPLER"] = mode
            opts = PipelineOptions(fof=str(fof),
                                   run_dir=str(tmp_path / f"run_{mode}"),
                                   kmer_size=25, minim_size=6,
                                   nb_partitions=8)
            kmdir, config = stage_config(opts)
            P.stage_repart(kmdir, config, opts)
            tables[mode] = open(kmdir.repart_path, "rb").read()
    finally:
        if old is None:
            os.environ.pop("KMTRICKS_REPART_SAMPLER", None)
        else:
            os.environ["KMTRICKS_REPART_SAMPLER"] = old
    assert tables["host"] == tables["device"]


def test_tally_parity_multi_block_variable_lengths(tmp_path, monkeypatch):
    """Blocks that split batches at the block boundary with length
    variance across the split (advisor r3 finding: copy width must clamp
    to the block's bucketed L) — patch the block size small so a few
    hundred reads span many blocks, with width buckets changing between
    them."""
    k, m = 31, 6
    # alternate short reads with occasional very long ones so the width
    # bucket flips mid-buffer and blocks flush at different (B, L) shapes
    reads = []
    reads += _random_reads(150, 40, 100)
    reads += _random_reads(3, 700, 900)     # forces a wider bucket
    reads += _random_reads(150, 40, 100)
    reads += _random_reads(2, 1200, 1500)
    reads += _random_reads(100, 40, 100)
    order = rng.permutation(len(reads))
    reads = [reads[i] for i in order]
    kmdir, config = _fake_run(tmp_path, reads, k, m)
    monkeypatch.setenv("KMTRICKS_REPART_BLOCK", "128")
    host, dev = _both_backends(kmdir, config)
    assert host.sum() > 0
    np.testing.assert_array_equal(host, dev)
