"""Tests that need an NVIDIA GPU (marker ``gpu``). They skip elsewhere; run
them on a card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0``."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _fof(tmp_path, nsamp=3, reads=400):
    rng = np.random.default_rng(5)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 20000)
    lines = []
    for s in range(nsamp):
        p = tmp_path / f"S{s}.fasta"
        st = rng.integers(0, len(genome) - 150, reads)
        with open(p, "wb") as f:
            for i in st:
                f.write(b">r\n" + genome[i:i + 150].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    fof = tmp_path / "t.fof"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


@pytest.mark.parametrize("mode,k", [("kmer:count:bin", 31),
                                    ("hash:bf:bin", 31),
                                    ("kmer:count:bin", 45)])
def test_mesh_on_gpu_matches_host(gpu_device, tmp_path, monkeypatch, mode,
                                  k):
    from kmtricks_tpu.runtime.pipeline import PipelineOptions, run_pipeline
    fof = _fof(tmp_path)
    kw = dict(fof=fof, kmer_size=k, hard_min=1, soft_min="2", share_min=1,
              mode=mode, nb_partitions=4, bloom_size=1 << 20)
    monkeypatch.setenv("KMTRICKS_REPART_SAMPLER", "host")
    host = run_pipeline(PipelineOptions(run_dir=str(tmp_path / "h"),
                                        backend="host", **kw))
    monkeypatch.delenv("KMTRICKS_REPART_SAMPLER")
    gpu = run_pipeline(PipelineOptions(run_dir=str(tmp_path / "g"),
                                       backend="mesh", **kw))
    cf, m, _ = mode.split(":")
    for p in range(4):
        for path in (host.get_matrix_path(p, m, "bin", cf, False),
                     host.get_merge_info_path(p)):
            g = path.replace(str(tmp_path / "h"), str(tmp_path / "g"))
            assert open(path, "rb").read() == open(g, "rb").read(), path
    assert (open(host.repart_path, "rb").read()
            == open(gpu.repart_path, "rb").read())


def test_device_sampler_matches_host_on_gpu(gpu_device, tmp_path,
                                            monkeypatch):
    import types

    from kmtricks_tpu.runtime.pipeline import sample_minimizer_bins
    fof = _fof(tmp_path, nsamp=1, reads=3000)
    path = fof.replace("t.fof", "S0.fasta")
    kmdir = types.SimpleNamespace(fof=[types.SimpleNamespace(paths=[path])])
    config = types.SimpleNamespace(kmer_size=31, minim_size=10,
                                   seq_number=3000)
    bins = {}
    for mode in ("device", "host"):
        monkeypatch.setenv("KMTRICKS_REPART_SAMPLER", mode)
        bins[mode] = sample_minimizer_bins(kmdir, config)
    np.testing.assert_array_equal(bins["device"], bins["host"])
