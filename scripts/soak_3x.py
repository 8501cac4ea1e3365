"""3x-scale adaptive-cap soak on the real chip (no env pins): 30
samples x 1M genome x 30x coverage (~875M k-mers, ~900 MB FASTA)
through the production streaming engine, cold (fresh 32-sample-bucket
program family or history/cached) then warm in-process.

Exercises in anger: adaptive pair-cap consolidation sizing, mid-stream
folds under --max-memory pressure, overflow self-healing, the pipelined
tail. Prints walls + verifies matrix row totals match across runs.
"""
import os, sys, time, shutil
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo); sys.path.insert(0, os.path.join(_repo, "scripts"))
import numpy as np
import jax
from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()
from gen_synth_bank import gen_bank
from kmtricks_tpu.runtime.pipeline import PipelineOptions
from kmtricks_tpu.runtime.device_pipeline import run_mesh_pipeline

bank = os.path.join(_repo, ".bench", "soak_bank")
fof = os.path.join(bank, "bank.fof")
if not os.path.exists(fof):
    t0 = time.time()
    gen_bank(bank, nsamp=30, genome=1_000_000, coverage=30.0,
             read_len=1024, seed=77)
    print(f"bank generated in {time.time()-t0:.0f}s", flush=True)

n_kmers = 30 * (1_000_000 * 30 // 1024) * (1024 - 31 + 1)

def opts(run_dir):
    return PipelineOptions(
        fof=fof, run_dir=run_dir, kmer_size=31, hard_min=2, soft_min="2",
        mode="kmer:count:bin", backend="mesh", static_repart=True,
        nb_partitions=64, threads=4, max_memory_mb=3000)

walls = []
for tag in ("cold", "warm"):
    rd = os.path.join(_repo, ".bench", f"soak_{tag}")
    shutil.rmtree(rd, ignore_errors=True)
    t0 = time.perf_counter()
    run_mesh_pipeline(opts(rd))
    w = time.perf_counter() - t0
    walls.append(w)
    print(f"SOAK {tag}: {w:.1f}s = {n_kmers/w/1e6:.1f}M kmers/s", flush=True)

import glob
sizes = {}
for tag in ("cold", "warm"):
    sizes[tag] = sorted(
        (os.path.basename(p), os.path.getsize(p))
        for p in glob.glob(os.path.join(_repo, ".bench", f"soak_{tag}", "matrices", "*")))
assert sizes["cold"] == sizes["warm"], "cold/warm matrices differ!"
import hashlib
h = {tag: hashlib.sha256(b"".join(
        open(os.path.join(_repo, ".bench", f"soak_{tag}", "matrices", n), "rb").read()
        for n, _ in sizes[tag])).hexdigest()
     for tag in ("cold", "warm")}
assert h["cold"] == h["warm"], "cold/warm matrix bytes differ!"
print("matrices byte-identical across runs; sha", h["warm"][:16], flush=True)
