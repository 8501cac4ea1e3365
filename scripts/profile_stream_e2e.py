"""Traced streaming-engine e2e run (bench.py's pipeline_e2e shape)."""
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()

os.environ.setdefault("KMTRICKS_STREAM_TRACE", "1")
os.environ.setdefault("KMTRICKS_STREAM_PAIR_CAP", str(1 << 23))
os.environ.setdefault("KMTRICKS_STREAM_CHUNK_WINDOWS", str(62_500_000))

from gen_synth_bank import gen_bank
from kmtricks_tpu.runtime.device_pipeline import run_mesh_pipeline
from kmtricks_tpu.runtime.pipeline import PipelineOptions

bank_dir = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench", "bank_v1")
fof_p = os.path.join(bank_dir, "bank.fof")
if not os.path.exists(fof_p):
    gen_bank(bank_dir, nsamp=10, genome=1_000_000, coverage=30.0,
             read_len=1024, seed=42)

def opts(run_dir):
    return PipelineOptions(
        fof=fof_p, run_dir=run_dir, kmer_size=31, hard_min=2,
        soft_min="2", mode="kmer:count:bin", backend="mesh",
        static_repart=True, nb_partitions=64, threads=4,
        max_memory_mb=6000)

n_e2e = 10 * (1_000_000 * 30 // 1024) * (1024 - 31 + 1)
runs = int(os.environ.get("RUNS", "2"))
for r in range(runs):
    shutil.rmtree(os.path.join(os.path.dirname(bank_dir), "e2e_prof"), ignore_errors=True)
    t0 = time.perf_counter()
    run_mesh_pipeline(opts(os.path.join(os.path.dirname(bank_dir), "e2e_prof")))
    w = time.perf_counter() - t0
    print(f"RUN {r}: {w:.2f}s = {n_e2e / w / 1e6:.1f}M kmers/s", flush=True)
