"""Profile the bench e2e (warm + timed, trace on) on the GPU.

Replicates bench.py's pipeline_e2e setup exactly; prints the stream
trace timeline of the TIMED run plus phase-level walls, so regressions
in the e2e number can be attributed to a phase.
Usage: python scripts/profile_e2e.py [--adaptive]
"""
import os
import shutil
import sys
import time


os.environ.setdefault("KMTRICKS_STREAM_CHUNK_WINDOWS", "62500000")
if "--adaptive" not in sys.argv:
    os.environ.setdefault("KMTRICKS_STREAM_PAIR_CAP", str(1 << 23))

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
sys.path.insert(0, os.path.join(_repo, "scripts"))
from gen_synth_bank import gen_bank

from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()

bank_dir = os.path.join(_repo, ".bench", "bank_v1")
fof_p = os.path.join(bank_dir, "bank.fof")
if not os.path.exists(fof_p):
    gen_bank(bank_dir, nsamp=10, genome=1_000_000, coverage=30.0,
             read_len=1024, seed=42)

from kmtricks_tpu.runtime.device_pipeline import run_mesh_pipeline
from kmtricks_tpu.runtime.pipeline import PipelineOptions


def _opts(run_dir):
    return PipelineOptions(
        fof=fof_p, run_dir=run_dir, kmer_size=31, hard_min=2,
        soft_min="2", mode="kmer:count:bin", backend="mesh",
        static_repart=True, nb_partitions=64, threads=4,
        max_memory_mb=6000)


run_dir = os.path.join(_repo, ".bench", "e2e")
os.environ["KMTRICKS_STREAM_TRACE"] = "1"
shutil.rmtree(run_dir, ignore_errors=True)
t0 = time.perf_counter()
run_mesh_pipeline(_opts(run_dir))
print(f"WARM wall {time.perf_counter() - t0:.2f}s", flush=True)

shutil.rmtree(run_dir, ignore_errors=True)
t0 = time.perf_counter()
run_mesh_pipeline(_opts(run_dir))
wall = time.perf_counter() - t0
n = 10 * (1_000_000 * 30 // 1024) * (1024 - 31 + 1)
print(f"TIMED wall {wall:.2f}s = {n/wall/1e6:.1f}M kmers/s", flush=True)
