"""2000-sample presence/absence collection on the real chip: the
many-sample regime where the device pa-bits merge finalize replaces a
(rows x 2000) dense count fetch with packed bit rows + exact stats
(~30x fewer bytes). Cold (2048-sample-bucket family) then warm."""
import os, sys, time, shutil
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
import numpy as np
import jax
from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()
from kmtricks_tpu.runtime.pipeline import PipelineOptions, run_pipeline

bank = os.path.join(_repo, ".bench", "pa2000_bank")
fof = os.path.join(bank, "bank.fof")
if not os.path.exists(fof):
    os.makedirs(bank, exist_ok=True)
    g = np.random.default_rng(5).choice(
        np.frombuffer(b"ACGT", dtype=np.uint8), size=100_000)
    rr = np.random.default_rng(6)
    lines = []
    for s in range(2000):
        p = os.path.join(bank, f"S{s}.fasta")
        starts = rr.integers(0, 100_000 - 512, 12)
        with open(p, "wb") as f:
            for i, st in enumerate(starts):
                f.write(b">r%d\n" % i)
                f.write(g[st:st + 512].tobytes() + b"\n")
        lines.append(f"S{s} : {p}")
    open(fof, "w").write("\n".join(lines) + "\n")

n = 2000 * 12 * (512 - 31 + 1)
for tag in ("cold", "warm"):
    rd = os.path.join(_repo, ".bench", f"pa2000_{tag}")
    shutil.rmtree(rd, ignore_errors=True)
    t0 = time.perf_counter()
    run_pipeline(PipelineOptions(
        fof=fof, run_dir=rd, kmer_size=31, threads=4, hard_min=1,
        soft_min="1", mode="kmer:pa:bin", nb_partitions=16,
        static_repart=True, backend="mesh", max_memory_mb=256))
    w = time.perf_counter() - t0
    print(f"PA2000 {tag}: {w:.1f}s = {n/w/1e6:.2f}M kmers/s", flush=True)
import glob
tot = sum(os.path.getsize(p)
          for p in glob.glob(os.path.join(_repo, ".bench", "pa2000_warm", "matrices", "*")))
print(f"{len(glob.glob('/tmp/kmtricks_pa2000_warm/matrices/*'))} matrices, "
      f"{tot/1e6:.1f} MB", flush=True)
