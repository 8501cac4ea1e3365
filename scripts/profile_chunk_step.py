"""Time the e2e-shaped chunk step program with device-resident inputs
(no host-device transfers) — for A/B of chunk_count_pairs internals."""
import os, sys, time
_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
import jax, jax.numpy as jnp
import numpy as np

from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()

from kmtricks_tpu.parallel.pipeline import build_chunk_pairs_step, make_mesh

mesh = make_mesh(1)
rows, L = 62872, 1024
local = rows * (L - 31 + 1)
step = build_chunk_pairs_step(
    mesh, k=31, m=10, nb_parts=64, cap=-(-local // 1), nsamp=10,
    mode="kmer", window_bits=None, static_repart=True, batch_layout="lb",
    mmer_canonical=True, pair_cap=1 << 23, packed_input=True,
    with_vbits=False)
rng = np.random.default_rng(0)
pk = jnp.asarray(rng.integers(0, 256, (L // 4, rows), dtype=np.uint8))
ln = jnp.full(rows, L, jnp.int32)
sa = jnp.asarray((np.arange(rows, dtype=np.int32) * 10) // rows)
tb = jnp.asarray(np.zeros(4 ** 10, np.int32))

def fetch(out):
    return np.asarray(out[2])

fetch(step(pk, ln, sa, tb)); fetch(step(pk, ln, sa, tb))
t0 = time.perf_counter()
out = None
for _ in range(5):
    out = step(pk, ln, sa, tb)
n_pairs = fetch(out)
dt = (time.perf_counter() - t0) / 5
print(f"chunk step: {dt*1000:.0f} ms  ({local/dt/1e6:.0f}M win/s, "
      f"n_pairs {int(n_pairs.max())})")
