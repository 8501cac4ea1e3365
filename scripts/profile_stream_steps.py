"""Time each streaming-engine device program at the e2e bench shapes.

Isolates the device cost of: the full-chunk pairs step, the table fold
merge, phase A (sort+collapse), phase B (compact) — the e2e trace shows
the engine is device-bound, so this pins down which program eats it.
Each time ends in a device_get of a small output, which waits for the
program.
"""
import os
import sys
import time

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)

import jax
import numpy as np

from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()

from jax.sharding import Mesh

from kmtricks_tpu.parallel.pipeline import (build_chunk_pairs_step,
                                            build_table_merge)

K, M, NB_PARTS, NSAMP = 31, 10, 64, 10
L, ROWS = 1024, 62872
PAIR_CAP = 1 << 23

mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
rng = np.random.default_rng(0)

pk = rng.integers(0, 256, (L // 4, ROWS), dtype=np.uint8)
cl = np.full(ROWS, L, np.int32)
cs = rng.integers(0, NSAMP, ROWS).astype(np.int32)
table = rng.integers(0, NB_PARTS, 4 ** M).astype(np.int32)

step = build_chunk_pairs_step(
    mesh, k=K, m=M, nb_parts=NB_PARTS, cap=ROWS * (L - K + 1),
    nsamp=NSAMP, mode="kmer", window_bits=None, static_repart=True,
    batch_layout="lb", mmer_canonical=True, pair_cap=PAIR_CAP,
    packed_input=True, with_vbits=False)


def timed(label, fn, sync):
    fn()  # warm (compile/load)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn()
        np.asarray(sync(out))
        walls.append(time.perf_counter() - t0)
    print(f"{label}: {min(walls)*1e3:8.1f} ms  (runs {[f'{w*1e3:.0f}' for w in walls]})",
          flush=True)
    return fn()


out = timed("chunk step (62.5M win, k3)",
            lambda: step(pk, cl, cs, table), lambda o: o[2])
pw, pc, n_pairs, dropped = out
print("  n_pairs:", np.asarray(n_pairs), flush=True)

# fold merge: table (8.4M cap) + 4 chunk runs at 8.4M cap
nw = len(pw)
for n_streams in (2, 5):
    merge = build_table_merge(mesh, nw=nw, out_cap=1 << 24,
                              n_streams=n_streams,
                              in_caps=(PAIR_CAP,) * n_streams)
    args = []
    for _ in range(n_streams):
        args.extend(list(pw) + [pc])
    timed(f"fold merge x{n_streams}", lambda: merge(*args),
          lambda o: o[2])

# phase A at the e2e accumulated width: 5 runs of 8.4M cap
from kmtricks_tpu.runtime.stream_engine import _pow2ceil  # noqa: E402
from kmtricks_tpu.parallel.pipeline import build_table_sort_collapse  # noqa: E402
from kmtricks_tpu.parallel.pipeline import stream_layout  # noqa: E402

layout = stream_layout(K, M, NB_PARTS, NSAMP, "kmer", None)
print("layout:", layout, "nw:", nw, flush=True)
for n_runs in (5,):
    sortc = build_table_sort_collapse(
        mesh, layout=layout, nsamp=NSAMP, hard_min=1, n_runs=n_runs,
        key_bits=2 * K, window_bits=None, nb_parts=NB_PARTS)
    args = []
    for _ in range(n_runs):
        args.extend(list(pw) + [pc])
    pa = timed(f"phase A x{n_runs} runs (8.4M cap each)",
               lambda: sortc(*args), lambda o: o[2])

ws_d, cnt_d, nrows_a, maxc_a, phist_a = pa
nrs = np.asarray(nrows_a)
print("  nrows:", nrs, flush=True)

from kmtricks_tpu.parallel.pipeline import build_table_compact  # noqa: E402

rows_cap = max(1 << 12, _pow2ceil(int(nrs.max())))
compactf = build_table_compact(
    mesh, layout=layout, nsamp=NSAMP, key_bits=2 * K, window_bits=None,
    hard_min=1, rows_cap=rows_cap, mode="kmer")
timed(f"phase B compact (rows_cap {rows_cap})",
      lambda: compactf(*(list(ws_d) + [cnt_d])), lambda o: o[2])
