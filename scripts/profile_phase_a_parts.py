"""Phase A internal costs: sort, collapse, presence, phist."""
import os
import sys
import time

repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, repo)

import jax
import jax.numpy as jnp
import numpy as np

from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
enable_compile_cache()

from kmtricks_tpu.ops.table import _sat_add, _words_equal_next
from kmtricks_tpu.parallel.pipeline import _table_presence
from kmtricks_tpu.ops.count_merge import unpack_sorted

U32, I32 = jnp.uint32, jnp.int32
LAYOUT, NSAMP, NB_PARTS, HARD_MIN = "k3", 10, 64, 1
N_RUNS, CAP = 5, 1 << 23
N = N_RUNS * CAP

rng = np.random.default_rng(0)
base = np.sort(rng.integers(0, 1 << 62, N).astype(np.uint64))
w0 = ((base >> np.uint64(32)).astype(np.uint32) & np.uint32(0x7FFFFFFF))
ws = (jax.device_put(w0), jax.device_put(base.astype(np.uint32)),
      jax.device_put(rng.integers(0, 1 << 32, N, dtype=np.uint32)))
cnt = jax.device_put(rng.integers(1, 100, N, dtype=np.uint32))


def collapse(ws, cnt):
    n = cnt.shape[0]
    eq_prev = jnp.zeros((n,), dtype=bool).at[1:].set(_words_equal_next(ws))
    run_id = jnp.cumsum((~eq_prev).astype(I32))
    total = cnt
    shift = 1
    while shift < N_RUNS:
        fwd = jnp.concatenate([total[shift:], jnp.zeros((shift,), total.dtype)])
        rid_fwd = jnp.concatenate([run_id[shift:], jnp.full((shift,), -1, I32)])
        total = jnp.where(run_id == rid_fwd, _sat_add(total, fwd), total)
        shift *= 2
    return jnp.where(~eq_prev, total, U32(0))


@jax.jit
def f_collapse(ws, cnt):
    return collapse(ws, cnt)[:8]


@jax.jit
def f_presence(ws, cnt):
    c = collapse(ws, cnt)
    present, row_head, _ = _table_presence(LAYOUT, ws, c, NSAMP, HARD_MIN,
                                           None, None)
    return jnp.sum(row_head.astype(I32))


@jax.jit
def f_full(ws, cnt):
    c = collapse(ws, cnt)
    present, row_head, _ = _table_presence(LAYOUT, ws, c, NSAMP, HARD_MIN,
                                           None, None)
    nrows = jnp.sum(row_head.astype(I32))
    part_s = unpack_sorted(LAYOUT, ws, NSAMP, None, None)[0]
    pidx = jnp.where(row_head, part_s.astype(I32), I32(NB_PARTS))
    phist = jnp.zeros((NB_PARTS,), I32).at[pidx].add(I32(1), mode="drop")
    return nrows, phist


def timed(label, fn):
    r = fn(ws, cnt); jax.tree.map(np.asarray, r)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.tree.map(np.asarray, fn(ws, cnt))
        walls.append(time.perf_counter() - t0)
    print(f"{label}: {min(walls)*1e3:8.1f} ms "
          f"{[f'{w*1e3:.0f}' for w in walls]}", flush=True)


timed("collapse only          ", f_collapse)
timed("collapse+presence      ", f_presence)
timed("collapse+presence+phist", f_full)
