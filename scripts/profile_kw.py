"""Measure the kw packed layout vs the generic multi-operand sort path
for wide kmer keys (k > 32) on the chip.

The kw layout packs (valid|part|2k-bit key|sample) into ceil((1+pb+2k+sb)/32)
u32 sort operands vs the generic path's 2+nw; at the measured ~+2.7ms per
extra operand (4.19M rows) the predicted win is ~8ms for k=33..40 (3 ops vs
6) and ~5ms for k=41..55 (4 vs 6).
"""

import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
    enable_compile_cache()

    from kmtricks_tpu.ops.count_merge import count_merge_keys, packed_layout

    N = 4 * 1024 * 1024 + 65536
    NSAMP, NB_PARTS = 8, 64
    PB = (NB_PARTS - 1).bit_length()
    rng = np.random.default_rng(0)

    def inputs(nw, kb):
        part = rng.integers(0, NB_PARTS, N).astype(np.int32)
        words = []
        for j in range(nw):
            b = kb - 32 * (nw - 1 - j)
            if b <= 0:
                words.append(np.zeros(N, np.uint32))
            else:
                words.append(rng.integers(0, 1 << min(b, 32), N,
                                          dtype=np.uint64).astype(np.uint32))
        samp = rng.integers(0, NSAMP, N).astype(np.int32)
        valid = rng.random(N) < 0.97
        return (jnp.asarray(part), tuple(map(jnp.asarray, words)),
                jnp.asarray(samp), jnp.asarray(valid))

    amin = jnp.full(NSAMP, 2, dtype=jnp.uint32)

    def rate(k, nw, key_bits, part_bits, label, iters=10):
        part, keys, samp, valid = inputs(nw, 2 * k)

        def run():
            return count_merge_keys(
                part, keys, samp, valid, amin, nsamp=NSAMP, hard_min=2,
                rmin=1, save_if=2, count_max=255, with_stats=False,
                part_follows_keys=False, key_bits=key_bits,
                part_bits=part_bits)

        out = run()
        np.asarray(out[3][:8])
        t0 = time.perf_counter()
        for _ in range(iters):
            out = run()
        np.asarray(out[3][:8])
        dt = (time.perf_counter() - t0) / iters * 1e3
        lay = packed_layout(NSAMP, nw, False, key_bits, part_bits)
        print(f"k={k:3d} {label:28s} layout={str(lay):14s} {dt:7.2f} ms",
              flush=True)
        return dt

    for k, nw in ((33, 4), (45, 4), (64, 4), (96, 6), (128, 8)):
        rate(k, nw, 2 * k, PB, "kw packed")
        rate(k, nw, None, None, "generic (2+nw operands)")


if __name__ == "__main__":
    main()
