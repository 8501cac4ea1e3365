"""Measure lax.sort cost vs operand count AND operand width on the chip.

Question: NOTES.md records ~flat +2.7ms per extra u32 operand at 4.19M rows
(1 op 9.6 / 2 ops 12.5 / 3 ops 15.0 / 4 ops 18.3) — is that data movement
(then u8/u16 operands should be ~4x/2x cheaper) or per-operand stage cost
(then width won't matter)? If a narrow third operand is cheap, the k-mer
mode fused step (k=31, nsamp<=256) can ride (u32, u32, u8-sample) instead
of three packed u32 words.

Also: keys-only vs key+value comparator cost, and a u64 single-operand
sort (x64) as a 2-word alternative.
"""

import os
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
    enable_compile_cache()

    N = 4 * 1024 * 1024 + 65536     # ~4.19M, the bench step size

    rng = np.random.default_rng(0)
    a32 = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    b32 = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    c32 = jnp.asarray(rng.integers(0, 2**32, N, dtype=np.uint32))
    c16 = jnp.asarray(rng.integers(0, 2**16, N, dtype=np.uint16))
    c8 = jnp.asarray(rng.integers(0, 2**8, N, dtype=np.uint8))

    def rate(fn, args, label, iters=10):
        f = jax.jit(fn)
        out = f(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:8])
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*args)
        np.asarray(jax.tree_util.tree_leaves(out)[0].ravel()[:8])
        dt = (time.perf_counter() - t0) / iters * 1e3
        print(f"{label:44s} {dt:7.2f} ms", flush=True)
        return dt

    rate(lambda a: jax.lax.sort((a,), dimension=0, num_keys=1),
         (a32,), "1 key u32")
    rate(lambda a, b: jax.lax.sort((a, b), dimension=0, num_keys=2),
         (a32, b32), "2 keys u32")
    rate(lambda a, b, c: jax.lax.sort((a, b, c), dimension=0, num_keys=3),
         (a32, b32, c32), "3 keys u32")
    rate(lambda a, b, c: jax.lax.sort((a, b, c), dimension=0, num_keys=3),
         (a32, b32, c16), "2 keys u32 + key u16")
    rate(lambda a, b, c: jax.lax.sort((a, b, c), dimension=0, num_keys=3),
         (a32, b32, c8), "2 keys u32 + key u8")
    rate(lambda a, b, c: jax.lax.sort((a, b, c), dimension=0, num_keys=2),
         (a32, b32, c8), "2 keys u32 + VALUE u8")
    rate(lambda a, b, c: jax.lax.sort((a, b, c), dimension=0, num_keys=2),
         (a32, b32, c32), "2 keys u32 + VALUE u32")
    rate(lambda a, c: jax.lax.sort((a, c), dimension=0, num_keys=1),
         (a32, c8), "1 key u32 + VALUE u8")
    rate(lambda a, c: jax.lax.sort((a, c), dimension=0, num_keys=1),
         (a32, c32), "1 key u32 + VALUE u32")

    # u64 single operand (2-word alternative): needs x64
    try:
        import jax.experimental
        jax.config.update("jax_enable_x64", True)
        a64 = jnp.asarray(
            rng.integers(0, 2**63, N, dtype=np.uint64), dtype=jnp.uint64)
        rate(lambda a: jax.lax.sort((a,), dimension=0, num_keys=1),
             (a64,), "1 key u64 (x64)")
        rate(lambda a, c: jax.lax.sort((a, c), dimension=0, num_keys=1),
             (a64, c8), "1 key u64 + VALUE u8 (x64)")
    except Exception as e:      # noqa: BLE001 - probe, report and move on
        print("u64 sort unavailable:", e)


if __name__ == "__main__":
    main()
