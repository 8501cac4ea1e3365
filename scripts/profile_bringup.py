"""GPU bring-up measurements of the count+merge device path.

Times, each to ``block_until_ready`` (median of ``--iters`` calls after two
warm-up calls), at the streaming chunk width (~62.5M k-mer windows of
150 bp reads in 256-wide rows, as the engine pads them):

- a large device-to-device copy (the rate the stages are read against);
- the fused single-device step (encode -> sort -> segment stage) in hash
  ("h1") and k-mer ("k3") mode, and each of its three parts alone, with
  the segment stage's bytes moved over its time against the copy rate;
- which sort XLA emitted for each layout (a CUB radix-sort custom call or
  XLA's own sort);
- the streaming engine's chunk step and its pair extraction
  (ops/table.chunk_count_pairs) alone;
- the repartition sampler on a 1M x 150 bp bank, device against host
  (bins must be equal);
- compile time of the chunk-width step: first compile with the
  persistent cache as the environment sets it, then again from the
  persistent cache after ``jax.clear_caches()``.

``--mesh N`` instead times the sharded fused step over N devices and the
receiver's sort of the routed runs alone. ``--trace DIR`` also writes a
profiler trace of three fused steps and prints the device kernels that
take the most time.

Usage: python scripts/profile_bringup.py [--mesh 4] [--trace DIR]
Needs a GPU; prints one line per measurement and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from gen_synth_bank import BASES, gen_bank, simulate_reads  # noqa: E402

K, M, NSAMP, NB_PARTS, WINDOW_BITS = 31, 10, 10, 64, 250048
L, READ_LEN = 256, 150
CHUNK_WINDOWS = 62_500_000
RESULTS: dict = {}


def say(key, value, note=""):
    RESULTS[key] = value
    print(f"{key}: {value}{'  ' + note if note else ''}", flush=True)


def timeit(fn, *args, iters=10):
    import jax
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def nbytes(tree) -> int:
    import jax
    return sum(int(x.size) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree))


def chunk_args(rows: int, seed: int = 1):
    """(L, rows) u8 reads from one random genome (20x-like duplication),
    lengths, sample ids, repartition table and soft-min vector."""
    import jax.numpy as jnp

    from kmtricks_tpu.core.repartition import Repartition
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, rows * READ_LEN // 20).astype(np.uint8)
    batch = np.full((rows, L), ord("N"), np.uint8)
    batch[:, :READ_LEN] = BASES[simulate_reads(rng, genome, rows, READ_LEN)]
    rep = Repartition.from_xxh(NB_PARTS, M)
    return (jnp.asarray(np.ascontiguousarray(batch.T)),
            jnp.asarray(np.full(rows, READ_LEN, np.int32)),
            jnp.asarray((np.arange(rows, dtype=np.int32) * NSAMP) // rows),
            jnp.asarray(rep.table.astype(np.int32)),
            jnp.asarray(np.full(NSAMP, 2, np.uint32)))


def sort_kind(lowered_text: str) -> str:
    """Which sort a compiled GPU program runs."""
    t = lowered_text.lower()
    if "cub" in t and "sort" in t:
        return "cub-radix-sort"
    if " sort(" in t or "sort." in t:
        return "xla-sort"
    return "none-found"


def copy_rate() -> float:
    import jax
    import jax.numpy as jnp
    x = jnp.arange(1 << 28, dtype=jnp.uint32)          # 1 GiB
    f = jax.jit(lambda v: v ^ jnp.uint32(1))
    t = timeit(f, x)
    rate = 2 * x.nbytes / t
    say("copy_bytes_per_s", round(rate), f"(1 GiB read + 1 GiB write, "
        f"{t * 1e3:.3f} ms)")
    return rate


def fused_parts(mode: str, args, copy_bps: float, iters: int):
    """Full fused step and its three parts at chunk width."""
    import jax

    from kmtricks_tpu.ops.count_merge import (count_merge_packed,
                                              pack_words, packed_layout,
                                              sort_packed)
    from kmtricks_tpu.parallel.pipeline import (_encode_flat,
                                                build_single_chip_step)
    kw = dict(k=K, m=M, nsamp=NSAMP, hard_min=2, rmin=1, save_if=2,
              mode=mode, static_repart_parts=NB_PARTS, with_stats=False,
              batch_layout="lb",
              window_bits=WINDOW_BITS if mode == "hash" else None)
    step = jax.jit(build_single_chip_step(**kw))
    key_bits = ((WINDOW_BITS * NB_PARTS - 1).bit_length()
                if mode == "hash" else 2 * K)
    part_bits = None if mode == "hash" else (NB_PARTS - 1).bit_length()
    layout = packed_layout(NSAMP, 2, mode == "hash", key_bits, part_bits)
    wb = WINDOW_BITS if mode == "hash" else None

    @jax.jit
    def encode(batch, lengths, samp, table):
        keys, sampw, parts, valid = _encode_flat(
            batch, lengths, samp, table, K, M, mode, wb, "auto", NB_PARTS,
            "lb", True)
        return pack_words(layout, parts, keys, sampw, valid, NSAMP)

    sort = jax.jit(lambda words: sort_packed(layout, words))

    def segment(ws, amin):
        return count_merge_packed(
            ws, amin, layout=layout, nsamp=NSAMP, hard_min=2, rmin=1,
            save_if=2, with_stats=False, key_bits=key_bits, window_bits=wb,
            sorted_runs=1)

    words = encode(*args[:4])
    ws = sort(words)
    n = int(words[0].shape[0])
    t_step = timeit(step, *args, iters=iters)
    t_enc = timeit(encode, *args[:4], iters=iters)
    t_sort = timeit(sort, words, iters=iters)
    t_seg = timeit(segment, ws, args[4], iters=iters)
    seg_bytes = nbytes(ws) + nbytes(jax.eval_shape(segment, ws, args[4]))
    kind = sort_kind(sort.lower(words).compile().as_text())
    tag = f"fused_{mode}_{layout}"
    say(f"{tag}_entries", n)
    say(f"{tag}_step_ms", round(t_step * 1e3, 3),
        f"({n / t_step:.0f} windows/s)")
    say(f"{tag}_encode_ms", round(t_enc * 1e3, 3))
    say(f"{tag}_sort_ms", round(t_sort * 1e3, 3),
        f"({len(words)} u32 operand(s), {kind})")
    say(f"{tag}_sort_share_of_step", round(t_sort / t_step, 4))
    say(f"{tag}_segment_ms", round(t_seg * 1e3, 3))
    say(f"{tag}_segment_share_of_step", round(t_seg / t_step, 4))
    rate = seg_bytes / t_seg
    say(f"{tag}_segment_bytes_per_s", round(rate),
        f"({seg_bytes} bytes in+out; {rate / copy_bps:.3f} of the copy "
        "rate)")
    say(f"{tag}_segment_copy_fraction", round(rate / copy_bps, 4))
    return step, t_step


def stream_chunk(args, iters: int):
    """The streaming engine's chunk step and its pair extraction."""
    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.ops.count_merge import sort_packed
    from kmtricks_tpu.ops.encode import pack_2bit_host_clean
    from kmtricks_tpu.ops.table import chunk_count_pairs
    from kmtricks_tpu.parallel.pipeline import (build_chunk_pairs_step,
                                                make_mesh, stream_layout)
    rows = int(args[0].shape[1])
    n = rows * (L - K + 1)
    pair_cap = 1 << 23
    mesh = make_mesh(1)
    step = build_chunk_pairs_step(
        mesh, k=K, m=M, nb_parts=NB_PARTS, cap=n, nsamp=NSAMP, mode="kmer",
        pair_cap=pair_cap, packed_input=True, with_vbits=False)
    batch = np.asarray(args[0]).T
    packed, _vbits, _clean = pack_2bit_host_clean(batch, np.asarray(args[1]))
    pk = jnp.asarray(np.ascontiguousarray(packed.T))
    sargs = (pk, args[1], args[2], args[3])
    t_step = timeit(step, *sargs, iters=iters)
    layout = stream_layout(K, M, NB_PARTS, NSAMP, "kmer", None)
    rng = np.random.default_rng(5)
    sorted_words = sort_packed(layout, tuple(
        jnp.asarray(np.sort(rng.integers(0, 1 << 31, n, dtype=np.uint64)
                            .astype(np.uint32)))
        for _ in range(3)))
    pairs = jax.jit(lambda ws: chunk_count_pairs(ws, pair_cap))
    t_pairs = timeit(pairs, sorted_words, iters=iters)
    say("stream_chunk_step_ms", round(t_step * 1e3, 3),
        f"({n} windows, layout {layout}, {n / t_step:.0f} windows/s)")
    say("stream_chunk_pairs_ms", round(t_pairs * 1e3, 3),
        f"(share {t_pairs / t_step:.4f} of the chunk step)")
    return step, sargs


def sampler(work: str, nreads: int = 1_000_000):
    import types

    from kmtricks_tpu.runtime.pipeline import sample_minimizer_bins
    bank_dir = os.path.join(work, f"repart{nreads}")
    bank = os.path.join(bank_dir, "S0.fasta")
    if not os.path.exists(bank):
        gen_bank(bank_dir, nsamp=1, genome=nreads * READ_LEN, coverage=1.0,
                 read_len=READ_LEN, seed=11, snp_rate=0.0)
    kmdir = types.SimpleNamespace(
        fof=[types.SimpleNamespace(paths=[bank])])
    config = types.SimpleNamespace(kmer_size=K, minim_size=M,
                                   seq_number=nreads)
    out = {}
    for mode in ("device", "host"):
        os.environ["KMTRICKS_REPART_SAMPLER"] = mode
        walls = []
        for _ in range(2 if mode == "device" else 1):
            t0 = time.perf_counter()
            out[mode] = sample_minimizer_bins(kmdir, config)
            walls.append(time.perf_counter() - t0)
        say(f"repart_sampler_{mode}_s_{nreads}x150bp", round(min(walls), 3),
            f"(walls {[round(w, 3) for w in walls]}; first includes "
            "compile)" if mode == "device" else
            f"(walls {[round(w, 3) for w in walls]})")
    os.environ.pop("KMTRICKS_REPART_SAMPLER")
    if not np.array_equal(out["device"], out["host"]):
        raise SystemExit("device sampler bins != host sampler bins")
    say("repart_sampler_bins_equal", True)


def compile_times(args):
    import jax
    from jax import monitoring

    from kmtricks_tpu.parallel.pipeline import build_single_chip_step
    hits = [0]

    def on_event(event, **_kw):
        if event == "/jax/compilation_cache/cache_hits":
            hits[0] += 1

    monitoring.register_event_listener(on_event)
    kw = dict(k=K, m=M, nsamp=NSAMP + 1, hard_min=2, rmin=1, save_if=2,
              mode="kmer", static_repart_parts=NB_PARTS, with_stats=False,
              batch_layout="lb")
    for label in ("first", "after_clear_caches"):
        hits[0] = 0
        jax.clear_caches()
        t0 = time.perf_counter()
        jax.jit(build_single_chip_step(**kw)).lower(*args).compile()
        say(f"compile_kmer_step_{label}_s",
            round(time.perf_counter() - t0, 3),
            f"({hits[0]} persistent-cache hits; cache dir "
            f"{jax.config.jax_compilation_cache_dir})")


def trace_top(step, args, out_dir: str, top: int = 15):
    import jax
    jax.block_until_ready(step(*args))
    with jax.profiler.trace(out_dir):
        for _ in range(3):
            jax.block_until_ready(step(*args))
    import glob
    paths = glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        print("trace: no xplane file written", flush=True)
        return
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(sorted(paths)[-1])
    tot: dict = {}
    busy = 0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
                busy += ev.duration_ns
    print(f"trace: {busy / 3e6:.3f} ms of device events per step "
          f"(summed over lines)", flush=True)
    for name, ns in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ns / 3e6:10.3f} ms/step  {name[:110]}", flush=True)


def mesh_step(ndev: int, iters: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from kmtricks_tpu.ops.count_merge import sort_packed
    from kmtricks_tpu.parallel.pipeline import (build_sharded_pipeline,
                                                make_mesh)
    mesh = make_mesh(ndev)
    rows = ndev * (CHUNK_WINDOWS // (L - K + 1) // 8 * 8)
    args = chunk_args(rows)
    sh_b = NamedSharding(mesh, P(None, "d"))
    sh_v = NamedSharding(mesh, P("d"))
    rep = NamedSharding(mesh, P())
    args = (jax.device_put(args[0], sh_b), jax.device_put(args[1], sh_v),
            jax.device_put(args[2], sh_v), jax.device_put(args[3], rep),
            jax.device_put(args[4], rep))
    local = rows * (L - K + 1) // ndev
    cap = local // ndev * 3 // 2
    step = build_sharded_pipeline(
        mesh, k=K, m=M, nb_parts=NB_PARTS, cap=cap, nsamp=NSAMP,
        hard_min=2, rmin=1, save_if=2, mode="kmer", static_repart=True,
        with_stats=False, batch_layout="lb")
    t_step = timeit(step, *args, iters=iters)
    # the receiver's re-sort: ndev routed runs of cap entries per device
    rng = np.random.default_rng(4)
    width = ndev * cap
    words = tuple(jax.device_put(jnp.asarray(
        rng.integers(0, 1 << 31, ndev * width, dtype=np.uint64)
        .astype(np.uint32)), sh_v) for _ in range(3))
    sort = jax.jit(jax.shard_map(
        lambda *w: sort_packed("k3", w), mesh=mesh,
        in_specs=(P("d"),) * 3, out_specs=(P("d"),) * 3))
    t_sort = timeit(sort, *words, iters=iters)
    say(f"mesh{ndev}_step_ms", round(t_step * 1e3, 3),
        f"({rows * (L - K + 1)} windows over {ndev} devices)")
    say(f"mesh{ndev}_receiver_sort_ms", round(t_sort * 1e3, 3),
        f"(3 operands x {width} per device; share "
        f"{t_sort / t_step:.4f} of the step)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--work", default=os.path.join(REPO, ".bench"))
    a = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX platform is {dev.platform}")
    from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("card", card)
    say("device", f"{dev.platform} {dev.device_kind} x{len(jax.devices())}")
    os.makedirs(a.work, exist_ok=True)
    if a.mesh:
        mesh_step(a.mesh, a.iters)
    else:
        rows = CHUNK_WINDOWS // (L - K + 1) // 8 * 8
        args = chunk_args(rows)
        compile_times(args)
        cbps = copy_rate()
        fused_parts("hash", args, cbps, a.iters)
        fused_parts("kmer", args, cbps, a.iters)
        sstep, sargs = stream_chunk(args, a.iters)
        sampler(a.work)
        if a.trace:
            trace_top(sstep, sargs, a.trace)
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
        say("peak_bytes_in_use", peak)
    print(json.dumps(RESULTS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
