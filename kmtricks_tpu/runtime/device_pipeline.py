"""Fused mesh pipeline: reads -> matrices in ONE sharded device program.

The fused device execution mode (``--backend mesh``): instead of per-sample
count files + a later merge (the reference's disk-mediated dataflow), all
samples' reads are batched, sharded over the device mesh, routed with an
``all_to_all`` and counted+merged in a single jitted step
(parallel/pipeline.py). The run directory then receives only the final
artifacts (matrices, merge_infos, fpr) — no intermediate count files, which
is why this mode requires ``--until`` all/merge.

The whole occurrence stream must fit one fixed-shape step; the step reports
dropped occurrences if the per-device capacity is exceeded, in which case we
raise with sizing advice (the reference's nb_partitions/memory feedback
loop plays this role, ConfigurationAlgorithm.cpp:398-425).
"""

from __future__ import annotations

import logging

import numpy as np

from kmtricks_tpu.core.hashers import HashWindow
from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.host.ops import MergeResult, MergeStats
from kmtricks_tpu.io import sequences as seqio
from kmtricks_tpu.ops import u64 as U
from kmtricks_tpu.runtime.config import Config
from kmtricks_tpu.runtime.kmdir import KmDir
from kmtricks_tpu.runtime.pipeline import (
    PipelineOptions,
    parse_mode,
    resolve_soft_min,
    write_merge_outputs,
)

log = logging.getLogger("kmtricks_tpu")


def _is_float_quantile(spec) -> bool:
    """--soft-min spec is a float quantile in (0, 1) (one of the three
    forms resolve_soft_min accepts: int | quantile | per-sample file)."""
    try:
        int(spec)
        return False
    except ValueError:
        pass
    try:
        return 0 < float(spec) < 1
    except ValueError:
        return False


def _round128(x: int) -> int:
    return max(128, ((x + 127) // 128) * 128)


def _stream_sample_blocks(kmdir: KmDir, opts: PipelineOptions,
                          pad: int = ord("N"), entries=None):
    """Yield (sample_idx, batch, lengths) blocks across the collection,
    decoding up to ``opts.threads`` samples concurrently (gz inflate and
    the native parser release the GIL; a single gz stream inflates
    slower than the device consumes reads, so multi-sample collections
    decode sample-parallel, the reference's per-sample SuperKTask
    fan-out reborn).

    ``entries``: optional [(global_sample_idx, FofEntry)] subset — the
    multi-process engine stripes SAMPLES over processes so each worker
    decodes only its share (the reference fans per-sample tasks over
    workers the same way, task_scheduler.hpp:164-249)."""
    if entries is None:
        entries = list(enumerate(kmdir.fof))
    threads = min(getattr(opts, "threads", 1) or 1, len(entries))
    if threads <= 1:
        for si, entry in entries:
            for got in seqio.iter_batches(entry.paths, opts.bam_filter(),
                                          pad=pad):
                yield (si,) + got
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=threads + 2)
    DONE = object()
    err: list[BaseException] = []
    it = iter(entries)
    lock = threading.Lock()
    stop = threading.Event()

    def _put(item) -> bool:
        """put() that gives up when the consumer is gone (stop set)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            while not stop.is_set():
                with lock:
                    nxt = next(it, None)
                if nxt is None:
                    return
                si, entry = nxt
                for got in seqio.iter_batches(entry.paths,
                                              opts.bam_filter(), pad=pad):
                    if not _put((si,) + got):
                        return
        except BaseException as e:  # noqa: BLE001 - relayed to consumer
            err.append(e)
        finally:
            _put(DONE)

    ts = [threading.Thread(target=worker, daemon=True)
          for _ in range(threads)]
    for t in ts:
        t.start()
    try:
        done = 0
        while done < threads:
            if err:                 # fail fast, don't drain other samples
                raise err[0]
            item = q.get()
            if item is DONE:
                done += 1
                continue
            yield item
        if err:
            raise err[0]
    finally:
        # unblock any producer stuck on a full queue (consumer abandoned
        # mid-stream, e.g. a device error downstream)
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def stream_row_chunks(kmdir: KmDir, opts: PipelineOptions, k: int, L: int,
                      rows: int, pad: int = ord("N"),
                      first_rows: tuple = (),
                      tail_rows: int | None = None,
                      entries=None):
    """Stream the whole collection as fixed-shape (rows, L) chunks.

    Reads longer than L are split into overlapping segments (overlap
    k - 1), so every k-mer window appears exactly once; short trailing
    chunks are padded with 'N' rows (masked on device). Host RSS is
    bounded by one chunk — the replacement for materializing the whole
    collection (the reference streams banks the same way,
    BankFasta.cpp 256KB buffers).

    ``first_rows``: row counts for the FIRST flushes (then ``rows``
    thereafter) — the engine stripes the first chunk into quarters so
    decode/pack/upload pipeline from ~t=0 instead of serializing one
    full chunk before the device sees anything. All values must be
    derived from run parameters (shape determinism).

    ``tail_rows``: re-emit the FINAL partial chunk as ceil(fill/q)
    blocks of q rows (the prologue quarter shape — its programs are
    already compiled) instead of one padded full-cap chunk: a 2/3-empty
    final chunk otherwise uploads and computes on its padding."""
    step_over = L - k + 1
    pending = list(first_rows)

    def _next_cap() -> int:
        return pending.pop(0) if pending else rows

    cap0 = _next_cap()
    state = {"buf": np.full((cap0, L), pad, np.uint8),
             "ln": np.zeros(cap0, np.int32),
             "sa": np.zeros(cap0, np.int32), "fill": 0, "cap": cap0,
             "n": 0}

    def flush_full():
        from kmtricks_tpu.runtime._trace import mark
        mark(f"parse flush {state['n']} ({state['cap']} rows)")
        state["n"] += 1
        out = (state["buf"], state["ln"], state["sa"])
        c = _next_cap()
        state["buf"] = np.full((c, L), pad, np.uint8)
        state["ln"] = np.zeros(c, np.int32)
        state["sa"] = np.zeros(c, np.int32)
        state["fill"] = 0
        state["cap"] = c
        return out

    def place(block, lengths, si):
        """Bulk-copy (B, Lb<=L) rows into the chunk buffer."""
        i = 0
        while i < len(lengths):
            take = min(state["cap"] - state["fill"], len(lengths) - i)
            f0 = state["fill"]
            state["buf"][f0:f0 + take, :block.shape[1]] = block[i:i + take]
            state["ln"][f0:f0 + take] = lengths[i:i + take]
            state["sa"][f0:f0 + take] = si
            state["fill"] += take
            i += take
            if state["fill"] == state["cap"]:
                yield flush_full()

    for si, batch, lengths in _stream_sample_blocks(kmdir, opts, pad,
                                                    entries):
        keep = lengths >= k
        if not keep.all():
            batch, lengths = batch[keep], lengths[keep]
        if not len(lengths):
            continue
        if batch.shape[1] <= L:
            yield from place(batch, lengths, si)
            continue
        # mixed block: bulk-place the short reads, split the long ones
        # into overlapping segments (overlap k - 1) so every k-mer
        # window appears exactly once
        short = lengths <= L
        if short.any():
            yield from place(batch[short][:, :L], lengths[short], si)
        for row, n in zip(batch[~short], lengths[~short]):
            segs, slens = [], []
            for off in range(0, int(n) - k + 1, step_over):
                m = min(L, int(n) - off)
                if m < k:
                    break
                seg = np.full(L, pad, np.uint8)
                seg[:m] = row[off:off + m]
                segs.append(seg)
                slens.append(m)
            yield from place(np.asarray(segs),
                             np.asarray(slens, np.int32), si)
    f, cap = state["fill"], state["cap"]
    if f:
        q = tail_rows
        if q and q < cap and f <= cap - q:
            # padding rows already carry 'N' fill + length 0
            for lo in range(0, f, q):
                yield (state["buf"][lo:lo + q], state["ln"][lo:lo + q],
                       state["sa"][lo:lo + q])
        else:
            yield state["buf"], state["ln"], state["sa"]


def _pack_transpose_chunks(gen, threads: int = 4):
    """(rows, L) ASCII chunks -> 2-bit packed + validity-bit chunks in the
    transposed (L/4, rows)/(L/8, rows) device layout. The pack QUARTERS
    both the transpose work and the device-link upload (0.375 B/base vs 1
    for ASCII); two chunks pack concurrently on an ordered pool so the
    pack of chunk i+1 overlaps chunk i's downstream consumption (numpy
    releases the GIL on the big kernels)."""
    from concurrent.futures import ThreadPoolExecutor

    from kmtricks_tpu.ops.encode import pack_2bit_host_clean

    tpw = max(1, threads // 2)

    def work(item, idx):
        from kmtricks_tpu.runtime._trace import mark

        from kmtricks_tpu import native
        buf, ln, sa = item
        mark(f"pack {idx} start")
        # fused native pack+transpose (~9x the numpy passes on the bench
        # host); clean chunks (ACGT count == length for every row) skip
        # the validity plane — the device derives it from lengths,
        # cutting the chunk upload by a third (the link is the e2e
        # bottleneck)
        res = native.pack2bit_t(buf, threads=tpw)
        if res is not None and (res[1] == ln).all():
            out = (res[0], None, ln, sa)
        elif res is not None:
            # interior non-ACGT bytes: keep the native packed plane,
            # build only the validity bits in numpy (the rare path)
            valid = ((buf == 65) | (buf == 67) | (buf == 71)
                     | (buf == 84) | (buf == 97) | (buf == 99)
                     | (buf == 103) | (buf == 116))
            vbits = np.packbits(valid, axis=1, bitorder="little")
            out = (res[0], _transpose_mt(vbits, tpw), ln, sa)
        else:
            packed, vbits, _clean = pack_2bit_host_clean(buf, ln)
            out = (_transpose_mt(packed, tpw),
                   None if vbits is None else _transpose_mt(vbits, tpw),
                   ln, sa)
        mark(f"pack {idx} done")
        return out

    with ThreadPoolExecutor(max_workers=2) as ex:
        pending = []
        idx = 0
        for item in gen:
            pending.append(ex.submit(work, item, idx))
            idx += 1
            if len(pending) >= 2:
                yield pending.pop(0).result()
        for f in pending:
            yield f.result()


def _transpose_chunks(gen, threads: int = 4):
    """(rows, L) chunks -> (L, rows) for the transposed-batch device layout
    ("lb"). Runs on the prefetch thread when wrapped before
    :func:`prefetched`; the strided copy itself fans out over a thread
    pool (:func:`_transpose_mt`)."""
    for buf, ln, sa in gen:
        yield _transpose_mt(buf, threads), ln, sa


def prefetched(gen, depth: int = 2):
    """Run a generator on a background thread with a bounded queue —
    double-buffered host decode overlapping device compute (the
    reference's --focus superk/count overlap reborn). The worker starts
    EAGERLY at call time (not at first next()), so chunk-0 decode
    overlaps whatever setup runs between construction and the loop."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    END = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:   # re-raised in the consumer below
            err.append(e)
        finally:
            q.put(END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def iterate():
        while True:
            item = q.get()
            if item is END:
                if err:
                    # a decode failure must fail the run, not silently
                    # truncate the input stream
                    raise err[0]
                return
            yield item

    return iterate()


def estimate_dest_skew(kmdir: KmDir, opts: PipelineOptions, config: Config,
                       repart, ndev: int, sample_rows: int = 384) -> float:
    """Sampled fraction of k-mer occurrences routed to the busiest device
    (the reference's PartiInfo pre-sizing role, PartiInfo.hpp:44-280):
    sizes the all_to_all per-peer capacity instead of assuming the
    worst case."""
    from kmtricks_tpu.core import kmer as kops

    k, m = config.kmer_size, config.minim_size
    counts = np.zeros(ndev, dtype=np.int64)
    seen = 0
    for entry in kmdir.fof:
        for seq in seqio.iter_sequences(entry.paths, opts.bam_filter()):
            if len(seq) < k:
                continue
            codes, valid = kops.encode_ascii(seq)
            wv = kops.window_validity(valid, k)
            if wv.any():
                minim = kops.window_minimizers(
                    codes, k, m,
                    canonical_mmers=config.mmer_scheme != "forward")
                parts = repart.table[minim[wv].astype(np.int64)]
                dest = (parts.astype(np.int64) * ndev) // config.nb_partitions
                counts += np.bincount(dest, minlength=ndev)
            seen += 1
            if seen >= sample_rows:
                break
        if seen >= sample_rows:
            break
    total = counts.sum()
    if total == 0:
        return 1.0 / ndev
    return float(counts.max()) / float(total)


def _load_global_batch(kmdir: KmDir, opts: PipelineOptions, k: int,
                       ndev: int):
    import math

    entries = list(kmdir.fof)
    nthreads = min(getattr(opts, "threads", 1) or 1, len(entries))
    if nthreads > 1:
        # decode samples concurrently: gzip inflate and the native batch
        # parser both release the GIL (the reference decodes banks on its
        # TaskPool the same way, task_scheduler.hpp:164-249)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            per_sample = list(ex.map(
                lambda e: seqio.load_batch(e.paths, opts.bam_filter()),
                entries))
    else:
        per_sample = [seqio.load_batch(e.paths, opts.bam_filter())
                      for e in entries]
    n_reads = sum(b.shape[0] for b, _ in per_sample)
    if not n_reads:
        raise ValueError("no sequences")
    L = max(b.shape[1] for b, _ in per_sample)
    L = ((L + 127) // 128) * 128
    rows = math.lcm(ndev, 8)      # shard_map needs B % ndev == 0
    B = ((n_reads + rows - 1) // rows) * rows
    batch = np.full((B, L), ord("N"), dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    sarr = np.zeros(B, dtype=np.int32)
    off = 0
    for i, (b, ln) in enumerate(per_sample):
        batch[off:off + b.shape[0], :b.shape[1]] = b
        lengths[off:off + b.shape[0]] = ln
        sarr[off:off + b.shape[0]] = i
        off += b.shape[0]
    # reads shorter than k produce no valid windows (masked on device)
    return batch, lengths, sarr


def _mesh_common(kmdir: KmDir, config: Config, opts: PipelineOptions,
                 uniform_hard_min: bool = True):
    """Shared mesh-path parameters: window math + hard-min resolution.

    The fused single-step kernel applies ONE hard_min, so per-sample fof
    overrides (`! amin`) require the chunked path (host-side hard-min)."""
    cf, _mode, _out = parse_mode(opts.mode)
    window_bits = None
    if cf == "hash":
        window_bits = HashWindow.load(kmdir.hash_win).window_size_bits
    count_max = (1 << (8 * config.count_bytes)) - 1
    hard_mins = kmdir.fof.abundance_mins(opts.hard_min)
    if uniform_hard_min and len(set(hard_mins)) != 1:
        raise ValueError("per-sample hard-min overrides require the "
                         "chunked mesh path (or --backend host/device)")
    return cf, window_bits, count_max, hard_mins


def _keys_to_u64(keys_s) -> np.ndarray:
    """Kernel key words (msb-first u32 tuple) -> u64 array: (N,) for 2-word
    keys, (N, slots) little-endian u64 rows for wider (k > 32) keys."""
    keys_s = [np.asarray(w) for w in keys_s]
    if len(keys_s) == 2:
        return U.to_u64_np(keys_s[0], keys_s[1])
    return U.msb_words_to_u64_rows_np(keys_s)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _transpose_mt(batch: np.ndarray, threads: int = 4) -> np.ndarray:
    """(B, L) -> contiguous (L, B) using a thread pool — the strided
    transpose copy is slow single-threaded and numpy releases the GIL
    for large block copies."""
    B = batch.shape[0]
    threads = max(1, min(threads, (B + (1 << 14) - 1) >> 14))
    if threads <= 1:
        return np.ascontiguousarray(batch.T)
    out = np.empty((batch.shape[1], B), dtype=batch.dtype)
    from concurrent.futures import ThreadPoolExecutor
    step = -(-B // threads)

    def work(i0):
        i1 = min(B, i0 + step)
        out[:, i0:i1] = batch[i0:i1].T

    with ThreadPoolExecutor(max_workers=threads) as ex:
        list(ex.map(work, range(0, B, step)))
    return out


def stage_mesh_count_merge(kmdir: KmDir, config: Config,
                           opts: PipelineOptions, repart,
                           amin_vec: np.ndarray,
                           batch=None, lengths=None, sarr=None,
                           n_devices: int | None = None) -> None:
    import jax
    import jax.numpy as jnp

    import os as _os

    from kmtricks_tpu.ops.compact import fetch_many, narrow_cast
    from kmtricks_tpu.parallel.pipeline import (
        build_col_slice, build_sharded_pipeline, make_mesh,
        partition_to_device, shape_bucket)

    nsamp = len(kmdir.fof)
    # program-shape sample bucket (see stage_mesh_stream): nearby sample
    # counts share the fused-step programs; pad samples carry sentinel
    # hard-min/amin so they are never present, and the padded pre
    # columns strip on device before the fetch
    nsamp_p = (shape_bucket(nsamp)
               if _os.environ.get("KMTRICKS_SHAPE_BUCKET", "1") != "0"
               else nsamp)
    mesh = make_mesh(n_devices)
    ndev = mesh.shape[mesh.axis_names[0]]
    if batch is None:
        batch, lengths, sarr = _load_global_batch(
            kmdir, opts, config.kmer_size, ndev)
    n_windows = batch.shape[0] * (batch.shape[1] - config.kmer_size + 1)
    local = -(-n_windows // ndev)        # worst case: all to one device
    cf, window_bits, count_max, hard_mins = _mesh_common(
        kmdir, config, opts, uniform_hard_min=False)
    hard_min = hard_mins[0]
    # per-sample `! amin` fof overrides ride the fused kernel directly
    # (padded to the sample bucket with never-passing sentinels)
    hard_min_vec = (np.concatenate([
        np.asarray(hard_mins, dtype=np.uint32),
        np.full(nsamp_p - nsamp, 0xFFFFFFFF, np.uint32)])
        if len(set(hard_mins)) != 1 else None)

    # size the per-peer all_to_all capacity from measured minimizer skew
    # (PartiInfo pre-sizing analogue) with 1.5x headroom; overflow
    # self-heals by doubling the cap and recompiling (never a hard error)
    skew = estimate_dest_skew(kmdir, opts, config, repart, ndev)
    # quantized (shape_bucket): a raw skew-scaled int would give every
    # bank its own step-program shape
    cap = min(local, shape_bucket(int(local * skew * ndev * 1.5) + 1024))
    # per-device distinct-row capacity: distinct rows are typically far
    # below the window count (coverage deduplicates), so start at 1/32 of
    # the worst case (power of two for compile-cache hits) and double on
    # overflow — but never beyond what the compaction buffers can hold in
    # device memory (~4*(nsamp + key words + 2) bytes per row slot).
    # Oversizing costs real step time (the dense scatter target scales
    # with rows_cap).
    from kmtricks_tpu.ops.encode import device_key_words
    nw = 2 if cf == "hash" else device_key_words(config.kmer_size)
    row_bytes = 4 * (nsamp_p + nw + 2)
    # --max-memory budgets the occurrence sort; the compaction buffers
    # get their own floor (4M rows) bounded by the int32 flat-scatter
    # index space (rows_cap * nsamp < 2^31)
    rows_hbm = max(1 << 22, _pow2ceil(
        int(opts.max_memory_mb * 1e6 / 2 / row_bytes) + 1) // 2)
    rows_hbm = min(rows_hbm, _pow2ceil((1 << 31) // max(1, nsamp_p)) // 2)
    rows_cap = min(_pow2ceil(local), max(1 << 14, _pow2ceil(local) // 32),
                   rows_hbm)
    log.info("mesh step: %d reads x %d (windows %d) over %d device(s), "
             "skew %.3f cap %d/%d rows_cap %d",
             batch.shape[0], batch.shape[1], n_windows, ndev, skew, cap,
             local, rows_cap)

    def build(c, rc):
        return build_sharded_pipeline(
            mesh, k=config.kmer_size, m=config.minim_size,
            nb_parts=config.nb_partitions, cap=c, nsamp=nsamp_p,
            hard_min=hard_min, rmin=opts.recurrence_min,
            save_if=opts.share_min, mode=cf, window_bits=window_bits,
            count_max=count_max, static_repart=opts.static_repart,
            with_stats=True,    # per-partition stats computed on device
            hard_min_vec=hard_min_vec, batch_layout="lb",
            mmer_canonical=config.mmer_scheme != "forward",
            compact_rows=rc)

    amin_p = np.concatenate([np.asarray(amin_vec, np.uint32),
                             np.full(nsamp_p - nsamp, 0xFFFFFFFF,
                                     np.uint32)])
    args = (jnp.asarray(_transpose_mt(batch, getattr(opts, "threads", 4))),
            jnp.asarray(lengths), jnp.asarray(sarr),
            jnp.asarray(repart.table.astype(np.int32)),
            jnp.asarray(amin_p))
    while True:
        rows_d, pre_d, nrows_d, maxc_d, _npres_d, dropped_d = build(
            cap, rows_cap)(*args)
        # ONE batched device_get for everything small (the link pays a
        # round trip per transfer)
        nrs, maxc, ndropped = jax.device_get((nrows_d, maxc_d, dropped_d))
        if int(ndropped):
            assert cap < local, "dropped occurrences at worst-case capacity"
            cap = min(local, cap * 2)
            log.warning("mesh shuffle overflow (%d dropped) - retrying "
                        "with cap %d", int(ndropped), cap)
            continue
        if int(nrs.max()) > rows_cap:
            rows_cap = _pow2ceil(int(nrs.max()))
            if rows_cap > rows_hbm:
                raise ValueError(
                    f"partition rows ({int(nrs.max())}) exceed the device "
                    f"compaction budget ({rows_hbm} rows at "
                    f"--max-memory {opts.max_memory_mb} MB); raise "
                    "--max-memory or lower the per-step window budget so "
                    "the chunked path engages")
            log.warning("row compaction overflow - retrying with rows_cap "
                        "%d", rows_cap)
            continue
        break

    if nsamp_p != nsamp:
        # strip the shape-bucket sample padding on device before the
        # dense matrix rides the link
        pre_d = build_col_slice(mesh, nsamp)(pre_d)
    part8_d = None
    if cf == "kmer" and config.nb_partitions <= 256:
        # the partition id occupies a full u32 column of every fetched
        # row; split it into a u8 plane on device (12 -> 9 B/row)
        from kmtricks_tpu.parallel.pipeline import build_rows_narrow
        rows_d, part8_d = build_rows_narrow(mesh)(rows_d)
    part_dev = partition_to_device(config.nb_partitions, ndev)
    maxc = int(maxc)
    for d in range(ndev):
        nr = int(nrs[d])
        off = d * rows_cap
        specs = [(rows_d, nr, None, off), (pre_d, nr, narrow_cast(maxc),
                                           off)]
        if part8_d is not None:
            specs.append((part8_d, nr, None, off))
            rows, pre, part8 = fetch_many(specs)
        else:
            rows, pre = fetch_many(specs)
        pre = pre.astype(np.uint32, copy=False)
        if cf == "hash":
            keys = _keys_to_u64(tuple(rows[:, j]
                                      for j in range(rows.shape[1])))
            part_col = (keys // np.uint64(window_bits)).astype(np.int64)
        else:
            kwords = rows if part8_d is not None else rows[:, :-1]
            keys = _keys_to_u64(tuple(kwords[:, j]
                                      for j in range(kwords.shape[1])))
            slots = max(1, kwords.shape[1] // 2)
            keys = keys.reshape(nr, slots)
            part_col = (part8.astype(np.int64) if part8_d is not None
                        else rows[:, -1].astype(np.int64))
        # rows are sorted by (partition, key): partition blocks are
        # contiguous; rescue/keep/stats reconstructed from the dense
        # pre-merge counts (host/ops.py merge_dense)
        bounds = np.searchsorted(part_col, np.arange(
            config.nb_partitions + 1))
        for p in np.nonzero(part_dev == d)[0]:
            sl = slice(int(bounds[p]), int(bounds[p + 1]))
            res = hops.merge_dense(keys[sl], pre[sl], amin_vec,
                                   opts.recurrence_min, opts.share_min)
            write_merge_outputs(kmdir, config, opts, p, res)
        assert int(bounds[-1]) == nr, (int(bounds[-1]), nr, d)


def _merge_result_for_partition(keys, samp, final, cnt, present, row_head,
                                row_keep, nsamp, amin_vec, cf) -> MergeResult:
    """Reassemble a host MergeResult (rows + per-partition statistics) from
    the kernel's flat sorted outputs."""
    row_of = np.cumsum(row_head) - 1
    nrows = int(row_of[-1]) + 1 if len(row_of) and row_head.any() else 0
    ukeys = keys[row_head]
    mat = np.zeros((nrows, nsamp), dtype=np.uint32)
    pre = np.zeros((nrows, nsamp), dtype=np.uint32)
    if nrows:
        mat[row_of[present], samp[present]] = final[present]
        pre[row_of[present], samp[present]] = cnt[present]
    presence = np.zeros((nrows, nsamp), dtype=bool)
    if nrows:
        presence[row_of[present], samp[present]] = True

    amin = np.asarray(amin_vec, dtype=np.uint32)[None, :]
    solid = presence & (pre >= amin)
    rescued = presence & ~solid & (mat > 0)
    stats = MergeStats(
        non_solid=(presence & ~solid).sum(axis=0).astype(np.uint64),
        rescued=rescued.sum(axis=0).astype(np.uint64),
        uniq_wo_rescue=solid.sum(axis=0).astype(np.uint64),
        uniq_w_rescue=(solid | rescued).sum(axis=0).astype(np.uint64),
        total_wo_rescue=np.where(solid, pre, 0).sum(axis=0).astype(
            np.uint64),
        total_w_rescue=mat.astype(np.uint64).sum(axis=0),
    )
    slots = 1 if keys.ndim == 1 else keys.shape[1]
    return MergeResult(
        keys=ukeys.reshape(len(ukeys), slots) if cf == "kmer" else ukeys,
        counts=mat, keep=row_keep[row_head], stats=stats)


def stage_mesh_chunked(kmdir: KmDir, config: Config, opts: PipelineOptions,
                       repart, amin_vec: np.ndarray,
                       chunk_windows: int,
                       batch=None, lengths=None, sarr=None,
                       n_devices: int | None = None,
                       use_stream: bool = False,
                       ests=None) -> None:
    """Chunked mesh pipeline for collections larger than one device step.

    Each chunk runs the sharded step as a PURE COUNTER (hard_min=1, no
    rescue); the host aggregates partial per-partition (key, sample, count)
    tables across chunks (summing counts of keys split between chunks),
    then applies hard-min and the full merge semantics per partition. This
    is the reference's memory feedback loop (ConfigurationAlgorithm.cpp:
    398-425) reborn: the chunk size is the device-memory budget, the host
    aggregation replaces the per-partition files.

    With ``use_stream``, chunks are decoded from the banks on a background
    thread (prefetched, double-buffered with the device steps) and the
    whole collection is NEVER materialized: host RSS stays bounded by a
    few chunks regardless of collection size.
    """
    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.parallel.pipeline import (
        build_sharded_pipeline, make_mesh)

    nsamp = len(kmdir.fof)
    mesh = make_mesh(n_devices)
    ndev = mesh.shape[mesh.axis_names[0]]
    import math

    rows_align = math.lcm(ndev, 8)
    k = config.kmer_size
    if use_stream:
        if ests is None:
            ests = [seqio.estimate(e.paths) for e in kmdir.fof]
        L = max(_round128(k), min(_round128(max(e.max_size for e in ests)),
                                  4096))
        W = L - k + 1
        rows_per_chunk = max(rows_align,
                             (chunk_windows // W) // rows_align * rows_align)
        focus = opts.focus if opts.focus is not None else 0.5
        depth = max(1, int(round(focus * 4)))   # --focus 0 -> depth 1
        chunks = prefetched(_transpose_chunks(
            stream_row_chunks(kmdir, opts, k, L, rows_per_chunk),
            getattr(opts, "threads", 4) or 4), depth)
        log.info("mesh chunked (streaming): %d-row x %d chunks, prefetch "
                 "depth %d", rows_per_chunk, L, depth)
    else:
        if batch is None:
            batch, lengths, sarr = _load_global_batch(kmdir, opts, k, ndev)
        L = batch.shape[1]
        W = L - k + 1
        rows_per_chunk = max(rows_align,
                             (chunk_windows // W) // rows_align * rows_align)
        # never pad a chunk beyond the actual batch
        rows_per_chunk = min(rows_per_chunk,
                             -(-batch.shape[0] // rows_align) * rows_align)

        def _slice_chunks():
            nchunks = -(-batch.shape[0] // rows_per_chunk)
            for c in range(nchunks):
                lo = c * rows_per_chunk
                hi = min(batch.shape[0], lo + rows_per_chunk)
                pad = rows_per_chunk - (hi - lo)
                cb, cl, cs = batch[lo:hi], lengths[lo:hi], sarr[lo:hi]
                if pad:
                    cb = np.vstack([cb, np.full((pad, L), ord("N"),
                                                np.uint8)])
                    cl = np.concatenate([cl, np.zeros(pad, np.int32)])
                    cs = np.concatenate([cs, np.zeros(pad, np.int32)])
                yield cb, cl, cs

        # prefetched: the per-chunk host transpose runs on the worker
        # thread, overlapped with device steps (like the streaming path)
        chunks = prefetched(_transpose_chunks(
            _slice_chunks(), getattr(opts, "threads", 4) or 4), 2)
        log.info("mesh chunked: %d reads in %d chunk(s) of %d rows",
                 batch.shape[0], -(-batch.shape[0] // rows_per_chunk),
                 rows_per_chunk)
    cf, window_bits, count_max, hard_mins = _mesh_common(
        kmdir, config, opts, uniform_hard_min=False)

    from kmtricks_tpu.parallel.pipeline import shape_bucket as _sb
    local = -(-(rows_per_chunk * W) // ndev)
    skew = estimate_dest_skew(kmdir, opts, config, repart, ndev)
    # quantized: a raw skew-scaled int gives every bank its own shape
    cap = min(local, _sb(int(local * skew * ndev * 1.5) + 1024))

    # sample bucket (see stage_mesh_count_merge): the step only uses
    # nsamp through bucket-stable samp_bits and the amin input length;
    # sample ids in the outputs stay < the real nsamp
    import os as _os2
    nsamp_p = (_sb(nsamp)
               if _os2.environ.get("KMTRICKS_SHAPE_BUCKET", "1") != "0"
               else nsamp)

    def build(c):
        return build_sharded_pipeline(
            mesh, k=k, m=config.minim_size,
            nb_parts=config.nb_partitions, cap=c, nsamp=nsamp_p,
            hard_min=1, rmin=1, save_if=0, mode=cf, window_bits=window_bits,
            count_max=0xFFFFFFFF, static_repart=opts.static_repart,
            with_stats=False, batch_layout="lb",
            mmer_canonical=config.mmer_scheme != "forward")

    step = build(cap)
    table = jnp.asarray(repart.table.astype(np.int32))
    ones = jnp.ones(nsamp_p, dtype=jnp.uint32)

    partials: list[tuple] = []       # (part, keys, samp, cnt) per chunk
    for cb, cl, cs in chunks:
        args = (jnp.asarray(cb), jnp.asarray(cl), jnp.asarray(cs), table,
                ones)
        while True:
            outp = step(*args)
            ndropped = int(np.asarray(outp[-1]))
            if not ndropped:
                break
            assert cap < local, "dropped at worst-case capacity"
            cap = min(local, cap * 2)
            log.warning("mesh chunk overflow (%d dropped) - retrying with "
                        "cap %d", ndropped, cap)
            step = build(cap)
        (part_s, keys_s, samp_s, _final, cnt, present, _rh, _rk,
         _stats, dropped) = outp
        part_s, keys_s, samp_s, cnt, present = jax.device_get(
            (part_s, keys_s, samp_s, cnt, present))
        present = present.astype(bool)
        keys = _keys_to_u64([w[present] for w in keys_s])
        keys = keys.reshape(len(keys), -1)
        partials.append((part_s[present], keys, samp_s[present],
                         cnt[present].astype(np.uint64)))

    # host aggregation: sum counts of (part, key, sample) across chunks,
    # then (optionally) histograms, per-sample hard-min, soft-min
    # resolution (float quantiles become possible here because the full
    # pre-hard-min abundance distribution is in hand) and the merge.
    part = np.concatenate([p[0] for p in partials])
    keys = np.concatenate([p[1] for p in partials])
    samp = np.concatenate([p[2] for p in partials])
    cnt = np.concatenate([p[3] for p in partials])
    from kmtricks_tpu.core.histogram import KHist
    from kmtricks_tpu.host.ops import merge_partition
    from kmtricks_tpu.io import formats as F
    from kmtricks_tpu.runtime.filter import lex_view

    # histograms: requested explicitly, or required by a float soft-min
    # quantile (the reference requires counting with --hist first; here the
    # full distribution is in hand anyway)
    want_hists = opts.hist or (amin_vec is None
                               and _is_float_quantile(opts.soft_min))
    hists = ([KHist(s, config.kmer_size) for s in range(nsamp)]
             if want_hists else None)
    # with a resolvable soft-min, merge each partition as soon as its
    # tables are built (streaming, no extra copy); the histogram/quantile
    # case needs all tables first (amin depends on the full distribution)
    streaming = amin_vec is not None and hists is None
    tables: dict[tuple[int, int], tuple] = {}

    def build_tables(p):
        sel = part == p
        pk, ps, pc = keys[sel], samp[sel], cnt[sel]
        keys_list, counts_list = [], []
        for s in range(nsamp):
            m_s = ps == s
            kk, cc = pk[m_s], pc[m_s]
            if len(kk):
                order = np.argsort(lex_view(kk), kind="stable")
                kk, cc = kk[order], cc[order]
                view = lex_view(kk)
                head = np.ones(len(kk), dtype=bool)
                head[1:] = view[1:] != view[:-1]
                idx = np.cumsum(head) - 1
                summed = np.zeros(int(idx[-1]) + 1, dtype=np.uint64)
                np.add.at(summed, idx, cc)
                kk = kk[head]
                cc = summed
            if hists is not None:
                hists[s].inc_counts(cc)
            solid = cc >= hard_mins[s]
            kk, cc = kk[solid], np.minimum(cc[solid], count_max)
            keys_list.append(kk if cf == "kmer" else kk.ravel())
            counts_list.append(cc.astype(np.uint32))
        return keys_list, counts_list

    def merge_and_write(p, keys_list, counts_list):
        res = merge_partition(keys_list, counts_list, amin_vec,
                              opts.recurrence_min, opts.share_min)
        write_merge_outputs(kmdir, config, opts, p, res)

    for p in range(config.nb_partitions):
        kl, cl = build_tables(p)
        if streaming:
            merge_and_write(p, kl, cl)
        else:
            tables[p] = (kl, cl)

    if not streaming:
        if hists is not None:
            for s, entry in enumerate(kmdir.fof):
                F.write_hist_file(kmdir.get_hist_path(entry.id), hists[s])
        if amin_vec is None:
            amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
        for p in range(config.nb_partitions):
            merge_and_write(p, *tables[p])


def _needs_host_aggregation(opts: PipelineOptions, kmdir: KmDir) -> bool:
    if opts.hist:
        return True
    return _is_float_quantile(opts.soft_min)   # quantile needs histograms


def run_mesh_pipeline(opts: PipelineOptions) -> KmDir:
    """`pipeline --backend mesh` driver: config -> repart -> fused step."""
    import time

    from kmtricks_tpu.runtime.pipeline import (
        _finish, stage_config, stage_repart)

    t0 = time.time()
    if opts.until not in ("merge", "all"):
        raise ValueError("--backend mesh runs the fused count+merge step; "
                         "--until repart/superk/count need --backend "
                         "host/device")
    kmdir, config = stage_config(opts)
    repart = stage_repart(kmdir, config, opts)
    if getattr(repart, "freq", None) is not None:
        raise ValueError("--backend mesh does not support frequency-ordered "
                         "minimizers yet")
    # device-memory budget: ~48 bytes of sort operands per window occupancy;
    # beyond it, stream chunks and aggregate on host. Decide on the REAL
    # padded window count of the loaded batch (row padding to the longest
    # read can dwarf the bank's k-mer estimate for mixed-length banks).
    # Features needing the full abundance distribution on host
    # (histograms, float soft-min quantiles, per-sample hard-min) also
    # route through the chunked path.
    from kmtricks_tpu.parallel.pipeline import make_mesh

    ndev = make_mesh().shape["d"]
    budget_windows = int(opts.max_memory_mb * 1e6 / 48)
    # decouple the chunk size from the memory budget when asked: a larger
    # --max-memory raises the device TABLE budget (fewer mid-stream
    # folds) without forcing bigger chunks (bigger chunks expose more
    # chunk-0 decode latency and change every program shape)
    import os as _os
    env_cw = _os.environ.get("KMTRICKS_STREAM_CHUNK_WINDOWS")
    chunk_windows = int(env_cw) if env_cw else budget_windows
    k = opts.kmer_size
    # file-size upper bound decides whether the collection is ever
    # materialized: beyond the single-step device budget -> stream chunks
    # from the banks with bounded host RSS (total bases <= file bytes for
    # FASTA/FASTQ; gz sized x4, the reference's own name heuristic — the
    # sampled seqio.estimate costs a 50k-record parse per file, only paid
    # when the streaming path is actually taken). Any bank that would be
    # chunked anyway streams: decoding then overlaps device compute
    # instead of materializing the whole collection up-front (an idle
    # device meanwhile).
    est_bytes = sum(
        _os.path.getsize(p) * (4 if p.endswith("gz") else 1)
        for e in kmdir.fof for p in e.paths)
    from kmtricks_tpu.parallel.pipeline import stream_layout
    cfm = parse_mode(opts.mode)[0]
    wb = (HashWindow.load(kmdir.hash_win).window_size_bits
          if cfm == "hash" else None)
    streamable = stream_layout(k, config.minim_size, config.nb_partitions,
                               len(kmdir.fof), cfm, wb) is not None
    if est_bytes > budget_windows:
        ests = [seqio.estimate(e.paths) for e in kmdir.fof]
        if streamable:
            from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream
            stage_mesh_stream(kmdir, config, opts, repart, None,
                              chunk_windows=chunk_windows,
                              use_stream=True, ests=ests)
        else:
            stage_mesh_chunked(kmdir, config, opts, repart, None,
                               chunk_windows=chunk_windows,
                               use_stream=True, ests=ests)
        cf, mode, _ = parse_mode(opts.mode)
        if mode == "bft":
            from kmtricks_tpu.runtime.pipeline import stage_format
            stage_format(kmdir, config, opts)
        return _finish(kmdir, t0)
    batch, lengths, sarr = _load_global_batch(kmdir, opts, k, ndev)
    n_windows = batch.shape[0] * (batch.shape[1] - k + 1)
    if n_windows > budget_windows or _needs_host_aggregation(opts, kmdir):
        if streamable:
            from kmtricks_tpu.runtime.stream_engine import stage_mesh_stream
            stage_mesh_stream(kmdir, config, opts, repart, None,
                              chunk_windows=chunk_windows,
                              batch=batch, lengths=lengths, sarr=sarr)
        else:
            stage_mesh_chunked(kmdir, config, opts, repart, None,
                               chunk_windows=chunk_windows,
                               batch=batch, lengths=lengths, sarr=sarr)
    else:
        amin_vec = resolve_soft_min(opts.soft_min, kmdir, len(kmdir.fof))
        stage_mesh_count_merge(kmdir, config, opts, repart, amin_vec,
                               batch=batch, lengths=lengths, sarr=sarr)
    cf, mode, _ = parse_mode(opts.mode)
    if mode == "bft":
        from kmtricks_tpu.runtime.pipeline import stage_format
        stage_format(kmdir, config, opts)
    return _finish(kmdir, t0)
