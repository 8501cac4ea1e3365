"""Streaming matrix engine: banks -> device-resident count table -> files.

The device replacement for the reference's whole superk+count+merge
dataflow at collection scale (task_scheduler.hpp): read chunks stream
from the banks on background threads, each chunk reduces ON DEVICE to
sorted unique (packed key, count) pairs (ops/table.py), pair streams
merge into a device-resident table (the per-partition count files of the
reference, living in HBM), and one final pass compacts the table to
dense fetchable rows. Host work per chunk is O(1); nothing
occurrence-sized ever crosses the device link.

Feature handling (vs the fused single-step path):
- per-sample hard-min (fof ``! amin`` overrides): the device applies the
  MINIMUM hard-min; the host refines per sample on the fetched raw
  counts (exactly the host chunked path's semantics).
- histograms / float soft-min quantiles: the table holds pre-hard-min
  counts, so histograms are computed on host from the fetched rows and
  quantile thresholds resolved before the merge — no second pass over
  the input.
- count_max saturation: clamped on host AFTER hard-min (the reference
  compares the raw count at the count stage, count_processor.hpp:61-72).
"""

from __future__ import annotations

import logging

import numpy as np

from kmtricks_tpu import constants as C
from kmtricks_tpu.core.hashers import HashWindow
from kmtricks_tpu.host import ops as hops
from kmtricks_tpu.io import sequences as seqio
from kmtricks_tpu.runtime.config import Config
from kmtricks_tpu.runtime.kmdir import KmDir
from kmtricks_tpu.runtime.pipeline import (PipelineOptions, parse_mode,
                                           resolve_soft_min,
                                           write_merge_outputs)

log = logging.getLogger("kmtricks_tpu")

def _tracer():
    """Env-gated wall-clock tracer (KMTRICKS_STREAM_TRACE=1)."""
    from kmtricks_tpu.runtime._trace import mark
    return mark


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


# phase walls of the most recent stage_mesh_stream run (stream = decode/
# upload/chunk steps until phase A dispatch; finalize = phase A wait;
# tail = phase B + fetch + merge + write) — bench.py emits them next to
# the e2e number so a regressed capture is attributable to a phase
last_phase_walls: dict = {}

def _history_path() -> str | None:
    """Shape-history file: the engine's data-dependent program shapes
    (final pair cap, phase-A run caps, phase-B row capacity) from past
    runs, keyed by the run's shape signature. A repeat run of the same
    shape family fires EVERY big compile in one parallel wave at t=0
    instead of three serial data-gated waves (the reference binary has
    zero per-run program cost, src/kmtricks.cpp:32-126; this is the
    closest a compiled-program system gets). It lives beside the
    compilation cache whose programs it predicts (runtime/jax_cache.py);
    KMTRICKS_SHAPE_HISTORY overrides the path; "0" disables."""
    import os

    from kmtricks_tpu.runtime.jax_cache import compile_cache_dir
    p = os.environ.get("KMTRICKS_SHAPE_HISTORY")
    if p == "0":
        return None
    if p:
        return p
    return os.path.join(compile_cache_dir(), "kmtricks_shape_history.json")


def _history_load() -> dict:
    import json
    import os
    p = _history_path()
    if not p or not os.path.exists(p):
        return {}
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _history_store(key: str, value: dict) -> None:
    import json
    import os
    p = _history_path()
    if not p:
        return
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        h = _history_load()
        if h.get(key) == value:
            return
        h[key] = value
        tmp = f"{p}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(h, f)
        os.replace(tmp, p)      # atomic vs concurrent module processes
    except OSError:
        pass                    # best-effort: history is an optimization


# program signatures already compiled+executed in THIS process: the
# compile-ahead dummies skip them. A warm in-process run (the bench's
# timed run; any repeated engine use) would otherwise compile-check
# every predicted program again (the jit callables are lru-cached per
# process, so the executables already exist).
_warmed_sigs: set = set()


def stage_mesh_stream(kmdir: KmDir, config: Config, opts: PipelineOptions,
                      repart, amin_vec, chunk_windows: int,
                      batch=None, lengths=None, sarr=None,
                      n_devices: int | None = None,
                      use_stream: bool = False, ests=None) -> None:
    """Chunked mesh pipeline with device-resident aggregation (see module
    docstring). Mirrors stage_mesh_chunked's interface; requires a packed
    sort layout (callers check stream_layout first)."""
    import math
    import os as _os

    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.parallel.pipeline import (
        build_chunk_pairs_step, build_table_compact, build_table_merge,
        build_table_sort_collapse, _layout_words, make_mesh,
        stream_layout)
    from kmtricks_tpu.runtime.device_pipeline import (
        _load_global_batch, _pack_transpose_chunks, estimate_dest_skew,
        prefetched, stream_row_chunks)

    import time as _time
    _t_start = _time.perf_counter()
    trace = _tracer()
    nsamp = len(kmdir.fof)
    nproc = jax.process_count()
    if nproc > 1 and n_devices is None:
        from kmtricks_tpu.parallel import multihost as mh
        mesh = mh.global_mesh()
    else:
        mesh = make_mesh(n_devices)
    trace("mesh up")
    ndev = mesh.shape[mesh.axis_names[0]]
    k = config.kmer_size
    cf, _mode, _out = parse_mode(opts.mode)
    window_bits = None
    if cf == "hash":
        window_bits = HashWindow.load(kmdir.hash_win).window_size_bits
    # program-shape sample bucket: every big program is built at the
    # sample count rounded up to 8 buckets per octave (step = 2^(b-3)
    # of its power-of-two ceiling: 700 -> 768, 1000 -> 1024,
    # 5000 -> 5120), so nearby collection sizes reuse compiled programs
    # (the reference binary has zero per-shape cost,
    # src/kmtricks.cpp:32-126; here a fresh nsamp used to recompile the
    # whole engine) at <= 1/8 padding
    # overhead. The packed sort layouts are bucket-stable: rounding
    # stays below the same power of two, so samp_bits =
    # (nsamp-1).bit_length() is unchanged. Pad samples never occur in
    # the data, so they are never present, and padded planes slice back
    # off before or at fetch. KMTRICKS_SHAPE_BUCKET=0 disables (must
    # match across processes).
    from kmtricks_tpu.parallel.pipeline import shape_bucket
    nsamp_p = (shape_bucket(nsamp)
               if _os.environ.get("KMTRICKS_SHAPE_BUCKET", "1") != "0"
               else nsamp)
    layout = stream_layout(k, config.minim_size, config.nb_partitions,
                           nsamp_p, cf, window_bits)
    assert layout is not None
    if amin_vec is None:
        # int / per-sample-file soft-min resolves WITHOUT the abundance
        # histograms; only the float-quantile form needs them. Early
        # resolution enables device-side hard-min filtering and the
        # pipelined fetch->merge tail.
        from kmtricks_tpu.runtime.device_pipeline import _is_float_quantile
        if not _is_float_quantile(opts.soft_min):
            amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
    nw = _layout_words(layout, nsamp_p)
    key_bits = ((window_bits * config.nb_partitions - 1).bit_length()
                if cf == "hash" else 2 * k)
    count_max = (1 << (8 * config.count_bytes)) - 1
    hard_mins = np.asarray(kmdir.fof.abundance_mins(opts.hard_min),
                           dtype=np.uint32)
    want_hists = opts.hist or (amin_vec is None)
    dev_hard_min = 1 if want_hists else int(hard_mins.min())

    rows_align = math.lcm(ndev, 8)
    prologue = ()
    if use_stream:
        if ests is None:
            ests = [seqio.estimate(e.paths) for e in kmdir.fof]
        trace("bank estimates")
        L = max(_round128(k), min(_round128(max(e.max_size for e in ests)),
                                  4096))
        W = L - k + 1
        rows_per_chunk = max(rows_align,
                             (chunk_windows // W) // rows_align
                             * rows_align)
        focus = opts.focus if opts.focus is not None else 0.5
        depth = max(1, int(round(focus * 4)))
        # stripe the FIRST chunk into quarters: decode, pack and upload
        # pipeline from ~t=0 instead of serializing one full chunk
        # before the device sees anything. Quarter shapes and their pair
        # caps derive from run parameters only (shape determinism).
        q = (rows_per_chunk // 4) // rows_align * rows_align
        if (q >= max(rows_align, 1024)
                and _os.environ.get("KMTRICKS_STREAM_PROLOGUE", "1")
                != "0"):
            prologue = (q, q, q, q)
        if nproc > 1:
            # sharded decode: processes stripe SAMPLES (the reference
            # fans per-sample tasks over workers the same way,
            # task_scheduler.hpp:164-249) and each assembles only ITS
            # shard of every global chunk — r4 had every process decode
            # the ENTIRE collection single-threaded for determinism.
            # Chunk counts may differ per process, so a per-chunk
            # allgather agrees on continuation (exhausted processes
            # contribute padding); it runs on the MAIN thread so the
            # collective order is identical on every process.
            chunks = _mp_sharded_chunks(
                kmdir, opts, mesh, k, L, rows_per_chunk, prologue, depth,
                nproc, ests)
        else:
            chunks = prefetched(_device_put_chunks(_pack_transpose_chunks(
                stream_row_chunks(kmdir, opts, k, L, rows_per_chunk,
                                  first_rows=prologue,
                                  tail_rows=prologue[0] if prologue
                                  else None),
                getattr(opts, "threads", 4) or 4), mesh), depth)
    else:
        if nproc > 1:
            raise ValueError(
                "multi-process engine runs stream from the banks "
                "(use_stream=True): sample-striped decode replaces the "
                "global batch")
        if batch is None:
            batch, lengths, sarr = _load_global_batch(kmdir, opts, k, ndev)
        L = batch.shape[1]
        W = L - k + 1
        rows_per_chunk = max(rows_align,
                             (chunk_windows // W) // rows_align
                             * rows_align)
        rows_per_chunk = min(rows_per_chunk,
                             -(-batch.shape[0] // rows_align) * rows_align)

        def _slices():
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

        chunks = prefetched(_device_put_chunks(_pack_transpose_chunks(
            _slices(), getattr(opts, "threads", 4) or 4), mesh), 2)

    chunk_w = rows_per_chunk * W
    local = -(-chunk_w // ndev)
    skew = estimate_dest_skew(kmdir, opts, config, repart, ndev)
    trace("skew estimated")

    table_hbm, table_src = _table_budget(opts.max_memory_mb, mesh, nw)
    _env_hbm = _os.environ.get("KMTRICKS_STREAM_TABLE_CAP")
    if _env_hbm:
        table_hbm = int(_env_hbm)    # tests: force mid-stream folds
        table_src = "KMTRICKS_STREAM_TABLE_CAP"

    def pairs_step(pc, with_vb, cap):
        return build_chunk_pairs_step(
            mesh, k=k, m=config.minim_size, nb_parts=config.nb_partitions,
            cap=cap, nsamp=nsamp_p, mode=cf, window_bits=window_bits,
            static_repart=opts.static_repart, batch_layout="lb",
            mmer_canonical=config.mmer_scheme != "forward", pair_cap=pc,
            packed_input=True, with_vbits=with_vb)

    if nproc > 1:
        # jit inputs must be global arrays on a multi-process mesh
        from kmtricks_tpu.parallel import multihost as mh
        table_jnp = mh.replicated(repart.table.astype(np.int32), mesh)
    else:
        table_jnp = jnp.asarray(repart.table.astype(np.int32))

    _env_cap = _os.environ.get("KMTRICKS_STREAM_PAIR_CAP")
    pair_cap = int(_env_cap) if _env_cap else None
    # adaptive sizing: with a striped prologue, the PRODUCTION pair cap
    # is decided at consolidation time from the sum of the quarters'
    # observed pair counts (union <= sum, so the margin is built in) —
    # the r4 policy sized it from the FIRST chunk alone and every
    # deep-coverage run paid mid-stream overflow re-runs
    adaptive_bump = _env_cap is None and bool(prologue) and use_stream
    pred_cap = None       # wave-2 compile-ahead's guess at the bump
    hist_fold_in = None   # consolidation fold in_cap (shape history)
    runs = []             # accumulated pair runs [(words, cnt, cap, n)]
    inflight = []         # [(n_pairs dev, dropped dev, host_chunk, slot)]
    n_chunks = 0

    # --- compile-ahead ------------------------------------------------
    # The engine's first calls would serialize their compiles. Fire the
    # predicted initial program shapes' AOT compiles on background
    # threads instead; call_step / the prologue fold WAIT on the
    # matching future before their first real call, so same-signature
    # compiles never race.
    prefetch_futs: dict = {}
    _pex = None
    # starting cap local/16: a prologue QUARTER's distinct pairs are
    # genome-bound, not window-bound — measured up to ~local/28 on the
    # e2e bank, so local/32 intermittently overflowed a quarter (chunk
    # composition varies with decode-thread interleaving) and the re-run
    # made the consolidation fold's in_caps non-uniform: a fresh program
    # signature and a fresh compile
    pc0 = (pair_cap if pair_cap
           else max(1 << 14, _pow2ceil(local) // 16))
    # per-process warmed-program bookkeeping (see _warmed_sigs); the
    # skew-derived route cap is part of the chunk-program shape
    from kmtricks_tpu.parallel.pipeline import shape_bucket as _sb2
    _sig_base = (k, config.minim_size, config.nb_partitions, nsamp_p, cf,
                 window_bits, L, rows_per_chunk, ndev, dev_hard_min,
                 min(local, _sb2(int(local * skew * ndev * 1.5) + 1024)))

    def _mark_warm(key) -> None:
        _warmed_sigs.add(_sig_base + key)

    def _is_warm(key) -> bool:
        return (_sig_base + key) in _warmed_sigs

    # shape-history key: everything that shapes the engine's programs
    # (see _history_path); caps stored under it feed the t=0 prefetch
    hist_key = repr((_sig_base, opts.recurrence_min, opts.share_min,
                     count_max, config.count_bytes, _mode, _out,
                     table_hbm, bool(_env_cap)))
    hist_pair_cap = None
    # will the tail take the device pa-bits fast path? (predictable at
    # t=0: every condition is a run parameter)
    pa_pred = (_mode == "pa" and _out == "bin" and not opts.plugin
               and not want_hists and amin_vec is not None
               and _os.environ.get("KMTRICKS_PA_DEVICE", "1") != "0")

    def _sim_final_caps(qcap, ccap):
        """Replay the chunk/fold arithmetic to predict phase A's
        (n_runs, in_caps) — exact when the bank row estimates are
        exact, reads fit L, and no pair-cap overflow fires; any
        misprediction only wastes a compile thread. ``qcap``: the
        pair cap of the prologue quarters; ``ccap``: the cap from the
        consolidation onward (the adaptive bump, or qcap when pinned)."""
        if use_stream:
            if any(e.max_size > L for e in ests):
                return None        # long-read splits: rows unknowable
            rows_total = sum(e.sequences for e in ests)
        else:
            rows_total = batch.shape[0]
        qq = prologue[0] if prologue else None
        if qq and rows_total < 4 * qq + 1:
            return None            # tiny bank: loads are cheap anyway
        seq = []
        rt = rows_total
        if qq:
            seq += [qq] * 4
            rt -= 4 * qq
        nf, rem = divmod(max(0, rt), rows_per_chunk)
        seq += [rows_per_chunk] * nf
        if rem:
            if qq and rem <= rows_per_chunk - qq:
                seq += [qq] * (-(-rem // qq))
            else:
                seq += [rows_per_chunk]
        caps: list = []
        for i in range(len(seq)):
            caps.append(qcap if (qq and i < 4) else ccap)
            if qq and i == 3:
                caps = [ccap]      # prologue consolidation
            elif sum(caps) + ccap > table_hbm:
                caps = [max(min(table_hbm, _pow2ceil(sum(caps))) // 2,
                            1 << 14)]
        return tuple(caps)

    if (use_stream
            and _os.environ.get("KMTRICKS_COMPILE_PREFETCH", "1") != "0"):
        # multi-process too: the AOT dummies run NO device code and no
        # collectives (lower+compile is process-local on a multi-
        # controller mesh), so they cannot perturb SPMD program order
        from concurrent.futures import ThreadPoolExecutor

        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as _P

        from kmtricks_tpu.parallel.pipeline import shape_bucket as _sb

        # AOT warm-up: ``jit.lower(ShapeDtypeStruct...).compile()``
        # populates the SAME executable cache the real call hits — no
        # dummy arguments materialize and nothing executes on device
        # (running the programs on zeros would cost device time exactly
        # when the cold-run stream phase wants it). Shardings must match
        # the real calls' inputs or the cache keys diverge (asserted by
        # the prediction-hit test).
        (_ax,) = mesh.axis_names
        _sh_b = NamedSharding(mesh, _P(None, _ax))
        _sh_v = NamedSharding(mesh, _P(_ax))

        def _sds(shape, dtype, sh):
            return jax.ShapeDtypeStruct(shape, dtype, sharding=sh)

        def _dummy_chunk(rows_n, pc):
            local_b = -(-(rows_n * W) // ndev)
            cap_b = min(local_b,
                        _sb(int(local_b * skew * ndev * 1.5) + 1024))
            return pairs_step(pc, False, cap_b).lower(
                _sds((L // 4, rows_n), jnp.uint8, _sh_b),
                _sds((rows_n,), jnp.int32, _sh_v),
                _sds((rows_n,), jnp.int32, _sh_v),
                jax.ShapeDtypeStruct(table_jnp.shape, table_jnp.dtype,
                                     sharding=table_jnp.sharding))

        def _dummy_fold(in_cap, out_cap):
            m = build_table_merge(mesh, nw=nw, out_cap=out_cap,
                                  n_streams=4, in_caps=(in_cap,) * 4)
            zw = _sds((ndev * in_cap,), jnp.uint32, _sh_v)
            args = []
            for _ in range(4):
                args.extend([zw] * (nw + 1))
            return m.lower(*args)

        def _dummy_phase_a(caps):
            f = build_table_sort_collapse(
                mesh, layout=layout, nsamp=nsamp_p, hard_min=dev_hard_min,
                n_runs=len(caps), key_bits=key_bits,
                window_bits=window_bits, nb_parts=config.nb_partitions)
            args = []
            for c in caps:
                args.extend([_sds((ndev * c,), jnp.uint32, _sh_v)]
                            * (nw + 1))
            return f.lower(*args)

        def _dummy_phase_b(sum_caps, rc):
            f = build_table_compact(
                mesh, layout=layout, nsamp=nsamp_p, key_bits=key_bits,
                window_bits=window_bits, hard_min=dev_hard_min,
                rows_cap=rc, mode=cf)
            args = [_sds((ndev * sum_caps,), jnp.uint32, _sh_v)] * (nw + 1)
            return f.lower(*args)

        def _dummy_pa_fin(rc):
            from jax.sharding import SingleDeviceSharding

            from kmtricks_tpu.parallel.pipeline import \
                build_merge_finalize_bits
            mb = build_merge_finalize_bits(
                mesh, nsamp=nsamp_p, rows_cap=rc,
                rmin=opts.recurrence_min, save_if=opts.share_min,
                count_max=count_max, nb_parts=config.nb_partitions,
                count_bytes=config.count_bytes)
            if nproc > 1:
                # the multi-process pa tail passes replicated globals
                # and a device-sharded bounds vector
                rep = NamedSharding(mesh, _P())
                shb = _sh_v
            else:
                rep = SingleDeviceSharding(jax.local_devices()[0])
                shb = rep
            return mb.lower(
                _sds((ndev * rc, nsamp_p), jnp.uint32, _sh_v),
                _sds((nsamp_p,), jnp.uint32, rep),
                _sds((nsamp_p,), jnp.uint32, rep),
                _sds((ndev * (config.nb_partitions + 1),), jnp.int32,
                     shb))

        # the history/candidate waves can queue 8+ programs; compiles
        # run on the pool while the main thread decodes and dispatches
        _pex = ThreadPoolExecutor(max_workers=8)

        def _submit(key, fn, *a):
            """Fire a dummy AOT compile unless this process already
            built AND ran the program."""
            if _is_warm(key) or key in prefetch_futs:
                return
            trace(f"compile-prefetch fire: {key}")

            def _run():
                fn(*a).compile()
                _mark_warm(key)
                trace(f"compile-prefetch done: {key}")

            prefetch_futs[key] = _pex.submit(_run)

        for rn in ({rows_per_chunk} | ({prologue[0]} if prologue
                                       else set())):
            _submit(("chunk", rn, pc0), _dummy_chunk, rn, pc0)
        if prologue and not adaptive_bump:
            _submit(("fold4", pc0, pc0), _dummy_fold, pc0, pc0)
        if not adaptive_bump:
            # adaptive runs predict phase A in wave 2 (the consolidated
            # cap is unknowable before the first quarter's pair count)
            _caps = _sim_final_caps(pc0, pc0)
            if _caps:
                _submit(("phaseA", _caps), _dummy_phase_a, _caps)

        # shape history: a previous run of this shape family recorded
        # its data-dependent program shapes — fire the WHOLE family in
        # one parallel wave now instead of three serial data-gated
        # waves (q0 sizing -> consolidation bump -> phase-A rows)
        _hv = _history_load().get(hist_key)
        if _hv:
            if nproc == 1:
                # SHAPE DECISIONS (the q0 cap jump, the consolidation
                # preference) may only follow history single-process:
                # multi-host home dirs are not necessarily shared, and
                # a per-host divergent jump would give each process a
                # different program shape mid-SPMD. The speculative
                # COMPILES below are process-local and harmless either
                # way.
                hist_pair_cap = int(_hv["pair_cap"])
            caps_h = tuple(int(c) for c in _hv["caps"])
            rc_h = int(_hv["rows_cap"])
            hp_h = int(_hv["pair_cap"])
            for rn in ({rows_per_chunk} | ({prologue[0]} if prologue
                                           else set())):
                _submit(("chunk", rn, hp_h), _dummy_chunk, rn, hp_h)
            if prologue:
                # the consolidation fold's in_cap depends on whether q0
                # overflowed: no overflow -> pc0; overflow with history
                # -> the jump lands ON the recorded cap; plus the
                # recorded variant from the last run — fire all three
                _submit(("fold4", pc0, hp_h), _dummy_fold, pc0, hp_h)
                fi = int(_hv.get("fold_in", pc0))
                _submit(("fold4", fi, hp_h), _dummy_fold, fi, hp_h)
                _submit(("fold4", hp_h, hp_h), _dummy_fold, hp_h, hp_h)
            _submit(("phaseA", caps_h), _dummy_phase_a, caps_h)
            _submit(("phaseB", sum(caps_h), rc_h), _dummy_phase_b,
                    sum(caps_h), rc_h)
            if pa_pred:
                _submit(("paFin", rc_h), _dummy_pa_fin, rc_h)
        elif adaptive_bump and prologue:
            # first-ever run of this shape family: shallow banks (pairs
            # ~ windows, little coverage dedup) overflow q0's starting
            # cap BY CONSTRUCTION (pc0 < quarter windows), and the
            # re-run program would then compile inline, mid-stream.
            # Fire the full-distinct candidate family
            # now: quarter/full chunk programs, the consolidation fold
            # and phase A at the caps a no-dedup bank would settle on.
            # Deep banks waste these compiles once — their real shapes
            # land in the history for every later run.
            qWd = -(-(prologue[0] * W) // ndev)
            cfd1 = _pow2ceil(2 * qWd)
            cfd2 = _pow2ceil(4 * qWd)
            if cfd1 > pc0:
                _submit(("chunk", prologue[0], cfd1), _dummy_chunk,
                        prologue[0], cfd1)
                _submit(("chunk", prologue[0], cfd2), _dummy_chunk,
                        prologue[0], cfd2)
                _submit(("chunk", rows_per_chunk, cfd2), _dummy_chunk,
                        rows_per_chunk, cfd2)
                _submit(("fold4", cfd1, cfd2), _dummy_fold, cfd1, cfd2)
                _caps = _sim_final_caps(cfd1, cfd2)
                if _caps:
                    _submit(("phaseA", _caps), _dummy_phase_a, _caps)

    def _prefetch_wave2(obs_q0: int) -> int:
        """Adaptive runs: the first quarter's observed pair count is the
        earliest predictor of the consolidated production cap (quarters
        are striped alike, so 4x the first is ~the quarter sum). Fire
        the bumped-cap program family now — full/tail chunk steps, the
        consolidation fold and phase A — so the consolidation-time bump
        below finds them compiled (cold runs; warm runs hit caches)."""
        if _pex is None:
            return None     # no compiles fired -> nothing to keep exact
        pred = max(pair_cap, _pow2ceil(4 * obs_q0))
        if hist_pair_cap and hist_pair_cap >= pred:
            pred = hist_pair_cap    # history programs are already firing
        if pred == pc0:
            return pred
        for rn in {rows_per_chunk, prologue[0]}:
            _submit(("chunk", rn, pred), _dummy_chunk, rn, pred)
        _submit(("fold4", pair_cap, pred), _dummy_fold, pair_cap, pred)
        _caps = _sim_final_caps(pair_cap, pred)
        if _caps:
            _submit(("phaseA", _caps), _dummy_phase_a, _caps)
        return pred

    def _await_prefetch(key):
        fut = prefetch_futs.pop(key, None)
        if fut is not None:
            import time as _time
            t0 = _time.perf_counter()
            try:
                fut.result()
                trace(f"compile-prefetch hit: {key[0]} "
                      f"({_time.perf_counter() - t0:.2f}s wait)")
            except Exception:   # noqa: BLE001 - best-effort warmup; the
                pass            # real call surfaces any genuine error

    def _chunk_caps(chunk):
        """Per-chunk program capacities. The all_to_all route capacity
        scales with the chunk's row count, but the PAIR cap does not:
        distinct (key, sample) pairs are genome-bound, not read-bound,
        so a striped prologue quarter can hold as many distinct pairs as
        a full chunk (measured: 4 interleaved samples x 1M genome in one
        quarter). The skew-derived capacity quantizes to 8 buckets per
        octave — a raw ``int(local_b * skew * ...)`` would give every
        BANK its own chunk-program shape (<= 1/8 capacity overhead
        instead)."""
        from kmtricks_tpu.parallel.pipeline import shape_bucket
        local_b = -(-(chunk[0].shape[1] * W) // ndev)
        cap_b = min(local_b,
                    shape_bucket(int(local_b * skew * ndev * 1.5) + 1024))
        return pair_cap, cap_b

    def call_step(chunk):
        """Dispatch the chunk program matching this chunk's shape: clean
        chunks (vbits None) use the no-validity-plane variant — a third
        fewer upload bytes."""
        pk, vb, cl, cs = chunk
        pc, cap_b = _chunk_caps(chunk)
        key = ("chunk", pk.shape[1], pc) if vb is None else None
        if key is not None:
            _await_prefetch(key)
        args = ((pk, cl, cs, table_jnp) if vb is None
                else (pk, vb, cl, cs, table_jnp))
        out = pairs_step(pc, vb is not None, cap_b)(*args)
        if key is not None:
            _mark_warm(key)
        return out, pc

    def verify_inflight(keep_last: int) -> bool:
        """Resolve queued (n_pairs, dropped) checks; chunk overflow
        re-runs the kept host chunk at a bumped pair_cap program
        (device recompute from the retained chunk arrays — no re-upload).
        Overflow-lag tightening: ONE overflow discovery drains and checks
        every already-dispatched chunk in the same pass, all re-running
        at the single largest bumped cap — the r4 policy re-discovered
        the overflow per lagged chunk, re-running serially at stale
        caps. Returns True if any run slot was replaced (callers that
        already dispatched downstream programs must re-dispatch)."""
        nonlocal pair_cap
        replaced = False
        drain = False
        reruns = []
        while len(inflight) > (0 if drain else keep_last):
            n_pairs_d, dropped_d, host_chunk, slot = inflight.pop(0)
            n_pairs, dropped = jax.device_get((n_pairs_d, dropped_d))
            if int(dropped):
                raise ValueError(
                    "all_to_all capacity exceeded in the streaming "
                    "engine; re-run with more partitions or a larger "
                    "--max-memory")
            obs = int(n_pairs.max())
            if obs > runs[slot][2]:
                pair_cap = max(pair_cap, _pow2ceil(obs * 2))
                log.warning("chunk pair overflow - re-running chunk with "
                            "pair_cap %d", pair_cap)
                (pw, pc2, np_d, dr_d), pc_used = call_step(host_chunk)
                runs[slot] = (pw, pc2, pc_used, None)
                reruns.append((np_d, dr_d, host_chunk, slot))
                replaced = True
                drain = True
            else:
                runs[slot] = runs[slot][:3] + (obs,)
        inflight.extend(reruns)
        if keep_last == 0 and reruns:
            # callers needing fully-verified runs: the re-runs' own
            # checks (at the bumped cap) must resolve too
            replaced = verify_inflight(0) or replaced
        return replaced

    fold_pending = []     # deferred fold checks [(n_d, streams, caps, cap)]

    def _dispatch_fold(streams, in_caps, out_cap):
        key = (("fold4", in_caps[0], out_cap)
               if len(streams) == 4 and in_caps == (in_caps[0],) * 4
               else None)
        if key is not None:
            _await_prefetch(key)
        out = build_table_merge(mesh, nw=nw, out_cap=out_cap,
                                n_streams=len(streams), in_caps=in_caps)(
            *[x for s_ in streams for x in (list(s_[0]) + [s_[1]])])
        if key is not None:
            _mark_warm(key)
        return out

    def resolve_fold():
        """Resolve a deferred fold's out_cap check. Overflow (rare: the
        async fold starts at the full pair cap) re-merges synchronously
        from the RETAINED inputs at a doubled cap — nothing downstream
        has consumed the truncated run yet (only independent chunk steps
        dispatch between the fold and its resolution)."""
        nonlocal runs
        if not fold_pending:
            return
        n_d, streams, in_caps, out_cap = fold_pending.pop()
        n_new = int(np.asarray(n_d).max())
        while n_new > out_cap:
            if out_cap >= table_hbm:
                raise ValueError(
                    f"device table overflow ({n_new} entries > "
                    f"{table_hbm}-entry budget from {table_src}); "
                    "raise --max-memory")
            out_cap = min(table_hbm, _pow2ceil(n_new))
            ws, cnt, n_d2 = _dispatch_fold(streams, in_caps, out_cap)
            n_new = int(np.asarray(n_d2).max())
            runs[0] = (ws, cnt, out_cap, None)
            trace(f"fold overflow -> re-merged at cap {out_cap}")
        runs[0] = runs[0][:3] + (n_new,)

    def fold_runs(start_cap: int | None = None, deferred: bool = False):
        """Collapse all accumulated runs into ONE compacted run — paid
        when the accumulated pair width approaches the device budget,
        and once right after the striped prologue (the four quarter
        runs merge into a single full-cap run so the prologue doesn't
        widen the finalize sort or trip the memory fold). ``out_cap``
        starts at a FIXED half of the table budget (or ``start_cap``):
        a data-dependent start (e.g. the exact pair total) would give
        every fold a fresh program signature and a fresh compile —
        shapes must depend only on run parameters.

        ``deferred``: dispatch the merge and return WITHOUT waiting for
        its entry count — the synchronous wait after the prologue cost
        a dispatch-loop stall (the device must drain the quarter steps
        first). The cap check resolves at the next fold / before
        phase A (resolve_fold)."""
        nonlocal runs
        resolve_fold()
        verify_inflight(keep_last=0)
        streams = [(r[0], r[1]) for r in runs]
        in_caps = tuple(r[2] for r in runs)
        out_cap = (start_cap if start_cap is not None else
                   max(min(table_hbm, _pow2ceil(sum(in_caps))) // 2,
                       1 << 14))
        ws, cnt, n_d = _dispatch_fold(streams, in_caps, out_cap)
        runs = [(ws, cnt, out_cap, None)]
        fold_pending.append((n_d, streams, in_caps, out_cap))
        if not deferred:
            resolve_fold()

    for chunk in chunks:
        trace(f"chunk {n_chunks} decoded")
        pk, vb, cl, cs = chunk
        if pair_cap is None:
            # size pair_cap from the first chunk (synchronous once):
            # start small — oversized pair runs bloat the finalize sort
            # width — and grow exactly on overflow
            pair_cap = pc0
            (pw, pc, np_d, dr_d), pc_used = call_step(chunk)
            n_pairs, dropped = jax.device_get((np_d, dr_d))
            if int(dropped):
                raise ValueError("all_to_all capacity exceeded on the "
                                 "first streamed chunk")
            if int(n_pairs.max()) > pc_used:
                pair_cap = _pow2ceil(int(n_pairs.max()) * 2)
                if hist_pair_cap and hist_pair_cap >= pair_cap:
                    # jump straight to the recorded production cap: the
                    # re-run then reuses the prefetched history program
                    # instead of compiling an intermediate family
                    pair_cap = hist_pair_cap
                (pw, pc, np_d, dr_d), pc_used = call_step(chunk)
                n_pairs = jax.device_get(np_d)
                assert int(n_pairs.max()) <= pc_used
            runs.append((pw, pc, pc_used, int(n_pairs.max())))
            if adaptive_bump:
                pred_cap = _prefetch_wave2(int(n_pairs.max()))
        else:
            (pw, pc, np_d, dr_d), pc_used = call_step(chunk)
            runs.append((pw, pc, pc_used, None))
            inflight.append((np_d, dr_d, chunk, len(runs) - 1))
            # lag the overflow check by TWO chunks: chunk i-2's n_pairs is
            # already materialized while chunk i-1 computes, so this
            # device_get returns without stalling the dispatch cadence
            verify_inflight(keep_last=2)
        n_chunks += 1
        trace(f"chunk {n_chunks - 1} dispatched ({len(runs)} runs)")
        if prologue and n_chunks == len(prologue):
            if adaptive_bump:
                # size the PRODUCTION cap from the quarters' observed
                # pair counts: the consolidated union is <= their sum,
                # and a full chunk's distinct pairs ~ the union of four
                # quarters' (same windows' worth of reads) — so
                # pow2ceil(sum) covers both the consolidation fold and
                # the full-cap chunks with margin built in. The r4
                # first-chunk-only policy undersized here and every
                # deep-coverage bench paid overflow re-runs mid-stream.
                verify_inflight(keep_last=0)
                sum_q = sum(r[3] for r in runs)
                new_cap = max(pair_cap, _pow2ceil(sum_q))
                if pred_cap is not None and pred_cap >= new_cap:
                    new_cap = pred_cap   # keep the wave-2 compiles exact
                if new_cap != pair_cap:
                    trace(f"pair cap {pair_cap} -> {new_cap} "
                          f"(quarter pairs {sum_q})")
                    pair_cap = new_cap
            # consolidate the quarter runs while the first full chunks
            # decode/upload on the prefetch thread; deferred — the cap
            # check resolves at the next fold or before phase A
            hist_fold_in = runs[0][2]
            fold_runs(start_cap=pair_cap, deferred=True)
            trace(f"prologue consolidation dispatched (cap {runs[0][2]})")
        elif sum(r[2] for r in runs) + pair_cap > table_hbm:
            fold_runs()
            trace(f"folded -> {runs[0][3]} entries")
    if not runs:
        raise ValueError("no sequences")

    # final pass: ONE concat+sort+collapse over every accumulated run,
    # then presence + row heads + dense compaction, then fetch.
    # phase A: sort + collapse + EXACT row count + max count + the
    # per-partition row histogram — everything the host needs to size
    # phase B and slice the fetch, in ONE device round-trip;
    # phase B: dense compaction at that capacity, its outputs consumed
    # by device-side fetch slices dispatched WITHOUT waiting for it.
    def dispatch_phase_a():
        key = ("phaseA", tuple(r[2] for r in runs))
        _await_prefetch(key)
        out = build_table_sort_collapse(
            mesh, layout=layout, nsamp=nsamp_p,
            hard_min=dev_hard_min, n_runs=len(runs),
            key_bits=key_bits, window_bits=window_bits,
            nb_parts=config.nb_partitions)(
            *[x for r in runs for x in (list(r[0]) + [r[1]])])
        _mark_warm(key)
        return out

    # dispatch OPTIMISTICALLY before draining the lagged overflow checks:
    # the device queues phase A behind the remaining chunk steps while
    # the host waits on their n_pairs; a (rare) chunk re-run replaces a
    # run slot and simply re-dispatches phase A
    resolve_fold()
    phase_a = dispatch_phase_a()
    trace("phase A dispatched")
    if verify_inflight(keep_last=0):
        phase_a = dispatch_phase_a()
        trace("phase A re-dispatched (chunk overflow)")
    _t_stream = _time.perf_counter()
    n_total = sum(r[3] for r in runs)
    log.info("streamed %d chunks -> %d pair runs, %d entries/device",
             n_chunks, len(runs), n_total)
    ws_d, cnt_d, nrows_a, maxc_a, phist_a = phase_a
    nrs, maxc, phist = jax.device_get((nrows_a, maxc_a, phist_a))
    trace("phase A rows known")
    _t_rows = _time.perf_counter()
    rows_cap = max(1 << 12, _pow2ceil(int(nrs.max())))
    if rows_cap * nsamp_p >= (1 << 31):
        raise ValueError(
            f"dense output matrix too large ({rows_cap} rows x "
            f"{nsamp} samples); raise --nb-partitions so partitions "
            "shard the key space")
    _sum_caps = sum(r[2] for r in runs)
    _await_prefetch(("phaseB", _sum_caps, rows_cap))
    rows_d, pre_d, _nrows_d, _maxc_d, _npres_d = build_table_compact(
        mesh, layout=layout, nsamp=nsamp_p, key_bits=key_bits,
        window_bits=window_bits, hard_min=dev_hard_min,
        rows_cap=rows_cap, mode=cf)(*(list(ws_d) + [cnt_d]))
    _mark_warm(("phaseB", _sum_caps, rows_cap))
    trace(f"phase B dispatched (nrows {int(nrs.max())})")
    # record this run's data-dependent shapes for the next same-family
    # run's t=0 compile wave (see _history_path)
    _history_store(hist_key, {
        "pair_cap": int(pair_cap if pair_cap else 0) or int(runs[0][2]),
        "caps": [int(r[2]) for r in runs],
        "rows_cap": int(rows_cap),
        "fold_in": int(hist_fold_in if hist_fold_in else 0)
                   or int(runs[0][2])})

    _fetch_merge_write(
        kmdir, config, opts, cf, window_bits, rows_d, pre_d, nrs,
        int(maxc), rows_cap, ndev, amin_vec, hard_mins, count_max,
        want_hists,
        part_rows=np.asarray(phist).reshape(ndev, config.nb_partitions),
        mesh=mesh, awaiter=(_await_prefetch, _mark_warm))
    trace("fetch + merge + write done")
    _t_end = _time.perf_counter()
    last_phase_walls.clear()
    last_phase_walls.update(
        stream_s=round(_t_stream - _t_start, 3),
        finalize_s=round(_t_rows - _t_stream, 3),
        tail_s=round(_t_end - _t_rows, 3))


def _table_budget(max_memory_mb: int, mesh, nw: int) -> tuple:
    """(entries per device, what set it) of the accumulated device table
    (``nw`` key words + a count per entry, double-buffered through
    merges). An explicit --max-memory decides it: --max-memory chiefly
    budgets the per-chunk occurrence sort, and the table, far smaller per
    entry, gets up to a sixth of it but at least 32M entries (~1.5 GB
    through a merge) so that a small chunk budget does not strangle it.
    Left at its default, --max-memory says nothing of the device, and the
    table may grow to what the device holds (_device_table_slots)."""
    slots = max(1 << 25, _pow2ceil(int(
        max_memory_mb * 1e6 / 3 / (4 * (nw + 1))) + 1) // 2)
    if max_memory_mb != C.DEFAULT_MAX_MEMORY_MB:
        return slots, f"--max-memory {max_memory_mb} MB"
    dev = _device_table_slots(mesh, nw)
    if dev > slots:
        return dev, "an eighth of the device memory"
    return slots, f"the default --max-memory {max_memory_mb} MB"


def _device_table_slots(mesh, nw: int) -> int:
    """Table entries one device's memory holds through a fold or the
    finalize: an eighth of its allocator limit over the entry's (nw + 1)
    u32 words — the concat, the sort's operands and its output, and the
    next chunk step share the rest (the 10-sample bacterial collection of
    chip_smoke.py peaks at about half the limit with it). Powers of two
    keep program shapes stable; 0 where the backend reports no limit
    (CPU)."""
    import jax
    local = [d for d in mesh.devices.flat
             if d.process_index == jax.process_index()]
    stats = local[0].memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    slots = limit // 8 // (4 * (nw + 1))
    return 1 << (slots.bit_length() - 1) if slots else 0


def _round128(x: int) -> int:
    return max(128, ((x + 127) // 128) * 128)


# rows of real (non-padding) reads THIS process decoded in its most
# recent multi-process engine run — the sharded-decode contract is that
# each worker parses only its sample stripe (tests assert < the whole
# collection)
last_local_rows: int = 0


def _mp_sharded_chunks(kmdir, opts, mesh, k: int, L: int,
                       rows_per_chunk: int, prologue: tuple, depth: int,
                       nproc: int, ests=None):
    """Multi-process chunk assembly with sample-striped decode.

    Each process decodes only the fof entries with ``idx % nproc ==
    process_index`` (threads allowed — local chunk composition is
    nondeterministic but the aggregated matrices are order-free sums)
    into LOCAL chunks of rows_per_chunk/nproc rows following the global
    shape schedule (prologue quarters, then full chunks). Before each
    global chunk, ONE process_allgather agrees on (a) whether anyone
    still has data and (b) whether any shard carries a validity plane
    (program selection must match across processes); exhausted
    processes contribute zero-padding shards. Runs on the consumer's
    thread: the collective order interleaves deterministically with the
    chunk steps on every process (decode/pack still overlap via
    prefetched on background threads).
    """
    import jax
    from jax.experimental import multihost_utils as mhu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P_

    from kmtricks_tpu.runtime.device_pipeline import (
        _pack_transpose_chunks, prefetched, stream_row_chunks)

    global last_local_rows
    pi = jax.process_index()
    lr = rows_per_chunk // nproc
    lprologue = tuple(q // nproc for q in prologue)
    if ests is not None:
        # size-balanced sample assignment (greedy LPT over the bank
        # estimates, deterministic across processes — every process
        # computes the same ests): heterogeneous collections otherwise
        # leave the worker holding the big banks decoding long after
        # the others exhausted (the reference's LPT repartition plays
        # the same role for partition sizes, PartiInfo.cpp:48-106)
        order = sorted(range(len(ests)),
                       key=lambda i: (-ests[i].sequences, i))
        loads = [0] * nproc
        owner = {}
        for i in order:
            w = min(range(nproc), key=lambda p: (loads[p], p))
            owner[i] = w
            loads[w] += max(1, ests[i].sequences)
        entries = [(i, e) for i, e in enumerate(kmdir.fof)
                   if owner[i] == pi]
    else:
        entries = [(i, e) for i, e in enumerate(kmdir.fof)
                   if i % nproc == pi]
    local_gen = _pack_transpose_chunks(
        stream_row_chunks(kmdir, opts, k, L, lr, first_rows=lprologue,
                          entries=entries),
        getattr(opts, "threads", 4) or 4)
    local_iter = iter(prefetched(local_gen, depth))
    (axis,) = mesh.axis_names
    sb = NamedSharding(mesh, P_(None, axis))   # (L/4|L/8, B) planes
    sv = NamedSharding(mesh, P_(axis))         # (B,) vectors

    def put(arr, shd):
        return jax.make_array_from_process_local_data(
            shd, np.ascontiguousarray(arr))

    schedule = list(lprologue)
    last_local_rows = 0
    while True:
        cap = schedule.pop(0) if schedule else lr
        item = next(local_iter, None)
        has = 0 if item is None else 1
        hvb = 1 if (item is not None and item[1] is not None) else 0
        flags = mhu.process_allgather(np.array([has, hvb], np.int32))
        if not flags[:, 0].any():
            return
        if item is None:
            pk = np.zeros((L // 4, cap), np.uint8)
            ln = np.zeros(cap, np.int32)
            sa = np.zeros(cap, np.int32)
            vb = None
        else:
            pk, vb, ln, sa = item
            assert pk.shape[1] == cap, (pk.shape, cap)
            last_local_rows += int((ln > 0).sum())
        if flags[:, 1].any() and vb is None:
            # some process's shard carries interior non-ACGT bytes: all
            # shards must feed the with-validity program variant — a
            # clean shard's validity bits derive from its lengths
            valid = np.arange(L, dtype=np.int32)[None, :] < ln[:, None]
            vb = np.ascontiguousarray(
                np.packbits(valid, axis=1, bitorder="little").T)
        yield (put(pk, sb), None if not flags[:, 1].any() else put(vb, sb),
               put(ln, sv), put(sa, sv))


def _device_put_chunks(gen, mesh):
    """Ship packed chunks to the device(s) ON the prefetch thread, with
    the shardings the chunk step expects — the transfer then overlaps the
    previous chunk's compute instead of sitting on the dispatch path."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P_

    (axis,) = mesh.axis_names
    trace = _tracer()
    sb = NamedSharding(mesh, P_(None, axis))   # (L/4, B) batch layout
    sv = NamedSharding(mesh, P_(axis))         # (B,) vectors
    for i, (pk, vb, cl, cs) in enumerate(gen):
        out = (jax.device_put(pk, sb),
               None if vb is None else jax.device_put(vb, sb),
               jax.device_put(cl, sv), jax.device_put(cs, sv))
        trace(f"upload {i} dispatched ({pk.nbytes >> 20} MB)")
        yield out


def _decode_block_keys(rows, cf, window_bits, nr, has_part_col=True):
    """Fetched row words -> (keys, part_col) in merge_dense's layout.

    ``has_part_col=False``: kmer-mode rows carry only the key words —
    the partition column was sliced off on device (callers that slice
    by the phase-A histogram never need it; fetching it costs a full
    u32 column per row). part_col is then None."""
    from kmtricks_tpu.runtime.device_pipeline import _keys_to_u64

    if cf == "hash":
        keys = _keys_to_u64(tuple(rows[:, j] for j in range(rows.shape[1])))
        part_col = (keys // np.uint64(window_bits)).astype(np.int64)
        return keys, part_col
    kwords = rows if not has_part_col else rows[:, :-1]
    keys = _keys_to_u64(tuple(kwords[:, j] for j in range(kwords.shape[1])))
    keys = keys.reshape(nr, max(1, kwords.shape[1] // 2))
    if not has_part_col:
        return keys, None
    return keys, rows[:, -1].astype(np.int64)


def _fetch_merge_write_pipelined(kmdir, config, opts, cf, window_bits,
                                 rows_d, pre_d, nrs, maxc, rows_cap, ndev,
                                 amin_vec, hard_mins, count_max,
                                 want_hists, part_rows,
                                 rows_have_part=True) -> None:
    """Grouped fetch -> merge pipeline: the device-computed per-partition
    row histogram gives partition bounds WITHOUT fetching keys first, so
    per-partition merge+write jobs start while later row groups are still
    riding the device link (all group copies go in flight up-front;
    merges fan over the -t pool)."""
    from concurrent.futures import ThreadPoolExecutor

    from kmtricks_tpu.core.histogram import KHist
    from kmtricks_tpu.io import formats as F
    from kmtricks_tpu.ops.compact import _prepare_fetch, narrow_cast
    from kmtricks_tpu.parallel.pipeline import partition_to_device

    nsamp = len(kmdir.fof)
    nb_parts = config.nb_partitions
    part_dev = partition_to_device(nb_parts, ndev)
    cast = narrow_cast(maxc)
    nthreads = max(1, getattr(opts, "threads", 1) or 1)
    hists = ([KHist(s, config.kmer_size) for s in range(nsamp)]
             if want_hists else None)
    hmv = np.asarray(hard_mins, dtype=np.uint32)[None, :]

    # contiguous partition groups of ~target rows; ALL fetch copies are
    # dispatched before any group is consumed
    prepped = []
    for d in range(ndev):
        nr = int(nrs[d])
        off = d * rows_cap
        bounds = np.zeros(nb_parts + 1, np.int64)
        np.cumsum(part_rows[d], out=bounds[1:])
        assert bounds[-1] == nr, "partition histogram disagrees with nrows"
        target = max(1 << 17, nr // 8)
        p_lo = 0
        while p_lo < nb_parts:
            p_hi = p_lo + 1
            while p_hi < nb_parts and bounds[p_hi + 1] - bounds[p_lo] \
                    < target:
                p_hi += 1
            r_lo, r_hi = int(bounds[p_lo]), int(bounds[p_hi])
            ta = _prepare_fetch(rows_d, r_hi - r_lo, None, None, off + r_lo)
            tb = _prepare_fetch(pre_d, r_hi - r_lo, cast, None, off + r_lo)
            prepped.append((d, p_lo, p_hi, r_lo, bounds, ta, tb))
            p_lo = p_hi

    def _merge_write_one(p, keys, pre_m, sl):
        res = hops.merge_dense(keys[sl], pre_m[sl], amin_vec,
                               opts.recurrence_min, opts.share_min)
        write_merge_outputs(kmdir, config, opts, p, res)

    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        futs = []
        deferred = []      # amin unresolved (float quantile): merge jobs
        for d, p_lo, p_hi, r_lo, bounds, ta, tb in prepped:
            rows, pre = ta(), tb()
            nr_g = rows.shape[0]
            pre = pre.astype(np.uint32, copy=False)
            if hists is not None:
                for s in range(nsamp):
                    col = pre[:, s]
                    hists[s].inc_counts(col[col > 0].astype(np.uint64))
            # per-sample hard-min on RAW counts, then count-type
            # saturation (count_processor.hpp:61-72 order)
            pre_m = np.where(pre >= hmv, np.minimum(pre, count_max), 0)
            keys, _pc = _decode_block_keys(rows, cf, window_bits, nr_g,
                                           has_part_col=rows_have_part)
            for p in range(p_lo, p_hi):
                if part_dev[p] != d:
                    continue
                sl = slice(int(bounds[p] - r_lo), int(bounds[p + 1] - r_lo))
                if amin_vec is None:
                    deferred.append((p, keys, pre_m, sl))
                else:
                    futs.append(ex.submit(_merge_write_one, p, keys,
                                          pre_m, sl))
        if hists is not None and opts.hist:
            for s, entry in enumerate(kmdir.fof):
                F.write_hist_file(kmdir.get_hist_path(entry.id), hists[s])
        if amin_vec is None:
            # float-quantile soft-min: thresholds resolve from the
            # just-written histograms, then the deferred merges fan out
            # (the r4 quantile tail fell back to the un-pipelined dense
            # fetch with the partition column and full-width counts)
            from kmtricks_tpu.runtime.pipeline import resolve_soft_min
            amin_vec = resolve_soft_min(opts.soft_min, kmdir, nsamp)
            for job in deferred:
                futs.append(ex.submit(_merge_write_one, *job))
        for f in futs:
            f.result()


def _fetch_merge_write_pa_bits(kmdir, config, opts, cf, window_bits, mesh,
                               rows_d, pre_d, nrs, rows_cap, ndev,
                               amin_vec, hard_mins, count_max,
                               part_rows, awaiter=None) -> None:
    """Presence/absence fast tail: the merge semantics run ON DEVICE
    (build_merge_finalize_bits) and only packed pa bit rows + keep flags
    + exact per-partition stats cross the link — ~30x fewer bytes than
    the dense count matrix at 1000 samples (the many-sample regime the
    reference handles by never materializing N columns,
    merge.hpp:102-361)."""
    import jax
    import jax.numpy as jnp

    from kmtricks_tpu.ops.compact import _prepare_fetch
    from kmtricks_tpu.parallel.pipeline import (build_merge_finalize_bits,
                                                partition_to_device)

    nsamp = len(kmdir.fof)
    # program shapes at the bucketed width pre_d carries (shape
    # bucketing, stage_mesh_stream): pad samples get hard_min/amin
    # sentinels so they are never present; padded bit/stat planes
    # slice back off below
    nsamp_p = pre_d.shape[1]
    nb_parts = config.nb_partitions
    cb = config.count_bytes
    nproc = jax.process_count()
    part_dev = partition_to_device(nb_parts, ndev)
    if awaiter:
        awaiter[0](("paFin", rows_cap))

    def mb(*args):
        return build_merge_finalize_bits(
            mesh, nsamp=nsamp_p, rows_cap=rows_cap,
            rmin=opts.recurrence_min, save_if=opts.share_min,
            count_max=count_max, nb_parts=nb_parts, count_bytes=cb)(*args)
    pad = nsamp_p - nsamp
    amin_p = np.concatenate([np.minimum(amin_vec, count_max),
                             np.full(pad, count_max)]).astype(np.uint32)
    hard_p = np.concatenate([np.asarray(hard_mins, np.uint32),
                             np.full(pad, 0xFFFFFFFF, np.uint32)])
    bounds = np.zeros((ndev, nb_parts + 1), np.int32)
    np.cumsum(part_rows, axis=1, out=bounds[:, 1:])
    if nproc > 1:
        # multi-process mesh: jit inputs must be global arrays — the
        # replicated vectors and this process's slice of the sharded
        # per-device bounds
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P_

        from kmtricks_tpu.parallel import multihost as mh
        ld = ndev // nproc
        pi = jax.process_index()
        bounds_loc = np.ascontiguousarray(
            bounds[pi * ld:(pi + 1) * ld].reshape(-1))
        bounds_g = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P_(mesh.axis_names[0])), bounds_loc)
        packed_d, keep_d, stats_d = mb(
            pre_d, mh.replicated(amin_p, mesh),
            mh.replicated(hard_p, mesh), bounds_g)
    else:
        packed_d, keep_d, stats_d = mb(
            pre_d, jnp.asarray(amin_p), jnp.asarray(hard_p),
            jnp.asarray(bounds.reshape(-1)))
        if awaiter:
            awaiter[1](("paFin", rows_cap))

    nb8 = (nsamp + 7) // 8
    n_planes = 4 + 2 * cb
    rows_have_part = True
    if cf == "kmer":
        # partition slicing uses the phase-A histogram bounds — drop
        # the partition column on device before the fetch
        from kmtricks_tpu.parallel.pipeline import build_col_slice
        rows_d = build_col_slice(mesh, rows_d.shape[1] - 1)(rows_d)
        rows_have_part = False
    if nproc > 1:
        # each process reads its ADDRESSABLE shards and writes the
        # partitions its devices own (the r4 multi-process tail used
        # the plain per-partition loop and skipped this fast path)
        _pa_write_multiproc(
            kmdir, config, opts, cf, window_bits, rows_d, packed_d,
            keep_d, stats_d, nrs, rows_cap, part_dev, bounds, nsamp,
            nsamp_p, nb8, n_planes, cb, rows_have_part)
        return
    stats = np.asarray(jax.device_get(stats_d)).reshape(
        ndev, n_planes, nb_parts, nsamp_p)[..., :nsamp].astype(np.uint64)
    for d in range(ndev):
        nr = int(nrs[d])
        off = d * rows_cap
        ta = _prepare_fetch(rows_d, nr, None, None, off)
        tb = _prepare_fetch(packed_d, nr, None, None, off)
        tc = _prepare_fetch(keep_d, nr, None, None, off)
        rows, packed, keepv = ta(), tb(), tc()
        keys, _pc = _decode_block_keys(rows, cf, window_bits, nr,
                                       has_part_col=rows_have_part)
        for p in range(nb_parts):
            if part_dev[p] != d:
                continue
            sl = slice(int(bounds[d, p]), int(bounds[d, p + 1]))
            _pa_write_partition(kmdir, config, opts, cf, p, keys, packed,
                                keepv, sl, stats[d, :, p, :], nsamp, nb8,
                                cb)


def _pa_write_partition(kmdir, config, opts, cf, p, keys, packed, keepv,
                        sl, S, nsamp, nb8, cb) -> None:
    """Write one partition's pa matrix + merge stats from the device
    finalize's fetched bit rows (shared by the single- and multi-process
    tails)."""
    from kmtricks_tpu.host.ops import MergeStats
    from kmtricks_tpu.io import formats as F

    kept = keepv[sl] > 0
    pk = keys[sl][kept]
    pb = packed[sl][kept][:, :nb8]
    out_path = kmdir.get_matrix_path(p, "pa", "bin", cf, opts.cpr)
    if cf == "kmer":
        F.write_pa_matrix_file(out_path, pk, pb, config.kmer_size,
                               nsamp, 0, p, compressed=opts.cpr)
    else:
        F.write_pa_hash_matrix_file(out_path, pk, pb, nsamp, 0, p,
                                    compressed=opts.cpr)
    tot_wo = sum(S[4 + i] << np.uint64(8 * i) for i in range(cb))
    tot_rs = sum(S[4 + cb + i] << np.uint64(8 * i) for i in range(cb))
    MergeStats(non_solid=S[0], rescued=S[1], uniq_wo_rescue=S[2],
               uniq_w_rescue=S[3], total_wo_rescue=tot_wo,
               total_w_rescue=tot_wo + tot_rs).serialize(
        kmdir.get_merge_info_path(p))


def _pa_write_multiproc(kmdir, config, opts, cf, window_bits, rows_d,
                        packed_d, keep_d, stats_d, nrs, rows_cap,
                        part_dev, bounds, nsamp, nsamp_p, nb8, n_planes,
                        cb, rows_have_part) -> None:
    """Multi-process pa tail: read the ADDRESSABLE shards of the device
    finalize's outputs and write the partitions this process's devices
    own (r4's multi-process tail skipped the device pa-bits fast path
    entirely)."""
    shard = {}
    for name, arr in (("rows", rows_d), ("packed", packed_d),
                      ("keep", keep_d)):
        for sh in arr.addressable_shards:
            shard[(name, sh.index[0].start // rows_cap)] = \
                np.asarray(sh.data)
    for sh in stats_d.addressable_shards:
        # global stats shape: (ndev * n_planes, nb_parts, nsamp_p)
        d = sh.index[0].start // n_planes
        shard[("stats", d)] = np.asarray(sh.data)
    for d in sorted(d for (nm, d) in shard if nm == "rows"):
        nr = int(nrs[d])
        rows = shard[("rows", d)][:nr]
        packed = shard[("packed", d)][:nr]
        keepv = shard[("keep", d)][:nr]
        stats = shard[("stats", d)].reshape(
            n_planes, config.nb_partitions,
            nsamp_p)[..., :nsamp].astype(np.uint64)
        keys, _pc = _decode_block_keys(rows, cf, window_bits, nr,
                                       has_part_col=rows_have_part)
        for p in range(config.nb_partitions):
            if part_dev[p] != d:
                continue
            sl = slice(int(bounds[d, p]), int(bounds[d, p + 1]))
            _pa_write_partition(kmdir, config, opts, cf, p, keys, packed,
                                keepv, sl, stats[:, p, :], nsamp, nb8, cb)


def _mp_merge_hists(kmdir, config, opts, blocks, amin_vec):
    """Cross-process histograms + float-quantile soft-min resolution:
    each process histograms its ADDRESSABLE rows (disjoint partitions,
    so the partials are disjoint too), exchanges the partial planes
    through the shared run directory, and process 0 merges them into
    the final per-sample ``.hist`` files — the reference's
    clone-per-thread + merge_clones (histogram.hpp:77-135) with the
    filesystem as the clone channel (its multi-node contract,
    cli.cpp:456-539). Every process then resolves identical quantile
    thresholds from the merged files. Returns the resolved amin_vec."""
    import os

    import jax
    from jax.experimental import multihost_utils as mhu

    from kmtricks_tpu.core.histogram import (KHist,
                                             compute_merge_thresholds)
    from kmtricks_tpu.io import formats as F
    from kmtricks_tpu.runtime.device_pipeline import _is_float_quantile
    from kmtricks_tpu.runtime.pipeline import resolve_soft_min

    nsamp = len(kmdir.fof)
    hists = [KHist(s, config.kmer_size) for s in range(nsamp)]
    for _d, _keys, pre, _bounds in blocks:
        for s in range(nsamp):
            col = pre[:, s]
            hists[s].inc_counts(col[col > 0].astype(np.uint64))
    hdir = os.path.dirname(kmdir.get_hist_path(kmdir.fof.entries[0].id))
    os.makedirs(hdir, exist_ok=True)
    pid = jax.process_index()
    np.savez(os.path.join(hdir, f".partial_{pid}.npz"),
             hu=np.stack([h.hist_u for h in hists]),
             hn=np.stack([h.hist_n for h in hists]),
             sc=np.array([[h.uniq, h.total, h.oob_lu, h.oob_ln,
                           h.oob_uu, h.oob_un] for h in hists],
                         dtype=np.uint64))
    mhu.sync_global_devices("kmtricks_hist_partials")
    if pid == 0:
        for q in range(jax.process_count()):
            pp = os.path.join(hdir, f".partial_{q}.npz")
            with np.load(pp) as z:
                for s in range(nsamp):
                    o = KHist(s, config.kmer_size)
                    o.hist_u, o.hist_n = z["hu"][s], z["hn"][s]
                    (o.uniq, o.total, o.oob_lu, o.oob_ln, o.oob_uu,
                     o.oob_un) = (int(v) for v in z["sc"][s])
                    if q == pid:
                        continue       # own tallies already in hists
                    hists[s].merge(o)
            os.remove(pp)
        if opts.hist:
            for s, entry in enumerate(kmdir.fof):
                F.write_hist_file(kmdir.get_hist_path(entry.id), hists[s])
    mhu.sync_global_devices("kmtricks_hist_merged")
    if amin_vec is not None:
        return amin_vec
    if _is_float_quantile(opts.soft_min):
        if pid == 0:
            # proc0 merged the full hists in memory; it also writes the
            # thresholds file (single writer on the shared dir)
            thr = compute_merge_thresholds(
                hists, float(opts.soft_min), kmdir.get_merge_th_path())
            mhu.sync_global_devices("kmtricks_thresholds")
            return np.asarray(thr, dtype=np.uint32)
        mhu.sync_global_devices("kmtricks_thresholds")
        # other processes read the thresholds proc0 wrote (one int per
        # line — independent of whether .hist files were requested)
        with open(kmdir.get_merge_th_path()) as f:
            thr = [int(line) for line in f if line.strip()]
        return np.asarray(thr, dtype=np.uint32)
    return resolve_soft_min(opts.soft_min, kmdir, nsamp)


def _fetch_merge_write_multiproc(kmdir, config, opts, cf, window_bits,
                                 rows_d, pre_d, nrs, rows_cap,
                                 amin_vec, hard_mins, count_max,
                                 part_rows, want_hists) -> None:
    """Multi-process tail: each process reads its ADDRESSABLE shards of
    the compacted rows and writes the partitions its devices own to the
    shared run directory — the reference's multi-node contract reborn
    (module processes coordinating only through the run dir,
    cli.cpp:456-539). Histograms/float soft-min merge across processes
    (_mp_merge_hists); the per-partition merge+write jobs fan over the
    -t thread pool like the single-process pipelined tail."""
    from concurrent.futures import ThreadPoolExecutor

    from kmtricks_tpu.parallel.pipeline import partition_to_device

    nb_parts = config.nb_partitions
    ndev = part_rows.shape[0]
    part_dev = partition_to_device(nb_parts, ndev)
    hmv = np.asarray(hard_mins, dtype=np.uint32)[None, :]
    shards_pre = {sh.index[0].start // rows_cap: np.asarray(sh.data)
                  for sh in pre_d.addressable_shards}
    nsamp = len(kmdir.fof)
    blocks = []
    for sh in rows_d.addressable_shards:
        d = sh.index[0].start // rows_cap
        nr = int(nrs[d])
        rows = np.asarray(sh.data)[:nr]
        # [:, :nsamp]: strip shape-bucket sample padding (local shards —
        # a host slice, no link cost)
        pre = shards_pre[d][:nr, :nsamp].astype(np.uint32, copy=False)
        keys, _pc = _decode_block_keys(rows, cf, window_bits, nr)
        bounds = np.zeros(nb_parts + 1, np.int64)
        np.cumsum(part_rows[d], out=bounds[1:])
        assert bounds[-1] == nr, "partition histogram disagrees with nrows"
        blocks.append((d, keys, pre, bounds))

    if want_hists or amin_vec is None:
        amin_vec = _mp_merge_hists(kmdir, config, opts, blocks, amin_vec)

    jobs = []
    for d, keys, pre, bounds in blocks:
        # per-sample hard-min on RAW counts, then count-type saturation
        # (count_processor.hpp:61-72 order)
        pre_m = np.where(pre >= hmv, np.minimum(pre, count_max), 0)
        for p in range(nb_parts):
            if part_dev[p] != d:
                continue
            sl = slice(int(bounds[p]), int(bounds[p + 1]))
            jobs.append((p, keys, pre_m, sl))

    def _merge_write(job):
        p, keys, pre_m, sl = job
        res = hops.merge_dense(keys[sl], pre_m[sl], amin_vec,
                               opts.recurrence_min, opts.share_min)
        write_merge_outputs(kmdir, config, opts, p, res)

    nthreads = max(1, getattr(opts, "threads", 1) or 1)
    if nthreads > 1 and len(jobs) > 1:
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            list(ex.map(_merge_write, jobs))
    else:
        for job in jobs:
            _merge_write(job)


def _fetch_merge_write(kmdir, config, opts, cf, window_bits, rows_d, pre_d,
                       nrs, maxc, rows_cap, ndev, amin_vec, hard_mins,
                       count_max, want_hists, part_rows=None,
                       mesh=None, awaiter=None) -> None:
    """Fetch per-device compacted row blocks, apply host-side hard-min /
    histogram / soft-min-quantile semantics, run merge_dense per
    partition, write outputs. With a device-computed ``part_rows``
    histogram and a pre-resolved soft-min, the pipelined variant above
    overlaps fetch with merge work; pa:bin outputs additionally run the
    whole merge on device and fetch packed BITS (~30x fewer bytes at
    many samples)."""
    import os

    import jax

    _mode, _out = parse_mode(opts.mode)[1:]
    pa_fast = (_mode == "pa" and _out == "bin" and not opts.plugin
               and not want_hists and amin_vec is not None
               and part_rows is not None and mesh is not None
               and os.environ.get("KMTRICKS_PA_DEVICE", "1") != "0")
    if jax.process_count() > 1:
        assert part_rows is not None
        if pa_fast:
            _fetch_merge_write_pa_bits(
                kmdir, config, opts, cf, window_bits, mesh, rows_d,
                pre_d, nrs, rows_cap, ndev, amin_vec, hard_mins,
                count_max, part_rows, awaiter)
            return
        _fetch_merge_write_multiproc(
            kmdir, config, opts, cf, window_bits, rows_d, pre_d, nrs,
            rows_cap, amin_vec, hard_mins, count_max, part_rows,
            want_hists)
        return
    if pa_fast:
        # the device finalize consumes pre at the BUCKETED width (its
        # program is shape-bucketed too); padded outputs slice on fetch
        _fetch_merge_write_pa_bits(
            kmdir, config, opts, cf, window_bits, mesh, rows_d, pre_d,
            nrs, rows_cap, ndev, amin_vec, hard_mins, count_max,
            part_rows, awaiter)
        return

    nsamp = len(kmdir.fof)
    if mesh is not None and pre_d.shape[1] != nsamp:
        # shape-bucketed pre: strip the padded sample columns on device
        # before anything rides the link
        from kmtricks_tpu.parallel.pipeline import build_col_slice
        pre_d = build_col_slice(mesh, nsamp)(pre_d)

    if part_rows is not None:
        # pipelined grouped fetch for EVERY single-process tail,
        # including the histogram/float-quantile one (the r4 quantile
        # tail fetched full rows with the partition column)
        rows_have_part = True
        if cf == "kmer" and mesh is not None:
            # the pipelined tail slices by the phase-A histogram and
            # never reads the partition column — drop it on device
            # (a full u32 per row)
            from kmtricks_tpu.parallel.pipeline import build_col_slice
            rows_d = build_col_slice(mesh, rows_d.shape[1] - 1)(rows_d)
            rows_have_part = False
        _fetch_merge_write_pipelined(
            kmdir, config, opts, cf, window_bits, rows_d, pre_d, nrs,
            maxc, rows_cap, ndev, amin_vec, hard_mins, count_max,
            want_hists, part_rows, rows_have_part)
        return
    raise AssertionError(
        "streaming tail requires the phase-A partition histogram "
        "(part_rows) - every engine path provides it")
