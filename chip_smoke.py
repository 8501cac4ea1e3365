#!/usr/bin/env python3
"""Smoke test of the k-mer matrix pipeline on NVIDIA GPUs.

Drives ``kmtricks_tpu.cli.main`` (the ``python -m kmtricks_tpu pipeline``
entry point) in this one process and checks every output against the host
golden path (``--backend host``) or an independent numpy count:

  A  the committed fixtures (tests/data_ref_exec/c*_*.fasta) through
     ``--backend mesh`` at k=31, checked against a numpy count of their
     canonical 31-mers;
  B  a synthetic collection from ``--seed`` through every device route
     (fused step, chunked, streaming engine, ``--backend device``), every
     packed sort layout (h1, k2, k3, kw), ``--share-min`` rescue, the
     device presence/absence finalize, the device repartition sampler and
     ``KMTRICKS_TPU_BFT=device``, each byte-compared with the host golden
     path;
  C  a 10-sample bacterial abundance collection at real size (4.6 Mbp
     genome, 150 bp reads, 20x per sample, ~740M k-mers, one sample gzipped)
     through ``--backend auto``: wall, k-mers/s, phase walls, peak device
     memory, cold and warm compile, exact per-sample totals and the host
     golden run.

Every output the host fetches from a mesh route must be spread over all
the devices.

Usage:
  python chip_smoke.py                 one GPU: phases A, B, C
  python chip_smoke.py --four-cards    four GPUs: the sharded fused step and
                                       streaming engine on phase B's
                                       collection and phase C, nothing else

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "scripts"))
from gen_synth_bank import gen_bank  # noqa: E402

FIXTURES = os.path.join(HERE, "tests", "data_ref_exec")
COMPARED = ("matrices", "merge_infos", "histograms", "filters",
            "repartition", "fpr", "hash.info")

# phase C: BASELINE config 2 (10-sample bacterial abundance matrix)
GENOME_C = 4_600_000
READ_LEN = 150
COVERAGE_C = 20
ERROR_RATE = 0.005       # assumed Illumina substitution rate
STRAIN_SNP_RATE = 0.001  # assumed per-sample strain divergence


class SmokeFailure(Exception):
    """A phase found a wrong or missing output."""


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# device checks
# ---------------------------------------------------------------------------

def require_gpu(count: int):
    """The JAX devices when the first is a GPU and there are at least
    ``count``; otherwise SystemExit with a non-zero code."""
    import jax
    try:
        devs = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: JAX found no accelerator ({e})")
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX platform is {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devs)}")
    return devs[:count]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def compare_runs(golden: str, test: str, names=COMPARED) -> tuple:
    """(number of files compared, mismatch descriptions) between two run
    directories over ``names`` (subdirectories or files of the golden
    run; names the golden run lacks are skipped)."""
    n, bad = 0, []
    for name in names:
        g = os.path.join(golden, name)
        t = os.path.join(test, name)
        if not os.path.exists(g):
            continue
        if os.path.isfile(g):
            pairs = [(g, t, name)]
        else:
            want = sorted(os.listdir(g))
            have = sorted(os.listdir(t)) if os.path.isdir(t) else []
            if want != have:
                bad.append(f"{name}: files {want} != {have}")
                continue
            pairs = [(os.path.join(g, f), os.path.join(t, f),
                      f"{name}/{f}") for f in want]
        for gp, tp, label in pairs:
            n += 1
            if not os.path.exists(tp):
                bad.append(f"{label}: missing")
            elif not same_bytes(gp, tp):
                bad.append(f"{label}: bytes differ")
    return n, bad


def same_bytes(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def canonical_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical k-mer values (k <= 32) of every window of equal-length
    reads ``codes`` (n, L) in 2-bit codes A=0 C=1 T=2 G=3: first base in
    the high bits, canonical = min(forward, reverse complement)."""
    n, L = codes.shape
    w = L - k + 1
    fwd = np.zeros((n, w), np.uint64)
    rc = np.zeros((n, w), np.uint64)
    comp = (codes ^ 2).astype(np.uint64)
    c64 = codes.astype(np.uint64)
    for j in range(k):
        fwd <<= np.uint64(2)
        fwd |= c64[:, j:j + w]
        rc |= comp[:, j:j + w] << np.uint64(2 * j)
    return np.minimum(fwd, rc).ravel()


def read_codes(path: str) -> list:
    """2-bit code arrays of the ACGT runs of every read of a FASTA file
    (windows never span a non-ACGT byte)."""
    lut = np.full(256, 255, np.uint8)
    for i, b in enumerate(b"ACTG"):
        lut[b] = i
        lut[ord(chr(b).lower())] = i
    out, seq = [], []
    with open(path, "rb") as f:
        lines = f.read().splitlines() + [b">"]
    for line in lines:
        if line.startswith(b">"):
            if seq:
                c = lut[np.frombuffer(b"".join(seq), np.uint8)]
                cuts = np.flatnonzero(c == 255)
                for part in np.split(c, cuts):
                    part = part[part != 255]
                    if len(part):
                        out.append(part)
            seq = []
        else:
            seq.append(line.strip())
    return out


def numpy_counts(reads: list, k: int) -> tuple:
    """(sorted canonical k-mers, counts) of a list of code arrays."""
    vals = [canonical_kmers(r[None, :], k) for r in reads if len(r) >= k]
    if not vals:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return np.unique(np.concatenate(vals), return_counts=True)


def read_merge_infos(run: str, nparts: int) -> dict:
    """Per-sample merge statistics summed over partitions."""
    tot = {}
    for p in range(nparts):
        with open(os.path.join(run, "merge_infos",
                               f"partition{p}.merge_info")) as f:
            for line in f:
                name, *vals = line.rstrip("\t\n").split("\t")
                v = np.array([int(x) for x in vals], np.int64)
                tot[name] = tot.get(name, 0) + v
    return tot


def read_count_matrices(run: str, nparts: int) -> tuple:
    from kmtricks_tpu.io.formats import read_matrix_file
    keys, counts, rows = [], [], []
    for p in range(nparts):
        _info, k, c = read_matrix_file(
            os.path.join(run, "matrices", f"matrix_{p}.count"))
        keys.append(k[:, 0])
        counts.append(c)
        rows.append(len(k))
    return np.concatenate(keys), np.concatenate(counts), rows


def nb_partitions(run: str) -> int:
    return len([f for f in os.listdir(os.path.join(run, "matrices"))
                if f.startswith("matrix_")])


# ---------------------------------------------------------------------------
# CLI runs
# ---------------------------------------------------------------------------

class Probe:
    """Wraps pipeline functions to record the device route each run takes,
    how often the presence/absence finalize program is built, and over
    how many devices every output array the host fetches is spread."""

    def __init__(self):
        from kmtricks_tpu.ops import compact
        from kmtricks_tpu.parallel import pipeline as pp
        from kmtricks_tpu.runtime import device_pipeline as dp
        from kmtricks_tpu.runtime import stream_engine as se
        self.routes: list = []
        self.fetch_spans: list = []
        self.pa_builds = 0
        for mod, name in ((dp, "stage_mesh_count_merge"),
                          (dp, "stage_mesh_chunked"),
                          (se, "stage_mesh_stream")):
            self._wrap(mod, name,
                       lambda *a, _n=name, **kw: self.routes.append(_n))
        self._wrap(pp, "build_merge_finalize_bits", self._count_pa)
        self._wrap(compact, "_prepare_fetch", self._record_fetch)

    @staticmethod
    def _wrap(mod, name, before):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            before(*a, **kw)
            return fn(*a, **kw)
        wrapped.__wrapped__ = fn
        setattr(mod, name, wrapped)

    def _count_pa(self, *_a, **_kw):
        self.pa_builds += 1

    def _record_fetch(self, arr, nrows, *_a, **_kw):
        if nrows > 0:
            self.fetch_spans.append(len(arr.sharding.device_set))

    def mark(self) -> tuple:
        return len(self.routes), len(self.fetch_spans), self.pa_builds


class Overflows(logging.Handler):
    """Counts the engine's overflow re-run warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.n = 0

    def emit(self, record):
        if "overflow" in record.getMessage():
            self.n += 1


def run_cli(fof: str, run_dir: str, args: list, env: dict | None = None,
            threads: int = 4) -> float:
    """One ``pipeline`` run through the CLI entry point; returns its wall.
    ``env`` entries are set for the duration of the run."""
    import shutil

    from kmtricks_tpu.cli import main
    shutil.rmtree(run_dir, ignore_errors=True)
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        rc = main(["pipeline", "--file", fof, "--run-dir", run_dir,
                   "--threads", str(threads), "--verbose", "warning"]
                  + args)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise SmokeFailure(f"pipeline exited {rc}: {args}")
    return wall


def run_device(probe: Probe, what: str, fof: str, run_dir: str, args: list,
               route: str | None, env: dict | None = None,
               threads: int = 4) -> float:
    """``run_cli`` on a device backend, checked for the expected route
    (``None``: ``--backend device``, which takes no mesh route) and, on a
    mesh route, for outputs spread over every device."""
    import jax
    r0, f0, _ = probe.mark()
    wall = run_cli(fof, run_dir, args, env, threads)
    taken = probe.routes[r0:]
    if taken != ([route] if route else []):
        raise SmokeFailure(f"{what}: routes {taken}, expected {route}")
    if route:
        # the chunked route hands its per-chunk outputs to the host with
        # jax.device_get, not through the fetch helpers
        check_placement(probe.fetch_spans[f0:], len(jax.devices()), what,
                        required=route != "stage_mesh_chunked")
    return wall


def check_placement(spans: list, ndev: int, what: str,
                    required: bool = True) -> None:
    """Every array a mesh route hands to the host must be sharded over
    all ``ndev`` devices: one left on a single device (device 0 by
    default) shows as a span of 1."""
    if required and not spans:
        raise SmokeFailure(f"{what}: no output fetched from the devices")
    off = sorted({s for s in spans if s != ndev})
    if off:
        raise SmokeFailure(f"{what}: fetched outputs spread over {off} "
                           f"device(s), not all {ndev}")


HOST_ENV = {"KMTRICKS_REPART_SAMPLER": "host"}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_a(work: str, probe: Probe) -> None:
    """Committed fixtures through the mesh path vs a numpy count."""
    import glob
    groups: dict = {}
    for p in sorted(glob.glob(os.path.join(FIXTURES, "c*_*.fasta"))):
        groups.setdefault(os.path.basename(p).split("_")[0], []).append(p)
    fof = os.path.join(work, "fixtures.fof")
    with open(fof, "w") as f:
        for s, paths in groups.items():
            f.write(f"{s} : {' ; '.join(paths)}\n")
    run = os.path.join(work, "fixtures_mesh")
    wall = run_device(probe, "phase A", fof, run,
                      ["-k", "31", "--hard-min", "1", "--soft-min", "1",
                       "--share-min", "0", "--nb-partitions", "4",
                       "--mode", "kmer:count:bin", "--backend", "mesh"],
                      "stage_mesh_count_merge")
    keys, counts, rows = read_count_matrices(run, 4)
    samples = list(groups)
    want = {}
    for j, s in enumerate(samples):
        reads = [r for p in groups[s] for r in read_codes(p)]
        u, c = numpy_counts(reads, 31)
        for kk, cc in zip(u.tolist(), c.tolist()):
            want.setdefault(kk, [0] * len(samples))[j] = cc
    got = {int(k): [int(x) for x in row] for k, row in zip(keys, counts)}
    if got != want:
        raise SmokeFailure(f"phase A: {len(got)} rows vs {len(want)} "
                           "golden k-mers, contents differ")
    say(f"phase A fixtures: {len(samples)} samples, rows per partition "
        f"{rows} (total {sum(rows)}) == numpy golden count; "
        f"wall {wall:.3f} s")


class Case(NamedTuple):
    """One phase B run: device args (the host golden run takes the same
    args with ``--backend host``), extra env, the device route expected
    (``None`` for ``--backend device``), the packed sort layout, and
    whether to run it a second time through the shape-history
    compile-ahead wave."""
    name: str
    args: list
    env: dict
    route: str | None
    layout: str
    history_rerun: bool = False


def phase_b_cases(four_cards: bool) -> list:
    k31 = ["-k", "31"]
    fused_h1 = Case("fused_h1_bf", k31 + ["--mode", "hash:bf:bin",
                                          "--bloom-size", "4000000",
                                          "--backend", "mesh"],
                    {}, "stage_mesh_count_merge", "h1")
    # presence/absence through the streaming engine's device finalize
    # (no --hist, an integer soft-min); --max-memory 256 makes the
    # collection stream from the files in chunks
    stream_pa = Case("stream_k3_pa_rescue",
                     k31 + ["--mode", "kmer:pa:bin", "--soft-min", "3",
                            "--share-min", "1", "--max-memory", "256",
                            "--backend", "mesh"],
                     {}, "stage_mesh_stream", "k3", history_rerun=True)
    if four_cards:
        return [fused_h1, stream_pa]
    return [
        fused_h1,
        Case("fused_k3_rescue", k31 + ["--mode", "kmer:count:bin",
                                       "--soft-min", "3", "--share-min",
                                       "2", "--backend", "mesh"],
             {}, "stage_mesh_count_merge", "k3"),
        Case("stream_k3_hist_rescue", k31 + ["--mode", "kmer:count:bin",
                                             "--hist", "--soft-min", "3",
                                             "--share-min", "1",
                                             "--backend", "mesh"],
             {}, "stage_mesh_stream", "k3"),
        stream_pa,
        Case("fused_k2", ["-k", "21", "--mode", "kmer:count:bin",
                          "--backend", "mesh"],
             {}, "stage_mesh_count_merge", "k2"),
        Case("fused_kw", ["-k", "45", "--mode", "kmer:count:bin",
                          "--backend", "mesh"],
             {}, "stage_mesh_count_merge", "kw"),
        Case("bft_device_transpose", k31 + ["--mode", "hash:bft:bin",
                                            "--bloom-size", "4000000",
                                            "--backend", "mesh"],
             {"KMTRICKS_TPU_BFT": "device"}, "stage_mesh_count_merge",
             "h1"),
        Case("chunked_generic", k31 + ["--mode", "hash:count:bin",
                                       "--bloom-size", str(1 << 62),
                                       "--hist", "--backend", "mesh"],
             {}, "stage_mesh_chunked", "generic"),
        Case("device_backend", k31 + ["--mode", "kmer:count:bin", "--hist",
                                      "--soft-min", "2", "--share-min", "1",
                                      "--backend", "device"],
             {}, None, "per-stage"),
    ]


PHASE_B = dict(nsamp=4, genome=200_000, coverage=15.0)   # 20k reads each


def phase_b(work: str, seed: int, probe: Probe, four_cards: bool,
            sizes: dict = PHASE_B) -> None:
    col = gen_bank(os.path.join(work, "collection_b"), sizes["nsamp"],
                   sizes["genome"], sizes["coverage"], READ_LEN, seed,
                   snp_rate=STRAIN_SNP_RATE, error_rate=ERROR_RATE,
                   fastq=True, gzip_first=True)
    say(f"phase B collection: {col['nsamp']} samples x {col['reads']} "
        f"reads of {READ_LEN} bp from a {col['genome']} bp genome "
        f"({col['bytes']} bytes of FASTQ, sample 0 gzipped), seed {seed}")
    common = ["--hard-min", "1", "--nb-partitions", "8"]
    host_total = 0.0
    for case in phase_b_cases(four_cards):
        args = common + case.args
        host_args = [a if a not in ("mesh", "device") else "host"
                     for a in args]
        golden = os.path.join(work, f"b_{case.name}_host")
        test = os.path.join(work, f"b_{case.name}_gpu")
        host_total += run_cli(col["fof"], golden, host_args, HOST_ENV)
        mode = args[args.index("--mode") + 1]
        runs = ["first run"]
        if case.history_rerun:
            runs.append("shape-history run")
        walls = []
        for i, label in enumerate(runs):
            what = f"phase B {case.name} ({label})"
            if i:
                # forget this process's compiled programs: the engine
                # then fires the compile-ahead wave the first run's shape
                # history predicts, the pa finalize included (inputs on
                # device 0, outputs over the mesh)
                from kmtricks_tpu.runtime import stream_engine
                stream_engine._warmed_sigs.clear()
            _r, _f, pa0 = probe.mark()
            walls.append(run_device(probe, what, col["fof"], test, args,
                                    case.route, case.env))
            # a pa run builds the finalize once, twice with the
            # compile-ahead's AOT lowering
            want_pa = i + 1 if ":pa:" in mode else 0
            if probe.pa_builds - pa0 < want_pa:
                raise SmokeFailure(f"{what}: the device pa finalize was "
                                   f"built {probe.pa_builds - pa0} times, "
                                   f"expected {want_pa}")
            n, bad = compare_runs(golden, test)
            if bad or n == 0:
                raise SmokeFailure(f"{what}: {bad or 'nothing compared'}")
        say(f"phase B {case.name}: route {case.route or '--backend device'}"
            f", layout {case.layout}, {n} files byte-equal to --backend "
            f"host (repartition from the device sampler); gpu wall "
            + " / ".join(f"{w:.3f} s ({lab})" for w, lab in zip(walls, runs)))
    say(f"phase B host golden walls total {host_total:.3f} s")


def phase_c_collection(work: str, seed: int, nsamp: int = 10,
                       genome: int = GENOME_C) -> dict:
    t0 = time.perf_counter()
    col = gen_bank(os.path.join(work, "collection_c"), nsamp, genome,
                   COVERAGE_C, READ_LEN, seed + 1, snp_rate=STRAIN_SNP_RATE,
                   error_rate=ERROR_RATE, fastq=True, gzip_first=True,
                   keep_codes=True)
    windows = nsamp * col["reads"] * (READ_LEN - 31 + 1)
    say(f"phase C collection: {nsamp} samples x {col['reads']} reads of "
        f"{READ_LEN} bp ({COVERAGE_C}x of a {genome} bp genome; "
        f"substitution rate {ERROR_RATE} and strain SNP rate "
        f"{STRAIN_SNP_RATE} assumed), {windows} k-mers, {col['bytes']} "
        f"bytes of FASTQ (S0 .fastq.gz); generated in "
        f"{time.perf_counter() - t0:.1f} s")
    col["windows"] = windows
    return col


C_ARGS = ["-k", "31", "--mode", "kmer:count:bin", "--hard-min", "2",
          "--soft-min", "2", "--share-min", "2", "--backend", "auto"]


def golden_totals(codes: list, workers: int) -> tuple:
    """Per-sample (distinct k-mers with count >= 2, their total count)
    and the number of k-mers with count >= 2 in any sample, by numpy."""

    def one(reads):
        vals = np.concatenate([canonical_kmers(reads[i:i + 4096], 31)
                               for i in range(0, len(reads), 4096)])
        u, c = np.unique(vals, return_counts=True)
        keep = c >= 2
        return u[keep], int(keep.sum()), int(c[keep].sum())

    with ThreadPoolExecutor(max_workers=workers) as ex:
        res = list(ex.map(one, codes))
    rows = len(np.unique(np.concatenate([r[0] for r in res])))
    return [r[1] for r in res], [r[2] for r in res], rows


def phase_c(work: str, seed: int, probe: Probe, threads: int,
            deadline: float, genome: int = GENOME_C,
            warm: bool = True) -> None:
    """Phase C: the real-size collection through ``--backend auto``, a
    cold and (``warm``) a warm run in this process, checked against a
    numpy count (computed meanwhile on a quarter of the host's cores) and
    the host golden run."""
    import jax
    from jax import monitoring

    from kmtricks_tpu.runtime import stream_engine

    col = phase_c_collection(work, seed, genome=genome)
    numpy_pool = ThreadPoolExecutor(max_workers=1)
    golden = numpy_pool.submit(golden_totals, col.pop("codes"),
                               max(1, (os.cpu_count() or 4) // 4))
    compile_s = [0.0]
    cache_hits = [0]

    def on_duration(event, secs, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += secs

    def on_event(event, **_kw):
        if event == "/jax/compilation_cache/cache_hits":
            cache_hits[0] += 1

    monitoring.register_event_duration_secs_listener(on_duration)
    monitoring.register_event_listener(on_event)
    overflows = Overflows()
    logging.getLogger("kmtricks_tpu").addHandler(overflows)
    run = os.path.join(work, "c_gpu")
    for label in ("cold", "warm") if warm else ("cold",):
        compile_s[0], cache_hits[0] = 0.0, 0
        wall = run_device(probe, f"phase C {label}", col["fof"], run,
                          C_ARGS, "stage_mesh_stream", threads=threads)
        say(f"phase C gpu: {label} wall {wall:.3f} s = "
            f"{col['windows'] / wall:.0f} k-mers/s (backend compile "
            f"{compile_s[0]:.3f} s summed over compile threads, "
            f"{cache_hits[0]} persistent-cache hits, phases "
            f"{dict(stream_engine.last_phase_walls)})")
    say(f"phase C peak device memory {peak_bytes(jax.devices())} "
        f"bytes; overflow re-runs {overflows.n}")
    if overflows.n:
        raise SmokeFailure(f"phase C: {overflows.n} overflow re-runs")

    t0 = time.perf_counter()
    uniq, total, rows_want = golden.result()
    numpy_pool.shutdown()
    nparts = nb_partitions(run)
    info = read_merge_infos(run, nparts)
    _keys, _counts, rows = read_count_matrices(run, nparts)
    checks = {
        "UNIQUE_WO_RESCUE": uniq, "UNIQUE_W_RESCUE": uniq,
        "TOTAL_WO_RESCUE": total, "TOTAL_W_RESCUE": total,
        "NON_SOLID": [0] * len(uniq), "RESCUED": [0] * len(uniq)}
    for name, want in checks.items():
        if info[name].tolist() != want:
            raise SmokeFailure(f"phase C {name}: {info[name].tolist()} "
                               f"!= numpy {want}")
    if sum(rows) != rows_want or min(rows) == 0:
        raise SmokeFailure(f"phase C rows {rows} (sum {sum(rows)}) vs "
                           f"numpy {rows_want}")
    say(f"phase C totals: per-sample distinct k-mers {uniq} and counts "
        f"{total} == numpy count; {nparts} partitions, all non-empty, "
        f"{sum(rows)} matrix rows; zero dropped occurrences (the engine "
        f"raises on any); waited {time.perf_counter() - t0:.1f} s for the "
        f"numpy count")

    if time.monotonic() > deadline:
        say("phase C host golden: not compared (time limit)")
        return
    golden_run = os.path.join(work, "c_host")
    host_args = [a if a != "auto" else "host" for a in C_ARGS]
    hwall = run_cli(col["fof"], golden_run, host_args, HOST_ENV,
                    threads=threads)
    n, bad = compare_runs(golden_run, run)
    if bad or n == 0:
        raise SmokeFailure(f"phase C vs host: {bad or 'nothing compared'}")
    say(f"phase C host golden: {n} files byte-equal to --backend host "
        f"(host wall {hwall:.3f} s)")


def peak_bytes(devs) -> list:
    """``peak_bytes_in_use`` of each device (None where the backend keeps
    no statistics)."""
    return [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in devs]


def check_device_balance(peaks: list) -> None:
    """Four-card runs: every card holds its share of the work and card 0
    no more than its share (a table-sized array left on device 0 would
    lift its peak far above the others')."""
    others = sorted(peaks[1:])
    median = others[len(others) // 2]
    say(f"per-device peak memory {peaks} bytes")
    if min(peaks) <= 0:
        raise SmokeFailure(f"a device did no work: {peaks}")
    if peaks[0] > 1.25 * median + (256 << 20):
        raise SmokeFailure(f"device 0 peak {peaks[0]} above 1.25 x the "
                           f"others' median {median} + 256 MiB")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four GPUs")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--work", default=os.path.join(HERE, ".smoke"),
                    help="directory for collections and runs")
    args = ap.parse_args(argv)
    t_start = time.monotonic()
    count = 4 if args.four_cards else 1
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    devs = require_gpu(count)
    import jax

    from kmtricks_tpu.runtime.jax_cache import enable_compile_cache

    say(f"card: {card_line()}")
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}; "
        f"compile cache {enable_compile_cache()}")
    os.makedirs(args.work, exist_ok=True)
    probe = Probe()
    threads = min(16, os.cpu_count() or 4)
    # phase C's host golden run starts only before this (the whole
    # script must stay well inside its time limit)
    deadline = t_start + (400 if args.four_cards else 800)
    if args.four_cards:
        phase_b(args.work, args.seed, probe, four_cards=True)
        phase_c(args.work, args.seed, probe, threads, deadline, warm=False)
        check_device_balance(peak_bytes(devs))
    else:
        phase_a(args.work, probe)
        phase_b(args.work, args.seed, probe, four_cards=False)
        phase_c(args.work, args.seed, probe, threads, deadline)
    say(f"chip_smoke total wall {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
