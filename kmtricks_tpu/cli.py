"""Command-line interface.

Mirrors the reference CLI (src/cli.cpp): subcommands ``pipeline``,
``repart``, ``superk``, ``count``, ``merge``, ``dump``, ``aggregate``,
``combine``, ``filter``, ``infos`` with the same option names and the
``<count_format:mode:out>`` mode grammar.

Usage: ``python -m kmtricks_tpu <subcommand> ...`` (or ``python -m
kmtricks_tpu.cli``).
"""

from __future__ import annotations

import argparse
import sys

from kmtricks_tpu import constants as C


def _parts(value: str) -> list[int]:
    return [int(x) for x in value.split(",") if x != ""]


def _add_common_pipeline(p: argparse.ArgumentParser, merge_opts: bool = True):
    p.add_argument("--file", "-f", dest="fof", required=True,
                   help="fof that contains path of read files")
    p.add_argument("--run-dir", "-d", required=True,
                   help="directory to write tmp and output files")
    p.add_argument("--kmer-size", "-k", type=int,
                   default=C.DEFAULT_KMER_SIZE, help="size of a k-mer")
    p.add_argument("--minimizer-size", type=int,
                   default=C.DEFAULT_MINIM_SIZE, help="size of minimizers")
    p.add_argument("--hard-min", type=int, default=C.DEFAULT_HARD_MIN,
                   help="min abundance to keep a k-mer at count stage")
    p.add_argument("--nb-partitions", type=int, default=0,
                   help="number of partitions (0=auto)")
    p.add_argument("--minimizer-type", type=int, default=0)
    p.add_argument("--repartition-type", type=int, default=0)
    p.add_argument("--max-memory", type=int,
                   default=C.DEFAULT_MAX_MEMORY_MB,
                   help="max memory per core (MB); left at its default, "
                   "the streaming engine's device table may take an "
                   "eighth of each device's memory")
    p.add_argument("--restrict-to", type=float, default=1.0,
                   help="process only a fraction of partitions")
    p.add_argument("--restrict-to-list", type=_parts, default=None,
                   help="process only these partitions (comma-separated)")
    p.add_argument("--hist", action="store_true",
                   help="compute k-mer abundance histograms")
    p.add_argument("--cpr", action="store_true",
                   help="compress intermediate files")
    p.add_argument("--kff-output", dest="kff", action="store_true",
                   help="output counted k-mers in kff format")
    p.add_argument("--keep-tmp", action="store_true")
    p.add_argument("--repart-from", default=None,
                   help="reuse the repartition of another run")
    p.add_argument("--static-repart", action="store_true",
                   help="partition = XXH64(minimizer) %% P")
    p.add_argument("--mmer-scheme", choices=["canonical", "forward"],
                   default="canonical",
                   help="minimizer scheme for superk/count routing: "
                        "canonical m-mers (the reference binary's actual "
                        "behavior and its fixtures) or forward m-mers "
                        "(the intent of its dead NONCANONICAL define)")
    p.add_argument("--focus", type=float, default=0.5)
    p.add_argument("--backend", choices=["auto", "host", "device", "mesh"],
                   default="auto",
                   help="compute backend: auto (mesh on any accelerator, "
                        "host on CPU), host numpy, per-stage jax device, "
                        "or the fused sharded mesh step")
    p.add_argument("--threads", "-t", type=int, default=1,
                   help="host thread pool size for count/merge stages")
    p.add_argument("--verbose", "-v", default="info")
    # BAM filters (fork addition)
    p.add_argument("-F", "--bam-exclude-flags", type=int, default=0)
    p.add_argument("--bam-require-flags", dest="bam_require_flags",
                   type=int, default=0)
    p.add_argument("--bam-exclude-refs", type=lambda s: s.split(","),
                   default=[], help="skip reads on these references")
    if merge_opts:
        p.add_argument("--mode", "-m", default="kmer:count:bin",
                       help="<count_format:mode:out>")
        p.add_argument("--soft-min", default=str(C.DEFAULT_SOFT_MIN),
                       help="merge abundance min: int | float(0,1) | file")
        p.add_argument("--share-min", type=int, default=C.DEFAULT_SHARE_MIN,
                       help="rescue k-mers solid in >= N samples")
        p.add_argument("--recurrence-min", type=int,
                       default=C.DEFAULT_RECURRENCE_MIN,
                       help="min samples to keep a k-mer")
        p.add_argument("--bloom-size", type=int, default=C.DEFAULT_BLOOM_SIZE)
        p.add_argument("--bitw", type=int, default=C.DEFAULT_BITW)
        p.add_argument("--bf-format", choices=["howdesbt", "sdsl"],
                       default="howdesbt")
        p.add_argument("--plugin", default=None,
                       help="merge plugin: file.py[:ClassName]")
        p.add_argument("--plugin-config", default="",
                       help="string passed to plugin.configure")


def _options_from_args(args) -> "PipelineOptions":
    from kmtricks_tpu.runtime.pipeline import PipelineOptions

    o = PipelineOptions(
        fof=getattr(args, "fof", ""),
        run_dir=args.run_dir,
        kmer_size=getattr(args, "kmer_size", C.DEFAULT_KMER_SIZE),
        minim_size=getattr(args, "minimizer_size", C.DEFAULT_MINIM_SIZE),
        hard_min=getattr(args, "hard_min", C.DEFAULT_HARD_MIN),
        nb_partitions=getattr(args, "nb_partitions", 0),
        minim_type=getattr(args, "minimizer_type", 0),
        repart_type=getattr(args, "repartition_type", 0),
        max_memory_mb=getattr(args, "max_memory",
                              C.DEFAULT_MAX_MEMORY_MB),
        restrict_to=getattr(args, "restrict_to", 1.0),
        restrict_to_list=getattr(args, "restrict_to_list", None),
        hist=getattr(args, "hist", False),
        cpr=getattr(args, "cpr", False),
        kff=getattr(args, "kff", False),
        keep_tmp=getattr(args, "keep_tmp", False),
        repart_from=getattr(args, "repart_from", None),
        static_repart=getattr(args, "static_repart", False),
        mmer_scheme=getattr(args, "mmer_scheme", "canonical"),
        focus=getattr(args, "focus", 0.5),
        backend=getattr(args, "backend", "auto"),
        verbose=getattr(args, "verbose", "info"),
        bam_require_flags=getattr(args, "bam_require_flags", 0),
        bam_exclude_flags=getattr(args, "bam_exclude_flags", 0),
        bam_excluded_refs=getattr(args, "bam_exclude_refs", []),
    )
    for k in ("mode", "soft_min", "share_min", "recurrence_min",
              "bloom_size", "bitw", "bf_format", "until", "plugin",
              "plugin_config", "threads"):
        if hasattr(args, k):
            setattr(o, k, getattr(args, k))
    o.soft_min = str(o.soft_min)
    return o


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kmtricks_tpu",
        description="JAX k-mer matrix and Bloom filter engine "
                    "(kmtricks-compatible)")
    from kmtricks_tpu import __version__
    ap.add_argument("--version", action="version",
                    version=f"kmtricks_tpu {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pipeline", help="count + merge in one GO")
    _add_common_pipeline(p)
    p.add_argument("--until", default="all",
                   choices=["repart", "superk", "count", "merge", "all"])

    p = sub.add_parser("repart", help="compute the minimizer repartition")
    _add_common_pipeline(p, merge_opts=False)
    p.add_argument("--bloom-size", type=int, default=C.DEFAULT_BLOOM_SIZE)
    p.add_argument("--mode", "-m", default="kmer:count:bin")

    p = sub.add_parser("superk", help="compute superkmers")
    p.add_argument("--run-dir", "-d", required=True)
    p.add_argument("--id", required=True, help="sample id (fof)")
    p.add_argument("--restrict-to-list", type=_parts, default=None)
    p.add_argument("--cpr", action="store_true")
    p.add_argument("--verbose", "-v", default="info")

    p = sub.add_parser("count", help="count k-mers/hashes in partitions")
    p.add_argument("--run-dir", "-d", required=True)
    p.add_argument("--id", required=True)
    p.add_argument("--partition-id", type=int, default=None)
    p.add_argument("--mode", "-m", default="kmer",
                   choices=["kmer", "hash", "vector", "kff", "kff-sk"])
    p.add_argument("--hard-min", type=int, default=C.DEFAULT_HARD_MIN)
    p.add_argument("--hist", action="store_true")
    p.add_argument("--cpr", action="store_true")
    p.add_argument("--verbose", "-v", default="info")

    p = sub.add_parser("merge", help="merge partitions")
    p.add_argument("--run-dir", "-d", required=True)
    p.add_argument("--partition-id", type=int, default=None)
    p.add_argument("--mode", "-m", default="kmer:count:bin")
    p.add_argument("--soft-min", default=str(C.DEFAULT_SOFT_MIN))
    p.add_argument("--share-min", type=int, default=C.DEFAULT_SHARE_MIN)
    p.add_argument("--recurrence-min", type=int,
                   default=C.DEFAULT_RECURRENCE_MIN)
    p.add_argument("--bitw", type=int, default=C.DEFAULT_BITW)
    p.add_argument("--cpr", action="store_true")
    p.add_argument("--plugin", default=None)
    p.add_argument("--plugin-config", default="")
    p.add_argument("--verbose", "-v", default="info")

    p = sub.add_parser("dump", help="dump a kmtricks file as text")
    p.add_argument("input")
    p.add_argument("--output", "-o", default="stdout")

    p = sub.add_parser("aggregate", help="aggregate partition files")
    p.add_argument("--run-dir", "-d", required=True)
    p.add_argument("--count", default="", help="[id:kmer|hash]")
    p.add_argument("--matrix", default="", choices=["", "kmer", "hash"])
    p.add_argument("--pa-matrix", default="", choices=["", "kmer", "hash"])
    p.add_argument("--format", default="text", choices=["text", "bin"])
    p.add_argument("--sorted", action="store_true")
    p.add_argument("--cpr-in", action="store_true")
    p.add_argument("--cpr-out", action="store_true")
    p.add_argument("--no-count", action="store_true")
    p.add_argument("--output", default="stdout")

    p = sub.add_parser("combine", help="combine multiple runs")
    p.add_argument("--run-dirs", required=True,
                   help="comma-separated list of run dirs")
    p.add_argument("--output", "-o", required=True, help="output run dir")

    p = sub.add_parser("filter", help="filter a matrix with a key sample")
    p.add_argument("--in-matrix", required=True, help="matrix run dir")
    p.add_argument("--key", required=True, help="key sample fof")
    p.add_argument("--output", "-o", required=True, help="output dir")
    p.add_argument("--hard-min", type=int, default=C.DEFAULT_HARD_MIN)
    p.add_argument("--out-types", default="k,m,v",
                   help="k:kept key kmers, m:filtered matrix, v:vector")
    p.add_argument("--cpr", action="store_true")

    sub.add_parser("infos", help="build infos")
    return ap


def main(argv=None) -> int:
    import logging

    # persistent XLA compilation cache: device-backend runs reuse compiled
    # programs across processes (runtime/jax_cache.py picks the directory)
    from kmtricks_tpu.runtime.jax_cache import enable_compile_cache
    enable_compile_cache()

    args = build_parser().parse_args(argv)
    level = getattr(args, "verbose", "info")
    logging.basicConfig(
        level={"debug": logging.DEBUG, "info": logging.INFO,
               "warning": logging.WARNING, "error": logging.ERROR
               }.get(level, logging.INFO),
        format="[%(asctime)s] [%(levelname)s] %(message)s",
        datefmt="%H:%M:%S")

    if args.cmd == "infos":
        from kmtricks_tpu import build_infos
        sys.stdout.write(build_infos())
        return 0

    if args.cmd == "dump":
        from kmtricks_tpu.io.dump import dump_text
        if args.output == "stdout":
            dump_text(args.input)
        else:
            with open(args.output, "w") as f:
                dump_text(args.input, f)
        return 0

    if args.cmd == "pipeline":
        from kmtricks_tpu.runtime.pipeline import run_pipeline
        run_pipeline(_options_from_args(args))
        return 0

    if args.cmd == "repart":
        from kmtricks_tpu.runtime.modules import module_repart
        module_repart(_options_from_args(args))
        return 0

    if args.cmd == "superk":
        from kmtricks_tpu.runtime.modules import module_superk
        module_superk(args.run_dir, args.id, _options_from_args(args),
                      args.restrict_to_list)
        return 0

    if args.cmd == "count":
        from kmtricks_tpu.runtime.modules import module_count
        opts = _options_from_args(args)
        parts = [args.partition_id] if args.partition_id is not None else None
        module_count(args.run_dir, args.id, opts, parts,
                     count_mode=args.mode)
        return 0

    if args.cmd == "merge":
        from kmtricks_tpu.runtime.modules import module_merge
        opts = _options_from_args(args)
        parts = [args.partition_id] if args.partition_id is not None else None
        module_merge(args.run_dir, opts, parts)
        return 0

    if args.cmd == "aggregate":
        from kmtricks_tpu.runtime.modules import module_aggregate
        module_aggregate(args.run_dir, count=args.count, matrix=args.matrix,
                         pa_matrix=args.pa_matrix, fmt=args.format,
                         sorted_out=args.sorted, cpr_in=args.cpr_in,
                         cpr_out=args.cpr_out, no_count=args.no_count,
                         output=args.output)
        return 0

    if args.cmd == "combine":
        from kmtricks_tpu.runtime.combine import module_combine
        module_combine(args.run_dirs.split(","), args.output)
        return 0

    if args.cmd == "filter":
        from kmtricks_tpu.runtime.filter import module_filter
        module_filter(args.in_matrix, args.key, args.output,
                      hard_min=args.hard_min, out_types=args.out_types,
                      cpr=args.cpr)
        return 0

    raise SystemExit(f"unknown command {args.cmd}")


def main_with_backtrace(argv=None) -> int:
    """CLI entry with crash capture: unhandled exceptions are written to
    ``kmtricks_backtrace.log`` before exiting (the reference's
    SignalHandler behavior, include/kmtricks/signals.hpp:68-158)."""
    import logging
    import traceback

    try:
        return main(argv)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        with open("kmtricks_backtrace.log", "w") as f:
            f.write(traceback.format_exc())
        logging.getLogger("kmtricks_tpu").error(
            "fatal error — backtrace written to kmtricks_backtrace.log")
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main_with_backtrace())
