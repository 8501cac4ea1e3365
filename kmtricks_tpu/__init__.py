"""kmtricks_tpu — a k-mer matrix and Bloom filter engine in JAX.

A framework (JAX / XLA, sharded with shard_map) with the capabilities of
kmtricks (tlemane/kmtricks): builds per-sample sorted k-mer count tables,
cross-sample count / presence-absence matrices and partitioned Bloom filter
matrices from collections of FASTA/FASTQ(.gz)/BAM read sets, including
low-abundance k-mer rescue during the cross-sample merge.

Layout:
  core/      host-side exact data types (k-mer codec, minimizers, hashing,
             histograms, partition windows, repartition tables)
  io/        byte-compatible on-disk formats (run directory, all file types)
  ops/       device compute (jax kernels)
  parallel/  device mesh, sharding and collectives
  runtime/   pipeline orchestration (stages, scheduling, resume)
  cli.py     command-line interface (pipeline/repart/superk/count/merge/...)
"""

__version__ = "0.1.0"


def build_infos() -> str:
    """Build/version info dump (reference `kmtricks infos`, cmd/infos.hpp)."""
    import platform
    import sys

    lines = [
        f"kmtricks_tpu {__version__}",
        f"python {sys.version.split()[0]} ({platform.platform()})",
    ]
    try:
        import jax
        lines.append(f"jax {jax.__version__}")
    except ImportError:
        lines.append("jax not available")
    import numpy as np
    lines.append(f"numpy {np.__version__}")
    return "\n".join(lines) + "\n"
