"""Generate synthetic multi-sample read banks (FASTA or FASTQ, optionally
gzipped) for benchmarks, profiles and the GPU smoke test.

Reads are sampled from both strands of one shared random genome
(realistic cross-sample k-mer overlap and duplicate structure). Each
sample reads its own strain of the genome (``snp_rate`` substitutions) so
samples differ, and every read base is substituted with probability
``error_rate`` (sequencing errors).

Usage: python scripts/gen_synth_bank.py [OUTDIR]
       (NSAMP, GENOME, COV, RLEN from the environment)
"""

import gzip
import os
import sys

import numpy as np

BASES = np.frombuffer(b"ACTG", np.uint8)   # 2-bit codes A=0 C=1 T=2 G=3
                                            # (complement = code ^ 2)


def substitute(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    """Copy of ``codes`` with each base replaced by one of the three
    others with probability ``rate``."""
    out = codes.copy()
    if rate <= 0:
        return out
    hit = rng.random(out.shape) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def simulate_reads(rng, genome: np.ndarray, nreads: int, read_len: int,
                   error_rate: float = 0.0) -> np.ndarray:
    """(nreads, read_len) u8 codes from random positions of both strands
    of ``genome``, with ``error_rate`` substitutions."""
    st = rng.integers(0, len(genome) - read_len, nreads)
    reads = genome[st[:, None] + np.arange(read_len)]
    flip = rng.random(nreads) < 0.5
    reads[flip] = reads[flip, ::-1] ^ 2
    return substitute(rng, reads, error_rate).astype(np.uint8)


def write_reads(path: str, reads: np.ndarray, fastq: bool) -> None:
    """FASTA/FASTQ records with fixed-width ids; ``.gz`` paths gzip."""
    n, L = reads.shape
    ids = np.char.zfill(np.arange(n).astype(str), 9).astype("S9")
    idcol = np.frombuffer(ids.tobytes(), np.uint8).reshape(n, 9)
    nl = np.full((n, 1), ord("\n"), np.uint8)
    head = np.full((n, 1), ord("@" if fastq else ">"), np.uint8)
    cols = [head, idcol, nl, BASES[reads], nl]
    if fastq:
        cols += [np.full((n, 1), ord("+"), np.uint8), nl,
                 np.full((n, L), ord("I"), np.uint8), nl]
    blob = np.hstack(cols).tobytes()
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)


def gen_bank(outdir: str, nsamp: int = 10, genome: int = 1_000_000,
             coverage: float = 8.0, read_len: int = 1024, seed: int = 42,
             snp_rate: float = 0.001, error_rate: float = 0.0,
             fastq: bool = False, gzip_first: bool = False,
             keep_codes: bool = False) -> dict:
    """Write <outdir>/S<i>.fasta (or .fastq; sample 0 gzipped when
    ``gzip_first``) and <outdir>/bank.fof. Returns the fof path, the
    sizes, the bytes written and, with ``keep_codes``, every sample's
    read codes."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, genome).astype(np.uint8)
    nreads = round(genome * coverage / read_len)
    ext = ".fastq" if fastq else ".fasta"
    lines, codes, nbytes = [], [], 0
    for s in range(nsamp):
        reads = simulate_reads(rng, substitute(rng, g, snp_rate), nreads,
                               read_len, error_rate)
        path = os.path.join(
            outdir, f"S{s}{ext}" + (".gz" if s == 0 and gzip_first else ""))
        write_reads(path, reads, fastq)
        nbytes += os.path.getsize(path)
        lines.append(f"S{s} : {path}")
        if keep_codes:
            codes.append(reads)
    fof = os.path.join(outdir, "bank.fof")
    with open(fof, "w") as f:
        f.write("\n".join(lines) + "\n")
    return dict(fof=fof, nsamp=nsamp, genome=genome, reads=nreads,
                bytes=nbytes, codes=codes)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench", "synth_bank")
    bank = gen_bank(out,
                    nsamp=int(os.environ.get("NSAMP", "10")),
                    genome=int(os.environ.get("GENOME", "1000000")),
                    coverage=float(os.environ.get("COV", "8")),
                    read_len=int(os.environ.get("RLEN", "1024")))
    print(bank["fof"])
