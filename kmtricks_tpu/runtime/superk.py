"""Superkmer stage: GATB-compatible superkmer partition files.

On the device the pipeline routes k-mers with an all_to_all and never materializes
superkmers — but the reference's module workflow (``kmtricks superk`` then
``kmtricks count --id``) and downstream consumers (kmdiff) exchange
superkmer files, so we produce/consume the same artifacts:

* ``superkmers/<id>/skp.<P>``: SuperkFileHeader (io/superk_file.hpp:25-54)
  + repeated ``[u32 block_size][block]``; block = repeated
  ``[u8 nbK][packed superkmer]``, 32 KB write cache
  (superk_storage.hpp:174-356).
* Packed superkmer layout (gatb Model.hpp:1388-1433 ``save``): the first
  k-mer's FORWARD codes packed 4/byte starting from the LAST nucleotide
  (bits 0-1 of byte 0 = last nt), then k%4 leftover codes, then one 2-bit
  extension per following k-mer, LSB-first within bytes.
* Superkmer cutting (Sequence2SuperKmer.hpp:60-135): run of consecutive
  k-mers sharing a minimizer; invalid k-mer flushes; max run =
  min((2*span-8)/2, 255) k-mers.
* ``SuperKmerBinInfoFile`` text sidecar + ``PartiInfoFile`` text
  (PartiInfo.hpp:266-287) + ``partition_infos/<id>.pinfo``
  (gatb_utils.hpp:46-51).

NOTE: SuperKmerBinInfoFile per-file counters carry the *intended* values
(#k-mers, bytes written); the reference's running counters are mangled by a
double-count/reset interplay (superk_storage.hpp insertSuperkmer/flushCache)
and end up state-dependent — we write the meaningful numbers.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from kmtricks_tpu import constants as C
from kmtricks_tpu.core import kmer as kops

BLOCK_CAP = 32768
XMER = 5        # kx sizes 0..4


def span_for_k(k: int) -> int:
    """Smallest KMER_LIST span STRICTLY greater than k — the reference's
    const_loop_executor dispatch (loop_executor.hpp:23-70): a span-32
    model handles k <= 31, so k = 32/64/96 land on the NEXT span (which
    raises their max superkmer length). Verified against GATB-executed
    superkmer goldens (tests/test_ref_exec_golden.py)."""
    for span in (32, 64, 96, 128):
        if k < span:
            return span
    if k == 128:     # extension: the reference CLI stops at k = 127
        return 128
    raise ValueError(f"k={k} too large")


def max_superk(k: int) -> int:
    """min((TypeBits - 8)/2, 255) (Sequence2SuperKmer.hpp:146)."""
    return min((2 * span_for_k(k) - 8) // 2, 255)


# ---------------------------------------------------------------------------
# PartiInfo
# ---------------------------------------------------------------------------

class PartiInfo:
    """Per-partition / per-minimizer statistics (PartiInfo.hpp:44-280)."""

    def __init__(self, nb_parts: int, minim_size: int):
        self.nb_parts = nb_parts
        self.num_mm_bins = 4 ** minim_size
        self.nb_superk_total = 0
        self.nb_kmer_total = 0
        self.part_nb_kmers = np.zeros(nb_parts, dtype=np.int64)
        self.part_nb_kxmers = np.zeros(nb_parts, dtype=np.int64)
        self.nbk_per_radix = np.zeros((nb_parts, XMER, 256), dtype=np.int64)
        self.bin_superks = np.zeros(self.num_mm_bins, dtype=np.int64)
        self.bin_kmers = np.zeros(self.num_mm_bins, dtype=np.int64)
        self.bin_kxmers = np.zeros(self.num_mm_bins, dtype=np.int64)

    def inc_superkmer(self, minim: int, size: int) -> None:
        self.nb_superk_total += 1
        self.nb_kmer_total += size
        self.bin_superks[minim] += 1
        self.bin_kmers[minim] += size

    def inc_kmer_and_rad(self, part: int, radix: int, x: int) -> None:
        self.part_nb_kxmers[part] += 1
        self.part_nb_kmers[part] += x + 1
        self.nbk_per_radix[part, x, radix] += 1

    def get_nb_kmer(self, part: int) -> int:
        return int(self.part_nb_kmers[part])

    def save(self, prefix: str) -> None:
        with open(os.path.join(prefix, "PartiInfoFile"), "w") as f:
            f.write(f"{self.nb_parts}\n{self.num_mm_bins}\n"
                    f"{self.nb_superk_total}\n{self.nb_kmer_total}\n")
            for p in range(self.nb_parts):
                f.write(f"{self.part_nb_kmers[p]}\n{self.part_nb_kxmers[p]}\n")
                flat = self.nbk_per_radix[p].reshape(-1)
                f.write("".join(f"{v}\n" for v in flat))
            for b in range(self.num_mm_bins):
                f.write(f"{self.bin_superks[b]}\n{self.bin_kmers[b]}\n"
                        f"{self.bin_kxmers[b]}\n")

    @classmethod
    def load(cls, prefix: str) -> "PartiInfo":
        with open(os.path.join(prefix, "PartiInfoFile")) as f:
            vals = f.read().split()
        it = iter(vals)
        nb_parts = int(next(it))
        num_bins = int(next(it))
        import math
        obj = cls(nb_parts, int(math.log(num_bins, 4) + 0.5))
        obj.nb_superk_total = int(next(it))
        obj.nb_kmer_total = int(next(it))
        for p in range(nb_parts):
            obj.part_nb_kmers[p] = int(next(it))
            obj.part_nb_kxmers[p] = int(next(it))
            for i in range(XMER * 256):
                obj.nbk_per_radix[p, i // 256, i % 256] = int(next(it))
        for b in range(num_bins):
            obj.bin_superks[b] = int(next(it))
            obj.bin_kmers[b] = int(next(it))
            obj.bin_kxmers[b] = int(next(it))
        return obj


# ---------------------------------------------------------------------------
# Packing / unpacking
# ---------------------------------------------------------------------------

def pack_superkmer(codes: np.ndarray, k: int) -> bytes:
    """Pack superkmer nucleotide codes (k + nbk - 1 codes) into bytes
    (Model.hpp:1388-1433): first k-mer 4 codes/byte from the END, then k%4
    leftovers, then extensions LSB-first."""
    from kmtricks_tpu import native

    nat = native.pack_superkmer(codes, k)
    if nat is not None:
        return nat
    n = len(codes)
    out = bytearray()
    # full bytes of the first k-mer, starting from its last nt
    i = k - 1
    while i >= 3:
        out.append(int(codes[i]) | int(codes[i - 1]) << 2
                   | int(codes[i - 2]) << 4 | int(codes[i - 3]) << 6)
        i -= 4
    rem = i + 1                      # k % 4 leftover codes c[0..rem-1]
    newbyte = 0
    for t in range(rem):
        newbyte |= int(codes[rem - 1 - t]) << (2 * t)
    uid = rem
    for j in range(k, n):            # one extension code per extra k-mer
        if uid == 4:
            out.append(newbyte)
            newbyte, uid = 0, 0
        newbyte |= int(codes[j]) << (2 * uid)
        uid += 1
    if uid > 0:
        out.append(newbyte)
    return bytes(out)


def unpack_superkmer(data: bytes, nbk: int, k: int) -> np.ndarray:
    """Inverse of :func:`pack_superkmer` -> (k + nbk - 1,) uint8 codes."""
    from kmtricks_tpu import native

    nat = native.unpack_superkmer(bytes(data), k, nbk)
    if nat is not None:
        return nat
    total = k + nbk - 1
    codes = np.zeros(total, dtype=np.uint8)
    nfull = k // 4
    bi = 0
    i = k - 1
    for _ in range(nfull):
        b = data[bi]
        bi += 1
        codes[i] = b & 3
        codes[i - 1] = (b >> 2) & 3
        codes[i - 2] = (b >> 4) & 3
        codes[i - 3] = (b >> 6) & 3
        i -= 4
    rem = k % 4
    if rem:
        cur = data[bi]
        for t in range(rem):
            codes[rem - 1 - t] = (cur >> (2 * t)) & 3
        uid = rem
        have_cur = True
    else:
        cur = 0
        uid = 4          # force a fetch on the first extension
        have_cur = False
    for j in range(k, total):
        if uid == 4:
            if have_cur:
                bi += 1
            cur = data[bi]
            have_cur = True
            uid = 0
        codes[j] = (cur >> (2 * uid)) & 3
        uid += 1
    return codes


# ---------------------------------------------------------------------------
# skp file I/O
# ---------------------------------------------------------------------------

_BASE = struct.Struct("<QI?")


def write_skp_header(f, partition: int, compressed: bool = False) -> None:
    f.write(_BASE.pack(C.MAGIC_BASE, C.KM_IO_VERSION, compressed))
    f.write(struct.pack("<QI", C.MAGIC_SUPERK, partition))


def read_skp_header(f) -> tuple[int, bool]:
    base, _, compressed = _BASE.unpack(f.read(13))
    magic, part = struct.unpack("<QI", f.read(12))
    if base != C.MAGIC_BASE or magic != C.MAGIC_SUPERK:
        raise IOError("Invalid file format.")
    return part, compressed


def iter_skp_file(path: str, k: int):
    """Yield (nbk, codes) for each superkmer of an skp file (plain or with
    the post-header stream lz4-framed — SuperkWriter's second layer,
    superk_file.hpp:56-83)."""
    from kmtricks_tpu.io import lz4

    with open(path, "rb") as f:
        _part, compressed = read_skp_header(f)
        data = f.read()
    if compressed:
        data = lz4.decompress(data)
    pos = 0
    while pos + 4 <= len(data):
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        block = data[pos:pos + size]
        pos += size
        i = 0
        while i < len(block):
            nbk = block[i]
            i += 1
            nb = (k + nbk - 1 + 3) // 4    # ceil(total nts / 4)
            yield nbk, unpack_superkmer(block[i:i + nb], nbk, k)
            i += nb


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------

def _superkmer_runs(minim: np.ndarray, wvalid: np.ndarray, maxs: int):
    """Yield (start, length, minimizer) runs over the window axis.

    Vectorized segmentation: boundaries at minimizer changes or validity
    edges, then segments split at the ``maxs`` cap — O(#segments) Python
    iterations instead of O(#windows)."""
    n = len(minim)
    if n == 0:
        return
    edge = np.empty(n, dtype=bool)
    edge[0] = True
    edge[1:] = (minim[1:] != minim[:-1]) | ~wvalid[1:] | ~wvalid[:-1]
    starts = np.flatnonzero(edge)
    ends = np.concatenate([starts[1:], [n]])
    for s, e in zip(starts, ends):
        if not wvalid[s]:
            continue
        mv = int(minim[s])
        t = int(s)
        e = int(e)
        while t < e:
            sz = min(e - t, maxs)
            yield t, sz, mv
            t += sz


def stage_superk(kmdir, config, repart, sample_idx: int, opts,
                 partitions: list[int] | None = None) -> "PartiInfo":
    from kmtricks_tpu.io import sequences as seqio

    entry = kmdir.fof.entries[sample_idx]
    k, m = config.kmer_size, config.minim_size
    nb_parts = config.nb_partitions
    maxs = max_superk(k)
    psel = set(partitions) if partitions is not None \
        else set(range(nb_parts))

    from kmtricks_tpu.io import lz4

    cpr = bool(getattr(opts, "cpr", False))
    prefix = kmdir.get_superk_path(entry.id)
    os.makedirs(prefix, exist_ok=True)
    files = {}
    buffers: dict[int, bytearray] = {}
    nbk_file = dict.fromkeys(psel, 0)
    size_file = dict.fromkeys(psel, 0)
    for p in psel:
        files[p] = open(os.path.join(prefix, f"skp.{p}"), "wb")
        write_skp_header(files[p], p, compressed=cpr)
        buffers[p] = bytearray()

    def flush(p):
        # each 32 KB block is written immediately — in lz4 mode as its own
        # frame (the decoder handles concatenated frames), bounding memory
        if buffers[p]:
            framed = struct.pack("<I", len(buffers[p])) + bytes(buffers[p])
            files[p].write(lz4.compress(framed) if cpr else framed)
            size_file[p] += len(buffers[p]) + 4
            buffers[p].clear()

    pinfo = PartiInfo(nb_parts, m)
    bam_filter = opts.bam_filter() if hasattr(opts, "bam_filter") else None
    freq = (repart.freq.astype(np.uint64)
            if getattr(repart, "freq", None) is not None else None)
    for seq in seqio.iter_sequences(entry.paths, bam_filter):
        codes, valid = kops.encode_ascii(seq)
        if len(codes) < k:
            continue
        wvalid = kops.window_validity(valid, k)
        minim = kops.window_minimizers(
            codes, k, m, freq_order=freq,
            canonical_mmers=config.mmer_scheme != "forward")
        which, radix = _strand_and_radix(codes, k)
        for start, size, mv in _superkmer_runs(minim, wvalid, maxs):
            p = int(repart.table[mv])
            pinfo.inc_superkmer(mv, size)
            _tally_kxmers(pinfo, which, radix, start, size, p)
            if p not in psel:
                continue
            packed = pack_superkmer(codes[start:start + k + size - 1], k)
            if len(buffers[p]) + len(packed) + 1 > BLOCK_CAP:
                flush(p)
            buffers[p].append(size)
            buffers[p] += packed
            nbk_file[p] += size
    for p in psel:
        flush(p)
        files[p].close()

    # sidecars
    with open(os.path.join(prefix, "SuperKmerBinInfoFile"), "w") as f:
        f.write("skp\n")
        f.write(prefix + "\n")
        f.write(f"{nb_parts}\n")
        for p in range(nb_parts):
            f.write(f"{nbk_file.get(p, 0)}\n{size_file.get(p, 0)}\n")
    pinfo.save(prefix)
    with open(kmdir.get_pinfos_path(entry.id), "w") as f:
        for p in range(nb_parts):
            f.write(f"{pinfo.get_nb_kmer(p)}\n")
    return pinfo


def _strand_and_radix(codes: np.ndarray, k: int):
    """Per-window canonical strand choice + top-4-nt radix, vectorized over
    the whole read (inputs to the kx-mer accounting)."""
    fwd = kops.kmers_from_codes(codes, k)
    rc = kops.revcomp(fwd, k)
    take_rc = kops.compare_lt(rc, fwd)
    which = ~take_rc                                   # True = forward
    cano = np.where(take_rc[:, None], rc, fwd)
    bitpos = 2 * (k - 4)
    w, s = divmod(bitpos, 64)
    r = cano[:, w] >> np.uint64(s)
    if s > 56 and w + 1 < cano.shape[1]:     # radix spans two words
        r = r | (cano[:, w + 1] << np.uint64(64 - s))
    return which, (r & np.uint64(255)).astype(np.int64)


def _tally_kxmers(pinfo: PartiInfo, which: np.ndarray, radix: np.ndarray,
                  start: int, size: int, part: int) -> None:
    """kx-mer run accounting of KmFillPartitions::processSuperkmer
    (fill_partitions.hpp:60-104): same-strand runs chunked at <= 5 k-mers
    (the kx_size >= 4 flush); radix = top 4 nt of the canonical value —
    first k-mer of the chunk for forward strand, last for reverse.
    O(#chunks) instead of O(#k-mers)."""
    w = which[start:start + size]
    r = radix[start:start + size]
    edges = np.flatnonzero(w[1:] != w[:-1]) + 1
    bounds = np.concatenate([[0], edges, [size]])
    for a, b in zip(bounds[:-1], bounds[1:]):
        t = int(b - a)
        fwd = bool(w[a])
        o = int(a)
        while t > 0:
            sz = min(t, 5)
            rad = int(r[o]) if fwd else int(r[o + sz - 1])
            pinfo.inc_kmer_and_rad(part, rad, sz - 1)
            o += sz
            t -= sz
