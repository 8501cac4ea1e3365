"""Sequence input banks: FASTA / FASTQ (plain or gzip) / BAM.

Mirrors the reference bank layer (thirdparty/gatb-core-stripped/src/gatb/
bank/impl/): URI -> format detection with BAM checked before FASTA
(Bank.cpp:44-60), gzip-transparent FASTA/FASTQ parsing (BankFasta.cpp),
BAM decoding with samtools-style flag / reference filtering
(BankBam.cpp:440-550, fork addition), and sample-based size estimation
feeding the configuration stage (BankFasta estimate, ConfigurationAlgorithm).

All banks yield raw sequence ``bytes`` (name available via iter_named).
A "bank" URI may be a comma-separated list of files (composite bank).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np
from dataclasses import dataclass
from typing import Iterator

# BAM 4-bit nibble codes (BankBam.cpp:238-241)
BAM_NT_DECODE = b"=ACMGRSVTWYHKDBN"
_BAM_COMP = bytes.maketrans(b"ACGT", b"TGCA")


# ---------------------------------------------------------------------------
# Format detection (Bank.cpp: album, bam, fasta registration order)
# ---------------------------------------------------------------------------

def _is_gzip(head: bytes) -> bool:
    return head[:2] == b"\x1f\x8b"


def is_album(path: str) -> bool:
    """Album bank: a text file whose every non-empty line names an existing
    sequence file (relative lines resolved against the album's directory) —
    BankAlbum::isAlbumValid (BankAlbum.cpp:124-167)."""
    import os

    try:
        with open(path, "rb") as f:
            raw = f.read(1 << 20)
        text = raw.decode("ascii")
    except (UnicodeDecodeError, OSError):
        return False
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines:
        return False
    base = os.path.dirname(os.path.abspath(path))
    for ln in lines:
        p = ln if os.sep in ln else os.path.join(base, ln)
        if not os.path.exists(p):
            return False
    return True


def album_paths(path: str) -> list[str]:
    import os

    base = os.path.dirname(os.path.abspath(path))
    out = []
    for ln in open(path):
        ln = ln.strip()
        if ln:
            out.append(ln if os.sep in ln else os.path.join(base, ln))
    return out


def sniff_format(path: str) -> str:
    """Return 'album' | 'bam' | 'fasta' | 'fastq'. Registration order is
    album, bam, fasta — BAM before FASTA to prevent misdetection
    (Bank.cpp:44-60)."""
    if is_album(path):
        return "album"
    with open(path, "rb") as f:
        head = f.read(4096)
    if _is_gzip(head):
        try:
            inner = zlib.decompressobj(wbits=31).decompress(head, 256)
        except zlib.error:
            inner = b""
        if inner[:4] == b"BAM\x01":
            return "bam"
        head = inner
    first = head.lstrip()[:1]
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise IOError(f"Unable to detect sequence format of {path}")


# ---------------------------------------------------------------------------
# FASTA / FASTQ
# ---------------------------------------------------------------------------

def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        head = f.read(2)
    if _is_gzip(head):
        return gzip.open(path, "rb")
    return open(path, "rb", buffering=1 << 18)


def iter_fasta(path: str) -> Iterator[tuple[bytes, bytes]]:
    name, chunks = None, []
    with _open_maybe_gz(path) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name, chunks = line[1:], []
            elif line:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def iter_fastq(path: str) -> Iterator[tuple[bytes, bytes]]:
    with _open_maybe_gz(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\r\n")
            f.readline()   # '+'
            f.readline()   # quals
            yield header[1:].rstrip(b"\r\n"), seq


# ---------------------------------------------------------------------------
# BAM (BankBam.cpp — fork addition)
# ---------------------------------------------------------------------------

@dataclass
class BamFilter:
    """samtools-style filters (cli_common.hpp:54-75): ``require_flags`` = -f
    (all bits must be set), ``exclude_flags`` = -F (no bit may be set),
    ``excluded_refs`` = skip reads mapped to these reference names."""
    require_flags: int = 0
    exclude_flags: int = 0
    excluded_refs: frozenset[str] = frozenset()


_BAM_LUT = np.frombuffer(BAM_NT_DECODE, dtype=np.uint8)


# ---------------------------------------------------------------------------
# BGZF (the BAM container): concatenated <= 64KB gzip members, each carrying
# its compressed size in a 'BC' gzip-extra subfield — so members are
# independently inflatable and a thread pool can decode them concurrently
# (zlib releases the GIL). Plain-gzip BAMs (no BC field) fall back to the
# serial gzip module. The reference's BankBam inflates serially through
# zlib (BankBam.cpp); this is a host-throughput improvement over it.
# ---------------------------------------------------------------------------

def _bgzf_member_size(buf: bytes, pos: int) -> int | None:
    """Total byte size of the BGZF member starting at ``pos``, or None if
    ``buf`` doesn't hold its full header yet. Raises ValueError when the
    bytes are not a BGZF member (bad magic / no BC subfield)."""
    hdr = buf[pos:pos + 18]
    if len(hdr) < 18:
        return None
    if hdr[:3] != b"\x1f\x8b\x08" or not hdr[3] & 4:
        raise ValueError("not BGZF")
    (xlen,) = struct.unpack_from("<H", hdr, 10)
    extra = buf[pos + 12:pos + 12 + xlen]
    if len(extra) < xlen:
        return None
    off = 0
    while off + 4 <= xlen:
        si1, si2, slen = extra[off], extra[off + 1], \
            struct.unpack_from("<H", extra, off + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:      # 'B','C'
            (bsize,) = struct.unpack_from("<H", extra, off + 4)
            return bsize + 1
        off += 4 + slen
    raise ValueError("not BGZF")


class _BgzfParallelFile:
    """File-like reader over a BGZF stream that inflates member groups in
    parallel. Only ``read(n)`` / context-manager use (what the BAM paths
    need)."""

    def __init__(self, path: str, threads: int | None = None,
                 group_bytes: int = 8 << 20):
        import os
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        self._f = open(path, "rb", buffering=0)
        self._path = path
        self._group = group_bytes
        self._raw = b""             # compressed carry (partial member)
        self._chunks = deque()      # inflated, not yet consumed
        self._avail = 0
        self._eof = False
        if threads is None:
            threads = int(os.environ.get(
                "KMTRICKS_TPU_BGZF_THREADS",
                min(8, os.cpu_count() or 1)))
        self._pool = ThreadPoolExecutor(max_workers=max(threads, 1)) \
            if threads > 1 else None

    def _fill_once(self) -> None:
        """Read one compressed group, inflate its members in parallel,
        queue the inflated chunks (no large-buffer copies)."""
        data = self._f.read(self._group)
        raw = self._raw + data
        spans = []
        pos = 0
        while True:
            sz = _bgzf_member_size(raw, pos)
            if sz is None or pos + sz > len(raw):
                break
            spans.append((pos, sz))
            pos += sz
        self._raw = raw[pos:]
        if not data:
            self._eof = True
            if self._raw:
                raise EOFError(f"{self._path}: truncated BGZF member")
        mv = memoryview(raw)
        members = [mv[a:a + s] for a, s in spans]
        inflate = lambda m: zlib.decompressobj(wbits=31).decompress(m)
        if self._pool is not None and len(members) > 1:
            chunks = list(self._pool.map(inflate, members))
        else:
            chunks = [inflate(m) for m in members]
        for c in chunks:
            if c:
                self._chunks.append(c)
                self._avail += len(c)

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or self._avail < n):
            self._fill_once()
        if n < 0 or n >= self._avail:
            out = b"".join(self._chunks)
            self._chunks.clear()
            self._avail = 0
            return out
        parts = []
        need = n
        while need:
            c = self._chunks[0]
            if len(c) <= need:
                parts.append(self._chunks.popleft())
                need -= len(c)
            else:
                parts.append(c[:need])
                self._chunks[0] = c[need:]
                need = 0
        self._avail -= n
        return b"".join(parts)

    def close(self) -> None:
        self._f.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_bam_stream(path: str):
    """Inflated-byte reader for a BAM file: parallel BGZF member decode
    when the file is BGZF-framed, serial gzip otherwise."""
    with open(path, "rb") as f:
        head = f.read(4096)
    try:
        if _bgzf_member_size(head, 0) is not None:
            return _BgzfParallelFile(path)
    except ValueError:
        pass
    return gzip.open(path, "rb")


def _read_bam_header(f, path: str) -> list[str]:
    """Consume the BAM magic/header/reference directory from an inflated
    stream; return the reference names (BankBam.cpp header walk)."""
    def read(n):
        b = f.read(n)
        if len(b) != n:
            raise EOFError(f"{path}: truncated BAM header")
        return b

    if read(4) != b"BAM\x01":
        raise IOError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack("<i", read(4))
    read(l_text)
    (n_ref,) = struct.unpack("<i", read(4))
    ref_names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", read(4))
        ref_names.append(read(l_name)[:-1].decode())
        read(4)  # l_ref
    return ref_names


def _bam_excluded_mask(ref_names: list[str], filt: BamFilter):
    """uint8 mask over reference ids for the native parser (None when no
    reference is excluded)."""
    if not filt.excluded_refs:
        return None
    mask = np.zeros(max(len(ref_names), 1), dtype=np.uint8)
    for i, n in enumerate(ref_names):
        if n in filt.excluded_refs:
            mask[i] = 1
    return mask


def _bam_decode_seq(packed: bytes, l_seq: int) -> np.ndarray:
    """Vectorized 4-bit nibble decode (BAM_NT16 codes -> ASCII)."""
    pk = np.frombuffer(packed, dtype=np.uint8)
    nib = np.empty(l_seq, dtype=np.uint8)
    nib[0::2] = pk[:(l_seq + 1) // 2] >> 4
    nib[1::2] = pk[:l_seq // 2] & 0xF
    return _BAM_LUT[nib]


def iter_bam(path: str, filt: BamFilter | None = None
             ) -> Iterator[tuple[bytes, bytes]]:
    """Yield (name, sequence) from a BAM file.

    Semantics of BankBam (BankBam.cpp:440-550): secondary (0x100) and
    supplementary (0x800) alignments are always skipped; -f/-F flag filters
    and excluded-reference filtering apply; reverse-complemented reads
    (0x10) are reverse-complemented back to original orientation (ambiguous
    bases left unchanged).
    """
    filt = filt or BamFilter()
    with _open_bam_stream(path) as f:
        def read(n):
            b = f.read(n)
            if len(b) != n:
                raise EOFError
            return b

        ref_names = _read_bam_header(f, path)
        excluded_ids = {i for i, n in enumerate(ref_names)
                        if n in filt.excluded_refs}

        while True:
            raw = f.read(4)
            if len(raw) < 4:
                return
            (block_size,) = struct.unpack("<i", raw)
            block = read(block_size)
            ref_id, = struct.unpack_from("<i", block, 0)
            l_read_name = block[8]
            n_cigar_op, flag = struct.unpack_from("<HH", block, 12)
            l_seq, = struct.unpack_from("<i", block, 16)
            if flag & 0x100 or flag & 0x800:
                continue
            if filt.require_flags and \
                    (flag & filt.require_flags) != filt.require_flags:
                continue
            if filt.exclude_flags and (flag & filt.exclude_flags):
                continue
            if ref_id in excluded_ids:
                continue
            name = block[32:32 + l_read_name].split(b"\x00", 1)[0]
            off = 32 + l_read_name + 4 * n_cigar_op
            packed = block[off:off + (l_seq + 1) // 2]
            seq = _bam_decode_seq(packed, l_seq).tobytes()
            if flag & 0x10:
                seq = seq[::-1].translate(_BAM_COMP)
            yield name, seq


# ---------------------------------------------------------------------------
# Bank facade
# ---------------------------------------------------------------------------

def iter_bank(uri: str | list[str], bam_filter: BamFilter | None = None
              ) -> Iterator[tuple[bytes, bytes]]:
    """Iterate (name, seq) over a bank URI: one path, a comma-separated list,
    or a list of paths (composite bank, BankAlbum/BankComposite)."""
    paths = uri if isinstance(uri, list) else uri.split(",")
    for p in paths:
        p = p.strip()
        fmt = sniff_format(p)
        if fmt == "album":
            yield from iter_bank(album_paths(p), bam_filter)
        elif fmt == "fasta":
            yield from iter_fasta(p)
        elif fmt == "fastq":
            yield from iter_fastq(p)
        else:
            yield from iter_bam(p, bam_filter)


def iter_sequences(uri: str | list[str],
                   bam_filter: BamFilter | None = None) -> Iterator[bytes]:
    for _, seq in iter_bank(uri, bam_filter):
        yield seq


def _record_cut(data: bytes, fmt: str, carry_last: bytes = b"",
                carry_nl: int = 0) -> int:
    """Largest prefix of ``data`` ending at a record boundary, given that
    the (unscanned) carry before it starts at one. Returns -1 for "no
    complete record yet" (the caller grows the carry without rescanning
    it — only ``data`` is ever scanned, so a record larger than the
    segment size stays linear). ``carry_last`` is the carry's final byte,
    ``carry_nl`` its newline count (< 4 by the cut invariant)."""
    if fmt == "fasta":
        i = data.rfind(b"\n>")
        if i >= 0:
            return i + 1
        # boundary case: the carry ends exactly at the '\n' of '\n>'
        if carry_last == b"\n" and data[:1] == b">":
            return 0
        return -1
    # fastq: 4 lines per record, so cut after the (4q)-th newline overall
    arr = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(arr == 10)
    q = ((carry_nl + len(nl)) // 4) * 4
    if q == 0:
        return -1
    return int(nl[q - carry_nl - 1]) + 1


def _rows_to_batch(block: list[bytes], pad: int):
    L = max((len(s) for s in block), default=1)
    batch = np.full((len(block), L), pad, dtype=np.uint8)
    lengths = np.zeros(len(block), dtype=np.int32)
    for i, s in enumerate(block):
        batch[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    return batch, lengths


def iter_batches(uri: str | list[str], bam_filter: BamFilter | None = None,
                 pad: int = ord("N"), segment_bytes: int = 16 << 20,
                 ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream a bank as ((B, L) uint8, (B,) int32) blocks.

    Plain/gz FASTA and FASTQ are read in large segments, cut at record
    boundaries on the host, and parsed by the native C batch parser —
    the streaming equivalent of :func:`load_batch` with RSS bounded by
    one segment (the reference streams banks through 256KB gzread
    buffers the same way, BankFasta.cpp:42). BAM banks stream through
    the native record-batch parser (BankBam equivalent): records are
    length-prefixed, so the parser reports how many bytes of a segment
    form complete records and the remainder is carried. Album banks and
    missing-native fall back to the record iterators in fixed groups.
    """
    from kmtricks_tpu import native

    paths = uri if isinstance(uri, list) else uri.split(",")
    for p in paths:
        p = p.strip()
        fmt = sniff_format(p)
        if fmt == "bam" and native.lib() is not None:
            filt = bam_filter or BamFilter()
            with _open_bam_stream(p) as f:
                ref_names = _read_bam_header(f, p)
                mask = _bam_excluded_mask(ref_names, filt)
                carry = b""
                while True:
                    data = f.read(segment_bytes)
                    at_eof = not data
                    seg = carry + data
                    if not seg:
                        break
                    got = native.parse_bam_batch(
                        seg, len(ref_names), mask,
                        filt.require_flags, filt.exclude_flags, pad)
                    if got is None:
                        raise IOError(f"{p}: native BAM parse failed")
                    batch, lengths, consumed = got
                    if at_eof and consumed < len(seg):
                        raise EOFError(f"{p}: truncated BAM record")
                    carry = seg[consumed:]
                    if len(lengths):
                        yield batch, lengths
                    if at_eof:
                        break
            continue
        if fmt in ("fasta", "fastq") and native.lib() is not None:
            with _open_maybe_gz(p) as f:
                # the carry (partial record) accumulates as a list so a
                # record larger than the segment size is never re-copied
                # or re-scanned — each read only scans the new segment
                carry: list[bytes] = []
                carry_nl = 0
                while True:
                    data = f.read(segment_bytes)
                    at_eof = not data
                    if at_eof:
                        seg = b"".join(carry)
                        carry = []
                    else:
                        last = carry[-1][-1:] if carry else b""
                        cut = _record_cut(data, fmt, last, carry_nl)
                        if cut < 0:
                            carry.append(data)
                            if fmt == "fastq":
                                carry_nl += data.count(b"\n")
                            continue
                        seg = b"".join(carry) + data[:cut]
                        carry = [data[cut:]] if cut < len(data) else []
                        carry_nl = data.count(b"\n", cut)
                    if seg.strip():
                        got = native.parse_batch(seg, fmt, pad)
                        if got is None:      # native parse failed mid-file
                            raise IOError(f"{p}: native parse failed")
                        if len(got[1]):
                            yield got
                    if at_eof:
                        break
            continue
        block: list[bytes] = []
        for _, s in iter_bank(p, bam_filter):
            block.append(s)
            if len(block) >= 4096:
                yield _rows_to_batch(block, pad)
                block = []
        if block:
            yield _rows_to_batch(block, pad)


def load_batch(uri: str | list[str], bam_filter: BamFilter | None = None,
               pad: int = ord("N")):
    """Load a bank directly into a fixed-shape row batch:
    ((B, L) uint8 padded with 'N', (B,) int32 lengths).

    Plain/gz FASTA and FASTQ go through the native C parser (one pass over
    the raw text, ~10x the Python iterator); BAM goes through the native
    record-batch parser (zlib inflate stays in the gzip module's C layer);
    album banks and missing-native fall back to the record iterators. This
    is the host->device feed for the device/mesh backends (the reference's
    superk stage reads the same banks via its native gatb parsers).
    """
    from kmtricks_tpu import native

    paths = uri if isinstance(uri, list) else uri.split(",")
    batches = []
    for p in paths:
        p = p.strip()
        fmt = sniff_format(p)
        got = None
        if fmt in ("fasta", "fastq"):
            with _open_maybe_gz(p) as f:
                data = f.read()
            got = native.parse_batch(data, fmt, pad)
        elif fmt == "bam":
            filt = bam_filter or BamFilter()
            with _open_bam_stream(p) as f:
                ref_names = _read_bam_header(f, p)
                records = f.read()
            got = native.parse_bam_batch(
                records, len(ref_names), _bam_excluded_mask(ref_names, filt),
                filt.require_flags, filt.exclude_flags, pad)
            if got is not None:
                batch, lengths, consumed = got
                if consumed < len(records):
                    raise EOFError(f"{p}: truncated BAM record")
                got = batch, lengths
        if got is None:
            seqs = [s for _, s in iter_bank(p, bam_filter)]
            L = max((len(s) for s in seqs), default=1)
            batch = np.full((len(seqs), L), pad, dtype=np.uint8)
            lengths = np.zeros(len(seqs), dtype=np.int32)
            for i, s in enumerate(seqs):
                batch[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
                lengths[i] = len(s)
            got = batch, lengths
        batches.append(got)
    if len(batches) == 1:
        return batches[0]
    W = max(b.shape[1] for b, _ in batches)
    B = sum(b.shape[0] for b, _ in batches)
    batch = np.full((B, W), pad, dtype=np.uint8)
    lengths = np.zeros(B, dtype=np.int32)
    off = 0
    for b, ln in batches:
        batch[off:off + b.shape[0], :b.shape[1]] = b
        lengths[off:off + b.shape[0]] = ln
        off += b.shape[0]
    return batch, lengths


@dataclass
class BankEstimate:
    sequences: int
    total_bases: int
    max_size: int


_ESTIMATE_BUF = 256 * 1024      # BankFasta BUFFER_SIZE (BankFasta.cpp:42)


def _estimate_fasta_like(path: str, fmt: str, threshold: int):
    """BankFasta::Iterator::estimate, faithfully (BankFasta.cpp:728-773):
    parse sequences from 256KB decompressed chunks until one MORE than
    ``threshold`` sequences have been consumed (the 50002nd read is
    consumed but not counted — the while-condition order), then linearly
    extrapolate by estimated-file-size / bytes-fetched. gztell counts
    whole buffered chunks, so ``consumed`` advances in 256KB steps."""
    import os

    fsize = os.path.getsize(path)
    # sizing is by NAME (BankFasta.cpp:176): compressed files are assumed
    # ~4x (the Quip-paper "crude hack"). Faithfully: strstr finds the
    # FIRST "gz" in the basename-with-path and the check wants it at the
    # very end — a name containing "gz" earlier (e.g. "gzipped_x.gz")
    # defeats the heuristic and the file is sized as-is
    # (executed-golden-verified).
    gz_named = path.find("gz") == len(path) - 2
    est_size = fsize * 4 if gz_named else fsize

    number = total = mx = 0
    fetched = 0
    with _open_maybe_gz(path) as f:
        carry = b""
        eof = False

        def lines():
            # C-level split per 256KB chunk (a per-line carry reslice is
            # quadratic in chunk size); fetch accounting is unchanged —
            # a chunk is fetched only once the carried data has no
            # complete line left, exactly like the per-line version
            nonlocal carry, eof, fetched
            while True:
                if b"\n" in carry:
                    parts = carry.split(b"\n")
                    carry = parts.pop()
                    for line in parts:
                        yield line.rstrip(b"\r")
                    continue
                if eof:
                    if carry:
                        line, carry = carry, b""
                        yield line.rstrip(b"\r")
                    return
                chunk = f.read(_ESTIMATE_BUF)
                fetched += len(chunk)
                if not chunk:
                    eof = True
                else:
                    carry += chunk

        def records():
            if fmt == "fasta":
                cur = None
                for ln in lines():
                    if ln.startswith(b">"):
                        if cur is not None:
                            yield cur
                        cur = 0
                    elif cur is not None:
                        cur += len(ln)
                if cur is not None:
                    yield cur
            else:
                it = lines()
                while True:
                    try:
                        next(it)                     # @header
                    except StopIteration:
                        return
                    try:
                        yield len(next(it))          # sequence
                        next(it)                     # +
                        next(it)                     # quals
                    except StopIteration:
                        return

        for seq_len in records():
            if number > threshold:
                break            # consumed but not counted (loop order)
            number += 1
            total += seq_len
            if seq_len > mx:
                mx = seq_len
    if fetched > 0:
        # linear extrapolation (exact when the file was fully read and
        # is uncompressed: fetched == est_size). The reference computes
        # the totalSize ratio in FLOAT32 (BankFasta.cpp:771) — emulate
        # for the exact truncated result.
        number = number * est_size // fetched
        ratio = np.float32(np.float32(est_size) / np.float32(fetched))
        total = int(np.float32(total) * ratio)
    return number, total, mx


_ESTIMATE_CACHE: dict = {}


def estimate(uri: str | list[str], sample: int = 50000) -> BankEstimate:
    """Bank size estimation with the reference's exact semantics
    (AbstractBank threshold 50000, BankFasta.cpp estimate + gz x4 name
    sizing + 256KB-chunk gztell extrapolation) — executed-golden-verified
    (tests/test_ref_exec_golden.py). Composite banks sum per-file
    estimates. BAM falls back to record sampling.

    Results are memoized per (paths, size, mtime): a pipeline estimates
    every bank twice (ConfigurationAlgorithm, then the streaming engine's
    chunk sizing), and the sampled parse reads 50k records per file."""
    paths = uri if isinstance(uri, list) else uri.split(",")
    try:
        key = (tuple(p.strip() for p in paths), sample,
               tuple((os.path.getsize(p.strip()),
                      os.stat(p.strip()).st_mtime_ns) for p in paths))
    except OSError:
        key = None
    if key is not None and key in _ESTIMATE_CACHE:
        return _ESTIMATE_CACHE[key]
    total_seqs = 0
    total_bases = 0
    max_size = 0
    for p in paths:
        p = p.strip()
        fmt = sniff_format(p)
        if fmt in ("fasta", "fastq"):
            n, bases, mx = _estimate_fasta_like(p, fmt, sample)
            total_seqs += n
            total_bases += bases
            max_size = max(max_size, mx)
            continue
        n = bases = 0
        for _, seq in iter_bank(p):
            n += 1
            bases += len(seq)
            max_size = max(max_size, len(seq))
            if n > sample:
                break
        total_seqs += n
        total_bases += bases
    res = BankEstimate(total_seqs, total_bases, max_size)
    if key is not None:
        if len(_ESTIMATE_CACHE) > 4096:
            _ESTIMATE_CACHE.clear()
        _ESTIMATE_CACHE[key] = res
    return res
