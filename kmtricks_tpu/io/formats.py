"""Byte-compatible readers/writers for every kmtricks on-disk format.

All files share a 13-byte base header: u64 magic "kmtricks", u32 version (0),
u8 compressed — followed by a per-type magic and fields, then the payload
(wrapped in an LZ4 frame when ``compressed`` — except .hash files whose
blocks use TurboPFor-style framing, see HashFile).

Unlike the reference's record-at-a-time streams, payloads here are bulk
numpy arrays — the natural interchange unit with the device pipeline.

Reference layouts: include/kmtricks/io/{io_common,kmer_file,hash_file,
matrix_file,pa_matrix_file,vector_file,vector_matrix_file,hist_file}.hpp.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

from kmtricks_tpu import constants as C
from kmtricks_tpu.io import lz4, p4

_BASE = struct.Struct("<QI?")  # magic, version, compressed


def _count_dtype(count_bytes: int):
    return {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[count_bytes]


def nbytes(bits: int) -> int:
    return (bits + 7) // 8


# ---------------------------------------------------------------------------
# Type sniffing (io_common.hpp:64-97)
# ---------------------------------------------------------------------------

FILE_TYPES = {
    C.MAGIC_KMER: "kmer",
    C.MAGIC_HASH: "hash",
    C.MAGIC_MATRIX: "matrix",
    C.MAGIC_MATRIX_HASH: "matrix_hash",
    C.MAGIC_PAMATRIX: "pa_matrix",
    C.MAGIC_PAMATRIX_HASH: "pa_matrix_hash",
    C.MAGIC_VECTOR: "vector",
    C.MAGIC_BITMATRIX: "bit_matrix",
    C.MAGIC_HIST: "hist",
    C.MAGIC_SUPERK: "superk",
}


def get_km_file_type(path: str) -> str:
    with open(path, "rb") as f:
        base, _, _ = _BASE.unpack(f.read(13))
        if base != C.MAGIC_BASE:
            raise IOError("Not a kmtricks file.")
        (magic,) = struct.unpack("<Q", f.read(8))
    if magic not in FILE_TYPES:
        raise IOError("Not a kmtricks file.")
    return FILE_TYPES[magic]


def _write_header(f: BinaryIO, compressed: bool, magic: int, fields: bytes) -> None:
    f.write(_BASE.pack(C.MAGIC_BASE, C.KM_IO_VERSION, compressed))
    f.write(struct.pack("<Q", magic))
    f.write(fields)


def _read_header(f: BinaryIO, magic_expect: int | None, fields_fmt: str):
    base, version, compressed = _BASE.unpack(f.read(13))
    if base != C.MAGIC_BASE:
        raise IOError("Invalid file format.")
    if magic_expect is not None:
        (magic,) = struct.unpack("<Q", f.read(8))
        if magic != magic_expect:
            raise IOError("Invalid file format.")
    s = struct.Struct(fields_fmt)
    fields = s.unpack(f.read(s.size))
    return compressed, fields


def _payload(f: BinaryIO, compressed: bool) -> bytes:
    data = f.read()
    return lz4.decompress(data) if compressed else data


# ---------------------------------------------------------------------------
# .kmer — per-sample sorted k-mer counts (kmer_file.hpp:26-108)
# ---------------------------------------------------------------------------

@dataclass
class KmerFileInfo:
    kmer_size: int
    kmer_slots: int
    count_slots: int
    id: int
    partition: int
    compressed: bool


def write_kmer_file(path: str, kmers: np.ndarray, counts: np.ndarray,
                    kmer_size: int, count_bytes: int, sample_id: int,
                    partition: int, compressed: bool = False) -> None:
    slots = (kmer_size + 31) // 32
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64).reshape(-1, slots)
    counts = np.asarray(counts).astype(_count_dtype(count_bytes))
    n = len(counts)
    rec = np.zeros(n, dtype=np.dtype([("kmer", "<u8", (slots,)),
                                      ("count", counts.dtype)]))
    rec["kmer"] = kmers
    rec["count"] = counts
    payload = rec.tobytes()
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_KMER,
                      struct.pack("<IIIII", kmer_size, slots, count_bytes,
                                  sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_kmer_file(path: str) -> tuple[KmerFileInfo, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        compressed, (ksize, slots, cslots, sid, part) = _read_header(
            f, C.MAGIC_KMER, "<IIIII")
        payload = _payload(f, compressed)
    info = KmerFileInfo(ksize, slots, cslots, sid, part, compressed)
    rec = np.frombuffer(payload, dtype=np.dtype(
        [("kmer", "<u8", (slots,)), ("count", _count_dtype(cslots))]))
    return info, rec["kmer"].reshape(-1, slots), rec["count"].copy()


# ---------------------------------------------------------------------------
# .hash — per-sample sorted hash counts, blocked (hash_file.hpp:26-229)
# ---------------------------------------------------------------------------

@dataclass
class HashFileInfo:
    count_slots: int
    id: int
    partition: int
    compressed: bool


HASH_BLOCK = 32768 // 8  # 4096 hashes per block (buf_size / sizeof(u64))


def write_hash_file(path: str, hashes: np.ndarray, counts: np.ndarray,
                    count_bytes: int, sample_id: int, partition: int,
                    compressed: bool = False) -> None:
    """Write a .hash file. Raw blocks are [u64 n][u64 hash × n][count × n];
    compressed (`.hash.p4`) blocks are [u64 n][u64 hash_bytes][p4nd1enc64]
    [u64 count_bytes][p4nzenc] (hash_file.hpp:100-131, codec: io/p4.py).
    """
    hashes = np.asarray(hashes, dtype=np.uint64).ravel()
    counts = np.asarray(counts).astype(_count_dtype(count_bytes)).ravel()
    parts = []
    for off in range(0, len(hashes), HASH_BLOCK):
        h = hashes[off:off + HASH_BLOCK]
        c = counts[off:off + HASH_BLOCK]
        parts.append(struct.pack("<Q", len(h)))
        if compressed:
            hb = p4.p4nd1enc64(h)
            cb = p4.p4nzenc(c, count_bytes)
            parts.append(struct.pack("<Q", len(hb)))
            parts.append(hb)
            parts.append(struct.pack("<Q", len(cb)))
            parts.append(cb)
            continue
        parts.append(h.tobytes())
        parts.append(c.tobytes())
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_HASH,
                      struct.pack("<III", count_bytes, sample_id, partition))
        f.write(b"".join(parts))


def read_hash_file(path: str) -> tuple[HashFileInfo, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        compressed, (cslots, sid, part) = _read_header(f, C.MAGIC_HASH, "<III")
        data = f.read()
    cdt = _count_dtype(cslots)
    hs, cs = [], []
    i = 0
    while i + 8 <= len(data):
        (n,) = struct.unpack_from("<Q", data, i)
        i += 8
        if compressed:
            (hb,) = struct.unpack_from("<Q", data, i)
            i += 8
            hs.append(p4.p4nd1dec64(data[i:i + hb], n))
            i += hb
            (cb,) = struct.unpack_from("<Q", data, i)
            i += 8
            cs.append(p4.p4nzdec(data[i:i + cb], n, cslots))
            i += cb
            continue
        hs.append(np.frombuffer(data, dtype=np.uint64, count=n, offset=i))
        i += 8 * n
        cs.append(np.frombuffer(data, dtype=cdt, count=n, offset=i))
        i += int(cdt().itemsize) * n
    info = HashFileInfo(cslots, sid, part, compressed)
    empty = np.zeros(0, dtype=np.uint64)
    return (info,
            np.concatenate(hs) if hs else empty,
            np.concatenate(cs) if cs else empty.astype(cdt))


# ---------------------------------------------------------------------------
# .count — k-mer count matrix (matrix_file.hpp:26-178)
# ---------------------------------------------------------------------------

@dataclass
class MatrixFileInfo:
    kmer_size: int
    kmer_slots: int
    count_slots: int
    nb_counts: int
    id: int
    partition: int
    compressed: bool


def write_matrix_file(path: str, kmers: np.ndarray, counts: np.ndarray,
                      kmer_size: int, count_bytes: int, sample_id: int,
                      partition: int, compressed: bool = False,
                      header_count_slots: int = 1) -> None:
    """Count-matrix writer. NOTE the reference quirk: KmerMerger::write_as_bin
    (merge.hpp:262-272) hardcodes header count_slots=1 regardless of the real
    count width; readers use their compile-time width. We reproduce that
    by default (header_count_slots=1) for byte equality.
    """
    slots = (kmer_size + 31) // 32
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64).reshape(-1, slots)
    counts = np.ascontiguousarray(counts).astype(_count_dtype(count_bytes))
    n, nb = counts.shape
    rec = np.zeros(n, dtype=np.dtype([("kmer", "<u8", (slots,)),
                                      ("counts", counts.dtype, (nb,))]))
    rec["kmer"] = kmers
    rec["counts"] = counts
    payload = rec.tobytes()
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_MATRIX,
                      struct.pack("<IIIIII", kmer_size, slots,
                                  header_count_slots, nb, sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_matrix_file(path: str, count_bytes: int = 4, kasm: bool = False
                     ) -> tuple[MatrixFileInfo, np.ndarray, np.ndarray]:
    """Read a .count matrix. ``count_bytes`` must match the writer's real
    count width (the header lies — see write_matrix_file). ``kasm`` reads
    the kasm-compat header variant (matrix_file.hpp:55-74: u64 dummy,
    kmer_size, kmer_slots, id, partition, count_slots; nb_counts = 1)."""
    with open(path, "rb") as f:
        if kasm:
            compressed, (_dummy, ksize, slots, sid, part, cslots) = \
                _read_header(f, None, "<QIIIII")
            nb = 1
        else:
            compressed, (ksize, slots, cslots, nb, sid, part) = _read_header(
                f, C.MAGIC_MATRIX, "<IIIIII")
        payload = _payload(f, compressed)
    info = MatrixFileInfo(ksize, slots, cslots, nb, sid, part, compressed)
    rec = np.frombuffer(payload, dtype=np.dtype(
        [("kmer", "<u8", (slots,)), ("counts", _count_dtype(count_bytes), (nb,))]))
    return info, rec["kmer"].reshape(-1, slots), rec["counts"].reshape(-1, nb)


# ---------------------------------------------------------------------------
# .count_hash — hash count matrix (matrix_file.hpp:180-311)
# ---------------------------------------------------------------------------

def write_matrix_hash_file(path: str, hashes: np.ndarray, counts: np.ndarray,
                           count_bytes: int, sample_id: int, partition: int,
                           compressed: bool = False) -> None:
    hashes = np.asarray(hashes, dtype=np.uint64).ravel()
    counts = np.ascontiguousarray(counts).astype(_count_dtype(count_bytes))
    n, nb = counts.shape
    rec = np.zeros(n, dtype=np.dtype([("hash", "<u8"),
                                      ("counts", counts.dtype, (nb,))]))
    rec["hash"] = hashes
    rec["counts"] = counts
    payload = rec.tobytes()
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_MATRIX_HASH,
                      struct.pack("<IIII", count_bytes, nb, sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_matrix_hash_file(path: str):
    with open(path, "rb") as f:
        compressed, (cslots, nb, sid, part) = _read_header(
            f, C.MAGIC_MATRIX_HASH, "<IIII")
        payload = _payload(f, compressed)
    rec = np.frombuffer(payload, dtype=np.dtype(
        [("hash", "<u8"), ("counts", _count_dtype(cslots), (nb,))]))
    info = MatrixFileInfo(0, 0, cslots, nb, sid, part, compressed)
    return info, rec["hash"].copy(), rec["counts"].reshape(-1, nb)


# ---------------------------------------------------------------------------
# .pa / .pa_hash — presence/absence matrices (pa_matrix_file.hpp)
# ---------------------------------------------------------------------------

@dataclass
class PAMatrixFileInfo:
    kmer_size: int
    kmer_slots: int
    bits: int
    bytes: int
    id: int
    partition: int
    compressed: bool


def pack_pa_bits(pa: np.ndarray) -> np.ndarray:
    """(N, nb_samples) bool/int -> (N, nbytes) uint8, LSB-first per byte
    (utils.hpp BITSET convention)."""
    return np.packbits(pa.astype(bool), axis=1, bitorder="little")


def unpack_pa_bits(rows: np.ndarray, bits: int) -> np.ndarray:
    return np.unpackbits(rows, axis=1, count=bits, bitorder="little").astype(bool)


def write_pa_matrix_file(path: str, kmers: np.ndarray, pa_rows: np.ndarray,
                         kmer_size: int, bits: int, sample_id: int,
                         partition: int, compressed: bool = False) -> None:
    slots = (kmer_size + 31) // 32
    nb = nbytes(bits)
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64).reshape(-1, slots)
    pa_rows = np.ascontiguousarray(pa_rows, dtype=np.uint8).reshape(-1, nb)
    rec = np.zeros(len(pa_rows), dtype=np.dtype(
        [("kmer", "<u8", (slots,)), ("bits", "u1", (nb,))]))
    rec["kmer"] = kmers
    rec["bits"] = pa_rows
    payload = rec.tobytes()
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_PAMATRIX,
                      struct.pack("<IIIIII", kmer_size, slots, bits, nb,
                                  sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_pa_matrix_file(path: str):
    with open(path, "rb") as f:
        compressed, (ksize, slots, bits, nb, sid, part) = _read_header(
            f, C.MAGIC_PAMATRIX, "<IIIIII")
        payload = _payload(f, compressed)
    info = PAMatrixFileInfo(ksize, slots, bits, nb, sid, part, compressed)
    rec = np.frombuffer(payload, dtype=np.dtype(
        [("kmer", "<u8", (slots,)), ("bits", "u1", (nb,))]))
    return info, rec["kmer"].reshape(-1, slots), rec["bits"].reshape(-1, nb)


def write_pa_hash_matrix_file(path: str, hashes: np.ndarray, pa_rows: np.ndarray,
                              bits: int, sample_id: int, partition: int,
                              compressed: bool = False) -> None:
    nb = nbytes(bits)
    hashes = np.asarray(hashes, dtype=np.uint64).ravel()
    pa_rows = np.ascontiguousarray(pa_rows, dtype=np.uint8).reshape(-1, nb)
    rec = np.zeros(len(pa_rows), dtype=np.dtype(
        [("hash", "<u8"), ("bits", "u1", (nb,))]))
    rec["hash"] = hashes
    rec["bits"] = pa_rows
    payload = rec.tobytes()
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_PAMATRIX_HASH,
                      struct.pack("<IIII", bits, nb, sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_pa_hash_matrix_file(path: str):
    with open(path, "rb") as f:
        compressed, (bits, nb, sid, part) = _read_header(
            f, C.MAGIC_PAMATRIX_HASH, "<IIII")
        payload = _payload(f, compressed)
    info = PAMatrixFileInfo(0, 0, bits, nb, sid, part, compressed)
    rec = np.frombuffer(payload, dtype=np.dtype(
        [("hash", "<u8"), ("bits", "u1", (nb,))]))
    return info, rec["hash"].copy(), rec["bits"].reshape(-1, nb)


# ---------------------------------------------------------------------------
# .vector — one dense bit vector (vector_file.hpp)
# ---------------------------------------------------------------------------

def write_bit_vector_file(path: str, bit_bytes: bytes | np.ndarray, bits: int,
                          sample_id: int, partition: int,
                          compressed: bool = False) -> None:
    payload = bytes(bytearray(np.asarray(bit_bytes, dtype=np.uint8).tobytes()
                              if not isinstance(bit_bytes, (bytes, bytearray))
                              else bit_bytes))
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_VECTOR,
                      struct.pack("<QII", bits, sample_id, partition))
        f.write(lz4.compress(payload) if compressed else payload)


def read_bit_vector_file(path: str):
    with open(path, "rb") as f:
        compressed, (bits, sid, part) = _read_header(f, C.MAGIC_VECTOR, "<QII")
        payload = _payload(f, compressed)
    return (bits, sid, part), np.frombuffer(payload, dtype=np.uint8)


# ---------------------------------------------------------------------------
# .cmbf — vertical BF matrix (vector_matrix_file.hpp)
# ---------------------------------------------------------------------------

@dataclass
class VectorMatrixFileInfo:
    bits: int          # row width in bits (= nb samples, or samples*w for cbf)
    id: int
    partition: int
    first: int         # lower hash bound of the window
    window: int        # number of rows (upper-lower+1)
    compressed: bool


def write_vector_matrix_file(path: str, rows: np.ndarray, bits: int,
                             sample_id: int, partition: int, first: int,
                             window: int, compressed: bool = False) -> None:
    """rows: (window, nbytes(bits)) uint8 — one row per hash value, dense."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    # memoryview, not tobytes(): a bloom-scale window is ~117 MB and the
    # copy would cost as much as the write — write straight from the
    # array buffer
    # (the lz4 binding needs a bytes object, so only that path copies)
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_BITMATRIX,
                      struct.pack("<IQQII", bits, first, window,
                                  sample_id, partition))
        f.write(lz4.compress(rows.tobytes()) if compressed
                else memoryview(rows).cast("B"))


def read_vector_matrix_file(path: str):
    info, rows = read_vector_matrix_payload(path)
    return info, rows.reshape(-1, nbytes(info.bits))


def read_vector_matrix_rows(path: str, first_row: int, n_rows: int):
    """Seek-read a row range of an uncompressed .cmbf — the reference's
    VectorMatrixReader::read(vec, p) ``seekg(49 + p*window/8)`` query path
    (vector_matrix_file.hpp)."""
    with open(path, "rb") as f:
        compressed, (bits, first, window, sid, part) = _read_header(
            f, C.MAGIC_BITMATRIX, "<IQQII")
        info = VectorMatrixFileInfo(bits, sid, part, first, window,
                                    compressed)
        nb = nbytes(bits)
        if compressed:
            rows = np.frombuffer(lz4.decompress(f.read()),
                                 dtype=np.uint8).reshape(-1, nb)
            return info, rows[first_row:first_row + n_rows]
        f.seek(first_row * nb, 1)
        data = f.read(n_rows * nb)
    return info, np.frombuffer(data, dtype=np.uint8).reshape(-1, nb)


def read_vector_matrix_payload(path: str):
    """Raw payload variant: needed for transposed (bft) matrices whose row
    width is ROUND_UP(window,8)/8 bytes, not nbytes(header.bits)."""
    with open(path, "rb") as f:
        compressed, (bits, first, window, sid, part) = _read_header(
            f, C.MAGIC_BITMATRIX, "<IQQII")
        payload = _payload(f, compressed)
    info = VectorMatrixFileInfo(bits, sid, part, first, window, compressed)
    return info, np.frombuffer(payload, dtype=np.uint8)


# ---------------------------------------------------------------------------
# .hist — abundance histogram (hist_file.hpp)
# ---------------------------------------------------------------------------

@dataclass
class HistFileInfo:
    kmer_size: int
    id: int
    lower: int
    upper: int
    uniq: int
    total: int
    oob_lu: int
    oob_uu: int
    oob_ln: int
    oob_un: int
    compressed: bool


def write_hist_file(path: str, hist, compressed: bool = False) -> None:
    """hist: core.histogram.KHist."""
    payload = (np.asarray(hist.hist_u, dtype=np.uint64).tobytes()
               + np.asarray(hist.hist_n, dtype=np.uint64).tobytes())
    with open(path, "wb") as f:
        _write_header(f, compressed, C.MAGIC_HIST,
                      struct.pack("<IIQQQQQQQQ", hist.ksize, hist.idx,
                                  hist.lower, hist.upper, hist.uniq, hist.total,
                                  hist.oob_lu, hist.oob_uu, hist.oob_ln,
                                  hist.oob_un))
        f.write(lz4.compress(payload) if compressed else payload)


def read_hist_file(path: str):
    with open(path, "rb") as f:
        compressed, fields = _read_header(f, C.MAGIC_HIST, "<IIQQQQQQQQ")
        payload = _payload(f, compressed)
    info = HistFileInfo(*fields, compressed)
    size = info.upper - info.lower + 1
    arr = np.frombuffer(payload, dtype=np.uint64)
    return info, arr[:size].copy(), arr[size:2 * size].copy()
