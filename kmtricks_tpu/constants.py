"""Shared constants: nucleotide encoding, file magics, defaults.

Encoding contract (reference: include/kmtricks/kmer.hpp:38-49):
2-bit nucleotide codes are A=0, C=1, T=2, G=3 (NOT alphabetical order).
This is the classic ``(ascii >> 1) & 3`` encoding; its key property is that
the complement of a code is ``code ^ 2`` (A<->T, C<->G).

K-mers are packed as base-4 polynomials: the first (leftmost) nucleotide of
the string sits in the highest-order bits. Multi-word k-mers use little-endian
word order (``words[0]`` = lowest 64 bits).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Nucleotide encoding
# ---------------------------------------------------------------------------

BASE_TO_CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
CODE_TO_BASE = "ACTG"  # bToN
CODE_COMPLEMENT = np.array([2, 3, 0, 1], dtype=np.uint8)  # revB: code ^ 2

# NToB equivalent (reference kmer.hpp:41-49): any non-ACGT byte maps to 1.
NT_TO_CODE_TABLE = np.ones(256, dtype=np.uint8)
for _b, _c in ((65, 0), (67, 1), (84, 2), (71, 3),  # 'A' 'C' 'T' 'G'
               (97, 0), (99, 1), (116, 2), (103, 3)):  # lowercase
    NT_TO_CODE_TABLE[_b] = _c

# GATB ConvertASCII (Data.hpp:179): code = (byte >> 1) & 3, valid iff the byte
# is one of "ACGTacgt" (Data.cpp validNucleotide table; 0 == valid there, we
# store True == valid).
ASCII_CODE_TABLE = ((np.arange(256, dtype=np.uint16) >> 1) & 3).astype(np.uint8)
ASCII_VALID_TABLE = np.zeros(256, dtype=bool)
for _b in (65, 67, 71, 84, 97, 99, 103, 116):
    ASCII_VALID_TABLE[_b] = True

# rev_table equivalent (kmer.hpp:50-67): for one byte holding four 2-bit
# codes, reverse the code order and complement each code.
_idx = np.arange(256, dtype=np.uint16)
_c0 = (_idx >> 0) & 3
_c1 = (_idx >> 2) & 3
_c2 = (_idx >> 4) & 3
_c3 = (_idx >> 6) & 3
BYTE_REVCOMP_TABLE = (
    ((_c0 ^ 2) << 6) | ((_c1 ^ 2) << 4) | ((_c2 ^ 2) << 2) | ((_c3 ^ 2) << 0)
).astype(np.uint8)

# ---------------------------------------------------------------------------
# File magics (reference include/kmtricks/io/io_common.hpp:50-62)
# ---------------------------------------------------------------------------

MAGIC_BASE = 0x736B636972746D6B      # "kmtricks"
MAGIC_KMER = 0x72656D6B              # "kmer"
MAGIC_HASH = 0x68736168              # "hash"
MAGIC_MATRIX = 0x6B5F78697274616D    # "matrix_k"
MAGIC_MATRIX_HASH = 0x685F78697274616D  # "matrix_h"
MAGIC_PAMATRIX = 0x6B5F74616D6170    # "pamat_k"
MAGIC_PAMATRIX_HASH = 0x685F74616D6170  # "pamat_h"
MAGIC_VECTOR = 0x726F74636576        # "vector"
MAGIC_BITMATRIX = 0x74616D746962     # "bitmat"
MAGIC_HIST = 0x747369686B            # "khist"
MAGIC_SUPERK = 0x6B7265707573        # "superk"
MAGIC_GATB_REPART = 0x12345678       # repartition.hpp:31

KM_IO_VERSION = 0

# ---------------------------------------------------------------------------
# Defaults (reference src/cli.cpp pipeline options)
# ---------------------------------------------------------------------------

DEFAULT_KMER_SIZE = 31
DEFAULT_MINIM_SIZE = 10
DEFAULT_HARD_MIN = 2
DEFAULT_SOFT_MIN = 1
DEFAULT_RECURRENCE_MIN = 1
DEFAULT_SHARE_MIN = 0
DEFAULT_BLOOM_SIZE = 10_000_000
DEFAULT_BITW = 2
DEFAULT_MAX_MEMORY_MB = 8192   # --max-memory (MB per core)

# GATB Sequence2SuperKmer: sentinel marking an undefined superkmer minimizer.
DEFAULT_MINIMIZER = 1_000_000_000

# XXH64 primes.
XXH_PRIME64_1 = 0x9E3779B185EBCA87
XXH_PRIME64_2 = 0xC2B2AE3D27D4EB4F
XXH_PRIME64_3 = 0x165667B19E3779F9
XXH_PRIME64_4 = 0x85EBCA77C2B2AE63
XXH_PRIME64_5 = 0x27D4EB2F165667C5
