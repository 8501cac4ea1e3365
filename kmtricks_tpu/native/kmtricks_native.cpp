// kmtricks_tpu native host codecs.
//
// The reference implements its host-side byte-twiddling (lz4 frame streams,
// superkmer packing, xxHash) in native code (thirdparty/lz4, xxHash, and the
// gatb superkmer serializer); this module is this framework's native
// equivalent, exposed to Python via ctypes (no pybind11 in this image).
//
// Contents (all clean-room from the public specs):
//   * LZ4 block + frame codec (compress/decompress), matching the LZ4 Frame
//     format v1.6.3 (magic 0x184D2204, FLG/BD, optional content checksum) so
//     files interoperate with the reference's lz4_stream layers.
//   * XXH32 / XXH64 (needed for frame header checksums and k-mer hashing).
//   * Batch superkmer pack/unpack (gatb Model.hpp:1388-1433 byte layout).
//
// Build: see build.py (g++ -O3 -march=native -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <initializer_list>

extern "C" {

// ---------------------------------------------------------------------------
// XXH32 / XXH64 (public algorithm, implemented from the spec)
// ---------------------------------------------------------------------------

static const uint32_t P32_1 = 2654435761U, P32_2 = 2246822519U,
                      P32_3 = 3266489917U, P32_4 = 668265263U,
                      P32_5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}

uint32_t km_xxh32(const uint8_t* data, size_t len, uint32_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P32_1 + P32_2, v2 = seed + P32_2, v3 = seed,
             v4 = seed - P32_1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v2 = rotl32(v2 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v3 = rotl32(v3 + rd32(p) * P32_2, 13) * P32_1; p += 4;
      v4 = rotl32(v4 + rd32(p) * P32_2, 13) * P32_1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P32_5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + rd32(p) * P32_3, 17) * P32_4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P32_5, 11) * P32_1;
    p++;
  }
  h ^= h >> 15; h *= P32_2; h ^= h >> 13; h *= P32_3; h ^= h >> 16;
  return h;
}

static const uint64_t P64_1 = 11400714785074694791ULL,
                      P64_2 = 14029467366897019727ULL,
                      P64_3 = 1609587929392839161ULL,
                      P64_4 = 9650029242287828579ULL,
                      P64_5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t round64(uint64_t acc, uint64_t input) {
  return rotl64(acc + input * P64_2, 31) * P64_1;
}

uint64_t km_xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P64_1 + P64_2, v2 = seed + P64_2, v3 = seed,
             v4 = seed - P64_1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round64(v1, rd64(p)); p += 8;
      v2 = round64(v2, rd64(p)); p += 8;
      v3 = round64(v3, rd64(p)); p += 8;
      v4 = round64(v4, rd64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4})
      h = (h ^ round64(0, v)) * P64_1 + P64_4;
  } else {
    h = seed + P64_5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h = rotl64(h ^ round64(0, rd64(p)), 27) * P64_1 + P64_4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl64(h ^ (rd32(p) * P64_1), 23) * P64_2 + P64_3;
    p += 4;
  }
  while (p < end) {
    h = rotl64(h ^ ((*p) * P64_5), 11) * P64_1;
    p++;
  }
  h ^= h >> 33; h *= P64_2; h ^= h >> 29; h *= P64_3; h ^= h >> 32;
  return h;
}

// batch: XXH64 over rows of `words` u64 little-endian words
void km_xxh64_batch(const uint64_t* words, size_t n, size_t slots,
                    uint64_t seed, uint64_t* out) {
  for (size_t i = 0; i < n; i++)
    out[i] = km_xxh64((const uint8_t*)(words + i * slots), slots * 8, seed);
}

// ---------------------------------------------------------------------------
// LZ4 block codec (clean-room from the public LZ4 block format spec)
// ---------------------------------------------------------------------------

// Decompress one block. Returns decompressed size or -1 on error.
int64_t km_lz4_decompress_block(const uint8_t* src, size_t src_len,
                                uint8_t* dst, size_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    memcpy(op, ip, lit);
    ip += lit; op += lit;
    if (ip >= iend) break;          // last literals
    if (ip + 2 > iend) return -1;
    size_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || (size_t)(op - dst) < offset) return -1;
    size_t mlen = (token & 15);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t* match = op - offset;
    for (size_t i = 0; i < mlen; i++) op[i] = match[i];   // overlap-safe
    op += mlen;
  }
  return (int64_t)(op - dst);
}

// Greedy hash-table compressor producing valid LZ4 blocks.
// Returns compressed size, or -1 if dst too small.
int64_t km_lz4_compress_block(const uint8_t* src, size_t src_len,
                              uint8_t* dst, size_t dst_cap) {
  static const size_t MINMATCH = 4, MFLIMIT = 12, LASTLITERALS = 5;
  uint8_t* op = dst;
  uint8_t* oend = dst + dst_cap;
  const uint8_t* ip = src;
  const uint8_t* iend = src + src_len;
  const uint8_t* anchor = src;

  auto write_len = [&](size_t len) -> bool {
    while (len >= 255) {
      if (op >= oend) return false;
      *op++ = 255;
      len -= 255;
    }
    if (op >= oend) return false;
    *op++ = (uint8_t)len;
    return true;
  };
  auto emit = [&](size_t lit, const uint8_t* litp, size_t mlen,
                  size_t offset) -> bool {
    uint8_t* token = op;
    if (op >= oend) return false;
    op++;
    uint8_t t = 0;
    if (lit >= 15) {
      t = 15 << 4;
      if (!write_len(lit - 15)) return false;
    } else {
      t = (uint8_t)(lit << 4);
    }
    if (op + lit > oend) return false;
    memcpy(op, litp, lit);
    op += lit;
    if (mlen) {
      if (op + 2 > oend) return false;
      *op++ = (uint8_t)(offset & 255);
      *op++ = (uint8_t)(offset >> 8);
      size_t m = mlen - MINMATCH;
      if (m >= 15) {
        t |= 15;
        if (!write_len(m - 15)) return false;
      } else {
        t |= (uint8_t)m;
      }
    }
    *token = t;
    return true;
  };

  if (src_len >= MFLIMIT) {
    const size_t HSIZE = 1 << 16;
    static thread_local int64_t table[1 << 16];
    for (size_t i = 0; i < HSIZE; i++) table[i] = -1;
    const uint8_t* mflimit = iend - MFLIMIT;
    while (ip <= mflimit) {
      uint32_t seq = rd32(ip);
      uint32_t hsh = (seq * 2654435761U) >> 16;
      int64_t cand = table[hsh];
      table[hsh] = ip - src;
      if (cand >= 0 && (size_t)(ip - src) - (size_t)cand <= 65535 &&
          rd32(src + cand) == seq) {
        const uint8_t* match = src + cand;
        const uint8_t* mend = iend - LASTLITERALS;
        size_t mlen = MINMATCH;
        while (ip + mlen < mend && ip[mlen] == match[mlen]) mlen++;
        if (!emit((size_t)(ip - anchor), anchor, mlen,
                  (size_t)(ip - match)))
          return -1;
        ip += mlen;
        anchor = ip;
      } else {
        ip++;
      }
    }
  }
  if (!emit((size_t)(iend - anchor), anchor, 0, 0)) return -1;
  return (int64_t)(op - dst);
}

// ---------------------------------------------------------------------------
// Superkmer pack/unpack (gatb Model.hpp:1388-1433 layout)
// ---------------------------------------------------------------------------

// Pack `total` 2-bit codes (k + nbk - 1) for one superkmer.
// Returns bytes written ( = ceil(total/4) arranged per the gatb layout ).
int64_t km_pack_superkmer(const uint8_t* codes, int k, int total,
                          uint8_t* out) {
  uint8_t* op = out;
  int i = k - 1;
  while (i >= 3) {
    *op++ = (uint8_t)(codes[i] | (codes[i - 1] << 2) | (codes[i - 2] << 4) |
                      (codes[i - 3] << 6));
    i -= 4;
  }
  int rem = i + 1;
  uint8_t cur = 0;
  int uid = rem;
  for (int t = 0; t < rem; t++) cur |= codes[rem - 1 - t] << (2 * t);
  for (int j = k; j < total; j++) {
    if (uid == 4) {
      *op++ = cur;
      cur = 0;
      uid = 0;
    }
    cur |= codes[j] << (2 * uid);
    uid++;
  }
  if (uid > 0) *op++ = cur;
  return (int64_t)(op - out);
}

int64_t km_unpack_superkmer(const uint8_t* data, int k, int nbk,
                            uint8_t* codes) {
  int total = k + nbk - 1;
  const uint8_t* bp = data;
  int i = k - 1;
  for (int f = 0; f < k / 4; f++) {
    uint8_t b = *bp++;
    codes[i] = b & 3;
    codes[i - 1] = (b >> 2) & 3;
    codes[i - 2] = (b >> 4) & 3;
    codes[i - 3] = (b >> 6) & 3;
    i -= 4;
  }
  int rem = k % 4;
  uint8_t cur = 0;
  int uid;
  bool have = false;
  if (rem) {
    cur = *bp;
    have = true;
    for (int t = 0; t < rem; t++) codes[rem - 1 - t] = (cur >> (2 * t)) & 3;
    uid = rem;
  } else {
    uid = 4;
  }
  for (int j = k; j < total; j++) {
    if (uid == 4) {
      if (have) bp++;
      cur = *bp;
      have = true;
      uid = 0;
    }
    codes[j] = (cur >> (2 * uid)) & 3;
    uid++;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Sequence batch parsing (FASTA / FASTQ text -> fixed-shape row batches)
// ---------------------------------------------------------------------------

// Scan FASTA text. Two-pass API:
//   batch == nullptr: count records, write max sequence length to *max_len;
//   batch != nullptr: fill `rows` x `L` (caller pre-fills padding, e.g. 'N')
//     and per-row lengths; rows beyond `rows` or bases beyond L are an error
//     (-1). Multi-line sequences are concatenated; '\r' is stripped.
// Returns the number of records (or -1 on overflow).
int64_t km_fasta_batch(const uint8_t* data, size_t len,
                       uint8_t* batch, int64_t rows, int64_t L,
                       int32_t* lengths, int64_t* max_len) {
  int64_t n = -1;       // current record index
  int64_t cur = 0;      // current sequence length
  int64_t mx = 0;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* eol = nl ? nl : end;
    size_t ll = eol - p;
    while (ll && p[ll - 1] == '\r') ll--;
    if (ll && p[0] == '>') {
      if (n >= 0) {
        if (lengths) lengths[n] = (int32_t)cur;
        if (cur > mx) mx = cur;
      }
      n++;
      cur = 0;
      if (batch && n >= rows) return -1;
    } else if (ll && n >= 0) {
      if (batch) {
        if (cur + (int64_t)ll > L) return -1;
        memcpy(batch + n * L + cur, p, ll);
      }
      cur += ll;
    }
    p = eol + 1;
  }
  if (n >= 0) {
    if (lengths) lengths[n] = (int32_t)cur;
    if (cur > mx) mx = cur;
  }
  if (max_len) *max_len = mx;
  return n + 1;
}

// Same for FASTQ (4-line records, sequence on line 2).
int64_t km_fastq_batch(const uint8_t* data, size_t len,
                       uint8_t* batch, int64_t rows, int64_t L,
                       int32_t* lengths, int64_t* max_len) {
  int64_t n = 0;
  int64_t mx = 0;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  int line = 0;
  while (p < end) {
    const uint8_t* nl = (const uint8_t*)memchr(p, '\n', end - p);
    const uint8_t* eol = nl ? nl : end;
    size_t ll = eol - p;
    while (ll && p[ll - 1] == '\r') ll--;
    if (line == 1) {
      if (batch) {
        if (n >= rows || (int64_t)ll > L) return -1;
        memcpy(batch + n * L, p, ll);
      }
      if (lengths) lengths[n] = (int32_t)ll;
      if ((int64_t)ll > mx) mx = (int64_t)ll;
      n++;
    }
    line = (line + 1) & 3;
    p = eol + 1;
  }
  if (max_len) *max_len = mx;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Greedy LPT minimizer->partition packing (Repartitor::computeDistrib,
// gatb PartiInfo.cpp:48-106): sort bins by decreasing kx-mer count, assign
// each to the currently emptiest partition. The ALGORITHM ties (equal-count
// bins, equal-load partitions) are resolved by std::sort's and
// std::priority_queue's implementation-defined-but-deterministic behavior —
// running the same STL primitives here reproduces the reference binary's
// table bit-for-bit on the same platform (verified against an executed
// computeDistrib, tests/test_ref_exec_golden.py). Python fallback uses
// specified tie-breaks instead (core/repartition.py).
// ---------------------------------------------------------------------------
#include <algorithm>
#include <queue>
#include <utility>
#include <vector>

extern "C" int64_t km_lpt_distrib(const uint64_t* bin_sizes,
                                  uint64_t nb_minims, int nbpart,
                                  uint16_t* table_out) {
  using ipair = std::pair<uint64_t, uint64_t>;      // (size, minimizer)
  struct triple { uint64_t part, load, n; };
  struct comp_load {
    bool operator()(const triple& l, const triple& r) const {
      return l.load > r.load;
    }
  };
  std::vector<ipair> bins;
  bins.reserve(nb_minims);
  for (uint64_t i = 0; i < nb_minims; i++)
    bins.push_back(ipair(bin_sizes[i], i));
  std::priority_queue<triple, std::vector<triple>, comp_load> pq;
  for (int j = 0; j < nbpart; j++) pq.push(triple{(uint64_t)j, 0, 0});
  std::sort(bins.begin(), bins.end(),
            [](const ipair& l, const ipair& r) { return l.first > r.first; });
  for (uint64_t cur = 0; cur < nb_minims; cur++) {
    triple t = pq.top();
    pq.pop();
    table_out[bins[cur].second] = (uint16_t)t.part;
    t.load += bins[cur].first;
    t.n++;
    pq.push(t);
  }
  return (int64_t)nb_minims;
}

extern "C" {

// ---------------------------------------------------------------------------
// BAM record-batch parsing (the reference's BankBam is native too:
// gatb-core-stripped/src/gatb/bank/impl/BankBam.cpp:440-550). Input is the
// INFLATED BAM byte stream positioned after the header (alignment records
// only — the caller parses magic/header/refs in Python, once per file).
//
// Two-pass API like km_fasta_batch:
//   batch == nullptr: count records passing the filters, write the max
//     sequence length to *max_len and the byte offset just past the last
//     COMPLETE record to *consumed (streaming callers carry the tail);
//   batch != nullptr: fill `rows` x `L` and per-row lengths.
// Semantics: secondary (0x100) / supplementary (0x800) always skipped;
// require_flags (-f: all bits set), exclude_flags (-F: no bit set);
// excluded_mask[ref_id] != 0 skips reads mapped to that reference;
// flag 0x10 reads are reverse-complemented back to original orientation
// (only A/C/G/T complemented — ambiguity codes pass through, matching
// BankBam). Returns the record count (or -1 on overflow/malformed).
// ---------------------------------------------------------------------------
static const char BAM_NT16[] = "=ACMGRSVTWYHKDBN";

int64_t km_bam_batch(const uint8_t* data, size_t len,
                     int64_t n_refs, const uint8_t* excluded_mask,
                     uint32_t require_flags, uint32_t exclude_flags,
                     uint8_t* batch, int64_t rows, int64_t L,
                     int32_t* lengths, int64_t* max_len,
                     int64_t* consumed) {
  uint8_t comp[256];
  for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
  comp['A'] = 'T'; comp['T'] = 'A'; comp['C'] = 'G'; comp['G'] = 'C';
  // packed byte -> two ASCII bases at once (little-endian u16 store)
  uint16_t pair[256];
  for (int i = 0; i < 256; i++)
    pair[i] = (uint16_t)((uint8_t)BAM_NT16[i >> 4]
                         | ((uint8_t)BAM_NT16[i & 0xF] << 8));

  int64_t n = 0;
  int64_t mx = 0;
  size_t pos = 0;
  while (pos + 4 <= len) {
    uint32_t block_size;
    memcpy(&block_size, data + pos, 4);
    if (block_size < 32 || pos + 4 + (size_t)block_size > len) break;
    const uint8_t* b = data + pos + 4;
    pos += 4 + block_size;

    int32_t ref_id;
    memcpy(&ref_id, b, 4);
    uint32_t l_read_name = b[8];
    uint16_t n_cigar_op, flag;
    memcpy(&n_cigar_op, b + 12, 2);
    memcpy(&flag, b + 14, 2);
    int32_t l_seq;
    memcpy(&l_seq, b + 16, 4);
    if (l_seq < 0) return -1;
    size_t off = 32 + l_read_name + 4 * (size_t)n_cigar_op;
    if (off + ((size_t)l_seq + 1) / 2 > block_size) return -1;

    if (flag & (0x100 | 0x800)) continue;
    if (require_flags && (flag & require_flags) != require_flags) continue;
    if (exclude_flags && (flag & exclude_flags)) continue;
    if (excluded_mask && ref_id >= 0 && ref_id < n_refs &&
        excluded_mask[ref_id]) continue;

    if (batch) {
      if (n >= rows || (int64_t)l_seq > L) return -1;
      uint8_t* row = batch + n * L;
      const uint8_t* packed = b + off;
      // decode forward two bases per packed byte
      int32_t half = l_seq >> 1;
      for (int32_t j = 0; j < half; j++)
        memcpy(row + 2 * j, &pair[packed[j]], 2);
      if (l_seq & 1) row[l_seq - 1] = (uint8_t)BAM_NT16[packed[half] >> 4];
      if (flag & 0x10) {
        // reverse-complement back, in place
        for (int32_t i = 0, j = l_seq - 1; i < j; i++, j--) {
          uint8_t a = row[i];
          row[i] = comp[row[j]];
          row[j] = comp[a];
        }
        if (l_seq & 1) row[l_seq >> 1] = comp[row[l_seq >> 1]];
      }
    }
    if (lengths) lengths[n] = l_seq;
    if (l_seq > mx) mx = l_seq;
    n++;
  }
  if (max_len) *max_len = mx;
  if (consumed) *consumed = (int64_t)pos;
  return n;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Fused 2-bit pack + transpose for the streaming engine's chunk uploads
// (the reference packs per-superkmer on its count path, superk.hpp; here
// whole read chunks pack into the TRANSPOSED (L/4, B) device layout the
// chunk step consumes). One pass over the ASCII batch replaces numpy's
// code/valid/pack/transpose passes (~530 ms -> ~60 ms per 64 MB chunk on
// the bench host, scripts/profile_link.py follow-ups). Codes follow the
// numpy path exactly: (c >> 1) & 3 for EVERY byte ('N' packs as 3 and is
// masked on device); valid_cnt[i] counts ACGT/acgt bytes of the whole
// row — equal to lengths[i] iff the row is clean ('N' padding past the
// length contributes nothing).
//
// Caller threads over disjoint [row_lo, row_hi) ranges (ctypes releases
// the GIL). Row tiles of 128 transpose through an L2-resident scratch so
// the (L/4, B) column writes stay sequential per output row.
int64_t km_pack2bit_t(const uint8_t* batch, int64_t B, int64_t L,
                      uint8_t* out, int32_t* valid_cnt,
                      int64_t row_lo, int64_t row_hi) {
  if (L % 4 != 0 || row_lo < 0 || row_hi > B || row_lo > row_hi) return -1;
  const int64_t P = L / 4;
  static uint8_t code[256], isv[256];
  static bool init = false;
  if (!init) {   // idempotent: concurrent writers store identical bytes
    for (int c = 0; c < 256; c++) {
      code[c] = (uint8_t)((c >> 1) & 3);
      isv[c] = (c == 'A' || c == 'C' || c == 'G' || c == 'T' ||
                c == 'a' || c == 'c' || c == 'g' || c == 't');
    }
    init = true;
  }
  const int64_t T = 128;
  uint8_t* tmp = (uint8_t*)malloc((size_t)(P * T));
  if (!tmp) return -2;
  for (int64_t r0 = row_lo; r0 < row_hi; r0 += T) {
    const int64_t tn = (row_hi - r0 < T) ? (row_hi - r0) : T;
    for (int64_t i = 0; i < tn; i++) {
      const uint8_t* src = batch + (r0 + i) * L;
      int32_t cnt = 0;
      for (int64_t p = 0; p < P; p++) {
        const uint8_t a = src[4 * p], b = src[4 * p + 1];
        const uint8_t c = src[4 * p + 2], d = src[4 * p + 3];
        tmp[p * T + i] = (uint8_t)(code[a] | (code[b] << 2) |
                                   (code[c] << 4) | (code[d] << 6));
        cnt += isv[a] + isv[b] + isv[c] + isv[d];
      }
      valid_cnt[r0 + i] = cnt;
    }
    for (int64_t p = 0; p < P; p++)
      memcpy(out + p * B + r0, tmp + p * T, (size_t)tn);
  }
  free(tmp);
  return row_hi - row_lo;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Fused presence-bit pack + dense-row scatter for write_as_bf windows
// (merge.hpp:575-600 semantics: row index == hash - lower; absent rows
// stay zero). One pass replaces numpy's packbits + fancy-index row
// scatter (~330 ms -> ~90 ms for a 16.7M x 50 window on the bench
// host); the caller threads over disjoint [lo, hi) slices of the
// sorted unique hash list (target rows are disjoint, ctypes releases
// the GIL).
int64_t km_bf_fill(const uint8_t* counts, const int64_t* hashes,
                   int64_t n, int64_t nsamp, uint8_t* rows, int64_t nb,
                   int64_t lo, int64_t hi) {
  if (lo < 0 || hi > n || lo > hi || nb * 8 < nsamp) return -1;
  for (int64_t i = lo; i < hi; i++) {
    const uint8_t* c = counts + i * nsamp;
    uint8_t* dst = rows + hashes[i] * nb;
    int64_t s = 0;
    for (int64_t b = 0; b < nb; b++) {
      uint8_t v = 0;
      const int64_t lim = (nsamp - s < 8) ? (nsamp - s) : 8;
      for (int64_t j = 0; j < lim; j++)
        v |= (uint8_t)((c[s + j] != 0) << j);
      dst[b] = v;
      s += 8;
    }
  }
  return hi - lo;
}

}  // extern "C"
