// Streaming BAM -> packed-column decoder of the port's host layer.
//
// The port's copy of the JAX package's bamdecode.cpp: it emits the same
// fixed-width struct-of-arrays columns (the ReadFrame schema of
// sctools_tpu_torch/io/packed.py), with strings dictionary-encoded against
// lexicographically sorted per-batch vocabularies, so the arrays can be
// handed to torch unchanged.
//
// The decoder is a bounded-memory STREAM: the file is read in fixed-size
// compressed chunks, BGZF blocks inflate on a thread pool (blocks are
// independent raw-deflate streams; one reusable zlib inflater per worker
// thread), and each scx_stream_next(max_records) call parses at most
// max_records alignments. An uncompressed "BAM\1" stream (the fused tag
// sort's pipe) is read as it is.
//
// Hot-path design:
//   * every column is preallocated per batch and written by index; worker
//     threads own disjoint contiguous record ranges, so there is no
//     per-record push_back, no locking, and no post-parse concatenation;
//   * cell/molecule barcodes are packed to uint64 (3 bits/base, A=1 C=2 G=3
//     N=4 T=5, left-aligned) whose integer order equals byte-lexicographic
//     string order, so dictionary codes come from a run-compressed
//     sort-unique over ints (strings that don't pack, e.g. non-ACGTN,
//     divert to a slow path that reproduces numpy's np.unique semantics);
//   * gene names and query names keep per-thread interning with a last-key
//     memo, merged and remapped once per batch.
//
// Left out of the JAX copy: its per-stage timers. In their place a stream
// keeps three clocks, read per compressed chunk and per batch, never per
// record: the file reads, the block-parallel inflate and the rest of each
// batch (scx_stream_timers).
//
// Exposed through a minimal C API consumed by ctypes
// (sctools_tpu_torch/native/__init__.py); no Python.h dependency.

#include <sys/mman.h>

#include <algorithm>
#include <cstdlib>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include "native_io.h"

namespace {

constexpr size_t kCompChunk = 16u << 20;  // compressed bytes per file read
constexpr uint64_t kIrregular = ~0ull;    // packed sentinel: see overflow

// ----------------------------------------------------------------- columns

struct Columns {
  std::vector<int32_t> cell, umi, gene, qname, ref, pos, nh;
  std::vector<int8_t> strand, xf, perfect_umi, perfect_cb;
  std::vector<uint8_t> unmapped, duplicate, spliced;
  std::vector<uint16_t> umi_qual, cb_qual;     // above30<<8 | len, 0=missing
  std::vector<uint32_t> genomic_qual;          // above30<<16 | aligned len
  std::vector<uint32_t> genomic_total;         // sum of aligned phreds

  size_t size() const { return cell.size(); }

  void resize(size_t n) {
    cell.resize(n); umi.resize(n); gene.resize(n); qname.resize(n);
    ref.resize(n); pos.resize(n); nh.resize(n);
    strand.resize(n); xf.resize(n); perfect_umi.resize(n);
    perfect_cb.resize(n);
    unmapped.resize(n); duplicate.resize(n); spliced.resize(n);
    umi_qual.resize(n); cb_qual.resize(n);
    genomic_qual.resize(n); genomic_total.resize(n);
  }

  void clear() { resize(0); }
};

// --------------------------------------------------------- barcode packing

// 3-bit code per base, ascending in ASCII order so packed-integer order ==
// byte-lexicographic string order for ACGTN strings; 0 doubles as both the
// end-of-string padding and the empty (missing-tag) barcode, which therefore
// sorts first, matching the reference's empty-string sort default
// (src/sctools/bam.py:660).
constexpr int8_t kBaseCode[256] = {
    // 'A'=65 -> 1, 'C'=67 -> 2, 'G'=71 -> 3, 'N'=78 -> 4, 'T'=84 -> 5
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 4, 0,
    0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
};
constexpr char kBaseLetter[6] = {'\0', 'A', 'C', 'G', 'N', 'T'};
constexpr size_t kMaxPackedLen = 21;  // 21 bases x 3 bits = 63 bits

// returns false when the string cannot pack (too long / non-ACGTN)
inline bool pack_barcode(const char* s, size_t len, uint64_t& out) {
  if (len > kMaxPackedLen) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < len; ++i) {
    uint64_t code = static_cast<uint64_t>(
        kBaseCode[static_cast<uint8_t>(s[i])]);
    if (code == 0) return false;
    v |= code << (60 - 3 * i);
  }
  out = v;
  return true;
}

std::string unpack_barcode(uint64_t v) {
  std::string s;
  for (int shift = 60; shift >= 0; shift -= 3) {
    unsigned code = (v >> shift) & 7u;
    if (code == 0) break;
    s += kBaseLetter[code];
  }
  return s;
}

// ------------------------------------------------------- string interning

// thread-local string interner: local code = insertion order. Sorted BAMs
// repeat the same GE across consecutive records, so a one-entry memo of the
// last key skips the string allocation + hash on the common path.
struct LocalVocab {
  std::unordered_map<std::string, int32_t> map;
  std::vector<const std::string*> order;  // local code -> key
  const std::string* last_key = nullptr;
  int32_t last_code = -1;

  int32_t code(const char* data, size_t len) {
    // len == 0 short-circuits before memcmp: a missing tag passes data ==
    // nullptr, and memcmp's arguments are declared nonnull even for n == 0
    if (last_key && last_key->size() == len &&
        (len == 0 || std::memcmp(last_key->data(), data, len) == 0))
      return last_code;
    auto [it, inserted] = map.try_emplace(
        len ? std::string(data, len) : std::string(),
        static_cast<int32_t>(map.size()));
    if (inserted) order.push_back(&it->first);
    last_key = &it->first;
    last_code = it->second;
    return it->second;
  }
};

struct CodeRange {
  int32_t* data;
  size_t len;
};

// merge thread-local vocabularies into one sorted vocabulary and remap each
// thread's code range in place
void merge_vocabs(std::vector<LocalVocab>& locals,
                  std::vector<CodeRange> code_ranges,
                  std::vector<std::string>& out_sorted) {
  out_sorted.clear();
  for (const LocalVocab& local : locals)
    for (const std::string* s : local.order) out_sorted.push_back(*s);
  std::sort(out_sorted.begin(), out_sorted.end());
  out_sorted.erase(std::unique(out_sorted.begin(), out_sorted.end()),
                   out_sorted.end());
  std::unordered_map<std::string_view, int32_t> rank;
  rank.reserve(out_sorted.size() * 2);
  for (size_t i = 0; i < out_sorted.size(); ++i)
    rank.emplace(out_sorted[i], static_cast<int32_t>(i));
  for (size_t t = 0; t < locals.size(); ++t) {
    std::vector<int32_t> remap(locals[t].order.size());
    for (size_t i = 0; i < locals[t].order.size(); ++i)
      remap[i] = rank.at(*locals[t].order[i]);
    int32_t* codes = code_ranges[t].data;
    for (size_t i = 0; i < code_ranges[t].len; ++i) codes[i] = remap[codes[i]];
  }
}

struct Batch {
  Columns cols;
  std::vector<std::string> cell_vocab, umi_vocab, gene_vocab, qname_vocab;
  struct Flat {
    std::string bytes;
    std::vector<int64_t> offsets;
    bool built = false;
  };
  Flat flat[4];

  void clear() {
    cols.clear();
    cell_vocab.clear(); umi_vocab.clear();
    gene_vocab.clear(); qname_vocab.clear();
    for (Flat& f : flat) { f.bytes.clear(); f.offsets.clear(); f.built = false; }
  }
};

// ------------------------------------------------------- code assignment

// sorted-BAM-friendly dictionary coding: unique candidates come from value
// runs (consecutive records usually share CB/UB), so the sort operates on
// run heads, not records; codes fill per run. Ascending uint64 order ==
// string order, so the resulting codes match np.unique(strings) exactly.
void codes_from_packed(const std::vector<uint64_t>& packed,
                       int32_t* codes,
                       std::vector<uint64_t>& uniq) {
  size_t n = packed.size();
  uniq.clear();
  for (size_t i = 0; i < n; ++i)
    if (i == 0 || packed[i] != packed[i - 1]) uniq.push_back(packed[i]);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  size_t i = 0;
  while (i < n) {
    size_t j = i + 1;
    while (j < n && packed[j] == packed[i]) ++j;
    int32_t code = static_cast<int32_t>(
        std::lower_bound(uniq.begin(), uniq.end(), packed[i]) - uniq.begin());
    for (size_t k = i; k < j; ++k) codes[k] = code;
    i = j;
  }
}

// slow path: some values could not pack (non-ACGTN / >21bp). Reconstructs
// every value as a string (overflow entries carry the original bytes) and
// reproduces np.unique semantics with a hash map — only exercised by
// pathological barcodes, never by real 10x data.
void codes_from_strings(const std::vector<uint64_t>& packed,
                        const std::vector<std::pair<size_t, std::string>>& overflow,
                        int32_t* codes,
                        std::vector<std::string>& vocab) {
  size_t n = packed.size();
  std::unordered_map<size_t, const std::string*> irregular;
  irregular.reserve(overflow.size() * 2);
  for (const auto& [idx, s] : overflow) irregular.emplace(idx, &s);
  std::vector<std::string> values(n);
  for (size_t i = 0; i < n; ++i) {
    if (packed[i] == kIrregular)
      values[i] = *irregular.at(i);
    else
      values[i] = unpack_barcode(packed[i]);
  }
  vocab.assign(values.begin(), values.end());
  std::sort(vocab.begin(), vocab.end());
  vocab.erase(std::unique(vocab.begin(), vocab.end()), vocab.end());
  std::unordered_map<std::string_view, int32_t> rank;
  rank.reserve(vocab.size() * 2);
  for (size_t i = 0; i < vocab.size(); ++i)
    rank.emplace(vocab[i], static_cast<int32_t>(i));
  for (size_t i = 0; i < n; ++i) codes[i] = rank.at(values[i]);
}

// ----------------------------------------------------------------- BGZF

// mmap-backed byte buffer: no zero-initialization on growth, a large
// geometric floor, and transparent hugepages, because std::vector's
// value-initializing resize, repeated realloc-copies, and 4KB first-touch
// faults measurably dominated inflate itself (~2x the decompression cost)
// while a batch's inflated bytes ramped up to steady state.
struct ByteBuf {
  uint8_t* data = nullptr;
  size_t size = 0, cap = 0;

  ~ByteBuf() { if (data) munmap(data, cap); }
  ByteBuf() = default;
  ByteBuf(const ByteBuf&) = delete;
  ByteBuf& operator=(const ByteBuf&) = delete;

  bool reserve(size_t want) {
    if (want <= cap) return true;
    size_t newcap = cap ? cap * 2 : (64u << 20);
    while (newcap < want) newcap *= 2;
    void* p = mmap(nullptr, newcap, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return false;
#ifdef MADV_HUGEPAGE
    madvise(p, newcap, MADV_HUGEPAGE);
#endif
    if (size) std::memcpy(p, data, size);
    if (data) munmap(data, cap);
    data = static_cast<uint8_t*>(p);
    cap = newcap;
    return true;
  }

  // append n uninitialized bytes; returns the write pointer or null on OOM
  uint8_t* grow(size_t n) {
    if (!reserve(size + n)) return nullptr;
    uint8_t* p = data + size;
    size += n;
    return p;
  }

  void consume_prefix(size_t n) {
    if (!n) return;
    std::memmove(data, data + n, size - n);
    size -= n;
  }
};

struct BlockInfo {
  size_t src_offset;    // offset of the deflate payload within comp buffer
  uint32_t payload_len; // compressed payload length
  uint32_t isize;       // uncompressed size
  size_t out_offset;    // prefix-summed offset within the new inflated bytes
};

// ----------------------------------------------------------------- stream

struct Stream {
  FILE* f = nullptr;
  bool plain = false;       // uncompressed "BAM\1" input (no BGZF container)
  bool format_known = false;
  int n_threads = 1;
  bool want_qname = true;
  bool file_eof = false;
  std::string error;

  ByteBuf comp;  // compressed bytes not yet inflated
  size_t comp_pos = 0;
  ByteBuf bam;   // inflated bytes not yet parsed
  size_t bam_pos = 0;
  bool header_done = false;

  Batch batch;

  // nanoseconds on the decoding thread: the compressed chunks' file reads,
  // the block-parallel inflate (indexing, thread spawn and join included),
  // and the rest of scx_stream_next (the record scan, the parallel parse and
  // the vocabulary merge)
  int64_t read_ns = 0, inflate_ns = 0, parse_ns = 0;

  // per-batch scratch, reused across batches to avoid reallocation
  std::vector<uint64_t> cell_packed, umi_packed;
  std::vector<uint64_t> uniq_scratch;

  ~Stream() { if (f) std::fclose(f); }
};

// Pull one compressed chunk from the file and inflate every complete BGZF
// block in the buffer. Consumed prefixes of both buffers are compacted first,
// so relative offsets from {comp,bam}_pos stay valid across calls. Returns
// false when no new inflated bytes could be produced (EOF or error).
bool refill(Stream& s) {
  if (s.error.size()) return false;
  // compact
  if (s.bam_pos) {
    s.bam.consume_prefix(s.bam_pos);
    s.bam_pos = 0;
  }
  if (s.comp_pos) {
    s.comp.consume_prefix(s.comp_pos);
    s.comp_pos = 0;
  }

  size_t produced = 0;
  while (produced == 0) {
    if (!s.file_eof) {
      uint8_t* w = s.comp.grow(kCompChunk);
      if (!w) {
        s.error = "out of memory";
        return false;
      }
      int64_t start = scx::now_ns();
      size_t got = std::fread(w, 1, kCompChunk, s.f);
      s.read_ns += scx::now_ns() - start;
      s.comp.size -= kCompChunk - got;
      if (got < kCompChunk) s.file_eof = true;
    }
    if (s.comp.size == 0) return false;

    if (!s.format_known) {
      // fread returns short only at EOF, so comp holds >= 4 bytes here
      // unless the whole file is shorter than that (which cannot be a BAM)
      if (s.comp.size >= 4 && std::memcmp(s.comp.data, "BAM\1", 4) == 0)
        s.plain = true;
      else if (s.comp.size >= 2 && s.comp.data[0] == 0x1f &&
               s.comp.data[1] == 0x8b)
        s.plain = false;
      else {
        s.error = "not a BAM stream (bad magic)";
        return false;
      }
      s.format_known = true;
    }

    if (s.plain) {
      uint8_t* w = s.bam.grow(s.comp.size);
      if (!w) {
        s.error = "out of memory";
        return false;
      }
      std::memcpy(w, s.comp.data, s.comp.size);
      s.comp.size = 0;
      return s.bam.size != 0;
    }

    // index complete BGZF blocks in comp, then inflate them
    int64_t inflate_start = scx::now_ns();
    std::vector<BlockInfo> blocks;
    size_t offset = 0;
    size_t total_out = 0;
    while (offset + 18 <= s.comp.size) {
      const uint8_t* p = s.comp.data + offset;
      if (p[0] != 0x1f || p[1] != 0x8b) {
        s.error = "malformed BGZF container";
        return false;
      }
      uint16_t xlen = p[10] | (p[11] << 8);
      size_t extra = offset + 12;
      size_t extra_end = extra + xlen;
      if (extra_end > s.comp.size) break;  // header spans chunk boundary
      uint32_t bsize = 0;
      while (extra + 4 <= extra_end) {
        uint8_t si1 = s.comp.data[extra], si2 = s.comp.data[extra + 1];
        uint16_t slen = s.comp.data[extra + 2] | (s.comp.data[extra + 3] << 8);
        if (si1 == 'B' && si2 == 'C' && slen == 2 && extra + 6 <= extra_end)
          bsize = (s.comp.data[extra + 4] | (s.comp.data[extra + 5] << 8)) + 1;
        extra += 4 + slen;
      }
      if (bsize < 12u + xlen + 8u) {
        s.error = "malformed BGZF container";
        return false;
      }
      if (offset + bsize > s.comp.size) break;  // incomplete block
      uint32_t payload_len = bsize - 12 - xlen - 8;
      uint32_t isize = s.comp.data[offset + bsize - 4] |
                       (s.comp.data[offset + bsize - 3] << 8) |
                       (s.comp.data[offset + bsize - 2] << 16) |
                       (s.comp.data[offset + bsize - 1] << 24);
      if (isize > 0) {
        blocks.push_back({offset + 12 + xlen, payload_len, isize, total_out});
        total_out += isize;
      }
      offset += bsize;
    }
    if (offset == 0 && s.file_eof) {
      // leftover bytes that can never form a block
      if (s.comp.size) s.error = "truncated BGZF block at EOF";
      s.inflate_ns += scx::now_ns() - inflate_start;
      return false;
    }

    if (total_out) {
      size_t base = s.bam.size;
      if (!s.bam.grow(total_out)) {
        s.error = "out of memory";
        return false;
      }
      std::atomic<bool> ok{true};
      auto inflate_range = [&](size_t lo, size_t hi) {
        scx::RawInflater inflater;
        for (size_t i = lo; i < hi && ok.load(std::memory_order_relaxed); ++i) {
          const BlockInfo& b = blocks[i];
          if (!inflater.inflate_block(s.comp.data + b.src_offset,
                                      b.payload_len,
                                      s.bam.data + base + b.out_offset,
                                      b.isize))
            ok.store(false);
        }
      };
      int workers = std::min<int>(std::max(s.n_threads, 1),
                                  static_cast<int>(blocks.size()));
      if (workers <= 1) {
        inflate_range(0, blocks.size());
      } else {
        size_t per = (blocks.size() + workers - 1) / workers;
        std::vector<std::thread> pool;
        for (int t = 0; t < workers; ++t) {
          size_t lo = std::min(blocks.size(), t * per);
          size_t hi = std::min(blocks.size(), lo + per);
          pool.emplace_back(inflate_range, lo, hi);
        }
        for (auto& t : pool) t.join();
      }
      s.inflate_ns += scx::now_ns() - inflate_start;
      if (!ok.load()) {
        s.error = "BGZF block failed to inflate";
        return false;
      }
      produced += total_out;
    } else {
      s.inflate_ns += scx::now_ns() - inflate_start;
    }
    s.comp.consume_prefix(offset);
    if (s.file_eof && produced == 0) return false;
  }
  return true;
}

// ensure at least `need` unparsed inflated bytes are available
bool ensure(Stream& s, size_t need) {
  while (s.bam.size - s.bam_pos < need)
    if (!refill(s)) return false;
  return true;
}

inline uint32_t read_u32(const uint8_t* q) {
  return q[0] | (q[1] << 8) | (q[2] << 16) | (uint32_t(q[3]) << 24);
}

// skip the BAM header (text + reference list); ref ids stay numeric in the
// frame schema so reference names are not retained
bool read_header(Stream& s) {
  if (!ensure(s, 12)) {
    if (s.error.empty()) s.error = "truncated header";
    return false;
  }
  if (std::memcmp(s.bam.data + s.bam_pos, "BAM\1", 4) != 0) {
    s.error = "not a BAM stream (bad magic)";
    return false;
  }
  uint64_t l_text = read_u32(s.bam.data + s.bam_pos + 4);
  if (!ensure(s, 12 + l_text)) {
    if (s.error.empty()) s.error = "truncated header";
    return false;
  }
  uint64_t cursor = 8 + l_text;  // relative to bam_pos
  uint32_t n_ref = read_u32(s.bam.data + s.bam_pos + cursor);
  cursor += 4;
  for (uint32_t i = 0; i < n_ref; ++i) {
    if (!ensure(s, cursor + 4)) {
      if (s.error.empty()) s.error = "truncated reference list";
      return false;
    }
    uint64_t l_name = read_u32(s.bam.data + s.bam_pos + cursor);
    if (!ensure(s, cursor + 8 + l_name)) {
      if (s.error.empty()) s.error = "truncated reference list";
      return false;
    }
    cursor += 8 + l_name;  // l_name field + name + l_ref
  }
  s.bam_pos += cursor;
  s.header_done = true;
  return true;
}

// --------------------------------------------------------------- BAM parse

// above30<<8 | len for a string-encoded quality tag; 0 means missing.
// Lengths above 255 degrade to missing (no real barcode approaches that).
inline uint16_t pack_string_qual(const char* qual, size_t len) {
  if (len == 0 || len > 0xFF) return 0;
  uint32_t above = 0;
  for (size_t i = 0; i < len; ++i)
    above += static_cast<uint8_t>(qual[i]) > 63;  // q - 33 > 30
  return static_cast<uint16_t>((above << 8) | len);
}

struct TagView {
  const char* cb = nullptr; size_t cb_len = 0; bool has_cb = false;
  const char* cr = nullptr; size_t cr_len = 0;
  const char* cy = nullptr; size_t cy_len = 0;
  const char* ub = nullptr; size_t ub_len = 0; bool has_ub = false;
  const char* ur = nullptr; size_t ur_len = 0;
  const char* uy = nullptr; size_t uy_len = 0;
  const char* ge = nullptr; size_t ge_len = 0;
  const char* xf = nullptr; size_t xf_len = 0; bool has_xf = false;
  int32_t nh = -1;
};

// walk the BAM aux-tag region
bool parse_tags(const uint8_t* p, const uint8_t* end, TagView& tags) {
  while (p + 3 <= end) {
    char t0 = static_cast<char>(p[0]);
    char t1 = static_cast<char>(p[1]);
    char type = static_cast<char>(p[2]);
    p += 3;
    size_t size = 0;
    const char* str = nullptr;
    size_t str_len = 0;
    int64_t int_value = 0;
    switch (type) {
      case 'A': case 'c': case 'C': size = 1;
        int_value = (type == 'c') ? *reinterpret_cast<const int8_t*>(p) : p[0];
        break;
      case 's': size = 2;
        int_value = static_cast<int16_t>(p[0] | (p[1] << 8));
        break;
      case 'S': size = 2;
        int_value = static_cast<uint16_t>(p[0] | (p[1] << 8));
        break;
      case 'i': case 'I': case 'f': size = 4;
        if (type != 'f')
          int_value = static_cast<int32_t>(p[0] | (p[1] << 8) | (p[2] << 16) |
                                           (p[3] << 24));
        break;
      case 'Z': case 'H': {
        const uint8_t* z = p;
        while (z < end && *z) ++z;
        if (z >= end) return false;
        str = reinterpret_cast<const char*>(p);
        str_len = static_cast<size_t>(z - p);
        size = str_len + 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) return false;
        char sub = static_cast<char>(p[0]);
        uint32_t n = p[1] | (p[2] << 8) | (p[3] << 16) | (p[4] << 24);
        size_t elem = (sub == 'c' || sub == 'C') ? 1
                      : (sub == 's' || sub == 'S') ? 2 : 4;
        size = 5 + static_cast<size_t>(n) * elem;
        break;
      }
      default:
        return false;
    }
    if (p + size > end) return false;

    if (t0 == 'C' && t1 == 'B' && type == 'Z') { tags.cb = str; tags.cb_len = str_len; tags.has_cb = true; }
    else if (t0 == 'C' && t1 == 'R' && type == 'Z') { tags.cr = str; tags.cr_len = str_len; }
    else if (t0 == 'C' && t1 == 'Y' && type == 'Z') { tags.cy = str; tags.cy_len = str_len; }
    else if (t0 == 'U' && t1 == 'B' && type == 'Z') { tags.ub = str; tags.ub_len = str_len; tags.has_ub = true; }
    else if (t0 == 'U' && t1 == 'R' && type == 'Z') { tags.ur = str; tags.ur_len = str_len; }
    else if (t0 == 'U' && t1 == 'Y' && type == 'Z') { tags.uy = str; tags.uy_len = str_len; }
    else if (t0 == 'G' && t1 == 'E' && type == 'Z') { tags.ge = str; tags.ge_len = str_len; }
    else if (t0 == 'X' && t1 == 'F' && type == 'Z') { tags.xf = str; tags.xf_len = str_len; tags.has_xf = true; }
    else if (t0 == 'N' && t1 == 'H' && (type == 'c' || type == 'C' || type == 's' ||
                                        type == 'S' || type == 'i' || type == 'I'))
      tags.nh = static_cast<int32_t>(int_value);

    p += size;
  }
  return true;
}

// XF codes must match sctools_tpu_torch/consts.py (XF_MISSING..XF_OTHER)
int8_t xf_code(const TagView& tags) {
  if (!tags.has_xf) return 0;
  std::string_view v(tags.xf, tags.xf_len);
  if (v == "CODING") return 1;
  if (v == "INTRONIC") return 2;
  if (v == "UTR") return 3;
  if (v == "INTERGENIC") return 4;
  return 5;
}

struct ThreadState {
  LocalVocab gene, qname;
  std::vector<std::pair<size_t, std::string>> cell_overflow, umi_overflow;
  std::string error;
};

// parse one alignment record (block_size bytes at rec) into row i of the
// preallocated batch columns
bool parse_record(const uint8_t* rec, uint32_t block_size, size_t i,
                  bool want_qname, Columns& c,
                  uint64_t* cell_packed, uint64_t* umi_packed,
                  ThreadState& t) {
  int32_t ref_id = static_cast<int32_t>(read_u32(rec));
  int32_t pos = static_cast<int32_t>(read_u32(rec + 4));
  uint8_t l_read_name = rec[8];
  uint16_t n_cigar = rec[12] | (rec[13] << 8);
  uint16_t flag = rec[14] | (rec[15] << 8);
  uint32_t l_seq = read_u32(rec + 16);

  // validate field extents in 64-bit before forming any pointer: a corrupt
  // l_seq near UINT32_MAX would otherwise wrap (l_seq+1)/2 and overflow the
  // qual pointer arithmetic (UB) before a downstream check could reject it
  uint64_t need = 32ull + l_read_name + 4ull * n_cigar +
                  (static_cast<uint64_t>(l_seq) + 1) / 2 + l_seq;
  if (need > block_size) {
    t.error = "record fields overflow block";
    return false;
  }

  const char* read_name = reinterpret_cast<const char*>(rec + 32);
  size_t name_len = l_read_name ? l_read_name - 1 : 0;
  const uint8_t* cigar = rec + 32 + l_read_name;
  const uint8_t* seq = cigar + 4 * n_cigar;
  const uint8_t* qual = seq + (l_seq + 1) / 2;
  const uint8_t* tags_start = qual + l_seq;

  bool unmapped = flag & 0x4;
  bool reverse = flag & 0x10;
  bool duplicate = flag & 0x400;

  // cigar walk: spliced (N op), soft-clip bounds (H ignored, leading and
  // trailing S excluded) — matches BamRecord._clip_bounds. Clamped so a
  // corrupt trailing soft-clip longer than l_seq cannot underflow clip_end
  // into an out-of-bounds quality scan.
  bool spliced = false;
  uint32_t clip_start = 0, clip_end = l_seq;
  int first_non_h = -1, last_non_h = -1;
  for (uint16_t k = 0; k < n_cigar; ++k) {
    uint32_t entry = read_u32(cigar + 4 * k);
    uint32_t op = entry & 0xf;
    if (op == 3) spliced = true;          // N
    if (op != 5) {                        // not H
      if (first_non_h < 0) first_non_h = k;
      last_non_h = k;
    }
  }
  if (first_non_h >= 0) {
    uint32_t first_entry = read_u32(cigar + 4 * first_non_h);
    uint32_t last_entry = read_u32(cigar + 4 * last_non_h);
    if ((first_entry & 0xf) == 4)
      clip_start = std::min(first_entry >> 4, l_seq);  // S
    if (last_non_h != first_non_h && (last_entry & 0xf) == 4)
      clip_end = (last_entry >> 4) > l_seq ? 0 : l_seq - (last_entry >> 4);
  }

  TagView tags;
  if (!parse_tags(tags_start, rec + block_size, tags)) {
    t.error = "malformed aux tags";
    return false;
  }

  c.qname[i] = want_qname ? t.qname.code(read_name, name_len) : 0;

  size_t cb_len = tags.has_cb ? tags.cb_len : 0;
  if (!pack_barcode(tags.cb, cb_len, cell_packed[i])) {
    cell_packed[i] = kIrregular;
    t.cell_overflow.emplace_back(i, std::string(tags.cb, cb_len));
  }
  size_t ub_len = tags.has_ub ? tags.ub_len : 0;
  if (!pack_barcode(tags.ub, ub_len, umi_packed[i])) {
    umi_packed[i] = kIrregular;
    t.umi_overflow.emplace_back(i, std::string(tags.ub, ub_len));
  }
  c.gene[i] = t.gene.code(tags.ge, tags.ge ? tags.ge_len : 0);

  c.ref[i] = ref_id;
  c.pos[i] = pos;
  c.strand[i] = reverse ? 1 : 0;
  c.unmapped[i] = unmapped ? 1 : 0;
  c.duplicate[i] = duplicate ? 1 : 0;
  c.spliced[i] = spliced ? 1 : 0;
  c.xf[i] = xf_code(tags);
  c.nh[i] = tags.nh;

  int8_t perfect_umi = -1;
  if (tags.ur && tags.has_ub)
    perfect_umi = (tags.ur_len == tags.ub_len &&
                   std::memcmp(tags.ur, tags.ub, tags.ub_len) == 0) ? 1 : 0;
  c.perfect_umi[i] = perfect_umi;
  int8_t perfect_cb = -1;
  if (tags.has_cb && tags.cr)
    perfect_cb = (tags.cr_len == tags.cb_len &&
                  std::memcmp(tags.cr, tags.cb, tags.cb_len) == 0) ? 1 : 0;
  c.perfect_cb[i] = perfect_cb;

  c.umi_qual[i] = tags.uy ? pack_string_qual(tags.uy, tags.uy_len) : 0;
  c.cb_qual[i] = tags.cy ? pack_string_qual(tags.cy, tags.cy_len) : 0;

  // aligned-portion qualities; an all-0xFF fill means "absent" in BAM
  // (BamRecord.from_bytes sets quality=None only when every byte is 0xFF)
  bool has_qual = false;
  for (uint32_t k = 0; k < l_seq; ++k) {
    if (qual[k] != 0xff) { has_qual = true; break; }
  }
  uint32_t n_aligned = clip_end > clip_start ? clip_end - clip_start : 0;
  if (has_qual && n_aligned > 0 && n_aligned <= 0xFFFF) {
    uint32_t above = 0;
    uint32_t total = 0;  // <= 255 * 65535 < 2^24
    for (uint32_t k = clip_start; k < clip_end; ++k) {
      uint8_t q = qual[k];
      above += q > 30;
      total += q;
    }
    c.genomic_qual[i] = (above << 16) | n_aligned;
    c.genomic_total[i] = total;
  } else {
    // absent qualities, or an aligned window beyond 65535 bases (outside
    // the short-read domain) degrade to "absent"
    c.genomic_qual[i] = 0;
    c.genomic_total[i] = 0;
  }
  return true;
}

// decode up to max_records alignments into s.batch; returns count, 0 at EOF,
// -1 on error
long decode_batch(Stream& s, long max_records) {
  if (s.error.size()) return -1;
  s.batch.clear();
  if (!s.header_done) {
    if (!ensure(s, 1)) {
      // completely empty input is an error; empty record section is EOF
      if (s.error.empty() && !s.format_known) s.error = "empty input";
      return s.error.empty() ? 0 : -1;
    }
    if (!read_header(s)) return -1;
  }

  // reserve the batch's likely footprint once: growth mid-batch would
  // realloc-copy hundreds of MB (measured ~2x the inflate cost)
  if (max_records > 0)
    s.bam.reserve(static_cast<size_t>(max_records) * 384);

  // collect record spans (relative to bam_pos; refill preserves them)
  struct Span { size_t offset; uint32_t size; };
  std::vector<Span> spans;
  size_t cursor = 0;  // relative to bam_pos
  while (max_records < 0 ||
         spans.size() < static_cast<size_t>(max_records)) {
    if (!ensure(s, cursor + 4)) {
      if (!s.error.empty()) return -1;
      if (s.bam.size - s.bam_pos != cursor) {
        s.error = "truncated record";
        return -1;
      }
      break;  // clean EOF at a record boundary
    }
    uint32_t block_size = read_u32(s.bam.data + s.bam_pos + cursor);
    if (block_size < 32) {
      s.error = "truncated record";
      return -1;
    }
    if (!ensure(s, cursor + 4 + block_size)) {
      s.error = s.error.empty() ? "truncated record" : s.error;
      return -1;
    }
    spans.push_back({cursor + 4, block_size});
    cursor += 4 + block_size;
  }
  if (spans.empty()) return 0;

  // parallel parse into preallocated columns: each worker owns a contiguous
  // record range, so every column write is by index and lock-free
  size_t n = spans.size();
  s.batch.cols.resize(n);
  s.cell_packed.resize(n);
  s.umi_packed.resize(n);
  int workers = std::min<int>(std::max(s.n_threads, 1), static_cast<int>(n));
  std::vector<ThreadState> states(workers);
  std::vector<size_t> bounds(workers + 1);
  size_t per = (n + workers - 1) / workers;
  for (int t = 0; t <= workers; ++t)
    bounds[t] = std::min(n, static_cast<size_t>(t) * per);
  const uint8_t* base = s.bam.data + s.bam_pos;
  auto work = [&](int t) {
    ThreadState& state = states[t];
    for (size_t i = bounds[t]; i < bounds[t + 1]; ++i) {
      if (!parse_record(base + spans[i].offset, spans[i].size, i,
                        s.want_qname, s.batch.cols,
                        s.cell_packed.data(), s.umi_packed.data(), state))
        return;
    }
  };
  if (workers == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
    for (auto& t : pool) t.join();
  }
  for (ThreadState& state : states) {
    if (!state.error.empty()) {
      s.error = state.error;
      return -1;
    }
  }

  // cell/umi codes from packed ints (fast path), or the string slow path
  // when any value failed to pack
  auto assign = [&](std::vector<uint64_t>& packed,
                    std::vector<std::pair<size_t, std::string>> ThreadState::*member,
                    std::vector<int32_t>& codes,
                    std::vector<std::string>& vocab) {
    std::vector<std::pair<size_t, std::string>> overflow;
    for (ThreadState& state : states) {
      auto& part = state.*member;
      overflow.insert(overflow.end(),
                      std::make_move_iterator(part.begin()),
                      std::make_move_iterator(part.end()));
      part.clear();
    }
    if (overflow.empty()) {
      codes_from_packed(packed, codes.data(), s.uniq_scratch);
      vocab.resize(s.uniq_scratch.size());
      for (size_t i = 0; i < s.uniq_scratch.size(); ++i)
        vocab[i] = unpack_barcode(s.uniq_scratch[i]);
    } else {
      codes_from_strings(packed, overflow, codes.data(), vocab);
    }
  };
  assign(s.cell_packed, &ThreadState::cell_overflow, s.batch.cols.cell,
         s.batch.cell_vocab);
  assign(s.umi_packed, &ThreadState::umi_overflow, s.batch.cols.umi,
         s.batch.umi_vocab);

  // gene/qname vocabularies: merge thread-local interners, remap each
  // thread's contiguous code range
  auto ranges_for = [&](std::vector<int32_t>& col) {
    std::vector<CodeRange> ranges;
    for (int t = 0; t < workers; ++t)
      ranges.push_back({col.data() + bounds[t], bounds[t + 1] - bounds[t]});
    return ranges;
  };
  {
    std::vector<LocalVocab> locals;
    locals.reserve(workers);
    for (ThreadState& state : states) locals.push_back(std::move(state.gene));
    merge_vocabs(locals, ranges_for(s.batch.cols.gene), s.batch.gene_vocab);
  }
  if (s.want_qname) {
    std::vector<LocalVocab> locals;
    locals.reserve(workers);
    for (ThreadState& state : states) locals.push_back(std::move(state.qname));
    merge_vocabs(locals, ranges_for(s.batch.cols.qname), s.batch.qname_vocab);
  } else {
    s.batch.qname_vocab.assign(1, std::string());
  }

  s.bam_pos += cursor;
  return static_cast<long>(n);
}

// decode_batch, its time outside the file reads and the inflate counted as
// the parse
long stream_next(Stream& s, long max_records) {
  int64_t start = scx::now_ns();
  int64_t io = s.read_ns + s.inflate_ns;
  long n = decode_batch(s, max_records);
  s.parse_ns += scx::now_ns() - start - (s.read_ns + s.inflate_ns - io);
  return n;
}

// ------------------------------------------------------- packed column arena
//
// Caller-owned contiguous staging buffer: one allocation holds every
// per-record column of a batch as adjacent struct-of-arrays sections, so the
// Python side views them with np.frombuffer (no copies, no per-record
// objects). The section order and widths are the ingest ABI:
// sctools_tpu_torch/ingest/arena.py ARENA_SPEC iterates the same list, and
// tests/test_torch_ingest.py holds the two sides (and the JAX package's
// arena) to the same bytes. Widths descend (4-byte lanes first) and the
// capacity must be a multiple of kArenaAlign, so every section offset stays
// 64-byte aligned for any capacity.
//
// Two fields are finished host-side because they need host-only knowledge:
// the ``flags`` word carries bits 0..11 (strand/unmapped/duplicate/spliced/
// xf/perfect_umi/perfect_cb/nh==1, the io/packed.py bit layout); FLAG_MITO
// and FLAG_RUN_START need the mito-gene set / run boundaries and are OR-ed
// in by the gatherer's padder. ``ps`` ships finished (pos << 1 | strand).

constexpr long kArenaAlign = 64;

struct ArenaLane {
  const char* name;
  int width;  // bytes per record
};

// the ingest ABI: order and widths mirrored by ingest/arena.py ARENA_SPEC
constexpr ArenaLane kArenaLanes[] = {
    {"cell", 4},         {"umi", 4},           {"gene", 4},
    {"qname", 4},        {"ref", 4},           {"pos", 4},
    {"nh", 4},           {"ps", 4},            {"genomic_qual", 4},
    {"genomic_total", 4},{"umi_qual", 2},      {"cb_qual", 2},
    {"flags", 2},        {"strand", 1},        {"xf", 1},
    {"perfect_umi", 1},  {"perfect_cb", 1},    {"unmapped", 1},
    {"duplicate", 1},    {"spliced", 1},
};

long arena_nbytes(long capacity) {
  if (capacity <= 0 || capacity % kArenaAlign != 0) return -1;
  long total = 0;
  for (const ArenaLane& lane : kArenaLanes) total += capacity * lane.width;
  return total;
}

long batch_fill_arena(Stream& s, uint8_t* arena, long capacity) {
  const Columns& c = s.batch.cols;
  long n = static_cast<long>(c.size());
  if (arena == nullptr || capacity < n || capacity % kArenaAlign != 0)
    return -1;
  uint8_t* cursor = arena;
  auto lane = [&](int width) {
    uint8_t* p = cursor;
    cursor += capacity * width;
    return p;
  };
  auto copy = [&](const void* src, int width) {
    std::memcpy(lane(width), src, static_cast<size_t>(n) * width);
  };
  copy(c.cell.data(), 4);
  copy(c.umi.data(), 4);
  copy(c.gene.data(), 4);
  copy(c.qname.data(), 4);
  copy(c.ref.data(), 4);
  copy(c.pos.data(), 4);
  copy(c.nh.data(), 4);
  // ps: the prepacked position-strand sort operand (io/packed.py key docs)
  int32_t* ps = reinterpret_cast<int32_t*>(lane(4));
  for (long i = 0; i < n; ++i)
    ps[i] = (c.pos[i] << 1) | static_cast<int32_t>(c.strand[i]);
  copy(c.genomic_qual.data(), 4);
  copy(c.genomic_total.data(), 4);
  copy(c.umi_qual.data(), 2);
  copy(c.cb_qual.data(), 2);
  // flags bits 0..11: io/packed.py pack_flags minus the host-only bits
  int16_t* flags = reinterpret_cast<int16_t*>(lane(2));
  for (long i = 0; i < n; ++i) {
    int32_t f = static_cast<int32_t>(c.strand[i]) & 1;
    f |= (static_cast<int32_t>(c.unmapped[i]) & 1) << 1;
    f |= (static_cast<int32_t>(c.duplicate[i]) & 1) << 2;
    f |= (static_cast<int32_t>(c.spliced[i]) & 1) << 3;
    f |= (static_cast<int32_t>(c.xf[i]) & 7) << 4;
    f |= ((static_cast<int32_t>(c.perfect_umi[i]) + 1) & 3) << 7;
    f |= ((static_cast<int32_t>(c.perfect_cb[i]) + 1) & 3) << 9;
    f |= (c.nh[i] == 1 ? 1 : 0) << 11;
    flags[i] = static_cast<int16_t>(f);
  }
  copy(c.strand.data(), 1);
  copy(c.xf.data(), 1);
  copy(c.perfect_umi.data(), 1);
  copy(c.perfect_cb.data(), 1);
  copy(c.unmapped.data(), 1);
  copy(c.duplicate.data(), 1);
  copy(c.spliced.data(), 1);
  return n;
}

Batch::Flat* flat_vocab(Stream* s, const char* name) {
  std::string_view n(name);
  std::vector<std::string>* vocab = nullptr;
  int slot = -1;
  if (n == "cell") { vocab = &s->batch.cell_vocab; slot = 0; }
  else if (n == "umi") { vocab = &s->batch.umi_vocab; slot = 1; }
  else if (n == "gene") { vocab = &s->batch.gene_vocab; slot = 2; }
  else if (n == "qname") { vocab = &s->batch.qname_vocab; slot = 3; }
  else return nullptr;
  Batch::Flat& flat = s->batch.flat[slot];
  if (!flat.built) {
    flat.offsets.push_back(0);
    for (const std::string& str : *vocab) {
      flat.bytes += str;
      flat.offsets.push_back(static_cast<int64_t>(flat.bytes.size()));
    }
    flat.built = true;
  }
  return &flat;
}

Stream* open_stream(const char* path, int n_threads, bool want_qname,
                    std::string& error) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    error = std::string("cannot open ") + path;
    return nullptr;
  }
  auto* s = new Stream();
  s->f = f;
  s->n_threads = n_threads < 1 ? 1 : n_threads;
  s->want_qname = want_qname;
  return s;
}

void set_errbuf(char* errbuf, int errbuf_len, const std::string& message) {
  if (errbuf && errbuf_len > 0)
    std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
}

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

// ---- streaming API ----

void* scx_stream_open(const char* path, int n_threads, int want_qname,
                      char* errbuf, int errbuf_len) {
  std::string error;
  Stream* s = open_stream(path, n_threads, want_qname != 0, error);
  if (!s) set_errbuf(errbuf, errbuf_len, error);
  return s;
}

long scx_stream_next(void* h, long max_records) {
  return stream_next(*static_cast<Stream*>(h), max_records);
}

// the stream's seconds so far, up to n values: [read, inflate, parse].
// Returns the number of values a stream has (3). Call it from the thread
// that decodes.
int scx_stream_timers(void* h, double* out, int n) {
  const Stream& s = *static_cast<Stream*>(h);
  const double values[3] = {s.read_ns * 1e-9, s.inflate_ns * 1e-9,
                            s.parse_ns * 1e-9};
  for (int i = 0; i < n && i < 3; ++i) out[i] = values[i];
  return 3;
}

const char* scx_stream_error(void* h) {
  return static_cast<Stream*>(h)->error.c_str();
}

void scx_stream_close(void* h) { delete static_cast<Stream*>(h); }

// ---- packed column arena (ingest ABI; layout mirrored by ingest/arena.py)

long scx_arena_nbytes(long capacity) { return arena_nbytes(capacity); }

long scx_batch_fill_arena(void* h, uint8_t* arena, long capacity) {
  return batch_fill_arena(*static_cast<Stream*>(h), arena, capacity);
}

// ---- batch column accessors (current batch of a stream / whole-file handle)

long scx_n_records(void* h) {
  return static_cast<long>(static_cast<Stream*>(h)->batch.cols.size());
}

const int32_t* scx_col_i32(void* h, const char* name) {
  Columns& c = static_cast<Stream*>(h)->batch.cols;
  std::string_view n(name);
  if (n == "cell") return c.cell.data();
  if (n == "umi") return c.umi.data();
  if (n == "gene") return c.gene.data();
  if (n == "qname") return c.qname.data();
  if (n == "ref") return c.ref.data();
  if (n == "pos") return c.pos.data();
  if (n == "nh") return c.nh.data();
  return nullptr;
}

const int8_t* scx_col_i8(void* h, const char* name) {
  Columns& c = static_cast<Stream*>(h)->batch.cols;
  std::string_view n(name);
  if (n == "strand") return c.strand.data();
  if (n == "xf") return c.xf.data();
  if (n == "perfect_umi") return c.perfect_umi.data();
  if (n == "perfect_cb") return c.perfect_cb.data();
  if (n == "unmapped") return reinterpret_cast<const int8_t*>(c.unmapped.data());
  if (n == "duplicate") return reinterpret_cast<const int8_t*>(c.duplicate.data());
  if (n == "spliced") return reinterpret_cast<const int8_t*>(c.spliced.data());
  return nullptr;
}

const uint16_t* scx_col_u16(void* h, const char* name) {
  Columns& c = static_cast<Stream*>(h)->batch.cols;
  std::string_view n(name);
  if (n == "umi_qual") return c.umi_qual.data();
  if (n == "cb_qual") return c.cb_qual.data();
  return nullptr;
}

const uint32_t* scx_col_u32(void* h, const char* name) {
  Columns& c = static_cast<Stream*>(h)->batch.cols;
  std::string_view n(name);
  if (n == "genomic_qual") return c.genomic_qual.data();
  if (n == "genomic_total") return c.genomic_total.data();
  return nullptr;
}

long scx_vocab_size(void* h, const char* name) {
  Batch::Flat* flat = flat_vocab(static_cast<Stream*>(h), name);
  return flat ? static_cast<long>(flat->offsets.size()) - 1 : -1;
}

const char* scx_vocab_bytes(void* h, const char* name, long* total_len) {
  Batch::Flat* flat = flat_vocab(static_cast<Stream*>(h), name);
  if (!flat) return nullptr;
  if (total_len) *total_len = static_cast<long>(flat->bytes.size());
  return flat->bytes.data();
}

const int64_t* scx_vocab_offsets(void* h, const char* name) {
  Batch::Flat* flat = flat_vocab(static_cast<Stream*>(h), name);
  return flat ? flat->offsets.data() : nullptr;
}

// ---- legacy whole-file API: a stream whose single batch is the file ----

void* scx_decode_bam(const char* path, int n_threads, char* errbuf,
                     int errbuf_len) {
  std::string error;
  Stream* s = open_stream(path, n_threads, /*want_qname=*/true, error);
  if (!s) {
    set_errbuf(errbuf, errbuf_len, error);
    return nullptr;
  }
  long n = stream_next(*s, -1);
  if (n < 0) {
    set_errbuf(errbuf, errbuf_len, s->error);
    delete s;
    return nullptr;
  }
  return s;
}

void scx_free(void* h) { delete static_cast<Stream*>(h); }

}  // extern "C"
