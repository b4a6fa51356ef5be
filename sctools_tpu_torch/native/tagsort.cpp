// Out-of-core BAM tag sort of the port's host layer.
//
// The port's copy of the JAX package's tagsort.cpp (itself the role of the
// reference's TagSort binary: sorted partial files, then a k-way heap
// merge). Records stream through the shared inflate reader, each batch
// sorts IN PLACE over raw record bytes (no record objects), sorted batches
// write as BGZF partial BAMs, and a heap merge concatenates them into the
// output: a BGZF file (scx_tagsort), or plain "BAM\1" bytes into a pipe
// that the column decoder reads, optionally teed to a BGZF file
// (scx_tagsort_pipe_*, the fused metrics pass).
//
// Sort key: (tag1, tag2, tag3, query_name), byte-lexicographic, missing
// tags as empty strings -- the TagSortableRecord order for STRING tags
// (sctools_tpu_torch/bam.py). The Python caller gates this path to the
// barcode/umi/gene string tags; integer tag values, reachable only by
// calling scx_tagsort directly, stringify in decimal and therefore order
// lexicographically, not numerically.
// The sort is stable (std::stable_sort per batch; the merge breaks key
// ties by partial index, and partials are in file order).

#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <queue>
#include <string>
#include <string_view>
#include <thread>
#include <vector>
#include <chrono>
#include <condition_variable>
#include <cstdlib>
#include <mutex>

#include "native_io.h"

namespace {

using scx::BgzfWriter;
using scx::BgzfByteStream;

// ------------------------------------------------------------ key extraction

struct RecordKey {
  std::string_view tag[3];
  std::string_view qname;
  uint64_t packed[3];  // 3-bit ACGTN packing (order-preserving, injective)
  uint64_t prefix0;    // big-endian first-8-bytes of tag[0] (any string)
  uint8_t packable;    // bit i set when tag[i] packed exactly
};

// 3-bit code per base ascending in ASCII order: packed-integer order ==
// byte-lexicographic order for ACGTN strings, 0 = end padding, so the
// empty (missing) tag packs to 0 and sorts first — the reference's
// empty-string sort default (src/sctools/bam.py:660).
constexpr int8_t kTagBase[256] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 1, 0, 2, 0, 0, 0, 3, 0, 0, 0, 0, 0, 0, 4, 0,
    0, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
};

inline bool pack_tag(std::string_view s, uint64_t& out) {
  if (s.size() > 21) return false;  // 21 bases x 3 bits = 63 bits
  uint64_t v = 0;
  for (size_t i = 0; i < s.size(); ++i) {
    uint64_t code =
        static_cast<uint64_t>(kTagBase[static_cast<uint8_t>(s[i])]);
    if (code == 0) return false;
    v |= code << (60 - 3 * i);
  }
  out = v;
  return true;
}

// big-endian 8-byte prefix: u64 order == lexicographic order of the first
// 8 bytes for ANY string (ties fall back to the full comparator, so zero
// padding is harmless)
inline uint64_t prefix8(std::string_view s) {
  uint8_t buf[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  std::memcpy(buf, s.data(), std::min<size_t>(8, s.size()));
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | buf[i];
  return v;
}

inline uint32_t read_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Walk the aux region of one record, filling key views for the requested
// 2-char tag names. Z/H values are viewed in place; integer values are
// stringified into `arena` (deque: stable addresses). Returns false on a
// malformed aux region.
bool extract_key(const uint8_t* rec, uint32_t len, const char (*want)[2],
                 std::deque<std::string>& arena, RecordKey& key) {
  uint8_t l_read_name = rec[8];
  uint16_t n_cigar = rec[12] | (rec[13] << 8);
  uint32_t l_seq = read_u32(rec + 16);
  uint64_t fixed = 32ull + l_read_name + 4ull * n_cigar +
                   (static_cast<uint64_t>(l_seq) + 1) / 2 + l_seq;
  if (fixed > len) return false;
  key.qname = std::string_view(reinterpret_cast<const char*>(rec + 32),
                               l_read_name ? l_read_name - 1 : 0);
  for (int i = 0; i < 3; ++i) key.tag[i] = std::string_view();
  key.packable = 0;

  const uint8_t* p = rec + fixed;
  const uint8_t* end = rec + len;
  while (p + 3 <= end) {
    char t0 = static_cast<char>(p[0]), t1 = static_cast<char>(p[1]);
    char type = static_cast<char>(p[2]);
    p += 3;
    size_t size = 0;
    int64_t int_value = 0;
    bool is_int = false;
    const char* str = nullptr;
    size_t str_len = 0;
    switch (type) {
      case 'A': size = 1; str = reinterpret_cast<const char*>(p); str_len = 1; break;
      case 'c': size = 1; is_int = true;
        int_value = *reinterpret_cast<const int8_t*>(p); break;
      case 'C': size = 1; is_int = true; int_value = p[0]; break;
      case 's': size = 2; is_int = true;
        int_value = static_cast<int16_t>(p[0] | (p[1] << 8)); break;
      case 'S': size = 2; is_int = true;
        int_value = static_cast<uint16_t>(p[0] | (p[1] << 8)); break;
      case 'i': size = 4; is_int = true;
        int_value = static_cast<int32_t>(read_u32(p)); break;
      case 'I': size = 4; is_int = true; int_value = read_u32(p); break;
      case 'f': size = 4; break;  // float tags cannot be sort keys here
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
        uint32_t n = read_u32(p + 1);
        size_t elem = (sub == 'c' || sub == 'C') ? 1
                      : (sub == 's' || sub == 'S') ? 2 : 4;
        size = 5 + static_cast<size_t>(n) * elem;
        break;
      }
      default:
        return false;
    }
    if (p + size > end) return false;
    for (int i = 0; i < 3; ++i) {
      if (t0 == want[i][0] && t1 == want[i][1]) {
        if (str) {
          key.tag[i] = std::string_view(str, str_len);
        } else if (is_int) {
          arena.emplace_back(std::to_string(int_value));
          key.tag[i] = arena.back();
        }
      }
    }
    p += size;
  }
  for (int i = 0; i < 3; ++i) {
    if (pack_tag(key.tag[i], key.packed[i])) key.packable |= 1 << i;
  }
  key.prefix0 = prefix8(key.tag[0]);
  return true;
}

inline bool key_less(const RecordKey& a, const RecordKey& b) {
  for (int i = 0; i < 3; ++i) {
    uint8_t bit = 1 << i;
    if ((a.packable & bit) && (b.packable & bit)) {
      // injective order-preserving packing: one register compare replaces
      // the string compare, and equality IS tag equality
      if (a.packed[i] != b.packed[i]) return a.packed[i] < b.packed[i];
    } else if (a.tag[i] != b.tag[i]) {
      return a.tag[i] < b.tag[i];
    }
  }
  return a.qname < b.qname;
}

// ------------------------------------------------------------- input stream

// sequential record reader over a BAM (BGZF or plain), header captured raw
struct RecordStream {
  BgzfByteStream in;
  std::string header;  // raw uncompressed header bytes (magic..refs)
  std::string error;

  bool open(const char* path) {
    if (!in.open(path)) {
      error = std::string("cannot open ") + path;
      return false;
    }
    uint8_t buf[8];
    if (!in.read_exact(buf, 8) || std::memcmp(buf, "BAM\1", 4) != 0) {
      error = "not a BAM stream (bad magic)";
      return false;
    }
    header.assign(reinterpret_cast<char*>(buf), 8);
    uint32_t l_text = read_u32(buf + 4);
    if (!append_exact(l_text)) return false;
    uint8_t nref_buf[4];
    if (!in.read_exact(nref_buf, 4)) {
      error = "truncated header";
      return false;
    }
    header.append(reinterpret_cast<char*>(nref_buf), 4);
    uint32_t n_ref = read_u32(nref_buf);
    for (uint32_t i = 0; i < n_ref; ++i) {
      uint8_t lbuf[4];
      if (!in.read_exact(lbuf, 4)) {
        error = "truncated reference list";
        return false;
      }
      header.append(reinterpret_cast<char*>(lbuf), 4);
      uint32_t l_name = read_u32(lbuf);
      if (!append_exact(l_name + 4ull)) return false;  // name + l_ref
    }
    return true;
  }

  bool append_exact(uint64_t n) {
    std::vector<uint8_t> tmp(n);
    if (n && !in.read_exact(tmp.data(), n)) {
      error = "truncated header";
      return false;
    }
    header.append(reinterpret_cast<char*>(tmp.data()), n);
    return true;
  }

  // append next record (4-byte size prefix included) to `arena`; returns
  // bytes appended, 0 at clean EOF, -1 on error (error set)
  long next_into(std::vector<uint8_t>& arena) {
    uint8_t size_buf[4];
    if (!in.read_exact(size_buf, 4)) {
      if (in.failed()) {
        error = "truncated record";
        return -1;
      }
      return 0;
    }
    uint32_t block_size = read_u32(size_buf);
    if (block_size < 32) {
      error = "truncated record";
      return -1;
    }
    size_t base = arena.size();
    arena.resize(base + 4 + block_size);
    std::memcpy(arena.data() + base, size_buf, 4);
    if (!in.read_exact(arena.data() + base + 4, block_size)) {
      error = "truncated record";
      return -1;
    }
    return static_cast<long>(4 + block_size);
  }

  // next record (4-byte size prefix INCLUDED in out); false at EOF
  bool next(std::vector<uint8_t>& out) {
    uint8_t size_buf[4];
    if (!in.read_exact(size_buf, 4)) {
      // distinguish clean EOF from a mid-stream failure: the merge must
      // not treat a corrupt partial as exhausted (silent truncation)
      if (in.failed()) error = "truncated record";
      return false;
    }
    uint32_t block_size = read_u32(size_buf);
    if (block_size < 32) {
      error = "truncated record";
      return false;
    }
    out.resize(4 + block_size);
    std::memcpy(out.data(), size_buf, 4);
    if (!in.read_exact(out.data() + 4, block_size)) {
      error = "truncated record";
      return false;
    }
    return true;
  }
};

// ---------------------------------------------------------------- phase 1

struct Span {
  size_t offset;
  uint32_t len;  // includes the 4-byte size prefix
};

// sort spans of `arena` by record key; returns false on malformed tags
bool sort_batch(const std::vector<uint8_t>& arena, std::vector<Span>& spans,
                const char (*want)[2], std::string& error) {
  std::vector<RecordKey> keys(spans.size());
  std::deque<std::string> int_arena;
  for (size_t i = 0; i < spans.size(); ++i) {
    if (!extract_key(arena.data() + spans[i].offset + 4, spans[i].len - 4,
                     want, int_arena, keys[i])) {
      error = "malformed aux tags";
      return false;
    }
  }
  // sort 16-byte (prefix, index) items: most comparisons resolve on the
  // register-width big-endian prefix of tag[0] without touching the keys
  // array at all; ties fall into the packed/string comparator
  struct SortItem {
    uint64_t k0;
    uint32_t idx;
  };
  std::vector<SortItem> order(spans.size());
  for (size_t i = 0; i < order.size(); ++i)
    order[i] = {keys[i].prefix0, static_cast<uint32_t>(i)};
  std::stable_sort(order.begin(), order.end(),
                   [&](const SortItem& a, const SortItem& b) {
                     if (a.k0 != b.k0) return a.k0 < b.k0;
                     return key_less(keys[a.idx], keys[b.idx]);
                   });
  std::vector<Span> sorted(spans.size());
  for (size_t i = 0; i < order.size(); ++i) sorted[i] = spans[order[i].idx];
  spans.swap(sorted);
  return true;
}

void write_batch(BgzfWriter& out, const std::string& header,
                 const std::vector<uint8_t>& arena,
                 const std::vector<Span>& spans) {
  out.write(reinterpret_cast<const uint8_t*>(header.data()), header.size());
  for (const Span& s : spans) out.write(arena.data() + s.offset, s.len);
}

// ---------------------------------------------------------------- phase 2

struct PartialCursor {
  std::unique_ptr<RecordStream> stream;
  std::vector<uint8_t> record;
  RecordKey key;
  std::deque<std::string> int_arena;
  bool done = false;

  bool advance(const char (*want)[2], std::string& error) {
    int_arena.clear();
    if (!stream->next(record)) {
      done = true;
      if (!stream->error.empty()) {
        error = stream->error;
        return false;
      }
      return true;
    }
    if (!extract_key(record.data() + 4, record.size() - 4, want, int_arena,
                     key)) {
      error = "malformed aux tags";
      return false;
    }
    return true;
  }
};

// ------------------------------------------------------------- output sinks

// The merged sorted stream can flow to a compressed BAM on disk, raw bytes
// into a pipe (the fused-metrics path: the column decoder reads the other
// end, no disk round trip), or both at once (sorted BAM + metrics in one
// merge pass — the reference computes metrics DURING its k-way merge,
// fastqpreprocessing/src/tagsort.cpp:185-196).
struct OutSink {
  virtual bool write(const uint8_t* data, size_t len) = 0;
  virtual bool finish() = 0;  // flush + close; false on error
  virtual void abort() = 0;   // error path: output must not look complete
  virtual ~OutSink() = default;
};

struct BgzfSink : OutSink {
  BgzfWriter writer;
  std::string path;
  bool open(const char* p, int level) {
    path = p;
    return writer.open(p, level);
  }
  bool write(const uint8_t* data, size_t len) override {
    writer.write(data, len);
    return !writer.failed();
  }
  bool finish() override {
    if (!writer.close()) {
      std::remove(path.c_str());
      return false;
    }
    return true;
  }
  void abort() override {
    writer.abort_close();
    std::remove(path.c_str());
  }
};

struct RawFileSink : OutSink {  // plain (uncompressed) BAM into a FILE*
  FILE* file = nullptr;
  bool write(const uint8_t* data, size_t len) override {
    return std::fwrite(data, 1, len, file) == len;
  }
  bool finish() override {
    int rc = std::fclose(file);
    file = nullptr;
    return rc == 0;
  }
  void abort() override {
    // closing mid-stream leaves the reader a truncated stream, which the
    // decoder reports as an error — never a silently short result
    if (file) std::fclose(file);
    file = nullptr;
  }
};

struct TeeSink : OutSink {
  OutSink* a;
  OutSink* b;
  bool write(const uint8_t* data, size_t len) override {
    bool ok_a = a->write(data, len);
    bool ok_b = b->write(data, len);
    return ok_a && ok_b;
  }
  bool finish() override {
    bool ok_a = a->finish();
    bool ok_b = b->finish();
    return ok_a && ok_b;
  }
  void abort() override {
    a->abort();
    b->abort();
  }
};

// A bounded-queue writer thread in front of any sink: the producer hands
// over byte chunks and keeps computing while compression + disk writes
// happen behind it. On a single-core host this only overlaps IO waits; on
// the reference's intended multi-core hosts (input_options.h:15 caps at 30
// threads) it takes the compression off the merge/sort thread entirely.
struct AsyncSink : OutSink {
  OutSink* inner = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  std::deque<std::vector<uint8_t>> queue;
  size_t queued_bytes = 0;
  bool closing = false;
  bool failed = false;
  std::vector<uint8_t> current;
  static constexpr size_t kChunk = 4u << 20;
  static constexpr size_t kMaxQueued = 64u << 20;

  void start(OutSink* sink) {
    inner = sink;
    worker = std::thread([this]() {
      for (;;) {
        std::vector<uint8_t> chunk;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv_data.wait(lock, [&] { return !queue.empty() || closing; });
          if (queue.empty()) break;
          chunk = std::move(queue.front());
          queue.pop_front();
          queued_bytes -= chunk.size();
          cv_space.notify_one();
        }
        if (!failed && !inner->write(chunk.data(), chunk.size())) {
          std::lock_guard<std::mutex> lock(mu);
          failed = true;
        }
      }
    });
  }

  bool write(const uint8_t* data, size_t len) override {
    current.insert(current.end(), data, data + len);
    if (current.size() >= kChunk) push();
    std::lock_guard<std::mutex> lock(mu);
    return !failed;
  }

  void push() {
    std::unique_lock<std::mutex> lock(mu);
    cv_space.wait(lock, [&] { return queued_bytes < kMaxQueued || failed; });
    queued_bytes += current.size();
    queue.push_back(std::move(current));
    current.clear();
    cv_data.notify_one();
  }

  void drain() {
    if (!current.empty()) push();
    {
      std::lock_guard<std::mutex> lock(mu);
      closing = true;
      cv_data.notify_one();
    }
    if (worker.joinable()) worker.join();
  }

  bool finish() override {
    drain();
    bool write_ok = !failed;
    return inner->finish() && write_ok;
  }

  void abort() override {
    {
      std::lock_guard<std::mutex> lock(mu);
      failed = true;  // unblocks a full queue
      closing = true;
      cv_space.notify_all();
      cv_data.notify_one();
    }
    if (worker.joinable()) worker.join();
    inner->abort();
  }

  ~AsyncSink() { drain(); }
};

// Phase-1 partial writer: compresses and writes the previous sorted batch
// while the producer reads and sorts the next one (double-buffered; at
// most one batch in flight bounds memory at two arenas).
struct PartialWriter {
  struct Job {
    std::string path;
    std::vector<uint8_t> arena;
    std::vector<Span> spans;
  };
  const std::string* header = nullptr;
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_submit, cv_done;
  std::unique_ptr<Job> pending;
  bool in_flight = false;
  bool closing = false;
  bool failed = false;
  std::string error;

  void start(const std::string& header_bytes) {
    header = &header_bytes;
    worker = std::thread([this]() {
      for (;;) {
        std::unique_ptr<Job> job;
        {
          std::unique_lock<std::mutex> lock(mu);
          cv_submit.wait(lock, [&] { return pending || closing; });
          if (!pending) break;
          job = std::move(pending);
          in_flight = true;  // cleared only when the write COMPLETES
        }
        BgzfWriter part;
        // level 1: stored-block (level 0) partials put ~7x the input
        // bytes on disk and made the 42M-record merge disk-bound;
        // libdeflate level 1 compresses BAM records ~3-4x cheaply
        if (!part.open(job->path.c_str(), 1)) {
          std::lock_guard<std::mutex> lock(mu);
          failed = true;
          error = "cannot open " + job->path;
        } else {
          write_batch(part, *header, job->arena, job->spans);
          if (!part.close()) {
            std::lock_guard<std::mutex> lock(mu);
            failed = true;
            error = "partial write failed";
          }
        }
        {
          std::lock_guard<std::mutex> lock(mu);
          in_flight = false;
        }
        cv_done.notify_one();
      }
    });
  }

  // takes ownership of the batch; blocks while one is queued OR being
  // written, so at most two arenas are live (the in-flight one and the
  // producer's next batch)
  bool submit(std::string path, std::vector<uint8_t>&& arena,
              std::vector<Span>&& spans) {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [&] { return (!pending && !in_flight) || failed; });
    if (failed) return false;
    pending = std::make_unique<Job>(
        Job{std::move(path), std::move(arena), std::move(spans)});
    cv_submit.notify_one();
    return true;
  }

  // waits until every submitted batch has fully completed (not merely
  // been taken by the worker): a failed FINAL partial must fail the run
  bool wait_idle() {
    std::unique_lock<std::mutex> lock(mu);
    cv_done.wait(lock, [&] { return (!pending && !in_flight) || failed; });
    return !failed;
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lock(mu);
      closing = true;
      cv_submit.notify_one();
    }
    if (worker.joinable()) worker.join();
  }

  ~PartialWriter() { stop(); }
};

// ------------------------------------------------------------ tagsort core

// what a sort did: its wall seconds by phase (reading and framing the
// input, the batch sorts with their keys, writing the partials or, with a
// writer thread, waiting for it, and the merge's output, partial reads
// and keys) and the number of partials it wrote
struct SortStats {
  double read = 0, sort = 0, partials = 0, merge = 0;
  long partial_files = 0;
};

// Sort `input` by (tag1, tag2, tag3, query name) into `out`. Partials go
// to `scratch_prefix + N`. Returns records written, -1 on error (with
// `error` set); the caller owns sink abort/cleanup on failure.
long tagsort_core(const char* input, OutSink& out,
                  const std::string& scratch_prefix, const char (*want)[2],
                  long batch_records, std::string& error,
                  SortStats& stats) {
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  RecordStream in;
  if (!in.open(input)) {
    error = in.error;
    return -1;
  }

  // read batches; if the first batch reaches EOF, skip the partial round
  // trip entirely (reference behavior for small inputs)
  std::vector<std::string> partials;
  std::vector<uint8_t> arena;
  std::vector<Span> spans;
  std::vector<uint8_t> pending;  // one-record lookahead across batches
  bool have_pending = false;
  long total = 0;
  bool eof = false;

  // the writer threads only pay off with a second core to run on
  const bool overlap = scx::effective_concurrency() > 1;
  PartialWriter partial_writer;
  auto cleanup = [&]() {
    for (const std::string& p : partials) std::remove(p.c_str());
  };

  while (!eof) {
    auto t0 = now();
    arena.clear();
    spans.clear();
    if (have_pending) {
      spans.push_back({0, static_cast<uint32_t>(pending.size())});
      arena = pending;
      pending.clear();
      have_pending = false;
    }
    while (spans.size() < static_cast<size_t>(batch_records)) {
      long r = in.next_into(arena);
      if (r < 0) {
        cleanup();
        error = in.error;
        return -1;
      }
      if (r == 0) {
        eof = true;
        break;
      }
      spans.push_back({arena.size() - static_cast<size_t>(r),
                       static_cast<uint32_t>(r)});
    }
    if (!eof && spans.size() == static_cast<size_t>(batch_records)) {
      // peek one record so an input of exactly N batches still takes the
      // no-partials fast path instead of a 1-cursor merge round trip
      long r = in.next_into(pending);
      if (r < 0) {
        cleanup();
        error = in.error;
        return -1;
      }
      if (r == 0)
        eof = true;
      else
        have_pending = true;
    }
    if (spans.empty()) break;
    auto t1 = now();
    stats.read += secs(t0, t1);
    if (!sort_batch(arena, spans, want, error)) {
      cleanup();
      return -1;
    }
    total += static_cast<long>(spans.size());
    auto t2 = now();
    stats.sort += secs(t1, t2);

    if (eof && partials.empty()) {
      // whole file fit in one batch: straight to the sink
      bool ok = out.write(
          reinterpret_cast<const uint8_t*>(in.header.data()),
          in.header.size());
      for (const Span& s : spans)
        ok = ok && out.write(arena.data() + s.offset, s.len);
      stats.merge = secs(t2, now());
      if (!ok) {
        error = "write failed";
        return -1;
      }
      return total;
    }
    std::string path = scratch_prefix + std::to_string(partials.size());
    if (overlap) {
      // compress + write the previous batch behind the reader/sorter
      if (partials.empty()) partial_writer.start(in.header);
      if (!partial_writer.submit(path, std::move(arena), std::move(spans))) {
        partial_writer.stop();
        cleanup();
        error = partial_writer.error;
        return -1;
      }
      arena = std::vector<uint8_t>();
      spans = std::vector<Span>();
    } else {
      // single-core hosts: inline writes avoid the context-switch tax
      BgzfWriter part;
      if (!part.open(path.c_str(), 1)) {
        cleanup();
        error = std::string("cannot open ") + path;
        return -1;
      }
      write_batch(part, in.header, arena, spans);
      if (!part.close()) {
        cleanup();
        error = "partial write failed";
        return -1;
      }
    }
    partials.push_back(path);
    stats.partial_files = static_cast<long>(partials.size());
    stats.partials += secs(t2, now());
  }
  if (overlap && !partials.empty()) {
    bool ok = partial_writer.wait_idle();
    partial_writer.stop();
    if (!ok) {
      cleanup();
      error = partial_writer.error;
      return -1;
    }
  }

  if (partials.empty()) {
    // empty input: header-only output
    if (!out.write(reinterpret_cast<const uint8_t*>(in.header.data()),
                   in.header.size())) {
      error = "write failed";
      return -1;
    }
    return 0;
  }

  // k-way merge (reference tagsort.cpp:144-294); ties break by partial
  // index, preserving overall stability
  std::vector<PartialCursor> cursors(partials.size());
  for (size_t i = 0; i < partials.size(); ++i) {
    cursors[i].stream = std::make_unique<RecordStream>();
    if (!cursors[i].stream->open(partials[i].c_str())) {
      cleanup();
      error = cursors[i].stream->error;
      return -1;
    }
    if (!cursors[i].advance(want, error)) {
      cleanup();
      return -1;
    }
  }
  auto heap_greater = [&](size_t a, size_t b) {
    const RecordKey& ka = cursors[a].key;
    const RecordKey& kb = cursors[b].key;
    if (ka.prefix0 != kb.prefix0) return ka.prefix0 > kb.prefix0;
    if (key_less(kb, ka)) return true;
    if (key_less(ka, kb)) return false;
    return a > b;
  };
  std::priority_queue<size_t, std::vector<size_t>, decltype(heap_greater)>
      heap(heap_greater);
  for (size_t i = 0; i < cursors.size(); ++i)
    if (!cursors[i].done) heap.push(i);

  if (!out.write(reinterpret_cast<const uint8_t*>(in.header.data()),
                 in.header.size())) {
    cleanup();
    error = "write failed";
    return -1;
  }
  auto t3 = now();
  while (!heap.empty()) {
    size_t i = heap.top();
    heap.pop();
    if (!out.write(cursors[i].record.data(), cursors[i].record.size())) {
      cleanup();
      error = "write failed";
      return -1;
    }
    if (!cursors[i].advance(want, error)) {
      cleanup();
      return -1;
    }
    if (!cursors[i].done) heap.push(i);
  }
  stats.merge = secs(t3, now());
  cleanup();
  return total;
}

bool parse_tags(const char* tag1, const char* tag2, const char* tag3,
                char (*want)[2], std::string& error) {
  const char* names[3] = {tag1, tag2, tag3};
  for (int i = 0; i < 3; ++i) {
    if (!names[i] || std::strlen(names[i]) != 2) {
      error = "tag keys must be 2 characters";
      return false;
    }
    want[i][0] = names[i][0];
    want[i][1] = names[i][1];
  }
  return true;
}

// ------------------------------------------------------ pipe-mode handle

struct TagsortPipe {
  std::thread worker;
  int read_fd = -1;
  std::atomic<long> result{-2};  // -2 = still running
  std::string error;             // written before `result` stores
  std::string input;
  std::string scratch_prefix;
  std::string bam_output;  // optional tee target ("" = none)
  int bam_level = 6;
  char want[3][2];
  long batch_records = 0;
  SortStats stats;  // written before `result` stores
};

}  // namespace

extern "C" {

// Sort input by (tag1, tag2, tag3, query name); bounded memory:
// ~batch_records records (plus compression buffers). Returns records
// written, -1 on error.
long scx_tagsort(const char* input, const char* output, const char* tag1,
                 const char* tag2, const char* tag3, long batch_records,
                 int compress_level, char* errbuf, int errbuf_len) {
  auto fail = [&](const std::string& message) -> long {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    return -1;
  };
  if (batch_records < 1000) batch_records = 1000;  // reference's floor
  char want[3][2];
  std::string error;
  if (!parse_tags(tag1, tag2, tag3, want, error)) return fail(error);

  BgzfSink sink;
  if (!sink.open(output, compress_level))
    return fail(std::string("cannot open ") + output);
  const bool overlap = scx::effective_concurrency() > 1;
  AsyncSink async;
  OutSink* out = &sink;
  if (overlap) {
    async.start(&sink);
    out = &async;
  }
  SortStats stats;
  long total = tagsort_core(
      input, *out, std::string(output) + ".tagsort_partial_", want,
      batch_records, error, stats);
  if (total < 0) {
    out->abort();
    return fail(error);
  }
  if (!out->finish()) return fail("write failed");
  return total;
}

// Fused path: run the tag sort on a worker thread, streaming the merged
// sorted records as PLAIN (uncompressed) BAM into a pipe. The caller opens
// the read end with the parallel column decoder (scx_stream_open on
// /proc/self/fd/N) — the merged stream feeds the device metrics engine
// with no sorted BAM written, compressed, or re-read. Optionally tees the
// sorted BAM to `bam_output` (level `bam_level`) in the same pass.
// Returns a handle, or null with errbuf set.
void* scx_tagsort_pipe_open(const char* input, const char* tag1,
                            const char* tag2, const char* tag3,
                            long batch_records, const char* bam_output,
                            int bam_level, const char* scratch_prefix,
                            char* errbuf, int errbuf_len) {
  auto fail = [&](const std::string& message) -> void* {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    return nullptr;
  };
  if (batch_records < 1000) batch_records = 1000;
  auto handle = std::make_unique<TagsortPipe>();
  std::string error;
  if (!parse_tags(tag1, tag2, tag3, handle->want, error)) return fail(error);
  int fds[2];
  if (pipe(fds) != 0) return fail("cannot create pipe");
  FILE* write_file = fdopen(fds[1], "wb");
  if (!write_file) {
    close(fds[0]);
    close(fds[1]);
    return fail("cannot open pipe stream");
  }
  handle->read_fd = fds[0];
  handle->input = input;
  // scratch goes where the caller says (a temp dir / beside the outputs),
  // never beside the input, which may live on a read-only mount
  handle->scratch_prefix = std::string(scratch_prefix) + "_" +
                           std::to_string(getpid()) + "_";
  handle->bam_output = bam_output ? bam_output : "";
  handle->bam_level = bam_level;
  handle->batch_records = batch_records;
  TagsortPipe* p = handle.get();
  handle->worker = std::thread([p, write_file]() {
    RawFileSink pipe_sink;
    pipe_sink.file = write_file;
    BgzfSink bam_sink;
    TeeSink tee;
    OutSink* out = &pipe_sink;
    if (!p->bam_output.empty()) {
      if (!bam_sink.open(p->bam_output.c_str(), p->bam_level)) {
        p->error = "cannot open " + p->bam_output;
        pipe_sink.abort();
        p->result.store(-1);
        return;
      }
      tee.a = &pipe_sink;
      tee.b = &bam_sink;
      out = &tee;
    }
    std::string error;
    long total = tagsort_core(p->input.c_str(), *out, p->scratch_prefix,
                              p->want, p->batch_records, error, p->stats);
    if (total < 0) {
      p->error = error;
      out->abort();
      p->result.store(-1);
      return;
    }
    if (!out->finish()) {
      p->error = "write failed";
      p->result.store(-1);
      return;
    }
    p->result.store(total);
  });
  return handle.release();
}

int scx_tagsort_pipe_fd(void* h) {
  return static_cast<TagsortPipe*>(h)->read_fd;
}

// Join the worker and return records merged, or -1 (error available via
// scx_tagsort_pipe_error). The caller must have consumed the stream (or
// closed every read descriptor) first, or the worker may block on a full
// pipe forever.
long scx_tagsort_pipe_finish(void* h) {
  TagsortPipe* p = static_cast<TagsortPipe*>(h);
  if (p->worker.joinable()) p->worker.join();
  return p->result.load();
}

// The finished sort's wall seconds by phase (read, sort, partials, merge)
// and the number of partials it wrote, in out[0..4]; valid after
// scx_tagsort_pipe_finish.
void scx_tagsort_pipe_stats(void* h, double* out) {
  const SortStats& s = static_cast<TagsortPipe*>(h)->stats;
  out[0] = s.read;
  out[1] = s.sort;
  out[2] = s.partials;
  out[3] = s.merge;
  out[4] = static_cast<double>(s.partial_files);
}

const char* scx_tagsort_pipe_error(void* h) {
  return static_cast<TagsortPipe*>(h)->error.c_str();
}

// Close the read end, join the worker and free the handle. Unless
// `keep_output` is set (the caller consumed and checked the whole stream),
// a tee the worker finished is removed too: a worker that failed has
// removed its own, so an abandoned or failed pass leaves no sorted BAM.
void scx_tagsort_pipe_free(void* h, int keep_output) {
  TagsortPipe* p = static_cast<TagsortPipe*>(h);
  if (p->read_fd >= 0) close(p->read_fd);
  if (p->worker.joinable()) p->worker.join();
  if (!keep_output && p->result.load() >= 0 && !p->bam_output.empty())
    std::remove(p->bam_output.c_str());
  delete p;
}

}  // extern "C"
