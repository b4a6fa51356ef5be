// Shared native IO building blocks of the port's host layer: raw-deflate
// block (de)compression, streaming BGZF/gzip/plain readers, buffered line
// and record access, BGZF block writing (in line, or on a pool of threads),
// and the FASTQ record and span helpers. Used by the streaming decoder
// (bamdecode.cpp), the out-of-core tag sort (tagsort.cpp) and the FASTQ
// loops (fastqprocess.cpp, attach.cpp, fastqtools.cpp).
//
// A copy of the JAX package's native_io.h with two changes. Every block
// goes through zlib's raw-deflate calls (inflateInit2/deflateInit2 with
// window bits -15, crc32) where the JAX copy calls libdeflate: zlib is what
// both machines the port runs on provide. So the compressed bytes may differ
// from the JAX copy's; the decompressed records are the same. And since
// zlib on one thread would bound the FASTQ loops, their writers compress
// their blocks on a pool of threads (PooledBgzfWriter) and their inputs
// inflate on a thread each (ReadaheadInflateReader). Both can add where
// their time goes into an IoTimers (the FastqProcess loop's handle has one).
//
// BGZF framing matches the spec: <=64KB payloads, BC extra field, CRC32,
// trailing EOF block.

#ifndef SCTOOLS_TORCH_NATIVE_IO_H_
#define SCTOOLS_TORCH_NATIVE_IO_H_

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace scx {

constexpr size_t kBgzfMaxPayload = 0xff00;  // htslib's conventional max

// steady_clock in nanoseconds: read around a chunk's or a block's work,
// never per record
inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Where a FASTQ loop's IO time goes, in nanoseconds. The loop's thread, the
// readahead threads and the pool's workers each add their own fields, so
// every field is atomic.
struct IoTimers {
  std::atomic<int64_t> read_wait{0};   // the loop waiting on a readahead chunk
  std::atomic<int64_t> inflate{0};     // readahead threads in InflateReader::read, summed
  std::atomic<int64_t> write_wait{0};  // the loop waiting on the pool's head block
  std::atomic<int64_t> write_file{0};  // the loop writing finished blocks to their files
  std::atomic<int64_t> deflate{0};     // compressing payloads into blocks, summed over threads

  static void add(std::atomic<int64_t>& field, int64_t value) {
    field.fetch_add(value, std::memory_order_relaxed);
  }
};

// One reusable raw-deflate decompressor: a BGZF block's payload is a raw
// deflate stream, inflated whole into a buffer of its known size (ISIZE).
// inflateReset between blocks skips zlib's per-block set-up; one instance
// per worker thread needs no locking.
class RawInflater {
 public:
  RawInflater() {
    std::memset(&strm_, 0, sizeof(strm_));
    ok_ = inflateInit2(&strm_, -15) == Z_OK;
  }
  ~RawInflater() {
    if (ok_) inflateEnd(&strm_);
  }
  RawInflater(const RawInflater&) = delete;
  RawInflater& operator=(const RawInflater&) = delete;

  // true when the deflate stream ends exactly after dst_len output bytes
  bool inflate_block(const uint8_t* src, uint32_t src_len, uint8_t* dst,
                     uint32_t dst_len) {
    if (!ok_ || inflateReset(&strm_) != Z_OK) return false;
    strm_.next_in = const_cast<Bytef*>(src);
    strm_.avail_in = src_len;
    strm_.next_out = dst;
    strm_.avail_out = dst_len;
    int ret = inflate(&strm_, Z_FINISH);
    return ret == Z_STREAM_END && strm_.avail_out == 0;
  }

 private:
  z_stream strm_;
  bool ok_ = false;
};

// One reusable raw-deflate compressor at a fixed level (0 = stored blocks).
class RawDeflater {
 public:
  explicit RawDeflater(int level) {
    std::memset(&strm_, 0, sizeof(strm_));
    ok_ = deflateInit2(&strm_, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) == Z_OK;
  }
  ~RawDeflater() {
    if (ok_) deflateEnd(&strm_);
  }
  RawDeflater(const RawDeflater&) = delete;
  RawDeflater& operator=(const RawDeflater&) = delete;

  // compressed length, or 0 when the output did not fit in dst_cap
  size_t compress(const uint8_t* src, size_t src_len, uint8_t* dst,
                  size_t dst_cap) {
    if (!ok_ || deflateReset(&strm_) != Z_OK) return 0;
    strm_.next_in = const_cast<Bytef*>(src);
    strm_.avail_in = static_cast<uInt>(src_len);
    strm_.next_out = dst;
    strm_.avail_out = static_cast<uInt>(dst_cap);
    if (deflate(&strm_, Z_FINISH) != Z_STREAM_END) return 0;
    return dst_cap - strm_.avail_out;
  }

 private:
  z_stream strm_;
  bool ok_ = false;
};

// generic zlib pull-reader over a file (gzip via window bits 15+32,
// concatenated members handled by inflateReset)
class InflateReader {
 public:
  bool open(const char* path) {
    file_ = std::fopen(path, "rb");
    if (!file_) return false;
    std::memset(&strm_, 0, sizeof(strm_));
    plain_probe();
    if (!plain_) {
      if (inflateInit2(&strm_, 15 + 32) != Z_OK) return false;
      inited_ = true;
    }
    return true;
  }

  // fill out with up to len bytes; returns bytes produced (0 = EOF)
  size_t read(uint8_t* out, size_t len) {
    if (plain_) return std::fread(out, 1, len, file_);
    size_t produced = 0;
    while (produced < len) {
      if (strm_.avail_in == 0 && !feed()) break;
      strm_.next_out = out + produced;
      strm_.avail_out = static_cast<uInt>(len - produced);
      int ret = inflate(&strm_, Z_NO_FLUSH);
      produced = len - strm_.avail_out;
      if (ret == Z_STREAM_END) {
        // possibly another concatenated gzip member
        if (strm_.avail_in == 0 && !feed()) break;
        if (inflateReset(&strm_) != Z_OK) break;
      } else if (ret != Z_OK && ret != Z_BUF_ERROR) {
        error_ = true;
        break;
      } else if (ret == Z_BUF_ERROR && strm_.avail_in == 0 && !feed()) {
        break;
      }
    }
    return produced;
  }

  bool failed() const { return error_; }

  ~InflateReader() {
    if (file_) std::fclose(file_);
    // only after a successful inflateInit2: this reader is a member of
    // BgzfInflateReader and may never have been opened at all
    if (inited_) inflateEnd(&strm_);
  }

 private:
  void plain_probe() {
    int c0 = std::fgetc(file_);
    int c1 = std::fgetc(file_);
    std::rewind(file_);
    plain_ = !(c0 == 0x1f && c1 == 0x8b);
  }

  bool feed() {
    size_t n = std::fread(inbuf_, 1, sizeof(inbuf_), file_);
    strm_.next_in = inbuf_;
    strm_.avail_in = static_cast<uInt>(n);
    return n > 0;
  }

  FILE* file_ = nullptr;
  z_stream strm_;
  uint8_t inbuf_[1 << 16];
  bool plain_ = false;
  bool error_ = false;
  bool inited_ = false;
};

// BGZF-aware reader: one raw inflate per block, falling back to the generic
// zlib path for non-BGZF gzip and raw passthrough for plain files.
// Sequential single-threaded; the parallel batch decoder in bamdecode.cpp
// is the multi-core path.
class BgzfInflateReader {
 public:
  bool open(const char* path) {
    file_ = std::fopen(path, "rb");
    if (!file_) return false;
    uint8_t head[18];
    size_t n = std::fread(head, 1, sizeof(head), file_);
    std::rewind(file_);
    if (n >= 2 && head[0] == 0x1f && head[1] == 0x8b) {
      bool bgzf = n >= 18 && (head[3] & 4) && head[12] == 'B' &&
                  head[13] == 'C';
      if (!bgzf) {
        std::fclose(file_);
        file_ = nullptr;
        mode_ = kGzip;
        return zlib_.open(path);
      }
      mode_ = kBgzf;
      return true;
    }
    mode_ = kPlain;
    return true;
  }

  size_t read(uint8_t* out, size_t len) {
    if (mode_ == kGzip) return zlib_.read(out, len);
    if (mode_ == kPlain) return std::fread(out, 1, len, file_);
    size_t produced = 0;
    while (produced < len) {
      if (out_pos_ < out_buf_.size()) {
        size_t take = std::min(len - produced, out_buf_.size() - out_pos_);
        std::memcpy(out + produced, out_buf_.data() + out_pos_, take);
        out_pos_ += take;
        produced += take;
        continue;
      }
      if (!next_block()) break;
    }
    return produced;
  }

  bool failed() const { return mode_ == kGzip ? zlib_.failed() : error_; }

  ~BgzfInflateReader() {
    if (file_) std::fclose(file_);
  }

 private:
  bool next_block() {
    for (;;) {
      uint8_t hdr[12];
      size_t n = std::fread(hdr, 1, sizeof(hdr), file_);
      if (n == 0) return false;
      if (n != sizeof(hdr) || hdr[0] != 0x1f || hdr[1] != 0x8b) {
        error_ = true;
        return false;
      }
      uint16_t xlen = hdr[10] | (hdr[11] << 8);
      extra_.resize(xlen);
      if (xlen && std::fread(extra_.data(), 1, xlen, file_) != xlen) {
        error_ = true;
        return false;
      }
      uint32_t bsize = 0;
      for (size_t p = 0; p + 4 <= extra_.size();) {
        uint16_t slen = extra_[p + 2] | (extra_[p + 3] << 8);
        if (extra_[p] == 'B' && extra_[p + 1] == 'C' && slen == 2 &&
            p + 6 <= extra_.size())
          bsize = (extra_[p + 4] | (extra_[p + 5] << 8)) + 1u;
        p += 4 + slen;
      }
      if (bsize < 12u + xlen + 8u) {
        error_ = true;
        return false;
      }
      size_t payload = bsize - 12 - xlen - 8;
      comp_.resize(payload + 8);
      if (std::fread(comp_.data(), 1, payload + 8, file_) != payload + 8) {
        error_ = true;
        return false;
      }
      uint32_t isize = comp_[payload + 4] | (comp_[payload + 5] << 8) |
                       (comp_[payload + 6] << 16) |
                       (uint32_t(comp_[payload + 7]) << 24);
      if (isize == 0) continue;  // EOF marker (or empty) block: keep going
      out_buf_.resize(isize);
      out_pos_ = 0;
      if (!inflater_.inflate_block(comp_.data(),
                                   static_cast<uint32_t>(payload),
                                   out_buf_.data(), isize)) {
        error_ = true;
        return false;
      }
      return true;
    }
  }

  enum Mode { kBgzf, kGzip, kPlain };
  Mode mode_ = kBgzf;
  FILE* file_ = nullptr;
  RawInflater inflater_;
  InflateReader zlib_;
  std::vector<uint8_t> extra_, comp_, out_buf_;
  size_t out_pos_ = 0;
  bool error_ = false;
};

// buffered line/record access on top of a pull reader
template <class Reader>
class BasicByteStream {
 public:
  bool open(const char* path) { return reader_.open(path); }

  // next '\n'-terminated line (newline stripped); false at EOF
  bool read_line(std::string& line) {
    for (;;) {
      const uint8_t* base = buffer_.data() + offset_;
      size_t avail = buffer_.size() - offset_;
      // avail == 0 short-circuits: an empty vector's data() may be null,
      // and memchr's pointer is declared nonnull even for n == 0
      const void* nl = avail ? std::memchr(base, '\n', avail) : nullptr;
      if (nl) {
        size_t len = static_cast<const uint8_t*>(nl) - base;
        line.assign(reinterpret_cast<const char*>(base), len);
        offset_ += len + 1;
        compact();
        return true;
      }
      if (!refill()) {
        if (avail == 0) return false;
        line.assign(reinterpret_cast<const char*>(base), avail);
        offset_ += avail;
        return true;
      }
    }
  }

  // read exactly n bytes into out; false at EOF/short
  bool read_exact(uint8_t* out, size_t n) {
    while (buffer_.size() - offset_ < n) {
      if (!refill()) return false;
    }
    std::memcpy(out, buffer_.data() + offset_, n);
    offset_ += n;
    compact();
    return true;
  }

  bool failed() const { return reader_.failed(); }

  Reader& reader() { return reader_; }

 private:
  bool refill() {
    uint8_t chunk[1 << 16];
    size_t n = reader_.read(chunk, sizeof(chunk));
    if (n == 0) return false;
    buffer_.insert(buffer_.end(), chunk, chunk + n);
    return true;
  }

  void compact() {
    if (offset_ > (1 << 20)) {
      buffer_.erase(buffer_.begin(), buffer_.begin() + offset_);
      offset_ = 0;
    }
  }

  Reader reader_;
  std::vector<uint8_t> buffer_;
  size_t offset_ = 0;
};

// An InflateReader run on a thread of its own, a bounded queue of chunks
// ahead of the caller: the FASTQ loops' inputs inflate in parallel with
// each other and with the loop that parses them. Same bytes, same errors
// (failed() is final once read() has returned 0).
class ReadaheadInflateReader {
 public:
  ReadaheadInflateReader() = default;
  ReadaheadInflateReader(const ReadaheadInflateReader&) = delete;
  ReadaheadInflateReader& operator=(const ReadaheadInflateReader&) = delete;

  // where the waits and the inflate go (before open; null: nowhere)
  void set_timers(IoTimers* timers) { timers_ = timers; }

  bool open(const char* path) {
    if (!reader_.open(path)) return false;
    thread_ = std::thread([this] { run(); });
    return true;
  }

  size_t read(uint8_t* out, size_t len) {
    size_t produced = 0;
    while (produced < len) {
      if (pos_ == chunk_.size()) {
        if (eof_) break;
        std::unique_lock<std::mutex> lock(mu_);
        int64_t waited = timers_ && queue_.empty() ? now_ns() : 0;
        cv_.wait(lock, [this] { return !queue_.empty(); });
        if (waited) IoTimers::add(timers_->read_wait, now_ns() - waited);
        chunk_ = std::move(queue_.front());
        queue_.pop_front();
        lock.unlock();
        cv_.notify_all();
        pos_ = 0;
        if (chunk_.empty()) {
          eof_ = true;
          break;
        }
      }
      size_t take = std::min(len - produced, chunk_.size() - pos_);
      std::memcpy(out + produced, chunk_.data() + pos_, take);
      pos_ += take;
      produced += take;
    }
    return produced;
  }

  bool failed() const {
    std::lock_guard<std::mutex> lock(mu_);
    return failed_;
  }

  ~ReadaheadInflateReader() {
    if (!thread_.joinable()) return;
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    thread_.join();
  }

 private:
  static constexpr size_t kChunk = 1 << 18;
  static constexpr size_t kAhead = 8;  // chunks queued: 2 MiB a stream

  void run() {
    for (;;) {
      std::vector<uint8_t> chunk(kChunk);
      int64_t start = timers_ ? now_ns() : 0;
      chunk.resize(reader_.read(chunk.data(), kChunk));
      if (timers_) IoTimers::add(timers_->inflate, now_ns() - start);
      bool end = chunk.empty();
      std::unique_lock<std::mutex> lock(mu_);
      cv_.wait(lock, [this] { return stop_ || queue_.size() < kAhead; });
      if (stop_) return;
      if (end) failed_ = reader_.failed();
      queue_.push_back(std::move(chunk));  // an empty chunk ends the stream
      lock.unlock();
      cv_.notify_all();
      if (end) return;
    }
  }

  InflateReader reader_;
  IoTimers* timers_ = nullptr;
  std::thread thread_;
  mutable std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::vector<uint8_t>> queue_;
  std::vector<uint8_t> chunk_;
  size_t pos_ = 0;
  bool eof_ = false, stop_ = false, failed_ = false;
};

// the FASTQ loops' input streams (gzip or plain), inflated ahead
using ByteStream = BasicByteStream<ReadaheadInflateReader>;
using BgzfByteStream = BasicByteStream<BgzfInflateReader>;

// The BGZF block of one payload (at most kBgzfMaxPayload bytes) appended to
// out: header with BSIZE, the raw deflate stream, CRC32 and ISIZE. False
// when the compressed payload does not fit a block.
inline bool append_bgzf_block(RawDeflater& deflater, const uint8_t* data,
                              size_t len, std::vector<uint8_t>& out) {
  // a 64 KiB stored or incompressible payload grows by a few bytes of
  // deflate framing at most; a block must stay within BSIZE's 16 bits
  constexpr size_t kCap = kBgzfMaxPayload + 1024;
  size_t at = out.size();
  out.resize(at + 18 + kCap + 8);
  uint8_t* block = out.data() + at;
  size_t clen = deflater.compress(data, len, block + 18, kCap);
  if (clen == 0 || clen + 26 > 0x10000) {
    out.resize(at);
    return false;
  }
  uint32_t crc = static_cast<uint32_t>(
      crc32(0L, data, static_cast<uInt>(len)));
  uint32_t isize = static_cast<uint32_t>(len);
  uint16_t bsize = static_cast<uint16_t>(clen + 25);  // total block - 1
  const uint8_t header[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                              0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
                              static_cast<uint8_t>(bsize & 0xff),
                              static_cast<uint8_t>(bsize >> 8)};
  const uint8_t footer[8] = {
      static_cast<uint8_t>(crc & 0xff), static_cast<uint8_t>(crc >> 8),
      static_cast<uint8_t>(crc >> 16), static_cast<uint8_t>(crc >> 24),
      static_cast<uint8_t>(isize & 0xff), static_cast<uint8_t>(isize >> 8),
      static_cast<uint8_t>(isize >> 16), static_cast<uint8_t>(isize >> 24)};
  std::memcpy(block, header, 18);
  std::memcpy(block + 18 + clen, footer, 8);
  out.resize(at + 18 + clen + 8);
  return true;
}

// the spec's EOF marker block
constexpr uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00, 0x42, 0x43,
    0x02, 0x00, 0x1b, 0x00, 0x03, 0, 0, 0, 0, 0, 0, 0, 0, 0};

class BgzfWriter {
 public:
  // level 6 matches the reference's output sizing; level 1 is ~3x faster
  // for scratch outputs
  bool open(const char* path, int level = 6) {
    file_ = std::fopen(path, "wb");
    level_ = level;
    return file_ != nullptr;
  }

  void write(const uint8_t* data, size_t len) {
    while (len > 0) {
      size_t take = std::min(len, kBgzfMaxPayload - pending_.size());
      pending_.insert(pending_.end(), data, data + take);
      data += take;
      len -= take;
      if (pending_.size() >= kBgzfMaxPayload) flush_block();
    }
  }

  bool close() {
    if (!file_) return true;
    if (!pending_.empty()) flush_block();
    std::fwrite(kBgzfEof, 1, sizeof(kBgzfEof), file_);
    int rc = std::fclose(file_);
    file_ = nullptr;
    return rc == 0 && !error_;
  }

  // close WITHOUT flushing pending data or writing the EOF marker: the
  // error path. A partial output must not end in a valid EOF block, or it
  // would read as a complete (silently truncated) BAM downstream.
  void abort_close() {
    if (!file_) return;
    std::fclose(file_);
    file_ = nullptr;
    pending_.clear();
  }

  bool failed() const { return error_; }

  ~BgzfWriter() { close(); }

 private:
  void flush_block() {
    if (!deflater_) deflater_.reset(new RawDeflater(level_));
    block_.clear();
    if (!append_bgzf_block(*deflater_, pending_.data(), pending_.size(),
                           block_) ||
        std::fwrite(block_.data(), 1, block_.size(), file_) != block_.size())
      error_ = true;
    pending_.clear();
  }

  FILE* file_ = nullptr;
  std::vector<uint8_t> pending_, block_;
  bool error_ = false;
  int level_ = 6;
  std::unique_ptr<RawDeflater> deflater_;
};

// SCTOOLS_TPU_THREADS when it holds a positive integer up to 1024, else 0.
inline unsigned env_threads() {
  const char* env = std::getenv("SCTOOLS_TPU_THREADS");
  if (env && *env) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end && *end == '\0' && v > 0 && v <= 1024)
      return static_cast<unsigned>(v);
  }
  return 0;
}

// Worker-thread budget for every native pool/overlap path. The env var
// SCTOOLS_TPU_THREADS (a positive integer) overrides the hardware count, so
// the multi-core paths can be exercised, and pinned byte-identical, on a
// host with one core.
inline unsigned effective_concurrency() {
  unsigned env = env_threads();
  return env ? env : std::thread::hardware_concurrency();
}

// The threads of the FASTQ loops' pools: SCTOOLS_TPU_THREADS when set, else
// the hardware count, at most 16 (the rule of the Python side's
// default_threads(), which sizes the decoder's pool).
inline unsigned default_threads() {
  unsigned env = env_threads();
  if (env) return env;
  return std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
}

class PooledBgzfWriter;

// Compresses the full BGZF payloads of any number of PooledBgzfWriters on
// worker threads. Every writer of a pool is driven from one thread, the
// caller's: it cuts payloads, queues them and writes the finished blocks to
// their files, all in the order it queued them, so each file gets its
// blocks in order. At most 4 blocks a worker are queued or in flight, so
// memory stays flat. With one thread there is no worker: the caller
// compresses each payload as it queues it. Either way a writer writes the
// bytes a BgzfWriter at the same level writes for the same stream.
class BgzfPool {
 public:
  // timers: where the waits, the deflate and the writes go (null: nowhere)
  BgzfPool(int level, unsigned threads, IoTimers* timers = nullptr)
      : level_(level), threads_(std::max(1u, threads)), timers_(timers) {
    if (threads_ > 1)
      for (unsigned t = 0; t < threads_; ++t)
        workers_.emplace_back([this] { work(); });
    else
      inline_deflater_.reset(new RawDeflater(level_));
  }
  ~BgzfPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    work_cv_.notify_all();
    for (std::thread& t : workers_) t.join();
  }
  BgzfPool(const BgzfPool&) = delete;
  BgzfPool& operator=(const BgzfPool&) = delete;

  unsigned threads() const { return threads_; }

 private:
  friend class PooledBgzfWriter;
  struct Job {
    PooledBgzfWriter* writer;
    std::vector<uint8_t> payload, block;
    bool done = false, ok = false;
  };

  void work() {
    RawDeflater deflater(level_);
    std::unique_lock<std::mutex> lock(mu_);
    for (;;) {
      work_cv_.wait(lock, [this] { return stop_ || !todo_.empty(); });
      if (stop_) return;
      Job* job = todo_.front();
      todo_.pop_front();
      lock.unlock();
      bool ok = deflate(deflater, *job);
      lock.lock();
      job->ok = ok;
      job->done = true;
      done_cv_.notify_all();
    }
  }

  // compress a job's payload into its block, timed when timers are given
  bool deflate(RawDeflater& deflater, Job& job) {
    int64_t start = timers_ ? now_ns() : 0;
    bool ok = append_bgzf_block(deflater, job.payload.data(),
                                job.payload.size(), job.block);
    if (timers_) IoTimers::add(timers_->deflate, now_ns() - start);
    return ok;
  }

  // queue one payload of `writer`, then write what is done at the head
  inline void submit(PooledBgzfWriter* writer, std::vector<uint8_t>&& payload);
  // write (or, for `drop`, discard) every queued block, in order
  inline void drain(PooledBgzfWriter* drop);
  // wait for the head block and hand it to its writer (or discard it)
  inline void pop_front(PooledBgzfWriter* drop);

  int level_;
  unsigned threads_;
  IoTimers* timers_;
  std::unique_ptr<RawDeflater> inline_deflater_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable work_cv_, done_cv_;
  std::deque<std::unique_ptr<Job>> queued_;  // queue order, not yet written
  std::deque<Job*> todo_;                    // not yet compressed
  bool stop_ = false;
};

// A BGZF file written through a BgzfPool. Same framing, cuts and EOF
// marker as BgzfWriter; a writer dropped without close() is aborted.
class PooledBgzfWriter {
 public:
  explicit PooledBgzfWriter(BgzfPool& pool) : pool_(pool) {}
  PooledBgzfWriter(const PooledBgzfWriter&) = delete;
  PooledBgzfWriter& operator=(const PooledBgzfWriter&) = delete;

  bool open(const char* path) {
    file_ = std::fopen(path, "wb");
    return file_ != nullptr;
  }

  void write(const uint8_t* data, size_t len) {
    while (len > 0) {
      size_t take = std::min(len, kBgzfMaxPayload - pending_.size());
      pending_.insert(pending_.end(), data, data + take);
      data += take;
      len -= take;
      if (pending_.size() >= kBgzfMaxPayload) {
        pool_.submit(this, std::move(pending_));
        pending_ = std::vector<uint8_t>();
        pending_.reserve(kBgzfMaxPayload);
      }
    }
  }

  // the last partial block, every queued block, the EOF marker
  bool close() {
    if (!file_) return true;
    if (!pending_.empty()) {
      pool_.submit(this, std::move(pending_));
      pending_ = std::vector<uint8_t>();
    }
    pool_.drain(nullptr);
    if (std::fwrite(kBgzfEof, 1, sizeof(kBgzfEof), file_) != sizeof(kBgzfEof))
      error_ = true;
    int rc = std::fclose(file_);
    file_ = nullptr;
    return rc == 0 && !error_;
  }

  // the error path: drop the pending payload and the queued blocks, write
  // no EOF marker, so that a partial output never reads as complete
  void abort_close() {
    if (!file_) return;
    pool_.drain(this);
    std::fclose(file_);
    file_ = nullptr;
    pending_.clear();
  }

  bool failed() const { return error_; }

  ~PooledBgzfWriter() { abort_close(); }

 private:
  friend class BgzfPool;
  void put_block(const BgzfPool::Job& job) {
    IoTimers* timers = pool_.timers_;
    int64_t start = timers ? now_ns() : 0;
    if (!job.ok ||
        std::fwrite(job.block.data(), 1, job.block.size(), file_) !=
            job.block.size())
      error_ = true;
    if (timers) IoTimers::add(timers->write_file, now_ns() - start);
  }

  BgzfPool& pool_;
  FILE* file_ = nullptr;
  std::vector<uint8_t> pending_;
  bool error_ = false;
};

inline void BgzfPool::submit(PooledBgzfWriter* writer,
                             std::vector<uint8_t>&& payload) {
  auto job = std::make_unique<Job>();
  job->writer = writer;
  job->payload = std::move(payload);
  if (inline_deflater_) {
    job->ok = deflate(*inline_deflater_, *job);
    job->done = true;
    writer->put_block(*job);
    return;
  }
  size_t queued;
  {
    std::lock_guard<std::mutex> lock(mu_);
    todo_.push_back(job.get());
    queued_.push_back(std::move(job));
    queued = queued_.size();
  }
  work_cv_.notify_one();
  // only this thread pops queued_, so its head stays valid unlocked
  while (queued > 4 * threads_) {
    pop_front(nullptr);
    --queued;
  }
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (queued_.empty() || !queued_.front()->done) return;
    }
    pop_front(nullptr);
  }
}

inline void BgzfPool::pop_front(PooledBgzfWriter* drop) {
  std::unique_ptr<Job> job;
  {
    std::unique_lock<std::mutex> lock(mu_);
    Job* head = queued_.front().get();
    int64_t waited = timers_ && !head->done ? now_ns() : 0;
    done_cv_.wait(lock, [head] { return head->done; });
    if (waited) IoTimers::add(timers_->write_wait, now_ns() - waited);
    job = std::move(queued_.front());
    queued_.pop_front();
  }
  if (job->writer != drop) job->writer->put_block(*job);
}

inline void BgzfPool::drain(PooledBgzfWriter* drop) {
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      if (queued_.empty()) return;
    }
    pop_front(drop);
  }
}

// ---------------------------------------------------------- FASTQ helpers
// (used by fastqprocess.cpp, attach.cpp and fastqtools.cpp: one definition
// so a fix in one loop cannot miss the others)

struct Span {
  int32_t start, end;
};

// the [start, end) slices of read, concatenated; slices clamp to a short
// read, which gives a truncated value
inline std::string extract_spans(const std::string& read,
                                 const std::vector<Span>& spans) {
  std::string out;
  for (const Span& span : spans) {
    int32_t lo = std::min<int32_t>(span.start, read.size());
    int32_t hi = std::min<int32_t>(span.end, read.size());
    if (hi > lo) out.append(read, lo, hi - lo);
  }
  return out;
}

inline int span_len(const std::vector<Span>& spans) {
  int total = 0;
  for (const Span& s : spans) total += s.end - s.start;
  return total;
}

inline std::vector<Span> spans_from(const int32_t* flat, int n) {
  std::vector<Span> spans;
  for (int i = 0; i < n; ++i) spans.push_back({flat[2 * i], flat[2 * i + 1]});
  return spans;
}

// row `index` of a fixed-width buffer: value, NUL-padded to width
inline void fill_fixed(std::vector<char>& buffer, long index, int width,
                       const std::string& value) {
  std::memset(buffer.data() + index * width, 0, width);
  std::memcpy(buffer.data() + index * width, value.data(),
              std::min<size_t>(width, value.size()));
}

inline void append_z_tag(std::vector<uint8_t>& rec, const char* tag,
                         const char* value, size_t len) {
  rec.push_back(tag[0]);
  rec.push_back(tag[1]);
  rec.push_back('Z');
  rec.insert(rec.end(), value, value + len);
  rec.push_back('\0');
}

inline void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back(v & 0xff);
  out.push_back((v >> 8) & 0xff);
  out.push_back((v >> 16) & 0xff);
  out.push_back((v >> 24) & 0xff);
}

struct FastqRecord {
  std::string name, seq, qual;
};

// one 4-line record; name stripped of '@' and anything after a space
template <class Stream>
bool next_fastq(Stream& stream, FastqRecord& rec) {
  std::string plus, name_line;
  if (!stream.read_line(name_line)) return false;
  if (!stream.read_line(rec.seq)) return false;
  if (!stream.read_line(plus)) return false;
  if (!stream.read_line(rec.qual)) return false;
  size_t start = name_line.empty() ? 0 : (name_line[0] == '@' ? 1 : 0);
  size_t space = name_line.find(' ', start);
  rec.name = name_line.substr(
      start, space == std::string::npos ? std::string::npos : space - start);
  return true;
}

}  // namespace scx

#endif  // SCTOOLS_TORCH_NATIVE_IO_H_
