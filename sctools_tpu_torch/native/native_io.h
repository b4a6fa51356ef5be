// Shared native IO building blocks of the port's host layer: raw-deflate
// block (de)compression, streaming BGZF/gzip/plain readers, buffered record
// access, and BGZF block writing. Used by the streaming decoder
// (bamdecode.cpp) and the out-of-core tag sort (tagsort.cpp).
//
// A copy of the JAX package's native_io.h, cut to what those two files use,
// with one change: every block goes through zlib's raw-deflate calls
// (inflateInit2/deflateInit2 with window bits -15, crc32) where the JAX copy
// calls libdeflate. zlib is what both machines the port runs on provide.
// The compressed bytes may therefore differ from the JAX copy's; the
// decompressed records are the same.
//
// BGZF framing matches the spec: <=64KB payloads, BC extra field, CRC32,
// trailing EOF block.

#ifndef SCTOOLS_TORCH_NATIVE_IO_H_
#define SCTOOLS_TORCH_NATIVE_IO_H_

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

namespace scx {

constexpr size_t kBgzfMaxPayload = 0xff00;  // htslib's conventional max

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

// buffered record access on top of a pull reader
template <class Reader>
class BasicByteStream {
 public:
  bool open(const char* path) { return reader_.open(path); }

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

using BgzfByteStream = BasicByteStream<BgzfInflateReader>;

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
    // spec EOF marker block
    static const uint8_t kEof[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00, 0x42,
        0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    std::fwrite(kEof, 1, sizeof(kEof), file_);
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
    // a 64 KiB stored or incompressible payload grows by a few bytes of
    // deflate framing at most; a block must stay within BSIZE's 16 bits
    uint8_t compressed[kBgzfMaxPayload + 1024];
    if (!deflater_) deflater_.reset(new RawDeflater(level_));
    size_t clen = deflater_->compress(pending_.data(), pending_.size(),
                                      compressed, sizeof(compressed));
    if (clen == 0 || clen + 26 > 0x10000) {
      error_ = true;
      pending_.clear();
      return;
    }
    uint32_t crc = static_cast<uint32_t>(
        crc32(0L, pending_.data(), static_cast<uInt>(pending_.size())));
    uint32_t isize = static_cast<uint32_t>(pending_.size());
    uint16_t bsize = static_cast<uint16_t>(clen + 25);  // total block - 1

    uint8_t header[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                          0x06, 0x00, 0x42, 0x43, 0x02, 0x00,
                          static_cast<uint8_t>(bsize & 0xff),
                          static_cast<uint8_t>(bsize >> 8)};
    uint8_t footer[8] = {
        static_cast<uint8_t>(crc & 0xff), static_cast<uint8_t>(crc >> 8),
        static_cast<uint8_t>(crc >> 16), static_cast<uint8_t>(crc >> 24),
        static_cast<uint8_t>(isize & 0xff), static_cast<uint8_t>(isize >> 8),
        static_cast<uint8_t>(isize >> 16), static_cast<uint8_t>(isize >> 24)};
    if (std::fwrite(header, 1, 18, file_) != 18 ||
        std::fwrite(compressed, 1, clen, file_) != clen ||
        std::fwrite(footer, 1, 8, file_) != 8)
      error_ = true;
    pending_.clear();
  }

  FILE* file_ = nullptr;
  std::vector<uint8_t> pending_;
  bool error_ = false;
  int level_ = 6;
  std::unique_ptr<RawDeflater> deflater_;
};

// Worker-thread budget for every native pool/overlap path. The env var
// SCTOOLS_TPU_THREADS (a positive integer) overrides the hardware count, so
// the multi-core paths can be exercised, and pinned byte-identical, on a
// host with one core.
inline unsigned effective_concurrency() {
  const char* env = std::getenv("SCTOOLS_TPU_THREADS");
  if (env && *env) {
    char* end = nullptr;
    long v = std::strtol(env, &end, 10);
    if (end && *end == '\0' && v > 0 && v <= 1024)
      return static_cast<unsigned>(v);
  }
  return std::thread::hardware_concurrency();
}

}  // namespace scx

#endif  // SCTOOLS_TORCH_NATIVE_IO_H_
