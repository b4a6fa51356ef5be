// Barcode attach: FASTQ decode + BAM tag-append + BGZF write, the port's
// attach loop.
//
// The port's copy of the JAX package's attach.cpp (the analog of the
// reference's fastqprocess binary, fastqpreprocessing/src/fastq_common.cpp:
// 274-414, restructured for a device in the loop): the native side streams
// R1 (+I1) fastq records and the unaligned BAM, exports each batch's raw
// barcode bytes as a fixed-width buffer, and Python runs whitelist
// correction on the card (ops/whitelist.py) before handing the corrected
// barcodes back for tag writing.
//
// Flow per batch (driven from sctools_tpu_torch/native/__init__.py):
//   scx_attach_next()   -> decode up to N fastq records, fill CR/CY/UR/UY/
//                          SR/SY buffers (spans clamp to short reads;
//                          truncated barcodes then fail correction)
//   scx_attach_write()  -> read N records from the u2 BAM, append tags
//                          (+ CB where the caller corrected), BGZF-compress
//                          into the output
//
// One change from the JAX copy: the output compresses its BGZF blocks on a
// pool of threads (native_io.h BgzfPool), with the same bytes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <vector>

#include "native_io.h"

namespace {

using scx::BgzfPool;
using scx::ByteStream;
using scx::FastqRecord;
using scx::Span;
using scx::append_z_tag;
using scx::extract_spans;
using scx::fill_fixed;
using scx::PooledBgzfWriter;
using scx::span_len;
using scx::spans_from;

// --------------------------------------------------------------- handle

struct AttachHandle {
  ByteStream r1, i1, u2;
  bool has_i1 = false;
  // the BAM at level 6, as the JAX copy writes it; the pool is declared
  // before the writer, which must go first
  BgzfPool pool{6, scx::default_threads()};
  PooledBgzfWriter out{pool};
  std::string error;

  std::vector<Span> cb_spans, umi_spans, sample_spans;
  int cb_len = 0, umi_len = 0, sample_len = 0;

  // batch buffers (fixed-width, size = n * len; short reads '\0'-padded so
  // Python sees the truncation and correction rejects it)
  std::vector<char> cr, cy, ur, uy, sr, sy;
};

// read one 4-line fastq record's sequence+quality; false at EOF
bool next_fastq(ByteStream& stream, std::string& seq, std::string& qual) {
  FastqRecord rec;
  if (!scx::next_fastq(stream, rec)) return false;
  seq = std::move(rec.seq);
  qual = std::move(rec.qual);
  return true;
}

// copy the BAM header (magic..references) from u2 to out; needs the stream
// positioned at the start
bool copy_bam_header(AttachHandle& handle) {
  uint8_t magic[4];
  if (!handle.u2.read_exact(magic, 4) || std::memcmp(magic, "BAM\1", 4) != 0) {
    handle.error = "u2 is not a BAM stream";
    return false;
  }
  handle.out.write(magic, 4);
  uint8_t len4[4];
  auto copy_sized = [&](uint32_t n) -> bool {
    std::vector<uint8_t> buf(n);
    if (n && !handle.u2.read_exact(buf.data(), n)) return false;
    handle.out.write(buf.data(), n);
    return true;
  };
  auto read_u32 = [&](uint32_t& value) -> bool {
    if (!handle.u2.read_exact(len4, 4)) return false;
    value = len4[0] | (len4[1] << 8) | (len4[2] << 16) | (uint32_t(len4[3]) << 24);
    handle.out.write(len4, 4);
    return true;
  };
  uint32_t l_text;
  if (!read_u32(l_text) || !copy_sized(l_text)) {
    handle.error = "truncated BAM header";
    return false;
  }
  uint32_t n_ref;
  if (!read_u32(n_ref)) {
    handle.error = "truncated BAM header";
    return false;
  }
  for (uint32_t i = 0; i < n_ref; ++i) {
    uint32_t l_name;
    if (!read_u32(l_name) || !copy_sized(l_name + 4)) {  // name + l_ref
      handle.error = "truncated BAM reference list";
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" {

void* scx_attach_open(const char* r1, const char* i1, const char* u2,
                      const char* out_path, const int32_t* cb_spans,
                      int n_cb_spans, const int32_t* umi_spans,
                      int n_umi_spans, const int32_t* sample_spans,
                      int n_sample_spans, char* errbuf, int errbuf_len) {
  auto handle = new AttachHandle();
  auto fail = [&](const std::string& message) -> void* {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    delete handle;
    return nullptr;
  };
  if (!handle->r1.open(r1)) return fail(std::string("cannot open ") + r1);
  if (i1 && *i1) {
    if (!handle->i1.open(i1)) return fail(std::string("cannot open ") + i1);
    handle->has_i1 = true;
  }
  if (!handle->u2.open(u2)) return fail(std::string("cannot open ") + u2);
  if (!handle->out.open(out_path))
    return fail(std::string("cannot open for write ") + out_path);
  handle->cb_spans = spans_from(cb_spans, n_cb_spans);
  handle->umi_spans = spans_from(umi_spans, n_umi_spans);
  handle->sample_spans = spans_from(sample_spans, n_sample_spans);
  handle->cb_len = span_len(handle->cb_spans);
  handle->umi_len = span_len(handle->umi_spans);
  handle->sample_len = span_len(handle->sample_spans);
  if (!copy_bam_header(*handle)) {
    // an output this call created goes with the failure
    handle->out.abort_close();
    std::remove(out_path);
    return fail(handle->error);
  }
  return handle;
}

long scx_attach_next(void* h, long max_batch) {
  auto* handle = static_cast<AttachHandle*>(h);
  handle->cr.resize(max_batch * handle->cb_len);
  handle->cy.resize(max_batch * handle->cb_len);
  handle->ur.resize(max_batch * handle->umi_len);
  handle->uy.resize(max_batch * handle->umi_len);
  handle->sr.resize(max_batch * handle->sample_len);
  handle->sy.resize(max_batch * handle->sample_len);
  long n = 0;
  std::string seq, qual, iseq, iqual;
  while (n < max_batch) {
    if (!next_fastq(handle->r1, seq, qual)) break;
    if (handle->cb_len) {
      fill_fixed(handle->cr, n, handle->cb_len,
                 extract_spans(seq, handle->cb_spans));
      fill_fixed(handle->cy, n, handle->cb_len,
                 extract_spans(qual, handle->cb_spans));
    }
    if (handle->umi_len) {
      fill_fixed(handle->ur, n, handle->umi_len,
                 extract_spans(seq, handle->umi_spans));
      fill_fixed(handle->uy, n, handle->umi_len,
                 extract_spans(qual, handle->umi_spans));
    }
    if (handle->has_i1 && handle->sample_len) {
      if (!next_fastq(handle->i1, iseq, iqual)) {
        handle->error = "i1 fastq ended before r1";
        return -1;
      }
      fill_fixed(handle->sr, n, handle->sample_len,
                 extract_spans(iseq, handle->sample_spans));
      fill_fixed(handle->sy, n, handle->sample_len,
                 extract_spans(iqual, handle->sample_spans));
    }
    ++n;
  }
  if (handle->r1.failed()) {
    handle->error = "r1 decompression failed";
    return -1;
  }
  return n;
}

const char* scx_attach_buf(void* h, const char* name) {
  auto* handle = static_cast<AttachHandle*>(h);
  std::string_view n(name);
  if (n == "cr") return handle->cr.data();
  if (n == "cy") return handle->cy.data();
  if (n == "ur") return handle->ur.data();
  if (n == "uy") return handle->uy.data();
  if (n == "sr") return handle->sr.data();
  if (n == "sy") return handle->sy.data();
  return nullptr;
}

int scx_attach_len(void* h, const char* name) {
  auto* handle = static_cast<AttachHandle*>(h);
  std::string_view n(name);
  if (n == "cb") return handle->cb_len;
  if (n == "umi") return handle->umi_len;
  if (n == "sample") return handle->sample_len;
  return -1;
}

// tag + write `n` u2 records. cb_bytes/cb_mask: corrected barcodes (may be
// null when no whitelist). Returns records written, or -1 on error.
long scx_attach_write(void* h, long n, const char* cb_bytes,
                      const uint8_t* cb_mask) {
  auto* handle = static_cast<AttachHandle*>(h);
  std::vector<uint8_t> rec;
  uint8_t len4[4];
  long written = 0;
  for (long i = 0; i < n; ++i) {
    if (!handle->u2.read_exact(len4, 4)) break;  // u2 exhausted: stop (zip semantics)
    uint32_t block_size =
        len4[0] | (len4[1] << 8) | (len4[2] << 16) | (uint32_t(len4[3]) << 24);
    // sanity-bound before allocating: corrupt length bytes would otherwise
    // raise bad_alloc across the C boundary and terminate the process
    if (block_size < 32 || block_size > (1u << 28)) {
      handle->error = "implausible u2 record size (corrupt stream?)";
      return -1;
    }
    rec.resize(block_size);
    if (block_size && !handle->u2.read_exact(rec.data(), block_size)) {
      handle->error = "truncated u2 record";
      return -1;
    }
    auto strip = [](const char* data, int width) {
      size_t len = 0;
      while (len < static_cast<size_t>(width) && data[len]) ++len;
      return std::make_pair(data, len);
    };
    if (handle->cb_len) {
      auto [crp, crl] = strip(handle->cr.data() + i * handle->cb_len, handle->cb_len);
      auto [cyp, cyl] = strip(handle->cy.data() + i * handle->cb_len, handle->cb_len);
      append_z_tag(rec, "CR", crp, crl);
      append_z_tag(rec, "CY", cyp, cyl);
      if (cb_bytes && cb_mask && cb_mask[i]) {
        append_z_tag(rec, "CB", cb_bytes + i * handle->cb_len, handle->cb_len);
      }
    }
    if (handle->umi_len) {
      auto [urp, url] = strip(handle->ur.data() + i * handle->umi_len, handle->umi_len);
      auto [uyp, uyl] = strip(handle->uy.data() + i * handle->umi_len, handle->umi_len);
      append_z_tag(rec, "UR", urp, url);
      append_z_tag(rec, "UY", uyp, uyl);
    }
    if (handle->has_i1 && handle->sample_len) {
      auto [srp, srl] = strip(handle->sr.data() + i * handle->sample_len, handle->sample_len);
      auto [syp, syl] = strip(handle->sy.data() + i * handle->sample_len, handle->sample_len);
      append_z_tag(rec, "SR", srp, srl);
      append_z_tag(rec, "SY", syp, syl);
    }
    uint32_t new_size = static_cast<uint32_t>(rec.size());
    uint8_t out4[4] = {static_cast<uint8_t>(new_size & 0xff),
                       static_cast<uint8_t>(new_size >> 8),
                       static_cast<uint8_t>(new_size >> 16),
                       static_cast<uint8_t>(new_size >> 24)};
    handle->out.write(out4, 4);
    handle->out.write(rec.data(), rec.size());
    ++written;
  }
  if (handle->out.failed()) {
    handle->error = "output write failed";
    return -1;
  }
  return written;
}

int scx_attach_close(void* h) {
  auto* handle = static_cast<AttachHandle*>(h);
  return handle->out.close() ? 0 : -1;
}

const char* scx_attach_error(void* h) {
  return static_cast<AttachHandle*>(h)->error.c_str();
}

void scx_attach_free(void* h) {
  auto* handle = static_cast<AttachHandle*>(h);
  // a handle freed without a close (the caller is raising) must not
  // finalize the output: flushing + writing the EOF marker would leave a
  // valid-looking truncated BAM on disk; the writer aborts on delete
  delete handle;
}

}  // extern "C"
