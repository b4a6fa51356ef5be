// FASTQ triplets -> N disjoint-barcode shards: the port's FastqProcess loop.
//
// The port's copy of the JAX package's fastqprocess.cpp (the scatter stage
// of the reference's fastqprocess binary, fastqpreprocessing/src/
// fastq_common.cpp:274-414): read (I1, R1, R2) fastq triplets, extract
// barcode/UMI spans from R1 (sample from I1), and route each record to
// output shard fnv1a(corrected-or-raw barcode) % n_shards, so a cell never
// spans shards while uncorrectable barcodes spread uniformly. Outputs are
// either unaligned tagged BAM shards (flag 4, CR/CY/UR/UY/SR/SY + CB when
// corrected) or per-shard R1/R2 fastq.gz pairs (R1 = CR+UR / CY+UY, R2 =
// the read).
//
// Correction happens outside this file: each batch exports its fixed-width
// CR buffer, Python runs the whitelist kernel (ops/whitelist.py) and hands
// the corrected barcodes back to scx_fqp_write.
//
// Three changes from the JAX copy: the shards compress their BGZF blocks on
// one pool of threads (native_io.h BgzfPool), the 10M-read progress line is
// printed by the Python caller, which counts the same reads, and the handle
// keeps where its IO time goes (scx_fqp_timers).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
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
using scx::next_fastq;
using scx::PooledBgzfWriter;
using scx::put_u32;
using scx::span_len;
using scx::spans_from;

// FNV-1a: stable across builds (std::hash is implementation-defined; only
// the disjointness invariant matters, not the exact assignment)
inline uint64_t fnv1a(const char* data, size_t len) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= 1099511628211ull;
  }
  return h;
}

// 4-bit base codes for BAM seq encoding ("=ACMGRSVTWYHKDBN")
inline uint8_t seq_nibble(char c) {
  switch (c) {
    case 'A': case 'a': return 1;
    case 'C': case 'c': return 2;
    case 'G': case 'g': return 4;
    case 'T': case 't': return 8;
    case '=': return 0;
    default: return 15;  // N / anything else
  }
}


struct Handle {
  // first, so that the streams and the pool, whose threads add to it, go
  // before it
  scx::IoTimers timers;
  std::vector<std::string> i1s, r1s, r2s;
  size_t triplet = 0;
  std::unique_ptr<ByteStream> i1, r1, r2;
  bool has_i1 = false;

  std::vector<Span> cb_spans, umi_spans, sample_spans;
  int cb_len = 0, umi_len = 0, sample_len = 0;

  bool fastq_mode = false;
  // declared before the writers, which must go first
  std::unique_ptr<BgzfPool> pool;
  std::vector<std::unique_ptr<PooledBgzfWriter>> bam_out;       // BAM mode
  std::vector<std::unique_ptr<PooledBgzfWriter>> fq_r1, fq_r2;  // FASTQ mode
  std::vector<std::string> created_paths;

  // batch state
  std::vector<char> cr, cy, ur, uy, sr, sy;
  std::vector<FastqRecord> batch;  // R2 reads of the current batch

  // counters (fastq_common.cpp:356-359)
  long total_reads = 0, n_correct = 0, n_corrected = 0, n_uncorrectable = 0;
  std::string error;
};

bool open_triplet(Handle& h) {
  h.r1 = std::make_unique<ByteStream>();
  h.r2 = std::make_unique<ByteStream>();
  h.r1->reader().set_timers(&h.timers);
  h.r2->reader().set_timers(&h.timers);
  if (!h.r1->open(h.r1s[h.triplet].c_str())) {
    h.error = "cannot open " + h.r1s[h.triplet];
    return false;
  }
  if (!h.r2->open(h.r2s[h.triplet].c_str())) {
    h.error = "cannot open " + h.r2s[h.triplet];
    return false;
  }
  if (h.has_i1) {
    h.i1 = std::make_unique<ByteStream>();
    h.i1->reader().set_timers(&h.timers);
    if (!h.i1->open(h.i1s[h.triplet].c_str())) {
      h.error = "cannot open " + h.i1s[h.triplet];
      return false;
    }
  }
  return true;
}


// minimal unaligned-BAM header: @HD + @RG with the sample id, no references
// (reference bamWriterThread header, fastq_common.cpp:150-171)
void write_bam_header(PooledBgzfWriter& out, const std::string& sample_id) {
  std::string text = "@HD\tVN:1.6\tSO:unsorted\n@RG\tID:A\tSM:" + sample_id +
                     "\n";
  std::vector<uint8_t> header;
  header.insert(header.end(), {'B', 'A', 'M', 1});
  put_u32(header, static_cast<uint32_t>(text.size()));
  header.insert(header.end(), text.begin(), text.end());
  put_u32(header, 0);  // n_ref
  out.write(header.data(), header.size());
}

// unaligned record from an R2 read + tag values (fillSamRecordCommon:
// flag 4, no coordinates; fastq_common.cpp:186-213)
void build_bam_record(std::vector<uint8_t>& rec, const FastqRecord& read) {
  rec.clear();
  uint32_t l_read_name = static_cast<uint32_t>(read.name.size()) + 1;
  uint32_t l_seq = static_cast<uint32_t>(read.seq.size());
  put_u32(rec, 0xffffffffu);  // refID -1
  put_u32(rec, 0xffffffffu);  // pos -1
  rec.push_back(static_cast<uint8_t>(l_read_name));
  rec.push_back(0);                    // mapq
  rec.push_back(0x48); rec.push_back(0x12);  // bin 4680 (unmapped)
  rec.push_back(0); rec.push_back(0);  // n_cigar 0
  rec.push_back(0x04); rec.push_back(0x00);  // flag 4 (unmapped)
  put_u32(rec, l_seq);
  put_u32(rec, 0xffffffffu);  // next_refID -1
  put_u32(rec, 0xffffffffu);  // next_pos -1
  put_u32(rec, 0);            // tlen
  rec.insert(rec.end(), read.name.begin(), read.name.end());
  rec.push_back('\0');
  for (uint32_t i = 0; i < l_seq; i += 2) {
    uint8_t hi = seq_nibble(read.seq[i]);
    uint8_t lo = (i + 1 < l_seq) ? seq_nibble(read.seq[i + 1]) : 0;
    rec.push_back((hi << 4) | lo);
  }
  for (uint32_t i = 0; i < l_seq; ++i) {
    char q = i < read.qual.size() ? read.qual[i] : '!';
    rec.push_back(static_cast<uint8_t>(q - 33));
  }
}

void write_fastq_gz(PooledBgzfWriter& out, const std::string& name,
                    std::string_view seq, std::string_view qual) {
  std::string block;
  block.reserve(name.size() + seq.size() + qual.size() + 8);
  block += '@';
  block += name;
  block += '\n';
  block.append(seq.data(), seq.size());
  block += "\n+\n";
  block.append(qual.data(), qual.size());
  block += '\n';
  out.write(reinterpret_cast<const uint8_t*>(block.data()), block.size());
}

}  // namespace

extern "C" {

// paths are '\n'-joined lists (one per triplet); i1_paths may be empty.
// output_format: 0 = BAM shards (<prefix>_<i>.bam), 1 = fastq shard pairs
// (<prefix>_R1_<i>.fastq.gz / <prefix>_R2_<i>.fastq.gz). The shards share
// one pool of default_threads() compressing at compress_level.
void* scx_fqp_open(const char* r1_paths, const char* i1_paths,
                   const char* r2_paths, const char* out_prefix, int n_shards,
                   int output_format, const char* sample_id,
                   const int32_t* cb_spans, int n_cb,
                   const int32_t* umi_spans, int n_umi,
                   const int32_t* sample_spans, int n_sample,
                   int compress_level, char* errbuf, int errbuf_len) {
  auto handle = std::make_unique<Handle>();
  auto fail = [&](const std::string& message) -> void* {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    // already-opened shard writers must not survive as complete-looking
    // (header + EOF block) empty outputs: abort them and unlink
    for (auto& w : handle->bam_out) w->abort_close();
    for (auto& w : handle->fq_r1) w->abort_close();
    for (auto& w : handle->fq_r2) w->abort_close();
    for (const std::string& path : handle->created_paths)
      std::remove(path.c_str());
    return nullptr;
  };
  auto split = [](const char* joined, std::vector<std::string>& out) {
    if (!joined || !*joined) return;
    std::string_view view(joined);
    size_t pos = 0;
    while (pos <= view.size()) {
      size_t nl = view.find('\n', pos);
      if (nl == std::string_view::npos) nl = view.size();
      if (nl > pos) out.emplace_back(view.substr(pos, nl - pos));
      pos = nl + 1;
    }
  };
  split(r1_paths, handle->r1s);
  split(i1_paths, handle->i1s);
  split(r2_paths, handle->r2s);
  if (handle->r1s.empty() || handle->r1s.size() != handle->r2s.size())
    return fail("need equal non-empty R1/R2 path lists");
  if (!handle->i1s.empty() && handle->i1s.size() != handle->r1s.size())
    return fail("I1 list must be empty or match R1 list length");
  handle->has_i1 = !handle->i1s.empty();
  if (n_shards < 1) return fail("n_shards must be >= 1");

  handle->cb_spans = spans_from(cb_spans, n_cb);
  handle->umi_spans = spans_from(umi_spans, n_umi);
  handle->sample_spans = spans_from(sample_spans, n_sample);
  handle->cb_len = span_len(handle->cb_spans);
  handle->umi_len = span_len(handle->umi_spans);
  handle->sample_len = span_len(handle->sample_spans);

  handle->fastq_mode = output_format == 1;
  handle->pool = std::make_unique<BgzfPool>(
      compress_level, scx::default_threads(), &handle->timers);
  std::string prefix(out_prefix);
  for (int i = 0; i < n_shards; ++i) {
    if (handle->fastq_mode) {
      auto r1w = std::make_unique<PooledBgzfWriter>(*handle->pool);
      auto r2w = std::make_unique<PooledBgzfWriter>(*handle->pool);
      std::string p1 = prefix + "_R1_" + std::to_string(i) + ".fastq.gz";
      std::string p2 = prefix + "_R2_" + std::to_string(i) + ".fastq.gz";
      if (!r1w->open(p1.c_str()))
        return fail("cannot open for write " + p1);
      handle->created_paths.push_back(p1);
      if (!r2w->open(p2.c_str()))
        return fail("cannot open for write " + p2);
      handle->created_paths.push_back(p2);
      handle->fq_r1.push_back(std::move(r1w));
      handle->fq_r2.push_back(std::move(r2w));
    } else {
      auto w = std::make_unique<PooledBgzfWriter>(*handle->pool);
      std::string p = prefix + "_" + std::to_string(i) + ".bam";
      if (!w->open(p.c_str()))
        return fail("cannot open for write " + p);
      handle->created_paths.push_back(p);
      write_bam_header(*w, sample_id ? sample_id : "");
      handle->bam_out.push_back(std::move(w));
    }
  }
  if (!open_triplet(*handle)) return fail(handle->error);
  return handle.release();
}

// decode up to max_batch records (advancing through triplets); fills the
// fixed-width barcode buffers and keeps R2 reads for the write step
long scx_fqp_next(void* h, long max_batch) {
  auto* handle = static_cast<Handle*>(h);
  handle->cr.resize(max_batch * handle->cb_len);
  handle->cy.resize(max_batch * handle->cb_len);
  handle->ur.resize(max_batch * handle->umi_len);
  handle->uy.resize(max_batch * handle->umi_len);
  handle->sr.resize(max_batch * handle->sample_len);
  handle->sy.resize(max_batch * handle->sample_len);
  handle->batch.clear();
  handle->batch.reserve(max_batch);
  FastqRecord r1_rec, i1_rec;
  long n = 0;
  while (n < max_batch) {
    if (!next_fastq(*handle->r1, r1_rec)) {
      if (handle->r1->failed()) {
        handle->error = "r1 decompression failed";
        return -1;
      }
      // a truncated R1 must not silently drop R2's tail (the converse of
      // the r2-ended-early error below)
      FastqRecord extra;
      if (next_fastq(*handle->r2, extra)) {
        handle->error = "r1 fastq ended before r2";
        return -1;
      }
      // triplet exhausted: advance to the next one
      if (handle->triplet + 1 >= handle->r1s.size()) break;
      ++handle->triplet;
      if (!open_triplet(*handle)) return -1;
      continue;
    }
    FastqRecord r2_rec;
    if (!next_fastq(*handle->r2, r2_rec)) {
      handle->error = "r2 fastq ended before r1";
      return -1;
    }
    if (r2_rec.name.size() > 254) {
      // l_read_name is a single byte in BAM; a longer name would wrap the
      // cast and corrupt the record layout
      handle->error = "read name longer than 254 characters: " + r2_rec.name;
      return -1;
    }
    if (handle->cb_len) {
      fill_fixed(handle->cr, n, handle->cb_len,
                 extract_spans(r1_rec.seq, handle->cb_spans));
      fill_fixed(handle->cy, n, handle->cb_len,
                 extract_spans(r1_rec.qual, handle->cb_spans));
    }
    if (handle->umi_len) {
      fill_fixed(handle->ur, n, handle->umi_len,
                 extract_spans(r1_rec.seq, handle->umi_spans));
      fill_fixed(handle->uy, n, handle->umi_len,
                 extract_spans(r1_rec.qual, handle->umi_spans));
    }
    if (handle->has_i1 && handle->sample_len) {
      if (!next_fastq(*handle->i1, i1_rec)) {
        handle->error = "i1 fastq ended before r1";
        return -1;
      }
      fill_fixed(handle->sr, n, handle->sample_len,
                 extract_spans(i1_rec.seq, handle->sample_spans));
      fill_fixed(handle->sy, n, handle->sample_len,
                 extract_spans(i1_rec.qual, handle->sample_spans));
    }
    handle->batch.push_back(std::move(r2_rec));
    ++n;
  }
  return n;
}

const char* scx_fqp_buf(void* h, const char* name) {
  auto* handle = static_cast<Handle*>(h);
  std::string_view n(name);
  if (n == "cr") return handle->cr.data();
  if (n == "cy") return handle->cy.data();
  return nullptr;
}

int scx_fqp_len(void* h, const char* name) {
  auto* handle = static_cast<Handle*>(h);
  std::string_view n(name);
  if (n == "cb") return handle->cb_len;
  if (n == "umi") return handle->umi_len;
  if (n == "sample") return handle->sample_len;
  return -1;
}

// route + write the current batch. cb_bytes/cb_mask: corrected barcodes
// (null = no whitelist; every record then keeps only raw tags and buckets
// by raw barcode). Returns records written, -1 on error.
long scx_fqp_write(void* h, long n, const char* cb_bytes,
                   const uint8_t* cb_mask) {
  auto* handle = static_cast<Handle*>(h);
  if (n > static_cast<long>(handle->batch.size())) {
    handle->error = "write batch larger than decoded batch";
    return -1;
  }
  int n_shards = static_cast<int>(
      handle->fastq_mode ? handle->fq_r1.size() : handle->bam_out.size());
  std::vector<uint8_t> rec;
  auto strip = [](const char* data, int width) {
    size_t len = 0;
    while (len < static_cast<size_t>(width) && data[len]) ++len;
    return std::string_view(data, len);
  };
  for (long i = 0; i < n; ++i) {
    const FastqRecord& read = handle->batch[i];
    std::string_view cr = strip(handle->cr.data() + i * handle->cb_len,
                                handle->cb_len);
    std::string_view cy = strip(handle->cy.data() + i * handle->cb_len,
                                handle->cb_len);
    std::string_view ur = strip(handle->ur.data() + i * handle->umi_len,
                                handle->umi_len);
    std::string_view uy = strip(handle->uy.data() + i * handle->umi_len,
                                handle->umi_len);
    bool corrected = cb_bytes && cb_mask && cb_mask[i];
    std::string_view cb =
        corrected ? std::string_view(cb_bytes + i * handle->cb_len,
                                     handle->cb_len)
                  : std::string_view();
    if (cb_bytes || cb_mask) {
      if (corrected) {
        if (cb == cr)
          ++handle->n_correct;
        else
          ++handle->n_corrected;
      } else {
        ++handle->n_uncorrectable;
      }
    }
    // bucket by the corrected barcode when available, raw otherwise, so
    // uncorrectable reads spread uniformly (fastq_common.cpp:222-257)
    std::string_view bucket_key = corrected ? cb : cr;
    int shard = static_cast<int>(
        fnv1a(bucket_key.data(), bucket_key.size()) % n_shards);

    if (handle->fastq_mode) {
      // R1 = barcode+umi reconstruction, R2 = the read
      // (writeFastqRecord, fastq_common.cpp:115-121)
      std::string r1_seq(cr);
      r1_seq.append(ur.data(), ur.size());
      std::string r1_qual(cy);
      r1_qual.append(uy.data(), uy.size());
      write_fastq_gz(*handle->fq_r1[shard], read.name, r1_seq, r1_qual);
      write_fastq_gz(*handle->fq_r2[shard], read.name, read.seq, read.qual);
      if (handle->fq_r1[shard]->failed() || handle->fq_r2[shard]->failed()) {
        handle->error = "fastq shard write failed";
        return -1;
      }
    } else {
      build_bam_record(rec, read);
      if (handle->cb_len) {
        append_z_tag(rec, "CR", cr.data(), cr.size());
        append_z_tag(rec, "CY", cy.data(), cy.size());
        if (corrected) append_z_tag(rec, "CB", cb.data(), cb.size());
      }
      if (handle->umi_len) {
        append_z_tag(rec, "UR", ur.data(), ur.size());
        append_z_tag(rec, "UY", uy.data(), uy.size());
      }
      if (handle->has_i1 && handle->sample_len) {
        std::string_view sr = strip(
            handle->sr.data() + i * handle->sample_len, handle->sample_len);
        std::string_view sy = strip(
            handle->sy.data() + i * handle->sample_len, handle->sample_len);
        append_z_tag(rec, "SR", sr.data(), sr.size());
        append_z_tag(rec, "SY", sy.data(), sy.size());
      }
      uint8_t len4[4] = {
          static_cast<uint8_t>(rec.size() & 0xff),
          static_cast<uint8_t>((rec.size() >> 8) & 0xff),
          static_cast<uint8_t>((rec.size() >> 16) & 0xff),
          static_cast<uint8_t>((rec.size() >> 24) & 0xff)};
      handle->bam_out[shard]->write(len4, 4);
      handle->bam_out[shard]->write(rec.data(), rec.size());
      if (handle->bam_out[shard]->failed()) {
        handle->error = "bam shard write failed";
        return -1;
      }
    }
    ++handle->total_reads;
  }
  return n;
}

// counters: [total, correct, corrected, uncorrectable]
void scx_fqp_stats(void* h, long* out4) {
  auto* handle = static_cast<Handle*>(h);
  out4[0] = handle->total_reads;
  out4[1] = handle->n_correct;
  out4[2] = handle->n_corrected;
  out4[3] = handle->n_uncorrectable;
}

// where the handle's IO time went so far, up to n values: seconds of
// [read.wait, inflate, write.wait, write.file, deflate]. Returns the number
// of values the handle has (5).
int scx_fqp_timers(void* h, double* out, int n) {
  const scx::IoTimers& t = static_cast<Handle*>(h)->timers;
  const double values[5] = {
      t.read_wait.load() * 1e-9, t.inflate.load() * 1e-9,
      t.write_wait.load() * 1e-9, t.write_file.load() * 1e-9,
      t.deflate.load() * 1e-9};
  for (int i = 0; i < n && i < 5; ++i) out[i] = values[i];
  return 5;
}

int scx_fqp_close(void* h) {
  auto* handle = static_cast<Handle*>(h);
  bool ok = true;
  for (auto& w : handle->bam_out) ok = w->close() && ok;
  for (auto& w : handle->fq_r1) ok = w->close() && ok;
  for (auto& w : handle->fq_r2) ok = w->close() && ok;
  return ok ? 0 : -1;
}

const char* scx_fqp_error(void* h) {
  return static_cast<Handle*>(h)->error.c_str();
}

// a handle freed without a close (the caller is raising) leaves no shard
// that reads as complete: its writers abort on delete
void scx_fqp_free(void* h) { delete static_cast<Handle*>(h); }

// the threads of the FASTQ loops' pools (native_io.h default_threads())
int scx_pool_threads() { return static_cast<int>(scx::default_threads()); }

}  // extern "C"
