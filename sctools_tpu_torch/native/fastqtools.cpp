// FastqMetrics' scan and SampleFastq's loop: the port's copies of the JAX
// package's fastqtools.cpp.
//
// fastq_metrics (scx_fqm): the reference's per-shard parallel R1 scan
// (fastqpreprocessing/src/fastq_metrics.cpp:174-209): barcode/UMI
// read-count tables plus per-position base-composition matrices, one
// worker thread per shard (at most default_threads()), shard accumulators
// folded in file order. Count rows sort by count descending with ties in
// first-appearance order, PWM rows are 1-based tab-separated.
//
// samplefastq (scx_sfq): the reference's whitelist downsampler
// (samplefastq.cpp:85-103) shaped like fastqprocess: native IO reads R1/R2
// batches and exposes the fixed-width cell-barcode buffer; the caller runs
// the whitelist kernel and hands back a keep mask; kept reads re-emit with
// the fixed slide-seq R1 rewrite (barcode[0:8] + linker + barcode[8:] + UMI
// + 'T').
//
// One change from the JAX copy: scx_sfq_write slices a barcode quality
// shorter than its barcode where the JAX copy reads past its end.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

#include "native_io.h"

namespace {

using scx::ByteStream;
using scx::FastqRecord;
using scx::Span;
using scx::extract_spans;
using scx::next_fastq;
using scx::span_len;
using scx::spans_from;

std::vector<std::string> split_lines(const char* joined) {
  std::vector<std::string> out;
  std::string_view view(joined ? joined : "");
  while (!view.empty()) {
    size_t cut = view.find('\n');
    out.emplace_back(view.substr(0, cut));
    if (cut == std::string_view::npos) break;
    view.remove_prefix(cut + 1);
  }
  return out;
}

// ------------------------------------------------------------ fastq_metrics

// base row (A=0 C=1 G=2 T=3 N=4), case-insensitive; anything else = 5
// (excluded from every column, like the Python _CODE_LUT)
inline int base_row(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    case 'N': case 'n': return 4;
    default: return 5;
  }
}

// count table preserving first-appearance order (the tie order of the
// Python oracle's stable sort). Open addressing over the entries' indices,
// with each entry's hash kept beside it: one probe sequence per read and no
// node per key, where a node-based map spent most of the scan on cache
// misses.
struct CountTable {
  std::vector<std::pair<std::string, long>> entries;  // appearance order
  std::vector<uint64_t> hashes;                       // of each entry's key
  std::vector<uint32_t> slots;  // entry index + 1; 0 = empty

  static uint64_t hash(const std::string& seq) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (unsigned char c : seq) h = (h ^ c) * 1099511628211ull;
    return h ^ (h >> 29);
  }

  void add(const std::string& seq, long count = 1) {
    if (2 * (entries.size() + 1) > slots.size()) grow();
    uint64_t h = hash(seq);
    size_t mask = slots.size() - 1;
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      uint32_t slot = slots[i];
      if (slot == 0) {
        slots[i] = static_cast<uint32_t>(entries.size() + 1);
        entries.emplace_back(seq, count);
        hashes.push_back(h);
        return;
      }
      if (hashes[slot - 1] == h && entries[slot - 1].first == seq) {
        entries[slot - 1].second += count;
        return;
      }
    }
  }

  void fold(const CountTable& other) {
    for (const auto& [seq, count] : other.entries) add(seq, count);
  }

 private:
  void grow() {
    slots.assign(std::max<size_t>(1024, 2 * slots.size()), 0);
    size_t mask = slots.size() - 1;
    for (size_t e = 0; e < entries.size(); ++e) {
      size_t i = hashes[e] & mask;
      while (slots[i] != 0) i = (i + 1) & mask;
      slots[i] = static_cast<uint32_t>(e + 1);
    }
  }
};

struct FqmShard {
  CountTable barcodes, umis;
  std::vector<long> barcode_pwm, umi_pwm;  // [len x 5]
  long n_reads = 0;
  std::string error;
  bool validation_error = false;  // scx_fqm returns -2: caller contract
};

void pwm_add(std::vector<long>& pwm, const std::string& seq) {
  for (size_t i = 0; i < seq.size(); ++i) {
    int row = base_row(seq[i]);
    if (row < 5) pwm[i * 5 + row] += 1;
  }
}

bool scan_shard(const std::string& path, const std::vector<Span>& cb_spans,
                const std::vector<Span>& umi_spans, int min_length,
                FqmShard& shard) {
  ByteStream in;
  if (!in.open(path.c_str())) {
    shard.error = "cannot open " + path;
    return false;
  }
  FastqRecord rec;
  while (next_fastq(in, rec)) {
    if (static_cast<int>(rec.seq.size()) < min_length) {
      shard.error = path + ": read of length " +
                    std::to_string(rec.seq.size()) +
                    " is shorter than read structure (needs " +
                    std::to_string(min_length) + ")";
      shard.validation_error = true;
      return false;
    }
    std::string barcode = extract_spans(rec.seq, cb_spans);
    std::string umi = extract_spans(rec.seq, umi_spans);
    shard.barcodes.add(barcode);
    shard.umis.add(umi);
    pwm_add(shard.barcode_pwm, barcode);
    pwm_add(shard.umi_pwm, umi);
    shard.n_reads += 1;
  }
  if (in.failed()) {
    shard.error = "truncated or corrupt fastq: " + path;
    return false;
  }
  return true;
}

bool write_counts(const CountTable& table, const std::string& path) {
  // count desc, ties by first appearance: sort appearance-ordered entry
  // indexes stably by count
  std::vector<size_t> order(table.entries.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return table.entries[a].second > table.entries[b].second;
  });
  FILE* out = std::fopen(path.c_str(), "wb");
  if (!out) return false;
  for (size_t i : order) {
    const auto& [seq, count] = table.entries[i];
    std::fprintf(out, "%ld\t%s\n", count, seq.c_str());
  }
  // an intermediate buffered flush can fail while the final fclose still
  // succeeds; ferror catches the truncation
  bool ok = std::ferror(out) == 0;
  return std::fclose(out) == 0 && ok;
}

bool write_pwm(const std::vector<long>& pwm, int length,
               const std::string& path) {
  FILE* out = std::fopen(path.c_str(), "wb");
  if (!out) return false;
  std::fprintf(out, "position\tA\tC\tG\tT\tN\n");
  for (int i = 0; i < length; ++i) {
    std::fprintf(out, "%d\t%ld\t%ld\t%ld\t%ld\t%ld\n", i + 1,
                 pwm[i * 5 + 0], pwm[i * 5 + 1], pwm[i * 5 + 2],
                 pwm[i * 5 + 3], pwm[i * 5 + 4]);
  }
  bool ok = std::ferror(out) == 0;
  return std::fclose(out) == 0 && ok;
}

// --------------------------------------------------------------- samplefastq

constexpr const char kLinker[] = "CTTCAGCGTTCCCGAGAG";  // samplefastq.cpp:94
constexpr size_t kLinkerLen = sizeof(kLinker) - 1;

struct SfqHandle {
  std::vector<std::string> r1s, r2s;
  size_t r1_index = 0, r2_index = 0;
  std::unique_ptr<ByteStream> r1, r2;

  std::vector<Span> cb_spans, umi_spans;
  int cb_len = 0;

  FILE* out_r1 = nullptr;
  FILE* out_r2 = nullptr;
  std::string path_r1, path_r2;

  // batch state
  std::vector<char> cr;  // fixed-width barcode buffer for the corrector
  struct Pending {
    std::string name, barcode, barcode_qual, umi, umi_qual;
    std::string r2_name, r2_seq, r2_qual;
  };
  std::vector<Pending> batch;

  long total = 0, kept = 0;
  std::string error;
};

// pull the next record from a concatenated multi-file stream (the Python
// oracle zips two concatenated Readers, not per-file pairs)
bool next_from(std::vector<std::string>& paths, size_t& index,
               std::unique_ptr<ByteStream>& stream, FastqRecord& rec,
               std::string& error, bool& got) {
  got = false;
  for (;;) {
    if (!stream) {
      if (index >= paths.size()) return true;  // clean end
      stream = std::make_unique<ByteStream>();
      if (!stream->open(paths[index].c_str())) {
        error = "cannot open " + paths[index];
        return false;
      }
    }
    if (next_fastq(*stream, rec)) {
      got = true;
      return true;
    }
    if (stream->failed()) {
      error = "truncated or corrupt fastq: " + paths[index];
      return false;
    }
    stream.reset();
    ++index;
  }
}

}  // namespace

extern "C" {

// ---- fastq_metrics ----

// Scan R1 shards (newline-joined paths) into the four output files.
// Returns reads processed, -1 on IO/format error, -2 on input validation
// failure (short read) — a structural code, so the Python wrapper maps it
// to the oracle's ValueError without parsing message text.
long scx_fqm(const char* r1_paths, const int32_t* cb_spans_flat, int n_cb,
             const int32_t* umi_spans_flat, int n_umi, int min_length,
             const char* output_prefix, int n_threads, char* errbuf,
             int errbuf_len) {
  auto fail = [&](const std::string& message) -> long {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    return -1;
  };
  std::vector<std::string> files = split_lines(r1_paths);
  if (files.empty()) return fail("no input files");
  std::vector<Span> cb_spans = spans_from(cb_spans_flat, n_cb);
  std::vector<Span> umi_spans = spans_from(umi_spans_flat, n_umi);
  int cb_len = span_len(cb_spans);
  int umi_len = span_len(umi_spans);

  std::vector<FqmShard> shards(files.size());
  for (FqmShard& shard : shards) {
    shard.barcode_pwm.assign(static_cast<size_t>(cb_len) * 5, 0);
    shard.umi_pwm.assign(static_cast<size_t>(umi_len) * 5, 0);
  }
  // one worker per shard, capped (the reference spawns a thread per shard,
  // fastq_metrics.cpp:174-209, bounded by its global thread cap)
  int workers = std::min<int>(
      static_cast<int>(files.size()),
      n_threads > 0 ? n_threads : static_cast<int>(scx::default_threads()));
  std::atomic<size_t> next{0};
  auto work = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= files.size()) break;
      scan_shard(files[i], cb_spans, umi_spans, min_length, shards[i]);
    }
  };
  if (workers == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (std::thread& t : pool) t.join();
  }
  for (FqmShard& shard : shards)
    if (!shard.error.empty()) {
      fail(shard.error);
      return shard.validation_error ? -2 : -1;
    }

  // fold in FILE order, so tie order == the sequential first-appearance
  // order of the Python oracle
  FqmShard& total = shards[0];
  for (size_t i = 1; i < shards.size(); ++i) {
    total.barcodes.fold(shards[i].barcodes);
    total.umis.fold(shards[i].umis);
    for (size_t j = 0; j < total.barcode_pwm.size(); ++j)
      total.barcode_pwm[j] += shards[i].barcode_pwm[j];
    for (size_t j = 0; j < total.umi_pwm.size(); ++j)
      total.umi_pwm[j] += shards[i].umi_pwm[j];
    total.n_reads += shards[i].n_reads;
  }

  std::string prefix(output_prefix);
  // the reference's exact output names (fastq_metrics.cpp:232-242),
  // including the historical numReads_perCell_XM name for the UMI table
  if (!write_counts(total.umis, prefix + ".numReads_perCell_XM.txt") ||
      !write_counts(total.barcodes, prefix + ".numReads_perCell_XC.txt") ||
      !write_pwm(total.barcode_pwm, cb_len,
                 prefix + ".barcode_distribution_XC.txt") ||
      !write_pwm(total.umi_pwm, umi_len,
                 prefix + ".barcode_distribution_XM.txt"))
    return fail("cannot write outputs");
  return total.n_reads;
}

// ---- samplefastq ----

void* scx_sfq_open(const char* r1_paths, const char* r2_paths,
                   const int32_t* cb_spans_flat, int n_cb,
                   const int32_t* umi_spans_flat, int n_umi,
                   const char* output_prefix, char* errbuf, int errbuf_len) {
  auto fail = [&](const std::string& message) -> void* {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "%s", message.c_str());
    return nullptr;
  };
  auto handle = std::make_unique<SfqHandle>();
  handle->r1s = split_lines(r1_paths);
  handle->r2s = split_lines(r2_paths);
  if (handle->r1s.empty() || handle->r2s.empty())
    return fail("need R1 and R2 inputs");
  handle->cb_spans = spans_from(cb_spans_flat, n_cb);
  handle->umi_spans = spans_from(umi_spans_flat, n_umi);
  handle->cb_len = span_len(handle->cb_spans);
  handle->path_r1 = std::string(output_prefix) + ".R1";
  handle->path_r2 = std::string(output_prefix) + ".R2";
  handle->out_r1 = std::fopen(handle->path_r1.c_str(), "wb");
  handle->out_r2 = std::fopen(handle->path_r2.c_str(), "wb");
  if (!handle->out_r1 || !handle->out_r2) {
    if (handle->out_r1) std::fclose(handle->out_r1);
    if (handle->out_r2) std::fclose(handle->out_r2);
    handle->out_r1 = handle->out_r2 = nullptr;
    std::remove(handle->path_r1.c_str());
    std::remove(handle->path_r2.c_str());
    return fail("cannot open outputs under " + std::string(output_prefix));
  }
  return handle.release();
}

// Read up to max_batch read pairs; returns the batch size, 0 at EOF, -1 on
// IO error, -2 on an R1/R2 length mismatch (the strict-zip contract,
// mapped to ValueError by the wrapper).
long scx_sfq_next(void* h, long max_batch) {
  SfqHandle& handle = *static_cast<SfqHandle*>(h);
  handle.batch.clear();
  handle.cr.assign(static_cast<size_t>(max_batch) * handle.cb_len, 0);
  FastqRecord r1, r2;
  while (static_cast<long>(handle.batch.size()) < max_batch) {
    bool got1 = false, got2 = false;
    if (!next_from(handle.r1s, handle.r1_index, handle.r1, r1, handle.error,
                   got1))
      return -1;
    if (!next_from(handle.r2s, handle.r2_index, handle.r2, r2, handle.error,
                   got2))
      return -1;
    if (got1 != got2) {
      handle.error = "R1 and R2 hold different read counts";
      return -2;  // validation code: the wrapper raises ValueError
    }
    if (!got1) break;
    SfqHandle::Pending pending;
    pending.name = r1.name;
    pending.barcode = extract_spans(r1.seq, handle.cb_spans);
    pending.barcode_qual = extract_spans(r1.qual, handle.cb_spans);
    pending.umi = extract_spans(r1.seq, handle.umi_spans);
    pending.umi_qual = extract_spans(r1.qual, handle.umi_spans);
    pending.r2_name = r2.name;
    pending.r2_seq = r2.seq;
    pending.r2_qual = r2.qual;
    size_t i = handle.batch.size();
    std::memcpy(handle.cr.data() + i * handle.cb_len, pending.barcode.data(),
                std::min<size_t>(pending.barcode.size(), handle.cb_len));
    handle.batch.push_back(std::move(pending));
    handle.total += 1;
  }
  return static_cast<long>(handle.batch.size());
}

const char* scx_sfq_buf(void* h, const char* name) {
  SfqHandle& handle = *static_cast<SfqHandle*>(h);
  if (std::string_view(name) == "cr") return handle.cr.data();
  return nullptr;
}

int scx_sfq_len(void* h, const char* name) {
  SfqHandle& handle = *static_cast<SfqHandle*>(h);
  if (std::string_view(name) == "cr") return handle.cb_len;
  return -1;
}

// Emit the kept reads of the current batch (keep_mask[i] != 0). The R1
// rewrite is the reference's fixed slide-seq layout (samplefastq.cpp:
// 91-97): barcode[0:8] + linker + barcode[8:] + UMI + 'T', qualities
// padded with 'F'. The barcode's quality is cut at the same head, clamped
// to its own length. Returns reads kept this batch, -1 on error.
long scx_sfq_write(void* h, long n, const uint8_t* keep_mask) {
  SfqHandle& handle = *static_cast<SfqHandle*>(h);
  if (n != static_cast<long>(handle.batch.size())) {
    handle.error = "write size does not match the current batch";
    return -1;
  }
  static const std::string kLinkerQual(kLinkerLen, 'F');
  std::string r1, r2;
  long kept = 0;
  for (long i = 0; i < n; ++i) {
    if (!keep_mask || !keep_mask[i]) continue;
    const SfqHandle::Pending& read = handle.batch[i];
    const std::string& barcode = read.barcode;
    const std::string& qual = read.barcode_qual;
    size_t head = std::min<size_t>(8, barcode.size());
    size_t qual_head = std::min(head, qual.size());
    r1 += '@';
    r1 += read.name;
    r1 += '\n';
    r1.append(barcode, 0, head);
    r1.append(kLinker, kLinkerLen);
    r1.append(barcode, head, std::string::npos);
    r1 += read.umi;
    r1 += "T\n+\n";
    r1.append(qual, 0, qual_head);
    r1 += kLinkerQual;
    r1.append(qual, qual_head, std::string::npos);
    r1 += read.umi_qual;
    r1 += "F\n";
    r2 += '@';
    r2 += read.r2_name;
    r2 += '\n';
    r2 += read.r2_seq;
    r2 += "\n+\n";
    r2 += read.r2_qual;
    r2 += '\n';
    kept += 1;
  }
  if (std::fwrite(r1.data(), 1, r1.size(), handle.out_r1) != r1.size() ||
      std::fwrite(r2.data(), 1, r2.size(), handle.out_r2) != r2.size()) {
    handle.error = "write failed";
    return -1;
  }
  handle.kept += kept;
  return kept;
}

int scx_sfq_close(void* h) {
  SfqHandle& handle = *static_cast<SfqHandle*>(h);
  int rc = 0;
  if (handle.out_r1 && std::fclose(handle.out_r1) != 0) rc = -1;
  if (handle.out_r2 && std::fclose(handle.out_r2) != 0) rc = -1;
  handle.out_r1 = handle.out_r2 = nullptr;
  return rc;
}

const char* scx_sfq_error(void* h) {
  return static_cast<SfqHandle*>(h)->error.c_str();
}

void scx_sfq_free(void* h) {
  SfqHandle* handle = static_cast<SfqHandle*>(h);
  if (handle->out_r1) std::fclose(handle->out_r1);
  if (handle->out_r2) std::fclose(handle->out_r2);
  delete handle;
}

}  // extern "C"
