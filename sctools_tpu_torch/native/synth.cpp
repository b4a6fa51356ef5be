// Native synthetic 10x-style BAM generator: the port's copy of the JAX
// package's synth.cpp, over the port's native_io.h.
//
// Writes a cell-sorted, fully tagged BAM (CB/CR/CY, UB/UR/UY, GE, XF, NH)
// at native speed, so tests and the card's smoke can build large inputs in
// seconds. The record layout mirrors what the pipeline consumes (the tag
// vocabulary the reference's fastqprocess emits,
// fastqpreprocessing/src/fastq_common.cpp:186-213).
//
// Cell barcodes encode the cell index in base 4 (A<C<G<T), so barcode
// order is cell index order and the output is sorted by CB without
// sorting. UMIs encode the molecule index the same way (sorted within each
// cell); each molecule gets one gene, so the file meets the (CB, UB, GE)
// sort precondition of GatherCellMetrics. The records equal the JAX copy's
// for the same arguments and seed; the compressed bytes may differ (zlib
// where the JAX copy's writer calls libdeflate).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "native_io.h"

namespace {

// splitmix64: deterministic, seedable, fast
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }
  uint32_t below(uint32_t n) { return static_cast<uint32_t>(next() % n); }
};

const char kBases[4] = {'A', 'C', 'G', 'T'};

void encode_base4(uint64_t value, int width, char* out) {
  for (int i = width - 1; i >= 0; --i) {
    out[i] = kBases[value & 3];
    value >>= 2;
  }
}

void put_u32(std::vector<uint8_t>& buf, uint32_t v) {
  buf.push_back(v & 0xff);
  buf.push_back((v >> 8) & 0xff);
  buf.push_back((v >> 16) & 0xff);
  buf.push_back((v >> 24) & 0xff);
}

void put_i32(std::vector<uint8_t>& buf, int32_t v) {
  put_u32(buf, static_cast<uint32_t>(v));
}

void put_z_tag(std::vector<uint8_t>& buf, const char* tag, const char* value,
               size_t len) {
  buf.push_back(tag[0]);
  buf.push_back(tag[1]);
  buf.push_back('Z');
  buf.insert(buf.end(), value, value + len);
  buf.push_back('\0');
}

// 4-bit base codes: A=1 C=2 G=4 T=8 (SAM spec "=ACMGRSVTWYHKDBN")
const uint8_t kSeqCode[4] = {1, 2, 4, 8};

}  // namespace

extern "C" {

// Returns records written, or -1 with errbuf filled.
// cell_offset shifts the barcode space: barcodes encode cell_offset+i,
// so two files written with disjoint [offset, offset+n_cells) ranges
// share no cell barcode — multi-job serving tests pack them into one
// device batch without tripping the entity-collision guard.
long scx_synth_bam(const char* path, long n_cells, long cell_offset,
                   int molecules_per_cell, int reads_per_molecule,
                   int n_genes, int seq_len, unsigned long long seed,
                   int compress_level, char* errbuf, int errbuf_len) {
  scx::BgzfWriter out;
  if (!out.open(path, compress_level)) {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "cannot open for write %s", path);
    return -1;
  }

  // header: magic + text + one reference (chr1)
  {
    std::vector<uint8_t> head;
    const char* text = "@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:248956422\n";
    uint32_t l_text = static_cast<uint32_t>(std::strlen(text));
    head.insert(head.end(), {'B', 'A', 'M', 1});
    put_u32(head, l_text);
    head.insert(head.end(), text, text + l_text);
    put_u32(head, 1);  // n_ref
    put_u32(head, 5);  // l_name ("chr1" + NUL)
    head.insert(head.end(), {'c', 'h', 'r', '1', '\0'});
    put_u32(head, 248956422);
    out.write(head.data(), head.size());
  }

  Rng rng(seed ? seed : 1);
  std::vector<uint8_t> rec;
  rec.reserve(512);
  char cb[16], ub[10], ge[16], qname[40];
  std::string seq(seq_len, 'A');
  std::string qual_tag_umi(10, 'I');
  std::string qual_tag_cb(16, 'I');
  std::vector<uint8_t> qual(seq_len, 37);
  long written = 0;

  for (long cell = 0; cell < n_cells; ++cell) {
    encode_base4(static_cast<uint64_t>(cell_offset + cell), 16, cb);
    for (int mol = 0; mol < molecules_per_cell; ++mol) {
      encode_base4(static_cast<uint64_t>(mol), 10, ub);
      uint32_t gene = rng.below(static_cast<uint32_t>(n_genes));
      int ge_len = std::snprintf(ge, sizeof(ge), "GENE%u", gene);
      // fragment anchor for the molecule; most reads share it (duplicates),
      // some land elsewhere (distinct fragments)
      int32_t anchor = static_cast<int32_t>(rng.below(100000000));
      for (int r = 0; r < reads_per_molecule; ++r) {
        uint64_t bits = rng.next();
        bool duplicate = r > 0 && (bits & 0xff) < 64;          // ~25% of non-first
        bool reverse = (bits >> 8) & 1;
        int32_t pos = ((bits >> 9) & 0x3) ? anchor
                                          : anchor + static_cast<int32_t>((bits >> 11) & 0xffff);
        uint8_t xf_roll = (bits >> 32) & 0xff;
        const char* xf = xf_roll < 230 ? "CODING"
                         : xf_roll < 243 ? "INTRONIC"
                         : xf_roll < 251 ? "UTR"
                                         : "INTERGENIC";
        int qn_len = std::snprintf(qname, sizeof(qname), "q%ld_%d_%d",
                                   cell, mol, r);

        // vary base qualities deterministically per read
        uint8_t q = static_cast<uint8_t>(20 + ((bits >> 40) & 0x13));
        for (int i = 0; i < seq_len; ++i)
          qual[i] = static_cast<uint8_t>(q + ((i * 7 + (bits & 7)) % 17));

        rec.clear();
        put_i32(rec, 0);                       // refID
        put_i32(rec, pos);                     // pos
        rec.push_back(static_cast<uint8_t>(qn_len + 1));  // l_read_name
        rec.push_back(255);                    // mapq
        rec.push_back(0); rec.push_back(0);    // bin (unused)
        rec.push_back(1); rec.push_back(0);    // n_cigar = 1
        uint16_t flag = (duplicate ? 0x400 : 0) | (reverse ? 0x10 : 0);
        rec.push_back(flag & 0xff);
        rec.push_back(flag >> 8);
        put_u32(rec, static_cast<uint32_t>(seq_len));  // l_seq
        put_i32(rec, -1);                      // next_refID
        put_i32(rec, -1);                      // next_pos
        put_i32(rec, 0);                       // tlen
        rec.insert(rec.end(), qname, qname + qn_len);
        rec.push_back('\0');
        put_u32(rec, (static_cast<uint32_t>(seq_len) << 4) | 0);  // cigar: <len>M
        // packed sequence (pseudo-random bases from the read bits)
        uint64_t seq_bits = bits;
        for (int i = 0; i < (seq_len + 1) / 2; ++i) {
          seq_bits = seq_bits * 6364136223846793005ull + 1442695040888963407ull;
          uint8_t hi = kSeqCode[(seq_bits >> 20) & 3];
          uint8_t lo = kSeqCode[(seq_bits >> 40) & 3];
          rec.push_back(static_cast<uint8_t>((hi << 4) | lo));
        }
        rec.insert(rec.end(), qual.begin(), qual.end());

        put_z_tag(rec, "CB", cb, 16);
        put_z_tag(rec, "CR", cb, 16);  // perfect cell barcode
        put_z_tag(rec, "CY", qual_tag_cb.data(), 16);
        put_z_tag(rec, "UB", ub, 10);
        put_z_tag(rec, "UR", ub, 10);  // perfect molecule barcode
        put_z_tag(rec, "UY", qual_tag_umi.data(), 10);
        put_z_tag(rec, "GE", ge, static_cast<size_t>(ge_len));
        put_z_tag(rec, "XF", xf, std::strlen(xf));
        rec.push_back('N'); rec.push_back('H'); rec.push_back('C');
        rec.push_back(1);

        uint8_t len4[4];
        uint32_t block_size = static_cast<uint32_t>(rec.size());
        len4[0] = block_size & 0xff;
        len4[1] = (block_size >> 8) & 0xff;
        len4[2] = (block_size >> 16) & 0xff;
        len4[3] = (block_size >> 24) & 0xff;
        out.write(len4, 4);
        out.write(rec.data(), rec.size());
        ++written;
      }
    }
    if (out.failed()) {
      if (errbuf && errbuf_len > 0)
        std::snprintf(errbuf, errbuf_len, "write failed at record %ld",
                      written);
      out.abort_close();
      return -1;
    }
  }
  if (!out.close()) {
    if (errbuf && errbuf_len > 0)
      std::snprintf(errbuf, errbuf_len, "close failed");
    return -1;
  }
  return written;
}

}  // extern "C"
