// Native data loader: high-throughput FASTQ/FASTA parsing + base encoding.
//
// The reference pipeline's I/O hot path is C (BWA's kseq.h FASTQ reader,
// SURVEY.md section 2.2); this is this framework's equivalent: parse +
// encode straight into the padded int8 code tensors the device consumes
// (A0 C1 G2 T3, N/other 4), no intermediate Python string objects.
// Exposed as a plain C ABI consumed via ctypes (rambl_tpu/io/loader.py);
// zlib's gzFile transparently handles both plain and .gz inputs.
//
// Build: make -C native   (produces native/librambl_loader.so)

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

constexpr int8_t kPad = 4;

inline int8_t code_of(int c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return kPad;
  }
}

// Buffered gz reader: gzgetc is too slow; pull 1 MiB blocks.
class Reader {
 public:
  explicit Reader(const char* path) : f_(gzopen(path, "rb")) {}
  ~Reader() { if (f_) gzclose(f_); }
  bool ok() const { return f_ != nullptr; }

  int next() {
    if (pos_ >= len_) {
      if (!f_) return -1;
      len_ = gzread(f_, buf_, sizeof(buf_));
      pos_ = 0;
      if (len_ <= 0) return -1;
    }
    return buf_[pos_++];
  }

  // Read one line (no newline) into out; returns false at EOF with empty out.
  bool line(std::vector<char>& out) {
    out.clear();
    int c;
    while ((c = next()) >= 0) {
      if (c == '\n') return true;
      if (c != '\r') out.push_back(static_cast<char>(c));
    }
    return !out.empty();
  }

 private:
  gzFile f_;
  unsigned char buf_[1 << 20];
  int len_ = 0;
  int pos_ = 0;
};

}  // namespace

extern "C" {

// Parse up to max_reads FASTQ records; encode into out_codes (max_reads x
// lmax, pre-filled by callee with pad) and out_lens. Returns the number of
// records parsed, or -1 on open failure.
long rambl_fastq_parse(const char* path, int8_t* out_codes, int32_t* out_lens,
                       long max_reads, int lmax) {
  Reader r(path);
  if (!r.ok()) return -1;
  std::vector<char> l1, l2, l3, l4;
  long n = 0;
  while (n < max_reads) {
    if (!r.line(l1)) break;
    if (l1.empty()) continue;
    if (l1[0] != '@') return -2;
    if (!r.line(l2)) return -2;
    if (!r.line(l3) || l3.empty() || l3[0] != '+') return -2;
    if (!r.line(l4)) return -2;
    int8_t* row = out_codes + n * static_cast<long>(lmax);
    int len = static_cast<int>(l2.size());
    if (len > lmax) len = lmax;
    for (int i = 0; i < len; ++i) row[i] = code_of(l2[i]);
    for (int i = len; i < lmax; ++i) row[i] = kPad;
    out_lens[n] = len;
    ++n;
  }
  return n;
}

// Count FASTQ records (cheap pre-pass so callers can size buffers).
long rambl_fastq_count(const char* path) {
  Reader r(path);
  if (!r.ok()) return -1;
  std::vector<char> l;
  long lines = 0;
  while (r.line(l)) {
    if (!l.empty()) ++lines;
  }
  return lines / 4;
}

// Parse FASTA; same output contract as fastq_parse. Multi-line sequences
// are concatenated. Returns record count or -1/-2 on error.
long rambl_fasta_parse(const char* path, int8_t* out_codes, int32_t* out_lens,
                       long max_seqs, int lmax) {
  Reader r(path);
  if (!r.ok()) return -1;
  std::vector<char> l;
  long n = -1;
  int len = 0;
  int8_t* row = nullptr;
  while (r.line(l)) {
    if (l.empty()) continue;
    if (l[0] == '>') {
      if (n >= 0) out_lens[n] = len;
      ++n;
      if (n >= max_seqs) { n = max_seqs; break; }
      row = out_codes + n * static_cast<long>(lmax);
      for (int i = 0; i < lmax; ++i) row[i] = kPad;
      len = 0;
    } else if (n >= 0) {
      for (char c : l) {
        if (len < lmax) row[len++] = code_of(c);
      }
    }
  }
  if (n >= 0 && n < max_seqs) {
    out_lens[n] = len;
    ++n;
  }
  return n < 0 ? 0 : n;
}

long rambl_fasta_count(const char* path) {
  Reader r(path);
  if (!r.ok()) return -1;
  std::vector<char> l;
  long n = 0;
  while (r.line(l)) {
    if (!l.empty() && l[0] == '>') ++n;
  }
  return n;
}

// Batched reverse complement in place-compatible layout:
// out[i] = revcomp(codes[i][:lens[i]]) left-aligned, pad elsewhere.
void rambl_revcomp_batch(const int8_t* codes, const int32_t* lens,
                         int8_t* out, long n, int lmax) {
  static const int8_t comp[5] = {3, 2, 1, 0, 4};
  for (long r = 0; r < n; ++r) {
    const int8_t* src = codes + r * static_cast<long>(lmax);
    int8_t* dst = out + r * static_cast<long>(lmax);
    int len = lens[r];
    for (int i = 0; i < len; ++i) dst[i] = comp[src[len - 1 - i]];
    for (int i = len; i < lmax; ++i) dst[i] = kPad;
  }
}

}  // extern "C"
