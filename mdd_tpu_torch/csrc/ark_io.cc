// Native bulk reader for Kaldi binary ark archives.
//
// The port's copy of mdd_tpu's reader, built by mdd_tpu_torch/ops/build.py.
// The Python reader (mdd_tpu_torch/frontend/kaldi_io.py) opens the ark and
// seeks per utterance — fine for lazy streaming, wasteful for bulk
// ingest (the device-cache build reads the whole corpus at once: 5,496
// entries / ~540 MB at the reference scale).  This library mmaps the
// archive once, indexes every entry in a single linear scan, and exposes
// zero-copy access to the float32 payloads; Python binds it via ctypes
// (mdd_tpu_torch/native/__init__.py, class NativeArkReader).  A library
// that fails to build raises there: nothing falls back to Python for it.
//
// Replaces the role of the reference's prebuilt Kaldi IO binaries
// (copy-feats / the kaldiio dependency) on the bulk-ingest path; format
// per kaldi/src/matrix/kaldi-matrix.cc binary headers:
//   <utt> ' ' '\0' 'B' "BFM " '\x04' <int32 rows> '\x04' <int32 cols>
//   <rows*cols float32>
// Only "BFM" (float32 matrix) entries are indexed natively — anything
// else fails open() and the caller uses the Python reader.

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct ArkIndex {
  const uint8_t* data = nullptr;
  int64_t size = 0;
  int fd = -1;
  std::vector<int64_t> marker_off;  // offset of the "\0B" marker (the
                                    // offset scp entries point at)
  std::vector<int64_t> data_off;    // offset of the float payload
  std::vector<int32_t> rows, cols;
  std::string utts;                 // '\n'-separated utterance ids

  ~ArkIndex() {
    if (data != nullptr) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};

bool parse(ArkIndex* idx) {
  int64_t p = 0;
  const uint8_t* d = idx->data;
  const int64_t n = idx->size;
  while (p < n) {
    const int64_t utt_start = p;
    while (p < n && d[p] != ' ') p++;
    if (p >= n) return idx->rows.empty() ? false : true;
    const int64_t utt_len = p - utt_start;
    p++;  // the space
    const int64_t marker = p;
    if (p + 2 > n || d[p] != 0 || d[p + 1] != 'B') return false;
    p += 2;
    if (p + 4 > n || memcmp(d + p, "BFM ", 4) != 0) return false;
    p += 4;
    if (p + 10 > n || d[p] != 4 || d[p + 5] != 4) return false;
    int32_t r, c;
    memcpy(&r, d + p + 1, 4);
    memcpy(&c, d + p + 6, 4);
    p += 10;
    const int64_t bytes = static_cast<int64_t>(r) * c * 4;
    if (r < 0 || c < 0 || p + bytes > n) return false;
    idx->utts.append(reinterpret_cast<const char*>(d) + utt_start, utt_len);
    idx->utts.push_back('\n');
    idx->marker_off.push_back(marker);
    idx->data_off.push_back(p);
    idx->rows.push_back(r);
    idx->cols.push_back(c);
    p += bytes;
  }
  return true;
}

}  // namespace

extern "C" {

// Open + index; returns a handle and sets *n_entries, or nullptr if the
// file is missing/unparseable (caller falls back to the Python reader).
void* mdd_ark_open(const char* path, int64_t* n_entries) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (m == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* idx = new ArkIndex();
  idx->data = static_cast<const uint8_t*>(m);
  idx->size = st.st_size;
  idx->fd = fd;
  if (!parse(idx)) {
    delete idx;
    return nullptr;
  }
  *n_entries = static_cast<int64_t>(idx->rows.size());
  return idx;
}

// Entry metadata, parallel arrays of length n_entries.
void mdd_ark_entries(void* h, int64_t* marker_off, int64_t* data_off,
                     int32_t* rows, int32_t* cols) {
  auto* idx = static_cast<ArkIndex*>(h);
  const size_t n = idx->rows.size();
  memcpy(marker_off, idx->marker_off.data(), n * sizeof(int64_t));
  memcpy(data_off, idx->data_off.data(), n * sizeof(int64_t));
  memcpy(rows, idx->rows.data(), n * sizeof(int32_t));
  memcpy(cols, idx->cols.data(), n * sizeof(int32_t));
}

int64_t mdd_ark_utts_size(void* h) {
  return static_cast<int64_t>(static_cast<ArkIndex*>(h)->utts.size());
}

void mdd_ark_utts(void* h, char* buf) {
  auto* idx = static_cast<ArkIndex*>(h);
  memcpy(buf, idx->utts.data(), idx->utts.size());
}

// Base pointer of the mapping — payload i is at base + data_off[i],
// rows[i]*cols[i] little-endian float32s (valid until close).
const void* mdd_ark_base(void* h) {
  return static_cast<ArkIndex*>(h)->data;
}

// Copy entry i into dst (rows*cols float32s).
void mdd_ark_read(void* h, int64_t i, float* dst) {
  auto* idx = static_cast<ArkIndex*>(h);
  memcpy(dst, idx->data + idx->data_off[i],
         static_cast<int64_t>(idx->rows[i]) * idx->cols[i] * 4);
}

void mdd_ark_close(void* h) { delete static_cast<ArkIndex*>(h); }

}  // extern "C"
