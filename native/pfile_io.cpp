// Native pfile reader: mmap'd, zero-copy header/index parse, byteswapped
// per-sentence extraction.
//
// The reference's data path is QuickNet's C++ pfile stream classes
// (QN_InFtrStream_PFile -- SURVEY.md §2.1 L0); this is the native fast path
// behind asr_craft/data/pfile.py (pure-Python fallback), exposed via a
// C ABI for ctypes.  Format notes in the Python module.
//
// Built on first use by asr_craft/utils/native_build.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr size_t kHeaderSize = 32768;

struct PFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  int32_t num_sents = 0;
  int64_t num_frames = 0;
  int32_t num_features = 0;
  int32_t num_label_cols = 0;
  int32_t first_feature_col = 2;
  std::vector<uint32_t> sent_offsets;  // num_sents + 1 row offsets
};

inline uint32_t bswap(uint32_t v) { return __builtin_bswap32(v); }

bool parse_header(const char* hdr, PFile* pf) {
  auto find_val = [&](const char* key, long long* out) {
    const char* p = strstr(hdr, key);
    if (!p) return false;
    p += strlen(key);
    *out = strtoll(p, nullptr, 10);
    return true;
  };
  long long ns, nf, d, k;
  if (!find_val("-num_sentences ", &ns)) return false;
  if (!find_val("-num_frames ", &nf)) return false;
  if (!find_val("-num_features ", &d)) return false;
  if (!find_val("-num_labels ", &k)) return false;
  long long ffc = 2;
  find_val("-first_feature_column ", &ffc);
  pf->num_sents = (int32_t)ns;
  pf->num_frames = nf;
  pf->num_features = (int32_t)d;
  pf->num_label_cols = (int32_t)k;
  pf->first_feature_col = (int32_t)ffc;
  return true;
}

}  // namespace

extern "C" {

void* craft_pfile_open(const char* path) {
  PFile* pf = new PFile();
  pf->fd = open(path, O_RDONLY);
  if (pf->fd < 0) { delete pf; return nullptr; }
  struct stat st;
  if (fstat(pf->fd, &st) != 0 || (size_t)st.st_size < kHeaderSize) {
    close(pf->fd); delete pf; return nullptr;
  }
  pf->map_size = st.st_size;
  pf->map = (const uint8_t*)mmap(nullptr, pf->map_size, PROT_READ,
                                 MAP_PRIVATE, pf->fd, 0);
  if (pf->map == MAP_FAILED) { close(pf->fd); delete pf; return nullptr; }

  std::string hdr((const char*)pf->map, kHeaderSize);
  if (!parse_header(hdr.c_str(), pf)) {
    munmap((void*)pf->map, pf->map_size); close(pf->fd); delete pf;
    return nullptr;
  }
  int64_t ncol = 2 + pf->num_features + pf->num_label_cols;
  int64_t data_words = pf->num_frames * ncol;
  size_t need = kHeaderSize + (data_words + pf->num_sents + 1) * 4;
  if (pf->map_size < need) {
    munmap((void*)pf->map, pf->map_size); close(pf->fd); delete pf;
    return nullptr;
  }
  const uint32_t* idx = (const uint32_t*)(pf->map + kHeaderSize
                                          + data_words * 4);
  pf->sent_offsets.resize(pf->num_sents + 1);
  for (int32_t s = 0; s <= pf->num_sents; ++s)
    pf->sent_offsets[s] = bswap(idx[s]);
  return pf;
}

void craft_pfile_close(void* h) {
  PFile* pf = static_cast<PFile*>(h);
  if (pf->map) munmap((void*)pf->map, pf->map_size);
  if (pf->fd >= 0) close(pf->fd);
  delete pf;
}

int32_t craft_pfile_num_sents(void* h) { return static_cast<PFile*>(h)->num_sents; }
int32_t craft_pfile_num_features(void* h) { return static_cast<PFile*>(h)->num_features; }
int32_t craft_pfile_num_label_cols(void* h) { return static_cast<PFile*>(h)->num_label_cols; }

int32_t craft_pfile_sent_frames(void* h, int32_t sent) {
  PFile* pf = static_cast<PFile*>(h);
  if (sent < 0 || sent >= pf->num_sents) return -1;
  return (int32_t)(pf->sent_offsets[sent + 1] - pf->sent_offsets[sent]);
}

// feats: (frames, num_features) float32 row-major; labels: (frames,) uint32
// (labels may be null when num_label_cols == 0).  Returns frame count or -1.
int32_t craft_pfile_read_sent(void* h, int32_t sent, float* feats,
                              uint32_t* labels) {
  PFile* pf = static_cast<PFile*>(h);
  if (sent < 0 || sent >= pf->num_sents) return -1;
  int64_t ncol = 2 + pf->num_features + pf->num_label_cols;
  int64_t row0 = pf->sent_offsets[sent];
  int32_t T = (int32_t)(pf->sent_offsets[sent + 1] - row0);
  const uint32_t* base =
      (const uint32_t*)(pf->map + kHeaderSize) + row0 * ncol;
  for (int32_t t = 0; t < T; ++t) {
    const uint32_t* row = base + t * ncol + pf->first_feature_col;
    float* out = feats + (int64_t)t * pf->num_features;
    for (int32_t d = 0; d < pf->num_features; ++d) {
      uint32_t v = bswap(row[d]);
      std::memcpy(&out[d], &v, 4);
    }
    if (labels && pf->num_label_cols > 0)
      labels[t] = bswap(row[pf->num_features]);
  }
  return T;
}

}  // extern "C"
