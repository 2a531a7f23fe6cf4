// Native host runtime of the PyTorch port: a copy of the JAX package's
// native/sbl_native.cc, kept here so that the port builds it from its own
// sources (utils/native.py compiles it with g++ at first use).
//
// The reference's host path burns python/CPU time in DataLoader workers
// (np.load + per-frame cv2 + float math, SBL data_gen.py:270-304) and in
// the `editdistance` package during eval.  These C++ functions cover the
// two host-side hot spots:
//
//   * sbl_load_clip_batch: multithreaded .npy clip batch loader -- parses
//     NPY v1/v2 headers directly, reads uint8 (or float32/float64 in [0,1]
//     or [0,255]) frame stacks, and packs them zero-padded into a
//     preallocated (N, frames, H, W) uint8 batch buffer ready for the
//     device ingest op.  No python object churn, no intermediate copies.
//   * sbl_levenshtein / sbl_levenshtein_batch: O(min(m,n)) edit distance
//     over int32 token sequences for WER/PER scoring.
//
// C ABI only (called via ctypes, see
// sbl_for_multilingual_lip_reading_tpu_torch/utils/native.py).
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  char dtype;      // 'u' = uint8, 'f' = float32, 'd' = float64
  size_t data_offset;
};

// Parse an NPY v1.0/v2.0 header. Returns false on malformed/unsupported.
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  auto find_val = [&](const char* key) -> std::string {
    size_t p = header.find(key);
    if (p == std::string::npos) return "";
    p = header.find(':', p);
    if (p == std::string::npos) return "";
    size_t e = header.find_first_of(",}", p + 1);
    return header.substr(p + 1, e - p - 1);
  };

  std::string descr = find_val("'descr'");
  if (descr.find("u1") != std::string::npos) info->dtype = 'u';
  else if (descr.find("f4") != std::string::npos) info->dtype = 'f';
  else if (descr.find("f8") != std::string::npos) info->dtype = 'd';
  else return false;
  if (find_val("'fortran_order'").find("True") != std::string::npos)
    return false;

  size_t p = header.find("'shape'");
  if (p == std::string::npos) return false;
  p = header.find('(', p);
  size_t e = header.find(')', p);
  if (p == std::string::npos || e == std::string::npos) return false;
  std::string dims = header.substr(p + 1, e - p - 1);
  info->shape.clear();
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    info->shape.push_back(strtoll(s, const_cast<char**>(&s), 10));
  }
  return !info->shape.empty();
}

// Load one clip file into out (frames, h, w) uint8, zero-padded/truncated.
int load_one_clip(const char* path, uint8_t* out, int frames, int h, int w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info) || info.shape.size() != 3) {
    fclose(f);
    return -2;
  }
  int64_t T = info.shape[0], H = info.shape[1], W = info.shape[2];
  if (H != h || W != w) {
    fclose(f);
    return -3;
  }
  int64_t copy_t = std::min<int64_t>(T, frames);
  int64_t n = copy_t * H * W;
  memset(out, 0, static_cast<size_t>(frames) * h * w);
  if (fseek(f, static_cast<long>(info.data_offset), SEEK_SET) != 0) {
    fclose(f);
    return -4;
  }
  int rc = 0;
  if (info.dtype == 'u') {
    if (fread(out, 1, n, f) != static_cast<size_t>(n)) rc = -5;
  } else {
    size_t esz = info.dtype == 'f' ? 4 : 8;
    std::vector<unsigned char> buf(n * esz);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      rc = -5;
    } else {
      // detect [0,1] vs [0,255] scaling like the python loader
      double maxv = 0.0;
      for (int64_t i = 0; i < n; ++i) {
        double v = info.dtype == 'f'
                       ? static_cast<double>(
                             reinterpret_cast<float*>(buf.data())[i])
                       : reinterpret_cast<double*>(buf.data())[i];
        maxv = std::max(maxv, v);
      }
      double scale = maxv <= 1.0 ? 255.0 : 1.0;
      for (int64_t i = 0; i < n; ++i) {
        double v = info.dtype == 'f'
                       ? static_cast<double>(
                             reinterpret_cast<float*>(buf.data())[i])
                       : reinterpret_cast<double*>(buf.data())[i];
        double scaled = v * scale;
        out[i] = static_cast<uint8_t>(
            std::min(255.0, std::max(0.0, scaled)));
      }
    }
  }
  fclose(f);
  return rc;
}

}  // namespace

extern "C" {

// Edit distance between int32 sequences (two-row DP).
int32_t sbl_levenshtein(const int32_t* a, int32_t la, const int32_t* b,
                        int32_t lb) {
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  if (lb == 0) return la;
  std::vector<int32_t> prev(lb + 1), cur(lb + 1);
  for (int32_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int32_t i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int32_t j = 1; j <= lb; ++j) {
      int32_t sub = prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0);
      cur[j] = std::min(std::min(prev[j] + 1, cur[j - 1] + 1), sub);
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Batched edit distance: sequences flattened with per-item lengths.
void sbl_levenshtein_batch(const int32_t* a_flat, const int32_t* a_len,
                           const int32_t* b_flat, const int32_t* b_len,
                           int32_t n, int32_t* out) {
  int64_t ao = 0, bo = 0;
  for (int32_t i = 0; i < n; ++i) {
    out[i] = sbl_levenshtein(a_flat + ao, a_len[i], b_flat + bo, b_len[i]);
    ao += a_len[i];
    bo += b_len[i];
  }
}

// Load n clip files into out (n, frames, h, w) uint8 with nthreads workers.
// Returns 0 if every clip loaded, else the count of failed clips (their
// slots are zero-filled).
int32_t sbl_load_clip_batch(const char** paths, int32_t n, uint8_t* out,
                            int32_t frames, int32_t h, int32_t w,
                            int32_t nthreads) {
  std::atomic<int32_t> failures{0};
  std::atomic<int32_t> next{0};
  const int64_t clip_sz = static_cast<int64_t>(frames) * h * w;
  auto worker = [&]() {
    while (true) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      if (load_one_clip(paths[i], out + i * clip_sz, frames, h, w) != 0) {
        memset(out + i * clip_sz, 0, clip_sz);
        failures.fetch_add(1);
      }
    }
  };
  int32_t t = std::max(1, std::min(nthreads, n));
  std::vector<std::thread> threads;
  for (int32_t i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
