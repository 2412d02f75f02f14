// Native COLMAP binary readers (ctypes ABI).
//
// The data layer's hot offline parse: points3D.bin holds one
// variable-length record per point (id, xyz, rgb, error, track) — the
// pure-Python struct loop costs minutes at Waymo scale (multi-million
// LiDAR-merged points, SURVEY.md C22), this single buffered pass runs at
// disk speed. Layout per record (COLMAP src/base/reconstruction.cc):
//   uint64 point3D_id; 3x double xyz; 3x uint8 rgb; double error;
//   uint64 track_len; track_len x { uint32 image_id; uint32 point2D_idx }
//
// Build: g++ -O3 -shared -fPIC colmap_reader.cpp -o libsgnt_native.so
// (done lazily by street_gaussians_ns_tpu_torch.native on first use, into
// build/torch_native/). A copy of street_gaussians_ns_tpu/native/
// colmap_reader.cpp.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// Buffered reader: fread in 8 MiB blocks, memcpy out records.
class Reader {
 public:
  explicit Reader(FILE* f) : f_(f), buf_(8 << 20), pos_(0), end_(0) {}

  bool read(void* dst, size_t n) {
    char* out = static_cast<char*>(dst);
    while (n > 0) {
      if (pos_ == end_) {
        end_ = fread(buf_.data(), 1, buf_.size(), f_);
        pos_ = 0;
        if (end_ == 0) return false;
      }
      size_t take = end_ - pos_ < n ? end_ - pos_ : n;
      memcpy(out, buf_.data() + pos_, take);
      pos_ += take;
      out += take;
      n -= take;
    }
    return true;
  }

  bool skip(size_t n) {
    while (n > 0) {
      if (pos_ == end_) {
        end_ = fread(buf_.data(), 1, buf_.size(), f_);
        pos_ = 0;
        if (end_ == 0) return false;
      }
      size_t take = end_ - pos_ < n ? end_ - pos_ : n;
      pos_ += take;
      n -= take;
    }
    return true;
  }

 private:
  FILE* f_;
  std::vector<char> buf_;
  size_t pos_, end_;
};

}  // namespace

extern "C" {

// Returns the number of points parsed (<= n_max), or -1 on error.
// Caller allocates ids (n_max), xyz (n_max*3), rgb (n_max*3),
// err (n_max). Query n_max first with sgnt_points3d_count.
long long sgnt_read_points3d(const char* path, long long n_max,
                             long long* ids, double* xyz,
                             unsigned char* rgb, double* err) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Reader r(f);
  uint64_t n = 0;
  if (!r.read(&n, 8)) { fclose(f); return -1; }
  if ((long long)n > n_max) n = (uint64_t)n_max;
  for (uint64_t i = 0; i < n; ++i) {
    // Fixed prefix: 8 + 24 + 3 + 8 = 43 bytes, packed.
    char rec[43];
    if (!r.read(rec, sizeof(rec))) { fclose(f); return (long long)i; }
    uint64_t id;
    memcpy(&id, rec, 8);
    ids[i] = (long long)id;
    memcpy(xyz + 3 * i, rec + 8, 24);
    memcpy(rgb + 3 * i, rec + 32, 3);
    memcpy(err + i, rec + 35, 8);
    uint64_t track_len;
    if (!r.read(&track_len, 8)) { fclose(f); return (long long)i; }
    if (!r.skip(track_len * 8)) { fclose(f); return (long long)(i + 1); }
  }
  fclose(f);
  return (long long)n;
}

// Point count from the header (for caller-side allocation).
long long sgnt_points3d_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t n = 0;
  size_t got = fread(&n, 1, 8, f);
  fclose(f);
  return got == 8 ? (long long)n : -1;
}

}  // extern "C"
