// libvolym_io — native asset pipeline for volym.
//
// C++ equivalents of the reference's native (Rust) host byte-crunching:
//   * raw uint8 volume load + pad/truncate to side^3 + Y flip
//     (reference src/gpu_resources/volume.rs:35-101, src/gpu_resources/mod.rs:70-82)
//   * label->importance mapping fused into the load
//     (reference src/demos/simple/importance.rs:45-158)
//   * NRRD payload split (reference volym_devtools/src/main.rs:85-95)
//
// Exposed as a plain C ABI consumed via ctypes (volym/native/__init__.py).
// Error codes: 0 ok, -1 open failed, -2 read failed, -3 write failed.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Read an entire file; returns false on failure.
bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, out.size(), f) : 0;
  std::fclose(f);
  return got == out.size();
}

// Pad/truncate to side^3 and optionally flip Y, writing into out
// (out must hold side^3 bytes).  Mirrors flip_3d_texture_y semantics:
// data[z][y][x] -> data[z][side-1-y][x].
void pad_flip(const std::vector<uint8_t>& data, uint8_t* out, int side, int flip) {
  const size_t want = static_cast<size_t>(side) * side * side;
  const size_t have = data.size() < want ? data.size() : want;
  const size_t plane = static_cast<size_t>(side) * side;
  if (!flip) {
    std::memcpy(out, data.data(), have);
    if (have < want) std::memset(out + have, 0, want - have);
    return;
  }
  std::memset(out, 0, want);
  for (size_t z = 0; z < static_cast<size_t>(side); ++z) {
    for (size_t y = 0; y < static_cast<size_t>(side); ++y) {
      const size_t src_row = z * plane + y * side;
      if (src_row >= have) break;
      const size_t n = (src_row + side <= have) ? side : have - src_row;
      const size_t dst_row = z * plane + (side - 1 - y) * side;
      std::memcpy(out + dst_row, data.data() + src_row, n);
    }
  }
}

}  // namespace

extern "C" {

int volym_load_volume(const char* path, uint8_t* out, int side, int flip) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return -1;
  pad_flip(data, out, side, flip);
  return 0;
}

int volym_load_importance(const char* path, const uint8_t* label_lut, uint8_t* out,
                          int side, int flip) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return -1;
  // Map labels through the 256-entry LUT first (reference order:
  // map -> pad -> flip, importance.rs:53-78).
  for (auto& b : data) b = label_lut[b];
  pad_flip(data, out, side, flip);
  return 0;
}

// Split the NRRD payload: everything after the first blank line (the header
// terminator per the NRRD spec; the reference devtools takes the last
// text line, which is equivalent for the single-payload files it handles).
long long volym_nrrd_split(const char* in_path, const char* out_path) {
  std::vector<uint8_t> data;
  if (!read_file(in_path, data)) return -1;
  size_t start = 0;
  for (size_t i = 0; i + 1 < data.size(); ++i) {
    if (data[i] == '\n' && data[i + 1] == '\n') {
      start = i + 2;
      break;
    }
    if (i + 3 < data.size() && data[i] == '\r' && data[i + 1] == '\n' &&
        data[i + 2] == '\r' && data[i + 3] == '\n') {
      start = i + 4;
      break;
    }
  }
  FILE* f = std::fopen(out_path, "wb");
  if (!f) return -1;
  const size_t n = data.size() - start;
  const size_t wrote = n ? std::fwrite(data.data() + start, 1, n, f) : 0;
  std::fclose(f);
  if (wrote != n) return -3;
  return static_cast<long long>(n);
}

}  // extern "C"
