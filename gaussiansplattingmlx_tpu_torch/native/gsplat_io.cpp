// Native data-loading core of gaussiansplattingmlx_tpu_torch: the COLMAP
// binary parsers, behind a plain C interface for ctypes.
//
// COLMAP's images.bin and points3D.bin are variable-length record walks, one
// Python struct call per field in data/colmap.py's pure-Python parsers, which
// compute the same values and are the plain versions the tests compare
// against (scripts/torch_colmap_parse_bench.py times both).  Every length
// read from a file is checked against the bytes left before it is used, so a
// corrupt or crafted file makes a parser return -1, never read outside it.
//
// Built at first use by data/native_io.py with the host C++ compiler
// (c++ -O3 -fPIC -shared -std=c++17) into the package's _build/ directory.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  size_t left() const { return static_cast<size_t>(end - p); }

  template <typename T>
  T read() {
    if (!ok || sizeof(T) > left()) {
      ok = false;
      return T{};
    }
    T v;
    std::memcpy(&v, p, sizeof(T));
    p += sizeof(T);
    return v;
  }

  // count items of item_size bytes each; count comes from the file, so it
  // is compared with what is left before it is multiplied.
  void skip(uint64_t count, size_t item_size = 1) {
    if (!ok || count > left() / item_size) {
      ok = false;
      return;
    }
    p += count * item_size;
  }

  // NUL-terminated string.
  std::string read_string() {
    if (!ok) return {};
    const uint8_t* q = p;
    while (q < end && *q != 0) q++;
    if (q >= end) {
      ok = false;
      return {};
    }
    std::string s(reinterpret_cast<const char*>(p), q - p);
    p = q + 1;
    return s;
  }
};

int param_count_for_model(int model_id) {
  switch (model_id) {
    case 0: return 3;   // SIMPLE_PINHOLE: f, cx, cy
    case 1: return 4;   // PINHOLE: fx, fy, cx, cy
    case 2: return 4;   // SIMPLE_RADIAL: f, cx, cy, k
    case 4: return 8;   // OPENCV: fx, fy, cx, cy, k1, k2, p1, p2
    default: return -1;  // the models data/colmap.py does not read either
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// points3D.bin: returns the point count, fills xyz [n*3] f32 and rgb [n*3]
// f32 if non-null.  Call once with null outputs to size, then again to fill.
// Layout per point: u64 id, 3x f64 xyz, 3x u8 rgb, f64 error, u64 track_len,
// track_len * (i32, i32).
// ---------------------------------------------------------------------------
int64_t gsplat_parse_points3d(const uint8_t* data, int64_t size, float* xyz,
                              float* rgb) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  for (uint64_t i = 0; i < n; i++) {
    c.skip(8);  // point id
    double x = c.read<double>(), y = c.read<double>(), z = c.read<double>();
    uint8_t r = c.read<uint8_t>(), g = c.read<uint8_t>(), b = c.read<uint8_t>();
    c.skip(8);  // reprojection error
    const uint64_t track = c.read<uint64_t>();
    c.skip(track, 8);  // (image id i32, point2D index i32)
    if (!c.ok) return -1;
    if (xyz) {
      xyz[i * 3 + 0] = static_cast<float>(x);
      xyz[i * 3 + 1] = static_cast<float>(y);
      xyz[i * 3 + 2] = static_cast<float>(z);
    }
    if (rgb) {
      rgb[i * 3 + 0] = static_cast<float>(r);
      rgb[i * 3 + 1] = static_cast<float>(g);
      rgb[i * 3 + 2] = static_cast<float>(b);
    }
  }
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// images.bin: fills per-image image_id [n] i32, qvec (w,x,y,z) [n*4] f64,
// tvec [n*3] f64, camera_id [n] i32, and a flat NUL-separated name buffer
// (names_cap bytes); names_size, if non-null, gets the bytes the names take.
// Returns image count, or -1 on parse error / -2 if names don't fit.
// ---------------------------------------------------------------------------
int64_t gsplat_parse_images(const uint8_t* data, int64_t size, int32_t* image_id,
                            double* qvec, double* tvec, int32_t* camera_id,
                            char* names, int64_t names_cap, int64_t* names_size) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  int64_t name_pos = 0;
  for (uint64_t i = 0; i < n; i++) {
    int32_t id = c.read<int32_t>();
    double q[4], t[3];
    for (double& v : q) v = c.read<double>();
    for (double& v : t) v = c.read<double>();
    int32_t cam = c.read<int32_t>();
    std::string name = c.read_string();
    const uint64_t npts = c.read<uint64_t>();
    c.skip(npts, 8 + 8 + 8);  // (x f64, y f64, point3D_id i64)
    if (!c.ok) return -1;
    if (image_id) image_id[i] = id;
    if (qvec) std::memcpy(qvec + i * 4, q, sizeof(q));
    if (tvec) std::memcpy(tvec + i * 3, t, sizeof(t));
    if (camera_id) camera_id[i] = cam;
    if (names) {
      if (name_pos + static_cast<int64_t>(name.size()) + 1 > names_cap)
        return -2;
      std::memcpy(names + name_pos, name.c_str(), name.size() + 1);
    }
    name_pos += static_cast<int64_t>(name.size()) + 1;
  }
  if (names_size) *names_size = name_pos;
  return static_cast<int64_t>(n);
}

// ---------------------------------------------------------------------------
// cameras.bin: fills camera_id [n] i32, model_id [n] i32, width/height [n]
// i64, params [n*8] f64 (zero-padded).  Returns camera count, or -1 on a parse
// error or a camera model other than the four above.
// ---------------------------------------------------------------------------
int64_t gsplat_parse_cameras(const uint8_t* data, int64_t size,
                             int32_t* camera_id, int32_t* model_id,
                             int64_t* width, int64_t* height, double* params) {
  Cursor c{data, data + size};
  const uint64_t n = c.read<uint64_t>();
  for (uint64_t i = 0; i < n; i++) {
    int32_t cid = c.read<int32_t>();
    int32_t mid = c.read<int32_t>();
    uint64_t w = c.read<uint64_t>();
    uint64_t h = c.read<uint64_t>();
    int np = param_count_for_model(mid);
    if (np < 0 || !c.ok) return -1;
    double ps[8] = {0};
    for (int k = 0; k < np; k++) ps[k] = c.read<double>();
    if (!c.ok) return -1;
    if (camera_id) camera_id[i] = cid;
    if (model_id) model_id[i] = mid;
    if (width) width[i] = static_cast<int64_t>(w);
    if (height) height[i] = static_cast<int64_t>(h);
    if (params) std::memcpy(params + i * 8, ps, sizeof(ps));
  }
  return static_cast<int64_t>(n);
}

}  // extern "C"
