// Host image decoding, resizing and prefetching for the demo (cli/demo.py).
//
// The decoder, resampler and loader of native/multihmr_native.cpp: JPEG
// (libjpeg) and PNG (libpng) decoding, PIL-convention BICUBIC contain-resize,
// centred zero pad and ImageNet normalization into a float32 [S, S, 3]
// buffer, and a prefetching worker pool behind a bounded queue. Its
// rasterizer (mh_rasterize) is csrc/raster.cpp, a library of its own, so that
// the renderer builds where the codecs' headers are absent. Built at first
// use by io/native.py:
//
//   g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off -pthread ... -ljpeg -lpng
//
// Without -march=native: the JAX package's build contracts products and sums
// into FMAs, which moves a few resampled values by one uint8 level; both
// builds stay within one level of PIL, which is what this code is held to.
//
// C ABI, bound with ctypes (io/native.py): mh_preprocess_file,
// mh_preprocess_pixels, mh_decode_file and mh_loader_{create,next,total,destroy}.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct ImageU8 {
  std::vector<uint8_t> data;  // HWC, RGB
  int h = 0, w = 0;
  bool ok = false;
};

// ---------------- JPEG ----------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

ImageU8 decode_jpeg(const uint8_t* buf, size_t len) {
  ImageU8 img;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return img;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  img.w = cinfo.output_width;
  img.h = cinfo.output_height;
  img.data.resize(size_t(img.w) * img.h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = img.data.data() + size_t(cinfo.output_scanline) * img.w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  img.ok = true;
  return img;
}

// ---------------- PNG ----------------

struct PngReadState {
  const uint8_t* data;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "png: read past end");
  }
  memcpy(out, st->data + st->pos, n);
  st->pos += n;
}

ImageU8 decode_png(const uint8_t* buf, size_t len) {
  ImageU8 img;
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return img;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return img;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return img;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);           // palette/gray → rgb, bit depth ≥ 8
  png_set_strip_16(png);         // 16-bit → 8-bit
  png_set_strip_alpha(png);      // drop alpha
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  img.w = png_get_image_width(png, info);
  img.h = png_get_image_height(png, info);
  if (png_get_channels(png, info) != 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return img;
  }
  img.data.resize(size_t(img.w) * img.h * 3);
  std::vector<png_bytep> rows(img.h);
  for (int y = 0; y < img.h; ++y)
    rows[y] = img.data.data() + size_t(y) * img.w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  img.ok = true;
  return img;
}

ImageU8 decode_image(const uint8_t* buf, size_t len) {
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf, len);
  return decode_png(buf, len);
}

// Header-only dimension probe: jpeg_read_header / png_read_info give w/h
// without decoding any scanlines (a full decode just to learn the size
// doubled the host cost of the two-call ctypes protocol).
bool decode_dims(const uint8_t* buf, size_t len, int* w, int* h) {
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  *w = (int)png_get_image_width(png, info);
  *h = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// Raw file bytes (shared by load_file and the dims probe).
bool read_file_bytes(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) {
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  buf->resize(n);
  size_t rd = fread(buf->data(), 1, n, f);
  fclose(f);
  return (long)rd == n;
}

ImageU8 load_file(const char* path) {
  std::vector<uint8_t> buf;
  if (!read_file_bytes(path, &buf)) return ImageU8();
  return decode_image(buf.data(), buf.size());
}

// -------- contain-resize + pad + normalize --------

// PIL ImageOps.contain sizing: Python round() = ROUND HALF TO EVEN on the
// scaled side (nearbyint under the default FP rounding mode); naive +0.5
// half-up differs at exact .5 ties (e.g. 250x1000 → 674: 168.5 → 168, not
// 169) and changes the whole canvas geometry.
void contain_size(int w, int h, int target, int* nw, int* nh) {
  if (w >= h) {
    *nw = target;
    *nh = (int)std::nearbyint((double)h * target / w);
    if (*nh < 1) *nh = 1;
  } else {
    *nh = target;
    *nw = (int)std::nearbyint((double)w * target / h);
    if (*nw < 1) *nw = 1;
  }
}

// ---- PIL-convention BICUBIC resampling ----
//
// ImageOps.contain (the reference's resize, demo.py:39-43) uses PIL's
// default BICUBIC resample: a separable convolution whose support widens
// with the downscale factor (area-average-like when shrinking — NOT naive
// 4-tap bicubic interpolation), with per-output-pixel normalized weights,
// run horizontally into a uint8 intermediate and then vertically (each
// pass rounds+clips to uint8 like PIL's 8-bit path). Matching this keeps
// the native loader's tensors within 1/255 of the PIL path — the earlier
// bilinear version diverged by several levels per pixel, enough to move
// meshes in a real-weight parity check.

inline double bicubic_kernel(double x) {
  // Catmull-Rom (a = -0.5), PIL's "BICUBIC"
  const double a = -0.5;
  if (x < 0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct AxisWeights {
  std::vector<int> first;              // per out pixel: first source index
  std::vector<std::vector<double>> k;  // per out pixel: normalized weights
};

AxisWeights build_axis_weights(int in_size, int out_size) {
  AxisWeights ax;
  ax.first.resize(out_size);
  ax.k.resize(out_size);
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;  // bicubic support = 2
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    ax.first[xx] = xmin;
    auto& k = ax.k[xx];
    k.resize(xmax - xmin);
    double ww = 0.0;
    for (int x = 0; x < xmax - xmin; ++x) {
      double w = bicubic_kernel((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0)
      for (auto& w : k) w /= ww;
  }
  return ax;
}

inline uint8_t clip8_round(double v) {
  // PIL's fixed-point rounding is (ss + half) >> bits == floor(v + 0.5)
  long r = (long)std::floor(v + 0.5);
  if (r < 0) return 0;
  if (r > 255) return 255;
  return (uint8_t)r;
}

// Contain-resize (PIL BICUBIC) + centered zero-pad + normalize into dst.
void resize_normalize_into(const ImageU8& img, int target, float* dst,
                           bool imagenet_norm) {
  int nw, nh;
  contain_size(img.w, img.h, target, &nw, &nh);
  // PIL ImageOps.pad centers with round(diff*0.5) HALF-TO-EVEN — truncating
  // division shifts the image one row/column for diff ≡ 3 (mod 4)
  const int off_x = (int)std::nearbyint((target - nw) * 0.5);
  const int off_y = (int)std::nearbyint((target - nh) * 0.5);
  // zero-padding corresponds to pixel value 0 → normalized (0-mean)/std
  for (int c = 0; c < 3; ++c) {
    float pad = imagenet_norm ? (0.f - kMean[c]) / kStd[c] : 0.f;
    for (size_t i = c; i < size_t(target) * target * 3; i += 3) dst[i] = pad;
  }

  // horizontal pass: [h, w] → [h, nw], uint8 intermediate like PIL
  AxisWeights axx = build_axis_weights(img.w, nw);
  std::vector<uint8_t> tmp(size_t(img.h) * nw * 3);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t* row = img.data.data() + size_t(y) * img.w * 3;
    uint8_t* out = tmp.data() + size_t(y) * nw * 3;
    for (int x = 0; x < nw; ++x) {
      const auto& k = axx.k[x];
      int x0 = axx.first[x];
      double s0 = 0, s1 = 0, s2 = 0;
      for (size_t i = 0; i < k.size(); ++i) {
        const uint8_t* p = row + size_t(x0 + i) * 3;
        s0 += k[i] * p[0];
        s1 += k[i] * p[1];
        s2 += k[i] * p[2];
      }
      out[x * 3 + 0] = clip8_round(s0);
      out[x * 3 + 1] = clip8_round(s1);
      out[x * 3 + 2] = clip8_round(s2);
    }
  }

  // vertical pass: [h, nw] → [nh, nw], rounded to uint8 then normalized
  AxisWeights axy = build_axis_weights(img.h, nh);
  for (int y = 0; y < nh; ++y) {
    const auto& k = axy.k[y];
    int y0 = axy.first[y];
    for (int x = 0; x < nw; ++x) {
      double s0 = 0, s1 = 0, s2 = 0;
      for (size_t i = 0; i < k.size(); ++i) {
        const uint8_t* p = tmp.data() + (size_t(y0 + i) * nw + x) * 3;
        s0 += k[i] * p[0];
        s1 += k[i] * p[1];
        s2 += k[i] * p[2];
      }
      float* out = dst + (size_t(y + off_y) * target + (x + off_x)) * 3;
      double v[3] = {clip8_round(s0) / 255.0, clip8_round(s1) / 255.0,
                     clip8_round(s2) / 255.0};
      for (int c = 0; c < 3; ++c)
        out[c] = imagenet_norm ? (float)((v[c] - kMean[c]) / kStd[c])
                               : (float)v[c];
    }
  }
}

// ---------------- prefetching batch loader ----------------

struct Loader {
  std::vector<std::string> paths;
  int img_size = 0;
  int n_threads = 0;
  bool imagenet_norm = true;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<std::pair<int, std::vector<float>>> ready;  // (index, tensor)
  size_t max_queue = 8;
  std::atomic<int> next_idx{0};
  std::atomic<bool> stop{false};
  int delivered = 0;  // guarded by mu; every valid index is enqueued exactly once

  void worker() {
    while (!stop.load()) {
      int idx = next_idx.fetch_add(1);
      if (idx >= (int)paths.size()) break;
      // exceptions (bad_alloc on decompression bombs, …) must NOT escape
      // the thread — that would std::terminate the whole Python process;
      // the loader contract encodes per-file failure as index -(i+1).
      // The guard covers decode AND resize (its h×nw intermediate can be
      // the allocation that actually throws).
      bool ok = false;
      std::vector<float> out;
      try {
        ImageU8 img = load_file(paths[idx].c_str());
        out.assign(size_t(img_size) * img_size * 3, 0.f);
        if (img.ok) {
          resize_normalize_into(img, img_size, out.data(), imagenet_norm);
          ok = true;
        }
      } catch (...) {
        out.assign(size_t(img_size) * img_size * 3, 0.f);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) break;
      ready.emplace(ok ? idx : -(idx + 1), std::move(out));
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

// Decode + preprocess one file into dst [img_size, img_size, 3] float32.
// Returns 1 on success, 0 on failure.
int mh_preprocess_file(const char* path, int img_size, int imagenet_norm,
                       float* dst) {
  ImageU8 img = load_file(path);
  if (!img.ok) return 0;
  resize_normalize_into(img, img_size, dst, imagenet_norm != 0);
  return 1;
}

// Preprocess raw HWC u8 pixels (already decoded) into dst.
int mh_preprocess_pixels(const uint8_t* pixels, int h, int w, int img_size,
                         int imagenet_norm, float* dst) {
  ImageU8 img;
  img.w = w;
  img.h = h;
  img.data.assign(pixels, pixels + size_t(h) * w * 3);
  img.ok = true;
  resize_normalize_into(img, img_size, dst, imagenet_norm != 0);
  return 1;
}

// Decode only: returns w/h via out params; writes RGB u8 into dst if
// dst_capacity is large enough. Call with dst=null to query the size —
// that path reads only the image HEADER (no scanline decode).
int mh_decode_file(const char* path, int* out_h, int* out_w, uint8_t* dst,
                   int64_t dst_capacity) {
  if (dst == nullptr) {
    std::vector<uint8_t> buf;
    if (!read_file_bytes(path, &buf)) return 0;
    int w = 0, h = 0;
    if (!decode_dims(buf.data(), buf.size(), &w, &h)) return 0;
    *out_h = h;
    *out_w = w;
    return 1;
  }
  ImageU8 img = load_file(path);
  if (!img.ok) return 0;
  *out_h = img.h;
  *out_w = img.w;
  if ((int64_t)img.data.size() > dst_capacity) return 0;
  memcpy(dst, img.data.data(), img.data.size());
  return 1;
}

void* mh_loader_create(const char** paths, int n_paths, int img_size,
                       int n_threads, int imagenet_norm, int max_queue) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->img_size = img_size;
  L->imagenet_norm = imagenet_norm != 0;
  L->n_threads = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (max_queue > 0) L->max_queue = max_queue;
  for (int i = 0; i < L->n_threads; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until the next preprocessed image is ready. Returns the image index
// (order is NOT guaranteed), or -1 - index when decoding failed (tensor is
// zeros), or -2^30 when the loader is exhausted.
int mh_loader_next(void* handle, float* dst) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->delivered >= (int)L->paths.size()) return -(1 << 30);
  L->cv_ready.wait(lk, [&] { return !L->ready.empty(); });
  auto item = std::move(L->ready.front());
  L->ready.pop();
  L->delivered++;
  L->cv_space.notify_one();
  lk.unlock();
  memcpy(dst, item.second.data(),
         sizeof(float) * L->img_size * L->img_size * 3);
  return item.first;  // negative -(i+1) encodes decode failure for i
}

int mh_loader_total(void* handle) {
  return (int)static_cast<Loader*>(handle)->paths.size();
}

void mh_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
