// Native data loader: multi-threaded JPEG/PNG decode + bilinear resize +
// ImageNet normalization, producing NHWC float32 batches ready for the
// device. This is the TPU build's native runtime tier for input (the
// reference relies on Python PIL + torch DataLoader workers,
// ref:src/dataset.py:215-258); sustaining ~1k img/s/chip needs the host
// decode path off the GIL.
//
// Resize semantics: bilinear with half-pixel source coordinates and border
// replication — identical to torch F.interpolate(align_corners=False,
// antialias=False) and to nn/torch_interp.py. (The exact-parity inference
// path uses PIL's antialiased resize on the Python side; this loader is the
// throughput path.)
//
// Exposed C ABI (ctypes):
//   int caim_decode_resize_batch(const char** paths, int n,
//                                int out_h, int out_w,
//                                float* out,        // [n, out_h, out_w, 3]
//                                unsigned char* ok, // [n] 1=success
//                                int n_threads, int normalize);

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

struct ImageU8 {
  std::vector<unsigned char> data;  // HWC, 3 channels
  int h = 0, w = 0;
};

// ----------------------------------------------------------- JPEG decode ---
struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(FILE* f, ImageU8* out,
                 std::vector<unsigned char>* exif_out = nullptr) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (exif_out)  // capture the EXIF APP1 payload during header parse —
                 // the file is read ONCE for both pixels and metadata
    jpeg_save_markers(&cinfo, JPEG_APP0 + 1, 0xFFFF);
  jpeg_read_header(&cinfo, TRUE);
  if (exif_out) {
    for (jpeg_saved_marker_ptr m = cinfo.marker_list; m; m = m->next) {
      if (m->marker == JPEG_APP0 + 1 && m->data_length >= 6 &&
          memcmp(m->data, "Exif\0\0", 6) == 0) {
        exif_out->assign(m->data, m->data + m->data_length);
        break;
      }
    }
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ------------------------------------------------------------ PNG decode ---
bool decode_png(FILE* f, ImageU8* out) {
  png_byte header[8];
  if (fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) return false;
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
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);
  png_set_expand(png);           // palette/gray/low-bit -> 8-bit
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, ImageU8* out,
                 std::vector<unsigned char>* exif_out = nullptr) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[2] = {0, 0};
  size_t got = fread(magic, 1, 2, f);
  rewind(f);
  bool ok = false;
  if (got == 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out, exif_out);
  } else if (got == 2 && magic[0] == 0x89 && magic[1] == 'P') {
    ok = decode_png(f, out);  // PNG eXIf chunks are rare; PIL fallback
  }
  fclose(f);
  return ok && out->w > 0 && out->h > 0;
}

// -------------------------------------------------- resize + normalize -----
void resize_normalize(const ImageU8& img, int out_h, int out_w, float* dst,
                      bool normalize) {
  const float sy = float(img.h) / out_h;
  const float sx = float(img.w) / out_w;
  std::vector<int> x0v(out_w), x1v(out_w);
  std::vector<float> txv(out_w);
  for (int x = 0; x < out_w; ++x) {
    float src = (x + 0.5f) * sx - 0.5f;
    int x0 = int(std::floor(src));
    txv[x] = src - x0;
    x0v[x] = x0 < 0 ? 0 : (x0 >= img.w ? img.w - 1 : x0);
    int x1 = x0 + 1;
    x1v[x] = x1 < 0 ? 0 : (x1 >= img.w ? img.w - 1 : x1);
  }
  for (int y = 0; y < out_h; ++y) {
    float srcy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(std::floor(srcy));
    float ty = srcy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1 = y0 + 1;
    int y1c = y1 < 0 ? 0 : (y1 >= img.h ? img.h - 1 : y1);
    const unsigned char* r0 = img.data.data() + size_t(y0c) * img.w * 3;
    const unsigned char* r1 = img.data.data() + size_t(y1c) * img.w * 3;
    float* orow = dst + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float tx = txv[x];
      int xa = x0v[x] * 3, xb = x1v[x] * 3;
      for (int c = 0; c < 3; ++c) {
        float top = r0[xa + c] * (1.f - tx) + r0[xb + c] * tx;
        float bot = r1[xa + c] * (1.f - tx) + r1[xb + c] * tx;
        float v = (top * (1.f - ty) + bot * ty) / 255.f;
        if (normalize) v = (v - kMean[c]) / kStd[c];
        orow[x * 3 + c] = v;
      }
    }
  }
}

}  // namespace

namespace {

// u8 variant: resized RGB bytes (for minimal host->device transfer; the
// device fuses /255 + ImageNet normalization into the jitted forward)
void resize_u8(const ImageU8& img, int out_h, int out_w, unsigned char* dst) {
  const float sy = float(img.h) / out_h;
  const float sx = float(img.w) / out_w;
  for (int y = 0; y < out_h; ++y) {
    float srcy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(std::floor(srcy));
    float ty = srcy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1 = y0 + 1;
    int y1c = y1 < 0 ? 0 : (y1 >= img.h ? img.h - 1 : y1);
    const unsigned char* r0 = img.data.data() + size_t(y0c) * img.w * 3;
    const unsigned char* r1 = img.data.data() + size_t(y1c) * img.w * 3;
    unsigned char* orow = dst + size_t(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      float src = (x + 0.5f) * sx - 0.5f;
      int x0 = int(std::floor(src));
      float tx = src - x0;
      int xa = (x0 < 0 ? 0 : (x0 >= img.w ? img.w - 1 : x0)) * 3;
      int x1 = x0 + 1;
      int xb = (x1 < 0 ? 0 : (x1 >= img.w ? img.w - 1 : x1)) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = r0[xa + c] * (1.f - tx) + r0[xb + c] * tx;
        float bot = r1[xa + c] * (1.f - tx) + r1[xb + c] * tx;
        float v = top * (1.f - ty) + bot * ty;
        orow[x * 3 + c] = (unsigned char)(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

int caim_decode_resize_batch_u8(const char** paths, int n, int out_h,
                                int out_w, unsigned char* out,
                                unsigned char* ok, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> n_ok(0);
  const size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ImageU8 img;
      if (decode_file(paths[i], &img)) {
        resize_u8(img, out_h, out_w, out + stride * i);
        ok[i] = 1;
        n_ok.fetch_add(1);
      } else {
        memset(out + stride * i, 0, stride);
        ok[i] = 0;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return n_ok.load();
}

// Combined pixels+EXIF read: same as the u8 variant but also returns each
// JPEG's raw EXIF APP1 payload ("Exif\0\0" + TIFF blob, parsed host-side by
// PIL.Image.Exif.load without reopening the file). exif_out is [n, exif_cap]
// bytes, exif_lens[i] = payload length copied (0 = none / PNG / truncated-
// oversize). Kills the second per-file host I/O pass that made serving
// host-bound on small-core hosts.
int caim_decode_resize_batch_u8_exif(const char** paths, int n, int out_h,
                                     int out_w, unsigned char* out,
                                     unsigned char* ok,
                                     unsigned char* exif_out, int* exif_lens,
                                     int exif_cap, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> n_ok(0);
  const size_t stride = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ImageU8 img;
      std::vector<unsigned char> exif;
      exif_lens[i] = 0;
      if (decode_file(paths[i], &img, &exif)) {
        resize_u8(img, out_h, out_w, out + stride * i);
        ok[i] = 1;
        n_ok.fetch_add(1);
        if (!exif.empty() && int(exif.size()) <= exif_cap) {
          memcpy(exif_out + size_t(i) * exif_cap, exif.data(), exif.size());
          exif_lens[i] = int(exif.size());
        }
      } else {
        memset(out + stride * i, 0, stride);
        ok[i] = 0;
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return n_ok.load();
}

int caim_decode_resize_batch(const char** paths, int n, int out_h, int out_w,
                             float* out, unsigned char* ok, int n_threads,
                             int normalize) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> n_ok(0);
  const size_t stride = size_t(out_h) * out_w * 3;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      ImageU8 img;
      if (decode_file(paths[i], &img)) {
        resize_normalize(img, out_h, out_w, out + stride * i, normalize != 0);
        ok[i] = 1;
        n_ok.fetch_add(1);
      } else {
        memset(out + stride * i, 0, stride * sizeof(float));
        ok[i] = 0;
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return n_ok.load();
}

}  // extern "C"
