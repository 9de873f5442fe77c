// Native dataset loader: threaded PNG decode + half-resolution resize.
//
// The reference's Dataset::NextFrame (src/dataset.cpp:53-86) decodes two
// PNGs and resizes them synchronously on the tracking thread via OpenCV.
// Here decode/resize runs in a worker pool that prefetches ahead of the
// consumer, so host I/O overlaps device compute; frames are handed out
// strictly in order.  Exposed as a small C API consumed via ctypes
// (legoslam/native/loader.py).
//
// Build: g++ -O3 -shared -fPIC loader.cpp -o libloader.so -lpng -lpthread

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  std::vector<float> data;  // grayscale 0..255
};

// Decode an 8/16-bit PNG to grayscale float (libpng does the channel
// conversions; 16-bit is stripped to 8 as in cv::imread's default path).
bool decode_png_gray(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    // ITU-R BT.601 luma, matching cv::IMREAD_GRAYSCALE.
    png_set_rgb_to_gray_fixed(png, 1, 29900, 58700);
  }
  png_read_update_info(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->data.resize(static_cast<size_t>(w) * h);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + static_cast<size_t>(y) * w;
    for (png_uint_32 x = 0; x < w; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// cv::resize INTER_NEAREST at exactly 0.5: even rows/cols (dataset.cpp:76).
void nearest_half(const Image& src, Image* dst) {
  dst->width = src.width / 2;
  dst->height = src.height / 2;
  dst->data.resize(static_cast<size_t>(dst->width) * dst->height);
  for (int y = 0; y < dst->height; ++y) {
    const float* s = src.data.data() + static_cast<size_t>(2 * y) * src.width;
    float* d = dst->data.data() + static_cast<size_t>(y) * dst->width;
    for (int x = 0; x < dst->width; ++x) d[x] = s[2 * x];
  }
}

struct Frame {
  int index = -1;
  Image left, right;
  bool ok = false;
};

class Loader {
 public:
  Loader(std::string dir, int start, int count, bool half, int workers, int prefetch)
      : dir_(std::move(dir)), start_(start), count_(count), half_(half), prefetch_(prefetch) {
    next_to_decode_.store(start_);
    for (int i = 0; i < workers; ++i) threads_.emplace_back([this] { Work(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : threads_) t.join();
  }

  // Blocking, in-order. Returns false at end of sequence or on decode error.
  bool Next(Frame* out) {
    std::unique_lock<std::mutex> lock(mu_);
    int want = next_to_consume_;
    if (want >= start_ + count_) return false;
    cv_ready_.wait(lock, [&] { return stop_ || ready_.count(want) > 0; });
    if (stop_ && ready_.count(want) == 0) return false;
    *out = std::move(ready_[want]);
    ready_.erase(want);
    ++next_to_consume_;
    cv_space_.notify_all();
    return out->ok;
  }

 private:
  void Work() {
    for (;;) {
      int idx = next_to_decode_.fetch_add(1);
      if (idx >= start_ + count_) return;
      Frame fr;
      fr.index = idx;
      char path[1024];
      Image raw_l, raw_r;
      snprintf(path, sizeof(path), "%s/image_0/%06d.png", dir_.c_str(), idx);
      bool ok_l = decode_png_gray(path, &raw_l);
      snprintf(path, sizeof(path), "%s/image_1/%06d.png", dir_.c_str(), idx);
      bool ok_r = decode_png_gray(path, &raw_r);
      fr.ok = ok_l && ok_r;
      if (fr.ok) {
        if (half_) {
          nearest_half(raw_l, &fr.left);
          nearest_half(raw_r, &fr.right);
        } else {
          fr.left = std::move(raw_l);
          fr.right = std::move(raw_r);
        }
      }
      std::unique_lock<std::mutex> lock(mu_);
      // Bound the prefetch window so memory stays flat.
      cv_space_.wait(lock, [&] { return stop_ || idx < next_to_consume_ + prefetch_; });
      if (stop_) return;
      ready_[idx] = std::move(fr);
      cv_ready_.notify_all();
    }
  }

  std::string dir_;
  int start_, count_;
  bool half_;
  int prefetch_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::map<int, Frame> ready_;
  std::atomic<int> next_to_decode_{0};
  int next_to_consume_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* ls_loader_open(const char* dir, int start, int count, int half, int workers, int prefetch) {
  auto* l = new Loader(dir, start, count, half != 0, workers > 0 ? workers : 4,
                       prefetch > 0 ? prefetch : 8);
  return l;
}

// Returns: 1 frame produced, 0 end-of-sequence/failure.  Buffers must hold
// width*height floats (query the size first via ls_probe_size).
int ls_loader_next(void* handle, float* left, float* right, int* frame_index,
                   int* width, int* height, int capacity) {
  auto* l = static_cast<Loader*>(handle);
  Frame fr;
  if (!l->Next(&fr)) return 0;
  int n = fr.left.width * fr.left.height;
  if (n > capacity || fr.right.width != fr.left.width || fr.right.height != fr.left.height)
    return 0;
  memcpy(left, fr.left.data.data(), sizeof(float) * n);
  memcpy(right, fr.right.data.data(), sizeof(float) * n);
  *frame_index = fr.index;
  *width = fr.left.width;
  *height = fr.left.height;
  return 1;
}

void ls_loader_close(void* handle) { delete static_cast<Loader*>(handle); }

// Decode a single PNG (for probing sizes / tests). Returns 1 on success.
int ls_decode_png(const char* path, float* buffer, int capacity, int* width, int* height,
                  int half) {
  Image img;
  if (!decode_png_gray(path, &img)) return 0;
  Image out;
  if (half) {
    nearest_half(img, &out);
  } else {
    out = std::move(img);
  }
  int n = out.width * out.height;
  if (buffer) {
    if (n > capacity) return 0;
    memcpy(buffer, out.data.data(), sizeof(float) * n);
  }
  *width = out.width;
  *height = out.height;
  return 1;
}

}  // extern "C"
