// Native dataset IO for supereight_tpu_torch: mmap'd SLAMBench .raw reader
// with a background prefetch thread, plus host-side frame preprocessing
// (decimation + mm->m conversion) so the accelerator only ever sees ready
// float frames.
//
// Reference counterparts: RawDepthReader (se_apps/include/interface.h:286-499,
// seek-based fread per frame) and mm2metersKernel (se_denseslam/src/
// preprocessing.cpp:161-188).  This implementation replaces per-frame
// fread+memcpy with zero-copy mmap and overlaps disk/page-cache latency with
// device compute via a simple double-buffered prefetcher.
//
// C ABI only (consumed via ctypes from supereight_tpu_torch.io.native).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct RawFile {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t bytes = 0;
  uint32_t width = 0, height = 0;
  size_t frame_bytes = 0;
  size_t num_frames = 0;

  // prefetch state: one decoded float frame ahead
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<float> staged;      // decoded frame (meters, decimated)
  long staged_idx = -1;           // which frame is staged (-1: none)
  long want_idx = -1;             // frame requested for staging
  int out_w = 0, out_h = 0, ratio = 1;
  std::atomic<bool> stop{false};

  ~RawFile() {
    stop = true;
    {
      std::lock_guard<std::mutex> l(mu);
      want_idx = -2;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
    if (base) munmap(const_cast<uint8_t*>(base), bytes);
    if (fd >= 0) close(fd);
  }

  const uint16_t* depth_ptr(size_t frame) const {
    return reinterpret_cast<const uint16_t*>(base + frame * frame_bytes + 8);
  }
  const uint8_t* rgb_ptr(size_t frame) const {
    return base + frame * frame_bytes + 8 +
           size_t(width) * height * sizeof(uint16_t) + 8;
  }

  void decode_into(long frame, float* out) const {
    // decimate by pixel striding + mm->m (preprocessing.cpp:178-186)
    const uint16_t* d = depth_ptr(frame);
    for (int y = 0; y < out_h; ++y) {
      const uint16_t* row = d + size_t(y) * ratio * width;
      float* orow = out + size_t(y) * out_w;
      for (int x = 0; x < out_w; ++x) orow[x] = row[x * ratio] * 1e-3f;
    }
  }

  void prefetch_loop() {
    std::unique_lock<std::mutex> l(mu);
    while (!stop) {
      cv.wait(l, [&] { return want_idx != staged_idx || stop; });
      if (stop || want_idx < 0) {
        if (want_idx == -2) return;
        continue;
      }
      long idx = want_idx;
      l.unlock();
      std::vector<float> buf(size_t(out_w) * out_h);
      if (idx < long(num_frames)) decode_into(idx, buf.data());
      l.lock();
      if (want_idx == idx) {
        staged.swap(buf);
        staged_idx = idx;
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

// Open a .raw stream; ratio = compute-size decimation. Returns handle or 0.
void* se_raw_open(const char* path, int ratio) {
  auto* f = new RawFile();
  f->fd = open(path, O_RDONLY);
  if (f->fd < 0) { delete f; return nullptr; }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 8) { delete f; return nullptr; }
  f->bytes = size_t(st.st_size);
  f->base = static_cast<const uint8_t*>(
      mmap(nullptr, f->bytes, PROT_READ, MAP_PRIVATE, f->fd, 0));
  if (f->base == MAP_FAILED) { f->base = nullptr; delete f; return nullptr; }
  memcpy(&f->width, f->base, 4);
  memcpy(&f->height, f->base + 4, 4);
  // Never trust the mmap'd header: a corrupt/truncated file would otherwise
  // produce zero dims or frame pointers past the mapping (SIGBUS in
  // decode_into).  Bound dims, require at least one whole frame, and require
  // every per-frame header to agree with frame 0.
  if (f->width <= 0 || f->height <= 0 ||
      f->width > 16384 || f->height > 16384) {
    munmap(const_cast<uint8_t*>(f->base), f->bytes);
    f->base = nullptr; delete f; return nullptr;
  }
  f->frame_bytes = 16 + size_t(f->width) * f->height * (2 + 3);
  if (f->bytes < f->frame_bytes) {
    munmap(const_cast<uint8_t*>(f->base), f->bytes);
    f->base = nullptr; delete f; return nullptr;
  }
  f->num_frames = f->bytes / f->frame_bytes;
  for (size_t i = 0; i < f->num_frames; ++i) {
    int32_t w, h;
    memcpy(&w, f->base + i * f->frame_bytes, 4);
    memcpy(&h, f->base + i * f->frame_bytes + 4, 4);
    if (w != f->width || h != f->height) {  // disagreeing frame header
      f->num_frames = i;                    // expose only the valid prefix
      break;
    }
  }
  if (f->num_frames == 0) {
    munmap(const_cast<uint8_t*>(f->base), f->bytes);
    f->base = nullptr; delete f; return nullptr;
  }
  f->ratio = ratio > 0 ? ratio : 1;
  f->out_w = f->width / f->ratio;
  f->out_h = f->height / f->ratio;
  f->worker = std::thread([f] { f->prefetch_loop(); });
  return f;
}

int se_raw_width(void* h) { return static_cast<RawFile*>(h)->out_w; }
int se_raw_height(void* h) { return static_cast<RawFile*>(h)->out_h; }
long se_raw_frames(void* h) {
  return long(static_cast<RawFile*>(h)->num_frames);
}

// Blocking read of the decoded float frame (meters, decimated); kicks off
// prefetch of frame+1. Returns 0 on success.
int se_raw_read(void* h, long frame, float* out) {
  auto* f = static_cast<RawFile*>(h);
  if (frame < 0 || frame >= long(f->num_frames)) return -1;
  std::unique_lock<std::mutex> l(f->mu);
  if (f->staged_idx == frame) {
    memcpy(out, f->staged.data(), f->staged.size() * sizeof(float));
  } else {
    l.unlock();
    f->decode_into(frame, out);
    l.lock();
  }
  f->want_idx = frame + 1;   // stage the next frame in the background
  f->cv.notify_all();
  return 0;
}

// Raw (undecimated) uint16 depth access, zero-copy semantics via memcpy of
// the mmap'd page range.
int se_raw_read_depth_mm(void* h, long frame, uint16_t* out) {
  auto* f = static_cast<RawFile*>(h);
  if (frame < 0 || frame >= long(f->num_frames)) return -1;
  memcpy(out, f->depth_ptr(frame), size_t(f->width) * f->height * 2);
  return 0;
}

int se_raw_read_rgb(void* h, long frame, uint8_t* out) {
  auto* f = static_cast<RawFile*>(h);
  if (frame < 0 || frame >= long(f->num_frames)) return -1;
  memcpy(out, f->rgb_ptr(frame), size_t(f->width) * f->height * 3);
  return 0;
}

void se_raw_close(void* h) { delete static_cast<RawFile*>(h); }

// ---------------------------------------------------------------------
// scene2raw: ICL-NUIM text depth -> SLAMBench .raw (se_tools/scene2raw.cpp).
// depth_txt: w*h whitespace-separated floats (euclidean ray lengths);
// converts to planar z-depth in mm using the given intrinsics.
// ---------------------------------------------------------------------
int se_scene2raw_frame(const float* euclidean, int w, int h, float fx,
                       float fy, float cx, float cy, uint16_t* out_mm) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float u = (x - cx) / fx;
      float v = (y - cy) / fy;
      float r = euclidean[size_t(y) * w + x];
      float z = r / std::sqrt(u * u + v * v + 1.0f);
      float mm = z * 1000.0f;
      out_mm[size_t(y) * w + x] =
          mm < 0 ? 0 : (mm > 65535.f ? 65535 : uint16_t(mm + 0.5f));
    }
  }
  return 0;
}

}  // extern "C"
