// dbsr_io — native IO runtime: 16-bit PNG codec, threaded burst loader and
// the libjpeg decoder (the port's copy of the repository's
// native/dbsr_io.cpp; the code is that file's, the JPEG half behind
// DBSR_IO_NO_JPEG).
//
// Built with libjpeg:     g++ -O3 -std=c++17 -fPIC -shared dbsr_io.cpp \
//                             -o libdbsr_io.so -lz -ljpeg -lpthread
// Without it (no jpeglib.h on the host), the PNG half with zlib alone:
//                         g++ ... -DDBSR_IO_NO_JPEG dbsr_io.cpp -lz -lpthread
// dbsr_io_has_jpeg() says which was built. One change to the code:
// dbsr_load_burst checks a frame's size from its header before decoding it
// into the shared buffer (the original decodes first, and a frame of
// another size overruns it). Exposed through a plain C ABI for ctypes
// (dbsr_tpu_torch/utils/native_io.py).

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first
#ifndef DBSR_IO_NO_JPEG
#include <jpeglib.h>
#endif
#include <zlib.h>

#include <atomic>
#include <csetjmp>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct PngInfo {
  uint32_t width = 0;
  uint32_t height = 0;
  uint8_t depth = 0;      // bits per sample: 8 or 16
  uint8_t channels = 0;   // 1..4
};

constexpr uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int channels_for_color_type(uint8_t ct) {
  switch (ct) {
    case 0: return 1;
    case 2: return 3;
    case 4: return 2;
    case 6: return 4;
    default: return -1;  // palette unsupported
  }
}

// Parse IHDR + gather IDAT extents. Returns 0 on success.
int parse_png(const uint8_t* buf, size_t len, PngInfo* info,
              std::vector<std::pair<size_t, size_t>>* idat_spans) {
  if (len < 8 || memcmp(buf, kSig, 8) != 0) return -1;
  size_t pos = 8;
  bool have_ihdr = false;
  while (pos + 12 <= len) {
    uint32_t chunk_len = be32(buf + pos);
    const uint8_t* tag = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 12 + chunk_len > len) return -2;
    if (memcmp(tag, "IHDR", 4) == 0) {
      if (chunk_len != 13) return -3;
      info->width = be32(data);
      info->height = be32(data + 4);
      info->depth = data[8];
      int ch = channels_for_color_type(data[9]);
      if (ch < 0) return -4;
      info->channels = uint8_t(ch);
      if (data[12] != 0) return -5;  // interlaced unsupported
      have_ihdr = true;
    } else if (memcmp(tag, "IDAT", 4) == 0) {
      idat_spans->emplace_back(pos + 8, chunk_len);
    } else if (memcmp(tag, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + chunk_len;
  }
  return have_ihdr ? 0 : -6;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Undo PNG scanline filters in place over the decompressed stream
// (rows of [filter_byte, bpr bytes]) writing reconstructed rows to out.
void unfilter(const uint8_t* raw, uint8_t* out, uint32_t height,
              size_t bpr, int bpp) {
  std::vector<uint8_t> zero(bpr, 0);
  const uint8_t* prev = zero.data();
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t f = raw[y * (bpr + 1)];
    const uint8_t* line = raw + y * (bpr + 1) + 1;
    uint8_t* rec = out + y * bpr;
    switch (f) {
      case 0:
        memcpy(rec, line, bpr);
        break;
      case 1:  // Sub
        memcpy(rec, line, bpp);
        for (size_t x = bpp; x < bpr; ++x)
          rec[x] = uint8_t(line[x] + rec[x - bpp]);
        break;
      case 2:  // Up
        for (size_t x = 0; x < bpr; ++x) rec[x] = uint8_t(line[x] + prev[x]);
        break;
      case 3:  // Average
        for (size_t x = 0; x < size_t(bpp); ++x)
          rec[x] = uint8_t(line[x] + prev[x] / 2);
        for (size_t x = bpp; x < bpr; ++x)
          rec[x] = uint8_t(line[x] + (rec[x - bpp] + prev[x]) / 2);
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < size_t(bpp); ++x)
          rec[x] = uint8_t(line[x] + paeth(0, prev[x], 0));
        for (size_t x = bpp; x < bpr; ++x)
          rec[x] = uint8_t(line[x] + paeth(rec[x - bpp], prev[x],
                                           prev[x - bpp]));
        break;
      default:
        memcpy(rec, line, bpr);
    }
    prev = rec;
  }
}

int decode_impl(const uint8_t* buf, size_t len, uint8_t* out,
                PngInfo* info_out) {
  PngInfo info;
  std::vector<std::pair<size_t, size_t>> spans;
  int rc = parse_png(buf, len, &info, &spans);
  if (rc != 0) return rc;
  if (info.depth != 8 && info.depth != 16) return -7;

  size_t bpr = (size_t(info.width) * info.channels * info.depth + 7) / 8;
  size_t raw_size = (bpr + 1) * info.height;
  std::vector<uint8_t> raw(raw_size);

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -8;
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw_size);
  for (auto& span : spans) {
    zs.next_in = const_cast<uint8_t*>(buf + span.first);
    zs.avail_in = uInt(span.second);
    int zrc = inflate(&zs, Z_NO_FLUSH);
    if (zrc != Z_OK && zrc != Z_STREAM_END) {
      inflateEnd(&zs);
      return -9;
    }
  }
  inflateEnd(&zs);

  int bpp = info.channels * info.depth / 8;
  unfilter(raw.data(), out, info.height, bpr, bpp);

  // PNG 16-bit samples are big-endian; swap to host little-endian.
  if (info.depth == 16) {
    size_t n = bpr * info.height / 2;
    uint8_t* p = out;
    for (size_t i = 0; i < n; ++i, p += 2) {
      uint8_t t = p[0];
      p[0] = p[1];
      p[1] = t;
    }
  }
  if (info_out) *info_out = info;
  return 0;
}

#ifndef DBSR_IO_NO_JPEG
// --------------------------------------------------------------------------
// JPEG (libjpeg-turbo)

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode an in-memory JPEG to RGB8. If out == nullptr, only fills info.
// Returns 0 on success.
int jpeg_decode_impl(const uint8_t* buf, size_t len, uint8_t* out, int* w,
                     int* h, int* c) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -20;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -21;
  }
  cinfo.out_color_space = JCS_RGB;
  if (w) *w = int(cinfo.image_width);
  if (h) *h = int(cinfo.image_height);
  if (c) *c = 3;
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  size_t row_bytes = size_t(cinfo.output_width) * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + size_t(cinfo.output_scanline) * row_bytes;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

#endif  // DBSR_IO_NO_JPEG

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf->resize(size_t(sz));
  size_t got = fread(buf->data(), 1, size_t(sz), f);
  fclose(f);
  return got == size_t(sz) ? 0 : -2;
}

}  // namespace

extern "C" {

// Parse header only: fills w/h/channels/depth. Returns 0 on success.
int dbsr_png_info(const uint8_t* buf, size_t len, int* w, int* h, int* c,
                  int* depth) {
  PngInfo info;
  std::vector<std::pair<size_t, size_t>> spans;
  int rc = parse_png(buf, len, &info, &spans);
  if (rc != 0) return rc;
  *w = int(info.width);
  *h = int(info.height);
  *c = int(info.channels);
  *depth = int(info.depth);
  return 0;
}

// Decode into caller-allocated out (h*w*c samples, native-endian).
int dbsr_png_decode(const uint8_t* buf, size_t len, uint8_t* out) {
  return decode_impl(buf, len, out, nullptr);
}

// Load `n` PNG files concurrently into one contiguous buffer of
// `frame_samples` samples each (uint16 when depth==16, else uint8).
// All files must share w/h/c/depth (validated). Returns 0 on success,
// else -(100 + index-of-failed-file).
int dbsr_load_burst(const char** paths, int n, uint8_t* out,
                    size_t frame_bytes, int num_threads) {
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  int workers = num_threads > 0
                    ? num_threads
                    : int(std::min<unsigned>(std::thread::hardware_concurrency(),
                                             unsigned(n)));
  if (workers < 1) workers = 1;
  std::vector<std::thread> pool;
  pool.reserve(size_t(workers));
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n || err.load() != 0) return;
        std::vector<uint8_t> buf;
        if (read_file(paths[i], &buf) != 0) {
          err.store(100 + i);
          return;
        }
        // the frame's size from its header first: a frame of another size
        // is refused before anything is written to out
        PngInfo info;
        std::vector<std::pair<size_t, size_t>> spans;
        if (parse_png(buf.data(), buf.size(), &info, &spans) != 0 ||
            size_t(info.width) * info.height * info.channels *
                    (info.depth / 8) != frame_bytes) {
          err.store(100 + i);
          return;
        }
        if (decode_impl(buf.data(), buf.size(), out + size_t(i) * frame_bytes,
                        nullptr) != 0) {
          err.store(100 + i);
          return;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  return -err.load();
}

// 1 when the JPEG half was built, else 0.
int dbsr_io_has_jpeg() {
#ifdef DBSR_IO_NO_JPEG
  return 0;
#else
  return 1;
#endif
}

#ifndef DBSR_IO_NO_JPEG
// JPEG header: w/h (+c, always 3: decoded as RGB). Returns 0 on success.
int dbsr_jpeg_info(const uint8_t* buf, size_t len, int* w, int* h, int* c) {
  return jpeg_decode_impl(buf, len, nullptr, w, h, c);
}

// Decode an in-memory JPEG into caller-allocated out (h*w*3 uint8 RGB).
int dbsr_jpeg_decode(const uint8_t* buf, size_t len, uint8_t* out) {
  return jpeg_decode_impl(buf, len, out, nullptr, nullptr, nullptr);
}

// Load `n` same-sized JPEG files concurrently into one contiguous RGB8
// buffer of `frame_bytes` each. Returns 0 or -(100+i) for the failed file.
int dbsr_load_jpeg_batch(const char** paths, int n, uint8_t* out,
                         size_t frame_bytes, int num_threads) {
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  int workers = num_threads > 0
                    ? num_threads
                    : int(std::min<unsigned>(std::thread::hardware_concurrency(),
                                             unsigned(n)));
  if (workers < 1) workers = 1;
  std::vector<std::thread> pool;
  pool.reserve(size_t(workers));
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n || err.load() != 0) return;
        std::vector<uint8_t> buf;
        if (read_file(paths[i], &buf) != 0) {
          err.store(100 + i);
          return;
        }
        int w = 0, h = 0, c = 0;
        if (jpeg_decode_impl(buf.data(), buf.size(), nullptr, &w, &h, &c)
                != 0 ||
            size_t(w) * h * 3 != frame_bytes) {
          err.store(100 + i);
          return;
        }
        if (jpeg_decode_impl(buf.data(), buf.size(),
                             out + size_t(i) * frame_bytes, nullptr, nullptr,
                             nullptr) != 0) {
          err.store(100 + i);
          return;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  return -err.load();
}

#endif  // DBSR_IO_NO_JPEG

}  // extern "C"
