// Native host runtime for gme_tpu.
//
// Host-side components that sit off-device by necessity (SURVEY.md §2.3):
//  - YUV4MPEG2 (y4m) decode into packed grayscale frame buffers, replacing
//    the reference's cv2.VideoCapture loop (reference utils.py:9-31) for raw
//    video without any codec dependency;
//  - codec (mp4/webm/...) decode via FFmpeg/libav when built with
//    -DGME_WITH_LIBAV: demux + decode + swscale to BGR24 + the same
//    fixed-point BT.601 grayscale as cv2.cvtColor — drops the OpenCV
//    dependency for mp4 ingest (reference utils.py:20-30);
//  - zlib-backed PNG encoder + a multi-threaded background writer pool,
//    replacing the reference's cv2.imwrite result streams
//    (reference results.py:64-106) so image IO overlaps device compute.
//
// Exposed as a plain C ABI consumed via ctypes (gme_tpu/native/loader.py).

#include <zlib.h>

#ifdef GME_WITH_LIBAV
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libswscale/swscale.h>
}
#endif

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// y4m parsing
// ---------------------------------------------------------------------------

struct Y4mInfo {
  int width = 0;
  int height = 0;
  int frame_count = 0;
  long header_end = 0;  // offset just past the stream-header newline
  long frame_size = 0;  // luma + chroma bytes per FRAME payload
};

int parse_y4m_header(FILE* f, Y4mInfo* info) {
  char line[1024];
  if (!fgets(line, sizeof(line), f)) return -1;
  if (strncmp(line, "YUV4MPEG2", 9) != 0) return -2;
  std::string subsampling = "420";
  for (char* tok = strtok(line + 9, " \n"); tok; tok = strtok(nullptr, " \n")) {
    switch (tok[0]) {
      case 'W': info->width = atoi(tok + 1); break;
      case 'H': info->height = atoi(tok + 1); break;
      case 'C': subsampling = tok + 1; break;
      default: break;
    }
  }
  if (info->width <= 0 || info->height <= 0) return -3;
  long y = (long)info->width * info->height;
  if (subsampling.rfind("420", 0) == 0) {
    info->frame_size = y + 2 * ((info->width / 2) * (long)(info->height / 2));
  } else if (subsampling.rfind("422", 0) == 0) {
    info->frame_size = y + 2 * ((info->width / 2) * (long)info->height);
  } else if (subsampling.rfind("444", 0) == 0) {
    info->frame_size = 3 * y;
  } else if (subsampling.rfind("mono", 0) == 0) {
    info->frame_size = y;
  } else {
    return -4;
  }
  info->header_end = ftell(f);
  return 0;
}

int skip_frame_header(FILE* f) {
  char line[1024];
  if (!fgets(line, sizeof(line), f)) return -1;
  if (strncmp(line, "FRAME", 5) != 0) return -2;
  return 0;
}

// ---------------------------------------------------------------------------
// PNG encoding (zlib)
// ---------------------------------------------------------------------------

void put_be32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back((v >> 24) & 0xff);
  out->push_back((v >> 16) & 0xff);
  out->push_back((v >> 8) & 0xff);
  out->push_back(v & 0xff);
}

void put_chunk(std::vector<uint8_t>* out, const char tag[4],
               const uint8_t* payload, size_t n) {
  put_be32(out, (uint32_t)n);
  size_t crc_start = out->size();
  out->insert(out->end(), tag, tag + 4);
  out->insert(out->end(), payload, payload + n);
  uint32_t crc = crc32(0L, out->data() + crc_start, (uInt)(n + 4));
  put_be32(out, crc);
}

// data: row-major uint8; channels 1 (gray) or 3 (BGR, converted to RGB).
int encode_png(const uint8_t* data, int w, int h, int channels, int level,
               std::vector<uint8_t>* out) {
  if (channels != 1 && channels != 3) return -1;
  const int stride = w * channels;
  std::vector<uint8_t> raw((size_t)h * (stride + 1));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (stride + 1);
    row[0] = 0;  // filter: none
    const uint8_t* src = data + (size_t)y * stride;
    if (channels == 1) {
      memcpy(row + 1, src, stride);
    } else {
      for (int x = 0; x < w; ++x) {  // BGR -> RGB
        row[1 + 3 * x + 0] = src[3 * x + 2];
        row[1 + 3 * x + 1] = src[3 * x + 1];
        row[1 + 3 * x + 2] = src[3 * x + 0];
      }
    }
  }
  uLongf comp_bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_bound);
  if (compress2(comp.data(), &comp_bound, raw.data(), (uLong)raw.size(),
                level) != Z_OK) {
    return -2;
  }
  comp.resize(comp_bound);

  out->clear();
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out->insert(out->end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;                          // bit depth
  ihdr[9] = channels == 1 ? 0 : 2;      // color type
  ihdr[10] = ihdr[11] = ihdr[12] = 0;   // compression/filter/interlace
  put_chunk(out, "IHDR", ihdr, sizeof(ihdr));
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);
  return 0;
}

int write_png_file(const char* path, const uint8_t* data, int w, int h,
                   int channels, int level) {
  std::vector<uint8_t> png;
  int rc = encode_png(data, w, h, channels, level, &png);
  if (rc != 0) return rc;
  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  size_t written = fwrite(png.data(), 1, png.size(), f);
  fclose(f);
  return written == png.size() ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Background writer pool
// ---------------------------------------------------------------------------

struct Job {
  std::string path;
  std::vector<uint8_t> data;  // owned copy so the caller can reuse its buffer
  int w, h, channels, level;
};

class WriterPool {
 public:
  int start(int workers) {
    std::lock_guard<std::mutex> lk(mu_);
    if (running_) return 0;
    running_ = true;
    pending_ = 0;
    for (int i = 0; i < workers; ++i) {
      // Detached: workers idle on the condvar for the process lifetime and
      // die with it (keeping joinable std::threads in a static aborts at
      // interpreter exit).
      std::thread([this] { worker(); }).detach();
    }
    return 0;
  }

  int submit(const char* path, const uint8_t* data, int w, int h, int channels,
             int level) {
    Job job;
    job.path = path;
    job.data.assign(data, data + (size_t)w * h * channels);
    job.w = w; job.h = h; job.channels = channels; job.level = level;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (!running_) return -1;
      queue_.push_back(std::move(job));
      ++pending_;
    }
    cv_.notify_one();
    return 0;
  }

  int drain() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
    return errors_.exchange(0) == 0 ? 0 : -1;
  }

 private:
  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return !queue_.empty() || !running_; });
        if (queue_.empty()) {
          if (!running_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      if (write_png_file(job.path.c_str(), job.data.data(), job.w, job.h,
                         job.channels, job.level) != 0) {
        errors_.fetch_add(1);
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        --pending_;
      }
      done_cv_.notify_all();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Job> queue_;
  bool running_ = false;
  int pending_ = 0;
  std::atomic<int> errors_{0};
};

// Heap-allocated and intentionally leaked: a static WriterPool's destructor
// would tear down the mutex/condvar while detached workers still wait on
// them, hanging interpreter exit.
WriterPool& pool() {
  static WriterPool* p = new WriterPool;
  return *p;
}

}  // namespace

extern "C" {

int gme_y4m_probe(const char* path, int* width, int* height, int* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Y4mInfo info;
  int rc = parse_y4m_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  // count frames by walking FRAME headers
  int n = 0;
  while (skip_frame_header(f) == 0) {
    if (fseek(f, info.frame_size, SEEK_CUR) != 0) break;
    ++n;
  }
  fclose(f);
  *width = info.width;
  *height = info.height;
  *frames = n;
  return 0;
}

// buf receives n*h*w luma bytes (grayscale frames, packed).
int gme_y4m_decode(const char* path, uint8_t* buf, long buf_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Y4mInfo info;
  int rc = parse_y4m_header(f, &info);
  if (rc != 0) { fclose(f); return rc; }
  const long luma = (long)info.width * info.height;
  long off = 0;
  while (skip_frame_header(f) == 0) {
    if (off + luma > buf_size) { fclose(f); return -5; }
    if (fread(buf + off, 1, luma, f) != (size_t)luma) { fclose(f); return -6; }
    if (fseek(f, info.frame_size - luma, SEEK_CUR) != 0) { fclose(f); return -7; }
    off += luma;
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Codec decode (FFmpeg/libav) — streaming handle API
// ---------------------------------------------------------------------------

int gme_codec_available(void) {
#ifdef GME_WITH_LIBAV
  return 1;
#else
  return 0;
#endif
}

#ifdef GME_WITH_LIBAV

struct GmeCodecReader {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frame = nullptr;
  AVFrame* bgr = nullptr;
  AVPacket* pkt = nullptr;
  int stream_index = -1;
  int width = 0, height = 0;
  bool flushed = false;
};

void* gme_codec_open(const char* path, int* width, int* height) {
  auto* r = new GmeCodecReader;
  if (avformat_open_input(&r->fmt, path, nullptr, nullptr) < 0) goto fail;
  if (avformat_find_stream_info(r->fmt, nullptr) < 0) goto fail;
  {
    const AVCodec* codec = nullptr;
    r->stream_index =
        av_find_best_stream(r->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &codec, 0);
    if (r->stream_index < 0 || !codec) goto fail;
    r->dec = avcodec_alloc_context3(codec);
    if (!r->dec) goto fail;
    if (avcodec_parameters_to_context(
            r->dec, r->fmt->streams[r->stream_index]->codecpar) < 0)
      goto fail;
    if (avcodec_open2(r->dec, codec, nullptr) < 0) goto fail;
  }
  r->width = r->dec->width;
  r->height = r->dec->height;
  r->frame = av_frame_alloc();
  r->bgr = av_frame_alloc();
  r->pkt = av_packet_alloc();
  if (!r->frame || !r->bgr || !r->pkt) goto fail;
  *width = r->width;
  *height = r->height;
  return r;
fail:
  if (r->pkt) av_packet_free(&r->pkt);
  if (r->bgr) av_frame_free(&r->bgr);
  if (r->frame) av_frame_free(&r->frame);
  if (r->dec) avcodec_free_context(&r->dec);
  if (r->fmt) avformat_close_input(&r->fmt);
  delete r;
  return nullptr;
}

namespace {

// BGR24 -> gray with OpenCV's BT.601 15-bit fixed point (matches
// cv2.cvtColor(..., COLOR_BGR2GRAY) and gme_tpu.io.video.bgr_to_gray).
void bgr_to_gray_row(const uint8_t* src, uint8_t* dst, int w) {
  for (int x = 0; x < w; ++x) {
    uint32_t b = src[3 * x], g = src[3 * x + 1], rr = src[3 * x + 2];
    dst[x] = (uint8_t)((3735u * b + 19235u * g + 9798u * rr + (1u << 14)) >> 15);
  }
}

int convert_gray(GmeCodecReader* r, uint8_t* buf) {
  r->sws = sws_getCachedContext(
      r->sws, r->width, r->height, (AVPixelFormat)r->frame->format, r->width,
      r->height, AV_PIX_FMT_BGR24, SWS_BICUBIC, nullptr, nullptr, nullptr);
  if (!r->sws) return -10;
  // Honour the stream's YUV matrix and range (swscale defaults to limited-
  // range BT.601; e.g. pan240.mp4 is BT.709) — required for bit parity
  // with OpenCV's FFmpeg backend.
  int cs;
  switch (r->frame->colorspace) {
    case AVCOL_SPC_BT709: cs = SWS_CS_ITU709; break;
    case AVCOL_SPC_FCC: cs = SWS_CS_FCC; break;
    case AVCOL_SPC_SMPTE240M: cs = SWS_CS_SMPTE240M; break;
    case AVCOL_SPC_BT2020_NCL: cs = SWS_CS_BT2020; break;
    default: cs = SWS_CS_DEFAULT; break;
  }
  const int src_range = r->frame->color_range == AVCOL_RANGE_JPEG ? 1 : 0;
  int *inv_tbl, *tbl, sr, dr, brightness, contrast, saturation;
  if (sws_getColorspaceDetails(r->sws, &inv_tbl, &sr, &tbl, &dr, &brightness,
                               &contrast, &saturation) >= 0) {
    sws_setColorspaceDetails(r->sws, sws_getCoefficients(cs), src_range,
                             sws_getCoefficients(cs), dr, brightness,
                             contrast, saturation);
  }
  std::vector<uint8_t> bgr((size_t)r->width * r->height * 3);
  uint8_t* dst_data[4] = {bgr.data(), nullptr, nullptr, nullptr};
  int dst_linesize[4] = {r->width * 3, 0, 0, 0};
  sws_scale(r->sws, r->frame->data, r->frame->linesize, 0, r->height,
            dst_data, dst_linesize);
  for (int y = 0; y < r->height; ++y) {
    bgr_to_gray_row(bgr.data() + (size_t)y * r->width * 3,
                    buf + (size_t)y * r->width, r->width);
  }
  return 0;
}

}  // namespace

// Returns 1 when a frame was written to buf (h*w gray bytes), 0 on EOF,
// negative on error.
int gme_codec_read_gray(void* handle, uint8_t* buf) {
  auto* r = (GmeCodecReader*)handle;
  for (;;) {
    int rc = avcodec_receive_frame(r->dec, r->frame);
    if (rc == 0) {
      rc = convert_gray(r, buf);
      av_frame_unref(r->frame);
      return rc == 0 ? 1 : rc;
    }
    if (rc == AVERROR_EOF) return 0;
    if (rc != AVERROR(EAGAIN)) return -11;
    // need more input
    for (;;) {
      rc = av_read_frame(r->fmt, r->pkt);
      if (rc < 0) {
        if (!r->flushed) {
          avcodec_send_packet(r->dec, nullptr);  // enter drain mode
          r->flushed = true;
        }
        break;
      }
      if (r->pkt->stream_index == r->stream_index) {
        rc = avcodec_send_packet(r->dec, r->pkt);
        av_packet_unref(r->pkt);
        if (rc < 0 && rc != AVERROR(EAGAIN)) return -12;
        break;
      }
      av_packet_unref(r->pkt);
    }
  }
}

void gme_codec_close(void* handle) {
  auto* r = (GmeCodecReader*)handle;
  if (!r) return;
  if (r->sws) sws_freeContext(r->sws);
  av_packet_free(&r->pkt);
  av_frame_free(&r->bgr);
  av_frame_free(&r->frame);
  avcodec_free_context(&r->dec);
  avformat_close_input(&r->fmt);
  delete r;
}

#else  // !GME_WITH_LIBAV

void* gme_codec_open(const char*, int*, int*) { return nullptr; }
int gme_codec_read_gray(void*, uint8_t*) { return -100; }
void gme_codec_close(void*) {}

#endif

int gme_write_png(const char* path, const uint8_t* data, int w, int h,
                  int channels, int level) {
  return write_png_file(path, data, w, h, channels, level);
}

int gme_png_writer_start(int workers) { return pool().start(workers); }

int gme_png_writer_submit(const char* path, const uint8_t* data, int w, int h,
                          int channels, int level) {
  return pool().submit(path, data, w, h, channels, level);
}

int gme_png_writer_drain() { return pool().drain(); }

}  // extern "C"
