// Native video decoder: libavformat/avcodec/swscale.
//
// The reference delegates decode to decord/PyAV/OpenCV from Python
// (MCT loading.py:725-1247, MultiFusion utils.py:15).  This library decodes
// a selected set of frame indices of one container straight into a caller-
// provided RGB24 buffer: one seek to the keyframe before the earliest
// wanted frame, demux/decode forward, and — when the container's keyframe
// index shows a GOP boundary between the current position and the next
// wanted frame — a forward re-seek that skips the unwanted GOPs entirely
// (decord's random-access get_batch semantics, the reference's ingest in
// MCT loading.py:1081-1144).  Sparse samplers (8 uniform frames over a
// whole clip) therefore decode only the GOPs that contain wanted frames
// instead of every GOP in the file.
//
// C ABI (ctypes):
//   vd_open(path, out int32[3]{n_frames_estimate, width, height}) -> handle
//   vd_decode(handle, indices*, n, out_u8*, out_w, out_h) -> 0 on success
//       out buffer: n * out_h * out_w * 3 bytes (RGB24, bilinear resize if
//       out_w/out_h differ from stream size)
//   vd_close(handle)

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  int stream_idx = -1;
  int width = 0;
  int height = 0;
  int64_t n_frames = 0;
};

}  // namespace

extern "C" {

void* vd_open(const char* path, int32_t* info_out) {
  auto* d = new Decoder;
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  const AVCodec* dec = nullptr;
  d->stream_idx = av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                      &dec, 0);
  if (d->stream_idx < 0) {
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  AVStream* st = d->fmt->streams[d->stream_idx];
  d->codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(d->codec, st->codecpar);
  d->codec->thread_count = 0;  // auto
  if (avcodec_open2(d->codec, dec, nullptr) < 0) {
    avcodec_free_context(&d->codec);
    avformat_close_input(&d->fmt);
    delete d;
    return nullptr;
  }
  d->width = d->codec->width;
  d->height = d->codec->height;
  d->n_frames = st->nb_frames;
  if (d->n_frames <= 0 && st->avg_frame_rate.den > 0 &&
      d->fmt->duration > 0) {
    d->n_frames = av_rescale(d->fmt->duration, st->avg_frame_rate.num,
                             st->avg_frame_rate.den * (int64_t)AV_TIME_BASE);
  }
  if (info_out) {
    info_out[0] = static_cast<int32_t>(d->n_frames);
    info_out[1] = d->width;
    info_out[2] = d->height;
  }
  return d;
}

int vd_decode(void* handle, const int64_t* indices, int64_t n,
              uint8_t* out, int out_w, int out_h) {
  auto* d = static_cast<Decoder*>(handle);
  if (!d || n <= 0) return -1;
  if (out_w <= 0) out_w = d->width;
  if (out_h <= 0) out_h = d->height;

  // map wanted frame index -> output slots (indices may repeat/unsorted)
  std::vector<std::pair<int64_t, int64_t>> want;  // (frame_idx, out_slot)
  for (int64_t i = 0; i < n; ++i) want.emplace_back(indices[i], i);
  std::sort(want.begin(), want.end());

  // Seek to the keyframe before the EARLIEST wanted frame (the header's
  // contract): decoding from 0 would make late-clip sampling O(video).
  // After a timestamp seek the running counter is recovered from the
  // first received frame's pts (exact for CFR streams); short prefixes
  // keep the exact sequential scan.
  AVStream* st = d->fmt->streams[d->stream_idx];
  const int64_t ts_base =
      (st->start_time != AV_NOPTS_VALUE) ? st->start_time : 0;
  AVRational inv_fps = {st->avg_frame_rate.den, st->avg_frame_rate.num};
  auto frame_to_ts = [&](int64_t idx) {
    return av_rescale_q(idx, inv_fps, st->time_base) + ts_base;
  };
  auto ts_to_frame = [&](int64_t ts) {
    int64_t f = av_rescale_q_rnd(ts - ts_base, st->time_base, inv_fps,
                                 AV_ROUND_NEAR_INF);
    return f < 0 ? 0 : f;
  };

  bool seeked = false;
  if (want[0].first > 64 && st->avg_frame_rate.num > 0) {
    if (av_seek_frame(d->fmt, d->stream_idx, frame_to_ts(want[0].first),
                      AVSEEK_FLAG_BACKWARD) >= 0)
      seeked = true;
  }
  if (!seeked)
    av_seek_frame(d->fmt, d->stream_idx, 0, AVSEEK_FLAG_BACKWARD);
  avcodec_flush_buffers(d->codec);

  // sws context tracks the DECODED frame geometry (mid-stream
  // resolution changes are legal in H.264/mpegts; scaling with the
  // open-time dims would over-read the smaller frame)
  SwsContext* sws = nullptr;
  int sws_w = -1, sws_h = -1, sws_fmt = -1;

  // swscale's SIMD paths write past the end of the final row (measured
  // 24 bytes on this box's rgb24 output) — scaling straight into the
  // caller's tightly-sized numpy buffer corrupts the heap (and, for
  // unsorted indices, the first bytes of a neighboring frame slot).
  // Scale into an aligned, row-padded staging buffer and row-copy out,
  // the same discipline decord/OpenCV use.
  const int stage_stride = FFALIGN(out_w * 3, 64);
  uint8_t* stage = static_cast<uint8_t*>(
      av_malloc(static_cast<size_t>(stage_stride) * out_h + 64));
  if (!stage) return -2;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t decoded = seeked ? -1 : 0;  // -1: recover from first pts
  size_t next_want = 0;
  const size_t frame_bytes = static_cast<size_t>(out_w) * out_h * 3;
  int ret = 0;

  auto emit = [&](AVFrame* f) {
    if (decoded < 0) {
      int64_t pts = f->best_effort_timestamp;
      decoded = (pts == AV_NOPTS_VALUE) ? 0 : ts_to_frame(pts);
    }
    if (f->width != sws_w || f->height != sws_h || f->format != sws_fmt) {
      if (sws) sws_freeContext(sws);
      sws = sws_getContext(f->width, f->height,
                           static_cast<AVPixelFormat>(f->format), out_w,
                           out_h, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                           nullptr, nullptr);
      sws_w = f->width;
      sws_h = f->height;
      sws_fmt = f->format;
    }
    // <=: a conservative keyframe seek can overshoot a wanted index by
    // a frame on odd-pts streams — serve it with the current frame
    // rather than stalling until the repeat-last fallback
    bool staged = false;
    while (sws && next_want < want.size() &&
           want[next_want].first <= decoded) {
      if (!staged) {
        uint8_t* dst[1] = {stage};
        int dst_stride[1] = {stage_stride};
        sws_scale(sws, f->data, f->linesize, 0, f->height, dst, dst_stride);
        staged = true;
      }
      uint8_t* slot = out + want[next_want].second * frame_bytes;
      for (int row = 0; row < out_h; ++row) {
        memcpy(slot + static_cast<size_t>(row) * out_w * 3,
               stage + static_cast<size_t>(row) * stage_stride, out_w * 3);
      }
      ++next_want;
    }
    ++decoded;
  };

  // GOP skip: if the container's keyframe index shows a keyframe
  // strictly between the current position and the next wanted frame,
  // re-seek instead of decoding through the gap.  The index check makes
  // the decision exact for indexed containers (mp4 stss et al.) and
  // degrades to the plain forward scan where no index exists (raw
  // mpegts before its index is built) or keyframes are sparse — the
  // worst case stays the old behavior, never a backward re-decode.
  constexpr int64_t kMinSkip = 8;  // seek+flush cost floor, in frames
  int64_t last_seek_target = -1;
  auto maybe_skip = [&]() {
    if (decoded < 0 || next_want >= want.size() ||
        st->avg_frame_rate.num <= 0)
      return;
    const int64_t target = want[next_want].first;
    if (target == last_seek_target || target - decoded <= kMinSkip) return;
    last_seek_target = target;  // one attempt per wanted index
    int idx = av_index_search_timestamp(st, frame_to_ts(target),
                                        AVSEEK_FLAG_BACKWARD);
    if (idx < 0) return;
    const AVIndexEntry* e = avformat_index_get_entry(st, idx);
    if (!e || ts_to_frame(e->timestamp) <= decoded + kMinSkip) return;
    const int64_t resume = decoded;
    if (av_seek_frame(d->fmt, d->stream_idx, frame_to_ts(target),
                      AVSEEK_FLAG_BACKWARD) >= 0) {
      avcodec_flush_buffers(d->codec);
      decoded = -1;
    } else {
      decoded = resume;  // seek refused: keep scanning forward
    }
  };

  while (next_want < want.size() &&
         (maybe_skip(), av_read_frame(d->fmt, pkt) >= 0)) {
    if (pkt->stream_index == d->stream_idx) {
      if (avcodec_send_packet(d->codec, pkt) == 0) {
        while (avcodec_receive_frame(d->codec, frame) == 0) emit(frame);
      }
    }
    av_packet_unref(pkt);
  }
  // drain
  avcodec_send_packet(d->codec, nullptr);
  while (next_want < want.size() &&
         avcodec_receive_frame(d->codec, frame) == 0) {
    emit(frame);
  }
  avcodec_flush_buffers(d->codec);
  if (next_want < want.size()) {
    // requested frames beyond the stream: repeat-last semantics
    if (next_want == 0) {
      ret = -3;
    } else {
      const uint8_t* last =
          out + want[next_want - 1].second * frame_bytes;
      for (size_t i = next_want; i < want.size(); ++i) {
        memcpy(out + want[i].second * frame_bytes, last, frame_bytes);
      }
    }
  }
  av_frame_free(&frame);
  av_packet_free(&pkt);
  av_free(stage);
  sws_freeContext(sws);
  return ret;
}

void vd_close(void* handle) {
  auto* d = static_cast<Decoder*>(handle);
  if (!d) return;
  avcodec_free_context(&d->codec);
  avformat_close_input(&d->fmt);
  delete d;
}

// Decode a BATCH of videos with a thread pool — the host-side loader hot
// path that keeps the TPU fed (one ctypes call per training batch instead
// of per-video Python round trips).
//
//   paths:        n_videos C strings
//   indices:      concatenated frame indices, frames_per_video each
//   out:          n_videos * frames_per_video * out_h * out_w * 3 bytes
//   returns number of videos that FAILED (0 = all good); failed videos'
//   buffers are zeroed.
int vd_decode_batch(const char** paths, const int64_t* indices,
                    int64_t frames_per_video, int64_t n_videos,
                    uint8_t* out, int out_w, int out_h, int n_threads) {
  if (n_videos <= 0 || frames_per_video <= 0 || out_w <= 0 || out_h <= 0) {
    return -1;
  }
  const size_t video_bytes =
      static_cast<size_t>(frames_per_video) * out_h * out_w * 3;
  std::atomic<int64_t> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_videos) return;
      int32_t info[3];
      void* h = vd_open(paths[i], info);
      uint8_t* dst = out + i * video_bytes;
      if (!h || vd_decode(h, indices + i * frames_per_video,
                          frames_per_video, dst, out_w, out_h) != 0) {
        memset(dst, 0, video_bytes);
        failures.fetch_add(1);
      }
      if (h) vd_close(h);
    }
  };

  int nt = std::max(1, std::min<int>(n_threads, (int)n_videos));
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// ---------------------------------------------------------------------------
// Audio extraction (the reference shells out to `ffmpeg -map 0:a`
// per video, MCT/tools/data/extract_audio.py:21; here it is one in-process
// call: decode the best audio stream, mixdown to mono float and resample
// to target_rate via libswresample).
//
//   ad_duration(path) -> seconds (<=0 on failure / no audio)
//   ad_extract(path, target_rate, out, max_samples) -> samples written
//       (truncates at max_samples; negative = error / no audio stream)

extern "C" {
#include <libswresample/swresample.h>
}

extern "C" {

double ad_duration(const char* path) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1.0;
  double secs = -1.0;
  if (avformat_find_stream_info(fmt, nullptr) >= 0 && fmt->duration > 0) {
    secs = fmt->duration / (double)AV_TIME_BASE;
  }
  avformat_close_input(&fmt);
  return secs;
}

int64_t ad_extract(const char* path, int target_rate, float* out,
                   int64_t max_samples) {
  AVFormatContext* fmt = nullptr;
  if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(fmt, nullptr) < 0) {
    avformat_close_input(&fmt);
    return -1;
  }
  const AVCodec* dec = nullptr;
  int si = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
  if (si < 0) {
    avformat_close_input(&fmt);
    return -2;  // no audio stream
  }
  AVCodecContext* codec = avcodec_alloc_context3(dec);
  avcodec_parameters_to_context(codec, fmt->streams[si]->codecpar);
  if (avcodec_open2(codec, dec, nullptr) < 0) {
    avcodec_free_context(&codec);
    avformat_close_input(&fmt);
    return -3;
  }

  SwrContext* swr = nullptr;
  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (codec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &codec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 2);
  }
  if (swr_alloc_set_opts2(&swr, &mono, AV_SAMPLE_FMT_FLT, target_rate,
                          &in_layout, codec->sample_fmt, codec->sample_rate,
                          0, nullptr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&codec);
    avformat_close_input(&fmt);
    return -4;
  }
  // plain per-channel average (librosa semantics) instead of swr's
  // default -3 dB downmix
  if (in_layout.nb_channels > 1) {
    std::vector<double> matrix(in_layout.nb_channels,
                               1.0 / in_layout.nb_channels);
    swr_set_matrix(swr, matrix.data(), in_layout.nb_channels);
  }
  if (swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    avcodec_free_context(&codec);
    avformat_close_input(&fmt);
    return -4;
  }

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  int64_t written = 0;

  // f: feed the frame once, then take what swr still buffers with
  // non-null input of 0 samples (a null input flushes the resampler,
  // which at every frame would cut the signal into independently
  // resampled pieces); f == nullptr: flush at the end
  auto drain_swr = [&](const AVFrame* f) {
    const uint8_t** in =
        f ? const_cast<const uint8_t**>(f->data) : nullptr;
    int in_count = f ? f->nb_samples : 0;
    while (written < max_samples) {
      uint8_t* dst[1] = {
          reinterpret_cast<uint8_t*>(out + written)};
      int room = static_cast<int>(
          std::min<int64_t>(max_samples - written, 1 << 16));
      int got = swr_convert(swr, dst, room, in, in_count);
      if (got <= 0) break;
      written += got;
      if (f && got < room) break;  // the frame's output is all out
      in_count = 0;
    }
  };

  while (written < max_samples && av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == si &&
        avcodec_send_packet(codec, pkt) == 0) {
      while (avcodec_receive_frame(codec, frame) == 0) {
        drain_swr(frame);
      }
    }
    av_packet_unref(pkt);
  }
  avcodec_send_packet(codec, nullptr);
  while (written < max_samples &&
         avcodec_receive_frame(codec, frame) == 0) {
    drain_swr(frame);
  }
  drain_swr(nullptr);  // flush the resampler

  av_frame_free(&frame);
  av_packet_free(&pkt);
  swr_free(&swr);
  av_channel_layout_uninit(&in_layout);
  avcodec_free_context(&codec);
  avformat_close_input(&fmt);
  return written;
}

}  // extern "C"

}  // extern "C"
