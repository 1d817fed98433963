// Compressed-audio decoder for the cpc2_torch data loader, backed by the
// system FFmpeg libraries (libavformat + libavcodec); a copy of the JAX
// package's `csrc/audiodec.cc`.
//
// The reference framework's Common Voices workflow is mp3-first: it reads
// mp3 through torchaudio/sox (`cpc/eval/utils/adjust_sample_rate.py:13-95`,
// `--file_extension .mp3`). WAV and FLAC have dedicated fast paths in this
// framework (`audio_io.py` numpy parser, `flacdec.cc`); this shim
// covers mp3 — and, incidentally, every other container/codec the system
// lavf build knows — by demuxing with libavformat and decoding with
// libavcodec, then interleaving to float32 host-side.
//
// Exposed to Python via ctypes (`cpc2_torch/data/audio_io.py`). Built with
// g++ at first use into build/cpc2_torch_kernels/libaudiodec.so
// (`cpc2_torch/ops/_build.py:build_host`), only where the FFmpeg dev
// headers are present; elsewhere the Python side raises a clear "mp3
// unsupported" error.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Error codes surfaced to Python (keep in sync with audio_io.py).
enum {
  ERR_OPEN = -1,         // file missing / not a recognizable container
  ERR_NO_AUDIO = -2,     // no audio stream
  ERR_DECODER = -3,      // decoder unavailable or failed to open
  ERR_DECODE = -4,       // bitstream error mid-decode
  ERR_SAMPLE_FMT = -5,   // sample format we do not interleave
  ERR_ALLOC = -6,
};

struct Demux {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  int stream_index = -1;

  ~Demux() {
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }

  int open(const char* path) {
    if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0)
      return ERR_OPEN;
    if (avformat_find_stream_info(fmt, nullptr) < 0) return ERR_OPEN;
    const AVCodec* codec = nullptr;
    stream_index =
        av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
    if (stream_index < 0 || !codec) return ERR_NO_AUDIO;
    dec = avcodec_alloc_context3(codec);
    if (!dec) return ERR_ALLOC;
    if (avcodec_parameters_to_context(
            dec, fmt->streams[stream_index]->codecpar) < 0)
      return ERR_DECODER;
    if (avcodec_open2(dec, codec, nullptr) < 0) return ERR_DECODER;
    return 0;
  }
};

// Append one decoded frame, interleaved, to `out`. Returns 0 or an error.
int append_frame(const AVFrame* f, int channels, std::vector<float>* out) {
  const int n = f->nb_samples;
  size_t base = out->size();
  out->resize(base + size_t(n) * channels);
  float* dst = out->data() + base;

  switch (f->format) {
    case AV_SAMPLE_FMT_FLT:
      std::memcpy(dst, f->data[0], sizeof(float) * size_t(n) * channels);
      break;
    case AV_SAMPLE_FMT_FLTP:
      for (int c = 0; c < channels; ++c) {
        const float* src = reinterpret_cast<const float*>(f->extended_data[c]);
        for (int i = 0; i < n; ++i) dst[i * channels + c] = src[i];
      }
      break;
    case AV_SAMPLE_FMT_S16:
      for (int i = 0; i < n * channels; ++i)
        dst[i] = reinterpret_cast<const int16_t*>(f->data[0])[i] / 32768.0f;
      break;
    case AV_SAMPLE_FMT_S16P:
      for (int c = 0; c < channels; ++c) {
        const int16_t* src =
            reinterpret_cast<const int16_t*>(f->extended_data[c]);
        for (int i = 0; i < n; ++i)
          dst[i * channels + c] = src[i] / 32768.0f;
      }
      break;
    case AV_SAMPLE_FMT_S32:
      for (int i = 0; i < n * channels; ++i)
        dst[i] = float(reinterpret_cast<const int32_t*>(f->data[0])[i] /
                       2147483648.0);
      break;
    case AV_SAMPLE_FMT_S32P:
      for (int c = 0; c < channels; ++c) {
        const int32_t* src =
            reinterpret_cast<const int32_t*>(f->extended_data[c]);
        for (int i = 0; i < n; ++i)
          dst[i * channels + c] = float(src[i] / 2147483648.0);
      }
      break;
    case AV_SAMPLE_FMT_DBL:
      for (int i = 0; i < n * channels; ++i)
        dst[i] = float(reinterpret_cast<const double*>(f->data[0])[i]);
      break;
    case AV_SAMPLE_FMT_DBLP:
      for (int c = 0; c < channels; ++c) {
        const double* src =
            reinterpret_cast<const double*>(f->extended_data[c]);
        for (int i = 0; i < n; ++i) dst[i * channels + c] = float(src[i]);
      }
      break;
    case AV_SAMPLE_FMT_U8:
      for (int i = 0; i < n * channels; ++i)
        dst[i] = (reinterpret_cast<const uint8_t*>(f->data[0])[i] - 128) /
                 128.0f;
      break;
    default:
      return ERR_SAMPLE_FMT;
  }
  return 0;
}

}  // namespace

extern "C" {

// Decodes the whole file to interleaved float32. On success returns the
// frame (per-channel sample) count and stores a malloc'd buffer of
// `frames * channels` floats in *out (caller frees with audec_free), the
// sample rate in *sr and the channel count in *ch. Negative return = error.
long long audec_decode_file(const char* path, float** out, int* sr,
                            int* ch) {
  av_log_set_level(AV_LOG_ERROR);
  Demux d;
  int rc = d.open(path);
  if (rc < 0) return rc;

  // Let lavc trim encoder delay/padding (Xing/LAME gapless info) exactly
  // as torchaudio's ffmpeg path does.
  std::vector<float> pcm;
  AVPacket* pkt = av_packet_alloc();
  AVFrame* frame = av_frame_alloc();
  if (!pkt || !frame) {
    if (pkt) av_packet_free(&pkt);
    if (frame) av_frame_free(&frame);
    return ERR_ALLOC;
  }

  int channels = 0;
  int rate = 0;
  int err = 0;
  auto drain = [&]() -> int {
    while (true) {
      int r = avcodec_receive_frame(d.dec, frame);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return ERR_DECODE;
      if (!channels) {
        channels = frame->ch_layout.nb_channels;
        rate = frame->sample_rate;
      }
      int ar = append_frame(frame, channels, &pcm);
      if (ar < 0) return ar;
    }
  };

  while (err == 0 && av_read_frame(d.fmt, pkt) >= 0) {
    if (pkt->stream_index == d.stream_index) {
      if (avcodec_send_packet(d.dec, pkt) == 0) err = drain();
      // Corrupt packets are skipped (send_packet < 0), matching ffmpeg's
      // own CLI behaviour on truncated mp3 tails.
    }
    av_packet_unref(pkt);
  }
  if (err == 0) {
    avcodec_send_packet(d.dec, nullptr);  // flush
    err = drain();
  }
  av_packet_free(&pkt);
  av_frame_free(&frame);
  if (err < 0) return err;
  if (!channels || pcm.empty()) return ERR_DECODE;

  float* buf = static_cast<float*>(malloc(pcm.size() * sizeof(float)));
  if (!buf) return ERR_ALLOC;
  std::memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
  *out = buf;
  *sr = rate;
  *ch = channels;
  return static_cast<long long>(pcm.size() / channels);
}

void audec_free(float* buf) { free(buf); }

// Container-level info: estimated per-channel frame count (from the
// demuxer's duration estimate — for CBR mp3 without a Xing header this is
// bitrate-derived and may be off by a frame; the data layer only uses it
// for pack-size budgeting, mirroring the reference's use of
// torchaudio.info), plus sample rate and channels. Negative = error.
long long audec_info_file(const char* path, int* sr, int* ch) {
  av_log_set_level(AV_LOG_ERROR);
  Demux d;
  int rc = d.open(path);
  if (rc < 0) return rc;
  AVStream* st = d.fmt->streams[d.stream_index];
  *sr = st->codecpar->sample_rate;
  *ch = st->codecpar->ch_layout.nb_channels;
  double seconds = 0.0;
  if (st->duration > 0)
    seconds = st->duration * av_q2d(st->time_base);
  else if (d.fmt->duration > 0)
    seconds = double(d.fmt->duration) / AV_TIME_BASE;
  if (seconds <= 0.0 || *sr <= 0) return ERR_DECODE;
  return static_cast<long long>(seconds * (*sr) + 0.5);
}

}  // extern "C"
