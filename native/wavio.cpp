// Native batch audio loader for dsp_asr.
//
// The reference loads WAVs one by one in Python (SURVEY.md L0).  Feeding a
// device pipeline wants the host data path off the interpreter: this library
// decodes a whole batch of WAV files into a padded float32 matrix
// [n, max_samples] with a thread pool — RIFF parse, PCM8/16/32 + float32,
// multi-channel mono mix, linear resample to the target rate — one ctypes
// call per batch (dsp_asr/io/native.py).
//
// Sample normalisation matches dsp_asr/io/wav.py exactly:
//   pcm16: x/32768, pcm8: (x-128)/128, pcm32: x/2^31, float32: as-is;
// resampling matches numpy.interp on the grid t_out = i * sr_in / sr_out.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  int sample_rate = 0;
  std::vector<float> samples;  // mono
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Parse a RIFF/WAVE buffer into mono float samples. Returns 0 on success.
int parse_wav(const uint8_t* data, size_t size, WavData* out) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0)
    return 1;
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* pcm = nullptr;
  uint32_t pcm_bytes = 0;
  while (pos + 8 <= size) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk > size) chunk = static_cast<uint32_t>(size - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_bytes = chunk;
    }
    pos += 8 + chunk + (chunk & 1);  // chunks are word-aligned
  }
  if (!pcm || channels == 0 || rate == 0) return 2;
  bool is_float = (fmt == 3);
  if (fmt != 1 && fmt != 3) return 3;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return 3;
  size_t n_frames = pcm_bytes / (bytes_per * channels);
  out->sample_rate = static_cast<int>(rate);
  out->samples.resize(n_frames);
  for (size_t i = 0; i < n_frames; ++i) {
    float acc = 0.0f;
    for (unsigned c = 0; c < channels; ++c) {
      const uint8_t* s = pcm + (i * channels + c) * bytes_per;
      float v = 0.0f;
      if (is_float && bits == 32) {
        float f;
        std::memcpy(&f, s, 4);
        v = f;
      } else if (bits == 16) {
        int16_t x;
        std::memcpy(&x, s, 2);
        v = static_cast<float>(x) / 32768.0f;
      } else if (bits == 8) {
        v = (static_cast<float>(s[0]) - 128.0f) / 128.0f;
      } else if (bits == 32) {
        int32_t x;
        std::memcpy(&x, s, 4);
        v = static_cast<float>(static_cast<double>(x) / 2147483648.0);
      } else {
        return 3;
      }
      acc += v;
    }
    out->samples[i] = acc / static_cast<float>(channels);
  }
  return 0;
}

// numpy.interp-compatible linear resample.
void resample_linear(const std::vector<float>& in, int sr_in, int sr_out,
                     std::vector<float>* out) {
  if (sr_in == sr_out || in.empty()) {
    *out = in;
    return;
  }
  double ratio = static_cast<double>(sr_out) / sr_in;
  size_t n_out = static_cast<size_t>(in.size() * ratio + 0.5);
  out->resize(n_out);
  double step = static_cast<double>(sr_in) / sr_out;
  for (size_t i = 0; i < n_out; ++i) {
    double t = i * step;
    size_t lo = static_cast<size_t>(t);
    if (lo >= in.size() - 1) {
      (*out)[i] = in.back();
    } else {
      double frac = t - static_cast<double>(lo);
      (*out)[i] =
          static_cast<float>(in[lo] + (in[lo + 1] - in[lo]) * frac);
    }
  }
}

int read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return 1;
  }
  buf->resize(static_cast<size_t>(n));
  size_t got = std::fread(buf->data(), 1, buf->size(), f);
  std::fclose(f);
  return got == buf->size() ? 0 : 1;
}

}  // namespace

extern "C" {

// Decode one file into out[max_samples] (zero padded). Returns 0 ok.
int dsp_decode_wav(const char* path, int target_sr, float* out,
                   int64_t max_samples, int64_t* out_len) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf)) return 1;
  WavData wav;
  int rc = parse_wav(buf.data(), buf.size(), &wav);
  if (rc) return rc;
  std::vector<float> res;
  resample_linear(wav.samples, wav.sample_rate,
                  target_sr > 0 ? target_sr : wav.sample_rate, &res);
  int64_t n = static_cast<int64_t>(res.size());
  if (n > max_samples) n = max_samples;
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(max_samples));
  std::memcpy(out, res.data(), sizeof(float) * static_cast<size_t>(n));
  *out_len = n;
  return 0;
}

// Decode a batch with a thread pool into out[n, max_samples].
// Returns the number of files that failed (their rows stay zero, len 0).
int dsp_decode_wav_batch(const char** paths, int n, int target_sr,
                         float* out, int64_t max_samples, int64_t* out_lens,
                         int n_threads) {
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int64_t len = 0;
      int rc = dsp_decode_wav(paths[i], target_sr, out + i * max_samples,
                              max_samples, &len);
      out_lens[i] = rc ? 0 : len;
      if (rc) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
