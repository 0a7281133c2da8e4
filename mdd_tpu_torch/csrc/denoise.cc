// Spectral-subtraction noise suppressor.
//
// Native replacement for the reference's missing `eeo_apm_test` denoise
// binary (a WebRTC-APM-style tool invoked as `eeo_apm_test in.wav
// silence.wav out.wav 4 0`, egs/attention_aug/infer.py:506-507; the blob
// is absent from the repo — .MISSING_LARGE_BLOBS).  Implemented from
// scratch: STFT (radix-2 FFT, sqrt-Hann analysis/synthesis windows,
// 75% overlap), a minimum-statistics-flavored adaptive noise floor, and
// a Wiener-style gain with over-subtraction and a spectral floor,
// overlap-added back to the waveform.
//
// The port's copy of mdd_tpu's denoiser, the same code built with the
// same g++ flags (mdd_tpu_torch/ops/build.py), so that both packages
// denoise a waveform to the same bits.  Exposed both as a C API
// (libmdddenoise.so, driven from Python via ctypes —
// mdd_tpu_torch/native/__init__.py) and as a standalone CLI (mdd_denoise
// in.wav out.wav [aggressiveness], built with -DMDD_DENOISE_MAIN).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kFft = 512;       // 32 ms @ 16 kHz
constexpr int kHop = 128;       // 75% overlap
constexpr float kPi = 3.14159265358979323846f;

// In-place iterative radix-2 complex FFT (sign=-1 forward, +1 inverse).
void fft(float* re, float* im, int n, int sign) {
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (int len = 2; len <= n; len <<= 1) {
    float ang = sign * 2.0f * kPi / len;
    float wr = std::cos(ang), wi = std::sin(ang);
    for (int i = 0; i < n; i += len) {
      float cr = 1.0f, ci = 0.0f;
      for (int k = 0; k < len / 2; ++k) {
        int a = i + k, b = i + k + len / 2;
        float xr = re[b] * cr - im[b] * ci;
        float xi = re[b] * ci + im[b] * cr;
        re[b] = re[a] - xr;
        im[b] = im[a] - xi;
        re[a] += xr;
        im[a] += xi;
        float ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
  if (sign > 0) {
    float inv = 1.0f / n;
    for (int i = 0; i < n; ++i) {
      re[i] *= inv;
      im[i] *= inv;
    }
  }
}

struct NsState {
  std::vector<float> noise;     // noise power estimate per bin
  std::vector<float> window;    // sqrt-Hann
  float oversub;
  float floor_gain;
  int frames_seen = 0;

  explicit NsState(int aggressiveness) {
    // aggressiveness 0..4 like WebRTC NS levels; reference passes 4.
    float levels_over[5] = {1.0f, 1.5f, 2.0f, 2.5f, 3.0f};
    float levels_floor[5] = {0.30f, 0.20f, 0.12f, 0.08f, 0.05f};
    int a = aggressiveness < 0 ? 0 : (aggressiveness > 4 ? 4 : aggressiveness);
    oversub = levels_over[a];
    floor_gain = levels_floor[a];
    noise.assign(kFft / 2 + 1, 0.0f);
    window.resize(kFft);
    for (int i = 0; i < kFft; ++i) {
      float h = 0.5f - 0.5f * std::cos(2.0f * kPi * i / kFft);
      window[i] = std::sqrt(h);
    }
  }
};

}  // namespace

extern "C" {

// Denoise `n` float samples (any scale) from `in` into `out`.
// `aggressiveness` in [0,4].  Returns 0 on success.
int mdd_denoise_process(const float* in, int n, int aggressiveness,
                        float* out) {
  if (n <= 0) return 0;
  NsState st(aggressiveness);
  const int bins = kFft / 2 + 1;

  // Pad so every sample is covered by a full analysis frame.
  int padded = ((n + kFft - 1) / kHop) * kHop + kFft;
  std::vector<float> x(padded, 0.0f), y(padded, 0.0f), wsum(padded, 0.0f);
  std::memcpy(x.data(), in, n * sizeof(float));

  std::vector<float> re(kFft), im(kFft), mag2(bins);
  for (int start = 0; start + kFft <= padded; start += kHop) {
    for (int i = 0; i < kFft; ++i) {
      re[i] = x[start + i] * st.window[i];
      im[i] = 0.0f;
    }
    fft(re.data(), im.data(), kFft, -1);
    for (int b = 0; b < bins; ++b)
      mag2[b] = re[b] * re[b] + im[b] * im[b];

    // Noise estimate: running mean over the first ~0.25 s, then
    // speech-presence-gated smoothing — bins near the current estimate
    // (likely noise) track at 0.05, bins far above it (likely speech)
    // barely move, so the estimate stays at the noise mean instead of
    // decaying toward its lower quantiles.
    ++st.frames_seen;
    for (int b = 0; b < bins; ++b) {
      if (st.frames_seen <= 30) {
        st.noise[b] += (mag2[b] - st.noise[b]) / st.frames_seen;
      } else {
        float rate = mag2[b] < 4.0f * st.noise[b] ? 0.05f : 0.001f;
        st.noise[b] += rate * (mag2[b] - st.noise[b]);
      }
    }

    // Wiener-style gain with over-subtraction + spectral floor.
    for (int b = 0; b < bins; ++b) {
      float sub = st.oversub * st.noise[b];
      float g = (mag2[b] - sub) / (mag2[b] + 1e-12f);
      if (g < st.floor_gain * st.floor_gain) g = st.floor_gain * st.floor_gain;
      g = std::sqrt(g);
      int bc = (b == 0 || b == kFft / 2) ? b : kFft - b;
      re[b] *= g;
      im[b] *= g;
      if (bc != b) {  // keep Hermitian symmetry
        re[bc] = re[b];
        im[bc] = -im[b];
      }
    }

    fft(re.data(), im.data(), kFft, +1);
    for (int i = 0; i < kFft; ++i) {
      y[start + i] += re[i] * st.window[i];
      wsum[start + i] += st.window[i] * st.window[i];
    }
  }
  for (int i = 0; i < n; ++i)
    out[i] = wsum[i] > 1e-8f ? y[i] / wsum[i] : x[i];
  return 0;
}

}  // extern "C"

#ifdef MDD_DENOISE_MAIN
// Minimal PCM16 mono WAV I/O for the CLI tool.
namespace {
struct Wav {
  int sample_rate = 0;
  std::vector<float> data;
};

bool read_wav(const char* path, Wav* w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  unsigned char hdr[44];
  if (std::fread(hdr, 1, 12, f) != 12) { std::fclose(f); return false; }
  uint16_t channels = 1, bits = 16;
  uint32_t sr = 16000;
  // chunk walk
  for (;;) {
    unsigned char ch[8];
    if (std::fread(ch, 1, 8, f) != 8) { std::fclose(f); return false; }
    uint32_t size = ch[4] | ch[5] << 8 | ch[6] << 16 | (uint32_t)ch[7] << 24;
    if (!std::memcmp(ch, "fmt ", 4)) {
      std::vector<unsigned char> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != size) { std::fclose(f); return false; }
      channels = fmt[2] | fmt[3] << 8;
      sr = fmt[4] | fmt[5] << 8 | fmt[6] << 16 | (uint32_t)fmt[7] << 24;
      bits = fmt[14] | fmt[15] << 8;
    } else if (!std::memcmp(ch, "data", 4)) {
      if (bits != 16) { std::fclose(f); return false; }
      std::vector<int16_t> raw(size / 2);
      if (std::fread(raw.data(), 1, size, f) != size) { std::fclose(f); return false; }
      w->sample_rate = (int)sr;
      size_t frames = raw.size() / channels;
      w->data.resize(frames);
      for (size_t i = 0; i < frames; ++i) w->data[i] = (float)raw[i * channels];
      std::fclose(f);
      return true;
    } else {
      std::fseek(f, size, SEEK_CUR);
    }
  }
}

bool write_wav(const char* path, const Wav& w) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  uint32_t n = (uint32_t)w.data.size();
  uint32_t data_size = n * 2, riff = 36 + data_size, sr = w.sample_rate;
  uint32_t byte_rate = sr * 2;
  unsigned char hdr[44] = {'R','I','F','F',
    (unsigned char)riff, (unsigned char)(riff>>8), (unsigned char)(riff>>16), (unsigned char)(riff>>24),
    'W','A','V','E','f','m','t',' ', 16,0,0,0, 1,0, 1,0,
    (unsigned char)sr, (unsigned char)(sr>>8), (unsigned char)(sr>>16), (unsigned char)(sr>>24),
    (unsigned char)byte_rate, (unsigned char)(byte_rate>>8), (unsigned char)(byte_rate>>16), (unsigned char)(byte_rate>>24),
    2,0, 16,0, 'd','a','t','a',
    (unsigned char)data_size, (unsigned char)(data_size>>8), (unsigned char)(data_size>>16), (unsigned char)(data_size>>24)};
  std::fwrite(hdr, 1, 44, f);
  for (float v : w.data) {
    float c = v < -32768.f ? -32768.f : (v > 32767.f ? 32767.f : v);
    int16_t s = (int16_t)std::lrintf(c);
    std::fwrite(&s, 2, 1, f);
  }
  std::fclose(f);
  return true;
}
}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: mdd_denoise in.wav out.wav [aggressiveness 0-4]\n");
    return 1;
  }
  int aggr = argc > 3 ? std::atoi(argv[3]) : 4;
  Wav w;
  if (!read_wav(argv[1], &w)) {
    std::fprintf(stderr, "cannot read %s\n", argv[1]);
    return 1;
  }
  std::vector<float> out(w.data.size());
  mdd_denoise_process(w.data.data(), (int)w.data.size(), aggr, out.data());
  Wav o{w.sample_rate, std::move(out)};
  if (!write_wav(argv[2], o)) {
    std::fprintf(stderr, "cannot write %s\n", argv[2]);
    return 1;
  }
  return 0;
}
#endif  // MDD_DENOISE_MAIN
