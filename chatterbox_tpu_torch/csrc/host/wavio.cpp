// WAV reader for the data loader (dataload.cpp): RIFF/WAVE PCM16 / PCM32 /
// float32, channels scaled to [-1, 1] and averaged.
//
// ABI: plain C, int64 sizes, caller-owned buffers.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// RIFF helpers
// ---------------------------------------------------------------------------

struct WavInfo {
  int32_t sample_rate;
  int32_t channels;
  int32_t bits;         // 16 / 32
  int32_t is_float;     // 1 if IEEE float
  int64_t n_frames;     // samples per channel
  int64_t data_offset;  // byte offset of sample data
};

static int read_info(FILE* f, WavInfo* info) {
  char tag[5] = {0};
  uint32_t sz;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4)) return -1;
  if (fread(&sz, 4, 1, f) != 1) return -1;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4)) return -1;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  int64_t data_off = -1, data_len = 0;
  while (fread(tag, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!memcmp(tag, "fmt ", 4)) {
      uint8_t buf[64] = {0};
      uint32_t take = sz < 64 ? sz : 64;
      if (fread(buf, 1, take, f) != take) return -1;
      if (sz > take) fseek(f, sz - take, SEEK_CUR);
      memcpy(&fmt, buf + 0, 2);
      memcpy(&channels, buf + 2, 2);
      memcpy(&rate, buf + 4, 4);
      memcpy(&bits, buf + 14, 2);
    } else if (!memcmp(tag, "data", 4)) {
      data_off = ftell(f);
      data_len = sz;
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    } else {
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);
    }
  }
  if (data_off < 0 || channels == 0 || rate == 0) return -1;
  if (fmt != 1 && fmt != 3) return -2;  // PCM or IEEE float only
  info->sample_rate = (int32_t)rate;
  info->channels = (int32_t)channels;
  info->bits = (int32_t)bits;
  info->is_float = fmt == 3 ? 1 : 0;
  info->n_frames = data_len / (channels * (bits / 8));
  info->data_offset = data_off;
  return 0;
}

// Reads the file as mono float32 in [-1, 1] (channels averaged).
// out must hold info.n_frames floats. Returns frames read, <0 on error.
int64_t wav_read_mono_f32(const char* path, float* out, int64_t max_frames) {
  WavInfo info;
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (read_info(f, &info) != 0) { fclose(f); return -2; }
  int64_t n = info.n_frames < max_frames ? info.n_frames : max_frames;
  fseek(f, (long)info.data_offset, SEEK_SET);
  const int ch = info.channels;
  std::vector<uint8_t> row((size_t)ch * (info.bits / 8));
  for (int64_t i = 0; i < n; i++) {
    if (fread(row.data(), 1, row.size(), f) != row.size()) { n = i; break; }
    double acc = 0.0;
    for (int c = 0; c < ch; c++) {
      if (info.is_float && info.bits == 32) {
        float v; memcpy(&v, row.data() + c * 4, 4); acc += v;
      } else if (info.bits == 16) {
        int16_t v; memcpy(&v, row.data() + c * 2, 2); acc += v / 32768.0;
      } else if (info.bits == 32) {
        int32_t v; memcpy(&v, row.data() + c * 4, 4); acc += v / 2147483648.0;
      }
    }
    out[i] = (float)(acc / ch);
  }
  fclose(f);
  return n;
}

}  // extern "C"
