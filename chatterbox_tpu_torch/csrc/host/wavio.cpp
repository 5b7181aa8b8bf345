// WAV reader for the data loader (dataload.cpp): RIFF/WAVE PCM (8-bit
// unsigned, 16-, 24- and 32-bit signed) and IEEE float (32- and 64-bit),
// plain or WAVE_FORMAT_EXTENSIBLE; each sample scaled to [-1, 1] (PCM by
// 2^(bits-1), 8-bit as (v - 128) / 128), then the channels averaged. What
// utils/audio_io.read_wav decodes through scipy, to float32 rounding. Any
// other header (bits not a multiple of 8, a block align that disagrees with
// channels x bytes, another format) is refused with a negative return,
// which the loader counts as an error.
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
  int32_t bits;         // 8 / 16 / 24 / 32 PCM, 32 / 64 float
  int32_t is_float;     // 1 if IEEE float
  int64_t n_frames;     // samples per channel
  int64_t data_offset;  // byte offset of sample data
};

static const uint16_t kPcm = 1, kFloat = 3, kExtensible = 0xFFFE;

// The tail of a KSDATAFORMAT_SUBTYPE GUID whose first two bytes name the
// format ({XXXXXXXX-0000-0010-8000-00AA00389B71}, little-endian layout)
static const uint8_t kGuidTail[14] = {0x00, 0x00, 0x00, 0x00, 0x10, 0x00, 0x80,
                                      0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71};

static int read_info(FILE* f, WavInfo* info) {
  char tag[5] = {0};
  uint32_t sz;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "RIFF", 4)) return -1;
  if (fread(&sz, 4, 1, f) != 1) return -1;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "WAVE", 4)) return -1;
  uint16_t fmt = 0, channels = 0, block_align = 0, bits = 0;
  uint32_t rate = 0;
  int have_fmt = 0;
  int64_t data_off = -1, data_len = 0;
  while (fread(tag, 1, 4, f) == 4 && fread(&sz, 4, 1, f) == 1) {
    if (!memcmp(tag, "fmt ", 4)) {
      uint8_t buf[64] = {0};
      uint32_t take = sz < 64 ? sz : 64;
      if (take < 16 || fread(buf, 1, take, f) != take) return -1;
      fseek(f, ((sz + 1) & ~1u) - take, SEEK_CUR);
      memcpy(&fmt, buf + 0, 2);
      memcpy(&channels, buf + 2, 2);
      memcpy(&rate, buf + 4, 4);
      memcpy(&block_align, buf + 12, 2);
      memcpy(&bits, buf + 14, 2);
      if (fmt == kExtensible) {
        // cbSize (2), valid bits (2), channel mask (4), subformat GUID (16)
        if (take < 40 || memcmp(buf + 26, kGuidTail, 14)) return -2;
        memcpy(&fmt, buf + 24, 2);
      }
      have_fmt = 1;
    } else if (!memcmp(tag, "data", 4)) {
      data_off = ftell(f);
      data_len = sz;
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);  // chunks are word-aligned
    } else {
      fseek(f, (sz + 1) & ~1u, SEEK_CUR);
    }
  }
  if (!have_fmt || data_off < 0 || channels == 0 || rate == 0) return -1;
  const int pcm_ok = fmt == kPcm && (bits == 8 || bits == 16 || bits == 24 || bits == 32);
  const int float_ok = fmt == kFloat && (bits == 32 || bits == 64);
  if (!pcm_ok && !float_ok) return -2;
  if (block_align != channels * (bits / 8)) return -2;
  info->sample_rate = (int32_t)rate;
  info->channels = (int32_t)channels;
  info->bits = (int32_t)bits;
  info->is_float = fmt == kFloat ? 1 : 0;
  info->n_frames = data_len / block_align;
  info->data_offset = data_off;
  return 0;
}

// One sample at p, scaled to [-1, 1].
static double sample(const uint8_t* p, int bits, int is_float) {
  if (is_float) {
    if (bits == 64) { double v; memcpy(&v, p, 8); return v; }
    float v; memcpy(&v, p, 4); return v;
  }
  switch (bits) {
    case 8: return (p[0] - 128.0) / 128.0;
    case 16: { int16_t v; memcpy(&v, p, 2); return v / 32768.0; }
    case 24: {
      int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16));
      if (v & 0x800000) v -= 1 << 24;
      return v / 8388608.0;
    }
    default: { int32_t v; memcpy(&v, p, 4); return v / 2147483648.0; }
  }
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
  const int ch = info.channels, width = info.bits / 8;
  std::vector<uint8_t> row((size_t)ch * width);
  for (int64_t i = 0; i < n; i++) {
    if (fread(row.data(), 1, row.size(), f) != row.size()) { n = i; break; }
    double acc = 0.0;
    for (int c = 0; c < ch; c++) acc += sample(row.data() + c * width, info.bits, info.is_float);
    out[i] = (float)(acc / ch);
  }
  fclose(f);
  return n;
}

}  // extern "C"
