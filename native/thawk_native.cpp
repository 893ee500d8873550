// thawk_native — threaded host-side weight transformation kernels.
//
// The runtime streams GGML tensors from an mmap straight into
// device layouts ([out,in] row-major file blocks -> [in,out] transposed,
// q4 nibbles re-packed for the Pallas kernel).  Doing that with numpy
// costs several single-threaded passes and temporaries per multi-GB
// tensor; these C kernels do each conversion in one threaded pass.
//
// Plays the role the reference's C++ loader plays
// (/root/reference/th-llama-loader.cpp:121-265 tensor ingest +
// th.cpp:312-359 fp16 codec), for this framework's layouts.
//
// C ABI only; bound via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kQK = 32;  // quantization block length

inline float f16_to_f32(uint16_t h) {
  // bit-exact half -> float (no F16C dependency)
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FF;
      // subnormal value = (1 + man/1024) * 2^(-14 - shift)
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (man << 13);
    }
  } else if (exp == 0x1F) {
    bits = sign | 0x7F800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  // round-to-nearest-even
  uint32_t lsb = (bits >> 16) & 1;
  bits += 0x7FFFu + lsb;
  return (uint16_t)(bits >> 16);
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? (int64_t)hw : 4;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > n ? n : lo + chunk;
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// ---- fp16 <-> f32/bf16 ----------------------------------------------------

// src: f16 [rows, cols] row-major  ->  dst: f32 [rows, cols]
void thawk_f16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = f16_to_f32(src[i]);
  });
}

// src: f16 [rows, cols] -> dst: bf16 [cols, rows] (transposed, device layout)
void thawk_f16_to_bf16_transpose(const uint16_t* src, uint16_t* dst,
                                 int64_t rows, int64_t cols) {
  parallel_for(cols, [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c)
      for (int64_t r = 0; r < rows; ++r)
        dst[c * rows + r] = f32_to_bf16(f16_to_f32(src[r * cols + c]));
  });
}

// src: f32 [rows, cols] -> dst: bf16 [cols, rows]
void thawk_f32_to_bf16_transpose(const float* src, uint16_t* dst, int64_t rows,
                                 int64_t cols) {
  parallel_for(cols, [&](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c)
      for (int64_t r = 0; r < rows; ++r)
        dst[c * rows + r] = f32_to_bf16(src[r * cols + c]);
  });
}

// ---- ggjt v1 quantized block streams -> device layouts --------------------
//
// File layout (per tensor, row-major [rows, cols], blocks of 32 along cols):
//   q8_0 block: f32 d; int8 qs[32]              (36 B)
//   q4_0 block: f32 d; uint8 nibbles[16]        (20 B; adjacent-pair packing)
// Device layout ("in" = file cols = contraction dim):
//   q8: qs int8 [cols, rows];           scales f32 [cols/32, rows]
//   q4: qs uint8 [cols/2, rows] packed  (row j pairs logical rows j and
//       j+cols/2, offset-binary +8);    scales f32 [cols/32, rows]

void thawk_q8_decode_transpose(const uint8_t* raw, int8_t* qs_out,
                               float* scales_out, int64_t rows, int64_t cols) {
  const int64_t nbpr = cols / kQK;          // blocks per row
  const int64_t bb = 4 + kQK;               // bytes per block
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* rowp = raw + r * nbpr * bb;
      for (int64_t b = 0; b < nbpr; ++b) {
        const uint8_t* blk = rowp + b * bb;
        float d;
        std::memcpy(&d, blk, 4);
        scales_out[b * rows + r] = d;
        const int8_t* q = (const int8_t*)(blk + 4);
        for (int i = 0; i < kQK; ++i) {
          int64_t c = b * kQK + i;       // column in file = row in device
          qs_out[c * rows + r] = q[i];
        }
      }
    }
  });
}

void thawk_q4_decode_transpose_pack(const uint8_t* raw, uint8_t* qs_out,
                                    float* scales_out, int64_t rows,
                                    int64_t cols) {
  const int64_t nbpr = cols / kQK;
  const int64_t bb = 4 + kQK / 2;
  const int64_t half = cols / 2;
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* rowp = raw + r * nbpr * bb;
      for (int64_t b = 0; b < nbpr; ++b) {
        const uint8_t* blk = rowp + b * bb;
        float d;
        std::memcpy(&d, blk, 4);
        scales_out[b * rows + r] = d;
        const uint8_t* nib = blk + 4;
        for (int i = 0; i < kQK / 2; ++i) {
          // ggjt v1 adjacent-pair packing: byte i = col 2i | col 2i+1 << 4
          int64_t c0 = b * kQK + 2 * i;
          int64_t c1 = c0 + 1;
          uint8_t v0 = nib[i] & 0x0F;        // already offset-binary (+8)
          uint8_t v1 = nib[i] >> 4;
          // device packing: byte row j pairs logical rows j and j+half
          uint8_t* p0 = &qs_out[(c0 % half) * rows + r];
          uint8_t* p1 = &qs_out[(c1 % half) * rows + r];
          if (c0 < half) *p0 = (uint8_t)((*p0 & 0xF0) | v0);
          else           *p0 = (uint8_t)((*p0 & 0x0F) | (v0 << 4));
          if (c1 < half) *p1 = (uint8_t)((*p1 & 0xF0) | v1);
          else           *p1 = (uint8_t)((*p1 & 0x0F) | (v1 << 4));
        }
      }
    }
  });
}

// ---- host-side quantization (model conversion) ----------------------------

// x: f32 [rows, cols] -> ggjt q8_0 block stream
void thawk_q8_encode(const float* x, uint8_t* out, int64_t rows, int64_t cols) {
  const int64_t nbpr = cols / kQK;
  const int64_t bb = 4 + kQK;
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      for (int64_t b = 0; b < nbpr; ++b) {
        const float* xb = x + r * cols + b * kQK;
        float amax = 0.f;
        for (int i = 0; i < kQK; ++i) {
          float a = xb[i] < 0 ? -xb[i] : xb[i];
          if (a > amax) amax = a;
        }
        float d = amax / 127.0f;
        float inv = d != 0.f ? 1.0f / d : 0.0f;
        uint8_t* blk = out + (r * nbpr + b) * bb;
        std::memcpy(blk, &d, 4);
        int8_t* q = (int8_t*)(blk + 4);
        for (int i = 0; i < kQK; ++i) {
          float v = xb[i] * inv;
          // round-half-even to match the numpy (np.round) fallback —
          // the same tensor must quantize identically either way.
          int qi = (int)std::nearbyintf(v);
          if (qi > 127) qi = 127;
          if (qi < -127) qi = -127;
          q[i] = (int8_t)qi;
        }
      }
    }
  });
}

// x: f32 [rows, cols] -> ggjt q4_0 block stream (signed-absmax scheme)
void thawk_q4_encode(const float* x, uint8_t* out, int64_t rows, int64_t cols) {
  const int64_t nbpr = cols / kQK;
  const int64_t bb = 4 + kQK / 2;
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      for (int64_t b = 0; b < nbpr; ++b) {
        const float* xb = x + r * cols + b * kQK;
        float amax = 0.f, smax = 0.f;
        for (int i = 0; i < kQK; ++i) {
          float a = xb[i] < 0 ? -xb[i] : xb[i];
          if (a > amax) {
            amax = a;
            smax = xb[i];
          }
        }
        float d = smax / -8.0f;
        float inv = d != 0.f ? 1.0f / d : 0.0f;
        uint8_t* blk = out + (r * nbpr + b) * bb;
        std::memcpy(blk, &d, 4);
        uint8_t* q = blk + 4;
        for (int i = 0; i < kQK / 2; ++i) {
          float v0 = xb[2 * i] * inv, v1 = xb[2 * i + 1] * inv;
          int q0 = (int)std::nearbyintf(v0);  // round-half-even (see q8)
          int q1 = (int)std::nearbyintf(v1);
          if (q0 > 7) q0 = 7;
          if (q0 < -8) q0 = -8;
          if (q1 > 7) q1 = 7;
          if (q1 < -8) q1 = -8;
          q[i] = (uint8_t)((q0 + 8) | ((q1 + 8) << 4));
        }
      }
    }
  });
}

// ---- k-quant scalar reference dequantizers --------------------------------
//
// INDEPENDENT second implementation of the GGUF k-quant block formats,
// written element-at-a-time from the struct layouts (the shape of
// llama.cpp's scalar dequantize_row_* code) as a cross-check for the
// vectorized numpy codecs in ggml/kquants.py: with no llama.cpp binary
// or real weight file available in this environment, two structurally
// different implementations agreeing bit-for-bit is the strongest
// available layout validation (tests/test_kquant_crosscheck.py).

static inline void get_scale_min_k4(int j, const uint8_t* q, uint8_t* d,
                                    uint8_t* m) {
  if (j < 4) {
    *d = q[j] & 63;
    *m = q[j + 4] & 63;
  } else {
    *d = (q[j + 4] & 0xF) | ((q[j - 4] >> 6) << 4);
    *m = (q[j + 4] >> 4) | ((q[j] >> 6) << 4);
  }
}

void thawk_dequant_q4_k(const uint8_t* raw, float* y, int64_t nb) {
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* b = raw + i * 144;
    const float d = f16_to_f32(*(const uint16_t*)(b + 0));
    const float dmin = f16_to_f32(*(const uint16_t*)(b + 2));
    const uint8_t* scales = b + 4;
    const uint8_t* q = b + 16;
    float* yy = y + i * 256;
    int is = 0;
    for (int j = 0; j < 256; j += 64) {
      uint8_t sc, m;
      get_scale_min_k4(is + 0, scales, &sc, &m);
      const float d1 = d * sc, m1 = dmin * m;
      get_scale_min_k4(is + 1, scales, &sc, &m);
      const float d2 = d * sc, m2 = dmin * m;
      for (int l = 0; l < 32; ++l) *yy++ = d1 * (q[l] & 0xF) - m1;
      for (int l = 0; l < 32; ++l) *yy++ = d2 * (q[l] >> 4) - m2;
      q += 32;
      is += 2;
    }
  }
}

void thawk_dequant_q5_k(const uint8_t* raw, float* y, int64_t nb) {
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* b = raw + i * 176;
    const float d = f16_to_f32(*(const uint16_t*)(b + 0));
    const float dmin = f16_to_f32(*(const uint16_t*)(b + 2));
    const uint8_t* scales = b + 4;
    const uint8_t* qh = b + 16;
    const uint8_t* ql = b + 48;
    float* yy = y + i * 256;
    int is = 0;
    uint8_t u1 = 1, u2 = 2;
    for (int j = 0; j < 256; j += 64) {
      uint8_t sc, m;
      get_scale_min_k4(is + 0, scales, &sc, &m);
      const float d1 = d * sc, m1 = dmin * m;
      get_scale_min_k4(is + 1, scales, &sc, &m);
      const float d2 = d * sc, m2 = dmin * m;
      for (int l = 0; l < 32; ++l)
        *yy++ = d1 * ((ql[l] & 0xF) + ((qh[l] & u1) ? 16 : 0)) - m1;
      for (int l = 0; l < 32; ++l)
        *yy++ = d2 * ((ql[l] >> 4) + ((qh[l] & u2) ? 16 : 0)) - m2;
      ql += 32;
      is += 2;
      u1 <<= 2;
      u2 <<= 2;
    }
  }
}

void thawk_dequant_q6_k(const uint8_t* raw, float* y, int64_t nb) {
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* b = raw + i * 210;
    const uint8_t* ql = b;
    const uint8_t* qh = b + 128;
    const int8_t* sc = (const int8_t*)(b + 192);
    const float d = f16_to_f32(*(const uint16_t*)(b + 208));
    float* yy = y + i * 256;
    for (int n = 0; n < 256; n += 128) {
      for (int l = 0; l < 32; ++l) {
        const int is = l / 16;
        const int8_t q1 =
            (int8_t)((ql[l] & 0xF) | (((qh[l] >> 0) & 3) << 4)) - 32;
        const int8_t q2 =
            (int8_t)((ql[l + 32] & 0xF) | (((qh[l] >> 2) & 3) << 4)) - 32;
        const int8_t q3 =
            (int8_t)((ql[l] >> 4) | (((qh[l] >> 4) & 3) << 4)) - 32;
        const int8_t q4 =
            (int8_t)((ql[l + 32] >> 4) | (((qh[l] >> 6) & 3) << 4)) - 32;
        yy[l] = d * sc[is] * q1;
        yy[l + 32] = d * sc[is + 2] * q2;
        yy[l + 64] = d * sc[is + 4] * q3;
        yy[l + 96] = d * sc[is + 6] * q4;
      }
      yy += 128;
      ql += 64;
      qh += 32;
      sc += 8;
    }
  }
}

void thawk_dequant_q2_k(const uint8_t* raw, float* y, int64_t nb) {
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* b = raw + i * 84;
    const uint8_t* sc = b;
    const uint8_t* q = b + 16;
    const float d = f16_to_f32(*(const uint16_t*)(b + 80));
    const float dmin = f16_to_f32(*(const uint16_t*)(b + 82));
    float* yy = y + i * 256;
    int is = 0;
    for (int n = 0; n < 256; n += 128) {
      int shift = 0;
      for (int j = 0; j < 4; ++j) {
        uint8_t s = sc[is++];
        float dl = d * (s & 0xF), ml = dmin * (s >> 4);
        for (int l = 0; l < 16; ++l)
          *yy++ = dl * ((q[l] >> shift) & 3) - ml;
        s = sc[is++];
        dl = d * (s & 0xF);
        ml = dmin * (s >> 4);
        for (int l = 16; l < 32; ++l)
          *yy++ = dl * ((q[l] >> shift) & 3) - ml;
        shift += 2;
      }
      q += 32;
    }
  }
}

void thawk_dequant_q3_k(const uint8_t* raw, float* y, int64_t nb) {
  const uint32_t kmask1 = 0x03030303, kmask2 = 0x0f0f0f0f;
  for (int64_t i = 0; i < nb; ++i) {
    const uint8_t* b = raw + i * 110;
    const uint8_t* hm = b;
    const uint8_t* q = b + 32;
    const float d = f16_to_f32(*(const uint16_t*)(b + 108));
    uint32_t aux[4];
    memcpy(aux, b + 96, 12);
    const uint32_t tmp = aux[2];
    aux[2] = ((aux[0] >> 4) & kmask2) | (((tmp >> 4) & kmask1) << 4);
    aux[3] = ((aux[1] >> 4) & kmask2) | (((tmp >> 6) & kmask1) << 4);
    aux[0] = (aux[0] & kmask2) | (((tmp >> 0) & kmask1) << 4);
    aux[1] = (aux[1] & kmask2) | (((tmp >> 2) & kmask1) << 4);
    const int8_t* scales = (const int8_t*)aux;
    float* yy = y + i * 256;
    uint8_t m = 1;
    int is = 0;
    for (int n = 0; n < 256; n += 128) {
      int shift = 0;
      for (int j = 0; j < 4; ++j) {
        float dl = d * (scales[is++] - 32);
        for (int l = 0; l < 16; ++l)
          *yy++ = dl * (((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
        dl = d * (scales[is++] - 32);
        for (int l = 16; l < 32; ++l)
          *yy++ = dl * (((q[l] >> shift) & 3) - ((hm[l] & m) ? 0 : 4));
        shift += 2;
        m <<= 1;
      }
      q += 32;
    }
  }
}

}  // extern "C"

// ---- independent GGUF container writer -------------------------------------
//
// A complete tiny GGUF v3 llama file written element-at-a-time from the
// published container spec — INDEPENDENT of the Python writer
// (ggml/gguf.py write_gguf), as the container-level half of the codec
// cross-check: the Python parser must load a file this code produces
// byte-stream-compatibly (header, every kv value type it uses, string
// arrays, ne0-fastest dims, non-default alignment, GGUF f16-scale
// quant blocks with the first-half/second-half nibble split).
// Weights are a deterministic LCG stream so tests can reproduce the
// expected values without shipping a fixture blob.

namespace {

// GGUF kv value type ids (container spec).
enum : uint32_t {
  GGUF_U32 = 4,
  GGUF_F32 = 6,
  GGUF_STR = 8,
  GGUF_ARR = 9,
};

inline uint16_t f32_to_f16_rne(float f) {
  // Round-to-nearest-even f32 -> f16, bit-level (no <stdfloat> dep).
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = (int32_t)((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (((x >> 23) & 0xFF) == 0xFF) return (uint16_t)(sign | 0x7C00u | (mant ? 1 : 0));
  if (exp >= 0x1F) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflow -> 0
    mant |= 0x800000u;                      // make implicit bit explicit
    int shift = 14 - exp;                   // exp in [-10, 0] -> shift in [14, 24]
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1), mid = 1u << (shift - 1);
    if (rem > mid || (rem == mid && (half & 1))) half++;
    return (uint16_t)(sign | half);
  }
  uint32_t half = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1))) half++;
  return (uint16_t)(sign | half);
}

struct Lcg {
  uint64_t s;
  explicit Lcg(uint64_t seed) : s(seed) {}
  // Numerical Recipes LCG; float in [-0.5, 0.5).
  float next() {
    s = s * 6364136223846793005ull + 1442695040888963407ull;
    return (float)((s >> 33) & 0xFFFFFFu) / 16777216.0f - 0.5f;
  }
};

struct Buf {
  std::vector<uint8_t> v;
  void raw(const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    v.insert(v.end(), b, b + n);
  }
  void u32(uint32_t x) { raw(&x, 4); }
  void u64(uint64_t x) { raw(&x, 8); }
  void f32v(float x) { raw(&x, 4); }
  void str(const std::string& s) { u64(s.size()); raw(s.data(), s.size()); }
  void pad_to(size_t align) { v.resize((v.size() + align - 1) / align * align, 0); }
};

void kv_u32(Buf& b, const char* k, uint32_t x) { b.str(k); b.u32(GGUF_U32); b.u32(x); }
void kv_str(Buf& b, const char* k, const std::string& s) { b.str(k); b.u32(GGUF_STR); b.str(s); }

// GGUF-format quant blocks (f16 scale; low nibbles = elems 0..15, high
// = 16..31 — NOT the ggjt adjacent-pair layout the encoders above use).
void gguf_q8_blocks(const float* x, int64_t n, Buf& out) {
  for (int64_t b = 0; b < n / kQK; ++b) {
    const float* xb = x + b * kQK;
    float amax = 0.f;
    for (int i = 0; i < kQK; ++i) amax = std::max(amax, std::fabs(xb[i]));
    float d = amax / 127.0f;
    uint16_t dh = f32_to_f16_rne(d);
    float dr;  // quantize with the f16-rounded scale (llama.cpp stores f16)
    {
      uint32_t e = ((dh & 0x7C00u) ? ((uint32_t)(((dh >> 10) & 0x1F) - 15 + 127) << 23) : 0) |
                   ((uint32_t)(dh & 0x3FFu) << 13) | ((uint32_t)(dh & 0x8000u) << 16);
      std::memcpy(&dr, &e, 4);
    }
    float inv = dr != 0.f ? 1.0f / dr : 0.0f;
    out.raw(&dh, 2);
    for (int i = 0; i < kQK; ++i) {
      int q = (int)std::nearbyintf(xb[i] * inv);
      q = std::min(127, std::max(-127, q));
      int8_t q8 = (int8_t)q;
      out.raw(&q8, 1);
    }
  }
}

void gguf_q4_blocks(const float* x, int64_t n, Buf& out) {
  for (int64_t b = 0; b < n / kQK; ++b) {
    const float* xb = x + b * kQK;
    float amax = 0.f, smax = 0.f;
    for (int i = 0; i < kQK; ++i) {
      float a = std::fabs(xb[i]);
      if (a > amax) { amax = a; smax = xb[i]; }
    }
    float d = smax / -8.0f;
    uint16_t dh = f32_to_f16_rne(d);
    float dr;
    {
      uint32_t e = ((dh & 0x7C00u) ? ((uint32_t)(((dh >> 10) & 0x1F) - 15 + 127) << 23) : 0) |
                   ((uint32_t)(dh & 0x3FFu) << 13) | ((uint32_t)(dh & 0x8000u) << 16);
      std::memcpy(&dr, &e, 4);
    }
    float inv = dr != 0.f ? 1.0f / dr : 0.0f;
    out.raw(&dh, 2);
    for (int i = 0; i < kQK / 2; ++i) {
      int q0 = (int)std::nearbyintf(xb[i] * inv) + 8;           // elems 0..15
      int q1 = (int)std::nearbyintf(xb[i + kQK / 2] * inv) + 8;  // elems 16..31
      q0 = std::min(15, std::max(0, q0));
      q1 = std::min(15, std::max(0, q1));
      uint8_t p = (uint8_t)(q0 | (q1 << 4));
      out.raw(&p, 1);
    }
  }
}

struct TensorOut {
  std::string name;
  uint32_t gtype;           // 0=f32, 1=f16, 2=q4_0, 8=q8_0
  std::vector<uint64_t> ne; // ne0 fastest (GGUF order)
  std::vector<uint8_t> payload;
};

TensorOut make_tensor(const std::string& name, uint32_t gtype,
                      int64_t rows, int64_t cols, uint64_t seed) {
  TensorOut t;
  t.name = name;
  t.gtype = gtype;
  if (cols > 0) t.ne = {(uint64_t)cols, (uint64_t)rows};  // ne0 fastest
  else t.ne = {(uint64_t)rows};
  int64_t n = rows * (cols > 0 ? cols : 1);
  std::vector<float> x((size_t)n);
  Lcg g(seed);
  for (int64_t i = 0; i < n; ++i) x[(size_t)i] = g.next();
  Buf b;
  if (gtype == 0) b.raw(x.data(), (size_t)n * 4);
  else if (gtype == 1) {
    for (int64_t i = 0; i < n; ++i) { uint16_t h = f32_to_f16_rne(x[(size_t)i]); b.raw(&h, 2); }
  } else if (gtype == 2) gguf_q4_blocks(x.data(), n, b);
  else gguf_q8_blocks(x.data(), n, b);
  t.payload = std::move(b.v);
  return t;
}

}  // namespace

extern "C" {

// Writes a complete tiny GGUF v3 llama model with an SPM byte-fallback
// vocab and LCG weights.  Tensor seeds: `seed * 1000003 + index` in
// the fixed write order (token_embd, output_norm, then per layer:
// attn_norm, attn_q, attn_k, attn_v, attn_output, ffn_norm, ffn_gate,
// ffn_down, ffn_up).  output.weight is omitted (tied embeddings).
// Returns 0 on success.
int thawk_write_tiny_gguf(const char* path, int32_t n_vocab, int32_t n_embd,
                          int32_t n_head, int32_t n_layer, int32_t n_ff,
                          uint64_t seed) {
  const uint32_t align = 64;  // non-default on purpose (parser must honor it)
  Buf b;

  // ---- tensors (payloads first so infos can carry offsets) ----
  std::vector<TensorOut> ts;
  uint64_t idx = 0;
  auto s = [&]() { return seed * 1000003ull + (idx++); };
  ts.push_back(make_tensor("token_embd.weight", 1, n_vocab, n_embd, s()));
  ts.push_back(make_tensor("output_norm.weight", 0, n_embd, 0, s()));
  for (int l = 0; l < n_layer; ++l) {
    std::string p = "blk." + std::to_string(l) + ".";
    ts.push_back(make_tensor(p + "attn_norm.weight", 0, n_embd, 0, s()));
    ts.push_back(make_tensor(p + "attn_q.weight", 2, n_embd, n_embd, s()));
    ts.push_back(make_tensor(p + "attn_k.weight", 2, n_embd, n_embd, s()));
    ts.push_back(make_tensor(p + "attn_v.weight", 2, n_embd, n_embd, s()));
    ts.push_back(make_tensor(p + "attn_output.weight", 2, n_embd, n_embd, s()));
    ts.push_back(make_tensor(p + "ffn_norm.weight", 0, n_embd, 0, s()));
    ts.push_back(make_tensor(p + "ffn_gate.weight", 8, n_ff, n_embd, s()));
    ts.push_back(make_tensor(p + "ffn_down.weight", 8, n_embd, n_ff, s()));
    ts.push_back(make_tensor(p + "ffn_up.weight", 8, n_ff, n_embd, s()));
  }

  // ---- header ----
  b.u32(0x46554747u);  // "GGUF"
  b.u32(3);            // version
  b.u64(ts.size());
  b.u64(13);           // kv count (keep in sync below)

  // ---- metadata ----
  kv_str(b, "general.architecture", "llama");
  kv_u32(b, "general.alignment", align);
  kv_u32(b, "llama.embedding_length", (uint32_t)n_embd);
  kv_u32(b, "llama.block_count", (uint32_t)n_layer);
  kv_u32(b, "llama.attention.head_count", (uint32_t)n_head);
  kv_u32(b, "llama.feed_forward_length", (uint32_t)n_ff);
  kv_u32(b, "llama.rope.dimension_count", (uint32_t)(n_embd / n_head));
  kv_str(b, "tokenizer.ggml.model", "llama");
  // SPM byte-fallback vocab: specials + <0xHH> byte pieces + filler.
  b.str("tokenizer.ggml.tokens");
  b.u32(GGUF_ARR);
  b.u32(GGUF_STR);
  b.u64((uint64_t)n_vocab);
  for (int i = 0; i < n_vocab; ++i) {
    if (i == 0) b.str("<unk>");
    else if (i == 1) b.str("<s>");
    else if (i == 2) b.str("</s>");
    else if (i < 259) {
      char t[8];
      std::snprintf(t, sizeof t, "<0x%02X>", i - 3);
      b.str(t);
    } else b.str("tok" + std::to_string(i));
  }
  b.str("tokenizer.ggml.scores");
  b.u32(GGUF_ARR);
  b.u32(GGUF_F32);
  b.u64((uint64_t)n_vocab);
  for (int i = 0; i < n_vocab; ++i) b.f32v(i < 259 ? -1e6f : (float)i);
  b.str("tokenizer.ggml.token_type");
  b.u32(GGUF_ARR);
  b.u32(GGUF_U32);
  b.u64((uint64_t)n_vocab);
  for (int i = 0; i < n_vocab; ++i)
    b.u32(i < 3 ? 3u : (i < 259 ? 6u : 1u));  // control / byte / normal
  kv_u32(b, "tokenizer.ggml.bos_token_id", 1);
  kv_u32(b, "tokenizer.ggml.eos_token_id", 2);

  // ---- tensor infos ----
  uint64_t rel = 0;
  for (auto& t : ts) {
    b.str(t.name);
    b.u32((uint32_t)t.ne.size());
    for (uint64_t d : t.ne) b.u64(d);
    b.u32(t.gtype);
    b.u64(rel);
    rel = (rel + t.payload.size() + align - 1) / align * align;
  }

  // ---- data ----
  b.pad_to(align);
  for (auto& t : ts) {
    b.raw(t.payload.data(), t.payload.size());
    b.pad_to(align);
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  size_t w = std::fwrite(b.v.data(), 1, b.v.size(), f);
  std::fclose(f);
  return w == b.v.size() ? 0 : 2;
}

}  // extern "C"
