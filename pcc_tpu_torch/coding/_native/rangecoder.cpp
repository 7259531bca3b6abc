// Host-side range coder for the latent stream (.p.bin): the PyTorch port's
// copy of pcc_tpu/coding/_native/rangecoder.cpp (rc_encode, rc_decode).
//
// Replaces the torchac C++ arithmetic coder the reference calls at
// compress.py:136 / decompress.py:93. Each symbol slot i carries its own
// quantized CDF row (the conditional probability model's output), so the
// decoder — which reproduces the identical CDF from the transmitted
// skeleton — can invert the stream exactly.
//
// Canonical carry-propagating byte-wise range coder (LZMA-style shift-low
// with cache byte + 0xFF run), 32-bit range, per-row integer CDFs with
// total = cdf[row][Lp-1]. The first output byte is always 0 (the initial
// cache), which the decoder consumes during its 5-byte init.

#include <cstdint>

namespace {

constexpr uint32_t kTop = 1u << 24;

class Encoder {
 public:
  Encoder(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}

  void encode(uint32_t start, uint32_t size, uint32_t total) {
    range_ /= total;
    low_ += static_cast<uint64_t>(start) * range_;
    range_ *= size;
    while (range_ < kTop) {
      shift_low();
      range_ <<= 8;
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shift_low();
  }

  bool ok() const { return ok_; }
  int64_t size() const { return pos_; }

 private:
  void put(uint8_t b) {
    if (pos_ >= cap_) {
      ok_ = false;
      return;
    }
    out_[pos_++] = b;
  }

  void shift_low() {
    if (static_cast<uint32_t>(low_) < 0xFF000000u || (low_ >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      uint8_t b = cache_;
      do {
        put(static_cast<uint8_t>(b + carry));
        b = 0xFF;
      } while (--cache_size_ != 0);
      cache_ = static_cast<uint8_t>(low_ >> 24);
    }
    ++cache_size_;
    low_ = static_cast<uint32_t>(low_) << 8;
  }

  uint8_t* out_;
  int64_t cap_;
  int64_t pos_ = 0;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;
  bool ok_ = true;
};

class Decoder {
 public:
  Decoder(const uint8_t* in, int64_t len) : in_(in), len_(len) {
    for (int i = 0; i < 5; ++i) code_ = (code_ << 8) | get();
  }

  uint32_t decode_target(uint32_t total) {
    range_ /= total;
    uint32_t t = code_ / range_;
    return t < total ? t : total - 1;
  }

  void consume(uint32_t start, uint32_t size) {
    code_ -= start * range_;  // uint32 wraparound by design
    range_ *= size;
    while (range_ < kTop) {
      code_ = (code_ << 8) | get();
      range_ <<= 8;
    }
  }

 private:
  uint8_t get() { return pos_ < len_ ? in_[pos_++] : 0; }

  const uint8_t* in_;
  int64_t len_;
  int64_t pos_ = 0;
  uint32_t code_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
};

}  // namespace

extern "C" {

// cdf: [n, Lp] int32, per-row strictly increasing with cdf[i][0] == 0 and
//      cdf[i][Lp-1] == row total.
// syms: [n] int16 in [0, Lp-2].
// Returns bytes written, or -1 on buffer overflow / bad symbol.
int64_t rc_encode(const int32_t* cdf, int64_t n, int32_t Lp,
                  const int16_t* syms, uint8_t* out, int64_t cap) {
  Encoder enc(out, cap);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = cdf + i * Lp;
    int s = syms[i];
    if (s < 0 || s >= Lp - 1) return -1;
    uint32_t start = static_cast<uint32_t>(row[s]);
    uint32_t size = static_cast<uint32_t>(row[s + 1] - row[s]);
    uint32_t total = static_cast<uint32_t>(row[Lp - 1]);
    if (size == 0 || total == 0) return -1;
    enc.encode(start, size, total);
    if (!enc.ok()) return -1;
  }
  enc.flush();
  if (!enc.ok()) return -1;
  return enc.size();
}

// Inverse of rc_encode given the identical cdf. Returns 0, or -1 on error.
int64_t rc_decode(const int32_t* cdf, int64_t n, int32_t Lp,
                  const uint8_t* in, int64_t in_len, int16_t* syms_out) {
  Decoder dec(in, in_len);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = cdf + i * Lp;
    uint32_t total = static_cast<uint32_t>(row[Lp - 1]);
    if (total == 0) return -1;
    uint32_t target = dec.decode_target(total);
    // largest s with row[s] <= target (rows are short: linear scan)
    int s = 0;
    while (s + 1 < Lp - 1 && static_cast<uint32_t>(row[s + 1]) <= target) ++s;
    uint32_t start = static_cast<uint32_t>(row[s]);
    uint32_t size = static_cast<uint32_t>(row[s + 1] - row[s]);
    if (size == 0) return -1;
    dec.consume(start, size);
    syms_out[i] = static_cast<int16_t>(s);
  }
  return 0;
}

}  // extern "C"
