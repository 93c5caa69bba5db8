// deepcv_rc — native range coder of the learned lossless codec.
//
// The probability model of the codec (deepcv_tpu_torch/codec.py) runs on the
// card; what is irreducibly SEQUENTIAL — the entropy coder consuming one
// symbol's interval at a time — runs natively on the host. This is the
// classic carry-less 32-bit range coder (Subbotin's scheme, public domain),
// driven by per-symbol cumulative-frequency rows the model produces.
//
//   * deepcv_rc_encode — symbols[n] + cdf rows (n x (K+1), total 1<<16)
//                        -> byte stream; returns length or -1 on overflow
//   * deepcv_rc_decode — byte stream + the SAME cdf rows -> symbols
//
// The Python fallback (runtime/range_coder.py) implements the identical
// arithmetic bit for bit; streams are interchangeable, and equal to the JAX
// package's.
//
// Built at first use by deepcv_tpu_torch/ops/kernels/_build.py (build_host).

#include <cstdint>

namespace {

constexpr uint32_t kTop = 1u << 24;
constexpr uint32_t kBot = 1u << 16;  // == total frequency

struct Encoder {
    uint8_t* out;
    int64_t cap, len = 0;
    uint32_t low = 0, range = 0xFFFFFFFFu;
    bool overflow = false;

    void put(uint8_t b) {
        if (len >= cap) { overflow = true; return; }
        out[len++] = b;
    }
    void encode(uint32_t cum, uint32_t freq) {
        range >>= 16;                    // /= total (1<<16)
        low += cum * range;
        range *= freq;
        while ((low ^ (low + range)) < kTop ||
               (range < kBot && ((range = (0u - low) & (kBot - 1)), true))) {
            put(static_cast<uint8_t>(low >> 24));
            low <<= 8;
            range <<= 8;
        }
    }
    void flush() {
        for (int i = 0; i < 4; ++i) { put(static_cast<uint8_t>(low >> 24)); low <<= 8; }
    }
};

struct Decoder {
    const uint8_t* in;
    int64_t len, pos = 0;
    uint32_t low = 0, range = 0xFFFFFFFFu, code = 0;

    uint8_t get() { return pos < len ? in[pos++] : 0; }
    void init() { for (int i = 0; i < 4; ++i) code = (code << 8) | get(); }
    uint32_t freq_value() {
        range >>= 16;
        uint32_t v = (code - low) / range;
        return v > kBot - 1 ? kBot - 1 : v;
    }
    void update(uint32_t cum, uint32_t freq) {
        low += cum * range;              // range already /= total
        range *= freq;
        while ((low ^ (low + range)) < kTop ||
               (range < kBot && ((range = (0u - low) & (kBot - 1)), true))) {
            code = (code << 8) | get();
            low <<= 8;
            range <<= 8;
        }
    }
};

}  // namespace

extern "C" {

// cdf: n rows of (k + 1) uint32, row[0] == 0, row[k] == 65536, nondecreasing.
int64_t deepcv_rc_encode(const uint16_t* syms, int64_t n,
                         const uint32_t* cdf, int64_t k1,
                         uint8_t* out, int64_t cap) {
    Encoder e{out, cap};
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* row = cdf + i * k1;
        uint32_t s = syms[i];
        e.encode(row[s], row[s + 1] - row[s]);
        if (e.overflow) return -1;
    }
    e.flush();
    return e.overflow ? -1 : e.len;
}

int64_t deepcv_rc_decode(const uint8_t* in, int64_t in_len, int64_t n,
                         const uint32_t* cdf, int64_t k1, uint16_t* out_syms) {
    Decoder d{in, in_len};
    d.init();
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* row = cdf + i * k1;
        uint32_t v = d.freq_value();
        // binary search: largest s with row[s] <= v
        int64_t lo = 0, hi = k1 - 1;   // invariant: row[lo] <= v < row[hi]
        while (hi - lo > 1) {
            int64_t mid = (lo + hi) >> 1;
            if (row[mid] <= v) lo = mid; else hi = mid;
        }
        out_syms[i] = static_cast<uint16_t>(lo);
        d.update(row[lo], row[lo + 1] - row[lo]);
    }
    return n;
}

int32_t deepcv_rc_version() { return 1; }

}  // extern "C"
