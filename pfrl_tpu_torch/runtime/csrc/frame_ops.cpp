// Native host-side frame preprocessing for the Atari pipeline.
//
// The reference's WarpFrame (pfrl/wrappers/atari_wrappers.py:159-183) calls
// cv2.cvtColor + cv2.resize(INTER_AREA) per frame per env: a host-CPU hot
// loop that must keep up with the device actor. This library fuses
// RGB->grayscale and fractional-box (area) resize into one pass over the
// input, batched over env lanes, with no OpenCV dependency. Exposed to
// Python via ctypes (pfrl_tpu_torch/runtime/__init__.py); a numpy
// implementation of the same semantics is the plain version and the test
// oracle. It is a copy of pfrl_tpu/runtime/csrc/frame_ops.cpp, whose code
// it keeps byte for byte below this comment.
//
// Semantics (the numpy version computes the same, in another order):
//   gray  = round(0.299 R + 0.587 G + 0.114 B)            (uint8, like cv2)
//   out   = round(area_average(gray))                     (uint8)
// where area_average uses fractional pixel-overlap weights, the same math
// as cv2 INTER_AREA for arbitrary scale factors. The float32 sums round
// in another order than numpy's, so an output may differ from the numpy
// version's by 1 where it lies at a .5 boundary (under 1% of pixels;
// tests/test_torch_frame_ops.py).
//
// Build: g++ -O3 -shared -fPIC (see pfrl_tpu_torch/runtime/__init__.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

inline uint8_t luma_u8(uint8_t r, uint8_t g, uint8_t b) {
    // cv2 RGB2GRAY coefficients, round-half-away like cv2's fixed point.
    const float y = 0.299f * r + 0.587f * g + 0.114f * b;
    return static_cast<uint8_t>(y + 0.5f);
}

// Padded fixed-tap axis map: every output uses exactly K taps (trailing
// zero weights), with start clamped so reads never leave [0, in_size).
// Fixed trip counts let the compiler unroll the tap loop and vectorize
// the output loop — the variable-count version ran ~10x slower.
struct PaddedMap {
    int K;
    std::vector<int32_t> start;  // [out]
    std::vector<float> w;        // [out * K]
};

PaddedMap build_padded_map(int in_size, int out_size) {
    PaddedMap m;
    const double scale = static_cast<double>(in_size) / out_size;
    const double inv_area = 1.0 / scale;
    int K = 0;
    for (int o = 0; o < out_size; ++o) {
        const double lo = o * scale;
        const double hi = (o + 1) * scale;
        int ilo = static_cast<int>(std::floor(lo));
        int ihi = static_cast<int>(std::ceil(hi));
        if (ihi > in_size) ihi = in_size;
        if (ihi - ilo > K) K = ihi - ilo;
    }
    m.K = K;
    m.start.resize(out_size);
    m.w.assign(static_cast<size_t>(out_size) * K, 0.0f);
    for (int o = 0; o < out_size; ++o) {
        const double lo = o * scale;
        const double hi = (o + 1) * scale;
        int s = static_cast<int>(std::floor(lo));
        if (s > in_size - K) s = in_size - K;
        if (s < 0) s = 0;
        m.start[o] = s;
        for (int k = 0; k < K; ++k) {
            const int i = s + k;
            const double cov_lo = (i < lo) ? lo : i;
            const double cov_hi = ((i + 1) > hi) ? hi : (i + 1);
            const double cov = cov_hi - cov_lo;
            m.w[static_cast<size_t>(o) * K + k] =
                cov > 0.0 ? static_cast<float>(cov * inv_area) : 0.0f;
        }
    }
    return m;
}

// Separable area resize of one gray frame: horizontal pass into a float
// [in_h, out_w] buffer (gathers, small), then a vertical pass whose inner
// loop runs contiguously over the output row (vectorizes cleanly).
void resize_gray(const uint8_t* gray, int in_h, int in_w, uint8_t* dst,
                 int out_h, int out_w, const PaddedMap& xm,
                 const PaddedMap& ym, float* hres, float* row_acc) {
    const int KX = xm.K;
    for (int y = 0; y < in_h; ++y) {
        const uint8_t* row = gray + static_cast<size_t>(y) * in_w;
        float* hr = hres + static_cast<size_t>(y) * out_w;
        for (int ox = 0; ox < out_w; ++ox) {
            const int s = xm.start[ox];
            const float* w = xm.w.data() + static_cast<size_t>(ox) * KX;
            float acc = 0.0f;
            for (int k = 0; k < KX; ++k) acc += w[k] * row[s + k];
            hr[ox] = acc;
        }
    }
    const int KY = ym.K;
    for (int oy = 0; oy < out_h; ++oy) {
        std::memset(row_acc, 0, static_cast<size_t>(out_w) * sizeof(float));
        const int s = ym.start[oy];
        const float* w = ym.w.data() + static_cast<size_t>(oy) * KY;
        for (int k = 0; k < KY; ++k) {
            const float wk = w[k];
            const float* hr = hres + static_cast<size_t>(s + k) * out_w;
            for (int ox = 0; ox < out_w; ++ox) row_acc[ox] += wk * hr[ox];
        }
        uint8_t* d = dst + static_cast<size_t>(oy) * out_w;
        for (int ox = 0; ox < out_w; ++ox) {
            float v = row_acc[ox] + 0.5f;
            if (v > 255.0f) v = 255.0f;
            d[ox] = static_cast<uint8_t>(v);
        }
    }
}

}  // namespace

extern "C" {

// Fused batched RGB->gray + area resize.
//   in:  [n, in_h, in_w, 3] uint8 (C-contiguous)
//   out: [n, out_h, out_w]  uint8
void warp_frames_rgb(const uint8_t* in, int n, int in_h, int in_w,
                     uint8_t* out, int out_h, int out_w) {
    const PaddedMap ym = build_padded_map(in_h, out_h);
    const PaddedMap xm = build_padded_map(in_w, out_w);
    std::vector<uint8_t> gray(static_cast<size_t>(in_h) * in_w);
    std::vector<float> hres(static_cast<size_t>(in_h) * out_w);
    std::vector<float> row_acc(static_cast<size_t>(out_w));

    for (int f = 0; f < n; ++f) {
        const uint8_t* src = in + static_cast<size_t>(f) * in_h * in_w * 3;
        for (size_t p = 0, q = 0; p < static_cast<size_t>(in_h) * in_w;
             ++p, q += 3) {
            gray[p] = luma_u8(src[q], src[q + 1], src[q + 2]);
        }
        resize_gray(gray.data(), in_h, in_w,
                    out + static_cast<size_t>(f) * out_h * out_w,
                    out_h, out_w, xm, ym, hres.data(), row_acc.data());
    }
}

// Same fused warp for frames that are already single-channel.
//   in:  [n, in_h, in_w] uint8; out: [n, out_h, out_w] uint8
void warp_frames_gray(const uint8_t* in, int n, int in_h, int in_w,
                      uint8_t* out, int out_h, int out_w) {
    const PaddedMap ym = build_padded_map(in_h, out_h);
    const PaddedMap xm = build_padded_map(in_w, out_w);
    std::vector<float> hres(static_cast<size_t>(in_h) * out_w);
    std::vector<float> row_acc(static_cast<size_t>(out_w));
    for (int f = 0; f < n; ++f) {
        resize_gray(in + static_cast<size_t>(f) * in_h * in_w, in_h, in_w,
                    out + static_cast<size_t>(f) * out_h * out_w,
                    out_h, out_w, xm, ym, hres.data(), row_acc.data());
    }
}

// Elementwise max of two uint8 buffers (MaxAndSkip's two-frame max,
// atari_wrappers.py:124-139).
void frame_max_u8(const uint8_t* a, const uint8_t* b, uint8_t* out,
                  int64_t count) {
    for (int64_t i = 0; i < count; ++i) {
        out[i] = a[i] > b[i] ? a[i] : b[i];
    }
}

}  // extern "C"
