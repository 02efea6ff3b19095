// Native image codec: uint8 sRGB <-> float linear, premultiplied alpha (the
// same source and C ABI as the JAX package's tha4_tpu/native/codec.cpp).
//
// The pipeline edges (PNG bytes -> model units and back) run per frame in the
// puppeteer and per sample-grid during training.  The Python/numpy path costs
// several array passes (u8->f32, /255, piecewise pow, premultiply, *2-1);
// this does it in one cache-friendly pass with a 256-entry LUT for the exact
// piecewise sRGB EOTF (reference formula: src/tha4/shion/base/image_util.py
// numpy_srgb_to_linear / numpy_linear_to_srgb).
//
// Exposed as a plain C ABI consumed via ctypes, built by
// tha4_tpu_torch/native/loader.py.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct SrgbLut {
    float to_linear[256];
    SrgbLut() {
        for (int i = 0; i < 256; ++i) {
            const float x = static_cast<float>(i) / 255.0f;
            to_linear[i] =
                x <= 0.04045f ? x / 12.92f : std::pow((x + 0.055f) / 1.055f, 2.4f);
        }
    }
};
const SrgbLut kLut;

inline float linear_to_srgb1(float x) {
    x = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    return x <= 0.003130804953560372f ? x * 12.92f
                                      : 1.055f * std::pow(x, 1.0f / 2.4f) - 0.055f;
}

}  // namespace

extern "C" {

// RGBA u8 (H*W pixels) -> float32 model units: linear light, premultiplied
// alpha, scaled to [offset, offset+scale].
void tha4_decode_rgba(const uint8_t* src, float* dst, int64_t num_pixels,
                      float scale, float offset, int premultiply) {
    for (int64_t p = 0; p < num_pixels; ++p) {
        const uint8_t* s = src + p * 4;
        float* d = dst + p * 4;
        const float a = static_cast<float>(s[3]) / 255.0f;
        float r = kLut.to_linear[s[0]];
        float g = kLut.to_linear[s[1]];
        float b = kLut.to_linear[s[2]];
        if (premultiply) {
            r *= a;
            g *= a;
            b *= a;
        }
        d[0] = r * scale + offset;
        d[1] = g * scale + offset;
        d[2] = b * scale + offset;
        d[3] = a * scale + offset;
    }
}

// float32 model units -> RGBA u8 (straight alpha, sRGB), the save path
// (reference convert_zero_to_one_numpy_image_to_PIL_image semantics).
void tha4_encode_rgba(const float* src, uint8_t* dst, int64_t num_pixels,
                      float scale, float offset, int unpremultiply,
                      float epsilon) {
    for (int64_t p = 0; p < num_pixels; ++p) {
        const float* s = src + p * 4;
        uint8_t* d = dst + p * 4;
        float a = (s[3] - offset) / scale;
        a = a < 0.0f ? 0.0f : (a > 1.0f ? 1.0f : a);
        float rgb[3];
        for (int c = 0; c < 3; ++c) {
            float v = (s[c] - offset) / scale;
            if (unpremultiply) {
                v = std::fabs(a) < epsilon ? 0.0f : v / a;
            }
            rgb[c] = linear_to_srgb1(v);
        }
        for (int c = 0; c < 3; ++c) {
            d[c] = static_cast<uint8_t>(std::lround(rgb[c] * 255.0f));
        }
        d[3] = static_cast<uint8_t>(std::lround(a * 255.0f));
    }
}

}  // extern "C"
