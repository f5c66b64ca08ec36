// Native data-loader kernels for the video/image preprocessing hot path.
//
// The reference does this work in Python/numpy per frame
// (animatediff/video_dataset.py:78-132: BGR->RGB, resize, normalize to
// [-1,1]); at 16+ frames of 1024^2 the per-step host cost matters, and
// these loops vectorize well. Exposed via ctypes (no pybind11 in the
// image); OpenMP threads across rows/frames when available.
//
// Build: video_style_transfer_tpu_torch/data/native.py compiles it with g++
// into the package's _build/ at first use (a copy of native/preprocess.cpp).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// uint8 HWC frames -> float32 in [-1, 1].  n = total elements.
void u8_to_unit_range(const uint8_t* src, float* dst, int64_t n) {
    constexpr float kScale = 1.0f / 127.5f;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) * kScale - 1.0f;
    }
}

// uint8 HWC frames -> float32 in [0, 1].
void u8_to_unit_interval(const uint8_t* src, float* dst, int64_t n) {
    constexpr float kScale = 1.0f / 255.0f;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) * kScale;
    }
}

// BGR -> RGB channel swap in place for (n_pixels, 3) uint8 data.
void bgr_to_rgb_inplace(uint8_t* data, int64_t n_pixels) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n_pixels; ++i) {
        std::swap(data[i * 3], data[i * 3 + 2]);
    }
}

// Bilinear resize of a single HWC uint8 image (c channels).
// Half-pixel-center convention (matches cv2.INTER_LINEAR).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int c,
                        uint8_t* dst, int dh, int dw) {
    const float scale_y = static_cast<float>(sh) / dh;
    const float scale_x = static_cast<float>(sw) / dw;
#pragma omp parallel for schedule(static)
    for (int y = 0; y < dh; ++y) {
        float fy = (y + 0.5f) * scale_y - 0.5f;
        int y0 = static_cast<int>(std::floor(fy));
        float wy = fy - y0;
        int y0c = std::clamp(y0, 0, sh - 1);
        int y1c = std::clamp(y0 + 1, 0, sh - 1);
        for (int x = 0; x < dw; ++x) {
            float fx = (x + 0.5f) * scale_x - 0.5f;
            int x0 = static_cast<int>(std::floor(fx));
            float wx = fx - x0;
            int x0c = std::clamp(x0, 0, sw - 1);
            int x1c = std::clamp(x0 + 1, 0, sw - 1);
            const uint8_t* p00 = src + (static_cast<int64_t>(y0c) * sw + x0c) * c;
            const uint8_t* p01 = src + (static_cast<int64_t>(y0c) * sw + x1c) * c;
            const uint8_t* p10 = src + (static_cast<int64_t>(y1c) * sw + x0c) * c;
            const uint8_t* p11 = src + (static_cast<int64_t>(y1c) * sw + x1c) * c;
            uint8_t* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
            for (int ch = 0; ch < c; ++ch) {
                float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                          wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
                out[ch] = static_cast<uint8_t>(std::lround(
                    std::clamp(v, 0.0f, 255.0f)));
            }
        }
    }
}

// Fused pipeline for a batch of frames:
// (f, sh, sw, 3) uint8 BGR -> resize -> RGB -> float32 [-1,1] (f, dh, dw, 3)
void preprocess_frames_bgr(const uint8_t* src, int f, int sh, int sw,
                           uint8_t* scratch /* f*dh*dw*3 */,
                           float* dst, int dh, int dw) {
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < f; ++i) {
        const uint8_t* s = src + static_cast<int64_t>(i) * sh * sw * 3;
        uint8_t* tmp = scratch + static_cast<int64_t>(i) * dh * dw * 3;
        resize_bilinear_u8(s, sh, sw, 3, tmp, dh, dw);
        float* out = dst + static_cast<int64_t>(i) * dh * dw * 3;
        constexpr float kScale = 1.0f / 127.5f;
        for (int64_t px = 0; px < static_cast<int64_t>(dh) * dw; ++px) {
            // BGR -> RGB swap fused with normalize
            out[px * 3 + 0] = tmp[px * 3 + 2] * kScale - 1.0f;
            out[px * 3 + 1] = tmp[px * 3 + 1] * kScale - 1.0f;
            out[px * 3 + 2] = tmp[px * 3 + 0] * kScale - 1.0f;
        }
    }
}

}  // extern "C"
