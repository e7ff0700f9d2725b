// Native host-side image ops for the input pipeline.
//
// The reference's data path runs through torch's C-backed DataLoader
// workers (reference: lib/utils/data/dataloader.py); this library is the
// equivalent native layer for our host pipeline: fused uint8→normalized
// float conversion and mask remapping in single passes over the buffers
// (the numpy path makes 3-4 temporaries per frame).  Loaded via ctypes —
// no pybind11 dependency (see native/__init__.py beside this file, which
// builds it under build/native/ at the repository root).
//
// Build: g++ -O3 -shared -fPIC hostops.cpp -o libhostops.so

#include <cstdint>
#include <cstddef>

extern "C" {

// img_u8: [n, 3] interleaved RGB; out: [n, 3] float32 = (v/255 - mean)/std.
void normalize_u8(const uint8_t* img, float* out, size_t n_pixels,
                  const float* mean, const float* std_) {
    const float inv255 = 1.0f / 255.0f;
    float scale[3], shift[3];
    for (int c = 0; c < 3; ++c) {
        scale[c] = inv255 / std_[c];
        shift[c] = -mean[c] / std_[c];
    }
    for (size_t i = 0; i < n_pixels; ++i) {
        const uint8_t* p = img + 3 * i;
        float* q = out + 3 * i;
        q[0] = p[0] * scale[0] + shift[0];
        q[1] = p[1] * scale[1] + shift[1];
        q[2] = p[2] * scale[2] + shift[2];
    }
}

// VSPW mask remap (reference: dataset2.py:602-609): 0→255, v→v-1, 254→255.
void remap_label_u8(const uint8_t* mask, int32_t* out, size_t n) {
    static int32_t lut[256];
    static bool init = false;
    if (!init) {
        for (int v = 0; v < 256; ++v) {
            int32_t r = v - 1;
            if (v == 0) r = 255;
            if (r == 254) r = 255;
            lut[v] = r;
        }
        init = true;
    }
    for (size_t i = 0; i < n; ++i) out[i] = lut[mask[i]];
}

// fused crop + normalize: src uint8 [H, W, 3] row-major, crop at (y, x) of
// size (ch, cw) into out float32 [ch, cw, 3].
void crop_normalize_u8(const uint8_t* img, size_t width, float* out,
                       size_t y, size_t x, size_t ch, size_t cw,
                       const float* mean, const float* std_) {
    for (size_t r = 0; r < ch; ++r) {
        const uint8_t* row = img + ((y + r) * width + x) * 3;
        normalize_u8(row, out + r * cw * 3, cw, mean, std_);
    }
}

}  // extern "C"
