// Host augmentation kernels of the training pipeline: the affine warp and
// the HSV colour jitter of one record, in C++ on the CPU.
//
// The port's own copy of ydl_affine_warp and ydl_color_jitter in the JAX
// package's native/loader.cpp (:270-304 and :308-354), statement for
// statement: the same association and the same float/double types.  Built
// with the same flags (g++ -O3 -march=native, yolodl_torch/kernels/_build.py),
// so its output equals the reference's bit for bit.  The numpy/scipy plain
// versions are yolodl_torch/data/affine.py warp_image and
// yolodl_torch/data/color.py ColorJitter.apply.
//
// Neither libjpeg nor libpng is needed, so this builds wherever g++ runs.
// Python calls it through ctypes from the pipeline's worker threads; the
// call releases the GIL and touches no shared state.
//
// C ABI:
//   ydl_affine_warp(src[c*h*w], c, h, w, m[4], off[2], dst[c*h*w])
//   ydl_color_jitter(img[3*h*w], h, w, hue_shift, sat_shift, val_shift)

#include <cmath>
#include <cstddef>

extern "C" {

// Affine warp with scipy.ndimage.affine_transform(order=1, mode="constant",
// cval=0) semantics: output pixel (row, col) samples the input at
// in = m @ (row, col) + off, bilinear, out-of-range taps contribute 0.
// m is row-major 2x2 [m_rr, m_rc, m_cr, m_cc]; src/dst are CHW float32.
//
// The column coordinate is m[2]*r + off[1] + m[3]*col, summed in that order
// and possibly contracted into an FMA by -march=native.  Where it falls
// within rounding of 0 (or of size-1), scipy's own sum can land on the
// other side of the edge: such a border tie gives cval here and the edge
// pixel there, or the reverse.
void ydl_affine_warp(const float* src, int c, int h, int w,
                     const double* m, const double* off, float* dst) {
    for (int ch = 0; ch < c; ++ch) {
        const float* s = src + (size_t)ch * h * w;
        float* d = dst + (size_t)ch * h * w;
        for (int r = 0; r < h; ++r) {
            double ir_base = m[0] * r + off[0];
            double ic_base = m[2] * r + off[1];
            float* drow = d + (size_t)r * w;
            for (int col = 0; col < w; ++col) {
                double ir = ir_base + m[1] * col;
                double ic = ic_base + m[3] * col;
                // scipy mode="constant": a coordinate outside [0, size-1]
                // yields cval outright (no blending with edge pixels)
                if (ir < 0.0 || ir > h - 1 || ic < 0.0 || ic > w - 1) {
                    drow[col] = 0.f;
                    continue;
                }
                int r0 = (int)ir;
                int c0 = (int)ic;
                int r1 = r0 + 1 < h ? r0 + 1 : h - 1;
                int c1 = c0 + 1 < w ? c0 + 1 : w - 1;
                float fr = (float)(ir - r0);
                float fc = (float)(ic - c0);
                const float* row0 = s + (size_t)r0 * w;
                const float* row1 = s + (size_t)r1 * w;
                float top = row0[c0] + fc * (row0[c1] - row0[c0]);
                float bot = row1[c0] + fc * (row1[c1] - row1[c0]);
                drow[col] = top + fr * (bot - top);
            }
        }
    }
}

// Fused RGB->HSV->(shift)->RGB jitter, in place on a CHW float32 [0,1] image.
// Matches yolodl_torch/data/color.py: hue wraps modulo 1, saturation/value
// clamp to [0,1]; ties in the channel max resolve r-then-g like the numpy
// np.where chain.
void ydl_color_jitter(float* img, int h, int w,
                      float hue_shift, float sat_shift, float val_shift) {
    size_t n = (size_t)h * w;
    float* R = img;
    float* G = img + n;
    float* B = img + 2 * n;
    for (size_t i = 0; i < n; ++i) {
        float r = R[i], g = G[i], b = B[i];
        float maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
        float minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
        float v = maxc;
        float delta = maxc - minc;
        float s = maxc > 0.f ? delta / maxc : 0.f;
        float hh = 0.f;
        if (delta > 0.f) {
            float rc = (maxc - r) / delta;
            float gc = (maxc - g) / delta;
            float bc = (maxc - b) / delta;
            if (maxc == r) hh = bc - gc;
            else if (maxc == g) hh = 2.f + rc - bc;
            else hh = 4.f + gc - rc;
            hh /= 6.f;
            hh -= std::floor(hh);  // % 1.0
        }
        hh += hue_shift + 1.f;
        hh -= std::floor(hh);
        s += sat_shift;
        s = s < 0.f ? 0.f : (s > 1.f ? 1.f : s);
        v += val_shift;
        v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);

        float h6 = hh * 6.f;
        int sector = ((int)std::floor(h6)) % 6;
        float f = h6 - std::floor(h6);
        float p = v * (1.f - s);
        float q = v * (1.f - s * f);
        float t = v * (1.f - s * (1.f - f));
        switch (sector) {
            case 0: R[i] = v; G[i] = t; B[i] = p; break;
            case 1: R[i] = q; G[i] = v; B[i] = p; break;
            case 2: R[i] = p; G[i] = v; B[i] = t; break;
            case 3: R[i] = p; G[i] = q; B[i] = v; break;
            case 4: R[i] = t; G[i] = p; B[i] = v; break;
            default: R[i] = v; G[i] = p; B[i] = q; break;
        }
    }
}

}  // extern "C"
