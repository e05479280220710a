// Host decode of the training and inference pipelines: JPEG/PNG decode
// (libjpeg/libpng) and the letterbox resize, writing float32 CHW in [0,1]
// into a caller-owned buffer.
//
// The port's own copy of the decode half of the JAX package's
// native/loader.cpp (:19-262: content_dims, the setjmp error manager,
// decode_jpeg with DCT-scaled decode, decode_png, decode_file,
// letterbox_into, Loader and ldr_*), as it is.  Built with the same flags
// (g++ -O3 -march=native ... -ljpeg -lpng -lpthread,
// yolodl_torch/kernels/_build.py), so its output equals the reference's bit
// for bit.  The plain version is yolodl_torch/data/cache.py OnDemandLoader
// (PIL); the two differ by resampling, not by geometry.
//
// yolodl_torch/data/native_loader.py NativeLoader calls ldr_load through
// ctypes from the pipeline's worker threads: the call is synchronous,
// releases the GIL and is thread-safe (the Loader is stateless after
// construction).  It builds only where the compiler finds jpeglib.h and
// png.h; elsewhere yolodl_torch/data/cache.py make_decode_loader takes PIL.
//
// C ABI:
//   ldr_create(threads, out_h, out_w) -> handle   (threads is ignored)
//   ldr_create2(threads, out_h, out_w, flags)      flags bit 0: scaled decode
//   ldr_load(handle, path, out[3*out_h*out_w])    0 on success
//   ldr_destroy(handle)

#include <cmath>
#include <csetjmp>
#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Image {
    int h = 0, w = 0, c = 0;
    // pre-scaling dims: letterbox GEOMETRY must come from the original
    // image so box transforms stay bit-identical whether or not the JPEG
    // was DCT-scale-decoded (0 = not scaled, use h/w)
    int orig_h = 0, orig_w = 0;
    std::vector<uint8_t> data;  // HWC, 8-bit
};

// letterbox content dims for an (h, w) image into an (out_h, out_w) frame;
// lrint = round-half-even, matching letterbox_geometry (see letterbox_into)
void content_dims(int h, int w, int out_h, int out_w, int* new_h, int* new_w) {
    if ((int64_t)out_h * w <= (int64_t)out_w * h) {
        *new_h = out_h;
        *new_w = (int)lrint((int64_t)w * out_h / (double)h);
        if (*new_w < 1) *new_w = 1;
    } else {
        *new_h = (int)lrint((int64_t)h * out_w / (double)w);
        if (*new_h < 1) *new_h = 1;
        *new_w = out_w;
    }
}

struct JpegErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf jump;
};

void jpeg_error_exit_longjmp(j_common_ptr cinfo) {
    // libjpeg's default error_exit calls exit(); a corrupt JPEG must fail
    // the one decode (rc!=0 → Python PIL fallback), not kill training
    longjmp(reinterpret_cast<JpegErrorMgr*>(cinfo->err)->jump, 1);
}

// target_h/target_w > 0 enables DCT-domain scaled decode: pick the smallest
// libjpeg scale M/8 whose output still covers the letterbox content size, so
// a 4000px photograph headed for a 608px frame decodes ~4-8x less IDCT +
// color-convert work.  Geometry parity is preserved by recording the
// original dims (letterbox_into computes placement from them).
bool decode_jpeg(FILE* f, Image* out, int target_h, int target_w) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit_longjmp;
    if (setjmp(jerr.jump)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    cinfo.out_color_space = JCS_RGB;
    out->orig_h = (int)cinfo.image_height;
    out->orig_w = (int)cinfo.image_width;
    if (target_h > 0 && target_w > 0) {
        int need_h, need_w;
        content_dims(out->orig_h, out->orig_w, target_h, target_w,
                     &need_h, &need_w);
        // power-of-two scales only (like PIL's draft): fractional M/8
        // scales buy little and visibly soften noisy content; if even 1/2
        // doesn't cover the content, decode at full resolution
        for (int num : {1, 2, 4}) {
            cinfo.scale_num = (unsigned)num;
            cinfo.scale_denom = 8;
            jpeg_calc_output_dimensions(&cinfo);  // honors what the lib supports
            if ((int)cinfo.output_width >= need_w &&
                (int)cinfo.output_height >= need_h)
                break;
            cinfo.scale_num = cinfo.scale_denom = 8;  // reset to full res
        }
        jpeg_calc_output_dimensions(&cinfo);
    }
    jpeg_start_decompress(&cinfo);
    out->w = cinfo.output_width;
    out->h = cinfo.output_height;
    out->c = 3;
    out->data.resize((size_t)out->h * out->w * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out->data.data() + (size_t)cinfo.output_scanline * out->w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

bool decode_png(FILE* f, Image* out) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info) {
        png_destroy_read_struct(&png, nullptr, nullptr);
        return false;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);

    png_set_strip_16(png);
    png_set_palette_to_rgb(png);
    png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    png_set_strip_alpha(png);
    png_set_gray_to_rgb(png);
    png_read_update_info(png, info);

    out->w = png_get_image_width(png, info);
    out->h = png_get_image_height(png, info);
    out->c = 3;
    out->data.resize((size_t)out->h * out->w * 3);
    std::vector<png_bytep> rows(out->h);
    for (int y = 0; y < out->h; ++y)
        rows[y] = out->data.data() + (size_t)y * out->w * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

// target dims enable JPEG scaled decode (0 = always full-resolution)
bool decode_file(const char* path, Image* out, int target_h = 0,
                 int target_w = 0) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    uint8_t magic[8] = {0};
    size_t got = fread(magic, 1, 8, f);
    rewind(f);
    bool ok = false;
    if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
        ok = decode_jpeg(f, out, target_h, target_w);
    } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
        ok = decode_png(f, out);  // PNG has no scaled-decode fast path
    }
    fclose(f);
    return ok;
}

// letterbox into a float32 CHW buffer: integer-rounded geometry, matching
// yolodl_torch.data.letterbox.letterbox_geometry (parity with the Python path)
void letterbox_into(const Image& img, int out_h, int out_w, float pad, float* out) {
    int new_h, new_w;
    // lrint = round-half-even under the default FP environment, matching
    // Python's round() in letterbox_geometry — half-up here would misplace
    // the content (and thus the box transforms) by 1px on exact halves.
    // Geometry comes from the ORIGINAL dims (scaled JPEG decode changes the
    // sampling source, never the placement), keeping box transforms exact.
    int gh = img.orig_h > 0 ? img.orig_h : img.h;
    int gw = img.orig_w > 0 ? img.orig_w : img.w;
    content_dims(gh, gw, out_h, out_w, &new_h, &new_w);
    int off_y = (out_h - new_h) / 2;
    int off_x = (out_w - new_w) / 2;

    const size_t plane = (size_t)out_h * out_w;
    for (size_t i = 0; i < plane * 3; ++i) out[i] = pad;

    // bilinear resample (align-corners=false, PIL-like box centers)
    const float sy = (float)img.h / new_h;
    const float sx = (float)img.w / new_w;
    for (int y = 0; y < new_h; ++y) {
        float fy = (y + 0.5f) * sy - 0.5f;
        int y0 = (int)fy;
        if (fy < 0) { fy = 0; y0 = 0; }
        int y1 = y0 + 1 < img.h ? y0 + 1 : img.h - 1;
        float wy = fy - y0;
        for (int x = 0; x < new_w; ++x) {
            float fx = (x + 0.5f) * sx - 0.5f;
            int x0 = (int)fx;
            if (fx < 0) { fx = 0; x0 = 0; }
            int x1 = x0 + 1 < img.w ? x0 + 1 : img.w - 1;
            float wx = fx - x0;
            const uint8_t* p00 = &img.data[((size_t)y0 * img.w + x0) * 3];
            const uint8_t* p01 = &img.data[((size_t)y0 * img.w + x1) * 3];
            const uint8_t* p10 = &img.data[((size_t)y1 * img.w + x0) * 3];
            const uint8_t* p11 = &img.data[((size_t)y1 * img.w + x1) * 3];
            const size_t dst = (size_t)(off_y + y) * out_w + (off_x + x);
            for (int ch = 0; ch < 3; ++ch) {
                float v = (1 - wy) * ((1 - wx) * p00[ch] + wx * p01[ch]) +
                          wy * ((1 - wx) * p10[ch] + wx * p11[ch]);
                out[ch * plane + dst] = v / 255.0f;
            }
        }
    }
}

struct Loader {
    int out_h, out_w;
    bool scaled_decode;

    Loader(int h, int w, bool scaled)
        : out_h(h), out_w(w), scaled_decode(scaled) {}
};

}  // namespace

extern "C" {

void* ldr_create(int threads, int out_h, int out_w) {
    (void)threads;  // kept for ABI compatibility; ldr_load is synchronous
    return new Loader(out_h, out_w, /*scaled=*/false);
}

// flags bit 0: JPEG DCT-scaled decode (decode big photos at the smallest
// M/8 scale that still covers the letterbox content — same geometry,
// resampling source is the scaled image)
void* ldr_create2(int threads, int out_h, int out_w, int flags) {
    (void)threads;  // kept for ABI compatibility; ldr_load is synchronous
    return new Loader(out_h, out_w, (flags & 1) != 0);
}

void ldr_destroy(void* handle) { delete static_cast<Loader*>(handle); }

// synchronous decode+letterbox; returns 0 on success
int ldr_load(void* handle, const char* path, float* out) {
    Loader* l = static_cast<Loader*>(handle);
    Image img;
    if (!decode_file(path, &img, l->scaled_decode ? l->out_h : 0,
                     l->scaled_decode ? l->out_w : 0)) return -1;
    letterbox_into(img, l->out_h, l->out_w, 0.5f, out);
    return 0;
}

}  // extern "C"
