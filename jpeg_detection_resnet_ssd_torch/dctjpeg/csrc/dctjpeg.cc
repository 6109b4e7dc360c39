// Native JPEG -> block-DCT coefficient decoder (host code, g++ and libjpeg).
//
// The PyTorch package's own copy of the JAX package's
// `dctjpeg/csrc/dctjpeg.cc`, line for line below this comment, so that both
// packages give identical coefficients on one libjpeg.  It replaces the
// reference's two C++ submodules: uber-research/jpeg2dct (Huffman-decode +
// dequantize, no IDCT) and D3lt4lph4/jpeg_decoder (partial-decode levels).
// One decode core serves both output contracts:
//   * per-component block tensors (h_blocks, w_blocks, 64), coefficients in
//     natural (row-major) frequency order, dequantized to true DCT values —
//     the jpeg2dct `load/loads` contract;
//   * the spatial "DCT image" layout (jpegdecoder level 2) is a pure reshape
//     of the same data, done on the Python side.
//
// Implementation: libjpeg's jpeg_read_coefficients() performs the entropy
// decode; we dequantize with the component quant tables and emit int32.
// Coefficient blocks and quant tables are both stored in natural order in
// libjpeg's in-memory representation, so dequantization is elementwise.
//
// Thread-safe: no globals; one jpeg_decompress_struct per call, so a host
// thread pool can decode many images in parallel behind the input pipeline.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  char message[JMSG_LENGTH_MAX];
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  (*cinfo->err->format_message)(cinfo, err->message);
  longjmp(err->setjmp_buffer, 1);
}

void silent_emit(j_common_ptr, int) {}

}  // namespace

extern "C" {

typedef struct {
  int n_components;
  int img_height;
  int img_width;
  int h_samp[4];     // per-component sampling factors
  int v_samp[4];
  int h_blocks[4];   // ceil(downsampled_height / 8)
  int w_blocks[4];
  int32_t* coeffs[4];  // h_blocks * w_blocks * 64 int32 each (malloc'd)
  char error[JMSG_LENGTH_MAX];
} DctDecoded;

// Decode a JPEG byte buffer to per-component DCT coefficient tensors.
// dequantize != 0 multiplies each coefficient by its quantizer step
// (the jpeg2dct behaviour). Returns 0 on success, nonzero on error with
// out->error filled. Caller must call dctjpeg_release().
int dctjpeg_decode(const uint8_t* data, size_t size, int dequantize,
                   DctDecoded* out) {
  memset(out, 0, sizeof(*out));

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silent_emit;
  jerr.message[0] = '\0';

  if (setjmp(jerr.setjmp_buffer)) {
    snprintf(out->error, sizeof(out->error), "%s", jerr.message);
    jpeg_destroy_decompress(&cinfo);
    for (int c = 0; c < 4; ++c) {
      free(out->coeffs[c]);
      out->coeffs[c] = nullptr;
    }
    return 1;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);

  jvirt_barray_ptr* coef_arrays = jpeg_read_coefficients(&cinfo);
  if (coef_arrays == nullptr) {
    snprintf(out->error, sizeof(out->error), "jpeg_read_coefficients failed");
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }

  out->n_components = cinfo.num_components;
  out->img_height = static_cast<int>(cinfo.image_height);
  out->img_width = static_cast<int>(cinfo.image_width);
  if (out->n_components > 4) out->n_components = 4;

  int max_h = cinfo.max_h_samp_factor;
  int max_v = cinfo.max_v_samp_factor;

  for (int ci = 0; ci < out->n_components; ++ci) {
    jpeg_component_info* comp = &cinfo.comp_info[ci];
    out->h_samp[ci] = comp->h_samp_factor;
    out->v_samp[ci] = comp->v_samp_factor;
    // Downsampled component size from the image dims (independent of MCU
    // padding), matching the jpeg2dct "normalized" shape: e.g. 224x224 4:2:0
    // -> Y 28x28, Cb/Cr 14x14 blocks.
    long ds_h = (static_cast<long>(cinfo.image_height) * comp->v_samp_factor +
                 max_v - 1) / max_v;
    long ds_w = (static_cast<long>(cinfo.image_width) * comp->h_samp_factor +
                 max_h - 1) / max_h;
    int hb = static_cast<int>((ds_h + 7) / 8);
    int wb = static_cast<int>((ds_w + 7) / 8);
    out->h_blocks[ci] = hb;
    out->w_blocks[ci] = wb;

    int32_t* dst = static_cast<int32_t*>(
        malloc(static_cast<size_t>(hb) * wb * DCTSIZE2 * sizeof(int32_t)));
    if (dst == nullptr) {
      snprintf(out->error, sizeof(out->error), "out of memory");
      jpeg_destroy_decompress(&cinfo);
      return 1;
    }
    out->coeffs[ci] = dst;

    JQUANT_TBL* qtbl = comp->quant_table;
    for (int by = 0; by < hb; ++by) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), coef_arrays[ci],
          static_cast<JDIMENSION>(by), 1, FALSE);
      JBLOCKROW row = rows[0];
      for (int bx = 0; bx < wb; ++bx) {
        JCOEFPTR block = row[bx];
        int32_t* o = dst + (static_cast<size_t>(by) * wb + bx) * DCTSIZE2;
        if (dequantize && qtbl != nullptr) {
          for (int k = 0; k < DCTSIZE2; ++k) {
            o[k] = static_cast<int32_t>(block[k]) *
                   static_cast<int32_t>(qtbl->quantval[k]);
          }
        } else {
          for (int k = 0; k < DCTSIZE2; ++k) {
            o[k] = static_cast<int32_t>(block[k]);
          }
        }
      }
    }
  }

  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

void dctjpeg_release(DctDecoded* out) {
  for (int c = 0; c < 4; ++c) {
    free(out->coeffs[c]);
    out->coeffs[c] = nullptr;
  }
}

// ---------------------------------------------------------------------------
// Native corpus packing: JPEG bytes -> decode -> bilinear resize ->
// re-encode (4:2:0) -> coefficient decode, entirely in C++.
//
// Role: the hot loop of building the decode-once packed corpus
// (data/packed.py) and, by extension, the reference's whole per-image
// Python/PIL decode->augment->re-encode loop (`generators.py:141-194`).
// ctypes releases the GIL for the call's duration, so a Python thread pool
// scales this across all cores.  Output layout matches
// `data.dct_convert.rgb_to_dct_tensors`: Y (out_h/8, out_w/8, 64) int16 and
// stacked CbCr (out_h/16, out_w/16, 128) int16, dequantized.
// ---------------------------------------------------------------------------

namespace {

// Full decode to interleaved RGB8.  Returns malloc'd buffer (h*w*3) or null.
uint8_t* decode_rgb(const uint8_t* data, size_t size, int* h, int* w,
                    char* err, size_t err_len) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silent_emit;
  jerr.message[0] = '\0';
  uint8_t* rgb = nullptr;

  if (setjmp(jerr.setjmp_buffer)) {
    snprintf(err, err_len, "%s", jerr.message);
    jpeg_destroy_decompress(&cinfo);
    free(rgb);
    return nullptr;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // libjpeg converts gray/YCbCr to RGB
  jpeg_start_decompress(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  rgb = static_cast<uint8_t*>(
      malloc(static_cast<size_t>(*h) * *w * 3));
  if (rgb == nullptr) {
    snprintf(err, err_len, "out of memory");
    jpeg_destroy_decompress(&cinfo);
    return nullptr;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = rgb + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return rgb;
}

// cv2.INTER_LINEAR replica for uint8, bit-exact (parity-tested from Python
// against cv2.resize across up/down-scales and degenerate shapes).  OpenCV's
// 8-bit path is FIXED-POINT (INTER_RESIZE_COEF_BITS=11, scale 2048):
//   * per-axis taps: f = (d+0.5)*src/dst - 0.5 (float), s = floor(f),
//     coefficients round-half-even((1-f)*2048) / (f*2048);
//   * horizontal pass accumulates exactly in int32 (no truncation), so
//     clamping out-of-range taps with a collapsed weight is equivalent;
//   * vertical pass truncates PER TAP — dst = (((b0*(r0>>4))>>16)
//     + ((b1*(r1>>4))>>16) + 2) >> 2 — so at the borders the SPLIT
//     coefficients must be kept and only the tap rows clipped (folding
//     b0+b1 into one tap changes the truncation and diverges by ±1).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const double sy_scale = static_cast<double>(sh) / dh;
  const double sx_scale = static_cast<double>(sw) / dw;

  int* x0s = static_cast<int*>(malloc(sizeof(int) * dw));
  int* x1s = static_cast<int*>(malloc(sizeof(int) * dw));
  int* xa0 = static_cast<int*>(malloc(sizeof(int) * dw));
  int* xa1 = static_cast<int*>(malloc(sizeof(int) * dw));
  int32_t* row0 = static_cast<int32_t*>(malloc(sizeof(int32_t) * dw * 3));
  int32_t* row1 = static_cast<int32_t*>(malloc(sizeof(int32_t) * dw * 3));
  for (int ox = 0; ox < dw; ++ox) {
    float fx = static_cast<float>((ox + 0.5) * sx_scale - 0.5);
    int sx = static_cast<int>(std::floor(fx));
    fx -= static_cast<float>(sx);
    if (sx < 0) { sx = 0; fx = 0.f; }
    if (sx >= sw - 1) { sx = sw - 1; fx = 0.f; }
    x0s[ox] = sx;
    x1s[ox] = sx + 1 < sw ? sx + 1 : sw - 1;
    xa0[ox] = static_cast<int>(lrintf((1.f - fx) * 2048.f));
    xa1[ox] = static_cast<int>(lrintf(fx * 2048.f));
  }

  int cached_y0 = -1, cached_y1 = -1;
  for (int oy = 0; oy < dh; ++oy) {
    float fy = static_cast<float>((oy + 0.5) * sy_scale - 0.5);
    int sy = static_cast<int>(std::floor(fy));
    fy -= static_cast<float>(sy);
    const int b0 = static_cast<int>(lrintf((1.f - fy) * 2048.f));
    const int b1 = static_cast<int>(lrintf(fy * 2048.f));
    int y0 = sy < 0 ? 0 : (sy > sh - 1 ? sh - 1 : sy);
    int y1 = sy + 1 < 0 ? 0 : (sy + 1 > sh - 1 ? sh - 1 : sy + 1);

    if (y0 != cached_y0) {
      const uint8_t* s = src + static_cast<size_t>(y0) * sw * 3;
      for (int ox = 0; ox < dw; ++ox) {
        const uint8_t* a = s + x0s[ox] * 3;
        const uint8_t* b = s + x1s[ox] * 3;
        const int a0 = xa0[ox], a1 = xa1[ox];
        row0[ox * 3 + 0] = a[0] * a0 + b[0] * a1;
        row0[ox * 3 + 1] = a[1] * a0 + b[1] * a1;
        row0[ox * 3 + 2] = a[2] * a0 + b[2] * a1;
      }
      cached_y0 = y0;
    }
    if (y1 != cached_y1) {
      const uint8_t* s = src + static_cast<size_t>(y1) * sw * 3;
      for (int ox = 0; ox < dw; ++ox) {
        const uint8_t* a = s + x0s[ox] * 3;
        const uint8_t* b = s + x1s[ox] * 3;
        const int a0 = xa0[ox], a1 = xa1[ox];
        row1[ox * 3 + 0] = a[0] * a0 + b[0] * a1;
        row1[ox * 3 + 1] = a[1] * a0 + b[1] * a1;
        row1[ox * 3 + 2] = a[2] * a0 + b[2] * a1;
      }
      cached_y1 = y1;
    }
    uint8_t* o = dst + static_cast<size_t>(oy) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      o[i] = static_cast<uint8_t>(
          (((b0 * (row0[i] >> 4)) >> 16) + ((b1 * (row1[i] >> 4)) >> 16) + 2)
          >> 2);
    }
  }
  free(x0s);
  free(x1s);
  free(xa0);
  free(xa1);
  free(row0);
  free(row1);
}

// Encode interleaved RGB8 to an in-memory JPEG (4:2:0, given quality).
// Returns 0 on success; *out_buf is libjpeg-malloc'd, caller frees.
int encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                unsigned char** out_buf, unsigned long* out_size,
                char* err, size_t err_len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = silent_emit;
  jerr.message[0] = '\0';

  if (setjmp(jerr.setjmp_buffer)) {
    snprintf(err, err_len, "%s", jerr.message);
    jpeg_destroy_compress(&cinfo);
    return 1;
  }

  jpeg_create_compress(&cinfo);
  *out_buf = nullptr;
  *out_size = 0;
  jpeg_mem_dest(&cinfo, out_buf, out_size);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);  // default sampling = 2x2,1x1,1x1 (4:2:0)
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<size_t>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

}  // namespace

// JPEG bytes -> resized (out_h, out_w) -> 4:2:0 re-encode at `quality` ->
// dequantized coefficients.  out_y: (out_h/8)*(out_w/8)*64 int16;
// out_cbcr: (out_h/16)*(out_w/16)*128 int16 (Cb channels 0-63, Cr 64-127).
// out_h/out_w must be multiples of 16.  Returns 0 on success.
int dctjpeg_pack(const uint8_t* data, size_t size, int out_h, int out_w,
                 int quality, int16_t* out_y, int16_t* out_cbcr,
                 char* err, size_t err_len) {
  if (out_h % 16 || out_w % 16) {
    snprintf(err, err_len, "out dims must be multiples of 16");
    return 1;
  }
  int sh = 0, sw = 0;
  uint8_t* rgb = decode_rgb(data, size, &sh, &sw, err, err_len);
  if (rgb == nullptr) return 1;

  uint8_t* resized = rgb;
  if (sh != out_h || sw != out_w) {
    resized = static_cast<uint8_t*>(
        malloc(static_cast<size_t>(out_h) * out_w * 3));
    if (resized == nullptr) {
      snprintf(err, err_len, "out of memory");
      free(rgb);
      return 1;
    }
    resize_bilinear(rgb, sh, sw, resized, out_h, out_w);
    free(rgb);
  }

  unsigned char* jbuf = nullptr;
  unsigned long jsize = 0;
  int rc = encode_jpeg(resized, out_h, out_w, quality, &jbuf, &jsize,
                       err, err_len);
  free(resized);  // == rgb when no resize happened; rgb freed otherwise
  if (rc != 0) {
    free(jbuf);
    return 1;
  }

  DctDecoded dec;
  rc = dctjpeg_decode(jbuf, jsize, 1, &dec);
  free(jbuf);
  if (rc != 0) {
    snprintf(err, err_len, "%s", dec.error);
    return 1;
  }
  if (dec.n_components < 3) {
    snprintf(err, err_len, "re-encoded JPEG lost components");
    dctjpeg_release(&dec);
    return 1;
  }
  const int yb = dec.h_blocks[0] * dec.w_blocks[0];
  for (int i = 0; i < yb * DCTSIZE2; ++i) {
    out_y[i] = static_cast<int16_t>(dec.coeffs[0][i]);
  }
  const int cb = dec.h_blocks[1] * dec.w_blocks[1];
  for (int b = 0; b < cb; ++b) {
    int16_t* o = out_cbcr + static_cast<size_t>(b) * 2 * DCTSIZE2;
    const int32_t* src_cb = dec.coeffs[1] + static_cast<size_t>(b) * DCTSIZE2;
    const int32_t* src_cr = dec.coeffs[2] + static_cast<size_t>(b) * DCTSIZE2;
    for (int k = 0; k < DCTSIZE2; ++k) {
      o[k] = static_cast<int16_t>(src_cb[k]);
      o[DCTSIZE2 + k] = static_cast<int16_t>(src_cr[k]);
    }
  }
  dctjpeg_release(&dec);
  return 0;
}

}  // extern "C"
