// YCbCr -> RGBA of one pixel, shared by K3 assemble_color
// (jpeg_decode.cu) and K4 assemble_mcu (jpeg_codec.cu), so that the two
// convert colour in one place.
//
// The float stage follows the JAX reference's color_convert
// (ffpic_tpu/ops/jpeg_kernels.py:144) as XLA compiles it inside a jit:
// each product is fused with its sum into one f32 FMA (__fmaf_rn), g as
// fma(-0.381, v, fma(-0.215, u, y)); every other step is an explicit _rn
// intrinsic, so nvcc's own contraction cannot change the rounding.

#pragma once

#include <cstdint>

namespace {

// the int16 halves of a packed 32-bit word, sign-extended
__device__ __forceinline__ int lo16(uint32_t w) { return (int16_t)(w & 0xFFFFu); }
__device__ __forceinline__ int hi16(uint32_t w) { return (int16_t)(w >> 16); }

__device__ __forceinline__ uint8_t clip_u8(float f) {
  return (uint8_t)fminf(fmaxf(f, 0.0f), 255.0f);
}

__device__ __forceinline__ uint8_t clip_u8i(int v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The colour of one pixel, packed as 4 bytes in memory order.
// mode: 0 reference (trunc), 1 bt601 (floor(+0.5)), 2 rgb (clip only);
// order: 0 rgba, 1 bgra.
template <int kMode, int kOrder>
__device__ __forceinline__ uint32_t pixel(int ys, int us, int vs) {
  uint8_t r, g, b;
  if (kMode == 2) {
    r = clip_u8i(ys);
    g = clip_u8i(us);
    b = clip_u8i(vs);
  } else {
    float yy = (float)ys, uu = (float)us - 128.0f, vv = (float)vs - 128.0f;
    if (kMode == 0) {
      r = clip_u8(truncf(__fmaf_rn(1.280f, vv, yy)));
      g = clip_u8(truncf(__fmaf_rn(-0.381f, vv, __fmaf_rn(-0.215f, uu, yy))));
      b = clip_u8(truncf(__fmaf_rn(2.128f, uu, yy)));
    } else {
      r = clip_u8(floorf(__fadd_rn(__fmaf_rn(1.402f, vv, yy), 0.5f)));
      g = clip_u8(floorf(__fadd_rn(
          __fmaf_rn(-0.714136f, vv, __fmaf_rn(-0.344136f, uu, yy)), 0.5f)));
      b = clip_u8(floorf(__fadd_rn(__fmaf_rn(1.772f, uu, yy), 0.5f)));
    }
  }
  if (kOrder == 1) {
    uint8_t t = r;
    r = b;
    b = t;
  }
  return (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16) | 0xFF000000u;
}

}  // namespace
