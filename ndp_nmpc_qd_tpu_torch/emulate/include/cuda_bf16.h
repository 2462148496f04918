// Host stand-in for bf16 (see cuda_runtime.h): conversions to f32 exact,
// from f32 rounded to nearest even, as the card's intrinsics.
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{uint16_t((u >> 16) | 0x40u)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{uint16_t(u >> 16)};
}
