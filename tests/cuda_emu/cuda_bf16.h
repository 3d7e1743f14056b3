// bfloat16 conversions (round to nearest even) for the CPU emulation of
// the kernels' device code (see cuda_runtime.h beside this file).
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
