// Host emulation of the bf16 type and conversions the port's kernels use
// (see cuda_runtime.h): round to nearest even, NaN kept quiet.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 { uint16_t bits; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return {static_cast<uint16_t>((u >> 16) | 0x40)};
  return {static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
