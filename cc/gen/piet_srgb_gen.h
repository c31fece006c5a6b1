// Generated by python -m piet_tpu.layout; do not edit.
// sRGB decode table + deterministic encode (see piet_tpu/scene/color.py).
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>

namespace piet_srgb {

// u8 sRGB code -> linear f32, computed in float64 and rounded once
// (bit-exact across numpy / XLA / C++ by construction).
inline const uint32_t kDecodeBits[256] = {
    0x00000000u, 0x399f22b4u, 0x3a1f22b4u, 0x3a6eb40eu, 0x3a9f22b4u, 0x3ac6eb61u,
    0x3aeeb40eu, 0x3b0b3e5du, 0x3b1f22b4u, 0x3b33070au, 0x3b46eb61u, 0x3b5b518eu,
    0x3b70f18fu, 0x3b83e1c6u, 0x3b8fe616u, 0x3b9c87fdu, 0x3ba9c9b6u, 0x3bb7ad6fu,
    0x3bc6354au, 0x3bd56360u, 0x3be539c1u, 0x3bf5ba71u, 0x3c0373b6u, 0x3c0c6153u,
    0x3c15a705u, 0x3c1f45beu, 0x3c293e6bu, 0x3c3391f7u, 0x3c3e4149u, 0x3c494d44u,
    0x3c54b6c9u, 0x3c607eb4u, 0x3c6ca5dfu, 0x3c792d22u, 0x3c830aa9u, 0x3c89af9fu,
    0x3c9085dcu, 0x3c978dc6u, 0x3c9ec7c2u, 0x3ca63433u, 0x3cadd37du, 0x3cb5a602u,
    0x3cbdac21u, 0x3cc5e63au, 0x3cce54acu, 0x3cd6f7d5u, 0x3cdfd010u, 0x3ce8ddbau,
    0x3cf2212du, 0x3cfb9ac3u, 0x3d02a56au, 0x3d0798ddu, 0x3d0ca7e6u, 0x3d11d2afu,
    0x3d171964u, 0x3d1c7c30u, 0x3d21fb3cu, 0x3d2796b2u, 0x3d2d4ebbu, 0x3d332381u,
    0x3d39152bu, 0x3d3f23e4u, 0x3d454fd2u, 0x3d4b991du, 0x3d51ffecu, 0x3d588468u,
    0x3d5f26b6u, 0x3d65e6fdu, 0x3d6cc563u, 0x3d73c20eu, 0x3d7add24u, 0x3d810b65u,
    0x3d84b793u, 0x3d88732eu, 0x3d8c3e48u, 0x3d9018f4u, 0x3d940344u, 0x3d97fd49u,
    0x3d9c0715u, 0x3da020bau, 0x3da44a4au, 0x3da883d6u, 0x3daccd6fu, 0x3db12727u,
    0x3db5910fu, 0x3dba0b38u, 0x3dbe95b3u, 0x3dc33090u, 0x3dc7dbe0u, 0x3dcc97b4u,
    0x3dd1641du, 0x3dd6412bu, 0x3ddb2eeeu, 0x3de02d76u, 0x3de53cd4u, 0x3dea5d18u,
    0x3def8e51u, 0x3df4d090u, 0x3dfa23e5u, 0x3dff885eu, 0x3e027f06u, 0x3e05427fu,
    0x3e080ea2u, 0x3e0ae377u, 0x3e0dc104u, 0x3e10a753u, 0x3e13966au, 0x3e168e51u,
    0x3e198f0fu, 0x3e1c98acu, 0x3e1fab30u, 0x3e22c6a1u, 0x3e25eb07u, 0x3e29186au,
    0x3e2c4ed0u, 0x3e2f8e42u, 0x3e32d6c5u, 0x3e362862u, 0x3e39831fu, 0x3e3ce703u,
    0x3e405417u, 0x3e43ca60u, 0x3e4749e6u, 0x3e4ad2afu, 0x3e4e64c3u, 0x3e520029u,
    0x3e55a4e7u, 0x3e595305u, 0x3e5d0a89u, 0x3e60cb7au, 0x3e6495dfu, 0x3e6869beu,
    0x3e6c471fu, 0x3e702e07u, 0x3e741e7eu, 0x3e78188bu, 0x3e7c1c33u, 0x3e8014bfu,
    0x3e822039u, 0x3e84308bu, 0x3e8645b8u, 0x3e885fc3u, 0x3e8a7eb0u, 0x3e8ca281u,
    0x3e8ecb3bu, 0x3e90f8dfu, 0x3e932b72u, 0x3e9562f6u, 0x3e979f6fu, 0x3e99e0e0u,
    0x3e9c274cu, 0x3e9e72b6u, 0x3ea0c321u, 0x3ea31890u, 0x3ea57307u, 0x3ea7d288u,
    0x3eaa3716u, 0x3eaca0b6u, 0x3eaf0f68u, 0x3eb18332u, 0x3eb3fc15u, 0x3eb67a14u,
    0x3eb8fd34u, 0x3ebb8576u, 0x3ebe12deu, 0x3ec0a56eu, 0x3ec33d2au, 0x3ec5da14u,
    0x3ec87c30u, 0x3ecb2380u, 0x3ecdd008u, 0x3ed081cau, 0x3ed338c9u, 0x3ed5f508u,
    0x3ed8b68au, 0x3edb7d52u, 0x3ede4963u, 0x3ee11abfu, 0x3ee3f169u, 0x3ee6cd65u,
    0x3ee9aeb5u, 0x3eec955bu, 0x3eef815cu, 0x3ef272b8u, 0x3ef56974u, 0x3ef86593u,
    0x3efb6716u, 0x3efe6e00u, 0x3f00bd2bu, 0x3f02460cu, 0x3f03d1a5u, 0x3f055ff7u,
    0x3f06f104u, 0x3f0884cdu, 0x3f0a1b54u, 0x3f0bb499u, 0x3f0d509fu, 0x3f0eef65u,
    0x3f1090efu, 0x3f12353du, 0x3f13dc50u, 0x3f15862au, 0x3f1732ccu, 0x3f18e237u,
    0x3f1a946eu, 0x3f1c4970u, 0x3f1e0140u, 0x3f1fbbdeu, 0x3f21794du, 0x3f23398cu,
    0x3f24fc9fu, 0x3f26c285u, 0x3f288b41u, 0x3f2a56d2u, 0x3f2c253cu, 0x3f2df67fu,
    0x3f2fca9cu, 0x3f31a194u, 0x3f337b6au, 0x3f35581du, 0x3f3737b0u, 0x3f391a24u,
    0x3f3aff7au, 0x3f3ce7b2u, 0x3f3ed2cfu, 0x3f40c0d2u, 0x3f42b1bcu, 0x3f44a58eu,
    0x3f469c49u, 0x3f4895efu, 0x3f4a9280u, 0x3f4c91ffu, 0x3f4e946cu, 0x3f5099c9u,
    0x3f52a216u, 0x3f54ad56u, 0x3f56bb88u, 0x3f58ccafu, 0x3f5ae0ccu, 0x3f5cf7dfu,
    0x3f5f11eau, 0x3f612eefu, 0x3f634eeeu, 0x3f6571e9u, 0x3f6797e0u, 0x3f69c0d5u,
    0x3f6beccau, 0x3f6e1bbfu, 0x3f704db5u, 0x3f7282aeu, 0x3f74baabu, 0x3f76f5aeu,
    0x3f7933b6u, 0x3f7b74c6u, 0x3f7db8deu, 0x3f800000u,
};

inline float decode(uint32_t code) {
  float v;
  uint32_t b = kDecodeBits[code & 0xFF];
  std::memcpy(&v, &b, 4);
  return v;
}

// Deterministic linear -> sRGB encode: x^(1/2.4) as 2^(log2(x)/2.4) with
// a bit-level exponent/mantissa split and polynomial log2/exp2 -- only
// mul/add/floor/compare/bitcast, all exactly rounded and identical across
// numpy / device / C++ (a device sqrt/div need not be correctly rounded;
// see scene/color.py::linear_to_srgb_det).  Mirrors that function
// operation-for-operation -- keep the order identical (and
// -ffp-contract=off, set in cc/Makefile).
inline const uint32_t kLogPolyBits[9] = {
    0xbc11672du, 0x3df85f12u, 0xbf3c26e2u, 0x40265a14u, 0xc0be1d92u, 0x41133b6au, 0xc11f25bau, 0x41021532u, 0xc05af24eu
};
inline const uint32_t kExpPolyBits[6] = {
    0x3af86540u, 0x3c129325u, 0x3d64d0e6u, 0x3e75e776u, 0x3f317295u, 0x3f7ffffeu
};

inline float encode(float v) {
  v = std::min(std::max(v, 0.0f), 1.0f);
  float lo = v * 12.92f;
  uint32_t u;
  std::memcpy(&u, &v, 4);
  float e = (float)((int32_t)(u >> 23) - 127);
  uint32_t mb = (u & 0x007FFFFFu) | 0x3F800000u;
  float m;
  std::memcpy(&m, &mb, 4);
  float c, acc;
  std::memcpy(&acc, &kLogPolyBits[0], 4);
  for (int i = 1; i < 9; ++i) {
    std::memcpy(&c, &kLogPolyBits[i], 4);
    acc = acc * m + c;
  }
  float t = (e + acc) * (1.0f / 2.4f);
  float k = std::floor(t);
  float fr = t - k;
  uint32_t sb = (uint32_t)(((int32_t)k + 127) << 23);
  float s;
  std::memcpy(&s, &sb, 4);
  float pe;
  std::memcpy(&pe, &kExpPolyBits[0], 4);
  for (int i = 1; i < 6; ++i) {
    std::memcpy(&c, &kExpPolyBits[i], 4);
    pe = pe * fr + c;
  }
  float hi = 1.055f * (s * pe) - 0.055f;
  return v < 0.0031308f ? lo : hi;
}

// Linear f32 -> u8 code (round-half-even, matching np.round / jnp.round).
inline uint8_t encode_u8(float v) {
  return (uint8_t)(int)std::nearbyintf(encode(v) * 255.0f);
}

}  // namespace piet_srgb
