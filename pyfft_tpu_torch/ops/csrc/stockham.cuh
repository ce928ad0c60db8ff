// In-register complex arithmetic and R-point DFTs (R = 2, 4, 8) shared by
// the row kernel (local_rows.cu) and the column kernel (local_cols.cu), in
// single and double precision.
//
// Real is float or double; Complex<Real>::V is its complex type, a float2
// (one complex64 value) or a double2 (one complex128 value), with x the
// real and y the imaginary part.  The double instantiations compute in
// native FP64 throughout: every constant, product and fused multiply-add is
// taken in double, so a complex128 transform keeps double's ~1e-16 unit
// roundoff.  The sign argument s is -1 for the forward transform and +1 for
// the inverse.

#pragma once

#include <cuda_runtime.h>

namespace pyfft {

template <typename Real>
struct Complex;

template <>
struct Complex<float> {
  using V = float2;
  static constexpr float SQRT1_2 = 0.70710678118654752440f;
  __device__ static __forceinline__ float2 make(float x, float y) {
    return make_float2(x, y);
  }
};

template <>
struct Complex<double> {
  using V = double2;
  static constexpr double SQRT1_2 = 0.70710678118654752440;
  __device__ static __forceinline__ double2 make(double x, double y) {
    return make_double2(x, y);
  }
};

// The real type of a complex type: RealOf<float2>::T is float.
template <class V>
struct RealOf;

template <>
struct RealOf<float2> {
  using T = float;
};

template <>
struct RealOf<double2> {
  using T = double;
};

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 operator-(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// a * (s*i), s = +-1
template <typename Real>
__device__ __forceinline__ typename Complex<Real>::V mul_si(
    typename Complex<Real>::V a, Real s) {
  return Complex<Real>::make(-s * a.y, s * a.x);
}

// The pointer p, hidden from the optimiser: called inside a loop, it keeps
// the loads through p in the loop.  A chain run once per iteration of a
// loop would otherwise have its twiddle loads, the same every iteration,
// hoisted out of it and held in registers across the whole loop, which
// spills.
template <typename T>
__device__ __forceinline__ const T* fresh(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// In-register R-point DFT, y[k] = sum_r v[r] * exp(s*2*pi*i*r*k/R), R = 2,
// 4, 8 or 16.
template <int R, typename Real>
__device__ __forceinline__ void dft(typename Complex<Real>::V* v, Real s) {
  using C = Complex<Real>;
  using V = typename C::V;
  if constexpr (R == 2) {
    const V a = v[0], b = v[1];
    v[0] = a + b;
    v[1] = a - b;
  } else if constexpr (R == 4) {
    const V a = v[0] + v[2], b = v[0] - v[2];
    const V c = v[1] + v[3], d = mul_si<Real>(v[1] - v[3], s);
    v[0] = a + c;
    v[1] = b + d;
    v[2] = a - c;
    v[3] = b - d;
  } else if constexpr (R == 16) {
    // 16 = 4 x 4: 4-point DFTs over the high input digit (inputs r1 + 4*r2
    // for each r1), the w16^(r1*k1) twiddles as constants, then 4-point
    // DFTs over r1 whose outputs interleave as k = k1 + 4*k2.
    constexpr Real C1 = 0.92387953251128675613;   // cos(pi/8)
    constexpr Real S1 = 0.38268343236508977173;   // sin(pi/8)
    constexpr Real H = C::SQRT1_2;
    // w16^(s*m) for m = r1*k1 in 1, 2, 3, 4, 6, 9: (cos, sin) of 2*pi*m/16
    const auto rot = [s](V a, Real c, Real sn) {
      return C::make(a.x * c - s * sn * a.y, s * sn * a.x + a.y * c);
    };
    V a[4][4];
#pragma unroll
    for (int r1 = 0; r1 < 4; ++r1) {
#pragma unroll
      for (int r2 = 0; r2 < 4; ++r2) a[r1][r2] = v[r1 + 4 * r2];
      dft<4, Real>(a[r1], s);
    }
    a[1][1] = rot(a[1][1], C1, S1);
    a[1][2] = rot(a[1][2], H, H);
    a[1][3] = rot(a[1][3], S1, C1);
    a[2][1] = rot(a[2][1], H, H);
    a[2][2] = mul_si<Real>(a[2][2], s);
    a[2][3] = rot(a[2][3], -H, H);
    a[3][1] = rot(a[3][1], S1, C1);
    a[3][2] = rot(a[3][2], -H, H);
    a[3][3] = rot(a[3][3], -C1, -S1);
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
      V b[4] = {a[0][k1], a[1][k1], a[2][k1], a[3][k1]};
      dft<4, Real>(b, s);
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2) v[k1 + 4 * k2] = b[k2];
    }
  } else {
    // 8 = 2 x 4: a radix-2 step over the high input digit, the w8^j
    // twiddles as constants (w8 = c(1 + s*i), c = sqrt(1/2)), then two
    // 4-point DFTs whose outputs interleave as k = 2*k2 + k1.
    static_assert(R == 8, "radix 2, 4, 8 or 16");
    const Real c = C::SQRT1_2;
    V e[4], o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = v[j] + v[j + 4];
      o[j] = v[j] - v[j + 4];
    }
    o[1] = C::make(c * (o[1].x - s * o[1].y), c * (o[1].y + s * o[1].x));
    o[2] = mul_si<Real>(o[2], s);
    o[3] = C::make(-c * (o[3].x + s * o[3].y), c * (s * o[3].x - o[3].y));
    dft<4, Real>(e, s);
    dft<4, Real>(o, s);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = e[k];
      v[2 * k + 1] = o[k];
    }
  }
}

}  // namespace pyfft
