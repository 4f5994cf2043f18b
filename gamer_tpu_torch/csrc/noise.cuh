// Device math for the march kernel (march.cu): NaN-propagating min/max,
// the Qt clamp, minimax atan/atan2, the integer hash, and simplex noise
// (raw, octave, ridged multifractal).
//
// Replaces the in-kernel device functions of the TPU kernel,
// gamer_tpu/ops/pallas_noise.py: atan_f32/atan2_f32 (:39-67),
// raw_noise_3d (:119-189), octave_noise_3d (:328-345), ridged_mf
// (:348-374). The permutation table is read directly from shared memory
// (PERM[idx]); the TPU's byte-packed lane-gather layout is not ported.
//
// Every expression keeps the JAX evaluation order, and every non-trivial
// constant is written F32(double literal): JAX rounds a Python float to
// float32 from its double value, and so does this cast.
#pragma once

#include <math.h>
#include <stdint.h>

#define F32(x) ((float)(x))

namespace gamer {

constexpr double PI = 3.141592653589793;

// jnp.maximum / jnp.minimum: a NaN in either operand gives NaN (fmaxf and
// fminf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// max(lo, min(hi, v)) with std::min/max ordering: a NaN becomes hi.
__device__ __forceinline__ float qt_clamp(float v, float lo, float hi) {
    float r = v < hi ? v : hi;
    return r > lo ? r : lo;
}

// Floor modulo (jnp's %), b > 0.
__device__ __forceinline__ int floor_mod(int a, int b) {
    int r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// int32 abs with jnp semantics: |INT_MIN| stays INT_MIN.
__device__ __forceinline__ int abs_i32(int h) {
    return h < 0 ? (int)(0u - (uint32_t)h) : h;
}

// gamer_tpu.engine.render.hash3_i32: wrapping int32 multiplies (done in
// uint32, where overflow is defined), xor, arithmetic shift.
__device__ __forceinline__ int hash3_i32(int bx, int by, int bz) {
    uint32_t u = ((uint32_t)bx * 2654435769u)      // * int32(-1640531527)
                 ^ ((uint32_t)by * 97u)
                 ^ ((uint32_t)bz * 1013904223u);
    int h = (int)u;
    return h ^ (h >> 13);
}

__device__ __forceinline__ float atan_f32(float x) {
    float ax = fabsf(x);
    bool big = ax > F32(2.414213562373095);   // tan(3*pi/8)
    bool mid = ax > F32(0.4142135623730950);  // tan(pi/8)
    float safe = ax == 0.0f ? 1.0f : ax;
    float z = big ? -1.0f / safe : (mid ? (ax - 1.0f) / (ax + 1.0f) : ax);
    float base = big ? F32(PI / 2) : (mid ? F32(PI / 4) : 0.0f);
    float z2 = z * z;
    float p = ((F32(8.05374449538e-2) * z2 - F32(1.38776856032e-1)) * z2
               + F32(1.99777106478e-1)) * z2 - F32(3.33329491539e-1);
    float r = base + (z + z * z2 * p);
    return x < 0.0f ? -r : r;
}

__device__ __forceinline__ float atan2_f32(float y, float x) {
    float safe_x = x == 0.0f ? 1.0f : x;
    float r = atan_f32(y / safe_x);
    float shift = y < 0.0f ? F32(-PI) : F32(PI);
    r = x < 0.0f ? r + shift : r;
    float vert = y > 0.0f ? F32(PI / 2) : (y < 0.0f ? F32(-PI / 2) : 0.0f);
    return x == 0.0f ? vert : r;
}

// trunc for x > 0 else trunc - 1 (simplexnoise.h:130 — not floor at exact
// non-positive integers). __float2int_rz saturates and maps NaN to 0.
__device__ __forceinline__ int fastfloor(float x) {
    float t = truncf(x);
    return __float2int_rz(x > 0.0f ? t : t - 1.0f);
}

__device__ __forceinline__ float grad_dot(int gi, float x, float y, float z) {
    int group = gi >> 2;
    float u = group == 2 ? y : x;
    float v = group == 0 ? y : z;
    u = (gi & 1) ? -u : u;
    v = (gi & 2) ? -v : v;
    return u + v;
}

__device__ __forceinline__ float contrib(float tv, int gi, float x, float y,
                                         float z) {
    float tt = tv * tv;
    return tv < 0.0f ? 0.0f : tt * tt * grad_dot(gi, x, y, z);
}

// Raw 3-D simplex noise (simplexnoise.cpp:173+); perm is PERM[512].
inline __device__ float raw_noise_3d(const int* perm, float x, float y, float z) {
    const float third = F32(1.0 / 3.0);
    const float sixth = F32(1.0 / 6.0);
    float s = (x + y + z) * third;
    int i = fastfloor(x + s);
    int j = fastfloor(y + s);
    int k = fastfloor(z + s);
    float t = (float)(i + j + k) * sixth;
    float x0 = x - ((float)i - t);
    float y0 = y - ((float)j - t);
    float z0 = z - ((float)k - t);

    bool A = x0 >= y0, B = y0 >= z0, C = x0 >= z0;
    int i1 = A && (B || C);
    int j1 = !A && B;
    int k1 = (A && !B && !C) || (!A && !B);
    int i2 = A || (B && C);
    int j2 = !A || B;
    int k2 = (A && !B) || (!A && (!B || !C));

    float x1 = x0 - (float)i1 + sixth;
    float y1 = y0 - (float)j1 + sixth;
    float z1 = z0 - (float)k1 + sixth;
    float x2 = x0 - (float)i2 + F32(2.0 * (1.0 / 6.0));
    float y2 = y0 - (float)j2 + F32(2.0 * (1.0 / 6.0));
    float z2 = z0 - (float)k2 + F32(2.0 * (1.0 / 6.0));
    float x3 = x0 - 1.0f + F32(3.0 * (1.0 / 6.0));
    float y3 = y0 - 1.0f + F32(3.0 * (1.0 / 6.0));
    float z3 = z0 - 1.0f + F32(3.0 * (1.0 / 6.0));

    int ii = i & 255, jj = j & 255, kk = k & 255;
    int gi0 = perm[ii + perm[jj + perm[kk]]] % 12;
    int gi1 = perm[ii + i1 + perm[jj + j1 + perm[kk + k1]]] % 12;
    int gi2 = perm[ii + i2 + perm[jj + j2 + perm[kk + k2]]] % 12;
    int gi3 = perm[ii + 1 + perm[jj + 1 + perm[kk + 1]]] % 12;

    const float p6 = F32(0.6);
    float n0 = contrib(p6 - x0 * x0 - y0 * y0 - z0 * z0, gi0, x0, y0, z0);
    float n1 = contrib(p6 - x1 * x1 - y1 * y1 - z1 * z1, gi1, x1, y1, z1);
    float n2 = contrib(p6 - x2 * x2 - y2 * y2 - z2 * z2, gi2, x2, y2, z2);
    float n3 = contrib(p6 - x3 * x3 - y3 * y3 - z3 * z3, gi3, x3, y3, z3);
    return 32.0f * (n0 + n1 + n2 + n3);
}

// noise.cpp:162-180: frequency doubling, persistence amplitudes,
// normalized by the total amplitude.
inline __device__ float octave_noise_3d(const int* perm, int octaves,
                                 float persistence, float scale, float x,
                                 float y, float z) {
    float total = 0.0f;
    float freq = scale;
    float amp = 1.0f;
    float max_amp = 0.0f;
    for (int o = 0; o < octaves; ++o) {
        total = total + raw_noise_3d(perm, x * freq, y * freq, z * freq) * amp;
        freq = freq * 2.0f;
        max_amp = max_amp + amp;
        amp = amp * persistence;
    }
    return total / max_amp;
}

// noise.cpp:81-128 with host-computed spectral weights sw[0..n).
inline __device__ float ridged_mf(const int* perm, float x, float y, float z,
                           const float* sw, int n, float lacunarity,
                           float offset, float gain) {
    float value = 0.0f;
    float weight = 1.0f;
    for (int o = 0; o < n; ++o) {
        float signal = raw_noise_3d(perm, x, y, z);
        signal = offset - fabsf(signal);
        signal = signal * signal;
        signal = signal * weight;
        weight = nan_min(nan_max(signal * gain, 0.0f), 1.0f);  // jnp.clip
        value = value + signal * sw[o];
        x = x * lacunarity;
        y = y * lacunarity;
        z = z * lacunarity;
    }
    return value * 1.25f - 1.0f;
}

}  // namespace gamer
