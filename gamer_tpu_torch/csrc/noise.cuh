// Device math for the march kernel (march.cu): NaN-propagating min/max,
// the Qt clamp, minimax atan/atan2, the integer hash, and the three raw
// noise backends (simplex, classic Perlin, IQ sin-hash value noise) under
// the octave and ridged-multifractal combinators.
//
// Replaces the in-kernel device functions of the TPU kernel,
// gamer_tpu/ops/pallas_noise.py: atan_f32/atan2_f32 (:39-67),
// raw_noise_3d (:119-189), perlin_raw_3d (:248-291, with
// perlin_perm_lookup :214-221 and _perlin_grad_dot :224-245), iq_raw_3d
// (:294-325), octave_noise_3d (:328-345), ridged_mf (:348-374). The
// permutation tables are read directly from shared memory (noise_smem, which
// the kernel stages at block start), in a layout built on the host
// (ops/noise.py::kernel_noise_table) that shortens the dependent lookup
// chain without changing an index or a value: each word pairs an entry with
// its successor, so the two neighbours a lattice cell needs come from one
// load. The TPU's byte-packed and chunked lane-gather layouts are not
// ported. The raw backend is a template parameter of the combinators, so
// each kind is its own instantiation and the simplex one carries no trace
// of the others.
//
// The perlin gradients. The TPU kernel regenerates each lattice corner's
// gradient in registers from a hash of its 10-bit index (_perlin_grad_dot:
// its gathers were the frame's cost on the TPU); here that hash and its
// three int->float decodes (~21 integer, conversion and f32 operations of
// the 26 per corner, 8 corners a raw evaluation) depend on the index alone,
// so the 1,024 decoded gradients are a table: built on the host by the same
// f32 arithmetic (ops/noise.py::perlin_grad_table), after the paired
// permutation in the perlin kernels' table, staged at block start into
// perlin_grads (shared memory that only the perlin instantiations
// reference), one 16-byte shared load a corner and the dot in its order.
// The same bits by construction: the decode is two exact-or-once-rounded
// f32 operations on an integer below 1,024 (march.cu's check_perlin_grads
// holds the table against the hash on the card).
//
// Code size. The octave and ridged combinators are not inlined: the march
// calls them from six places, and a copy of the octave loop (with its raw
// backend) inlined at each one makes the kernel's hot code larger; measured
// on the H100, one shared copy runs the march 14-18 % faster (PERF.md).
// For the same reason their octaves run one after another: two raw
// evaluations in flight per trip tripled the raw backend's copies and cost
// 13-43 %.
//
// The iq hash. iq_raw_3d hashes eight integer-valued floats per evaluation
// (n = px + 157 py + 113 pz plus 0, 1, 157, 158, 113, 114, 270, 271: floors
// and integers, whose f32 sums are integers at every magnitude), and the
// library sinf each hash takes is ~25 f32 instructions with a Payne-Hanek
// branch for large arguments. So h(n) = frac(sinf(n) * 753.5453123) is
// read from a table of pairs (h(n), h(n + 1)) over |n| <= IQ_TABLE_R that
// march.cu's fill_iq_table writes with this same iq_hash: four 8-byte loads
// through the read-only path in place of eight sines, the same bits by
// construction. Arguments outside the table (NaN and inf included) take
// iq_corners_far, the sines in one non-inlined copy. The table is built
// once per device (ops/noise.py::iq_hash_table) and reaches the kernels as
// their noise-table argument, whose address the kernel stages in
// iq_pairs; simplex and perlin never read it.
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

// The kind's lookup table (noise_table_size entries), staged in shared memory
// by the kernel at block start: a fixed symbol, so the raw backends read it
// with shared-memory loads from inside the non-inlined combinators.
__shared__ int noise_smem[1024];

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

// The low and high 16-bit halves of a paired table word.
__device__ __forceinline__ int lo16(int w) { return w & 0xFFFF; }
__device__ __forceinline__ int hi16(int w) { return w >> 16; }

// Raw 3-D simplex noise (simplexnoise.cpp:173+). tab is [P2[512] | GI[512]]
// with P2[x] = PERM[x] | PERM[x + 1] << 16 (x + 1 taken mod 512) and
// GI[x] = PERM[x] % 12. The reference's gradient indices
// PERM[ii + a + PERM[jj + b + PERM[kk + c]]] % 12 (a, b, c in {0, 1}) take
// 12 loads in three dependent levels and 4 modulos; here P2[kk] gives
// PERM[kk + c] for both c, P2[jj + PERM[kk + c]] gives PERM[jj + b + ...]
// for both b, and GI the last level: 7 loads, the same depth, no modulo.
// Every index stays below 512, as in the reference.
inline __device__ float raw_noise_3d(const int* tab, float x, float y, float z) {
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
    const int* gi = tab + 512;
    const int pk = tab[kk];                  // PERM[kk], PERM[kk + 1]
    const int pj0 = tab[jj + lo16(pk)];      // PERM[jj + b + PERM[kk]]
    const int pj1 = tab[jj + hi16(pk)];      // PERM[jj + b + PERM[kk + 1]]
    const int q1 = k1 ? pj1 : pj0, q2 = k2 ? pj1 : pj0;
    int gi0 = gi[ii + lo16(pj0)];
    int gi1 = gi[ii + i1 + (j1 ? hi16(q1) : lo16(q1))];
    int gi2 = gi[ii + i2 + (j2 ? hi16(q2) : lo16(q2))];
    int gi3 = gi[ii + 1 + hi16(pj1)];

    const float p6 = F32(0.6);
    float n0 = contrib(p6 - x0 * x0 - y0 * y0 - z0 * z0, gi0, x0, y0, z0);
    float n1 = contrib(p6 - x1 * x1 - y1 * y1 - z1 * z1, gi1, x1, y1, z1);
    float n2 = contrib(p6 - x2 * x2 - y2 * y2 - z2 * z2, gi2, x2, y2, z2);
    float n3 = contrib(p6 - x3 * x3 - y3 * y3 - z3 * z3, gi3, x3, y3, z3);
    return 32.0f * (n0 + n1 + n2 + n3);
}

// --- classic Perlin gradient noise (perlin.cpp:99-150) ----------------------

// The gradient hash of ops/altnoise.py (GRAD_HASH): two rounds of
// multiply-xorshift over int32 with two's-complement wrap (the multiplies
// run in uint32, where overflow is defined) and arithmetic right shifts,
// keyed for table seed 94; the three 10-bit fields decode to gradient
// components (q - 511.5) / 511.5 with both constants rounded to float32.
// The march reads these from perlin_grads; the hash stays as the table's
// definition, which check_perlin_grads (march.cu) holds the table to.
constexpr uint32_t PERLIN_SEEDK = 0x185EB1EEu;  // grad_hash_seedk(94)
constexpr uint32_t GRAD_HASH_M1 = 0x7FEB352Du;
constexpr uint32_t GRAD_HASH_M2 = 0x846CA68Bu;

__device__ __forceinline__ float3 perlin_grad_hashed(int idx) {
    int h = (int)(((uint32_t)(idx & 1023) ^ PERLIN_SEEDK) * GRAD_HASH_M1);
    h = h ^ (h >> 15);
    h = (int)((uint32_t)h * GRAD_HASH_M2);
    h = h ^ (h >> 13);
    const float mid = F32(511.5);
    const float inv = F32(1.0 / 511.5);
    return make_float3(((float)(h & 1023) - mid) * inv,
                       ((float)((h >> 10) & 1023) - mid) * inv,
                       ((float)((h >> 20) & 1023) - mid) * inv);
}

// The perlin kernels' table: PERLIN_PERM_WORDS words of the paired
// permutation (staged in noise_smem), then PERLIN_GRADS gradients as
// float4 (gx, gy, gz, 0), 16-byte aligned.
constexpr int PERLIN_PERM_WORDS = 1024;
constexpr int PERLIN_GRADS = 1024;

// The gradients, staged by the perlin kernels at block start (16 KB; the
// other kinds never reference it, so their kernels do not allocate it).
__shared__ float4 perlin_grads[PERLIN_GRADS];

__device__ __forceinline__ float perlin_grad_dot(int idx, float rx, float ry,
                                                 float rz) {
    const float4 g = perlin_grads[idx & 1023];
    return rx * g.x + ry * g.y + rz * g.z;
}

// The setup() macro (perlin.cpp:24-29): the cast truncates, which is the
// lattice cell only for t >= 0, i.e. coordinates above -4096; kept as
// written. __float2int_rz saturates and maps NaN to 0.
__device__ __forceinline__ void perlin_setup(float v, int& b0, int& b1,
                                             float& r0, float& r1) {
    float t = v + 4096.0f;
    int it = __float2int_rz(t);
    b0 = it & 1023;
    b1 = (b0 + 1) & 1023;
    r0 = t - (float)it;
    r1 = r0 - 1.0f;
}

__device__ __forceinline__ float s_curve(float t) {
    return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float lerp_w(float w, float a, float b) {
    return a + w * (b - a);
}

// Raw 3-D Perlin noise, x2 as Perlin::raw_3d (perlin.h:32-37). q is the
// 1024-entry permutation p of table seed 94 in pairs,
// q[x] = p[x] | p[(x + 1) & 1023] << 16: since b1 = (b0 + 1) & 1023 on
// every axis, q[bx0] gives p[bx0] and p[bx1], and q[(i + by0) & 1023] gives
// p[(i + by0) & 1023] and p[(i + by1) & 1023]; 3 loads where the reference
// makes 6, with the same indices.
inline __device__ float perlin_raw_3d(const int* q, float x, float y, float z) {
    int bx0, bx1, by0, by1, bz0, bz1;
    float rx0, rx1, ry0, ry1, rz0, rz1;
    perlin_setup(x, bx0, bx1, rx0, rx1);
    perlin_setup(y, by0, by1, ry0, ry1);
    perlin_setup(z, bz0, bz1, rz0, rz1);

    const int qx = q[bx0];
    int i = lo16(qx);
    int j = hi16(qx);
    const int qi = q[(i + by0) & 1023];
    const int qj = q[(j + by0) & 1023];
    int b00 = lo16(qi), b01 = hi16(qi);
    int b10 = lo16(qj), b11 = hi16(qj);

    float t = s_curve(rx0);
    float sy = s_curve(ry0);
    float sz = s_curve(rz0);
    float a = lerp_w(t, perlin_grad_dot(b00 + bz0, rx0, ry0, rz0),
                   perlin_grad_dot(b10 + bz0, rx1, ry0, rz0));
    float b = lerp_w(t, perlin_grad_dot(b01 + bz0, rx0, ry1, rz0),
                   perlin_grad_dot(b11 + bz0, rx1, ry1, rz0));
    float c = lerp_w(sy, a, b);
    a = lerp_w(t, perlin_grad_dot(b00 + bz1, rx0, ry0, rz1),
             perlin_grad_dot(b10 + bz1, rx1, ry0, rz1));
    b = lerp_w(t, perlin_grad_dot(b01 + bz1, rx0, ry1, rz1),
             perlin_grad_dot(b11 + bz1, rx1, ry1, rz1));
    float d = lerp_w(sy, a, b);
    return 2.0f * lerp_w(sz, c, d);
}

// --- IQ sin-hash trilinear value noise (iqnoise.cpp:34-53) ------------------

// floor as trunc - (v < trunc), as the TPU kernel writes it.
__device__ __forceinline__ float iq_floor(float v) {
    float t = truncf(v);
    return t - (v < t ? 1.0f : 0.0f);
}

// frac(sin(n) * 753.5453123): sinf, never __sinf; the multiply amplifies
// the last ulps of the sine, so two sine implementations give hashes that
// differ visibly at single lattice corners.
__device__ __forceinline__ float iq_hash(float n) {
    float v = sinf(n) * F32(753.5453123);
    return v - iq_floor(v);
}

// The hash table: pair j holds (h(j - IQ_TABLE_R), h(j - IQ_TABLE_R + 1))
// for j in [0, IQ_TABLE_PAIRS), so the pairs at n, n + 157, n + 113 and
// n + 270 hold a cell's eight corners for every integer |n| <= IQ_TABLE_R.
// 2^20 covers every preset's arguments about twice (the largest are the
// spiral's, from its ridged dust's 9th octave: 538,428 at 64^2;
// tests/test_torch_iq_hash.py holds every preset inside): 16 MB, a third
// of the H100's L2. A persisting-L2 window over it bought nothing.
constexpr int IQ_TABLE_R = 1 << 20;
constexpr int IQ_TABLE_PAIRS = 2 * IQ_TABLE_R + 271;

// The table's address, staged by the iq kernels at block start.
__shared__ const float2* iq_pairs;

// A cell's eight hashes as the pairs at n, n + 157, n + 113 and n + 270.
struct IqCorners {
    float2 a, b, c, d;
};

// The corners outside the table, by the sines themselves: one shared copy
// of the eight inlined sinf, out of the noise loops' code.
static __noinline__ __device__ IqCorners iq_corners_far(float n) {
    return {{iq_hash(n + 0.0f), iq_hash(n + 1.0f)},
            {iq_hash(n + 157.0f), iq_hash(n + 158.0f)},
            {iq_hash(n + 113.0f), iq_hash(n + 114.0f)},
            {iq_hash(n + 270.0f), iq_hash(n + 271.0f)}};
}

// n is integer-valued (or NaN or inf, which fail the range test).
__device__ __forceinline__ IqCorners iq_corners(const float2* tab, float n) {
    if (!(fabsf(n) <= (float)IQ_TABLE_R)) return iq_corners_far(n);
    const float2* p = tab + (__float2int_rz(n) + IQ_TABLE_R);
    return {__ldg(p), __ldg(p + 157), __ldg(p + 113), __ldg(p + 270)};
}

inline __device__ float iq_raw_3d(float x, float y, float z) {
    float px = iq_floor(x), py = iq_floor(y), pz = iq_floor(z);
    float fx = x - px, fy = y - py, fz = z - pz;
    fx = s_curve(fx);
    fy = s_curve(fy);
    fz = s_curve(fz);
    float n = px + py * 157.0f + 113.0f * pz;
    const IqCorners h = iq_corners(iq_pairs, n);
    return lerp_w(
        fz,
        lerp_w(fy, lerp_w(fx, h.a.x, h.a.y), lerp_w(fx, h.b.x, h.b.y)),
        lerp_w(fy, lerp_w(fx, h.c.x, h.c.y), lerp_w(fx, h.d.x, h.d.y)));
}

// --- the raw backend as a compile-time kind ---------------------------------

enum { NOISE_SIMPLEX = 0, NOISE_PERLIN = 1, NOISE_IQ = 2, N_NOISE_KINDS = 3 };

// Entries of the kind's lookup table, which the caller stages in shared
// memory: [P2[512] | GI[512]] for simplex, the paired Perlin permutation
// [1024] (the perlin table's gradients after it go to perlin_grads:
// stage_perlin_grads), or none (iq's table stays in device memory:
// stage_iq_pairs stages its address).
__host__ __device__ constexpr int noise_table_size(int kind) {
    return kind == NOISE_IQ ? 0 : 1024;
}

// The iq kernels' staging at block start, before their __syncthreads: the
// hash table's address into iq_pairs (the other kinds stage their table
// into noise_smem and leave this empty).
template <int KIND>
__device__ __forceinline__ void stage_iq_pairs(const int* noise_g) {
    if constexpr (KIND == NOISE_IQ) {
        if (threadIdx.x == 0)
            iq_pairs = reinterpret_cast<const float2*>(noise_g);
    }
}

// The perlin kernels' staging at block start, before their __syncthreads:
// the gradients into perlin_grads (the other kinds stage nothing here).
template <int KIND>
__device__ __forceinline__ void stage_perlin_grads(const int* noise_g,
                                                   int n_threads) {
    if constexpr (KIND == NOISE_PERLIN) {
        const float4* g =
            reinterpret_cast<const float4*>(noise_g + PERLIN_PERM_WORDS);
        for (int k = threadIdx.x; k < PERLIN_GRADS; k += n_threads)
            perlin_grads[k] = g[k];
    }
}

template <int KIND>
__device__ __forceinline__ float raw_noise(float x, float y, float z) {
    if constexpr (KIND == NOISE_PERLIN) {
        return perlin_raw_3d(noise_smem, x, y, z);
    } else if constexpr (KIND == NOISE_IQ) {
        return iq_raw_3d(x, y, z);
    } else {
        return raw_noise_3d(noise_smem, x, y, z);
    }
}

// noise.cpp:162-180: frequency doubling, persistence amplitudes,
// normalized by the total amplitude.
template <int KIND>
__noinline__ __device__ float octave_noise_3d(int octaves, float persistence,
                                              float scale, float x, float y,
                                              float z) {
    float total = 0.0f;
    float freq = scale;
    float amp = 1.0f;
    float max_amp = 0.0f;
    for (int o = 0; o < octaves; ++o) {
        total = total + raw_noise<KIND>(x * freq, y * freq, z * freq) * amp;
        freq = freq * 2.0f;
        max_amp = max_amp + amp;
        amp = amp * persistence;
    }
    return total / max_amp;
}

// noise.cpp:81-128 with host-computed spectral weights sw[0..n).
template <int KIND>
__noinline__ __device__ float ridged_mf(float x, float y, float z,
                                        const float* sw, int n,
                                        float lacunarity, float offset,
                                        float gain) {
    float value = 0.0f;
    float weight = 1.0f;
    for (int o = 0; o < n; ++o) {
        float signal = raw_noise<KIND>(x, y, z);
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
