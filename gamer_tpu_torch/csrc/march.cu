// The march kernel: frames (or row bands of a frame, or an explicit list of
// ray directions) of emission-absorption ray marching through every galaxy
// instance of a scene, for sm_90a.
//
// Replaces the TPU kernels K1, K5, K4 and K6 of
// gamer_tpu/engine/pallas_render.py — both ray sources of _make_kernel
// (:284-383: the camera rays and the rays_input branch :296-298,327-333)
// with _march_instance (:386-679), _apply_bulge (:682-702), the component
// gates and emission (:705-914) and the arm/winding/twirl helpers
// (:917-988), launched by _compiled (:1094-1121), _compiled_band
// (:1243-1291), _compiled_batch (:1294-1321) and _compiled_dirs
// (:1324-1346) through _tile_call (:1022-1062), and S1's per-chip body,
// _compiled_rowshard (:1124-1187) — together with its in-kernel noise (K2
// and the perlin and iq raw backends, noise.cuh).
//
// Design. One thread per ray, each with its own loop exit: the
// reference's per-pixel loop (rasterizer.cpp:447-475). The TPU kernel's
// tile-wide triggers (pl.when(jnp.any(...))) only skipped work; here each
// thread tests the same conservative trigger and the exact gates for its
// own sample and skips its own noise. The scene's numbers arrive as the
// float32 scalar page and its structure as an int32 table
// (engine/cuda_render.py); one precompiled kernel walks the table at run
// time. The table is the same for every thread of a launch, so the class
// switch does not diverge, and a new scene never needs a rebuild. The march
// state (p, I, step_prev) lives in registers; I carries across instances
// and each instance has its own MAX_ITERS counter.
//
// The march's bookkeeping is the reference's (rasterizer.cpp:379-470), as
// the spec oracle transcribes it: each step's length from the sample's own
// distance to the camera, |p - cam|, the loop's exit on the sample's
// distance along the chord, dot(p - far point, chord direction), against
// the chord and the last step, and where the reference keeps C++ doubles
// beside Qt's float vectors (the ellipsoid's quadratic, the step, the exit
// sum, vector lengths) the kernel computes in double too, with the scene's
// own double ray step and least step (each page's float plus its low word,
// the page's last two entries). Whether a ray takes its last sample by the
// camera, where the presets' stars, disks and dust are densest, turns on
// the last bits of that bookkeeping: the TPU kernel's accumulated path
// length (|p - cam| = -t0 - tacc, exit on tacc) put the irregular and
// dusty_disk presets 6-7 uint8 LSB from the oracle on 190-355 pixels at
// 512^2, the reference's recurrence in float 3-6 LSB on 13-18, its doubles
// with float steps 3-6 LSB on 3-6; with the scene's steps every preset is
// within 1 LSB of the oracle.
//
// Work distribution: persistent warps. The grid is the resident blocks of
// the card (blocks per SM from the occupancy query times the SMs, capped
// by the work); each block stages the noise table, the structure table and
// the page in shared memory once (the tables are indexed by data, so
// __constant__ would serialize), and each warp then takes 32-ray tiles from
// a per-launch counter in device memory until the launch's tiles run out:
// lane 0 adds one, a shuffle hands the tile to the warp. Per-ray cost
// varies ~3x between tiles, so a fixed grid of blocks ends with a tail of
// slow blocks on an otherwise idle card; pulling tiles keeps every resident
// warp busy to the end. A frame tile is 8 x 4 pixels (neighbouring rays
// take similar paths, so the lanes of a warp finish together), enumerated
// over (frame, tile row, tile col); rows come from the page's row0, so one
// body serves the still frame (K1), a row band (K5: the band's rows at its
// row offset, _compiled_band :1243-1291 with _set_row0 :996-1000) and a
// batch of frames of one structure (K4, _compiled_batch :1294-1321). A
// batch has a page per frame: each warp keeps its own copy of the page of
// its tile's frame in shared memory and reloads it when a tile of another
// frame comes. A ray-list tile (K6) is 32 consecutive rays of an (N, 3)
// direction list, used as given; the TPU's padding of the list to
// (32, 128) tiles was a tiling constraint and is replaced by the i < N
// check. A zero direction has A = B = 0, so its discriminant is not
// positive and the ray leaves before the loop. Lanes past the frame, the
// band's rows or the list stay in the warp for the next shuffle and write
// nothing; rows of a band past the frame's last row write 0.
//
// The progressive frame (K5's render_progressive_pallas, :1526-1618, which
// runs _compiled_band once a band to get progress out of the TPU's grid) is
// one launch here: march_progressive_kernel marches the whole frame padded
// to its bands, tiles in the still's order, and reports each band while it
// runs. A warp counts each finished tile in its band's device counter; the
// warp that finishes a band sets the band's flag in pinned host memory,
// which the host polls (gamer_progress_wait) to run that band's epilogue
// and progress tick while later bands are marched; an abort word in the
// same memory, read after each tile, stops the launch. A lone band filled
// under half the card (64 blocks for 512 tiles at 512^2), so 16 launches
// of one band took 3.7 x the still's time (PERF.md).
//
// One frame or a batch over several cards (S1, _compiled_rowshard
// :1124-1187, which gives each chip one contiguous slab of rows; S2,
// _compiled_batch_rowshard :1190-1240 and the batch shard_map, which give
// each chip whole frames, padded to a multiple of the chips, and row
// slabs): march_dealt_kernel marches one mesh entry's share of a frame,
// march_dealt_stack_kernel of every frame of a page stack, the tile rows
// first + k * stride (on n cards,
// card i's rows i, i + n, i + 2n, ...; the first row comes as each page's
// row0, as a band's does), each across the whole width, into a compact
// strip stack that the host places into the frames. A ray's cost
// is set by its raw-noise evaluations, which vary ~2.8x between the disk's
// rows and the edge's while the samples vary ~3 %, so contiguous slabs
// gave four cards shares up to ~1.3x their mean, and whole frames leave
// cards idle or marching pad frames when the batch does not tile them;
// dealt tile rows give every card the same mix of rows of every frame,
// for any view and any batch. Entries that name one card cut its rows
// into contiguous runs (cuda_render.deal_plan). The ray list (S3) is dealt
// the same way by its wrapper, in 32-ray tiles, through march_rays_kernel
// as it is.
//
// Noise kinds. The raw noise backend (simplex, perlin, iq) is the same for
// every component of a scene; it is a template parameter of both kernels
// and of everything between them and the noise, so each kind is its own
// instantiation, chosen by the launch, and stages only its own lookup
// table (noise.cuh: the paired simplex tables, the paired Perlin
// permutation; for iq the address of the hash table, which fill_iq_table
// writes once per device and the loads read through L2).
//
// Bound. Instruction issue and the instruction cache, then the SFU: exp,
// pow, sin/cos and sqrt per sample and ~20 raw noise evaluations per step
// on the default spiral, every division an IEEE one. Measured on the H100
// (PERF.md): 50 % more resident warps bought 2-9 %, and two raw
// evaluations in flight per octave cost 13-43 %, so the warps are not
// waiting on latency; one shared copy of the octave combinators in place
// of a copy inlined at each call site ran 14-18 % faster. So
// the combinators are single non-inlined copies (noise.cuh), the lookup
// chain is shortened, and the register budget (MIN_BLOCKS) is set by a
// measured sweep. Device memory traffic is ~12 B per pixel out plus a few
// KB of page and tables per block.
//
// Numerics. Built with -fmad=false and without --use_fast_math, so every
// a*b+c rounds twice as in the JAX expressions (contraction alone moves
// frames by ~1 uint8 LSB). Vectors are normalized as QVector3D does: the
// double norm rounded to float, then an IEEE division. Masked updates are
// selects, never multiplies by a mask, and min/max propagate NaN like
// jnp.maximum/jnp.minimum. A ray's
// operations do not depend on the launch form, its tile or its warp, so a
// band, a batch frame or a listed ray is bit-equal to the still's ray.
#include <cuda_runtime.h>

#include <chrono>
#include <thread>

#include "noise.cuh"

namespace gamer {

constexpr int MAX_ITERS = 131072;

// Scalar page offsets (engine/cuda_render.py::_build_layout).
constexpr int G_CAMERA = 16, G_RAY_STEP = 19, G_MIN_STEP = 20, G_ROW0 = 21;
constexpr int I_POS = 0, I_AXIS_INV = 3, I_AXIS_X = 6, I_WINDING_B = 7,
              I_WINDING_N = 8, I_ARMS = 9, I_ROTMAT = 13, I_TWIRL = 17,
              I_ORIENT = 20, I_ISCALE = 23;
constexpr int C_STRENGTH = 0, C_ARM = 1, C_Z0 = 2, C_R0 = 3, C_INNER = 4,
              C_DELTA = 5, C_WINDING = 6, C_SCALE = 7, C_NOFF = 8,
              C_NTILT = 9, C_KS = 10, C_SPEC = 11, C_RIDGED_W = 14;

// Structure table (engine/cuda_render.py::_build_table).
constexpr int T_N_INST = 0, T_DITHER = 1, T_HDR = 3;  // [2]: noise kind
constexpr int T_INST = 4;  // n_comps, max_arms, page_off, comp_row
constexpr int T_COMP = 9;  // cid, arm_en, wind_en, star_extra, oct10, oct9,
                           // oct4, n_ridged, page_off

enum { CID_BULGE = 0, CID_DISK = 1, CID_DUST = 2, CID_DUST2 = 3,
       CID_DUST_POSITIVE = 4, CID_STARS = 5, CID_STARS_SMALL = 6 };

struct Quat { float w, x, y, z; };

__device__ __forceinline__ void quat_rotate(const Quat& q, float vx, float vy,
                                            float vz, float& ox, float& oy,
                                            float& oz) {
    float uvx = q.y * vz - q.z * vy;
    float uvy = q.z * vx - q.x * vz;
    float uvz = q.x * vy - q.y * vx;
    float uuvx = q.y * uvz - q.z * uvy;
    float uuvy = q.z * uvx - q.x * uvz;
    float uuvz = q.x * uvy - q.y * uvx;
    ox = vx + 2.0f * (q.w * uvx + uuvx);
    oy = vy + 2.0f * (q.w * uvy + uuvy);
    oz = vz + 2.0f * (q.w * uvz + uuvz);
}

// Rotation by angle t*pi about the unit twirl axis (galaxycomponent.h:86-90).
__device__ __forceinline__ void twirl(const float* ax, float t, float vx,
                                      float vy, float vz, float& ox, float& oy,
                                      float& oz) {
    float half = t * F32(PI * 0.5);
    float s = sinf(half);
    float c = cosf(half);
    Quat q{c, ax[0] * s, ax[1] * s, ax[2] * s};
    quat_rotate(q, vx, vy, vz, ox, oy, oz);
}

// galaxycomponent.h:156-165.
__device__ __forceinline__ float get_winding(float rad, float wb, float wn) {
    float r = rad + F32(0.05);
    return atan_f32(expf(F32(-0.25) / (0.5f * r)) / wb) * 2.0f * wn;
}

__device__ __forceinline__ float find_difference(float t1, float t2) {
    float d = t1 - t2;
    float v = fabsf(d);
    v = nan_min(v, fabsf(d - F32(2 * PI)));
    v = nan_min(v, fabsf(d + F32(2 * PI)));
    v = nan_min(v, fabsf(d - F32(4 * PI)));
    v = nan_min(v, fabsf(d + F32(4 * PI)));
    return v;
}

// galaxycomponent.h:120-146: the literal pow ladder (pow(negative,
// integral) is finite and may win), std::max NaN order.
__device__ float arm_value(const float* ip, const float* cp, int max_arms,
                           const Quat& rot, float radius, float Px, float Py,
                           float Pz) {
    float rx, ry, rz;
    quat_rotate(rot, Px, Py, Pz, rx, ry, rz);
    float theta = atan2_f32(rx, rz) + cp[C_DELTA];
    float ww = get_winding(radius, ip[I_WINDING_B], ip[I_WINDING_N]);
    float arm15 = cp[C_ARM] * 15.0f;
    float val = 0.0f;
    for (int a = 0; a < max_arms; ++a) {
        float v = fabsf(find_difference(ww, -theta + ip[I_ARMS + a])) / F32(PI);
        float arm_v = powf(1.0f - v, arm15);
        val = (a == 0 || arm_v > val) ? arm_v : val;
    }
    return val;
}

struct Ray {
    float I0, I1, I2;
};

// One non-bulge component at one sample (galaxycomponent.cpp:45-88 and
// the galaxycomponents.cpp class kernels).
template <int KIND>
__device__ void apply_component(const int* ct,
                                const float* ip, const float* cp, int max_arms,
                                const Quat& rot, float px, float py, float pz,
                                float Px, float Py, float Pz, float dott,
                                float radius, float weight, float ray_step,
                                Ray& I) {
    const float z0 = cp[C_Z0];
    const float r0 = cp[C_R0];
    // conservative trigger (pallas_render.py:705-720): h <= 2 and the
    // widened radial cutoff; a superset of the exact gates below
    float h = fabsf(dott / z0);
    float r_thr = r0 > 0.0f ? r0 * F32(2.2552) : F32(3.4e38);
    if (!((h <= 2.0f) && (radius < r_thr))) return;

    float eh = expf(h);
    float sech = 2.0f / (eh + 1.0f / eh);
    float z = h > 2.0f ? 0.0f : sech * sech;
    float ri = expf(-radius / (r0 * 0.5f));
    float intensity = qt_clamp(ri - F32(0.01), 0.0f, 1.0f);
    intensity = intensity > F32(0.1) ? F32(0.1) : intensity;
    if (!((z > F32(0.01)) && (intensity > F32(0.001)))) return;

    // smoothstep(0, inner, radius) with the raw division: inner == 0 gives
    // inf/NaN -> clamp -> 1, inner < 0 gives 0
    float t_s = qt_clamp(radius / cp[C_INNER], 0.0f, 1.0f);
    float sib = t_s * t_s * (3.0f - 2.0f * t_s);
    float scale_inner = (sib * sib) * (sib * sib);

    const int arm_en = ct[1], wind_en = ct[2];
    float arm_val = 1.0f, winding = 0.0f;
    if (arm_en) {
        arm_val = arm_value(ip, cp, max_arms, rot, radius, Px, Py, Pz);
        if (wind_en)
            winding = get_winding(radius, ip[I_WINDING_B], ip[I_WINDING_N])
                      * cp[C_WINDING];
    }
    const float iscale = ip[I_ISCALE];
    float val = cp[C_STRENGTH] * scale_inner * arm_val * z * intensity * iscale;
    float ival = val * weight;
    if (!(ival > F32(0.0005))) return;

    const float ks = cp[C_KS], cscale = cp[C_SCALE];
    const float noff = cp[C_NOFF], ntilt = cp[C_NTILT];
    const float* spec = cp + C_SPEC;
    const float* tw = ip + I_TWIRL;
    const int cid = ct[0];
    float tx, ty, tz;

    float cval;  // this sample's noise factor
    if (cid == CID_DUST) {
        twirl(tw, winding, px, py, pz, tx, ty, tz);
        cval = octave_noise_3d<KIND>(ct[5], ks, cscale * F32(0.1), tx, ty, tz);
        cval = nan_max(cval - noff, 0.0f);
        cval = qt_clamp(powf(5.0f * cval, ntilt), -10.0f, 10.0f);
    } else if (cid == CID_DUST2 || cid == CID_DUST_POSITIVE) {
        twirl(tw, winding, px, py, pz, tx, ty, tz);
        cval = nan_max(ridged_mf<KIND>(tx * cscale, ty * cscale, tz * cscale,
                                 cp + C_RIDGED_W, ct[7], 2.5f, noff, ntilt),
                       0.0f);
    } else if (cid == CID_DISK) {
        twirl(tw, winding, px, py, pz, tx, ty, tz);
        cval = fabsf(octave_noise_3d<KIND>(ct[4], ks, cscale * F32(0.1),
                                     tx, ty, tz));
        cval = nan_max(cval, F32(0.01));
        cval = powf(cval, ntilt);
        cval = cval + noff;
        if (!(cval >= 0.0f)) return;
    } else if (cid == CID_STARS) {
        float freq = (F32(0.01) * cscale) * 100.0f;
        float perlin = fabsf(octave_noise_3d<KIND>(ct[4], ks, freq, px, py, pz));
        float add_n = 0.0f;
        if (ct[3]) {  // star_extra
            twirl(tw, winding, px, py, pz, tx, ty, tz);
            add_n = noff * octave_noise_3d<KIND>(ct[6], -2.0f, F32(2.0 * 0.1),
                                           tx, ty, tz);
            twirl(tw, winding * 0.5f, px, py, pz, tx, ty, tz);
            add_n = add_n + 0.5f * noff * octave_noise_3d<KIND>(
                ct[6], -2.0f, F32(4.0 * 0.1), tx, ty, tz);
        }
        cval = fabsf(powf(perlin + 1.0f + add_n, ntilt));
    } else if (cid == CID_STARS_SMALL) {
        // seeded position-hash sparkle (engine.render._sparkle_hash)
        int hu = abs_i32(hash3_i32(__float_as_int(px), __float_as_int(py),
                                   __float_as_int(pz)));
        int scale_i = max(__float2int_rz(cscale), 1);
        if (floor_mod(hu, scale_i) != 0) return;
        float dval = (float)floor_mod(hu >> 8, 10);
        cval = powf(dval, ntilt);
    } else {
        return;  // unknown class: no-op (the reference skips it)
    }
    if (cid == CID_DUST || cid == CID_DUST2) {
        // absorbers multiply the accumulator
        float e = -cval * ival * F32(0.01);
        I.I0 = I.I0 * expf(e * spec[0]);
        I.I1 = I.I1 * expf(e * spec[1]);
        I.I2 = I.I2 * expf(e * spec[2]);
        return;
    }
    float add = ival * cval * ray_step;
    I.I0 = I.I0 + spec[0] * add;
    I.I1 = I.I1 + spec[1] * add;
    I.I2 = I.I2 + spec[2] * add;
}

// Bulge (galaxycomponents.cpp:5-39): no gating, every active sample.
__device__ __forceinline__ void apply_bulge(const float* ip, const float* cp,
                                            const Quat& rot, float px, float py,
                                            float pz, float weight,
                                            float ray_step, Ray& I) {
    float bx, by, bz;
    quat_rotate(rot, px, py, pz, bx, by, bz);
    float rad = (sqrtf(bx * bx + by * by + bz * bz) + F32(0.01)) * cp[C_R0]
                + F32(0.01);
    float ival = (cp[C_STRENGTH] * weight)
                 * (powf(rad, F32(-0.855)) * expf(-sqrtf(sqrtf(rad))) - F32(0.05))
                 * ip[I_ISCALE];
    ival = ival < 0.0f ? 0.0f : ival;
    float add = ival * ray_step;
    I.I0 = I.I0 + cp[C_SPEC + 0] * add;
    I.I1 = I.I1 + cp[C_SPEC + 1] * add;
    I.I2 = I.I2 + cp[C_SPEC + 2] * add;
}

// QVector3D::length: the double norm of float components, rounded to float.
__device__ __forceinline__ float length_qt(float x, float y, float z) {
    const double xd = x, yd = y, zd = z;
    return (float)sqrt((xd * xd + yd * yd) + zd * zd);
}

// QVector3D::normalized: v / length, v itself where the length is within
// 1e-5 of 1, and 0 where it is within 1e-5 of 0.
__device__ __forceinline__ void normalize_qt(float& x, float& y, float& z) {
    const float n = length_qt(x, y, z);
    if (fabsf(n) <= F32(1e-5)) {
        x = y = z = 0.0f;
    } else if (!(fabsf(n - 1.0f) <= F32(1e-5))) {
        x = x / n;
        y = y / n;
        z = z / n;
    }
}

// Util::clamp in double: max(lo, min(hi, v)); a NaN becomes hi.
__device__ __forceinline__ double qt_clamp_d(double v, double lo, double hi) {
    double r = v < hi ? v : hi;
    return r > lo ? r : lo;
}

// Intersect and march one instance (rasterizer.cpp:379-483).
template <int KIND>
__device__ void march_instance(const int* tab,
                               const float* pg, int n_page, const int* it,
                               bool dither, float dx, float dy, float dz,
                               Ray& I) {
    const int n_comps = it[0], max_arms = it[1];
    const float* ip = pg + it[2];
    const int* ct0 = tab + it[3];
    const float ray_step = pg[G_RAY_STEP];
    const float min_step = pg[G_MIN_STEP];

    const float cx = pg[G_CAMERA + 0] - ip[I_POS + 0];
    const float cy = pg[G_CAMERA + 1] - ip[I_POS + 1];
    const float cz = pg[G_CAMERA + 2] - ip[I_POS + 2];
    const float ivx = ip[I_AXIS_INV + 0];
    const float ivy = ip[I_AXIS_INV + 1];
    const float ivz = ip[I_AXIS_INV + 2];

    // the ellipsoid (util.h:66-98): float products, the quadratic in double
    const float rox = cx * ivx, roy = cy * ivy, roz = cz * ivz;
    const double A = (double)((dx * (dx * ivx) + dy * (dy * ivy))
                              + dz * (dz * ivz));
    const double B = 2.0 * (double)((dx * rox + dy * roy) + dz * roz);
    const double C = (double)((cx * rox + cy * roy) + cz * roz) - 1.0;
    const double Sdisc = B * B - 4.0 * A * C;
    const bool hit = Sdisc > 0.0;
    const double sq = sqrt(hit ? Sdisc : 0.0);
    const double t0 = (-B - sq) / (2.0 * A);
    const double t1 = (-B + sq) / (2.0 * A);
    // behind-camera rules (rasterizer.cpp:396-403)
    if (!hit || ((t0 > 0.0) && (t1 > 0.0))) return;

    const float t0f = (float)t0, t1f = (float)t1;
    const float o1x = cx + dx * t0f, o1y = cy + dy * t0f, o1z = cz + dz * t0f;
    const bool near_cam = t1 > 0.0;
    const float o2x = near_cam ? cx : cx + dx * t1f;
    const float o2y = near_cam ? cy : cy + dy * t1f;
    const float o2z = near_cam ? cz : cz + dz * t1f;
    const float fx = o1x - o2x, fy = o1y - o2y, fz = o1z - o2z;
    const float length = length_qt(fx, fy, fz);
    // a chord too short to have a direction is not marched (the
    // reference's loop would not advance on it)
    if (!(length > F32(1e-5))) return;
    float mdx = fx, mdy = fy, mdz = fz;
    normalize_qt(mdx, mdy, mdz);
    // the chord's direction from the far point toward the camera side
    const float lx = -mdx, ly = -mdy, lz = -mdz;

    float px = o1x, py = o1y, pz = o1z;
    if (dither) {
        // per-ray start jitter by a hash of the direction bits, a fraction
        // of the first step (at the far point's distance -t0)
        int hsh = hash3_i32(__float_as_int(dx), __float_as_int(dy),
                            __float_as_int(dz));
        float h01 = (float)floor_mod(abs_i32(hsh), 8192) * F32(1.0 / 8192.0);
        float delta = nan_min(
            qt_clamp(-t0f * ray_step, min_step, F32(0.01)) * h01, length);
        px = o1x - mdx * delta;
        py = o1y - mdy * delta;
        pz = o1z - mdz * delta;
    }
    // the step's bookkeeping in double, as the reference's (C++ double
    // scalars beside float vectors): the ray step and the least step as
    // the scene gave them, each its float plus its low word, the page's
    // last two entries
    const double rs = (double)ray_step + (double)pg[n_page - 2];
    const double ms = (double)min_step + (double)pg[n_page - 1];
    double steppr = rs;

    const float ox = ip[I_ORIENT + 0], oy = ip[I_ORIENT + 1],
                oz = ip[I_ORIENT + 2];
    const float axis_x = ip[I_AXIS_X];
    const Quat rot{ip[I_ROTMAT + 0], ip[I_ROTMAT + 1], ip[I_ROTMAT + 2],
                   ip[I_ROTMAT + 3]};

    for (int iter = 0; iter < MAX_ITERS; ++iter) {
        // loop exit (rasterizer.cpp:447): the sample's distance along the
        // chord vs the chord and the last step
        const float ux = px - o1x, uy = py - o1y, uz = pz - o1z;
        const float along = (ux * lx + uy * ly) + uz * lz;
        if ((double)along >= (double)length + steppr) break;
        // the step from the sample's distance to the camera
        // (rasterizer.cpp:449)
        const double step_d = qt_clamp_d(
            (double)length_qt(px - cx, py - cy, pz - cz) * rs, ms, 0.01);
        const float step = (float)step_d;
        const float weight = (float)(step_d * 200.0);

        float dott = px * ox + py * oy + pz * oz;
        float Px = px - ox * dott, Py = py - oy * dott, Pz = pz - oz * dott;
        float radius = sqrtf(Px * Px + Py * Py + Pz * Pz) / axis_x;

        // strictly in list order: emission adds, absorption multiplies
        for (int c = 0; c < n_comps; ++c) {
            const int* ct = ct0 + c * T_COMP;
            const float* cp = pg + ct[8];
            if (ct[0] == CID_BULGE)
                apply_bulge(ip, cp, rot, px, py, pz, weight, ray_step, I);
            else
                apply_component<KIND>(ct, ip, cp, max_arms, rot, px, py, pz,
                                Px, Py, Pz, dott, radius, weight, ray_step, I);
        }

        // advance (rasterizer.cpp:467-470), then RasterPixel::Floor:
        // negatives and NaN to 0
        px = px - mdx * step;
        py = py - mdy * step;
        pz = pz - mdz * step;
        steppr = step_d;
        I.I0 = I.I0 >= 0.0f ? I.I0 : 0.0f;
        I.I1 = I.I1 >= 0.0f ? I.I1 : 0.0f;
        I.I2 = I.I2 >= 0.0f ? I.I2 : 0.0f;
    }
}

// Every instance of the scene for one ray, far to near; I carries across.
template <int KIND>
__device__ __forceinline__ void march_scene(const int* tab,
                                            const float* pg, int n_page,
                                            float dx, float dy, float dz,
                                            Ray& I) {
    const bool dither = tab[T_DITHER] != 0;
    for (int gi = 0; gi < tab[T_N_INST]; ++gi)
        march_instance<KIND>(tab, pg, n_page, tab + T_HDR + gi * T_INST,
                             dither, dx, dy, dz, I);
}

// Threads of a block, and the blocks each SM must be able to hold at once:
// the register budget (ptxas caps a thread's registers at
// 65536 / (BLOCK_THREADS * MIN_BLOCKS), here 80, for 24 resident warps).
// Chosen by a measured sweep on the H100 (PERF.md): against 128 x 4
// (16 warps, 117 registers, no spills) and 128 x 6 (24 warps, 80), 256 x 3
// ran K1, K4 and K6 fastest for every noise kind despite ~100 bytes of
// spills; a lone 32-row band (K5) runs faster in 128-thread blocks.
constexpr int BLOCK_THREADS = 256;
constexpr int MIN_BLOCKS = 3;
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
// A frame tile: TILE_W x TILE_H pixels, one per lane.
constexpr int TILE_W = 8, TILE_H = 4;

// Dynamic shared memory of a launch: [structure table | page slots]; one
// page slot for a launch of one page, one per warp for a batch. (The noise
// table is the static noise_smem.)
__host__ __device__ constexpr size_t smem_bytes(int n_table, int n_page,
                                                int slots) {
    return (size_t)(n_table + slots * n_page) * 4;
}

// The next tile of the launch for the whole warp (all 32 lanes call it).
__device__ __forceinline__ unsigned next_tile(unsigned* counter, int lane) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(counter, 1u);
    return __shfl_sync(0xffffffffu, t, 0);
}

// The progressive frame (K5 as one launch). Its rows are n_bands bands of
// band_tile_rows tile rows each, so the tiles of band b are the tile rows
// [b, b + 1) * band_tile_rows, taken in order from the tile counter like
// any frame's. A warp that finished a tile of band b counts it in
// done[b]; the warp that counts the band's last tile raises the band's
// word in host memory the device can reach (flags[b] = 1), which the host
// reads while the launch runs. Release order: every lane's stores, a
// device fence, the count; then, in the warp that completes the band, a
// system fence and the flag. The host reads a band's rows only after it
// saw the flag.
__device__ __forceinline__ void band_tile_done(unsigned* done,
                                               unsigned band_tiles,
                                               int* flag, int lane) {
    __threadfence();
    __syncwarp();
    if (lane == 0) {
        __threadfence();
        if (atomicAdd(done, 1u) + 1u == band_tiles) {
            __threadfence_system();
            *(volatile int*)flag = 1;
        }
    }
}

// The host's abort word, read by lane 0 after each tile (one read over
// the bus per tile) and handed to the warp: a set word stops the launch
// within one tile of each warp.
__device__ __forceinline__ bool aborted(const int* abort_word, int lane) {
    int a = 0;
    if (lane == 0) a = *(const volatile int*)abort_word;
    return __shfl_sync(0xffffffffu, a, 0) != 0;
}

// The persistent body of the kernels. RAYS false: n_frames frames of one
// structure, page f at pages + f * page_stride, rows [0, rows) at global
// rows row0 + [0, rows) into out (n_frames, rows, frame_size, 3). RAYS
// true: the n_rays directions dirs (n_rays, 3) from the one page's camera
// point into out (n_rays, 3). PROGRESS (one frame, row0 0, rows a whole
// number of bands of band_tile_rows tile rows): the band flags and the
// abort word above, with the band counts at counter + 1. DEALT (rows a
// whole number of tile rows): the launch's tile row ty of frame f is that
// frame's tile row row0 / TILE_H + ty * tile_row_stride, row0 frame f's
// page's as in every frame launch, so that the stride's product is all the
// DEALT instantiation adds to K1's code. STACK (DEALT, several frames):
// the walk takes the tile rows outermost, then the frames, then the
// columns. The flag and dealing code is compiled into the PROGRESS, DEALT
// and STACK instantiations alone, so the other kernels are the same code
// as without it.
template <int KIND, bool RAYS, bool PROGRESS = false, bool DEALT = false,
          bool STACK = false>
__device__ __forceinline__ void march_tiles(
    const float* __restrict__ pages, int n_page, int page_stride,
    int n_frames, const int* __restrict__ table, int n_table,
    const int* __restrict__ noise_g, const float* __restrict__ dirs,
    int n_rays, float* __restrict__ out, int frame_size, int rows,
    unsigned* __restrict__ counter, int band_tile_rows = 0,
    int* flags = nullptr, const int* abort_word = nullptr,
    int tile_row_stride = 1) {
    extern __shared__ int smem[];
    const int* tab = smem;
    float* slots = reinterpret_cast<float*>(smem + n_table);
    const int lane = threadIdx.x & 31;
    const bool one_page = n_frames == 1;
    float* pg = slots + (one_page ? 0 : (threadIdx.x >> 5) * n_page);

    stage_iq_pairs<KIND>(noise_g);
    for (int k = threadIdx.x; k < noise_table_size(KIND); k += BLOCK_THREADS)
        noise_smem[k] = noise_g[k];
    stage_perlin_grads<KIND>(noise_g, BLOCK_THREADS);
    for (int k = threadIdx.x; k < n_table; k += BLOCK_THREADS)
        smem[k] = table[k];
    if (one_page)
        for (int k = threadIdx.x; k < n_page; k += BLOCK_THREADS)
            slots[k] = pages[k];
    __syncthreads();

    const int tiles_x = (frame_size + TILE_W - 1) / TILE_W;
    const int per_frame = tiles_x * ((rows + TILE_H - 1) / TILE_H);
    const unsigned n_tiles = RAYS ? (unsigned)(((long long)n_rays + 31) / 32)
                                  : (unsigned)per_frame * n_frames;
    const float fsize = (float)frame_size;
    const float half = F32((double)frame_size * 0.5);
    int frame_in_slot = one_page ? 0 : -1;
    [[maybe_unused]] int done_band = -1;  // PROGRESS: the warp's last band
    for (;;) {
        if constexpr (PROGRESS) {
            // after each tile: count it, then look at the abort word (not
            // before the first: the first wave's ~3,000 reads at once
            // queue on the bus)
            if (done_band >= 0) {
                band_tile_done(counter + 1 + done_band,
                               (unsigned)(tiles_x * band_tile_rows),
                               flags + done_band, lane);
                if (aborted(abort_word, lane)) break;
            }
        }
        const unsigned t = next_tile(counter, lane);
        if (t >= n_tiles) break;
        if constexpr (RAYS) {
            const size_t i = (size_t)t * 32 + lane;
            if (i >= (size_t)n_rays) continue;
            const float dx = dirs[3 * i], dy = dirs[3 * i + 1],
                        dz = dirs[3 * i + 2];
            Ray I{0.0f, 0.0f, 0.0f};
            march_scene<KIND>(tab, pg, n_page, dx, dy, dz, I);
            const float fs = F32(0.01) / pg[G_RAY_STEP];
            out[3 * i] = I.I0 * fs;
            out[3 * i + 1] = I.I1 * fs;
            out[3 * i + 2] = I.I2 * fs;
        } else {
            // a dealt stack walks its tile rows outermost, then frames, then
            // columns: the launch's last wave is the last tile rows of every
            // frame, as a whole frame's is its bottom rows, not the whole
            // share of its last frame (PERF.md)
            int f, rem;
            if constexpr (STACK) {
                const int per_row = tiles_x * n_frames;
                const int ty_all = (int)(t / (unsigned)per_row);
                const int r = (int)t - ty_all * per_row;
                f = r / tiles_x;
                rem = ty_all * tiles_x + (r - f * tiles_x);
            } else {
                f = (int)(t / (unsigned)per_frame);
                rem = (int)t - f * per_frame;
            }
            const int ty = rem / tiles_x;
            if constexpr (PROGRESS) done_band = ty / band_tile_rows;
            if (f != frame_in_slot) {  // warp-uniform: t is the warp's
                __syncwarp();
                const float* src = pages + (size_t)f * page_stride;
                for (int k = lane; k < n_page; k += 32) pg[k] = src[k];
                __syncwarp();
                frame_in_slot = f;
            }
            const int row = ty * TILE_H + lane / TILE_W;
            const int col = (rem - ty * tiles_x) * TILE_W + lane % TILE_W;
            if (row >= rows || col >= frame_size) continue;

            // ray from the inverse view-projection (gamercamera.cpp:210-217);
            // row0 is an exact integer in f32, so row0 + row is
            // bit-identical to the whole frame's row index
            // (pallas_render.py:338-343); so is a dealt tile row's offset
            // from the launch's first
            const int frame_row =
                DEALT ? ty * tile_row_stride * TILE_H + lane / TILE_W : row;
            const float jrow = pg[G_ROW0] + (float)frame_row;
            const float icol = (float)col;
            // (the screen point in double, rounded once; the direction
            // normalized as QVector3D::normalized)
            const float xx = (float)((double)icol / (double)half - 1.0);
            const float yy = (float)((double)jrow / (double)half - 1.0);
            float w[3];
            for (int r = 0; r < 3; ++r)
                w[r] = pg[4 * r] * xx - pg[4 * r + 1] * yy + pg[4 * r + 2]
                       + pg[4 * r + 3];
            float dx = w[0], dy = w[1], dz = w[2];
            normalize_qt(dx, dy, dz);

            // rows of a band past the frame's last row stay 0 (the TPU's
            // padding)
            Ray I{0.0f, 0.0f, 0.0f};
            if (jrow < fsize && icol < fsize)
                march_scene<KIND>(tab, pg, n_page, dx, dy, dz, I);
            // final scale (rasterizer.cpp:409)
            const float fs = F32(0.01) / pg[G_RAY_STEP];
            float* o = out + (((size_t)f * rows + row) * frame_size + col) * 3;
            o[0] = I.I0 * fs;
            o[1] = I.I1 * fs;
            o[2] = I.I2 * fs;
        }
    }
}

// K1, K5, K4: frames of camera rays.
template <int KIND>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
march_kernel(const float* __restrict__ pages, int n_page, int page_stride,
             int n_frames, const int* __restrict__ table, int n_table,
             const int* __restrict__ noise_g, float* __restrict__ out,
             int frame_size, int rows, unsigned* __restrict__ counter) {
    march_tiles<KIND, false>(pages, n_page, page_stride, n_frames, table,
                             n_table, noise_g, nullptr, 0, out, frame_size,
                             rows, counter);
}

// K6: ray i of an explicit (n_rays, 3) direction list from the page's
// camera point; no frame mask, inv_vp and row0 unused.
template <int KIND>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
march_rays_kernel(const float* __restrict__ page, int n_page,
                  const int* __restrict__ table, int n_table,
                  const int* __restrict__ noise_g,
                  const float* __restrict__ dirs, int n_rays,
                  float* __restrict__ out, unsigned* __restrict__ counter) {
    march_tiles<KIND, true>(page, n_page, n_page, 1, table, n_table, noise_g,
                            dirs, n_rays, out, 0, 0, counter);
}

// S1 dealt across a mesh: the n_tile_rows tile rows row0 / TILE_H + k *
// tile_row_stride (k < n_tile_rows; row0 the page's, a multiple of TILE_H
// for a share of a frame) of a frame_size frame, each across the whole
// width, into out (n_tile_rows * TILE_H, frame_size, 3) in that order;
// every ray is the still's, rows past the frame are 0.
template <int KIND>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
march_dealt_kernel(const float* __restrict__ page, int n_page,
                   const int* __restrict__ table, int n_table,
                   const int* __restrict__ noise_g, float* __restrict__ out,
                   int frame_size, int tile_row_stride, int n_tile_rows,
                   unsigned* __restrict__ counter) {
    march_tiles<KIND, false, false, true>(
        page, n_page, n_page, 1, table, n_table, noise_g, nullptr, 0, out,
        frame_size, n_tile_rows * TILE_H, counter, 0, nullptr, nullptr,
        tile_row_stride);
}

// S2 dealt across a mesh: march_dealt_kernel's tile rows of each of
// n_frames > 1 frames of one structure (frame f's page at pages + f *
// n_page, its own row0), into out (n_frames, n_tile_rows * TILE_H,
// frame_size, 3). A kernel of its own, so that S1's one frame keeps its
// code.
template <int KIND>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
march_dealt_stack_kernel(const float* __restrict__ pages, int n_page,
                         int n_frames, const int* __restrict__ table,
                         int n_table, const int* __restrict__ noise_g,
                         float* __restrict__ out, int frame_size,
                         int tile_row_stride, int n_tile_rows,
                         unsigned* __restrict__ counter) {
    march_tiles<KIND, false, false, true, true>(
        pages, n_page, n_page, n_frames, table, n_table, noise_g, nullptr, 0,
        out, frame_size, n_tile_rows * TILE_H, counter, 0, nullptr, nullptr,
        tile_row_stride);
}

// K5 as one launch: the progressive frame of n_bands bands of
// band_tile_rows * TILE_H rows from row 0 (the page's row0 must be 0), every
// ray the still's; rows past the frame are 0. counters[0] is the tile
// counter and counters[1 + b] band b's count of finished tiles (all 0 at
// the launch); flags (n_bands) and abort_word are host memory the device
// reaches (see band_tile_done and aborted).
template <int KIND>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS)
march_progressive_kernel(const float* __restrict__ page, int n_page,
                         const int* __restrict__ table, int n_table,
                         const int* __restrict__ noise_g,
                         float* __restrict__ out, int frame_size,
                         int band_tile_rows, int n_bands,
                         unsigned* __restrict__ counters, int* flags,
                         const int* abort_word) {
    march_tiles<KIND, false, true>(
        page, n_page, n_page, 1, table, n_table, noise_g, nullptr, 0, out,
        frame_size, n_bands * band_tile_rows * TILE_H, counters,
        band_tile_rows, flags, abort_word);
}

// The iq hash table (noise.cuh: IQ_TABLE_PAIRS float2): thread j writes
// pair j with the march's own iq_hash. One launch per device.
__global__ void fill_iq_table(float2* __restrict__ tab) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= IQ_TABLE_PAIRS) return;
    const float n = (float)(j - IQ_TABLE_R);
    tab[j] = make_float2(iq_hash(n), iq_hash(n + 1.0f));
}

// The table's exhaustive check. For each pair j: the stored pair against
// iq_hash at its two arguments (bad[0] counts the pairs that differ in a
// bit). For each integer n in [lo, lo + n_args): iq_corners against the
// eight iq_hash calls of the sines (bad[1] counts the n whose corners
// differ in a bit, bad[2] the n that took iq_corners_far).
__global__ void check_iq_table(const float2* __restrict__ tab, int lo,
                               int n_args, unsigned* bad) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k < IQ_TABLE_PAIRS) {
        const float n = (float)(k - IQ_TABLE_R);
        const float2 t = tab[k];
        if (__float_as_uint(t.x) != __float_as_uint(iq_hash(n))
            || __float_as_uint(t.y) != __float_as_uint(iq_hash(n + 1.0f)))
            atomicAdd(bad, 1u);
    }
    if (k >= n_args) return;
    const float n = (float)(lo + k);
    const IqCorners g = iq_corners(tab, n);
    const float got[8] = {g.a.x, g.a.y, g.b.x, g.b.y,
                          g.c.x, g.c.y, g.d.x, g.d.y};
    const float off[8] = {0.0f, 1.0f, 157.0f, 158.0f,
                          113.0f, 114.0f, 270.0f, 271.0f};
    bool same = true;
    for (int i = 0; i < 8; ++i)
        same &= __float_as_uint(got[i]) == __float_as_uint(iq_hash(n + off[i]));
    if (!same) atomicAdd(bad + 1, 1u);
    if (!(fabsf(n) <= (float)IQ_TABLE_R)) atomicAdd(bad + 2, 1u);
}

// The perlin gradient table's check (noise.cuh: the perlin kernels' table
// is the paired permutation, then PERLIN_GRADS float4 gradients). Each
// block stages the gradients as the perlin kernels do; for each idx in
// [0, n_idx): bad[0] counts the stored entries (idx < PERLIN_GRADS) whose
// (gx, gy, gz, 0) differ in a bit from perlin_grad_hashed(idx), bad[1] the
// idx whose perlin_grad_dot at the unit offsets (1,0,0), (0,1,0), (0,0,1),
// which return each component exactly, differs from the hash's.
__global__ void check_perlin_grads(const int* __restrict__ table, int n_idx,
                                   unsigned* bad) {
    stage_perlin_grads<NOISE_PERLIN>(table, blockDim.x);
    __syncthreads();
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n_idx) return;
    const float3 h = perlin_grad_hashed(idx);
    if (idx < PERLIN_GRADS) {
        const float4 t = reinterpret_cast<const float4*>(
            table + PERLIN_PERM_WORDS)[idx];
        if (__float_as_uint(t.x) != __float_as_uint(h.x)
            || __float_as_uint(t.y) != __float_as_uint(h.y)
            || __float_as_uint(t.z) != __float_as_uint(h.z)
            || __float_as_uint(t.w) != 0u)
            atomicAdd(bad, 1u);
    }
    const float gx = perlin_grad_dot(idx, 1.0f, 0.0f, 0.0f);
    const float gy = perlin_grad_dot(idx, 0.0f, 1.0f, 0.0f);
    const float gz = perlin_grad_dot(idx, 0.0f, 0.0f, 1.0f);
    if (__float_as_uint(gx) != __float_as_uint(h.x)
        || __float_as_uint(gy) != __float_as_uint(h.y)
        || __float_as_uint(gz) != __float_as_uint(h.z))
        atomicAdd(bad + 1, 1u);
}

// A block's shared memory above 48 KB, static and dynamic together, has to
// be granted to the kernel first (the perlin kernels hold 20 KB of static
// shared memory, noise_smem and perlin_grads; the others at most 4 KB).
template <typename Kernel>
static cudaError_t reserve_smem(Kernel kernel, size_t smem) {
    cudaFuncAttributes attr{};
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.sharedSizeBytes + smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KIND>
static int launch_frames(const float* pages, int n_page, int page_stride,
                         int n_frames, const int* table, int n_table,
                         const int* noise, float* out, int frame_size,
                         int rows, int grid, unsigned* counter,
                         cudaStream_t stream) {
    const size_t smem =
        smem_bytes(n_table, n_page, n_frames == 1 ? 1 : BLOCK_WARPS);
    cudaError_t e = reserve_smem(march_kernel<KIND>, smem);
    if (e != cudaSuccess) return (int)e;
    march_kernel<KIND><<<grid, BLOCK_THREADS, smem, stream>>>(
        pages, n_page, page_stride, n_frames, table, n_table, noise, out,
        frame_size, rows, counter);
    return (int)cudaGetLastError();
}

template <int KIND>
static int launch_rays(const float* page, int n_page, const int* table,
                       int n_table, const int* noise, const float* dirs,
                       int n_rays, float* out, int grid, unsigned* counter,
                       cudaStream_t stream) {
    const size_t smem = smem_bytes(n_table, n_page, 1);
    cudaError_t e = reserve_smem(march_rays_kernel<KIND>, smem);
    if (e != cudaSuccess) return (int)e;
    march_rays_kernel<KIND><<<grid, BLOCK_THREADS, smem, stream>>>(
        page, n_page, table, n_table, noise, dirs, n_rays, out, counter);
    return (int)cudaGetLastError();
}

template <int KIND>
static int launch_dealt(const float* pages, int n_page, int n_frames,
                        const int* table, int n_table, const int* noise,
                        float* out, int frame_size, int tile_row_stride,
                        int n_tile_rows, int grid, unsigned* counter,
                        cudaStream_t stream) {
    if (n_frames == 1) {
        const size_t smem = smem_bytes(n_table, n_page, 1);
        cudaError_t e = reserve_smem(march_dealt_kernel<KIND>, smem);
        if (e != cudaSuccess) return (int)e;
        march_dealt_kernel<KIND><<<grid, BLOCK_THREADS, smem, stream>>>(
            pages, n_page, table, n_table, noise, out, frame_size,
            tile_row_stride, n_tile_rows, counter);
    } else {
        const size_t smem = smem_bytes(n_table, n_page, BLOCK_WARPS);
        cudaError_t e = reserve_smem(march_dealt_stack_kernel<KIND>, smem);
        if (e != cudaSuccess) return (int)e;
        march_dealt_stack_kernel<KIND><<<grid, BLOCK_THREADS, smem, stream>>>(
            pages, n_page, n_frames, table, n_table, noise, out, frame_size,
            tile_row_stride, n_tile_rows, counter);
    }
    return (int)cudaGetLastError();
}

template <int KIND>
static int launch_progressive(const float* page, int n_page,
                              const int* table, int n_table,
                              const int* noise, float* out, int frame_size,
                              int band_tile_rows, int n_bands, int grid,
                              unsigned* counters, int* flags,
                              const int* abort_word, cudaStream_t stream) {
    const size_t smem = smem_bytes(n_table, n_page, 1);
    cudaError_t e = reserve_smem(march_progressive_kernel<KIND>, smem);
    if (e != cudaSuccess) return (int)e;
    march_progressive_kernel<KIND><<<grid, BLOCK_THREADS, smem, stream>>>(
        page, n_page, table, n_table, noise, out, frame_size, band_tile_rows,
        n_bands, counters, flags, abort_word);
    return (int)cudaGetLastError();
}

// The address at which the current device reaches host memory ``p``
// (pinned, hence mapped under unified addressing), or nullptr where it
// cannot reach it.
static void* device_view(const void* p) {
    cudaPointerAttributes a{};
    if (cudaPointerGetAttributes(&a, p) != cudaSuccess) {
        cudaGetLastError();  // not sticky: leave no error for the launch
        return nullptr;
    }
    return a.type == cudaMemoryTypeHost ? a.devicePointer : nullptr;
}

template <typename Kernel>
static int blocks_per_sm(Kernel kernel, size_t smem) {
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, BLOCK_THREADS, smem);
    return e == cudaSuccess ? n : -(int)e;
}

// With the dynamic shared memory of a small scene's table and page: a
// launch's own table and page (a few KB) leave the count as it is. form: 0
// the frame kernel, 1 the ray-list kernel, 2 the progressive kernel, 3 the
// dealt kernel, 4 the dealt stack kernel.
template <int KIND>
static int occupancy(int form) {
    const size_t smem = smem_bytes(256, 256, 1);
    switch (form) {
    case 0: return blocks_per_sm(march_kernel<KIND>, smem);
    case 1: return blocks_per_sm(march_rays_kernel<KIND>, smem);
    case 2: return blocks_per_sm(march_progressive_kernel<KIND>, smem);
    case 3: return blocks_per_sm(march_dealt_kernel<KIND>, smem);
    case 4: return blocks_per_sm(march_dealt_stack_kernel<KIND>, smem);
    }
    return -(int)cudaErrorInvalidValue;
}

}  // namespace gamer

// n_frames frames of one structure: frame z is marched with page
// pages + z * page_stride, with the table and the noise table shared by all
// frames, and rows [0, rows) of frame z's rays at global rows
// row0 + [0, rows) (row0 from the page) go to out (n_frames, rows,
// frame_size, 3). The still frame (K1) is n_frames = 1, rows = frame_size; a
// row band (K5) is one frame with rows = the band height; a batch (K4) is
// rows = frame_size. ``kind`` picks the instantiation (0 simplex, 1 perlin,
// 2 iq) and ``noise`` is that kind's lookup table (for iq the hash table
// of gamer_iq_table_fill on the launch's device). The
// launch runs ``grid`` blocks of gamer_march_block_threads() threads that
// take the tiles from ``counter``, one unsigned int that must be 0 and
// belong to this launch alone.
extern "C" int gamer_march_batch(const float* pages, int n_page,
                                 int page_stride, int n_frames,
                                 const int* table, int n_table,
                                 const int* noise, float* out, int frame_size,
                                 int rows, int kind, int grid,
                                 unsigned* counter, void* stream) {
    if (frame_size <= 0 || rows <= 0 || n_frames <= 0) return 0;
    const long long n_tiles =
        (long long)((frame_size + gamer::TILE_W - 1) / gamer::TILE_W)
        * ((rows + gamer::TILE_H - 1) / gamer::TILE_H) * n_frames;
    if (n_frames > 65535 || page_stride < n_page || grid <= 0
        || n_tiles + (long long)grid * gamer::BLOCK_WARPS >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
    case gamer::NOISE_SIMPLEX:
        return gamer::launch_frames<gamer::NOISE_SIMPLEX>(
            pages, n_page, page_stride, n_frames, table, n_table, noise, out,
            frame_size, rows, grid, counter, st);
    case gamer::NOISE_PERLIN:
        return gamer::launch_frames<gamer::NOISE_PERLIN>(
            pages, n_page, page_stride, n_frames, table, n_table, noise, out,
            frame_size, rows, grid, counter, st);
    case gamer::NOISE_IQ:
        return gamer::launch_frames<gamer::NOISE_IQ>(
            pages, n_page, page_stride, n_frames, table, n_table, noise, out,
            frame_size, rows, grid, counter, st);
    }
    return (int)cudaErrorInvalidValue;
}

// K6: n_rays directions (n_rays, 3) from the page's camera point into out
// (n_rays, 3); ``kind``, ``noise``, ``grid`` and ``counter`` as above.
extern "C" int gamer_march_rays(const float* page, int n_page,
                                const int* table, int n_table,
                                const int* noise, const float* dirs,
                                int n_rays, float* out, int kind, int grid,
                                unsigned* counter, void* stream) {
    if (n_rays <= 0) return 0;
    if (grid <= 0 || (long long)grid * gamer::BLOCK_WARPS >= (1LL << 30))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
    case gamer::NOISE_SIMPLEX:
        return gamer::launch_rays<gamer::NOISE_SIMPLEX>(
            page, n_page, table, n_table, noise, dirs, n_rays, out, grid,
            counter, st);
    case gamer::NOISE_PERLIN:
        return gamer::launch_rays<gamer::NOISE_PERLIN>(
            page, n_page, table, n_table, noise, dirs, n_rays, out, grid,
            counter, st);
    case gamer::NOISE_IQ:
        return gamer::launch_rays<gamer::NOISE_IQ>(
            page, n_page, table, n_table, noise, dirs, n_rays, out, grid,
            counter, st);
    }
    return (int)cudaErrorInvalidValue;
}

// S1 and S2 dealt across a mesh: one entry's share of n_frames frame_size
// frames of one structure (frame f's page at pages + f * n_page), of each
// frame its n_tile_rows tile rows (TILE_H rows each) from its page's row0
// on, every tile_row_stride-th, into out (n_frames, n_tile_rows * TILE_H,
// frame_size, 3); rows past the frame are 0. One frame (S1) launches
// march_dealt_kernel, several (S2) march_dealt_stack_kernel. The caller
// keeps row0 plus the share's last row below 2^24. ``kind``, ``noise``,
// ``grid``, ``counter`` and ``stream`` as in gamer_march_batch.
extern "C" int gamer_march_dealt(const float* pages, int n_page,
                                 int n_frames,
                                 const int* table, int n_table,
                                 const int* noise, float* out, int frame_size,
                                 int tile_row_stride, int n_tile_rows,
                                 int kind, int grid, unsigned* counter,
                                 void* stream) {
    if (frame_size <= 0 || n_tile_rows <= 0 || tile_row_stride <= 0
        || n_frames <= 0 || n_frames > 65535
        || grid <= 0)
        return (int)cudaErrorInvalidValue;
    const long long last_row =
        ((long long)(n_tile_rows - 1) * tile_row_stride + 1) * gamer::TILE_H;
    const long long n_tiles =
        (long long)((frame_size + gamer::TILE_W - 1) / gamer::TILE_W)
        * n_tile_rows * n_frames;
    if (last_row >= (1LL << 24)
        || n_tiles + (long long)grid * gamer::BLOCK_WARPS >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
    case gamer::NOISE_SIMPLEX:
        return gamer::launch_dealt<gamer::NOISE_SIMPLEX>(
            pages, n_page, n_frames, table, n_table, noise, out, frame_size,
            tile_row_stride, n_tile_rows, grid, counter, st);
    case gamer::NOISE_PERLIN:
        return gamer::launch_dealt<gamer::NOISE_PERLIN>(
            pages, n_page, n_frames, table, n_table, noise, out, frame_size,
            tile_row_stride, n_tile_rows, grid, counter, st);
    case gamer::NOISE_IQ:
        return gamer::launch_dealt<gamer::NOISE_IQ>(
            pages, n_page, n_frames, table, n_table, noise, out, frame_size,
            tile_row_stride, n_tile_rows, grid, counter, st);
    }
    return (int)cudaErrorInvalidValue;
}

// K5 as one launch: the progressive frame, n_bands bands of band_rows rows
// (a multiple of the tile height) from row 0 of a frame_size frame into out
// (n_bands * band_rows, frame_size, 3), with the page's row0 at 0. counters
// holds 1 + n_bands unsigned ints, all 0 and of this launch alone (the tile
// counter, then each band's count of finished tiles). flags (n_bands ints,
// 0 at the launch) and abort_word (one int) are pinned host memory: the
// launch sets flags[b] to 1 once band b's rows are stored, and stops within
// one tile of each warp once the host sets abort_word. Returns
// cudaErrorInvalidValue where the device cannot reach flags or abort_word;
// ``kind``, ``noise``, ``grid`` and ``stream`` as in gamer_march_batch.
extern "C" int gamer_march_progressive(const float* page, int n_page,
                                       const int* table, int n_table,
                                       const int* noise, float* out,
                                       int frame_size, int band_rows,
                                       int n_bands, int kind, int grid,
                                       unsigned* counters, int* flags,
                                       const int* abort_word, void* stream) {
    if (frame_size <= 0 || band_rows <= 0 || n_bands <= 0 || grid <= 0
        || band_rows % gamer::TILE_H != 0)
        return (int)cudaErrorInvalidValue;
    const long long rows = (long long)band_rows * n_bands;
    const long long n_tiles =
        (long long)((frame_size + gamer::TILE_W - 1) / gamer::TILE_W)
        * (rows / gamer::TILE_H);
    if (rows >= (1LL << 24)
        || n_tiles + (long long)grid * gamer::BLOCK_WARPS >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    int* dflags = static_cast<int*>(gamer::device_view(flags));
    const int* dabort =
        static_cast<const int*>(gamer::device_view(abort_word));
    if (dflags == nullptr || dabort == nullptr)
        return (int)cudaErrorInvalidValue;
    const int tile_rows = band_rows / gamer::TILE_H;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
    case gamer::NOISE_SIMPLEX:
        return gamer::launch_progressive<gamer::NOISE_SIMPLEX>(
            page, n_page, table, n_table, noise, out, frame_size, tile_rows,
            n_bands, grid, counters, dflags, dabort, st);
    case gamer::NOISE_PERLIN:
        return gamer::launch_progressive<gamer::NOISE_PERLIN>(
            page, n_page, table, n_table, noise, out, frame_size, tile_rows,
            n_bands, grid, counters, dflags, dabort, st);
    case gamer::NOISE_IQ:
        return gamer::launch_progressive<gamer::NOISE_IQ>(
            page, n_page, table, n_table, noise, out, frame_size, tile_rows,
            n_bands, grid, counters, dflags, dabort, st);
    }
    return (int)cudaErrorInvalidValue;
}

// The iq hash table: its IQ_TABLE_PAIRS pairs of floats (noise.cuh), the
// caller's ``pairs``, into ``table`` on the current device, on ``stream``;
// cudaErrorInvalidValue where ``pairs`` is another count.
extern "C" int gamer_iq_table_fill(float* table, int pairs, void* stream) {
    if (pairs != gamer::IQ_TABLE_PAIRS) return (int)cudaErrorInvalidValue;
    gamer::fill_iq_table<<<(pairs + 255) / 256, 256, 0,
                           (cudaStream_t)stream>>>(
        reinterpret_cast<float2*>(table));
    return (int)cudaGetLastError();
}

// The table's exhaustive check (check_iq_table) over every pair and the
// integers [lo, lo + n_args): three unsigned counts into ``bad``, which
// must be 0 at the launch.
extern "C" int gamer_iq_table_check(const float* table, int lo, int n_args,
                                    unsigned* bad, void* stream) {
    if (n_args < 0) return (int)cudaErrorInvalidValue;
    const int n = n_args > gamer::IQ_TABLE_PAIRS ? n_args
                                                 : gamer::IQ_TABLE_PAIRS;
    gamer::check_iq_table<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(table), lo, n_args, bad);
    return (int)cudaGetLastError();
}

// The perlin gradient table's check (check_perlin_grads) over the lattice
// indices [0, n_idx): two unsigned counts into ``bad``, which must be 0 at
// the launch; ``table`` is the perlin kernels' noise table.
extern "C" int gamer_perlin_grad_check(const int* table, int n_idx,
                                       unsigned* bad, void* stream) {
    if (n_idx < 0) return (int)cudaErrorInvalidValue;
    if (n_idx == 0) return 0;
    gamer::check_perlin_grads<<<(n_idx + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(table, n_idx, bad);
    return (int)cudaGetLastError();
}

// gamer_progress_wait's own results besides a count of bands and a CUDA
// error (as its negative).
constexpr int GAMER_WAIT_ENDED = -1000000;    // launch over, band unset
constexpr int GAMER_WAIT_TIMEOUT = -1000001;  // timeout_ms passed

// The host's side of the band flags: spins (yielding the thread) until
// flags[next_band] is set, then returns how many consecutive bands from
// next_band on are set. Returns GAMER_WAIT_ENDED when ``event`` (recorded
// after the launch) has completed with flags[next_band] still 0 (the launch
// was aborted or failed), minus the CUDA error when the event reports one,
// and GAMER_WAIT_TIMEOUT after timeout_ms. Called through ctypes, which
// lets other Python threads run while it waits.
extern "C" int gamer_progress_wait(const int* flags, int n_bands,
                                   int next_band, void* event,
                                   int timeout_ms) {
    if (n_bands <= 0 || next_band < 0 || next_band >= n_bands)
        return -(int)cudaErrorInvalidValue;
    const volatile int* f = flags;
    auto done_from = [&]() {
        int k = next_band;
        while (k < n_bands && f[k] != 0) ++k;
        return k - next_band;
    };
    const auto t0 = std::chrono::steady_clock::now();
    for (;;) {
        int n = done_from();
        if (n > 0) return n;
        const cudaError_t e = cudaEventQuery((cudaEvent_t)event);
        if (e == cudaSuccess) {
            // the launch is over: its last flag may have landed just now
            n = done_from();
            return n > 0 ? n : GAMER_WAIT_ENDED;
        }
        if (e != cudaErrorNotReady) return -(int)e;
        if (std::chrono::steady_clock::now() - t0
            > std::chrono::milliseconds(timeout_ms))
            return GAMER_WAIT_TIMEOUT;
        std::this_thread::yield();
    }
}

// Resident blocks per SM of the kind's frame kernel (form 0), ray-list
// kernel (1), progressive kernel (2), dealt kernel (3) or dealt stack
// kernel (4) on the current device; minus the CUDA error on failure.
extern "C" int gamer_march_occupancy(int kind, int form) {
    switch (kind) {
    case gamer::NOISE_SIMPLEX: return gamer::occupancy<gamer::NOISE_SIMPLEX>(form);
    case gamer::NOISE_PERLIN: return gamer::occupancy<gamer::NOISE_PERLIN>(form);
    case gamer::NOISE_IQ: return gamer::occupancy<gamer::NOISE_IQ>(form);
    }
    return -(int)cudaErrorInvalidValue;
}

// Threads of a block of the march kernels.
extern "C" int gamer_march_block_threads() { return gamer::BLOCK_THREADS; }

extern "C" const char* gamer_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
