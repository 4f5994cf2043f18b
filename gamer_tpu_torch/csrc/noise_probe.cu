// Noise probe: the march kernel's noise device functions (noise.cuh)
// evaluated on an explicit list of points, so they can be held against
// their plain torch versions (gamer_tpu_torch/ops/noise.py) value by value.
//
// The counterpart of the TPU repo's inline test kernel
// (tests/test_pallas.py:36-66), which checked the byte-packed permutation
// lookups the Pallas kernel used; here the kind's table (the paired simplex
// tables or the paired Perlin permutation with the perlin gradients,
// ops/noise.py::kernel_noise_table) is staged in shared memory and read
// exactly as the march kernel reads it;
// for iq, perm is the hash table (gamer_iq_table_fill), read as the march
// kernel reads it.
// The raw backend is the template parameter the march kernel uses
// (0 simplex, 1 perlin, 2 iq).
//
// Bound: ALU (one raw + octaves + ridged-octaves raw evaluations per
// point); 12 B in and 12 B out per point. One thread per point.
#include <cuda_runtime.h>

#include "noise.cuh"

namespace gamer {

template <int KIND>
__global__ void __launch_bounds__(256)
noise_probe_kernel(const float* __restrict__ xyz, int n,
                   const int* __restrict__ perm_g, int octaves,
                   float persistence, float scale,
                   const float* __restrict__ sw_g, int n_sw,
                   float lacunarity, float offset, float gain,
                   float* __restrict__ out) {
    __shared__ float sw[32];
    stage_iq_pairs<KIND>(perm_g);
    for (int k = threadIdx.x; k < noise_table_size(KIND); k += blockDim.x)
        noise_smem[k] = perm_g[k];
    stage_perlin_grads<KIND>(perm_g, blockDim.x);
    for (int k = threadIdx.x; k < n_sw; k += blockDim.x) sw[k] = sw_g[k];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    out[3 * i] = raw_noise<KIND>(x, y, z);
    out[3 * i + 1] = octave_noise_3d<KIND>(octaves, persistence, scale, x, y,
                                           z);
    out[3 * i + 2] = ridged_mf<KIND>(x, y, z, sw, n_sw, lacunarity, offset,
                                     gain);
}

template <int KIND>
static int launch_probe(const float* xyz, int n, const int* perm, int octaves,
                        float persistence, float scale, const float* sw,
                        int n_sw, float lacunarity, float offset, float gain,
                        float* out, cudaStream_t stream) {
    noise_probe_kernel<KIND><<<(n + 255) / 256, 256, 0, stream>>>(
        xyz, n, perm, octaves, persistence, scale, sw, n_sw, lacunarity,
        offset, gain, out);
    return (int)cudaGetLastError();
}

}  // namespace gamer

extern "C" int gamer_noise_probe(const float* xyz, int n, const int* perm,
                                 int octaves, float persistence, float scale,
                                 const float* sw, int n_sw, float lacunarity,
                                 float offset, float gain, float* out,
                                 int kind, void* stream) {
    if (n <= 0) return 0;
    if (n_sw < 0 || n_sw > 32) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
    case gamer::NOISE_SIMPLEX:
        return gamer::launch_probe<gamer::NOISE_SIMPLEX>(
            xyz, n, perm, octaves, persistence, scale, sw, n_sw, lacunarity,
            offset, gain, out, st);
    case gamer::NOISE_PERLIN:
        return gamer::launch_probe<gamer::NOISE_PERLIN>(
            xyz, n, perm, octaves, persistence, scale, sw, n_sw, lacunarity,
            offset, gain, out, st);
    case gamer::NOISE_IQ:
        return gamer::launch_probe<gamer::NOISE_IQ>(
            xyz, n, perm, octaves, persistence, scale, sw, n_sw, lacunarity,
            offset, gain, out, st);
    }
    return (int)cudaErrorInvalidValue;
}
