// Noise probe: the march kernel's noise device functions (noise.cuh)
// evaluated on an explicit list of points, so they can be held against
// their plain torch versions (gamer_tpu_torch/ops/noise.py) value by value.
//
// The counterpart of the TPU repo's inline test kernel
// (tests/test_pallas.py:36-66), which checked the byte-packed permutation
// lookups the Pallas kernel used; here the table is PERM[512] in shared
// memory, read exactly as the march kernel reads it.
//
// Bound: ALU (one raw + octaves + ridged-octaves simplex evaluations per
// point); 12 B in and 12 B out per point. One thread per point.
#include <cuda_runtime.h>

#include "noise.cuh"

namespace gamer {

__global__ void __launch_bounds__(256)
noise_probe_kernel(const float* __restrict__ xyz, int n,
                   const int* __restrict__ perm_g, int octaves,
                   float persistence, float scale,
                   const float* __restrict__ sw_g, int n_sw,
                   float lacunarity, float offset, float gain,
                   float* __restrict__ out) {
    __shared__ int perm[512];
    __shared__ float sw[32];
    for (int k = threadIdx.x; k < 512; k += blockDim.x) perm[k] = perm_g[k];
    for (int k = threadIdx.x; k < n_sw; k += blockDim.x) sw[k] = sw_g[k];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    out[3 * i] = raw_noise_3d(perm, x, y, z);
    out[3 * i + 1] = octave_noise_3d(perm, octaves, persistence, scale, x, y, z);
    out[3 * i + 2] = ridged_mf(perm, x, y, z, sw, n_sw, lacunarity, offset,
                               gain);
}

}  // namespace gamer

extern "C" int gamer_noise_probe(const float* xyz, int n, const int* perm,
                                 int octaves, float persistence, float scale,
                                 const float* sw, int n_sw, float lacunarity,
                                 float offset, float gain, float* out,
                                 void* stream) {
    if (n <= 0) return 0;
    if (n_sw < 0 || n_sw > 32) return (int)cudaErrorInvalidValue;
    gamer::noise_probe_kernel<<<(n + 255) / 256, 256, 0,
                                (cudaStream_t)stream>>>(
        xyz, n, perm, octaves, persistence, scale, sw, n_sw, lacunarity,
        offset, gain, out);
    return (int)cudaGetLastError();
}
