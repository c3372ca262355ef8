// dc-chain: hexamer-table lookup + per-phase (mod 3) inclusive prefix sum.
//
// Replaces pyrodigal_tpu/ops/star_pallas.py::_dc_chain_kernel (wrapper
// dc_phase_cumsum): out[b, p] = sum of table[b, codes[q]] over q <= p with
// q % 3 == p % 3, for a (B, 4096) per-bin table and one (S,) code row
// shared by every bin row.
//
// What bounds it on the H100: memory.  Per row it reads the S codes and
// writes S floats (B = 16, S = 2.56 M: 164 MB written per call); the work
// per element is one table read and one add.  The TPU kernel's 7/5 one-hot
// code split fed the matrix unit; here the lookup is a plain read of the
// bin's 16 KB table, staged once in shared memory.
//
// Design: one block per (phase, row).  The block walks its phase's S/3
// positions in chunks of blockDim * ITEMS: each thread sums ITEMS
// consecutive same-phase elements, a warp-shuffle block scan turns the
// thread sums into exclusive offsets, and a register carries the running
// total across chunks.  The summation order differs from a sequential
// cumsum, so results agree with it up to f32 rounding (the reference's
// own contract for this kernel, star_pallas.py:271-273).  Reads and
// writes are strided by 3 elements; coalescing them is later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;

__global__ void dc_chain_kernel(const float* __restrict__ table,
                                const int* __restrict__ codes,
                                float* __restrict__ out, long long S) {
    __shared__ float t[4096];
    const int phase = blockIdx.x;
    const int b = blockIdx.y;
    for (int k = threadIdx.x; k < 4096; k += THREADS)
        t[k] = table[(long long)b * 4096 + k];
    __syncthreads();

    const long long K = (S - phase + 2) / 3;    // positions phase + 3m < S
    float* row = out + (long long)b * S;
    float carry = 0.0f;
    for (long long base = 0; base < K; base += (long long)THREADS * ITEMS) {
        const long long m0 = base + (long long)threadIdx.x * ITEMS;
        float v[ITEMS];
        float s = 0.0f;
        for (int q = 0; q < ITEMS; ++q) {
            long long m = m0 + q;
            float x = m < K ? t[codes[phase + 3 * m] & 4095] : 0.0f;
            s += x;
            v[q] = s;
        }
        float total;
        float excl = block_exclusive_scan<THREADS>(s, &total);
        float off = carry + excl;
        for (int q = 0; q < ITEMS; ++q) {
            long long m = m0 + q;
            if (m < K) row[phase + 3 * m] = off + v[q];
        }
        carry += total;
    }
}

}  // namespace

extern "C" int dc_chain_launch(const float* table, const int* codes,
                               float* out, int B, long long S,
                               cudaStream_t stream) {
    dim3 grid(3, B);
    dc_chain_kernel<<<grid, THREADS, 0, stream>>>(table, codes, out, S);
    return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
