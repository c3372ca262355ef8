// phase_cumsum: per-phase (mod 3) inclusive prefix sums of a (B, S) float32
// array.
//
// Replaces pyrodigal_tpu/ops/star_pallas.py::_phase_cumsum_kernel (wrapper
// phase_cumsum): out[b, p] = sum of x[b, q] over q <= p with q % 3 == p % 3.
// On the std route each row of x holds the dc scores of its own (contig,
// bin): the bin's hexamer table read at the contig's 6-mer codes, a torch
// gather the caller makes (the lookup the mega route fuses into dc_chain).
//
// What bounds it on the H100: memory.  A std launch (B = 128, S = 49,152)
// reads 25 MB and writes 25 MB, one add per element.  The TPU kernel ran
// three masked log-shift scans per 2048-lane tile with (B, 3) carries in
// VMEM scratch across its sequential grid, to avoid the (B, S/3, 3)
// relayout; none of that carries over.
//
// Design: dc_chain.cu's without the table: one block per (phase, row)
// walks its phase's S/3 positions in chunks of THREADS * ITEMS; each thread
// sums ITEMS consecutive same-phase elements, a block scan of the thread
// sums gives exclusive offsets, and a register carries the running total
// across chunks.  The summation order differs from a sequential cumsum,
// so results agree with it up to f32 rounding, as the TPU kernel's did
// (star_pallas.py:271-273).  Accesses are strided by 3 elements; coalescing
// them is later work.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;

__global__ void phase_cumsum_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, long long S) {
    const int phase = blockIdx.x;
    const long long b = blockIdx.y;
    const long long K = (S - phase + 2) / 3;    // positions phase + 3m < S
    const float* xr = x + b * S;
    float* row = out + b * S;
    float carry = 0.0f;
    for (long long base = 0; base < K; base += (long long)THREADS * ITEMS) {
        const long long m0 = base + (long long)threadIdx.x * ITEMS;
        float v[ITEMS];
        float s = 0.0f;
        for (int q = 0; q < ITEMS; ++q) {
            long long m = m0 + q;
            s += m < K ? xr[phase + 3 * m] : 0.0f;
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

extern "C" int phase_cumsum_launch(const float* x, float* out, int B,
                                   long long S, cudaStream_t stream) {
    dim3 grid(3, B);
    phase_cumsum_kernel<<<grid, THREADS, 0, stream>>>(x, out, S);
    return (int)cudaGetLastError();
}
