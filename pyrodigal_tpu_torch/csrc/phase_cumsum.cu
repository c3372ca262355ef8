// phase_cumsum: per-phase (mod 3) inclusive prefix sums of a (B, S) float32
// array.
//
// Replaces pyrodigal_tpu/ops/star_pallas.py::_phase_cumsum_kernel (wrapper
// phase_cumsum): out[b, p] = sum of x[b, q] over q <= p with q % 3 == p % 3.
// On the std route each row of x holds the dc scores of its own (contig,
// bin): the bin's hexamer table read at the contig's 6-mer codes, a torch
// gather the caller makes (the lookup the mega route fuses into dc_chain).
//
// What bounds it on the H100: bytes.  A std launch (B = 128, S = 49,152)
// must read 25.2 MB and write 25.2 MB: 15.0 us at 3.35 TB/s, against
// 0.2 us for its 6.3 M adds at the f64 rate.  The TPU kernel ran three
// masked log-shift scans per 2048-lane tile with (B, 3) carries in VMEM
// scratch across its sequential grid; none of that carries over.
//
// Design (phase_scan.cuh): tiles of 3,072 positions, one block per (row,
// chunk of tiles), so a std launch runs 128 x 8 = 1,024 blocks on the 132
// SMs.  Loads and stores are float4, thread t on the t-th 16 bytes; a
// shared-memory copy of the tile hands each thread 12 consecutive
// positions, so the three phases need no stride.  The carry across tiles
// is reduce-then-scan: a first kernel writes each chunk's phase totals to
// a (B, chunks, 3) float64 scratch, the scan kernel sums its chunk's
// predecessors in a fixed order, so results are bit-identical from call
// to call.  Sums are float64, each output rounded once (phase_scan.cuh).
// The second pass reads x again (from L2 where it still lies): 75 MB
// moved for the 50 MB the bound counts.  A row that is not 16-byte aligned
// (S % 4 != 0) and the ragged last tile take coalesced 4-byte accesses.

#include "phase_scan.cuh"

namespace {

using namespace phase_scan;

struct Values {
    using Vec = float4;
    const float* xr;        // the row

    __device__ __forceinline__ bool vec() const { return aligned16(xr); }
    __device__ __forceinline__ void load(float4 (&v)[SLOTS],
                                         long long p0) const {
        const float4* s4 = reinterpret_cast<const float4*>(xr + p0);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) v[k] = s4[threadIdx.x + k * THREADS];
    }
    __device__ __forceinline__ void put(float* buf,
                                        const float4 (&v)[SLOTS]) const {
        float4* b4 = reinterpret_cast<float4*>(buf);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) b4[threadIdx.x + k * THREADS] = v[k];
    }
    __device__ __forceinline__ void add(acc_t (&acc)[1][3],
                                        const float4 (&v)[SLOTS]) const {
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) add_slot(acc[0], k, v[k]);
    }
    __device__ __forceinline__ void add_one(acc_t (&acc)[1][3], int m,
                                            long long p) const {
        acc[0][m] += xr[p];
    }
    __device__ __forceinline__ float value(long long p) const {
        return xr[p];
    }
};

__global__ void __launch_bounds__(THREADS) phase_cumsum_reduce_kernel(
        const float* __restrict__ x, acc_t* __restrict__ scratch, long long S,
        int tpb, long long chunks) {
    __shared__ acc_t red[3 * WARPS];
    const int b = blockIdx.x;
    const int c = blockIdx.y;
    acc_t tot[3];
    reduce_chunk<1>(Values{x + (long long)b * S}, c, tpb, tot, red);
    if (threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            scratch[((long long)b * chunks + c) * 3 + k] = tot[k];
}

__global__ void __launch_bounds__(THREADS) phase_cumsum_kernel(
        const float* __restrict__ x, float* __restrict__ out,
        const acc_t* __restrict__ scratch, long long S, int tpb,
        long long chunks) {
    __shared__ __align__(16) float buf[2][TILE];
    __shared__ ScanSmem sm;
    const int b = blockIdx.x;
    scan_chunk(Values{x + (long long)b * S},
               scratch + (long long)b * chunks * 3, out + (long long)b * S,
               S, blockIdx.y, tpb, buf, sm);
}

}  // namespace

extern "C" int phase_cumsum_launch(const float* x, float* out,
                                   double* scratch, int B, long long S,
                                   int tiles_per_block, cudaStream_t stream) {
    using namespace phase_scan;
    long long chunks;
    int err = check_launch(B, S, tiles_per_block, &chunks);
    if (err != 0) return err;
    if (chunks > 1) {
        phase_cumsum_reduce_kernel<<<dim3(B, chunks - 1), THREADS, 0,
                                     stream>>>(x, scratch, S,
                                               tiles_per_block, chunks);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    phase_cumsum_kernel<<<dim3(B, chunks), THREADS, 0, stream>>>(
        x, out, scratch, S, tiles_per_block, chunks);
    return (int)cudaGetLastError();
}
