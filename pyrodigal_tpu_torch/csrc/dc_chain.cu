// dc-chain: hexamer-table lookup + per-phase (mod 3) inclusive prefix sum.
//
// Replaces pyrodigal_tpu/ops/star_pallas.py::_dc_chain_kernel (wrapper
// dc_phase_cumsum): out[b, p] = sum of table[b, codes[q]] over q <= p with
// q % 3 == p % 3, for a (B, 4096) per-bin table and one (S,) code row
// shared by every bin row.
//
// What bounds it on the H100: bytes.  At the genome's launch (B = 16,
// S = 2,555,904) it must write 163.6 MB and read 10.2 MB of codes and
// 0.26 MB of tables: 52 us at 3.35 TB/s, against 1.2 us for its 41 M
// lookups and adds at the f64 rate.  The TPU kernel's 7/5 one-hot code
// split fed the matrix unit; here the lookup is a plain read of the bin's
// 16 KB table, staged once a block in shared memory.  Those lookups are
// random shared-memory gathers (bank conflicts), the kernel's costliest
// instruction after the stores.
//
// Design (phase_scan.cuh): tiles of 3,072 positions, one block per (row,
// chunk of tiles): the genome runs 16 x 64 blocks a kernel, each staging
// its row's table once for 13 tiles.  Codes are read as int4 and outputs
// stored as float4, thread t on the t-th 16 bytes; the looked-up values
// go through a shared-memory copy of the tile, from which each thread
// scans 12 consecutive positions.  The carry across tiles is
// reduce-then-scan: a first kernel writes each chunk's phase totals to a
// (B, chunks, 3) float64 scratch, the scan kernel sums its chunk's
// predecessors in a fixed order, so results are bit-identical from call
// to call.  Sums are float64, each output rounded once (phase_scan.cuh).  The
// reduce kernel takes two rows a block, their tables interleaved, so one
// 8-byte gather looks a code up for both (8 x 63 blocks at the genome).  The
// code row comes from device memory about once a pass: the grid's x axis
// is the row, so the B blocks of one chunk are issued one after another
// and the later ones find its codes in L2 (50 MB).  Codes that are not
// 16-byte aligned and the ragged last tile take coalesced 4-byte
// accesses.

#include "phase_scan.cuh"

namespace {

using namespace phase_scan;

constexpr int NCODES = 4096;

__device__ __forceinline__ int4 load_slot(const int* codes, long long p0,
                                          int k) {
    return reinterpret_cast<const int4*>(codes + p0)[threadIdx.x
                                                      + k * THREADS];
}

// The scan pass's source: one row's table, staged in shared memory.
struct Lookups {
    using Vec = int4;
    const int* codes;
    const float* tab;

    __device__ __forceinline__ bool vec() const { return aligned16(codes); }
    __device__ __forceinline__ void load(int4 (&v)[SLOTS],
                                         long long p0) const {
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) v[k] = load_slot(codes, p0, k);
    }
    __device__ __forceinline__ void put(float* buf,
                                        const int4 (&v)[SLOTS]) const {
        float4* b4 = reinterpret_cast<float4*>(buf);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k)
            b4[threadIdx.x + k * THREADS] = make_float4(
                tab[v[k].x & (NCODES - 1)], tab[v[k].y & (NCODES - 1)],
                tab[v[k].z & (NCODES - 1)], tab[v[k].w & (NCODES - 1)]);
    }
    __device__ __forceinline__ float value(long long p) const {
        return tab[codes[p] & (NCODES - 1)];
    }
};

// The reduce pass's source: two rows' tables interleaved in shared
// memory, so one 8-byte gather looks a code up for both rows (fewer
// bank-conflicted shared loads than two 4-byte gathers).
struct LookupPairs {
    using Vec = int4;
    const int* codes;
    const float2* tab2;

    __device__ __forceinline__ bool vec() const { return aligned16(codes); }
    __device__ __forceinline__ void load(int4 (&v)[SLOTS],
                                         long long p0) const {
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) v[k] = load_slot(codes, p0, k);
    }
    __device__ __forceinline__ void add_code(acc_t (&acc)[2][3], int m,
                                             int code) const {
        const float2 v = tab2[code & (NCODES - 1)];
        acc[0][m] += v.x;
        acc[1][m] += v.y;
    }
    __device__ __forceinline__ void add(acc_t (&acc)[2][3],
                                        const int4 (&v)[SLOTS]) const {
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            add_code(acc, k % 3, v[k].x);
            add_code(acc, (k + 1) % 3, v[k].y);
            add_code(acc, (k + 2) % 3, v[k].z);
            add_code(acc, k % 3, v[k].w);
        }
    }
    __device__ __forceinline__ void add_one(acc_t (&acc)[2][3], int m,
                                            long long p) const {
        add_code(acc, m, codes[p]);
    }
};

// Rows 2 g and 2 g + 1 (zeros past B) of the table, interleaved.
__global__ void __launch_bounds__(THREADS) dc_chain_reduce_kernel(
        const float* __restrict__ table, const int* __restrict__ codes,
        acc_t* __restrict__ scratch, int B, int tpb, long long chunks) {
    __shared__ float2 tab2[NCODES];
    __shared__ acc_t red[6 * WARPS];
    const int b0 = 2 * blockIdx.x;
    const int c = blockIdx.y;
    const bool pair = b0 + 1 < B;
    for (int k = threadIdx.x; k < NCODES; k += THREADS)
        tab2[k] = make_float2(
            table[(long long)b0 * NCODES + k],
            pair ? table[(long long)(b0 + 1) * NCODES + k] : 0.0f);
    __syncthreads();
    acc_t tot[6];
    reduce_chunk<2>(LookupPairs{codes, tab2}, c, tpb, tot, red);
    if (threadIdx.x == 0)
        for (int r = 0; r < (pair ? 2 : 1); ++r)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                scratch[((long long)(b0 + r) * chunks + c) * 3 + k] =
                    tot[3 * r + k];
}

__global__ void __launch_bounds__(THREADS) dc_chain_kernel(
        const float* __restrict__ table, const int* __restrict__ codes,
        float* __restrict__ out, const acc_t* __restrict__ scratch,
        long long S, int tpb, long long chunks) {
    __shared__ float tab[NCODES];
    __shared__ __align__(16) float buf[2][TILE];
    __shared__ ScanSmem sm;
    const int b = blockIdx.x;
    for (int k = threadIdx.x; k < NCODES; k += THREADS)
        tab[k] = table[(long long)b * NCODES + k];
    __syncthreads();
    scan_chunk(Lookups{codes, tab}, scratch + (long long)b * chunks * 3,
               out + (long long)b * S, S, blockIdx.y, tpb, buf, sm);
}

}  // namespace

extern "C" int dc_chain_launch(const float* table, const int* codes,
                               float* out, double* scratch, int B,
                               long long S, int tiles_per_block,
                               cudaStream_t stream) {
    using namespace phase_scan;
    long long chunks;
    int err = check_launch(B, S, tiles_per_block, &chunks);
    if (err != 0) return err;
    if (chunks > 1) {
        dc_chain_reduce_kernel<<<dim3((B + 1) / 2, chunks - 1), THREADS, 0,
                                 stream>>>(table, codes, scratch, B,
                                           tiles_per_block, chunks);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    dc_chain_kernel<<<dim3(B, chunks), THREADS, 0, stream>>>(
        table, codes, out, scratch, S, tiles_per_block, chunks);
    return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
