// Each row's K nearest columns for Hopper (sm_90a): for a row-major fp32
// (rows, n) matrix with row stride ld, the first K column indices of every
// row in torch.argsort(x, dim=1, stable=True)'s order (ascending, ties to the
// lower index), written as int64 (rows, K). Any K <= n; n <= 32768.
//
// Replaces no Pallas kernel. The TPU path picks these lists with
// jax.lax.top_k on the negated rows (grl_tpu/engine/rerank.py:703, 727);
// k-reciprocal re-ranking reads only each row's first max(k1 + 1, k2) = 21
// nearest, where the port had stable-argsorted every row of the n x n
// matrix (a 1.08 GB int64 order at the serve shape, and CUB's buffers).
//
// Bound: one read of the matrix. At the serve shape (11598 x 11598, 0.538 GB)
// that is 0.161 ms at 3.35 TB/s; the indices written are 1.95 MB.
//
// Design: one block of 512 threads per row. The row is read from device
// memory once; everything after that works in shared memory and registers.
// 1. Thread t reads columns t, t + 512, ... (at most 64 of them), coalesced,
//    and stages each as a 32-bit key that orders as the stable sort orders
//    the floats (-0.0 as +0.0; every NaN above +inf and equal to the others)
//    in dynamic shared memory, 4 n bytes (46 KB at the serve shape). A
//    column's composite (key << 32 | column) is unique, and "ascending, ties
//    to the lower index" is the plain order of composites. Each thread keeps
//    its smallest composite.
// The columns are then selected in rounds of up to 32 (one round at
// re-ranking's K = 21), each taking the R smallest composites at or above
// the round's floor (0 at first, then one past the last one written):
// 2. U, the R-th smallest of the 512 thread minima, bounds the R-th smallest
//    composite from above: the R smallest minima are R of the composites.
//    Each warp bitonic-sorts its 32 minima in registers, and four rounds of
//    pairwise merges through shared memory leave the block's 32 smallest
//    minima, sorted, in warp 0.
// 3. The candidates are the composites in [floor, U]. The R smallest are
//    among them, and only the (at most) R threads whose minimum is <= U hold
//    any, so there are at most 32 x 64 (32 x ceil(n / 512), sized so in
//    dynamic shared memory); the strided columns spread a row's smallest
//    entries, and runs of ties (lowest column first), over distinct threads,
//    so in practice there are about R.
// 4. A candidate's rank is the number of smaller candidates; the ranks below
//    R are written, and the R-th sets the next round's floor. A later round
//    takes each thread's minimum again from the staged keys.
// A radix select over the staged keys (histograms of 8-bit digits) was the
// other design: a row's keys share their top bits (distances normalized into
// [0, 1], a padded row all 2.0), so its first digits would pile every key
// into a few shared-memory counters, whose atomics serialize.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), K = 21: 0.33 ms
// at the serve shape and 0.43 ms at MARS's 13290 x 13290, against 10.9 and
// 14.0 ms for the stable argsort and 4.0 and 5.1 ms for torch.topk on unique
// int64 keys; K = 41 (two rounds) 0.53 and 0.71 ms. A single round for
// K <= 32 over at most 32 columns a thread was 0.32 and 0.39 ms. Taking each
// thread's minimum on the 64-bit composites cost 0.45 ms, and reading the
// candidates' columns again from device memory instead of staging the row
// 0.36 ms: what is left of the gap to the bound is the per-element
// instructions and the barriers of step 2, not the bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROUND = 32;                   // columns selected a round: one warp's sorted list
constexpr int MAX_ITEMS = 64;               // columns a thread
constexpr int MAX_N = THREADS * MAX_ITEMS;  // 32768
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory for rows of n columns: the round's candidates (8-byte
// aligned, first), then the row's keys.
__host__ __device__ constexpr int candidate_slots(int n) { return ROUND * ((n + THREADS - 1) / THREADS); }
__host__ __device__ constexpr size_t smem_bytes(int n) {
    return candidate_slots(n) * sizeof(uint64_t) + static_cast<size_t>(n) * sizeof(unsigned);
}

// The float's bits as an unsigned key in the stable sort's order: a negative
// float's bits flipped, a positive one's sign bit set; -0.0 as +0.0 (x + 0.0
// is +0.0 there), every NaN at the top.
__device__ __forceinline__ unsigned order_key(float x) {
    unsigned b = __float_as_uint(x + 0.0f);
    b ^= static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u;
    return x != x ? 0xffffffffu : b;
}

__device__ __forceinline__ uint64_t composite(unsigned key, int col) {
    return (static_cast<uint64_t>(key) << 32) | static_cast<unsigned>(col);
}

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ uint64_t umax(uint64_t a, uint64_t b) { return a < b ? b : a; }

// The warp's 32 values sorted ascending across its lanes (bitonic network).
__device__ uint64_t warp_sort(uint64_t v, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            uint64_t other = __shfl_xor_sync(FULL, v, stride);
            bool ascending = (lane & size) == 0;  // always true at size 32
            bool lower = (lane & stride) == 0;
            v = (lower == ascending) ? umin(v, other) : umax(v, other);
        }
    }
    return v;
}

// The 32 smallest of two ascending 32-lists, ascending: lane i holds a[i] and
// b[31 - i]; their minima form a bitonic sequence, which the last five steps
// of the network sort.
__device__ uint64_t merge_lowest(uint64_t a, uint64_t b_reversed, int lane) {
    uint64_t v = umin(a, b_reversed);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
        uint64_t other = __shfl_xor_sync(FULL, v, stride);
        v = (lane & stride) ? umax(v, other) : umin(v, other);
    }
    return v;
}

__global__ void __launch_bounds__(THREADS) nearest_kernel(const float* __restrict__ x, int64_t* __restrict__ out,
                                                          int n, long long ld, int k) {
    extern __shared__ uint64_t dynamic[];
    uint64_t* candidates = dynamic;                                       // candidate_slots(n)
    unsigned* keys = reinterpret_cast<unsigned*>(dynamic + candidate_slots(n));  // n
    __shared__ uint64_t lists[WARPS][32];
    __shared__ uint64_t bound, next_floor;
    __shared__ int count;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* row = x + static_cast<long long>(blockIdx.x) * ld;
    int64_t* dst = out + static_cast<long long>(blockIdx.x) * k;

    // 1. stage the row's keys; each thread's smallest composite, found on the
    // 32-bit keys (its columns ascend, so the first of equal keys is kept)
    unsigned best = 0xffffffffu;
    int best_col = tid;
#pragma unroll 8
    for (int col = tid; col < n; col += THREADS) {
        unsigned key = order_key(__ldg(row + col));
        keys[col] = key;
        if (key < best) best = key, best_col = col;
    }
    uint64_t smallest = tid < n ? composite(best, best_col) : ~0ull;

    uint64_t low = 0;  // the round's floor: every composite below it is written
    for (int done = 0; done < k; done += ROUND) {
        const int r = min(ROUND, k - done);
        if (done > 0) {  // each thread's smallest composite at or above the floor
            smallest = ~0ull;
            for (int col = tid; col < n; col += THREADS) {
                uint64_t c = composite(keys[col], col);
                if (c >= low) smallest = umin(smallest, c);
            }
        }
        if (tid == 0) count = 0;  // published by the first barrier below

        // 2. U: the R-th smallest thread minimum
        uint64_t v = warp_sort(smallest, lane);
#pragma unroll
        for (int step = 1; step < WARPS; step <<= 1) {
            if ((warp & (2 * step - 1)) == step) lists[warp][lane] = v;
            __syncthreads();
            if ((warp & (2 * step - 1)) == 0) v = merge_lowest(v, lists[warp + step][31 - lane], lane);
        }
        if (warp == 0 && lane == r - 1) bound = v;
        __syncthreads();
        const uint64_t u = bound;

        // 3. the candidates: every composite in [floor, U], from the threads
        // whose minimum is <= U
        if (smallest <= u) {
            int mine = 0;
            for (int col = tid; col < n; col += THREADS) {
                uint64_t c = composite(keys[col], col);
                mine += c >= low && c <= u;
            }
            int at = atomicAdd(&count, mine);
            for (int col = tid; col < n; col += THREADS) {
                uint64_t c = composite(keys[col], col);
                if (c >= low && c <= u) candidates[at++] = c;
            }
        }
        __syncthreads();

        // 4. rank the candidates; write the first R, and the next floor
        const int total = count;
        for (int j = tid; j < total; j += THREADS) {
            uint64_t c = candidates[j];
            int rank = 0;
            for (int i = 0; i < total; ++i) rank += candidates[i] < c;
            if (rank < r) dst[done + rank] = static_cast<int64_t>(c & 0xffffffffu);
            if (rank == r - 1) next_floor = c + 1;
        }
        __syncthreads();
        low = next_floor;
    }
}

}  // namespace

// Plain C entry point for ctypes. Launches one block per row on `stream`
// (PyTorch's current stream), does not synchronize, and returns
// cudaGetLastError() so a refused launch is reported to the caller, or
// cudaErrorInvalidValue for sizes the kernel does not take. x is (rows, n)
// fp32 with unit column stride and row stride ld >= 0 (rows are only read,
// so they may overlap); out is (rows, k) int64, contiguous; rows >= 1,
// 1 <= k <= n <= 32768.
extern "C" int grl_nearest_f32(const float* x, int64_t* out, int rows, int n, long long ld, int k,
                               void* stream) {
    if (rows < 1 || k < 1 || k > n || n > MAX_N || ld < 0) return static_cast<int>(cudaErrorInvalidValue);
    // the limit is the widest row's, so no launch of another width (another
    // thread, another call) can find it set below its own
    cudaError_t err = cudaFuncSetAttribute(nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_bytes(MAX_N)));
    if (err != cudaSuccess) return static_cast<int>(err);
    nearest_kernel<<<rows, THREADS, smem_bytes(n), static_cast<cudaStream_t>(stream)>>>(x, out, n, ld, k);
    return static_cast<int>(cudaGetLastError());
}
