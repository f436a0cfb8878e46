// Min-plus "matmul" for Hopper (sm_90a): S[i, j] = sum_t min(A[i, t], B[j, t]).
//
// Replaces the Pallas TPU kernel grl_tpu/ops/minplus.py::_minplus_kernel
// (pallas_call at minplus.py:84), the Jaccard min-sum of k-reciprocal
// re-ranking (grl_tpu/engine/rerank.py:210). A is (m, k), B is (n, k), both
// fp32 row-major; S is (m, n) fp32.
//
// What bounds it. `min` is not a multiply-add, so neither wgmma nor any
// tensor-core path applies: every (i, j, t) triple costs one fminf and one
// fadd on the fp32 CUDA cores, and the two cannot fuse into one FMA. At the
// MARS shape (m = 1980, n = k = 13290) that is 3.5e11 triples, 7.0e11
// operations. On instruction issue (132 SMs x 128 fp32 lanes x ~1.98 GHz,
// about 33.5e12 lane-ops/s) that is ~21 ms, more if fminf issues below the
// full fp32 rate on sm_90; counted against the data sheet's 67 TFLOP/s
// (which counts an FMA as two) it is ~10.5 ms. The bytes are 0.92 GB, ~0.27
// ms at 3.35 TB/s, so the kernel is compute-bound. These are bounds, not
// measurements: measured times are in PERF.md with the card's name and
// power limit.
//
// Design. A 2-D grid of 128x128 output tiles; 256 threads (16x16) per
// block, each thread holding an 8x8 fp32 accumulator in registers. A loop
// over k-chunks of 32 takes the place of the TPU kernel's sequential
// "arbitrary" grid axis: each step stages a 128x32 slab of A's rows and of
// B's rows through shared memory, stored k-major so the inner loop reads
// one A value per row and one B value per column. Both operands stay
// row-major (rows, k) in device memory: no transposed copy of B exists.
// The shared rows are padded to 129 floats so the transposing stores hit 32
// distinct banks. A thread owns rows ty + 16*i and columns tx + 16*j, so a
// warp's B reads are 16 consecutive floats (conflict-free) and its A reads
// are broadcasts. Ragged m, n and k edges are masked in the kernel: out of
// range elements are staged as 0 (min(0, 0) = 0 adds nothing) and out of
// range outputs are not stored. Making it fast (double-buffered cp.async
// or TMA, a deeper register tile) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // rows of A per block
constexpr int BN = 128;       // rows of B per block
constexpr int BK = 32;        // k-chunk staged per step
constexpr int TY = 16;        // thread grid (TY x TX)
constexpr int TX = 16;
constexpr int RM = BM / TY;   // 8 accumulator rows per thread
constexpr int RN = BN / TX;   // 8 accumulator columns per thread
constexpr int PAD = BM + 1;   // shared row stride (floats)
constexpr int NT = TY * TX;

__global__ void __launch_bounds__(NT)
minplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int m, int n, int k) {
    __shared__ float as[BK][PAD];
    __shared__ float bs[BK][PAD];

    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int tid = ty * TX + tx;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < k; k0 += BK) {
        // A warp reads 32 consecutive k of one row: coalesced in k.
#pragma unroll
        for (int s = 0; s < BM * BK / NT; ++s) {
            const int idx = tid + s * NT;
            const int r = idx / BK;
            const int c = idx % BK;
            const int kk = k0 + c;
            const int ra = row0 + r;
            const int rb = col0 + r;
            as[c][r] = (ra < m && kk < k) ? a[(size_t)ra * k + kk] : 0.0f;
            bs[c][r] = (rb < n && kk < k) ? b[(size_t)rb * k + kk] : 0.0f;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float av[RM], bv[RN];
#pragma unroll
            for (int i = 0; i < RM; ++i) av[i] = as[c][ty + TY * i];
#pragma unroll
            for (int j = 0; j < RN; ++j) bv[j] = bs[c][tx + TX * j];
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] += fminf(av[i], bv[j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int r = row0 + ty + TY * i;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < RN; ++j) {
            const int c = col0 + tx + TX * j;
            if (c < n) out[(size_t)r * n + c] = acc[i][j];
        }
    }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` (PyTorch's current
// stream), does not synchronize, and returns cudaGetLastError() so a
// refused launch is reported to the caller. m, n >= 1 and k >= 0.
extern "C" int grl_minplus_f32(const float* a, const float* b, float* out,
                               int m, int n, int k, void* stream) {
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    dim3 block(TX, TY);
    minplus_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, m, n, k);
    return static_cast<int>(cudaGetLastError());
}
