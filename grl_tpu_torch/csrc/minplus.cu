// Min-plus "matmul" for Hopper (sm_90a): S[i, j] = sum_t min(A[i, t], B[j, t]).
//
// Replaces the Pallas TPU kernel grl_tpu/ops/minplus.py::_minplus_kernel
// (pallas_call at minplus.py:84), the Jaccard min-sum of k-reciprocal
// re-ranking (grl_tpu/engine/rerank.py:210). A is (m, k) with row stride
// lda, B is (n, k) with row stride ldb, both fp32 with unit column stride,
// 16-byte aligned rows and non-negative values; S is (m, n) fp32, contiguous.
//
// Bounds at the MARS shape (m = 1980, n = k = 13290: 3.50e11 triples).
// - Data sheet: `min` is not a multiply-add, so no tensor-core path applies;
//   each (i, j, t) triple is one FMNMX and one FADD on the CUDA cores, and
//   the two cannot fuse. Against the 67 TFLOP/s fp32 peak (which counts an
//   FMA as two) the 7.0e11 operations take 10.44 ms.
// - Issue: Hopper has no packed fp32 add and no 3-input float min, so each
//   triple is two issued instructions: 7.0e11 / (132 SMs x 4 schedulers x 32
//   lanes x 1.98 GHz) = ~20.9 ms at boost clock. FMNMX runs on the 16-lane
//   ALU pipe, one warp instruction per two clocks, beside FADD on the FMA pipe.
// - Bytes: 0.92 GB, 0.27 ms at 3.35 TB/s. Bound by instruction issue.
//
// The first design (128x128 tiles on a 2-D grid, single-buffered scalar
// staging, scalar shared-memory reads) measured 32.3 ms on an NVIDIA H100
// 80GB HBM3 at 700 W; this one 24.7 ms (PERF.md). Per loss:
// 1. Staging overlaps compute and costs the SMs no instructions. One thread
//    issues two TMA copies (A's 128 rows, B's 256 rows, 32 k each) per
//    chunk into a ring of STAGES = 3 slots in dynamic shared memory
//    (147,456 B), completing on one mbarrier per slot; the block computes
//    chunk i while chunks i + 1 and i + 2 land, with one __syncthreads per
//    chunk before its slot is refilled. TMA zero-fills past m, n and k, so
//    ragged edges need no masks (min(0, 0) adds nothing). TMA needs 16-byte
//    aligned rows: re-ranking builds V in rows padded to 4 floats, and the
//    wrapper copies any other operand into such rows. Staging with 4-byte
//    cp.async instead cost 3.4 ms here in load/store-pipe instructions.
//    No transposed copy of B is made.
// 2. Shared-memory reads are 16 bytes. Slabs are [row][k], one 128-byte row
//    of 32 k per operand row, in TMA's 128-byte swizzle (16-byte group g of
//    row r stored at g ^ (r % 8)). A thread owns A rows a_row + 4 r (r < 8)
//    and B rows b_row + 8 q (q < 16) and reads 4 k of each as one LDS.128:
//    24 LDS.128 per 512 triples (1,024 math instructions), 2 % of issue
//    against 11 % for scalar reads. The 8 B rows a warp reads at once have
//    distinct r % 8, as do its 4 A rows, so both reads are conflict-free.
// 3. The schedule is balanced. The grid is persistent (every block slot of
//    the card, from the occupancy query: one 128x256 block per SM) and walks
//    the tiles; tiles that fill whole rounds run at full k, and the tiles of
//    the last, partial round are split along k so that round holds about as
//    many units as there are slots (at MARS: 832 tiles on 132 slots, 6
//    rounds and 40 tiles split in 3, 6.33 rounds of work instead of 7). Each
//    part writes its partial tile to a workspace; the last part to finish (a
//    per-tile counter) adds the parts in the fixed order 0, 1, ... and stores
//    the tile, so the result does not depend on which block finished last.
//    Split sums are taken in another order than one sequential pass; the
//    difference stays far inside the 1e-5 absolute tolerance the tests and
//    chip_smoke.py hold the kernel to (sums of row-normalized values <= 1).
//    The split count depends on the card's slot count, so cards with other
//    SM counts may differ in the last bits.
// 4. What remains: the last row tile at m = 1980 computes 68 padded rows
//    (3 % of the work), and the loop, 97 % FMNMX/FADD, issues below one
//    instruction per clock per scheduler (ptxas assigns registers and
//    stalls; `ncu` does not run where this was measured).
// The tile is 128 x 256 at one block per SM (8 x 16 accumulators per
// thread), 3 stages, 8 k-steps unrolled: the fastest of the variants timed
// on the card (128 x 128 at two blocks per SM, 2 or 4 stages, unroll 4 or
// 16 were slower; PERF.md).

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace {

constexpr int BM = 128;              // rows of A per tile
constexpr int BN = 256;              // rows of B per tile
constexpr int BK = 32;               // k-chunk per pipeline stage: one 128-byte row per operand row
constexpr int STAGES = 3;            // k-chunks in the shared-memory ring
constexpr int NT = 256;              // threads per block: 8 warps, 4 (M) x 2 (N)
constexpr int RN = BN / 16;          // B rows (output columns) per thread
constexpr int A_BYTES = BM * BK * 4;
constexpr int STAGE_BYTES = (BM + BN) * BK * 4;
// the ring, 1024 bytes of slack to align it for the 128-byte swizzle, the
// ring's mbarriers and the split-k flag
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 8 * STAGES + 16;
constexpr int TILE = BM * BN;        // floats of one partial tile in the workspace
static_assert(BK * 4 == 128, "a chunk row is one 128-byte swizzle row");
static_assert(BN <= 256, "a TMA box is at most 256 rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier has completed the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One TMA copy of the box at (k0, row0) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int k0, int row0,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(bar)
        : "memory");
}

// Fill one ring slot with k-chunk c of the tile at (row0, col0): A's rows,
// then B's. TMA zero-fills rows past m or n and k past k: min(0, 0) adds
// nothing.
__device__ __forceinline__ void load_chunk(uint32_t dst, uint32_t bar, const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, int c, int row0, int col0) {
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load(dst, map_a, c * BK, row0, bar);
    tma_load(dst + A_BYTES, map_b, c * BK, col0, bar);
}

// Sum over 4 k of min(a, b), in k order.
__device__ __forceinline__ float minsum4(float acc, float4 a, float4 b) {
    acc += fminf(a.x, b.x);
    acc += fminf(a.y, b.y);
    acc += fminf(a.z, b.z);
    return acc + fminf(a.w, b.w);
}

__global__ void __launch_bounds__(NT, 1)
minplus_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               float* __restrict__ out, int m, int n, int k, float* __restrict__ workspace,
               int* __restrict__ counters, int dp_tiles, int splits) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023) & ~1023u;  // 128-byte swizzle atoms are 1024-byte aligned
    const unsigned char* smem = smem_raw + (ring - raw);
    const uint32_t bars = ring + STAGES * STAGE_BYTES;
    int* s_last = reinterpret_cast<int*>(smem_raw + (bars - raw) + 8 * STAGES);

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tm = lane >> 3;
    const int tn = lane & 7;
    // The thread's rows of the [row][k] slabs: A rows a_row + 4 r (r < 8) and
    // B rows b_row + 8 q (q < RN). In the 128-byte swizzle, 16-byte group g of
    // row r sits at group g ^ (r % 8): the 8 B rows a warp reads at once have
    // r % 8 = tn and the 4 A rows r % 8 = tm or tm + 4, so both reads are
    // conflict-free.
    const int a_row = (warp & 3) * 32 + tm;
    const int b_row = (warp >> 2) * (BN / 2) + tn;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int tiles_m = (m + BM - 1) / BM;
    const int tiles = tiles_m * ((n + BN - 1) / BN);
    const int chunks = (k + BK - 1) / BK;
    const int units = dp_tiles + (tiles - dp_tiles) * splits;
    uint32_t used = 0;  // chunks this block has taken from the ring so far

    for (int u = blockIdx.x; u < units; u += gridDim.x) {
        // unit -> (tile, k-chunk range); split units of one tile are adjacent
        int tile = u, part = 0, c_begin = 0, c_end = chunks;
        if (u >= dp_tiles) {
            const int idx = u - dp_tiles;
            tile = dp_tiles + idx / splits;
            part = idx % splits;
            c_begin = static_cast<int>(static_cast<int64_t>(chunks) * part / splits);
            c_end = static_cast<int>(static_cast<int64_t>(chunks) * (part + 1) / splits);
        }
        const int row0 = (tile % tiles_m) * BM;
        const int col0 = (tile / tiles_m) * BN;
        const int nc = c_end - c_begin;

        // thread 0 fills ring slot (used + i) % STAGES with the unit's chunk i
        if (tid == 0)
            for (int s = 0; s < STAGES - 1 && s < nc; ++s) {
                const uint32_t slot = (used + s) % STAGES;
                load_chunk(ring + slot * STAGE_BYTES, bars + 8 * slot, &map_a, &map_b, c_begin + s,
                           row0, col0);
            }

        float acc[8][RN];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

        for (int i = 0; i < nc; ++i) {
            const uint32_t slot = (used + i) % STAGES;
            mbar_wait(bars + 8 * slot, ((used + i) / STAGES) & 1);
            __syncthreads();  // every thread is done with chunk i - 1, whose slot the next copy fills
            if (tid == 0 && i + STAGES - 1 < nc) {
                const uint32_t next = (used + i + STAGES - 1) % STAGES;
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                load_chunk(ring + next * STAGE_BYTES, bars + 8 * next, &map_a, &map_b,
                           c_begin + i + STAGES - 1, row0, col0);
            }
            const unsigned char* as = smem + slot * STAGE_BYTES + a_row * 128;
            const unsigned char* bs = smem + slot * STAGE_BYTES + A_BYTES + b_row * 128;
#pragma unroll 2  // two 4-k quads: 8 k-steps per unrolled body
            for (int g = 0; g < BK / 4; ++g) {
                float4 av[8];
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    av[r] = *reinterpret_cast<const float4*>(
                        as + r * 512 + ((g ^ (tm + 4 * (r & 1))) << 4));
#pragma unroll
                for (int q = 0; q < RN; ++q) {
                    const float4 bv = *reinterpret_cast<const float4*>(bs + q * 1024 + ((g ^ tn) << 4));
#pragma unroll
                    for (int r = 0; r < 8; ++r) acc[r][q] = minsum4(acc[r][q], av[r], bv);
                }
            }
        }
        used += nc;
        __syncthreads();  // the next unit's first copies overwrite the ring

        if (u >= dp_tiles && splits > 1) {
            // park this part; the last part of the tile to arrive sums them all
            const int tail = tile - dp_tiles;
            float* parts = workspace + static_cast<int64_t>(tail) * splits * TILE;
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int q = 0; q < RN; ++q)
                    __stcg(parts + static_cast<int64_t>(part) * TILE + (r * RN + q) * NT + tid,
                           acc[r][q]);
            __threadfence();
            __syncthreads();
            if (tid == 0) *s_last = atomicAdd(counters + tail, 1) == splits - 1;
            __syncthreads();
            if (!*s_last) continue;
            __threadfence();
#pragma unroll
            for (int r = 0; r < 8; ++r)
#pragma unroll
                for (int q = 0; q < RN; ++q) {
                    float s = 0.0f;
                    for (int p = 0; p < splits; ++p)
                        s += __ldcg(parts + static_cast<int64_t>(p) * TILE + (r * RN + q) * NT + tid);
                    acc[r][q] = s;
                }
        }

#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int row = row0 + a_row + 4 * r;
            if (row >= m) continue;
            float* orow = out + static_cast<int64_t>(row) * n;
#pragma unroll
            for (int q = 0; q < RN; ++q) {
                const int col = col0 + b_row + 8 * q;
                if (col < n) orow[col] = acc[r][q];
            }
        }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded;
// looked up at run time so the library links against the runtime alone.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (cuda == nullptr) cuda = dlopen("libcuda.so.1", RTLD_NOW);
        if (cuda != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(cuda, "cuTensorMapEncodeTiled"));
    }
    return fn;
}

// The TMA map of a (rows, k) fp32 operand with row stride ld floats: boxes
// of BK x box_rows, 128-byte swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const float* x, int rows, int k, int ld, int box_rows) {
    const EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
    const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t elem[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Tile shape and block slots per SM, for the wrapper's schedule:
// cfg = {BM, BN, BK, blocks per SM}. Sets the kernel's dynamic shared-memory
// limit on the current device, which grl_minplus_f32 needs: call this once
// per device before launching there. Returns a CUDA error code.
extern "C" int grl_minplus_config(int* cfg) {
    cudaError_t err = cudaFuncSetAttribute(minplus_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, minplus_kernel, NT, SMEM_BYTES);
    cfg[0] = BM;
    cfg[1] = BN;
    cfg[2] = BK;
    cfg[3] = blocks;
    return static_cast<int>(err);
}

// Plain C entry point for ctypes. Launches `grid` persistent blocks on
// `stream` (PyTorch's current stream; grl_minplus_config has run on its
// device), does not synchronize, and returns
// cudaGetLastError() so a refused launch is reported to the caller, or
// cudaErrorInvalidValue when an operand cannot be described to TMA.
// m, n >= 1, k >= 0. When k > 0, a and b are 16-byte aligned with row
// strides lda, ldb >= k that are multiples of 4 floats. Tiles [0, dp_tiles)
// run whole; the rest run in `splits` k-parts, which need `workspace`
// (tiles - dp_tiles) x splits x BM x BN floats and `counters`
// (tiles - dp_tiles) zeroed ints (both unused, and may be null, when
// splits == 1).
extern "C" int grl_minplus_f32(const float* a, const float* b, float* out, int m, int n, int k,
                               int lda, int ldb, float* workspace, int* counters, int grid,
                               int dp_tiles, int splits, void* stream) {
    CUtensorMap map_a = {}, map_b = {};
    if (k > 0 && !(encode(&map_a, a, m, k, lda, BM) && encode(&map_b, b, n, k, ldb, BN)))
        return static_cast<int>(cudaErrorInvalidValue);
    minplus_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        map_a, map_b, out, m, n, k, workspace, counters, dp_tiles, splits);
    return static_cast<int>(cudaGetLastError());
}
