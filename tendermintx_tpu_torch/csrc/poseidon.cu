// Batched width-12 Poseidon permutation over Goldilocks on Hopper.
//
// Replaces the reference's TPU kernel tendermintx_tpu/ops/poseidon_pallas.py
// (`_kernel`, reached through `pl.pallas_call` at :182) and its XLA twin
// ops/poseidon.py::_permute_xla: 30 rounds (4 full, 22 partial, 4 full),
// x^7 S-box, and an MDS matrix with 7-bit entries. The TPU kernel emulates
// 64-bit products with 16-bit pieces and runs the MDS layer as eight exact
// bf16 limb-plane dots on the MXU, because the TPU has neither a 64-bit
// multiply nor an integer matrix unit. Hopper has a native 64x64 -> 128-bit
// product (`*` plus `__umul64hi`), so none of that carries over.
//
// Bound: integer multiply throughput. A permutation is ~470 full field
// multiplies (S-boxes) and 360 7-bit x 64-bit MDS products against only 192
// bytes of state traffic. The design keeps everything in registers: one
// thread per state, the 12 limbs as uint64_t, round constants and the MDS
// matrix in __constant__ memory (every thread of a warp reads the same
// entry, the broadcast case constant memory serves in one access). Each MDS
// row accumulates its 12 products (< 2^71 each) in a 128-bit (lo, carry)
// pair and reduces once, as the Pallas kernel does after its carry chain.
//
// Layout: row-major (B, 12) canonical uint64 states, the layout of the
// port's `permute` API. The kernel allocates nothing; the wrapper
// (tendermintx_tpu_torch/ops/poseidon.py) allocates the output.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIDTH = 12;
constexpr int N_ROUNDS = 30;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;

__constant__ uint64_t c_rc[N_ROUNDS][WIDTH];
__constant__ uint64_t c_mds[WIDTH][WIDTH];

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += EPS;
    return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
    uint64_t hi_hi = hi >> 32;
    uint64_t hi_lo = hi & 0xFFFFFFFFULL;
    uint64_t t = lo - hi_hi;
    if (lo < hi_hi) t -= EPS;
    uint64_t m = (hi_lo << 32) - hi_lo;
    uint64_t s = t + m;
    if (s < t) s += EPS;
    return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
    return gl_reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sbox7(uint64_t x) {
    uint64_t x2 = gl_mul(x, x);
    uint64_t x3 = gl_mul(x2, x);
    uint64_t x4 = gl_mul(x2, x2);
    return gl_mul(x3, x4);
}

__device__ __forceinline__ void mds_apply(uint64_t s[WIDTH]) {
    uint64_t out[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        uint64_t lo = 0, hi = 0;
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) {
            uint64_t m = c_mds[i][j];
            uint64_t plo = m * s[j];
            uint64_t phi = __umul64hi(m, s[j]);
            lo += plo;
            hi += phi + (lo < plo);
        }
        out[i] = gl_reduce128(lo, hi);
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = out[i];
}

__global__ void poseidon_permute_kernel(const uint64_t* __restrict__ in,
                                        uint64_t* __restrict__ out,
                                        int64_t n) {
    int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < n;
         b += stride) {
        uint64_t s[WIDTH];
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) s[j] = in[b * WIDTH + j];
        int r = 0;
        for (int k = 0; k < HALF_FULL; ++k, ++r) {
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(gl_add(s[j], c_rc[r][j]));
            mds_apply(s);
        }
        for (int k = 0; k < PARTIAL; ++k, ++r) {
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) s[j] = gl_add(s[j], c_rc[r][j]);
            s[0] = sbox7(s[0]);
            mds_apply(s);
        }
        for (int k = 0; k < HALF_FULL; ++k, ++r) {
#pragma unroll
            for (int j = 0; j < WIDTH; ++j) s[j] = sbox7(gl_add(s[j], c_rc[r][j]));
            mds_apply(s);
        }
#pragma unroll
        for (int j = 0; j < WIDTH; ++j) out[b * WIDTH + j] = s[j];
    }
}

}  // namespace

// Copy the round constants (N_ROUNDS x WIDTH) and the MDS matrix
// (WIDTH x WIDTH), both host uint64 arrays, to the current device.
extern "C" int tmx_poseidon_set_params(const uint64_t* rc, const uint64_t* mds) {
    cudaError_t e = cudaMemcpyToSymbol(c_rc, rc, sizeof(c_rc));
    if (e != cudaSuccess) return (int)e;
    e = cudaMemcpyToSymbol(c_mds, mds, sizeof(c_mds));
    return (int)e;
}

// Permute n states: in/out are device pointers to (n, 12) uint64.
extern "C" int tmx_poseidon_permute(const void* in, void* out, int64_t n,
                                    void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    int64_t want = (n + threads - 1) / threads;
    int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
    poseidon_permute_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n);
    return (int)cudaGetLastError();
}
