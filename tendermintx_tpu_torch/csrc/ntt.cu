// The batched number-theoretic transform over Goldilocks on Hopper: the
// forward NTT, the inverse NTT and the coset low-degree extension of rows
// of canonical uint64 values, on the last axis (ops/ntt.py binds it with
// ctypes and plans its passes).
//
// Replaces the XLA programs of tendermintx_tpu/ops/ntt.py:86 `ntt`, :114
// `intt` and :139 `coset_lde` (radix-2 stages, jitted by the prover as
// tendermintx_tpu/stark/prover.py:643 `_trace_lde_fn`, :634 `_chunk_lde_fn`
// and :654 `_coset_intt_fn`).
//
// Bound: a transform of R rows reads each input word once and writes each
// output word once; it does (N/2) log2 N butterfly multiplies a row (a
// coset LDE of an n-point row into N = n * 2^r points needs only 2^r
// n-point transforms and N twists, (N/2) log2 n + N), each 4 32-bit
// multiply-adds. At the main path's shapes the bytes and the multiplies
// take about as long (chip_smoke.py prints both).
//
// Schedule: decimation in time. The row is read in bit-reversed order and
// radix-2 stage s pairs positions i and i + 2^s inside blocks of 2^(s+1)
// with the twiddle w_N^((i mod 2^s) * 2^(L-1-s)), L = log2 N, as the plain
// version's stages do. The stages are cut into passes of at most
// MAX_STAGES (ops/ntt.py::ntt_plan). A pass over stages [s0, s0 + k)
// touches, for each (hi, lo), only the 2^k positions
//
//     i = hi * 2^(s0+k) + mid * 2^s0 + lo,   mid in [0, 2^k),
//
// a "line"; line l of a row has lo = l mod 2^s0, hi = l >> s0. A block
// loads `lines` lines into shared memory, runs the k stages there and
// writes the lines back, so a pass reads and writes each word once.
// Consecutive lines differ in lo, so a warp loads and stores runs of
// `lines` consecutive words. The first pass reads the input through the
// bit reversal: position i = rev(l) * 2^k + mid holds
// x[rev_k(mid) * 2^(L-k) + l], so consecutive lines again read consecutive
// words, and it stores mid-fastest, each line a contiguous run. Later
// passes work in place on the output.
//
// The three entries differ only in their tables: the inverse takes the
// inverse root's twiddles and multiplies every output by n^-1 (and by an
// optional per-index table, the coset iNTT's shift^-i) in its last pass;
// the coset LDE multiplies input i by shift^i as its first pass reads it
// and reads every input index >= n as zero, so the zero-padded vector is
// never stored. Every field value stays canonical (goldilocks.cuh), so the
// output equals the plain torch version bit for bit.
//
// Entry, with a plain C interface:
//   tmx_ntt   the passes of one transform of `rows` rows, each launched on
//             the caller's stream; returns the first CUDA error.
// The kernel allocates nothing; the wrapper allocates the output.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_STAGES = 10;  // ops/ntt.py: MAX_STAGES
constexpr int MIN_LINES = 8;    // lines a block at least: 64-byte runs
constexpr int MIN_TILE_LOG = 11;  // a block holds at least 2^11 words
constexpr int THREADS = 256;

struct Pass {
    const uint64_t* src;   // first pass: the input (rows, 2^log_n)
    uint64_t* dst;         // the output (rows, 2^log_N); later passes read it
    const uint64_t* tw;    // w^u for u in [0, N/2), w the direction's root
    const uint64_t* pre;   // first pass: factor of input index j (or null)
    const uint64_t* post;  // last pass: factor of output index i (or null)
    uint64_t post_scalar;  // last pass: factor of every output (1: none)
    int64_t rows;
    int log_n;  // input length
    int log_N;  // transform length
    int s0;     // first stage of the pass
    int k;      // stages in the pass
    int lines;  // lines a block
    int first;
    int last;
};

__device__ __forceinline__ int64_t rev_bits(int64_t x, int bits) {
    return bits ? (int64_t)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

__global__ void __launch_bounds__(THREADS) tmx_ntt_pass(Pass a) {
    extern __shared__ uint64_t tile[];  // word (mid, line) at mid * (lines + 1) + line
    const int k = a.k, s0 = a.s0, G = a.lines, S = a.lines + 1;
    const int M = 1 << k;
    const int E = M * G;
    const int lbits = a.log_N - k;  // a line's index within its row
    const int64_t N = int64_t(1) << a.log_N;
    const int64_t n_in = int64_t(1) << a.log_n;
    const int64_t total = a.rows << lbits;
    const int64_t line0 = int64_t(blockIdx.x) * G;
    const int64_t l_mask = (int64_t(1) << lbits) - 1;
    const int64_t lo_mask = (int64_t(1) << s0) - 1;

    for (int e = threadIdx.x; e < E; e += THREADS) {
        const int ln = e % G, mid = e / G;
        const int64_t g = line0 + ln;
        uint64_t v = 0;
        if (g < total) {
            const int64_t row = g >> lbits, l = g & l_mask;
            if (a.first) {
                const int64_t j = (rev_bits(mid, k) << lbits) | l;
                if (j < n_in) {
                    v = a.src[row * n_in + j];
                    if (a.pre) v = tmx_gl::mul(v, a.pre[j]);
                }
            } else {
                v = a.dst[row * N + (((l >> s0) << (s0 + k)) | (int64_t(mid) << s0) | (l & lo_mask))];
            }
        }
        tile[mid * S + ln] = v;
    }
    __syncthreads();

    for (int t = 0; t < k; ++t) {
        const int h = 1 << t;
        const int tw_shift = a.log_N - 1 - (s0 + t);
        for (int b = threadIdx.x; b < E / 2; b += THREADS) {
            const int ln = b % G, p = b / G;
            const int j = p & (h - 1);
            const int m0 = ((p >> t) << (t + 1)) | j, m1 = m0 | h;
            const int64_t lo = (line0 + ln) & l_mask & lo_mask;
            const uint64_t w = a.tw[((int64_t(j) << s0) | lo) << tw_shift];
            const uint64_t x0 = tile[m0 * S + ln];
            const uint64_t x1 = tmx_gl::mul(tile[m1 * S + ln], w);
            tile[m0 * S + ln] = tmx_gl::add(x0, x1);
            tile[m1 * S + ln] = tmx_gl::sub(x0, x1);
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < E; e += THREADS) {
        const int ln = a.first ? e / M : e % G;
        const int mid = a.first ? e % M : e / G;
        const int64_t g = line0 + ln;
        if (g >= total) continue;
        const int64_t row = g >> lbits, l = g & l_mask;
        const int64_t i = a.first ? ((rev_bits(l, lbits) << k) | mid)
                                  : (((l >> s0) << (s0 + k)) | (int64_t(mid) << s0) | (l & lo_mask));
        uint64_t v = tile[mid * S + ln];
        if (a.last) {
            if (a.post_scalar != 1) v = tmx_gl::mul(v, a.post_scalar);
            if (a.post) v = tmx_gl::mul(v, a.post[i]);
        }
        a.dst[row * N + i] = v;
    }
}

}  // namespace

// One transform: the passes ks[0..n_passes) (their stage counts sum to
// log_N) over `rows` rows of 2^log_n input words into (rows, 2^log_N).
extern "C" int tmx_ntt(const uint64_t* src, uint64_t* dst, const uint64_t* tw, const uint64_t* pre,
                       const uint64_t* post, uint64_t post_scalar, int64_t rows, int log_n, int log_N,
                       const int* ks, int n_passes, void* stream) {
    if (rows <= 0) return 0;
    if (log_n < 0 || log_n > log_N || log_N > 31 || n_passes < 1) return (int)cudaErrorInvalidValue;
    int sum = 0;
    for (int p = 0; p < n_passes; ++p) {
        if (ks[p] < 0 || ks[p] > MAX_STAGES || (ks[p] == 0 && log_N > 0)) return (int)cudaErrorInvalidValue;
        sum += ks[p];
    }
    if (sum != log_N) return (int)cudaErrorInvalidValue;
    Pass a{src, dst, tw, pre, post, post_scalar, rows, log_n, log_N, 0, 0, 0, 0, 0};
    for (int p = 0; p < n_passes; ++p) {
        a.k = ks[p];
        a.first = p == 0;
        a.last = p == n_passes - 1;
        const int tile_log = a.k + 3 > MIN_TILE_LOG ? a.k + 3 : MIN_TILE_LOG;
        a.lines = 1 << (tile_log - a.k);
        if (a.lines < MIN_LINES) a.lines = MIN_LINES;
        const int64_t total = rows << (log_N - a.k);
        const int64_t blocks = (total + a.lines - 1) / a.lines;
        const size_t smem = sizeof(uint64_t) * ((size_t)1 << a.k) * (size_t)(a.lines + 1);
        if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
        cudaError_t err = cudaFuncSetAttribute(tmx_ntt_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        tmx_ntt_pass<<<(int)blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        a.s0 += a.k;
    }
    return 0;
}
