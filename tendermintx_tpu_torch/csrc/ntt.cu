// The batched number-theoretic transform over Goldilocks on Hopper: the
// forward NTT, the inverse NTT and the coset low-degree extension of rows
// of canonical uint64 values, on the last axis (ops/ntt.py binds it with
// ctypes, plans its passes and holds its plain twin, schedule_plain).
//
// Replaces the XLA programs of tendermintx_tpu/ops/ntt.py:86 `ntt`, :114
// `intt` and :139 `coset_lde` (radix-2 stages, jitted by the prover as
// tendermintx_tpu/stark/prover.py:643 `_trace_lde_fn`, :634 `_chunk_lde_fn`
// and :654 `_coset_intt_fn`).
//
// Bound: a transform of R rows reads each input word once and writes each
// output word once; a coset LDE of an n-point row into N = n 2^rate
// points is 2^rate n-point transforms and N twists. The kernel is bound by
// its integer issue (about 25 instructions a field multiply) as much as
// by its bytes, so the design cuts both the instructions per element and
// the passes over the output.
//
// Schedule: the six-step form. log2 N = K0 + K1 (+ K2) stages in 1-3
// passes of at most MAX_K (ops/ntt.py::ntt_plan). Pass 0 takes line l <
// 2^(log N - K0) of each row: the inputs l + e 2^(log n - k) for its k =
// K0 - rate digits e, once for each of the C = 2^rate cosets t, times
// F[e C + t] = shift^(e 2^(log n - k)) w_{2^K0}^(t e) (no butterfly on
// the zero padding: each coset is a 2^k-point DFT), then the DFT, then
// ONE twist a output, S[l] w_N^(l u) for u = t + C u_k, then the line's
// run of 2^K0 outputs is stored contiguously at u + rest(l) 2^K0 (rest:
// l's later-pass digits reversed). Pass p > 0 over stages [s, s + K)
// takes line D + R 2^s and transforms positions D + e 2^s + R 2^(s + K)
// in place; a middle pass twists output u by w_N^(R u 2^s), the last
// writes the natural order and multiplies by the optional power table
// (the coset iNTT's shift^-i). n^-1 rides in S (one pass: at the end).
//
// A block first stages its lines into shared memory with cp.async (every
// copy of the block in flight at once; the inputs land where round 0
// reads them in place), then runs the pass's 2^k-point DFT in register
// rounds (round_digits: 3+3+3, 4+4, 4+3, 3+3, 3+2 or one): each thread
// holds a radix-2^d sub-transform (up to 16 values) in registers and the
// block's tile of 2^13 words (2^(13-k) lines, 64 KiB) is touched once a
// round; decimation in time, so the last round leaves the natural order
// in place. Every line uses the pass's 2^k-point root table in shared memory
// between rounds and the 16th root's powers (kernel arguments) inside
// them; the twist between passes is a progression, base * step^i, from
// two table reads a thread. Consecutive threads take consecutive lines,
// so shared accesses between rounds hit one address a line; the tile's
// only transposed access (pass 0's store of contiguous runs) is
// conflict-free through the swizzle vl ^ ((u_k << rate) & 15). Passes are
// templates on k and the lines a block (2^(13-k), or a quarter of that,
// at least 16, when full tiles would leave the card's SMs short of
// blocks: transforms of few rows); within a row every index is
// 32-bit and every split a shift or mask. Every field value stays
// canonical (goldilocks.cuh), so the output equals the plain torch
// version bit for bit.
//
// Entry, with a plain C interface:
//   tmx_ntt   the passes of one transform of `rows` rows, each launched on
//             the caller's stream; returns the first CUDA error.
// The kernel allocates nothing; the wrapper allocates the output.

#include <cstdint>
#include <climits>
#include <utility>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_K = 9;       // ops/ntt.py: MAX_K
constexpr int TILE = 1 << 13;  // words of a block's tile (64 KiB)
constexpr int MAX_PASSES = 3;  // ops/ntt.py: MAX_PASSES
constexpr int THREADS = 256;

// ops/ntt.py::round_digits: the register rounds of a 2^k-point DFT (digit
// r of round r, the first the widest)
__host__ __device__ constexpr int n_rounds(int k) { return k == 9 ? 3 : k >= 5 ? 2 : 1; }
__host__ __device__ constexpr int digit(int k, int r) {
    return k == 9 ? 3 : k == 8 ? 4 : k == 7 ? (r ? 3 : 4) : k == 6 ? 3 : k == 5 ? (r ? 2 : 3) : k;
}
__host__ __device__ constexpr int rmax(int k) { return digit(k, 0); }
__host__ __device__ constexpr int digits_before(int k, int r) { return r == 0 ? 0 : digit(k, r - 1) + digits_before(k, r - 1); }
__host__ __device__ constexpr int log2c(int x) { return x <= 1 ? 0 : 1 + log2c(x >> 1); }
// i's d low bits reversed, as a constant (Rev<i, d>::value), so that the
// register sub-transforms index their arrays with constants only
__host__ __device__ constexpr int rev_bits(int i, int d) { return d == 0 ? 0 : ((i & 1) << (d - 1)) | rev_bits(i >> 1, d - 1); }
template <int i, int d>
struct Rev {
    static constexpr int value = rev_bits(i, d);
};

struct Pass {
    const uint64_t* src;   // pass 0: rows of 2^log_n inputs
    uint64_t* dst;         // rows of 2^log_N outputs; later passes work in place
    const uint64_t* tw;    // w_N^u for u < max(1, N/2)
    const uint64_t* W;     // w_{2^k}^i for i < 2^k: the pass DFT's roots
    const uint64_t* F;     // pass 0: F[e C + t], or null (all ones)
    const uint64_t* S;     // pass 0: S[l], or null (all ones)
    const uint64_t* post;  // last pass: factor of output i, or null
    uint64_t scale;        // one pass: factor of every output
    uint64_t r16[16];      // powers of the 16th root of the direction
    uint32_t lines;        // lines of the pass over all rows
    int log_n, log_N, rate;
    int s;         // first stage of the pass
    int K;         // stages of the pass (pass 0: k + rate)
    int K1, K2;    // pass 0: the later passes' stages
    int passes;
    int last;      // a later pass: the last one
};

__device__ __forceinline__ uint64_t omega(const Pass& a, uint32_t e) {
    const uint32_t half = a.log_N ? 1u << (a.log_N - 1) : 1u;
    return e < half ? a.tw[e] : tmx_gl::neg(a.tw[e - half]);
}

// radix-2 stages st.. of a 2^d-point DIT on bit-reversed y: pairs at
// distance h = 2^st, twiddles w_{2h}^j = r16[j 16 / 2h]
template <int d, int st>
__device__ __forceinline__ void dit_stages(uint64_t* y, const uint64_t (&r16)[16]) {
    if constexpr (st < d) {
        constexpr int h = 1 << st, M = 1 << d;
#pragma unroll
        for (int blk = 0; blk < M; blk += 2 * h) {
#pragma unroll
            for (int j = 0; j < h; ++j) {
                uint64_t b = y[blk + j + h];
                if (j) b = tmx_gl::mul(b, r16[j * (16 >> (st + 1))]);
                const uint64_t a0 = y[blk + j];
                y[blk + j] = tmx_gl::add(a0, b);
                y[blk + j + h] = tmx_gl::sub(a0, b);
            }
        }
        dit_stages<d, st + 1>(y, r16);
    }
}

template <int d, int... I>
__device__ __forceinline__ void bit_reversed(uint64_t* y, const uint64_t* x, std::integer_sequence<int, I...>) {
    ((y[I] = x[Rev<I, d>::value]), ...);
}

// the 2^d-point DFT of x[0, 2^d) in registers, natural order in and out
template <int d>
__device__ __forceinline__ void dft_regs(uint64_t* x, const uint64_t (&r16)[16]) {
    constexpr int M = 1 << d;
    uint64_t y[M];
    bit_reversed<d>(y, x, std::make_integer_sequence<int, M>{});
    dit_stages<d, 0>(y, r16);
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = y[i];
}

// word (pos, vl) of a tile of VL lines: pos-major, the line index
// swizzled by pos (swm 15 in pass 0, whose store reads the tile across
// positions; 0 in later passes)
template <int VL>
__device__ __forceinline__ uint32_t phys(uint32_t pos, uint32_t vl, int rate, uint32_t swm) {
    return pos * VL + (vl ^ ((pos << rate) & swm));
}

// Round r >= 1 of a pass's 2^k-point DFT: each item (vl, gam) holds
// 2^(RM - d) groups, each a 2^d-point sub-transform of item (vp, rho):
// positions vp + e 2^S + rho 2^(S + d), twiddles w_{2^(S+d)}^(e vp) from
// the root table, outputs written over the same positions (or given to
// finish in the last round).
template <int k, int r, int VL, class Finish>
__device__ __forceinline__ void pass_round(uint64_t* tile, const uint64_t* Ws, const Pass& a, int rate, uint32_t swm,
                                           Finish& finish) {
    constexpr int M = n_rounds(k), RM = rmax(k), d = digit(k, r), S = digits_before(k, r);
    constexpr int ITEMS = VL << (k - RM), LVL = log2c(VL);
    __syncthreads();
    for (int it = threadIdx.x; it < ITEMS; it += THREADS) {
        const uint32_t vl = it & (VL - 1), gam = it >> LVL;
#pragma unroll
        for (int g = 0; g < (1 << (RM - d)); ++g) {
            const uint32_t nu = (gam << (RM - d)) + g;
            const uint32_t vp = nu & ((1u << S) - 1), rho = nu >> S;
            uint64_t y[1 << d];
#pragma unroll
            for (int e = 0; e < (1 << d); ++e) {
                y[e] = tile[phys<VL>(vp + (uint32_t(e) << S) + (rho << (S + d)), vl, rate, swm)];
                if (e) y[e] = tmx_gl::mul(y[e], Ws[(uint32_t(e) * vp) << (k - S - d)]);
            }
            dft_regs<d>(y, a.r16);
            if constexpr (r == M - 1) {
                finish(vl, vp, y);
            } else {
#pragma unroll
                for (int e = 0; e < (1 << d); ++e)
                    tile[phys<VL>(vp + (uint32_t(e) << S) + (rho << (S + d)), vl, rate, swm)] = y[e];
            }
        }
    }
    if constexpr (r + 1 < M) pass_round<k, r + 1, VL>(tile, Ws, a, rate, swm, finish);
}

// round 0's in-place position of item lam's outputs: v + rev(lam) 2^d0,
// rev reversing lam's digits (from low: d_{M-1} .. d_1)
template <int k>
__device__ __forceinline__ uint32_t rev0(uint32_t lam) {
    if constexpr (n_rounds(k) == 3)
        return (lam >> digit(k, 2)) | ((lam & ((1u << digit(k, 2)) - 1)) << digit(k, 1));
    else if constexpr (n_rounds(k) == 2)
        return lam;
    else
        return 0;
}

// where input e of a line is staged in the tile: round 0 reads item lam's
// inputs lam + e' 2^(k - d0) at e' + rev(lam) 2^d0 and writes its outputs
// over them
template <int k>
__device__ __forceinline__ uint32_t in_pos(uint32_t e) {
    constexpr int d = digit(k, 0);
    return (e >> (k - d)) + (rev0<k>(e & ((1u << (k - d)) - 1)) << d);
}

// an 8-byte copy from device to shared memory that bypasses the
// registers; a block's staging copies are all in flight together
__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* gmem) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("{\n\t.reg .u64 g;\n\tcvta.to.global.u64 g, %1;\n\tcp.async.ca.shared.global [%0], [g], 8;\n\t}"
                 :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// A pass's 2^k-point DFT over the tile's VL lines in register rounds, the
// inputs staged in shared memory. in(vl, e, pos) gives input e of line vl
// (staged at tile position pos, or apart); finish(vl, vp, y) takes the
// last round's outputs y[v] = output vp + v 2^(k - d_last) of line vl.
// Between rounds the values live in the tile.
template <int k, int VL, class In, class Finish>
__device__ __forceinline__ void pass_dft(uint64_t* tile, const uint64_t* Ws, const Pass& a, int rate, uint32_t swm,
                                         In& in, Finish& finish) {
    constexpr int M = n_rounds(k), d = digit(k, 0);
    constexpr int ITEMS = VL << (k - d), LVL = log2c(VL);
    // round 0: item lam's inputs lam + e 2^(k - d)
    for (int it = threadIdx.x; it < ITEMS; it += THREADS) {
        const uint32_t vl = it & (VL - 1), lam = it >> LVL;
        const uint32_t rev = rev0<k>(lam) << d;
        uint64_t x[1 << d];
#pragma unroll
        for (int e = 0; e < (1 << d); ++e) x[e] = in(vl, lam + (uint32_t(e) << (k - d)), e + rev);
        dft_regs<d>(x, a.r16);
        if constexpr (M == 1) {
            finish(vl, 0u, x);
        } else {
#pragma unroll
            for (int e = 0; e < (1 << d); ++e) tile[phys<VL>(e + rev, vl, rate, swm)] = x[e];
        }
    }
    if constexpr (M > 1) pass_round<k, 1, VL>(tile, Ws, a, rate, swm, finish);
}

// Pass 0, round 0's inputs: input e of line vl >> rate, staged in the tile
// (one coset) or in Xs (lines x inputs, read by every coset), times
// F[e C + t]
template <int VL>
struct FirstIn {
    const Pass& a;
    const uint64_t* tile;
    const uint64_t* Xs;
    int rate, lg;  // lg: log2 lines a block

    __device__ __forceinline__ uint64_t operator()(uint32_t vl, uint32_t e, uint32_t pos) const {
        uint64_t v = rate ? Xs[(e << lg) + (vl >> rate)] : tile[phys<VL>(pos, vl, 0, 15)];
        if (a.F)  // through the read-only cache: 3 blocks an SM fit without it in shared memory
            v = tmx_gl::mul(v, __ldg(reinterpret_cast<const unsigned long long*>(a.F) + (e << rate) + (vl & ((1u << rate) - 1))));
        return v;
    }
};

// Pass 0, the last round's outputs u = t + C (vp + v 2^(k - DL)): twisted
// by S[l] w_N^(l u) = base * step^v (more than one pass), then written
// back over their positions, now in natural order
template <int k, int VL>
struct FirstFinish {
    static constexpr int DL = digit(k, n_rounds(k) - 1);
    const Pass& a;
    uint64_t* tile;
    uint32_t line0;
    int rate, lb;

    __device__ __forceinline__ void operator()(uint32_t vl, uint32_t vp, uint64_t* y) const {
        constexpr int n = 1 << DL;
        if (a.passes > 1) {
            const uint32_t g = line0 + (vl >> rate);
            const uint32_t l = g & ((1u << lb) - 1), t = vl & ((1u << rate) - 1);
            uint64_t base = omega(a, l * (t + (vp << rate)));
            if (a.S) base = tmx_gl::mul(base, __ldg(reinterpret_cast<const unsigned long long*>(a.S) + l));
            const uint64_t step = omega(a, l << (a.K - DL));
#pragma unroll
            for (int v = 0; v < n; ++v) {
                y[v] = tmx_gl::mul(y[v], base);
                if (v + 1 < n) base = tmx_gl::mul(base, step);
            }
        }
#pragma unroll
        for (int v = 0; v < n; ++v) tile[phys<VL>(vp + (uint32_t(v) << (k - DL)), vl, rate, 15)] = y[v];
    }
};

// Pass 0: lines of the input, each coset's 2^k-point DFT, the twist
// between passes (or scale and post for a single pass), contiguous runs.
template <int k, int VL>  // VL: (line, coset) pairs of a block, vl = t + C line
__global__ void __launch_bounds__(THREADS) tmx_ntt_first(Pass a) {
    extern __shared__ uint64_t smem[];
    uint64_t* tile = smem;
    uint64_t* Ws = smem + (VL << k);
    uint64_t* Xs = Ws + (1 << k);
    const int rate = a.rate, K = a.K;
    const uint32_t C = 1u << rate, G = VL >> rate;
    const int lb = a.log_N - K;  // lines a row: 2^lb
    const int lg = log2c(VL) - rate;
    const uint32_t line0 = blockIdx.x * G;
    const int in_shift = a.log_n - k;
    // stage the block's inputs: line l's input e from l + e 2^(log n - k)
    for (uint32_t i = threadIdx.x; i < (G << k); i += THREADS) {
        const uint32_t line = i & (G - 1), e = i >> lg, g = line0 + line;
        if (g >= a.lines) continue;
        const uint32_t row = g >> lb, l = g & ((1u << lb) - 1);
        uint64_t* dst = rate ? Xs + i : tile + phys<VL>(in_pos<k>(e), line, 0, 15);
        cp_async8(dst, a.src + (uint64_t(row) << a.log_n) + l + (e << in_shift));
    }
    for (int i = threadIdx.x; i < (1 << k); i += THREADS) Ws[i] = a.W[i];
    cp_async_wait();
    __syncthreads();

    FirstIn<VL> load{a, tile, Xs, rate, lg};
    FirstFinish<k, VL> finish{a, tile, line0, rate, lb};
    pass_dft<k, VL>(tile, Ws, a, rate, 15, load, finish);
    __syncthreads();

    // the runs: line's output u at u + rest(l) 2^K, read across the tile
    const uint32_t umask = (1u << K) - 1;
    for (uint32_t i = threadIdx.x; i < (G << K); i += THREADS) {
        const uint32_t line = i >> K, u = i & umask;
        const uint32_t g = line0 + line;
        if (g >= a.lines) break;
        const uint32_t row = g >> lb, l = g & ((1u << lb) - 1);
        const uint32_t uk = u >> rate, vl = (u & (C - 1)) + (line << rate);
        uint64_t v = tile[phys<VL>(uk, vl, rate, 15)];
        uint32_t out = u;
        if (a.passes > 1) {
            const uint32_t rest = (l >> a.K2) | ((l & ((1u << a.K2) - 1)) << a.K1);
            out += rest << K;
        } else {
            if (a.scale != 1) v = tmx_gl::mul(v, a.scale);
            if (a.post) v = tmx_gl::mul(v, a.post[u]);
        }
        a.dst[(uint64_t(row) << a.log_N) + out] = v;
    }
}

// A later pass's line vl: its positions D + e 2^s + R 2^(s + K) start at
// the returned pointer (R and D through the references)
template <int K>
struct RestLine {
    const Pass& a;
    uint32_t line0;
    int s, lb;

    __device__ __forceinline__ uint64_t* operator()(uint32_t vl, uint32_t& D, uint32_t& R) const {
        const uint32_t g = line0 + vl;
        const uint32_t row = g >> lb, l = g & ((1u << lb) - 1);
        D = l & ((1u << s) - 1);
        R = l >> s;
        return a.dst + (uint64_t(row) << a.log_N) + D + (uint64_t(R) << (s + K));
    }
};

// A later pass's round 0 inputs, staged in the tile
template <int VL>
struct RestIn {
    const uint64_t* tile;

    __device__ __forceinline__ uint64_t operator()(uint32_t vl, uint32_t, uint32_t pos) const {
        return tile[phys<VL>(pos, vl, 0, 0)];
    }
};

// A later pass's last round: a middle pass twists output u = vp + v
// 2^(K - DL) by w_N^(R u 2^s) = base * step^v, the last multiplies by
// post; outputs go back over the line's positions
template <int K>
struct RestFinish {
    static constexpr int DL = digit(K, n_rounds(K) - 1);
    RestLine<K> line;

    __device__ __forceinline__ void operator()(uint32_t vl, uint32_t vp, uint64_t* y) const {
        constexpr int n = 1 << DL;
        const Pass& a = line.a;
        const int s = line.s;
        if (line.line0 + vl >= a.lines) return;
        uint32_t D, R;
        uint64_t* p = line(vl, D, R);
        if (!a.last) {
            uint64_t base = omega(a, (R * vp) << s);
            const uint64_t step = omega(a, R << (K - DL + s));
#pragma unroll
            for (int v = 0; v < n; ++v) {
                y[v] = tmx_gl::mul(y[v], base);
                if (v + 1 < n) base = tmx_gl::mul(base, step);
            }
        }
#pragma unroll
        for (int v = 0; v < n; ++v) {
            const uint32_t u = vp + (uint32_t(v) << (K - DL));
            uint64_t val = y[v];
            if (a.post) val = tmx_gl::mul(val, a.post[D + (u << s)]);
            p[u << s] = val;
        }
    }
};

// Pass p > 0: in place over positions D + e 2^s + R 2^(s + K) of each line
// D + R 2^s; a middle pass twists, the last multiplies by post.
template <int K, int VL>  // VL: lines a block
__global__ void __launch_bounds__(THREADS) tmx_ntt_rest(Pass a) {
    extern __shared__ uint64_t smem[];
    uint64_t* tile = smem;
    uint64_t* Ws = smem + (VL << K);
    const RestLine<K> line{a, blockIdx.x * VL, a.s, a.log_N - K};
    // stage the block's lines: input e of line vl from D + e 2^s + R 2^(s + K)
    for (uint32_t i = threadIdx.x; i < uint32_t(VL << K); i += THREADS) {
        const uint32_t vl = i & (VL - 1), e = i >> log2c(VL);
        if (line.line0 + vl >= a.lines) continue;
        uint32_t D, R;
        cp_async8(tile + phys<VL>(in_pos<K>(e), vl, 0, 0), line(vl, D, R) + (e << line.s));
    }
    if constexpr (n_rounds(K) > 1)
        for (int i = threadIdx.x; i < (1 << K); i += THREADS) Ws[i] = a.W[i];
    cp_async_wait();
    __syncthreads();
    RestIn<VL> load{tile};
    RestFinish<K> finish{line};
    pass_dft<K, VL>(tile, Ws, a, 0, 0, load, finish);
}

// A pass whose full tiles would make fewer than FEW_WAVES blocks an SM runs
// in quarter tiles (the same kernel, a quarter of the lines a block, at
// least 16): more blocks for the card's SMs when a transform has few rows.
constexpr int FEW_WAVES = 2;

__host__ __device__ constexpr int small_vl(int k) { return (TILE >> (k + 2)) > 16 ? TILE >> (k + 2) : 16; }

int sm_count() {
    static const int sms = [] {
        int dev = 0, n = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        return n > 0 ? n : 1;
    }();
    return sms;
}

// the most dynamic shared memory a kernel instance can ask for, set once
// for each instance on each device
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
    constexpr int MAX_DEVICES = 64;
    static bool done[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

template <int k, int VL>
cudaError_t launch_first_vl(const Pass& a, cudaStream_t stream) {
    // the tile, the root table and Xs (at most half the tile)
    constexpr size_t most = sizeof(uint64_t) * ((VL << k) + (VL << k) / 2 + (1 << k));
    cudaError_t err = allow_smem<tmx_ntt_first<k, VL>>(most);
    if (err != cudaSuccess) return err;
    const uint32_t G = uint32_t(VL) >> a.rate;
    const uint32_t blocks = (a.lines + G - 1) / G;
    const size_t smem = sizeof(uint64_t) * ((VL << k) + (1 << k) + (a.rate ? (VL << k) >> a.rate : 0));
    tmx_ntt_first<k, VL><<<blocks, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int k>
cudaError_t launch_first(const Pass& a, cudaStream_t stream) {
    constexpr int VL = TILE >> k, VLS = small_vl(k);
    if constexpr (VLS < VL) {
        const uint32_t G = uint32_t(VL) >> a.rate;
        if ((1 << a.rate) <= VLS && (a.lines + G - 1) / G < uint32_t(FEW_WAVES * sm_count()))
            return launch_first_vl<k, VLS>(a, stream);
    }
    return launch_first_vl<k, VL>(a, stream);
}

template <int K, int VL>
cudaError_t launch_rest_vl(const Pass& a, cudaStream_t stream) {
    constexpr size_t smem = sizeof(uint64_t) * ((VL << K) + (1 << K));
    cudaError_t err = allow_smem<tmx_ntt_rest<K, VL>>(smem);
    if (err != cudaSuccess) return err;
    tmx_ntt_rest<K, VL><<<(a.lines + VL - 1) / VL, THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

template <int K>
cudaError_t launch_rest(const Pass& a, cudaStream_t stream) {
    constexpr int VL = TILE >> K, VLS = small_vl(K);
    if constexpr (VLS < VL) {
        if ((a.lines + VL - 1) / VL < uint32_t(FEW_WAVES * sm_count())) return launch_rest_vl<K, VLS>(a, stream);
    }
    return launch_rest_vl<K, VL>(a, stream);
}

cudaError_t first(int k, const Pass& a, cudaStream_t s) {
    switch (k) {
        case 0: return launch_first<0>(a, s);
        case 1: return launch_first<1>(a, s);
        case 2: return launch_first<2>(a, s);
        case 3: return launch_first<3>(a, s);
        case 4: return launch_first<4>(a, s);
        case 5: return launch_first<5>(a, s);
        case 6: return launch_first<6>(a, s);
        case 7: return launch_first<7>(a, s);
        case 8: return launch_first<8>(a, s);
        case 9: return launch_first<9>(a, s);
        default: return cudaErrorInvalidValue;
    }
}

cudaError_t rest(int K, const Pass& a, cudaStream_t s) {
    switch (K) {
        case 1: return launch_rest<1>(a, s);
        case 2: return launch_rest<2>(a, s);
        case 3: return launch_rest<3>(a, s);
        case 4: return launch_rest<4>(a, s);
        case 5: return launch_rest<5>(a, s);
        case 6: return launch_rest<6>(a, s);
        case 7: return launch_rest<7>(a, s);
        case 8: return launch_rest<8>(a, s);
        case 9: return launch_rest<9>(a, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// One transform: the passes ks[0..n_passes) (their stage counts sum to
// log_n + rate; ks[0] >= rate) over `rows` rows of 2^log_n input words
// into (rows, 2^(log_n + rate)). W[p] is pass p's root table (2^k
// entries, k = ks[0] - rate for pass 0), r16 the 16th root's powers.
extern "C" int tmx_ntt(const uint64_t* src, uint64_t* dst, const uint64_t* tw, const uint64_t* const* W,
                       const uint64_t* F, const uint64_t* S, const uint64_t* post, uint64_t scale,
                       const uint64_t* r16, int64_t rows, int log_n, int rate, const int* ks, int n_passes,
                       void* stream) {
    if (rows <= 0) return 0;
    const int log_N = log_n + rate;
    if (log_n < 0 || rate < 0 || log_N > MAX_PASSES * MAX_K || n_passes < 1 || n_passes > MAX_PASSES)
        return (int)cudaErrorInvalidValue;
    int sum = 0;
    for (int p = 0; p < n_passes; ++p) {
        if (ks[p] < 0 || ks[p] > MAX_K || (p > 0 && ks[p] < 1)) return (int)cudaErrorInvalidValue;
        sum += ks[p];
    }
    if (sum != log_N || ks[0] < rate) return (int)cudaErrorInvalidValue;
    Pass a{};
    a.src = src;
    a.dst = dst;
    a.tw = tw;
    a.F = F;
    a.S = S;
    a.scale = scale;
    for (int i = 0; i < 16; ++i) a.r16[i] = r16[i];
    a.log_n = log_n;
    a.log_N = log_N;
    a.passes = n_passes;
    a.K1 = n_passes > 1 ? ks[1] : 0;
    a.K2 = n_passes > 2 ? ks[2] : 0;
    const cudaStream_t st = (cudaStream_t)stream;
    for (int p = 0, s = 0; p < n_passes; s += ks[p], ++p) {
        const int64_t lines = rows << (log_N - ks[p]);
        if (lines > INT_MAX) return (int)cudaErrorInvalidValue;
        a.lines = (uint32_t)lines;
        a.K = ks[p];
        a.W = W[p];
        a.s = s;
        a.last = p == n_passes - 1;
        a.post = a.last ? post : nullptr;
        a.rate = p ? 0 : rate;
        const cudaError_t err = p ? rest(ks[p], a, st) : first(ks[0] - rate, a, st);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
