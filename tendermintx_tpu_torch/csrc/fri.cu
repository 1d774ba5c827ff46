// The FRI commit phase's field programs on Hopper (stark/fri.py binds them
// with ctypes):
//
//   tmx_fri_fold    one arity-2 fold of a GF(p^2) layer of N values on
//                   the coset shift <w_N>: out_i = (e_i + o_i) / 2 +
//                   beta (e_i - o_i) (2 x_i)^-1, with e_i = E(x_i) and
//                   o_i = E(-x_i) = E(x_(i + N/2)) and x_i = shift
//                   w_N^(start + i), for the outputs i < half;
//   tmx_fri_inject  the batch FRI's injection, cur + sum_k lambda_k F_k
//                   (or the sum alone) for up to MAX_INJECT codewords.
//
// Replaces the XLA programs of tendermintx_tpu/stark/fri.py:93
// `_fold_layer` (jitted at :117 as `_fold_jit`), :330 `_inject_fn` and
// :337 `_scale_fn`.
//
// Bounds and design:
//
// - A fold reads each input word once and writes each output word once:
//   16 N bytes read and 8 N written (N = 2^19 at the composite's first
//   layer: 12.6 MB, 3.76 us at 3.35 TB/s), against ~12 field multiplies an
//   output: bytes-bound. The (2 x_i)^-1 the reference reads from a host
//   table are made here: (2 x_i)^-1 = (2 shift)^-1 w_N^-(start + i), so
//   the kernel reads no table and the host builds none (the reference's
//   table is one Python inversion a point, seconds at 2^21). Each thread
//   takes FOLD_RUN outputs i, i + stride, .. (stride = ceil(half /
//   FOLD_RUN)), so a warp's loads and stores are consecutive words. Its
//   first factor is (2 shift)^-1 times the powers w_N^-(2^b) over the bits
//   of start + i (from the host, a base multiply a set bit), and it steps
//   by w_N^-stride; the run's loads are issued before its arithmetic, 4
//   FOLD_RUN words in flight a thread. `start` lets a row shard of a
//   sharded fold (parallel/prover.py::sharded_fold_fn) fold its own
//   outputs with no table slice. Each output component is one
//   three-product dot, s inv2 + u0 beta0 + u1 W beta1 (c0) or s inv2 + u0
//   beta1 + u1 beta0 (c1) with s = e + o and u = (e - o) (2 x)^-1, summed
//   unreduced in a 160-bit Acc (goldilocks.cuh) and reduced once.
// - An injection reads K codewords (and cur) and writes one: at the
//   composite's 2^18 injection (cur and two codewords) 16 MB, 5 us. Each
//   output component is one dot of 2 K products (lambda_k's components
//   against F_k's, W lambda_k1 from the host), reduced once, then cur
//   added. A thread an output, consecutive outputs to consecutive threads.
//
// Every result is canonical and equals the plain torch versions bit for
// bit (the field element is unique). Each entry has a plain C interface,
// launches on the caller's stream and returns cudaGetLastError(); the
// kernels allocate nothing (the wrapper allocates the outputs).

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int FOLD_RUN = 4;      // stark/fri.py: FOLD_RUN, outputs a fold thread
constexpr int MAX_INJECT = 4;    // stark/fri.py: INJECT_MAX, codewords a launch
constexpr int THREADS = 128;
constexpr uint64_t INV2 = (tmx_gl::P + 1) / 2;

}  // namespace

// stark/fri.py::_FoldArgs, field for field. The four inputs are the even
// half's (e) and the odd half's (o) c0 and c1 rows, half words each with
// unit stride; the outputs are out0 and out1, half words each.
struct FoldArgs {
    const uint64_t* e0;
    const uint64_t* e1;
    const uint64_t* o0;
    const uint64_t* o1;
    uint64_t beta0, beta1, wbeta1;  // beta and W beta1
    uint64_t inv2s;                 // (2 shift)^-1
    uint64_t wipow[32];             // w_N^-(2^b)
    uint64_t wistride;              // w_N^-stride
    int64_t start;                  // the domain index of output 0
    int64_t half;                   // outputs
    int64_t stride;                 // ceil(half / FOLD_RUN)
    uint64_t* out0;
    uint64_t* out1;
};

// stark/fri.py::_InjectArgs, field for field: rows of n words with unit
// stride; cur0 / cur1 null for an injection into nothing
struct InjectArgs {
    const uint64_t* cur0;
    const uint64_t* cur1;
    const uint64_t* f0[MAX_INJECT];
    const uint64_t* f1[MAX_INJECT];
    uint64_t lam0[MAX_INJECT], lam1[MAX_INJECT], wlam1[MAX_INJECT];  // lambda_k and W lambda_k1
    int64_t k;
    int64_t n;
    uint64_t* out0;
    uint64_t* out1;
};

namespace {

__device__ __forceinline__ uint64_t ld(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

__global__ void __launch_bounds__(THREADS) tmx_fri_fold_kernel(FoldArgs a) {
    const int64_t i0 = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (i0 >= a.stride) return;
    uint64_t e0[FOLD_RUN], e1[FOLD_RUN], o0[FOLD_RUN], o1[FOLD_RUN];
#pragma unroll
    for (int j = 0; j < FOLD_RUN; ++j) {
        const int64_t i = i0 + j * a.stride;
        if (i < a.half) {
            e0[j] = ld(a.e0 + i);
            e1[j] = ld(a.e1 + i);
            o0[j] = ld(a.o0 + i);
            o1[j] = ld(a.o1 + i);
        }
    }
    // t = (2 shift)^-1 w_N^-(start + i0), then times w_N^-stride an output
    const uint64_t idx = uint64_t(a.start + i0);
    uint64_t t = a.inv2s;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit)
        if ((idx >> bit) & 1) t = tmx_gl::mul(t, a.wipow[bit]);
#pragma unroll
    for (int j = 0; j < FOLD_RUN; ++j) {
        const int64_t i = i0 + j * a.stride;
        if (i >= a.half) break;
        const uint64_t s0 = tmx_gl::add(e0[j], o0[j]), s1 = tmx_gl::add(e1[j], o1[j]);
        const uint64_t u0 = tmx_gl::mul_nc(tmx_gl::sub(e0[j], o0[j]), t);
        const uint64_t u1 = tmx_gl::mul_nc(tmx_gl::sub(e1[j], o1[j]), t);
        tmx_gl::Acc c0{}, c1{};
        tmx_gl::mac(c0, s0, INV2);
        tmx_gl::mac(c0, u0, a.beta0);
        tmx_gl::mac(c0, u1, a.wbeta1);
        tmx_gl::mac(c1, s1, INV2);
        tmx_gl::mac(c1, u0, a.beta1);
        tmx_gl::mac(c1, u1, a.beta0);
        a.out0[i] = tmx_gl::reduce(c0);
        a.out1[i] = tmx_gl::reduce(c1);
        if (j + 1 < FOLD_RUN) t = tmx_gl::mul(t, a.wistride);
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS) tmx_fri_inject_kernel(InjectArgs a) {
    const int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= a.n) return;
    uint64_t f0[K], f1[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        f0[k] = ld(a.f0[k] + i);
        f1[k] = ld(a.f1[k] + i);
    }
    tmx_gl::Acc c0{}, c1{};
#pragma unroll
    for (int k = 0; k < K; ++k) {
        tmx_gl::mac(c0, f0[k], a.lam0[k]);
        tmx_gl::mac(c0, f1[k], a.wlam1[k]);
        tmx_gl::mac(c1, f0[k], a.lam1[k]);
        tmx_gl::mac(c1, f1[k], a.lam0[k]);
    }
    uint64_t r0 = tmx_gl::reduce(c0), r1 = tmx_gl::reduce(c1);
    if (a.cur0) {
        r0 = tmx_gl::add(ld(a.cur0 + i), r0);
        r1 = tmx_gl::add(ld(a.cur1 + i), r1);
    }
    a.out0[i] = r0;
    a.out1[i] = r1;
}

}  // namespace

extern "C" int tmx_fri_fold(const FoldArgs* args, void* stream) {
    const FoldArgs& a = *args;
    if (a.half < 0 || a.start < 0 || a.start + a.half > (int64_t(1) << 32) ||
        a.stride != (a.half + FOLD_RUN - 1) / FOLD_RUN)
        return (int)cudaErrorInvalidValue;
    if (a.half == 0) return 0;
    const int64_t blocks = (a.stride + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_fri_fold_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int tmx_fri_inject(const InjectArgs* args, void* stream) {
    const InjectArgs& a = *args;
    if (a.k < 1 || a.k > MAX_INJECT || a.n < 0 || (a.cur0 == nullptr) != (a.cur1 == nullptr))
        return (int)cudaErrorInvalidValue;
    if (a.n == 0) return 0;
    const int64_t blocks = (a.n + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (a.k) {
        case 1: tmx_fri_inject_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(a); break;
        case 2: tmx_fri_inject_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(a); break;
        case 3: tmx_fri_inject_kernel<3><<<(unsigned)blocks, THREADS, 0, s>>>(a); break;
        default: tmx_fri_inject_kernel<4><<<(unsigned)blocks, THREADS, 0, s>>>(a); break;
    }
    return (int)cudaGetLastError();
}
