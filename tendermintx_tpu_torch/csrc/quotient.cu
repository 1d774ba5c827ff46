// The constraint quotient of any AIR on Hopper, driven by the AIR's
// recorded constraint tape (stark/quotient_tape.py).
//
// Replaces the XLA program the reference compiles per AIR shape for the
// quotient: tendermintx_tpu/stark/prover.py:293 `_build_quotient_fn`
// (`jax.jit` at :363-364) over :379 `_eval_quotient_core`. Per LDE row it
// evaluates the AIR's first, transition, cyclic and last constraints on the
// row's frame, scales each by its group's zerofier inverse and sums
// alpha^k * c_k into GF(p^2).
//
// The constraint program is data, not code: a straight-line tape of
// base-field instructions (int4; stark/quotient_tape.py lists the opcodes
// and the operand encoding), recorded once per AIR shape from the AIR's
// own eval_* methods and scheduled so that few values are live at once.
// One kernel runs every AIR's tape; no AIR has constraint code here.
//
// Bound: a row reads its LDE columns once (the frame's offsets re-read the
// same columns a few rows apart) with its periodic, public and zerofier
// columns, and writes two felts; its field multiplies are 4 32-bit
// multiply-adds each, and for the AIRs of the N=128 paths those take
// longer than the bytes at 3.35 TB/s (chip_smoke.py prints both). An
// interpreter adds its own integer work: decoding, addressing and a
// canonical reduction per operation, ~20 instructions an ADD and ~50 a MAC
// on the integer pipes (64 lanes an SM a clock), so it is bound by that
// issue and by the latency of each operation's dependent chain. The design:
//
//   * One thread per row; the block walks the tape in chunks (TAPE_CHUNK
//     instructions), each staged into shared memory with cp.async while
//     the chunk before runs, so an instruction word is one broadcast read.
//   * Every operand is a shared-memory word. A row's per-row words (its
//     column: word p of thread t at [p * T + t], a warp's access 256
//     contiguous bytes) are the zerofier inverses, the value slots and two
//     load buffers. Slots are allocated on the host by liveness over a
//     schedule that emits each cluster of roots depth-first (89 slots for
//     Ed25519 at N=128, 43-44 for SHA-256 and SHA-512), so they fit: no
//     value goes to device memory, and a tape whose words do not fit a
//     block raises on the host. Constants, publics, challenges and the
//     chunk's alpha powers are uniform words, read as broadcasts.
//   * Loads are operands, not instructions: each chunk names the distinct
//     frame and row-input values it reads (at most LOAD_CAP), and every
//     thread copies its row's values into the chunk's load buffer with
//     cp.async one chunk ahead. The frame comes straight from the shard's
//     LDE row blocks and the halo past them (the wrapper gives each load
//     its block and halo address for row 0; a thread takes the one its
//     row's offset reaches); no gathered frame is built.
//   * Independent instructions of one opcode are bundled (up to four): a
//     bundle reads all its operands, computes, then writes, so its field
//     operations run side by side, each with its opcode's arithmetic only.
//   * Each ROOT instruction adds alpha^k * c * zinv_g(row) to the row's
//     GF(p^2) accumulator; the output is written once, as canonical
//     (c0, c1) felts. Every field value is canonical (< p) at every step
//     (goldilocks.cuh), so the result equals the plain torch evaluation
//     bit for bit.
//
// Entries, with a plain C interface (loaded with ctypes by
// stark/quotient_tape.py):
//   tmx_quotient            rows [r0, r0 + rows) of a shard -> out (2, rows)
//                           (c0 row, then c1 row); launched on the caller's
//                           stream with the tape's block size and the
//                           dynamic shared bytes of its layout (checked
//                           here); returns cudaGetLastError().
//   tmx_quotient_occupancy  resident blocks per SM at a launch shape.
// The kernel allocates nothing; the wrapper allocates the output.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

enum : int { OP_ADD = 0, OP_SUB, OP_MUL, OP_MAC, OP_MSUB, OP_ROOT };

// stark/quotient_tape.py: MAX_OFFSETS, ZINV_ROWS, TAPE_CHUNK, LOAD_CAP
constexpr int MAX_OFFSETS = 16;
constexpr int ZINV_ROWS = 4;
constexpr int CHUNK = 32;
constexpr int LOAD_CAP = 8;
constexpr int MAX_THREADS = 256;

}  // namespace

// stark/quotient_tape.py::_Args, field for field (8-byte fields only)
struct QuotientArgs {
    const int4* tape;    // (n_ins, 4) instructions
    const int4* chunks;  // (n_chunks, 8) int32: ins start, count, load start, count, root start, count, 0, 0
    int64_t n_chunks;
    const int* loads;    // load words (index << 3 | mode), chunk after chunk
    // per load word, the byte address of its value for local row 0 in the
    // shard's block and in its halo (equal for a row input): row r's value
    // is at one of them + 8 r, as row r + shift_k lies in the block or not
    const ulonglong2* load_addr;
    const uint64_t* consts;
    int64_t n_consts;
    const uint64_t* scalars;       // publics, then challenges
    const int64_t* scalar_index;   // the scalars the tape reads
    int64_t n_scalars;
    const uint64_t* alpha;  // (n_roots, 2): alpha^k of each ROOT in tape order
    const uint64_t* zinv[ZINV_ROWS];  // the zerofier inverses at local row 0
    int64_t block_rows;
    int64_t shift[MAX_OFFSETS];  // frame offset k reads block row r + shift[k]
    int64_t n_slots;
    int64_t r0;
    int64_t rows;
    uint64_t* out;  // (2, rows)
};

namespace {

// Shared memory, in this order (stark/quotient_tape.py::shared_bytes):
// two tape buffers, the uniform words (constants, scalars; an even count)
// and two alpha buffers, then the per-row words, word p of thread t at
// [p * T + t]: four zerofier inverses, the value slots, two load buffers.
struct Layout {
    int uni;     // 8-byte word offsets (the tape buffers start at 0)
    int abuf;
    int rows;
    int lbuf;    // per-row index of the first load buffer
    int row_words;

    __host__ __device__ Layout(int64_t n_uniform, int64_t n_slots) {
        uni = 2 * 16 * CHUNK / 8;
        abuf = uni + (int)((n_uniform + 1) / 2 * 2);
        rows = abuf + 2 * 2 * CHUNK;
        lbuf = ZINV_ROWS + (int)n_slots;
        row_words = lbuf + 2 * LOAD_CAP;
    }
    __host__ __device__ int64_t bytes(int threads) const { return 8 * ((int64_t)rows + (int64_t)row_words * threads); }
};

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gsrc) : "memory");
}
__device__ __forceinline__ void cp_async8(void* smem_dst, const void* gsrc) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gsrc) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// An operand: a per-row word's byte offset from this thread's first
// per-row word, with bit 0 set, or a uniform word's byte offset from the
// first uniform word. `delta` is (the thread's first per-row word - 1) -
// (the first uniform word), in bytes, so the address takes no branch.
struct Operands {
    const unsigned char* smem;
    int uni;    // byte offset of the first uniform word
    int delta;

    __device__ __forceinline__ uint64_t operator()(int w) const {
        return *reinterpret_cast<const uint64_t*>(smem + (uni + (w & 1) * delta + w));
    }
};

// W independent instructions of opcode OP: every tape word and operand
// read, then every result computed, then written, so the W field
// operations run side by side.
template <int OP, int W>
__device__ __forceinline__ void bundle(const int4* ins, const Operands& F, uint64_t* mine, int T) {
    using namespace tmx_gl;
    uint64_t x[W], y[W], c[W];
    int d[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int4 q = ins[j];
        x[j] = F(q.y);
        y[j] = F(q.z);
        if (OP == OP_MAC || OP == OP_MSUB) c[j] = F(q.w);
        d[j] = q.x >> 8;
    }
    uint64_t v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        if (OP == OP_ADD) v[j] = add(x[j], y[j]);
        if (OP == OP_SUB) v[j] = sub(x[j], y[j]);
        if (OP == OP_MUL) v[j] = mul(x[j], y[j]);
        if (OP == OP_MAC) v[j] = add(c[j], mul(x[j], y[j]));
        if (OP == OP_MSUB) v[j] = sub(c[j], mul(x[j], y[j]));
    }
#pragma unroll
    for (int j = 0; j < W; ++j) mine[(ZINV_ROWS + d[j]) * T] = v[j];
}

template <int OP>
__device__ __forceinline__ void bundle_of(int w, const int4* ins, const Operands& F, uint64_t* mine, int T) {
    switch (w) {
        case 1: bundle<OP, 1>(ins, F, mine, T); break;
        case 2: bundle<OP, 2>(ins, F, mine, T); break;
        case 3: bundle<OP, 3>(ins, F, mine, T); break;
        default: bundle<OP, 4>(ins, F, mine, T); break;
    }
}

}  // namespace

extern "C" __global__ void __launch_bounds__(MAX_THREADS)
tmx_quotient_kernel(const QuotientArgs A) {
    using namespace tmx_gl;
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* sm = reinterpret_cast<uint64_t*>(smem);
    const Layout L(A.n_consts + A.n_scalars, A.n_slots);
    int4* s_tape = reinterpret_cast<int4*>(smem);
    const int T = blockDim.x;
    const int tid = threadIdx.x;

    for (int64_t i = tid; i < A.n_consts; i += T) sm[L.uni + i] = A.consts[i];
    for (int64_t i = tid; i < A.n_scalars; i += T) sm[L.uni + A.n_consts + i] = A.scalars[A.scalar_index[i]];
    __syncthreads();

    // threads past the range run the tape on row r0 and store nothing:
    // every thread of the block takes part in the staging
    const int64_t local = (int64_t)blockIdx.x * T + tid;
    const bool active = local < A.rows;
    const int64_t row = A.r0 + (active ? local : 0);
    // bit k: frame offset k's row of this thread lies in the block (else in the halo)
    uint32_t in_block = 0;
#pragma unroll
    for (int k = 0; k < MAX_OFFSETS; ++k) in_block |= (uint32_t)(row + A.shift[k] < A.block_rows) << k;
    uint64_t* mine = sm + L.rows + tid;  // this row's per-row word p at mine[p * T]
    const Operands F{smem, 8 * L.uni, 8 * (L.rows + tid) - 1 - 8 * L.uni};
#pragma unroll
    for (int g = 0; g < ZINV_ROWS; ++g) mine[g * T] = A.zinv[g][row];

    // the address of load j's value for this thread's row
    auto source = [&](int64_t j) -> const uint64_t* {
        const int k = (__ldg(A.loads + j) >> 3) & (MAX_OFFSETS - 1);
        const ulonglong2 a = __ldg(A.load_addr + j);
        return reinterpret_cast<const uint64_t*>(((in_block >> k) & 1 ? a.x : a.y) + 8 * row);
    };
    // chunk c into buffer c & 1: its instructions and alpha pairs (shared by
    // the block), and this row's loads (cp.async, waited for one chunk on)
    auto stage = [&](int64_t c) {
        const int4 m0 = __ldg(A.chunks + 2 * c);
        const int4 m1 = __ldg(A.chunks + 2 * c + 1);
        const int buf = (int)(c & 1);
        for (int j = tid; j < m0.y; j += T) cp_async16(s_tape + buf * CHUNK + j, A.tape + m0.x + j);
        for (int j = tid; j < m1.y; j += T) cp_async16(sm + L.abuf + buf * 2 * CHUNK + 2 * j, A.alpha + 2 * (m1.x + j));
        uint64_t* lb = mine + (L.lbuf + buf * LOAD_CAP) * T;
#pragma unroll 4
        for (int j = 0; j < m0.w; ++j) cp_async8(lb + j * T, source(m0.z + j));
        cp_async_commit();
    };

    uint64_t acc0 = 0, acc1 = 0;
    if (A.n_chunks > 0) stage(0);
#pragma unroll 1
    for (int64_t c = 0; c < A.n_chunks; ++c) {
        if (c + 1 < A.n_chunks) {
            stage(c + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int buf = (int)(c & 1);
        const int4* tb = s_tape + buf * CHUNK;
        const uint64_t* al = sm + L.abuf + buf * 2 * CHUNK;
        const int n = __ldg(A.chunks + 2 * c).y;
        int i = 0, q = 0;
        int4 x = tb[0];
#pragma unroll 1
        while (i < n) {
            const int op = x.x & 7;
            if (op == OP_ROOT) {  // acc += alpha^k * a * zinv_g, g = x.w
                const uint64_t cz = mul(F(x.y), mine[x.w * T]);
                acc0 = add(acc0, mul(al[2 * q], cz));
                acc1 = add(acc1, mul(al[2 * q + 1], cz));
                ++q;
                x = tb[++i];  // past the chunk's end: a stale word, not used
                continue;
            }
            const int w = ((x.x >> 3) & 3) + 1;  // the bundle's width
            const int4 next = tb[i + w];
            switch (op) {
                case OP_ADD: bundle_of<OP_ADD>(w, tb + i, F, mine, T); break;
                case OP_SUB: bundle_of<OP_SUB>(w, tb + i, F, mine, T); break;
                case OP_MUL: bundle_of<OP_MUL>(w, tb + i, F, mine, T); break;
                case OP_MAC: bundle_of<OP_MAC>(w, tb + i, F, mine, T); break;
                default: bundle_of<OP_MSUB>(w, tb + i, F, mine, T); break;
            }
            i += w;
            x = next;
        }
        __syncthreads();  // the tape and alpha buffers are restaged two chunks on
    }
    if (active) {
        A.out[local] = acc0;
        A.out[A.rows + local] = acc1;
    }
}

extern "C" int tmx_quotient(const QuotientArgs* args, int threads, int64_t shared_bytes, void* stream) {
    if (args->rows <= 0) return 0;
    const Layout L(args->n_consts + args->n_scalars, args->n_slots);
    if (threads <= 0 || threads > MAX_THREADS || threads % 32 || args->r0 < 0 ||
        args->r0 + args->rows > args->block_rows || shared_bytes != L.bytes(threads) || shared_bytes > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (args->rows + threads - 1) / threads;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(tmx_quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
    tmx_quotient_kernel<<<(int)blocks, threads, (size_t)shared_bytes, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int tmx_quotient_occupancy(int threads, int64_t shared_bytes, int* blocks_per_sm) {
    cudaError_t err = cudaFuncSetAttribute(tmx_quotient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, tmx_quotient_kernel, threads,
                                                              (size_t)shared_bytes);
}
