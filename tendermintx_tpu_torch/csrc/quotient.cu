// The constraint quotient of any AIR on Hopper, driven by the AIR's
// recorded constraint tape (stark/quotient_tape.py).
//
// Replaces the XLA program the reference compiles per AIR shape for the
// quotient: tendermintx_tpu/stark/prover.py:293 `_build_quotient_fn`
// (`jax.jit` at :363-364) over :379 `_eval_quotient_core`. Per LDE row it
// evaluates the AIR's first, transition, cyclic and last constraints on the
// gathered frame, scales each by its group's zerofier inverse and sums
// alpha^k * c_k into GF(p^2).
//
// The constraint program is data, not code: a straight-line tape of
// base-field instructions (int4: op | dst << 8, a, b, c; the opcodes and
// operand meanings are listed in stark/quotient_tape.py), recorded once
// per AIR shape from the AIR's own eval_* methods. One kernel runs every
// AIR's tape; no AIR has constraint code here.
//
// Bound: a row reads its frame (n_offsets x columns felts) and its
// periodic, public and zerofier columns once, and writes two felts; its
// field multiplies are 4 32-bit multiply-adds each. For the AIRs of the
// N=128 paths (Ed25519, SHA-256, SHA-512, WrapAir, EvalAir) the bytes take
// longer at 3.35 TB/s than the multiplies at the card's integer rate;
// PoseidonChainAir is bound by its multiplies (chip_smoke.py prints both
// bounds for each). The kernel's own traffic is its value slots, a few
// reads and one write per instruction, far above either. The design:
//
//   * One thread per row. Every thread walks the same tape, so the
//     instruction fetch is uniform across the warp: one broadcast load of
//     16 bytes an instruction, read through the read-only cache (the
//     Ed25519 tape is ~62,000 instructions, ~1 MB, and stays in L2).
//   * Values live in value slots, allocated on the host by liveness, so a
//     row needs the tape's peak live set (~6,300 slots for Ed25519 at
//     N=128), not its length. The slots are a scratch buffer in device
//     memory laid out [slot][row]: a warp's access to one slot is 256
//     contiguous bytes. Registers or a local array could not hold them
//     (~50 KB a row) without spilling.
//   * Each ROOT instruction adds alpha^k * c * zinv_g(row) to the row's
//     GF(p^2) accumulator, so no (constraints x rows) stack is ever made;
//     the output is written once, as canonical (c0, c1) felts.
//   * Every field value is canonical (< p) at every step (goldilocks.cuh),
//     so the result equals the plain torch evaluation bit for bit.
//
// Later work: reorder the tape to shrink the live set, keep the hottest
// slots in shared memory, and read the frame straight from the LDE blocks
// instead of the gathered copy.
//
// Entry, with a plain C interface (loaded with ctypes by
// stark/quotient_tape.py, launched on the caller's stream, returning
// cudaGetLastError()):
//   tmx_quotient  rows [r0, r0 + rows) of a (n_frame, B) frame block ->
//                 out (2, B) (c0 row, then c1 row), with a scratch buffer
//                 of (n_slots, R) values, R >= rows.
// The kernel allocates nothing; the wrapper allocates output and scratch.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

enum : int {
    OP_CONST = 0, OP_FRAME, OP_ROW, OP_SCALAR, OP_ADD, OP_SUB, OP_MUL, OP_CMUL,
    OP_MAC, OP_MSUB, OP_CMAC, OP_ROOT,
};

constexpr int THREADS = 128;

}  // namespace

extern "C" __global__ void __launch_bounds__(THREADS)
tmx_quotient_kernel(const int4* __restrict__ tape, int64_t n_ins,
                    const uint64_t* __restrict__ consts,
                    const uint64_t* __restrict__ frame,    // (n_frame, B)
                    const uint64_t* __restrict__ rowvecs,  // (n_rowvecs, B)
                    const uint64_t* __restrict__ scalars,
                    const uint64_t* __restrict__ alpha,    // (2, K)
                    uint64_t* __restrict__ scratch,        // (n_slots, R)
                    uint64_t* __restrict__ out,            // (2, B)
                    int64_t B, int64_t r0, int64_t rows, int64_t R, int64_t K,
                    int64_t zinv_base) {
    using namespace tmx_gl;
    const int64_t local = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (local >= rows) return;
    const int64_t row = r0 + local;
    uint64_t* slot = scratch + local;  // value slot s at slot[s * R]
    const uint64_t z0 = rowvecs[(zinv_base + 0) * B + row];
    const uint64_t z1 = rowvecs[(zinv_base + 1) * B + row];
    const uint64_t z2 = rowvecs[(zinv_base + 2) * B + row];
    const uint64_t z3 = rowvecs[(zinv_base + 3) * B + row];
    uint64_t acc0 = 0, acc1 = 0;
#pragma unroll 1
    for (int64_t t = 0; t < n_ins; ++t) {
        const int4 ins = __ldg(&tape[t]);
        const int op = ins.x & 0xFF;
        const int64_t dst = (int64_t)(ins.x >> 8);
        const int64_t a = ins.y, b = ins.z, c = ins.w;
        uint64_t v;
        switch (op) {
            case OP_CONST: v = consts[a]; break;
            case OP_FRAME: v = frame[a * B + row]; break;
            case OP_ROW: v = rowvecs[a * B + row]; break;
            case OP_SCALAR: v = scalars[a]; break;
            case OP_ADD: v = add(slot[a * R], slot[b * R]); break;
            case OP_SUB: v = sub(slot[a * R], slot[b * R]); break;
            case OP_MUL: v = mul(slot[a * R], slot[b * R]); break;
            case OP_CMUL: v = mul(consts[b], slot[a * R]); break;
            case OP_MAC: v = add(mul(slot[a * R], slot[b * R]), slot[c * R]); break;
            case OP_MSUB: v = sub(slot[c * R], mul(slot[a * R], slot[b * R])); break;
            case OP_CMAC: v = add(mul(consts[b], slot[a * R]), slot[c * R]); break;
            default: {  // OP_ROOT: acc += alpha^b * slot[a] * zinv_c
                const uint64_t z = c == 0 ? z0 : c == 1 ? z1 : c == 2 ? z2 : z3;
                const uint64_t cz = mul(slot[a * R], z);
                acc0 = add(acc0, mul(alpha[b], cz));
                acc1 = add(acc1, mul(alpha[K + b], cz));
                continue;
            }
        }
        slot[dst * R] = v;
    }
    out[row] = acc0;
    out[B + row] = acc1;
}

extern "C" int tmx_quotient(const void* tape, int64_t n_ins, const void* consts, const void* frame,
                            const void* rowvecs, const void* scalars, const void* alpha,
                            void* scratch, void* out, int64_t B, int64_t r0, int64_t rows,
                            int64_t R, int64_t K, int64_t zinv_base, void* stream) {
    if (rows <= 0) return 0;
    if (rows > R || r0 < 0 || r0 + rows > B) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (rows + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_quotient_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int4*)tape, n_ins, (const uint64_t*)consts, (const uint64_t*)frame,
        (const uint64_t*)rowvecs, (const uint64_t*)scalars, (const uint64_t*)alpha,
        (uint64_t*)scratch, (uint64_t*)out, B, r0, rows, R, K, zinv_base);
    return (int)cudaGetLastError();
}
