// Staging a block's contiguous span of global memory into shared memory
// with 16-byte cp.async copies (csrc/sha.cu's challenge, csrc/ed25519.cu's
// binding).
//
// A kernel that takes a few lanes a block reads each lane's row of every
// operand: copied lane by lane, rows that are not multiples of 16 bytes
// (a 124-byte message, a 2,024-byte selector row) give strided loads that
// touch a sector each. The block's rows of one operand are one contiguous
// span, so the block copies the 16-byte aligned words that hold the span,
// neighbouring threads on neighbouring words, all copies in flight at once:
// one round trip for the block's whole input. The first and last word may
// hold bytes before and after the span; they lie in the same 16-byte word
// as a byte of the span, so in the same page of the same allocation, and
// are never read back.

#pragma once

#include <cstdint>

namespace tmx_stage {

// shared bytes `span` writes for a span of n bytes: its aligned words, at
// most one more than n / 16 rounded up
__host__ __device__ constexpr int64_t bytes(int64_t n) { return (n + 30) & ~int64_t(15); }

// Issues the copies of [src, src + n) into dst (16-byte aligned, at least
// bytes(n) long) by threads tid = 0 .. threads - 1 of the block; returns
// where src's first byte lands. Read only after wait() and a barrier.
__device__ __forceinline__ const uint8_t* span(uint8_t* dst, const void* src, int64_t n, int tid, int threads) {
    const uintptr_t s = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a = s & ~uintptr_t(15);
    const int64_t words = n > 0 ? int64_t((s + n - a + 15) >> 4) : 0;
    for (int64_t c = tid; c < words; c += threads) {
        const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + 16 * c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(a + 16 * c) : "memory");
    }
    return dst + (s - a);
}

// this thread's copies complete (the block's after a barrier)
__device__ __forceinline__ void wait() { asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory"); }

}  // namespace tmx_stage
