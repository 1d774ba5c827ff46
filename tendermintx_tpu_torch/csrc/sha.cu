// Batched SHA-256 and SHA-512 compressions of the witness programs on Hopper
// (ops/sha256.py, ops/sha512.py and circuits/gadgets.py bind them with ctypes):
//
//   tmx_sha256_blocks          lanes of (n_blocks, 16) 32-bit words (the low
//                              32 bits of int64 inputs) -> (lanes, 8) digest
//                              words;
//   tmx_sha512_blocks          the same over 64-bit words (int64 bit
//                              patterns), 80 rounds;
//   tmx_sha512_challenge       the Ed25519 challenge SHA-512(R || A || M) of
//                              each lane's raw signature half R, key A and
//                              message bytes M of msg_len bytes -> (lanes, 64)
//                              digest bytes, padded on the card
//                              (ops/sha512.py::sha512_challenge);
//   tmx_sha256_validator_root  a validator set's CometBFT Merkle root: each
//                              lane's 0x00-prefixed leaf bytes padded and
//                              hashed, then every level's pairs, in one
//                              block (circuits/gadgets.py::validator_root);
//   tmx_sha256_header_proofs   k header Merkle proofs of depth 4: each
//                              proof's leaf bytes hashed, then its 4 aunts
//                              walked by its path bits, a thread a proof
//                              (circuits/gadgets.py::header_proof_root).
//
// Replace the XLA programs of tendermintx_tpu/ops/sha256.py:82
// `sha256_blocks` (jitted as `sha256_blocks_jit`) and
// tendermintx_tpu/ops/sha512.py:143 `sha512_blocks` (`sha512_blocks_jit`);
// the challenge replaces those and the byte assembly before them in
// tendermintx_tpu/ops/ed25519.py:524 `verify_bound` (:533-536: the
// concatenation, ops/sha512.py:160 `bytes_to_blocks512`, :193
// `digest_words_to_bytes_dev`), which the JAX package jits whole; the tree
// and proof entries replace the per-level programs of
// tendermintx_tpu/circuits/gadgets.py:94 `merkle_root_dynamic` (over :89
// `hash_validator_leaves`) and :123 `header_proof_root`, which the JAX
// package traces into its jitted step / skip verification.
//
// A lane compresses its blocks 0 .. min(n_active, n_blocks) - 1: none when
// n_active <= 0, all of them when n_active > n_blocks. That is what the
// plain versions' `keep = i < n_active` loop gives. Digest words are
// written as int64 (SHA-256's below 2^32).
//
// The tree and proof entries pad byte messages as gadgets.py's
// bytes_to_blocks does: the bytes below the lane's length (zero past the
// buffer's width), 0x80, zeros, the bit length in the last active block's
// final word. A length outside [0, 64 n_blocks - 9] (bytes_to_blocks'
// contract) is clamped into it, so no lane reads past its row. The
// challenge pads R || A || M as bytes_to_blocks512 does, over n_blocks =
// (64 + width + 17 + 127) / 128 blocks, its byte length 64 + msg_len
// clamped into bytes_to_blocks512's contract [0, 128 n_blocks - 17] (so
// msg_len into [-64, 128 n_blocks - 81]: within it, the bytes past the
// width are zeros and a negative msg_len hashes a prefix of R || A, as the
// reference does).
//
// Bounds and design: the witness programs hash 1-129 lanes of one or two
// blocks a call, a few kilobytes. The work is ~1,400 Hopper instructions a
// SHA-256 block and ~3,500 a SHA-512 block, nanoseconds over the card;
// what a call costs is its launch and its dependent chain of compressions.
// So one thread takes one lane: its message schedule is a ring of 16 words
// in registers, K and the initial state sit in __constant__ (every round
// reads one word at a compile-time index), and the rounds unroll. A tree
// is one block of B' threads (B' the lane count rounded up to a power of
// two, at most 1,024): a thread hashes its leaf into shared memory, then
// each level's pair-and-promote runs there with n_enabled read on the card,
// the 65-byte pair message 0x01 || left || right built from the digest
// words in registers (two blocks, the second one byte, 0x80 and the length
// 520). Its chain is the leaf and two compressions a level.
//
// The challenge is one launch of 32 lanes a block (128 lanes over 4 SMs),
// three warps: its R, A and message rows come into shared memory as the
// block's three contiguous spans in one burst of 16-byte copies (a lane's
// 124-byte message row is not a multiple of 16: copied lane by lane it
// would touch a sector a load); then warp 0 runs the 80 rounds a block
// (the rounds core the other SHA-512 entry runs) off schedule words that
// warps 1 and 2 write into shared memory, each for the blocks of its slot
// (even and odd blocks): it pads the lane's stream into the block's 16
// words (three aligned 32-bit loads, a funnel shift and a byte swap a
// word) and expands the schedule 16 words ahead of the rounds. A warp
// issues an integer instruction every other clock (16 lanes a scheduler),
// and each warp has a scheduler of its own: the rounds warp issues ~2,450
// instructions a block (~30 a round), a thread-a-lane compression ~3,600.
// Each chunk of 16 words is handed over by a named barrier (bar.arrive by
// the schedule warp, bar.sync by the rounds warp); a slot is freed by the
// rounds warp before its schedule warp refills it (blocks 2 and on). A
// lane past its last active block runs the block's remaining blocks and
// keeps its state.
//
// Each entry has a plain C interface, launches on the caller's stream and
// returns cudaGetLastError(); the kernels allocate nothing.

#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "stage.cuh"

namespace {

constexpr int THREADS = 128;

__constant__ uint32_t K256[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

__constant__ uint32_t H256[8] = {
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
};

__constant__ uint64_t K512[80] = {
    0x428A2F98D728AE22, 0x7137449123EF65CD, 0xB5C0FBCFEC4D3B2F, 0xE9B5DBA58189DBBC,
    0x3956C25BF348B538, 0x59F111F1B605D019, 0x923F82A4AF194F9B, 0xAB1C5ED5DA6D8118,
    0xD807AA98A3030242, 0x12835B0145706FBE, 0x243185BE4EE4B28C, 0x550C7DC3D5FFB4E2,
    0x72BE5D74F27B896F, 0x80DEB1FE3B1696B1, 0x9BDC06A725C71235, 0xC19BF174CF692694,
    0xE49B69C19EF14AD2, 0xEFBE4786384F25E3, 0x0FC19DC68B8CD5B5, 0x240CA1CC77AC9C65,
    0x2DE92C6F592B0275, 0x4A7484AA6EA6E483, 0x5CB0A9DCBD41FBD4, 0x76F988DA831153B5,
    0x983E5152EE66DFAB, 0xA831C66D2DB43210, 0xB00327C898FB213F, 0xBF597FC7BEEF0EE4,
    0xC6E00BF33DA88FC2, 0xD5A79147930AA725, 0x06CA6351E003826F, 0x142929670A0E6E70,
    0x27B70A8546D22FFC, 0x2E1B21385C26C926, 0x4D2C6DFC5AC42AED, 0x53380D139D95B3DF,
    0x650A73548BAF63DE, 0x766A0ABB3C77B2A8, 0x81C2C92E47EDAEE6, 0x92722C851482353B,
    0xA2BFE8A14CF10364, 0xA81A664BBC423001, 0xC24B8B70D0F89791, 0xC76C51A30654BE30,
    0xD192E819D6EF5218, 0xD69906245565A910, 0xF40E35855771202A, 0x106AA07032BBD1B8,
    0x19A4C116B8D2D0C8, 0x1E376C085141AB53, 0x2748774CDF8EEB99, 0x34B0BCB5E19B48A8,
    0x391C0CB3C5C95A63, 0x4ED8AA4AE3418ACB, 0x5B9CCA4F7763E373, 0x682E6FF3D6B2B8A3,
    0x748F82EE5DEFB2FC, 0x78A5636F43172F60, 0x84C87814A1F0AB72, 0x8CC702081A6439EC,
    0x90BEFFFA23631E28, 0xA4506CEBDE82BDE9, 0xBEF9A3F7B2C67915, 0xC67178F2E372532B,
    0xCA273ECEEA26619C, 0xD186B8C721C0C207, 0xEADA7DD6CDE0EB1E, 0xF57D4F7FEE6ED178,
    0x06F067AA72176FBA, 0x0A637DC5A2C898A6, 0x113F9804BEF90DAE, 0x1B710B35131C471B,
    0x28DB77F523047D84, 0x32CAAB7B40C72493, 0x3C9EBE0A15C9BEBC, 0x431D67C49C100D4C,
    0x4CC5D4BECB3E42B6, 0x597F299CFC657E2A, 0x5FCB6FAB3AD6FAEC, 0x6C44198C4A475817,
};

__constant__ uint64_t H512[8] = {
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
};

}  // namespace

// ops/sha256.py::_ShaArgs, field for field: blocks (lanes, n_blocks, 16)
// and n_active (lanes,) int64, contiguous; out (lanes, 8) int64
struct ShaArgs {
    const int64_t* blocks;
    const int64_t* n_active;
    int64_t lanes;
    int64_t n_blocks;
    int64_t* out;
};

// ops/sha512.py::_ChallengeArgs, field for field: sig_r and sig_pk (lanes,
// 32) and messages (lanes, width) uint8, msg_len (lanes,) int64,
// contiguous; out (lanes, 64) uint8
struct ChallengeArgs {
    const uint8_t* sig_r;
    const uint8_t* sig_pk;
    const uint8_t* messages;
    const int64_t* msg_len;
    int64_t lanes;
    int64_t width;
    uint8_t* out;
};

// circuits/gadgets.py::_RootArgs, field for field: leaf_bytes (lanes, width)
// uint8, leaf_len (lanes,) and n_enabled (one value) int64, contiguous;
// out (32,) uint8
struct RootArgs {
    const uint8_t* leaf_bytes;
    const int64_t* leaf_len;
    const int64_t* n_enabled;
    int64_t lanes;
    int64_t width;
    uint8_t* out;
};

// circuits/gadgets.py::_ProofArgs, field for field: leaf_bytes (proofs, width)
// and aunts (proofs, 4, 32) uint8, leaf_len (proofs,) and path_bits
// (proofs, 4) int64, contiguous; out (proofs, 32) uint8
struct ProofArgs {
    const uint8_t* leaf_bytes;
    const int64_t* leaf_len;
    const uint8_t* aunts;
    const int64_t* path_bits;
    int64_t proofs;
    int64_t width;
    uint8_t* out;
};

// the most lanes a validator tree takes: one block, a thread a leaf
constexpr int MAX_TREE_LANES = 1024;
// circuits/gadgets.py::header_proof_root: a header proof's depth
constexpr int PROOF_DEPTH = 4;

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// FIPS 180-4's round functions over 32-bit (SHA-256) or 64-bit (SHA-512)
// words: the rotations of Sigma0, Sigma1 (rounds) and sigma0, sigma1
// (schedule), and the right shifts of the sigmas
template <typename Word>
struct Spec;

template <>
struct Spec<uint32_t> {
    static constexpr int ROUNDS = 64;
    static __device__ __forceinline__ uint32_t k(int t) { return K256[t]; }
    static __device__ __forceinline__ uint32_t h0(int i) { return H256[i]; }
    static __device__ __forceinline__ uint32_t S0(uint32_t a) { return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22); }
    static __device__ __forceinline__ uint32_t S1(uint32_t e) { return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25); }
    static __device__ __forceinline__ uint32_t s0(uint32_t w) { return rotr(w, 7) ^ rotr(w, 18) ^ (w >> 3); }
    static __device__ __forceinline__ uint32_t s1(uint32_t w) { return rotr(w, 17) ^ rotr(w, 19) ^ (w >> 10); }
};

template <>
struct Spec<uint64_t> {
    static constexpr int ROUNDS = 80;
    static __device__ __forceinline__ uint64_t k(int t) { return K512[t]; }
    static __device__ __forceinline__ uint64_t h0(int i) { return H512[i]; }
    static __device__ __forceinline__ uint64_t S0(uint64_t a) { return rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39); }
    static __device__ __forceinline__ uint64_t S1(uint64_t e) { return rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41); }
    static __device__ __forceinline__ uint64_t s0(uint64_t w) { return rotr(w, 1) ^ rotr(w, 8) ^ (w >> 7); }
    static __device__ __forceinline__ uint64_t s1(uint64_t w) { return rotr(w, 19) ^ rotr(w, 61) ^ (w >> 6); }
};

// FIPS 180-4's message schedule: word t >= 16 into the ring w of the last
// 16 words
template <typename Word>
__device__ __forceinline__ Word schedule(Word (&w)[16], int t) {
    using S = Spec<Word>;
    w[t & 15] += S::s0(w[(t - 15) & 15]) + w[(t - 7) & 15] + S::s1(w[(t - 2) & 15]);
    return w[t & 15];
}

// The rounds of one block into the state h (FIPS 180-4's compression with
// its feed-forward add): word(t) gives schedule word t, called once for
// each t in ascending order. Every SHA entry runs this core.
template <typename Word, typename Words>
__device__ __forceinline__ void rounds(Word (&h)[8], Words&& word) {
    using S = Spec<Word>;
    Word v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = h[i];
#pragma unroll
    for (int t = 0; t < S::ROUNDS; ++t) {
        // v = (a, b, c, d, e, f, g, h) rotated by t: v[(8 - t) & 7] is a
        Word& A = v[(8 - t) & 7];
        Word& B = v[(9 - t) & 7];
        Word& C = v[(10 - t) & 7];
        Word& D = v[(11 - t) & 7];
        Word& E = v[(12 - t) & 7];
        Word& F = v[(13 - t) & 7];
        Word& G = v[(14 - t) & 7];
        Word& H = v[(15 - t) & 7];
        // h + K + W is ready a round early: only Sigma1 and Ch of e wait
        const Word hkw = H + S::k(t) + word(t);
        const Word t1 = hkw + S::S1(E) + ((E & F) ^ (~E & G));
        const Word t2 = S::S0(A) + ((A & B) ^ (A & C) ^ (B & C));
        D += t1;        // the new e
        H = t1 + t2;    // the new a: h's slot is a's next round
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] += v[i];
}

// One block of 16 words into h, its schedule expanded in the ring w.
template <typename Word>
__device__ __forceinline__ void compress(Word (&h)[8], Word (&w)[16]) {
    rounds(h, [&](int t) { return t < 16 ? w[t] : schedule(w, t); });
}

template <typename Word>
__device__ __forceinline__ void init(Word (&h)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = Spec<Word>::h0(i);
}

// One lane a thread: its active blocks compressed in order, the digest
// words written as int64.
template <typename Word>
__device__ __forceinline__ void sha_lane(const ShaArgs& a) {
    const int64_t lane = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (lane >= a.lanes) return;
    Word h[8];
    init(h);
    const int64_t active = a.n_active[lane];
    const int64_t n = active < a.n_blocks ? active : a.n_blocks;
    const int64_t* block = a.blocks + lane * a.n_blocks * 16;
    for (int64_t b = 0; b < n; ++b, block += 16) {
        Word w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) w[t] = Word(uint64_t(block[t]));
        compress(h, w);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) a.out[lane * 8 + i] = int64_t(uint64_t(h[i]));
}

// SHA-256 of a byte message of `len` bytes (clamped to [0, 64 NB - 9]) in a
// row of `width` bytes, padded as gadgets.py::bytes_to_blocks pads it: byte
// p of the padded stream is the row's byte p below len (zero at and past
// width), 0x80 at len, else zero, and the last active block's word 15 is
// the bit length (its word 14 is zero: len < 2^29).
template <int NB>
__device__ __forceinline__ void sha256_bytes(const uint8_t* row, int64_t width, int64_t len, uint32_t (&h)[8]) {
    constexpr int64_t CAP = 64 * NB - 9;
    len = len < 0 ? 0 : len > CAP ? CAP : len;
    const int64_t have = len < width ? len : width;
    const int active = int((len + 9 + 63) / 64);
    init(h);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        if (b >= active) break;
        uint32_t w[16];
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            uint32_t word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t p = 64 * b + 4 * t + j;
                const uint32_t byte = p < have ? row[p] : p == len ? 0x80u : 0u;
                word |= byte << (24 - 8 * j);
            }
            w[t] = word;
        }
        if (b == active - 1) w[15] = uint32_t(len * 8);
        compress(h, w);
    }
}

// SHA-256(0x01 || left || right), a CometBFT inner node: the 65 bytes and
// their padding as two blocks of words shifted by the prefix byte
__device__ __forceinline__ void sha256_pair(const uint32_t (&l)[8], const uint32_t (&r)[8], uint32_t (&h)[8]) {
    uint32_t w[16];
    w[0] = 0x01000000u | (l[0] >> 8);
#pragma unroll
    for (int k = 1; k < 8; ++k) w[k] = (l[k - 1] << 24) | (l[k] >> 8);
    w[8] = (l[7] << 24) | (r[0] >> 8);
#pragma unroll
    for (int k = 1; k < 8; ++k) w[8 + k] = (r[k - 1] << 24) | (r[k] >> 8);
    init(h);
    compress(h, w);
    w[0] = (r[7] << 24) | 0x00800000u;
#pragma unroll
    for (int k = 1; k < 15; ++k) w[k] = 0;
    w[15] = 65 * 8;
    compress(h, w);
}

__device__ __forceinline__ void store_digest(const uint32_t (&h)[8], uint8_t* out) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[4 * i + j] = uint8_t(h[i] >> (24 - 8 * j));
}

// One block, B' = blockDim.x threads (a power of two >= lanes): leaf i's
// digest (zeros for the padding rows i >= lanes), then log2 B' levels of
// pair-and-promote in shared memory with n read on the card: node i of the
// next level is H(node 2i, node 2i + 1) for i < n / 2, node n - 1 promoted
// at i = n / 2 when n is odd, else zeros; n becomes n / 2 + n % 2 (floor
// division, as torch's on a negative n). Reads happen before the barrier,
// writes after it: a level rewrites its nodes in place.
__global__ void __launch_bounds__(MAX_TREE_LANES) tmx_sha256_root_kernel(RootArgs a) {
    __shared__ uint32_t node[MAX_TREE_LANES][8];
    const int i = threadIdx.x;
    uint32_t h[8] = {};
    if (i < a.lanes) sha256_bytes<1>(a.leaf_bytes + i * a.width, a.width, a.leaf_len[i], h);
#pragma unroll
    for (int k = 0; k < 8; ++k) node[i][k] = h[k];
    int64_t n = *a.n_enabled;
    __syncthreads();
    for (int size = blockDim.x; size > 1; size >>= 1) {
        const int half = size >> 1;
        const int64_t pairs = n >> 1, odd = n & 1;
        uint32_t v[8] = {};
        if (i < half && i < pairs) {
            uint32_t l[8], r[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                l[k] = node[2 * i][k];
                r[k] = node[2 * i + 1][k];
            }
            sha256_pair(l, r, v);
        } else if (i < half && i == pairs && odd) {
            const int64_t last = n - 1 < size - 1 ? n - 1 : size - 1;  // n <= size within the contract
#pragma unroll
            for (int k = 0; k < 8; ++k) v[k] = node[last][k];
        }
        __syncthreads();
        if (i < half)
#pragma unroll
            for (int k = 0; k < 8; ++k) node[i][k] = v[k];
        __syncthreads();
        n = pairs + odd;
    }
    if (i == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) h[k] = node[0][k];
        store_digest(h, a.out);
    }
}

// A thread a proof: the leaf (up to two blocks), then at each depth d the
// pair (aunt, node) when path bit d is 1 (the node is a right child), else
// (node, aunt).
__global__ void __launch_bounds__(THREADS) tmx_sha256_proofs_kernel(ProofArgs a) {
    const int64_t p = int64_t(blockIdx.x) * THREADS + threadIdx.x;
    if (p >= a.proofs) return;
    uint32_t h[8];
    sha256_bytes<2>(a.leaf_bytes + p * a.width, a.width, a.leaf_len[p], h);
#pragma unroll 1
    for (int d = 0; d < PROOF_DEPTH; ++d) {
        const uint8_t* aunt = a.aunts + (p * PROOF_DEPTH + d) * 32;
        uint32_t s[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            s[k] = (uint32_t(aunt[4 * k]) << 24) | (uint32_t(aunt[4 * k + 1]) << 16) |
                   (uint32_t(aunt[4 * k + 2]) << 8) | uint32_t(aunt[4 * k + 3]);
        uint32_t l[8], r[8];
        const bool right = a.path_bits[p * PROOF_DEPTH + d] == 1;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            l[k] = right ? s[k] : h[k];
            r[k] = right ? h[k] : s[k];
        }
        sha256_pair(l, r, h);
    }
    store_digest(h, a.out + p * 32);
}

// The challenge: 32 lanes a block of three warps (see the head of the file).
constexpr int CHAL_LANES = 32;
constexpr int CHAL_THREADS = 3 * 32;
constexpr int CHUNK = 16;            // schedule words a hand-over
constexpr int CHUNKS = 80 / CHUNK;   // hand-overs a block
// shared memory of a launch over messages of `width` bytes: two slots of
// 80 words x 32 lanes, the spans of R, A and the messages, each with 16
// bytes past it that a word's aligned loads may touch
constexpr int64_t CHAL_WORDS_BYTES = 2 * 80 * CHAL_LANES * 8;
__host__ __device__ constexpr int64_t chal_span(int64_t row) { return tmx_stage::bytes(CHAL_LANES * row) + 16; }
__host__ __device__ constexpr int64_t chal_smem(int64_t width) {
    return CHAL_WORDS_BYTES + 2 * chal_span(32) + chal_span(width);
}
// the most shared memory a block may take on Hopper
constexpr int64_t MAX_SMEM = 232448;

// named barriers of the hand-over between the rounds warp and the
// schedule warp of slot s (64 threads): chunk c of slot s ready (the
// schedule warp arrives, the rounds warp waits), slot s free (the
// reverse); barrier 0 is __syncthreads'
__device__ __forceinline__ int ready_bar(int slot, int c) { return 1 + CHUNKS * slot + c; }
__device__ __forceinline__ int free_bar(int slot) { return 1 + 2 * CHUNKS + slot; }
__device__ __forceinline__ void bar_sync(int id) { asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id) { asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory"); }

// Big-endian word t of block b of a lane's padded stream: byte p is R's,
// A's, then the message's below `have` (the byte length, at most 64 +
// width), 0x80 at the byte length `len`, else zero; the last active
// block's word 15 is the bit length (its word 14 zero: len < 2^29). R and
// A end on word boundaries (32, 64), so a word's 8 bytes come from one row
// (r, pk or m in shared memory): three aligned 32-bit loads, a funnel
// shift and a byte swap, the bytes at and past `have` masked off (a word
// wholly past it reads its row's first bytes, never past the row's span).
__device__ __forceinline__ uint64_t stream_word(const uint8_t* r, const uint8_t* pk, const uint8_t* m, int64_t len,
                                                int64_t have, int64_t b, int t, int64_t last) {
    const int64_t p0 = 128 * b + 8 * t;
    if (b == last && t == 15) return uint64_t(uint32_t(len * 8));
    const uint8_t* row = p0 < 32 ? r : p0 < 64 ? pk : m;
    const int64_t off = p0 < have ? p0 - (p0 < 32 ? 0 : p0 < 64 ? 32 : 64) : 0;
    const int mis = int(reinterpret_cast<uintptr_t>(row + off) & 3);
    const uint32_t* a = reinterpret_cast<const uint32_t*>(row + off - mis);  // shared loads, not generic
    const uint32_t sh = uint32_t(mis) * 8;
    const uint32_t lo = __funnelshift_r(a[0], a[1], sh), hi = __funnelshift_r(a[1], a[2], sh);
    uint64_t w = (uint64_t(__byte_perm(lo, 0, 0x0123)) << 32) | __byte_perm(hi, 0, 0x0123);
    const int64_t keep = have - p0;  // bytes of the word below `have`
    w = keep >= 8 ? w : keep <= 0 ? 0 : w & (~uint64_t(0) << (64 - 8 * keep));
    const int64_t at = len - p0;  // where 0x80 goes
    return at >= 0 && at < 8 ? w | (uint64_t(0x80) << (56 - 8 * at)) : w;
}

__global__ void __launch_bounds__(CHAL_THREADS) tmx_sha512_challenge_kernel(ChallengeArgs a, int64_t n_blocks) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint64_t(*words)[80][CHAL_LANES] = reinterpret_cast<uint64_t(*)[80][CHAL_LANES]>(smem);  // [slot][t][lane]
    uint8_t* spans = smem + CHAL_WORDS_BYTES;
    const int64_t first = int64_t(blockIdx.x) * CHAL_LANES;
    const int n = int(a.lanes - first < CHAL_LANES ? a.lanes - first : CHAL_LANES);
    const int tid = threadIdx.x, warp = tid / CHAL_LANES;
    const uint8_t* rs = tmx_stage::span(spans, a.sig_r + first * 32, int64_t(n) * 32, tid, CHAL_THREADS);
    spans += chal_span(32);
    const uint8_t* pks = tmx_stage::span(spans, a.sig_pk + first * 32, int64_t(n) * 32, tid, CHAL_THREADS);
    spans += chal_span(32);
    const uint8_t* ms = tmx_stage::span(spans, a.messages + first * a.width, int64_t(n) * a.width, tid, CHAL_THREADS);
    // each warp takes the block's 32 lanes, one a thread; threads past the
    // last lane repeat it and write nothing
    const int l = tid % CHAL_LANES, li = l < n ? l : n - 1;
    const int64_t cap = 128 * n_blocks - 17, ml = a.msg_len[first + li];
    const int64_t len = ml < -64 ? 0 : ml > cap - 64 ? cap : ml + 64;
    const int64_t have = len < 64 + a.width ? len : 64 + a.width;
    const int64_t last = (len + 17 + 127) / 128 - 1;  // the lane's last active block
    // the block's blocks: the most any of its lanes has (the same in every
    // warp: they take the same lanes)
    const int64_t blocks = __reduce_max_sync(0xffffffffu, int(last)) + 1;
    tmx_stage::wait();
    __syncthreads();
    if (warp > 0) {  // a schedule warp: the blocks of its slot
        const int slot = warp - 1;
        const uint8_t *r = rs + 32 * li, *pk = pks + 32 * li, *m = ms + a.width * li;
#pragma unroll 1
        for (int64_t b = slot; b < blocks; b += 2) {
            if (b >= 2) bar_sync(free_bar(slot));
            uint64_t w[16];
#pragma unroll
            for (int t = 0; t < 16; ++t) {
                w[t] = stream_word(r, pk, m, len, have, b, t, last);
                words[slot][t][l] = w[t];
            }
            bar_arrive(ready_bar(slot, 0));
#pragma unroll
            for (int c = 1; c < CHUNKS; ++c) {
#pragma unroll
                for (int t = CHUNK * c; t < CHUNK * (c + 1); ++t) words[slot][t][l] = schedule(w, t);
                bar_arrive(ready_bar(slot, c));
            }
        }
        return;
    }
    uint64_t h[8];  // the rounds warp
    init(h);
#pragma unroll 1
    for (int64_t b = 0; b < blocks; ++b) {
        const int slot = int(b & 1);
        uint64_t g[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) g[i] = h[i];
        rounds(g, [&](int t) {
            if (t % CHUNK == 0) bar_sync(ready_bar(slot, t / CHUNK));
            return words[slot][t][l];
        });
        if (b + 2 < blocks) bar_arrive(free_bar(slot));
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i] = b <= last ? g[i] : h[i];
    }
    if (l < n) {
        uint4* out = reinterpret_cast<uint4*>(a.out + (first + l) * 64);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint64_t x = h[2 * k], y = h[2 * k + 1];
            out[k] = make_uint4(__byte_perm(uint32_t(x >> 32), 0, 0x0123), __byte_perm(uint32_t(x), 0, 0x0123),
                                __byte_perm(uint32_t(y >> 32), 0, 0x0123), __byte_perm(uint32_t(y), 0, 0x0123));
        }
    }
}

__global__ void __launch_bounds__(THREADS) tmx_sha256_kernel(ShaArgs a) { sha_lane<uint32_t>(a); }

__global__ void __launch_bounds__(THREADS) tmx_sha512_kernel(ShaArgs a) { sha_lane<uint64_t>(a); }

int launch(void (*kernel)(ShaArgs), const ShaArgs& a, void* stream) {
    if (a.lanes < 0 || a.n_blocks < 0) return (int)cudaErrorInvalidValue;
    if (a.lanes == 0) return 0;
    const int64_t blocks = (a.lanes + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tmx_sha256_blocks(const ShaArgs* args, void* stream) {
    return launch(tmx_sha256_kernel, *args, stream);
}

extern "C" int tmx_sha512_blocks(const ShaArgs* args, void* stream) {
    return launch(tmx_sha512_kernel, *args, stream);
}

// lanes of 32 a block; cudaErrorInvalidValue and no launch for a width
// whose staged rows do not fit a block's shared memory
extern "C" int tmx_sha512_challenge(const ChallengeArgs* args, void* stream) {
    const ChallengeArgs& a = *args;
    if (a.lanes < 0 || a.width < 0) return (int)cudaErrorInvalidValue;
    if (a.lanes == 0) return 0;
    const int64_t blocks = (a.lanes + CHAL_LANES - 1) / CHAL_LANES, smem = chal_smem(a.width);
    if (blocks > INT_MAX || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(tmx_sha512_challenge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return (int)err;
    }
    tmx_sha512_challenge_kernel<<<(unsigned)blocks, CHAL_THREADS, size_t(smem), (cudaStream_t)stream>>>(
        a, (64 + a.width + 17 + 127) / 128);
    return (int)cudaGetLastError();
}

// one block of lanes rounded up to a power of two; 1 <= lanes <=
// MAX_TREE_LANES, else cudaErrorInvalidValue and no launch
extern "C" int tmx_sha256_validator_root(const RootArgs* args, void* stream) {
    const RootArgs& a = *args;
    if (a.lanes < 1 || a.lanes > MAX_TREE_LANES || a.width < 0) return (int)cudaErrorInvalidValue;
    int threads = 1;
    while (threads < a.lanes) threads <<= 1;
    tmx_sha256_root_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int tmx_sha256_header_proofs(const ProofArgs* args, void* stream) {
    const ProofArgs& a = *args;
    if (a.proofs < 0 || a.width < 0) return (int)cudaErrorInvalidValue;
    if (a.proofs == 0) return 0;
    const int64_t blocks = (a.proofs + THREADS - 1) / THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tmx_sha256_proofs_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
