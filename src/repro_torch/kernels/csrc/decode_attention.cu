// Decode attention for Hopper (sm_90a): one query token per row against a
// contiguous or a paged KV cache, with the keys split over the SMs.
//
// Hand-written counterparts of two Pallas kernels of the reference:
//
//   attn_decode        kernels/decode_attention.py _dec_kernel
//   attn_paged_decode  kernels/paged_attention.py  _paged_dec_kernel
//
// (The flash kernels, attn_flash and attn_paged_flash, are in attention.cu
// and carry this design to S > 1; both sources take their cp.async,
// ldmatrix and mma helpers from attention_helpers.cuh.)
//
// Both are one templated routine, decode_kernel<T, Src, kD>, over a "KV
// source": ContigKV reads the per-row cache k/v (B, C, Hkv, D) with
// positions (B, C); PagedKV reads the shared block pool kp/vp (nb, bs, Hkv,
// D) with positions ppos (nb, bs) through the block table tbl (B, M).  K/V
// are read where they lie.  Head dims 16, 64, 128 and 256, bf16 and fp32.
//
// Semantics (exactly the reference's):
//   * scale = 1/sqrt(D) of the real D (passed in by the wrapper);
//   * a key is valid iff kv_pos >= 0, kv_pos <= q_pos (decode is causal)
//     and, when windowed, q_pos - kv_pos < window; in the paged source its
//     table column must also be >= 0;
//   * NEG_INF = -1e30 is finite; online softmax (m, l, acc) in fp32;
//   * out = acc / max(l, 1e-30), so a row with no valid key is exactly 0,
//     cast to q's dtype (round to nearest even for bf16).
// The kernel keeps scores and m in log2 units (score * scale * log2(e)),
// so every exponential is one exp2f, and multiplies acc by 1 / max(l,
// 1e-30): both change the rounding only, within TIGHT in fp32.
//
// What bounds it.  Decode reads each K/V byte once and does 4 operations
// per key and query head per dim: at the GQA groups of the ported configs
// (G 12-16) that is 16-32 operations per byte, far below the ~295 at which
// the H100's tensor cores become the limit.  So the bound is bytes: each
// valid entry's K and V row of its kv head (plus its position) over 3.35
// TB/s, 1.4-1.6 us at the main path's shapes.  What the kernel pays on top
// is latency: dependent trips to memory and the merge, so the design keeps
// the bytes in flight over many SMs and the trips few.
//
// Design.
//   1. The keys are split over blocks.  The grid is (splits, Hkv *
//      row_tiles, B); a block owns split_keys consecutive logical entries
//      of one (row b, kv head) and up to kRows = 16 query heads of its GQA
//      group (row_tiles = ceil(G / 16) is 1 for every ported config).  The
//      wrapper computes split_keys (128 unless the capacity needs more than
//      kMaxSplits splits) and splits from the shapes alone (capacity C or
//      M * bs), so there is no device sync.  A block reads only its own
//      split's positions (and table columns), one entry per thread.
//   2. One launch, with a deterministic merge.  Each block writes an fp32
//      partial (m, l, acc) for its rows to a workspace the wrapper
//      provides; after a barrier, its thread 0 fences (fences are
//      cumulative) and takes a ticket from an atomic counter per (b, kv
//      head, row tile).  The block that draws the last ticket merges the
//      partials in split order 0..n-1, whichever block arrives last, so two
//      calls give bitwise-equal results; then it resets the counter to 0.
//      A block whose split holds no valid key writes an empty partial (m =
//      -1e30, l = 0; its acc is never read: the merge skips a partial with
//      l = 0, which is exact, as it adds 0) and still takes its ticket: a
//      block that left early would leave the merge waiting.  The merging
//      block reads every split's m and l in one trip (they lie together in
//      the workspace), lists the live splits, and then reads only their
//      acc, four splits' loads in flight per thread.  The counter buffer is
//      zeroed once per device and reused, which assumes the calls of one
//      device run on one stream.  A second, merge-only launch would add
//      host time to every attention layer of every token tick, which is
//      host-bound.
//   3. Tiles in flight, kept in their own type.  Each of the kWarps warps
//      owns split_keys / kWarps consecutive keys and walks them in chunks of
//      kChunk = 16 through its own ring of kRing chunk buffers in shared
//      memory: K and V rows go from device memory straight to shared
//      memory with cp.async, 16 bytes per lane, zero-filled for a masked
//      key (its V row must be 0, not stale bits, as p = 0 multiplies it), and
//      a chunk with no valid key is neither loaded nor computed.  q comes
//      the same way, with the first chunks.  A warp waits only for its own
//      copies (cp.async.wait_group + __syncwarp; one block barrier makes q
//      visible), so the main loop has no other block-wide barrier.  At the
//      default split of 128 keys the ring (two chunks, wherever two fit in
//      140 KB) holds all of a warp's keys, so a block makes three dependent
//      trips to device memory: positions, q and K/V, partial + ticket.
//   4. Tensor cores for bf16.  With the GQA group as the 16 rows of
//      mma.sync.m16n8k16 (bf16 in, fp32 accumulate; G 12 padded with zero
//      rows), S = Q K^T for a warp's 16 keys is two mmas per 16 dims (two
//      accumulators, odd and even 16 dims, halve the dependent chain); the
//      bf16 x bf16 products are exact in fp32, so only the order of the sum
//      differs from the reference.  P stays fp32 in the reference (which
//      casts V to fp32 before the product), so P is split as P = P_hi +
//      P_lo, both bf16, and P V is two mmas per 8 output dims: the pair
//      carries 16 bits of P's mantissa, far finer than the bf16 output, at
//      the cost of one more mma on a unit that is otherwise idle.  Q, K and
//      V fragments come from shared memory with ldmatrix (V transposed);
//      rows are padded by 16 bytes so those reads are free of bank
//      conflicts.  fp32 inputs (the tests and the card-vs-CPU checks) take
//      the same split, ring and merge with fp32 FMA on the CUDA cores, in
//      the mma's register layout, so the softmax and the epilogue are
//      shared.
//   5. The block merges its warps' states through shared memory (in warp
//      order), writes one partial, and only the merging block touches the
//      output.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// (or the launch's refusal) so the wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_helpers.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                  // query rows per block: mma M
constexpr int kChunk = 16;                 // keys per warp step: P.V's mma K
constexpr int kSplitQuantum = kWarps * kChunk;
constexpr int kMaxSplits = 128;            // attention_common.MAX_SPLITS
constexpr int kRingBudget = 140 * 1024;    // two ring slots if they fit

// elements of T per shared-memory row: D plus 16 bytes of padding
template <typename T, int kD>
__host__ __device__ constexpr int row_elems() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

// bytes of one ring slot (K and V chunks) of all warps
template <typename T, int kD>
__host__ __device__ constexpr int slot_bytes() {
  return kWarps * 2 * kChunk * row_elems<T, kD>() *
         static_cast<int>(sizeof(T));
}

template <typename T, int kD>
__host__ __device__ constexpr int ring_depth() {
  return 2 * slot_bytes<T, kD>() <= kRingBudget ? 2 : 1;
}

// The ring's region also holds the warps' final states and, in the merging
// block, the m and l of every split.
template <typename T, int kD>
__host__ __device__ constexpr int ring_region_bytes() {
  constexpr int ring = ring_depth<T, kD>() * slot_bytes<T, kD>();
  constexpr int merge = 2 * kMaxSplits * kRows * 4;
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ bool key_valid(int p, int qp, int window) {
  return p >= 0 && p <= qp && (!window || qp - p < window);
}

// Contiguous cache: logical entry e of row b is row b * C + e of k/v.
template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  const int* pos;                              // (B, C), -1 = empty
  int C;

  // the K/V row of entry e if it is valid for a query at qp, else -1
  __device__ int entry(int b, int e, int qp, int window) const {
    if (e >= C) return -1;
    const int ent = b * C + e;
    return key_valid(__ldg(pos + ent), qp, window) ? ent : -1;
  }
};

// Paged pool: logical entry e of row b is entry e % bs of block tbl[b, e /
// bs]; a column of -1 masks its entries.
template <typename T>
struct PagedKV {
  const T* k;                                  // (nb, bs, Hkv, D)
  const T* v;
  const int* ppos;                             // (nb, bs), -1 = empty
  const int* tbl;                              // (B, M), -1 = unused
  int M, bs;

  __device__ int entry(int b, int e, int qp, int window) const {
    const int col = e / bs;
    if (col >= M) return -1;
    const int blk = __ldg(tbl + static_cast<long long>(b) * M + col);
    if (blk < 0) return -1;
    const int ent = blk * bs + e % bs;
    return key_valid(__ldg(ppos + ent), qp, window) ? ent : -1;
  }
};

// One warp's online-softmax state for 16 rows, in the mma accumulator
// layout: lane holds rows g = lane / 4 and g + 8 (index h), and of each 8
// output dims j the two at 8 j + 2 (lane % 4) (+1).  l is the lane's share
// (its own columns) until the end.
template <int kD>
struct State {
  float m[2], l[2];
  float acc[kD / 8][4];
};

// Scale and mask a chunk's scores s (accumulator layout: s[n][2 h + e] is
// row g + 8 h, key 8 n + 2 (lane % 4) + e; bit k of vmask: key k valid),
// fold them into the running state, and leave p = exp(s - m) (0 for a
// masked key) in s.  Scores and m are kept in log2 units (scale2 = scale *
// log2(e)), so every exponential is one exp2f.
template <int kD>
__device__ __forceinline__ void softmax_step(State<kD>& st, float (&s)[2][4],
                                             unsigned vmask, int lane,
                                             float scale2) {
  const int c0 = (lane % 4) * 2;
  bool valid[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) valid[n][e] = (vmask >> (n * 8 + c0 + e)) & 1u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * h + e];
        x = valid[n][e] ? x * scale2 : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(st.m[h], mx);
    const float alpha = exp2f(st.m[h] - m_new);
    st.m[h] = m_new;
    st.l[h] *= alpha;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      st.acc[j][2 * h] *= alpha;
      st.acc[j][2 * h + 1] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * h + e];
        x = valid[n][e] ? exp2f(x - m_new) : 0.f;
        st.l[h] += x;
      }
  }
}

// One chunk of 16 keys on the tensor cores (bf16).
template <int kD>
__device__ __forceinline__ void chunk(State<kD>& st,
                                      const __nv_bfloat16* qs,
                                      const __nv_bfloat16* ks,
                                      const __nv_bfloat16* vs, unsigned vmask,
                                      int lane, float scale2) {
  constexpr int RS = row_elems<__nv_bfloat16, kD>();
  float s[2][4] = {}, t[2][4] = {};            // even and odd 16 dims
  const int r8 = lane % 8, m1 = (lane / 8) & 1, m2 = lane / 16;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    unsigned a[4], bk[4];
    ldsm_x4(a, qs + (r8 + m1 * 8) * RS + kk * 16 + m2 * 8);
    ldsm_x4(bk, ks + (r8 + m2 * 8) * RS + kk * 16 + m1 * 8);
    float (&acc)[2][4] = (kk & 1) ? t : s;
    mma_bf16(acc[0], a, bk[0], bk[1]);
    mma_bf16(acc[1], a, bk[2], bk[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] += t[n][i];
  softmax_step(st, s, vmask, lane, scale2);
  unsigned ph[4], pl[4];
  split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
  split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
  split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
  split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    unsigned bv[4];
    ldsm_x4_t(bv, vs + (r8 + m1 * 8) * RS + j * 16 + m2 * 8);
    mma_bf16(st.acc[2 * j], ph, bv[0], bv[1]);
    mma_bf16(st.acc[2 * j], pl, bv[0], bv[1]);
    mma_bf16(st.acc[2 * j + 1], ph, bv[2], bv[3]);
    mma_bf16(st.acc[2 * j + 1], pl, bv[2], bv[3]);
  }
}

// One chunk of 16 keys with fp32 FMA, in the same register layout.
template <int kD>
__device__ __forceinline__ void chunk(State<kD>& st, const float* qs,
                                      const float* ks, const float* vs,
                                      unsigned vmask, int lane, float scale2) {
  constexpr int RS = row_elems<float, kD>();
  const int g = lane / 4, c0 = (lane % 4) * 2;
  float s[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4* qr =
          reinterpret_cast<const float4*>(qs + (g + (i >> 1) * 8) * RS);
      const float4* kr =
          reinterpret_cast<const float4*>(ks + (n * 8 + c0 + (i & 1)) * RS);
      float d = 0.f;
#pragma unroll 8
      for (int c = 0; c < kD / 4; ++c) {
        const float4 a = qr[c], k4 = kr[c];
        d = fmaf(a.x, k4.x, d);
        d = fmaf(a.y, k4.y, d);
        d = fmaf(a.z, k4.z, d);
        d = fmaf(a.w, k4.w, d);
      }
      s[n][i] = d;
    }
  softmax_step(st, s, vmask, lane, scale2);
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {        // p of key kk from its owner
    const int from = (lane & ~3) | ((kk & 7) >> 1);
    const float p0 = __shfl_sync(kFull, s[kk >> 3][kk & 1], from);
    const float p1 = __shfl_sync(kFull, s[kk >> 3][2 + (kk & 1)], from);
    const float* vr = vs + kk * RS + c0;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const float2 v2 = *reinterpret_cast<const float2*>(vr + 8 * j);
      st.acc[j][0] = fmaf(p0, v2.x, st.acc[j][0]);
      st.acc[j][1] = fmaf(p0, v2.y, st.acc[j][1]);
      st.acc[j][2] = fmaf(p1, v2.x, st.acc[j][2]);
      st.acc[j][3] = fmaf(p1, v2.y, st.acc[j][3]);
    }
  }
}

template <typename T, typename Src, int kD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
              T* __restrict__ out, float* __restrict__ ws, int* cnt, Src src,
              int Hq, int Hkv, int row_tiles, int split_keys, int window,
              float scale) {
  constexpr int kRing = ring_depth<T, kD>();
  constexpr int RS = row_elems<T, kD>();
  constexpr int kPieces = kD * static_cast<int>(sizeof(T)) / 16;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));   // per piece
  constexpr int kWarpRing = kRing * 2 * kChunk * RS;         // elements
  constexpr int WS = kD + 8;                   // a warp state's row stride
  static_assert(kThreads >= kMaxSplits, "one thread per split in the merge");
  static_assert(kWarpRing * sizeof(T) >= (2 * kRows + kRows * WS) * 4,
                "a warp's state fits its ring region");

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hk = blockIdx.y / row_tiles, rt = blockIdx.y % row_tiles;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int row0 = rt * kRows;
  const int nrows = min(kRows, G - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = (b * Hkv + hk) * row_tiles + rt;
  // The workspace (fp32): first m[kRows], l[kRows] of every (slot, split),
  // then acc[kRows][kD] of every (slot, split).
  const long long nparts = static_cast<long long>(gridDim.y) * gridDim.z *
                           nsplit;
  float* ml_ws = ws;
  float* acc_ws = ws + nparts * 2 * kRows;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                        // kRows x RS
  unsigned char* region = smem + kRows * RS * sizeof(T);
  T* ring = reinterpret_cast<T*>(region);
  int* srcs = reinterpret_cast<int*>(region + ring_region_bytes<T, kD>());
  __shared__ float wts[kWarps][kRows];
  __shared__ float rinv[kRows];
  __shared__ int live_split[kMaxSplits];
  __shared__ unsigned live_mask[kWarps];
  __shared__ int is_last;

  // each key's K/V row (-1 = masked): one trip to the positions (two
  // through the table)
  const int qp = q_pos[b];
  const int e0 = split * split_keys;
  int live = 0;
  for (int k = tid; k < split_keys; k += kThreads) {
    const int ent = src.entry(b, e0 + k, qp, window);
    srcs[k] = ent;
    live |= ent >= 0;
  }
  live = __syncthreads_or(live);

  const long long pidx = static_cast<long long>(slot) * nsplit + split;
  float* part_ml = ml_ws + pidx * 2 * kRows;
  float* part_acc = acc_ws + pidx * kRows * kD;
  if (!live) {                                 // empty partial: l = 0
    if (tid < nrows) {
      part_ml[tid] = kNegInf;
      part_ml[kRows + tid] = 0.f;
    }
  } else {
    // the block's query rows (zero past nrows), in flight with the first
    // K/V chunks: the oldest cp.async group
    const T* qb = q + (static_cast<long long>(b) * Hq + hk * G + row0) * kD;
    for (int i = tid; i < kRows * kPieces; i += kThreads) {
      const int r = i / kPieces, pc = (i % kPieces) * kElems;
      cp_async16(qs + r * RS + pc, qb + (r < nrows ? r * kD + pc : 0),
                 r < nrows);
    }
    cp_async_commit();

    const int wkeys = split_keys / kWarps;
    const int nch = wkeys / kChunk;
    const int* wsrc = srcs + warp * wkeys;
    T* wring = ring + warp * kWarpRing;
    // bit k: key k of chunk c is valid
    auto chunk_mask = [&](int c) {
      return __ballot_sync(kFull,
                           lane < kChunk && wsrc[c * kChunk + lane] >= 0);
    };
    auto fetch = [&](int c) {
      T* kd = wring + (c % kRing) * 2 * kChunk * RS;
      T* vd = kd + kChunk * RS;
      for (int i = lane; i < kChunk * kPieces; i += 32) {
        const int j = i / kPieces, pc = (i % kPieces) * kElems;
        const int ent = wsrc[c * kChunk + j];
        const long long off =
            (static_cast<long long>(ent < 0 ? 0 : ent) * Hkv + hk) * kD + pc;
        cp_async16(kd + j * RS + pc, src.k + off, ent >= 0);
        cp_async16(vd + j * RS + pc, src.v + off, ent >= 0);
      }
    };

    State<kD> st;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.m[h] = kNegInf;
      st.l[h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[j][i] = 0.f;

    // every thread commits one group per step, empty or not, so
    // wait_group<kRing - 1> at step c means q and chunk c have landed
#pragma unroll
    for (int c = 0; c < kRing; ++c) {
      if (c < nch && chunk_mask(c)) fetch(c);
      cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<kRing - 1>();
      if (c == 0)
        __syncthreads();                       // q, loaded by all warps
      else
        __syncwarp();
      if (const unsigned vmask = chunk_mask(c)) {
        const T* kd = wring + (c % kRing) * 2 * kChunk * RS;
        chunk<kD>(st, qs, kd, kd + kChunk * RS, vmask, lane, scale * kLog2e);
      }
      __syncwarp();                            // buffer free before reuse
      if (c + kRing < nch && chunk_mask(c + kRing)) fetch(c + kRing);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncwarp();

    // the warp's state, row-major (rows padded to WS floats against bank
    // conflicts), into its own ring region: m, l, acc
    float* wst = reinterpret_cast<float*>(wring);
    const int g = lane / 4, c0 = (lane % 4) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.l[h] += __shfl_xor_sync(kFull, st.l[h], 1);
      st.l[h] += __shfl_xor_sync(kFull, st.l[h], 2);
      if (lane % 4 == 0) {
        wst[g + 8 * h] = st.m[h];
        wst[kRows + g + 8 * h] = st.l[h];
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<float2*>(wst + 2 * kRows + (g + 8 * h) * WS +
                                   8 * j + c0) =
            make_float2(st.acc[j][2 * h], st.acc[j][2 * h + 1]);
    }
    __syncthreads();

    // merge the warps' states in warp order into the block's partial
    auto wbase = [&](int w) {
      return reinterpret_cast<const float*>(ring + w * kWarpRing);
    };
    if (tid < kRows) {
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wbase(w)[tid]);
      float L = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float lw = wbase(w)[kRows + tid];
        const float x = lw > 0.f ? exp2f(wbase(w)[tid] - M) : 0.f;
        wts[w][tid] = x;
        L += lw * x;
      }
      if (tid < nrows) {
        part_ml[tid] = M;
        part_ml[kRows + tid] = L;
      }
    }
    __syncthreads();
    for (int i = tid; i < nrows * (kD / 4); i += kThreads) {
      const int r = i / (kD / 4), d = (i % (kD / 4)) * 4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        fma4(a,
             *reinterpret_cast<const float4*>(wbase(w) + 2 * kRows + r * WS +
                                              d),
             wts[w][r]);
      store4(part_acc + r * kD + d, a);
    }
  }

  // ticket: the last block of this (b, kv head, row tile) merges.  One
  // thread fences after the barrier (fences are cumulative: the block's
  // partial is visible before the ticket), and the last block's thread 0
  // fences again before its barrier releases the others to read.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(cnt + slot, 1) == nsplit - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;

  // m and l of every split and row in one trip (they lie together), then
  // the splits with a valid key (l > 0; every row of a split has the same
  // keys) in split order: the others are skipped, which is exact
  float* ml = reinterpret_cast<float*>(region);  // [split][m 16, l 16]
  {
    const float4* src4 = reinterpret_cast<const float4*>(
        ml_ws + static_cast<long long>(slot) * nsplit * 2 * kRows);
    for (int i = tid; i < nsplit * 2 * kRows / 4; i += kThreads)
      reinterpret_cast<float4*>(ml)[i] = __ldcg(src4 + i);
  }
  __syncthreads();
  const bool mine = tid < nsplit && ml[tid * 2 * kRows + kRows] > 0.f;
  const unsigned mask = __ballot_sync(kFull, mine);
  if (lane == 0) live_mask[warp] = mask;
  __syncthreads();
  int before = __popc(mask & ((1u << lane) - 1u)), nlive = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = __popc(live_mask[w]);
    before += w < warp ? n : 0;
    nlive += n;
  }
  if (mine) live_split[before] = tid;
  __syncthreads();
  // each live split's weight 2^(m - m*) per row, in place of its m, and
  // 1 / max(l, 1e-30) per row: eight lanes per row, all rows at once
  {
    const int r = tid / 8, sub = tid % 8;
    const bool row = r < nrows;
    float M = kNegInf;
    for (int j = sub; row && j < nlive; j += 8)
      M = fmaxf(M, ml[live_split[j] * 2 * kRows + r]);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    float L = 0.f;
    for (int j = sub; row && j < nlive; j += 8) {
      float* mj = ml + live_split[j] * 2 * kRows;
      const float x = exp2f(mj[r] - M);
      L += mj[kRows + r] * x;
      mj[r] = x;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) L += __shfl_xor_sync(kFull, L, o);
    if (row && sub == 0) rinv[r] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // out = the live partials' acc, weighted and summed in split order, times
  // rinv: each thread owns kPer float4 of the output and walks the live
  // splits with the loads of kUnroll splits in flight
  constexpr int kPer = (kRows * kD / 4 + kThreads - 1) / kThreads;
  constexpr int kUnroll = 4;
  const int n4 = nrows * (kD / 4);
  const float* acc_slot = acc_ws + static_cast<long long>(slot) * nsplit *
                                       kRows * kD;
  float4 a[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll kUnroll
  for (int j = 0; j < nlive; ++j) {
    const int sp = live_split[j];
    const float4* pacc = reinterpret_cast<const float4*>(
        acc_slot + static_cast<long long>(sp) * kRows * kD);
    float4 v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads;
      v[e] = i < n4 ? __ldcg(pacc + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = tid + e * kThreads;
      if (i < n4) fma4(a[e], v[e], ml[sp * 2 * kRows + i / (kD / 4)]);
    }
  }
  T* ob = out + (static_cast<long long>(b) * Hq + hk * G + row0) * kD;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads;
    if (i < n4) {
      const float x = rinv[i / (kD / 4)];
      store4(ob + static_cast<long long>(i) * 4,
             make_float4(a[e].x * x, a[e].y * x, a[e].z * x, a[e].w * x));
    }
  }
  if (tid == 0) cnt[slot] = 0;                 // ready for the next call
}

template <typename T, int kD>
size_t smem_bytes(int split_keys) {
  return sizeof(T) * kRows * row_elems<T, kD>() +
         ring_region_bytes<T, kD>() + sizeof(int) * split_keys;
}

template <typename T, typename Src, int kD>
int launch_d(const void* q, const int* q_pos, void* out, float* ws, int* cnt,
             Src src, int B, int Hq, int Hkv, int capacity, int split_keys,
             int window, float scale, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int G = Hq / Hkv;
  const int row_tiles = (G + kRows - 1) / kRows;
  int splits = (capacity + split_keys - 1) / split_keys;
  if (splits < 1) splits = 1;
  if (splits > kMaxSplits || B > 65535 || Hkv * row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = smem_bytes<T, kD>(split_keys);
  auto kernel = decode_kernel<T, Src, kD>;
  const cudaError_t e = fit_dynamic_smem(kernel, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(splits, Hkv * row_tiles, B);
  kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), q_pos, static_cast<T*>(out), ws, cnt, src, Hq,
      Hkv, row_tiles, split_keys, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Src>
int launch(const void* q, const int* q_pos, void* out, float* ws, int* cnt,
           Src src, int B, int Hq, int Hkv, int D, int capacity,
           int split_keys, int window, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || split_keys < kSplitQuantum ||
      split_keys % kSplitQuantum != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_d<T, Src, 16>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv,
                                  capacity, split_keys, window, scale, stream);
    case 64:
      return launch_d<T, Src, 64>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv,
                                  capacity, split_keys, window, scale, stream);
    case 128:
      return launch_d<T, Src, 128>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv,
                                   capacity, split_keys, window, scale, stream);
    case 256:
      return launch_d<T, Src, 256>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv,
                                   capacity, split_keys, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int smem_of(int D, int split_keys) {
  switch (D) {
    case 16: return static_cast<int>(smem_bytes<T, 16>(split_keys));
    case 64: return static_cast<int>(smem_bytes<T, 64>(split_keys));
    case 128: return static_cast<int>(smem_bytes<T, 128>(split_keys));
    case 256: return static_cast<int>(smem_bytes<T, 256>(split_keys));
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of one block in bytes (-1: D not instantiated)
int attn_decode_smem(int D, int split_keys, int is_bf16) {
  return is_bf16 ? smem_of<__nv_bfloat16>(D, split_keys)
                 : smem_of<float>(D, split_keys);
}

// q (B,1,Hq,D), k/v (B,C,Hkv,D), q_pos (B,1), kv_pos (B,C) -> out
// (B,1,Hq,D).  With slots = B * Hkv * ceil(G / 16) and splits =
// ceil(C / split_keys): ws is an fp32 workspace of slots * splits * 16 *
// (D + 2) floats; cnt holds slots int32 counters, 0 on entry and on exit.
int attn_decode(const void* q, const void* k, const void* v, const int* q_pos,
                const int* kv_pos, void* out, float* ws, int* cnt, int B,
                int Hq, int Hkv, int C, int D, int window, int split_keys,
                float scale, int is_bf16, void* stream) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    ContigKV<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                    kv_pos, C};
    return launch<T>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv, D, C,
                     split_keys, window, scale, stream);
  }
  ContigKV<float> src{static_cast<const float*>(k),
                      static_cast<const float*>(v), kv_pos, C};
  return launch<float>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv, D, C,
                       split_keys, window, scale, stream);
}

// q (B,1,Hq,D), kp/vp (nb,bs,Hkv,D), ppos (nb,bs), tbl (B,M), q_pos (B,1);
// ws and cnt as for attn_decode, with capacity M * bs
int attn_paged_decode(const void* q, const void* kp, const void* vp,
                      const int* ppos, const int* tbl, const int* q_pos,
                      void* out, float* ws, int* cnt, int B, int Hq, int Hkv,
                      int bs, int M, int D, int window, int split_keys,
                      float scale, int is_bf16, void* stream) {
  if (bs < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    using T = __nv_bfloat16;
    PagedKV<T> src{static_cast<const T*>(kp), static_cast<const T*>(vp), ppos,
                   tbl, M, bs};
    return launch<T>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv, D, M * bs,
                     split_keys, window, scale, stream);
  }
  PagedKV<float> src{static_cast<const float*>(kp),
                     static_cast<const float*>(vp), ppos, tbl, M, bs};
  return launch<float>(q, q_pos, out, ws, cnt, src, B, Hq, Hkv, D, M * bs,
                       split_keys, window, scale, stream);
}

}  // extern "C"
