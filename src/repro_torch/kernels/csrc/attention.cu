// Flash attention for Hopper (sm_90a): S query tokens per row against a
// contiguous or a paged KV cache, with the keys split over the SMs.
//
// Hand-written counterparts of two Pallas kernels of the reference:
//
//   attn_flash         kernels/flash_attention.py  _fa_kernel
//   attn_paged_flash   kernels/paged_attention.py  _paged_fa_kernel
//
// (The two decode kernels, attn_decode and attn_paged_decode, are in
// decode_attention.cu; both sources take their cp.async, ldmatrix and mma
// helpers from attention_helpers.cuh.)
//
// Both are one templated routine, flash_kernel<T, Src, kD, kBR>, over a
// "KV source": ContigSrc reads the per-row cache k/v (B, C, Hkv, D) with
// positions (B, C); PagedSrc reads the shared block pool kp/vp (nb, bs,
// Hkv, D) with positions ppos (nb, bs) through the block table tbl (B, M).
// K/V are read where they lie (no transpose, no padding of D or of the
// block to TPU lane widths).  Head dims 16, 64, 128 and 256, bf16 and fp32.
//
// Semantics (exactly the reference's):
//   * scale = 1/sqrt(D) of the real D (passed in by the wrapper);
//   * a key is valid iff kv_pos >= 0, and kv_pos <= q_pos when causal, and
//     q_pos - kv_pos < window when windowed; in the paged kernel the key's
//     table column must also be >= 0;
//   * NEG_INF = -1e30 is finite; online softmax (m, l, acc) in fp32; both
//     products accumulate in fp32;
//   * out = acc / max(l, 1e-30), so a row with no valid key is exactly 0,
//     cast to q's dtype (round to nearest even for bf16).
// The kernel keeps scores and m in log2 units (score * scale * log2(e)),
// so every exponential is one exp2f, and multiplies acc by 1 / max(l,
// 1e-30): both change the rounding only, within TIGHT in fp32.
//
// What bounds it.  At the main path's shapes (a 128-token prefill chunk
// against ~1000 cached keys, G 12-16) the operations bound is 1.4-2.1 us
// and the bytes bound below it; a call moves little data and does little
// arithmetic by the card's measure, so what it pays is latency: dependent
// trips to memory per key tile, the number of tiles one block walks in
// turn, and the merge.  The design cuts the tiles per block (splits), keeps
// the next tile's bytes in flight (cp.async ring) and shortens each tile's
// arithmetic (tensor cores).
//
// Design.
//   1. Rows.  The query rows of one (row b, kv head) enumerate (s, g), the
//      GQA group index g fastest, so one K/V tile serves every query head
//      of the group (q head = hk * G + g, the reference's h // G rule).  A
//      block takes kBR = 64 or 128 of them (4 or 8 warps of 16 rows: each
//      warp owns the M = 16 of mma.sync.m16n8k16); rows past S * G are
//      inert (q = 0, no valid key, nothing stored).
//   2. Keys split over blocks, one launch.  The grid is (splits, Hkv *
//      row_tiles, B); a block owns split_keys consecutive logical entries
//      (a multiple of kTileK = 64).  The wrapper computes split_keys and
//      splits from the shapes alone (attention_common.flash_split), so
//      there is no device sync.  Each block writes an fp32 partial (m, l,
//      acc) for its rows to a workspace; after a barrier its thread 0
//      fences (fences are cumulative) and takes a ticket from an atomic
//      counter per (b, kv head, row tile).  The block that draws the last
//      ticket merges the partials in split order 0..n-1, whichever block
//      arrives last, so two calls give bitwise-equal results; then it
//      resets the counter to 0.  A block whose split holds no key valid for
//      its rows (past the causal frontier, outside the window, empty slots,
//      -1 columns) writes an empty partial (m = -1e30, l = 0 for every row;
//      its acc is never read) and still takes its ticket: a block that left
//      early would leave the merge waiting.  With one split the block
//      writes the output itself and takes no ticket.
//   3. Which keys a block loads.  The block reads its split's positions
//      (through its table columns when paged) into shared memory, one trip
//      per key for all threads, and loads a key iff its position is >= 0
//      and inside the hull of its rows' valid ranges (<= the largest q_pos
//      when causal, > the smallest q_pos - window when windowed).  A 64-key
//      tile with no such key is neither loaded nor computed; the rows'
//      own masks apply in the softmax, exactly.  A key not loaded is
//      zero-filled (cp.async with src-size 0): its V row must be 0, not
//      stale bits (NaN, Inf), as p = 0 multiplies it.
//   4. Tiles in flight, in their own type.  K and V tiles of 64 keys go
//      from device memory straight to shared memory with cp.async, 16 bytes
//      a lane (bf16 stays bf16), through a ring of kRing stages: the loads
//      of tile t+1 are in flight while tile t is computed; one block
//      barrier per tile.  q comes the same way, with the first tile.
//   5. Tensor cores for bf16.  Per warp and tile, S = Q K^T (16 rows x 64
//      keys) is (D / 16) x 8 mma.sync m16n8k16 (bf16 in, fp32 accumulate:
//      the bf16 x bf16 products are exact in fp32, so only the order of the
//      sum differs from the reference); the softmax runs once per tile on
//      the accumulators; P V is 4 x (D / 8) mmas.  P stays fp32 in the
//      reference (which casts V to fp32 before the product), so P = P_hi
//      + P_lo (both bf16) and P V is two mmas per 8 output dims: 16 bits
//      of P's mantissa, for 3-5% of the call's time over rounding P once
//      (on an H100; tools/torch_flash_ablate.py times both).
//      Q, K and V fragments come from shared memory with ldmatrix (V
//      transposed); rows are padded by 16 bytes so those reads are free of
//      bank conflicts.  fp32 inputs (the tests and the card-vs-CPU checks)
//      take the same rows, split, ring and merge with fp32 FMA on the CUDA
//      cores, in the mma's register layout (P through a per-warp scratch in
//      shared memory), so the softmax and the epilogue are shared.
//   6. The merge reads every split's m and l in one trip, lists the splits
//      with a valid key for some row, computes each row's weights 2^(m_i -
//      m*) and 1 / max(l, 1e-30), and then reads only the live splits' acc
//      (L2-resident) into registers: eight float4 a thread from four splits
//      at once, 32 loads in flight, summed in split order.
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// (or the launch's refusal) so the wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_helpers.cuh"

namespace {

constexpr int kTileK = 64;                 // keys per tile
constexpr int kMaxSplits = 64;             // attention_common.FLASH_MAX_SPLITS
constexpr int kSmemMax = 223 * 1024;       // dynamic: 227 KB opt-in less static
constexpr int kKeyBudget = 16 * 1024;      // left for positions and lists
constexpr int kPStride = kTileK + 4;       // fp32 P scratch row (floats)

// elements of T per shared-memory row: D plus 16 bytes of padding
template <typename T, int kD>
__host__ __device__ constexpr int row_elems() {
  return kD + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int kD, int kBR>
__host__ __device__ constexpr int q_bytes() {
  return kBR * row_elems<T, kD>() * static_cast<int>(sizeof(T));
}

// one ring stage: a K and a V tile
template <typename T, int kD>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * kTileK * row_elems<T, kD>() * static_cast<int>(sizeof(T));
}

// fp32 only: each warp's P tile (16 rows) for the FMA P.V
template <typename T, int kBR>
__host__ __device__ constexpr int pscratch_bytes() {
  return sizeof(T) == 4 ? (kBR / 16) * 16 * kPStride * 4 : 0;
}

// two stages where q, two stages and the scratch leave kKeyBudget
template <typename T, int kD, int kBR>
__host__ __device__ constexpr int ring_depth() {
  return q_bytes<T, kD, kBR>() + 2 * stage_bytes<T, kD>() +
                     pscratch_bytes<T, kBR>() + kKeyBudget <=
                 kSmemMax
             ? 2
             : 1;
}

// The ring's region also holds, in the merging block, every split's m and
// l (then the weights).
template <typename T, int kD, int kBR>
__host__ __device__ constexpr long long region_bytes(int nsplit) {
  const long long ring =
      static_cast<long long>(ring_depth<T, kD, kBR>()) * stage_bytes<T, kD>();
  const long long merge = 8LL * nsplit * kBR;
  return ring > merge ? ring : merge;
}

template <typename T, int kD, int kBR>
__host__ __device__ long long smem_bytes(int split_keys, int nsplit) {
  return q_bytes<T, kD, kBR>() + region_bytes<T, kD, kBR>(nsplit) +
         pscratch_bytes<T, kBR>() +
         4LL * (2 * split_keys + split_keys / kTileK);
}

__device__ __forceinline__ bool key_valid(int p, int qp, int causal,
                                          int window) {
  return p >= 0 && (!causal || p <= qp) && (!window || qp - p < window);
}

// Contiguous cache: logical entry e of row b is row b * C + e of k/v.
template <typename T>
struct ContigSrc {
  const T* k;
  const T* v;
  const int* pos;                              // (B, C), -1 = empty
  int C;

  // (K/V row, position) of entry e; (-1, -1) past the capacity
  __device__ int2 lookup(int b, int e) const {
    if (e >= C) return make_int2(-1, -1);
    const int ent = b * C + e;
    return make_int2(ent, __ldg(pos + ent));
  }
};

// Paged pool: logical entry e of row b is entry e % bs of block tbl[b, e /
// bs]; a column of -1 masks its entries.
template <typename T>
struct PagedSrc {
  const T* k;                                  // (nb, bs, Hkv, D)
  const T* v;
  const int* ppos;                             // (nb, bs), -1 = empty
  const int* tbl;                              // (B, M), -1 = unused
  int M, bs;

  __device__ int2 lookup(int b, int e) const {
    const int col = e / bs;
    if (col >= M) return make_int2(-1, -1);
    const int blk = __ldg(tbl + static_cast<long long>(b) * M + col);
    if (blk < 0) return make_int2(-1, -1);
    const int ent = blk * bs + e % bs;
    return make_int2(ent, __ldg(ppos + ent));
  }
};

// One warp's online-softmax state for its 16 rows, in the mma accumulator
// layout: lane holds rows g = lane / 4 and g + 8 (index h), and of each 8
// output dims j the two at 8 j + 2 (lane % 4) (+1).  l is the lane's share
// (its own columns) until the end.
template <int kD>
struct State {
  float m[2], l[2];
  float acc[kD / 8][4];
};

// S = Q K^T for the warp's 16 rows and a 64-key tile, on the tensor cores:
// s[n][2 h + e] is row g + 8 h, key 8 n + 2 (lane % 4) + e.
template <int kD>
__device__ __forceinline__ void tile_scores(float (&s)[8][4],
                                            const __nv_bfloat16* qw,
                                            const __nv_bfloat16* ks,
                                            int lane) {
  constexpr int RS = row_elems<__nv_bfloat16, kD>();
  const int r8 = lane % 8, m1 = (lane / 8) & 1, m2 = lane / 16;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, qw + (r8 + m1 * 8) * RS + kk * 16 + m2 * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bk[4];
      ldsm_x4(bk, ks + (np * 16 + r8 + m2 * 8) * RS + kk * 16 + m1 * 8);
      mma_bf16(s[2 * np], a, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }
}

// The same with fp32 FMA, in the same layout.
template <int kD>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const float* qw,
                                            const float* ks, int lane) {
  constexpr int RS = row_elems<float, kD>();
  const int g = lane / 4, c0 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4* qr =
          reinterpret_cast<const float4*>(qw + (g + (i >> 1) * 8) * RS);
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
}

// Mask a tile's scores per row (kpos: the tile's key positions, -1 for a
// key not loaded; qp/rok: the lane's two rows' positions and whether they
// are real), fold them into the running state, and leave p = 2^(s - m) (0
// for a masked key) in s.
template <int kD>
__device__ __forceinline__ void tile_softmax(State<kD>& st, float (&s)[8][4],
                                             const int* kpos,
                                             const int (&qp)[2],
                                             const bool (&rok)[2], int causal,
                                             int window, float scale2,
                                             int lane) {
  const int c0 = (lane % 4) * 2;
  int p[8][2];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 pp = *reinterpret_cast<const int2*>(kpos + n * 8 + c0);
    p[n][0] = pp.x;
    p[n][1] = pp.y;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned vm = 0u;                          // bit 2 n + e: key valid
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = rok[h] && key_valid(p[n][e], qp[h], causal, window);
        vm |= static_cast<unsigned>(ok) << (2 * n + e);
        float& x = s[n][2 * h + e];
        x = ok ? x * scale2 : kNegInf;
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * h + e];
        x = (vm >> (2 * n + e)) & 1u ? exp2f(x - m_new) : 0.f;
        st.l[h] += x;
      }
  }
}

// acc += P V for a 64-key tile on the tensor cores (bf16).
template <int kD>
__device__ __forceinline__ void tile_pv(State<kD>& st, const float (&s)[8][4],
                                        const __nv_bfloat16* vs, float*,
                                        int lane) {
  constexpr int RS = row_elems<__nv_bfloat16, kD>();
  const int r8 = lane % 8, m1 = (lane / 8) & 1, m2 = lane / 16;
#pragma unroll
  for (int kt = 0; kt < kTileK / 16; ++kt) {
    unsigned ph[4], pl[4];
    split_bf16(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
    split_bf16(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
    split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      unsigned bv[4];
      ldsm_x4_t(bv, vs + (kt * 16 + r8 + m1 * 8) * RS + j * 16 + m2 * 8);
      mma_bf16(st.acc[2 * j], ph, bv[0], bv[1]);
      mma_bf16(st.acc[2 * j + 1], ph, bv[2], bv[3]);
      mma_bf16(st.acc[2 * j], pl, bv[0], bv[1]);
      mma_bf16(st.acc[2 * j + 1], pl, bv[2], bv[3]);
    }
  }
}

// The same with fp32 FMA: P goes through the warp's scratch (16 rows of
// kPStride floats), then each key's V row meets its two rows' p.
template <int kD>
__device__ __forceinline__ void tile_pv(State<kD>& st, const float (&s)[8][4],
                                        const float* vs, float* ps,
                                        int lane) {
  constexpr int RS = row_elems<float, kD>();
  const int g = lane / 4, c0 = (lane % 4) * 2;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(ps + (g + 8 * h) * kPStride + n * 8 + c0, s[n][2 * h],
             s[n][2 * h + 1]);
  __syncwarp();
#pragma unroll 4
  for (int kk = 0; kk < kTileK; ++kk) {
    const float p0 = ps[g * kPStride + kk];
    const float p1 = ps[(g + 8) * kPStride + kk];
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
  __syncwarp();                                // scratch free for the next
}

// out row of (b, kv head hk, block row r): q head hk * G + g at s
__device__ __forceinline__ long long row_offset(int b, int S, int Hq, int G,
                                                int hk, int row) {
  const int s = row / G, g = row % G;
  return (static_cast<long long>(b) * S + s) * Hq + hk * G + g;
}

template <typename T, typename Src, int kD, int kBR>
__global__ void __launch_bounds__(kBR * 2)
flash_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
             T* __restrict__ out, float* __restrict__ ws, int* cnt, Src src,
             int S, int Hq, int Hkv, int row_tiles, int split_keys,
             int causal, int window, float scale) {
  constexpr int kWarps = kBR / 16;
  constexpr int kThreads = kWarps * 32;
  constexpr int kRing = ring_depth<T, kD, kBR>();
  constexpr int RS = row_elems<T, kD>();
  constexpr int kPieces = kD * static_cast<int>(sizeof(T)) / 16;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));   // per piece
  constexpr int kStage = 2 * kTileK * RS;                    // elements
  static_assert(kThreads >= kMaxSplits, "one thread per split in the merge");
  static_assert(kThreads >= kBR, "one thread per row");

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int hk = blockIdx.y / row_tiles, rt = blockIdx.y % row_tiles;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int row0 = rt * kBR;
  const int nrows = min(kBR, S * G - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = (b * Hkv + hk) * row_tiles + rt;
  const int ntiles = split_keys / kTileK;
  // The workspace (fp32): first m[kBR], l[kBR] of every (slot, split), then
  // acc[kBR][kD] of every (slot, split).
  const long long nparts = static_cast<long long>(gridDim.y) * gridDim.z *
                           nsplit;
  float* ml_ws = ws;
  float* acc_ws = ws + nparts * 2 * kBR;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);                        // kBR x RS
  unsigned char* region = smem + q_bytes<T, kD, kBR>();
  T* ring = reinterpret_cast<T*>(region);
  float* pscr = reinterpret_cast<float*>(
      region + region_bytes<T, kD, kBR>(nsplit));            // fp32 only
  int* epos = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(pscr) +
                                     pscratch_bytes<T, kBR>());
  int* srcs = epos + split_keys;
  int* tlist = srcs + split_keys;
  __shared__ int rpos[kBR];
  __shared__ int wlo[kWarps], whi[kWarps];
  __shared__ float rinv[kBR];
  __shared__ int live_split[kMaxSplits], live_flag[kMaxSplits];
  __shared__ int n_tiles, is_last, n_live;

  // one trip: the rows' positions (in flight while the split's lookups
  // are issued) and the split's (K/V row, position)
  const int qp_row = tid < nrows
                         ? q_pos[static_cast<long long>(b) * S +
                                 (row0 + tid) / G]
                         : 0;
  const int e0 = split * split_keys;
  for (int k = tid; k < split_keys; k += kThreads) {
    const int2 ep = src.lookup(b, e0 + k);
    srcs[k] = ep.x;
    epos[k] = ep.x >= 0 ? ep.y : -1;
  }
  {
    if (tid < kBR) rpos[tid] = qp_row;
    const int lo = __reduce_min_sync(kFull, tid < nrows ? qp_row : INT_MAX);
    const int hi = __reduce_max_sync(kFull, tid < nrows ? qp_row : INT_MIN);
    if (lane == 0) {
      wlo[warp] = lo;
      whi[warp] = hi;
    }
  }
  __syncthreads();
  // keys in the hull of the rows' valid ranges; per 64-key tile, whether
  // it holds one (warp w takes tiles w, w + kWarps, ...)
  {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, wlo[w]);
      hi = max(hi, whi[w]);
    }
    for (int t = warp; t < ntiles; t += kWarps) {
      bool any = false;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = t * kTileK + u * 32 + lane;
        const int p = epos[k];
        const bool live = p >= 0 && (!causal || p <= hi) &&
                          (!window || lo - p < window);
        if (!live) {
          epos[k] = -1;
          srcs[k] = -1;
        }
        any |= live;
      }
      any = __any_sync(kFull, any);
      if (lane == 0) tlist[t] = any;
    }
  }
  __syncthreads();
  if (warp == 0) {                             // ordered list of live tiles
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < ntiles && tlist[t];
      const unsigned bal = __ballot_sync(kFull, live);
      __syncwarp();                            // every read before a write
      if (live) tlist[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
      __syncwarp();
    }
    if (lane == 0) n_tiles = n;
  }
  __syncthreads();
  const int nt = n_tiles;

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

  const int g = lane / 4, c0 = (lane % 4) * 2;
  const int wrow = warp * 16;                  // the warp's first row
  if (nt > 0) {
    // q rows (zero past nrows): the oldest cp.async group
    for (int i = tid; i < kBR * kPieces; i += kThreads) {
      const int r = i / kPieces, pc = (i % kPieces) * kElems;
      const bool ok = r < nrows;
      const T* qr =
          q + (ok ? row_offset(b, S, Hq, G, hk, row0 + r) * kD + pc : 0);
      cp_async16(qs + r * RS + pc, qr, ok);
    }
    cp_async_commit();
    auto fetch = [&](int it) {
      const int t = tlist[it];
      T* kd = ring + (it % kRing) * kStage;
      T* vd = kd + kTileK * RS;
      for (int i = tid; i < kTileK * kPieces; i += kThreads) {
        const int j = i / kPieces, pc = (i % kPieces) * kElems;
        const int ent = srcs[t * kTileK + j];
        const long long off =
            (static_cast<long long>(ent < 0 ? 0 : ent) * Hkv + hk) * kD + pc;
        cp_async16(kd + j * RS + pc, src.k + off, ent >= 0);
        cp_async16(vd + j * RS + pc, src.v + off, ent >= 0);
      }
    };
    int qp[2];
    bool rok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + g + 8 * h;
      rok[h] = r < nrows;
      qp[h] = rpos[r];
    }
    const bool busy = wrow < nrows;            // warp-uniform
    const float scale2 = scale * kLog2e;
    float* ps = pscr + warp * 16 * kPStride;   // fp32 only

    // Every thread commits one group per step, empty or not: tile it is
    // group it + 1 (after q), so at step it wait_group<kRing - 2> (kRing >=
    // 2) means q and tile it have landed.  With one stage the next tile is
    // fetched after the block is done with the current one.
#pragma unroll
    for (int c = 0; c + 1 < kRing; ++c) {
      if (c < nt) fetch(c);
      cp_async_commit();
    }
    for (int it = 0; it < nt; ++it) {
      if constexpr (kRing == 1) {
        fetch(it);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<(kRing >= 2 ? kRing - 2 : 0)>();
      }
      __syncthreads();
      if constexpr (kRing >= 2) {
        if (it + kRing - 1 < nt) fetch(it + kRing - 1);
        cp_async_commit();
      }
      if (busy) {
        const T* kd = ring + (it % kRing) * kStage;
        float s[8][4];
        tile_scores<kD>(s, qs + wrow * RS, kd, lane);
        tile_softmax<kD>(st, s, epos + tlist[it] * kTileK, qp, rok, causal,
                         window, scale2, lane);
        tile_pv<kD>(st, s, kd + kTileK * RS, ps, lane);
      }
      if constexpr (kRing == 1) __syncthreads();
    }
    cp_async_wait<0>();
  }

  // the lane's rows: l summed over the four lanes that share them
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.l[h] += __shfl_xor_sync(kFull, st.l[h], 1);
    st.l[h] += __shfl_xor_sync(kFull, st.l[h], 2);
  }

  if (nsplit == 1) {                           // no partial, no merge
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + g + 8 * h;
      if (r >= nrows) continue;
      const float inv = 1.f / fmaxf(st.l[h], 1e-30f);
      T* orow = out + row_offset(b, S, Hq, G, hk, row0 + r) * kD + c0;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        store2(orow + 8 * j, st.acc[j][2 * h] * inv,
               st.acc[j][2 * h + 1] * inv);
    }
    return;
  }

  // the partial: m and l of every row (empty ones too), acc when live
  const long long pidx = static_cast<long long>(slot) * nsplit + split;
  float* part_ml = ml_ws + pidx * 2 * kBR;
  float* part_acc = acc_ws + pidx * kBR * kD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + g + 8 * h;
    if (lane % 4 == 0) {
      part_ml[r] = st.m[h];
      part_ml[kBR + r] = st.l[h];
    }
    if (nt > 0) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        store2(part_acc + r * kD + 8 * j + c0, st.acc[j][2 * h],
               st.acc[j][2 * h + 1]);
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

  // m and l of every split and row in one trip, then the splits with a
  // valid key for some row (l > 0), in split order: the others are
  // skipped, which is exact (their acc is 0 or never written)
  float* ml = reinterpret_cast<float*>(region);  // [split][m kBR, l kBR]
  if (tid < kMaxSplits) live_flag[tid] = 0;
  {
    const float4* src4 = reinterpret_cast<const float4*>(
        ml_ws + static_cast<long long>(slot) * nsplit * 2 * kBR);
    for (int i = tid; i < nsplit * 2 * kBR / 4; i += kThreads)
      reinterpret_cast<float4*>(ml)[i] = __ldcg(src4 + i);
  }
  __syncthreads();
  for (int i = tid; i < nsplit * nrows; i += kThreads) {
    const int sp = i / nrows, r = i - sp * nrows;
    if (ml[sp * 2 * kBR + kBR + r] > 0.f) live_flag[sp] = 1;
  }
  __syncthreads();
  if (warp == 0) {                             // ordered list of live splits
    int n = 0;
    for (int s0 = 0; s0 < nsplit; s0 += 32) {
      const bool live = s0 + lane < nsplit && live_flag[s0 + lane];
      const unsigned bal = __ballot_sync(kFull, live);
      if (live) live_split[n + __popc(bal & ((1u << lane) - 1u))] = s0 + lane;
      n += __popc(bal);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();
  const int nlive = n_live;
  // each row's weights 2^(m_i - m*) in place of m_i (0 where l_i = 0), and
  // 1 / max(l, 1e-30): one thread per row
  if (tid < nrows) {
    const int r = tid;
    float M = kNegInf;
    for (int j = 0; j < nlive; ++j) {
      const float* mj = ml + live_split[j] * 2 * kBR;
      if (mj[kBR + r] > 0.f) M = fmaxf(M, mj[r]);
    }
    float L = 0.f;
    for (int j = 0; j < nlive; ++j) {
      float* mj = ml + live_split[j] * 2 * kBR;
      const float lj = mj[kBR + r];
      const float x = lj > 0.f ? exp2f(mj[r] - M) : 0.f;
      L += lj * x;
      mj[r] = x;
    }
    rinv[r] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  // out = the live partials' acc, weighted and summed in split order, times
  // rinv: each thread owns kPer float4 of a pass and walks the live splits
  // with the loads of kUn splits in flight
  constexpr int kPer = 8, kUn = 4;
  constexpr int kRowVecs = kD / 4;
  const int n4 = nrows * kRowVecs;
  const float4* acc_slot = reinterpret_cast<const float4*>(
      acc_ws + static_cast<long long>(slot) * nsplit * kBR * kD);
  for (int base = tid; base < n4; base += kPer * kThreads) {
    float4 a[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) a[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < nlive; j0 += kUn) {
      float4 v[kUn][kPer];
#pragma unroll
      for (int u = 0; u < kUn; ++u) {
        const int sp = live_split[min(j0 + u, nlive - 1)];
        const float4* pacc = acc_slot + static_cast<long long>(sp) * kBR *
                                            kRowVecs;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int i = base + e * kThreads;
          v[u][e] = (i < n4 && j0 + u < nlive) ? __ldcg(pacc + i)
                                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kUn; ++u) {
        if (j0 + u >= nlive) break;
        const float* w = ml + live_split[j0 + u] * 2 * kBR;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int i = base + e * kThreads;
          if (i < n4) fma4(a[e], v[u][e], w[i / kRowVecs]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = base + e * kThreads;
      if (i < n4) {
        const int r = i / kRowVecs, d = (i % kRowVecs) * 4;
        const float x = rinv[r];
        store4(out + row_offset(b, S, Hq, G, hk, row0 + r) * kD + d,
               make_float4(a[e].x * x, a[e].y * x, a[e].z * x, a[e].w * x));
      }
    }
  }
  if (tid == 0) cnt[slot] = 0;                 // ready for the next call
}

template <typename T, typename Src, int kD, int kBR>
int launch_r(const void* q, const int* q_pos, void* out, float* ws, int* cnt,
             Src src, int B, int S, int Hq, int Hkv, int capacity,
             int split_keys, int causal, int window, float scale,
             void* stream) {
  const int G = Hq / Hkv;
  const int row_tiles = (S * G + kBR - 1) / kBR;
  if (B == 0 || row_tiles == 0) return static_cast<int>(cudaSuccess);
  int splits = (capacity + split_keys - 1) / split_keys;
  if (splits < 1) splits = 1;
  if (splits > kMaxSplits || B > 65535 ||
      static_cast<long long>(Hkv) * row_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long shmem = smem_bytes<T, kD, kBR>(split_keys, splits);
  if (shmem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_kernel<T, Src, kD, kBR>;
  const cudaError_t e = fit_dynamic_smem(kernel, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(splits, Hkv * row_tiles, B);
  kernel<<<grid, kBR * 2, static_cast<size_t>(shmem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), q_pos, static_cast<T*>(out), ws, cnt, src, S,
      Hq, Hkv, row_tiles, split_keys, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// rows per block: 64 for every type, 128 for bf16
template <typename T, typename Src, int kD>
int launch_d(int rows, const void* q, const int* q_pos, void* out, float* ws,
             int* cnt, Src src, int B, int S, int Hq, int Hkv, int capacity,
             int split_keys, int causal, int window, float scale,
             void* stream) {
  if (rows == 64)
    return launch_r<T, Src, kD, 64>(q, q_pos, out, ws, cnt, src, B, S, Hq,
                                    Hkv, capacity, split_keys, causal, window,
                                    scale, stream);
  if constexpr (sizeof(T) == 2) {
    if (rows == 128)
      return launch_r<T, Src, kD, 128>(q, q_pos, out, ws, cnt, src, B, S, Hq,
                                       Hkv, capacity, split_keys, causal,
                                       window, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename Src>
int launch(int rows, const void* q, const int* q_pos, void* out, float* ws,
           int* cnt, Src src, int B, int S, int Hq, int Hkv, int D,
           int capacity, int split_keys, int causal, int window, float scale,
           void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0 || split_keys < kTileK ||
      split_keys % kTileK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_d<T, Src, 16>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq,
                                  Hkv, capacity, split_keys, causal, window,
                                  scale, stream);
    case 64:
      return launch_d<T, Src, 64>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq,
                                  Hkv, capacity, split_keys, causal, window,
                                  scale, stream);
    case 128:
      return launch_d<T, Src, 128>(rows, q, q_pos, out, ws, cnt, src, B, S,
                                   Hq, Hkv, capacity, split_keys, causal,
                                   window, scale, stream);
    case 256:
      return launch_d<T, Src, 256>(rows, q, q_pos, out, ws, cnt, src, B, S,
                                   Hq, Hkv, capacity, split_keys, causal,
                                   window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B,S,Hq,D), k/v (B,C,Hkv,D), q_pos (B,S), kv_pos (B,C) -> out
// (B,S,Hq,D).  With slots = B * Hkv * ceil(S * G / rows) and splits =
// ceil(C / split_keys) > 1: ws is an fp32 workspace of slots * splits *
// rows * (D + 2) floats; cnt holds slots int32 counters, 0 on entry and on
// exit (neither is touched with one split).
int attn_flash(const void* q, const void* k, const void* v, const int* q_pos,
               const int* kv_pos, void* out, float* ws, int* cnt, int B,
               int S, int Hq, int Hkv, int C, int D, int causal, int window,
               int rows, int split_keys, float scale, int is_bf16,
               void* stream) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    ContigSrc<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                     kv_pos, C};
    return launch<T>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq, Hkv, D, C,
                     split_keys, causal, window, scale, stream);
  }
  ContigSrc<float> src{static_cast<const float*>(k),
                       static_cast<const float*>(v), kv_pos, C};
  return launch<float>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq, Hkv, D, C,
                       split_keys, causal, window, scale, stream);
}

// q (B,S,Hq,D), kp/vp (nb,bs,Hkv,D), ppos (nb,bs), tbl (B,M), q_pos (B,S);
// ws and cnt as for attn_flash, with capacity M * bs
int attn_paged_flash(const void* q, const void* kp, const void* vp,
                     const int* ppos, const int* tbl, const int* q_pos,
                     void* out, float* ws, int* cnt, int B, int S, int Hq,
                     int Hkv, int bs, int M, int D, int causal, int window,
                     int rows, int split_keys, float scale, int is_bf16,
                     void* stream) {
  if (bs < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    using T = __nv_bfloat16;
    PagedSrc<T> src{static_cast<const T*>(kp), static_cast<const T*>(vp),
                    ppos, tbl, M, bs};
    return launch<T>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq, Hkv, D,
                     M * bs, split_keys, causal, window, scale, stream);
  }
  PagedSrc<float> src{static_cast<const float*>(kp),
                      static_cast<const float*>(vp), ppos, tbl, M, bs};
  return launch<float>(rows, q, q_pos, out, ws, cnt, src, B, S, Hq, Hkv, D,
                       M * bs, split_keys, causal, window, scale, stream);
}

}  // extern "C"
