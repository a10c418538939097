// Flash attention kernels for Hopper (sm_90a): paged and contiguous.
//
// Hand-written counterparts of two Pallas kernels of the reference:
//
//   attn_paged_flash   kernels/paged_attention.py  _paged_fa_kernel
//   attn_flash         kernels/flash_attention.py  _fa_kernel
//
// (The two decode kernels, attn_decode and attn_paged_decode, are in
// decode_attention.cu: they split the keys over the SMs.)
//
// Both are one templated routine, attn_kernel<T, Src, kD>, over a
// "KV source": PagedSrc reads the shared block pool kp/vp (nb, bs, Hkv, D)
// through the block table tbl (B, M); ContigSrc reads the per-row cache
// k/v (B, C, Hkv, D).  Both read K/V where they lie (no transpose, no
// padding of D or of the block to TPU lane widths).  Head dims 16, 64, 128
// and 256 (those of the ported configs and the tests; recurrentgemma-9b's
// is 256, whose 32-key fp32 K+V tile alone is 64 KB, so it always takes the
// >48 KB shared-memory path) are instantiated.
//
// Semantics (exactly the reference's):
//   * scale = 1/sqrt(D) of the real D (passed in by the wrapper);
//   * a key is valid iff kv_pos >= 0, and kv_pos <= q_pos when causal, and
//     q_pos - kv_pos < window when windowed; in the paged kernels the key's
//     table column must also be >= 0;
//   * NEG_INF = -1e30 is finite; online softmax (m, l, acc) in fp32; both
//     products accumulate in fp32;
//   * out = acc / max(l, 1e-30), so a row with no valid key is exactly 0,
//     cast to q's dtype (round to nearest even for bf16).
//
// Mapping.  The TPU grid's sequential axis (table column j, or KV block ik)
// becomes a loop over key tiles inside one block; nothing carries across
// blocks.  A block owns one (batch row b, kv head hk) and a tile of up to
// kMaxRows query rows, the rows enumerating (s, g) with the GQA group index
// g fastest, so one K/V tile staged in shared memory serves every query
// head of the group (q head = hk * G + g, the reference's h // G rule):
// ceil(S*G / kMaxRows) row tiles per (b, hk).
//
// Scalar prefetch becomes the block reading its own table row: the paged
// prologue copies tbl[b, :] into shared memory and keeps the live columns
// only.  The prologue then reads every live entry's position into shared
// memory, marks in one 32-bit mask per tile of kTileK = 32 entries the keys
// valid for at least one row of the block, and lists the tiles with any.
// Skipping a column with tbl < 0, a tile with no valid key, or a key valid
// for no row is exact: a fully masked key leaves (m, l, acc) unchanged
// (m_new = m, alpha = exp(0) = 1, p = 0).
//
// Work per listed tile: each thread holds 4-element vectors of the tile's
// K and V rows in registers; the loads of the NEXT tile are issued before
// the current one is computed, so device-memory latency overlaps the math.
// The tile is staged in shared memory as fp32 (K rows padded to D+4
// floats: lane j reads key j's row as float4 without bank conflicts); each
// of the 8 warps owns two rows; lane j computes the score of key j for
// both (four independent FMA chains each), the warp reduces max and sum
// with shuffles, and each lane accumulates D/32 contiguous output dims in
// registers, four keys at a time.  fp32 FMA on the
// CUDA cores throughout: no wgmma or TMA yet.
//
// Bounds, for the main path's shapes (PERF.md has the numbers): bytes =
// each live K/V entry read once per kv head (2 * Hkv * D * itemsize per
// entry, plus its 4-byte position) plus q and the output; operations =
// 4 * D * sum over query rows and heads of the keys valid for that row.
// bound = max(bytes / 3.35 TB/s, operations / 989 TFLOP/s bf16).
//
// Plain C entry points, loaded with ctypes; each returns cudaGetLastError()
// (or the launch's refusal) so the wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;                     // keys per tile: one per lane
constexpr int kMaxRows = 16;                   // query rows per block
constexpr int kRowsPerWarp = kMaxRows / kWarps;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// four consecutive elements of T, as loaded from device memory
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float4 to_f(float4 v) { return v; }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static float4 to_f(uint2 v) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool key_valid(int p, int qp, int causal,
                                          int window) {
  return p >= 0 && (!causal || p <= qp) && (!window || qp - p < window);
}

// Contiguous cache: logical entry e of row b is k[b, e] (B, C, Hkv, D).
template <typename T>
struct ContigSrc {
  const T* k;
  const T* v;
  const int* pos;                              // (B, C), -1 = empty
  int C;

  // Each entry's position into epos; returns the number of entries.
  __device__ int prologue(int b, int*, int* epos, int tid) const {
    for (int e = tid; e < C; e += kThreads)
      epos[e] = pos[static_cast<long long>(b) * C + e];
    return C;
  }
  __device__ long long entry(int b, int e, const int*) const {
    return static_cast<long long>(b) * C + e;
  }
};

// Paged pool: logical entry e of row b is entry e % bs of the e / bs'th
// LIVE column of tbl[b] (columns with tbl < 0 are dropped in prologue).
template <typename T>
struct PagedSrc {
  const T* k;                                  // (nb, bs, Hkv, D)
  const T* v;
  const int* ppos;                             // (nb, bs), -1 = empty
  const int* tbl;                              // (B, M), -1 = unused
  int M, bs;

  // Copy tbl[b, :] into cols and compact it to its live block ids, in
  // column order; then each live entry's position into epos.  Returns the
  // number of live entries.
  __device__ int prologue(int b, int* cols, int* epos, int tid) const {
    for (int c = tid; c < M; c += kThreads)
      cols[c] = tbl[static_cast<long long>(b) * M + c];
    __syncthreads();
    __shared__ int n_live;
    if (tid < 32) {
      int n = 0;
      for (int c0 = 0; c0 < M; c0 += 32) {
        const int c = c0 + tid;
        const int blk = c < M ? cols[c] : -1;
        const unsigned live = __ballot_sync(kFull, blk >= 0);
        __syncwarp();                          // every read before a write
        if (blk >= 0) cols[n + __popc(live & ((1u << tid) - 1u))] = blk;
        n += __popc(live);
        __syncwarp();
      }
      if (tid == 0) n_live = n;
    }
    __syncthreads();
    const int L = n_live * bs;
    for (int e = tid; e < L; e += kThreads)
      epos[e] = ppos[entry(b, e, cols)];
    return L;
  }
  __device__ long long entry(int, int e, const int* cols) const {
    return static_cast<long long>(cols[e / bs]) * bs + e % bs;
  }
};

// Shared memory: fp32 q rows, the K and V tile, then ints: entry positions
// (max_entries), tile masks and the tile list (max_entries / 32 each), and
// the paged table row (M).
__host__ __device__ constexpr int float_words(int D) {
  return kMaxRows * D + kTileK * (D + 4) + kTileK * D;
}

// Start loading tile t's valid K/V rows into registers: thread tid holds
// the 4-element vectors tid, tid + kThreads, ... of the tile's kTileK rows.
template <typename T, int kD, typename Src, typename VT, int N>
__device__ __forceinline__ void load_tile(const Src& src, int b, int hk,
                                          int Hkv, int t,
                                          const unsigned* tmask,
                                          const int* cols, int tid,
                                          VT (&rk)[N], VT (&rv)[N]) {
  constexpr int kRowVecs = kD / 4;
  const unsigned m = tmask[t];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int vi = tid + i * kThreads;
    const int j = vi / kRowVecs, c = (vi % kRowVecs) * 4;
    if (vi < kTileK * kRowVecs && ((m >> j) & 1u)) {
      const long long off =
          (src.entry(b, t * kTileK + j, cols) * Hkv + hk) * kD + c;
      rk[i] = *reinterpret_cast<const VT*>(src.k + off);
      rv[i] = *reinterpret_cast<const VT*>(src.v + off);
    }
  }
}

template <typename T, typename Src, int kD>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const int* __restrict__ q_pos,
            T* __restrict__ out, Src src, int S, int Hq, int Hkv,
            int max_entries, int row_tiles, int causal, int window,
            float scale) {
  using V4 = Vec4<T>;
  using VT = typename V4::type;
  constexpr int kRowVecs = kD / 4;                   // float4 per row
  constexpr int kVecs = kTileK * kRowVecs;           // per tile
  constexpr int kVecsPerThread = (kVecs + kThreads - 1) / kThreads;
  constexpr int kEPL = kD >= 32 ? kD / 32 : 1;       // output dims per lane
  constexpr int kKStride = kD + 4;

  const int G = Hq / Hkv;
  const int rows_total = S * G;
  int bid = blockIdx.x;
  const int rt = bid % row_tiles;
  bid /= row_tiles;
  const int hk = bid % Hkv;
  const int b = bid / Hkv;
  const int r0 = rt * kMaxRows;
  const int nrows = min(kMaxRows, rows_total - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int max_tiles = (max_entries + kTileK - 1) / kTileK;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);       // kMaxRows x kD
  float* ks = qs + kMaxRows * kD;                    // kTileK x (kD + 4)
  float* vs = ks + kTileK * kKStride;                // kTileK x kD
  int* epos = reinterpret_cast<int*>(vs + kTileK * kD);
  unsigned* tmask = reinterpret_cast<unsigned*>(epos + max_entries);
  int* tlist = reinterpret_cast<int*>(tmask + max_tiles);
  int* cols = tlist + max_tiles;                     // paged only
  __shared__ int rpos[kMaxRows];
  __shared__ int kpos[kTileK];
  __shared__ int n_tiles;

  // query rows (fp32) and their positions
  for (int r = warp; r < nrows; r += kWarps) {
    const int row = r0 + r, s = row / G, g = row % G;
    const T* qr = q + ((static_cast<long long>(b) * S + s) * Hq + hk * G + g) * kD;
    for (int d = lane; d < kD; d += 32) qs[r * kD + d] = to_f(qr[d]);
  }
  if (tid < nrows)
    rpos[tid] = q_pos[static_cast<long long>(b) * S + (r0 + tid) / G];
  const int L = src.prologue(b, cols, epos, tid);
  __syncthreads();

  // per tile, the keys valid for at least one row of the block
  const int ntiles = (L + kTileK - 1) / kTileK;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int e = t * kTileK + lane;
    const int p = e < L ? epos[e] : -1;
    bool v = false;
    if (p >= 0)
      for (int r = 0; r < nrows; ++r) v |= key_valid(p, rpos[r], causal, window);
    const unsigned m = __ballot_sync(kFull, v);
    if (lane == 0) tmask[t] = m;
  }
  __syncthreads();
  if (warp == 0) {                             // ordered list of live tiles
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < ntiles && tmask[t] != 0u;
      const unsigned bal = __ballot_sync(kFull, live);
      if (live) tlist[n + __popc(bal & ((1u << lane) - 1u))] = t;
      n += __popc(bal);
    }
    if (lane == 0) n_tiles = n;
  }
  __syncthreads();
  const int nt = n_tiles;

  VT rk[kVecsPerThread], rv[kVecsPerThread];

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kEPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kEPL; ++c) acc[i][c] = 0.f;
  }

  if (nt > 0) load_tile<T, kD>(src, b, hk, Hkv, tlist[0], tmask, cols, tid, rk, rv);
  for (int it = 0; it < nt; ++it) {
    const int t = tlist[it];
    const unsigned mask = tmask[t];
    // stage this tile (fp32) in shared memory
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int vi = tid + i * kThreads;
      const int j = vi / kRowVecs, c = (vi % kRowVecs) * 4;
      if (vi < kVecs) {                        // masked keys: zeros
        const bool live = (mask >> j) & 1u;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(ks + j * kKStride + c) =
            live ? V4::to_f(rk[i]) : z;
        *reinterpret_cast<float4*>(vs + j * kD + c) = live ? V4::to_f(rv[i]) : z;
      }
    }
    if (tid < kTileK)
      kpos[tid] = ((mask >> tid) & 1u) ? epos[t * kTileK + tid] : -1;
    __syncthreads();
    if (it + 1 < nt)                           // overlaps the math below
      load_tile<T, kD>(src, b, hk, Hkv, tlist[it + 1], tmask, cols, tid, rk,
                       rv);

    // Warp w owns rows w and w + kWarps: with few blocks in flight, many
    // warps per block hide each other's latency; 8 warps of two rows ran
    // faster on the token path's shapes than 4 of four or 16 of one.  A
    // warp whose rows are all past nrows only helps stage (warp-uniform
    // skip).
    if (warp < nrows) {
      const int p = kpos[lane];
      bool valid[kRowsPerWarp];
      float s[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        valid[i] = r < nrows && key_valid(p, rpos[r], causal, window);
      }
      {
        const float4* kr = reinterpret_cast<const float4*>(ks + lane * kKStride);
        float d[kRowsPerWarp][4];             // four independent chains
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
#pragma unroll
        for (int c = 0; c < kRowVecs; ++c) {
          const float4 k4 = kr[c];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            const float4 a =
                reinterpret_cast<const float4*>(qs + (warp + i * kWarps) * kD)[c];
            d[i][0] = fmaf(a.x, k4.x, d[i][0]);
            d[i][1] = fmaf(a.y, k4.y, d[i][1]);
            d[i][2] = fmaf(a.z, k4.z, d[i][2]);
            d[i][3] = fmaf(a.w, k4.w, d[i][3]);
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          s[i] = valid[i] ? ((d[i][0] + d[i][1]) + (d[i][2] + d[i][3])) * scale
                          : kNegInf;
      }
      float mx[kRowsPerWarp], pr[kRowsPerWarp], sum[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) mx[i] = s[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], o));
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float m_new = fmaxf(m[i], mx[i]);
        const float alpha = expf(m[i] - m_new);
        pr[i] = valid[i] ? expf(s[i] - m_new) : 0.f;
        sum[i] = pr[i];
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < kEPL; ++c) acc[i][c] *= alpha;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          sum[i] += __shfl_xor_sync(kFull, sum[i], o);
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) l[i] += sum[i];

      // P @ V, four keys at a time; a group of keys masked for every row
      // of the warp adds exactly 0 and is skipped (warp-uniform)
      const bool owns = lane * kEPL < kD;      // lanes past D own no dim
      for (int j0 = 0; j0 < kTileK; j0 += 4) {
        float pj[4][kRowsPerWarp];
        bool any = false;
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            pj[u][i] = __shfl_sync(kFull, pr[i], j0 + u);
            any |= pj[u][i] != 0.f;
          }
        if (!any || !owns) continue;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* vr = vs + (j0 + u) * kD + lane * kEPL;
          if constexpr (kEPL % 4 == 0) {
#pragma unroll
            for (int c = 0; c < kEPL; c += 4) {
              const float4 v4 = *reinterpret_cast<const float4*>(vr + c);
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i) {
                acc[i][c] = fmaf(pj[u][i], v4.x, acc[i][c]);
                acc[i][c + 1] = fmaf(pj[u][i], v4.y, acc[i][c + 1]);
                acc[i][c + 2] = fmaf(pj[u][i], v4.z, acc[i][c + 2]);
                acc[i][c + 3] = fmaf(pj[u][i], v4.w, acc[i][c + 3]);
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < kEPL; ++c) {
              const float v1 = vr[c];
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i)
                acc[i][c] = fmaf(pj[u][i], v1, acc[i][c]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (r < nrows && lane * kEPL < kD) {
      const int row = r0 + r, s = row / G, g = row % G;
      T* orow = out + ((static_cast<long long>(b) * S + s) * Hq + hk * G + g) * kD
                + lane * kEPL;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kEPL; ++c) orow[c] = from_f<T>(acc[i][c] / denom);
    }
  }
}

size_t smem_bytes(int D, int max_entries, int M) {
  const size_t tiles = (max_entries + kTileK - 1) / kTileK;
  return sizeof(float) * static_cast<size_t>(float_words(D)) +
         sizeof(int) * (static_cast<size_t>(max_entries) + 2 * tiles +
                        static_cast<size_t>(M));
}

template <typename T, typename Src, int kD>
int launch_d(const void* q, const int* q_pos, void* out, Src src, int B,
             int S, int Hq, int Hkv, int max_entries, int M, int causal,
             int window, float scale, void* stream) {
  const int row_tiles = (S * (Hq / Hkv) + kMaxRows - 1) / kMaxRows;
  const long long blocks = static_cast<long long>(B) * Hkv * row_tiles;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const size_t shmem = smem_bytes(kD, max_entries, M);
  auto kernel = attn_kernel<T, Src, kD>;
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, shmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), q_pos, static_cast<T*>(out), src, S, Hq, Hkv,
      max_entries, row_tiles, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Src>
int launch(const void* q, const int* q_pos, void* out, Src src, int B, int S,
           int Hq, int Hkv, int D, int max_entries, int M, int causal,
           int window, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_d<T, Src, 16>(q, q_pos, out, src, B, S, Hq, Hkv,
                                  max_entries, M, causal, window, scale,
                                  stream);
    case 64:
      return launch_d<T, Src, 64>(q, q_pos, out, src, B, S, Hq, Hkv,
                                  max_entries, M, causal, window, scale,
                                  stream);
    case 128:
      return launch_d<T, Src, 128>(q, q_pos, out, src, B, S, Hq, Hkv,
                                   max_entries, M, causal, window, scale,
                                   stream);
    case 256:
      return launch_d<T, Src, 256>(q, q_pos, out, src, B, S, Hq, Hkv,
                                   max_entries, M, causal, window, scale,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int contig(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, int B, int S, int Hq, int Hkv, int C,
           int D, int causal, int window, float scale, int is_bf16,
           void* stream) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    ContigSrc<T> src{static_cast<const T*>(k), static_cast<const T*>(v),
                     kv_pos, C};
    return launch<T, ContigSrc<T>>(q, q_pos, out, src, B, S, Hq, Hkv, D, C,
                                   0, causal, window, scale, stream);
  }
  ContigSrc<float> src{static_cast<const float*>(k),
                       static_cast<const float*>(v), kv_pos, C};
  return launch<float, ContigSrc<float>>(q, q_pos, out, src, B, S, Hq, Hkv,
                                         D, C, 0, causal, window, scale,
                                         stream);
}

int paged(const void* q, const void* kp, const void* vp, const int* ppos,
          const int* tbl, const int* q_pos, void* out, int B, int S, int Hq,
          int Hkv, int bs, int M, int D, int causal, int window, float scale,
          int is_bf16, void* stream) {
  if (bs < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    using T = __nv_bfloat16;
    PagedSrc<T> src{static_cast<const T*>(kp), static_cast<const T*>(vp),
                    ppos, tbl, M, bs};
    return launch<T, PagedSrc<T>>(q, q_pos, out, src, B, S, Hq, Hkv, D,
                                  M * bs, M, causal, window, scale, stream);
  }
  PagedSrc<float> src{static_cast<const float*>(kp),
                      static_cast<const float*>(vp), ppos, tbl, M, bs};
  return launch<float, PagedSrc<float>>(q, q_pos, out, src, B, S, Hq, Hkv,
                                        D, M * bs, M, causal, window, scale,
                                        stream);
}

}  // namespace

extern "C" {

// q (B,S,Hq,D), k/v (B,C,Hkv,D), q_pos (B,S), kv_pos (B,C) -> out (B,S,Hq,D)
int attn_flash(const void* q, const void* k, const void* v, const int* q_pos,
               const int* kv_pos, void* out, int B, int S, int Hq, int Hkv,
               int C, int D, int causal, int window, float scale, int is_bf16,
               void* stream) {
  return contig(q, k, v, q_pos, kv_pos, out, B, S, Hq, Hkv, C, D, causal,
                window, scale, is_bf16, stream);
}

// q (B,S,Hq,D), kp/vp (nb,bs,Hkv,D), ppos (nb,bs), tbl (B,M), q_pos (B,S)
int attn_paged_flash(const void* q, const void* kp, const void* vp,
                     const int* ppos, const int* tbl, const int* q_pos,
                     void* out, int B, int S, int Hq, int Hkv, int bs, int M,
                     int D, int causal, int window, float scale, int is_bf16,
                     void* stream) {
  return paged(q, kp, vp, ppos, tbl, q_pos, out, B, S, Hq, Hkv, bs, M, D,
               causal, window, scale, is_bf16, stream);
}

}  // extern "C"
