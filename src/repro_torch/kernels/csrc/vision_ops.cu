// Frame-ingest kernels for Hopper (sm_90a): resample, gate score, scatter.
//
// Hand-written counterparts of the four Pallas kernels in the reference's
// kernels/vision_ops.py.  The TPU kernels hold one whole stream in VMEM and
// resample with one-hot / box-weight matmuls on the MXU.  One 256x256x3 fp32
// frame is 786 KB, more than the 227 KB of shared memory a Hopper block can
// have, so these kernels do not copy that layout:
//
//   * ingest    — one launch, grid (S, 1 + m / rows, chunks).  A block
//                 per stream computes the small gate frame, keeps the
//                 channel-mean |gate - ref| in shared memory and reduces
//                 the block x block tiles, a warp a tile in a fixed order,
//                 to the max of the tile means (partial edge tiles average
//                 their valid pixels only: pad-and-mask); no atomics, so
//                 two calls give the same bits.  Every other block holds a
//                 few model rows, one thread per 16 bytes of output: it
//                 gathers its four source elements through a column map
//                 the wrapper tabulates once (no index division per
//                 element; all index arithmetic 32-bit) and writes one
//                 float4.  No thread of a model block waits on another, so
//                 the card keeps every row's loads in flight; the gate
//                 blocks come first in the grid and run beside them.  Model
//                 rows that are not 16-byte multiples are written element
//                 by element.  (A cluster of blocks a stream streaming
//                 source rows through a cp.async ring, its map gathered in
//                 rank 0's shared memory, measured slower: PERF.md.)
//   * resample  — a direct gather, one thread per output pixel and many
//                 blocks per stream: nearest loads one source pixel, box
//                 averages its bucket.  Normalization (x 1/255 for uint8)
//                 happens on load, before resampling.  Nearest in fp32 is a
//                 pure copy, so it is bit-identical to the plain gather.
//   * sad       — the score half alone, on frames already at gate size.
//   * scatter   — a masked row select into NEW output tensors (copy
//                 semantics, like the reference), casting the model frame
//                 to the pool dtype (round-to-nearest-even for bf16).
//                 Grid (X, S): the block reads admit[s] once and copies
//                 its share of the row from one source, 16 bytes a thread
//                 (fp32: a float4; bf16: eight values from two float4 of
//                 the model, or eight of the kept row), four copies in
//                 flight a thread, 32-bit offsets within the row.  Rows
//                 that are not 16-byte multiples (the gateless path's
//                 1x1x3 null references) are copied element by element.
//
// All four are bound by device-memory bytes, not arithmetic: each output
// element costs a handful of flops.  Plain C entry points, loaded with
// ctypes; each returns cudaGetLastError() so the wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;          // channels per pixel the kernels accept
constexpr int kNearest = 0;       // method codes (kernels/vision_ops.py)

template <typename T>
__device__ __forceinline__ float load_norm(const T* p, long long i,
                                           float scale);

template <>
__device__ __forceinline__ float load_norm<float>(const float* p, long long i,
                                                  float scale) {
  return p[i] * scale;
}

template <>
__device__ __forceinline__ float load_norm<uint8_t>(const uint8_t* p,
                                                    long long i, float scale) {
  return static_cast<float>(p[i]) * scale;
}

// One output pixel (i, j) of an (H, W, C) frame resampled to res x res.
// Nearest takes source row i*H/res; box averages [i*H/res, (i+1)*H/res).
template <typename T>
__device__ __forceinline__ void resample_px(const T* frame, int H, int W,
                                            int C, int res, int i, int j,
                                            int method, float scale,
                                            float* out) {
  const int y0 = static_cast<int>(static_cast<long long>(i) * H / res);
  const int x0 = static_cast<int>(static_cast<long long>(j) * W / res);
  if (method == kNearest) {
    const long long base = (static_cast<long long>(y0) * W + x0) * C;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) out[c] = load_norm(frame, base + c, scale);
    return;
  }
  const int y1 = static_cast<int>(static_cast<long long>(i + 1) * H / res);
  const int x1 = static_cast<int>(static_cast<long long>(j + 1) * W / res);
  float acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};     // register-resident
  for (int y = y0; y < y1; ++y) {
    const long long row = static_cast<long long>(y) * W;
    for (int x = x0; x < x1; ++x) {
      const long long base = (row + x) * C;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc[c] += load_norm(frame, base + c, scale);
    }
  }
  const float cnt = static_cast<float>((y1 - y0) * (x1 - x0));
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) out[c] = acc[c] / cnt;
}

// Block-wide max of per-thread values; the result is valid in thread 0.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_max[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Max over block x block tiles of the tile mean of d (H x W, in shared
// memory).  Edge tiles average their valid pixels only.  All threads of the
// block call it; thread 0 writes *score.
__device__ __forceinline__ void max_block_mean(const float* d, int H, int W,
                                               int block, float* score) {
  const int nbh = (H + block - 1) / block, nbw = (W + block - 1) / block;
  float best = -INFINITY;
  for (int b = threadIdx.x; b < nbh * nbw; b += blockDim.x) {
    const int y0 = (b / nbw) * block, x0 = (b % nbw) * block;
    const int y1 = min(y0 + block, H), x1 = min(x0 + block, W);
    float sum = 0.f;
    for (int y = y0; y < y1; ++y)
      for (int x = x0; x < x1; ++x) sum += d[y * W + x];
    best = fmaxf(best, sum / static_cast<float>((y1 - y0) * (x1 - x0)));
  }
  best = block_max(best);
  if (threadIdx.x == 0) *score = best;
}

template <typename T>
__global__ void resample_kernel(const T* __restrict__ frames,
                                float* __restrict__ out, int S, int H, int W,
                                int C, int res, int method, float scale) {
  const long long n = static_cast<long long>(S) * res * res;
  const long long frame_elems = static_cast<long long>(H) * W * C;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < n; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(p / (res * res));
    const int q = static_cast<int>(p % (res * res));
    float v[kMaxC];
    resample_px(frames + s * frame_elems, H, W, C, res, q / res, q % res,
                method, scale, v);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) out[p * C + c] = v[c];
  }
}

// ---------------------------------------------------------------------------
// ingest: one launch; blocks of model rows, and a block a stream's gate
// ---------------------------------------------------------------------------

constexpr int kModelVec = 1;      // flags (kernels/vision_ops.py ingest_plan)
constexpr int kMaxRows = 4;       // model rows a thread holds, at most
constexpr int kGateBatch = 4;     // gate pixels a thread loads at once

// What the wrapper's ingest_plan chose, passed by value.
struct IngestGeo {
  int H, W, C, m, g, block, rows, flags, method;
  float scale;
};

// One normalized source element, read through the read-only cache.
// __fmul_rn is never contracted into a following add, so a box sum rounds
// as the plain model's mul-then-add.
__device__ __forceinline__ float norm32(const float* p, int o, float) {
  return __ldg(p + o);
}
__device__ __forceinline__ float norm32(const uint8_t* p, int o,
                                        float scale) {
  return __fmul_rn(static_cast<float>(__ldg(p + o)), scale);
}

// Box mean of one output element: source rows [y0, y1) x the elements o0,
// o0 + C, ... < o1 of each, added row by row, left to right.
template <typename T>
__device__ __forceinline__ float box_mean(const T* frame, int rowC, int y0,
                                          int y1, int o0, int o1, int C,
                                          float scale) {
  float a = 0.f;
  int n = 0;
  for (int y = y0; y < y1; ++y) {
    const T* row = frame + y * rowC;
    n = 0;
    for (int o = o0; o < o1; o += C, ++n) a += norm32(row, o, scale);
  }
  return a / static_cast<float>((y1 - y0) * n);
}

// Max over every thread of a (blockDim.x, blockDim.y) block; valid in
// thread 0.
__device__ __forceinline__ float block_max_all(float v, int tid,
                                               int nthreads) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(kFull, v, off));
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (nthreads >> 5) ? warp_max[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(kFull, v, off));
  }
  return v;
}

// Stream s's gate block: the g x g gate frame, the channel-mean
// |gate - ref| in shared memory, then a warp a block x block tile (lane l
// sums the tile's columns l, l + 32, ... top to bottom, a fixed tree of
// shuffles adds the lanes) and the max of the tile means.  A thread loads
// kGateBatch pixels and their references before it uses any, so their
// loads are in flight together.
template <typename T>
__device__ void gate_block(const T* __restrict__ frame,
                           const float* __restrict__ refs,
                           const int* __restrict__ gx,
                           float* __restrict__ gate, float* __restrict__ score,
                           float* dmap, const IngestGeo& G, int s) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int H = G.H, C = G.C, g = G.g, rowC = G.W * C;
  const bool box = G.method != kNearest;
  const long long base = static_cast<long long>(s) * g * g * C;
  for (int p0 = tid; p0 < g * g; p0 += kGateBatch * nthreads) {
    float v[kGateBatch][kMaxC], r[kGateBatch][kMaxC];
#pragma unroll
    for (int k = 0; k < kGateBatch; ++k) {
      const int p = p0 + k * nthreads;
      if (p >= g * g) break;
      const int i = p / g, j = p - i * g;
      const int y0 = i * H / g, y1 = box ? (i + 1) * H / g : y0 + 1;
      const int x0 = gx[j] * C, x1 = box ? gx[j + 1] * C : x0 + C;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= C) break;
        v[k][c] = box ? box_mean(frame, rowC, y0, y1, x0 + c, x1 + c, C,
                                 G.scale)
                      : norm32(frame + y0 * rowC, x0 + c, G.scale);
        r[k][c] = __ldg(refs + base + p * C + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kGateBatch; ++k) {
      const int p = p0 + k * nthreads;
      if (p >= g * g) break;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= C) break;
        gate[base + p * C + c] = v[k][c];
        sum += fabsf(v[k][c] - r[k][c]);
      }
      dmap[p] = sum / static_cast<float>(C);
    }
  }
  __syncthreads();
  const int B = G.block, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  float best = -INFINITY;
  int owner = 0;
  for (int y0 = 0; y0 < g; y0 += B) {
    const int hy = min(B, g - y0);
    for (int x0 = 0; x0 < g; x0 += B) {
      const bool mine = owner == warp;
      owner = owner + 1 == nwarps ? 0 : owner + 1;
      if (!mine) continue;
      const int hx = min(B, g - x0);
      float sum = 0.f;
      for (int xx = lane; xx < hx; xx += 32) {
        const float* col = dmap + y0 * g + x0 + xx;
#pragma unroll 8
        for (int yy = 0; yy < hy; ++yy) sum += col[yy * g];
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(kFull, sum, off);
      if (lane == 0) best = fmaxf(best, sum / static_cast<float>(hy * hx));
    }
  }
  best = block_max_all(best, tid, nthreads);
  if (tid == 0) score[s] = best;
}

// One model element (nearest: the source element; box: its bucket's mean)
// of output row i.
template <typename T>
__device__ __forceinline__ float model_elem(const T* frame, int rowC, int i,
                                            int o0, int o1,
                                            const IngestGeo& G, bool box) {
  const int y0 = i * G.H / G.m;
  if (!box) return norm32(frame + y0 * rowC, o0, G.scale);
  return box_mean(frame, rowC, y0, (i + 1) * G.H / G.m, o0, o1, G.C,
                  G.scale);
}

// grid (S, 1 + ceil(m / (blockDim.y * rows)), chunks), block (tx, ty).
// blockIdx.y 0 is stream blockIdx.x's gate block (chunk 0 only); in the
// others thread (x, y) holds one 16-byte unit (or one element) of `rows`
// consecutive model rows, G.rows <= kMaxRows: it loads all of them before
// it stores any.  tab holds the column maps: for model element e its first
// source element (and, for box, its bucket's end), then the gate's source
// column of each gate pixel (and one past).  No thread waits on another
// outside the gate blocks, and the gate blocks, first in the grid, run
// beside the model rows.
template <typename T>
__global__ void __launch_bounds__(512)
ingest_kernel(const T* __restrict__ frames, const float* __restrict__ refs,
              const int* __restrict__ tab, float* __restrict__ model,
              float* __restrict__ gate, float* __restrict__ score,
              IngestGeo G) {
  extern __shared__ float dmap[];                   // g * g, gate blocks
  const int s = blockIdx.x;
  const int C = G.C, m = G.m, rowC = G.W * C, mC = m * C;
  const bool box = G.method != kNearest;
  const T* frame = frames + static_cast<long long>(s) * G.H * rowC;
  const int* me0 = tab;
  const int* me1 = tab + mC;                        // box only
  if (blockIdx.y == 0) {
    if (blockIdx.z == 0)
      gate_block(frame, refs, tab + (box ? 2 : 1) * mC, gate, score, dmap,
                 G, s);
    return;
  }
  const int i0 = ((blockIdx.y - 1) * blockDim.y + threadIdx.y) * G.rows;
  const int u = blockIdx.z * blockDim.x + threadIdx.x;
  float* out = model + (static_cast<long long>(s) * m + i0) * mC;
  if (!(G.flags & kModelVec)) {
    if (u >= mC) return;
    const int o0 = __ldg(me0 + u), o1 = box ? __ldg(me1 + u) : 0;
    float v[kMaxRows];
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k)
      if (k < G.rows && i0 + k < m)
        v[k] = model_elem(frame, rowC, i0 + k, o0, o1, G, box);
#pragma unroll
    for (int k = 0; k < kMaxRows; ++k)
      if (k < G.rows && i0 + k < m) out[k * mC + u] = v[k];
    return;
  }
  const int e = u * 4;
  if (e >= mC) return;
  const int4 o = __ldg(reinterpret_cast<const int4*>(me0 + e));
  const int4 p = box ? __ldg(reinterpret_cast<const int4*>(me1 + e)) : o;
  float4 v[kMaxRows];
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    if (k >= G.rows || i0 + k >= m) break;
    v[k] = make_float4(model_elem(frame, rowC, i0 + k, o.x, p.x, G, box),
                       model_elem(frame, rowC, i0 + k, o.y, p.y, G, box),
                       model_elem(frame, rowC, i0 + k, o.z, p.z, G, box),
                       model_elem(frame, rowC, i0 + k, o.w, p.w, G, box));
  }
#pragma unroll
  for (int k = 0; k < kMaxRows; ++k) {
    if (k >= G.rows || i0 + k >= m) break;
    *reinterpret_cast<float4*>(out + k * mC + e) = v[k];
  }
}

template <typename T>
int launch_ingest(const void* frames, const void* refs, const int* tab,
                  void* model, void* gate, void* score, int S, int tx,
                  int ty, int chunks, const IngestGeo& G, cudaStream_t st) {
  auto kernel = ingest_kernel<T>;
  const int smem = G.g * G.g * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int group = ty * G.rows;                  // model rows a block
  const dim3 grid(S, 1 + (G.m + group - 1) / group, chunks);
  kernel<<<grid, dim3(tx, ty), static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(frames), static_cast<const float*>(refs), tab,
      static_cast<float*>(model), static_cast<float*>(gate),
      static_cast<float*>(score), G);
  return static_cast<int>(cudaGetLastError());
}

// grid = (S,): score of frames[s] against refs[s], both (H, W, C) fp32.
__global__ void sad_kernel(const float* __restrict__ refs,
                           const float* __restrict__ frames,
                           float* __restrict__ score, int H, int W, int C,
                           int block) {
  extern __shared__ float d[];                       // H * W
  const long long off = static_cast<long long>(blockIdx.x) * H * W * C;
  for (int p = threadIdx.x; p < H * W; p += blockDim.x) {
    float sum = 0.f;
    for (int c = 0; c < C; ++c)
      sum += fabsf(frames[off + p * C + c] - refs[off + p * C + c]);
    d[p] = sum / static_cast<float>(C);
  }
  __syncthreads();
  max_block_mean(d, H, W, block, score + blockIdx.x);
}

template <typename TB>
__device__ __forceinline__ TB to_pool(float x);

template <>
__device__ __forceinline__ float to_pool<float>(float x) { return x; }

template <>
__device__ __forceinline__ __nv_bfloat16 to_pool<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// scatter: grid (X, S), one source per block, 16 bytes a thread
// ---------------------------------------------------------------------------

constexpr int kBatchRowVec = 1;  // flags (vision_ops.py scatter_plan)
constexpr int kRefsRowVec = 2;
constexpr int kUnroll = 4;        // 16-byte copies in flight a thread

// 16 bytes of the pool type from the fp32 model row: unit u of 4 (fp32)
// or 8 (bf16, two float4 rounded to nearest even) elements
__device__ __forceinline__ uint4 adopt16(const float* src, int u, float*) {
  return reinterpret_cast<const uint4*>(src)[u];
}
__device__ __forceinline__ uint4 adopt16(const float* src, int u,
                                         __nv_bfloat16*) {
  const float4 a = reinterpret_cast<const float4*>(src)[2 * u];
  const float4 b = reinterpret_cast<const float4*>(src)[2 * u + 1];
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

// This block's share of one row of n elements: out = take ? cast(adopt) :
// keep.  The row is split into gridDim.x contiguous chunks of 16-byte
// units (of elements on the scalar path).
template <typename TB>
__device__ __forceinline__ void select_row(bool take, const TB* keep,
                                           const float* adopt, TB* out,
                                           int n, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(TB));
  const int units = vec ? n / kPer : n;
  const int chunk = (units + gridDim.x - 1) / gridDim.x;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, units);
  const int hi = min(lo + chunk, units);
  if (!vec) {
    for (int e = lo + threadIdx.x; e < hi; e += kThreads)
      out[e] = take ? to_pool<TB>(adopt[e]) : keep[e];
    return;
  }
  const uint4* kept = reinterpret_cast<const uint4*>(keep);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int u0 = lo + threadIdx.x; u0 < hi; u0 += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      if (u < hi) v[k] = take ? adopt16(adopt, u, out) : kept[u];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int u = u0 + k * kThreads;
      if (u < hi) dst[u] = v[k];
    }
  }
}

// batch_out = admit ? cast(model) : batch; refs_out = admit ? gate : refs.
// nb / nr elements per stream row.
template <typename TB>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const uint8_t* __restrict__ admit,
                    const TB* __restrict__ batch,
                    const float* __restrict__ model,
                    const float* __restrict__ refs,
                    const float* __restrict__ gate,
                    TB* __restrict__ batch_out, float* __restrict__ refs_out,
                    int nb, int nr, int flags) {
  __shared__ int take_s;
  const int s = blockIdx.y;
  if (threadIdx.x == 0) take_s = admit[s];
  __syncthreads();
  const bool take = take_s != 0;
  const long long ob = static_cast<long long>(s) * nb;
  const long long orr = static_cast<long long>(s) * nr;
  select_row<TB>(take, batch + ob, model + ob, batch_out + ob, nb,
                 flags & kBatchRowVec);
  select_row<float>(take, refs + orr, gate + orr, refs_out + orr, nr,
                    flags & kRefsRowVec);
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 64 ? (blocks > 0 ? blocks : 1)
                                            : 132 * 64);
}

}  // namespace


extern "C" {

int vo_downscale(const void* frames, void* out, int S, int H, int W, int C,
                 int res, int is_u8, int method, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(static_cast<long long>(S) * res * res);
  if (is_u8)
    resample_kernel<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(frames), static_cast<float*>(out), S, H,
        W, C, res, method, scale);
  else
    resample_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(frames), static_cast<float*>(out), S, H, W,
        C, res, method, scale);
  return static_cast<int>(cudaGetLastError());
}

int vo_ingest(const void* frames, const void* refs, const void* tab,
              void* model, void* gate, void* score, int S, int H, int W,
              int C, int m, int g, int block, int is_u8, int method,
              float scale, int rows, int tx, int ty, int chunks, int flags,
              void* stream) {
  const IngestGeo G{H, W, C, m, g, block, rows, flags, method, scale};
  if (S < 1 || C < 1 || C > kMaxC || block < 1 || rows < 1 ||
      rows > kMaxRows || tx < 32 || tx % 32 != 0 || ty < 1 ||
      tx * ty > 512 || chunks < 1 || chunks > 65535 ||
      1 + (m + ty * rows - 1) / (ty * rows) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tab);
  if (is_u8)
    return launch_ingest<uint8_t>(frames, refs, t, model, gate, score, S,
                                  tx, ty, chunks, G, st);
  return launch_ingest<float>(frames, refs, t, model, gate, score, S, tx,
                              ty, chunks, G, st);
}

int vo_block_sad(const void* refs, const void* frames, void* score, int S,
                 int H, int W, int C, int block, void* stream) {
  const size_t shmem = sizeof(float) * H * W;
  sad_kernel<<<S, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(refs), static_cast<const float*>(frames),
      static_cast<float*>(score), H, W, C, block);
  return static_cast<int>(cudaGetLastError());
}

int vo_scatter_admit(const void* admit, const void* batch, const void* model,
                     const void* refs, const void* gate, void* batch_out,
                     void* refs_out, int nb, int nr, int S, int batch_bf16,
                     int blocks_x, int flags, void* stream) {
  if (blocks_x < 1 || S < 1 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_x, S);
  const uint8_t* a = static_cast<const uint8_t*>(admit);
  if (batch_bf16)
    scatter_rows_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        a, static_cast<const __nv_bfloat16*>(batch),
        static_cast<const float*>(model), static_cast<const float*>(refs),
        static_cast<const float*>(gate),
        static_cast<__nv_bfloat16*>(batch_out), static_cast<float*>(refs_out),
        nb, nr, flags);
  else
    scatter_rows_kernel<float><<<grid, kThreads, 0, st>>>(
        a, static_cast<const float*>(batch), static_cast<const float*>(model),
        static_cast<const float*>(refs), static_cast<const float*>(gate),
        static_cast<float*>(batch_out), static_cast<float*>(refs_out), nb, nr,
        flags);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
