// Frame-ingest kernels for Hopper (sm_90a): resample, gate score, scatter.
//
// Hand-written counterparts of the four Pallas kernels in the reference's
// kernels/vision_ops.py.  The TPU kernels hold one whole stream in VMEM and
// resample with one-hot / box-weight matmuls on the MXU.  One 256x256x3 fp32
// frame is 786 KB, more than the 227 KB of shared memory a Hopper block can
// have, so these kernels do not copy that layout.  Two pieces of device
// code carry all the resampling and all the scoring:
//
//   * model_rows  — a block of model rows, one thread per 16 bytes of
//                   output: it gathers its four source elements through a
//                   column map the wrapper tabulates once (no index
//                   division per element; all index arithmetic 32-bit) for
//                   up to four rows, every load issued before the first
//                   store.  Rows that are not 16-byte multiples are written
//                   element by element.
//   * gate_score  — a block per stream: (a) build_map fills the channel-mean
//                   |pixel - ref| map in shared memory, kGateBatch pixels
//                   of both inputs in flight a thread, from one of two
//                   sources (resampled from the source frame through the
//                   gate's column table, or read from a frame already at
//                   gate size); (b) tile_max reduces the block x block
//                   tiles, a warp a tile in a fixed order, to the max of
//                   the tile means (partial edge tiles average their valid
//                   pixels only: pad-and-mask).  No atomics, so two calls
//                   give the same bits.
//
// The launches:
//
//   * ingest    — one launch, grid (S, 1 + m / rows, chunks): blockIdx.y 0
//                 is a stream's gate_score on the resampled source (it also
//                 writes the gate frame), every other block model_rows.  No
//                 thread of a model block waits on another, so the card
//                 keeps every row's loads in flight; the gate blocks come
//                 first in the grid and run beside them.  (A cluster of
//                 blocks a stream streaming source rows through a cp.async
//                 ring, its map gathered in rank 0's shared memory,
//                 measured slower: PERF.md.)
//   * downscale — the resample half alone: model_rows with no gate block,
//                 grid (S, res / rows, chunks).  It is the ingest's code, so
//                 its frames equal the ingest's bit for bit; normalization
//                 (x 1/255 for uint8) happens on load, before resampling.
//   * block_sad — the score half alone, on frames already at gate size:
//                 gate_score reading the frame directly, one block a
//                 stream.  On the ingest's own gate frame it gives the
//                 ingest's score bit for bit.
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

constexpr int kThreads = 256;     // a scatter block's threads
constexpr int kMaxC = 4;          // channels per pixel the kernels accept
constexpr int kNearest = 0;       // method codes (kernels/vision_ops.py)
constexpr int kModelVec = 1;      // flags (kernels/vision_ops.py ingest_plan)
constexpr int kMaxRows = 4;       // model rows a thread holds, at most
constexpr int kGateBatch = 4;     // gate pixels a thread loads at once
constexpr int kMaxBlock = 512;    // threads of an ingest, downscale or
                                  // block_sad block, at most

// What the wrapper's ingest_plan / downscale_plan chose, passed by value
// (downscale: m is its resolution; g and block are unused).
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

// ---------------------------------------------------------------------------
// gate_score: (a) the map, (b) the tile reduction
// ---------------------------------------------------------------------------

// Map source of the ingest: gate pixel p of the g x g gate frame, resampled
// from the stream's source frame through the gate's column table (gx[j]:
// pixel j's first source column, gx[j + 1] its box's end); kept as the
// gate frame.
template <typename T>
struct ResampledPixels {
  const T* frame;
  const int* gx;
  float* gate;
  int H, rowC, g, C;
  bool box;
  float scale;

  __device__ __forceinline__ void load(int p, float* v) const {
    const int i = p / g, j = p - i * g;
    const int y0 = i * H / g, y1 = box ? (i + 1) * H / g : y0 + 1;
    const int x0 = gx[j] * C, x1 = box ? gx[j + 1] * C : x0 + C;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      v[c] = box ? box_mean(frame, rowC, y0, y1, x0 + c, x1 + c, C, scale)
                 : norm32(frame + y0 * rowC, x0 + c, scale);
    }
  }
  __device__ __forceinline__ void keep(int p, const float* v) const {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      gate[p * C + c] = v[c];
    }
  }
};

// Map source of block_sad: pixel p of a frame already at gate size.
struct GatePixels {
  const float* frame;
  int C;

  __device__ __forceinline__ void load(int p, float* v) const {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      v[c] = __ldg(frame + p * C + c);
    }
  }
  __device__ __forceinline__ void keep(int, const float*) const {}
};

// (a) dmap[p] = the channel mean of |pixel - ref| over the n pixels: the
// channels added in order, then divided by C.  A thread loads kGateBatch
// pixels and their references before it uses any, so their loads are in
// flight together.
template <typename Src>
__device__ __forceinline__ void build_map(const Src& src,
                                          const float* __restrict__ ref,
                                          float* dmap, int n, int C, int tid,
                                          int nthreads) {
  for (int p0 = tid; p0 < n; p0 += kGateBatch * nthreads) {
    float v[kGateBatch][kMaxC], r[kGateBatch][kMaxC];
#pragma unroll
    for (int k = 0; k < kGateBatch; ++k) {
      const int p = p0 + k * nthreads;
      if (p >= n) break;
      src.load(p, v[k]);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= C) break;
        r[k][c] = __ldg(ref + p * C + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kGateBatch; ++k) {
      const int p = p0 + k * nthreads;
      if (p >= n) break;
      src.keep(p, v[k]);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c >= C) break;
        sum += fabsf(v[k][c] - r[k][c]);
      }
      dmap[p] = sum / static_cast<float>(C);
    }
  }
}

// (b) This warp's share of the max over the B x B tiles of the h x w map
// of the tile means (block_max_all takes the block's).  Tile t (row-major)
// goes to warp t % nwarps, which walks only its own tiles; lane l sums the
// tile's columns l, l + 32, ... top to bottom, a fixed tree of shuffles
// adds the lanes, the sum is divided by the tile's valid pixels.  Valid in
// lane 0.
__device__ __forceinline__ float tile_max(const float* dmap, int h, int w,
                                          int B, int tid, int nthreads) {
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int ntx = (w + B - 1) / B, nt = (h + B - 1) / B * ntx;
  float best = -INFINITY;
  for (int t = warp; t < nt; t += nwarps) {
    const int ty = t / ntx;
    const int y0 = ty * B, x0 = (t - ty * ntx) * B;
    const int hy = min(B, h - y0), hx = min(B, w - x0);
    float sum = 0.f;
    for (int xx = lane; xx < hx; xx += 32) {
      const float* col = dmap + y0 * w + x0 + xx;
#pragma unroll 8
      for (int yy = 0; yy < hy; ++yy) sum += col[yy * w];
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(kFull, sum, off);
    if (lane == 0) best = fmaxf(best, sum / static_cast<float>(hy * hx));
  }
  return best;
}

// One stream's score, by every thread of the block: the h x w map of src
// against ref (the stream's own rows), then its tiles; *score by thread 0.
template <typename Src>
__device__ __forceinline__ void gate_score(const Src& src,
                                           const float* __restrict__ ref,
                                           float* __restrict__ score,
                                           float* dmap, int h, int w, int C,
                                           int B) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  build_map(src, ref, dmap, h * w, C, tid, nthreads);
  __syncthreads();
  float best = tile_max(dmap, h, w, B, tid, nthreads);
  best = block_max_all(best, tid, nthreads);
  if (tid == 0) *score = best;
}

// ---------------------------------------------------------------------------
// model_rows: blocks of model rows, 16 bytes of up to four rows a thread
// ---------------------------------------------------------------------------

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

// Model-row block `group` of stream s (frame: its source frame): thread
// (x, y) holds one 16-byte unit (or one element) of G.rows consecutive
// rows of the m x m output, G.rows <= kMaxRows, and loads all of them
// before it stores any.  tab holds the column map: for model element e its
// first source element (and, for box, at tab[m * C + e], its bucket's
// end).
template <typename T>
__device__ __forceinline__ void model_rows(const T* __restrict__ frame,
                                           const int* __restrict__ tab,
                                           float* __restrict__ model,
                                           const IngestGeo& G, int s,
                                           int group) {
  const int C = G.C, m = G.m, rowC = G.W * C, mC = m * C;
  const bool box = G.method != kNearest;
  const int* me0 = tab;
  const int* me1 = tab + mC;                        // box only
  const int i0 = (group * blockDim.y + threadIdx.y) * G.rows;
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

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// ingest: grid (S, 1 + ceil(m / (blockDim.y * rows)), chunks), block
// (tx, ty).  blockIdx.y 0 is stream blockIdx.x's gate block (chunk 0
// only): gate_score on the resampled source, the gate's column table after
// the model's in tab.  Every other block is model_rows.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
ingest_kernel(const T* __restrict__ frames, const float* __restrict__ refs,
              const int* __restrict__ tab, float* __restrict__ model,
              float* __restrict__ gate, float* __restrict__ score,
              IngestGeo G) {
  extern __shared__ float dmap[];                   // g * g, gate blocks
  const int s = blockIdx.x;
  const int C = G.C, rowC = G.W * C;
  const T* frame = frames + static_cast<long long>(s) * G.H * rowC;
  if (blockIdx.y != 0) {
    model_rows(frame, tab, model, G, s, blockIdx.y - 1);
    return;
  }
  if (blockIdx.z != 0) return;
  const bool box = G.method != kNearest;
  const long long base = static_cast<long long>(s) * G.g * G.g * C;
  const ResampledPixels<T> src{frame, tab + (box ? 2 : 1) * G.m * C,
                               gate + base, G.H, rowC, G.g, C, box,
                               G.scale};
  gate_score(src, refs + base, score + s, dmap, G.g, G.g, C, G.block);
}

// downscale: grid (S, ceil(m / (blockDim.y * rows)), chunks), block
// (tx, ty): the ingest's model-row blocks alone.
template <typename T>
__global__ void __launch_bounds__(kMaxBlock)
downscale_kernel(const T* __restrict__ frames, const int* __restrict__ tab,
                 float* __restrict__ out, IngestGeo G) {
  const int s = blockIdx.x;
  model_rows(frames + static_cast<long long>(s) * G.H * G.W * G.C, tab,
             out, G, s, blockIdx.y);
}

// block_sad: grid (S,), one block a stream; the h x w map in dynamic
// shared memory.  frames and refs are (S, h, w, C) fp32.
__global__ void __launch_bounds__(kMaxBlock)
score_kernel(const float* __restrict__ refs, const float* __restrict__ frames,
             float* __restrict__ score, int h, int w, int C, int block) {
  extern __shared__ float dmap[];                   // h * w, one stream
  const long long base = static_cast<long long>(blockIdx.x) * h * w * C;
  gate_score(GatePixels{frames + base, C}, refs + base, score + blockIdx.x,
             dmap, h, w, C, block);
}

// Allow `smem` bytes of dynamic shared memory where it is over the 48 KB a
// launch gets without asking.
template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T>
int launch_ingest(const void* frames, const void* refs, const int* tab,
                  void* model, void* gate, void* score, int S, int tx,
                  int ty, int chunks, const IngestGeo& G, cudaStream_t st) {
  auto kernel = ingest_kernel<T>;
  const int smem = G.g * G.g * static_cast<int>(sizeof(float));
  if (const int e = allow_smem(kernel, smem)) return e;
  const int group = ty * G.rows;                  // model rows a block
  const dim3 grid(S, 1 + (G.m + group - 1) / group, chunks);
  kernel<<<grid, dim3(tx, ty), static_cast<size_t>(smem), st>>>(
      static_cast<const T*>(frames), static_cast<const float*>(refs), tab,
      static_cast<float*>(model), static_cast<float*>(gate),
      static_cast<float*>(score), G);
  return static_cast<int>(cudaGetLastError());
}

// True where a (tx, ty) block of `rows` model rows a thread, `chunks`
// blocks a row and `groups` row groups a stream is a launch the kernels
// take.
bool model_geometry_ok(int C, int rows, int tx, int ty, int chunks,
                       int groups) {
  return C >= 1 && C <= kMaxC && rows >= 1 && rows <= kMaxRows && tx >= 32 &&
         tx % 32 == 0 && ty >= 1 && tx * ty <= kMaxBlock && chunks >= 1 &&
         chunks <= 65535 && groups <= 65535;
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

}  // namespace


extern "C" {

int vo_downscale(const void* frames, const void* tab, void* out, int S,
                 int H, int W, int C, int res, int is_u8, int method,
                 float scale, int rows, int tx, int ty, int chunks,
                 int flags, void* stream) {
  const IngestGeo G{H, W, C, res, 0, 0, rows, flags, method, scale};
  const int groups = rows > 0 && ty > 0 ? (res + ty * rows - 1) / (ty * rows)
                                        : 0;
  if (S < 1 || res < 1 ||
      !model_geometry_ok(C, rows, tx, ty, chunks, groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, groups, chunks), blk(tx, ty);
  const int* t = static_cast<const int*>(tab);
  if (is_u8)
    downscale_kernel<uint8_t><<<grid, blk, 0, st>>>(
        static_cast<const uint8_t*>(frames), t, static_cast<float*>(out), G);
  else
    downscale_kernel<float><<<grid, blk, 0, st>>>(
        static_cast<const float*>(frames), t, static_cast<float*>(out), G);
  return static_cast<int>(cudaGetLastError());
}

int vo_ingest(const void* frames, const void* refs, const void* tab,
              void* model, void* gate, void* score, int S, int H, int W,
              int C, int m, int g, int block, int is_u8, int method,
              float scale, int rows, int tx, int ty, int chunks, int flags,
              void* stream) {
  const IngestGeo G{H, W, C, m, g, block, rows, flags, method, scale};
  const int groups = rows > 0 && ty > 0 ? 1 + (m + ty * rows - 1) / (ty * rows)
                                        : 0;
  if (S < 1 || block < 1 ||
      !model_geometry_ok(C, rows, tx, ty, chunks, groups))
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
                 int H, int W, int C, int block, int threads, void* stream) {
  if (S < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC || block < 1 ||
      threads < 32 || threads % 32 != 0 || threads > kMaxBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = H * W * static_cast<int>(sizeof(float));
  if (const int e = allow_smem(score_kernel, smem)) return e;
  score_kernel<<<S, threads, static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(
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
