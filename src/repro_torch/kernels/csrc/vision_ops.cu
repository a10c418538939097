// Frame-ingest kernels for Hopper (sm_90a): resample, gate score, scatter.
//
// Hand-written counterparts of the four Pallas kernels in the reference's
// kernels/vision_ops.py.  The TPU kernels hold one whole stream in VMEM and
// resample with one-hot / box-weight matmuls on the MXU.  One 256x256x3 fp32
// frame is 786 KB, more than the 227 KB of shared memory a Hopper block can
// have, so these kernels do not copy that layout:
//
//   * resample  — a direct gather, one thread per output pixel and many
//                 blocks per stream: nearest loads one source pixel, box
//                 averages its bucket.  Normalization (x 1/255 for uint8)
//                 happens on load, before resampling.  Nearest in fp32 is a
//                 pure copy, so it is bit-identical to the plain gather.
//   * gate      — one block per stream: resample to the (small) gate
//                 resolution, write the gate frame, keep the channel-mean
//                 |gate - ref| in shared memory, then the max over blocks of
//                 the block mean (partial edge blocks average their valid
//                 pixels only: pad-and-mask).
//   * sad       — the score half alone, on frames already at gate size.
//   * scatter   — a masked row select into NEW output tensors (copy
//                 semantics, like the reference), casting the model frame
//                 to the pool dtype (round-to-nearest-even for bf16).
//
// All four are bound by device-memory bytes, not arithmetic: each output
// element costs a handful of flops.  Plain C entry points, loaded with
// ctypes; each returns cudaGetLastError() so the wrapper can raise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

// grid = (S,): stream s resamples to g x g, writes the gate frame and its
// score against refs[s].
template <typename T>
__global__ void gate_kernel(const T* __restrict__ frames,
                            const float* __restrict__ refs,
                            float* __restrict__ gate,
                            float* __restrict__ score, int H, int W, int C,
                            int g, int block, int method, float scale) {
  extern __shared__ float d[];                       // g * g
  const int s = blockIdx.x;
  const T* frame = frames + static_cast<long long>(s) * H * W * C;
  const long long off = static_cast<long long>(s) * g * g * C;
  for (int p = threadIdx.x; p < g * g; p += blockDim.x) {
    float v[kMaxC];
    resample_px(frame, H, W, C, g, p / g, p % g, method, scale, v);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c >= C) break;
      gate[off + p * C + c] = v[c];
      sum += fabsf(v[c] - refs[off + p * C + c]);
    }
    d[p] = sum / static_cast<float>(C);
  }
  __syncthreads();
  max_block_mean(d, g, g, block, score + s);
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

// batch_out = admit ? cast(model) : batch; refs_out = admit ? gate : refs.
// Rows are flattened: nb / nr elements per stream row.
template <typename TB>
__global__ void scatter_kernel(const uint8_t* __restrict__ admit,
                               const TB* __restrict__ batch,
                               const float* __restrict__ model,
                               const float* __restrict__ refs,
                               const float* __restrict__ gate,
                               TB* __restrict__ batch_out,
                               float* __restrict__ refs_out, long long nb,
                               long long nr, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  for (long long i = start; i < S * nb; i += stride)
    batch_out[i] = admit[i / nb] ? to_pool<TB>(model[i]) : batch[i];
  for (long long i = start; i < S * nr; i += stride)
    refs_out[i] = admit[i / nr] ? gate[i] : refs[i];
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

int vo_ingest(const void* frames, const void* refs, void* model, void* gate,
              void* score, int S, int H, int W, int C, int m, int g,
              int block, int is_u8, int method, float scale, void* stream) {
  const int err = vo_downscale(frames, model, S, H, W, C, m, is_u8, method,
                               scale, stream);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shmem = sizeof(float) * g * g;
  if (is_u8)
    gate_kernel<uint8_t><<<S, kThreads, shmem, st>>>(
        static_cast<const uint8_t*>(frames), static_cast<const float*>(refs),
        static_cast<float*>(gate), static_cast<float*>(score), H, W, C, g,
        block, method, scale);
  else
    gate_kernel<float><<<S, kThreads, shmem, st>>>(
        static_cast<const float*>(frames), static_cast<const float*>(refs),
        static_cast<float*>(gate), static_cast<float*>(score), H, W, C, g,
        block, method, scale);
  return static_cast<int>(cudaGetLastError());
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
                     void* refs_out, long long nb, long long nr, int S,
                     int batch_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(S * (nb > nr ? nb : nr));
  const uint8_t* a = static_cast<const uint8_t*>(admit);
  if (batch_bf16)
    scatter_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        a, static_cast<const __nv_bfloat16*>(batch),
        static_cast<const float*>(model), static_cast<const float*>(refs),
        static_cast<const float*>(gate),
        static_cast<__nv_bfloat16*>(batch_out), static_cast<float*>(refs_out),
        nb, nr, S);
  else
    scatter_kernel<float><<<grid, kThreads, 0, st>>>(
        a, static_cast<const float*>(batch), static_cast<const float*>(model),
        static_cast<const float*>(refs), static_cast<const float*>(gate),
        static_cast<float*>(batch_out), static_cast<float*>(refs_out), nb, nr,
        S);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
