// Recurrent kernels for Hopper (sm_90a): the RG-LRU linear scan and the
// chunkwise stabilised mLSTM.
//
// Hand-written counterparts of two Pallas kernels of the reference:
//
//   rglru_scan       kernels/rglru.py  _rglru_kernel (rglru_scan_blocked)
//   mlstm_chunkwise  kernels/mlstm.py  _mlstm_kernel (mlstm_chunkwise_bhsd)
//
// Both compute what the TPU kernels compute; neither carries the TPU's
// blocking over.  Plain C entry points, loaded with ctypes; each returns
// cudaGetLastError() (or the launch's refusal) so the wrapper can raise.
//
// ---- RG-LRU: h_t = a_t * h_{t-1} + b_t, per channel -----------------------
//
// a, b, out (B, S, W) fp32; h0 (B, W) fp32 or null (zeros).  The Pallas
// kernel walks (bs, bw) VMEM blocks with the carry in scratch across the
// sequential time-block axis.  Here one thread owns one channel and walks
// all of time with the carry in a register; a block spans kScanThreads
// neighbouring channels, so every load and store of a time step is one
// coalesced row segment.  Grid (ceil(W / kScanThreads), B).  The loads of
// kScanUnroll steps all go out before their dependent chain runs.
//
// Bound: 12 bytes per element (a, b read, h written) plus h0, over
// 3.35 TB/s; 2 operations per element are nothing beside that.
//
// Rounding: h = __fadd_rn(__fmul_rn(a, h), b) rounds the product and the
// sum separately, as the plain version's two tensor operations do (nvcc
// would contract a*h+b into one FMA), and h0 enters as b_0 + a_0*h0, the
// reference's fold into step 0.  So the kernel is bit-exact against its
// plain version.
//
// ---- mLSTM: exact chunkwise form of the stabilised parallel mLSTM ---------
//
// q, k, v, out (B, S, H, Dh) bf16 or fp32, read and written in the model's
// layout (no transpose, no padding of Dh to 128 lanes); gates i, f (B, S, H)
// fp32 raw logits.  Per head the sequence is walked in chunks of kTc = 128
// rows, carrying the state (C: Dh x Dh, n: Dh, m: scalar) from chunk to
// chunk, exactly as the Pallas kernel does (NEG_INF = -1e30 finite;
// log-sigmoid forget gates with an inclusive cumsum bcum inside the chunk;
// m_t = max(m_intra, bcum + m_prev); denom = max(|sum scores + q.n * coeff|,
// exp(-m_t)); m_new = max(g + m_prev, max w_s); q scaled by 1/sqrt(Dh)).
//
// At xlstm-350m's Dh = 512, C is 512 x 512 fp32 = 1 MB: it cannot live in
// one block's shared memory (227 KB) as it lives in the TPU's VMEM.  So the
// value columns are split over blocks: grid (ceil(Dh / kBv), B * H), and a
// block owns C[:, 32 value columns] (64 KB at Dh 512) plus its own copy of
// n and m.  Each block recomputes the chunk's gated Tc x Tc panel, q.n and
// m itself (the redundancy is the price of keeping C on chip), streams Dk
// in tiles of 32 for q.k^T and q.C, and walks the chunks in order:
//
//   A  gates: bcum (warp scan), m_intra, m_t, coeff; the state-update
//      weights w_s, m_new, scale_old.
//   B  for each Dk tile: q (scaled) and k staged in shared memory; warp w
//      accumulates rows 16w..16w+15 of q.k^T against all 128 keys (lane
//      owns keys lane + 32j), q.C for its value column (lane) and q.n.
//   C  panel = (q.k^T) * exp(bcum_t - bcum_s + i_s - m_t) (s <= t), into
//      shared memory; row sums by warp shuffles; denominators.
//   D  out = (panel @ V + q.C * coeff) / denom, V's 32 columns staged.
//   E  (every chunk but the last) C = C * scale_old + k^T (V * w),
//      n = n * scale_old + k^T w, m = m_new.
//
// Rows past the sequence's end (a ragged last chunk) are zero in the
// staged tiles and are never written: the reference pads S with zeros to a
// whole chunk and slices them away; trailing pads affect no earlier row in
// either.  fp32 FMA on the CUDA cores: no tensor cores, no TMA yet.
//
// Bound: q, k, v read once, gates read, out written, over 3.35 TB/s; or
// the chunkwise operations (2 * (pairs s <= t) * (Dk + Dv) per chunk for
// the panel, 2 * L * Dk * Dv for q.C past the first chunk and for the
// state update before the last) over 989 TFLOP/s (bf16); the larger.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// RG-LRU
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 128;
constexpr int kScanUnroll = 8;

__global__ void __launch_bounds__(kScanThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, int S,
             int W) {
  const int w = blockIdx.x * kScanThreads + threadIdx.x;
  if (w >= W) return;
  const long long row = blockIdx.y;
  const long long W64 = W;
  const float* ap = a + row * S * W64 + w;
  const float* bp = b + row * S * W64 + w;
  float* op = out + row * S * W64 + w;
  float h = h0 != nullptr ? h0[row * W64 + w] : 0.f;
  int t = 0;
  for (; t + kScanUnroll <= S; t += kScanUnroll) {
    float av[kScanUnroll], bv[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      av[u] = ap[(t + u) * W64];
      bv[u] = bp[(t + u) * W64];
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(t + u) * W64] = h;
    }
  }
  for (; t < S; ++t) {
    h = __fadd_rn(__fmul_rn(ap[t * W64], h), bp[t * W64]);
    op[t * W64] = h;
  }
}

// ---------------------------------------------------------------------------
// mLSTM
// ---------------------------------------------------------------------------

constexpr int kTc = 128;               // chunk rows (ops.mlstm_chunkwise's)
constexpr int kBv = 32;                // value columns per block: one per lane
constexpr int kDt = 32;                // Dk tile
constexpr int kLd = kDt + 4;           // staged q/k row stride (float4 rows)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTc / kWarps;    // rows per warp: 16
constexpr int kCols = kTc / 32;        // keys per lane: 4
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// shared memory, in floats
__host__ __device__ constexpr int mlstm_smem_floats(int Dp) {
  return Dp * kBv            // C[:, value tile]
         + Dp                // n
         + kTc * kTc         // gated panel
         + 2 * kTc * kLd     // staged q and k tiles
         + kTc * kBv         // staged V tile (then V * w)
         + 6 * kTc           // ig, bcum, m_t, coeff, denom, w
         + 8;                // reductions and scalars
}

// Stage rows [c0, c0 + L) x columns [d0, d0 + kDt) of x (B, S, H, Dh) for
// head (b, h) into dst (kTc x kLd), times mul; zeros outside.
template <typename T>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x,
                                           float* dst, long long head_base,
                                           int c0, int L, int d0, int Dh,
                                           int HDh, float mul, int tid) {
  const int d = tid % kDt;
#pragma unroll 4
  for (int t = tid / kDt; t < kTc; t += kThreads / kDt) {
    float val = 0.f;
    if (t < L && d0 + d < Dh)
      val = to_f(x[head_base + static_cast<long long>(c0 + t) * HDh + d0 + d]) *
            mul;
    dst[t * kLd + d] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ ig_g,
             const float* __restrict__ fg_g, T* __restrict__ out, int S,
             int H, int Dh, int Dp, float scale) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int v0 = blockIdx.x * kBv;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int HDh = H * Dh;
  // element (b, t, h, d) of a (B, S, H, Dh) tensor is head_base + t*HDh + d
  const long long head_base = static_cast<long long>(b) * S * HDh +
                              static_cast<long long>(h) * Dh;
  const long long gate_base = static_cast<long long>(b) * S * H + h;

  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);   // Dp x kBv
  float* ns = Cs + Dp * kBv;                     // Dp
  float* P = ns + Dp;                            // kTc x kTc
  float* qs = P + kTc * kTc;                     // kTc x kLd
  float* ks = qs + kTc * kLd;                    // kTc x kLd
  float* Vs = ks + kTc * kLd;                    // kTc x kBv
  float* s_ig = Vs + kTc * kBv;                  // kTc each:
  float* s_bc = s_ig + kTc;                      //   bcum
  float* s_mt = s_bc + kTc;                      //   m_t
  float* s_co = s_mt + kTc;                      //   coeff
  float* s_de = s_co + kTc;                      //   denom
  float* s_w = s_de + kTc;                       //   state-update weights
  float* s_red = s_w + kTc;                      // 8 scalars

  for (int i = tid; i < Dp * kBv + Dp; i += kThreads) Cs[i] = 0.f;
  float m_prev = kNegInf;
  const int vcol = v0 + lane;                    // this lane's value column
  const bool vlive = vcol < Dh;
  const int nchunks = (S + kTc - 1) / kTc;

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * kTc;
    const int L = min(kTc, S - c0);
    const bool last = ci == nchunks - 1;

    // ---- A: gates --------------------------------------------------------
    if (tid < kTc) {
      float ig = 0.f, lf = 0.f;
      if (tid < L) {
        const long long gi = gate_base + static_cast<long long>(c0 + tid) * H;
        ig = ig_g[gi];
        lf = log_sigmoid(fg_g[gi]);
      }
      s_ig[tid] = ig;
      s_bc[tid] = lf;
    }
    __syncthreads();
    if (warp == 0) {                   // inclusive scan of 128 = 32 x 4
      float x[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) x[u] = s_bc[lane * kCols + u];
#pragma unroll
      for (int u = 1; u < kCols; ++u) x[u] += x[u - 1];
      float run = x[kCols - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run += y;
      }
      const float before = run - x[kCols - 1];
#pragma unroll
      for (int u = 0; u < kCols; ++u) s_bc[lane * kCols + u] = before + x[u];
    }
    __syncthreads();
    const float g = s_bc[L - 1];
    if (tid < kTc) {
      float ws = kNegInf;
      if (tid < L) {
        const float bt = s_bc[tid];
        float mi = kNegInf;
        for (int s = 0; s <= tid; ++s)
          mi = fmaxf(mi, (bt - s_bc[s]) + s_ig[s]);
        const float mt = fmaxf(fmaxf(mi, bt + m_prev), kNegInf);
        s_mt[tid] = mt;
        s_co[tid] = expf((bt + m_prev) - mt);
        ws = (g - bt) + s_ig[tid];
      } else {
        s_mt[tid] = 0.f;
        s_co[tid] = 0.f;
      }
      s_w[tid] = ws;
      float mx = ws;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      if (lane == 0) s_red[warp] = mx;
    }
    __syncthreads();
    const float m_new =
        fmaxf(g + m_prev,
              fmaxf(fmaxf(s_red[0], s_red[1]), fmaxf(s_red[2], s_red[3])));
    const float scale_old = expf((g + m_prev) - m_new);

    // ---- B: stream Dk: q.k^T, q.C, q.n -------------------------------------
    float acc[kRows][kCols], qc[kRows], qn[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      qc[i] = qn[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    }
    for (int d0 = 0; d0 < Dp; d0 += kDt) {
      stage_tile(q, qs, head_base, c0, L, d0, Dh, HDh, scale, tid);
      stage_tile(k, ks, head_base, c0, L, d0, Dh, HDh, 1.f, tid);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < kDt; d += 4) {
        float4 b4[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          b4[j] = *reinterpret_cast<const float4*>(ks + (lane + 32 * j) * kLd + d);
        const float4 c4 = make_float4(
            Cs[(d0 + d) * kBv + lane], Cs[(d0 + d + 1) * kBv + lane],
            Cs[(d0 + d + 2) * kBv + lane], Cs[(d0 + d + 3) * kBv + lane]);
        const float4 n4 = *reinterpret_cast<const float4*>(ns + d0 + d);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(qs + (warp * kRows + i) * kLd + d);
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = dot4(a4, b4[j], acc[i][j]);
          qc[i] = dot4(a4, c4, qc[i]);
          qn[i] = dot4(a4, n4, qn[i]);
        }
      }
      __syncthreads();
    }

    // ---- C: gated panel, row sums, denominators ----------------------------
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int t = warp * kRows + i;
      const float bt = s_bc[t], mt = s_mt[t];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int s = lane + 32 * j;
        float val = 0.f;
        if (s <= t && t < L)
          val = acc[i][j] * expf(((bt - s_bc[s]) + s_ig[s]) - mt);
        P[t * kTc + s] = val;
        rs += val;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(kFull, rs, o);
      if (lane == 0)
        s_de[t] = fmaxf(fabsf(rs + qn[i] * s_co[t]), expf(-mt));
    }
    // V's value tile
#pragma unroll 4
    for (int s = warp; s < kTc; s += kWarps)
      Vs[s * kBv + lane] =
          (s < L && vlive)
              ? to_f(v[head_base + static_cast<long long>(c0 + s) * HDh + vcol])
              : 0.f;
    __syncthreads();

    // ---- D: out = (P @ V + q.C * coeff) / denom ----------------------------
    float o[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) o[i] = 0.f;
    for (int s = 0; s < L; s += 4) {
      const float4 v4 = make_float4(Vs[s * kBv + lane], Vs[(s + 1) * kBv + lane],
                                    Vs[(s + 2) * kBv + lane],
                                    Vs[(s + 3) * kBv + lane]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        o[i] = dot4(*reinterpret_cast<const float4*>(P + (warp * kRows + i) * kTc + s),
                    v4, o[i]);
    }
    if (vlive) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = warp * kRows + i;
        if (t < L)
          out[head_base + static_cast<long long>(c0 + t) * HDh + vcol] =
              from_f<T>((o[i] + qc[i] * s_co[t]) / s_de[t]);
      }
    }
    if (last) break;

    // ---- E: state update ---------------------------------------------------
    __syncthreads();                   // every warp is done reading Vs
    for (int s = warp; s < kTc; s += kWarps) {
      const float ws = s < L ? expf(s_w[s] - m_new) : 0.f;
      Vs[s * kBv + lane] *= ws;
      __syncwarp();                    // every lane has read s_w[s]
      if (lane == 0) s_w[s] = ws;
    }
    __syncthreads();
    for (int d0 = 0; d0 < Dp; d0 += kDt) {
      stage_tile(k, ks, head_base, c0, L, d0, Dh, HDh, 1.f, tid);
      __syncthreads();
      constexpr int kRowsE = kDt / kWarps;           // 4 rows of C per warp
      float cu[kRowsE], nu[kRowsE];
#pragma unroll
      for (int r = 0; r < kRowsE; ++r) cu[r] = nu[r] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float vw = Vs[s * kBv + lane];
        const float ws = s_w[s];
#pragma unroll
        for (int r = 0; r < kRowsE; ++r) {
          const float kv = ks[s * kLd + warp * kRowsE + r];
          cu[r] = fmaf(kv, vw, cu[r]);
          nu[r] = fmaf(kv, ws, nu[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsE; ++r) {
        const int dk = d0 + warp * kRowsE + r;
        Cs[dk * kBv + lane] = Cs[dk * kBv + lane] * scale_old + cu[r];
        if (lane == 0) ns[dk] = ns[dk] * scale_old + nu[r];
      }
      __syncthreads();
    }
    m_prev = m_new;
  }
}

template <typename T>
int mlstm_launch(const void* q, const void* k, const void* v, const float* ig,
                 const float* fg, void* out, int B, int S, int H, int Dh,
                 float scale, void* stream) {
  if (B < 0 || S < 0 || H < 1 || Dh < 1 || Dh > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const int Dp = (Dh + kDt - 1) / kDt * kDt;
  const size_t shmem = sizeof(float) * static_cast<size_t>(mlstm_smem_floats(Dp));
  auto kernel = mlstm_kernel<T>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Dh + kBv - 1) / kBv, static_cast<unsigned>(B * H));
  kernel<<<grid, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ig, fg, static_cast<T*>(out), S, H, Dh, Dp,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b, out (B, S, W) fp32; h0 (B, W) fp32 or null
int rglru_scan(const float* a, const float* b, const float* h0, float* out,
               int B, int S, int W, void* stream) {
  if (B < 0 || S < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((W + kScanThreads - 1) / kScanThreads,
                  static_cast<unsigned>(B));
  rglru_kernel<<<grid, kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h0, out, S, W);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v, out (B, S, H, Dh) bf16 or fp32; ig, fg (B, S, H) fp32 logits
int mlstm_chunkwise(const void* q, const void* k, const void* v,
                    const float* ig, const float* fg, void* out, int B, int S,
                    int H, int Dh, float scale, int is_bf16, void* stream) {
  if (is_bf16)
    return mlstm_launch<__nv_bfloat16>(q, k, v, ig, fg, out, B, S, H, Dh,
                                       scale, stream);
  return mlstm_launch<float>(q, k, v, ig, fg, out, B, S, H, Dh, scale,
                             stream);
}

}  // extern "C"
