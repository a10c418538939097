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
// a, b, out (B, S, W) fp32; h0 (B, W) fp32 or null (zeros).  The recurrence
// is one sequential chain per channel, so the time steps cannot be spread
// over threads without reassociating the sums (which would change the last
// bits).  What the card can do is start many chains at once and keep their
// loads ahead of them:
//
//   * a block owns kCh neighbouring channels (16, 32 or 64; the wrapper's
//     CHANNELS_PER_BLOCK), grid (ceil(W / kCh), B): 128 blocks at B 1,
//     W 4096, kCh 32, so every SM holds a chain;
//   * all kScanThreads threads of the block copy the (time x kCh) tiles of
//     a and b into shared memory with cp.async, in stages of kScanStep
//     steps through a ring of kScanRing stages: at S <= 128 every load of
//     the chunk is in flight before the first step runs, and the chain
//     starts on stage 0 while the others arrive;
//   * the first kCh threads walk the chain, one channel each, reading a and
//     b from shared memory and storing h as coalesced row segments.
//
// A row of W fp32 values is 16-byte aligned only when W % 4 == 0 (and the
// tensors are); otherwise the copies are 4-byte cp.async, so every W the
// reference takes is taken.
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
// raw logits in their own type (bf16 or fp32), read here.  Per head the
// sequence is walked in chunks of kTc = 128 rows, carrying the state (C:
// Dh x Dh, n: Dh, m: scalar) from chunk to chunk, exactly as the Pallas
// kernel does (NEG_INF = -1e30 finite; log-sigmoid forget gates with an
// inclusive cumsum bcum inside the chunk; m_t = max(m_intra, bcum + m_prev);
// denom = max(|sum scores + q.n * coeff|, exp(-m_t)); m_new = max(g +
// m_prev, max w_s); 1/sqrt(Dh) on q).
//
// At Dh 512, C is 1 MB fp32: it cannot live in one block's shared memory.
// The value columns are split over blocks: grid (ceil(Dh / kBv), B * H),
// kBv = 64 (the wrapper's VALUE_COLS), and a block owns C[:, its 64
// columns] (128 KB at Dh 512) plus its own n and m: 128 blocks at
// xlstm-350m's BH 16, one wave on 132 SMs (32 columns, 256 blocks in two
// waves, took 1.6x as long).  Eight warps, each owning a 16-row tile of
// the chunk (warps w and w + 4, which share an SM sub-partition, take
// tiles w and 7 - w, so the causal work of each sub-partition is the
// same).  Per chunk:
//
//   A  gates (loaded a chunk ahead): bcum (warp scan), m_intra (a warp per
//      row), m_t, coeff; w_s, m_new, scale_old.
//   B  one pass over Dk in tiles of 128 bytes a row (64 bf16, 32 fp32),
//      q and k tiles double-buffered by cp.async (bf16): S = q.k^T for the
//      warp's rows against the keys at or below them (the tiles above the
//      diagonal are skipped), q.C for the block's columns and q.n.  S stays
//      in registers in the mma accumulator layout, as the flash kernels keep
//      theirs.
//   C  the panel P = S * scale * exp(bcum_t - bcum_s + i_s - m_t) (s <= t)
//      in registers, its row sums by quad shuffles, the denominators;
//      out = (P @ V + (q.C) * scale * coeff) / denom, the accumulator
//      fragments of P becoming the A operand of P @ V.
//   D  (every chunk but the last) a second pass over Dk, k tiles only:
//      C^T[v, dk] = C^T * scale_old + (V * w)^T k for the block's columns,
//      n = n * scale_old + k^T w, m = m_new.  Its last tile's loads carry
//      the next chunk's V and first q/k tiles.
//
// Tensor cores (bf16 inputs): mma.sync m16n8k16 for all four products,
// q.k^T, P.V, q.C and (V*w)^T k.  q, k and V enter as given (bf16, exact);
// the scale multiplies the fp32 scores, not q.  Each fp32 operand (P, C,
// V*w) is split into bf16 hi + lo and takes two mmas, so it keeps 16 bits.
// C lives in shared memory in the order of the B fragments of q.C (16
// bytes a lane per 16 x 8 fragment), already split: every warp reads all
// of C in pass B, so it is split once, where the update writes it.  The
// update computes C^T, whose accumulator fragments are exactly those B
// fragments, so it rewrites them in place (old hi + lo, scaled, plus the
// product, split again).  The (V*w)^T fragments are made once per chunk.
// fp32 inputs take fp32 FMA in the same structure (same grid, tiles,
// passes, layout of C, held in fp32, and ownership of the outputs), one
// q/k stage.
//
// Rows past the sequence's end (a ragged last chunk) and columns past Dh
// are zero in the staged tiles and are never written: the reference pads S
// with zeros to a whole chunk and slices them away; trailing pads affect no
// earlier row in either.  When Dh * sizeof(T) is not a multiple of 16 the
// tiles are staged by plain loads instead of cp.async.
//
// Bound: q, k, v read once, gates read, out written, over 3.35 TB/s; or
// the chunkwise operations (2 * (pairs s <= t) * (Dk + Dv) per chunk for
// the panel, 2 * L * Dk * Dv for q.C past the first chunk and for the
// state update before the last) over 989 TFLOP/s (bf16); the larger.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_helpers.cuh"

namespace {

// 4 bytes global -> shared (for rows that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// d += a b (bf16 m16n8k16, fp32 accumulate), as mma_bf16 of the helpers
// but not volatile: the compiler may interleave independent products and
// hoist the next fragment loads (the hi and lo products of one accumulator
// are dependent)
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// RG-LRU
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 128;      // all stage the tiles
constexpr int kScanStep = 32;          // time steps per stage
constexpr int kScanRing = 4;           // stages in flight

__host__ __device__ constexpr int scan_smem_bytes(int channels) {
  return 2 * kScanRing * kScanStep * channels * 4;
}

template <int kCh>
__global__ void __launch_bounds__(kScanThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out, int S,
             int W, int vec) {
  static_assert(kCh % 4 == 0 && kCh <= kScanThreads, "channels per block");
  constexpr int kStage = kScanStep * kCh;               // floats of a stage
  extern __shared__ float4 scan_smem4[];
  float* sa = reinterpret_cast<float*>(scan_smem4);     // kScanRing stages
  float* sb = sa + kScanRing * kStage;
  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * kCh;
  const long long W64 = W;
  const long long base = static_cast<long long>(blockIdx.y) * S * W64;
  const int nst = (S + kScanStep - 1) / kScanStep;

  // copy stage st (steps st * kScanStep ...) into its ring slot; one
  // commit group per call, empty past the end
  auto issue = [&](int st) {
    if (st < nst) {
      const int t0 = st * kScanStep, steps = min(kScanStep, S - t0);
      float* da = sa + (st % kScanRing) * kStage;
      float* db = sb + (st % kScanRing) * kStage;
      if (vec) {
        constexpr int kPieces = kCh / 4;
        for (int i = tid; i < steps * kPieces; i += kScanThreads) {
          const int t = i / kPieces, col = 4 * (i % kPieces);
          if (w0 + col < W) {
            const long long off = base + (t0 + t) * W64 + w0 + col;
            cp_async16(da + t * kCh + col, a + off, true);
            cp_async16(db + t * kCh + col, b + off, true);
          }
        }
      } else {
        for (int i = tid; i < steps * kCh; i += kScanThreads) {
          const int t = i / kCh, col = i % kCh;
          if (w0 + col < W) {
            const long long off = base + (t0 + t) * W64 + w0 + col;
            cp_async4(da + i, a + off);
            cp_async4(db + i, b + off);
          }
        }
      }
    }
    cp_async_commit();
  };

  const int w = w0 + tid;
  const bool live = tid < kCh && w < W;
  float h = 0.f;
  if (live && h0 != nullptr) h = h0[blockIdx.y * W64 + w];
#pragma unroll
  for (int st = 0; st < kScanRing - 1; ++st) issue(st);
  float* op = out + base + w;
  for (int st = 0; st < nst; ++st) {
    issue(st + kScanRing - 1);
    cp_async_wait<kScanRing - 1>();                     // stage st landed
    __syncthreads();
    if (live) {
      const float* xa = sa + (st % kScanRing) * kStage + tid;
      const float* xb = sb + (st % kScanRing) * kStage + tid;
      const int steps = min(kScanStep, S - st * kScanStep);
      if (steps == kScanStep) {
        // the stage's loads all go out before the chain: a store to out
        // between two shared loads would hold the second back
        float av[kScanStep], bv[kScanStep];
#pragma unroll
        for (int t = 0; t < kScanStep; ++t) {
          av[t] = xa[t * kCh];
          bv[t] = xb[t * kCh];
        }
#pragma unroll
        for (int t = 0; t < kScanStep; ++t) {
          h = __fadd_rn(__fmul_rn(av[t], h), bv[t]);
          op[t * W64] = h;
        }
      } else {
        for (int t = 0; t < steps; ++t) {
          h = __fadd_rn(__fmul_rn(xa[t * kCh], h), xb[t * kCh]);
          op[t * W64] = h;
        }
      }
      op += kScanStep * W64;
    }
    __syncthreads();                                    // slot free again
  }
}

template <int kCh>
int rglru_launch(const float* a, const float* b, const float* h0, float* out,
                 int B, int S, int W, cudaStream_t stream) {
  constexpr int shmem = scan_smem_bytes(kCh);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rglru_kernel<kCh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shmem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec = W % 4 == 0 && aligned16(a) && aligned16(b);
  const dim3 grid((W + kCh - 1) / kCh, static_cast<unsigned>(B));
  rglru_kernel<kCh><<<grid, kScanThreads, shmem, stream>>>(a, b, h0, out, S,
                                                           W, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// mLSTM
// ---------------------------------------------------------------------------

constexpr int kTc = 128;               // chunk rows (ops.mlstm_chunkwise's)
constexpr int kBv = 64;                // value columns of C per block
constexpr int kNT = kBv / 8;           // 8-column tiles of the block's C
constexpr int kMT = kBv / 16;          // 16-row value tiles of C^T
constexpr int kMWarps = 8;             // one 16-row tile of the chunk each
constexpr int kMThreads = kMWarps * 32;
constexpr int kRowBytes = 128;         // a staged q/k row of one Dk tile
constexpr int kGateArrays = 5;         // ig, bcum, m_t, coeff, w
constexpr int kScalars = 16;           // reductions
constexpr int kNParts = 2 * kMT * 64;  // n's partial sums, two tiles' worth

template <typename T>
struct MTile {
  static constexpr int kDt = kRowBytes / static_cast<int>(sizeof(T));
  static constexpr int kLd = kDt + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStages = sizeof(T) == 2 ? 2 : 1;
  static constexpr bool kMma = sizeof(T) == 2;
};

template <typename T>
__host__ __device__ constexpr int padded_dk(int Dh) {
  return (Dh + MTile<T>::kDt - 1) / MTile<T>::kDt * MTile<T>::kDt;
}

// shared memory of one block: C (fp32), n, the q and k stages, the V tile,
// the gate vectors and the reductions
template <typename T>
__host__ __device__ constexpr long long mlstm_smem_bytes(int Dh) {
  return 4LL * padded_dk<T>(Dh) * kBv + 4LL * padded_dk<T>(Dh) +
         2LL * MTile<T>::kStages * kTc * MTile<T>::kLd * sizeof(T) +
         1LL * kTc * (kBv + 16 / sizeof(T)) * sizeof(T) +
         4LL * (kGateArrays * kTc + kScalars + kNParts);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 bf2_to_f2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
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

__device__ __forceinline__ float comp(const float4& f, int i) {
  return i == 0 ? f.x : i == 1 ? f.y : i == 2 ? f.z : f.w;
}

// C is kept in the order of q.C's B fragments: fragment (kk, j) covers
// C[16 kk .. 16 kk + 15][8 j .. 8 j + 7], and lane l's 16 bytes hold
// C[16 kk + 2 c + e][8 j + g] (e = 0, 1) then C[16 kk + 8 + 2 c + e][8 j + g]
// with g = l / 4, c = l % 4: for fp32 inputs as four fp32 values, for bf16
// as the two bf16 pairs of the B fragment's hi, then the two of its lo.
// The float index of C[d][v] (fp32):
__device__ __forceinline__ int c_index(int d, int v) {
  const int dd = d & 15;
  const int lane = (v & 7) * 4 + ((dd & 7) >> 1);
  return ((((d >> 4) * kNT + (v >> 3)) * 32 + lane) << 2) +
         ((dd >> 3) << 1) + (dd & 1);
}

// Pass 1 of a Dk tile on the tensor cores: s += q.k^T for the warp's rows
// and the keys at or below them; past the first chunk o += q.C (C held as
// bf16 hi + lo fragments) and qn += q.n (the lane's share, reduced over
// the quad later).  qt/kt: the staged tiles; d0: the tile's first dk.
__device__ __forceinline__ void pass1_tile(
    float (&s)[16][4], float (&o)[kNT][4], float (&qn)[2],
    const __nv_bfloat16* qt, const __nv_bfloat16* kt, const float* Cf,
    const float* ns, int d0, bool inter, int rt, int lane) {
  using Tile = MTile<__nv_bfloat16>;
  constexpr int kLd = Tile::kLd;
  const int r8 = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int c = lane & 3;
#pragma unroll
  for (int kk = 0; kk < Tile::kDt / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, qt + (rt * 16 + (lane & 15)) * kLd + kk * 16 + m2 * 8);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      if (np <= rt) {
        unsigned bk[4];
        ldsm_x4(bk, kt + (np * 16 + r8 + m2 * 8) * kLd + kk * 16 + m1 * 8);
        mma(s[2 * np], a, bk[0], bk[1]);
        mma(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    if (inter) {
      const int dg = d0 + kk * 16;
      const float2 n0 = *reinterpret_cast<const float2*>(ns + dg + 2 * c);
      const float2 n1 = *reinterpret_cast<const float2*>(ns + dg + 8 + 2 * c);
      float2 x = bf2_to_f2(a[0]);
      qn[0] = fmaf(x.x, n0.x, fmaf(x.y, n0.y, qn[0]));
      x = bf2_to_f2(a[2]);
      qn[0] = fmaf(x.x, n1.x, fmaf(x.y, n1.y, qn[0]));
      x = bf2_to_f2(a[1]);
      qn[1] = fmaf(x.x, n0.x, fmaf(x.y, n0.y, qn[1]));
      x = bf2_to_f2(a[3]);
      qn[1] = fmaf(x.x, n1.x, fmaf(x.y, n1.y, qn[1]));
      const uint4* cf =
          reinterpret_cast<const uint4*>(Cf) + (dg >> 4) * kNT * 32 + lane;
#pragma unroll
      for (int j0 = 0; j0 < kNT; j0 += 4) {
        uint4 f[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) f[jj] = cf[(j0 + jj) * 32];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma(o[j0 + jj], a, f[jj].x, f[jj].y);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) mma(o[j0 + jj], a, f[jj].z, f[jj].w);
      }
    }
  }
}

// The same with fp32 FMA, in the same layout (qn complete in every lane).
__device__ __forceinline__ void pass1_tile(
    float (&s)[16][4], float (&o)[kNT][4], float (&qn)[2],
    const float* qt, const float* kt, const float* Cf, const float* ns,
    int d0, bool inter, int rt, int lane) {
  using Tile = MTile<float>;
  constexpr int kLd = Tile::kLd;
  const int g = lane >> 2, c = lane & 3;
  const float* q0 = qt + (rt * 16 + g) * kLd;
  const float* q1 = q0 + 8 * kLd;
#pragma unroll 2
  for (int d4 = 0; d4 < Tile::kDt / 4; ++d4) {
    const float4 qa = *reinterpret_cast<const float4*>(q0 + 4 * d4);
    const float4 qb = *reinterpret_cast<const float4*>(q1 + 4 * d4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j <= 2 * rt + 1) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kv = *reinterpret_cast<const float4*>(
              kt + (8 * j + 2 * c + e) * kLd + 4 * d4);
          s[j][e] = dot4(qa, kv, s[j][e]);
          s[j][2 + e] = dot4(qb, kv, s[j][2 + e]);
        }
      }
    }
    if (inter) {
      const int dg = d0 + 4 * d4;
      const float4 n4 = *reinterpret_cast<const float4*>(ns + dg);
      qn[0] = dot4(qa, n4, qn[0]);
      qn[1] = dot4(qb, n4, qn[1]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int vc = 8 * j + 2 * c + e;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cv = Cf[c_index(dg + i, vc)];
            o[j][e] = fmaf(comp(qa, i), cv, o[j][e]);
            o[j][2 + e] = fmaf(comp(qb, i), cv, o[j][2 + e]);
          }
        }
    }
  }
}

// o += P V for the warp's rows on the tensor cores, P = hi + lo from the
// score accumulators; only the 16-key steps at or below the diagonal.
__device__ __forceinline__ void panel_v(float (&o)[kNT][4],
                                        const float (&s)[16][4],
                                        const __nv_bfloat16* vs, int rt,
                                        int lane) {
  constexpr int kVld = kBv + 8;
  const int r8 = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    if (kt <= rt) {
      unsigned ph[4], pl[4];
      split_bf16(s[2 * kt][0], s[2 * kt][1], ph[0], pl[0]);
      split_bf16(s[2 * kt][2], s[2 * kt][3], ph[1], pl[1]);
      split_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < kBv / 16; ++j) {
        unsigned bv[4];
        ldsm_x4_t(bv, vs + (kt * 16 + r8 + m1 * 8) * kVld + j * 16 + m2 * 8);
        mma(o[2 * j], ph, bv[0], bv[1]);
        mma(o[2 * j + 1], ph, bv[2], bv[3]);
        mma(o[2 * j], pl, bv[0], bv[1]);
        mma(o[2 * j + 1], pl, bv[2], bv[3]);
      }
    }
  }
}

// The same with fp32 FMA: each key's p for the lane's two rows comes from
// the quad lane that holds it.
__device__ __forceinline__ void panel_v(float (&o)[kNT][4],
                                        const float (&s)[16][4],
                                        const float* vs, int rt, int lane) {
  constexpr int kVld = kBv + 4;
  const int c = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j <= 2 * rt + 1) {
#pragma unroll
      for (int src = 0; src < 4; ++src)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = __shfl_sync(kFull, s[j][e], quad | src);
          const float p1 = __shfl_sync(kFull, s[j][2 + e], quad | src);
          const float* vr = vs + (8 * j + 2 * src + e) * kVld + 2 * c;
#pragma unroll
          for (int jj = 0; jj < kBv / 8; ++jj) {
            const float2 v2 = *reinterpret_cast<const float2*>(vr + 8 * jj);
            o[jj][0] = fmaf(p0, v2.x, o[jj][0]);
            o[jj][1] = fmaf(p0, v2.y, o[jj][1]);
            o[jj][2] = fmaf(p1, v2.x, o[jj][2]);
            o[jj][3] = fmaf(p1, v2.y, o[jj][3]);
          }
        }
    }
  }
}

// The A fragments of (V w)^T for the update, once per chunk: warp's value
// rows 16 t .. 16 t + 15 (t = warp % kMT) against every 16-key step, V * w
// split into bf16 hi (ah) and lo (al).
__device__ __forceinline__ void vw_fragments(unsigned (&ah)[kTc / 16][4],
                                             unsigned (&al)[kTc / 16][4],
                                             const __nv_bfloat16* vs,
                                             const float* s_w, int warp,
                                             int lane) {
  constexpr int kVld = kBv + 8;
  const int r8 = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int c = lane & 3, t = warp % kMT;
#pragma unroll
  for (int ks = 0; ks < kTc / 16; ++ks) {
    const int s0 = ks * 16;
    unsigned av[4];
    ldsm_x4_t(av, vs + (s0 + r8 + m2 * 8) * kVld + 16 * t + m1 * 8);
    const float2 w0 = *reinterpret_cast<const float2*>(s_w + s0 + 2 * c);
    const float2 w8 = *reinterpret_cast<const float2*>(s_w + s0 + 8 + 2 * c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = bf2_to_f2(av[i]);
      const float2 ww = i < 2 ? w0 : w8;
      split_bf16(x.x * ww.x, x.y * ww.y, ah[ks][i], al[ks][i]);
    }
  }
}

// C^T[v, dk] = C^T * scale_old + (V w)^T k over one Dk tile, and a part of
// k^T w.  Warp (t = warp % kMT, grp = warp / kMT) computes the value rows
// 16 t .. 16 t + 15 against kUT of the tile's 8-wide dk columns; its
// accumulator fragments are C's stored B fragments, rewritten as bf16 hi +
// lo.  The kMT warps of a dk group each sum k^T w over their share of the
// keys (16-key steps ks with ks % kMT == t) into np[t][dk]; the kernel adds
// the shares once every warp is done.
__device__ __forceinline__ void update_tile(float* Cf, float* np,
                                            const __nv_bfloat16* kt,
                                            const unsigned (&ah)[kTc / 16][4],
                                            const unsigned (&al)[kTc / 16][4],
                                            const float* s_w, int L, int d0,
                                            float scale_old, int warp,
                                            int lane) {
  using Tile = MTile<__nv_bfloat16>;
  constexpr int kLd = Tile::kLd;
  constexpr int kUT = Tile::kDt / 8 / (kMWarps / kMT);
  static_assert(kUT % 2 == 0, "whole 16-wide dk steps per warp");
  const int r8 = lane & 7, m1 = (lane >> 3) & 1, m2 = lane >> 4;
  const int g = lane >> 2, c = lane & 3;
  const int t = warp % kMT, grp = warp / kMT;
  float acc[kUT][4], nacc[kUT];
#pragma unroll
  for (int i = 0; i < kUT; ++i) {
    nacc[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < kTc / 16; ++ks) {
    const int s0 = ks * 16;
    if (s0 < L) {
      const float2 w0 = *reinterpret_cast<const float2*>(s_w + s0 + 2 * c);
      const float2 w8 =
          *reinterpret_cast<const float2*>(s_w + s0 + 8 + 2 * c);
      unsigned bk[kUT / 2][4];
#pragma unroll
      for (int i2 = 0; i2 < kUT / 2; ++i2)
        ldsm_x4_t(bk[i2], kt + (s0 + r8 + m1 * 8) * kLd +
                              8 * (grp * kUT + 2 * i2) + m2 * 8);
#pragma unroll
      for (int i2 = 0; i2 < kUT / 2; ++i2) {
        mma(acc[2 * i2], ah[ks], bk[i2][0], bk[i2][1]);
        mma(acc[2 * i2 + 1], ah[ks], bk[i2][2], bk[i2][3]);
      }
#pragma unroll
      for (int i2 = 0; i2 < kUT / 2; ++i2) {
        mma(acc[2 * i2], al[ks], bk[i2][0], bk[i2][1]);
        mma(acc[2 * i2 + 1], al[ks], bk[i2][2], bk[i2][3]);
      }
#pragma unroll
      for (int i2 = 0; i2 < kUT / 2; ++i2) {
        if (ks % kMT == t) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 k0 = bf2_to_f2(bk[i2][2 * h]);
            const float2 k8 = bf2_to_f2(bk[i2][2 * h + 1]);
            float& n = nacc[2 * i2 + h];
            n = fmaf(k0.x, w0.x, n);
            n = fmaf(k0.y, w0.y, n);
            n = fmaf(k8.x, w8.x, n);
            n = fmaf(k8.y, w8.y, n);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kUT; ++i) {
    const int nt = d0 / 8 + grp * kUT + i;          // global dk 8-column
    const int kk = nt >> 1, half = nt & 1;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      unsigned* f = reinterpret_cast<unsigned*>(Cf) +
                    (((kk * kNT + 2 * t + jh) * 32 + lane) << 2) + half;
      const float2 hi = bf2_to_f2(f[0]), lo = bf2_to_f2(f[2]);
      split_bf16(fmaf(hi.x + lo.x, scale_old, acc[i][2 * jh]),
                 fmaf(hi.y + lo.y, scale_old, acc[i][2 * jh + 1]), f[0],
                 f[2]);
    }
    float n = nacc[i];
    n += __shfl_xor_sync(kFull, n, 1);
    n += __shfl_xor_sync(kFull, n, 2);
    if (c == 0) np[t * Tile::kDt + 8 * (grp * kUT + i) + g] = n;
  }
}

// The same with fp32 FMA, in the same ownership.
__device__ __forceinline__ void update_tile(float* Cf, float* ns,
                                            const float* kt, const float* vs,
                                            const float* s_w, int L, int d0,
                                            float scale_old, int warp,
                                            int lane) {
  using Tile = MTile<float>;
  constexpr int kLd = Tile::kLd, kVld = kBv + 4;
  constexpr int kUT = Tile::kDt / 8 / (kMWarps / kMT);
  static_assert(kUT >= 1, "dk columns per warp");
  const int g = lane >> 2, c = lane & 3;
  const int t = warp % kMT, grp = warp / kMT;
  float acc[kUT][4], nacc[kUT][2];
#pragma unroll
  for (int i = 0; i < kUT; ++i) {
    nacc[i][0] = nacc[i][1] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
#pragma unroll 4
  for (int s = 0; s < L; ++s) {
    const float ws = s_w[s];
    const float vw0 = vs[s * kVld + 16 * t + g] * ws;
    const float vw1 = vs[s * kVld + 16 * t + g + 8] * ws;
#pragma unroll
    for (int i = 0; i < kUT; ++i) {
      const float2 kv = *reinterpret_cast<const float2*>(
          kt + s * kLd + 8 * (grp * kUT + i) + 2 * c);
      acc[i][0] = fmaf(vw0, kv.x, acc[i][0]);
      acc[i][1] = fmaf(vw0, kv.y, acc[i][1]);
      acc[i][2] = fmaf(vw1, kv.x, acc[i][2]);
      acc[i][3] = fmaf(vw1, kv.y, acc[i][3]);
      nacc[i][0] = fmaf(kv.x, ws, nacc[i][0]);
      nacc[i][1] = fmaf(kv.y, ws, nacc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kUT; ++i) {
    const int nt = d0 / 8 + grp * kUT + i;
    const int kk = nt >> 1, half = nt & 1;
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
      float2* f = reinterpret_cast<float2*>(
          Cf + (((kk * kNT + 2 * t + jh) * 32 + lane) << 2) + 2 * half);
      float2 x = *f;
      x.x = fmaf(x.x, scale_old, acc[i][2 * jh]);
      x.y = fmaf(x.y, scale_old, acc[i][2 * jh + 1]);
      *f = x;
    }
    if (t == 0 && g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& dst = ns[8 * nt + 2 * c + e];
        dst = fmaf(dst, scale_old, nacc[i][e]);
      }
    }
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(kMThreads, 1)
mlstm_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const G* __restrict__ ig_g,
             const G* __restrict__ fg_g, T* __restrict__ out, int S, int H,
             int Dh, float scale, int vec) {
  using Tile = MTile<T>;
  constexpr int kDt = Tile::kDt, kLd = Tile::kLd, kStages = Tile::kStages;
  constexpr int kE = 16 / static_cast<int>(sizeof(T));   // elements / 16 B
  constexpr int kVld = kBv + kE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  // the warp's row tile: warps w and w + 4 share an SM sub-partition, and
  // row tiles w and 7 - w together hold 9 of the panel's 36 16 x 16 blocks
  const int rt = warp < 4 ? warp : 11 - warp;
  const int v0 = blockIdx.x * kBv;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int HDh = H * Dh;
  const int Dp = padded_dk<T>(Dh);
  const int nd = Dp / kDt;
  // element (b, t, h, d) of a (B, S, H, Dh) tensor is head_base + t*HDh + d
  const long long head_base = static_cast<long long>(b) * S * HDh +
                              static_cast<long long>(h) * Dh;
  const long long gate_base = static_cast<long long>(b) * S * H + h;

  extern __shared__ float4 mlstm_smem4[];
  float* Cf = reinterpret_cast<float*>(mlstm_smem4);  // Dp x kBv, fragments
  float* ns = Cf + Dp * kBv;                          // Dp
  T* qs = reinterpret_cast<T*>(ns + Dp);              // kStages x kTc x kLd
  T* ks = qs + kStages * kTc * kLd;                   // kStages x kTc x kLd
  T* vs = ks + kStages * kTc * kLd;                   // kTc x kVld
  float* s_ig = reinterpret_cast<float*>(vs + kTc * kVld);
  float* s_bc = s_ig + kTc;                           // bcum
  float* s_mt = s_bc + kTc;                           // m_t
  float* s_co = s_mt + kTc;                           // coeff
  float* s_w = s_co + kTc;                            // w_s, then exp(w - m)
  float* s_red = s_w + kTc;                           // kScalars
  float* s_np = s_red + kScalars;                     // 2 x kMT x 64: n's parts

  // rows [c0, c0 + L) x columns [d0, d0 + ncols) of x into dst (kTc rows of
  // ld elements); zeros past L and past Dh
  auto stage = [&](T* dst, int ld, const T* x, int c0, int L, int d0,
                   int ncols) {
    if (vec) {
      const int pieces = ncols / kE;
      for (int i = tid; i < kTc * pieces; i += kMThreads) {
        const int t = i / pieces, col = (i % pieces) * kE;
        const bool ok = t < L && d0 + col < Dh;
        const T* src =
            ok ? x + head_base + static_cast<long long>(c0 + t) * HDh + d0 +
                     col
               : x;
        cp_async16(dst + t * ld + col, src, ok);
      }
    } else {
      for (int i = tid; i < kTc * ncols; i += kMThreads) {
        const int t = i / ncols, col = i % ncols;
        const bool ok = t < L && d0 + col < Dh;
        dst[t * ld + col] =
            ok ? x[head_base + static_cast<long long>(c0 + t) * HDh + d0 + col]
               : from_f<T>(0.f);
      }
    }
  };

  // n over Dk tile d: n = n * scale_old + the four value-row warps'
  // partial k^T w, summed in a fixed order (tensor-core update only)
  float scale_old = 0.f;
  auto finish_n = [&](int d) {
    if (tid < kDt) {
      const float* p = s_np + (d & 1) * kMT * kDt + tid;
      float n = p[0];
#pragma unroll
      for (int t = 1; t < kMT; ++t) n += p[t * kDt];
      float& dst = ns[d * kDt + tid];
      dst = fmaf(dst, scale_old, n);
    }
  };

  for (int i = tid; i < Dp * kBv + Dp; i += kMThreads) Cf[i] = 0.f;
  float m_prev = kNegInf;
  const int nchunks = (S + kTc - 1) / kTc;
  // the gates of the next chunk, row tid (tid < kTc), loaded a chunk ahead
  float gi_next = 0.f, gf_next = 0.f;
  auto load_gates = [&](int c0) {
    if (tid < min(kTc, S - c0)) {
      const long long gi = gate_base + static_cast<long long>(c0 + tid) * H;
      gi_next = to_f(ig_g[gi]);
      gf_next = to_f(fg_g[gi]);
    }
  };
  load_gates(0);
  bool prefetched = false;             // this chunk's first tiles are out

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * kTc;
    const int L = min(kTc, S - c0);
    const bool last = ci == nchunks - 1;
    const bool inter = ci > 0;

    // the V tile and the first q/k tile go out before the gates, unless
    // the previous chunk's update sent them
    if (!prefetched) {
      stage(vs, kVld, v, c0, L, v0, kBv);
      stage(qs, kLd, q, c0, L, 0, kDt);
      stage(ks, kLd, k, c0, L, 0, kDt);
      cp_async_commit();
    }
    prefetched = false;

    // ---- A: gates --------------------------------------------------------
    if (tid < kTc) {
      s_ig[tid] = tid < L ? gi_next : 0.f;
      s_bc[tid] = tid < L ? log_sigmoid(gf_next) : 0.f;
      if (!last) load_gates(c0 + kTc);
    }
    __syncthreads();
    if (warp == 0) {                   // inclusive scan of 128 = 32 x 4
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = s_bc[lane * 4 + u];
#pragma unroll
      for (int u = 1; u < 4; ++u) x[u] += x[u - 1];
      float run = x[3];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run += y;
      }
      const float before = run - x[3];
#pragma unroll
      for (int u = 0; u < 4; ++u) s_bc[lane * 4 + u] = before + x[u];
    }
    __syncthreads();
    const float gsum = s_bc[L - 1];
    // m_intra_t = max_{s <= t} (bcum_t - bcum_s) + i_s: a warp per row,
    // its lanes over the keys
    for (int r = warp; r < kTc; r += kMWarps) {
      float mt = 0.f, co = 0.f;
      if (r < L) {
        const float br = s_bc[r];
        float mi = kNegInf;
#pragma unroll
        for (int i = 0; i < kTc / 32; ++i) {
          const int s = lane + 32 * i;
          if (s <= r) mi = fmaxf(mi, (br - s_bc[s]) + s_ig[s]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mi = fmaxf(mi, __shfl_xor_sync(kFull, mi, o));
        mt = fmaxf(fmaxf(mi, br + m_prev), kNegInf);
        co = expf((br + m_prev) - mt);
      }
      if (lane == 0) {
        s_mt[r] = mt;
        s_co[r] = co;
      }
    }
    if (tid < kTc) {
      const float ws = tid < L ? (gsum - s_bc[tid]) + s_ig[tid] : kNegInf;
      s_w[tid] = ws;
      float mx = ws;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      if (lane == 0) s_red[warp] = mx;
    }
    __syncthreads();
    const float m_new =
        fmaxf(gsum + m_prev,
              fmaxf(fmaxf(s_red[0], s_red[1]), fmaxf(s_red[2], s_red[3])));
    scale_old = expf((gsum + m_prev) - m_new);

    // ---- B: one pass over Dk: q.k^T, q.C, q.n ------------------------------
    float sacc[16][4], oacc[kNT][4], qn[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
    for (int d = 0; d < nd; ++d) {
      // one barrier a tile (two stages): tile d has landed, and every warp
      // is done with tile d - 1, whose buffer takes tile d + 1
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kStages == 2) {
        if (d + 1 < nd) {
          const int nb = ((d + 1) & 1) * kTc * kLd;
          stage(qs + nb, kLd, q, c0, L, (d + 1) * kDt, kDt);
          stage(ks + nb, kLd, k, c0, L, (d + 1) * kDt, kDt);
          cp_async_commit();
        }
      }
      const int buf = kStages == 2 ? (d & 1) * kTc * kLd : 0;
      pass1_tile(sacc, oacc, qn, qs + buf, ks + buf, Cf, ns, d * kDt, inter,
                 rt, lane);
      if constexpr (kStages == 1) {
        __syncthreads();
        if (d + 1 < nd) {
          stage(qs, kLd, q, c0, L, (d + 1) * kDt, kDt);
          stage(ks, kLd, k, c0, L, (d + 1) * kDt, kDt);
          cp_async_commit();
        }
      }
    }
    // pass D's tiles alternate from the k buffer the last tile left free
    const int pb = kStages == 2 ? (nd & 1) : 0;
    if (!last) {                       // pass D's first k tile, early
      stage(ks + pb * kTc * kLd, kLd, k, c0, L, 0, kDt);
      cp_async_commit();
    }
    if constexpr (Tile::kMma) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        qn[hh] += __shfl_xor_sync(kFull, qn[hh], 1);
        qn[hh] += __shfl_xor_sync(kFull, qn[hh], 2);
      }
    }

    // ---- C: gated panel, denominators, out ---------------------------------
    float den[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g + 8 * hh;
      const float bt = s_bc[t], mt = s_mt[t];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j <= 2 * rt + 1) {
          const int s = 8 * j + 2 * c;
          const float2 bs = *reinterpret_cast<const float2*>(s_bc + s);
          const float2 is = *reinterpret_cast<const float2*>(s_ig + s);
          float& x0 = sacc[j][2 * hh];
          float& x1 = sacc[j][2 * hh + 1];
          x0 = (s <= t && t < L)
                   ? x0 * scale * expf(((bt - bs.x) + is.x) - mt)
                   : 0.f;
          x1 = (s + 1 <= t && t < L)
                   ? x1 * scale * expf(((bt - bs.y) + is.y) - mt)
                   : 0.f;
          rs += x0 + x1;
        }
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      const float co = scale * s_co[t];
      den[hh] = fmaxf(fabsf(rs + qn[hh] * co), expf(-mt));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        oacc[j][2 * hh] *= co;
        oacc[j][2 * hh + 1] *= co;
      }
    }
    panel_v(oacc, sacc, vs, rt, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = rt * 16 + g + 8 * hh;
      if (t < L) {
        T* orow = out + head_base + static_cast<long long>(c0 + t) * HDh;
        const float inv = 1.f / den[hh];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = v0 + 8 * j + 2 * c;
          const float x = oacc[j][2 * hh] * inv;
          const float y = oacc[j][2 * hh + 1] * inv;
          if (col + 1 < Dh && (Dh & 1) == 0) {
            store2(orow + col, x, y);
          } else {
            if (col < Dh) orow[col] = from_f<T>(x);
            if (col + 1 < Dh) orow[col + 1] = from_f<T>(y);
          }
        }
      }
    }
    if (last) break;

    // ---- D: state update -----------------------------------------------------
    if (tid < kTc) s_w[tid] = tid < L ? expf(s_w[tid] - m_new) : 0.f;
    __syncthreads();
    unsigned vwh[kTc / 16][4], vwl[kTc / 16][4];
    if constexpr (Tile::kMma) vw_fragments(vwh, vwl, vs, s_w, warp, lane);
    for (int d = 0; d < nd; ++d) {
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kStages == 2) {
        if (d >= 1) finish_n(d - 1);
        if (d + 1 < nd) {
          stage(ks + ((d + 1 + pb) & 1) * kTc * kLd, kLd, k, c0, L,
                (d + 1) * kDt, kDt);
        } else {
          // the last tile is in k's second buffer: the next chunk's V and
          // first q/k tile go out now, behind it
          const int cn = c0 + kTc, Ln = min(kTc, S - cn);
          stage(vs, kVld, v, cn, Ln, v0, kBv);
          stage(qs, kLd, q, cn, Ln, 0, kDt);
          stage(ks, kLd, k, cn, Ln, 0, kDt);
          prefetched = true;
        }
        cp_async_commit();
      }
      const int buf = kStages == 2 ? ((d + pb) & 1) * kTc * kLd : 0;
      if constexpr (Tile::kMma)
        update_tile(Cf, s_np + (d & 1) * kMT * kDt, ks + buf, vwh, vwl, s_w,
                    L, d * kDt, scale_old, warp, lane);
      else
        update_tile(Cf, ns, ks + buf, vs, s_w, L, d * kDt, scale_old, warp,
                    lane);
      if constexpr (kStages == 1) {
        __syncthreads();
        if (d + 1 < nd) {
          stage(ks, kLd, k, c0, L, (d + 1) * kDt, kDt);
          cp_async_commit();
        }
      }
    }
    if constexpr (Tile::kMma) {
      __syncthreads();
      finish_n(nd - 1);
    }
    m_prev = m_new;
  }
}

template <typename T, typename G>
int mlstm_launch(const void* q, const void* k, const void* v, const void* ig,
                 const void* fg, void* out, int B, int S, int H, int Dh,
                 float scale, cudaStream_t stream) {
  const long long shmem = mlstm_smem_bytes<T>(Dh);
  auto kernel = mlstm_kernel<T, G>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec = (Dh * static_cast<int>(sizeof(T))) % 16 == 0 &&
                  aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid((Dh + kBv - 1) / kBv, static_cast<unsigned>(B * H));
  kernel<<<grid, kMThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const G*>(ig),
      static_cast<const G*>(fg), static_cast<T*>(out), S, H, Dh, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int mlstm_gates(int gate_bf16, const void* q, const void* k, const void* v,
                const void* ig, const void* fg, void* out, int B, int S,
                int H, int Dh, float scale, cudaStream_t stream) {
  if (gate_bf16)
    return mlstm_launch<T, __nv_bfloat16>(q, k, v, ig, fg, out, B, S, H, Dh,
                                          scale, stream);
  return mlstm_launch<T, float>(q, k, v, ig, fg, out, B, S, H, Dh, scale,
                                stream);
}

}  // namespace

extern "C" {

// a, b, out (B, S, W) fp32; h0 (B, W) fp32 or null; channels per block
// 16, 32 or 64
int rglru_scan(const float* a, const float* b, const float* h0, float* out,
               int B, int S, int W, int channels, void* stream) {
  if (B < 0 || S < 0 || W < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0 || W == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (channels) {
    case 16: return rglru_launch<16>(a, b, h0, out, B, S, W, st);
    case 32: return rglru_launch<32>(a, b, h0, out, B, S, W, st);
    case 64: return rglru_launch<64>(a, b, h0, out, B, S, W, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, out (B, S, H, Dh) bf16 or fp32; ig, fg (B, S, H) logits, bf16
// or fp32
int mlstm_chunkwise(const void* q, const void* k, const void* v,
                    const void* ig, const void* fg, void* out, int B, int S,
                    int H, int Dh, float scale, int is_bf16, int gate_bf16,
                    void* stream) {
  if (B < 0 || S < 0 || H < 1 || Dh < 1 || Dh > 512 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return mlstm_gates<__nv_bfloat16>(gate_bf16, q, k, v, ig, fg, out, B, S,
                                      H, Dh, scale, st);
  return mlstm_gates<float>(gate_bf16, q, k, v, ig, fg, out, B, S, H, Dh,
                            scale, st);
}

// dynamic shared memory of one mLSTM block (the wrapper's
// mlstm_smem_bytes mirrors it)
int mlstm_smem(int Dh, int is_bf16) {
  return static_cast<int>(is_bf16 ? mlstm_smem_bytes<__nv_bfloat16>(Dh)
                                  : mlstm_smem_bytes<float>(Dh));
}

}  // extern "C"
