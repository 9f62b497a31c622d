// Fused dilated residual unit (kernel B1) for Hopper: tensor cores at
// float32 accuracy (3xTF32 with mma.sync) and thread-block clusters.
//
// Replaces the Pallas TPU kernel `_kernel` of
// rave_tpu/ops/pallas/residual_unit.py (launched by `_pallas_forward`).
// It computes, for x of shape (B, C, T) channels-first,
//
//   y[b, :, t] = x[b, :, t] + b2
//              + W2 . lrelu(b1 + sum_j W1[j] . lrelu(x)[b, :, t + j*d - pad_left])
//
// with lrelu slope 0.2, zero padding outside [0, T) and a same-length
// output.  The weights arrive K-major (input channel fastest): w1k is
// (k, C_out, C_in) and w2 (C_out, C_in).
//
// What bounds it: 2*B*T*C^2*(k+1) FLOPs against 2*B*T*C*4 + (k+1)*C^2*4
// bytes, over 100 FLOP per byte at every shape of the v2 model, so the
// arithmetic bounds it, not the memory.  On float32 FMAs that is 67
// TFLOP/s; on the tensor cores 495 TFLOP/s of TF32, of which 3xTF32 takes
// three products per term.
//
// Design.
// * One CTA owns one batch row, one 64-step time tile and one group of 64
//   output channels.  The C/64 CTAs of a time tile form a cluster (2, 4,
//   6, 8 at C = 128, 256, 384, 512), so a v2 forward launches 128-256
//   CTAs per unit and each CTA reads only its 64 rows of W1 and W2.
// * GEMM 1, hidden(64 x 64) = W1-rows . window, K = k*C: input channels
//   stream in chunks of KC (32, or 16/8 where a wide window must fit: at
//   k = 3, 32 up to d = 273, 16 up to 673, 8 up to 1489)
//   through a double buffer filled with cp.async: the x window of the
//   chunk (tile plus its (k-1)*d halo, zero outside [0, T); 16-byte
//   copies from the aligned step before the window where T % 4 == 0,
//   4-byte copies otherwise) and the chunk's slice of all k taps of W1
//   (16-byte copies).  lrelu is applied as a fragment is read.  The
//   window keeps x's time-contiguous rows: with mma.sync the B operand is
//   read from it bank-conflict-free (row stride = 8 mod 32 words) and tap
//   j is a column offset j*d, not a copy.
// * hidden = lrelu(acc + b1) stays in shared memory (64 x 64); it never
//   goes to device memory.  After cluster.sync() each CTA reads its
//   peers' hidden tiles through distributed shared memory
//   (cluster.map_shared_rank), 32 channels at a time into a local double
//   buffer, and contracts them with its 64 rows of W2 (GEMM 2, K = C).
// * The epilogue adds b2, stages the tile in shared memory and adds the
//   residual x while storing: a warp stores (and reads x) along 32
//   consecutive time steps.  A second cluster.sync() before exit keeps
//   each CTA's hidden tile alive while its peers read it.
// * Arithmetic: mma.sync.m16n8k8 TF32.  8 warps in two groups of 4 split
//   each chunk's (tap, k8-step) pairs; in a group each warp owns 32
//   channels x 32 steps; the groups' sums meet in shared memory.  The TPU
//   kernel computes at Precision.HIGHEST, so each operand is split,
//   hi = TF32 rounding of a (to nearest), lo = a - hi, and every term
//   accumulates lo*hi + hi*lo + hi*hi in float32 (3xTF32).
// * What holds it back (clock64 phases on the H100, C = 512): about a
//   quarter of a CTA's time is spent issuing the next chunk's cp.async
//   (every warp stalls at issue while ~35 KB per chunk are in flight),
//   and the mma loop runs at about half of mma.sync's TF32 rate.  A ninth
//   warp that stages alone through an mbarrier pipeline (cp.async; or
//   bulk copies of the W1 chunk and of each x row, 2-4 stages) was right
//   but slower in every variant measured: each chunk then waits out the
//   copies' latency.  Left to try: TMA tensor copies with multicast of
//   the x window across the cluster, then wgmma (which wants K-major
//   swizzled shared-memory operands; a j*d row offset does not meet the
//   swizzle, so A would come from registers).
// * The dynamic shared-memory limit is raised once per device, and the
//   launch sets the cluster size with cudaLaunchKernelEx.
//
// The bf16 instance (residual_unit_bf16_forward) computes the Pallas
// kernel's contract for bf16 operands (x, W1, b1, W2, b2 and the output
// all bf16): lrelu(x) in bf16 (the slope rounded to bf16, 0.2001953125,
// as JAX reads 0.2 beside a bf16 array, and 0.2 * x rounded to bf16),
// GEMM 1 accumulated in float32, + b1 and lrelu in float32, ONE rounding
// of the hidden tile to bf16, GEMM 2 accumulated in float32, + b2 and the
// residual x in float32, ONE rounding at the output.  Same design as the
// float32 instance, with mma.sync.m16n8k16 on bf16 operands (one pass
// where 3xTF32 takes three) and half the bytes staged: 16-byte cp.async
// pieces of 8 values where T % 8 == 0, element copies otherwise; lrelu
// is applied to each staged x window in place, once per chunk; the
// hidden tile is bf16 in shared memory and reaches the peers through
// distributed shared memory in 16-byte pieces; chunks of 32 input
// channels (16 where a wide window must fit: at k = 3 up to d = 1560).
// Bound: 2*B*T*C^2*(k+1) FLOPs on 989 TFLOP/s of dense bf16 against
// 2*(2*B*T*C + (k+1)*C^2 + 2*C) bytes, so again the arithmetic.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegSlope = 0.2f;
constexpr int kTile = 64;      // time steps per CTA
constexpr int kGroup = 64;     // output channels per CTA
// 8 warps: two groups of 4 split the K range of every chunk; in a group,
// 2 warps along channels x 2 along time, each 32 channels x 32 steps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 4;  // n8 tiles of a warp
constexpr int kHs = kTile + 8;   // row stride of hidden / epilogue tiles
constexpr int kKC2 = 32;         // hidden channels per GEMM-2 chunk
constexpr int kWs2 = kKC2 + 4;   // row stride of a W2 chunk
constexpr int kMaxSmem = 232448; // what a Hopper CTA may use
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kNegSlope * v;
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 but in two integer ops: the cvt runs on a slower
// pipe), lo = v - hi exactly; the tensor core reads lo's top 19 bits.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte copy; bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Window row stride: the least S >= W + 6 (the window, up to 3 floats of
// alignment shift and the round-up to a 16-byte piece) with S = 8 (mod
// 32), so that the B fragment's 4 rows x 8 columns fall in 32 distinct
// banks.
__host__ __device__ inline int window_stride(int k, int dilation) {
  const int w = kTile + (k - 1) * dilation + 6;
  return ((w + 23) / 32) * 32 + 8;
}

// Floats of dynamic shared memory: the hidden tile, then the larger of
// GEMM 1's and GEMM 2's double buffers (the epilogue tile reuses them).
__host__ __device__ inline int smem_floats(int kc, int k, int dilation) {
  const int g1 = 2 * kc * window_stride(k, dilation) +
                 2 * k * kGroup * (kc + 4);
  const int g2 = 2 * kKC2 * kHs + 2 * kGroup * kWs2;
  return kGroup * kHs + (g1 > g2 ? g1 : g2);
}

// One warp's 32 x (8 kNT) product over 8 of K: A (channels x K) from `a`
// with row stride `as`, B (K x time) from `bm` with row stride `bs`;
// each operand split into TF32 hi and lo.
template <bool kLreluB>
__device__ __forceinline__ void mma_k8(float (*acc)[kNT][4], const float* a,
                                       int as, const float* bm, int bs,
                                       int gid, int tig) {
  uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* p = a + (mt * 16 + gid) * as + tig;
    split(p[0], ah[mt][0], al[mt][0]);
    split(p[8 * as], ah[mt][1], al[mt][1]);
    split(p[4], ah[mt][2], al[mt][2]);
    split(p[8 * as + 4], ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float* p = bm + tig * bs + nt * 8 + gid;
    float v0 = p[0], v1 = p[4 * bs];
    if (kLreluB) {
      v0 = lrelu(v0);
      v1 = lrelu(v1);
    }
    split(v0, bh[nt][0], bl[nt][0]);
    split(v1, bh[nt][1], bl[nt][1]);
  }
  // three passes over the 2 x kNT accumulators, small products first:
  // consecutive mma never wait on each other's result
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }

// a bf16 value's bits
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// dst (64 x 64, row stride kHs) = act(group 0's + group 1's accumulators
// + bias[row]); act is lrelu or nothing.  The fragment holds rows gid and
// gid + 8, columns 2*tig and 2*tig + 1 of each 16 x 8 tile.  Group 1
// writes its sum first; the caller syncs before anyone reads dst.  The
// bias is float32 or bf16 (its bits), the sums float32 either way.
template <typename Bias>
__device__ __forceinline__ void reduce_groups(float (*acc)[kNT][4],
                                              float* dst, int grp, int wm,
                                              int wt, int gid, int tig,
                                              const Bias* bias,
                                              bool act) {
  auto each = [&](auto&& fn) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 32 + mt * 16 + gid + 8 * h;
          fn(reinterpret_cast<float2*>(dst + r * kHs + wt + nt * 8 + 2 * tig),
             acc[mt][nt] + 2 * h, r);
        }
  };
  if (grp == 1) each([](float2* d, const float* a, int) {
    *d = make_float2(a[0], a[1]);
  });
  __syncthreads();
  if (grp == 0) each([&](float2* d, const float* a, int r) {
    const float2 o = *d;
    const float b = to_f32(bias[r]);
    float v0 = a[0] + o.x + b, v1 = a[1] + o.y + b;
    if (act) {
      v0 = lrelu(v0);
      v1 = lrelu(v1);
    }
    *d = make_float2(v0, v1);
  });
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
    residual_unit_kernel(const float* __restrict__ x,
                         const float* __restrict__ w1k,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2,
                         float* __restrict__ out, int C, int T, int k,
                         int dilation, int pad_left) {
  constexpr int kWs = KC + 4;  // W1 chunk row stride (= 4 mod 8 words)
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int win = kTile + (k - 1) * dilation;
  const int xs_stride = window_stride(k, dilation);
  float* hs = smem;                          // [64][kHs] hidden, own rows
  float* region = smem + kGroup * kHs;
  float* xbuf = region;                      // [2][KC][xs_stride]
  float* wbuf = region + 2 * KC * xs_stride; // [2][k][64][kWs]
  float* hbuf = region;                      // GEMM 2: [2][32][kHs]
  float* w2buf = region + 2 * kKC2 * kHs;    //         [2][64][kWs2]

  const int group = static_cast<int>(cluster.block_rank());
  const int co0 = group * kGroup;
  const int t0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int grp = warp >> 2;                   // K-split group
  const int wm = (warp >> 1) & 1, wn = warp & 1;
  const int wt = wn * kNT * 8;  // warp's first time step in the tile
  const float* xb = x + static_cast<size_t>(b) * C * T;

  // ---- GEMM 1: hidden = lrelu(b1 + sum_j W1[j] . lrelu(x) window) ----
  // Where T % 4 == 0 and x is 16-byte aligned, every row of the window
  // is staged in 16-byte pieces from the aligned step xshift (0-3) before
  // t0 - pad_left, and fragments read it xshift floats in; otherwise
  // element by element.
  const bool xvec =
      T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int xshift = xvec ? ((t0 - pad_left) & 3) : 0;
  const int xstart = t0 - pad_left - xshift;
  auto stage1 = [&](int chunk, int s) {
    const int ci0 = chunk * KC;
    float* xd = xbuf + s * KC * xs_stride;
    for (int r = warp; r < KC; r += kWarps) {
      const float* src = xb + static_cast<size_t>(ci0 + r) * T;
      float* dst = xd + r * xs_stride;
      if (xvec) {
        for (int c = 4 * lane; c < xshift + win; c += 128) {
          const int t = xstart + c;
          if (t >= 0 && t + 4 <= T) {
            cp_async16(dst + c, src + t);
          } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = (t + i >= 0 && t + i < T) ? src[t + i] : 0.f;
            *reinterpret_cast<float4*>(dst + c) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      } else {
        for (int c = lane; c < win; c += 32) {
          const int t = xstart + c;
          const bool in = t >= 0 && t < T;
          cp_async4(dst + c, in ? src + t : src, in ? 4 : 0);
        }
      }
    }
    constexpr int kQ = KC / 4;  // 16-byte pieces per weight row
    float* wd = wbuf + s * k * kGroup * kWs;
    for (int i = tid; i < k * kGroup * kQ; i += kThreads) {
      const int row = i / kQ, q = i % kQ;  // row = j * 64 + m
      const int j = row / kGroup, m = row % kGroup;
      cp_async16(wd + row * kWs + 4 * q,
                 w1k + (static_cast<size_t>(j) * C + co0 + m) * C + ci0 +
                     4 * q);
    }
    cp_async_commit();
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n1 = C / KC;
  stage1(0, 0);
  for (int chunk = 0; chunk < n1; ++chunk) {
    const int s = chunk & 1;
    if (chunk + 1 < n1) {
      stage1(chunk + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xd = xbuf + s * KC * xs_stride + xshift + wt;
    const float* wd = wbuf + s * k * kGroup * kWs + wm * 32 * kWs;
    // (tap, k8 step) pairs of the chunk, alternately to the two groups
    for (int p = grp; p < k * (KC / 8); p += 2) {
      const int j = p / (KC / 8), kk = p % (KC / 8);
      mma_k8<true>(acc, wd + j * kGroup * kWs + kk * 8, kWs,
                   xd + kk * 8 * xs_stride + j * dilation, xs_stride, gid,
                   tig);
    }
    __syncthreads();
  }

  // hidden tile = lrelu(group 0 + group 1 + b1)
  reduce_groups(acc, hs, grp, wm, wt, gid, tig, b1 + co0, true);

  // ---- GEMM 2: y = W2-rows . hidden of the whole cluster ----
  auto stage_w2 = [&](int chunk, int s) {
    float* wd = w2buf + s * kGroup * kWs2;
    for (int i = tid; i < kGroup * (kKC2 / 4); i += kThreads) {
      const int m = i / (kKC2 / 4), q = i % (kKC2 / 4);
      cp_async16(wd + m * kWs2 + 4 * q,
                 w2 + static_cast<size_t>(co0 + m) * C + chunk * kKC2 +
                     4 * q);
    }
    cp_async_commit();
  };
  // 32 hidden rows of a peer = 512 float4, 4 per thread
  constexpr int kH4 = kKC2 * (kTile / 4) / kThreads;
  float4 hreg[kH4];
  auto load_h = [&](int chunk) {
    const float* peer = cluster.map_shared_rank(hs, (chunk * kKC2) / kGroup);
    const float* src = peer + ((chunk * kKC2) % kGroup) * kHs;
#pragma unroll
    for (int u = 0; u < kH4; ++u) {
      const int i = tid + u * kThreads;
      hreg[u] = *reinterpret_cast<const float4*>(src + (i >> 4) * kHs +
                                                 4 * (i & 15));
    }
  };
  auto store_h = [&](int s) {
    float* dst = hbuf + s * kKC2 * kHs;
#pragma unroll
    for (int u = 0; u < kH4; ++u) {
      const int i = tid + u * kThreads;
      *reinterpret_cast<float4*>(dst + (i >> 4) * kHs + 4 * (i & 15)) =
          hreg[u];
    }
  };

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n2 = C / kKC2;
  stage_w2(0, 0);
  cluster.sync();  // every hidden tile of the cluster is written
  load_h(0);
  store_h(0);
  for (int chunk = 0; chunk < n2; ++chunk) {
    const int s = chunk & 1;
    const bool more = chunk + 1 < n2;
    if (more) {
      stage_w2(chunk + 1, s ^ 1);
      load_h(chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* hd = hbuf + s * kKC2 * kHs + wt;
    const float* wd = w2buf + s * kGroup * kWs2 + wm * 32 * kWs2;
#pragma unroll
    for (int kk = grp; kk < kKC2 / 8; kk += 2)
      mma_k8<false>(acc, wd + kk * 8, kWs2, hd + kk * 8 * kHs, kHs, gid,
                    tig);
    if (more) store_h(s ^ 1);
    __syncthreads();
  }

  // ---- epilogue: out = x + (acc + b2), stored along time ----
  float* ot = region;  // [64][kHs]
  reduce_groups(acc, ot, grp, wm, wt, gid, tig, b2 + co0, false);
  __syncthreads();
  for (int m = warp; m < kGroup; m += kWarps) {
    const size_t row = static_cast<size_t>(b) * C * T +
                       static_cast<size_t>(co0 + m) * T;
#pragma unroll
    for (int c = lane; c < kTile; c += 32) {
      const int t = t0 + c;
      if (t < T) out[row + t] = x[row + t] + ot[m * kHs + c];
    }
  }
  cluster.sync();  // peers have finished reading this CTA's hidden tile
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <auto Kernel>
cudaError_t max_smem_once() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The time tiles go on grid.x, which takes up to 2^31 - 1 blocks, so any
// int T fits; grid.y (the channel groups, one cluster) and grid.z (batch
// rows) take up to 65535.
struct Plan {
  int kc;          // input channels per GEMM-1 chunk; 0: nothing fits
  size_t smem;     // dynamic shared memory, bytes
  dim3 grid;       // (ceil(T / 64), C / 64, B)
  int cluster;     // C / 64, along grid.y
};

Plan plan_for(int B, int C, int T, int k, int dilation) {
  Plan p{0, 0, dim3((T + kTile - 1) / kTile, (C + kGroup - 1) / kGroup, B),
         (C + kGroup - 1) / kGroup};
  for (int kc : {32, 16, 8}) {
    const size_t bytes = sizeof(float) * smem_floats(kc, k, dilation);
    if (bytes <= static_cast<size_t>(kMaxSmem)) {
      p.kc = kc;
      p.smem = bytes;
      break;
    }
  }
  return p;
}

template <int KC>
cudaError_t launch(const Plan& p, const float* x, const float* w1k,
                   const float* b1, const float* w2, const float* b2,
                   float* out, int C, int T, int k, int dilation,
                   int pad_left, cudaStream_t stream) {
  cudaError_t err = max_smem_once<residual_unit_kernel<KC>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, residual_unit_kernel<KC>, x, w1k, b1, w2,
                           b2, out, C, T, k, dilation, pad_left);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16 instance
// ---------------------------------------------------------------------

constexpr float kNegSlopeBf16 = 0.2001953125f;  // 0.2 rounded to bf16
constexpr int kHsB = kTile + 8;   // row stride (bf16) of the hidden tile
constexpr int kWs2B = kKC2 + 8;   // row stride (bf16) of a W2 chunk

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's 32 x (8 kNT) product over 16 of K, bf16 operands: A
// (channels x K, K contiguous) from `a` with row stride `as`, B (K x time,
// time contiguous) from `bm` with row stride `bs`; the B fragment pairs
// two rows of K into one register.
__device__ __forceinline__ void mma_k16(float (*acc)[kNT][4],
                                        const uint16_t* a, int as,
                                        const uint16_t* bm, int bs, int gid,
                                        int tig) {
  uint32_t af[2][4], bf[kNT][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint16_t* p = a + (mt * 16 + gid) * as + 2 * tig;
    af[mt][0] = ld32(p);
    af[mt][1] = ld32(p + 8 * as);
    af[mt][2] = ld32(p + 8);
    af[mt][3] = ld32(p + 8 * as + 8);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const uint16_t* p = bm + 2 * tig * bs + nt * 8 + gid;
    bf[nt][0] = pack2(p[0], p[bs]);
    bf[nt][1] = pack2(p[8 * bs], p[9 * bs]);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt]);
}

// Window row stride (bf16 values): the least S >= W + 14 (the window, up
// to 7 values of alignment shift and the round-up to a 16-byte piece)
// with S = 8 (mod 64), so that a B fragment's rows 2*tig fall in
// distinct 4-bank groups.
__host__ __device__ inline int window_stride_bf16(int k, int dilation) {
  const int w = kTile + (k - 1) * dilation + 14;
  return ((w + 55) / 64) * 64 + 8;
}

// Bytes of dynamic shared memory: the bf16 hidden tile, then the largest
// of GEMM 1's double buffers, GEMM 2's, and the float32 tile that the
// group reduction and the epilogue stage.
__host__ __device__ inline int smem_bytes_bf16(int kc, int k, int dilation) {
  const int g1 = 2 * (2 * kc * window_stride_bf16(k, dilation) +
                      2 * k * kGroup * (kc + 8));
  const int g2 = 2 * (2 * kKC2 * kHsB + 2 * kGroup * kWs2B);
  const int f = 4 * kGroup * kHs;
  const int r = g1 > g2 ? g1 : g2;
  return 2 * kGroup * kHsB + (r > f ? r : f);
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
    residual_unit_bf16_kernel(const uint16_t* __restrict__ x,
                              const uint16_t* __restrict__ w1k,
                              const uint16_t* __restrict__ b1,
                              const uint16_t* __restrict__ w2,
                              const uint16_t* __restrict__ b2,
                              uint16_t* __restrict__ out, int C, int T,
                              int k, int dilation, int pad_left) {
  constexpr int kWsB = KC + 8;  // W1 chunk row stride (bf16)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();

  const int win = kTile + (k - 1) * dilation;
  const int xs = window_stride_bf16(k, dilation);
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem_raw);  // [64][kHsB]
  unsigned char* region = smem_raw + 2 * kGroup * kHsB;
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(region);  // [2][KC][xs]
  uint16_t* wbuf = xbuf + 2 * KC * xs;                   // [2][k][64][kWsB]
  uint16_t* hbuf = reinterpret_cast<uint16_t*>(region);  // [2][32][kHsB]
  uint16_t* w2buf = hbuf + 2 * kKC2 * kHsB;              // [2][64][kWs2B]
  float* ftile = reinterpret_cast<float*>(region);       // [64][kHs]

  const int group = static_cast<int>(cluster.block_rank());
  const int co0 = group * kGroup;
  const int t0 = blockIdx.x * kTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int grp = warp >> 2;
  const int wm = (warp >> 1) & 1, wn = warp & 1;
  const int wt = wn * kNT * 8;
  const uint16_t* xb = x + static_cast<size_t>(b) * C * T;

  // ---- GEMM 1 ----
  const bool xvec =
      T % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int xshift = xvec ? ((t0 - pad_left) & 7) : 0;
  const int xstart = t0 - pad_left - xshift;
  const int wcols = xshift + win;  // staged values of a window row
  auto stage1 = [&](int chunk, int s) {
    const int ci0 = chunk * KC;
    uint16_t* xd = xbuf + s * KC * xs;
    for (int r = warp; r < KC; r += kWarps) {
      const uint16_t* src = xb + static_cast<size_t>(ci0 + r) * T;
      uint16_t* dst = xd + r * xs;
      if (xvec) {
        for (int c = 8 * lane; c < wcols; c += 256) {
          const int t = xstart + c;
          if (t >= 0 && t + 8 <= T) {
            cp_async16(dst + c, src + t);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              dst[c + i] = (t + i >= 0 && t + i < T) ? src[t + i] : 0;
          }
        }
      } else {
        for (int c = lane; c < win; c += 32) {
          const int t = xstart + c;
          dst[c] = (t >= 0 && t < T) ? src[t] : 0;
        }
      }
    }
    constexpr int kQ = KC / 8;  // 16-byte pieces per weight row
    uint16_t* wd = wbuf + s * k * kGroup * kWsB;
    for (int i = tid; i < k * kGroup * kQ; i += kThreads) {
      const int row = i / kQ, q = i % kQ;  // row = j * 64 + m
      const int j = row / kGroup, m = row % kGroup;
      cp_async16(wd + row * kWsB + 8 * q,
                 w1k + (static_cast<size_t>(j) * C + co0 + m) * C + ci0 +
                     8 * q);
    }
    cp_async_commit();
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n1 = C / KC;
  stage1(0, 0);
  for (int chunk = 0; chunk < n1; ++chunk) {
    const int s = chunk & 1;
    if (chunk + 1 < n1) {
      stage1(chunk + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // lrelu of the staged window, in place, rounded to bf16
    uint16_t* xw = xbuf + s * KC * xs;
    for (int i = tid; i < KC * wcols; i += kThreads) {
      uint16_t* p = xw + (i / wcols) * xs + i % wcols;
      const float v = to_f32(*p);
      if (v < 0.f) *p = f2bf(kNegSlopeBf16 * v);
    }
    __syncthreads();
    const uint16_t* xd = xw + xshift + wt;
    const uint16_t* wd = wbuf + s * k * kGroup * kWsB + wm * 32 * kWsB;
    for (int p = grp; p < k * (KC / 16); p += 2) {
      const int j = p / (KC / 16), kk = p % (KC / 16);
      mma_k16(acc, wd + j * kGroup * kWsB + kk * 16, kWsB,
              xd + kk * 16 * xs + j * dilation, xs, gid, tig);
    }
    __syncthreads();
  }

  // hidden tile = bf16(lrelu(group 0 + group 1 + b1)): summed in float32
  // in the staging tile, then rounded once
  reduce_groups(acc, ftile, grp, wm, wt, gid, tig, b1 + co0, true);
  __syncthreads();
  for (int i = tid; i < kGroup * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    hs[r * kHsB + c] = f2bf(ftile[r * kHs + c]);
  }
  __syncthreads();

  // ---- GEMM 2 ----
  auto stage_w2 = [&](int chunk, int s) {
    uint16_t* wd = w2buf + s * kGroup * kWs2B;
    for (int i = tid; i < kGroup * (kKC2 / 8); i += kThreads) {
      const int m = i / (kKC2 / 8), q = i % (kKC2 / 8);
      cp_async16(wd + m * kWs2B + 8 * q,
                 w2 + static_cast<size_t>(co0 + m) * C + chunk * kKC2 +
                     8 * q);
    }
    cp_async_commit();
  };
  // 32 hidden rows of a peer = 256 pieces of 16 bytes, one per thread
  uint4 hreg;
  auto load_h = [&](int chunk) {
    const uint16_t* peer =
        cluster.map_shared_rank(hs, (chunk * kKC2) / kGroup);
    const uint16_t* src = peer + ((chunk * kKC2) % kGroup) * kHsB;
    hreg = *reinterpret_cast<const uint4*>(src + (tid >> 3) * kHsB +
                                           8 * (tid & 7));
  };
  auto store_h = [&](int s) {
    uint16_t* dst = hbuf + s * kKC2 * kHsB;
    *reinterpret_cast<uint4*>(dst + (tid >> 3) * kHsB + 8 * (tid & 7)) =
        hreg;
  };

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n2 = C / kKC2;
  stage_w2(0, 0);
  cluster.sync();  // every hidden tile of the cluster is written
  load_h(0);
  store_h(0);
  for (int chunk = 0; chunk < n2; ++chunk) {
    const int s = chunk & 1;
    const bool more = chunk + 1 < n2;
    if (more) {
      stage_w2(chunk + 1, s ^ 1);
      load_h(chunk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* hd = hbuf + s * kKC2 * kHsB + wt;
    const uint16_t* wd = w2buf + s * kGroup * kWs2B + wm * 32 * kWs2B;
    // kKC2 / 16 = 2 steps: one per group
    mma_k16(acc, wd + grp * 16, kWs2B, hd + grp * 16 * kHsB, kHsB, gid,
            tig);
    if (more) store_h(s ^ 1);
    __syncthreads();
  }

  // ---- epilogue: out = bf16(x + (acc + b2)), stored along time ----
  reduce_groups(acc, ftile, grp, wm, wt, gid, tig, b2 + co0, false);
  __syncthreads();
  for (int m = warp; m < kGroup; m += kWarps) {
    const size_t row = static_cast<size_t>(b) * C * T +
                       static_cast<size_t>(co0 + m) * T;
#pragma unroll
    for (int c = lane; c < kTile; c += 32) {
      const int t = t0 + c;
      if (t < T) out[row + t] = f2bf(to_f32(x[row + t]) + ftile[m * kHs + c]);
    }
  }
  cluster.sync();  // peers have finished reading this CTA's hidden tile
}

Plan plan_for_bf16(int B, int C, int T, int k, int dilation) {
  Plan p{0, 0, dim3((T + kTile - 1) / kTile, (C + kGroup - 1) / kGroup, B),
         (C + kGroup - 1) / kGroup};
  for (int kc : {32, 16}) {
    const size_t bytes = smem_bytes_bf16(kc, k, dilation);
    if (bytes <= static_cast<size_t>(kMaxSmem)) {
      p.kc = kc;
      p.smem = bytes;
      break;
    }
  }
  return p;
}

template <int KC>
cudaError_t launch_bf16(const Plan& p, const uint16_t* x,
                        const uint16_t* w1k, const uint16_t* b1,
                        const uint16_t* w2, const uint16_t* b2,
                        uint16_t* out, int C, int T, int k, int dilation,
                        int pad_left, cudaStream_t stream) {
  cudaError_t err = max_smem_once<residual_unit_bf16_kernel<KC>>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = p.grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, residual_unit_bf16_kernel<KC>, x, w1k, b1,
                           w2, b2, out, C, T, k, dilation, pad_left);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch.  The caller
// guarantees contiguous float32 tensors, C % 64 == 0, C <= 512 (a cluster
// of at most 8), pad_left <= (k - 1) * dilation and 16-byte aligned
// weights.  A window too wide for chunks of 8 input channels returns
// cudaErrorInvalidValue.
extern "C" int residual_unit_forward(const float* x, const float* w1k,
                                     const float* b1, const float* w2,
                                     const float* b2, float* out, int B,
                                     int C, int T, int k, int dilation,
                                     int pad_left, void* stream) {
  if (C % kGroup || C > 8 * kGroup || B < 1 || T < 1 || k < 1)
    return cudaErrorInvalidValue;
  const Plan p = plan_for(B, C, T, k, dilation);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.kc) {
    case 32:
      return launch<32>(p, x, w1k, b1, w2, b2, out, C, T, k, dilation,
                        pad_left, s);
    case 16:
      return launch<16>(p, x, w1k, b1, w2, b2, out, C, T, k, dilation,
                        pad_left, s);
    case 8:
      return launch<8>(p, x, w1k, b1, w2, b2, out, C, T, k, dilation,
                       pad_left, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// What a launch at this shape uses: info = {CTAs, cluster size, threads
// per CTA, dynamic shared memory bytes, registers per thread, KC}.
extern "C" int residual_unit_launch_info(int B, int C, int T, int k,
                                         int dilation, int* info) {
  const Plan p = plan_for(B, C, T, k, dilation);
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaErrorInvalidValue;
  switch (p.kc) {
    case 32: err = cudaFuncGetAttributes(&attr, residual_unit_kernel<32>); break;
    case 16: err = cudaFuncGetAttributes(&attr, residual_unit_kernel<16>); break;
    case 8: err = cudaFuncGetAttributes(&attr, residual_unit_kernel<8>); break;
  }
  if (err != cudaSuccess) return err;
  info[0] = static_cast<int>(p.grid.x * p.grid.y * p.grid.z);
  info[1] = p.cluster;
  info[2] = kThreads;
  info[3] = static_cast<int>(p.smem);
  info[4] = attr.numRegs;
  info[5] = p.kc;
  return cudaSuccess;
}

extern "C" const char* residual_unit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The bf16 instance: the same contract over bf16 tensors (bf16 bits as
// uint16_t); a window too wide for chunks of 16 input channels returns
// cudaErrorInvalidValue.
extern "C" int residual_unit_bf16_forward(const uint16_t* x,
                                          const uint16_t* w1k,
                                          const uint16_t* b1,
                                          const uint16_t* w2,
                                          const uint16_t* b2, uint16_t* out,
                                          int B, int C, int T, int k,
                                          int dilation, int pad_left,
                                          void* stream) {
  if (C % kGroup || C > 8 * kGroup || B < 1 || T < 1 || k < 1)
    return cudaErrorInvalidValue;
  const Plan p = plan_for_bf16(B, C, T, k, dilation);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.kc) {
    case 32:
      return launch_bf16<32>(p, x, w1k, b1, w2, b2, out, C, T, k, dilation,
                             pad_left, s);
    case 16:
      return launch_bf16<16>(p, x, w1k, b1, w2, b2, out, C, T, k, dilation,
                             pad_left, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// residual_unit_launch_info for the bf16 instance.
extern "C" int residual_unit_bf16_launch_info(int B, int C, int T, int k,
                                              int dilation, int* info) {
  const Plan p = plan_for_bf16(B, C, T, k, dilation);
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaErrorInvalidValue;
  switch (p.kc) {
    case 32:
      err = cudaFuncGetAttributes(&attr, residual_unit_bf16_kernel<32>);
      break;
    case 16:
      err = cudaFuncGetAttributes(&attr, residual_unit_bf16_kernel<16>);
      break;
  }
  if (err != cudaSuccess) return err;
  info[0] = static_cast<int>(p.grid.x * p.grid.y * p.grid.z);
  info[1] = p.cluster;
  info[2] = kThreads;
  info[3] = static_cast<int>(p.smem);
  info[4] = attr.numRegs;
  info[5] = p.kc;
  return cudaSuccess;
}
