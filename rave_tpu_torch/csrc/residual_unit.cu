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
// residual x in float32, ONE rounding at the output.
//
// What bounds it: 2*B*T*C^2*(k+1) FLOPs on 989 TFLOP/s of dense bf16
// against 2*(2*B*T*C + (k+1)*C^2 + 2*C) bytes over 3.35 TB/s: at C = 512
// the arithmetic, at C = 128-256 the bytes; 22.9 us per v2 forward.  Its
// first design (the float32 one on bf16 operands: two cp.async stages, an
// in-place lrelu pass and three barriers per 32-channel chunk, B
// fragments from scalar loads, a DSMEM pull and two barriers per GEMM-2
// chunk) waited on latency: its time grew with the number of chunks, not
// with the FLOPs, 3 % of the bound.  This design:
// * One CTA still owns one batch row, 64 steps and 64 output channels,
//   the C / 64 CTAs of a time tile one cluster.  Warp 8 is the producer:
//   its lane 0 issues TMA copies into a ring of 5 slots, each slot one
//   tap j of one block of 64 input channels: the x window (64 channel
//   rows of 72 steps from t0 - pad_left + j*d rounded down to 8, zeros
//   outside the tensor) and the W1 tile (64 x 64, 128B-swizzled), each
//   completing on the slot's mbarrier; and, while GEMM 1 runs, the first
//   W2 tiles into a ring of their own.  A wide dilation costs no shared
//   memory; the k reads of x hit in L2.  GEMM 1's ring shares its memory
//   with the hidden buffer of GEMM 2 (a cluster barrier between them),
//   so that every width takes 112,896 bytes and two CTAs share an SM.
// * Warps 0-7 (two warpgroups) run wgmma.mma_async m64n64k16 with x as
//   the register operand A (64 steps x 16 channels) and the weight tile
//   as the shared-memory operand B (K-major, 128B swizzle), accumulating
//   in float32 registers.  Warpgroup g takes the k16 steps 2g and 2g+1
//   of every slot; a slot goes back to the producer (its empty mbarrier,
//   one arrival per warpgroup) once the group after it is issued; at the
//   end of each GEMM the two partial sums meet in the ring's memory,
//   past the 64 KB that the hidden buffer may take (warpgroup 0 writes
//   its hidden tile with no barrier after its reads of the sums, so the
//   two must not share bytes; they did once, and a lagging warp read
//   another's hidden values: rare wrong rows, 18-25 ulps).  A comes from ldmatrix.trans of the window's aligned 8-step blocks; a
//   tap's window starts (j*d - pad_left) mod 8 steps in, so each lane
//   takes its step from the lane that holds it (two shuffles per
//   register, none at shift 0), and lrelu runs on the packed bf16 pairs
//   (mul.rn, max): no in-place pass.
// * The hidden tile, rounded once, goes to this CTA's block of a hidden
//   buffer (C / 64 tiles, K-major, 128B-swizzled) and, once every CTA of
//   the cluster is through GEMM 1, is pushed in 16-byte DSMEM stores to
//   the same block of every peer; one more cluster barrier, then GEMM 2
//   is a local K loop over all C hidden channels (plain ldmatrix for A).
// * The epilogue reads the residual tile (a TMA copy issued first),
//   writes bf16(x + (acc + b2)) over it and stores it with one TMA store.
// * Tried and dropped (on the H100, PERF.md): a window that starts at the
//   tap itself (TMA refuses a row that starts off a 16-byte boundary: an
//   illegal instruction); each CTA loading 1/(C/64) of every window and
//   multicasting it to the cluster (a slot then waits for every CTA's
//   consumers: slower at every width, most at C = 512); 8-slot rings with
//   one CTA per SM (at C = 512 each CTA lived about half of its launch:
//   the clusters of 8 did not all find 8 free SMs at once), and 2-4-slot
//   rings beside a separate hidden buffer; one consumer warpgroup (with
//   one warp per scheduler, building a slot's A took about twice as long
//   as its products).

#include <cooperative_groups.h>
#include <cuda.h>
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
// bf16 instance: a TMA ring fed by one producer warp, wgmma with the
// operand x (or the hidden tile) in registers, the hidden tile pushed
// once to every CTA of the cluster (see the note at the head of the file)
// ---------------------------------------------------------------------

constexpr uint32_t kSlopeBf16x2 = 0x3E4D3E4Du;   // two bf16 0.2001953125
constexpr int kBT = 64;                  // time steps per CTA (wgmma M)
constexpr int kBC = 64;                  // channels per CTA and per K block
constexpr int kTileBytes = kBT * kBC * 2;   // one 64 x 64 bf16 tile
// An x window: 64 channel rows of kXW steps from a step that is a multiple
// of 8 (TMA reads the innermost dimension from 16-byte boundaries), so
// that it holds the tap's 64 steps at any shift 0-7; rows of 144 bytes
// keep ldmatrix's 8 rows in distinct banks.
constexpr int kXW = kBT + 8;
constexpr int kXBytes = kBC * kXW * 2;
constexpr int kSlotBytes = kXBytes + kTileBytes;  // x window + weight tile
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreadsBf16 = kConsumers + 32;  // and the producer warp
constexpr int kBarBytes = 256;           // room for the mbarriers

__device__ __forceinline__ uint16_t f2bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Byte offset of (row, col) in a 64 x 64 bf16 tile of 128-byte rows laid
// out as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes it (tile 1024-byte
// aligned): the 16-byte piece col / 8 of a row moves to piece
// (col / 8) ^ (row % 8).
__host__ __device__ inline uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of `parity` has completed.  A copy that never
// lands would hang the card: trap after ~10 s instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the consumer warpgroups' own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void st_shared_f32(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t map_addr(const CUtensorMap* map) {
  return reinterpret_cast<uint64_t>(map);
}

// TMA: the box of `map` at (col c0, row c1) into shared memory at dst;
// the bytes complete a transaction on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(map_addr(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store of the box at src to (col c0, row c1) of `map` (clipped at
// the tensor's edge); returns once the box has been read
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"(map_addr(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm2_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// lrelu of two packed bf16 values: max(v, bf16(0.2001953125 * v)), the
// product rounded once, as the bf16 contract has it
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t v) {
  uint32_t p, r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(p) : "r"(v), "r"(kSlopeBf16x2));
  asm("max.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(p));
  return r;
}

__device__ __forceinline__ void st_shared_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ uint16_t ld_shared_u16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u16(uint32_t a, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(a), "h"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// 16 bytes into the shared memory of CTA `rank`, at the offset of `a`
__device__ __forceinline__ void st_remote_v4(uint32_t a, uint32_t rank,
                                             uint4 v) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "st.shared::cluster.v4.u32 [ra], {%2, %3, %4, %5};\n}" ::"r"(a),
      "r"(rank), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// wgmma descriptor of a 64 x 64 bf16 tile, K-major, 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1024 bytes apart); +2 per 16 of K
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Registers that an issued wgmma reads (A) or writes (the accumulator)
// must not change until a wait covers it, and the compiler does not know
// that: these empty statements "use" them at the point given, so that
// they stay where they are until then.
__device__ __forceinline__ void keep(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ void keep(float (&acc)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc[e])::"memory");
}

// d (64 x 64 over the warpgroup, float32) += a (64 x 16, bf16 in
// registers) . B (16 x 64, bf16 in shared memory at `desc`)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// wgmma's A for warp w's 16 steps and the k16 steps kk0, kk0 + 1 (16
// channels each), from a slot's x window whose tap starts `shift` steps
// in: ldmatrix.trans
// of the aligned 8-step blocks (channel rows 16 kk + 8 (mi / 2) + r, steps
// 16 w + 8 (mi % 2), and the block at 16 w + 16), each lane then taking
// step g + shift from lane 4 ((g + shift) % 8) + t of the block it falls
// in; lrelu last.
__device__ __forceinline__ void load_a_x(uint32_t (*a)[4], uint32_t xw,
                                         int w, int kk0, int shift,
                                         int lane) {
  const int mi = lane >> 3, r = lane & 7;
  const uint32_t rows = xw + (16 * kk0 + r) * (kXW * 2) + 32 * w;
  uint32_t e[2][2];  // block 16 w + 16, channels 16 kk + (0, 8)
  // every load first, so that their latencies overlap
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    ldsm4_trans(a[kk], rows + (16 * kk + 8 * (mi >> 1)) * (kXW * 2) +
                           16 * (mi & 1));
  if (shift != 0) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm2_trans(e[kk], rows + (16 * kk + 8 * (mi & 1)) * (kXW * 2) + 32);
    const int q = (lane >> 2) + shift;
    const int src = ((q & 7) << 2) | (lane & 3);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t lo[4] = {a[kk][0], a[kk][1], a[kk][2], a[kk][3]};
      const uint32_t hi[4] = {a[kk][1], e[kk][0], a[kk][3], e[kk][1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t x = __shfl_sync(0xffffffffu, lo[i], src);
        const uint32_t y = __shfl_sync(0xffffffffu, hi[i], src);
        a[kk][i] = q < 8 ? x : y;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = lrelu_bf16x2(a[kk][i]);
}

// The tensor maps of one launch (row-major 2-D views, bf16):
struct Bf16Maps {
  CUtensorMap x;    // x as (B * C rows, T), box 64 rows x 64 steps, 128B
                    // swizzle: the residual tile
  CUtensorMap xw;   // the same, box 64 rows x kXW steps: an x window
  CUtensorMap w1;   // w1k as (k * C rows, C), box 64 x 64, 128B swizzle
  CUtensorMap w2;   // w2 as (C rows, C), likewise
  CUtensorMap out;  // out as x
};

// Shared memory, from a 1024-byte aligned base:
// * region A: GEMM 1's ring of kStages1 slots (an x window of one tap and
//   one block of 64 input channels, then the matching W1 tile); once GEMM
//   1 is done, the hidden buffer (C / 64 tiles of 64 steps x 64 channels,
//   K-major, one per CTA of the cluster) from its start, and the
//   warpgroups' partial sums from kPartOffset, past every hidden tile:
//   warpgroup 0 writes its hidden tile while its other warps may still
//   read partial sums, and the peers push theirs after barrier #0;
// * region B: GEMM 2's ring of kStages2 W2 tiles, so that W2 streams in
//   while GEMM 1 runs;
// * the residual x tile (then the output tile) and the mbarriers.
// 112,896 bytes at every width: two CTAs share an SM.
constexpr int kStages1 = 5;
constexpr int kStages2 = 2;
constexpr int kRegionA = kStages1 * kSlotBytes;  // >= 8 hidden tiles
constexpr int kPartOffset = 8 * kTileBytes;      // the partial sums
constexpr int kPartBytes = 32 * 128 * 4;  // 32 floats of 128 threads
constexpr int kSmemBf16 =
    1024 + kRegionA + kStages2 * kTileBytes + kTileBytes + kBarBytes;
static_assert(kPartOffset + kPartBytes <= kRegionA,
              "the hidden buffer, then the partial sums, fit region A");
static_assert(2 * (kSmemBf16 + 1024) <= 233472, "two CTAs fit on an SM");

// One CTA: batch row blockIdx.z, time steps [64 blockIdx.x, +64), output
// channels [64 r, +64) for its rank r in the cluster of C / 64 CTAs that
// share the time tile.  Warps 0-7 (two warpgroups) compute, warp 8
// copies.  Warpgroup g takes the k16 steps 2 g, 2 g + 1 (32 of the 64
// input channels) of every slot into an accumulator of its own; the two
// sums meet in region A at the end of each GEMM.
__global__ void __launch_bounds__(kThreadsBf16, 2)
    residual_unit_bf16_wgmma_kernel(const __grid_constant__ Bf16Maps maps,
                                    const uint16_t* __restrict__ b1,
                                    const uint16_t* __restrict__ b2, int C,
                                    int k, int dilation, int pad_left) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring1 = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t hid = ring1;  // region A, after barrier #0
  const uint32_t ring2 = ring1 + kRegionA;
  const uint32_t xres = ring2 + kStages2 * kTileBytes;
  const uint32_t bars = xres + kTileBytes;
  auto full1 = [&](int s) { return bars + 8 * s; };
  auto empty1 = [&](int s) { return bars + 8 * (kStages1 + s); };
  auto full2 = [&](int s) { return bars + 8 * (2 * kStages1 + s); };
  auto empty2 = [&](int s) {
    return bars + 8 * (2 * kStages1 + kStages2 + s);
  };
  const uint32_t xbar = bars + 16 * (kStages1 + kStages2);

  const int nblk = C / kBC;
  const int rank = static_cast<int>(cluster_rank());
  const int co0 = rank * kBC;
  const int t0 = blockIdx.x * kBT;
  const int row0 = blockIdx.z * C;  // x's first row of this batch item
  const int n1 = nblk * k, n2 = nblk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(full1(s), 1);
      mbar_init(empty1(s), 2);  // one arrival per warpgroup
    }
    for (int s = 0; s < kStages2; ++s) {
      mbar_init(full2(s), 1);
      mbar_init(empty2(s), 2);
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer warp: the warp waits together, lane 0 issues the
    // copies (a lane left alone in a loop while its warp waits at a
    // cluster barrier runs only when the barrier lets the warp go) ----
    if (lane == 0) {
      mbar_expect_tx(xbar, kTileBytes);
      tma_load(xres, &maps.x, xbar, t0, row0 + co0);
    }
    // GEMM 1: slot u = (block cb of input channels, tap j)
    for (int u = 0; u < n1; ++u) {
      const int s = u % kStages1, q = u / kStages1;
      if (q > 0) mbar_wait(empty1(s), (q - 1) & 1);
      if (lane == 0) {
        const uint32_t xs = ring1 + s * kSlotBytes;
        const int cb = u / k, j = u % k;
        // the window from the tap's first step rounded down to 8 (two's
        // complement: also below 0, where the copy reads zeros)
        const int t = (t0 - pad_left + j * dilation) & ~7;
        mbar_expect_tx(full1(s), kSlotBytes);
        tma_load(xs, &maps.xw, full1(s), t, row0 + cb * kBC);
        tma_load(xs + kXBytes, &maps.w1, full1(s), cb * kBC, j * C + co0);
      }
      __syncwarp();
    }
    // GEMM 2: slot v = W2 tile of hidden channels [64 v, +64); the first
    // uses of the ring now, the rest once the consumers release them
    auto load2 = [&](int v) {
      const int s = v % kStages2, q = v / kStages2;
      if (q > 0) mbar_wait(empty2(s), (q - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full2(s), kTileBytes);
        tma_load(ring2 + s * kTileBytes, &maps.w2, full2(s), v * kBC, co0);
      }
      __syncwarp();
    };
    int v = 0;
    for (; v < n2 && v < kStages2; ++v) load2(v);
    cluster_arrive();  // #0
    cluster_wait();
    cluster_arrive();  // #1
    for (; v < n2; ++v) load2(v);
    cluster_wait();
    return;
  }

  // ---- consumer warpgroups: warpgroup g, warp w of it owns time steps
  // [16 w, +16) ----
  const int g = warp >> 2, w = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int mi = lane >> 3, r = lane & 7;   // ldmatrix: matrix, row
  // a partial sum: value e at part + 512 e, clear of every hidden tile
  const uint32_t part = ring1 + kPartOffset + 4 * (tid & 127);
  // acc += warpgroup 1's partial sum: it writes, warpgroup 0 reads
  auto add_partial = [&](float* acc) {
    if (g == 1) {
#pragma unroll
      for (int e = 0; e < 32; ++e) st_shared_f32(part + 512 * e, acc[e]);
    }
    consumers_sync();
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += ld_shared_f32(part + 512 * e);
    }
  };

  // GEMM 1: acc[t][co] = sum over slots of lrelu(x window)^T . W1
  // tile^T.  The window holds 64 channel rows of steps: A (steps x
  // channels) is its transpose, read with ldmatrix.trans and shifted to
  // the tap's first step; lrelu is applied in registers.  Two sets of A
  // registers in turn: a slot's set is written while the previous slot's
  // products still read the other one.
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  uint32_t a0[2][4], a1[2][4];
  auto slot1 = [&](int u, uint32_t (&a)[2][4], uint32_t (&prev)[2][4]) {
    const int s = u % kStages1;
    mbar_wait(full1(s), (u / kStages1) & 1);
    const uint32_t xs = ring1 + s * kSlotBytes;
    const int shift = ((u % k) * dilation - pad_left) & 7;  // t0 % 8 == 0
    load_a_x(a, xs, w, 2 * g, shift, lane);
    keep(acc);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wgmma_m64n64k16(acc, a[i],
                      sw128_desc(xs + kXBytes) + 2 * (2 * g + i));
    wg_commit();
    keep(acc);
    if (u > 0) {
      wg_wait<1>();  // the previous slot's products are done
      keep(prev);
      if ((tid & 127) == 0) mbar_arrive(empty1((u - 1) % kStages1));
    }
  };
  for (int u = 0; u < n1; u += 2) {
    slot1(u, a0, a1);
    if (u + 1 < n1) slot1(u + 1, a1, a0);
  }
  wg_wait<0>();
  keep(acc);
  keep(a0);
  keep(a1);
  // every copy into region A has landed and been read: the partial sums
  // and the hidden buffer take it over
  consumers_sync();
  add_partial(acc);

  // hidden = bf16(lrelu(acc + b1)), rounded once, into this CTA's tile of
  // the hidden buffer: row t, column = hidden channel; the accumulator
  // holds rows 16 w + gid (+8), columns 8 i + 2 tig (+1)
  const uint32_t own = hid + rank * kTileBytes;
  if (g == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * tig;
      const float bb0 = to_f32(b1[co0 + c]), bb1 = to_f32(b1[co0 + c + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = lrelu(acc[4 * i + 2 * h] + bb0);
        const float v1 = lrelu(acc[4 * i + 2 * h + 1] + bb1);
        st_shared_u32(own + sw128(16 * w + gid + 8 * h, c),
                      static_cast<uint32_t>(f2bf(v0)) |
                          (static_cast<uint32_t>(f2bf(v1)) << 16));
      }
    }
  }
  consumers_sync();
  cluster_arrive();  // #0: this CTA's region A is free for its peers
  cluster_wait();
  // push the tile to the same place in every peer's hidden buffer
  for (int i = tid; i < kTileBytes / 16; i += kConsumers) {
    const uint4 v = ld_shared_v4(own + 16 * i);
    for (int p = 0; p < nblk; ++p)
      if (p != rank) st_remote_v4(own + 16 * i, p, v);
  }
  cluster_arrive();  // #1: the whole hidden buffer is in place
  cluster_wait();

  // GEMM 2: acc[t][co] = sum over blocks v of hidden tile v . W2 tile^T;
  // the hidden tiles are K-major (plain ldmatrix)
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  auto slot2 = [&](int v, uint32_t (&a)[2][4], uint32_t (&prev)[2][4]) {
    const int s = v % kStages2;
    mbar_wait(full2(s), (v / kStages2) & 1);
    const uint32_t hs = hid + v * kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // matrix mi: steps 16 w + 8 (mi % 2) + r, channels 16 kk + 8 (mi / 2)
      const int row = 16 * w + 8 * (mi & 1) + r;
      ldsm4(a[i], hs + sw128(row, 16 * (2 * g + i) + 8 * (mi >> 1)));
    }
    keep(acc);
    wg_fence();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wgmma_m64n64k16(acc, a[i],
                      sw128_desc(ring2 + s * kTileBytes) + 2 * (2 * g + i));
    wg_commit();
    keep(acc);
    if (v > 0) {
      wg_wait<1>();
      keep(prev);
      if ((tid & 127) == 0) mbar_arrive(empty2((v - 1) % kStages2));
    }
  };
  for (int v = 0; v < n2; v += 2) {
    slot2(v, a0, a1);
    if (v + 1 < n2) slot2(v + 1, a1, a0);
  }
  wg_wait<0>();
  keep(acc);
  keep(a0);
  keep(a1);
  consumers_sync();  // the hidden buffer is read: region A is free again
  add_partial(acc);

  // out = bf16(x + (acc + b2)), rounded once, staged over the residual
  // tile (rows = channels), then one TMA store
  if (g == 0) {
    mbar_wait(xbar, 0);
    uint16_t xv[32];  // every residual value first, then every store
#pragma unroll
    for (int e = 0; e < 32; ++e)
      xv[e] = ld_shared_u16(
          xres + sw128(8 * (e >> 2) + 2 * tig + (e & 1),
                       16 * w + gid + 8 * ((e >> 1) & 1)));
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = 8 * (e >> 2) + 2 * tig + (e & 1);
      st_shared_u16(xres + sw128(c, 16 * w + gid + 8 * ((e >> 1) & 1)),
                    f2bf(to_f32(xv[e]) + (acc[e] + to_f32(b2[co0 + c]))));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  consumers_sync();
  if (tid == 0) tma_store(&maps.out, xres, t0, row0 + co0);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that the library links without -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a row-major bf16 matrix (rows x cols, row stride ld
// values): boxes of box_rows x box_cols, zeros outside; 64-column boxes
// 128B-swizzled (wgmma's operand layout), wider ones (x windows) plain.
bool encode_map(EncodeTiled enc, CUtensorMap* map, const void* p,
                uint64_t rows, uint64_t cols, uint64_t ld, uint32_t box_rows,
                uint32_t box_cols = 64) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_bf16(const Bf16Maps& maps, const uint16_t* b1,
                        const uint16_t* b2, int B, int C, int T, int k,
                        int dilation, int pad_left, cudaStream_t stream) {
  cudaError_t err = max_smem_once<residual_unit_bf16_wgmma_kernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + kBT - 1) / kBT, C / kBC, B);
  cfg.blockDim = dim3(kThreadsBf16);
  cfg.dynamicSmemBytes = kSmemBf16;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C / kBC;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, residual_unit_bf16_wgmma_kernel, maps, b1,
                           b2, C, k, dilation, pad_left);
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
// uint16_t).  TMA needs 16-byte row strides and bases: the caller pads T
// to a multiple of 8 with zeros (they only extend the unit's zero
// padding) and passes 16-byte aligned tensors; anything else returns
// cudaErrorInvalidValue.
extern "C" int residual_unit_bf16_forward(const uint16_t* x,
                                          const uint16_t* w1k,
                                          const uint16_t* b1,
                                          const uint16_t* w2,
                                          const uint16_t* b2, uint16_t* out,
                                          int B, int C, int T, int k,
                                          int dilation, int pad_left,
                                          void* stream) {
  if (C % kBC || C > 8 * kBC || B < 1 || T < 1 || k < 1 || T % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1k) |
       reinterpret_cast<uintptr_t>(w2) | reinterpret_cast<uintptr_t>(out)) &
          15)
    return cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  Bf16Maps maps;
  const uint64_t rows = static_cast<uint64_t>(B) * C;
  if (!encode_map(enc, &maps.x, x, rows, T, T, kBC) ||
      !encode_map(enc, &maps.xw, x, rows, T, T, kBC, kXW) ||
      !encode_map(enc, &maps.w1, w1k, static_cast<uint64_t>(k) * C, C, C,
                  kBC) ||
      !encode_map(enc, &maps.w2, w2, C, C, C, kBC) ||
      !encode_map(enc, &maps.out, out, rows, T, T, kBC))
    return cudaErrorInvalidValue;
  return launch_bf16(maps, b1, b2, B, C, T, k, dilation, pad_left,
                     static_cast<cudaStream_t>(stream));
}

// What a bf16 launch at this shape uses: info = {CTAs, cluster size,
// threads per CTA, dynamic shared memory bytes, registers per thread,
// ring slots}.  A wide dilation costs no shared memory: each tap is a box
// of its own.
extern "C" int residual_unit_bf16_launch_info(int B, int C, int T, int k,
                                              int dilation, int* info) {
  (void)k;
  (void)dilation;
  cudaFuncAttributes attr = {};
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, residual_unit_bf16_wgmma_kernel);
  if (err != cudaSuccess) return err;
  info[0] = ((T + kBT - 1) / kBT) * (C / kBC) * B;
  info[1] = C / kBC;
  info[2] = kThreadsBf16;
  info[3] = kSmemBf16;
  info[4] = attr.numRegs;
  info[5] = kStages1;
  return cudaSuccess;
}
