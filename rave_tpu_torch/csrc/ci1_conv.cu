// Same-length 1-D convolution with one input channel (kernels B2 and B3)
// for Hopper, on float32 or bf16 operands: the MelGAN discriminator's
// head conv (k = 15, 1 -> 16).
//
// Replaces the Pallas TPU kernels of rave_tpu/ops/pallas/ci1_conv.py:
//   B2 `_fwd_kernel` (forward), launched by `ci1_conv_forward` (float32)
//   and `ci1_conv_forward_bf16`:
//     out[b, c, t] = sum_j x[b, t + j - pad_left] * w[c, j]
//   B3 `_dx_kernel` (data gradient), launched by `ci1_conv_dx` (float32)
//   and `ci1_conv_dx_bf16`:
//     dx[b, t] = sum_c sum_o g[b, c, t - pad_right + o] * w[c, k - 1 - o]
// with zeros outside [0, T), pad_left + pad_right = k - 1, k <= 16 taps
// and co <= 64 output channels.  Layouts are the port's channels-first
// ones: x and dx (B, T), g and out (B, co, T), w (co, k).
//
// Every instance keeps the Pallas kernels' contract, which is generic in
// the dtype: the operands are staged in their own dtype, every tap and
// weight is widened to float32 (a bf16 product is exact in float32), the
// sums are float32, and the result is rounded once into the operands'
// dtype (bf16: __float2bfloat16_rn at the store).
//
// What bounds them: at the main path's (B, T, co, k) = (16, 91232, 16, 15)
// each does 2*B*T*co*k = 0.70 GFLOP against 4*B*T*(1 + co) = 99 MB of
// device memory traffic (bf16: 50 MB): 30 us (bf16: 15 us) of HBM
// against 10 us of f32 FMA, so all are bound by bytes.  Each design is
// one pass over the big operand (out for B2, g for B3), with the small
// one and the taps on chip.
//
// B2, both dtypes, and float32 B3:
// * a block owns one batch row and a tile of time steps, and stages the
//   tile plus its k - 1 halo (B2: of x, widened to float32; B3: of the
//   co rows of g, 16 rows at a time) and the taps (float32) in shared
//   memory, zero outside [0, T);
// * B2: each thread forms kR = 4 consecutive time steps from a register
//   window read with 16-byte shared loads, the taps read as broadcasts,
//   and writes, for each channel, 4 consecutive values (one 16-byte store
//   in float32, one 8-byte store of two bf16 pairs in bf16, where
//   T % 4 == 0), so a warp stores a contiguous run of a channel row;
// * B3 stages with 16-byte copies and no division per element: warp w
//   takes channel rows w, w + 4, ..., lane l the 16-byte pieces l, l + 32,
//   ... of a row (4 float32 values), by cp.async where a piece lies
//   inside [0, T); the few pieces at the ragged ends are assembled with
//   zeros.  Where the window starts off a 16-byte boundary (T not a
//   multiple of the piece, or the pad), the row is staged from the
//   aligned piece before it and the compute reads it `shift` values in
//   (0-3), a template instance per shift.  Each thread sums the co * k
//   products of kDxR = 8 consecutive steps in registers (each reversed
//   tap read from shared memory serves 8 products) and writes them once.
//   Plain f32 FMAs, no tensor cores.
//
// B3-bf16 (ci1_dx_bf16_mma_kernel) is a design of its own.  The float32
// design on bf16 operands issued ~2.6k instructions per warp (16-byte
// loads, bf16 -> f32 widenings, 120 FMAs per channel row), about as many
// cycles as its byte bound, and staged a block's rows before summing
// them: it ran well under half of the bound.  Here the products go to
// the tensor cores, and each warp's next copy is in flight while it
// sums:
// * Tensor cores with one input channel.  Outputs come in blocks of 8,
//   u = 8m + r.  Output block m of a 128-step tile reads the same 32
//   values of every channel row: staged pieces m .. m + 3 (a piece is 8
//   values, 16 bytes).  So the tile is a product: A[m, (c, j)] =
//   staged_c[8m + j] (16 blocks x 32 per channel) times the banded tap
//   matrix Wt_c[j, r] = w[c, k - 1 - (j - S_c - r)] where 0 <= j - S_c -
//   r < k, else 0.  S_c (0-7) is where the row's window starts in its
//   staged row.  A is a Hankel view: row m of K-half h is piece m + 2h
//   (and + 1), so ldmatrix.x4 reads its four 8 x 8 matrices straight
//   from consecutive pieces, 128 contiguous bytes each, free of bank
//   conflicts.  A warp's tile is one mma.sync.m16n8k16 (bf16 -> f32) per
//   channel and K-half: 32 MMAs and 32 ldmatrix.x4 per 128 outputs at
//   co = 16, against ~1.3k instructions before.  The ldmatrix of four
//   channels go out before their products, into four accumulator
//   chains.  Each lane builds its B fragments (64 registers at 16
//   channels) from a zero-padded table of reversed taps in shared
//   memory, once per batch row and group of 16 channels (per tile where
//   co > 16).  Every K-half is a whole m16n8k16, also where a row's band
//   ends inside three pieces (S_c + k <= 17, as the main path's S = 1,
//   k = 15): one sum path for every shape.  The band's zeros double the
//   tensor-core FLOPs, which stay far under the card's rate.  A zero of
//   the band times a non-finite g gives NaN where the plain conv gives
//   +-inf; the G step's g is finite, and nothing checks for it.
// * Staging: a slot holds 16 channel rows x 152 values (19 pieces) of one
//   128-step tile, from the window start ts = t0 - pad_right rounded down
//   to a 16-byte boundary of g (S_c values before it), zeros outside
//   [0, T).  The launcher picks the mode by shape, never by failure:
//   - TMA, where T % 8 == 0 and g is 16-byte aligned: S_c = ts mod 8
//     for every row, one 3-D tensor copy (T, co, B) per slot from column
//     ts - S_c (TMA refuses an innermost start off a 16-byte boundary),
//     zero fill out of bounds (the pads, the ends, channels past co),
//     completing on the slot's mbarrier;
//   - cp.async elsewhere (T % 8 != 0, or g a view at an odd offset):
//     S_c differs by row, each lane copies 16-byte pieces of the rows
//     from the aligned piece before each row's window, the pieces that
//     straddle [0, T) assembled with zeros, one cp.async group per slot.
// * The ring: each of a CTA's 4 warps owns 2 slots and feeds them itself
//   (lane 0 issues the TMA; every lane its cp.async pieces): the one it
//   sums and the next load, in flight meanwhile.  Reuse rule: load n + 1
//   goes into the slot of load n - 1, issued only after the warp's
//   __syncwarp() that ends load n - 1's sums, whose MMAs have consumed
//   every ldmatrix of it (and a proxy fence before the TMA).  No warp
//   reads another's slots, so no CTA barrier and no producer warp are
//   needed.  The first loads go out before the tap table is read.
// * A persistent grid: SMs x 2 CTAs (47,296 bytes of shared memory
//   each), 8 warps and ~39 KB of copies in flight per SM; warp i of the
//   grid takes a contiguous 1/(4 x CTAs) share of the (batch row, tile)
//   pairs, so the small shapes end without a wave tail and B is rebuilt
//   only where a batch row starts.  Deeper rings and more warps per SM
//   (3 loads ahead, 114 KB in flight) were slower on the H100, most at
//   the small shapes: the copies all land late and the sums queue behind
//   them.  What bounds it there is the card's read rate: a PyTorch sum
//   of g over its channels, which only reads g, takes about as long at
//   the largest shape (PERF.md).
// * The epilogue writes the sums of the four chains as bf16 pairs (one
//   rounding; 4-byte stores, a warp 128 contiguous bytes), element by
//   element at a ragged end or where T is odd.
// The TPU kernels' 4096-step tiles and 128-lane halo are lane-layout
// facts of the TPU and are not carried over.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kR = 4;          // consecutive time steps per thread
constexpr int kMaxK = 16;      // taps, padded with zeros to a float4 row
constexpr int kMaxCo = 64;
constexpr int kFwdThreads = 256;
constexpr int kDxThreads = 128;
constexpr int kFwdTile = kR * kFwdThreads;
constexpr int kDxR = 8;        // B3: consecutive time steps per thread
constexpr int kDxTile = kDxR * kDxThreads;
constexpr int kDxRows = 16;    // B3: channel rows staged at once
constexpr int kDxWarps = kDxThreads / 32;
constexpr int kDxGroups = kDxRows / kDxWarps;  // cp.async groups of rows
constexpr int kMaxDevices = 64;
// staged window of a tile: the tile, the largest halo and the float4
// over-read of the last thread, a multiple of 4 floats
__host__ __device__ constexpr int window(int tile) {
  return tile + kMaxK + kR;
}

// Values of E in one 16-byte piece: 4 float32, 8 bf16.
template <typename E>
constexpr int kPer = 16 / static_cast<int>(sizeof(E));

// Float32 B3's staged row: up to 3 values of alignment shift, the tile
// and its k - 1 halo, and the over-read of the last thread's 16-byte
// loads; a whole number of 16-byte pieces.
constexpr int kDxWin = kDxTile + kMaxK + 4;

// B3-bf16 (ci1_dx_bf16_mma_kernel): a slot holds kB3Rows channel rows of
// kB3Cols staged values for one item of kB3Tile outputs (16 blocks of 8,
// one m16 tile); output block m reads pieces m .. m + 3, so a row needs
// kB3Tile / 8 + 3 pieces.  Each of a CTA's kB3Warps warps owns kB3Stages
// slots; the persistent grid holds kB3CtasPerSm CTAs on each SM.  Shared
// memory: the warps' rings, the zero-padded reversed taps
// (kB3TapCols per channel, reversed tap 0 at column kB3TapOff) and one
// mbarrier per slot, from the first 128-byte boundary of the dynamic
// shared memory (kB3Smem holds the slack).
constexpr int kB3Tile = 128;
constexpr int kB3Rows = 16;
constexpr int kB3Pieces = kB3Tile / 8 + 3;
constexpr int kB3Cols = 8 * kB3Pieces;
constexpr int kB3Warps = 4;
constexpr int kB3Threads = 32 * kB3Warps;
constexpr int kB3Stages = 2;
constexpr int kB3CtasPerSm = 2;
constexpr int kB3SlotBytes = kB3Rows * kB3Cols * 2;
constexpr int kB3TapCols = 64;
constexpr int kB3TapOff = 16;
constexpr int kB3RingBytes = kB3Warps * kB3Stages * kB3SlotBytes;
constexpr int kB3TapBytes = kMaxCo * kB3TapCols * 2;
constexpr int kB3Smem =
    128 + kB3RingBytes + kB3TapBytes + kB3Warps * kB3Stages * 8;
static_assert(kB3SlotBytes % 128 == 0, "a TMA destination is 128-byte aligned");
// the window of the last block, at the largest shift: S + 8 * 15 + 7 + k - 1
static_assert(7 + kB3Tile - 1 + kMaxK - 1 < kB3Cols, "slot too narrow");
// B's band index j - S - r + kB3TapOff stays inside a channel's taps
static_assert(kB3TapOff >= 14 && 31 + kB3TapOff < kB3TapCols, "tap table");

// (K + kR - 1) inputs feed kR outputs: loaded as kV float4s
template <int K>
struct Taps {
  static constexpr int kV = (K + kR - 1 + 3) / 4;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0-3) of the newest cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_groups(int n) {
  switch (n) {
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void load4(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// Store n = 4 or 8 consecutive sums at o (time step t of a row of T):
// float32 in 16-byte pieces, where the row's alignment allows (o's row
// starts at a multiple of T from a 16-byte aligned base); element by
// element at a ragged end.
template <int N>
__device__ __forceinline__ void store_run(float* o, const float* acc, int t,
                                          int T) {
  if ((T % 4 == 0) && (t + N <= T)) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      *reinterpret_cast<float4*>(o + 4 * q) = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (t + r < T) o[r] = acc[r];
  }
}

// bf16: 4 consecutive sums rounded once and packed in pairs, one 8-byte
// store where T % 4 == 0, bf16 pairs where T is even.
template <int N>
__device__ __forceinline__ void store_run(bf16* o, const float* acc, int t,
                                          int T) {
  static_assert(N == 4, "B2-bf16 stores runs of 4");
  if ((T % N == 0) && (t + N <= T)) {
    uint32_t words[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      words[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint2*>(o) = make_uint2(words[0], words[1]);
  } else if ((T % 2 == 0) && (t + N <= T)) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + 2 * i) =
          __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (t + r < T) o[r] = __float2bfloat16_rn(acc[r]);
  }
}

template <typename E, int K>
__global__ void __launch_bounds__(kFwdThreads)
    ci1_fwd_kernel(const E* __restrict__ x, const E* __restrict__ w,
                   E* __restrict__ out, int co, int T, int pad_left) {
  constexpr int kWin = window(kFwdTile);
  constexpr int kV = Taps<K>::kV;
  __shared__ __align__(16) float xs[kWin];
  __shared__ __align__(16) float ws[kMaxCo * kMaxK];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFwdTile;
  const E* xb = x + static_cast<size_t>(b) * T;
  for (int i = threadIdx.x; i < kWin; i += kFwdThreads) {
    const int t = t0 - pad_left + i;
    xs[i] = (t >= 0 && t < T) ? widen(xb[t]) : 0.f;
  }
  for (int i = threadIdx.x; i < co * kMaxK; i += kFwdThreads) {
    const int j = i % kMaxK;
    ws[i] = j < K ? widen(w[(i / kMaxK) * K + j]) : 0.f;
  }
  __syncthreads();

  const int u0 = threadIdx.x * kR;
  const int t = t0 + u0;
  if (t >= T) return;
  float xv[4 * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) load4(xs + u0 + 4 * q, xv + 4 * q);

  E* ob = out + static_cast<size_t>(b) * co * T + t;
  for (int c = 0; c < co; ++c) {
    float wv[kMaxK];
#pragma unroll
    for (int q = 0; q < kMaxK / 4; ++q) load4(ws + c * kMaxK + 4 * q, wv + 4 * q);
    float acc[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(xv[r + j], wv[j], acc[r]);
    store_run<kR>(ob + static_cast<size_t>(c) * T, acc, t, T);
  }
}

// Float32 B3's window of one channel row starts `shift` values into its
// shared-memory row, so that every 16-byte piece of the global row lands
// on a 16-byte word; this thread's kDxR outputs read taps o = 0..K-1 at
// window positions u0 + r + o.
template <int S, int K>
__device__ __forceinline__ void dx_row(const float* row, const float* taps,
                                       int u0, float* acc) {
  constexpr int kP = kPer<float>;
  constexpr int kV = (kDxR + K - 1 + S + kP - 1) / kP;
  float gv[kP * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) load4(row + u0 + kP * q, gv + kP * q);
  float wv[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q) load4(taps + 4 * q, wv + 4 * q);
#pragma unroll
  for (int o = 0; o < K; ++o)
#pragma unroll
    for (int r = 0; r < kDxR; ++r) acc[r] = fmaf(gv[S + r + o], wv[o], acc[r]);
}

// One row's sums at the row's shift (uniform across the block).
template <int K>
__device__ __forceinline__ void dx_row_at(int shift, const float* row,
                                          const float* taps, int u0,
                                          float* acc) {
  switch (shift) {
    case 0: dx_row<0, K>(row, taps, u0, acc); break;
    case 1: dx_row<1, K>(row, taps, u0, acc); break;
    case 2: dx_row<2, K>(row, taps, u0, acc); break;
    case 3: dx_row<3, K>(row, taps, u0, acc); break;
  }
}

// Misalignment, in values of E, of element `e` of g from a 16-byte
// boundary.
template <typename E>
__device__ __forceinline__ int misalign(const E* g, long long e) {
  return static_cast<int>(
      (static_cast<long long>(reinterpret_cast<uintptr_t>(g) / sizeof(E)) +
       e) &
      (kPer<E> - 1));
}

template <int K>
__global__ void __launch_bounds__(kDxThreads)
    ci1_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                  float* __restrict__ dx, int co, int T, int pad_right) {
  constexpr int kW = kDxTile + K - 1;  // window positions the tile reads
  constexpr int kP = kPer<float>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);          // [kDxRows][kDxWin]
  __shared__ __align__(16) float ws[kMaxCo * kMaxK];   // ws[c][o] = w[c][K-1-o]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kDxTile;
  const int ts = t0 - pad_right;  // time of window position 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < co * kMaxK; i += kDxThreads) {
    const int o = i % kMaxK;
    ws[i] = o < K ? w[(i / kMaxK) * K + K - 1 - o] : 0.f;
  }

  const int u0 = threadIdx.x * kDxR;
  const int t = t0 + u0;
  float acc[kDxR];
#pragma unroll
  for (int r = 0; r < kDxR; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < co; c0 += kDxRows) {
    const int rows = min(kDxRows, co - c0);
    if (c0 > 0) __syncthreads();  // the previous rows have been read
    // stage in kDxGroups cp.async groups of one row per warp; lane l
    // takes the 16-byte pieces l, l + 32, ... of a row; pieces inside
    // [0, T) go by cp.async, the ragged ends are assembled with zeros
#pragma unroll
    for (int grp = 0; grp < kDxGroups; ++grp) {
      const int r = grp * kDxWarps + warp;
      if (r < rows) {
        const long long base = (static_cast<long long>(b) * co + c0 + r) * T;
        const int shift = misalign(g, base + ts);
        const long long e0 = base + ts - shift;  // 16-byte aligned
        float* srow = gs + r * kDxWin;
        for (int q = lane; kP * q < shift + kW; q += 32) {
          const long long e = e0 + kP * q;
          const long long te = e - base;  // time of element e
          if (te >= 0 && te + kP <= T) {
            cp_async16(srow + kP * q, g + e);
          } else {
#pragma unroll
            for (int i = 0; i < kP; ++i)
              srow[kP * q + i] = (te + i >= 0 && te + i < T) ? g[e + i] : 0.f;
          }
        }
      }
      cp_async_commit();
    }
    // sum each group's rows as soon as they have landed
#pragma unroll
    for (int grp = 0; grp < kDxGroups; ++grp) {
      cp_async_wait_groups(kDxGroups - 1 - grp);
      __syncthreads();
      const int r1 = min(rows, (grp + 1) * kDxWarps);
      for (int r = grp * kDxWarps; t < T && r < r1; ++r) {
        const long long base = (static_cast<long long>(b) * co + c0 + r) * T;
        dx_row_at<K>(misalign(g, base + ts), gs + r * kDxWin,
                     ws + (c0 + r) * kMaxK, u0, acc);
      }
    }
  }
  if (t >= T) return;
  store_run<kDxR>(dx + static_cast<size_t>(b) * T + t, acc, t, T);
}

// ---------------------------------------------------------------------
// B3-bf16: tensor-core sums over the Hankel view of staged g rows
// ---------------------------------------------------------------------

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

// TMA: the box of the 3-D map at (c0, c1, c2) into shared memory at dst,
// zeros outside the tensor; the bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The sums of one slot's `rows` channel rows into the four chains, four
// channels at a time: their ldmatrix first, then their products, chain
// 2 (c % 2) + h, so that neither waits on the one before it.
__device__ __forceinline__ void sum_slot(uint32_t slot, int rows,
                                         const uint32_t (&bfrag)[kB3Rows][4],
                                         float (&acc)[4][4]) {
#pragma unroll
  for (int c0q = 0; c0q < kB3Rows; c0q += 4) {
    uint32_t a[4][2][4];
#pragma unroll
    for (int c = c0q; c < c0q + 4; ++c) {
      if (c < rows) {
        const uint32_t row = slot + c * kB3Cols * 2;
        ldsm4(a[c - c0q][0], row);
        ldsm4(a[c - c0q][1], row + 32);
      }
    }
#pragma unroll
    for (int c = c0q; c < c0q + 4; ++c) {
      if (c < rows) {
        float* d = acc[2 * (c & 1)];
        mma_bf16(d, a[c - c0q][0], bfrag[c][0], bfrag[c][1]);
        mma_bf16(d + 4, a[c - c0q][1], bfrag[c][2], bfrag[c][3]);
      }
    }
  }
}

// One persistent grid walks the (batch row, tile) pairs; warp i of it
// takes pairs [first, first + loads / groups) and loads each pair's
// channel groups in turn into its ring (load n: slot n % kB3Stages).
template <bool kTma>
__global__ void __launch_bounds__(kB3Threads)
    ci1_dx_bf16_mma_kernel(const __grid_constant__ CUtensorMap map,
                           const bf16* __restrict__ g,
                           const uint16_t* __restrict__ w,
                           bf16* __restrict__ dx, int B, int co, int k,
                           int T, int pad_right) {
  extern __shared__ __align__(128) unsigned char b3_smem[];
  unsigned char* smem = b3_smem + ((128 - (smem_u32(b3_smem) & 127)) & 127);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const CUtensorMap* gmap = &map;
  unsigned char* ring = smem + warp * kB3Stages * kB3SlotBytes;
  uint16_t* taps = reinterpret_cast<uint16_t*>(smem + kB3RingBytes);
  const uint32_t bars =
      smem_u32(smem + kB3RingBytes + kB3TapBytes) + warp * kB3Stages * 8;

  if (kTma && lane == 0) {
    for (int s = 0; s < kB3Stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  const int ntiles = (T + kB3Tile - 1) / kB3Tile;
  const int groups = (co + kB3Rows - 1) / kB3Rows;
  const long long items = static_cast<long long>(B) * ntiles;
  const long long nw = static_cast<long long>(gridDim.x) * kB3Warps;
  const long long gw = static_cast<long long>(blockIdx.x) * kB3Warps + warp;
  const long long first = items * gw / nw;
  const int loads = static_cast<int>(items * (gw + 1) / nw - first) * groups;
  const uint32_t box_bytes = (co < kB3Rows ? co : kB3Rows) * kB3Cols * 2;

  // Load n into its slot: the item's 128-step window, from ts rounded
  // down to g's 16-byte boundary, of the group's channel rows.  Called
  // for load n + kB3Stages - 1 once load n - 1's sums are done.
  auto issue = [&](int n) {
    if (n >= loads) {
      if (!kTma) cp_async_commit();  // keep one group per load
      return;
    }
    const long long it = first + n / groups;
    const int b = static_cast<int>(it / ntiles);
    const int ts = static_cast<int>(it % ntiles) * kB3Tile - pad_right;
    const int c0 = (n % groups) * kB3Rows;
    unsigned char* slot = ring + (n % kB3Stages) * kB3SlotBytes;
    if constexpr (kTma) {
      if (lane == 0) {
        const uint32_t bar = bars + 8 * (n % kB3Stages);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar, box_bytes);
        tma_load_3d(smem_u32(slot), gmap, bar, ts & ~7, c0, b);
      }
    } else {
      const int rows = min(kB3Rows, co - c0);
      bf16* srow = reinterpret_cast<bf16*>(slot);
      for (int i = lane; i < rows * kB3Pieces; i += 32) {
        const int r = i / kB3Pieces, q = i % kB3Pieces;
        const long long base = (static_cast<long long>(b) * co + c0 + r) * T;
        const long long e = base + ts - misalign(g, base + ts) + 8 * q;
        const long long te = e - base;  // time of element e
        bf16* dst = srow + r * kB3Cols + 8 * q;
        if (te >= 0 && te + 8 <= T) {
          cp_async16(dst, g + e);
        } else {
#pragma unroll
          for (int v = 0; v < 8; ++v)
            dst[v] = (te + v >= 0 && te + v < T) ? g[e + v]
                                                 : __float2bfloat16_rn(0.f);
        }
      }
      cp_async_commit();
    }
  };

  // ldmatrix.x4 of K-half h of a channel row: lane l gives row l % 8 of
  // matrix l / 8, A's rows m = 0-7 (matrices 0, 2) or 8-15 (1, 3) and
  // K columns 0-7 (0, 1) or 8-15 (2, 3): piece m + (l / 16) + 2h.
  const uint32_t lane_piece =
      16 * ((lane & 7) + 8 * ((lane >> 3) & 1) + (lane >> 4));
  uint32_t bfrag[kB3Rows][4];  // B of each channel: K-halves 0, 1 x 2
  float acc[4][4];             // four chains of products
  int built = -1;              // the batch row B was built for

  // the first loads go out before the taps are read: they need none
#pragma unroll 1
  for (int n = 0; n < kB3Stages - 1; ++n) issue(n);
  // taps[c][x] = w[c][k - 1 - (x - kB3TapOff)] inside the k taps, else
  // 0; 8 entries a thread at once, their loads back to back
  for (int i = threadIdx.x; i < co * kB3TapCols / 8; i += kB3Threads) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int c = (8 * i + e) / kB3TapCols;
      const int o0 = (8 * i + e) % kB3TapCols - kB3TapOff, o1 = o0 + 1;
      const uint32_t lo = (o0 >= 0 && o0 < k) ? w[c * k + k - 1 - o0] : 0;
      const uint32_t hi = (o1 >= 0 && o1 < k) ? w[c * k + k - 1 - o1] : 0;
      v[e / 2] = lo | (hi << 16);
    }
    reinterpret_cast<uint4*>(taps)[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
#pragma unroll 1
  for (int n = 0; n < loads; ++n) {
    issue(n + kB3Stages - 1);
    const long long it = first + n / groups;
    const int b = static_cast<int>(it / ntiles);
    const int tile = static_cast<int>(it % ntiles);
    const int grp = n % groups, c0 = grp * kB3Rows;
    const int rows = min(kB3Rows, co - c0);
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    if (groups > 1 || b != built) {
      // Wt_c[j][r] = taps_c[kB3TapOff + j - S_c - r]: lane (gid, tig)
      // holds j = 8q + 2 tig, + 1 (register q: K-half q / 2, rows + 8
      // for odd q) at r = gid; S_c is the same for every tile of a row
#pragma unroll
      for (int c = 0; c < kB3Rows; ++c) {
        if (c < rows) {
          const long long base =
              (static_cast<long long>(b) * co + c0 + c) * T;
          const int shift = misalign(g, base - pad_right);
          const uint16_t* tc = taps + (c0 + c) * kB3TapCols + kB3TapOff -
                               shift - gid + 2 * tig;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bfrag[c][q] = tc[8 * q] |
                          (static_cast<uint32_t>(tc[8 * q + 1]) << 16);
        }
      }
      built = b;
    }
    if constexpr (kTma) {
      mbar_wait(bars + 8 * (n % kB3Stages), (n / kB3Stages) & 1);
    } else {
      asm volatile("cp.async.wait_group %0;" ::"n"(kB3Stages - 1)
                   : "memory");
    }
    __syncwarp();
    const uint32_t slot =
        smem_u32(ring + (n % kB3Stages) * kB3SlotBytes) + lane_piece;
    sum_slot(slot, rows, bfrag, acc);
    if (grp == groups - 1) {
      // D rows gid, gid + 8 (blocks), columns 2 tig, + 1 (r): steps
      // 8 gid + 2 tig, + 1 and 64 more
      bf16* o = dx + static_cast<long long>(b) * T;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = tile * kB3Tile + 64 * half + 8 * gid + 2 * tig;
        const float v0 = (acc[0][2 * half] + acc[1][2 * half]) +
                         (acc[2][2 * half] + acc[3][2 * half]);
        const float v1 = (acc[0][2 * half + 1] + acc[1][2 * half + 1]) +
                         (acc[2][2 * half + 1] + acc[3][2 * half + 1]);
        if (T % 2 == 0 && t + 1 < T) {
          *reinterpret_cast<__nv_bfloat162*>(o + t) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (t < T) o[t] = __float2bfloat16_rn(v0);
          if (t + 1 < T) o[t + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
    __syncwarp();  // every lane is through this slot before its refill
  }
}

template <typename E, int K>
cudaError_t launch_fwd(const E* x, const E* w, E* out, int B, int co, int T,
                       int pad_left, cudaStream_t stream) {
  const dim3 grid((T + kFwdTile - 1) / kFwdTile, B);
  ci1_fwd_kernel<E, K><<<grid, kFwdThreads, 0, stream>>>(x, w, out, co, T,
                                                         pad_left);
  return cudaGetLastError();
}

// Raise a kernel's dynamic shared-memory limit once per device.
template <auto Kernel>
cudaError_t max_smem_once(int bytes) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

size_t dx_smem(int co) {
  return sizeof(float) * static_cast<size_t>(co < kDxRows ? co : kDxRows) *
         kDxWin;
}

template <int K>
cudaError_t launch_dx(const float* g, const float* w, float* dx, int B,
                      int co, int T, int pad_right, cudaStream_t stream) {
  cudaError_t err =
      max_smem_once<ci1_dx_kernel<K>>(static_cast<int>(dx_smem(kDxRows)));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kDxTile - 1) / kDxTile, B);
  ci1_dx_kernel<K><<<grid, kDxThreads, dx_smem(co), stream>>>(
      g, w, dx, co, T, pad_right);
  return cudaGetLastError();
}

// B3-bf16's staging mode, by shape: TMA where every row starts on a
// 16-byte boundary of g, cp.async elsewhere.
bool b3_tma(const void* g, int T) {
  return T % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
}

// The persistent grid of a B3-bf16 launch of `items` (batch row, tile)
// pairs: SMs x kB3CtasPerSm CTAs (fewer where fewer fit), at most one
// item per warp.  The shared-memory limit is raised and the occupancy
// read once per device.
template <bool kTma>
cudaError_t b3_grid(int dev, long long items, int* grid) {
  static int full[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (full[dev] == 0) {
    cudaError_t err = max_smem_once<ci1_dx_bf16_mma_kernel<kTma>>(kB3Smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ci1_dx_bf16_mma_kernel<kTma>, kB3Threads, kB3Smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    full[dev] = sms * (per_sm < kB3CtasPerSm ? per_sm : kB3CtasPerSm);
  }
  const long long need = (items + kB3Warps - 1) / kB3Warps;
  *grid = static_cast<int>(need < full[dev] ? need : full[dev]);
  return cudaSuccess;
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

// g (B, co, T) as a 3-D map, innermost T: boxes of kB3Cols steps x
// min(co, kB3Rows) channels x 1 batch row, zeros outside.
bool encode_g(CUtensorMap* map, const void* g, int B, int co, int T) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(co),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {2ull * T, 2ull * T * co};
  const cuuint32_t box[3] = {kB3Cols,
                             static_cast<cuuint32_t>(co < kB3Rows ? co
                                                                  : kB3Rows),
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(g),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kTma>
cudaError_t launch_dx_bf16_mode(int dev, const CUtensorMap& map,
                                const bf16* g, const uint16_t* w, bf16* dx,
                                int B, int co, int k, int T, int pad_right,
                                cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = b3_grid<kTma>(
      dev, static_cast<long long>(B) * ((T + kB3Tile - 1) / kB3Tile), &grid);
  if (err != cudaSuccess || grid == 0) return err;
  ci1_dx_bf16_mma_kernel<kTma><<<grid, kB3Threads, kB3Smem, stream>>>(
      map, g, w, dx, B, co, k, T, pad_right);
  return cudaGetLastError();
}

cudaError_t launch_dx_bf16(const bf16* g, const uint16_t* w, bf16* dx, int B,
                           int co, int k, int T, int pad_right,
                           cudaStream_t stream) {
  if (k < 1 || k > kMaxK || co < 1 || co > kMaxCo || pad_right < 0 ||
      pad_right >= k)
    return cudaErrorInvalidValue;
  // The map is encoded by a driver call, which needs the device's
  // context current in this thread: a thread whose first CUDA call this
  // is (autograd's backward thread) may have none until a runtime call
  // binds it.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  alignas(64) CUtensorMap map = {};
  if (!b3_tma(g, T))
    return launch_dx_bf16_mode<false>(dev, map, g, w, dx, B, co, k, T,
                                      pad_right, stream);
  if (!encode_g(&map, g, B, co, T)) return cudaErrorInvalidValue;
  return launch_dx_bf16_mode<true>(dev, map, g, w, dx, B, co, k, T,
                                   pad_right, stream);
}

#define CI1_TAPS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

template <typename E>
int forward(const void* x, const void* w, void* out, int B, int co, int k,
            int T, int pad_left, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const E* xe = static_cast<const E*>(x);
  const E* we = static_cast<const E*>(w);
  E* oe = static_cast<E*>(out);
  switch (k) {
#define CI1_FWD_CASE(K) \
  case K:               \
    return launch_fwd<E, K>(xe, we, oe, B, co, T, pad_left, s);
    CI1_TAPS(CI1_FWD_CASE)
#undef CI1_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

int data_gradient(const float* g, const float* w, float* dx, int B, int co,
                  int k, int T, int pad_right, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define CI1_DX_CASE(K) \
  case K:              \
    return launch_dx<K>(g, w, dx, B, co, T, pad_right, s);
    CI1_TAPS(CI1_DX_CASE)
#undef CI1_DX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`; return the cudaError_t of the launch.  The caller
// guarantees contiguous tensors of the entry point's dtype (float32, or
// bf16 for the _bf16 ones), 1 <= k <= 16, 1 <= co <= 64,
// pad_left + pad_right == k - 1 and 16-byte aligned out / dx.
extern "C" int ci1_conv_forward(const float* x, const float* w, float* out,
                                int B, int co, int k, int T, int pad_left,
                                void* stream) {
  return forward<float>(x, w, out, B, co, k, T, pad_left, stream);
}

extern "C" int ci1_conv_forward_bf16(const void* x, const void* w, void* out,
                                     int B, int co, int k, int T,
                                     int pad_left, void* stream) {
  return forward<bf16>(x, w, out, B, co, k, T, pad_left, stream);
}

extern "C" int ci1_conv_dx(const float* g, const float* w, float* dx, int B,
                           int co, int k, int T, int pad_right, void* stream) {
  return data_gradient(g, w, dx, B, co, k, T, pad_right, stream);
}

extern "C" int ci1_conv_dx_bf16(const void* g, const void* w, void* dx,
                                int B, int co, int k, int T, int pad_right,
                                void* stream) {
  return launch_dx_bf16(static_cast<const bf16*>(g),
                        static_cast<const uint16_t*>(w),
                        static_cast<bf16*>(dx), B, co, k, T, pad_right,
                        static_cast<cudaStream_t>(stream));
}

// What a float32 B3 launch at this shape uses: info = {blocks, threads per
// block, shared memory bytes (dynamic + static), registers per thread}.
extern "C" int ci1_conv_dx_launch_info(int B, int co, int k, int T,
                                       int* info) {
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
#define CI1_ATTR_CASE(K) \
  case K:                \
    err = cudaFuncGetAttributes(&attr, ci1_dx_kernel<K>); \
    break;
    CI1_TAPS(CI1_ATTR_CASE)
#undef CI1_ATTR_CASE
  }
  if (err != cudaSuccess) return err;
  info[0] = ((T + kDxTile - 1) / kDxTile) * B;
  info[1] = kDxThreads;
  info[2] = static_cast<int>(dx_smem(co) + attr.sharedSizeBytes);
  info[3] = attr.numRegs;
  return cudaSuccess;
}

// What a B3-bf16 launch at this shape uses, for a 16-byte aligned g:
// info = {CTAs, threads per CTA, shared memory bytes, registers per
// thread, slots per warp's ring, 1 for TMA staging (0: cp.async)}.
extern "C" int ci1_conv_dx_bf16_launch_info(int B, int co, int k, int T,
                                            int* info) {
  if (k < 1 || k > kMaxK || co < 1 || co > kMaxCo)
    return cudaErrorInvalidValue;
  const bool tma = T % 8 == 0;
  const long long items = static_cast<long long>(B) * ((T + kB3Tile - 1) / kB3Tile);
  cudaFuncAttributes attr = {};
  int dev = 0, grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = tma ? b3_grid<true>(dev, items, &grid)
              : b3_grid<false>(dev, items, &grid);
  if (err == cudaSuccess)
    err = tma ? cudaFuncGetAttributes(&attr, ci1_dx_bf16_mma_kernel<true>)
              : cudaFuncGetAttributes(&attr, ci1_dx_bf16_mma_kernel<false>);
  if (err != cudaSuccess) return err;
  info[0] = grid;
  info[1] = kB3Threads;
  info[2] = static_cast<int>(kB3Smem + attr.sharedSizeBytes);
  info[3] = attr.numRegs;
  info[4] = kB3Stages;
  info[5] = tma;
  return cudaSuccess;
}

extern "C" const char* ci1_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
