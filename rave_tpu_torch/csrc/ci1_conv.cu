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
// Both instances keep the Pallas kernels' contract, which is generic in
// the dtype: the operands are staged in their own dtype, every tap and
// weight is widened to float32, the sums are float32, and the result is
// rounded once into the operands' dtype (bf16: __float2bfloat16_rn at
// the store).  The bf16 instance is the float32 one with half the bytes
// staged: the same loops, the same order of FMAs.
//
// What bounds them: at the main path's (B, T, co, k) = (16, 91232, 16, 15)
// each does 2*B*T*co*k = 0.70 GFLOP against 4*B*T*(1 + co) = 99 MB of
// device memory traffic (bf16: 50 MB): 30 us (bf16: 15 us) of HBM
// against 10 us of f32 FMA, so both are bound by bytes.  The design is
// one pass over the big operand (out for B2, g for B3), with the small
// one and the taps on chip:
// * a block owns one batch row and a tile of time steps, and stages the
//   tile plus its k - 1 halo (B2: of x, widened to float32; B3: of the
//   co rows of g in their own dtype, 16 rows at a time) and the taps
//   (float32) in shared memory, zero outside [0, T);
// * B2: each thread forms kR = 4 consecutive time steps from a register
//   window read with 16-byte shared loads, the taps read as broadcasts,
//   and writes, for each channel, 4 consecutive values (one 16-byte store
//   in float32, one 8-byte store of two bf16 pairs in bf16, where
//   T % 4 == 0), so a warp stores a contiguous run of a channel row;
// * B3 stages with 16-byte copies and no division per element: warp w
//   takes channel rows w, w + 4, ..., lane l the 16-byte pieces l, l + 32,
//   ... of a row (4 float32 or 8 bf16 values), by cp.async where a piece
//   lies inside [0, T); the few pieces at the ragged ends are assembled
//   with zeros.  Where the window starts off a 16-byte boundary (T not a
//   multiple of the piece, or the pad), the row is staged from the
//   aligned piece before it and the compute reads it `shift` values in
//   (0-3 in float32, 0-7 in bf16), a template instance per shift.  Each
//   thread sums the co * k products of kDxR = 8 consecutive steps in
//   registers (each reversed tap read from shared memory serves 8
//   products) and writes them once.
// Plain f32 FMAs, no tensor cores: with one input channel there is
// nothing to contract.  The TPU kernels' 4096-step tiles and 128-lane
// halo are lane-layout facts of the TPU and are not carried over.

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

// B3's staged row, in values of E: up to kPer - 1 values of alignment
// shift, the tile and its k - 1 halo, and the over-read of the last
// thread's 16-byte loads; a whole number of 16-byte pieces.
template <typename E>
constexpr int kDxWin = kDxTile + kMaxK + (sizeof(E) == 4 ? 4 : 16);

// (K + kR - 1) inputs feed kR outputs: loaded as kV float4s
template <int K>
struct Taps {
  static constexpr int kV = (K + kR - 1 + 3) / 4;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
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

// One 16-byte piece of shared memory widened to float32: 4 float32 or 8
// bf16 values.
__device__ __forceinline__ void load_piece(const float* src, float* dst) {
  load4(src, dst);
}
__device__ __forceinline__ void load_piece(const bf16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Store n = 4 or 8 consecutive sums at o (time step t of a row of T):
// float32 in 16-byte pieces, bf16 rounded once and packed in pairs,
// where the row's alignment allows (o's row starts at a multiple of T
// from a 16-byte aligned base); element by element at a ragged end.
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

template <int N>
__device__ __forceinline__ void store_run(bf16* o, const float* acc, int t,
                                          int T) {
  if ((T % N == 0) && (t + N <= T)) {
    uint32_t words[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      words[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    if constexpr (N == 8) {
      *reinterpret_cast<uint4*>(o) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      *reinterpret_cast<uint2*>(o) = make_uint2(words[0], words[1]);
    }
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

// B3's window of one channel row starts `shift` values into its
// shared-memory row, so that every 16-byte piece of the global row lands
// on a 16-byte word; this thread's kDxR outputs read taps o = 0..K-1 at
// window positions u0 + r + o.
template <typename E, int S, int K>
__device__ __forceinline__ void dx_row(const E* row, const float* taps,
                                       int u0, float* acc) {
  constexpr int kP = kPer<E>;
  constexpr int kV = (kDxR + K - 1 + S + kP - 1) / kP;
  float gv[kP * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) load_piece(row + u0 + kP * q, gv + kP * q);
  float wv[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q) load4(taps + 4 * q, wv + 4 * q);
#pragma unroll
  for (int o = 0; o < K; ++o)
#pragma unroll
    for (int r = 0; r < kDxR; ++r) acc[r] = fmaf(gv[S + r + o], wv[o], acc[r]);
}

// One row's sums at the row's shift (uniform across the block).
template <typename E, int K>
__device__ __forceinline__ void dx_row_at(int shift, const E* row,
                                          const float* taps, int u0,
                                          float* acc) {
  switch (shift) {
    case 0: dx_row<E, 0, K>(row, taps, u0, acc); break;
    case 1: dx_row<E, 1, K>(row, taps, u0, acc); break;
    case 2: dx_row<E, 2, K>(row, taps, u0, acc); break;
    case 3: dx_row<E, 3, K>(row, taps, u0, acc); break;
    default:
      if constexpr (kPer<E> == 8) {
        switch (shift) {
          case 4: dx_row<E, 4, K>(row, taps, u0, acc); break;
          case 5: dx_row<E, 5, K>(row, taps, u0, acc); break;
          case 6: dx_row<E, 6, K>(row, taps, u0, acc); break;
          default: dx_row<E, 7, K>(row, taps, u0, acc); break;
        }
      }
      break;
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

template <typename E, int K>
__global__ void __launch_bounds__(kDxThreads)
    ci1_dx_kernel(const E* __restrict__ g, const E* __restrict__ w,
                  E* __restrict__ dx, int co, int T, int pad_right) {
  constexpr int kW = kDxTile + K - 1;  // window positions the tile reads
  constexpr int kP = kPer<E>;
  constexpr int kWin = kDxWin<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* gs = reinterpret_cast<E*>(smem);                  // [kDxRows][kWin]
  __shared__ __align__(16) float ws[kMaxCo * kMaxK];   // ws[c][o] = w[c][K-1-o]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kDxTile;
  const int ts = t0 - pad_right;  // time of window position 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < co * kMaxK; i += kDxThreads) {
    const int o = i % kMaxK;
    ws[i] = o < K ? widen(w[(i / kMaxK) * K + K - 1 - o]) : 0.f;
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
        E* srow = gs + r * kWin;
        for (int q = lane; kP * q < shift + kW; q += 32) {
          const long long e = e0 + kP * q;
          const long long te = e - base;  // time of element e
          if (te >= 0 && te + kP <= T) {
            cp_async16(srow + kP * q, g + e);
          } else {
#pragma unroll
            for (int i = 0; i < kP; ++i)
              srow[kP * q + i] =
                  (te + i >= 0 && te + i < T) ? g[e + i] : narrow<E>(0.f);
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
        dx_row_at<E, K>(misalign(g, base + ts), gs + r * kWin,
                        ws + (c0 + r) * kMaxK, u0, acc);
      }
    }
  }
  if (t >= T) return;
  store_run<kDxR>(dx + static_cast<size_t>(b) * T + t, acc, t, T);
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

template <typename E>
size_t dx_smem(int co) {
  return sizeof(E) * static_cast<size_t>(co < kDxRows ? co : kDxRows) *
         kDxWin<E>;
}

template <typename E, int K>
cudaError_t launch_dx(const E* g, const E* w, E* dx, int B, int co, int T,
                      int pad_right, cudaStream_t stream) {
  cudaError_t err = max_smem_once<ci1_dx_kernel<E, K>>(
      static_cast<int>(dx_smem<E>(kDxRows)));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kDxTile - 1) / kDxTile, B);
  ci1_dx_kernel<E, K><<<grid, kDxThreads, dx_smem<E>(co), stream>>>(
      g, w, dx, co, T, pad_right);
  return cudaGetLastError();
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

template <typename E>
int data_gradient(const void* g, const void* w, void* dx, int B, int co,
                  int k, int T, int pad_right, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const E* ge = static_cast<const E*>(g);
  const E* we = static_cast<const E*>(w);
  E* de = static_cast<E*>(dx);
  switch (k) {
#define CI1_DX_CASE(K) \
  case K:              \
    return launch_dx<E, K>(ge, we, de, B, co, T, pad_right, s);
    CI1_TAPS(CI1_DX_CASE)
#undef CI1_DX_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// What a B3 launch at this shape uses: info = {blocks, threads per
// block, shared memory bytes (dynamic + static), registers per thread}.
template <typename E>
int dx_launch_info(int B, int co, int k, int T, int* info) {
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
#define CI1_ATTR_CASE(K) \
  case K:                \
    err = cudaFuncGetAttributes(&attr, ci1_dx_kernel<E, K>); \
    break;
    CI1_TAPS(CI1_ATTR_CASE)
#undef CI1_ATTR_CASE
  }
  if (err != cudaSuccess) return err;
  info[0] = ((T + kDxTile - 1) / kDxTile) * B;
  info[1] = kDxThreads;
  info[2] = static_cast<int>(dx_smem<E>(co) + attr.sharedSizeBytes);
  info[3] = attr.numRegs;
  return cudaSuccess;
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
  return data_gradient<float>(g, w, dx, B, co, k, T, pad_right, stream);
}

extern "C" int ci1_conv_dx_bf16(const void* g, const void* w, void* dx,
                                int B, int co, int k, int T, int pad_right,
                                void* stream) {
  return data_gradient<bf16>(g, w, dx, B, co, k, T, pad_right, stream);
}

extern "C" int ci1_conv_dx_launch_info(int B, int co, int k, int T,
                                       int* info) {
  return dx_launch_info<float>(B, co, k, T, info);
}

extern "C" int ci1_conv_dx_bf16_launch_info(int B, int co, int k, int T,
                                            int* info) {
  return dx_launch_info<bf16>(B, co, k, T, info);
}

extern "C" const char* ci1_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
