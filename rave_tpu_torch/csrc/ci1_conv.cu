// Same-length 1-D convolution with one input channel (kernels B2 and B3)
// for Hopper, f32: the MelGAN discriminator's head conv (k = 15, 1 -> 16).
//
// Replaces the Pallas TPU kernels of rave_tpu/ops/pallas/ci1_conv.py:
//   B2 `_fwd_kernel` (forward), launched by `ci1_conv_forward`:
//     out[b, c, t] = sum_j x[b, t + j - pad_left] * w[c, j]
//   B3 `_dx_kernel` (data gradient), launched by `ci1_conv_dx`:
//     dx[b, t] = sum_c sum_o g[b, c, t - pad_right + o] * w[c, k - 1 - o]
// with zeros outside [0, T), pad_left + pad_right = k - 1, k <= 16 taps
// and co <= 64 output channels.  Layouts are the port's channels-first
// ones: x and dx (B, T), g and out (B, co, T), w (co, k).
//
// What bounds them: at the main path's (B, T, co, k) = (16, 91232, 16, 15)
// each does 2*B*T*co*k = 0.70 GFLOP against 4*B*T*(1 + co) = 99 MB of
// device memory traffic: 30 us of HBM against 10 us of f32 FMA, so both
// are bound by bytes.  The design is one pass over the big operand (out
// for B2, g for B3), with the small one and the taps on chip:
// * a block owns one batch row and a tile of time steps, and stages the
//   tile plus its k - 1 halo (B2: of x; B3: of the co rows of g, 16 rows
//   at a time) and the taps in shared memory, zero outside [0, T);
// * B2: each thread forms kR = 4 consecutive time steps from a register
//   window read with 16-byte shared loads, the taps read as broadcasts,
//   and writes, for each channel, 4 consecutive words (one 16-byte store
//   where T % 4 == 0), so a warp stores 512 contiguous bytes of a
//   channel row;
// * B3 stages with 16-byte copies and no division per element: warp w
//   takes channel rows w, w + 4, ..., lane l the 16-byte pieces l, l + 32,
//   ... of a row, by cp.async where a piece lies inside [0, T); the few
//   pieces at the ragged ends are assembled with zeros.  Where T % 4 != 0
//   or the window starts off a 16-byte boundary (pad 7), the row is
//   staged from the aligned piece before it and the compute reads it
//   `shift` (0-3) floats in, a template instance per shift.  Each thread
//   sums the co * k products of kDxR = 8 consecutive steps in registers
//   (each reversed tap read from shared memory serves 8 products) and
//   writes them once.
// Plain f32 FMAs, no tensor cores: with one input channel there is
// nothing to contract.  The TPU kernels' 4096-step tiles and 128-lane
// halo are lane-layout facts of the TPU and are not carried over.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
// B3's staged row: up to 3 floats of alignment shift, the tile and its
// k - 1 halo, and the over-read of the last thread's float4 loads
constexpr int kDxWin = kDxTile + kMaxK + 4;
constexpr int kMaxDevices = 64;
// staged window of a tile: the tile, the largest halo and the float4
// over-read of the last thread, a multiple of 4 floats
__host__ __device__ constexpr int window(int tile) {
  return tile + kMaxK + kR;
}

// (K + kR - 1) inputs feed kR outputs: loaded as kV float4s
template <int K>
struct Taps {
  static constexpr int kV = (K + kR - 1 + 3) / 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

template <int K>
__global__ void __launch_bounds__(kFwdThreads)
    ci1_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int co, int T, int pad_left) {
  constexpr int kWin = window(kFwdTile);
  constexpr int kV = Taps<K>::kV;
  __shared__ __align__(16) float xs[kWin];
  __shared__ __align__(16) float ws[kMaxCo * kMaxK];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFwdTile;
  const float* xb = x + static_cast<size_t>(b) * T;
  for (int i = threadIdx.x; i < kWin; i += kFwdThreads) {
    const int t = t0 - pad_left + i;
    xs[i] = (t >= 0 && t < T) ? xb[t] : 0.f;
  }
  for (int i = threadIdx.x; i < co * kMaxK; i += kFwdThreads) {
    const int j = i % kMaxK;
    ws[i] = j < K ? w[(i / kMaxK) * K + j] : 0.f;
  }
  __syncthreads();

  const int u0 = threadIdx.x * kR;
  const int t = t0 + u0;
  if (t >= T) return;
  float xv[4 * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) load4(xs + u0 + 4 * q, xv + 4 * q);

  float* ob = out + static_cast<size_t>(b) * co * T + t;
  const bool vec = (T % 4 == 0) && (t + kR <= T);
  for (int c = 0; c < co; ++c) {
    float wv[kMaxK];
#pragma unroll
    for (int q = 0; q < kMaxK / 4; ++q) load4(ws + c * kMaxK + 4 * q, wv + 4 * q);
    float acc[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(xv[r + j], wv[j], acc[r]);
    float* o = ob + static_cast<size_t>(c) * T;
    if (vec) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (t + r < T) o[r] = acc[r];
    }
  }
}

// B3's window of one channel row starts `shift` (0-3) floats into its
// shared-memory row, so that every 16-byte piece of the global row lands
// on a 16-byte word; this thread's kDxR outputs read taps o = 0..K-1 at
// window positions u0 + r + o.
template <int S, int K>
__device__ __forceinline__ void dx_row(const float* row, const float* taps,
                                       int u0, float* acc) {
  constexpr int kV = (kDxR + K - 1 + S + 3) / 4;
  float gv[4 * kV];
#pragma unroll
  for (int q = 0; q < kV; ++q) load4(row + u0 + 4 * q, gv + 4 * q);
  float wv[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK / 4; ++q) load4(taps + 4 * q, wv + 4 * q);
#pragma unroll
  for (int o = 0; o < K; ++o)
#pragma unroll
    for (int r = 0; r < kDxR; ++r) acc[r] = fmaf(gv[S + r + o], wv[o], acc[r]);
}

// Misalignment, in floats, of element `e` of g from a 16-byte boundary.
__device__ __forceinline__ int misalign(const float* g, long long e) {
  return static_cast<int>(
      (static_cast<long long>(reinterpret_cast<uintptr_t>(g) / 4) + e) & 3);
}

template <int K>
__global__ void __launch_bounds__(kDxThreads)
    ci1_dx_kernel(const float* __restrict__ g, const float* __restrict__ w,
                  float* __restrict__ dx, int co, int T, int pad_right) {
  constexpr int kW = kDxTile + K - 1;  // window positions the tile reads
  extern __shared__ __align__(16) float gs[];          // [kDxRows][kDxWin]
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
        for (int q = lane; 4 * q < shift + kW; q += 32) {
          const long long e = e0 + 4 * q;
          const long long te = e - base;  // time of element e
          if (te >= 0 && te + 4 <= T) {
            cp_async16(srow + 4 * q, g + e);
          } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = (te + i >= 0 && te + i < T) ? g[e + i] : 0.f;
            *reinterpret_cast<float4*>(srow + 4 * q) =
                make_float4(v[0], v[1], v[2], v[3]);
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
        const float* srow = gs + r * kDxWin;
        const float* taps = ws + (c0 + r) * kMaxK;
        switch (misalign(g, base + ts)) {  // uniform across the block
          case 0: dx_row<0, K>(srow, taps, u0, acc); break;
          case 1: dx_row<1, K>(srow, taps, u0, acc); break;
          case 2: dx_row<2, K>(srow, taps, u0, acc); break;
          default: dx_row<3, K>(srow, taps, u0, acc); break;
        }
      }
    }
  }
  if (t >= T) return;
  float* d = dx + static_cast<size_t>(b) * T + t;
  if ((T % 4 == 0) && (t + kDxR <= T)) {
#pragma unroll
    for (int q = 0; q < kDxR / 4; ++q)
      *reinterpret_cast<float4*>(d + 4 * q) = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < kDxR; ++r)
      if (t + r < T) d[r] = acc[r];
  }
}

template <int K>
cudaError_t launch_fwd(const float* x, const float* w, float* out, int B,
                       int co, int T, int pad_left, cudaStream_t stream) {
  const dim3 grid((T + kFwdTile - 1) / kFwdTile, B);
  ci1_fwd_kernel<K><<<grid, kFwdThreads, 0, stream>>>(x, w, out, co, T,
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
  cudaError_t err = max_smem_once<ci1_dx_kernel<K>>(
      static_cast<int>(dx_smem(kDxRows)));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kDxTile - 1) / kDxTile, B);
  ci1_dx_kernel<K><<<grid, kDxThreads, dx_smem(co), stream>>>(
      g, w, dx, co, T, pad_right);
  return cudaGetLastError();
}

template <int K>
cudaError_t dx_attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, ci1_dx_kernel<K>);
}

}  // namespace

#define CI1_TAPS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// Launch on `stream`; return the cudaError_t of the launch.  The caller
// guarantees contiguous float32 tensors, 1 <= k <= 16, 1 <= co <= 64,
// pad_left + pad_right == k - 1 and 16-byte aligned out / dx.
extern "C" int ci1_conv_forward(const float* x, const float* w, float* out,
                                int B, int co, int k, int T, int pad_left,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define CI1_FWD_CASE(K) \
  case K:               \
    return launch_fwd<K>(x, w, out, B, co, T, pad_left, s);
    CI1_TAPS(CI1_FWD_CASE)
#undef CI1_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ci1_conv_dx(const float* g, const float* w, float* dx, int B,
                           int co, int k, int T, int pad_right, void* stream) {
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

// What a B3 launch at this shape uses: info = {blocks, threads per
// block, shared memory bytes (dynamic + static), registers per thread}.
extern "C" int ci1_conv_dx_launch_info(int B, int co, int k, int T,
                                       int* info) {
  cudaFuncAttributes attr = {};
  cudaError_t err = cudaErrorInvalidValue;
  switch (k) {
#define CI1_ATTR_CASE(K) \
  case K:                \
    err = dx_attributes<K>(&attr); \
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

extern "C" const char* ci1_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
