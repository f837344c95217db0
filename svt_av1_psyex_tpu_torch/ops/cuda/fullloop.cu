// Fused analysis full loop for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `fullloop` (body `_fullloop_kernel`) in
// svt_av1_psyex_tpu/ops/pallas/fullloop.py. Per residual block of n x n
// (n in {4, 8, 16, 32}):
//   forward DCT_DCT  C  = Fc . X . Fr^T          (shift gains folded in)
//   analysis quantize qabs = floor((|c| + rnd) * ((1 << log_scale) / deq)),
//                     zero below the zbin dead zone
//   integer dequant  dq = sign * ((qabs * deq) >> log_scale)
//   inverse DCT      inv = Gc . DQ . Gr^T
// and writes metrics (B, 8) f32: dist = sum (x - inv)^2, the rate proxy
// (bits<<9), eob (default-scan position + 1), sse = sum x^2, zeros;
// optionally the inverse residual (B, n, n) f32.
//
// Bound. Per coefficient the kernel reads 4 bytes (and writes 4 more with
// the inverse) and does 4n fp32 FMAs: at n = 16 and 32 the FP32 pipes
// bound it, at n = 4 and 8 device-memory bytes. No tensor cores: fp32
// inputs reach them only as TF32, whose rounding can flip a quantization
// decision against the reference's HIGHEST-precision transforms.
//
// Design. Each 1-D pass of a block is N dot products of length N. A thread
// owns one row of each of kRows blocks for the row passes and the same
// column of those blocks for the column passes, with the kRows x N inputs
// in registers. It makes two outputs at a time: per step of four k, two
// 16-byte shared-memory loads of transform coefficients, which every
// thread of the warp reads at the same address (a broadcast), feed
// 2 x kRows x 4 FMAs. Shared memory holds the CTA's tile between passes
// (rows padded to N + 1 words, so a warp reading 32 rows or 32 columns
// touches 32 banks) and the four matrices of n, copied in once per CTA.
// Reading both FMA operands from shared memory would cap the kernel at
// 1/8 of the FP32 rate; the coefficients are not in __constant__ memory
// because a 4 KB matrix per pass at n = 32 thrashes the constant cache
// (measured at 10% of the bound). The loop over outputs is not unrolled,
// so the code stays small at every n. Tiles are loaded and the inverse
// stored with coalesced 4-byte accesses.
//
// What bounds it in practice: instruction issue. Besides its 4n FMAs a
// coefficient costs about 25 other instructions (quantizer, rate terms,
// loads and stores), as many as the FMAs at n = 8 and half of them at
// n = 16, so the kernel stays below the FMA and byte bounds. The rate
// proxy's log2(1 + q) is a shared-memory table, filled by log2f on the
// device (log2f inline costs about 25 instructions per coefficient).
//
// Order of operations. Each coefficient, quantized level, eob, nnz and
// inverse sample comes from one FMA chain per output, k = 0..N-1 from 0,
// row pass then column pass, as the reference's separable transform
// orders it. The per-block sums run per thread (sum log2 down its
// column, dist and sse along its row, x read again from L2), then as a
// butterfly over the block's N lanes: a fixed order that does not depend
// on scheduling, and no atomics.
//
// Accuracy: the quantizer keeps the reference's operation order with
// explicit round-to-nearest intrinsics (nvcc must not contract it), the
// dequant stays in int32, and the rate terms use log2f (not __log2f) and
// are truncated to int as in the reference. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kRateNz = 1229;   // per nonzero coefficient
constexpr int kRateLog2 = 614;  // per log2(1+|q|) of each nonzero
constexpr int kRateZero = 154;  // per zero coefficient before eob
constexpr int kRateEob = 1946;  // per log2(1+eob)

// Per n: fc, fr, gc, gr (n*n floats each, row-major [out][in]) and the
// default-scan position of each row-major coefficient (n*n ints), in
// global memory, written once per n by svt_fullloop_set_constants.
__host__ __device__ constexpr int mat_off(int n) {
  return n == 4 ? 0 : n == 8 ? 64 : n == 16 ? 320 : 1344;
}
__host__ __device__ constexpr int spos_off(int n) {
  return n == 4 ? 0 : n == 8 ? 16 : n == 16 ? 80 : 336;
}
__device__ __align__(16) float g_mats[1344 + 4 * 1024];
__device__ int g_spos[336 + 1024];
// log2f(1 + q) for the quantized levels q < kLog2Levels, made on the
// device by log2f itself, so that a lookup equals the call it replaces
constexpr int kLog2Levels = 256;
__device__ float g_log2q[kLog2Levels];

__global__ void fill_log2q() {
  const int q = threadIdx.x;
  g_log2q[q] = log2f(__fadd_rn(1.0f, static_cast<float>(q)));
}

// the rare level beyond the table: a real call, so that the common path
// does not carry log2f's instructions under a predicate
__device__ __noinline__ float log2_1p(int q) {
  return log2f(__fadd_rn(1.0f, static_cast<float>(q)));
}

template <int N>
struct Cfg {
  static constexpr int kThreads = N == 32 ? 128 : 256;
  static constexpr int kRows = 2;                  // blocks per thread
  static constexpr int kHalf = kThreads / N;       // blocks per row group
  static constexpr int kBlocks = kRows * kHalf;    // blocks per CTA
  static constexpr int S = N + 1;                  // padded row stride
  static constexpr int kMatWords = 4 * N * N;  // then N * N scan positions
                                               // and the log2 table
  static constexpr int kSmemBytes =
      (kMatWords + N * N + kLog2Levels + kBlocks * N * S) * 4;
};

// CTAs per SM the register budget must allow: 4 caps a thread at 128
// registers at n = 32 and at 64 below, where more CTAs measured no faster
constexpr int kMinCtas = 4;

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

struct QParams {
  float deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac;
  int log_scale;
};

// One 1-D pass over the thread's R lines: out[h][l] = sum_k v[h][k] *
// m[l][k] (m row-major in shared memory), each a chain k = 0..N-1 from 0,
// handed to emit(h, l, value) two l at a time.
template <int N, int R, typename Emit>
__device__ __forceinline__ void pass(const float (&v)[R][N],
                                     const float* __restrict__ m, Emit emit) {
#pragma unroll 1
  for (int l = 0; l < N; l += 2) {
    float a0[R], a1[R];
#pragma unroll
    for (int h = 0; h < R; ++h) a0[h] = a1[h] = 0.0f;
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 m0 = *reinterpret_cast<const float4*>(m + l * N + k);
      const float4 m1 = *reinterpret_cast<const float4*>(m + (l + 1) * N + k);
#pragma unroll
      for (int h = 0; h < R; ++h) {
        a0[h] = fmaf(v[h][k], m0.x, a0[h]);
        a1[h] = fmaf(v[h][k], m1.x, a1[h]);
        a0[h] = fmaf(v[h][k + 1], m0.y, a0[h]);
        a1[h] = fmaf(v[h][k + 1], m1.y, a1[h]);
        a0[h] = fmaf(v[h][k + 2], m0.z, a0[h]);
        a1[h] = fmaf(v[h][k + 2], m1.z, a1[h]);
        a0[h] = fmaf(v[h][k + 3], m0.w, a0[h]);
        a1[h] = fmaf(v[h][k + 3], m1.w, a1[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < R; ++h) {
      emit(h, l, a0[h]);
      emit(h, l + 1, a1[h]);
    }
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(Cfg<N>::kThreads, kMinCtas)
fullloop_kernel(const T* __restrict__ resid, long long nblocks, QParams qp,
                float* __restrict__ metrics, float* __restrict__ inv_out) {
  using C = Cfg<N>;
  constexpr int R = C::kRows, S = C::S, NN = N * N;
  extern __shared__ float4 smem4[];
  float* mats = reinterpret_cast<float*>(smem4);   // fc, fr, gc, gr
  int* spos = reinterpret_cast<int*>(mats + C::kMatWords);
  float* log2q = mats + C::kMatWords + NN;
  float* tile = log2q + kLog2Levels;               // kBlocks x N x S

  const int tid = threadIdx.x;
  const int lb = tid / N;                  // block of row group 0
  const int r = tid % N;                   // its row, then its column
  const long long b0 = static_cast<long long>(blockIdx.x) * C::kBlocks;
  const long long base = b0 * NN;
  const long long total = nblocks * NN;

  // the matrices, the scan positions, then the tile, coalesced: element
  // e of the tile is (block e / NN, row (e / N) % N, column e % N), at
  // (e / N) * S + e % N
  {
    const float4* src = reinterpret_cast<const float4*>(g_mats + mat_off(N));
    for (int i = tid; i < C::kMatWords / 4; i += C::kThreads)
      smem4[i] = src[i];
    for (int i = tid; i < NN; i += C::kThreads)
      spos[i] = g_spos[spos_off(N) + i];
    for (int i = tid; i < kLog2Levels; i += C::kThreads)
      log2q[i] = g_log2q[i];
  }
#pragma unroll
  for (int it = 0; it < R * N; ++it) {
    const int e = tid + it * C::kThreads;
    const long long g = base + e;
    tile[(e / N) * S + e % N] =
        g < total ? static_cast<float>(resid[g]) : 0.0f;
  }
  __syncthreads();
  float* tb[R];
#pragma unroll
  for (int h = 0; h < R; ++h) tb[h] = tile + (lb + h * C::kHalf) * N * S;
  float v[R][N];

  // forward row pass, in place: t[r][l] = sum_k x[r][k] * fr[l][k]
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int k = 0; k < N; ++k) v[h][k] = tb[h][r * S + k];
  pass<N, R>(v, mats + NN, [&](int h, int l, float a) {
    tb[h][r * S + l] = a;
  });
  __syncthreads();

  // forward column pass: c[i][r] = sum_j fc[i][j] * t[j][r], quantized as
  // it comes; the dequantized level replaces t in the thread's own column
  // (no other thread reads it in this pass)
  int nnz[R], eob[R];
  float slog[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    nnz[h] = eob[h] = 0;
    slog[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) v[h][j] = tb[h][j * S + r];
  }
  {
    const float num = static_cast<float>(1 << qp.log_scale);
    const float scale_dc = __fdiv_rn(num, qp.deq_dc);
    const float scale_ac = __fdiv_rn(num, qp.deq_ac);
    pass<N, R>(v, mats, [&](int h, int i, float c) {
      const bool dc = i == 0 && r == 0;
      const float deq = dc ? qp.deq_dc : qp.deq_ac;
      const float rnd = dc ? qp.rnd_dc : qp.rnd_ac;
      const float zbin = dc ? qp.zbin_dc : qp.zbin_ac;
      const float scale = dc ? scale_dc : scale_ac;
      const float ac = fabsf(c);
      int qa = __float2int_rd(__fmul_rn(__fadd_rn(ac, rnd), scale));
      qa = ac >= zbin ? max(qa, 0) : 0;
      int dq = (qa * static_cast<int>(deq)) >> qp.log_scale;
      if (c < 0.0f) dq = -dq;
      tb[h][i * S + r] = static_cast<float>(dq);
      // branch-free: a zero level adds log2(1) = 0, which leaves the sum
      nnz[h] += qa != 0;
      eob[h] = max(eob[h], qa != 0 ? spos[i * N + r] + 1 : 0);
      slog[h] = __fadd_rn(
          slog[h], qa < kLog2Levels ? log2q[qa] : log2_1p(qa));
    });
  }
  __syncthreads();

  // inverse row pass, in place: u[r][l] = sum_k dq[r][k] * gr[l][k]
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int k = 0; k < N; ++k) v[h][k] = tb[h][r * S + k];
  pass<N, R>(v, mats + 3 * NN, [&](int h, int l, float a) {
    tb[h][r * S + l] = a;
  });
  __syncthreads();

  // inverse column pass: inv[i][r] = sum_j gc[i][j] * u[j][r], into the
  // thread's own column
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int j = 0; j < N; ++j) v[h][j] = tb[h][j * S + r];
  pass<N, R>(v, mats + 2 * NN, [&](int h, int i, float a) {
    tb[h][i * S + r] = a;
  });
  __syncthreads();

  // dist and sse along the thread's row (x read again, from L2, 16 bytes
  // at a time), then a butterfly over the block's N lanes
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const long long gb = b0 + lb + h * C::kHalf;
    float dist = 0.0f, sse = 0.0f;
    if (gb < nblocks) {
      const T* xr = resid + gb * NN + r * N;
#pragma unroll
      for (int k = 0; k < N; k += 4) {
        using V4 = typename Vec4<T>::type;
        const V4 q = __ldg(reinterpret_cast<const V4*>(xr + k));
        const float x[4] = {static_cast<float>(q.x), static_cast<float>(q.y),
                            static_cast<float>(q.z), static_cast<float>(q.w)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float err = __fsub_rn(x[u], tb[h][r * S + k + u]);
          dist = __fadd_rn(dist, __fmul_rn(err, err));
          sse = __fadd_rn(sse, __fmul_rn(x[u], x[u]));
        }
      }
    }
#pragma unroll
    for (int off = N / 2; off > 0; off >>= 1) {
      dist = __fadd_rn(dist, __shfl_xor_sync(0xffffffffu, dist, off));
      sse = __fadd_rn(sse, __shfl_xor_sync(0xffffffffu, sse, off));
      slog[h] = __fadd_rn(slog[h], __shfl_xor_sync(0xffffffffu, slog[h], off));
      nnz[h] += __shfl_xor_sync(0xffffffffu, nnz[h], off);
      eob[h] = max(eob[h], __shfl_xor_sync(0xffffffffu, eob[h], off));
    }
    if (r == 0 && gb < nblocks) {
      const int rate =
          kRateNz * nnz[h] +
          static_cast<int>(__fmul_rn(static_cast<float>(kRateLog2), slog[h])) +
          kRateZero * max(eob[h] - nnz[h], 0) +
          static_cast<int>(__fmul_rn(
              static_cast<float>(kRateEob),
              log2f(__fadd_rn(1.0f, static_cast<float>(eob[h])))));
      float4* m = reinterpret_cast<float4*>(metrics + gb * 8);
      m[0] = make_float4(dist, static_cast<float>(rate),
                         static_cast<float>(eob[h]), sse);
      m[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  if (inv_out != nullptr) {
#pragma unroll
    for (int it = 0; it < R * N; ++it) {
      const int e = tid + it * C::kThreads;
      const long long g = base + e;
      if (g < total) inv_out[g] = tile[(e / N) * S + e % N];
    }
  }
}

template <int N, typename T>
int launch(const void* resid, long long nblocks, QParams qp, float* metrics,
           float* inv, cudaStream_t stream) {
  using C = Cfg<N>;
  const auto kernel = fullloop_kernel<N, T>;
  if (C::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long ctas = (nblocks + C::kBlocks - 1) / C::kBlocks;
  kernel<<<static_cast<unsigned>(ctas), C::kThreads, C::kSmemBytes, stream>>>(
      static_cast<const T*>(resid), nblocks, qp, metrics, inv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int n, const void* resid, long long nblocks, QParams qp,
             float* metrics, float* inv, cudaStream_t stream) {
  switch (n) {
    case 4: return launch<4, T>(resid, nblocks, qp, metrics, inv, stream);
    case 8: return launch<8, T>(resid, nblocks, qp, metrics, inv, stream);
    case 16: return launch<16, T>(resid, nblocks, qp, metrics, inv, stream);
    case 32: return launch<32, T>(resid, nblocks, qp, metrics, inv, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Writes the transform matrices and the scan positions of size n, and the
// table of log2(1 + q), into the current device's memory. fc/fr are the (n, n) forward, gc/gr the (n, n)
// inverse matrices, spos (n*n,) int32, all in host memory. Call once per
// device and n before the first launch at n; returns the cudaError_t of
// the copies (it synchronises the device).
extern "C" int svt_fullloop_set_constants(int n, const float* fc,
                                          const float* fr, const float* gc,
                                          const float* gr, const int* spos) {
  if (n != 4 && n != 8 && n != 16 && n != 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t nn = static_cast<size_t>(n) * n, bytes = nn * sizeof(float);
  const size_t off = mat_off(n) * sizeof(float);
  const float* mats[4] = {fc, fr, gc, gr};
  for (int m = 0; m < 4; ++m) {
    const cudaError_t err = cudaMemcpyToSymbol(g_mats, mats[m], bytes,
                                               off + m * bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaMemcpyToSymbol(g_spos, spos, nn * sizeof(int),
                                       spos_off(n) * sizeof(int));
  if (err == cudaSuccess) {
    fill_log2q<<<1, kLog2Levels>>>();
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

// C entry point, bound with ctypes. resid is int32 (resid_is_float = 0) or
// float32 (B, n, n), contiguous, on the device; inv may be null. The
// constants of n must have been set. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int svt_fullloop_launch(
    const void* resid, int resid_is_float, long long nblocks, int n,
    float deq_dc, float deq_ac, float rnd_dc, float rnd_ac, float zbin_dc,
    float zbin_ac, int log_scale, float* metrics, float* inv, void* stream) {
  if (nblocks <= 0) return 0;
  const QParams qp{deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac, log_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resid_is_float
             ? launch_n<float>(n, resid, nblocks, qp, metrics, inv, s)
             : launch_n<int>(n, resid, nblocks, qp, metrics, inv, s);
}

extern "C" const char* svt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
