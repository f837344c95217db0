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
// Design. The TPU kernel turns each 2-D transform into one Kronecker
// GEMM so that the block batch fills the 128x128 matrix unit; that is a
// TPU layout choice. Here one CTA of 256 threads owns a tile of 1024
// coefficients (one 32x32 block, or 4 / 16 / 64 smaller ones), keeps the
// block, the intermediate and the two matrices of the current pass in
// shared memory, and runs each transform separably, row pass then column
// pass, as fp32 FMAs on the CUDA cores: no TF32, no tensor-core MMA, the
// reference's HIGHEST precision. Each thread owns four consecutive
// coefficients of one block, so a block's reductions (dist, sse, nnz,
// sum log2, eob max) are warp shuffles within its lanes, plus a fixed-order
// sum over the block's warps in shared memory for n >= 16: the result does
// not depend on scheduling.
//
// Bound: per coefficient it reads 4 bytes and writes at most 4, and does
// 4n FMAs, so at n = 32 it is bound by the shared-memory operand traffic of
// the scalar FMAs and at n = 4 by device-memory bytes. A first kernel is
// right and simple; wgmma/TMA tiling is for later work.
//
// Accuracy: the quantizer keeps the reference's operation order with
// explicit round-to-nearest intrinsics (nvcc must not contract it), the
// dequant stays in int32, and the rate terms use log2f (not __log2f) and
// are truncated to int as in the reference. Build without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;  // coefficients per CTA

constexpr int kRateNz = 1229;   // per nonzero coefficient
constexpr int kRateLog2 = 614;  // per log2(1+|q|) of each nonzero
constexpr int kRateZero = 154;  // per zero coefficient before eob
constexpr int kRateEob = 1946;  // per log2(1+eob)

struct QParams {
  float deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac;
  int log_scale;
};

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
fullloop_kernel(const T* __restrict__ resid, long long nblocks,
                const float* __restrict__ fc, const float* __restrict__ fr,
                const float* __restrict__ gc, const float* __restrict__ gr,
                const int* __restrict__ spos, QParams qp,
                float* __restrict__ metrics, float* __restrict__ inv_out) {
  constexpr int NN = N * N;
  constexpr int kBlocksPerCta = kTile / NN;
  constexpr int kThreadsPerBlock = NN / kPerThread;
  constexpr int kWarpsPerBlock = kThreadsPerBlock / 32;

  __shared__ float xs[kTile];
  __shared__ float ts[kTile];
  __shared__ float mat_row[NN];  // row-pass matrix, transposed: [k][l]
  __shared__ float mat_col[NN];  // column-pass matrix: [i][j]
  __shared__ float red_f[kThreads / 32][3];
  __shared__ int red_i[kThreads / 32][2];

  const int tid = threadIdx.x;
  const int lb = tid / kThreadsPerBlock;             // block within the CTA
  const long long gb = (long long)blockIdx.x * kBlocksPerCta + lb;
  const bool valid = gb < nblocks;
  const int e0 = tid * kPerThread;                   // first tile element
  const int q0 = e0 - lb * NN;                       // first row-major index
  float* xb = xs + lb * NN;
  float* tb = ts + lb * NN;

  for (int i = tid; i < NN; i += kThreads) {
    mat_row[(i % N) * N + i / N] = fr[i];
    mat_col[i] = fc[i];
  }
  float x[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    x[r] = valid ? static_cast<float>(resid[gb * NN + q0 + r]) : 0.0f;
    xs[e0 + r] = x[r];
  }
  __syncthreads();

  // forward row pass: t[j][l] = sum_k x[j][k] * fr[l][k]
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = (q0 + r) / N, l = (q0 + r) % N;
    float a = 0.0f;
#pragma unroll 8
    for (int k = 0; k < N; ++k) a = fmaf(xb[j * N + k], mat_row[k * N + l], a);
    tb[j * N + l] = a;
  }
  __syncthreads();

  // forward column pass: c[i][l] = sum_j fc[i][j] * t[j][l]
  float c[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = (q0 + r) / N, l = (q0 + r) % N;
    float a = 0.0f;
#pragma unroll 8
    for (int j = 0; j < N; ++j) a = fmaf(mat_col[i * N + j], tb[j * N + l], a);
    c[r] = a;
  }
  __syncthreads();  // every read of ts and of the forward matrices is done

  // quantize, dequantize, rate terms
  int nnz = 0, eob = 0;
  float slog = 0.0f;
  const float num = static_cast<float>(1 << qp.log_scale);
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int q = q0 + r;
    const bool dc = q == 0;
    const float deq = dc ? qp.deq_dc : qp.deq_ac;
    const float rnd = dc ? qp.rnd_dc : qp.rnd_ac;
    const float zbin = dc ? qp.zbin_dc : qp.zbin_ac;
    const float ac = fabsf(c[r]);
    const float scale = __fdiv_rn(num, deq);
    int qa = static_cast<int>(floorf(__fmul_rn(__fadd_rn(ac, rnd), scale)));
    qa = ac >= zbin ? max(qa, 0) : 0;
    int dq = (qa * static_cast<int>(deq)) >> qp.log_scale;
    if (c[r] < 0.0f) dq = -dq;
    tb[q] = static_cast<float>(dq);
    if (qa != 0) {
      ++nnz;
      eob = max(eob, __ldg(spos + q) + 1);
      slog = __fadd_rn(slog, log2f(__fadd_rn(1.0f, static_cast<float>(qa))));
    }
  }
  for (int i = tid; i < NN; i += kThreads) {
    mat_row[(i % N) * N + i / N] = gr[i];
    mat_col[i] = gc[i];
  }
  __syncthreads();

  // inverse row pass: u[j][l] = sum_k dq[j][k] * gr[l][k]  (into xs)
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = (q0 + r) / N, l = (q0 + r) % N;
    float a = 0.0f;
#pragma unroll 8
    for (int k = 0; k < N; ++k) a = fmaf(tb[j * N + k], mat_row[k * N + l], a);
    xb[j * N + l] = a;
  }
  __syncthreads();

  // inverse column pass: inv[i][l] = sum_j gc[i][j] * u[j][l]
  float dist = 0.0f, sse = 0.0f;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = (q0 + r) / N, l = (q0 + r) % N;
    float a = 0.0f;
#pragma unroll 8
    for (int j = 0; j < N; ++j) a = fmaf(mat_col[i * N + j], xb[j * N + l], a);
    if (inv_out != nullptr && valid) inv_out[gb * NN + q0 + r] = a;
    const float err = __fsub_rn(x[r], a);
    dist = __fadd_rn(dist, __fmul_rn(err, err));
    sse = __fadd_rn(sse, __fmul_rn(x[r], x[r]));
  }

  // per-block reductions: butterflies within the block's lanes ...
  constexpr int kLanes = kThreadsPerBlock < 32 ? kThreadsPerBlock : 32;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    dist += __shfl_xor_sync(0xffffffffu, dist, off);
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
    slog += __shfl_xor_sync(0xffffffffu, slog, off);
    nnz += __shfl_xor_sync(0xffffffffu, nnz, off);
    eob = max(eob, __shfl_xor_sync(0xffffffffu, eob, off));
  }
  // ... then, for blocks wider than a warp, over its warps in order
  if constexpr (kWarpsPerBlock > 1) {
    const int warp = tid / 32;
    if (tid % 32 == 0) {
      red_f[warp][0] = dist;
      red_f[warp][1] = sse;
      red_f[warp][2] = slog;
      red_i[warp][0] = nnz;
      red_i[warp][1] = eob;
    }
    __syncthreads();
    if (tid % kThreadsPerBlock == 0) {
      const int w0 = lb * kWarpsPerBlock;
      dist = red_f[w0][0];
      sse = red_f[w0][1];
      slog = red_f[w0][2];
      nnz = red_i[w0][0];
      eob = red_i[w0][1];
      for (int w = w0 + 1; w < w0 + kWarpsPerBlock; ++w) {
        dist += red_f[w][0];
        sse += red_f[w][1];
        slog += red_f[w][2];
        nnz += red_i[w][0];
        eob = max(eob, red_i[w][1]);
      }
    }
  }

  if (valid && tid % kThreadsPerBlock == 0) {
    const int rate =
        kRateNz * nnz +
        static_cast<int>(__fmul_rn(static_cast<float>(kRateLog2), slog)) +
        kRateZero * max(eob - nnz, 0) +
        static_cast<int>(__fmul_rn(
            static_cast<float>(kRateEob),
            log2f(__fadd_rn(1.0f, static_cast<float>(eob)))));
    float* m = metrics + gb * 8;
    m[0] = dist;
    m[1] = static_cast<float>(rate);
    m[2] = static_cast<float>(eob);
    m[3] = sse;
    m[4] = m[5] = m[6] = m[7] = 0.0f;
  }
}

template <int N, typename T>
void launch(const void* resid, long long nblocks, const float* fc,
            const float* fr, const float* gc, const float* gr,
            const int* spos, QParams qp, float* metrics, float* inv,
            cudaStream_t stream) {
  constexpr int kBlocksPerCta = kTile / (N * N);
  const long long ctas = (nblocks + kBlocksPerCta - 1) / kBlocksPerCta;
  fullloop_kernel<N, T><<<static_cast<unsigned>(ctas), kThreads, 0,
                          stream>>>(static_cast<const T*>(resid), nblocks,
                                    fc, fr, gc, gr, spos, qp, metrics, inv);
}

template <typename T>
int launch_n(int n, const void* resid, long long nblocks, const float* fc,
             const float* fr, const float* gc, const float* gr,
             const int* spos, QParams qp, float* metrics, float* inv,
             cudaStream_t stream) {
  switch (n) {
    case 4: launch<4, T>(resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, stream); break;
    case 8: launch<8, T>(resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, stream); break;
    case 16: launch<16, T>(resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, stream); break;
    case 32: launch<32, T>(resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point, bound with ctypes. resid is int32 (resid_is_float = 0) or
// float32 (B, n, n), contiguous; fc/fr are (n, n) forward, gc/gr (n, n)
// inverse matrices and spos (n*n,) int32, all on the device; inv may be
// null. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int svt_fullloop_launch(
    const void* resid, int resid_is_float, long long nblocks, int n,
    const float* fc, const float* fr, const float* gc, const float* gr,
    const int* spos, float deq_dc, float deq_ac, float rnd_dc, float rnd_ac,
    float zbin_dc, float zbin_ac, int log_scale, float* metrics, float* inv,
    void* stream) {
  if (nblocks <= 0) return 0;
  const QParams qp{deq_dc, deq_ac, rnd_dc, rnd_ac, zbin_dc, zbin_ac, log_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return resid_is_float
             ? launch_n<float>(n, resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, s)
             : launch_n<int>(n, resid, nblocks, fc, fr, gc, gr, spos, qp, metrics, inv, s);
}

extern "C" const char* svt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
