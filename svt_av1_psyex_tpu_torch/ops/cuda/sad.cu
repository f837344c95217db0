// Full-resolution ME SAD lattice for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `sad_lattice` (body `_sad_kernel`) in
// svt_av1_psyex_tpu/ops/pallas/sad.py. Per superblock: a 64x64 source tile
// and its 80x80 search window (gathered with spec MC edge clamping); for
// each of the 289 full-pel offsets (dy, dx) in [0, 16]^2, offset index
// o = dy * 17 + dx, the 8x8 grid of 8x8-box sums of
// |tile - win[dy:dy+64, dx:dx+64]|. Output (nSB, 289, 8, 8) int32.
//
// Design. The TPU kernel rolls the window through the lanes and box-sums
// with two pooling matmuls, because Mosaic has no lane-unaligned slices
// and no (64,64)->(8,8,8,8) reshape; none of that applies here. One CTA of
// 256 threads owns one superblock and four consecutive dy: the tile and
// the 67 window rows those dy read are copied into shared memory once, as
// int32, and each thread owns one 8x8 box at one dy and all 17 dx. For
// each of the box's 8 rows it holds the tile's 8 samples and the window's
// 24 samples in registers and adds the 17 x 8 absolute differences into
// 17 int32 accumulators, so every shared-memory word it reads serves 4 to
// 17 differences. Threads of a dy past 16 (the last group of a superblock)
// only help with the copy. Both shared arrays are padded so that the
// 128-bit shared loads of a quarter warp hit distinct banks: the tile is
// stored box-major with a 68-word box stride, the window with 4 spare
// words after every 32 columns.
//
// Bound: 289 x 4096 absolute differences per superblock from 36 KB of
// input, so it is bound by integer issue, not by device memory. A first
// kernel is right and simple; making it faster is later work.
//
// Exactness: integer arithmetic only. A box sum is at most 64 x 1023 at
// 10 bits, far inside int32, so the result equals the plain version's bit
// for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 64;                 // superblock side
constexpr int kN = 17;                   // shifts per axis (+-8)
constexpr int kNoff = kN * kN;           // 289 offsets
constexpr int kSpan = 80;                // window side
constexpr int kDyPerCta = 4;
constexpr int kGroups = (kN + kDyPerCta - 1) / kDyPerCta;  // 5 CTAs per SB
constexpr int kThreads = kDyPerCta * 64;  // one thread per (dy, box)
constexpr int kTileStride = 68;          // words per box: 64 + 4 pad
constexpr int kWinRows = kBlk + kDyPerCta - 1;
constexpr int kWinStride = 88;           // 80 columns + 2 x 4 pad

// shared-memory column of window column c: 4 spare words after every 32
__device__ __forceinline__ int win_col(int c) { return c + (c >> 5) * 4; }

__global__ void __launch_bounds__(kThreads)
sad_kernel(const int* __restrict__ tiles, const int* __restrict__ wins,
           int* __restrict__ out) {
  __shared__ __align__(16) int tile_s[64 * kTileStride];
  __shared__ __align__(16) int win_s[kWinRows * kWinStride];

  const long long sb = blockIdx.x / kGroups;
  const int dy0 = static_cast<int>(blockIdx.x % kGroups) * kDyPerCta;
  const int* tile = tiles + sb * (kBlk * kBlk);
  const int* win = wins + sb * (kSpan * kSpan);

  for (int i = threadIdx.x; i < kBlk * kBlk; i += kThreads) {
    const int y = i >> 6, x = i & 63;
    tile_s[((y >> 3) * 8 + (x >> 3)) * kTileStride + (y & 7) * 8 + (x & 7)] =
        tile[i];
  }
  const int rows = min(kWinRows, kSpan - dy0);
  for (int i = threadIdx.x; i < rows * kSpan; i += kThreads) {
    const int r = i / kSpan, c = i - r * kSpan;
    win_s[r * kWinStride + win_col(c)] = win[(dy0 + r) * kSpan + c];
  }
  __syncthreads();

  const int dyi = threadIdx.x >> 6;
  const int box = threadIdx.x & 63;
  const int dy = dy0 + dyi;
  if (dy >= kN) return;  // masked: the last group has one dy
  const int by = box >> 3, bx = box & 7;

  int acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0;

  const int* trow = tile_s + box * kTileStride;
  for (int r = 0; r < 8; ++r) {
    int t[8], w[24];
    const int4 t0 = *reinterpret_cast<const int4*>(trow + r * 8);
    const int4 t1 = *reinterpret_cast<const int4*>(trow + r * 8 + 4);
    t[0] = t0.x; t[1] = t0.y; t[2] = t0.z; t[3] = t0.w;
    t[4] = t1.x; t[5] = t1.y; t[6] = t1.z; t[7] = t1.w;
    const int* wrow = win_s + (dyi + by * 8 + r) * kWinStride;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int4 v =
          *reinterpret_cast<const int4*>(wrow + win_col(bx * 8 + 4 * j));
      w[4 * j] = v.x; w[4 * j + 1] = v.y; w[4 * j + 2] = v.z;
      w[4 * j + 3] = v.w;
    }
#pragma unroll
    for (int dx = 0; dx < kN; ++dx) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[dx] += abs(t[c] - w[dx + c]);
    }
  }

  int* o = out + (sb * kNoff + dy * kN) * 64 + box;
#pragma unroll
  for (int dx = 0; dx < kN; ++dx) o[dx * 64] = acc[dx];
}

}  // namespace

// C entry point, bound with ctypes. tiles (nsb, 64, 64) and wins
// (nsb, 80, 80) int32, out (nsb, 289, 8, 8) int32, all contiguous on the
// device. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int svt_sad_launch(const int* tiles, const int* wins,
                              long long nsb, int* out, void* stream) {
  if (nsb <= 0) return 0;
  const long long ctas = nsb * kGroups;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sad_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(tiles, wins, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
