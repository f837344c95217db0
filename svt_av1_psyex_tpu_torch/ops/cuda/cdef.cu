// CDEF's direction search, strength-candidate search and apply for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces no Pallas kernel: the JAX package's CDEF is an XLA program
// (svt_av1_psyex_tpu/device/cdef.py) and its host path the C of
// native/cdef.c at the repository's root, which the port ran on one host
// thread. It was added because that C was the largest stage the card sat
// idle behind in a 720p encode. It does what the C does, bit for bit: the
// same directions and variances (svt_cdef_dirs), the same int64 tables of
// per-filter-block distortion for every candidate strength
// (svt_cdef_search), and the same filtered planes (svt_cdef_apply). So an
// encode codes the same bits on either.
//
// Layout: the recon and source planes as the encoder holds them (int32,
// row-major, the plane's width as its stride). The C's padded planes carry
// a 2-sample border and CDEF_VERY_LARGE outside the coded area; here every
// read outside the coded area returns CDEF_VERY_LARGE instead
// (`sample`), so nothing is padded. Units are 8x8 (luma) and 4x4 (4:2:0
// chroma) over an nv8p x nh8p grid of whole 64x64 filter blocks.
//
// Design. Three launches a frame:
//   * dirs: one thread per unit; the 8 x 15 line sums in registers (the
//     loops are unrolled, so their indices are constants), costs in int64.
//   * search: one warp per (searched unit, candidate). Each lane filters
//     two luma samples and one chroma sample (32 = 2 planes x 16), the
//     warp reduces the five luma sums and the chroma SSE with shuffles,
//     and lane 0 computes dist_8x8 and adds both into the unit's filter
//     block with 64-bit atomics. The sums are integers, so the order in
//     which units arrive does not change them.
//   * apply: one thread per output sample of each plane: filtered where
//     its unit is filtered, copied otherwise, read from the unfiltered
//     input, written to a separate output.
//
// Bound (ops/cuda/roofline.py cdef_bound): the direction search by its
// bytes (the luma plane read once); the search and the apply by their
// int32 operations, about 10 a constrained tap and up to 12 taps a
// sample, for each of the level's candidates in the search. The planes
// fit in the 50 MB L2, so re-reads of neighbouring samples hit it.
// This first kernel is right and simple: the reads are 4-byte and only
// partly coalesced, and the search's warps of one unit re-read its
// samples through L1 instead of sharing them in shared memory.
//
// Exactness: integers throughout, but for dist_8x8's float64 formula,
// written with the _rn intrinsics so that nvcc contracts nothing into a
// fused multiply-add and every operation rounds as the C's does; its
// product svar * dvar is an integer below 2^53 at 8 and 10 bits, exact
// either way. Double division and sqrt are IEEE round-to-nearest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVeryLarge = 30000;
constexpr int kThreads = 256;

// Cdef_Directions (dy, dx) for k = 0, 1 (cdef.c:99-120)
__constant__ int kDy[8][2] = {{-1, -2}, {0, -1}, {0, 0}, {0, 1},
                              {1, 2},   {1, 2},  {1, 2}, {1, 2}};
__constant__ int kDx[8][2] = {{1, 2}, {1, 2}, {1, 2}, {1, 2},
                              {1, 2}, {0, 1}, {0, 0}, {0, -1}};

struct Plane {
  const int* p;
  int stride;
  int vh, vw;  // the coded area: rows and columns read as samples
};

__device__ __forceinline__ int sample(const Plane& pl, int y, int x) {
  return (y >= 0 && y < pl.vh && x >= 0 && x < pl.vw)
             ? __ldg(pl.p + static_cast<long long>(y) * pl.stride + x)
             : kVeryLarge;
}

__device__ __forceinline__ int msb32(unsigned v) { return 31 - __clz(v); }

__device__ __forceinline__ int constrain(int diff, int strength,
                                         int damping) {
  if (!strength) return 0;
  const int shift = max(0, damping - msb32(strength));
  const int ad = abs(diff);
  const int v = min(ad, max(0, strength - (ad >> shift)));
  return diff < 0 ? -v : v;
}

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  if (!var) return 0;
  const int v6 = var >> 6;
  const int i = v6 > 0 ? min(msb32(v6), 12) : 0;
  return (strength * (4 + i) + 8) >> 4;
}

// svt_cdef_filter_block_c at one sample (y, x) of a plane
__device__ int filter_sample(const Plane& pl, int y, int x, int dir,
                             int pri, int sec, int damping, int cs) {
  const int c = sample(pl, y, x);
  if (!pri && !sec) return c;
  // the primary taps {4, 2}, or {3, 3} for odd strengths
  const int odd = (pri >> cs) & 1;
  const int pt[2] = {odd ? 3 : 4, odd ? 3 : 2};
  int mn = c, mx = c, sum = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int dy = kDy[dir][k], dx = kDx[dir][k];
    const int p0 = sample(pl, y + dy, x + dx);
    const int p1 = sample(pl, y - dy, x - dx);
    if (pri) {
      sum += pt[k] * constrain(p0 - c, pri, damping);
      sum += pt[k] * constrain(p1 - c, pri, damping);
    }
    if (p0 != kVeryLarge) mx = max(mx, p0);
    if (p1 != kVeryLarge) mx = max(mx, p1);
    mn = min(mn, min(p0, p1));
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int dd = s == 0 ? (dir + 2) & 7 : (dir - 2) & 7;
      const int sy = kDy[dd][k], sx = kDx[dd][k];
      const int s0 = sample(pl, y + sy, x + sx);
      const int s1 = sample(pl, y - sy, x - sx);
      if (sec) {  // the secondary taps {2, 1}
        sum += (2 - k) * constrain(s0 - c, sec, damping);
        sum += (2 - k) * constrain(s1 - c, sec, damping);
      }
      if (s0 != kVeryLarge) mx = max(mx, s0);
      if (s1 != kVeryLarge) mx = max(mx, s1);
      mn = min(mn, min(s0, s1));
    }
  }
  const int v = c + ((8 + sum - (sum < 0)) >> 4);
  return min(max(v, mn), mx);
}

// ---- direction search: one thread per unit ----

__global__ void __launch_bounds__(kThreads)
dirs_kernel(Plane y, int nv8p, int nh8p, int cs, int* __restrict__ dirs,
            int* __restrict__ var) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= nv8p * nh8p) return;
  const int y0 = (bi / nh8p) * 8, x0 = (bi % nh8p) * 8;
  int partial[8][15];
#pragma unroll
  for (int d = 0; d < 8; ++d)
#pragma unroll
    for (int b = 0; b < 15; ++b) partial[d][b] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = (sample(y, y0 + i, x0 + j) >> cs) - 128;
      partial[0][i + j] += x;
      partial[1][i + j / 2] += x;
      partial[2][i] += x;
      partial[3][3 + i - j / 2] += x;
      partial[4][7 + i - j] += x;
      partial[5][3 - i / 2 + j] += x;
      partial[6][j] += x;
      partial[7][i / 2 + j] += x;
    }
  }
  const long long div[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
  long long cost[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) cost[d] = 0;
#pragma unroll
  for (int d = 2; d < 8; d += 4)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      cost[d] += static_cast<long long>(partial[d][i]) * partial[d][i] *
                 div[8];
#pragma unroll
  for (int d = 0; d < 8; d += 4) {
    cost[d] = static_cast<long long>(partial[d][7]) * partial[d][7] * div[8];
#pragma unroll
    for (int i = 0; i < 7; ++i)
      cost[d] += (static_cast<long long>(partial[d][i]) * partial[d][i] +
                  static_cast<long long>(partial[d][14 - i]) *
                      partial[d][14 - i]) *
                 div[i + 1];
  }
#pragma unroll
  for (int d = 1; d < 8; d += 2) {
#pragma unroll
    for (int i = 3; i < 8; ++i)
      cost[d] += static_cast<long long>(partial[d][i]) * partial[d][i] *
                 div[8];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cost[d] += (static_cast<long long>(partial[d][j]) * partial[d][j] +
                  static_cast<long long>(partial[d][10 - j]) *
                      partial[d][10 - j]) *
                 div[2 * j + 2];
  }
  int best = 0;
  long long best_cost = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d)
    if (cost[d] > best_cost) {
      best_cost = cost[d];
      best = d;
    }
  long long opp = cost[0];
#pragma unroll
  for (int d = 1; d < 8; ++d)
    if (d == ((best + 4) & 7)) opp = cost[d];
  dirs[bi] = best;
  var[bi] = static_cast<int>((best_cost - opp) >> 10);
}

// ---- strength search: one warp per (searched unit, candidate) ----

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dist_8xn (enc_cdef.c:76-100) as native/cdef.c dist_8x8 computes it
__device__ long long dist_8x8(long long sum_s, long long sum_d,
                              long long sum_s2, long long sum_d2,
                              long long sum_sd, int cs) {
  const double svar =
      static_cast<double>(sum_s2 - (sum_s * sum_s + 32) / 64);
  const double dvar =
      static_cast<double>(sum_d2 - (sum_d * sum_d + 32) / 64);
  const double num = __dmul_rn(
      __dmul_rn(static_cast<double>(sum_d2 + sum_s2 - 2 * sum_sd), 0.5),
      __dadd_rn(__dadd_rn(svar, dvar),
                static_cast<double>(400 << (2 * cs))));
  const double den = __dsqrt_rn(
      __dadd_rn(static_cast<double>(static_cast<long long>(20000) << (4 * cs)),
                __dmul_rn(svar, dvar)));
  return static_cast<long long>(floor(__dadd_rn(0.5, __ddiv_rn(num, den))));
}

struct SearchArgs {
  Plane y, u, v;        // recon
  Plane sy, su, sv;     // source (vh, vw unused)
  const int* units;     // searched unit indices
  int n_units;
  int nh8p, nhfb;
  const int* dirs;
  const int* var;
  const int* cands;     // strength indices gi = pri * 4 + sec
  int n_cand;
  int ydamp, cdamp, cs, chroma;
  unsigned long long* mse0;  // (nfb, n_cand) int64, zeroed
  unsigned long long* mse1;
};

__global__ void __launch_bounds__(kThreads) search_kernel(SearchArgs a) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(a.n_units) * a.n_cand) return;
  const int ui = static_cast<int>(warp / a.n_cand);
  const int ci = static_cast<int>(warp % a.n_cand);
  const int bi = a.units[ui];
  const int by = bi / a.nh8p, bx = bi % a.nh8p;
  const int fb = (by >> 3) * a.nhfb + (bx >> 3);
  const int gi = a.cands[ci];
  const int pri = gi >> 2;
  int sec = gi & 3;
  sec += sec == 3;
  const int cs = a.cs;
  const int dir = pri ? a.dirs[bi] : 0;
  const int t = adjust_strength(pri << cs, a.var[bi]);

  int s_sum = 0, d_sum = 0, s2 = 0, d2 = 0, sd = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int px = lane + 32 * h;
    const int yy = by * 8 + (px >> 3), xx = bx * 8 + (px & 7);
    const int d = filter_sample(a.y, yy, xx, dir, t, sec << cs, a.ydamp, cs);
    const int s = __ldg(a.sy.p + static_cast<long long>(yy) * a.sy.stride +
                        xx);
    s_sum += s;
    d_sum += d;
    s2 += s * s;
    d2 += d * d;
    sd += s * d;
  }
  s_sum = warp_sum(s_sum);
  d_sum = warp_sum(d_sum);
  s2 = warp_sum(s2);
  d2 = warp_sum(d2);
  sd = warp_sum(sd);

  int sse = 0;
  if (a.chroma) {
    const int px = lane & 15;
    const Plane pl = lane < 16 ? a.u : a.v;
    const Plane sp = lane < 16 ? a.su : a.sv;
    const int yy = by * 4 + (px >> 2), xx = bx * 4 + (px & 3);
    const int d =
        filter_sample(pl, yy, xx, dir, pri << cs, sec << cs, a.cdamp, cs);
    const int e =
        d - __ldg(sp.p + static_cast<long long>(yy) * sp.stride + xx);
    sse = warp_sum(e * e);
  }
  if (lane == 0) {
    const long long at = static_cast<long long>(fb) * a.n_cand + ci;
    atomicAdd(a.mse0 + at, static_cast<unsigned long long>(
                               dist_8x8(s_sum, d_sum, s2, d2, sd, cs)));
    if (a.chroma)
      atomicAdd(a.mse1 + at, static_cast<unsigned long long>(
                                 static_cast<long long>(sse) >> (2 * cs)));
  }
}

// ---- apply: one thread per output sample, blockIdx.y the plane ----

struct ApplyArgs {
  Plane in[3];
  int* out[3];
  int h[3], w[3];   // the planes' shapes
  const unsigned char* mask;
  int nv8p, nh8p;
  const int* dirs;
  const int* var;
  const int* y_gi;
  const int* uv_gi;
  int ydamp, cdamp, cs;
};

__global__ void __launch_bounds__(kThreads) apply_kernel(ApplyArgs a) {
  const int k = blockIdx.y;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int h = a.h[k], w = a.w[k];
  if (i >= static_cast<long long>(h) * w) return;
  const int yy = static_cast<int>(i / w), xx = static_cast<int>(i % w);
  const Plane& pl = a.in[k];
  const int shift = k == 0 ? 3 : 2;
  const int by = yy >> shift, bx = xx >> shift;
  int out;
  const int bi = by * a.nh8p + bx;
  const int gi = (by < a.nv8p && bx < a.nh8p && a.mask[bi])
                     ? (k == 0 ? a.y_gi[bi] : a.uv_gi[bi])
                     : 0;
  if (gi) {
    const int cs = a.cs;
    const int pri = gi >> 2;
    int sec = gi & 3;
    sec += sec == 3;
    const int dir = pri ? a.dirs[bi] : 0;
    const int p = k == 0 ? adjust_strength(pri << cs, a.var[bi]) : pri << cs;
    out = filter_sample(pl, yy, xx, dir, p, sec << cs,
                        k == 0 ? a.ydamp : a.cdamp, cs);
  } else {
    out = __ldg(pl.p + static_cast<long long>(yy) * pl.stride + xx);
  }
  a.out[k][static_cast<long long>(yy) * w + xx] = out;
}

Plane plane(const int* p, int stride, int vh, int vw) {
  Plane pl;
  pl.p = p;
  pl.stride = stride;
  pl.vh = vh;
  pl.vw = vw;
  return pl;
}

}  // namespace

// C entry points, bound with ctypes. Planes are int32, contiguous rows of
// `stride` samples, on the device; (vh, vw) is a plane's coded area.
// Each launches on `stream` and returns the cudaError_t of the launch.

extern "C" int svt_cdef_dirs_launch(const int* y, int stride, int vh, int vw,
                                    int nv8p, int nh8p, int cs, int* dirs,
                                    int* var, void* stream) {
  const int n = nv8p * nh8p;
  if (n <= 0) return 0;
  dirs_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      plane(y, stride, vh, vw), nv8p, nh8p, cs, dirs, var);
  return static_cast<int>(cudaGetLastError());
}

// mse0 and mse1 (nfb, n_cand) int64 are zeroed here, on the stream, then
// accumulated; mse1 only with chroma (u, v, su, sv ignored without).
extern "C" int svt_cdef_search_launch(
    const int* y, int ystride, const int* u, const int* v, int cstride,
    const int* sy, int systride, const int* su, const int* sv, int scstride,
    int vh, int vw, const int* units, int n_units, int nh8p, int nhfb,
    int nfb, const int* dirs, const int* var, const int* cands, int n_cand,
    int ydamp, int cdamp, int cs, int chroma, long long* mse0,
    long long* mse1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = sizeof(long long) * nfb * n_cand;
  cudaError_t err = cudaMemsetAsync(mse0, 0, bytes, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(mse1, 0, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = static_cast<long long>(n_units) * n_cand;
  if (warps <= 0) return 0;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  SearchArgs a;
  a.y = plane(y, ystride, vh, vw);
  a.u = plane(u, cstride, vh >> 1, vw >> 1);
  a.v = plane(v, cstride, vh >> 1, vw >> 1);
  a.sy = plane(sy, systride, vh, vw);
  a.su = plane(su, scstride, vh >> 1, vw >> 1);
  a.sv = plane(sv, scstride, vh >> 1, vw >> 1);
  a.units = units;
  a.n_units = n_units;
  a.nh8p = nh8p;
  a.nhfb = nhfb;
  a.dirs = dirs;
  a.var = var;
  a.cands = cands;
  a.n_cand = n_cand;
  a.ydamp = ydamp;
  a.cdamp = cdamp;
  a.cs = cs;
  a.chroma = chroma;
  a.mse0 = reinterpret_cast<unsigned long long*>(mse0);
  a.mse1 = reinterpret_cast<unsigned long long*>(mse1);
  search_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out* (h*, w*) int32 contiguous, the planes' shapes; with chroma 0 the
// U and V arguments are ignored.
extern "C" int svt_cdef_apply_launch(
    const int* y, int ystride, const int* u, const int* v, int cstride,
    int* oy, int* ou, int* ov, int h, int w, int hc, int wc, int vh, int vw,
    const unsigned char* mask, int nv8p, int nh8p, const int* dirs,
    const int* var, const int* y_gi, const int* uv_gi, int ydamp, int cdamp,
    int cs, int chroma, void* stream) {
  ApplyArgs a;
  a.in[0] = plane(y, ystride, vh, vw);
  a.in[1] = plane(u, cstride, vh >> 1, vw >> 1);
  a.in[2] = plane(v, cstride, vh >> 1, vw >> 1);
  a.out[0] = oy;
  a.out[1] = ou;
  a.out[2] = ov;
  a.h[0] = h;
  a.w[0] = w;
  a.h[1] = a.h[2] = hc;
  a.w[1] = a.w[2] = wc;
  a.mask = mask;
  a.nv8p = nv8p;
  a.nh8p = nh8p;
  a.dirs = dirs;
  a.var = var;
  a.y_gi = y_gi;
  a.uv_gi = uv_gi;
  a.ydamp = ydamp;
  a.cdamp = cdamp;
  a.cs = cs;
  const long long most = static_cast<long long>(h) * w;
  if (most <= 0) return 0;
  const long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), chroma ? 3 : 1);
  apply_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* svt_cdef_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
