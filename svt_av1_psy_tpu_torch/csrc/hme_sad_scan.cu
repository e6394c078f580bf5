// K1 — full-search SAD scan of the low-delay P-frame motion search, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel hme_search_pallas
// (svt_av1_psy_tpu/ops/jax_backend.py). For every half-resolution 8x8 block
// of the decimated source `sh` (one per 16x16 full-resolution block) it
// computes the SAD against the edge-padded decimated reference `rp` at all
// (2R+1)^2 offsets and keeps the first minimal offset in dy-major order,
// exactly as the reference's strict-< running min does.
//
// What bounds it: at 1080p (padded 1088x1920) a frame is 8160 blocks x 625
// offsets x 64 pixels = 3.3e8 integer abs-diff-adds over about 4 MB of
// int32 input. That is instruction issue and shared-memory loads, not
// device-memory bandwidth: each block reads its 32x32 window once.
//
// Design (simple and exact first):
//  - one thread block per 8x8 block; it stages the (8+2R)^2 window of `rp`
//    and the 8x8 source block in shared memory;
//  - each thread scans a strided subset of the offsets;
//  - the block reduces min(sad << 10 | k), k the dy-major offset index.
//    SAD < 2^18 for pixels < 2^12 and k < 1024, so the key fits in int32,
//    and its minimum is the smallest SAD with ties to the lowest k — the
//    reference's tie rule, which an arbitrary parallel argmin would break.
//
// Later work: __vabsdiff4 on packed uint8 pixels, several blocks per CTA
// sharing one window, and fusing the 2x2 decimation and the edge pad into
// the window load (both are PyTorch ops in the wrapper today).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 8;          // half-res block side
constexpr int kThreads = 128;    // 625 offsets -> 5 per thread at R = 12
constexpr int kKeyBits = 10;     // offsets per block must be <= 1 << 10

__global__ void __launch_bounds__(kThreads)
hme_sad_scan_kernel(const int32_t* __restrict__ sh,
                    const int32_t* __restrict__ rp,
                    int32_t* __restrict__ sad_out,
                    int32_t* __restrict__ mv_out, int n16c, int R) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t warp_min[kThreads / 32];
  const int side = 2 * R + 1;
  const int win = kBlk + 2 * R;
  int32_t* s_win = smem;                  // win * win
  int32_t* s_src = smem + win * win;      // kBlk * kBlk

  const int bi = blockIdx.y;
  const int bj = blockIdx.x;
  const int tid = threadIdx.x;
  const int sh_w = n16c * kBlk;
  const int rp_w = sh_w + 2 * R;

  // the window of offsets (dy, dx) in [-R, R]^2 starts at rp[8*bi][8*bj]
  const int32_t* wsrc = rp + (size_t)(bi * kBlk) * rp_w + bj * kBlk;
  for (int e = tid; e < win * win; e += kThreads) {
    const int r = e / win;
    s_win[e] = wsrc[(size_t)r * rp_w + (e - r * win)];
  }
  if (tid < kBlk * kBlk) {
    s_src[tid] = sh[(size_t)(bi * kBlk + (tid >> 3)) * sh_w +
                    bj * kBlk + (tid & 7)];
  }
  __syncthreads();

  int best = INT_MAX;
  for (int k = tid; k < side * side; k += kThreads) {
    const int oy = k / side;
    const int32_t* w = s_win + oy * win + (k - oy * side);
    int s = 0;
#pragma unroll
    for (int r = 0; r < kBlk; ++r) {
#pragma unroll
      for (int c = 0; c < kBlk; ++c) {
        s += abs(s_src[r * kBlk + c] - w[r * win + c]);
      }
    }
    best = min(best, (s << kKeyBits) | k);
  }

  best = __reduce_min_sync(0xffffffffu, best);
  if ((tid & 31) == 0) warp_min[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    int b = warp_min[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) b = min(b, warp_min[i]);
    const int k = b & ((1 << kKeyBits) - 1);
    const int blk = bi * n16c + bj;
    sad_out[blk] = b >> kKeyBits;
    mv_out[2 * blk] = k / side - R;
    mv_out[2 * blk + 1] = k % side - R;
  }
}

}  // namespace

// sh: (8*n16r, 8*n16c) int32; rp: (8*n16r + 2R, 8*n16c + 2R) int32;
// sad: (n16r, n16c) int32; mv: (n16r, n16c, 2) int32 (dy, dx) half-pel.
// Launches on `stream` of `device`; returns cudaGetLastError().
extern "C" int hme_sad_scan(const void* sh, const void* rp, void* sad,
                            void* mv, int n16r, int n16c, int search_range,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int win = kBlk + 2 * search_range;
  const size_t smem = (size_t)(win * win + kBlk * kBlk) * sizeof(int32_t);
  const dim3 grid(n16c, n16r);
  hme_sad_scan_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sh), static_cast<const int32_t*>(rp),
      static_cast<int32_t*>(sad), static_cast<int32_t*>(mv), n16c,
      search_range);
  return static_cast<int>(cudaGetLastError());
}
