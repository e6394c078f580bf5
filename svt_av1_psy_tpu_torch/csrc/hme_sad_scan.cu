// K1 — full-search SAD scan of the low-delay P-frame motion search, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel hme_search_pallas
// (svt_av1_psy_tpu/ops/jax_backend.py) together with the decimation and
// the edge pad that surround it there. From two full-resolution (H, W)
// pixel planes it forms, per 16x16 block, the SAD of the block's 8x8
// half-resolution pixels (rounded 2x2 means) against the edge-padded
// half-resolution reference at all (2R+1)^2 offsets, and keeps the first
// minimal offset in dy-major order, exactly as the reference's strict-<
// running min does. One launch writes mv (int16, full-pel) and sad (int32).
//
// What bounds it. By the roofline rule (each input read once, each output
// written once) it is bytes: an 8-bit 1088x1920 pair is 4.2 MB, 1.3 us at
// 3.35 TB/s, and its 6.6e8 operations take 0.34 us at the int8 tensor-core
// peak. In practice it is the integer lanes: a SAD is a sum of absolute
// values, which is not bilinear, so neither wgmma nor the int8 mma computes
// it exactly, and the 8160 x 625 x 64 absolute differences run on the CUDA
// cores. Packed four to a word they are 8.2e7 lane operations, some 5-6 us
// on 132 SMs at 64 lanes per SM and clock.
//
// Design:
//  - a CTA takes a tile of blocks (the wrapper picks 4 x 8) and stages ONE
//    window of the decimated reference for all of them in shared memory:
//    (8*rows + 2R) x (8*cols + 2R) pixels, packed in the pixels' own width
//    (uint8 four to a word, 16-bit two to a word). Neighbouring blocks'
//    windows overlap by three quarters, so a shared window costs 2.4 loaded
//    pixels per source pixel where one window per block costs 16;
//  - decimation and edge pad are fused into that load: a window pixel at
//    half-res (y, x) is the 2x2 mean at (clamp(y), clamp(x)), clamped in
//    HALF-res coordinates (clamping the full-res rows one by one would
//    average a border row with itself). Interior words come from two
//    8-byte loads and packed 16-bit-lane sums, border words pixel by pixel.
//    Nothing subtracts or sums in 8 bits outside the packed intrinsics;
//  - a thread takes one (block, dx) pair: the block's 8x8 source pixels
//    live in 16 registers (32 for 16-bit), and the thread walks the 8 + 2R
//    window rows once, extracting its 8 unaligned pixels per row from
//    neighbouring words with a funnel shift. Row r feeds the eight
//    offsets dy = r - 7 .. r, whose sums sit in a rotating set of eight
//    registers; at R = 12 (the only range the encoder uses) the walk is a
//    compile-time unroll and the rotation costs nothing, other ranges
//    take a runtime loop of the same body;
//  - SAD steps are packed. 8-bit: vabsdiff4 with its accumulate operand,
//    one VABSDIFF4 per four pixels, 16 per block and offset. 16-bit:
//    vabsdiff2 has no instruction on this card (ptxas emulates it with
//    byte permutes, 3.4 times slower here), so max - min per 16-bit lane
//    (two VIMNMX) and one dot product (IDP.2A) that adds both lanes;
//  - each thread reduces min(sad << 10 | k), k the dy-major offset index,
//    and the threads of one block combine with atomicMin on a shared word.
//    SAD < 2^18 for pixels < 2^12 and k < 1024, so the key fits in int32
//    and is a total order: its minimum is the smallest SAD with ties to
//    the lowest k — the reference's tie rule — under any parallel order.
//
// The planes (4.2 MB) stay in the 50 MB L2 after first touch and the window
// fill is a few percent of the scan, so no cp.async / TMA pipeline: TMA
// fills out-of-bounds with zeros, not with the edge, and the decimation
// has to run between the copy and the packed window anyway.
//
// What the compiler made of it (nvcc 12.8, -O3, sm_90a; ptxas -v and
// cuobjdump -sass through kernels/k1_bench.py): 63 registers for the 8-bit
// kernel at R = 12 and 64 for the 16-bit one under __launch_bounds__(512,
// 2), no spills, two CTAs of 416 threads per SM; the R = 12 walk holds
// exactly 400 VABSDIFF4 (25 dy x 16) beside 109 LDS and 120 SHF in a
// kernel of 1608 opcodes: the SAD steps are the largest share of the
// walk. Times and what limits them: PERF.md.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlk = 8;           // half-res block side
constexpr int kMaxThreads = 512;  // the wrapper launches at most this many
constexpr int kKeyBits = 10;      // offsets per block must be <= 1 << 10

// Packed-word arithmetic for one pixel width.
template <typename Pix>
struct Packed;

template <>
struct Packed<uint8_t> {
  static constexpr int kPerWord = 4;
  static __device__ __forceinline__ uint32_t sad(uint32_t a, uint32_t b,
                                                 uint32_t acc) {
    // one VABSDIFF4 with its accumulate operand (__vsadu4 takes none)
    uint32_t d;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(d) : "r"(a), "r"(b), "r"(acc));
    return d;
  }
  // four half-res pixels from 8 + 8 full-res bytes (two rows)
  static __device__ __forceinline__ uint32_t decimate(uint2 a, uint2 b) {
    constexpr uint32_t m = 0x00FF00FFu;
    uint32_t lo = (a.x & m) + ((a.x >> 8) & m) + (b.x & m) +
                  ((b.x >> 8) & m) + 0x00020002u;
    uint32_t hi = (a.y & m) + ((a.y >> 8) & m) + (b.y & m) +
                  ((b.y >> 8) & m) + 0x00020002u;
    return __byte_perm((lo >> 2) & m, (hi >> 2) & m, 0x6420);
  }
};

template <>
struct Packed<uint16_t> {
  static constexpr int kPerWord = 2;
  static __device__ __forceinline__ uint32_t sad(uint32_t a, uint32_t b,
                                                 uint32_t acc) {
    // sm_90a has no two-lane VABSDIFF (vabsdiff2 is emulated with byte
    // permutes): max - min per 16-bit lane, which never borrows across
    // lanes, then both lanes added into acc by one dot product
    return __dp2a_lo(__vmaxu2(a, b) - __vminu2(a, b), 0x0101u, acc);
  }
  // two half-res pixels from 4 + 4 full-res 16-bit pixels (two rows)
  static __device__ __forceinline__ uint32_t decimate(uint2 a, uint2 b) {
    uint32_t p0 = ((a.x & 0xFFFFu) + (a.x >> 16) + (b.x & 0xFFFFu) +
                   (b.x >> 16) + 2u) >> 2;
    uint32_t p1 = ((a.y & 0xFFFFu) + (a.y >> 16) + (b.y & 0xFFFFu) +
                   (b.y >> 16) + 2u) >> 2;
    return p0 | (p1 << 16);
  }
};

// One packed word of the decimated plane: half-res row y, columns x0 ..
// x0 + kPerWord - 1, every coordinate clamped to the half-res plane
// (Hh x Wh). `plane` is the full-resolution plane, W pixels wide.
template <typename Pix>
__device__ __forceinline__ uint32_t decimated_word(
    const Pix* __restrict__ plane, int W, int Hh, int Wh, int y, int x0) {
  using P = Packed<Pix>;
  const int yc = min(max(y, 0), Hh - 1);
  const Pix* row0 = plane + (size_t)(2 * yc) * W;
  const Pix* row1 = row0 + W;
  if (x0 >= 0 && x0 + P::kPerWord <= Wh && (x0 % P::kPerWord) == 0) {
    // 2 * x0 pixels is a multiple of 8 bytes; rows are 16-byte multiples
    const uint2 a = *reinterpret_cast<const uint2*>(row0 + 2 * x0);
    const uint2 b = *reinterpret_cast<const uint2*>(row1 + 2 * x0);
    return P::decimate(a, b);
  }
  uint32_t word = 0;
#pragma unroll
  for (int p = 0; p < P::kPerWord; ++p) {
    const int xc = 2 * min(max(x0 + p, 0), Wh - 1);
    const uint32_t v = ((uint32_t)row0[xc] + row0[xc + 1] + row1[xc] +
                        row1[xc + 1] + 2u) >> 2;
    word |= v << (p * (32 / P::kPerWord));
  }
  return word;
}

// RCT: the search range when it is known at compile time, else -1.
template <typename Pix, int RCT>
__global__ void __launch_bounds__(kMaxThreads, 2)
hme_sad_scan_kernel(const Pix* __restrict__ src, const Pix* __restrict__ ref,
                    int32_t* __restrict__ sad_out,
                    uint32_t* __restrict__ mv_out, int H, int W, int R_arg,
                    int tile_r, int tile_c) {
  using P = Packed<Pix>;
  constexpr int kPerWord = P::kPerWord;
  constexpr int kRowWords = kBlk / kPerWord;      // words per block row
  constexpr int kPixBits = 32 / kPerWord;
  extern __shared__ uint32_t smem[];

  const int R = RCT >= 0 ? RCT : R_arg;
  const int side = 2 * R + 1;
  const int Hh = H / 2, Wh = W / 2;
  const int n16r = Hh / kBlk, n16c = Wh / kBlk;
  const int win_h = kBlk * tile_r + 2 * R;
  const int win_w = kBlk * tile_c + 2 * R;
  const int win_words = (win_w + kPerWord - 1) / kPerWord;
  // one spare word per row: a thread reads kRowWords + 1 words from its
  // first one, and the last of them may lie past the window's pixels
  const int stride = win_words + 1;
  const int src_words = tile_c * kRowWords;
  const int n_blk = tile_r * tile_c;

  uint32_t* s_win = smem;                              // win_h * stride
  uint32_t* s_src = s_win + win_h * stride;            // 8*tile_r * src_words
  int* s_best = reinterpret_cast<int*>(s_src + kBlk * tile_r * src_words);

  const int tid = threadIdx.x;
  const int n_thr = blockDim.x;
  const int by0 = blockIdx.y * tile_r;                 // first block row
  const int bx0 = blockIdx.x * tile_c;
  const int wy0 = kBlk * by0 - R;                      // window origin
  const int wx0 = kBlk * bx0 - R;

  for (int e = tid; e < win_h * win_words; e += n_thr) {
    const int r = e / win_words;
    const int c = e - r * win_words;
    s_win[r * stride + c] = decimated_word<Pix>(ref, W, Hh, Wh, wy0 + r,
                                                wx0 + c * kPerWord);
  }
  for (int e = tid; e < kBlk * tile_r * src_words; e += n_thr) {
    const int r = e / src_words;
    const int c = e - r * src_words;
    s_src[e] = decimated_word<Pix>(src, W, Hh, Wh, kBlk * by0 + r,
                                   kBlk * bx0 + c * kPerWord);
  }
  for (int e = tid; e < n_blk; e += n_thr) s_best[e] = INT_MAX;
  __syncthreads();

  for (int item = tid; item < n_blk * side; item += n_thr) {
    const int lb = item / side;
    const int dxi = item - lb * side;
    const int ty = lb / tile_c;
    const int tx = lb - ty * tile_c;
    if (by0 + ty >= n16r || bx0 + tx >= n16c) continue;   // ragged tile

    uint32_t s[kBlk][kRowWords];
#pragma unroll
    for (int j = 0; j < kBlk; ++j) {
#pragma unroll
      for (int c = 0; c < kRowWords; ++c) {
        s[j][c] = s_src[(ty * kBlk + j) * src_words + tx * kRowWords + c];
      }
    }
    const int o = tx * kBlk + dxi;                 // first window column
    const uint32_t* wp = s_win + ty * kBlk * stride + o / kPerWord;
    const int shift = (o % kPerWord) * kPixBits;

    // acc[k] sums offset row dyi = r - k while the walk is at window row r
    uint32_t acc[kBlk];
#pragma unroll
    for (int k = 0; k < kBlk; ++k) acc[k] = 0;
    int best = INT_MAX;
    const int rows = kBlk + 2 * R;
#pragma unroll
    for (int r = 0; r < rows; ++r) {
      uint32_t raw[kRowWords + 1], w[kRowWords];
#pragma unroll
      for (int c = 0; c <= kRowWords; ++c) raw[c] = wp[r * stride + c];
#pragma unroll
      for (int c = 0; c < kRowWords; ++c) {
        w[c] = __funnelshift_r(raw[c], raw[c + 1], shift);
      }
#pragma unroll
      for (int k = 0; k < kBlk; ++k) {
        // with a compile-time range, skip the sums no offset keeps
        if (RCT < 0 || (r - k >= 0 && r - k <= 2 * RCT)) {
#pragma unroll
          for (int c = 0; c < kRowWords; ++c) {
            acc[k] = P::sad(s[k][c], w[c], acc[k]);
          }
        }
      }
      const int dyi = r - (kBlk - 1);              // acc[7] is complete
      if (dyi >= 0) {
        best = min(best, (int)((acc[kBlk - 1] << kKeyBits) |
                               (uint32_t)(dyi * side + dxi)));
      }
#pragma unroll
      for (int k = kBlk - 1; k > 0; --k) acc[k] = acc[k - 1];
      acc[0] = 0;
    }
    atomicMin(&s_best[lb], best);
  }
  __syncthreads();

  for (int lb = tid; lb < n_blk; lb += n_thr) {
    const int ty = lb / tile_c;
    const int tx = lb - ty * tile_c;
    if (by0 + ty >= n16r || bx0 + tx >= n16c) continue;
    const int key = s_best[lb];
    const int k = key & ((1 << kKeyBits) - 1);
    const int dy = k / side - R;
    const int dx = k - (k / side) * side - R;
    const int blk = (by0 + ty) * n16c + bx0 + tx;
    sad_out[blk] = key >> kKeyBits;
    // (dy, dx) full-pel as two int16 in one store
    mv_out[blk] = ((uint32_t)(2 * dy) & 0xFFFFu) | ((uint32_t)(2 * dx) << 16);
  }
}

template <typename Pix>
cudaError_t launch(const void* src, const void* ref, void* sad, void* mv,
                   int h, int w, int R, int tile_r, int tile_c, dim3 grid,
                   int threads, size_t smem, cudaStream_t stream) {
  const Pix* s = static_cast<const Pix*>(src);
  const Pix* r = static_cast<const Pix*>(ref);
  int32_t* so = static_cast<int32_t*>(sad);
  uint32_t* mo = static_cast<uint32_t*>(mv);
  if (R == 12) {
    hme_sad_scan_kernel<Pix, 12><<<grid, threads, smem, stream>>>(
        s, r, so, mo, h, w, R, tile_r, tile_c);
  } else {
    hme_sad_scan_kernel<Pix, -1><<<grid, threads, smem, stream>>>(
        s, r, so, mo, h, w, R, tile_r, tile_c);
  }
  return cudaGetLastError();
}

}  // namespace

// src, ref: (h, w) full-resolution planes of pixel_bytes (1: uint8, 2:
// 16-bit with pixels < 2^12) per pixel, 8-byte aligned, h and w multiples
// of 16; sad: (h/16, w/16) int32; mv: (h/16, w/16, 2) int16 (dy, dx)
// full-pel. The launch geometry (tile of tile_r x tile_c blocks per CTA,
// grid, threads <= 512, shared-memory bytes <= 48 KB) is the caller's:
// kernels/hme.py launch_geometry. Launches on `stream` of `device`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a geometry or
// pixel width the kernel does not take).
extern "C" int hme_sad_scan(const void* src, const void* ref, void* sad,
                            void* mv, int h, int w, int search_range,
                            int pixel_bytes, int tile_r, int tile_c,
                            int grid_x, int grid_y, int threads,
                            int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int side = 2 * search_range + 1;
  if (search_range < 0 || side * side > (1 << kKeyBits) || threads < 1 ||
      threads > kMaxThreads || tile_r < 1 || tile_c < 1 ||
      grid_x * tile_c < w / 16 || grid_y * tile_r < h / 16 ||
      (pixel_bytes != 1 && pixel_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(grid_x, grid_y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pixel_bytes == 1) {
    err = launch<uint8_t>(src, ref, sad, mv, h, w, search_range, tile_r,
                          tile_c, grid, threads, smem_bytes, st);
  } else {
    err = launch<uint16_t>(src, ref, sad, mv, h, w, search_range, tile_r,
                           tile_c, grid, threads, smem_bytes, st);
  }
  return static_cast<int>(err);
}
