// CDEF on the card — the frame-level CDEF apply and strength search of the
// fast encoder path, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package and the port ran this stage in
// the shared host C (native/cdef_backend.c tpue_cdef, through native.py
// cdef_run, banded over 4 threads): it held 135-170 ms of every 1080p frame
// on the encoder thread while the card sat idle, so it moves onto the card.
// The arithmetic is tpue_cdef's, bit for bit: find_dir once per 8x8 block,
// adjust_strength on luma only, the primary direction only where the
// primary strength is not 0, chroma at damping + coeff_shift - 1 with the
// co-located luma direction, reads outside the MI AREA (mi_cols*4 x
// mi_rows*4, not the display size) seeing 0x7F7F, an SSE over display
// pixels only, and a candidate with pri = sec = 0 giving the unfiltered
// SSE (the C's !apply branch).
//
// One launch does one of two things over a list of 8x8 block origins:
//  - search: for each of K strength quadruples (y_pri, y_sec, uv_pri,
//    uv_sec) the luma and chroma SSE against the source, as int64. The
//    distinct luma and chroma (pri, sec) pairs are filtered once each; the
//    sums are integer atomics, so they are exact and equal the C's float64
//    sums (every term is an integer, the total far below 2^53);
//  - apply: the filtered pixels of one quadruple written over the whole
//    mi-area extent of each listed block into output planes that start as
//    copies of the input (a block reads its neighbours' pre-CDEF pixels).
//
// What bounds it. A 1080p search (the 21 quadruples of the encoder's
// ladder, 18 luma and 3 chroma pairs plus the unfiltered chroma, over a
// quarter of the 32,400 blocks) reads the 4.1 MB pre-CDEF mi area and the
// 3.1 MB 8-bit source once: 2.2 us at 3.35 TB/s. Its integer work is some
// 1.2e9 operations (per block ~1,000 for the direction; per pixel and
// candidate 41 for the 12 taps' max/min tests and the rounding, and
// constrain's 9 for each of the 4 primary taps where pri != 0 and each of
// the 8 secondary taps where sec != 0; kernels/cdef.py cdef_work counts
// them): ~71 us on 132 SMs at 64 integer lanes per SM and clock, so it is
// bound by the integer lanes, as the C is by its one core per band. An
// apply is ~4.2e8 operations and ~13 MB of traffic: ~25 us.
//
// Design: the blocks are independent and the frame (~7 MB) sits in the
// 50 MB L2, so each warp takes one block at a time and stages only that
// block's halo in shared memory: the 12x12 luma window and the two 8x8
// chroma windows (the 4x4 block and 2 pixels around), 0x7F7F outside the
// mi area. The 8 x 15 direction partial sums are shared-memory atomics of
// the 64 pixels (2 per lane), lanes 0-7 form one direction's cost each,
// and shuffles give every lane the first maximum, as the C's strict >
// does. Each candidate then filters 2 luma pixels per lane, and 1 chroma
// pixel per lane (16 per plane); a candidate's SSE is a warp shuffle sum
// added into the CTA's shared int64 totals, which go to the output once
// per CTA. No TMA or cp.async: a block's windows are 272 reads that hit
// L2, against ~147,000 operations of filtering per block in a search.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kVeryLarge = 0x7F7F;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCand = 32;
constexpr int kMaxCtas = 132 * 8;
constexpr int kLw = 12;  // luma window side: the 8x8 block and 2 around
constexpr int kCw = 8;   // chroma window side: the 4x4 block and 2 around

__constant__ int kDirs[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}},
    {{0, 1}, {1, 2}},   {{1, 1}, {2, 2}},  {{1, 0}, {2, 1}},
    {{1, 0}, {2, 0}},   {{1, 0}, {2, -1}}};
__constant__ int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};

struct Frame {
  const uint16_t* in[3];      // pre-CDEF mi area: (gh, gw), (gh/2, gw/2)
  const void* src[3];         // sources, uint8 or uint16; null: no SSE
  uint16_t* out[3];           // apply: the output planes; null: search
  const int* blocks;          // (n_blocks, 2) pixel origins (y0, x0)
  unsigned long long* sse;    // (k, 2): luma, chroma per quadruple
  int n_blocks, gh, gw, w, h;
  int src_stride[2], src_bytes;
  int coeff_shift, damping;
};

struct Cands {
  int ky, kc, k;
  int y[kMaxCand][2];         // distinct luma (pri, sec) pairs
  int c[kMaxCand][2];         // distinct chroma (pri, sec) pairs
  int qy[kMaxCand], qc[kMaxCand];  // per quadruple: its pairs
};

__device__ __forceinline__ int constrain(int diff, int strength,
                                         int damping) {
  if (!strength) return 0;
  const int shift = max(damping - (31 - __clz(strength)), 0);
  const int ad = abs(diff);
  const int v = min(ad, max(strength - (ad >> shift), 0));
  return diff < 0 ? -v : v;
}

__device__ __forceinline__ int adjust_strength(int strength, int var) {
  if (var == 0) return 0;
  const int v6 = var >> 6;
  const int i = v6 ? min(31 - __clz(v6), 12) : 0;
  return (strength * (4 + i) + 8) >> 4;
}

// one pixel of filter_block: (i, j) in the block, at (i + 2, j + 2) of a
// window of side ws
__device__ __forceinline__ int filter_px(const int* win, int ws, int i,
                                         int j, int pri, int sec, int dir,
                                         int damping, int coeff_shift) {
  const int taps_i = (pri >> coeff_shift) & 1;
  const int c = (i + 2) * ws + j + 2;
  const int x = win[c];
  const int d1 = (dir + 2) & 7, d2 = (dir + 6) & 7;
  int sm = 0, mx = x, mn = x;
#pragma unroll
  for (int k = 0; k < 2; k++) {
    const int pt = taps_i ? 3 : (k ? 2 : 4);
    const int st = k ? 1 : 2;
    const int op = kDirs[dir][k][0] * ws + kDirs[dir][k][1];
    const int o1 = kDirs[d1][k][0] * ws + kDirs[d1][k][1];
    const int o2 = kDirs[d2][k][0] * ws + kDirs[d2][k][1];
#pragma unroll
    for (int sgn = 1; sgn >= -1; sgn -= 2) {
      const int p = win[c + sgn * op];
      sm += pt * constrain(p - x, pri, damping);
      if (p != kVeryLarge) mx = max(mx, p);
      mn = min(mn, p);
      const int s1 = win[c + sgn * o1];
      sm += st * constrain(s1 - x, sec, damping);
      if (s1 != kVeryLarge) mx = max(mx, s1);
      mn = min(mn, s1);
      const int s2 = win[c + sgn * o2];
      sm += st * constrain(s2 - x, sec, damping);
      if (s2 != kVeryLarge) mx = max(mx, s2);
      mn = min(mn, s2);
    }
  }
  const int y = x + ((8 + sm - (sm < 0)) >> 4);
  return min(max(y, mn), mx);
}

__device__ __forceinline__ int src_px(const Frame& f, int pl, int y, int x) {
  const int stride = f.src_stride[pl ? 1 : 0];
  return f.src_bytes == 1
             ? static_cast<const uint8_t*>(f.src[pl])[y * stride + x]
             : static_cast<const uint16_t*>(f.src[pl])[y * stride + x];
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    cdef_blocks(const Frame f, const Cands cd) {
  __shared__ int s_lwin[kWarps][kLw * kLw];
  __shared__ int s_cwin[kWarps][2][kCw * kCw];
  __shared__ int s_part[kWarps][8 * 15];
  __shared__ unsigned long long s_sse[2][kMaxCand];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < 2 * kMaxCand; t += kThreads)
    s_sse[t / kMaxCand][t % kMaxCand] = 0;
  __syncthreads();
  const int cs = f.coeff_shift;
  const int cgh = f.gh >> 1, cgw = f.gw >> 1;
  const int ch = (f.h + 1) >> 1, cw = (f.w + 1) >> 1;
  const bool apply = f.out[0] != nullptr, sse = f.sse != nullptr;
  int* lwin = s_lwin[warp];
  int* part = s_part[warp];
  for (int b = blockIdx.x * kWarps + warp; b < f.n_blocks;
       b += gridDim.x * kWarps) {
    const int y0 = f.blocks[2 * b], x0 = f.blocks[2 * b + 1];
    const int cy0 = y0 >> 1, cx0 = x0 >> 1;
    for (int t = lane; t < kLw * kLw; t += 32) {
      const int y = y0 - 2 + t / kLw, x = x0 - 2 + t % kLw;
      lwin[t] = (y >= 0 && y < f.gh && x >= 0 && x < f.gw)
                    ? f.in[0][y * f.gw + x] : kVeryLarge;
    }
    for (int t = lane; t < 2 * kCw * kCw; t += 32) {
      const int pl = t / (kCw * kCw), r = (t / kCw) % kCw, c = t % kCw;
      const int y = cy0 - 2 + r, x = cx0 - 2 + c;
      s_cwin[warp][pl][r * kCw + c] =
          (y >= 0 && y < cgh && x >= 0 && x < cgw)
              ? f.in[1 + pl][y * cgw + x] : kVeryLarge;
    }
    for (int t = lane; t < 8 * 15; t += 32) part[t] = 0;
    __syncwarp();
    // find_dir: the partial sums of the 8 directions' lines
    for (int p = lane; p < 64; p += 32) {
      const int i = p >> 3, j = p & 7;
      const int x = (lwin[(i + 2) * kLw + j + 2] >> cs) - 128;
      atomicAdd(&part[0 * 15 + i + j], x);
      atomicAdd(&part[1 * 15 + i + j / 2], x);
      atomicAdd(&part[2 * 15 + i], x);
      atomicAdd(&part[3 * 15 + 3 + i - j / 2], x);
      atomicAdd(&part[4 * 15 + 7 + i - j], x);
      atomicAdd(&part[5 * 15 + 3 - i / 2 + j], x);
      atomicAdd(&part[6 * 15 + j], x);
      atomicAdd(&part[7 * 15 + i / 2 + j], x);
    }
    __syncwarp();
    long long cost = 0;
    if (lane < 8) {
      const int d = lane;
      const int* pd = part + d * 15;
      if (d == 2 || d == 6) {
        for (int k = 0; k < 8; k++)
          cost += static_cast<long long>(pd[k]) * pd[k] * kDiv[8];
      } else if (d == 0 || d == 4) {
        for (int k = 0; k < 7; k++)
          cost += (static_cast<long long>(pd[k]) * pd[k] +
                   static_cast<long long>(pd[14 - k]) * pd[14 - k]) *
                  kDiv[k + 1];
        cost += static_cast<long long>(pd[7]) * pd[7] * kDiv[8];
      } else {
        for (int k = 3; k < 8; k++)
          cost += static_cast<long long>(pd[k]) * pd[k] * kDiv[8];
        for (int k = 0; k < 3; k++)
          cost += (static_cast<long long>(pd[k]) * pd[k] +
                   static_cast<long long>(pd[10 - k]) * pd[10 - k]) *
                  kDiv[2 * k + 2];
      }
    }
    int best = 0;
    long long bc = 0;
#pragma unroll
    for (int d = 0; d < 8; d++) {
      const long long cd_ = __shfl_sync(0xffffffffu, cost, d);
      if (cd_ > bc) {
        bc = cd_;
        best = d;
      }
    }
    const long long opp = __shfl_sync(0xffffffffu, cost, (best + 4) & 7);
    const int var = static_cast<int>((bc - opp) >> 10);

    // luma: 2 pixels a lane per candidate
    for (int q = 0; q < cd.ky; q++) {
      const int pri = cd.y[q][0], sec = cd.y[q][1];
      const bool filt = pri || sec;
      if (apply && !filt) continue;
      const int t = filt ? adjust_strength(pri << cs, var) : 0;
      const int dir = (pri << cs) ? best : 0;
      unsigned long long acc = 0;
      for (int p = lane; p < 64; p += 32) {
        const int i = p >> 3, j = p & 7;
        const int v = filt ? filter_px(lwin, kLw, i, j, t, sec << cs, dir,
                                       f.damping + cs, cs)
                           : lwin[(i + 2) * kLw + j + 2];
        const int y = y0 + i, x = x0 + j;
        if (apply && y < f.gh && x < f.gw) {
          f.out[0][y * f.gw + x] = static_cast<uint16_t>(v);
        }
        if (sse && y < f.h && x < f.w) {
          const long long d = v - src_px(f, 0, y, x);
          acc += static_cast<unsigned long long>(d * d);
        }
      }
      if (sse) {
        acc = warp_sum(acc);
        if (lane == 0) atomicAdd(&s_sse[0][q], acc);
      }
    }
    // chroma: lane = plane * 16 + the pixel of its 4x4 block
    const int pl = lane >> 4, i = (lane >> 2) & 3, j = lane & 3;
    const int* cwin = s_cwin[warp][pl];
    for (int q = 0; q < cd.kc; q++) {
      const int pri = cd.c[q][0], sec = cd.c[q][1];
      const bool filt = pri || sec;
      if (apply && !filt) continue;
      const int v = filt ? filter_px(cwin, kCw, i, j, pri << cs, sec << cs,
                                     (pri << cs) ? best : 0,
                                     f.damping + cs - 1, cs)
                         : cwin[(i + 2) * kCw + j + 2];
      const int y = cy0 + i, x = cx0 + j;
      if (apply && y < cgh && x < cgw) {
        f.out[1 + pl][y * cgw + x] = static_cast<uint16_t>(v);
      }
      if (sse) {
        unsigned long long acc = 0;
        if (y < ch && x < cw) {
          const long long d = v - src_px(f, 1 + pl, y, x);
          acc = static_cast<unsigned long long>(d * d);
        }
        acc = warp_sum(acc);
        if (lane == 0) atomicAdd(&s_sse[1][q], acc);
      }
    }
    __syncwarp();  // the next block overwrites this warp's windows
  }
  __syncthreads();
  if (f.sse != nullptr) {
    for (int q = threadIdx.x; q < cd.k; q += kThreads) {
      const unsigned long long a = s_sse[0][cd.qy[q]], c = s_sse[1][cd.qc[q]];
      if (a) atomicAdd(&f.sse[2 * q], a);
      if (c) atomicAdd(&f.sse[2 * q + 1], c);
    }
  }
}

}  // namespace

// The plain C entry (kernels/cdef.py cdef_frame_kernel). Search: sse is a
// device (k, 2) int64 buffer, set to 0 here, and out_* are null. Apply:
// sse and the sources are null, k is 1, and out_* are device planes of the
// inputs' shapes that receive a copy of the input before the launch. The
// pair and quadruple tables are host arrays. Queues on `stream`; returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int cdef_frame(const void* in_y, const void* in_u,
                          const void* in_v, int gh, int gw, const void* src_y,
                          const void* src_u, const void* src_v,
                          int src_stride_y, int src_stride_c, int src_bytes,
                          const void* blocks, int n_blocks,
                          const int* pairs_y, int ky, const int* pairs_c,
                          int kc, const int* quad_y, const int* quad_c,
                          int k, int bd, int damping, int w, int h,
                          void* sse, void* out_y, void* out_u, void* out_v,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool apply = out_y != nullptr;
  if (ky < 1 || ky > kMaxCand || kc < 1 || kc > kMaxCand || k < 1 ||
      k > kMaxCand || n_blocks < 0 || gh < 4 || gw < 4 || w > gw || h > gh ||
      (apply && (k != 1 || sse != nullptr || !out_u || !out_v)) ||
      (!apply && (sse == nullptr || !src_y || !src_u || !src_v ||
                  (src_bytes != 1 && src_bytes != 2)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Frame f{};
  f.in[0] = static_cast<const uint16_t*>(in_y);
  f.in[1] = static_cast<const uint16_t*>(in_u);
  f.in[2] = static_cast<const uint16_t*>(in_v);
  f.src[0] = src_y;
  f.src[1] = src_u;
  f.src[2] = src_v;
  f.out[0] = static_cast<uint16_t*>(out_y);
  f.out[1] = static_cast<uint16_t*>(out_u);
  f.out[2] = static_cast<uint16_t*>(out_v);
  f.blocks = static_cast<const int*>(blocks);
  f.sse = static_cast<unsigned long long*>(sse);
  f.n_blocks = n_blocks;
  f.gh = gh;
  f.gw = gw;
  f.w = w;
  f.h = h;
  f.src_stride[0] = src_stride_y;
  f.src_stride[1] = src_stride_c;
  f.src_bytes = src_bytes;
  f.coeff_shift = bd > 8 ? bd - 8 : 0;
  f.damping = damping;
  Cands cd{};
  cd.ky = ky;
  cd.kc = kc;
  cd.k = k;
  for (int q = 0; q < ky; q++) {
    cd.y[q][0] = pairs_y[2 * q];
    cd.y[q][1] = pairs_y[2 * q + 1];
  }
  for (int q = 0; q < kc; q++) {
    cd.c[q][0] = pairs_c[2 * q];
    cd.c[q][1] = pairs_c[2 * q + 1];
  }
  for (int q = 0; q < k; q++) {
    if (quad_y[q] < 0 || quad_y[q] >= ky || quad_c[q] < 0 || quad_c[q] >= kc)
      return static_cast<int>(cudaErrorInvalidValue);
    cd.qy[q] = quad_y[q];
    cd.qc[q] = quad_c[q];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t luma = static_cast<size_t>(gh) * gw * 2;
  const size_t chroma = static_cast<size_t>(gh / 2) * (gw / 2) * 2;
  if (apply) {
    err = cudaMemcpyAsync(out_y, in_y, luma, cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out_u, in_u, chroma, cudaMemcpyDeviceToDevice, st);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(out_v, in_v, chroma, cudaMemcpyDeviceToDevice, st);
  } else {
    err = cudaMemsetAsync(sse, 0, sizeof(unsigned long long) * 2 * k, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    const int need = (n_blocks + kWarps - 1) / kWarps;
    cdef_blocks<<<need < kMaxCtas ? need : kMaxCtas, kThreads, 0, st>>>(f,
                                                                       cd);
  }
  return static_cast<int>(cudaGetLastError());
}
