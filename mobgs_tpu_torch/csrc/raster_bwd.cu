// Backward tile compositor for Hopper (sm_90a).
//
// Replaces the two Pallas TPU backward kernels of
// mobgs_tpu/ops/pallas_raster.py: _bwd_kernel (:203-282) and, with SUB,
// _bwd_kernel_sub (:285-383), together with the record gather of
// _gather_records (:398-428) and the scatter-add of its VJP. Same
// semantics: the tile replays its depth-sorted list front to back in chunks
// of `ch`, with the same gates and the same chunk-level early exit as the
// forward (raster_common.cuh), and uses the forward's output as the suffix
// anchor of the 3DGS backward identity
//   dL/dalpha_i = T_i (c_i . g) - (g . C_total - sum_{j<=i} w_j (c_j . g))
//                                 / max(1 - alpha_i, 1e-6),
// zeroed unless the pair passed its gates and raw alpha < 0.99; then
// dL/dsigma = -alpha dL/dalpha, and per (slot, pixel)
//   dL/dmx = -dL/dsigma (a dx + b dy),  dL/dmy = -dL/dsigma (c dy + b dx),
//   dL/da = dL/dsigma dx^2 / 2,  dL/db = dL/dsigma dx dy,
//   dL/dc = dL/dsigma dy^2 / 2,  dL/do = e^-sigma dL/dalpha,
//   dL/dcol_c = w g_c.
// The mean rows are written with their final sign here: the Pallas path
// flips rows 0-1 after its kernel (:486-489, :561-564); this port flips
// them once, inside the kernel, and nowhere else. With SUB the subset chain
// (opacity column 6, upstream g2 on its alpha-only output) is replayed in
// the same walk: its opacity gradient goes to column 6 and its sigma
// gradient adds into the shared mean and conic terms.
//
// Layout: one block per tile, one thread per pixel. At tile start the
// block copies the tile's upstream gradient g [P, CE] into shared memory,
// coalesced and transposed to [CE][P + 1] (rows padded by one word, so both
// the copy and the reads below are free of bank conflicts), and stages
// `out` the same way once to form g . C_total per pixel. With SUB, g2 and
// g2 . out2 of each pixel go to shared memory too: in registers they would
// not fit beside phase B's sums without spilling. Each chunk's records and
// colour columns are gathered by gauss_id into shared memory, as in the
// forward. The chunk is then walked
// in sub-chunks of S slots (S = 8, or 4 with SUB; S divides 64 and so both
// chunk sizes), in two phases:
//   A. the replay, one thread per pixel, with the carried T, the in-chunk
//      prefix product and the running sum of w (c . g) in registers. Each
//      pair writes w, dL/dsigma, dL/do (and dL/do_sub) to shared [S][P]
//      arrays, pixel-contiguous; a pair that passed a gate sets its slot's
//      flag.
//   B. the sums over pixels, 256 / S threads per slot: 8 / S warps, each
//      lane summing S pixels of one column in registers, its loop
//      unrolled so the shared loads overlap. A lane's pixels share dx, so
//      the five geometric terms factor into sums of dL/dsigma,
//      dL/dsigma dy and dL/dsigma dy^2 (dy recomputed with the replay's
//      rounded subtraction); then dL/do (and dL/do_sub), then the CE
//      colour terms w g_c from the staged g, eight channels at a time.
//      Each group of eight sums is completed by a transposed xor
//      reduction (9 shuffles where one sum at a time takes 40), after
//      which lanes 4t hold term t and add it with one atomicAdd, all
//      together: one atomic per (slot, term) and block at S = 8, two at
//      S = 4, where the earlier design issued one per warp, 8 per block.
//      A slot whose flag is clear (every pair failed its gates) is
//      skipped.
// The per-pair values of phase A are those of the earlier per-pixel walk,
// in the forward's order; only the order of the sums over pixels and tiles
// differs. Atomics add in an order that changes from run to run, so the
// sums are not bitwise reproducible.
//
// A launch may cover a range of the image's tiles: tile0 is the image tile
// of its first block. The operands (ids, counts, out, out2, g, g2) hold the
// range's rows, indexed by blockIdx.x; the pixel origin comes from the
// image tile tile0 + blockIdx.x (the Pallas kernels' global tile id, column
// 1 of their SMEM counts, pallas_raster.py:613-619). Over several views of
// one size the rows are the views' tiles in turn, and the pixel origin is
// that of the row modulo tpv, the tile count of one view, as in the
// forward; each view's ids point at its own rows of rec and col, so its
// gradients land in its own rows of grad_rec and grad_col.
//
// Occupancy. Shared memory is dynamic, sized to CE and ch: at the
// protocol's widths (ch = 128) 42 KB for CE = 9 and 39 KB for CE = 11 with
// SUB. With __launch_bounds__(256, 5) the compiler keeps the CE <= 4 and
// CE <= 12 instances within 48 registers, without spills, so five blocks
// fit on an SM and the 576 tiles of a 512x288 view are all resident at
// once on an H100's 132 SMs (one wave; CE = 12 holds four). The CE <= 32
// instance (the flow-on mid render, CE = 29) takes about 80 KB of shared
// memory and 90 registers: two blocks per SM, three waves.
// raster_bwd_occupancy reports what the card gives each instance.
//
// What bounds it on an H100: per live (slot, pixel) pair the replay costs
// about 20 float32 operations and one expf, per kept pair about 35 + 3 CE
// more; bytes are few, so operations bound it. On the card the replay
// (phase A with the staging) takes about 60 % of the time and the sums
// over pixels the rest; the atomics cost under 3 %. No tensor cores: the
// colour sum is an [S x 256] . [256 x CE] product, but TF32 keeps 10
// mantissa bits, and the backward is held to 1e-4 of each column's largest
// magnitude, so it is FFMA; three-pass TF32 (split products, as CUTLASS's
// 3xTF32) is the route if a profile shows the colour sum leading. The g
// and out copies go through registers because they are transposed on the
// way (cp.async copies bytes as they lie); they happen once per tile.

#include "raster_common.cuh"

using namespace raster;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = P / 32;
constexpr int GP = P + 1;  // padded row of the staged per-pixel operands
constexpr int CG = 8;      // colour sums live at once in phase B

// Eight sums over the warp in 9 shuffles (40 one by one): each of the
// first three xor steps halves the values a lane carries, sending the half
// its partner keeps, and the last two add the one value left. Lane l
// returns the warp's sum of v[(l >> 2) & 7].
__device__ __forceinline__ float warp_sum8(float (&v)[8], int lane) {
  bool up = lane & 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = up ? v[j] : v[j + 4];
    v[j] = (up ? v[j + 4] : v[j]) + __shfl_xor_sync(FULL, send, 16);
  }
  up = lane & 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = up ? v[j] : v[j + 2];
    v[j] = (up ? v[j + 2] : v[j]) + __shfl_xor_sync(FULL, send, 8);
  }
  up = lane & 4;
  const float send = up ? v[0] : v[1];
  float r = (up ? v[1] : v[0]) + __shfl_xor_sync(FULL, send, 4);
  r += __shfl_xor_sync(FULL, r, 2);
  return r + __shfl_xor_sync(FULL, r, 1);
}

template <bool SUB>
struct Shape {
  static constexpr int S = SUB ? 4 : 8;     // slots per sub-chunk
  static constexpr int NREC = SUB ? 7 : 6;  // record floats per slot
  static constexpr int NA = SUB ? 4 : 3;    // phase-A arrays [S][P]
  static constexpr int ROWS = SUB ? 7 : 6;  // gradient columns written
};

// Words of dynamic shared memory: ids, records, colours, g, the scratch
// shared by the out staging and the phase-A arrays, and two banks of
// S slot flags.
template <bool SUB>
__host__ __device__ constexpr int scratch_words(int CE) {
  return Shape<SUB>::NA * Shape<SUB>::S * P > GP * CE
             ? Shape<SUB>::NA * Shape<SUB>::S * P
             : GP * CE;
}

template <bool SUB>
__host__ __device__ constexpr int smem_words(int CE, int ch) {
  return ch * (1 + Shape<SUB>::NREC) + ch * CE + GP * CE + (SUB ? 2 * P : 0) +
         scratch_words<SUB>(CE) + 2 * Shape<SUB>::S;
}

template <int CEM, bool SUB>
__global__ void __launch_bounds__(P, CEM <= 12 ? 5 : 2)
raster_bwd_kernel(const int32_t* __restrict__ ids,     // [T, K]
                  const int32_t* __restrict__ counts,  // [T]
                  const float* __restrict__ rec,       // [N, R]
                  const float* __restrict__ col,       // [N, CE]
                  const float* __restrict__ out,       // [T, P, CE]
                  const float* __restrict__ out2,      // [T, P] (SUB only)
                  const float* __restrict__ g,         // [T, P, CE]
                  const float* __restrict__ g2,        // [T, P] (SUB only)
                  float* __restrict__ grad_rec,        // [N, R], zeroed
                  float* __restrict__ grad_col,        // [N, CE], zeroed
                  int K, int CE, int ntx, int tile0, int tpv, int ch) {
  constexpr int S = Shape<SUB>::S, NA = Shape<SUB>::NA, ROWS = Shape<SUB>::ROWS;
  constexpr int WPS = WARPS / S;  // warps per slot in phase B
  extern __shared__ float smem[];
  int* s_id = reinterpret_cast<int*>(smem);
  float* s_mx = smem + ch;
  float* s_my = s_mx + ch;
  float* s_a = s_my + ch;
  float* s_b = s_a + ch;
  float* s_c = s_b + ch;
  float* s_o = s_c + ch;
  float* s_os = s_o + ch;  // SUB only
  float* s_col = smem + ch * (1 + Shape<SUB>::NREC);  // [ch][CE]
  float* s_g = s_col + ch * CE;                        // [CE][GP]
  float* s_g2 = s_g + GP * CE;   // SUB: g2 and g2 . out2 per pixel [2][P]
  float* s_scr = s_g2 + (SUB ? 2 * P : 0);  // out [CE][GP], then phase A [NA][S][P]
  int* s_hit = reinterpret_cast<int*>(s_scr + scratch_words<SUB>(CE));  // [2][S]

  const int tile = blockIdx.x;     // this launch's tile: its operands' row
  const int gtile = (tile0 + tile) % tpv;  // its view's tile: its pixels
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int count = counts[tile];
  if (count <= 0) return;  // nothing to replay, nothing to add
  const float ox = (float)((gtile % ntx) * TILE);
  const float oy = (float)((gtile / ntx) * TILE);
  const float px = (float)(tid % TILE) + 0.5f + ox;
  const float py = (float)(tid / TILE) + 0.5f + oy;
  const size_t pix = (size_t)tile * P + tid;

  // Stage g and out transposed, coalesced: neighbouring threads read
  // neighbouring words of the tile's contiguous [P, CE] block.
  {
    const float* gt = g + (size_t)tile * P * CE;
    const float* ot = out + (size_t)tile * P * CE;
    for (int e = tid; e < P * CE; e += P) {
      const int p = e / CE;
      const int c = e - p * CE;
      s_g[c * GP + p] = gt[e];
      s_scr[c * GP + p] = ot[e];
    }
  }
  if (tid < 2 * S) s_hit[tid] = 0;
  __syncthreads();
  // g . C_total of this pixel, summed in channel order
  float gdt = 0.f;
#pragma unroll
  for (int c = 0; c < CEM; ++c)
    if (c < CE) gdt += s_g[c * GP + tid] * s_scr[c * GP + tid];
  if (SUB) {
    const float g2v = g2[pix];
    s_g2[tid] = g2v;
    s_g2[P + tid] = g2v * out2[pix];
  }

  float T = 1.f, T2 = 1.f;        // transmittance carried between chunks
  float gacc = 0.f, gacc2 = 0.f;  // inclusive sums of w (c . g), w_s g2
  int bank = 0;                   // which bank of slot flags is live

  const int n_chunks = K / ch;
  for (int j = 0; j < n_chunks && j * ch < count; ++j) {
    const int s0 = j * ch;
    // Stage the chunk as the forward does; slots past the tile's count
    // become zero-opacity records that never pass a gate. The barrier
    // before this (the one after g . C_total, or the chunk-end one) also
    // keeps it off the scratch and the records still in use.
    for (int s = tid; s < ch; s += P) {
      const int slot = s0 + s;
      if (slot < count) {
        const int gid = ids[(size_t)tile * K + slot];
        const float* r = rec + (size_t)gid * R;
        s_id[s] = gid;
        s_mx[s] = r[0];
        s_my[s] = r[1];
        s_a[s] = r[2];
        s_b[s] = r[3];
        s_c[s] = r[4];
        s_o[s] = r[5];
        if (SUB) s_os[s] = r[6];
      } else {
        s_id[s] = -1;
        s_mx[s] = s_my[s] = 0.f;
        s_a[s] = s_b[s] = s_c[s] = 0.f;
        s_o[s] = 0.f;
        if (SUB) s_os[s] = 0.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < ch * CE; e += P) {
      const int s = e / CE;
      const int gid = s_id[s];
      s_col[e] = gid >= 0 ? col[(size_t)gid * CE + (e - s * CE)] : 0.f;
    }
    __syncthreads();

    float Tc = 1.f, T2c = 1.f;  // exclusive prefix products in the chunk
    const int live = min(ch, count - s0);
    for (int b0 = 0; b0 < live; b0 += S) {
      // ---- phase A: the replay of S slots, one thread per pixel ----
      int* hit_now = s_hit + bank * S;
#pragma unroll 1
      for (int i = 0; i < S; ++i) {
        const int s = b0 + i;
        float dx, dy;
        const float sigma = splat_sigma(px, py, s_mx[s], s_my[s], s_a[s],
                                        s_b[s], s_c[s], dx, dy);
        float w = 0.f, gsig = 0.f, gop = 0.f, gop_s = 0.f;
        bool hit = false;
        if (sigma >= 0.f) {
          const float e = expf(-sigma);
          const float raw = splat_raw_alpha(s_o[s], e);
          const float alpha = fminf(ALPHA_MAX, raw);
          if (alpha > ALPHA_MIN) {
            hit = true;
            const float Ti = Tc * T;
            w = alpha * Tc * T;  // the forward's weight, in its order
            float cg = 0.f;
#pragma unroll
            for (int c = 0; c < CEM; ++c)
              if (c < CE) cg += s_col[s * CE + c] * s_g[c * GP + tid];
            gacc += w * cg;
            if (raw < ALPHA_MAX) {
              const float ga = Ti * cg - (gdt - gacc) / fmaxf(1.f - alpha, 1e-6f);
              gsig = -alpha * ga;
              gop = e * ga;
            }
            Tc = trans_step(Tc, alpha);
          }
          if (SUB) {
            const float g2v = s_g2[tid];
            const float raw_s = splat_raw_alpha(s_os[s], e);
            const float alpha_s = fminf(ALPHA_MAX, raw_s);
            if (alpha_s > ALPHA_MIN) {
              hit = true;
              const float Ti_s = T2c * T2;
              gacc2 += alpha_s * T2c * T2 * g2v;
              if (raw_s < ALPHA_MAX) {
                const float ga_s =
                    Ti_s * g2v - (s_g2[P + tid] - gacc2) / fmaxf(1.f - alpha_s, 1e-6f);
                gsig -= alpha_s * ga_s;
                gop_s = e * ga_s;
              }
              T2c = trans_step(T2c, alpha_s);
            }
          }
        }
        s_scr[(0 * S + i) * P + tid] = w;
        s_scr[(1 * S + i) * P + tid] = gsig;
        s_scr[(2 * S + i) * P + tid] = gop;
        if (SUB) s_scr[(3 * S + i) * P + tid] = gop_s;
        if (hit) hit_now[i] = 1;
      }
      // the other bank was last read before the barrier above and is next
      // set after the barrier below
      if (tid < S) s_hit[(bank ^ 1) * S + tid] = 0;
      __syncthreads();

      // ---- phase B: the sums over pixels, 8 / S warps per slot ----
      {
        const int i = warp / WPS;
        if (hit_now[i]) {  // uniform across the warp
          const int s = b0 + i;
          const int p0 = (warp - i * WPS) * 32 * S + lane;
          const float mx = s_mx[s], my = s_my[s];
          const float a = s_a[s], b = s_b[s], c = s_c[s];
          const float* sw = s_scr + (0 * S + i) * P;
          const float* ss = s_scr + (1 * S + i) * P;
          const float* so = s_scr + (2 * S + i) * P;
          const float* so2 = s_scr + (3 * S + i) * P;
          // This lane's S pixels share a column (p % TILE is fixed), so dx
          // is one value per lane and the five geometric sums factor
          // into three per-lane sums over the pixels' dy.
          const float dx = __fsub_rn((float)(p0 % TILE) + 0.5f + ox, mx);
          const int gid = s_id[s];
          const int t = lane >> 2;  // the term this lane holds after a sum8
          const bool lead = (lane & 3) == 0;
          {
            float m0 = 0.f, m1 = 0.f, m2 = 0.f, o = 0.f, o2 = 0.f;
#pragma unroll
            for (int k = 0; k < S; ++k) {
              const int p = p0 + 32 * k;
              const float dy = __fsub_rn((float)(p / TILE) + 0.5f + oy, my);
              const float gsig = ss[p];
              const float gdy = gsig * dy;
              m0 += gsig;
              m1 += gdy;
              m2 += gdy * dy;
              o += so[p];
              if (SUB) o2 += so2[p];
            }
            float v[8] = {-(a * dx * m0 + b * m1), -(c * m1 + b * dx * m0),
                          0.5f * dx * dx * m0, dx * m1, 0.5f * m2, o, o2, 0.f};
            const float r = warp_sum8(v, lane);
            if (lead && t < ROWS) atomicAdd(grad_rec + (size_t)gid * R + t, r);
          }
          // the colour terms, CG = 8 channels at a time
#pragma unroll
          for (int c0 = 0; c0 < CEM; c0 += CG) {
            if (c0 < CE) {
              float v[CG];
#pragma unroll
              for (int q = 0; q < CG; ++q) v[q] = 0.f;
#pragma unroll
              for (int k = 0; k < S; ++k) {
                const int p = p0 + 32 * k;
                const float w = sw[p];
#pragma unroll
                for (int q = 0; q < CG; ++q)
                  if (c0 + q < CEM && c0 + q < CE) v[q] += w * s_g[(c0 + q) * GP + p];
              }
              const float r = warp_sum8(v, lane);
              if (lead && c0 + t < CE) atomicAdd(grad_col + (size_t)gid * CE + c0 + t, r);
            }
          }
        }
      }
      bank ^= 1;
      __syncthreads();  // phase A of the next sub-chunk rewrites the arrays
    }
    T = __fmul_rn(T, Tc);
    if (SUB) T2 = __fmul_rn(T2, T2c);
    // the forward's chunk-level early exit, over both chains with SUB; the
    // barrier also keeps the next chunk's staging off records in use
    const bool more = SUB ? (T > TRANS_EPS || T2 > TRANS_EPS) : (T > TRANS_EPS);
    if (!__syncthreads_or(more)) break;
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const float*,
                          const float*, const float*, const float*,
                          const float*, const float*, float*, float*, int, int,
                          int, int, int, int);

KernelFn pick(int CE, bool sub) {
  if (sub)
    return CE <= 4    ? raster_bwd_kernel<4, true>
           : CE <= 12 ? raster_bwd_kernel<12, true>
                      : raster_bwd_kernel<32, true>;
  return CE <= 4    ? raster_bwd_kernel<4, false>
         : CE <= 12 ? raster_bwd_kernel<12, false>
                    : raster_bwd_kernel<32, false>;
}

size_t smem_bytes(int CE, int ch, bool sub) {
  return sizeof(float) *
         (size_t)(sub ? smem_words<true>(CE, ch) : smem_words<false>(CE, ch));
}

// Above 48 KB a launch needs the kernel's dynamic shared memory limit
// raised first.
cudaError_t prepare(KernelFn k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_shape(int CE, int ch) {
  // S (8, or 4 with SUB) must divide ch
  return CE < 1 || CE > 32 || ch < 8 || ch > CH_MAX || ch % 8 != 0;
}

}  // namespace

extern "C" int raster_bwd(const void* ids, const void* counts, const void* rec,
                          const void* col, const void* out, const void* out2,
                          const void* g, const void* g2, void* grad_rec,
                          void* grad_col, int T, int K, int CE, int ntx,
                          int tile0, int tpv, int ch, int sub, void* stream) {
  if (T <= 0) return 0;
  if (bad_shape(CE, ch) || K % ch != 0 || ntx < 1 || tile0 < 0 || tpv < 1 ||
      (sub && (out2 == nullptr || g2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const KernelFn k = pick(CE, sub != 0);
  const size_t smem = smem_bytes(CE, ch, sub != 0);
  const cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<T, P, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(rec), static_cast<const float*>(col),
      static_cast<const float*>(out), static_cast<const float*>(out2),
      static_cast<const float*>(g), static_cast<const float*>(g2),
      static_cast<float*>(grad_rec), static_cast<float*>(grad_col), K, CE, ntx,
      tile0, tpv, ch);
  return (int)cudaGetLastError();
}

// What the card gives the instance that raster_bwd launches for (CE, ch,
// sub) on the current device: info = {resident blocks per SM, shared
// memory bytes per block (dynamic + static), registers per thread, local
// memory bytes per thread (spills)}.
extern "C" int raster_bwd_occupancy(int CE, int ch, int sub, int* info) {
  if (bad_shape(CE, ch) || info == nullptr) return (int)cudaErrorInvalidValue;
  const KernelFn k = pick(CE, sub != 0);
  const size_t smem = smem_bytes(CE, ch, sub != 0);
  cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, P, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = (int)(smem + attr.sharedSizeBytes);
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  return 0;
}
