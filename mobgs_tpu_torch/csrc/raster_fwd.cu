// Forward tile compositor for Hopper (sm_90a).
//
// Replaces the two Pallas TPU forward kernels of
// mobgs_tpu/ops/pallas_raster.py: _fwd_kernel (:118-148) and, with SUB,
// _fwd_kernel_sub (:151-200). Same semantics: a 16x16 tile walks its
// depth-sorted list front to back in chunks of `ch`,
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  alpha = min(0.99, o e^-sigma),
// kept where sigma >= 0, alpha > 1/255 and slot < count; weights are
// alpha * (exclusive prefix of 1-alpha inside the chunk) * (T carried
// between chunks); the tile stops after a chunk once the largest
// transmittance of its 256 pixels is <= 1e-4 (both chains with SUB).
// There is no per-pixel stop, unlike gsplat.
//
// What bounds it on an H100. Per live (slot, pixel) pair about 16 float32
// operations and one expf, per kept pair 2 + 2 CE more; the bytes (records
// and colours of the referenced Gaussians, the output) are few, so the
// float32 rate bounds it: 0.013-0.016 ms at the seesaw protocol view (576
// tiles, K = 256). In practice the walk is bound by instruction issue and
// latency: the earlier design (one thread per pixel, records in scalar
// shared arrays) spent its issue slots on 32-bit shared loads (6-7 per
// pair, CE more per kept pair) and ran one dependent sigma -> expf ->
// weight -> FMA chain per thread. This one issues about 146 instructions
// per slot and warp at CE = 9 for four pixels (sigma 7, expf 8, gates,
// weight and transmittance 6, and the CE FMAs, per pixel), nearly all of
// which the semantics need.
//
// Design. One block per tile, so the whole-tile exit stays one
// __syncthreads_or. Each thread owns PPT pixels of one column (rows y0 ..
// y0 + PPT - 1): PPT = 4 (64 threads) up to CE = 12, PPT = 2 (128 threads)
// with the sub chain, where it measured 10 % faster (and 3-4 % slower at
// CE = 9 without it), and above CE = 12, where 4 x 32 sums would not fit
// in registers. A record fetched from shared memory then feeds PPT
// independent chains, and the column's terms of sigma (dx, a dx^2, b dx)
// are computed once for them (raster_common.cuh; the same rounded
// operations). Records are staged as
// two float4 per slot (mx, my, a, b | c, o, o_sub, pad: the record row as
// it lies in device memory) and colours as rows padded to a multiple of
// four floats, read as float4. The walk is straight-line, SLOTS slots a
// step (two up to CE = 12): the step's records were loaded one step ahead
// and its colour rows are loaded into registers first, so no shared load
// waits behind a gate, and the FMAs are predicated on the gate. (A branch
// around the colour sums, as the earlier design had, made every slot wait
// for its row's address and loads after the gate.) Above CE = 12 the rows
// stay in shared memory and are read only where a pixel kept the slot.
// Each chunk is staged with cp.async: the thread that owns a slot copies
// its record (two 16-byte copies) and its CE colours (4-byte copies: colour
// rows are not 16-byte aligned); only the slots below the tile's count are
// copied and walked. The copies are not overlapped with the walk: while a
// block waits for them, the other blocks on its SM walk, and a
// double-buffered version measured no faster.
// Every pixel keeps its order of operations: slots in order,
// acc[c] += w * col[c] with w = alpha * Tc * T, Tc = trans_step(Tc, alpha),
// T *= Tc at the chunk's end, so the backward's replay keeps and drops the
// same pairs. expf is evaluated for every pair and gated after. The colour
// sums are chunked as the plain version's: acc sums one chunk's slots from
// zero and is folded into the tile's sum, held in `out` (thread-private
// words), before the next chunk. One running sum over a walk thousands of
// slots deep rounds each small late term against a large total; its
// float32 drift was what moved the train step's gradients from the float64
// compositor at max_per_tile 2560 (ROADMAP C.4).
//
// Occupancy (raster_fwd_occupancy, chip_smoke.py phase 2): at CE = 9 / 11
// 64 threads, 10 KB of shared memory, 8 or more blocks per SM; with SUB at
// CE = 11 128 threads, 5 blocks; the 576 tiles of a 512x288 view are
// resident in one wave. The instance above CE = 12 (CE = 29 with SUB,
// 128 threads, 20 KB) is bounded to 4 blocks: at 5 its 102 registers
// spilled once the chunk fold was added; 4 x 132 blocks hold 528 of the
// 576 tiles at once.
//
// What the attribution builds found (scripts/torch_raster_ab.py --kernel
// fwd --variants, on an H100 80GB HBM3 at 700 W): the colour sums take 26
// / 34 / 23 % of the time at CE = 9 / 11 / 11 with SUB (48 % at CE = 29),
// so tensor cores are not worth their rounding here; staging every live
// chunk alone takes 0.02-0.03 ms, off the critical path (see above); the
// instances for any width up to 12 are 43-52 % slower than the exact-width
// ones (CE = 9, 11); one slot a step is 2-5 % slower, the other choice of
// pixels per thread 1-9 %. The kernel's span is its slowest tile's: at
// CE = 9 a full tile alone on the card takes 41 us of the 64 us span, and
// 26 % of the SM-time between the first block's start and the last one's
// end is idle (15 % for the 128-thread blocks with SUB; 4 or 5 tiles per
// SM, tiles of 18-64 us); balancing that tail is left open.
// A launch may cover a range of the image's tiles: tile0 is the image tile
// of the launch's first block. The operands (ids, counts, out, out2) hold
// the range's rows, indexed by blockIdx.x; the pixel origin comes from the
// image tile tile0 + blockIdx.x, as the Pallas kernels take it from the
// global tile id in column 1 of their SMEM counts (pallas_raster.py:613-619)
// so that a shard of the tile axis composites its own pixels. With
// tile0 = 0 over all tiles the output is that of one launch per image.
// A launch may also cover several views of one size: the rows are then
// the views' tiles in turn (view v's tile t at row v * tpv + t, where tpv
// is the tile count of one view), and a block's pixel origin is that of
// its row modulo tpv. The records and colours of all views lie in one
// table, each view's ids pointing at its own rows, so a block reads and
// writes only its view's. Over one view (every row below tpv) the modulo
// changes nothing, and the launch is the one-view launch.
// Plain C interface for ctypes: the entry point returns cudaGetLastError()
// after the launch.

#include "raster_common.cuh"

using namespace raster;

namespace {

// Pixels per thread, threads per block, the shared colour row (floats)
// and the slots walked per step of an instance that sums CEM channels;
// up to CE = 12 a step's colour rows are held in registers (REG_COL).
template <int CEM, bool SUB>
struct FwdShape {
  static constexpr int PPT = CEM > 12 || SUB ? 2 : 4;
  static constexpr int NT = P / PPT;
  static constexpr int CES = (CEM + 3) / 4 * 4;
  static constexpr int SLOTS = CEM > 12 ? 1 : 2;
  static constexpr bool REG_COL = CEM <= 12;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Wait for all of this thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start copying the live slots [s0, s0 + live) of a tile's list into shared
// memory: records as two float4 per slot, colours as rows of CES floats.
template <int CEM, bool SUB>
__device__ __forceinline__ void stage(const int32_t* __restrict__ ids_t,
                                      const float* __restrict__ rec,
                                      const float* __restrict__ col, int ce,
                                      int s0, int live, float4* b_rec,
                                      float* b_col, int tid) {
  constexpr int NT = FwdShape<CEM, SUB>::NT, CES = FwdShape<CEM, SUB>::CES;
  for (int s = tid; s < live; s += NT) {
    const int g = ids_t[s0 + s];
    const float* r = rec + (size_t)g * R;
    cp_async16(b_rec + 2 * s, r);
    cp_async16(b_rec + 2 * s + 1, r + 4);
    const float* c = col + (size_t)g * ce;
    float* d = b_col + s * CES;
    for (int q = 0; q < ce; ++q) cp_async4(d + q, c + q);
  }
}

// The gates of one slot for a thread's PPT pixels: each chain's alpha and
// whether the pair passed (sigma >= 0, alpha > 1/255).
template <int PPT>
struct Gates {
  float alpha[PPT], alpha_s[PPT];
  bool keep[PPT], keep_s[PPT];
};

// sigma, alpha and the gates come from raster_common.cuh, rounded as the
// plain version and the backward round them: a gate that rounding flips
// would move a pixel's sums by up to T/255. Branch-free: expf runs for
// every pair, and a pair it overflows for (sigma < 0) is never kept.
template <int PPT, bool SUB>
__device__ __forceinline__ void slot_gates(const float4 r0, const float4 r1,
                                           float px, const float (&py)[PPT],
                                           Gates<PPT>& g) {
  const SigmaCol sx = splat_sigma_col(px, r0.x, r0.z, r0.w);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float dy;
    const float sigma = splat_sigma_row(sx, py[k], r0.y, r1.x, dy);
    const float e = expf(-sigma);
    g.alpha[k] = fminf(ALPHA_MAX, splat_raw_alpha(r1.y, e));
    g.keep[k] = sigma >= 0.f && g.alpha[k] > ALPHA_MIN;
    if (SUB) {
      g.alpha_s[k] = fminf(ALPHA_MAX, splat_raw_alpha(r1.z, e));
      g.keep_s[k] = sigma >= 0.f && g.alpha_s[k] > ALPHA_MIN;
    }
  }
}

// acc[k][c] += w[k] * colour[c] for the kept pixels, the colour row read
// as float4s (from registers or shared memory).
template <int CEM, bool EXACT, int PPT>
__device__ __forceinline__ void colour_sums(const float4* colour, int ce,
                                            const float (&w)[PPT],
                                            const bool (&keep)[PPT],
                                            float (&acc)[PPT][CEM]) {
#pragma unroll
  for (int q = 0; q < (CEM + 3) / 4; ++q) {
    const float4 cv = colour[q];
    const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 4 * q + i;
      if (c < CEM && (EXACT || c < ce)) {
#pragma unroll
        for (int k = 0; k < PPT; ++k)
          if (keep[k]) acc[k][c] += w[k] * cq[i];
      }
    }
  }
}

// One slot's weights and sums, in the per-pixel order of the Pallas
// kernel: w = alpha * Tc * T, then Tc = trans_step(Tc, alpha).
template <int CEM, bool EXACT, bool SUB, int PPT>
__device__ __forceinline__ void composite_slot(
    const Gates<PPT>& g, const float4* colour, int ce, const float (&T)[PPT],
    const float (&T2)[PPT], float (&Tc)[PPT], float (&T2c)[PPT],
    float (&acc)[PPT][CEM], float (&acc2)[PPT]) {
  float w[PPT];
  bool any = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    w[k] = g.alpha[k] * Tc[k] * T[k];
    if (g.keep[k]) Tc[k] = trans_step(Tc[k], g.alpha[k]);
    any |= g.keep[k];
    if (SUB && g.keep_s[k]) {
      acc2[k] += g.alpha_s[k] * T2c[k] * T2[k];
      T2c[k] = trans_step(T2c[k], g.alpha_s[k]);
    }
  }
  // predicated where the row is in registers; read from shared memory (the
  // widest instance) only where a pixel kept the slot
  if (FwdShape<CEM, SUB>::REG_COL || any)
    colour_sums<CEM, EXACT>(colour, ce, w, g.keep, acc);
}

// EXACT: the launch guarantees CE == CEM (the training and render widths),
// so no channel test is left in the sums.
template <int CEM, bool EXACT, bool SUB>
__global__ void __launch_bounds__(FwdShape<CEM, SUB>::NT, CEM > 12 ? 4 : 5)
raster_fwd_kernel(const int32_t* __restrict__ ids,     // [T, K]
                  const int32_t* __restrict__ counts,  // [T]
                  const float* __restrict__ rec,       // [N, R], 16-B aligned
                  const float* __restrict__ col,       // [N, CE]
                  float* __restrict__ out,             // [T, P, CE]
                  float* __restrict__ out2,            // [T, P] (SUB only)
                  int K, int CE, int ntx, int tile0, int tpv, int ch) {
  constexpr int PPT = FwdShape<CEM, SUB>::PPT, CES = FwdShape<CEM, SUB>::CES;
  constexpr bool REG_COL = FwdShape<CEM, SUB>::REG_COL;
  __shared__ float4 s_rec[2 * CH_MAX];  // mx, my, a, b | c, o, o_sub, pad
  __shared__ float4 s_col4[CH_MAX * CES / 4];

  const int ce = EXACT ? CEM : CE;
  const int tile = blockIdx.x;     // this launch's tile: its operands' row
  const int gtile = (tile0 + tile) % tpv;  // its view's tile: its pixels
  const int tid = threadIdx.x;
  const int count = counts[tile];
  const int x = tid % TILE;
  const int y0 = (tid / TILE) * PPT;  // this thread's rows y0 .. y0 + PPT - 1
  const float px = (float)x + 0.5f + (float)((gtile % ntx) * TILE);
  float py[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    py[k] = (float)(y0 + k) + 0.5f + (float)((gtile / ntx) * TILE);

  float acc[PPT][CEM];
  float T[PPT], acc2[PPT], T2[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int c = 0; c < CEM; ++c) acc[k][c] = 0.f;
    T[k] = T2[k] = 1.f;
    acc2[k] = 0.f;
  }

  const int32_t* ids_t = ids + (size_t)tile * K;
  const int n_chunks = min(K / ch, (count + ch - 1) / ch);  // chunks with a live slot
  int done = 0;  // chunks walked
  for (int j = 0; j < n_chunks; ++j) {
    const int live = min(ch, count - j * ch);
    if (j > 0) {
      // ---- fold the last chunk's sums into the tile's, held in out ----
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t p = (size_t)tile * P + (y0 + k) * TILE + x;
#pragma unroll
        for (int c = 0; c < CEM; ++c) {
          if (EXACT || c < ce) out[p * ce + c] = j > 1 ? out[p * ce + c] + acc[k][c] : acc[k][c];
          acc[k][c] = 0.f;
        }
        if (SUB) {
          out2[p] = j > 1 ? out2[p] + acc2[k] : acc2[k];
          acc2[k] = 0.f;
        }
      }
    }
    done = j + 1;
    // ---- stage the chunk ----
    // (the previous chunk-end barrier keeps the copies off records in use;
    // the block waits for them while the other blocks on its SM walk)
    stage<CEM, SUB>(ids_t, rec, col, ce, j * ch, live, s_rec,
               reinterpret_cast<float*>(s_col4), tid);
    cp_async_wait_all();
    __syncthreads();

    // ---- walk the chunk ----
    float Tc[PPT], T2c[PPT];  // exclusive prefix products in the chunk
#pragma unroll
    for (int k = 0; k < PPT; ++k) Tc[k] = T2c[k] = 1.f;
    // SL slots a step, straight-line: the step's records were loaded one
    // step ahead and its colour rows are loaded first, so no shared load
    // waits behind a gate; the slots' gates are independent chains, which
    // the compiler interleaves; the sums then take the slots in order. A
    // slot index past the chunk's end is clamped and its sums skipped.
    constexpr int SL = FwdShape<CEM, SUB>::SLOTS, NQ = CES / 4;
    float4 rn[SL][2];
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      const int si = min(i, live - 1);
      rn[i][0] = s_rec[2 * si];
      rn[i][1] = s_rec[2 * si + 1];
    }
    for (int s = 0; s < live; s += SL) {
      float4 r[SL][2], c[SL][REG_COL ? NQ : 1];
#pragma unroll
      for (int i = 0; i < SL; ++i) {
        r[i][0] = rn[i][0];
        r[i][1] = rn[i][1];
        if (REG_COL) {
          const int si = min(s + i, live - 1);
#pragma unroll
          for (int q = 0; q < NQ; ++q) c[i][q] = s_col4[si * NQ + q];
        }
        const int ni = min(s + SL + i, live - 1);
        rn[i][0] = s_rec[2 * ni];
        rn[i][1] = s_rec[2 * ni + 1];
      }
      Gates<PPT> g[SL];
#pragma unroll
      for (int i = 0; i < SL; ++i) slot_gates<PPT, SUB>(r[i][0], r[i][1], px, py, g[i]);
#pragma unroll
      for (int i = 0; i < SL; ++i)
        if (i == 0 || s + i < live)
          composite_slot<CEM, EXACT, SUB>(g[i], REG_COL ? c[i] : s_col4 + (s + i) * NQ,
                                          ce, T, T2, Tc, T2c, acc, acc2);
    }
    bool more = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      T[k] = __fmul_rn(T[k], Tc[k]);
      if (SUB) T2[k] = __fmul_rn(T2[k], T2c[k]);
      more |= SUB ? (T[k] > TRANS_EPS || T2[k] > TRANS_EPS) : (T[k] > TRANS_EPS);
    }
    // ---- end of the walk ----
    // chunk-level early exit for the whole tile
    if (!__syncthreads_or(more)) break;
  }

  // ---- write the tile's sums ----
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t p = (size_t)tile * P + (y0 + k) * TILE + x;
#pragma unroll
    for (int c = 0; c < CEM; ++c)
      if (EXACT || c < ce) out[p * ce + c] = done > 1 ? out[p * ce + c] + acc[k][c] : acc[k][c];
    if (SUB) out2[p] = done > 1 ? out2[p] + acc2[k] : acc2[k];
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const float*,
                          const float*, float*, float*, int, int, int, int, int, int);

// The instance a launch with CE channels takes, and its block size.
template <bool SUB>
KernelFn pick_sub(int CE, int& threads) {
  if (CE == 9) {
    threads = FwdShape<9, SUB>::NT;
    return raster_fwd_kernel<9, true, SUB>;
  }
  if (CE == 11) {
    threads = FwdShape<11, SUB>::NT;
    return raster_fwd_kernel<11, true, SUB>;
  }
  if (CE <= 4) {
    threads = FwdShape<4, SUB>::NT;
    return raster_fwd_kernel<4, false, SUB>;
  }
  if (CE <= 12) {
    threads = FwdShape<12, SUB>::NT;
    return raster_fwd_kernel<12, false, SUB>;
  }
  threads = FwdShape<32, SUB>::NT;
  return raster_fwd_kernel<32, false, SUB>;
}

KernelFn pick(int CE, bool sub, int& threads) {
  return sub ? pick_sub<true>(CE, threads) : pick_sub<false>(CE, threads);
}

bool bad_shape(int CE, int ch) {
  return CE < 1 || CE > 32 || ch < 1 || ch > CH_MAX;
}

}  // namespace

extern "C" int raster_fwd(const void* ids, const void* counts, const void* rec,
                          const void* col, void* out, void* out2, int T, int K,
                          int CE, int ntx, int tile0, int tpv, int ch, int sub,
                          void* stream) {
  if (T <= 0) return 0;
  if (bad_shape(CE, ch) || K % ch != 0 || ntx < 1 || tile0 < 0 || tpv < 1 ||
      (sub && out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  // records are copied 16 bytes at a time
  if (reinterpret_cast<uintptr_t>(rec) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int threads = 0;
  const KernelFn k = pick(CE, sub != 0, threads);
  k<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(counts),
      static_cast<const float*>(rec), static_cast<const float*>(col),
      static_cast<float*>(out), static_cast<float*>(out2), K, CE, ntx, tile0, tpv, ch);
  return (int)cudaGetLastError();
}

// What the card gives the instance that raster_fwd launches for (CE, sub)
// on the current device: info = {resident blocks per SM, shared memory
// bytes per block, registers per thread, local memory bytes per thread
// (spills), threads per block}. ch is checked as raster_fwd checks it.
extern "C" int raster_fwd_occupancy(int CE, int ch, int sub, int* info) {
  if (bad_shape(CE, ch) || info == nullptr) return (int)cudaErrorInvalidValue;
  int threads = 0;
  const KernelFn k = pick(CE, sub != 0, threads);
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = (int)attr.sharedSizeBytes;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = threads;
  return 0;
}
