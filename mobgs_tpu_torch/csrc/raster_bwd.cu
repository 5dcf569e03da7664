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
// Layout: one block per tile, one thread per pixel, as the forward. Each
// chunk's records and CE colour columns are gathered by gauss_id into
// shared memory. Per pixel, g[CE], g.C_total, the carried T and the carried
// inclusive sum of w (c . g) stay in registers (and g2, g2 out2, T2 and its
// sum with SUB). Each slot's 6 (7) record gradients and CE colour gradients
// are summed over the block's pixels by a warp shuffle reduction, then one
// atomicAdd per warp into the per-Gaussian grad_rec [N, 8] and
// grad_col [N, CE], which the caller zeroes. A warp none of whose pixels
// passed a gate for the slot skips the reduction (its terms are all zero).
// Atomics add in an order that changes from run to run, so the sums are
// not bitwise reproducible.
//
// What bounds it on an H100: per live (slot, pixel) pair the replay costs
// about 20 float32 operations and one expf, per kept pair about 35 + 3 CE
// more, plus (6 + CE) shuffle-and-add steps per slot and pixel of a warp
// that has a kept pair; bytes are few (records, colours, g and out once, a
// read-modify-write of each touched gradient row), so operations bound it.
// No tensor cores, TMA or pipelining yet.

#include "raster_common.cuh"

using namespace raster;

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;  // complete in lane 0
}

template <int CEM, bool SUB>
__global__ void __launch_bounds__(P)
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
                  int K, int CE, int ntx, int ch) {
  __shared__ int s_id[CH_MAX];
  __shared__ float s_mx[CH_MAX], s_my[CH_MAX];
  __shared__ float s_a[CH_MAX], s_b[CH_MAX], s_c[CH_MAX];
  __shared__ float s_o[CH_MAX], s_os[CH_MAX];
  __shared__ float s_col[CH_MAX * CEM];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int count = counts[tile];
  const float px = (float)(tid % TILE) + 0.5f + (float)((tile % ntx) * TILE);
  const float py = (float)(tid / TILE) + 0.5f + (float)((tile / ntx) * TILE);
  const size_t pix = (size_t)tile * P + tid;

  // upstream gradient and g . C_total of this pixel
  float gv[CEM];
  float gdt = 0.f;
#pragma unroll
  for (int c = 0; c < CEM; ++c) {
    gv[c] = c < CE ? g[pix * CE + c] : 0.f;
    if (c < CE) gdt += gv[c] * out[pix * CE + c];
  }
  const float g2v = SUB ? g2[pix] : 0.f;
  const float gdt2 = SUB ? g2v * out2[pix] : 0.f;

  float T = 1.f, T2 = 1.f;          // transmittance carried between chunks
  float gacc = 0.f, gacc2 = 0.f;    // inclusive sums of w (c . g), w_s g2

  const int n_chunks = K / ch;
  for (int j = 0; j < n_chunks && j * ch < count; ++j) {
    const int s0 = j * ch;
    // Stage the chunk as the forward does; slots past the tile's count
    // become zero-opacity records that never pass a gate.
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
      const int c = e - s * CE;
      const int gid = s_id[s];
      s_col[s * CEM + c] = gid >= 0 ? col[(size_t)gid * CE + c] : 0.f;
    }
    __syncthreads();

    float Tc = 1.f, T2c = 1.f;  // exclusive prefix products in the chunk
    for (int s = 0; s < ch; ++s) {
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
            if (c < CE) cg += s_col[s * CEM + c] * gv[c];
          gacc += w * cg;
          if (raw < ALPHA_MAX) {
            const float ga = Ti * cg - (gdt - gacc) / fmaxf(1.f - alpha, 1e-6f);
            gsig = -alpha * ga;
            gop = e * ga;
          }
          Tc = trans_step(Tc, alpha);
        }
        if (SUB) {
          const float raw_s = splat_raw_alpha(s_os[s], e);
          const float alpha_s = fminf(ALPHA_MAX, raw_s);
          if (alpha_s > ALPHA_MIN) {
            hit = true;
            const float Ti_s = T2c * T2;
            gacc2 += alpha_s * T2c * T2 * g2v;
            if (raw_s < ALPHA_MAX) {
              const float ga_s =
                  Ti_s * g2v - (gdt2 - gacc2) / fmaxf(1.f - alpha_s, 1e-6f);
              gsig -= alpha_s * ga_s;
              gop_s = e * ga_s;
            }
            T2c = trans_step(T2c, alpha_s);
          }
        }
      }
      // Sum this slot's terms over the warp's 32 pixels, one atomic per
      // warp and term. The branch is uniform across the warp.
      if (__any_sync(FULL, hit)) {
        const int gid = s_id[s];
        float* gr = grad_rec + (size_t)gid * R;
        const float a = s_a[s], b = s_b[s], c = s_c[s];
        float v;
        v = warp_sum(-gsig * (a * dx + b * dy));
        if (lane == 0) atomicAdd(gr + 0, v);
        v = warp_sum(-gsig * (c * dy + b * dx));
        if (lane == 0) atomicAdd(gr + 1, v);
        v = warp_sum(gsig * 0.5f * dx * dx);
        if (lane == 0) atomicAdd(gr + 2, v);
        v = warp_sum(gsig * dx * dy);
        if (lane == 0) atomicAdd(gr + 3, v);
        v = warp_sum(gsig * 0.5f * dy * dy);
        if (lane == 0) atomicAdd(gr + 4, v);
        v = warp_sum(gop);
        if (lane == 0) atomicAdd(gr + 5, v);
        if (SUB) {
          v = warp_sum(gop_s);
          if (lane == 0) atomicAdd(gr + 6, v);
        }
        float* gc = grad_col + (size_t)gid * CE;
#pragma unroll
        for (int k = 0; k < CEM; ++k) {
          if (k < CE) {
            v = warp_sum(w * gv[k]);
            if (lane == 0) atomicAdd(gc + k, v);
          }
        }
      }
    }
    T = __fmul_rn(T, Tc);
    if (SUB) T2 = __fmul_rn(T2, T2c);
    // the forward's chunk-level early exit, over both chains with SUB; the
    // barrier also keeps the next chunk's staging off records in use
    const bool more = SUB ? (T > TRANS_EPS || T2 > TRANS_EPS) : (T > TRANS_EPS);
    if (!__syncthreads_or(more)) break;
  }
}

template <bool SUB>
void launch(const int32_t* ids, const int32_t* counts, const float* rec,
            const float* col, const float* out, const float* out2,
            const float* g, const float* g2, float* grad_rec, float* grad_col,
            int T, int K, int CE, int ntx, int ch, cudaStream_t stream) {
  const dim3 grid(T), block(P);
  if (CE <= 4)
    raster_bwd_kernel<4, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, g, g2, grad_rec, grad_col, K, CE,
        ntx, ch);
  else if (CE <= 12)
    raster_bwd_kernel<12, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, g, g2, grad_rec, grad_col, K, CE,
        ntx, ch);
  else
    raster_bwd_kernel<32, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, g, g2, grad_rec, grad_col, K, CE,
        ntx, ch);
}

}  // namespace

extern "C" int raster_bwd(const void* ids, const void* counts, const void* rec,
                          const void* col, const void* out, const void* out2,
                          const void* g, const void* g2, void* grad_rec,
                          void* grad_col, int T, int K, int CE, int ntx,
                          int ch, int sub, void* stream) {
  if (T <= 0) return 0;
  if (CE < 1 || CE > 32 || ch < 1 || ch > CH_MAX || K % ch != 0 || ntx < 1 ||
      (sub && (out2 == nullptr || g2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* n = static_cast<const int32_t*>(counts);
  const auto* r = static_cast<const float*>(rec);
  const auto* c = static_cast<const float*>(col);
  const auto* o = static_cast<const float*>(out);
  const auto* o2 = static_cast<const float*>(out2);
  const auto* gg = static_cast<const float*>(g);
  const auto* gg2 = static_cast<const float*>(g2);
  auto* gr = static_cast<float*>(grad_rec);
  auto* gc = static_cast<float*>(grad_col);
  auto st = static_cast<cudaStream_t>(stream);
  if (sub)
    launch<true>(i, n, r, c, o, o2, gg, gg2, gr, gc, T, K, CE, ntx, ch, st);
  else
    launch<false>(i, n, r, c, o, o2, gg, gg2, gr, gc, T, K, CE, ntx, ch, st);
  return (int)cudaGetLastError();
}
