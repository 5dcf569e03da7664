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
// Layout: one block per tile, one thread per pixel. Each chunk's records
// (mx, my, a, b, c, o[, o_sub]) and its CE colour columns are gathered by
// gauss_id straight from the per-Gaussian tables into shared memory; the
// per-pixel sums stay in registers. Plain C interface for ctypes: the
// entry point returns cudaGetLastError() after the launch.

#include "raster_common.cuh"

using namespace raster;

namespace {

template <int CEM, bool SUB>
__global__ void __launch_bounds__(P)
raster_fwd_kernel(const int32_t* __restrict__ ids,     // [T, K]
                  const int32_t* __restrict__ counts,  // [T]
                  const float* __restrict__ rec,       // [N, R]
                  const float* __restrict__ col,       // [N, CE]
                  float* __restrict__ out,             // [T, P, CE]
                  float* __restrict__ out2,            // [T, P] (SUB only)
                  int K, int CE, int ntx, int ch) {
  __shared__ int s_id[CH_MAX];
  __shared__ float s_mx[CH_MAX], s_my[CH_MAX];
  __shared__ float s_a[CH_MAX], s_b[CH_MAX], s_c[CH_MAX];
  __shared__ float s_o[CH_MAX], s_os[CH_MAX];
  __shared__ float s_col[CH_MAX * CEM];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = counts[tile];
  const float px = (float)(tid % TILE) + 0.5f + (float)((tile % ntx) * TILE);
  const float py = (float)(tid / TILE) + 0.5f + (float)((tile / ntx) * TILE);

  float acc[CEM];
#pragma unroll
  for (int c = 0; c < CEM; ++c) acc[c] = 0.f;
  float acc2 = 0.f;
  float T = 1.f, T2 = 1.f;

  const int n_chunks = K / ch;
  for (int j = 0; j < n_chunks && j * ch < count; ++j) {
    const int s0 = j * ch;
    // Stage the chunk's records; slots past the tile's count hold
    // garbage ids and become zero-opacity records that never pass.
    for (int s = tid; s < ch; s += P) {
      const int slot = s0 + s;
      if (slot < count) {
        const int g = ids[(size_t)tile * K + slot];
        const float* r = rec + (size_t)g * R;
        s_id[s] = g;
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
      const int g = s_id[s];
      s_col[s * CEM + c] = g >= 0 ? col[(size_t)g * CE + c] : 0.f;
    }
    __syncthreads();

    float Tc = 1.f, T2c = 1.f;  // exclusive prefix products in the chunk
    for (int s = 0; s < ch; ++s) {
      // sigma, alpha and the transmittance steps come from
      // raster_common.cuh, rounded as the plain version and the backward
      // round them: a gate that rounding flips would move a pixel's sums
      // by up to T/255.
      float dx, dy;
      const float sigma = splat_sigma(px, py, s_mx[s], s_my[s], s_a[s],
                                      s_b[s], s_c[s], dx, dy);
      if (!(sigma >= 0.f)) continue;
      const float e = expf(-sigma);
      const float alpha = fminf(ALPHA_MAX, splat_raw_alpha(s_o[s], e));
      if (alpha > ALPHA_MIN) {
        const float w = alpha * Tc * T;
#pragma unroll
        for (int c = 0; c < CEM; ++c)
          if (c < CE) acc[c] += w * s_col[s * CEM + c];
        Tc = trans_step(Tc, alpha);
      }
      if (SUB) {
        const float alpha_s = fminf(ALPHA_MAX, splat_raw_alpha(s_os[s], e));
        if (alpha_s > ALPHA_MIN) {
          acc2 += alpha_s * T2c * T2;
          T2c = trans_step(T2c, alpha_s);
        }
      }
    }
    T = __fmul_rn(T, Tc);
    if (SUB) T2 = __fmul_rn(T2, T2c);
    // chunk-level early exit for the whole tile; the barrier also keeps
    // the next chunk's staging from overwriting records still in use
    const bool more = SUB ? (T > TRANS_EPS || T2 > TRANS_EPS) : (T > TRANS_EPS);
    if (!__syncthreads_or(more)) break;
  }

  float* o = out + ((size_t)tile * P + tid) * CE;
#pragma unroll
  for (int c = 0; c < CEM; ++c)
    if (c < CE) o[c] = acc[c];
  if (SUB) out2[(size_t)tile * P + tid] = acc2;
}

template <bool SUB>
void launch(const int32_t* ids, const int32_t* counts, const float* rec,
            const float* col, float* out, float* out2, int T, int K, int CE,
            int ntx, int ch, cudaStream_t stream) {
  const dim3 grid(T), block(P);
  if (CE <= 4)
    raster_fwd_kernel<4, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, K, CE, ntx, ch);
  else if (CE <= 12)
    raster_fwd_kernel<12, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, K, CE, ntx, ch);
  else
    raster_fwd_kernel<32, SUB><<<grid, block, 0, stream>>>(
        ids, counts, rec, col, out, out2, K, CE, ntx, ch);
}

}  // namespace

extern "C" int raster_fwd(const void* ids, const void* counts, const void* rec,
                          const void* col, void* out, void* out2, int T, int K,
                          int CE, int ntx, int ch, int sub, void* stream) {
  if (T <= 0) return 0;
  if (CE < 1 || CE > 32 || ch < 1 || ch > CH_MAX || K % ch != 0 || ntx < 1 ||
      (sub && out2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* n = static_cast<const int32_t*>(counts);
  const auto* r = static_cast<const float*>(rec);
  const auto* c = static_cast<const float*>(col);
  auto* o = static_cast<float*>(out);
  auto* o2 = static_cast<float*>(out2);
  auto st = static_cast<cudaStream_t>(stream);
  if (sub)
    launch<true>(i, n, r, c, o, o2, T, K, CE, ntx, ch, st);
  else
    launch<false>(i, n, r, c, o, o2, T, K, CE, ntx, ch, st);
  return (int)cudaGetLastError();
}
