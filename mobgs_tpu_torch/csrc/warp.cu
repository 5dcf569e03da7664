// The flow-warp loss's bilinear K-warp on the card: the forward and backward
// of train/losses.py::_WarpImages (port of mobgs_tpu/train/losses.py:113-234,
// _warp_fwd / _warp_bwd). It replaces no Pallas kernel: the JAX package
// leaves the warp to XLA's gather and scatter-add. It exists because the
// plain route is a Python loop over the K = 2E warps of a view, ~39
// launches a warp forward and ~65 backward, each over a few hundred
// kilobytes: the host's dispatch, not the card, set its time.
//
// Semantics (those of the plain route): grid_sample(bilinear, border
// padding, align_corners=False) composed with the reference's pixel -> grid
// normalisation, so a coordinate c maps to the source point
// x = c * W/(W-1) - 0.5, clamped to [0, W-1]; x0 = min(floor(x), W-2) and
// wx = x - x0, likewise y. Clamping x0 to W-2 keeps the 2x2 footprint inside
// the image, and wx saturates to 0 or 1 at the border, which gives border
// padding's values. The coordinate gradient is zero where the unclamped
// point lies outside [0, W-1] (resp. [0, H-1]); on the far border itself it
// is the one-sided derivative.
//
// What bounds it on an H100: bytes. Per (warp, pixel) with C=3 the forward
// reads 2 coordinates and the pixel's share of the images (neighbouring
// pixels share footprints, which the caches serve) and writes C values:
// ~32 B. The backward reads the coordinates, the incoming gradient and the
// footprint, writes the coordinate gradient and adds its 4 C products into
// the image gradient: ~52 B. A view at 512x288 with K=18 moves ~85 MB
// forward and ~138 MB backward: ~25 and ~41 us at 3.35 TB/s.
//
// Design: one thread per (warp, pixel), all C channels, one launch a call.
// Every value is rounded op by op in the plain route's order (the _rn
// intrinsics are never contracted into FMAs), so the forward is bit-equal
// to it. The backward recomputes the footprint from the images and the
// coordinates instead of keeping the gathered [K, P, 4C] rows, and adds
// the four weighted products straight into the image gradient by atomicAdd:
// the adjoint of the plain route's index_add_ into its packed footprint
// space and inverse rolls, in another order of summation, so the image
// gradient is close to it and not equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// The plain route's _warp_prep for one pixel.
struct Tap {
  int64_t i00;        // flat pixel index of (y0, x0) in its warp's image
  float wx, wy;       // weights of column x0 + 1 and row y0 + 1
  bool inb_x, inb_y;  // the unclamped point inside [0, W-1], [0, H-1]
};

// torch.clamp: NaN passes through (and then reads pixel 0, as the plain
// route's clamped integer index does).
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return v != v ? v : fminf(fmaxf(v, 0.f), hi);
}

__device__ __forceinline__ Tap make_tap(float cx, float cy, int W, int H,
                                        float sx, float sy) {
  float x = __fsub_rn(__fmul_rn(cx, sx), 0.5f);
  float y = __fsub_rn(__fmul_rn(cy, sy), 0.5f);
  const float xm = (float)(W - 1), ym = (float)(H - 1);
  Tap t;
  t.inb_x = x >= 0.f && x <= xm;
  t.inb_y = y >= 0.f && y <= ym;
  x = clamp_keep_nan(x, xm);
  y = clamp_keep_nan(y, ym);
  // a NaN converts to 0
  const int x0 = max(0, min((int)floorf(x), W - 2));
  const int y0 = max(0, min((int)floorf(y), H - 2));
  t.wx = __fsub_rn(x, (float)x0);
  t.wy = __fsub_rn(y, (float)y0);
  t.i00 = (int64_t)y0 * W + x0;
  return t;
}

__global__ void __launch_bounds__(THREADS)
warp_fwd_kernel(const float* __restrict__ imgs, const float* __restrict__ coords,
                float* __restrict__ out, int64_t n, int W, int H, int C,
                float sx, float sy) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;  // (warp, pixel)
  if (i >= n) return;
  const int64_t P = (int64_t)W * H;
  const Tap t = make_tap(coords[2 * i], coords[2 * i + 1], W, H, sx, sy);
  const float* v00 = imgs + ((i / P) * P + t.i00) * C;
  const float* v10 = v00 + C;
  const float* v01 = v00 + (int64_t)W * C;
  const float* v11 = v01 + C;
  const float owx = __fsub_rn(1.f, t.wx), owy = __fsub_rn(1.f, t.wy);
  float* o = out + i * C;
  for (int c = 0; c < C; ++c) {
    const float top = __fadd_rn(__fmul_rn(v00[c], owx), __fmul_rn(v10[c], t.wx));
    const float bot = __fadd_rn(__fmul_rn(v01[c], owx), __fmul_rn(v11[c], t.wx));
    o[c] = __fadd_rn(__fmul_rn(top, owy), __fmul_rn(bot, t.wy));
  }
}

// g_img must hold zeros: every (warp, pixel) adds its four products there.
__global__ void __launch_bounds__(THREADS)
warp_bwd_kernel(const float* __restrict__ imgs, const float* __restrict__ coords,
                const float* __restrict__ g, float* __restrict__ g_img,
                float* __restrict__ g_coord, int64_t n, int W, int H, int C,
                float sx, float sy) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t P = (int64_t)W * H;
  const Tap t = make_tap(coords[2 * i], coords[2 * i + 1], W, H, sx, sy);
  const int64_t o00 = ((i / P) * P + t.i00) * C;
  const int64_t o10 = o00 + C, o01 = o00 + (int64_t)W * C, o11 = o01 + C;
  const float owx = __fsub_rn(1.f, t.wx), owy = __fsub_rn(1.f, t.wy);
  const float* gi = g + i * C;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float gc = gi[c];
    // g (1-wx)(1-wy), g wx (1-wy), g (1-wx) wy, g wx wy, each a product of
    // three as the plain route's (g * a) * b
    const float ga = __fmul_rn(gc, owx), gb = __fmul_rn(gc, t.wx);
    atomicAdd(g_img + o00 + c, __fmul_rn(ga, owy));
    atomicAdd(g_img + o10 + c, __fmul_rn(gb, owy));
    atomicAdd(g_img + o01 + c, __fmul_rn(ga, t.wy));
    atomicAdd(g_img + o11 + c, __fmul_rn(gb, t.wy));
    const float v00 = imgs[o00 + c], v10 = imgs[o10 + c];
    const float v01 = imgs[o01 + c], v11 = imgs[o11 + c];
    const float dx = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), owy),
                               __fmul_rn(__fsub_rn(v11, v01), t.wy));
    const float dy = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), owx),
                               __fmul_rn(__fsub_rn(v11, v10), t.wx));
    gx = c ? __fadd_rn(gx, __fmul_rn(gc, dx)) : __fmul_rn(gc, dx);
    gy = c ? __fadd_rn(gy, __fmul_rn(gc, dy)) : __fmul_rn(gc, dy);
  }
  g_coord[2 * i] = __fmul_rn(gx, t.inb_x ? sx : 0.f);
  g_coord[2 * i + 1] = __fmul_rn(gy, t.inb_y ? sy : 0.f);
}

// The shapes a launch takes: W, H >= 2 (a 2x2 footprint), C >= 1, and
// K * H * W below 2^31 (the wrapper's limit; offsets are 64-bit inside).
int check(int K, int H, int W, int C, int64_t& n, int& blocks) {
  if (K < 0 || W < 2 || H < 2 || C < 1) return (int)cudaErrorInvalidValue;
  n = (int64_t)K * H * W;
  if (n >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  blocks = (int)((n + THREADS - 1) / THREADS);
  return 0;
}

// The plain route's scale W/(W-1): a double quotient rounded to float, as
// PyTorch rounds a Python scalar for a float32 product.
float scale(int S) { return (float)((double)S / (double)(S - 1)); }

}  // namespace

// imgs [K, H, W, C], coords [K, H, W, 2] -> out [K, H, W, C], all float32
// and contiguous on the current device; launched on `stream`.
extern "C" int warp_fwd(const void* imgs, const void* coords, void* out, int K,
                        int H, int W, int C, void* stream) {
  int64_t n = 0;
  int blocks = 0;
  if (int err = check(K, H, W, C, n, blocks)) return err;
  if (n == 0) return 0;
  warp_fwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(coords),
      static_cast<float*>(out), n, W, H, C, scale(W), scale(H));
  return (int)cudaGetLastError();
}

// The gradients of warp_fwd's output g [K, H, W, C]: g_img [K, H, W, C]
// (zeroed by the caller) and g_coord [K, H, W, 2].
extern "C" int warp_bwd(const void* imgs, const void* coords, const void* g,
                        void* g_img, void* g_coord, int K, int H, int W, int C,
                        void* stream) {
  int64_t n = 0;
  int blocks = 0;
  if (int err = check(K, H, W, C, n, blocks)) return err;
  if (n == 0) return 0;
  warp_bwd_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(coords),
      static_cast<const float*>(g), static_cast<float*>(g_img),
      static_cast<float*>(g_coord), n, W, H, C, scale(W), scale(H));
  return (int)cudaGetLastError();
}
