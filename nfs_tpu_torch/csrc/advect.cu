// Bounded-displacement semi-Lagrangian advection of a 3D scalar field
// (clamp boundary) and its two adjoints, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nfs_tpu/ops/pallas_advect.py:
//   K1  advect_fwd_kernel       <- _fwd_kernel        (forward)
//   K2  advect_bwd_field_kernel <- _bwd_field_kernel  (grad wrt the field)
//   K3  advect_bwd_vel_kernel   <- _bwd_vel_kernel    (grad wrt backtrace s)
//   K3b advect_bwd_fused_kernel <- _bwd_fused_kernel  (K2 and K3 in one pass)
//
// What they compute (all f32, C-contiguous, vel channel-last (D,H,W,3) in
// array-axis order, displacement already scaled by dt):
//   s_a[i]  = clip(i_a - clip(v_a[i], -max_disp, max_disp), 0, n_a - 1)
//   out[i]  = sum_c prod_a tent(s_a[i] - c_a) * f[c]          (K1)
//   gf[j]   = sum_i prod_a tent(s_a[i] - j_a) * g[i]          (K2, pull)
//   gs_a[i] = g[i] * sum_c d_a[prod tent](s_i - c) * f[c]     (K3)
// with tent(u) = max(0, 1 - |u|), corners outside the grid reading 0, and
// the derivative of tent taken with JAX's subgradient conventions
// (abs'(0) = +1, 0.5 at |u| == 1), exactly as _dtent does. K3b writes K2's
// gf and K3's gs from one thread per cell.
//
// Design. The TPU kernels evaluate all (2K+1)^3 window taps from a VMEM
// slab because the TPU has no fast gather. On Hopper a gather through L1
// is cheap, so each kernel touches only the taps whose weight can be
// nonzero: 8 corners for K1, 27 taps for K3 (s_a - 1 .. s_a + 1 around
// floor(s_a); the tap at floor + 2 always has |u| > 1), and
// (2R+1)^3 source cells for K2 with R = ceil(max_disp) (a source i
// further away backtraces to |s_a - j_a| >= 1 and has zero weight).
// One thread per output cell, neighbouring threads on neighbouring x, so
// the reads of a warp coalesce. K2 gathers (pull) instead of scattering
// with atomics: it is deterministic, which bit-exact resume needs.
// Bound on the H100: K1 and K3 are memory-bound (one read of vel and g,
// 8 / 27 mostly-L1 reads of f, one write). K2 re-reads (2R+1)^3 vel/g
// neighbours per cell, mostly from L1/L2; its time grows with R^3, and
// the early exit on a zero z-weight skips most of the y/x work.
// K3b runs K2's and K3's device functions back to back in one thread: it
// saves one launch and one read of vel and g (36 B per cell against 48 B
// for the pair), and its result equals the pair's term for term. The TPU
// kernel fused the two legs to halve slab DMAs; there is no slab here.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tent(float u) {
  return fmaxf(0.0f, 1.0f - fabsf(u));
}

// d/du max(0, 1 - |u|) with JAX's conventions (pallas_advect.py _dtent).
__device__ __forceinline__ float dtent(float u) {
  const float sgn = u >= 0.0f ? 1.0f : -1.0f;
  const float au = fabsf(u);
  const float mag = au < 1.0f ? 1.0f : (au == 1.0f ? 0.5f : 0.0f);
  return -sgn * mag;
}

// Clamped backtrace coordinate along one axis.
__device__ __forceinline__ float backtrace(int i, float v, float max_disp,
                                           int n) {
  const float disp = fminf(fmaxf(v, -max_disp), max_disp);
  return fminf(fmaxf(static_cast<float>(i) - disp, 0.0f),
               static_cast<float>(n - 1));
}

__global__ void advect_fwd_kernel(const float* __restrict__ field,
                                  const float* __restrict__ vel,
                                  float* __restrict__ out, int D, int H,
                                  int W, float max_disp) {
  const long long n = static_cast<long long>(D) * H * W;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % W);
  const int y = static_cast<int>((idx / W) % H);
  const int z = static_cast<int>(idx / (static_cast<long long>(W) * H));
  const float sz = backtrace(z, vel[3 * idx + 0], max_disp, D);
  const float sy = backtrace(y, vel[3 * idx + 1], max_disp, H);
  const float sx = backtrace(x, vel[3 * idx + 2], max_disp, W);
  // s lies in [0, n-1], so floor(s) is a valid index and only the upper
  // corner can fall outside (then s == n-1 exactly and its weight is 0).
  const int z0 = static_cast<int>(floorf(sz));
  const int y0 = static_cast<int>(floorf(sy));
  const int x0 = static_cast<int>(floorf(sx));
  float acc = 0.0f;
  for (int zc = z0; zc <= z0 + 1 && zc < D; ++zc) {
    const float wz = tent(sz - static_cast<float>(zc));
    for (int yc = y0; yc <= y0 + 1 && yc < H; ++yc) {
      const float wzy = wz * tent(sy - static_cast<float>(yc));
      const float* row = field + (static_cast<long long>(zc) * H + yc) * W;
      for (int xc = x0; xc <= x0 + 1 && xc < W; ++xc) {
        acc += wzy * tent(sx - static_cast<float>(xc)) * row[xc];
      }
    }
  }
  out[idx] = acc;
}

// K2's pull at cell (z, y, x): the (2R+1)^3 source cells i in the grid,
// each weighted by prod_a tent(s_a[i] - j_a). A source outside the grid is
// skipped (the TPU kernel reads g = 0 in its zero pad there).
__device__ __forceinline__ float pull_field_grad(
    const float* __restrict__ vel, const float* __restrict__ g, int z, int y,
    int x, int D, int H, int W, float max_disp, int R) {
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const float fx = static_cast<float>(x);
  float acc = 0.0f;
  for (int iz = max(z - R, 0); iz <= min(z + R, D - 1); ++iz) {
    for (int iy = max(y - R, 0); iy <= min(y + R, H - 1); ++iy) {
      const long long row = (static_cast<long long>(iz) * H + iy) * W;
      for (int ix = max(x - R, 0); ix <= min(x + R, W - 1); ++ix) {
        const long long i = row + ix;
        const float wz = tent(backtrace(iz, vel[3 * i + 0], max_disp, D) - fz);
        if (wz == 0.0f) continue;
        const float wy = tent(backtrace(iy, vel[3 * i + 1], max_disp, H) - fy);
        if (wy == 0.0f) continue;
        const float wx = tent(backtrace(ix, vel[3 * i + 2], max_disp, W) - fx);
        acc += wz * wy * wx * g[i];
      }
    }
  }
  return acc;
}

struct Grad3 {
  float z, y, x;
};

// K3's 27 taps at cell idx = (z, y, x), before the factor g[idx]:
// sum_c d_a[prod tent](s - c) * f[c] for a = z, y, x.
__device__ __forceinline__ Grad3 push_vel_grad(
    const float* __restrict__ field, const float* __restrict__ vel,
    long long idx, int z, int y, int x, int D, int H, int W,
    float max_disp) {
  const float s[3] = {backtrace(z, vel[3 * idx + 0], max_disp, D),
                      backtrace(y, vel[3 * idx + 1], max_disp, H),
                      backtrace(x, vel[3 * idx + 2], max_disp, W)};
  const int dims[3] = {D, H, W};
  // Per axis: taps floor(s)-1 .. floor(s)+1, their tent weight and tent
  // derivative; a tap outside the grid reads a zero field value.
  int c[3][3];
  float w[3][3];
  float d[3][3];
  for (int a = 0; a < 3; ++a) {
    const int base = static_cast<int>(floorf(s[a])) - 1;
    for (int t = 0; t < 3; ++t) {
      const int ct = base + t;
      const bool ok = ct >= 0 && ct < dims[a];
      const float u = s[a] - static_cast<float>(ct);
      c[a][t] = ok ? ct : -1;
      w[a][t] = tent(u);
      d[a][t] = dtent(u);
    }
  }
  float az = 0.0f, ay = 0.0f, ax = 0.0f;
  for (int tz = 0; tz < 3; ++tz) {
    if (c[0][tz] < 0) continue;
    for (int ty = 0; ty < 3; ++ty) {
      if (c[1][ty] < 0) continue;
      const float* row =
          field + (static_cast<long long>(c[0][tz]) * H + c[1][ty]) * W;
      for (int tx = 0; tx < 3; ++tx) {
        if (c[2][tx] < 0) continue;
        const float f = row[c[2][tx]];
        az += d[0][tz] * w[1][ty] * w[2][tx] * f;
        ay += w[0][tz] * d[1][ty] * w[2][tx] * f;
        ax += w[0][tz] * w[1][ty] * d[2][tx] * f;
      }
    }
  }
  return {az, ay, ax};
}

// Linear index of this thread's cell and its (z, y, x); false past the end.
__device__ __forceinline__ bool cell_of_thread(int D, int H, int W,
                                               long long* idx, int* z,
                                               int* y, int* x) {
  const long long n = static_cast<long long>(D) * H * W;
  *idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (*idx >= n) return false;
  *x = static_cast<int>(*idx % W);
  *y = static_cast<int>((*idx / W) % H);
  *z = static_cast<int>(*idx / (static_cast<long long>(W) * H));
  return true;
}

__device__ __forceinline__ void store_grad_s(float* __restrict__ grad_s,
                                             long long idx, Grad3 a,
                                             float gi) {
  grad_s[3 * idx + 0] = a.z * gi;
  grad_s[3 * idx + 1] = a.y * gi;
  grad_s[3 * idx + 2] = a.x * gi;
}

__global__ void advect_bwd_field_kernel(const float* __restrict__ vel,
                                        const float* __restrict__ g,
                                        float* __restrict__ grad_field,
                                        int D, int H, int W, float max_disp,
                                        int R) {
  long long idx;
  int z, y, x;
  if (!cell_of_thread(D, H, W, &idx, &z, &y, &x)) return;
  grad_field[idx] = pull_field_grad(vel, g, z, y, x, D, H, W, max_disp, R);
}

__global__ void advect_bwd_vel_kernel(const float* __restrict__ field,
                                      const float* __restrict__ vel,
                                      const float* __restrict__ g,
                                      float* __restrict__ grad_s, int D,
                                      int H, int W, float max_disp) {
  long long idx;
  int z, y, x;
  if (!cell_of_thread(D, H, W, &idx, &z, &y, &x)) return;
  store_grad_s(grad_s, idx,
               push_vel_grad(field, vel, idx, z, y, x, D, H, W, max_disp),
               g[idx]);
}

// K3b: one thread per cell j writes K2's grad_f[j] and K3's grad_s[j, :].
__global__ void advect_bwd_fused_kernel(const float* __restrict__ field,
                                        const float* __restrict__ vel,
                                        const float* __restrict__ g,
                                        float* __restrict__ grad_field,
                                        float* __restrict__ grad_s, int D,
                                        int H, int W, float max_disp,
                                        int R) {
  long long idx;
  int z, y, x;
  if (!cell_of_thread(D, H, W, &idx, &z, &y, &x)) return;
  grad_field[idx] = pull_field_grad(vel, g, z, y, x, D, H, W, max_disp, R);
  store_grad_s(grad_s, idx,
               push_vel_grad(field, vel, idx, z, y, x, D, H, W, max_disp),
               g[idx]);
}

constexpr int kThreads = 256;

unsigned int blocks_for(int D, int H, int W) {
  const long long n = static_cast<long long>(D) * H * W;
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int nfs_advect_fwd(const void* field, const void* vel, void* out, int D,
                   int H, int W, float max_disp, void* stream) {
  advect_fwd_kernel<<<blocks_for(D, H, W), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float*>(vel),
      static_cast<float*>(out), D, H, W, max_disp);
  return static_cast<int>(cudaGetLastError());
}

int nfs_advect_bwd_field(const void* vel, const void* g, void* grad_field,
                         int D, int H, int W, float max_disp, int R,
                         void* stream) {
  advect_bwd_field_kernel<<<blocks_for(D, H, W), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vel), static_cast<const float*>(g),
      static_cast<float*>(grad_field), D, H, W, max_disp, R);
  return static_cast<int>(cudaGetLastError());
}

int nfs_advect_bwd_vel(const void* field, const void* vel, const void* g,
                       void* grad_s, int D, int H, int W, float max_disp,
                       void* stream) {
  advect_bwd_vel_kernel<<<blocks_for(D, H, W), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float*>(vel),
      static_cast<const float*>(g), static_cast<float*>(grad_s), D, H, W,
      max_disp);
  return static_cast<int>(cudaGetLastError());
}

int nfs_advect_bwd_fused(const void* field, const void* vel, const void* g,
                         void* grad_field, void* grad_s, int D, int H, int W,
                         float max_disp, int R, void* stream) {
  advect_bwd_fused_kernel<<<blocks_for(D, H, W), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(field), static_cast<const float*>(vel),
      static_cast<const float*>(g), static_cast<float*>(grad_field),
      static_cast<float*>(grad_s), D, H, W, max_disp, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
