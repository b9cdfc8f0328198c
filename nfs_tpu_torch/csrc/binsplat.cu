// Binned quadratic-B-spline particle-to-grid splat (the LNST hot path) and
// its adjoint, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of nfs_tpu/ops/pallas_binsplat.py:
//   K4 binsplat_fwd_kernel <- _fwd_kernel (forward splat)
//   K5 binsplat_bwd_kernel <- _bwd_kernel (grads wrt attribute, positions)
//
// Inputs are four (K, Z, Y, X) f32 C-contiguous bin arrays over the PADDED
// grid (Z, Y, X): the masked attribute a (0 in empty slots) and the raw
// position components p_z, p_y, p_x of the particle in each slot, in
// unpadded grid coordinates. The slot (k, b) is bin b of rank k; its
// offset from the bin is frac_d = p_d + PAD - b_d (PAD = 2), and its tap
// `off` (each off_d in {0, 1, 2}) lands on cell b + off with weight
//   W_off = w1d(off_z - frac_z) * w1d(off_y - frac_y) * w1d(off_x - frac_x)
//   out[q]     = sum_k sum_off W_off[k, q - off] * a[k, q - off]    (K4)
//   da[k, b]   = sum_off W_off[k, b] * g[b + off]                    (K5)
//   dp_d[k, b] = a[k, b] * sum_off (-w1d')_d * (other two w) * g[b + off]
// with the quadratic B-spline w1d, and its derivative taken with JAX's
// subgradient conventions as pallas_binsplat.py _dw1d is: the branch the
// forward `where` selects at |u| = 0.5 and 1.5, and sign +1 at u = 0. Bins
// q - off below 0 and cells b + off beyond the grid contribute nothing.
//
// Design. The TPU kernels keep a z-slab of the bins in VMEM and the output
// block resident across a sequential k grid dimension. On Hopper blocks
// run in no order, so both kernels are one thread per output element with
// the k and tap loops inside the thread, and neither uses atomics: the
// results are deterministic, which bit-exact resume will need.
//   K4 pulls: one thread per padded cell q reads the 27 bins q - off of
//   every rank k. Neighbouring threads read neighbouring x, so a warp's
//   reads coalesce and the 27-fold re-reads of a bin mostly hit L1/L2. An
//   empty slot (a == 0) contributes exactly 0 and is skipped: at the
//   particles_3d finest octave ~7% of the slots hold a particle.
//   K5 gathers, as the TPU kernel does: one thread per slot (k, b)
//   evaluates 3 weights and 3 derivatives per axis once and reads the 27
//   cotangents g[b + off] (g is one (Z, Y, X) grid, small enough to stay
//   in L2).
// Bound on the H100: both are memory-bound at the main path's shapes (K4
// moves 4 bin arrays in and one grid out, K5 4 bin arrays + g in and 4
// bin arrays out; a few hundred flops per slot are far below the f32
// rate). A shared-memory tile of bins with its 2-cell low halo and the 9
// weights precomputed per bin is the next step for K4.

#include <cuda_runtime.h>

namespace {

constexpr float kPad = 2.0f;  // nfs_tpu_torch.ops.binsplat.PAD

// Quadratic B-spline (pallas_binsplat.py _w1d).
__device__ __forceinline__ float w1d(float u) {
  const float au = fabsf(u);
  if (au < 0.5f) return 0.75f - au * au;
  if (au < 1.5f) {
    const float t = 1.5f - au;
    return 0.5f * (t * t);
  }
  return 0.0f;
}

// d w1d / du with JAX's conventions (pallas_binsplat.py _dw1d).
__device__ __forceinline__ float dw1d(float u) {
  const float sgn = u >= 0.0f ? 1.0f : -1.0f;
  const float au = fabsf(u);
  if (au < 0.5f) return -2.0f * u;
  if (au < 1.5f) return -(1.5f - au) * sgn;
  return 0.0f;
}

__global__ void binsplat_fwd_kernel(const float* __restrict__ a,
                                    const float* __restrict__ pz,
                                    const float* __restrict__ py,
                                    const float* __restrict__ px,
                                    float* __restrict__ out, int K, int Z,
                                    int Y, int X) {
  const long long cells = static_cast<long long>(Z) * Y * X;
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= cells) return;
  const int qx = static_cast<int>(q % X);
  const int qy = static_cast<int>((q / X) % Y);
  const int qz = static_cast<int>(q / (static_cast<long long>(X) * Y));
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long kbase = static_cast<long long>(k) * cells;
    for (int oz = 0; oz < 3 && qz - oz >= 0; ++oz) {
      const int bz = qz - oz;
      for (int oy = 0; oy < 3 && qy - oy >= 0; ++oy) {
        const int by = qy - oy;
        const long long row =
            kbase + (static_cast<long long>(bz) * Y + by) * X;
        for (int ox = 0; ox < 3 && qx - ox >= 0; ++ox) {
          const int bx = qx - ox;
          const long long i = row + bx;
          const float av = a[i];
          if (av == 0.0f) continue;
          const float fz = pz[i] + kPad - static_cast<float>(bz);
          const float fy = py[i] + kPad - static_cast<float>(by);
          const float fx = px[i] + kPad - static_cast<float>(bx);
          acc += w1d(static_cast<float>(oz) - fz) *
                 w1d(static_cast<float>(oy) - fy) *
                 w1d(static_cast<float>(ox) - fx) * av;
        }
      }
    }
  }
  out[q] = acc;
}

__global__ void binsplat_bwd_kernel(
    const float* __restrict__ a, const float* __restrict__ pz,
    const float* __restrict__ py, const float* __restrict__ px,
    const float* __restrict__ g, float* __restrict__ da,
    float* __restrict__ dpz, float* __restrict__ dpy,
    float* __restrict__ dpx, int K, int Z, int Y, int X) {
  const long long cells = static_cast<long long>(Z) * Y * X;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells * K) return;
  const long long b = i % cells;
  const int bx = static_cast<int>(b % X);
  const int by = static_cast<int>((b / X) % Y);
  const int bz = static_cast<int>(b / (static_cast<long long>(X) * Y));
  const float fz = pz[i] + kPad - static_cast<float>(bz);
  const float fy = py[i] + kPad - static_cast<float>(by);
  const float fx = px[i] + kPad - static_cast<float>(bx);
  float wz[3], wy[3], wx[3], dz[3], dy[3], dx[3];
  for (int o = 0; o < 3; ++o) {
    const float of = static_cast<float>(o);
    wz[o] = w1d(of - fz);
    wy[o] = w1d(of - fy);
    wx[o] = w1d(of - fx);
    // du/dp = -1
    dz[o] = -dw1d(of - fz);
    dy[o] = -dw1d(of - fy);
    dx[o] = -dw1d(of - fx);
  }
  float sa = 0.0f, sz = 0.0f, sy = 0.0f, sx = 0.0f;
  for (int oz = 0; oz < 3 && bz + oz < Z; ++oz) {
    for (int oy = 0; oy < 3 && by + oy < Y; ++oy) {
      const float* grow =
          g + (static_cast<long long>(bz + oz) * Y + (by + oy)) * X;
      for (int ox = 0; ox < 3 && bx + ox < X; ++ox) {
        const float gv = grow[bx + ox];
        sa += wz[oz] * wy[oy] * wx[ox] * gv;
        sz += dz[oz] * wy[oy] * wx[ox] * gv;
        sy += wz[oz] * dy[oy] * wx[ox] * gv;
        sx += wz[oz] * wy[oy] * dx[ox] * gv;
      }
    }
  }
  const float av = a[i];
  da[i] = sa;
  dpz[i] = sz * av;
  dpy[i] = sy * av;
  dpx[i] = sx * av;
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().
extern "C" {

int nfs_binsplat_fwd(const void* a, const void* pz, const void* py,
                     const void* px, void* out, int K, int Z, int Y, int X,
                     void* stream) {
  const long long cells = static_cast<long long>(Z) * Y * X;
  binsplat_fwd_kernel<<<blocks_for(cells), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(pz),
      static_cast<const float*>(py), static_cast<const float*>(px),
      static_cast<float*>(out), K, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}

int nfs_binsplat_bwd(const void* a, const void* pz, const void* py,
                     const void* px, const void* g, void* da, void* dpz,
                     void* dpy, void* dpx, int K, int Z, int Y, int X,
                     void* stream) {
  const long long slots = static_cast<long long>(K) * Z * Y * X;
  binsplat_bwd_kernel<<<blocks_for(slots), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(pz),
      static_cast<const float*>(py), static_cast<const float*>(px),
      static_cast<const float*>(g), static_cast<float*>(da),
      static_cast<float*>(dpz), static_cast<float*>(dpy),
      static_cast<float*>(dpx), K, Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
