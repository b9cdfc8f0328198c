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
// run in no order, so the k loop runs inside the thread, and neither
// kernel uses atomics: the results are deterministic, which bit-exact
// resume needs.
//   K4 pulls. Its first version took one thread per padded cell reading
//   the 27 bins q - off of every rank from device memory. Only ~7% of the slots
//   hold a particle at the particles_3d finest octave, yet some lane of a
//   warp nearly always did, so every warp ran the full weight arithmetic
//   for each of its 27 K slots, each slot's weights recomputed up to 27
//   times: bound by issued instructions, at 8.6% of its least time.
//   Staging a tile's bins, one rank at a time, with their weights in
//   shared memory (the natural translation of the TPU's VMEM slab) ran at
//   0.09-0.12 ms whatever was tried: 52-72 B per staged slot left one or
//   two blocks, 4-8 warps, per SM, and the time followed the warps per SM
//   (PERF.md). So K4 keeps nothing in shared memory: a warp owns a row of
//   30 cells along x, a lane a column of cells along z, and the lane
//   walks the slots of its own column (one load of a per slot and row),
//   computes its slot's weights once per row of slots and hands
//   ((w_z * w_y) * w_x) and a to the two lanes beside it by shuffle. Each
//   slot's weights are computed 3 times (once per row of cells it
//   reaches), not 27, a row of slots that is empty across the warp is
//   skipped, and 40 registers a thread keep ~48 warps per SM in flight.
//   Issued instructions and the latency of the loads of a then bound it.
//   K5 gathers, as the TPU kernel does: one thread per slot (k, b)
//   evaluates 3 weights and 3 derivatives per axis once and reads the 27
//   cotangents g[b + off] (g is one (Z, Y, X) grid, small enough to stay
//   in L2); memory-bound (4 bin arrays + g in, 4 bin arrays out).

#include <cuda_runtime.h>

#include <climits>

#include "launch.cuh"

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

// ---------------------------------------------------------------------
// K4: a warp owns kLanesX output cells along x (its 32 lanes cover them
// and the 2 bins below them), a lane one column of kCellsZ cells along z;
// a block holds kRows warps, one per row y (PERF.md gives the launches
// tried). No shared memory and no barrier, so the SM keeps as many warps
// in flight as registers allow; the launch bounds ask for kWarpsPerSm
// warps per SM, which holds a thread to 40 registers.
// ---------------------------------------------------------------------

constexpr int kLanesX = 30;
constexpr int kRows = 4;
constexpr int kCellsZ = 4;
constexpr int kWarpsPerSm = 48;
constexpr unsigned kFullWarp = 0xffffffffu;

// out[q] for this lane's cells (z0 + j, y, x), j < kCellsZ, summed in
// the order of the one-thread-per-cell version this replaces: rank k,
// then oz, oy, ox ascending, each term ((w_z * w_y) * w_x) * a. The lane
// visits the slots (bz, y - oy, x) of its own column, bz descending from
// the top cell down to z0 - 2, so a cell meets its slots in ascending oz;
// for each it computes the slot's weights once and takes
// ((w_z * w_y) * w_x) and a of the slots x - 1 and x - 2 from the lanes
// beside it. A row of slots that holds no particle
// in the whole warp adds only +0 terms and is skipped; an empty slot's
// positions are not read (empty and parked slots may hold any position).
// Deterministic, no atomics.
__global__ void __launch_bounds__(32 * kRows, kWarpsPerSm / kRows)
    binsplat_fwd_kernel(const float* __restrict__ a,
                        const float* __restrict__ pz,
                        const float* __restrict__ py,
                        const float* __restrict__ px,
                        float* __restrict__ out, int K, int Z, int Y,
                        int X) {
  const int lane = static_cast<int>(threadIdx.x);
  const int x = static_cast<int>(blockIdx.x) * kLanesX - 2 + lane;
  const int y = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y);
  const int z0 = static_cast<int>(blockIdx.z) * kCellsZ;
  if (y >= Y) return;  // the whole warp: all its lanes share y
  const bool column = x >= 0 && x < X;
  const long long cells = static_cast<long long>(Z) * Y * X;
  float acc[kCellsZ];
#pragma unroll
  for (int j = 0; j < kCellsZ; ++j) acc[j] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const long long rank = k * cells;
#pragma unroll
    for (int t = kCellsZ + 1; t >= 0; --t) {
      const int bz = z0 - 2 + t;
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        const int by = y - oy;
        const bool in = column && bz >= 0 && bz < Z && by >= 0;
        const long long i =
            rank + (in ? static_cast<long long>(bz * Y + by) * X + x : 0);
        float av = a[i];
        if (!in) av = 0.0f;
        if (!__any_sync(kFullWarp, av != 0.0f)) continue;
        float wx[3] = {0.0f, 0.0f, 0.0f};
        float wzy[3] = {0.0f, 0.0f, 0.0f};
        if (av != 0.0f) {
          const float fz = pz[i] + kPad - static_cast<float>(bz);
          const float fy = py[i] + kPad - static_cast<float>(by);
          const float fx = px[i] + kPad - static_cast<float>(x);
          const float wy = w1d(static_cast<float>(oy) - fy);
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            wx[o] = w1d(static_cast<float>(o) - fx);
            // cell z0 + t - 2 + o takes this slot at oz = o
            if (t - 2 + o >= 0 && t - 2 + o < kCellsZ) {
              wzy[o] = w1d(static_cast<float>(o) - fz) * wy;
            }
          }
        }
        const float a1 = __shfl_up_sync(kFullWarp, av, 1);
        const float a2 = __shfl_up_sync(kFullWarp, av, 2);
#pragma unroll
        for (int oz = 0; oz < 3; ++oz) {
          const int j = t - 2 + oz;
          if (j < 0 || j >= kCellsZ) continue;
          const float w0 = wzy[oz] * wx[0];
          const float w1 = __shfl_up_sync(kFullWarp, wzy[oz] * wx[1], 1);
          const float w2 = __shfl_up_sync(kFullWarp, wzy[oz] * wx[2], 2);
          acc[j] += w0 * av;
          acc[j] += w1 * a1;
          acc[j] += w2 * a2;
        }
      }
    }
  }
  if (lane < 2 || x >= X) return;
  const long long row = static_cast<long long>(y) * X + x;
#pragma unroll
  for (int j = 0; j < kCellsZ; ++j) {
    if (z0 + j < Z) {
      out[static_cast<long long>(z0 + j) * Y * X + row] = acc[j];
    }
  }
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

// K5: one thread per slot.
constexpr int kThreads = 256;

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points, called by the operators of ops.cpp once they have
// checked the tensors. Each launches on ``stream`` of CUDA device
// ``device`` (made current for the launch when it is not already), does
// not synchronise, and returns cudaGetLastError() (or the error that
// refused the launch).
extern "C" {

int nfs_binsplat_fwd(const void* a, const void* pz, const void* py,
                     const void* px, void* out, int K, int Z, int Y, int X,
                     int device, void* stream) {
  if (static_cast<long long>(Z) * Y > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return nfs::on_device(device, [&] {
    const dim3 grid((X + kLanesX - 1) / kLanesX, (Y + kRows - 1) / kRows,
                    (Z + kCellsZ - 1) / kCellsZ);
    binsplat_fwd_kernel<<<grid, dim3(32, kRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(pz),
        static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<float*>(out), K, Z, Y, X);
    return cudaGetLastError();
  });
}

int nfs_binsplat_bwd(const void* a, const void* pz, const void* py,
                     const void* px, const void* g, void* da, void* dpz,
                     void* dpy, void* dpx, int K, int Z, int Y, int X,
                     int device, void* stream) {
  return nfs::on_device(device, [&] {
    const long long slots = static_cast<long long>(K) * Z * Y * X;
    binsplat_bwd_kernel<<<blocks_for(slots), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(pz),
        static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<const float*>(g), static_cast<float*>(da),
        static_cast<float*>(dpz), static_cast<float*>(dpy),
        static_cast<float*>(dpx), K, Z, Y, X);
    return cudaGetLastError();
  });
}

}  // extern "C"
