// Bounded-displacement semi-Lagrangian advection of a 3D scalar field
// (clamp boundary) and its two adjoints, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of nfs_tpu/ops/pallas_advect.py:
//   K1  advect_fwd_kernel       <- _fwd_kernel        (forward)
//   K2  advect_bwd_field_kernel <- _bwd_field_kernel  (grad wrt the field)
//       advect_bin_sources_kernel and advect_bwd_field_binned_kernel
//       (K2's binned route, from R = 4; its tile plan ends at R = 8)
//       advect_bwd_field_untiled_kernel (K2's untiled pull: on no path,
//       the oracle the binned route is held against)
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
// gf and K3's gs.
//
// Design. The TPU kernels evaluate all (2K+1)^3 window taps from a VMEM
// slab because the TPU has no fast gather. On Hopper a gather through L1
// is cheap, so K1 and K3 touch only the taps whose weight can be nonzero:
// 8 corners for K1, 27 taps for K3 (s_a - 1 .. s_a + 1 around floor(s_a);
// the tap at floor + 2 always has |u| > 1), neighbouring threads on
// neighbouring x.
//
// K1 and K3 were first written with one thread per cell over the flat
// index, and spent their issue slots on three 64-bit divisions per cell
// and on loop guards (PERF.md: K1 at 32% of its least time, K3 at 25%).
// Both now run a 2D launch with 32-bit indices: a thread owns one (y, x)
// and a run of cells along z, and loads all their displacements (and, for
// K3, cotangents) before it gathers. K1 clamps its upper corners instead
// of guarding them (their weight is exactly 0 where they leave the grid).
// K3 cannot: at a backtrace clamped to exactly 0 or n - 1 the tap outside
// the grid has weight 0 but a tent derivative of -+0.5, so K3 zeroes
// both along that axis instead, without a branch per tap. It also leaves
// out the terms of weight +0 that every cell has (push_vel_grad): 36 of
// its 81 products remain, from 20 of its 27 taps. K1 runs at ~40% of its
// least time, random and smooth displacements within 10% of each other;
// staging f with its halo in shared memory lost to the gather through L1
// in every tile tried (PERF.md), so f is read through L1.
//
// K2 and K3b pull: cell j sums over the (2R+1)^3 source cells i within
// R = ceil(max_disp) of it (a source further away backtraces to
// |s_a - j_a| >= 1 and has zero weight). Pulling instead of scattering
// with atomics keeps them deterministic, which bit-exact resume needs;
// there are no atomics anywhere here. Their least time is set by bytes
// (20 / 36 B per cell), but what bounds them on the H100 is the
// instructions they issue for the (2R+1)^3 = 125 source visits per cell
// at R = 2: with one thread per cell reading its sources from global
// memory, every source would be re-read and re-backtraced up to 125
// times, through strided loads of the channel-last vel.
//
// So a block owns a TZ x TY x TX tile of output cells (x fastest; the
// wrapper picks the tile from R, 4 x 8 x 24 up to R = 5) and stages the
// tile plus its R-halo of sources in dynamic shared memory, each source
// backtraced once per block: (s_z, s_y, s_x, g) as one float4 (16 B per
// source). The pull then reads shared memory only, without a branch, in
// ascending (iz, iy, ix) with the arithmetic of the pull from device
// memory, so for finite g the sum is the same to the bit. A thread takes
// kCellsX = 3 cells along x: per row of sources it loads 2R + 3 of them
// (not 3 (2R + 1)) and computes w_z * w_y once per source for its cells.
// Shared-memory bandwidth and issued instructions then bound the pull.
// A source outside the grid is staged with s = kOutside and g = 0: its
// weight is 0 for every cell.
//
// K3b also stages f over the tile with an (R+1)-halo, zero outside the
// grid, which holds all 27 taps of every cell of the tile, and runs K3's
// arithmetic on its staged s and f: its result equals K2 + K3 to the bit.
//
// The tile of K2 plus its R-halo of sources outgrows the 227 KB a block
// may stage past R = 8 (R = 7 for K3b, which also stages f). A pull
// without a tile (advect_bwd_field_untiled_kernel: one thread per cell,
// its (2R+1)^3 sources read and backtraced from device memory, 6 859 per
// cell at R = 9, in the same order and arithmetic, so the tiled pull's
// bits) spends its time on sources of weight 0: only those whose floor
// cell floor(s) is one of the 8 cells j - d, d in {0, 1}^3, can weigh on
// cell j; the tiled pull too visits (2R+1)^3 sources per cell. So from
// R = 4, where it is the faster on the H100 (the wrapper's BINNED_FROM_R;
// PERF.md gives both routes' times), and past R = 8, where no tile fits,
// the wrapper takes the binned route, whose work grows with the cells
// and not with (2R+1)^3:
//   1. advect_bin_sources_kernel backtraces every source once and writes
//      its record (s_z, s_y, s_x, g), the float4 the tiled pull stages,
//      and as its key the flat index of its floor cell;
//   2. the wrapper sorts the keys stably (torch.sort) and finds the run
//      of each floor cell (torch.searchsorted): within a run the sources
//      stay in ascending source index;
//   3. advect_bwd_field_binned_kernel gives each output cell a thread that
//      merges its 8 runs by source index and adds ((w_z * w_y) * w_x) * g
//      in ascending (iz, iy, ix), the arithmetic of the pull.
// Every source of nonzero weight lies within R of the cell, so the pull
// adds the same nonzero terms in the same order; the terms it adds and the
// gather does not, and the gather's sources beyond R, all have weight 0
// and add +-0. For finite g the binned route thus gives the pull's bits,
// with no atomics and a fixed order. The gather reads each source once
// per cell of its 8 (8 visits per source, whatever R is), through perm,
// so its record reads are scattered. Its least time is set by bytes, as
// K2's; what bounds it on the H100 is the sort (radix passes over the
// keys and their indices, and the search for the runs), then the
// gather's scattered reads (PERF.md).
//
// Every kernel takes a batch of B frames, (B, D, H, W) fields and
// (B, D, H, W, 3) displacements, in one launch (the joint sequence engine
// advects all its local frames at once; the TPU package ran one launch per
// frame under sequential_vmap). The frame index is folded into a grid
// dimension the kernel does not otherwise use: grid.z for K1, K3 and the
// untiled and binned K2, and b * ceil(D / TZ) + tz in grid.z for the tiled
// K2 and K3b. The binned route's keys number the floor cells over the
// whole batch (b * D * H * W + cell), so one sort serves every frame and a
// frame's runs hold its own sources only.
// A block offsets its pointers to its frame and runs the per-cell
// arithmetic of a single frame unchanged, so a batched launch gives the
// bits of B single launches.

#include <cuda_runtime.h>

#include <climits>

#include "launch.cuh"

namespace {

__device__ __forceinline__ float tent(float u) {
  return fmaxf(0.0f, 1.0f - fabsf(u));
}

// Clamped backtrace coordinate along one axis.
__device__ __forceinline__ float backtrace(int i, float v, float max_disp,
                                           int n) {
  const float disp = fminf(fmaxf(v, -max_disp), max_disp);
  return fminf(fmaxf(static_cast<float>(i) - disp, 0.0f),
               static_cast<float>(n - 1));
}

// Staged backtrace of a source outside the grid: tent(kOutside - j) == 0
// for every cell j, and its g is 0.
constexpr float kOutside = -1.0e30f;

// K1's launch: blocks of kFwdThreads threads along the (y, x) plane, each
// thread taking kFwdCellsZ cells along z (PERF.md gives the launches
// tried).
constexpr int kFwdThreads = 512;
constexpr int kFwdCellsZ = 2;

// K1: a thread owns one (y, x) of the plane and kFwdCellsZ cells along z
// at it (blockIdx.y numbers the runs of kFwdCellsZ planes). Neighbouring
// lanes take neighbouring x, so every load of vel and every corner gather
// of f is coalesced across the warp as far as the displacement allows. The
// thread loads the displacements of all its cells before it gathers, so
// their loads are in flight together. Indices are 32-bit (one division by
// W per thread); the entry point refuses D * H or H * W past INT_MAX. The
// upper corner's index is clamped instead of guarded: it leaves the grid
// only where s == n - 1, whose weight there is exactly 0, so the term
// adds +-0 and, for finite f, the sum keeps the bits of a loop that skips
// it (a sum that starts at +0 never becomes -0). The arithmetic is that
// of the one-thread-per-cell kernel this replaces: wzy = wz * wy, then
// acc += (wzy * wx) * f in (zc, yc, xc) order.
__global__ void advect_fwd_kernel(const float* __restrict__ field,
                                  const float* __restrict__ vel,
                                  float* __restrict__ out, int D, int H,
                                  int W, float max_disp) {
  const int plane = H * W;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const long long frame = static_cast<long long>(blockIdx.z) * D * plane;
  field += frame;
  vel += 3 * frame;
  out += frame;
  const int y = p / W;
  const int x = p - y * W;
  const int z_begin = static_cast<int>(blockIdx.y) * kFwdCellsZ;
  float v[kFwdCellsZ][3];
#pragma unroll
  for (int j = 0; j < kFwdCellsZ; ++j) {
    // a cell past the last plane loads the last plane's displacement and
    // stores nothing
    const long long i =
        static_cast<long long>(min(z_begin + j, D - 1)) * plane + p;
    v[j][0] = vel[3 * i + 0];
    v[j][1] = vel[3 * i + 1];
    v[j][2] = vel[3 * i + 2];
  }
#pragma unroll
  for (int j = 0; j < kFwdCellsZ; ++j) {
    const int z = z_begin + j;
    if (z >= D) break;
    const float sz = backtrace(z, v[j][0], max_disp, D);
    const float sy = backtrace(y, v[j][1], max_disp, H);
    const float sx = backtrace(x, v[j][2], max_disp, W);
    // s lies in [0, n-1], so floor(s) is a valid index
    const int z0 = static_cast<int>(floorf(sz));
    const int y0 = static_cast<int>(floorf(sy));
    const int x0 = static_cast<int>(floorf(sx));
    float acc = 0.0f;
#pragma unroll
    for (int zc = z0; zc <= z0 + 1; ++zc) {
      const float wz = tent(sz - static_cast<float>(zc));
      const int zi = min(zc, D - 1);
#pragma unroll
      for (int yc = y0; yc <= y0 + 1; ++yc) {
        const float wzy = wz * tent(sy - static_cast<float>(yc));
        const float* row =
            field + static_cast<long long>(zi * H + min(yc, H - 1)) * W;
#pragma unroll
        for (int xc = x0; xc <= x0 + 1; ++xc) {
          acc += wzy * tent(sx - static_cast<float>(xc)) *
                 row[min(xc, W - 1)];
        }
      }
    }
    out[static_cast<long long>(z) * plane + p] = acc;
  }
}

struct Grad3 {
  float z, y, x;
};

// K3's 27 taps at a cell with backtrace s, before the factor g of the
// cell: sum_c d_a[prod tent](s - c) * f[c] for a = z, y, x, the taps in
// (z, y, x) order, each term ((a * b) * c) * f with its pair product
// a * b formed once per (tz, ty). ``tap(cz, cy, cx)`` reads f at a tap,
// or anything finite at a tap outside the grid: there the tap's weight
// and derivative along the axis it leaves by are taken as 0.
//
// Terms of weight +-0 are left out, which leaves each sum's bits as they
// were for finite f (a sum that starts at +0 never becomes -0, and +-0
// added to it changes nothing). The weight of the tap floor(s) - 1 is
// always exactly +0 (|u| >= 1 there); only its derivative can be
// nonzero (-0.5, at an integer s). So a term that multiplies that
// weight is skipped at compile time: each sum keeps 12 of its 27 terms,
// and the 7 taps with two axes at floor(s) - 1 are not read at all. A
// tap outside the grid adds +-0 terms in place of the ones the sum would
// skip, without a branch.
//
// s lies in [0, n - 1], so the three taps sit at u = s - c in [1, 2),
// [0, 1) (the tap floor(s), always in the grid) and [-1, 0) (u computed
// as the first version did; the rounding of s - c is monotone), where
// the tent and its derivative with JAX's conventions (pallas_advect.py
// _dtent) reduce to (+0, -0.5 at u == 1 else -0), (1 - u, -1) and
// (1 + u, 0.5 at u == -1 else 1).
template <class Tap>
__device__ __forceinline__ Grad3 push_vel_grad(const float s[3],
                                               const int n[3], Tap tap) {
  // Per axis: taps floor(s)-1 .. floor(s)+1, their tent weight and tent
  // derivative, both 0 at a tap outside the grid.
  int c[3];
  float w[3][3];
  float d[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = static_cast<int>(floorf(s[a])) - 1;
    const float u0 = s[a] - static_cast<float>(c[a]);
    const float u1 = s[a] - static_cast<float>(c[a] + 1);
    const float u2 = s[a] - static_cast<float>(c[a] + 2);
    const bool in0 = c[a] >= 0;
    const bool in2 = c[a] + 2 < n[a];
    w[a][0] = 0.0f;
    d[a][0] = in0 && u0 == 1.0f ? -0.5f : 0.0f;
    w[a][1] = 1.0f - u1;
    d[a][1] = -1.0f;
    w[a][2] = in2 ? 1.0f + u2 : 0.0f;
    d[a][2] = in2 ? (u2 == -1.0f ? 0.5f : 1.0f) : 0.0f;
  }
  float az = 0.0f, ay = 0.0f, ax = 0.0f;
#pragma unroll
  for (int tz = 0; tz < 3; ++tz) {
#pragma unroll
    for (int ty = 0; ty < 3; ++ty) {
      const float dw = d[0][tz] * w[1][ty];
      const float wd = w[0][tz] * d[1][ty];
      const float ww = w[0][tz] * w[1][ty];
#pragma unroll
      for (int tx = 0; tx < 3; ++tx) {
        // w[a][0] == +0: az needs ty, tx > 0; ay tz, tx > 0; ax tz, ty > 0
        if ((tz == 0) + (ty == 0) + (tx == 0) > 1) continue;
        const float f = tap(c[0] + tz, c[1] + ty, c[2] + tx);
        if (ty > 0 && tx > 0) az += dw * w[2][tx] * f;
        if (tz > 0 && tx > 0) ay += wd * w[2][tx] * f;
        if (tz > 0 && ty > 0) ax += ww * d[2][tx] * f;
      }
    }
  }
  return {az, ay, ax};
}

__device__ __forceinline__ void store_grad_s(float* __restrict__ grad_s,
                                             long long idx, Grad3 a,
                                             float gi) {
  grad_s[3 * idx + 0] = a.z * gi;
  grad_s[3 * idx + 1] = a.y * gi;
  grad_s[3 * idx + 2] = a.x * gi;
}

// K3's launch: blocks of kVelThreads threads along the (y, x) plane, each
// thread taking kVelCellsZ cells along z (PERF.md gives the launches
// tried).
constexpr int kVelThreads = 256;
constexpr int kVelCellsZ = 4;

// K3: a thread owns one (y, x) of the plane and kVelCellsZ cells along z
// at it, as K1's threads do, and loads the displacements and cotangents
// of all its cells before it gathers. Indices are 32-bit within a plane;
// the entry point refuses D * H or H * W past INT_MAX.
__global__ void __launch_bounds__(kVelThreads)
    advect_bwd_vel_kernel(const float* __restrict__ field,
                          const float* __restrict__ vel,
                          const float* __restrict__ g,
                          float* __restrict__ grad_s, int D, int H, int W,
                          float max_disp) {
  const int plane = H * W;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const long long frame = static_cast<long long>(blockIdx.z) * D * plane;
  field += frame;
  vel += 3 * frame;
  g += frame;
  grad_s += 3 * frame;
  const int y = p / W;
  const int x = p - y * W;
  const int z_begin = static_cast<int>(blockIdx.y) * kVelCellsZ;
  float v[kVelCellsZ][3];
  float gv[kVelCellsZ];
#pragma unroll
  for (int j = 0; j < kVelCellsZ; ++j) {
    // a cell past the last plane loads the last plane's and stores nothing
    const long long i =
        static_cast<long long>(min(z_begin + j, D - 1)) * plane + p;
    v[j][0] = vel[3 * i + 0];
    v[j][1] = vel[3 * i + 1];
    v[j][2] = vel[3 * i + 2];
    gv[j] = g[i];
  }
  // a tap outside the grid reads its clamped neighbour
  const int n[3] = {D, H, W};
  const auto tap = [=](int cz, int cy, int cx) {
    const int zc = min(max(cz, 0), D - 1);
    const int yc = min(max(cy, 0), H - 1);
    const int xc = min(max(cx, 0), W - 1);
    return field[static_cast<long long>(zc * H + yc) * W + xc];
  };
#pragma unroll
  for (int j = 0; j < kVelCellsZ; ++j) {
    const int z = z_begin + j;
    if (z >= D) break;
    const float s[3] = {backtrace(z, v[j][0], max_disp, D),
                        backtrace(y, v[j][1], max_disp, H),
                        backtrace(x, v[j][2], max_disp, W)};
    store_grad_s(grad_s, static_cast<long long>(z) * plane + p,
                 push_vel_grad(s, n, tap), gv[j]);
  }
}

// K2's untiled pull (on no path: the binned route below replaced it, and
// it stays as the oracle that route is held against bitwise): one thread per output cell (blockIdx.y its z, blockIdx.z its
// frame), its sources read and backtraced straight from device memory in
// ascending (iz, iy, ix), each adding ((w_z * w_y) * w_x) * g, as the
// tiled pull adds them: for finite g both give the same bits (the tiled
// pull's extra terms of weight 0 add +-0). A source whose z or y weight
// is 0 is skipped after its first load. Indices are 32-bit within a
// plane.
constexpr int kUntiledThreads = 256;

__global__ void __launch_bounds__(kUntiledThreads)
    advect_bwd_field_untiled_kernel(const float* __restrict__ vel,
                                    const float* __restrict__ g,
                                    float* __restrict__ grad_field, int D,
                                    int H, int W, float max_disp, int R) {
  const int plane = H * W;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const long long frame = static_cast<long long>(blockIdx.z) * D * plane;
  vel += 3 * frame;
  g += frame;
  grad_field += frame;
  const int y = p / W;
  const int x = p - y * W;
  const int z = static_cast<int>(blockIdx.y);
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const float fx = static_cast<float>(x);
  float acc = 0.0f;
  for (int iz = max(z - R, 0); iz <= min(z + R, D - 1); ++iz) {
    const float* vz = vel + 3 * static_cast<long long>(iz) * plane;
    const float* gz = g + static_cast<long long>(iz) * plane;
    for (int iy = max(y - R, 0); iy <= min(y + R, H - 1); ++iy) {
      for (int ix = max(x - R, 0); ix <= min(x + R, W - 1); ++ix) {
        const int k = iy * W + ix;
        const float* vk = vz + 3 * static_cast<long long>(k);
        const float wz = tent(backtrace(iz, vk[0], max_disp, D) - fz);
        if (wz == 0.0f) continue;
        const float wy = tent(backtrace(iy, vk[1], max_disp, H) - fy);
        if (wy == 0.0f) continue;
        const float wx = tent(backtrace(ix, vk[2], max_disp, W) - fx);
        acc += wz * wy * wx * gz[k];
      }
    }
  }
  grad_field[static_cast<long long>(z) * plane + p] = acc;
}

// K2's binned route, step 1: one thread per source cell (blockIdx.y its
// z, blockIdx.z its frame) backtraces it once and writes its record
// (s_z, s_y, s_x, g) and, as its key, the index over the batch of its
// floor cell. Indices over the batch are 32-bit: the entry point refuses
// a batch of INT_MAX cells or more.
constexpr int kBinThreads = 256;

__global__ void __launch_bounds__(kBinThreads)
    advect_bin_sources_kernel(const float* __restrict__ vel,
                              const float* __restrict__ g,
                              int* __restrict__ keys,
                              float4* __restrict__ rec, int D, int H, int W,
                              float max_disp) {
  const int plane = H * W;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const int y = p / W;
  const int x = p - y * W;
  const int z = static_cast<int>(blockIdx.y);
  const int frame = static_cast<int>(blockIdx.z) * D * plane;
  const int i = frame + z * plane + p;
  const float* v = vel + 3 * static_cast<long long>(i);
  const float sz = backtrace(z, v[0], max_disp, D);
  const float sy = backtrace(y, v[1], max_disp, H);
  const float sx = backtrace(x, v[2], max_disp, W);
  rec[i] = make_float4(sz, sy, sx, g[i]);
  // s lies in [0, n-1], so floor(s) is a cell of the grid
  keys[i] = frame + (static_cast<int>(floorf(sz)) * H +
                     static_cast<int>(floorf(sy))) * W +
            static_cast<int>(floorf(sx));
}

// K2's binned route, step 3: one thread per output cell j (blockIdx.y its
// z, blockIdx.z its frame). Its sources are the runs of the floor cells
// j - d, d in {0, 1}^3, in ``perm`` (the source indices sorted stably by
// key), run c from offsets[c] to offsets[c + 1]. Each run is in ascending
// source index; the thread merges its (at most) 8 runs, always taking the
// run whose next source has the least index, and adds each source as the
// pull adds it. The runs' heads live in registers: the loops over them are
// unrolled, and a run is advanced by a select, not an indexed store.
constexpr int kGatherThreads = 256;
constexpr int kRuns = 8;

__global__ void __launch_bounds__(kGatherThreads)
    advect_bwd_field_binned_kernel(const float4* __restrict__ rec,
                                   const long long* __restrict__ perm,
                                   const int* __restrict__ offsets,
                                   float* __restrict__ grad_field, int D,
                                   int H, int W) {
  const int plane = H * W;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= plane) return;
  const int y = p / W;
  const int x = p - y * W;
  const int z = static_cast<int>(blockIdx.y);
  const int frame = static_cast<int>(blockIdx.z) * D * plane;
  int pos[kRuns], end[kRuns], head[kRuns];
#pragma unroll
  for (int r = 0; r < kRuns; ++r) {
    const int cz = z - (r >> 2), cy = y - ((r >> 1) & 1), cx = x - (r & 1);
    pos[r] = end[r] = 0;
    if (cz >= 0 && cy >= 0 && cx >= 0) {
      const int c = frame + (cz * H + cy) * W + cx;
      pos[r] = offsets[c];
      end[r] = offsets[c + 1];
    }
    head[r] = pos[r] < end[r] ? static_cast<int>(perm[pos[r]]) : INT_MAX;
  }
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const float fx = static_cast<float>(x);
  float acc = 0.0f;
  while (true) {
    int least = head[0], run = 0;
#pragma unroll
    for (int r = 1; r < kRuns; ++r) {
      if (head[r] < least) {
        least = head[r];
        run = r;
      }
    }
    if (least == INT_MAX) break;
    const float4 q = rec[least];
    const float wzy = tent(q.x - fz) * tent(q.y - fy);
    acc += wzy * tent(q.z - fx) * q.w;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      if (r == run) {
        ++pos[r];
        head[r] = pos[r] < end[r] ? static_cast<int>(perm[pos[r]]) : INT_MAX;
      }
    }
  }
  grad_field[frame + z * plane + p] = acc;
}

// ---------------------------------------------------------------------
// K2 and K3b: a tile of output cells per block, sources staged in shared
// memory. blockDim is (TX / kCellsX, TY, TZ): one thread per kCellsX
// output cells that follow each other along x; blockIdx (x, y, z)
// numbers the tiles.
// ---------------------------------------------------------------------

// Output cells per thread along x. Neighbouring cells along x share all
// but one of their sources per row and, since prod_a tent is summed as
// ((w_z * w_y) * w_x) * g, the product w_z * w_y of every shared source.
// Odd, so that the 16-byte loads of 8 lanes kCellsX sources apart hit
// distinct banks of shared memory.
constexpr int kCellsX = 3;

// A box of staged cells: its first grid cell and its extent.
struct Box {
  int z0, y0, x0;
  int nz, ny, nx;
  __device__ int size() const { return nz * ny * nx; }
};

__device__ __forceinline__ int thread_rank() {
  return (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int block_threads() {
  return blockDim.x * blockDim.y * blockDim.z;
}

// This block's frame of the batch and its tile along z: blockIdx.z
// numbers the tiles of frame b as b * ceil(D / TZ) + tz.
struct BatchTile {
  int b, tz;
};

__device__ __forceinline__ BatchTile batch_tile(int D) {
  const int tiles_z = (D + static_cast<int>(blockDim.z) - 1) /
                      static_cast<int>(blockDim.z);
  const int bz = static_cast<int>(blockIdx.z);
  return {bz / tiles_z, bz % tiles_z};
}

// The tile of this block (tile ``tz`` along z) grown by ``halo`` cells on
// every side.
__device__ __forceinline__ Box tile_box(int halo, int tz) {
  const int tx = kCellsX * static_cast<int>(blockDim.x);
  return {tz * static_cast<int>(blockDim.z) - halo,
          static_cast<int>(blockIdx.y * blockDim.y) - halo,
          static_cast<int>(blockIdx.x) * tx - halo,
          static_cast<int>(blockDim.z) + 2 * halo,
          static_cast<int>(blockDim.y) + 2 * halo,
          tx + 2 * halo};
}

// visit(k, iz, iy, ix) for every cell k of ``box``, the block's threads
// taking k = rank, rank + threads, ...; the cell's coordinates are
// carried from one step to the next, not divided out of k each time.
template <class Visit>
__device__ __forceinline__ void for_box(Box box, Visit visit) {
  const int n = box.size();
  const int step = block_threads();
  const int k0 = thread_rank();
  const int sx = step % box.nx;
  const int sy = step / box.nx % box.ny;
  const int sz = step / box.nx / box.ny;
  int lx = k0 % box.nx;
  int ly = k0 / box.nx % box.ny;
  int lz = k0 / box.nx / box.ny;
  for (int k = k0; k < n; k += step) {
    visit(k, box.z0 + lz, box.y0 + ly, box.x0 + lx);
    lx += sx;
    ly += sy;
    lz += sz;
    if (lx >= box.nx) {
      lx -= box.nx;
      ++ly;
    }
    if (ly >= box.ny) {
      ly -= box.ny;
      ++lz;
    }
  }
}

// (s_z, s_y, s_x, g) of every source of ``box`` in ``st``, backtraced
// once; (kOutside, kOutside, kOutside, 0) for a source outside the grid.
__device__ __forceinline__ void stage_sources(const float* __restrict__ vel,
                                              const float* __restrict__ g,
                                              Box box, float4* st, int D,
                                              int H, int W, float max_disp) {
  for_box(box, [&](int k, int iz, int iy, int ix) {
    if (iz >= 0 && iz < D && iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const long long i = (static_cast<long long>(iz) * H + iy) * W + ix;
      st[k] = make_float4(backtrace(iz, vel[3 * i + 0], max_disp, D),
                          backtrace(iy, vel[3 * i + 1], max_disp, H),
                          backtrace(ix, vel[3 * i + 2], max_disp, W), g[i]);
    } else {
      st[k] = make_float4(kOutside, kOutside, kOutside, 0.0f);
    }
  });
}

// f over ``box``, 0 outside the grid.
__device__ __forceinline__ void stage_field(const float* __restrict__ field,
                                            Box box, float* s_f, int D,
                                            int H, int W) {
  for_box(box, [&](int k, int iz, int iy, int ix) {
    const bool in = iz >= 0 && iz < D && iy >= 0 && iy < H && ix >= 0 &&
                    ix < W;
    s_f[k] = in ? field[(static_cast<long long>(iz) * H + iy) * W + ix]
                : 0.0f;
  });
}

// Index in ``box`` of the cell at this thread's offset from the box's
// first cell: for the tile with its R-halo, the source
// (z - R, y - R, x - R) of this thread's first cell (z, y, x).
__device__ __forceinline__ int first_source(Box src) {
  return (threadIdx.z * src.ny + threadIdx.y) * src.nx +
         kCellsX * threadIdx.x;
}

// K2's pull at this thread's cells (z, y, x + c), c < kCellsX, from the
// staged sources of ``src`` (the tile with its R-halo): for each cell the
// (2R+1)^3 sources in ascending (iz, iy, ix), each weighted by
// prod_a tent(s_a[i] - j_a), with the arithmetic of the pull from device
// memory it replaces. That pull skipped a source at a zero z or y weight;
// here every source adds its term, a zero weight adding +-0, which leaves
// the sum's bits as they were for finite g (a sum that starts at +0 never
// becomes -0). Skipping does not pay: the lanes of a warp visit different
// sources, so some lane nearly always needs the rest of the source, and
// a branch would only add its own instructions. Each row of sources is
// read once for the thread's cells, and each source's w_z * w_y computed
// once.
__device__ __forceinline__ void pull_field_grad(const float4* st, Box src,
                                                int R, int z, int y, int x,
                                                float acc[kCellsX]) {
  const float fz = static_cast<float>(z);
  const float fy = static_cast<float>(y);
  const int span = 2 * R + 1;
  const int k0 = first_source(src);
#pragma unroll
  for (int c = 0; c < kCellsX; ++c) acc[c] = 0.0f;
  for (int dz = 0; dz < span; ++dz) {
    for (int dy = 0; dy < span; ++dy) {
      const int row = k0 + (dz * src.ny + dy) * src.nx;
      // source j of the row lies in the window of cells j - 2R .. j
      for (int j = 0; j < span + kCellsX - 1; ++j) {
        const float4 q = st[row + j];
        const float wzy = tent(q.x - fz) * tent(q.y - fy);
#pragma unroll
        for (int c = 0; c < kCellsX; ++c) {
          if (j < c || j >= c + span) continue;
          acc[c] += wzy * tent(q.z - static_cast<float>(x + c)) * q.w;
        }
      }
    }
  }
}

__global__ void advect_bwd_field_kernel(const float* __restrict__ vel,
                                        const float* __restrict__ g,
                                        float* __restrict__ grad_field,
                                        int D, int H, int W, float max_disp,
                                        int R) {
  extern __shared__ float4 st[];
  const BatchTile bt = batch_tile(D);
  const long long frame = static_cast<long long>(bt.b) * D * H * W;
  vel += 3 * frame;
  g += frame;
  grad_field += frame;
  const Box src = tile_box(R, bt.tz);
  stage_sources(vel, g, src, st, D, H, W, max_disp);
  __syncthreads();
  const int z = src.z0 + R + threadIdx.z;
  const int y = src.y0 + R + threadIdx.y;
  const int x = src.x0 + R + kCellsX * threadIdx.x;
  if (z >= D || y >= H || x >= W) return;
  float acc[kCellsX];
  pull_field_grad(st, src, R, z, y, x, acc);
  const long long row = (static_cast<long long>(z) * H + y) * W;
#pragma unroll
  for (int c = 0; c < kCellsX; ++c) {
    if (x + c < W) grad_field[row + x + c] = acc[c];
  }
}

// K3b: K2's grad_f and K3's grad_s of every cell of the tile, both from
// shared memory: the sources with their R-halo, f with an (R+1)-halo.
__global__ void advect_bwd_fused_kernel(const float* __restrict__ field,
                                        const float* __restrict__ vel,
                                        const float* __restrict__ g,
                                        float* __restrict__ grad_field,
                                        float* __restrict__ grad_s, int D,
                                        int H, int W, float max_disp,
                                        int R) {
  extern __shared__ float4 st[];
  const BatchTile bt = batch_tile(D);
  const long long frame = static_cast<long long>(bt.b) * D * H * W;
  field += frame;
  vel += 3 * frame;
  g += frame;
  grad_field += frame;
  grad_s += 3 * frame;
  const Box src = tile_box(R, bt.tz);
  const Box fb = tile_box(R + 1, bt.tz);
  float* s_f = reinterpret_cast<float*>(st + src.size());
  stage_sources(vel, g, src, st, D, H, W, max_disp);
  stage_field(field, fb, s_f, D, H, W);
  __syncthreads();
  const int z = src.z0 + R + threadIdx.z;
  const int y = src.y0 + R + threadIdx.y;
  const int x = src.x0 + R + kCellsX * threadIdx.x;
  if (z >= D || y >= H || x >= W) return;
  float acc[kCellsX];
  pull_field_grad(st, src, R, z, y, x, acc);
  const long long row = (static_cast<long long>(z) * H + y) * W;
  // the thread's own staged sources, and f at its first cell
  const int k = first_source(src) + (R * src.ny + R) * src.nx + R;
  const float* f0 =
      s_f + first_source(fb) + ((R + 1) * fb.ny + R + 1) * fb.nx + R + 1;
#pragma unroll
  for (int c = 0; c < kCellsX; ++c) {
    if (x + c >= W) break;
    grad_field[row + x + c] = acc[c];
    const float4 q = st[k + c];
    const float s[3] = {q.x, q.y, q.z};
    // every tap lies within R + 1 of the cell (|s - cell| <= max_disp <=
    // R), inside the staged f, which reads 0 outside the grid
    const int n[3] = {D, H, W};
    const Grad3 a = push_vel_grad(s, n, [=](int cz, int cy, int cx) {
      return f0[((cz - z) * fb.ny + cy - y) * fb.nx + cx - x];
    });
    store_grad_s(grad_s, row + x + c, a, q.w);
  }
}

// The 2D launches of K1, K3 and the untiled K2 index a plane and a
// column of planes with 32-bit integers.
bool fits_32_bit(int D, int H, int W) {
  return static_cast<long long>(H) * W <= INT_MAX &&
         static_cast<long long>(D) * H <= INT_MAX;
}

// The binned route numbers every cell of the batch, and one past the last
// (its offsets), with 32-bit integers.
bool fits_binned(int B, int D, int H, int W) {
  return static_cast<long long>(B) * D * H * W < INT_MAX;
}

// The most blocks a launch may have along grid.y and grid.z.
constexpr long long kMaxGridYZ = 65535;

// Dynamic shared memory a kernel may use without opting in, and the most
// a block may use on the H100.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;

// Launch geometry of K2 / K3b for a batch of B frames and a TZ x TY x TX
// tile of cells (TX a multiple of kCellsX) staging ``smem_bytes`` (the
// wrapper's tile plan); opts the kernel in to more than the default shared
// memory where the plan needs it. cudaSuccess, or cudaErrorInvalidValue
// when the tile, its shared memory or the grid is refused.
cudaError_t tile_launch(const void* kernel, int B, int D, int H, int W,
                        int R, int TZ, int TY, int TX, int smem_bytes,
                        dim3* grid, dim3* block) {
  if (R < 0 || TZ < 1 || TY < 1 || TX < 1 || TX % kCellsX != 0 ||
      TZ * TY * (TX / kCellsX) > 1024 || smem_bytes > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  const long long tiles_z = (D + TZ - 1) / TZ;
  const long long tiles_y = (H + TY - 1) / TY;
  if (static_cast<long long>(B) * tiles_z > kMaxGridYZ ||
      tiles_y > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  *block = dim3(TX / kCellsX, TY, TZ);
  *grid = dim3((W + TX - 1) / TX, static_cast<unsigned>(tiles_y),
               static_cast<unsigned>(B * tiles_z));
  if (smem_bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

// Grid of K1, K3 and the untiled and binned K2: ``threads``-thread
// blocks over the
// (y, x) plane, ``rows`` blocks along grid.y (runs of planes), the B
// frames along grid.z. False when a dimension is out of range.
bool plane_grid(int B, int H, int W, long long rows, int threads,
                dim3* grid) {
  if (B > kMaxGridYZ || rows > kMaxGridYZ) return false;
  *grid = dim3((H * W + threads - 1) / threads, static_cast<unsigned>(rows),
               static_cast<unsigned>(B));
  return true;
}

}  // namespace

// Plain C entry points, called by the operators of ops.cpp once they have
// checked the tensors. Each takes a batch of B frames of D x H x W cells
// (B = 1 for a single field), launches once on ``stream`` of CUDA device
// ``device`` (made current for the launch when it is not already), does
// not synchronise, and returns cudaGetLastError() (or the error that
// refused the launch). B = 0 launches nothing.
extern "C" {

int nfs_advect_fwd(const void* field, const void* vel, void* out, int B,
                   int D, int H, int W, float max_disp, int device,
                   void* stream) {
  dim3 grid;
  if (B < 0 || !fits_32_bit(D, H, W) ||
      !plane_grid(B, H, W, (D + kFwdCellsZ - 1) / kFwdCellsZ, kFwdThreads,
                  &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    advect_fwd_kernel<<<grid, kFwdThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const float*>(vel),
        static_cast<float*>(out), D, H, W, max_disp);
    return cudaGetLastError();
  });
}

// K2 with a TZ x TY x TX tile and ``smem_bytes`` of dynamic shared
// memory, at most 232 448 on the H100: 16 bytes per source of the tile
// with its R-halo.
int nfs_advect_bwd_field(const void* vel, const void* g, void* grad_field,
                         int B, int D, int H, int W, float max_disp, int R,
                         int TZ, int TY, int TX, int smem_bytes, int device,
                         void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    dim3 grid, block;
    const cudaError_t err = tile_launch(
        reinterpret_cast<const void*>(advect_bwd_field_kernel), B, D, H, W,
        R, TZ, TY, TX, smem_bytes, &grid, &block);
    if (err != cudaSuccess) return err;
    advect_bwd_field_kernel<<<grid, block, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vel), static_cast<const float*>(g),
        static_cast<float*>(grad_field), D, H, W, max_disp, R);
    return cudaGetLastError();
  });
}

// K2's untiled pull, one thread per cell (any R >= 0): on no path, the
// oracle the binned route is held against.
int nfs_advect_bwd_field_untiled(const void* vel, const void* g,
                                 void* grad_field, int B, int D, int H,
                                 int W, float max_disp, int R, int device,
                                 void* stream) {
  dim3 grid;
  if (B < 0 || R < 0 || !fits_32_bit(D, H, W) ||
      !plane_grid(B, H, W, D, kUntiledThreads, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    advect_bwd_field_untiled_kernel<<<grid, kUntiledThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vel), static_cast<const float*>(g),
        static_cast<float*>(grad_field), D, H, W, max_disp, R);
    return cudaGetLastError();
  });
}

// K2's binned route, step 1: ``keys`` (int32) and ``rec`` (float4) of
// every source cell of the batch.
int nfs_advect_bin_sources(const void* vel, const void* g, void* keys,
                           void* rec, int B, int D, int H, int W,
                           float max_disp, int device, void* stream) {
  dim3 grid;
  if (B < 0 || !fits_binned(B, D, H, W) ||
      !plane_grid(B, H, W, D, kBinThreads, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    advect_bin_sources_kernel<<<grid, kBinThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vel), static_cast<const float*>(g),
        static_cast<int*>(keys), static_cast<float4*>(rec), D, H, W,
        max_disp);
    return cudaGetLastError();
  });
}

// K2's binned route, step 3, from step 1's ``rec``, the source indices
// ``perm`` (int64) sorted stably by key and the runs' ``offsets`` (int32,
// B * D * H * W + 1 of them). The kernel trusts perm and offsets to be
// what the wrapper's sort makes of step 1's keys.
int nfs_advect_bwd_field_binned(const void* rec, const void* perm,
                                const void* offsets, void* grad_field,
                                int B, int D, int H, int W, int device,
                                void* stream) {
  dim3 grid;
  if (B < 0 || !fits_binned(B, D, H, W) ||
      !plane_grid(B, H, W, D, kGatherThreads, &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    advect_bwd_field_binned_kernel<<<grid, kGatherThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rec),
        static_cast<const long long*>(perm),
        static_cast<const int*>(offsets), static_cast<float*>(grad_field), D,
        H, W);
    return cudaGetLastError();
  });
}

int nfs_advect_bwd_vel(const void* field, const void* vel, const void* g,
                       void* grad_s, int B, int D, int H, int W,
                       float max_disp, int device, void* stream) {
  dim3 grid;
  if (B < 0 || !fits_32_bit(D, H, W) ||
      !plane_grid(B, H, W, (D + kVelCellsZ - 1) / kVelCellsZ, kVelThreads,
                  &grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    advect_bwd_vel_kernel<<<grid, kVelThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const float*>(vel),
        static_cast<const float*>(g), static_cast<float*>(grad_s), D, H, W,
        max_disp);
    return cudaGetLastError();
  });
}

// K3b with a TZ x TY x TX tile; ``smem_bytes`` K2's and 4 bytes per cell
// of f over the tile with an (R+1)-halo.
int nfs_advect_bwd_fused(const void* field, const void* vel, const void* g,
                         void* grad_field, void* grad_s, int B, int D, int H,
                         int W, float max_disp, int R, int TZ, int TY,
                         int TX, int smem_bytes, int device, void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    dim3 grid, block;
    const cudaError_t err = tile_launch(
        reinterpret_cast<const void*>(advect_bwd_fused_kernel), B, D, H, W,
        R, TZ, TY, TX, smem_bytes, &grid, &block);
    if (err != cudaSuccess) return err;
    advect_bwd_fused_kernel<<<grid, block, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const float*>(vel),
        static_cast<const float*>(g), static_cast<float*>(grad_field),
        static_cast<float*>(grad_s), D, H, W, max_disp, R);
    return cudaGetLastError();
  });
}

}  // extern "C"
