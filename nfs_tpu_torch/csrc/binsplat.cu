// Binned quadratic-B-spline particle-to-grid splat (the LNST hot path) and
// its adjoint, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of nfs_tpu/ops/pallas_binsplat.py:
//   K4 binsplat_fwd_kernel <- _fwd_kernel (forward splat)
//   K5 binsplat_bwd_kernel <- _bwd_kernel (grads wrt attribute, positions)
// and holds the five-channel pair of LNST's colour pass, K4c
// binsplat_color_fwd_kernel and K5c binsplat_color_bwd_kernel, which
// replace no TPU kernel (their notes are at their code, below K5).
//
// Inputs are four (K, Z, Y, X) f32 C-contiguous bin arrays over the PADDED
// grid (Z, Y, X), or a keyframe batch of them, (B, K, Z, Y, X) with a
// (B, Z, Y, X) splat: the masked attribute a (0 in empty slots) and the raw
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
//   K5 gathers, as the TPU kernel does: each slot (k, b) evaluates 3
//   weights and 3 derivatives per axis once and reads the 27 cotangents
//   g[b + off] (g is one (Z, Y, X) grid, small enough to stay in L2). Its
//   first version ran all 27 taps into four sums in every slot, with
//   64-bit index arithmetic, at 29% of its least time (PERF.md). Yet a
//   slot whose frac lies outside (-1.5, 3.5) along some axis has all three
//   weights and derivatives 0 there: every term of its sums is +-0, so
//   (for finite g) its sums are exactly +0, whatever its positions (empty
//   and parked slots may hold any). ~93% of the slots are so at the
//   particles_3d finest octave. So a warp takes a run of consecutive
//   slots, streams their a and positions with coalesced loads, writes the
//   dead slots' results at once, and lists the live ones in shared memory;
//   then its lanes take the live slots 32 at a time, each computing one
//   slot's sums in the first version's order and arithmetic. It stays
//   deterministic (no atomics), its 32-bit indices come from a division
//   by multiplication, and the eight bin arrays' bytes bound it.
//   A keyframe batch is one launch of each kernel: the keyframe is a free
//   grid dimension (K4 folds it into blockIdx.z, K5 takes blockIdx.y), and
//   a block moves its pointers to its keyframe's arrays before anything
//   else, so every keyframe's arithmetic is that of a single launch, bit
//   for bit. The TPU engine runs its batch as B sequential kernel calls.

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
// tried); blockIdx.z runs over the keyframes, z_blocks blocks each. No shared memory and no barrier, so the SM keeps as many warps
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
                        int X, int z_blocks) {
  const int lane = static_cast<int>(threadIdx.x);
  const int x = static_cast<int>(blockIdx.x) * kLanesX - 2 + lane;
  const int y = static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y);
  const int kf = static_cast<int>(blockIdx.z) / z_blocks;
  const int z0 = (static_cast<int>(blockIdx.z) - kf * z_blocks) * kCellsZ;
  if (y >= Y) return;  // the whole warp: all its lanes share y
  const bool column = x >= 0 && x < X;
  const long long cells = static_cast<long long>(Z) * Y * X;
  const long long bins = K * cells;  // one keyframe's slots
  a += kf * bins;
  pz += kf * bins;
  py += kf * bins;
  px += kf * bins;
  out += kf * cells;
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

// ---------------------------------------------------------------------
// K5: a warp takes a run of kBwdRun consecutive slots of the flat slot
// index (k, z, y, x) of keyframe blockIdx.y; kBwdWarps warps a block.
// ---------------------------------------------------------------------

constexpr int kBwdWarps = 8;
constexpr int kBwdSlotsPerLane = 4;
constexpr int kBwdRun = 32 * kBwdSlotsPerLane;

// Division of a dividend below 2^31 by a divisor fixed at launch, as a
// multiplication (round-up method): n / d == umulhi(n, mul) >> shr, and
// mul == 0 stands for d == 1. K5 runs 1% faster with it than with plain
// unsigned / and % at the finest octave, 9% at the coarsest (PERF.md).
struct FastDiv {
  unsigned int d, mul, shr;
};

FastDiv fast_div(unsigned int d) {
  if (d == 1) return {1u, 0u, 0u};
  unsigned int l = 0;  // ceil(log2(d))
  while ((1ull << l) < d) ++l;
  const unsigned long long m = ((1ull << (31 + l)) + d - 1) / d;
  return {d, static_cast<unsigned int>(m), l - 1};
}

__device__ __forceinline__ unsigned int div_by(FastDiv f, unsigned int n) {
  return f.mul == 0u ? n : __umulhi(n, f.mul) >> f.shr;
}

// The slots' grid: divisions by Z * Y * X (one rank), X and Y.
struct SlotGrid {
  FastDiv cells, x, y;
  int Z, Y, X, n_slots;
};

// The bin (bz, by, bx) of slot i.
__device__ __forceinline__ void bin_of(const SlotGrid& sg, int i, int* bz,
                                       int* by, int* bx) {
  const unsigned int u = static_cast<unsigned int>(i);
  const unsigned int b = u - div_by(sg.cells, u) * sg.cells.d;
  const unsigned int q = div_by(sg.x, b);
  const unsigned int z = div_by(sg.y, q);
  *bx = static_cast<int>(b - q * sg.x.d);
  *by = static_cast<int>(q - z * sg.y.d);
  *bz = static_cast<int>(z);
}

// A slot is live when its frac lies in (-1.5, 3.5) along every axis; a
// NaN frac is dead, as its weights are 0.
__device__ __forceinline__ bool live_frac(float f) {
  return f > -1.5f && f < 3.5f;
}

// The four sums of live slot i, in the order and arithmetic of the
// one-thread-per-slot version this replaces: taps (oz, oy, ox) ascending,
// each term ((a * b) * c) * g, its pair product a * b formed once per
// (oz, oy). A tap beyond the grid reads g at a clamped address with its
// weight and derivative along the axis it leaves by taken as 0: its +-0
// terms leave each sum's bits as a loop that skips it would, for finite
// g (a sum that starts at +0 never becomes -0).
__device__ __forceinline__ void bwd_slot(
    const SlotGrid& sg, int i, const float* __restrict__ a,
    const float* __restrict__ pz, const float* __restrict__ py,
    const float* __restrict__ px, const float* __restrict__ g,
    float* __restrict__ da, float* __restrict__ dpz,
    float* __restrict__ dpy, float* __restrict__ dpx) {
  int bz, by, bx;
  bin_of(sg, i, &bz, &by, &bx);
  const float fz = pz[i] + kPad - static_cast<float>(bz);
  const float fy = py[i] + kPad - static_cast<float>(by);
  const float fx = px[i] + kPad - static_cast<float>(bx);
  float wz[3], wy[3], wx[3], dz[3], dy[3], dx[3];
  int rz[3], cy[3], cx[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float of = static_cast<float>(o);
    const bool in_z = bz + o < sg.Z;
    const bool in_y = by + o < sg.Y;
    const bool in_x = bx + o < sg.X;
    wz[o] = in_z ? w1d(of - fz) : 0.0f;
    wy[o] = in_y ? w1d(of - fy) : 0.0f;
    wx[o] = in_x ? w1d(of - fx) : 0.0f;
    // du/dp = -1
    dz[o] = in_z ? -dw1d(of - fz) : 0.0f;
    dy[o] = in_y ? -dw1d(of - fy) : 0.0f;
    dx[o] = in_x ? -dw1d(of - fx) : 0.0f;
    rz[o] = min(bz + o, sg.Z - 1) * sg.Y;
    cy[o] = min(by + o, sg.Y - 1);
    cx[o] = min(bx + o, sg.X - 1);
  }
  float sa = 0.0f, sz = 0.0f, sy = 0.0f, sx = 0.0f;
#pragma unroll
  for (int oz = 0; oz < 3; ++oz) {
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const float ww = wz[oz] * wy[oy];
      const float dw = dz[oz] * wy[oy];
      const float wd = wz[oz] * dy[oy];
      const float* grow = g + (rz[oz] + cy[oy]) * sg.X;
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        const float gv = grow[cx[ox]];
        sa += ww * wx[ox] * gv;
        sz += dw * wx[ox] * gv;
        sy += wd * wx[ox] * gv;
        sx += ww * dx[ox] * gv;
      }
    }
  }
  const float av = a[i];
  da[i] = sa;
  dpz[i] = sz * av;
  dpy[i] = sy * av;
  dpx[i] = sx * av;
}

// K5. Each lane loads a and the positions of kBwdSlotsPerLane slots of the
// warp's run (slot run + lane + 32 j, coalesced), all before it uses them;
// a dead slot gets da = +0 and dp_d = (+0) * a (the first version's sums
// of +-0 terms, -0 where a < 0) at once, and a live one goes on the
// warp's list by ballot. The warp's lanes then take the listed slots in
// turn, so a warp with a few live lanes per row does not pay 32 lanes'
// taps for each row. Every slot's result is computed by one thread.
__global__ void __launch_bounds__(32 * kBwdWarps)
    binsplat_bwd_kernel(const float* __restrict__ a,
                        const float* __restrict__ pz,
                        const float* __restrict__ py,
                        const float* __restrict__ px,
                        const float* __restrict__ g, float* __restrict__ da,
                        float* __restrict__ dpz, float* __restrict__ dpy,
                        float* __restrict__ dpx, SlotGrid sg) {
  __shared__ int live[kBwdWarps][kBwdRun];
  // this block's keyframe: its bins, its gradients and its cotangent
  const long long bins = static_cast<long long>(blockIdx.y) * sg.n_slots;
  a += bins;
  pz += bins;
  py += bins;
  px += bins;
  da += bins;
  dpz += bins;
  dpy += bins;
  dpx += bins;
  g += static_cast<long long>(blockIdx.y) * sg.cells.d;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int run =
      (static_cast<int>(blockIdx.x) * kBwdWarps + warp) * kBwdRun;
  float av[kBwdSlotsPerLane], qz[kBwdSlotsPerLane], qy[kBwdSlotsPerLane],
      qx[kBwdSlotsPerLane];
#pragma unroll
  for (int j = 0; j < kBwdSlotsPerLane; ++j) {
    // a lane past the last slot loads the last slot and stores nothing
    const int i = min(run + lane + 32 * j, sg.n_slots - 1);
    av[j] = a[i];
    qz[j] = pz[i];
    qy[j] = py[i];
    qx[j] = px[i];
  }
  int* list = live[warp];
  int n_live = 0;
#pragma unroll
  for (int j = 0; j < kBwdSlotsPerLane; ++j) {
    const int i = run + lane + 32 * j;
    bool is_live = false;
    if (i < sg.n_slots) {
      int bz, by, bx;
      bin_of(sg, i, &bz, &by, &bx);
      is_live = live_frac(qz[j] + kPad - static_cast<float>(bz)) &&
                live_frac(qy[j] + kPad - static_cast<float>(by)) &&
                live_frac(qx[j] + kPad - static_cast<float>(bx));
      if (!is_live) {
        da[i] = 0.0f;
        dpz[i] = 0.0f * av[j];
        dpy[i] = 0.0f * av[j];
        dpx[i] = 0.0f * av[j];
      }
    }
    const unsigned int ballot = __ballot_sync(kFullWarp, is_live);
    if (is_live) list[n_live + __popc(ballot & ((1u << lane) - 1u))] = i;
    n_live += __popc(ballot);
  }
  __syncwarp();
  for (int e = lane; e < n_live; e += 32) {
    bwd_slot(sg, list[e], a, pz, py, px, g, da, dpz, dpy, dpx);
  }
}

// ---------------------------------------------------------------------
// K4c and K5c: LNST's colour pass, the window of K4/K5 over the five
// channels [density, colour clipped to [0, 1] (3), ones] of the binned
// particles, and its adjoint. They replace no TPU kernel: the JAX package
// runs this pass as XLA's generic multi-channel window
// (nfs_tpu/ops/binsplat.py splat_binned), its Pallas kernels taking one
// channel only; the port ran the same generic pass, 27 taps of PyTorch
// operations each way over K x padded cells, whose saved tap weights grew
// with K (PERF.md).
//
// They read the binned arrays as the styler holds them, slot-minor with S
// slots a keyframe: positions p (3, S), densities dens (S), raw colours
// color (3, S), and the dense slots' valid bytes (n_slots), n_slots =
// K * Zp * Yp * Xp <= S (the slots past n_slots park particles and take
// no part). The splat is written on the UNPADDED grid (Z, Y, X) = (Zp,
// Yp, Xp) - 2 PAD, channel last, (Z, Y, X, 5): the crop of the padded
// splat. A slot that is not valid is never read beyond its valid byte, so
// it may hold any position or attribute, and gets +0 in all seven
// gradients; so do the parking slots.
//   K4c is K4 with five channels: the lane reads its slot's valid byte,
//   skips a row of slots that is empty across the warp, reads a valid
//   slot's 7 floats once, computes its weights once a row and hands the
//   weight products and the five attributes to the two lanes beside it by
//   shuffle; one set of weights serves all five sums. Like K4 it is bound
//   by the valid bytes' load latency and the instructions of the rows it
//   does not skip.
//   K5c is K5 with the valid byte as its test of life: a warp's run of
//   slots writes the not-valid ones' zeros at once and lists the valid
//   ones, whose lanes then read their 7 floats and the 27 taps' five
//   cotangents (channel last: 20 bytes a tap, in L2) and sum the density
//   and colour gradients W * g_c and the position gradients
//   (dW/dp) * (dens g0 + colour . g1..3 + g4), the five channels'
//   attributes folded into one cotangent a tap. Writing its 7 gradient
//   arrays over all S slots bounds it (28 S bytes: ~158 MB, ~47 us at
//   K = 8 on the finest octave of particles_3d).
//   Neither uses atomics: two launches give the same bits. A keyframe
//   batch is one launch, a keyframe a free grid dimension, as K4/K5.
// ---------------------------------------------------------------------

constexpr int kColorChannels = 5;
constexpr int kPadCells = 2;  // PAD as an integer

// jnp.clip(c, 0, 1)
__device__ __forceinline__ float clip01(float c) {
  return fminf(fmaxf(c, 0.0f), 1.0f);
}

// jnp.clip's subgradient: 1 strictly inside, 0.5 at a bound, 0 outside
// (advect_kernels.py _clip_grad).
__device__ __forceinline__ float clip01_grad(float c) {
  if (c > 0.0f && c < 1.0f) return 1.0f;
  return (c == 0.0f || c == 1.0f) ? 0.5f : 0.0f;
}

// K4c: K4's launch (a warp a row of kLanesX cells along x, a lane a
// column of kCellsZ cells along z, kRows warps a block, blockIdx.z the
// keyframes) over the unpadded grid's cells; the five sums of a cell in
// K4's order (rank k, then oz, oy, ox ascending). A row of slots with no
// valid slot in the warp adds only +0 terms and is skipped.
__global__ void __launch_bounds__(32 * kRows)
    binsplat_color_fwd_kernel(const float* __restrict__ p,
                              const float* __restrict__ dens,
                              const float* __restrict__ color,
                              const unsigned char* __restrict__ valid,
                              float* __restrict__ out, int K, int Z, int Y,
                              int X, int S, int z_blocks) {
  const int Zp = Z + 2 * kPadCells, Yp = Y + 2 * kPadCells,
            Xp = X + 2 * kPadCells;
  const int lane = static_cast<int>(threadIdx.x);
  // padded coordinates of this lane's column and this warp's row
  const int x = kPadCells + static_cast<int>(blockIdx.x) * kLanesX - 2 + lane;
  const int y = kPadCells + static_cast<int>(blockIdx.y * blockDim.y +
                                             threadIdx.y);
  const int kf = static_cast<int>(blockIdx.z) / z_blocks;
  const int z0 =
      kPadCells + (static_cast<int>(blockIdx.z) - kf * z_blocks) * kCellsZ;
  if (y >= kPadCells + Y) return;  // the whole warp
  const bool column = x < Xp;
  const int cells = Zp * Yp * Xp;
  p += 3LL * S * kf;
  dens += static_cast<long long>(S) * kf;
  color += 3LL * S * kf;
  valid += static_cast<long long>(K) * cells * kf;
  out += static_cast<long long>(kColorChannels) * Z * Y * X * kf;
  float acc[kCellsZ][kColorChannels];
#pragma unroll
  for (int j = 0; j < kCellsZ; ++j) {
#pragma unroll
    for (int c = 0; c < kColorChannels; ++c) acc[j][c] = 0.0f;
  }
  for (int k = 0; k < K; ++k) {
    const int rank = k * cells;
#pragma unroll
    for (int t = kCellsZ + 1; t >= 0; --t) {
      const int bz = z0 - 2 + t;
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        const int by = y - oy;
        const bool in = column && bz < Zp;
        const int i = rank + (in ? (bz * Yp + by) * Xp + x : 0);
        const bool live = in && valid[i] != 0;
        if (!__any_sync(kFullWarp, live)) continue;
        float av[kColorChannels] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float wx[3] = {0.0f, 0.0f, 0.0f};
        float wzy[3] = {0.0f, 0.0f, 0.0f};
        if (live) {
          const float fz = p[i] + kPad - static_cast<float>(bz);
          const float fy = p[S + i] + kPad - static_cast<float>(by);
          const float fx = p[2 * S + i] + kPad - static_cast<float>(x);
          av[0] = dens[i];
          av[1] = clip01(color[i]);
          av[2] = clip01(color[S + i]);
          av[3] = clip01(color[2 * S + i]);
          av[4] = 1.0f;
          const float wy = w1d(static_cast<float>(oy) - fy);
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            wx[o] = w1d(static_cast<float>(o) - fx);
            if (t - 2 + o >= 0 && t - 2 + o < kCellsZ) {
              wzy[o] = w1d(static_cast<float>(o) - fz) * wy;
            }
          }
        }
        float a1[kColorChannels], a2[kColorChannels];
#pragma unroll
        for (int c = 0; c < kColorChannels; ++c) {
          a1[c] = __shfl_up_sync(kFullWarp, av[c], 1);
          a2[c] = __shfl_up_sync(kFullWarp, av[c], 2);
        }
#pragma unroll
        for (int oz = 0; oz < 3; ++oz) {
          const int j = t - 2 + oz;
          if (j < 0 || j >= kCellsZ) continue;
          const float w0 = wzy[oz] * wx[0];
          const float w1 = __shfl_up_sync(kFullWarp, wzy[oz] * wx[1], 1);
          const float w2 = __shfl_up_sync(kFullWarp, wzy[oz] * wx[2], 2);
#pragma unroll
          for (int c = 0; c < kColorChannels; ++c) {
            acc[j][c] += w0 * av[c];
            acc[j][c] += w1 * a1[c];
            acc[j][c] += w2 * a2[c];
          }
        }
      }
    }
  }
  if (lane < 2 || x >= kPadCells + X) return;
  const int row = (y - kPadCells) * X + (x - kPadCells);
#pragma unroll
  for (int j = 0; j < kCellsZ; ++j) {
    const int z = z0 + j - kPadCells;
    if (z < Z) {
      float* cell = out + (static_cast<long long>(z) * Y * X + row) *
                              kColorChannels;
#pragma unroll
      for (int c = 0; c < kColorChannels; ++c) cell[c] = acc[j][c];
    }
  }
}

// The slot space of K5c: divisions by Zp * Yp * Xp (one rank), Xp and Yp,
// the unpadded grid, the dense slots and all slots of a keyframe.
struct ColorSlots {
  FastDiv cells, x, y;
  int Z, Y, X, n_slots, S;
};

// The seven gradients of valid slot i: taps (oz, oy, ox) ascending, a
// tap's weight ((w_z * w_y) * w_x) and its derivatives formed as K5's. A
// tap on a cell of the PAD ring or beyond takes no cotangent (the crop):
// it reads a clamped address with its weight and derivative along the
// axis it leaves by taken as 0, which leaves each sum's bits as a loop
// that skips it would, for finite cotangents.
__device__ __forceinline__ void color_bwd_slot(
    const ColorSlots& cs, int i, const float* __restrict__ p,
    const float* __restrict__ dens, const float* __restrict__ color,
    const float* __restrict__ g, float* __restrict__ dp,
    float* __restrict__ ddens, float* __restrict__ dcolor) {
  const unsigned int u = static_cast<unsigned int>(i);
  const unsigned int b = u - div_by(cs.cells, u) * cs.cells.d;
  const unsigned int q = div_by(cs.x, b);
  const unsigned int zq = div_by(cs.y, q);
  const int bx = static_cast<int>(b - q * cs.x.d);
  const int by = static_cast<int>(q - zq * cs.y.d);
  const int bz = static_cast<int>(zq);
  const int S = cs.S;
  const float fz = p[i] + kPad - static_cast<float>(bz);
  const float fy = p[S + i] + kPad - static_cast<float>(by);
  const float fx = p[2 * S + i] + kPad - static_cast<float>(bx);
  float wz[3], wy[3], wx[3], dz[3], dy[3], dx[3];
  int rz[3], cy[3], cx[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float of = static_cast<float>(o);
    // the tap's cell on the unpadded grid
    const int uz = bz + o - kPadCells, uy = by + o - kPadCells,
              ux = bx + o - kPadCells;
    const bool in_z = uz >= 0 && uz < cs.Z;
    const bool in_y = uy >= 0 && uy < cs.Y;
    const bool in_x = ux >= 0 && ux < cs.X;
    wz[o] = in_z ? w1d(of - fz) : 0.0f;
    wy[o] = in_y ? w1d(of - fy) : 0.0f;
    wx[o] = in_x ? w1d(of - fx) : 0.0f;
    // du/dp = -1
    dz[o] = in_z ? -dw1d(of - fz) : 0.0f;
    dy[o] = in_y ? -dw1d(of - fy) : 0.0f;
    dx[o] = in_x ? -dw1d(of - fx) : 0.0f;
    rz[o] = min(max(uz, 0), cs.Z - 1) * cs.Y;
    cy[o] = min(max(uy, 0), cs.Y - 1);
    cx[o] = min(max(ux, 0), cs.X - 1) * kColorChannels;
  }
  const float d0 = dens[i];
  const float c0 = color[i], c1 = color[S + i], c2 = color[2 * S + i];
  const float a1 = clip01(c0), a2 = clip01(c1), a3 = clip01(c2);
  float sd = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  float sz = 0.0f, sy = 0.0f, sx = 0.0f;
#pragma unroll
  for (int oz = 0; oz < 3; ++oz) {
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const float ww = wz[oz] * wy[oy];
      const float dw = dz[oz] * wy[oy];
      const float wd = wz[oz] * dy[oy];
      const float* grow = g + (rz[oz] + cy[oy]) * cs.X * kColorChannels;
#pragma unroll
      for (int ox = 0; ox < 3; ++ox) {
        const float* gc = grow + cx[ox];
        const float g0 = gc[0], g1 = gc[1], g2 = gc[2], g3 = gc[3],
                    g4 = gc[4];
        const float w = ww * wx[ox];
        sd += w * g0;
        s1 += w * g1;
        s2 += w * g2;
        s3 += w * g3;
        // the cotangent of this tap's weight: the five channels'
        // attributes times their cotangents
        const float h = d0 * g0 + a1 * g1 + a2 * g2 + a3 * g3 + g4;
        sz += dw * wx[ox] * h;
        sy += wd * wx[ox] * h;
        sx += ww * dx[ox] * h;
      }
    }
  }
  dp[i] = sz;
  dp[S + i] = sy;
  dp[2 * S + i] = sx;
  ddens[i] = sd;
  dcolor[i] = clip01_grad(c0) * s1;
  dcolor[S + i] = clip01_grad(c1) * s2;
  dcolor[2 * S + i] = clip01_grad(c2) * s3;
}

// K5c: K5's runs of kBwdRun consecutive slots a warp, over all S slots of
// keyframe blockIdx.y. Each lane loads the valid bytes of its
// kBwdSlotsPerLane slots first; a slot that is not valid, or parks (past
// n_slots), gets +0 in its seven gradients at once, a valid one goes on the
// warp's list, and the warp's lanes then take the listed slots in turn.
__global__ void __launch_bounds__(32 * kBwdWarps)
    binsplat_color_bwd_kernel(const float* __restrict__ p,
                              const float* __restrict__ dens,
                              const float* __restrict__ color,
                              const unsigned char* __restrict__ valid,
                              const float* __restrict__ g,
                              float* __restrict__ dp,
                              float* __restrict__ ddens,
                              float* __restrict__ dcolor, ColorSlots cs) {
  __shared__ int live[kBwdWarps][kBwdRun];
  const long long kf = blockIdx.y;
  const int S = cs.S;
  p += 3LL * S * kf;
  dens += S * kf;
  color += 3LL * S * kf;
  dp += 3LL * S * kf;
  ddens += S * kf;
  dcolor += 3LL * S * kf;
  valid += cs.n_slots * kf;
  g += static_cast<long long>(kColorChannels) * cs.Z * cs.Y * cs.X * kf;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int run =
      (static_cast<int>(blockIdx.x) * kBwdWarps + warp) * kBwdRun;
  bool is_valid[kBwdSlotsPerLane];
#pragma unroll
  for (int j = 0; j < kBwdSlotsPerLane; ++j) {
    const int i = run + lane + 32 * j;
    is_valid[j] = i < cs.n_slots && valid[i] != 0;
  }
  int* list = live[warp];
  int n_live = 0;
#pragma unroll
  for (int j = 0; j < kBwdSlotsPerLane; ++j) {
    const int i = run + lane + 32 * j;
    if (i < S && !is_valid[j]) {
      dp[i] = 0.0f;
      dp[S + i] = 0.0f;
      dp[2 * S + i] = 0.0f;
      ddens[i] = 0.0f;
      dcolor[i] = 0.0f;
      dcolor[S + i] = 0.0f;
      dcolor[2 * S + i] = 0.0f;
    }
    const unsigned int ballot = __ballot_sync(kFullWarp, is_valid[j]);
    if (is_valid[j]) list[n_live + __popc(ballot & ((1u << lane) - 1u))] = i;
    n_live += __popc(ballot);
  }
  __syncwarp();
  for (int e = lane; e < n_live; e += 32) {
    color_bwd_slot(cs, list[e], p, dens, color, g, dp, ddens, dcolor);
  }
}

// Whether K4c/K5c take a batch of B keyframes of S slots over the
// unpadded grid (Z, Y, X) with K ranks: the dense slots fit in S, the
// slot arrays' offsets within a keyframe (3 S, less a K5c block's slots)
// and the splat's (5 Z Y X) in 32 bits, and the batch in the grid's
// 65 535 blocks along z (K4c) and y (K5c).
bool color_args_ok(int B, int K, int S, int Z, int Y, int X) {
  constexpr long long kBlockSlots = kBwdWarps * kBwdRun;
  if (B < 0 || K < 1 || Z < 1 || Y < 1 || X < 1 || S < 0) return false;
  const long long n_slots = static_cast<long long>(K) *
                            (Z + 2 * kPadCells) * (Y + 2 * kPadCells) *
                            (X + 2 * kPadCells);
  const long long z_blocks = (Z + kCellsZ - 1) / kCellsZ;
  return n_slots <= S && 3LL * S <= INT_MAX - kBlockSlots &&
         static_cast<long long>(kColorChannels) * Z * Y * X <= INT_MAX &&
         B * z_blocks <= 65535;
}

}  // namespace

// Plain C entry points, called by the operators of ops.cpp once they have
// checked the tensors. Each takes B keyframes of bins (B = 1 for one),
// launches once on ``stream`` of CUDA device ``device`` (made current for
// the launch when it is not already), does not synchronise, and returns
// cudaGetLastError() (or the error that refused the launch).
extern "C" {

// K4; refuses Z * Y past INT_MAX (32-bit plane rows), and a negative
// batch or one past the grid's 65 535 blocks along z.
int nfs_binsplat_fwd(const void* a, const void* pz, const void* py,
                     const void* px, void* out, int B, int K, int Z, int Y,
                     int X, int device, void* stream) {
  const long long z_blocks = (Z + kCellsZ - 1) / kCellsZ;
  if (static_cast<long long>(Z) * Y > INT_MAX || B < 0 ||
      B * z_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  return nfs::on_device(device, [&] {
    const dim3 grid((X + kLanesX - 1) / kLanesX, (Y + kRows - 1) / kRows,
                    static_cast<unsigned int>(B * z_blocks));
    binsplat_fwd_kernel<<<grid, dim3(32, kRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(pz),
        static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<float*>(out), K, Z, Y, X,
        static_cast<int>(z_blocks));
    return cudaGetLastError();
  });
}

// K5; refuses K * Z * Y * X past INT_MAX less a block's slots (32-bit
// slot indices within a keyframe), and a negative batch or one past the
// grid's 65 535 blocks along y.
int nfs_binsplat_bwd(const void* a, const void* pz, const void* py,
                     const void* px, const void* g, void* da, void* dpz,
                     void* dpy, void* dpx, int B, int K, int Z, int Y, int X,
                     int device, void* stream) {
  constexpr long long kBlockSlots = kBwdWarps * kBwdRun;
  const long long slots = static_cast<long long>(K) * Z * Y * X;
  if (slots > INT_MAX - kBlockSlots || B < 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (slots == 0 || B == 0) return static_cast<int>(cudaSuccess);
  const SlotGrid sg = {fast_div(static_cast<unsigned int>(Z * Y * X)),
                       fast_div(static_cast<unsigned int>(X)),
                       fast_div(static_cast<unsigned int>(Y)),
                       Z, Y, X, static_cast<int>(slots)};
  return nfs::on_device(device, [&] {
    const dim3 blocks(
        static_cast<unsigned int>((slots + kBlockSlots - 1) / kBlockSlots),
        static_cast<unsigned int>(B));
    binsplat_bwd_kernel<<<blocks, 32 * kBwdWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(pz),
        static_cast<const float*>(py), static_cast<const float*>(px),
        static_cast<const float*>(g), static_cast<float*>(da),
        static_cast<float*>(dpz), static_cast<float*>(dpy),
        static_cast<float*>(dpx), sg);
    return cudaGetLastError();
  });
}

// K4c: the (Z, Y, X, 5) splats of B keyframes' colour bins (binsplat.cu
// K4c above) on the unpadded grid (Z, Y, X); refuses what
// color_args_ok refuses.
int nfs_binsplat_color_fwd(const void* p, const void* dens, const void* color,
                           const void* valid, void* out, int B, int K, int S,
                           int Z, int Y, int X, int device, void* stream) {
  if (!color_args_ok(B, K, S, Z, Y, X)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int z_blocks = (Z + kCellsZ - 1) / kCellsZ;
  return nfs::on_device(device, [&] {
    const dim3 grid((X + kLanesX - 1) / kLanesX, (Y + kRows - 1) / kRows,
                    static_cast<unsigned int>(B * z_blocks));
    binsplat_color_fwd_kernel<<<grid, dim3(32, kRows), 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(dens),
        static_cast<const float*>(color),
        static_cast<const unsigned char*>(valid), static_cast<float*>(out),
        K, Z, Y, X, S, z_blocks);
    return cudaGetLastError();
  });
}

// K5c: the gradients (dp (3, S), ddens (S), dcolor (3, S) a keyframe)
// given the splats' cotangent g (Z, Y, X, 5 a keyframe); refuses what
// color_args_ok refuses.
int nfs_binsplat_color_bwd(const void* p, const void* dens, const void* color,
                           const void* valid, const void* g, void* dp,
                           void* ddens, void* dcolor, int B, int K, int S,
                           int Z, int Y, int X, int device, void* stream) {
  if (!color_args_ok(B, K, S, Z, Y, X)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || S == 0) return static_cast<int>(cudaSuccess);
  constexpr int kBlockSlots = kBwdWarps * kBwdRun;
  const int Zp = Z + 2 * kPadCells, Yp = Y + 2 * kPadCells,
            Xp = X + 2 * kPadCells;
  const ColorSlots cs = {fast_div(static_cast<unsigned int>(Zp * Yp * Xp)),
                         fast_div(static_cast<unsigned int>(Xp)),
                         fast_div(static_cast<unsigned int>(Yp)),
                         Z, Y, X, K * Zp * Yp * Xp, S};
  return nfs::on_device(device, [&] {
    const dim3 blocks(
        static_cast<unsigned int>((S + kBlockSlots - 1) / kBlockSlots),
        static_cast<unsigned int>(B));
    binsplat_color_bwd_kernel<<<blocks, 32 * kBwdWarps, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), static_cast<const float*>(dens),
        static_cast<const float*>(color),
        static_cast<const unsigned char*>(valid),
        static_cast<const float*>(g), static_cast<float*>(dp),
        static_cast<float*>(ddens), static_cast<float*>(dcolor), cs);
    return cudaGetLastError();
  });
}

}  // extern "C"
