// An alternative launch of the advection forward K1, kept to be measured
// against the one nfs_tpu_torch/csrc/advect.cu ships (tools/kernel_ab.py
// kernels): a thread owns kCellsX = 4 neighbouring cells along x of one
// (z, y) row and loads their channel-last displacements as three float4
// (12 floats) where the row allows it (W a multiple of 4 and vel 16-byte
// aligned: then every group of 4 starts on a 48-byte boundary), and
// stores its 4 results as one float4 there. Elsewhere, and in a ragged
// tail, it loads and stores floats. Each cell's arithmetic is the shipped
// K1's, so the bits are the same.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk1_cells_x.so tools/k1_cells_x.cu

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../nfs_tpu_torch/csrc/launch.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCellsX = 4;

__device__ __forceinline__ float tent(float u) {
  return fmaxf(0.0f, 1.0f - fabsf(u));
}

__device__ __forceinline__ float backtrace(int i, float v, float max_disp,
                                           int n) {
  const float disp = fminf(fmaxf(v, -max_disp), max_disp);
  return fminf(fmaxf(static_cast<float>(i) - disp, 0.0f),
               static_cast<float>(n - 1));
}

// The shipped K1's sum for one cell at (z, y, x) with displacement v.
__device__ __forceinline__ float cell(const float* __restrict__ field,
                                      int z, int y, int x, const float* v,
                                      int D, int H, int W, float max_disp) {
  const float sz = backtrace(z, v[0], max_disp, D);
  const float sy = backtrace(y, v[1], max_disp, H);
  const float sx = backtrace(x, v[2], max_disp, W);
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
  return acc;
}

// blockIdx.y is z; the threads of a block run over (y, group of kCellsX
// cells along x) of that plane.
__global__ void advect_fwd_cells_x_kernel(const float* __restrict__ field,
                                          const float* __restrict__ vel,
                                          float* __restrict__ out, int D,
                                          int H, int W, float max_disp,
                                          bool vector) {
  const int groups = (W + kCellsX - 1) / kCellsX;
  const int p = static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (p >= H * groups) return;
  const int y = p / groups;
  const int x_begin = (p - y * groups) * kCellsX;
  const int z = static_cast<int>(blockIdx.y);
  const long long i0 = (static_cast<long long>(z) * H + y) * W + x_begin;
  float v[kCellsX * 3];
  const bool whole = vector && x_begin + kCellsX <= W;
  if (whole) {
    const float4* v4 = reinterpret_cast<const float4*>(vel + 3 * i0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 t = v4[q];
      v[4 * q + 0] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCellsX; ++j) {
      const long long i = i0 + min(j, W - 1 - x_begin);
      v[3 * j + 0] = vel[3 * i + 0];
      v[3 * j + 1] = vel[3 * i + 1];
      v[3 * j + 2] = vel[3 * i + 2];
    }
  }
  float r[kCellsX];
#pragma unroll
  for (int j = 0; j < kCellsX; ++j) {
    r[j] = cell(field, z, y, min(x_begin + j, W - 1), v + 3 * j, D, H, W,
                max_disp);
  }
  if (whole) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(r[0], r[1], r[2],
                                                       r[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCellsX; ++j) {
      if (x_begin + j < W) out[i0 + j] = r[j];
    }
  }
}

}  // namespace

// nfs_advect_fwd's interface (advect.cu).
extern "C" int nfs_advect_fwd_cells_x(const void* field, const void* vel,
                                      void* out, int D, int H, int W,
                                      float max_disp, int device,
                                      void* stream) {
  const long long groups = (W + kCellsX - 1) / kCellsX;
  if (groups * H > INT_MAX || D > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vector =
      W % kCellsX == 0 &&
      (reinterpret_cast<std::uintptr_t>(vel) % 16) == 0 &&
      (reinterpret_cast<std::uintptr_t>(out) % 16) == 0;
  return nfs::on_device(device, [&] {
    const dim3 grid(
        static_cast<unsigned>((groups * H + kThreads - 1) / kThreads), D);
    advect_fwd_cells_x_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const float*>(vel),
        static_cast<float*>(out), D, H, W, max_disp, vector);
    return cudaGetLastError();
  });
}
