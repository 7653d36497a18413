// Per-match 16x16 windows of the two gradient images, as f32.
//
// Replaces sfm_tpu/ops/pallas_kernels.py::extract_patches_pallas
// (_patch_kernel). The TPU kernel loads an aligned 24x256 slab per match and
// selects the window with two one-hot matmuls, because that machine cannot
// load at an unaligned offset. A GPU can: this is a plain indexed copy, one
// 256-thread block per match, one pixel of each channel per thread, u8 -> f32.
// Kept from the TPU kernel's contract: the top-left (v0, u0) is clipped into
// the image, reads past (H, W) give zeros, and every row at or past `count`
// is written as zeros (exactly the rows >= count, not whole blocks).
//
// Bound on the H100: bytes, almost all of them the f32 output
// (2 * M * 256 * 4 B written against 2 * M * 256 B read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 16;

__global__ void extract_patches_kernel(
    const uint8_t* __restrict__ du, const uint8_t* __restrict__ dv, int H,
    int W, const int* __restrict__ u0, const int* __restrict__ v0,
    const int* __restrict__ count, int M, float* __restrict__ pdu,
    float* __restrict__ pdv) {
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const int cnt = count ? min(*count, M) : M;
  const size_t o = (size_t)m * (PATCH * PATCH) + t;
  float a = 0.0f, b = 0.0f;
  if (m < cnt) {
    const int uc = min(max(u0[m], 0), W - 1);
    const int vc = min(max(v0[m], 0), H - 1);
    const int y = vc + (t >> 4);
    const int x = uc + (t & 15);
    if (y < H && x < W) {
      const size_t i = (size_t)y * W + x;
      a = (float)du[i];
      b = (float)dv[i];
    }
  }
  pdu[o] = a;
  pdv[o] = b;
}

}  // namespace

// du, dv [H, W] u8; u0, v0 [M] i32; count: device i32 or null (= M).
// Writes pdu, pdv [M, 16, 16] f32. Returns cudaGetLastError() of the launch.
extern "C" int sfm_extract_patches(const void* du, const void* dv, int H,
                                   int W, const void* u0, const void* v0,
                                   const void* count, int M, void* pdu,
                                   void* pdv, void* stream) {
  if (M > 0) {
    extract_patches_kernel<<<M, PATCH * PATCH, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)du, (const uint8_t*)dv, H, W, (const int*)u0,
        (const int*)v0, (const int*)count, M, (float*)pdu, (float*)pdv);
  }
  return (int)cudaGetLastError();
}
