// Fused detect-stage filters: Sobel5x5 (du, dv as u8) and, optionally,
// blob5x5 + checkerboard5x5 (i16), in one pass over a u8 image.
//
// Replaces sfm_tpu/ops/pallas_kernels.py::detect_filters_pallas
// (_detect_filters_kernel / _sobel_only_kernel). The TPU kernel holds the
// whole image in fast memory and builds the filters from ~20 rolled adds;
// here a block loads a 32x8 tile plus a 2-pixel halo into shared memory and
// every thread evaluates its pixel's 5x5 neighbourhood from there. Borders
// wrap around exactly like torch.roll / jnp.roll, so the result is bit-equal
// to ops/filters.py on every pixel, not only inside the margin. All
// arithmetic is int32 (exact); the u8 pack is (acc >> 7) + 128 saturated.
//
// Bound on the H100: bytes (1 B read + 2 or 6 B written per pixel); the
// arithmetic (~60 integer ops per pixel) is two orders of magnitude below
// the card's rate. A tiled kernel has no image-size limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 2;
constexpr int SW = TX + 2 * R;
constexpr int SH = TY + 2 * R;

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ uint8_t pack_u8(int acc) {
  int v = (acc >> 7) + 128;  // arithmetic shift = floor division
  return (uint8_t)min(max(v, 0), 255);
}

template <bool FULL>
__global__ void detect_filters_kernel(const uint8_t* __restrict__ img, int H,
                                      int W, uint8_t* __restrict__ du,
                                      uint8_t* __restrict__ dv,
                                      int16_t* __restrict__ blob,
                                      int16_t* __restrict__ chk) {
  __shared__ int tile[SH][SW + 1];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  for (int i = threadIdx.y * TX + threadIdx.x; i < SH * SW; i += TX * TY) {
    const int ty = i / SW;
    const int tx = i - ty * SW;
    const int gy = wrap(y0 + ty - R, H);
    const int gx = wrap(x0 + tx - R, W);
    tile[ty][tx] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  // per-column vertical passes over the 5 rows centred on this pixel
  int sm[5], dr[5], s5[5], s3[5], ck[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int a = tile[threadIdx.y + 0][threadIdx.x + c];
    const int b = tile[threadIdx.y + 1][threadIdx.x + c];
    const int m = tile[threadIdx.y + 2][threadIdx.x + c];
    const int d = tile[threadIdx.y + 3][threadIdx.x + c];
    const int e = tile[threadIdx.y + 4][threadIdx.x + c];
    sm[c] = a + 4 * b + 6 * m + 4 * d + e;   // taps 1 4 6 4 1
    dr[c] = a + 2 * b - 2 * d - e;           // taps 1 2 0 -2 -1
    if (FULL) {
      s5[c] = a + b + m + d + e;
      s3[c] = b + m + d;
      ck[c] = a + b - d - e;                 // taps 1 1 0 -1 -1
    }
  }
  const size_t o = (size_t)y * W + x;
  du[o] = pack_u8(sm[0] + 2 * sm[1] - 2 * sm[3] - sm[4]);
  dv[o] = pack_u8(dr[0] + 4 * dr[1] + 6 * dr[2] + 4 * dr[3] + dr[4]);
  if (FULL) {
    const int centre = tile[threadIdx.y + 2][threadIdx.x + 2];
    const int box5 = s5[0] + s5[1] + s5[2] + s5[3] + s5[4];
    const int box3 = s3[1] + s3[2] + s3[3];
    blob[o] = (int16_t)(-box5 + 2 * box3 + 7 * centre);
    chk[o] = (int16_t)(ck[0] + ck[1] - ck[3] - ck[4]);
  }
}

}  // namespace

// img [H, W] u8 -> du, dv [H, W] u8 and, when `full`, blob, chk [H, W] i16.
// Returns cudaGetLastError() of the launch.
extern "C" int sfm_detect_filters(const void* img, int H, int W, int full,
                                  void* du, void* dv, void* blob, void* chk,
                                  void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  cudaStream_t s = (cudaStream_t)stream;
  if (full) {
    detect_filters_kernel<true><<<grid, block, 0, s>>>(
        (const uint8_t*)img, H, W, (uint8_t*)du, (uint8_t*)dv, (int16_t*)blob,
        (int16_t*)chk);
  } else {
    detect_filters_kernel<false><<<grid, block, 0, s>>>(
        (const uint8_t*)img, H, W, (uint8_t*)du, (uint8_t*)dv, nullptr,
        nullptr);
  }
  return (int)cudaGetLastError();
}
