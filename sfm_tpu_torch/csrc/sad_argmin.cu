// Masked descriptor-SAD argmin: for every source row, the candidate with the
// lowest cost among those that are valid, of the same class and inside the
// row's [u, v] search window.
//
// Replaces sfm_tpu/ops/pallas_kernels.py::sad_argmin_pallas (_sad_kernel).
// The TPU kernel walks [TM, TN] cost tiles over a sequential grid dimension
// and keeps the running minimum in its output block; here that dimension is
// a loop inside the block. One warp owns one source row: its lanes stride
// over the candidates, test the cheap mask first (the analog of the
// reference's bin-restricted scan, matcher.cpp:931-940) and compute the
// 32-element SAD only for candidates that pass. Each lane keeps its own
// first minimum (candidates ascend, strict <), then the warp reduces on the
// pair (cost, index) so that equal costs resolve to the LOWEST candidate
// index whatever the reduction order.
//
// Exactness: descriptor values are u8-valued floats, so the SAD (<= 8160) is
// an exact integer sum in f32 in any order. The prior term 4*sqrt(du^2+dv^2)
// decides near-ties, so it is built from round-to-nearest intrinsics in the
// operation order of ops/matching.py::sad_argmin_pass (no fused multiply-add).
//
// Bound on the H100: operations. The inputs are ~1 MB at the dense shape;
// the mask tests are N1*N2 and the SADs one per surviving pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MIN_COST_INIT = 10000000.0f;  // matcher.cpp:899
constexpr int WARPS = 4;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void sad_argmin_kernel(
    const float* __restrict__ d1, const int* __restrict__ c1,
    const float* __restrict__ u_min, const float* __restrict__ u_max,
    const float* __restrict__ v_min, const float* __restrict__ v_max,
    const float* __restrict__ t_u, const float* __restrict__ t_v,
    const uint8_t* __restrict__ valid1, const int* __restrict__ count1,
    const float* __restrict__ d2, const float* __restrict__ u2,
    const float* __restrict__ v2, const int* __restrict__ c2,
    const uint8_t* __restrict__ valid2, const int* __restrict__ count2,
    int N1, int N2, int* __restrict__ idx_out, float* __restrict__ cost_out) {
  __shared__ float s_d1[WARPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= N1) return;  // warp-uniform: only warp-level sync below

  const int n1 = count1 ? min(max(*count1, 0), N1) : N1;
  const int n2 = count2 ? min(max(*count2, 0), N2) : N2;
  const bool live = row < n1 && (valid1 == nullptr || valid1[row] != 0);
  if (!live) {  // rows past the valid prefix keep the no-match result
    if (lane == 0) {
      idx_out[row] = 0;
      cost_out[row] = MIN_COST_INIT;
    }
    return;
  }

  s_d1[warp][lane] = d1[(size_t)row * 32 + lane];
  __syncwarp();

  const int cls = c1[row];
  const float umn = u_min[row], umx = u_max[row];
  const float vmn = v_min[row], vmx = v_max[row];
  const float tu = t_u[row], tv = t_v[row];
  const bool use_t = (tu >= 0.0f) && (tv >= 0.0f);

  float best = MIN_COST_INIT;
  int best_j = 0;
  for (int j = lane; j < n2; j += 32) {
    if (valid2[j] == 0 || c2[j] != cls) continue;
    const float uu = u2[j], vv = v2[j];
    if (!(uu >= umn && uu <= umx && vv >= vmn && vv <= vmx)) continue;
    const float4* p = reinterpret_cast<const float4*>(d2 + (size_t)j * 32);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 q = p[k];
      acc += fabsf(s_d1[warp][4 * k + 0] - q.x);
      acc += fabsf(s_d1[warp][4 * k + 1] - q.y);
      acc += fabsf(s_d1[warp][4 * k + 2] - q.z);
      acc += fabsf(s_d1[warp][4 * k + 3] - q.w);
    }
    if (use_t) {
      const float dx = __fsub_rn(uu, tu);
      const float dy = __fsub_rn(vv, tv);
      const float dist =
          __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      acc = __fadd_rn(acc, __fmul_rn(4.0f, dist));
    }
    if (acc < best) {  // strict: the lane keeps its first minimum
      best = acc;
      best_j = j;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL_MASK, best, o);
    const int oj = __shfl_xor_sync(FULL_MASK, best_j, o);
    if (oc < best || (oc == best && oj < best_j)) {
      best = oc;
      best_j = oj;
    }
  }
  if (lane == 0) {
    idx_out[row] = best < MIN_COST_INIT ? best_j : 0;
    cost_out[row] = best;
  }
}

}  // namespace

// d1 [N1,32] f32, row vectors [N1], d2 [N2,32] f32 (16-byte aligned),
// candidate vectors [N2]; valid1 / count1 / count2 may be null. Writes
// idx [N1] i32 and cost [N1] f32. Returns cudaGetLastError() of the launch.
extern "C" int sfm_sad_argmin(
    const void* d1, const void* c1, const void* u_min, const void* u_max,
    const void* v_min, const void* v_max, const void* t_u, const void* t_v,
    const void* valid1, const void* count1, const void* d2, const void* u2,
    const void* v2, const void* c2, const void* valid2, const void* count2,
    int N1, int N2, void* idx_out, void* cost_out, void* stream) {
  if (N1 > 0) {
    dim3 block(32 * WARPS);
    dim3 grid((N1 + WARPS - 1) / WARPS);
    sad_argmin_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)d1, (const int*)c1, (const float*)u_min,
        (const float*)u_max, (const float*)v_min, (const float*)v_max,
        (const float*)t_u, (const float*)t_v, (const uint8_t*)valid1,
        (const int*)count1, (const float*)d2, (const float*)u2,
        (const float*)v2, (const int*)c2, (const uint8_t*)valid2,
        (const int*)count2, N1, N2, (int*)idx_out, (float*)cost_out);
  }
  return (int)cudaGetLastError();
}
