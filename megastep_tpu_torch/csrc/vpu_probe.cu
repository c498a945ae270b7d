// f32 multiply-issue probe (K2): two interleaved dependent multiply chains per
// element, summed.
//
// Replaces: perf/roofline.py:85, the inner `kernel` of measure_vpu, the JAX
// package's Pallas TPU probe of its vector unit's f32 op rate. Per element y:
//   a = y * 1.0000001f, b = y * 0.9999999f, then chain/2 - 1 further
//   a = a * 1.0000001f, b = b * 0.9999999f, and out = a + b,
// the JAX body's sequence (roofline.py:86-95). Plain version:
// megastep_tpu_torch/perf/roofline.py::vpu_chain_plain, which it equals bit for
// bit: every step is one correctly rounded f32 multiply or add.
//
// What bounds it on an H100: f32 instruction issue. At the JAX default shape
// (64, 8, 256, 512), chain 256, one launch does 17.18 G multiplies against
// 537 MB of traffic (each element read once, written once), so it is bound by
// operations: 0.256 ms at the published 67 TFLOP/s. That rate counts a fused
// multiply-add as two operations, and these are plain FMULs (no add to fuse
// with, and the library is built with -fmad=false), one per lane per clock:
// 132 SMs x 128 lanes x 1.98 GHz, about 33.5 T multiplies/s, so at most half of
// the published figure: about 0.51 ms a launch at best. chip_smoke.py measured
// 0.5686 ms a launch (30.2 T multiplies/s, 90% of that ceiling) on an NVIDIA
// H100 80GB HBM3 at a 700.00 W power limit. The gap to the published bound is
// the probe's design, not a fault to tune away.
//
// What the design does about it: keeps the FP32 pipes fed and nothing else.
// One thread per float4 (16-byte coalesced loads and stores) over a
// grid-stride loop with one wave of resident blocks, so each thread carries
// eight independent chains, enough to hide the multiply latency with every
// warp scheduler busy; `#pragma unroll` on the runtime-length chain loop makes
// its counter and branch a small share of the issued instructions. Nothing may fold the chain: f32 multiplication is
// not reassociated without fast math, and -fmad=false keeps the last multiply
// and the add apart. Elements past the last whole float4, and arrays not
// 16-byte aligned, take a scalar path of the same arithmetic.

#include <cuda_runtime.h>

namespace {

constexpr float kUp = 1.0000001f;
constexpr float kDown = 0.9999999f;
constexpr int kThreads = 256;

__global__ void vpu_chain_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, long long n,
                                 long long n4, int half) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = first; i < n4; i += stride) {
    const float4 y = x4[i];
    float a0 = y.x * kUp, b0 = y.x * kDown;
    float a1 = y.y * kUp, b1 = y.y * kDown;
    float a2 = y.z * kUp, b2 = y.z * kDown;
    float a3 = y.w * kUp, b3 = y.w * kDown;
#pragma unroll 16
    for (int k = 1; k < half; ++k) {
      a0 = a0 * kUp;
      b0 = b0 * kDown;
      a1 = a1 * kUp;
      b1 = b1 * kDown;
      a2 = a2 * kUp;
      b2 = b2 * kDown;
      a3 = a3 * kUp;
      b3 = b3 * kDown;
    }
    out4[i] = make_float4(a0 + b0, a1 + b1, a2 + b2, a3 + b3);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float a = x[i] * kUp, b = x[i] * kDown;
#pragma unroll 16
    for (int k = 1; k < half; ++k) {
      a = a * kUp;
      b = b * kDown;
    }
    out[i] = a + b;
  }
}

}  // namespace

// Launches the probe on `stream` without synchronising: out[i] is element i's
// two chains of chain / 2 multiplies, summed. Returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int vpu_chain(const void* x, void* out, long long n, int chain,
                         void* stream) {
  if (n <= 0) return 0;
  const bool aligned =
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) % 16 == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long work = n4 + (n - 4 * n4);
  // One wave of resident blocks: every block then strides over the same share.
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vpu_chain_kernel,
                                                kThreads, 0);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  vpu_chain_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, n4, chain / 2);
  return static_cast<int>(cudaGetLastError());
}
