// Fused observe: raycast + shade (+ seen-texel mask), one CUDA kernel per step.
//
// Replaces: megastep_tpu/ops/fused.py::_observe_kernel, the JAX package's
// Pallas TPU kernel (launched at fused.py:605), in all of its modes:
//   K1a, Explorer: want_seen on, skip_dyn = n_dynamic, a static texel table.
//   K1b, Deathmatch's table patch: baked_dyn (N, T_dyn) holds this frame's
//     re-baked intensity of the first T_dyn texels (the agent models). A tap
//     at texel k < T_dyn takes its intensity from baked_dyn[n, k] instead of
//     the table's baked channel; its colour still comes from the table.
//   K1c, draw_model = M: the A*M head slots of the static lines hold the
//     unrotated model; slot i is drawn while it is staged, by agent i / M's
//     pose, with render.place's ops in its order: c = cosf, s = sinf of
//     (float)(pi/180) * angle, endpoints (c*x - s*y) + px and (s*x + c*y) + py,
//     the direction as the difference of the drawn endpoints. So it equals the
//     launch on torch-drawn lines bit for bit.
//   K1d, fast_div: recip = 1/uxv (an IEEE divide), s = s_num*recip,
//     t = t_num*recip, as fused.py:307-313, in place of two IEEE divides.
// want_seen off passes a null seen pointer. fast_div is a template
// parameter; the other modes are uniform branches.
// Plain version: megastep_tpu_torch/ops/fused.py::observe_plain.
//
// What it computes, per (env, agent, ray): the ray direction from the pose;
// the ray/segment intersection (s, t) against every live line slot, valid
// where |u x v| >= 1e-3, 0 <= t <= 1 and near < s; the nearest valid s, s_min,
// then the LOWEST slot whose valid s < fl(s_min + Z_TOLERANCE) (the JAX
// reduction, fused.py:326-334 and render.py:139-143); the winner's Lambert
// factor 1 - dot^2; the two-tap texture filter of tex_filter over a packed
// (N, T, 4) [r, g, b, baked] table; and, for a hit ray when the mask is asked
// for, a 1 stored into a per-env byte mask at the texel the ray sees (stores
// are idempotent, so no atomics; misses mark nothing).
//
// Numerics: every value the result depends on is the plain version's, op for
// op, in f32: pqx = ax - px, pqy = ay - py, s_num = pqx*vy - pqy*vx,
// uxv = vy*rux - vx*ruy, t_num = pqx*ruy - pqy*rux, the IEEE divides
// s_num/uxv and t_num/uxv, rlen = sqrt(rux^2 + ruy^2), near = radius/rlen,
// uy = hsw*((res - 2r - 1)/res). The library is built with -fmad=false and
// without --use_fast_math (megastep_tpu_torch/kernels.py), so no multiply-add
// is contracted. The divide-free rejections below only skip tests whose
// outcome is certain; every test they cannot decide takes the same divides.
//
// Design (one block per (env, agent); each thread carries kRays = 2 rays, so
// a block has R / 2 threads: 128 for Explorer, 256 for Deathmatch):
// 1. Staging. Every live slot's hot record, pqx, pqy, vx, vy as one float4
//    and s_num as one float, goes to shared memory once per block (it depends
//    on the line and the agent, not on the ray); the texel start and width go
//    to a cold array that only the winner reads. A test is then one 16-byte
//    and one 4-byte broadcast load, shared by the thread's kRays rays.
// 2. One pass over the slots keeps the running minimum m of the valid s and
//    a 64-bit candidate mask: bit i is set when slot i is valid and
//    s_i < fl(m + tol), with m already lowered by s_i. Rounding to nearest
//    is monotone and m only falls to s_min, so for every eligible slot
//    s_i < fl(s_min + tol) <= fl(m_i + tol): the mask is a superset of the
//    eligible set. After the pass the mask's bits are visited in ascending
//    order; each slot's s is recomputed with the same operations (the same
//    bits) and the first with s < fl(s_min + tol) wins: the JAX tie-break,
//    without a second pass over the lines. Slots past the 64th have no bit:
//    if no masked slot wins, a linear pass over them finds the first
//    eligible one with the same tests.
// 3. Rejection without a divide, only where the outcome is certain. With
//    a = |uxv|, the quotients are x/uxv = (x with uxv's sign flipped)/a
//    exactly (round to nearest is symmetric), so let sn, tn be s_num, t_num
//    with uxv's sign bit xored in:
//    - the parallel test a >= 1e-3 is the plain one, first;
//    - sn <= 0 (either zero, or the opposite sign): s = RN(sn/a) <= 0, and
//      near = radius/rlen >= 0 (the wrapper rejects a negative radius), so
//      near < s fails. Exact.
//    - t < 0 only where tn < -(a * 2^-100): a * 2^-100 is exact (a >= 1e-3,
//      a power-of-two scale stays normal), so tn/a < -2^-100 and
//      t <= -2^-100 < 0, with fast_div as well (t_num * RN(1/uxv) is within
//      2^-21 relative of tn/a even where RN(1/uxv) is subnormal, for any
//      finite uxv). A negative t_num of smaller size may round to -0.0,
//      which passes 0 <= t, so it goes to the divide; so do t_num = +-0.
//    - t > 1 only where tn > RN(a * c), c = 1 + 2^-18: RN(a * c) >=
//      a*c*(1 - 2^-24), so tn/a > (1 + 2^-18)(1 - 2^-24) > 1 + 2^-24, and
//      every real quotient above 1 + 2^-24 rounds above 1. With fast_div,
//      t_num * RN(1/uxv) >= (tn/a)(1 - 2^-21) > (1 + 2^-18)(1 - 2^-24)
//      (1 - 2^-21) > 1 + 2^-24 as well. If a * c overflows, nothing is
//      rejected.
//    Everything in doubt divides exactly as the plain version does, so the
//    decision is the plain version's. On the cells' reset states about 6%
//    (Deathmatch) and 13% (Explorer) of the tests are in doubt, and 8% and
//    18% of the (warp of 32 adjacent rays, slot) pairs have any lane in
//    doubt: adjacent rays agree, so the divides rarely cost a warp more than
//    its lanes need. The thread's rays share one branch into the divides.
//
// What bounds it on an H100 (chip_smoke.py computes bound_ms from each run's
// inputs with megastep_tpu_torch/perf/roofline.py::bound):
//  Explorer (N = 16,384 envs, A = 1, R = 256 rays, 48 padded line slots of
//  which 8 are skipped, ~13.4 live; T = 2,304 texels): ~266 MB moved (slots,
//  poses, two 16-B texel taps per hit ray, 20 B of outputs per ray, the
//  zero-filled seen mask), ~0.079 ms at 3.35 TB/s; 5.6e7 ray-line tests.
//  Deathmatch (N = 4,096 scenes, A = 4, R = 512, L = 64, ~45.4 live;
//  T = 2,432, T_dyn = 64): ~442 MB, ~0.132 ms; 3.8e8 tests.
//  The slot loop's straight path, the one a slot takes when every test is
//  rejected without a divide, is 74 SASS instructions for two slots of two
//  rays, 18.5 per test (chip_smoke.py prints it): 14 are the test (6 for
//  uxv and t_num, 2 threshold multiplies, 2 sign xors, 4 compares), the rest
//  the shared loads, the branch and the loop. At one instruction per lane
//  per clock (132 SMs x 128 lanes x 1.98 GHz) that is ~0.03 ms for Explorer,
//  under its bytes, and ~0.21 ms for Deathmatch, above them: so bytes bound
//  Explorer and instruction issue Deathmatch; the divides in doubt, the
//  per-ray setup and the shading come on top.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kParallelEps = 1e-3f;
constexpr float kZTolerance = 1e-4f;
constexpr float kDegToRad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr float kTLo = 0x1p-100f;      // t < 0 is certain below -|uxv| * kTLo
constexpr float kTHi = 1.f + 0x1p-18f;  // t > 1 is certain above |uxv| * kTHi
constexpr int kMaskSlots = 64;
constexpr int kRays = 2;  // rays a thread carries through the slot loop

struct Ray {
  float rux, ruy, rlen, near;
};

// The two cross products of one slot (h = pqx, pqy, vx, vy) and one ray.
__device__ __forceinline__ void crosses(const float4 h, const Ray& ray,
                                        float& uxv, float& t_num) {
  uxv = h.w * ray.rux - h.z * ray.ruy;
  t_num = h.x * ray.ruy - h.y * ray.rux;
}

// Whether a test is in doubt: false only where it certainly fails (see the
// header, design item 3).
__device__ __forceinline__ bool in_doubt(float uxv, float t_num, float s_num) {
  const float a = fabsf(uxv);
  const unsigned sign = __float_as_uint(uxv) & 0x80000000u;
  const float sn = __uint_as_float(__float_as_uint(s_num) ^ sign);
  const float tn = __uint_as_float(__float_as_uint(t_num) ^ sign);
  return (a >= kParallelEps) & (sn > 0.f) & (tn >= -(a * kTLo)) &
         (tn <= a * kTHi);
}

// The plain version's quotients and validity of a test in doubt.
template <bool kFastDiv>
__device__ __forceinline__ bool divide(float s_num, float t_num, float uxv,
                                       float near, float& s, float& t) {
  if (kFastDiv) {
    const float recip = 1.f / uxv;
    s = s_num * recip;
    t = t_num * recip;
  } else {
    s = s_num / uxv;
    t = t_num / uxv;
  }
  return 0.f <= t && t <= 1.f && near < s;
}

template <bool kFastDiv>
__global__ void observe_kernel(
    const float* __restrict__ lines,       // (N, L, 4): x0, y0, x1, y1
    const int* __restrict__ lines_width,   // (N,)
    const int* __restrict__ tex_starts,    // (N, L)
    const int* __restrict__ tex_widths,    // (N, L)
    const float4* __restrict__ table,      // (N, T): r, g, b, baked
    const float* __restrict__ baked_dyn,   // (N, T_dyn) or null
    const float* __restrict__ angles,      // (N, A) degrees
    const float* __restrict__ positions,   // (N, A, 2)
    int A, int L, int T, int T_dyn, int R, int skip, int draw_model,
    float hsw, float agent_radius,
    int* __restrict__ indices,             // (N, A, R)
    float* __restrict__ distances,         // (N, A, R)
    float* __restrict__ screen,            // (N, A, 3, R)
    unsigned char* __restrict__ seen) {    // (N, T) or null
  // Shared: hot (pqx, pqy, vx, vy)[S], cold (start, width)[S], s_num[S].
  extern __shared__ float4 hot[];
  const int S = L - skip;
  int2* cold = reinterpret_cast<int2*>(hot + S);
  float* snum = reinterpret_cast<float*>(cold + S);

  const int na = blockIdx.x;
  const int n = na / A;
  const int n_live = max(min(lines_width[n], L) - skip, 0);
  const int n_drawn = A * draw_model;  // 0 unless draw_model; then skip == 0
  const float px = positions[2 * na];
  const float py = positions[2 * na + 1];

  for (int i = threadIdx.x; i < n_live; i += blockDim.x) {
    const size_t g = static_cast<size_t>(n) * L + skip + i;
    const float* p = lines + 4 * g;
    float x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3];
    if (i < n_drawn) {
      const int owner = n * A + i / draw_model;
      const float a = kDegToRad * angles[owner];
      const float c = cosf(a);
      const float s = sinf(a);
      const float ox = positions[2 * owner];
      const float oy = positions[2 * owner + 1];
      const float x0d = (c * x0 - s * y0) + ox;
      const float y0d = (s * x0 + c * y0) + oy;
      const float x1d = (c * x1 - s * y1) + ox;
      const float y1d = (s * x1 + c * y1) + oy;
      x0 = x0d;
      y0 = y0d;
      x1 = x1d;
      y1 = y1d;
    }
    const float vx = x1 - x0;
    const float vy = y1 - y0;
    const float pqx = x0 - px;
    const float pqy = y0 - py;
    hot[i] = make_float4(pqx, pqy, vx, vy);
    snum[i] = pqx * vy - pqy * vx;
    cold[i] = make_int2(tex_starts[g], tex_widths[g]);
  }
  __syncthreads();

  const float a = kDegToRad * angles[na];
  const float co = cosf(a);
  const float si = sinf(a);
  const float4* env_table = table + static_cast<size_t>(n) * T;
  const float* env_dyn =
      baked_dyn ? baked_dyn + static_cast<size_t>(n) * T_dyn : nullptr;

  for (int r0 = threadIdx.x; r0 < R; r0 += kRays * blockDim.x) {
    Ray ray[kRays];
    float m[kRays];
    unsigned long long mask[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int r = r0 + k * blockDim.x;
      const float uy =
          hsw * ((static_cast<float>(R) - 2.f * static_cast<float>(r) - 1.f) /
                 static_cast<float>(R));
      ray[k].rux = co - si * uy;
      ray[k].ruy = si + co * uy;
      ray[k].rlen = sqrtf(ray[k].rux * ray[k].rux + ray[k].ruy * ray[k].ruy);
      ray[k].near = agent_radius / ray[k].rlen;
      m[k] = INFINITY;
      mask[k] = 0ull;
    }

    // The one pass: running minimum and candidate mask (design item 2). The
    // thread's rays share one branch into the divides, so a slot whose tests
    // are all rejected costs no divergence bookkeeping per ray.
#pragma unroll 2
    for (int i = 0; i < n_live; ++i) {
      const float4 h = hot[i];
      const float s_num = snum[i];
      float uxv[kRays], t_num[kRays];
      bool doubt[kRays], any = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        crosses(h, ray[k], uxv[k], t_num[k]);
        doubt[k] = in_doubt(uxv[k], t_num[k], s_num);
        any |= doubt[k];
      }
      if (!any) continue;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float s, t;
        if (doubt[k] &&
            divide<kFastDiv>(s_num, t_num[k], uxv[k], ray[k].near, s, t)) {
          m[k] = fminf(m[k], s);
          if (s < m[k] + kZTolerance && i < kMaskSlots) mask[k] |= 1ull << i;
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int r = r0 + k * blockDim.x;
      if (r >= R) continue;
      const Ray& ry = ray[k];
      const float bound = m[k] + kZTolerance;
      int idx = -1;
      float s_sel = 0.f, t_sel = 0.f;
      for (unsigned long long bits = mask[k]; bits; bits &= bits - 1) {
        const int i = __ffsll(static_cast<long long>(bits)) - 1;
        float uxv, t_num, s, t;
        crosses(hot[i], ry, uxv, t_num);
        divide<kFastDiv>(snum[i], t_num, uxv, ry.near, s, t);
        if (s < bound) {
          idx = i;
          s_sel = s;
          t_sel = t;
          break;
        }
      }
      for (int i = kMaskSlots; idx < 0 && i < n_live; ++i) {
        float uxv, t_num, s, t;
        crosses(hot[i], ry, uxv, t_num);
        if (in_doubt(uxv, t_num, snum[i]) &&
            divide<kFastDiv>(snum[i], t_num, uxv, ry.near, s, t) &&
            s < bound) {
          idx = i;
          s_sel = s;
          t_sel = t;
        }
      }

      const size_t o = static_cast<size_t>(na) * R + r;
      const size_t oc = static_cast<size_t>(na) * 3 * R + r;
      if (idx < 0) {
        indices[o] = -1;
        distances[o] = INFINITY;
        screen[oc] = 0.f;
        screen[oc + R] = 0.f;
        screen[oc + 2 * R] = 0.f;
        continue;
      }
      const float vx = hot[idx].z;
      const float vy = hot[idx].w;
      const int2 tex = cold[idx];
      const float vlen = sqrtf(vx * vx + vy * vy);
      const float dot = (ry.rux * vx + ry.ruy * vy) / (ry.rlen * vlen + 1e-6f);

      // Two-tap texture filter (tex_filter) with baked intensity and Lambert.
      const float tw = static_cast<float>(tex.y);
      const float y = fminf(t_sel * (tw + 1.f), tw - 1.f);
      const int l = static_cast<int>(fmaxf(y - 1.f, 0.f));
      const int rr = static_cast<int>(fminf(y, tw - 1.f));
      const float ld = fabsf(y - static_cast<float>(l + 1)) + 1e-3f;
      const float rd = fabsf(y - static_cast<float>(rr + 1)) + 1e-3f;
      const float lw = rd / (ld + rd);
      const float rw = ld / (ld + rd);
      const int kl = tex.x + l;
      const int kr = tex.x + rr;
      const float4 tap_l = env_table[kl];
      const float4 tap_r = env_table[kr];
      const float bl = (env_dyn && kl < T_dyn) ? env_dyn[kl] : tap_l.w;
      const float br = (env_dyn && kr < T_dyn) ? env_dyn[kr] : tap_r.w;
      const float intensity = lw * bl + rw * br;
      const float shadefac = (1.f - dot * dot) * intensity;

      indices[o] = idx + skip;
      distances[o] = s_sel * ry.rlen;
      screen[oc] = shadefac * (lw * tap_l.x + rw * tap_r.x);
      screen[oc + R] = shadefac * (lw * tap_l.y + rw * tap_r.y);
      screen[oc + 2 * R] = shadefac * (lw * tap_l.z + rw * tap_r.z);

      if (seen) {
        // Seen texel: start + clamp(floor(tw * t), 0, tw - 1).
        const float ti = fminf(floorf(tw * t_sel), tw - 1.f);
        seen[static_cast<size_t>(n) * T + tex.x +
             static_cast<int>(fmaxf(ti, 0.f))] = 1;
      }
    }
  }
}

template <bool kFastDiv>
cudaError_t launch(int N, int A, int L, int skip, int R, cudaStream_t st,
                   const float* lines, const int* lines_width,
                   const int* tex_starts, const int* tex_widths,
                   const float4* table, const float* baked_dyn,
                   const float* angles, const float* positions, int T,
                   int T_dyn, int draw_model, float hsw, float agent_radius,
                   int* indices, float* distances, float* screen,
                   unsigned char* seen) {
  const int per_thread = (R + kRays - 1) / kRays;
  const int warps = (per_thread + 31) / 32;
  const int threads = warps < 32 ? 32 * warps : 1024;
  const size_t smem = static_cast<size_t>(L - skip) *
                      (sizeof(float4) + sizeof(int2) + sizeof(float));
  observe_kernel<kFastDiv><<<N * A, threads, smem, st>>>(
      lines, lines_width, tex_starts, tex_widths, table, baked_dyn, angles,
      positions, A, L, T, T_dyn, R, skip, draw_model, hsw, agent_radius,
      indices, distances, screen, seen);
  return cudaGetLastError();
}

}  // namespace

// Launches the kernel on `stream` without synchronising. baked_dyn and seen
// may be null. Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int observe(
    const void* lines, const void* lines_width, const void* tex_starts,
    const void* tex_widths, const void* table, const void* baked_dyn,
    const void* angles, const void* positions, int N, int A, int L, int T,
    int T_dyn, int R, int skip, int draw_model, int fast_div, float hsw,
    float agent_radius, void* indices, void* distances, void* screen,
    void* seen, void* stream) {
  if (N == 0 || A == 0 || R == 0) return 0;
#define OBSERVE_ARGS                                                          \
  N, A, L, skip, R, static_cast<cudaStream_t>(stream),                        \
      static_cast<const float*>(lines), static_cast<const int*>(lines_width), \
      static_cast<const int*>(tex_starts), static_cast<const int*>(tex_widths), \
      static_cast<const float4*>(table), static_cast<const float*>(baked_dyn), \
      static_cast<const float*>(angles), static_cast<const float*>(positions), \
      T, T_dyn, draw_model, hsw, agent_radius, static_cast<int*>(indices),    \
      static_cast<float*>(distances), static_cast<float*>(screen),            \
      static_cast<unsigned char*>(seen)
  const cudaError_t err = fast_div ? launch<true>(OBSERVE_ARGS)
                                   : launch<false>(OBSERVE_ARGS);
#undef OBSERVE_ARGS
  return static_cast<int>(err);
}
