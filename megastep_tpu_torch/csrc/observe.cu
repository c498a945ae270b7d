// Fused observe: raycast + shade (+ seen-texel mask), one CUDA kernel per step;
// and, as a second entry point, Deathmatch's per-frame re-bake of the
// agent-model texels (rebake_kernel, described at its code below).
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

// ---------------------------------------------------------------------------
// Re-bake: this frame's light of the agent-model texels, one launch per step.
//
// Replaces no Pallas kernel: the JAX package's re-bake is XLA ops
// (megastep_tpu/ops/bake.py:181-205), and the port ran it as some eighty
// torch launches. Plain version, which it is held against:
// megastep_tpu_torch/ops/bake.py::dynamic_texel_intensity_parts (texel_points,
// then intensity_at). Wrapper: megastep_tpu_torch/ops/fused.py::rebake.
//
// What it computes, per scene n and model texel p < P: the texel's center on
// its owning drawn model line, as texel_points does (loc = (p - start + .5) /
// max(width, 1) as a true division, a*(1 - loc) + b*loc); for each live light
// k < min(lights_width, K), whether any live wall (slot l < lines_width - nd
// of the walls) crosses the segment from the light to the center, by
// intensity_at's test in its op order: U = C - I, uxv = Ux*vy - Uy*vx, the
// test is off where |uxv| < PARALLEL_EPS, else s = s_num/uxv, t = t_num/uxv
// (true divisions) with s_num = pqx*vy - pqy*vx, t_num = pqx*Uy - pqy*Ux,
// pq = a - I, and blocked = 0 < t < 1 and 0 < s < .999; then AMBIENT plus
// the unblocked lights' LUMINANCE*Ii / max(d^2, 1), clamped at 1.
//
// Numerics: every occlusion decision is the plain version's, bit for bit: the
// same f32 operations in the same order, built with -fmad=false and with
// correctly rounded division. A wall test stops the walk at the first wall
// that blocks; the plain version takes an any() over the walls, so the
// decision is the same. Two divides are skipped only where the outcome is
// certain. With a = |uxv| and sn, tn the numerators with uxv's sign bit xored
// in, s = RN(sn/a) and t = RN(tn/a) exactly (round to nearest is symmetric):
//   - sn <= 0 or tn <= 0 (zero, the opposite sign, or NaN): s or t is +-0,
//     negative or NaN, so s > 0 or t > 0 fails;
//   - sn >= a or tn >= a: the real quotient is >= 1, so its rounding is >= 1
//     (rounding is monotone and 1 is a float), and s < .999 or t < 1 fails.
// The sum over the lights is taken in light order by one thread a texel; the
// plain version's sum may be ordered differently, so the intensity may differ
// in its last bits (the decisions may not).
//
// Design: one block of kRebakeThreads threads per scene. The block stages the
// scene's live walls (a, v = b - a as one float4), its live lights, the P
// texel centers and s_num of every (light, wall) pair in shared memory; then
// each thread takes (light, texel) items, the texels of one light on adjacent
// lanes (adjacent texels lie on one model line, so their walks agree and end
// together), walks the walls from shared memory, and writes the light's
// contribution to a shared (K, P) array; last one thread a texel sums it.
// Padded light and wall slots are never staged nor walked.
//
// What bounds it on an H100 (chip_smoke.py computes bound_ms from each run's
// inputs with megastep_tpu_torch/perf/roofline.py::rebake_bound): at the
// deathmatch-step cell's shapes (N = 4,096 scenes, P = 64 texels, 32 model
// lines, 2-10 live lights and 6-22 live walls a scene) it reads ~1.3 KB a
// scene and writes 256 B (~6 MB, ~2 us at 3.35 TB/s) and runs ~2e7 tests of
// 18 operations (~5 us at 67 TFLOP/s): operations bound it, and both are far
// under a launch's own cost. So the design keeps every test in registers and
// every operand in shared memory, reads each input from device memory once,
// and has no intermediate go to device memory at all; its time is the
// per-scene staging (three dependent loads: owner, its texel range and
// endpoints) and the walk, hidden over 4,096 independent blocks.

namespace {

constexpr float kAmbient = 0.1f;
constexpr float kLuminance = 2.f;
constexpr float kSMax = 0.999f;
constexpr int kRebakeThreads = 128;

__global__ void rebake_kernel(
    const float* __restrict__ dyn_lines,    // (N, nd, 4): x0, y0, x1, y1
    const float* __restrict__ walls,        // (N, W, 4), rows wall_stride apart
    const int* __restrict__ lines_width,    // (N,) counts the nd model lines
    const float* __restrict__ lights,       // (N, K_full, 3): x, y, intensity
    const int* __restrict__ lights_width,   // (N,)
    const int* __restrict__ tex_line,       // (N, T) owning line of each texel
    const int* __restrict__ tex_starts,     // (N, L)
    const int* __restrict__ tex_widths,     // (N, L)
    int nd, int W, long long wall_stride, int K, int K_full, int P, int T,
    int L, float* __restrict__ out) {       // (N, P)
  // Shared: walls[W] (ax, ay, vx, vy), lights[K] (x, y, intensity, -),
  // centers[P], s_num[K][W], contributions[K][P].
  extern __shared__ float4 rebake_smem[];
  float4* wall = rebake_smem;
  float4* light = wall + W;
  float2* center = reinterpret_cast<float2*>(light + K);
  float* snum = reinterpret_cast<float*>(center + P);
  float* contrib = snum + static_cast<size_t>(K) * W;

  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int w_live = max(min(lines_width[n] - nd, W), 0);
  const int k_live = max(min(lights_width[n], K), 0);

  for (int l = tid; l < w_live; l += blockDim.x) {
    const float* w = walls + n * wall_stride + 4 * l;
    const float ax = w[0], ay = w[1];
    wall[l] = make_float4(ax, ay, w[2] - ax, w[3] - ay);
  }
  for (int k = tid; k < k_live; k += blockDim.x) {
    const float* i = lights + (static_cast<size_t>(n) * K_full + k) * 3;
    light[k] = make_float4(i[0], i[1], i[2], 0.f);
  }
  for (int p = tid; p < P; p += blockDim.x) {
    const int tl = tex_line[static_cast<size_t>(n) * T + p];
    float2 c = make_float2(NAN, NAN);  // a texel off the model lines reads NaN
    if (0 <= tl && tl < nd) {
      const size_t g = static_cast<size_t>(n) * L + tl;
      const float loc = (static_cast<float>(p - tex_starts[g]) + 0.5f) /
                        static_cast<float>(max(tex_widths[g], 1));
      const float* e = dyn_lines + (static_cast<size_t>(n) * nd + tl) * 4;
      const float rest = 1.f - loc;
      c = make_float2(e[0] * rest + e[2] * loc, e[1] * rest + e[3] * loc);
    }
    center[p] = c;
  }
  __syncthreads();

  for (int j = tid; j < k_live * w_live; j += blockDim.x) {
    const int k = j / w_live;
    const int l = j - k * w_live;
    const float4 h = wall[l];
    const float pqx = h.x - light[k].x;
    const float pqy = h.y - light[k].y;
    snum[k * W + l] = pqx * h.w - pqy * h.z;
  }
  __syncthreads();

  for (int j = tid; j < k_live * P; j += blockDim.x) {
    const int k = j / P;
    const int p = j - k * P;
    const float4 li = light[k];
    const float2 c = center[p];
    const float ux = c.x - li.x;
    const float uy = c.y - li.y;
    const float* sk = snum + k * W;
    bool blocked = false;
    for (int l = 0; l < w_live; ++l) {
      const float4 h = wall[l];
      const float uxv = ux * h.w - uy * h.z;
      const float a = fabsf(uxv);
      if (!(a >= kParallelEps)) continue;
      const float s_num = sk[l];
      const float t_num = (h.x - li.x) * uy - (h.y - li.y) * ux;
      const unsigned sign = __float_as_uint(uxv) & 0x80000000u;
      const float sn = __uint_as_float(__float_as_uint(s_num) ^ sign);
      const float tn = __uint_as_float(__float_as_uint(t_num) ^ sign);
      if (!((sn > 0.f) & (sn < a) & (tn > 0.f) & (tn < a))) continue;
      const float s = s_num / uxv;
      const float t = t_num / uxv;
      if (t > 0.f && t < 1.f && s > 0.f && s < kSMax) {
        blocked = true;
        break;
      }
    }
    float lit = 0.f;
    if (!blocked) {
      const float dx = li.x - c.x;
      const float dy = li.y - c.y;
      lit = (kLuminance * li.z) / fmaxf(dx * dx + dy * dy, 1.f);
    }
    contrib[k * P + p] = lit;
  }
  __syncthreads();

  for (int p = tid; p < P; p += blockDim.x) {
    float total = 0.f;
    for (int k = 0; k < k_live; ++k) total += contrib[k * P + p];
    out[static_cast<size_t>(n) * P + p] =
        isnan(center[p].x) ? NAN : fminf(kAmbient + total, 1.f);
  }
}

}  // namespace

// Launches the re-bake on `stream` without synchronising: one block per
// scene, `smem_bytes` of dynamic shared memory (the wrapper computes it and
// keeps it within the 48 KB a launch gets without opting in). Returns
// cudaGetLastError(): 0 when the launch was accepted.
extern "C" int rebake(
    const void* dyn_lines, const void* walls, const void* lines_width,
    const void* lights, const void* lights_width, const void* tex_line,
    const void* tex_starts, const void* tex_widths, int N, int nd, int W,
    long long wall_stride, int K, int K_full, int P, int T, int L,
    int smem_bytes, void* out, void* stream) {
  if (N == 0 || P == 0) return 0;
  rebake_kernel<<<N, kRebakeThreads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dyn_lines), static_cast<const float*>(walls),
      static_cast<const int*>(lines_width), static_cast<const float*>(lights),
      static_cast<const int*>(lights_width), static_cast<const int*>(tex_line),
      static_cast<const int*>(tex_starts), static_cast<const int*>(tex_widths),
      nd, W, wall_stride, K, K_full, P, T, L, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
