// Fused observe: raycast + shade (+ seen-texel mask), one CUDA kernel per step.
//
// Replaces: megastep_tpu/ops/fused.py::_observe_kernel, the JAX package's
// Pallas TPU kernel, in all of its modes:
//   K1a, Explorer: want_seen on, skip_dyn = n_dynamic, a static texel table.
//   K1b, Deathmatch's table patch: baked_dyn (N, T_dyn) holds this frame's
//     re-baked intensity of the first T_dyn texels (the agent models). A tap
//     at texel k < T_dyn takes its intensity from baked_dyn[n, k] instead of
//     the table's baked channel; its colour still comes from the table. This
//     replaces the JAX table_patch/patch_rows, which overwrite rows of a
//     blocked bf16 table in VMEM; the (N, T, 4) table here is never rebuilt.
//   K1c, draw_model = M: the A*M head slots of the static lines hold the
//     unrotated model; slot i is drawn while it is staged, by agent i / M's
//     pose, with render.place's ops in its order: c = cosf, s = sinf of
//     (float)(pi/180) * angle, endpoints (c*x - s*y) + px and (s*x + c*y) + py,
//     the direction as the difference of the drawn endpoints. So it equals the
//     launch on torch-drawn lines bit for bit, and replaces the per-step draw
//     of the full line array.
//   K1d, fast_div: recip = 1/uxv (an IEEE divide), s = s_num*recip,
//     t = t_num*recip, as fused.py:307-313, in place of two IEEE divides.
// want_seen off passes a null seen pointer: no mask is stored or allocated.
// fast_div is a template parameter, since it sits in the line loop; the other
// modes are uniform runtime branches outside it.
// Plain version: megastep_tpu_torch/ops/fused.py::observe_plain.
//
// What it computes, per (env, agent, ray): the ray direction from the pose;
// the ray/segment intersection (s, t) against every live line slot, with the
// parallel test |u x v| >= 1e-3, 0 <= t <= 1 and near < s; the nearest s and
// then the LOWEST line index whose s lies within Z_TOLERANCE of it (the JAX
// reduction semantics, fused.py:326-334 and render.py:94-98, not the
// reference CUDA's sequential replace-if-closer scan); the winner's Lambert
// factor 1 - dot^2; the two-tap texture filter of tex_filter (fused.py:372-379)
// over a packed (N, T, 4) [r, g, b, baked] table; and, for a hit ray when the
// mask is asked for, a 1 stored into a per-env byte mask at the texel the ray
// sees (fused.py:427-429). The stores are idempotent, so no atomics; misses
// mark nothing.
//
// Numerics: the arithmetic is the plain version's, op for op, in f32:
// uxv = vy*rux - vx*ruy, t_num = pqx*ruy - pqy*rux, s_num = pqx*vy - pqy*vx,
// true IEEE divides s_num/uxv and t_num/uxv, rlen = sqrt(rux^2 + ruy^2),
// near = agent_radius/rlen, uy = hsw*((res - 2r - 1)/res). The library is
// built with -fmad=false and without --use_fast_math (megastep_tpu_torch/
// kernels.py), so no multiply-add is contracted: every rounding is the one
// the plain version's separate torch ops make. That is a parity choice; a
// later performance change may revisit it. The pose's cos/sin are cosf/sinf
// of the f32 product (float)(pi/180) * angle, the same libdevice calls the
// plain version's torch.cos/torch.sin make on the card.
//
// What bounds it on an H100 (chip_smoke.py computes both bounds from each
// run's inputs):
//  Explorer (N = 16,384 envs, A = 1, R = 256 rays, 48 padded line slots of
//  which 8 are dynamic and skipped, T = 2,304 texels):
//   bytes: 24 B per live line slot, 12 B of pose per agent, two 16-B texel
//     taps per hit ray (~134 MB), 20 B of outputs per ray (~84 MB), and the
//     seen mask (N*T bytes zero-filled, ~38 MB, plus one byte per hit):
//     ~266 MB, ~0.08 ms at 3.35 TB/s;
//   operations: the loop stops at lines_width, and the procedural floorplans
//     average ~13.4 live static slots, so ~5.6e7 ray-line tests, each 18 f32
//     ops with two IEEE divides: ~1.0e9 ops, ~0.015 ms at 67 TFLOP/s f32.
//  Deathmatch (N = 4,096 scenes, A = 4, R = 512, L = 64 of which 32 are the
//  agent models, T = 2,432 of which T_dyn = 64 dynamic; every mode):
//   bytes: 24 B per live slot (~45 per env: ~4.5 MB), 12 B of pose per agent,
//     T_dyn*4 B of baked_dyn per env (1 MB), 32 B of taps per hit ray
//     (~268 MB), 20 B of outputs per ray (~168 MB), no seen: ~442 MB,
//     ~0.13 ms;
//   operations: A*R*live*18 per env, ~6.9e9 ops, ~0.10 ms (19 ops a test with
//     fast_div: one divide and two multiplies for two divides).
//   So by the published rates the bytes set the bound, narrowly at Deathmatch.
//   In practice each IEEE divide is a multi-instruction sequence, so the line
//   loop costs more instructions than the op count says.
// What the simple design does about it: nothing yet. One block per
// (env, agent), threads over rays, the env's live line slots staged in shared
// memory by every agent's block (with draw_model, every block draws all A*M
// model slots), two passes over them per ray (the second stops at the first
// eligible line). One block per env over A*R rays, staging once, is a later
// lever; so are compares against the running minimum instead of divides.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kParallelEps = 1e-3f;
constexpr float kZTolerance = 1e-4f;
constexpr float kDegToRad = static_cast<float>(3.14159265358979323846 / 180.0);

struct Line {
  float ax, ay, vx, vy;  // start point and direction
  int start, width;      // texel range of the line
};

// Ray/segment intersection of one line. Returns whether the ray hits it.
template <bool kFastDiv>
__device__ __forceinline__ bool intersect(const Line& ln, float px, float py,
                                          float rux, float ruy, float near,
                                          float& s, float& t) {
  const float pqx = ln.ax - px;
  const float pqy = ln.ay - py;
  const float uxv = ln.vy * rux - ln.vx * ruy;
  if (!(fabsf(uxv) >= kParallelEps)) return false;
  const float s_num = pqx * ln.vy - pqy * ln.vx;
  const float t_num = pqx * ruy - pqy * rux;
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
  extern __shared__ Line slots[];
  const int na = blockIdx.x;
  const int n = na / A;
  const int n_live = min(lines_width[n], L) - skip;
  const int n_drawn = A * draw_model;  // 0 unless draw_model; then skip == 0

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
    Line ln;
    ln.ax = x0;
    ln.ay = y0;
    ln.vx = x1 - x0;
    ln.vy = y1 - y0;
    ln.start = tex_starts[g];
    ln.width = tex_widths[g];
    slots[i] = ln;
  }
  __syncthreads();

  const float a = kDegToRad * angles[na];
  const float co = cosf(a);
  const float si = sinf(a);
  const float px = positions[2 * na];
  const float py = positions[2 * na + 1];
  const float4* env_table = table + static_cast<size_t>(n) * T;
  const float* env_dyn =
      baked_dyn ? baked_dyn + static_cast<size_t>(n) * T_dyn : nullptr;

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float uy =
        hsw * ((static_cast<float>(R) - 2.f * static_cast<float>(r) - 1.f) /
               static_cast<float>(R));
    const float rux = co - si * uy;
    const float ruy = si + co * uy;
    const float rlen = sqrtf(rux * rux + ruy * ruy);
    const float near = agent_radius / rlen;

    float s, t;
    float s_min = INFINITY;
    for (int i = 0; i < n_live; ++i) {
      if (intersect<kFastDiv>(slots[i], px, py, rux, ruy, near, s, t))
        s_min = fminf(s_min, s);
    }
    int idx = -1;
    float s_sel = 0.f, t_sel = 0.f;
    const float bound = s_min + kZTolerance;
    for (int i = 0; i < n_live; ++i) {
      if (intersect<kFastDiv>(slots[i], px, py, rux, ruy, near, s, t) &&
          s < bound) {
        idx = i;
        s_sel = s;
        t_sel = t;
        break;
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
    const Line ln = slots[idx];
    const float vlen = sqrtf(ln.vx * ln.vx + ln.vy * ln.vy);
    const float dot = (rux * ln.vx + ruy * ln.vy) / (rlen * vlen + 1e-6f);

    // Two-tap texture filter (tex_filter) with baked intensity and Lambert.
    const float tw = static_cast<float>(ln.width);
    const float y = fminf(t_sel * (tw + 1.f), tw - 1.f);
    const int l = static_cast<int>(fmaxf(y - 1.f, 0.f));
    const int rr = static_cast<int>(fminf(y, tw - 1.f));
    const float ld = fabsf(y - static_cast<float>(l + 1)) + 1e-3f;
    const float rd = fabsf(y - static_cast<float>(rr + 1)) + 1e-3f;
    const float lw = rd / (ld + rd);
    const float rw = ld / (ld + rd);
    const int kl = ln.start + l;
    const int kr = ln.start + rr;
    const float4 tap_l = env_table[kl];
    const float4 tap_r = env_table[kr];
    const float bl = (env_dyn && kl < T_dyn) ? env_dyn[kl] : tap_l.w;
    const float br = (env_dyn && kr < T_dyn) ? env_dyn[kr] : tap_r.w;
    const float intensity = lw * bl + rw * br;
    const float shadefac = (1.f - dot * dot) * intensity;

    indices[o] = idx + skip;
    distances[o] = s_sel * rlen;
    screen[oc] = shadefac * (lw * tap_l.x + rw * tap_r.x);
    screen[oc + R] = shadefac * (lw * tap_l.y + rw * tap_r.y);
    screen[oc + 2 * R] = shadefac * (lw * tap_l.z + rw * tap_r.z);

    if (seen) {
      // Seen texel: start + clamp(floor(tw * t), 0, tw - 1).
      const float ti = fminf(floorf(tw * t_sel), tw - 1.f);
      seen[static_cast<size_t>(n) * T + ln.start + static_cast<int>(fmaxf(ti, 0.f))] = 1;
    }
  }
}

}  // namespace

// Launches the kernel on `stream` without synchronising. baked_dyn and seen
// may be null. Returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int observe(
    const void* lines, const void* lines_width, const void* tex_starts,
    const void* tex_widths, const void* table, const void* baked_dyn,
    const void* angles, const void* positions, int N, int A, int L, int T,
    int T_dyn, int R, int skip, int draw_model, int fast_div, float hsw,
    float agent_radius, void* indices, void* distances, void* screen,
    void* seen, void* stream) {
  if (N == 0 || A == 0 || R == 0) return 0;
  const int threads = R < 256 ? ((R + 31) / 32) * 32 : 256;
  const size_t smem = static_cast<size_t>(L > skip ? L - skip : 0) * sizeof(Line);
  const dim3 grid(N * A), block(threads);
  const auto st = static_cast<cudaStream_t>(stream);
#define OBSERVE_ARGS                                                          \
  static_cast<const float*>(lines), static_cast<const int*>(lines_width),     \
      static_cast<const int*>(tex_starts), static_cast<const int*>(tex_widths), \
      static_cast<const float4*>(table), static_cast<const float*>(baked_dyn), \
      static_cast<const float*>(angles), static_cast<const float*>(positions), \
      A, L, T, T_dyn, R, skip, draw_model, hsw, agent_radius,                 \
      static_cast<int*>(indices), static_cast<float*>(distances),             \
      static_cast<float*>(screen), static_cast<unsigned char*>(seen)
  if (fast_div) {
    observe_kernel<true><<<grid, block, smem, st>>>(OBSERVE_ARGS);
  } else {
    observe_kernel<false><<<grid, block, smem, st>>>(OBSERVE_ARGS);
  }
#undef OBSERVE_ARGS
  return static_cast<int>(cudaGetLastError());
}
