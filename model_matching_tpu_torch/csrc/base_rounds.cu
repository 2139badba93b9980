// The sequential instance sampler's per-base rounds for NVIDIA Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. The JAX package runs these rounds inside its
// compiled scan; the port ran them as the plain torch parts `pre` and
// `post` of instance.sample_instance_bases_stepwise (now
// ops/base_rounds.py: base_pre_reference, base_post_reference), replayed
// from CUDA graphs a base at a time. Those graphs hold ~700 tiny
// elementwise kernels a base, so the sampler was bound by their launch
// cost (~1.7 ms a base), while a base's useful work is three PPF
// existence checks over N ~ 11,000 points, one acos and one plane and
// distance test a point, and four Gumbel argmaxes: a few MFLOP and well
// under a megabyte of reads.
//
// What bounds it on this card: not bytes and not the card's arithmetic,
// but latency. Every round ends in a global argmax that the next round's
// per-point work needs, so the rounds are one dependency chain. Each part
// is a few kernels, one at each argmax: every kernel spreads the points
// over a grid of up to kMaxBlocks blocks of kThreads threads (one block an
// SM at packed width), each block leaves its partial argmax in a scratch
// array the wrapper allocates, and the next kernel starts by reducing all
// partials in every block, so a kernel boundary is the grid-wide barrier.
// `pre` is two kernels (round 1; its mask, radius and claim), `post` three
// (round 2; the angle mask and round 3; the plane mask and round 4, whose
// draw the last block to finish reduces). On an H100 at packed width one
// block of 1,024 threads a part took 50 / 58 us of device time, bound by
// one SM's instruction rate; the grid takes 18 / 28 us. The
// design also cuts the work to the points that can change an output: a
// point whose weight is already zero keeps a zero weight whatever its
// masks say, so the existence checks, the angle and the plane test run
// only on points with weight left (after the previous segment's mask, a
// few hundred in `post`), while every point still takes part in each draw.
//
// Bit for bit with the plain torch parts. torch runs each operation of
// those parts as a kernel of its own, so nothing there is contracted into
// a fused multiply-add. Here every float operation is written as its
// rounding intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, and the
// float64 ones where ops/fmath.py works in float64), which nvcc never
// contracts, in the torch expression's order. Python float constants meet
// float32 tensors as float32 values; comparisons too. log and acos repeat
// ops/fmath.py's operations one for one, with its constants and its flush
// of denormals (fm_log, fm_atan2, fm_acos). Draws follow torch.argmax: the
// largest value, NaN above all, ties to the lowest index, an order that
// makes the result independent of how the points are cut into blocks. A
// draw's `ok` is "some weight > 0 and none NaN", which is `sum > 0` for
// weights that are never negative.
//
// Plain C interface (built with nvcc, loaded with ctypes). Launches go to
// the caller's stream; the functions return the CUDA error code. Both
// sampler entry points read the base number from the device (`row`) and
// make no host read, so they can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 128;      // a grid (N = 16,384 lanes: one point a thread)
constexpr int kMaxThresholds = 256;  // angle bins (180 at a 1-degree step)

// a block's partial draw
struct Part {
  float v, z;
  int i, zi, pos, nan;
};

// The scratch the wrapper allocates (zeroed) once a sampler call.
struct Scratch {
  Part parts[2][kMaxBlocks];    // the partial draws of the last two kernels
  float max_d[kMaxBlocks];      // the partial radii of pre's second kernel
  int counter;                  // blocks done (back to 0 by the last)
  int idx2, ok2;                // round 2's draw, for post's last kernel
};

// Mirrored field by field by ops/base_rounds.py: _Args.
struct BaseArgs {
  // the scene, read only
  const float* pos;             // [N, 3]
  const float* normal;          // [N, 3]
  const uint8_t* valid;         // [N] bool
  const float* edge_prob;       // [N]
  const int* pixel;             // [N, 2] (row, col)
  const float* noise;           // [block rows, 4, N] Gumbel noise
  // the existence check: one of three layouts (mode)
  const int* exists_bits;       // mode 0: [N, bits_words] int32 words
  const long long* exist_direct;  // mode 1: [S / 32] uint32 words in int64
  const int* exist_keys;        // mode 2: [Te] open-addressed keys, -1 empty
  const float* thresholds;      // [n_thresholds] angle-bin boundary cosines
  // carried across bases
  float* class_prob;            // [N]
  uint8_t* prev_in;             // [N] bool: in the previous base's segment
  const int* seg_buffer;        // [H, W] claims
  const uint8_t* seg;           // [H, W] bool: this base's segment
  uint8_t* masks;               // [B + 1, H, W] bool
  const uint8_t* fill_ok;       // [1] bool
  long long* row;               // [1] base number - 1
  int* raws;                    // [B, 4]
  uint8_t* oks;                 // [B] bool
  uint8_t* fills;               // [B] bool
  // handed from pre to post (and the fill)
  float* probs;                 // [N] weights after round 1
  float* log_w;                 // [N]
  int* idx1;                    // [1]
  uint8_t* ok1;                 // [1] bool
  int* seed_rc;                 // [2]
  float* max_pix_dist;          // [1]
  int* cached_id;               // [1]
  // the kernels' own
  Scratch* scratch;
  float* work;                  // [N] post's running weights
  long long hw;                 // H * W
  long long direct_words;       // S / 32
  int n, h, w, block, bits_words, exist_size, max_probes, n_thresholds;
  int tr_disc, rot_disc, mode;
  float disp, plane_threshold, min_distance_base, internal_angle_threshold;
};

__device__ __forceinline__ float fbits(uint32_t u) { return __uint_as_float(u); }

// ----------------------------------------------------- ops/fmath.py: log

__device__ __forceinline__ double horner(double fd, uint32_t c0, uint32_t c1,
                                         uint32_t c2) {
  // ((fd * c0 + c1).float().double() * fd + c2).float()
  const float a = __double2float_rn(__dadd_rn(__dmul_rn(fd, (double)fbits(c0)),
                                              (double)fbits(c1)));
  return (double)__double2float_rn(
      __dadd_rn(__dmul_rn((double)a, fd), (double)fbits(c2)));
}

__device__ float fm_log(float x) {
  const float min_norm = fbits(0x00800000u);
  const float t = x > min_norm ? x : min_norm;
  const int ti = __float_as_int(t);
  const float m = __int_as_float((ti & (int)0x807FFFFF) | 0x3F000000);
  const bool below = m < fbits(0x3F3504F3u);                   // sqrt(1/2)
  const float e = (float)((ti >> 23) - 126 - (below ? 1 : 0));
  const float f = __fadd_rn(__fsub_rn(m, 1.0f), below ? m : 0.0f);
  const float f2 = __fmul_rn(f, f);
  const float f3 = __fmul_rn(f2, f);
  const double fd = (double)f, f3d = (double)f3;
  const double y0 = horner(fd, 0x3D9021BBu, 0xBDEBD1B8u, 0x3DEF251Au);
  const double y1 = horner(fd, 0xBDFE5D4Fu, 0x3E11E9BFu, 0xBE2AAE50u);
  const double y2 = horner(fd, 0x3E4CCEACu, 0xBE7FFFFCu, 0x3EAAAAAAu);
  float y = __double2float_rn(__dadd_rn(__dmul_rn(y0, f3d), y1));
  y = __double2float_rn(__dadd_rn(__dmul_rn((double)y, f3d), y2));
  y = __double2float_rn(__dadd_rn(__dmul_rn((double)y, f3d),
                                  (double)__fmul_rn(e, fbits(0xB95E8083u))));
  float r = __fadd_rn(__fsub_rn(f, __fmul_rn(f2, 0.5f)), y);
  r = __double2float_rn(__dadd_rn(__dmul_rn((double)e, (double)fbits(0x3F318000u)),
                                  (double)r));
  r = x > 0.0f ? r : fbits(0x7FC00000u);                       // torch.nan
  r = fabsf(x) < min_norm ? -CUDART_INF_F : r;                // DAZ: +-0
  return x == CUDART_INF_F ? CUDART_INF_F : r;
}

// --------------------------------------------- ops/fmath.py: atan2, acos

__device__ __forceinline__ float fm_div(float a, float b) {
  return __double2float_rn(__ddiv_rn((double)a, (double)b));
}

__device__ __forceinline__ float fm_flush(float x) {
  return fabsf(x) < fbits(0x00800000u) ? __fmul_rn(x, 0.0f) : x;
}

// ops/fp.py: sqrt_rn, the float64 root rounded once to float32: the
// correctly rounded float32 root (53 >= 2 * 24 + 2 bits), which is
// __fsqrt_rn's
__device__ __forceinline__ float sqrt_rn(float x) { return __fsqrt_rn(x); }

__device__ float fm_atanf_nonneg(float t) {
  const int it = __float_as_int(t);
  const bool tiny = it < 0x31000000, big = it >= 0x4C000000;
  const bool id0 = it < 0x3F300000, id1 = it < 0x3F980000, id2 = it < 0x401C0000;
  const bool small = it < 0x3EE00000;
  const float num = id0 ? __fsub_rn(__fadd_rn(t, t), 1.0f)
                  : id1 ? __fsub_rn(t, 1.0f)
                  : id2 ? __fsub_rn(t, 1.5f) : -1.0f;
  const float den = id0 ? __fadd_rn(t, 2.0f)
                  : id1 ? __fadd_rn(t, 1.0f)
                  : id2 ? __fadd_rn(__fmul_rn(t, 1.5f), 1.0f) : t;
  const float x = small ? t : fm_div(num, den);
  const float z = __fmul_rn(x, x);
  const float w = __fmul_rn(z, z);
  float s1 = __fmul_rn(w, fbits(0x3C8569D7u));
  s1 = __fmul_rn(__fadd_rn(s1, fbits(0x3D4BDA59u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, fbits(0x3D886B35u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, fbits(0x3DBA2E6Eu)), w);
  s1 = __fmul_rn(__fadd_rn(s1, fbits(0x3E124925u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, fbits(0x3EAAAAABu)), z);
  float s2 = __fmul_rn(w, fbits(0xBD15A221u));
  s2 = __fmul_rn(__fsub_rn(s2, fbits(0x3D6EF16Bu)), w);
  s2 = __fmul_rn(__fsub_rn(s2, fbits(0x3D9D8795u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, fbits(0x3DE38E38u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, fbits(0x3E4CCCCDu)), w);
  const float xs = __fmul_rn(__fadd_rn(s1, s2), x);
  const int idx = (it >= 0x3F300000) + (it >= 0x3F980000) + (it >= 0x401C0000);
  // glibc's atanhi / atanlo at idx
  const float hi = fbits(idx == 0 ? 0x3EED6338u : idx == 1 ? 0x3F490FDAu
                         : idx == 2 ? 0x3F7B985Eu : 0x3FC90FDAu);
  const float lo = fbits(idx == 0 ? 0x31AC3769u : idx == 1 ? 0x33222168u
                         : idx == 2 ? 0x33140FB4u : 0x33A22168u);
  const float reduced = __fsub_rn(hi, __fsub_rn(__fsub_rn(xs, lo), x));
  float out = small ? __fsub_rn(x, xs) : reduced;
  out = tiny ? t : out;
  return (big && !isnan(t)) ? fbits(0x3FC90FDBu) : out;
}

__device__ float fm_atan2(float y, float x) {
  const float pi = fbits(0x40490FDBu), pi_o_2 = fbits(0x3FC90FDBu);
  const float pi_o_4 = fbits(0x3F490FDBu), pi3_o_4 = fbits(0x4016CBE4u);
  const int hx = __float_as_int(x), hy = __float_as_int(y);
  const int ix = hx & 0x7FFFFFFF, iy = hy & 0x7FFFFFFF;
  const bool y_neg = hy < 0, x_neg = hx < 0;
  const int k = (iy - ix) >> 23;
  const float q = hx == 0x3F800000 ? y : fm_flush(fm_div(fm_flush(y), fm_flush(x)));
  float z = fm_atanf_nonneg(fabsf(q));
  z = k > 60 ? fbits(0x3FC90FDBu) : z;                   // pi/2 + pi_lo/2
  z = (x_neg && k < -60) ? 0.0f : z;
  const float zl = __fadd_rn(z, fbits(0x33BBBD2Eu));      // z - pi_lo
  float out = x_neg ? (y_neg ? __fsub_rn(zl, pi) : __fsub_rn(pi, zl))
                    : (y_neg ? -z : z);
  const bool x_inf = ix == 0x7F800000, y_inf = iy == 0x7F800000;
  const float half_pi = y_neg ? -pi_o_2 : pi_o_2;
  out = y_inf ? half_pi : out;
  const float both = x_neg ? pi3_o_4 : pi_o_4;
  const float along = x_neg ? pi : 0.0f;
  const float at_inf = y_inf ? both : along;
  out = x_inf ? (y_neg ? -at_inf : at_inf) : out;
  out = ix == 0 ? half_pi : out;
  const float spi = y_neg ? -pi : pi;
  out = iy == 0 ? (x_neg ? spi : y) : out;
  const bool nan = ix > 0x7F800000 || iy > 0x7F800000;
  return nan ? __fadd_rn(x, y) : out;
}

__device__ __forceinline__ float fm_acos(float x) {
  return fm_atan2(sqrt_rn(__fmul_rn(__fsub_rn(1.0f, x), __fadd_rn(x, 1.0f))), x);
}

// ------------------------------------------------------- small helpers

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp: NaN stays NaN
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float dot3_plus0(float a0, float a1, float a2, float b0,
                                            float b1, float b2) {
  // ops/ppf.py: _dot3, with its trailing + 0.0
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                             __fmul_rn(a2, b2)), 0.0f);
}

__device__ __forceinline__ float norm3(float a0, float a1, float a2) {
  // sampling._norm
  return sqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1)),
                           __fmul_rn(a2, a2)));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// ops/ppf.py: angle_bin_index, the count of thresholds at or above c. The
// thresholds are cosines of increasing angles, so they never increase
// (the wrapper checks it): the ones at or above c are a prefix, found by
// bisection (a NaN c is at or below none).
__device__ __forceinline__ int angle_bin(const float* th, int n_th, float c) {
  int lo = 0, hi = n_th;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c <= th[mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// sampling._pairwise_exists: does PPF(anchor -> i) exist in the model map
__device__ bool pair_exists(const BaseArgs& a, const float* th, int anchor,
                            float ax, float ay, float az, float nx, float ny,
                            float nz, int i) {
  if (a.mode == 0) {
    const int word = a.exists_bits[(long long)anchor * a.bits_words + (i >> 5)];
    return ((word >> (i & 31)) & 1) != 0;
  }
  // ops/ppf.py: ppf_keys_fast(anchor, point i)
  const float px = a.pos[3 * i], py = a.pos[3 * i + 1], pz = a.pos[3 * i + 2];
  const float mx = a.normal[3 * i], my = a.normal[3 * i + 1], mz = a.normal[3 * i + 2];
  const float u0 = __fsub_rn(ax, px), u1 = __fsub_rn(ay, py), u2 = __fsub_rn(az, pz);
  const float d = sqrt_rn(dot3_plus0(u0, u1, u2, u0, u1, u2));
  const float inv_d = d > 0.0f ? __fdiv_rn(1.0f, d < 1e-30f ? 1e-30f : d) : 0.0f;
  const float c1 = clampf(__fmul_rn(dot3_plus0(nx, ny, nz, u0, u1, u2), inv_d), -1.0f, 1.0f);
  const float c2 = clampf(__fmul_rn(dot3_plus0(mx, my, mz, u0, u1, u2), inv_d), -1.0f, 1.0f);
  const float c3 = clampf(dot3_plus0(nx, ny, nz, mx, my, mz), -1.0f, 1.0f);
  const int v = __float2int_rz(__fmul_rn(d, 1000.0f));
  const int tr = a.tr_disc;
  const int q1 = floor_div((int)((uint32_t)v + (uint32_t)(tr / 2)), tr);
  const int a1 = angle_bin(th, a.n_thresholds, c1);
  const int a2 = angle_bin(th, a.n_thresholds, c2);
  const int a3 = angle_bin(th, a.n_thresholds, c3);
  // int32 arithmetic that wraps, as torch's
  const uint32_t key_u = (((uint32_t)q1 * 64u + (uint32_t)a1) * 64u + (uint32_t)a2) * 64u
                         + (uint32_t)a3;
  const int key = (int)((uint32_t)q1 * (uint32_t)tr) <= 5 ? -1 : (int)key_u;
  if (a.mode == 1) {
    // ppf_table.dense_index, then the bitmap word
    const int ar = 180 / a.rot_disc + 1;
    const int k3 = key & 63, k2 = (key >> 6) & 63, k1 = (key >> 12) & 63;
    const int dq = key >> 18;
    if (key < 0 || k1 >= ar || k2 >= ar || k3 >= ar) return false;
    const int idx = ((dq * ar + k1) * ar + k2) * ar + k3;
    if ((long long)idx >= a.direct_words * 32) return false;
    const long long word = a.exist_direct[idx >> 5];
    return ((word >> (idx & 31)) & 1) == 1;
  }
  // ppf_table.probe_slots: bounded linear probing
  if (key < 0) return false;
  const uint32_t mask = (uint32_t)a.exist_size - 1u;
  const uint32_t h0 = mix32((uint32_t)key) & mask;
  for (int p = 0; p < a.max_probes; ++p) {
    const int k = a.exist_keys[(h0 + (uint32_t)p) & mask];
    if (k == key) return true;
    if (k == -1) return false;
  }
  return false;
}

// torch.argmax's order: NaN above all, ties to the lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

struct Draw {
  float v;                      // argmax of noise + logits
  int i;
  float z;                      // argmax of the noise alone (a row with no mass)
  int zi;
  bool pos, nan;                // some weight > 0, some weight NaN

  // point i of a draw: its noise g, weight p and log weight lw
  __device__ __forceinline__ void add(float g, float p, float lw, int idx) {
    const float val = __fadd_rn(g, p > 0.0f ? lw : -CUDART_INF_F);
    if (better(val, idx, v, i)) { v = val; i = idx; }
    if (better(g, idx, z, zi)) { z = g; zi = idx; }
    pos |= p > 0.0f;
    nan |= isnan(p);
  }
};

__device__ __forceinline__ Draw no_draw() {
  Draw d;
  d.v = d.z = -CUDART_INF_F;
  d.i = d.zi = 0x7FFFFFFF;
  d.pos = d.nan = false;
  return d;
}

struct Shared {
  float v[2][kWarps];
  int i[2][kWarps];
  float m[kWarps];
  int r[3];
  float th[kMaxThresholds];     // the angle-bin thresholds
};

__device__ __forceinline__ void load_thresholds(const BaseArgs& a, Shared& sh) {
  for (int j = threadIdx.x; j < a.n_thresholds; j += kThreads) sh.th[j] = a.thresholds[j];
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xFFFFFFFFu, v, off);
    const int oi = __shfl_down_sync(0xFFFFFFFFu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// The block's best of each warp's (v, i) and (z, zi), left in sh.v[*][0],
// sh.i[*][0]; the block's `pos` and `nan` returned in sh.r[0], sh.r[1].
__device__ void block_best(Draw d, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(d.v, d.i);
  warp_best(d.z, d.zi);
  const int pos = __syncthreads_or(d.pos), nan = __syncthreads_or(d.nan);
  if (lane == 0) {
    sh.v[0][warp] = d.v; sh.i[0][warp] = d.i;
    sh.v[1][warp] = d.z; sh.i[1][warp] = d.zi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      for (int r = 0; r < 2; ++r)
        if (better(sh.v[r][w], sh.i[r][w], sh.v[r][0], sh.i[r][0])) {
          sh.v[r][0] = sh.v[r][w];
          sh.i[r][0] = sh.i[r][w];
        }
    sh.r[0] = pos;
    sh.r[1] = nan;
  }
}

// this block's partial draw into parts[blockIdx.x]
__device__ void block_partial(const Draw& d, Part* parts, Shared& sh) {
  block_best(d, sh);
  if (threadIdx.x == 0) {
    Part& p = parts[blockIdx.x];
    p.v = sh.v[0][0]; p.i = sh.i[0][0];
    p.z = sh.v[1][0]; p.zi = sh.i[1][0];
    p.pos = sh.r[0]; p.nan = sh.r[1];
  }
}

// The draw over the grid's partials, in every thread: (index, ok). The
// partials are read past L1, which does not see other blocks' writes.
__device__ int2 grid_draw(const Part* parts, Shared& sh) {
  Draw d = no_draw();
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    const Part* p = parts + b;
    const float pv = __ldcg(&p->v), pz = __ldcg(&p->z);
    const int pi = __ldcg(&p->i), pzi = __ldcg(&p->zi);
    if (better(pv, pi, d.v, d.i)) { d.v = pv; d.i = pi; }
    if (better(pz, pzi, d.z, d.zi)) { d.z = pz; d.zi = pzi; }
    d.pos |= __ldcg(&p->pos) != 0;
    d.nan |= __ldcg(&p->nan) != 0;
  }
  block_best(d, sh);
  __syncthreads();
  const bool ok = sh.r[0] && !sh.r[1];
  const int2 out = make_int2(ok ? sh.i[0][0] : sh.i[1][0], ok ? 1 : 0);
  __syncthreads();              // sh is reused by the next reduction
  return out;
}

// true in every thread of the last block to finish; it resets the counter
__device__ bool last_block(Scratch* sc, Shared& sh) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(&sc->counter, 1) == (int)gridDim.x - 1;
    if (last) sc->counter = 0;
    sh.r[2] = last;
  }
  __syncthreads();
  return sh.r[2] != 0;
}

__device__ __forceinline__ int first_point() { return blockIdx.x * kThreads + threadIdx.x; }
__device__ __forceinline__ int point_stride() { return gridDim.x * kThreads; }

__device__ __forceinline__ const float* base_noise(const BaseArgs& a, long long row) {
  return a.noise + (row % a.block) * 4 * (long long)a.n;
}

// -------------------------------------------------------------- pre

// The decay, the weights and their logs, round 1's partial draws.
__global__ void __launch_bounds__(kThreads) pre_round1(const BaseArgs a) {
  __shared__ Shared sh;
  const int n = a.n;
  const float* g0 = base_noise(a, *a.row);
  const float log_floor = fm_log(1e-30f);
  Draw d = no_draw();
  for (int i = first_point(); i < n; i += point_stride()) {
    const bool v = a.valid[i] != 0;
    float cp = a.class_prob[i];
    if (a.prev_in[i] && v) {                       // the dispersion decay
      cp = __fmul_rn(cp, a.disp);
      a.class_prob[i] = cp;
    }
    float p = v ? cp : 0.0f;
    if (a.edge_prob[i] == 1.0f) p = 0.0f;          // flood.prune_edge_points
    const float lw = p < 1e-30f ? log_floor : fm_log(p);   // sampling.log_weights
    a.log_w[i] = lw;
    a.probs[i] = p;
    d.add(g0[i], p, lw, i);
  }
  block_partial(d, a.scratch->parts[0], sh);
}

// Round 1's draw, its PPF mask, the segment's radius and the claim.
__global__ void __launch_bounds__(kThreads) pre_mask1(const BaseArgs a) {
  __shared__ Shared sh;
  Scratch* sc = a.scratch;
  const int n = a.n;
  load_thresholds(a, sh);
  const int2 r1 = grid_draw(sc->parts[0], sh);
  const int idx1 = r1.x;
  const float ax = a.pos[3 * idx1], ay = a.pos[3 * idx1 + 1], az = a.pos[3 * idx1 + 2];
  const float nx = a.normal[3 * idx1], ny = a.normal[3 * idx1 + 1],
              nz = a.normal[3 * idx1 + 2];
  const int sr = a.pixel[2 * idx1], sc_ = a.pixel[2 * idx1 + 1];

  float maxd = 0.0f;
  for (int i = first_point(); i < n; i += point_stride()) {
    float p = a.probs[i];
    if (!(p == 0.0f)) {              // a zero weight stays zero whatever the mask
      if (i == idx1 || !pair_exists(a, sh.th, idx1, ax, ay, az, nx, ny, nz, i)) {
        p = 0.0f;
        a.probs[i] = p;
      }
    }
    if (p > 0.0f) {                  // ops/base_rounds.py: pixel_distance
      const float dr = (float)(a.pixel[2 * i] - sr), dc = (float)(a.pixel[2 * i + 1] - sc_);
      maxd = fmaxf(maxd, sqrt_rn(__fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc))));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    maxd = fmaxf(maxd, __shfl_down_sync(0xFFFFFFFFu, maxd, off));
  if ((threadIdx.x & 31) == 0) sh.m[threadIdx.x >> 5] = maxd;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) maxd = fmaxf(maxd, sh.m[w]);
    sc->max_d[blockIdx.x] = maxd;
  }
  if (!last_block(sc, sh)) return;
  if (threadIdx.x == 0) {
    float m = 0.0f;
    for (int b = 0; b < (int)gridDim.x; ++b) m = fmaxf(m, __ldcg(&sc->max_d[b]));
    *a.idx1 = idx1;
    *a.ok1 = (uint8_t)r1.y;
    a.seed_rc[0] = sr;
    a.seed_rc[1] = sc_;
    *a.max_pix_dist = m;
    long long flat = (long long)sr * a.w + sc_;    // ops/base_rounds.py: cached_id
    if (flat < 0) flat += a.hw;
    *a.cached_id = a.seg_buffer[flat];
  }
}

// -------------------------------------------------------------- post

// The segment into the mask cache and prev_in; round 2's partial draws.
__global__ void __launch_bounds__(kThreads) post_round2(const BaseArgs a) {
  __shared__ Shared sh;
  const int n = a.n;
  const long long row = *a.row;
  const float* g = base_noise(a, row);

  // masks[row + 1] = seg
  uint8_t* dst = a.masks + (row + 1) * a.hw;
  const long long t0 = first_point(), stride = point_stride();
  if (a.hw % 16 == 0 && ((uintptr_t)dst % 16) == 0 && ((uintptr_t)a.seg % 16) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(a.seg);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long k = t0; k < a.hw / 16; k += stride) d4[k] = s4[k];
  } else {
    for (long long k = t0; k < a.hw; k += stride) dst[k] = a.seg[k];
  }

  // prev_in = seg[prow, pcol] (negative indices wrap, as torch's)
  Draw d = no_draw();
  for (int i = (int)t0; i < n; i += (int)stride) {
    long long r = a.pixel[2 * i], c = a.pixel[2 * i + 1];
    if (r < 0) r += a.h;
    if (c < 0) c += a.w;
    const uint8_t in = a.seg[r * a.w + c];
    a.prev_in[i] = in;
    const float p = in ? a.probs[i] : 0.0f;
    a.work[i] = p;
    d.add(g[n + i], p, a.log_w[i], i);
  }
  block_partial(d, a.scratch->parts[0], sh);
}

// Round 2's draw, sampling.round2_keep_mask, round 3's partial draws.
__global__ void __launch_bounds__(kThreads) post_mask2(const BaseArgs a) {
  __shared__ Shared sh;
  Scratch* sc = a.scratch;
  const int n = a.n;
  const float* g = base_noise(a, *a.row);
  load_thresholds(a, sh);
  const int idx1 = *a.idx1;
  const int2 r2 = grid_draw(sc->parts[0], sh);
  const int idx2 = r2.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    sc->idx2 = idx2;
    sc->ok2 = r2.y;
  }
  const float p1x = a.pos[3 * idx1], p1y = a.pos[3 * idx1 + 1], p1z = a.pos[3 * idx1 + 2];
  float v0 = __fsub_rn(a.pos[3 * idx2], p1x), v1 = __fsub_rn(a.pos[3 * idx2 + 1], p1y),
        v2 = __fsub_rn(a.pos[3 * idx2 + 2], p1z);
  float nv = norm3(v0, v1, v2);
  nv = nv < 1e-30f ? 1e-30f : nv;
  v0 = __fdiv_rn(v0, nv); v1 = __fdiv_rn(v1, nv); v2 = __fdiv_rn(v2, nv);
  const float ax = a.pos[3 * idx2], ay = a.pos[3 * idx2 + 1], az = a.pos[3 * idx2 + 2];
  const float nx = a.normal[3 * idx2], ny = a.normal[3 * idx2 + 1],
              nz = a.normal[3 * idx2 + 2];
  const float rad2deg = fbits(0x42652EE1u);
  Draw d = no_draw();
  for (int i = first_point(); i < n; i += point_stride()) {
    float p = a.work[i];
    if (!(p == 0.0f)) {
      float w0 = __fsub_rn(a.pos[3 * i], p1x), w1 = __fsub_rn(a.pos[3 * i + 1], p1y),
            w2 = __fsub_rn(a.pos[3 * i + 2], p1z);
      float nw = norm3(w0, w1, w2);
      nw = nw < 1e-30f ? 1e-30f : nw;
      w0 = __fdiv_rn(w0, nw); w1 = __fdiv_rn(w1, nw); w2 = __fdiv_rn(w2, nw);
      const float cosang = __fadd_rn(__fadd_rn(__fmul_rn(v0, w0), __fmul_rn(v1, w1)),
                                     __fmul_rn(v2, w2));
      float angle = __fmul_rn(fm_acos(clampf(cosang, -1.0f, 1.0f)), rad2deg);
      const float other = __fsub_rn(180.0f, angle);
      // torch.minimum: NaN if either is
      angle = (isnan(angle) || isnan(other)) ? CUDART_NAN_F : fminf(angle, other);
      const bool keep = i != idx2 && !(angle < a.internal_angle_threshold)
                        && pair_exists(a, sh.th, idx2, ax, ay, az, nx, ny, nz, i);
      if (!keep) {
        p = 0.0f;
        a.work[i] = p;
      }
    }
    d.add(g[2 * n + i], p, a.log_w[i], i);
  }
  block_partial(d, sc->parts[1], sh);
}

// Round 3's draw, sampling.round3_keep_mask (the plane through the three
// points by Cramer's rule, sampling._det3's expression, and three
// distances), round 4's draw and the base's output rows; row += 1.
__global__ void __launch_bounds__(kThreads) post_mask3(const BaseArgs a) {
  __shared__ Shared sh;
  Scratch* sc = a.scratch;
  const int n = a.n;
  const long long row = *a.row;
  const float* g = base_noise(a, row);
  load_thresholds(a, sh);
  const int idx1 = *a.idx1, idx2 = sc->idx2;
  const int2 r3 = grid_draw(sc->parts[1], sh);
  const int idx3 = r3.x;
  float m[3][3];
  for (int r = 0; r < 3; ++r) {
    const int id = r == 0 ? idx1 : r == 1 ? idx2 : idx3;
    for (int c = 0; c < 3; ++c) m[r][c] = a.pos[3 * id + c];
  }
  auto det3 = [](const float (&q)[3][3]) {
    float s = __fmul_rn(__fmul_rn(q[0][0], q[1][1]), q[2][2]);
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(q[0][1], q[1][2]), q[2][0]));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(q[0][2], q[1][0]), q[2][1]));
    s = __fsub_rn(s, __fmul_rn(__fmul_rn(q[0][2], q[1][1]), q[2][0]));
    s = __fsub_rn(s, __fmul_rn(__fmul_rn(q[0][0], q[1][2]), q[2][1]));
    return __fsub_rn(s, __fmul_rn(__fmul_rn(q[0][1], q[1][0]), q[2][2]));
  };
  const float denom = det3(m);
  const bool plane = fabsf(denom) > 0.0f;
  const float safe = plane ? denom : 1.0f;
  float abc[3];
  for (int col = 0; col < 3; ++col) {
    float q[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) q[r][c] = c == col ? 1.0f : m[r][c];
    abc[col] = __fdiv_rn(det3(q), safe);
  }
  const float ax = m[2][0], ay = m[2][1], az = m[2][2];
  const float nx = a.normal[3 * idx3], ny = a.normal[3 * idx3 + 1],
              nz = a.normal[3 * idx3 + 2];
  const float md = a.min_distance_base;
  Draw d = no_draw();
  for (int i = first_point(); i < n; i += point_stride()) {
    float p = a.work[i];
    if (!(p == 0.0f)) {
      const float x = a.pos[3 * i], y = a.pos[3 * i + 1], z = a.pos[3 * i + 2];
      float planar = fabsf(__fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(abc[0], x), __fmul_rn(abc[1], y)),
                    __fmul_rn(abc[2], z)), 1.0f));
      planar = plane ? planar : 10000.0f;
      const float d1 = norm3(__fsub_rn(x, m[0][0]), __fsub_rn(y, m[0][1]), __fsub_rn(z, m[0][2]));
      const float d2 = norm3(__fsub_rn(x, m[1][0]), __fsub_rn(y, m[1][1]), __fsub_rn(z, m[1][2]));
      const float d3 = norm3(__fsub_rn(x, m[2][0]), __fsub_rn(y, m[2][1]), __fsub_rn(z, m[2][2]));
      const bool reject = planar > a.plane_threshold || d1 < md || d2 < md || d3 < md
                          || i == idx3
                          || !pair_exists(a, sh.th, idx3, ax, ay, az, nx, ny, nz, i);
      if (reject) p = 0.0f;
    }
    d.add(g[3 * n + i], p, a.log_w[i], i);
  }
  block_partial(d, sc->parts[0], sh);
  if (!last_block(sc, sh)) return;
  const int2 r4 = grid_draw(sc->parts[0], sh);
  if (threadIdx.x == 0) {
    int* out = a.raws + row * 4;
    out[0] = idx1; out[1] = idx2; out[2] = idx3; out[3] = r4.x;
    a.oks[row] = (uint8_t)((*a.ok1 != 0) && sc->ok2 && r3.y && r4.y);
    a.fills[row] = *a.fill_ok;
    *a.row = row + 1;
  }
}

__global__ void fmath_kernel(const float* x, float* out_log, float* out_acos, long long n) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    out_log[t] = fm_log(x[t]);
    out_acos[t] = fm_acos(x[t]);
  }
}

int grid(int n) {
  const int b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : b > kMaxBlocks ? kMaxBlocks : b;
}

}  // namespace

// The bytes of scratch the sampler entry points need (zeroed, once).
extern "C" long long mm_base_rounds_scratch_bytes() { return (long long)sizeof(Scratch); }

extern "C" int mm_base_pre(const void* args, void* stream) {
  const BaseArgs& a = *static_cast<const BaseArgs*>(args);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  pre_round1<<<grid(a.n), kThreads, 0, st>>>(a);
  pre_mask1<<<grid(a.n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mm_base_post(const void* args, void* stream) {
  const BaseArgs& a = *static_cast<const BaseArgs*>(args);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  post_round2<<<grid(a.n), kThreads, 0, st>>>(a);
  post_mask2<<<grid(a.n), kThreads, 0, st>>>(a);
  post_mask3<<<grid(a.n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// The kernel's log and acos on n floats: the test entry point that holds
// them to ops/fmath.py.
extern "C" int mm_base_rounds_fmath(const float* x, float* out_log, float* out_acos,
                                    long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  fmath_kernel<<<(unsigned)blocks, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, out_log, out_acos, n);
  return (int)cudaGetLastError();
}
