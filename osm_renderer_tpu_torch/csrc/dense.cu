// Dense closed-form tile renderer for Hopper (sm_90a): `precision =
// exact` (int64 / f64) and its fast twin (int32 / f32).
//
// Computes what osm_renderer_tpu/ops/render_jnp.py::render_batch (the
// JAX package's jitted device program for precision = exact; it reaches
// no Pallas kernel) computes, byte for byte, in the two phases of the
// port's plain version osm_renderer_tpu_torch/ops/render_dense.py, whose
// functions each device function below transcribes (file:line there):
//
// 1. dense_stroke_alpha: one thread per pixel of every stroke segment's
//    window (BatchPlan.strokes), one launch.  A thread finds its item by
//    binary search in the host's prefix sums of the window areas and
//    evaluates _stroke_segment_alpha (:248, the reference's :158):
//    _stroke_opacity (:213), band_start's two fixed 6-step corrections
//    (:306-317), start_alive (:319) and, with `chain`, the 11-step walk
//    chain (:343).  plan.stroke_passes only bounds the plain version's
//    temporaries; the kernel ignores it.
// 2. dense_fill_alpha: one warp per fill window row (BatchPlan.fills, all
//    edge buckets E in one launch).  The warp evaluates _fill_rows (:391)
//    for the row's E lanes, one lane a thread, compacts the active edges
//    in lane order with a ballot into its own list (shared memory, or a
//    global scratch slice past SMEM_EDGES lanes), ranks them by counting
//    and then runs _fill_pixels (:432) for the row's pixels over the
//    active list only.
// 3. dense_blend_finalize: one CTA per (tile, band of BAND_PX pixels);
//    each thread owns PX pixels' RGBA in registers, so the f64 canvas
//    never lives in device memory.  It walks its tile's groups in paint
//    order (the host's per-tile list sorted by chunk index), skips those
//    whose window misses the band, applies _color_blend (:185) or, for a
//    group with a pattern, _pattern_blend (:193) inside the window, and
//    writes _finalize_rgb (:443) as (T, ts, ts, 3) u8.  BatchPlan.levels
//    only groups blends of disjoint pixels for the plain version; a
//    pixel's blend sequence is the same in paint order, so the kernel
//    does not need them.
//
// Pending alpha.  Both alpha kernels max-reduce into the plan's flat
// pending buffer at pend_off + y * pend_w + x, as scatter_reduce_(...,
// "amax") does, with an integer atomicMax on the float's bits.  pending
// starts at +0.0 (all bits 0).  Every alpha is opacity * fmin(sd_op,
// cd_op) or a fill opacity: never NaN (fmin and fmax drop a NaN operand)
// and never below zero.  For floats >= +0.0 the IEEE bit patterns, read
// as signed integers, order as the floats do, so atomicMax keeps the
// largest.  A -0.0 (sign bit set: a negative integer) never beats +0.0,
// where amax may keep either; the blends give the same bits for both
// zeros (m = -0.0: one_m = 1, fma(c, -0, C) = C).  A +NaN would win as it
// does in amax.  So the buffer holds amax's values in any launch order,
// and alphas of +0.0 are not written at all.
//
// Where the bits are at risk, and what this file does about each:
//
// * The five fused multiply-adds.  The reference's CPU compiler (XLA)
//   contracts a multiply feeding an add into one FMA at exactly these
//   sites, which the plain version emulates with render_dense._fma:
//   the start distance's _sq_diff (:182), both channels of the colour
//   blend (:189-190), the pattern blend (:196-197) and the cap-shrunk
//   half-width (:243).  Each is a real fma()/fmaf() here.  Everything
//   else stays unfused: ops/build.py passes -fmad=false; never use
//   --use_fast_math.
// * _sqrt (:97) must round correctly: f64 sqrt does; f32 sqrtf does under
//   nvcc's default -prec-sqrt=true, and `/` is IEEE under -prec-div=true.
// * Floor division.  torch.div(..., rounding_mode="floor") (:154) floors
//   where C's `/` truncates: floor_div corrects for sign as torch's
//   div_floor_integer does, and ceil_div2 (:171) negates around it.  The
//   fast path keeps the reference's f32 estimate and its four integer
//   corrections (:159-167).  Int64 `/` is a software routine on the GPU,
//   and a chained stroke pixel runs many of them: the first cost of this
//   kernel (see PERF.md).
// * Integer overflow.  Signed overflow is undefined in C++ and wraps in
//   torch.  Under FAST_COORD_BOUND (draw/primitives.py, checked by
//   parallel/renderer.py before a fast batch) and WINDOW_COORD_BOUND
//   (render_dense.py:47) every product of _stroke_segment_alpha and
//   _fill_rows stays in range (fast: |coord| < 12000, so dx*dx + dy*dy <
//   1.2e9 and A = 2*mn_d*n0 + 2*mx_d*m0 + mx_d - 1 < 1.3e9, under 2^31),
//   but past them (geometry the plan evaluates over the whole tile) it
//   does not.  So every integer +, - and * here goes through Wrap<I>,
//   which computes in the unsigned type and wraps as torch does;
//   comparisons and divisions read the signed value.
// * Casts.  .to(fi) of a float truncates as a C cast does; f2i spells out
//   the card's conversion (NaN -> 0, saturation past the range), which
//   is what torch's CUDA .to() does.  Windows come from the plan, which
//   encodes geometry past WINDOW_COORD_BOUND as a whole-tile window; the
//   kernels add no rule of their own.
//
// What bounds it on the H100.  Operations, not bytes: a chained exact
// stroke pixel runs a few hundred int64 divisions and f64 operations
// (the H100's f64 rate outside the tensor cores is half its f32 rate),
// while a batch's inputs are a few MB.  The design keeps the work to what
// the plain version does per pixel and no more: a pixel that is not
// in_line stops after its opacity, the chain stops at its first dead
// step or once jp >= jv, and fill pixels loop over a row's active edges
// only.  Making the divisions cheap is a later PR.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int STROKE_THREADS = 256;
constexpr int FILL_WARPS = 4;                 // warps per fill CTA
constexpr int SMEM_EDGES = 512;               // a warp's active-list capacity in shared memory
constexpr int BLEND_THREADS = 256;
constexpr int PX = 8;                         // pixels per blend thread
constexpr int BAND_PX = BLEND_THREADS * PX;   // pixels per blend CTA
constexpr int JMAX_CHAIN = 12;                // the walk chain checks jp = 1 .. 11

// Pointer slots of the entry points' `ptrs` array (ops/dense_cuda.py
// fills it in this order).
enum {
  P_GEOM, P_TRAV, P_GPROF, P_COLOR, P_OPACITY, P_HW, P_PAT, P_PROFILES, P_PROF_TOTAL,
  P_PATTERNS, P_CANVAS, P_STROKES, P_STROKE_PX, P_FILLS, P_FILL_ROWS, P_GROUPS, P_TILE_PTR,
  P_PENDING, P_OUT, P_SCRATCH, N_PTRS
};
// Size slots of the entry points' `dims` array.
enum {
  D_T, D_G, D_C, D_NP, D_DS, D_NPAT, D_TS, D_NS, D_NPX, D_NF, D_NROWS, D_EMAX, D_NG,
  D_FILL_BLOCKS, N_DIMS
};
// Columns of the packed items (ops/dense_cuda.py: STROKE_COLS, ...).
enum { S_T, S_C, S_SLOT, S_Y0, S_X0, S_H, S_W, S_OFF, S_PW, STROKE_COLS };
enum { F_T, F_C, F_FIRST, F_CNT, F_Y0, F_X0, F_H, F_W, F_OFF, F_PW, F_E, FILL_COLS };
enum { G_T, G_C, G_Y0, G_X0, G_H, G_W, G_BASE, GROUP_COLS };

template <typename I> struct Unsigned;
template <> struct Unsigned<int32_t> { typedef uint32_t type; };
template <> struct Unsigned<int64_t> { typedef uint64_t type; };

// An integer with torch's semantics: +, - and * wrap modulo 2^bits,
// comparisons and divisions read the signed value.
template <typename I>
struct Wrap {
  typedef typename Unsigned<I>::type U;
  I v;
  Wrap() = default;
  __host__ __device__ constexpr Wrap(I x) : v(x) {}
  friend __host__ __device__ Wrap operator+(Wrap a, Wrap b) { return Wrap((I)((U)a.v + (U)b.v)); }
  friend __host__ __device__ Wrap operator-(Wrap a, Wrap b) { return Wrap((I)((U)a.v - (U)b.v)); }
  friend __host__ __device__ Wrap operator*(Wrap a, Wrap b) { return Wrap((I)((U)a.v * (U)b.v)); }
  __host__ __device__ Wrap operator-() const { return Wrap((I)((U)0 - (U)v)); }
  friend __host__ __device__ bool operator<(Wrap a, Wrap b) { return a.v < b.v; }
  friend __host__ __device__ bool operator<=(Wrap a, Wrap b) { return a.v <= b.v; }
  friend __host__ __device__ bool operator>(Wrap a, Wrap b) { return a.v > b.v; }
  friend __host__ __device__ bool operator>=(Wrap a, Wrap b) { return a.v >= b.v; }
  friend __host__ __device__ bool operator==(Wrap a, Wrap b) { return a.v == b.v; }
  friend __host__ __device__ bool operator!=(Wrap a, Wrap b) { return a.v != b.v; }
};

template <typename T> struct Same { typedef T type; };

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

template <typename I>
__host__ __device__ __forceinline__ Wrap<I> wmin(Wrap<I> a, typename Same<Wrap<I>>::type b) {
  return a.v < b.v ? a : b;
}
template <typename I>
__host__ __device__ __forceinline__ Wrap<I> wmax(Wrap<I> a, typename Same<Wrap<I>>::type b) {
  return a.v > b.v ? a : b;
}
template <typename I>
__host__ __device__ __forceinline__ Wrap<I> wabs(Wrap<I> a) { return a.v < 0 ? -a : a; }

// Float -> integer as the card converts (cvt.rzi): truncation, NaN -> 0,
// saturation past the range.
template <typename I, typename F>
__host__ __device__ __forceinline__ I f2i(F f) {
  const F top = (F)(sizeof(I) == 8 ? 9223372036854775808.0 : 2147483648.0);  // 2^63, 2^31
  if (f != f) return 0;
  if (f >= top) return (I)(~(typename Unsigned<I>::type)0 >> 1);
  if (f < -top) return (I)((typename Unsigned<I>::type)1 << (8 * sizeof(I) - 1));
  return (I)f;
}

// Exact floor division (render_dense._floor_div), int64: truncation
// corrected for sign, as torch's div_floor_integer (the divisor is never 0).
__host__ __device__ __forceinline__ Wrap<int64_t> floor_div(Wrap<int64_t> u, Wrap<int64_t> v) {
  int64_t q = u.v / v.v;
  if ((u.v % v.v) != 0 && ((u.v < 0) != (v.v < 0))) --q;
  return Wrap<int64_t>(q);
}

// int32: the reference's f32 estimate and its four integer corrections.
__host__ __device__ __forceinline__ Wrap<int32_t> floor_div(Wrap<int32_t> u, Wrap<int32_t> v) {
  Wrap<int32_t> q = f2i<int32_t>(floorf((float)u.v / (float)v.v));
  Wrap<int32_t> r = u - q * v;
  if (r < 0) q = q - 1;
  r = u - q * v;
  if (r < 0) q = q - 1;
  r = u - q * v;
  if (r >= v) q = q + 1;
  r = u - q * v;
  if (r >= v) q = q + 1;
  return q;
}

template <typename I>
__host__ __device__ __forceinline__ Wrap<I> ceil_div2(Wrap<I> a, Wrap<I> b) {
  return -floor_div(-a, b);
}

template <typename I>
__host__ __device__ __forceinline__ Wrap<I> ceil_div(Wrap<I> a, Wrap<I> b) {
  return floor_div(a + b - 1, b);
}

__host__ __device__ __forceinline__ float xfma(float a, float b, float c) { return fmaf(a, b, c); }
__host__ __device__ __forceinline__ double xfma(double a, double b, double c) {
  return fma(a, b, c);
}
__host__ __device__ __forceinline__ float xsqrt(float a) { return sqrtf(a); }
__host__ __device__ __forceinline__ double xsqrt(double a) { return sqrt(a); }
__host__ __device__ __forceinline__ float xfmax(float a, float b) { return fmaxf(a, b); }
__host__ __device__ __forceinline__ double xfmax(double a, double b) { return fmax(a, b); }
__host__ __device__ __forceinline__ float xfmin(float a, float b) { return fminf(a, b); }
__host__ __device__ __forceinline__ double xfmin(double a, double b) { return fmin(a, b); }
__host__ __device__ __forceinline__ float xfmod(float a, float b) { return fmodf(a, b); }
__host__ __device__ __forceinline__ double xfmod(double a, double b) { return fmod(a, b); }
__host__ __device__ __forceinline__ float xabs(float a) { return fabsf(a); }
__host__ __device__ __forceinline__ double xabs(double a) { return fabs(a); }

// --------------------------------------------------------------------------
// Strokes (render_dense.py:200-383)
// --------------------------------------------------------------------------

// One segment's constants (the per-segment half of _stroke_segment_alpha).
template <typename I, typename F>
struct Seg {
  Wrap<I> p1x, p1y, mn0, mx0, mn_d, mx_d, mn_i, mx_i, numer_const, sdx, sdy, two_mx, K, hK;
  bool swap, degenerate, any_orig;
  F denom, ratio, hw, opacity, prof_total, traveled;
  const F* prof;  // (DS, 8)
  int DS;
};

template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> c_of(const Seg<I, F>& s, Wrap<I> k) {
  return floor_div(2 * k * s.mn_d + s.mx_d - 1, s.two_mx);
}

template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> h_of(const Seg<I, F>& s, Wrap<I> k) {
  return k + floor_div(2 * c_of(s, k) * s.mn_d + s.mx_d - 1, s.two_mx);
}

template <typename I, typename F>
__host__ __device__ Seg<I, F> make_seg(Wrap<I> p1x, Wrap<I> p1y, Wrap<I> p2x, Wrap<I> p2y, F hw,
                                       F opacity, const F* prof, int DS, F prof_total,
                                       F traveled) {
  Seg<I, F> s;
  s.p1x = p1x;
  s.p1y = p1y;
  s.degenerate = p1x == p2x && p1y == p2y;
  Wrap<I> dx = wabs(p2x - p1x), dy = wabs(p2y - p1y);
  s.swap = dx > dy;
  s.mn0 = s.swap ? p1y : p1x;
  s.mx0 = s.swap ? p1x : p1y;
  s.mn_d = s.swap ? dy : dx;
  s.mx_d = wmax(s.swap ? dx : dy, 1);  // degenerate guard (masked out at the end)
  Wrap<I> x_inc = p1x <= p2x ? 1 : -1, y_inc = p1y <= p2y ? 1 : -1;
  s.mn_i = s.swap ? y_inc : x_inc;
  s.mx_i = s.swap ? x_inc : y_inc;
  s.numer_const = p2x * p1y - p2y * p1x;
  s.sdx = p2x - p1x;
  s.sdy = p2y - p1y;
  s.denom = xsqrt((F)(dx * dx + dy * dy).v);
  s.two_mx = 2 * s.mx_d;
  s.K = s.mx_d;
  s.hK = h_of(s, s.K);
  s.ratio = (F)(s.mx_d * s.mx_d).v / (F)(s.mx_d * s.mx_d + s.mn_d * s.mn_d).v;
  s.hw = hw;
  s.opacity = opacity;
  s.prof = prof;
  s.DS = DS;
  s.prof_total = prof_total;
  s.traveled = traveled;
  s.any_orig = false;
  for (int i = 0; i < DS; ++i)
    s.any_orig = s.any_orig || (prof[8 * i] < (F)1e30 && prof[8 * i + 5] > (F)0);
  return s;
}

template <typename F>
__host__ __device__ __forceinline__ F opacity_by_center_distance(F cd, F hlw) {
  F feather_from = xfmax(hlw - (F)0.5, (F)0);
  F feather_to = xfmax(hlw + (F)0.5, (F)1);
  F feather_dist = feather_to - feather_from;
  F opacity_mul = xfmin((F)2 * hlw, (F)1);
  F v = cd < feather_from ? (F)1 : (cd < feather_to ? (feather_to - cd) / feather_dist : (F)0);
  return opacity_mul * v;
}

template <typename F>
struct Opacity {
  F op;
  bool alive;  // in_line: cd_op > 0
};

// _stroke_opacity (render_dense.py:213).
template <typename I, typename F>
__host__ __device__ Opacity<F> stroke_opacity(const Seg<I, F>& s, F cd, F start_dist) {
  const F inf = (F)INFINITY;
  F dist_rem = s.traveled + start_dist;
  F d = s.prof_total > (F)0 ? xfmod(dist_rem, s.prof_total) : dist_rem;
  F sd_op = 0, cap_dist = inf;
  bool any_rows = false;
  for (int i = 0; i < s.DS; ++i) {
    const F* r = s.prof + 8 * i;
    F s_from = r[0], s_to = r[1], e_from = r[2], e_to = r[3];
    F mul = r[4], has_orig = r[5], orig_a = r[6], orig_b = r[7];
    bool in_range = d >= s_from && d <= e_to;
    F base = d <= s_to ? (d - s_from) / (s_to - s_from)
                       : (d < e_from ? (F)1 : (e_to - d) / (e_to - e_from));
    sd_op = xfmax(sd_op, in_range ? mul * base : (F)0);
    F cap_d = d < orig_a ? orig_a - d : (d <= orig_b ? (F)0 : d - orig_b);
    cap_dist = xfmin(cap_dist, (in_range && has_orig > (F)0) ? cap_d : inf);
    any_rows = any_rows || s_from < inf;
  }
  // Empty profile (all rows disabled): plain opacity 1, no cap shrink.
  sd_op = any_rows ? sd_op : (F)1;
  cap_dist = isinf(cap_dist) ? (F)0 : cap_dist;
  F hlw = xsqrt(xfma(-cap_dist, cap_dist, s.hw * s.hw));  // FMA site (:243)
  F cd_op = opacity_by_center_distance(cd, hlw);
  Opacity<F> o;
  o.op = xfmin(sd_op, cd_op);
  o.alive = cd_op > (F)0;
  return o;
}

// The start distance at (x, y) given its centre distance cd.
template <typename I, typename F>
__host__ __device__ __forceinline__ F start_distance(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y,
                                                     F cd) {
  if constexpr (sizeof(F) == 8) {
    // Exact path: the reference's rounding chain (line.rs:120-121).
    F dxp = (F)(x - s.p1x).v, dyp = (F)(y - s.p1y).v;
    F long_d = xsqrt(dxp * dxp + dyp * dyp);
    return xsqrt(xfmax(xfma(long_d, long_d, -(cd * cd)), (F)0));  // FMA site (:182)
  } else {
    Wrap<I> dot = (x - s.p1x) * s.sdx + (y - s.p1y) * s.sdy;
    return xabs((F)dot.v) / s.denom;
  }
}

template <typename I, typename F>
__host__ __device__ bool start_alive(const Seg<I, F>& s, Wrap<I> s_mn, Wrap<I> s_mx) {
  Wrap<I> sx = s.swap ? s_mx : s_mn, sy = s.swap ? s_mn : s_mx;
  Wrap<I> raw = s.numer_const + s.sdy * sx - s.sdx * sy;
  F cd = xabs((F)raw.v) / s.denom;
  return stroke_opacity(s, cd, start_distance(s, sx, sy, cd)).alive;
}

template <typename I>
struct Band {
  Wrap<I> mn, mx, c_sel;
};

template <typename I, typename F>
__host__ __device__ Band<I> band_start(const Seg<I, F>& s, Wrap<I> b) {
  Wrap<I> bc = wmin(wmax(b, 0), s.hK);
  Wrap<I> k = f2i<I>((F)bc.v * s.ratio);
  k = wmin(wmax(k, 0), s.K);
  for (int i = 0; i < 6; ++i)
    if (k > 0 && h_of(s, k) > bc) k = k - 1;
  for (int i = 0; i < 6; ++i)
    if (k < s.K && h_of(s, k + 1) <= bc) k = k + 1;
  bool is_gap = h_of(s, k) != bc;
  Band<I> out;
  out.c_sel = is_gap ? c_of(s, k + 1) : c_of(s, k);
  out.mn = s.mn0 + s.mn_i * out.c_sel;
  out.mx = s.mx0 + s.mx_i * k;
  return out;
}

// The walk chain: every perpendicular pixel before jv must be in-line.
template <typename I, typename F>
__host__ __device__ bool chain_alive(const Seg<I, F>& s, Band<I> b,
                                     typename Same<Wrap<I>>::type mul, Wrap<I> jv) {
  Wrap<I> tcm = 2 * b.c_sel * s.mn_d;
  Wrap<I> G = wmax(ceil_div(tcm - s.mx_d, s.two_mx), 0);
  Wrap<I> e0 = mul * (tcm - s.two_mx * G);
  for (int jp = 1; jp < JMAX_CHAIN; ++jp) {
    if (Wrap<I>(jp) >= jv) break;  // this step and every later one pass
    Wrap<I> Cjp = wmax(ceil_div(e0 + 2 * Wrap<I>(jp) * s.mn_d - s.mx_d, s.two_mx), 0);
    Wrap<I> minor = b.mn + mul * s.mn_i * jp;
    Wrap<I> major = b.mx - mul * s.mx_i * Cjp;
    if (!start_alive(s, minor, major)) return false;
  }
  return true;
}

// _stroke_segment_alpha (render_dense.py:248) at one pixel.
template <typename I, typename F>
__host__ __device__ F stroke_alpha(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y, bool chain) {
  Wrap<I> raw = s.numer_const + s.sdy * x - s.sdx * y;
  F cd = xabs((F)raw.v) / s.denom;
  Opacity<F> o = stroke_opacity(s, cd, start_distance(s, x, y, cd));
  if (!o.alive || s.degenerate) return (F)0;
  Wrap<I> MN = s.swap ? y : x, MX = s.swap ? x : y;
  Wrap<I> n0 = (MN - s.mn0) * s.mn_i, m0 = (MX - s.mx0) * s.mx_i;
  Wrap<I> A = 2 * s.mn_d * n0 + s.two_mx * m0 + (s.mx_d - 1);
  Wrap<I> T = floor_div(A, s.two_mx);
  bool edge_band = A - T * s.two_mx == s.two_mx - 1;
  bool chained = chain && s.any_orig;

  if (A >= 0 && T <= s.hK) {
    Band<I> bt = band_start(s, T);
    if (start_alive(s, bt.mn, bt.mx)) {
      Wrap<I> dn = (MN - bt.mn) * s.mn_i;
      if ((!chained || chain_alive(s, bt, dn >= 0 ? 1 : -1, wabs(dn)))
          && (!edge_band || dn >= 0))
        return s.opacity * o.op;
    }
  }
  if (!edge_band || !(A + 1 >= 0) || !(T + 1 <= s.hK)) return (F)0;
  Band<I> bn = band_start(s, T + 1);
  Wrap<I> dn = (MN - bn.mn) * s.mn_i;
  if (!(dn <= 0) || !start_alive(s, bn.mn, bn.mx)) return (F)0;
  if (chained && !chain_alive(s, bn, -1, -dn)) return (F)0;
  return s.opacity * o.op;
}

// --------------------------------------------------------------------------
// Fills (render_dense.py:391-440)
// --------------------------------------------------------------------------

template <typename I>
struct Crossing {
  Wrap<I> a, b;
  bool active;
};

// _fill_rows' crossing of one edge with `row`; a and b only when active
// (an inactive edge's are never read).
template <typename I>
__host__ __device__ Crossing<I> fill_crossing(Wrap<I> x1, Wrap<I> y1, Wrap<I> x2, Wrap<I> y2,
                                              bool mask, Wrap<I> row) {
  Crossing<I> c;
  c.active = row > wmin(y1, y2) && row <= wmax(y1, y2) && mask;
  c.a = c.b = 0;
  if (!c.active) return c;
  Wrap<I> adx = wabs(x2 - x1), ady = wabs(y2 - y1);
  Wrap<I> sx = x1 < x2 ? 1 : -1;
  Wrap<I> j = wabs(row - y1);
  if (ady > adx) {  // steep
    c.a = c.b = x1 + sx * floor_div(2 * j * adx + ady, wmax(2 * ady, 1));
    return c;
  }
  Wrap<I> ady_nz = wmax(ady, 1);
  Wrap<I> i_min = wmin(wmax(ceil_div2(adx * (2 * j - 1), 2 * ady_nz), 0), adx);
  Wrap<I> i_max = wmin(wmax(ceil_div2(adx * (2 * j + 1), 2 * ady_nz) - 1, 0), adx);
  Wrap<I> lo = x1 + sx * i_min, hi = x1 + sx * i_max;
  c.a = wmin(lo, hi);
  c.b = wmax(lo, hi);
  return c;
}

// The stable argsort rank (render_dense.py:421-426) of active edge i of a
// row's active list (lane order), by counting: the active edges before it
// by (a, lane), plus the inactive lanes, whose sort key is `big`, that
// come before it (all of them when a_i > big, those of a lower lane when
// a_i == big).
template <typename I>
__host__ __device__ int stable_rank(const I* la, const int* lane, int n, int i, int E) {
  const I big = sizeof(I) == 8 ? ((I)1 << 60) : ((I)1 << 30);
  I ai = la[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += la[j] < ai || (la[j] == ai && j < i);
  if (ai > big) rank += E - n;
  else if (ai == big) rank += lane[i] - i;
  return rank;
}

// _fill_pixels (render_dense.py:432) at column x over the active list.
template <typename I>
__host__ __device__ bool fill_filled(const I* la, const I* lb, const int* odd, int n, Wrap<I> x) {
  int N = 0;
  bool tail = false;
  for (int i = 0; i < n; ++i) {
    if (la[i] <= x.v) {
      ++N;
      tail = tail || (odd[i] && x.v <= lb[i]);
    }
  }
  bool parity = (N & 1) == 1 && !(N == n && (n & 1) == 1);
  return parity || tail;
}

// --------------------------------------------------------------------------
// Blends (render_dense.py:185-197, 443)
// --------------------------------------------------------------------------

template <typename F>
__host__ __device__ __forceinline__ void color_blend(F* C, const F* color, F m) {
  F one_m = (F)1 - m;
  for (int ch = 0; ch < 3; ++ch) C[ch] = xfma(color[ch], m, one_m * C[ch]);  // FMA site (:189)
  C[3] = xfma(one_m, C[3], m);                                              // FMA site (:190)
}

template <typename F>
__host__ __device__ __forceinline__ void pattern_blend(F* C, const F* pat, F m) {
  F one_a = xfma(-m, pat[3], (F)1);                                        // FMA site (:196)
  for (int ch = 0; ch < 4; ++ch) C[ch] = xfma(m, pat[ch], one_a * C[ch]);  // FMA site (:197)
}

template <typename F>
__host__ __device__ __forceinline__ void finalize_rgb(const F* C, uint8_t* out) {
  F a = C[3];
  F mul = a == (F)0 ? (F)0 : (F)1 / a;
  for (int ch = 0; ch < 3; ++ch) {
    F v = (F)255 * C[ch] * mul;
    v = v != v ? (F)0 : (v < (F)0 ? (F)0 : (v > (F)255 ? (F)255 : v));
    out[ch] = (uint8_t)(int)v;
  }
}

// --------------------------------------------------------------------------
// Kernels
// --------------------------------------------------------------------------

struct Params {
  const int32_t* geom;      // (T, G, 4)
  const void* trav;         // (T, G) F
  const int32_t* gprof;     // (T, G)
  const void* color;        // (T, C, 3) F
  const void* opacity;      // (T, C) F
  const void* hw;           // (T, C) F
  const int32_t* pat;       // (T, C)
  const void* profiles;     // (NP, DS, 8) F
  const void* prof_total;   // (NP,) F
  const void* patterns;     // (NPat, ts, ts, 4) F
  const void* canvas;       // (3,) F
  const int64_t* strokes;   // (NS, STROKE_COLS)
  const int64_t* stroke_px; // (NS + 1,) window-pixel prefix sums
  const int64_t* fills;     // (NF, FILL_COLS)
  const int64_t* fill_rows; // (NF + 1,) window-row prefix sums
  const int64_t* groups;    // (NG, GROUP_COLS), per tile in paint order
  const int64_t* tile_ptr;  // (T + 1,) each tile's range of groups
  void* pending;            // (pending_size,) F
  uint8_t* out;             // (T, ts, ts, 3)
  void* scratch;            // fill active lists past SMEM_EDGES, or null
  int64_t d[N_DIMS];
};

// The item whose [prefix[i], prefix[i + 1]) holds `idx` (prefix[0] = 0).
__device__ __forceinline__ int64_t find_item(const int64_t* prefix, int64_t n, int64_t idx) {
  int64_t lo = 0, hi = n;  // prefix[lo] <= idx < prefix[hi]
  while (hi - lo > 1) {
    int64_t mid = (lo + hi) >> 1;
    if (prefix[mid] <= idx) lo = mid; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void pending_max(float* p, float v) {
  int bits = __float_as_int(v);
  if (bits > 0) atomicMax(reinterpret_cast<int*>(p), bits);
}

__device__ __forceinline__ void pending_max(double* p, double v) {
  long long bits = __double_as_longlong(v);
  if (bits > 0) atomicMax(reinterpret_cast<long long*>(p), bits);
}

template <typename I, typename F>
__global__ void __launch_bounds__(STROKE_THREADS)
dense_stroke_alpha(const Params p, bool chain) {
  const int64_t G = p.d[D_G], NP = p.d[D_NP], n_px = p.d[D_NPX];
  const F* trav = static_cast<const F*>(p.trav);
  const F* hw = static_cast<const F*>(p.hw);
  const F* opacity = static_cast<const F*>(p.opacity);
  const F* profiles = static_cast<const F*>(p.profiles);
  const F* prof_total = static_cast<const F*>(p.prof_total);
  F* pending = static_cast<F*>(p.pending);
  const int DS = (int)p.d[D_DS];
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n_px;
       idx += (int64_t)gridDim.x * blockDim.x) {
    int64_t item = find_item(p.stroke_px, p.d[D_NS], idx);
    const int64_t* it = p.strokes + item * STROKE_COLS;
    int64_t local = idx - p.stroke_px[item], w = it[S_W];
    int64_t ly = local / w;
    int64_t y = it[S_Y0] + ly, x = it[S_X0] + (local - ly * w);
    int64_t tg = it[S_T] * G + it[S_SLOT], tc = it[S_T] * p.d[D_C] + it[S_C];
    const int32_t* g = p.geom + 4 * tg;
    int64_t pidx = min64(max64(p.gprof[tg], 0), NP - 1);
    Seg<I, F> s = make_seg<I, F>((I)g[0], (I)g[1], (I)g[2], (I)g[3], hw[tc], opacity[tc],
                                 profiles + pidx * DS * 8, DS, prof_total[pidx], trav[tg]);
    F alpha = stroke_alpha(s, Wrap<I>((I)x), Wrap<I>((I)y), chain);
    pending_max(pending + it[S_OFF] + y * it[S_PW] + x, alpha);
  }
}

template <typename I, typename F>
__global__ void __launch_bounds__(32 * FILL_WARPS)
dense_fill_alpha(const Params p) {
  __shared__ I s_a[FILL_WARPS][SMEM_EDGES];
  __shared__ I s_b[FILL_WARPS][SMEM_EDGES];
  __shared__ int s_tag[FILL_WARPS][SMEM_EDGES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t G = p.d[D_G], n_rows = p.d[D_NROWS], e_max = p.d[D_EMAX];
  const F* opacity = static_cast<const F*>(p.opacity);
  F* pending = static_cast<F*>(p.pending);
  const int64_t gwarp = (int64_t)blockIdx.x * FILL_WARPS + warp;
  // A warp's active list: (a, b, tag) in shared memory, or its slice of
  // the global scratch when a bucket is wider than SMEM_EDGES.
  I* la = s_a[warp];
  I* lb = s_b[warp];
  int* tag = s_tag[warp];
  if (p.scratch != nullptr) {
    char* base = static_cast<char*>(p.scratch) + gwarp * e_max * (2 * sizeof(I) + sizeof(int));
    la = reinterpret_cast<I*>(base);
    lb = la + e_max;
    tag = reinterpret_cast<int*>(lb + e_max);
  }
  for (int64_t row = gwarp; row < n_rows; row += (int64_t)gridDim.x * FILL_WARPS) {
    int64_t item = find_item(p.fill_rows, p.d[D_NF], row);
    const int64_t* it = p.fills + item * FILL_COLS;
    const int64_t t = it[F_T], first = it[F_FIRST], cnt = it[F_CNT];
    const int E = (int)it[F_E];
    const int64_t y = it[F_Y0] + (row - p.fill_rows[item]);
    // Compact the active edges in lane order.
    int n = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      int e = e0 + lane;
      Crossing<I> c;
      c.active = false;
      if (e < E) {
        const int32_t* g = p.geom + 4 * (t * G + min64(first + e, G - 1));
        c = fill_crossing<I>((I)g[0], (I)g[1], (I)g[2], (I)g[3], e < cnt, Wrap<I>((I)y));
      }
      unsigned m = __ballot_sync(FULL_MASK, c.active);
      if (c.active) {
        int at = n + __popc(m & ((1u << lane) - 1u));
        la[at] = c.a.v;
        lb[at] = c.b.v;
        tag[at] = e;
      }
      n += __popc(m);
    }
    __syncwarp();
    // Rank parity.  stable_rank reads every a but only its own entry's
    // lane, so each thread may overwrite its own entries' tags.
    for (int i = lane; i < n; i += 32) tag[i] = stable_rank<I>(la, tag, n, i, E) & 1;
    __syncwarp();
    const F fop = opacity[t * p.d[D_C] + it[F_C]];
    const int64_t x0 = it[F_X0], w = it[F_W];
    F* prow = pending + it[F_OFF] + y * it[F_PW];
    for (int64_t x = x0 + lane; x < x0 + w; x += 32)
      if (fill_filled<I>(la, lb, tag, n, Wrap<I>((I)x))) pending_max(prow + x, fop);
    __syncwarp();
  }
}

template <typename F>
__global__ void __launch_bounds__(BLEND_THREADS)
dense_blend_finalize(const Params p) {
  const int64_t t = blockIdx.y, ts = p.d[D_TS], C = p.d[D_C], npat = p.d[D_NPAT];
  const int64_t p0 = (int64_t)blockIdx.x * BAND_PX, npx = ts * ts;
  const int64_t row_lo = p0 / ts, row_hi = (min64(p0 + BAND_PX, npx) - 1) / ts;
  const F* canvas = static_cast<const F*>(p.canvas);
  const F* color = static_cast<const F*>(p.color);
  const F* patterns = static_cast<const F*>(p.patterns);
  const F* pending = static_cast<const F*>(p.pending);
  F acc[PX][4];
  int64_t py[PX], px[PX];
  for (int k = 0; k < PX; ++k) {
    int64_t q = p0 + k * BLEND_THREADS + threadIdx.x;
    py[k] = q < npx ? q / ts : -1;  // -1: past the tile (never in a window)
    px[k] = q < npx ? q - py[k] * ts : -1;
    for (int ch = 0; ch < 3; ++ch) acc[k][ch] = canvas[ch];
    acc[k][3] = (F)1;
  }
  for (int64_t gi = p.tile_ptr[t]; gi < p.tile_ptr[t + 1]; ++gi) {
    const int64_t* g = p.groups + gi * GROUP_COLS;
    const int64_t y0 = g[G_Y0], h = g[G_H];
    if (y0 > row_hi || y0 + h - 1 < row_lo) continue;  // the window misses the band
    const int64_t x0 = g[G_X0], w = g[G_W], base = g[G_BASE], tc = t * C + g[G_C];
    const int32_t pat = p.pat[tc];
    F col[3];
    for (int ch = 0; ch < 3; ++ch) col[ch] = color[3 * tc + ch];
    for (int k = 0; k < PX; ++k) {
      int64_t ly = py[k] - y0, lx = px[k] - x0;
      if (py[k] < 0 || ly < 0 || ly >= h || lx < 0 || lx >= w) continue;
      F m = pending[base + ly * w + lx];
      if (pat >= 0) {
        // fill.rs:36-40: a premultiplied icon sample a pixel, the fill
        // opacity ignored.
        const F* tp = patterns + ((min64(pat, npat - 1) * ts + py[k]) * ts + px[k]) * 4;
        F pv[4] = {tp[0], tp[1], tp[2], tp[3]};
        pattern_blend(acc[k], pv, m);
      } else {
        color_blend(acc[k], col, m);
      }
    }
  }
  for (int k = 0; k < PX; ++k) {
    if (py[k] < 0) continue;
    finalize_rgb(acc[k], p.out + ((t * ts + py[k]) * ts + px[k]) * 3);
  }
}

Params make_params(const void* const* ptrs, const int64_t* dims) {
  Params p;
  p.geom = static_cast<const int32_t*>(ptrs[P_GEOM]);
  p.trav = ptrs[P_TRAV];
  p.gprof = static_cast<const int32_t*>(ptrs[P_GPROF]);
  p.color = ptrs[P_COLOR];
  p.opacity = ptrs[P_OPACITY];
  p.hw = ptrs[P_HW];
  p.pat = static_cast<const int32_t*>(ptrs[P_PAT]);
  p.profiles = ptrs[P_PROFILES];
  p.prof_total = ptrs[P_PROF_TOTAL];
  p.patterns = ptrs[P_PATTERNS];
  p.canvas = ptrs[P_CANVAS];
  p.strokes = static_cast<const int64_t*>(ptrs[P_STROKES]);
  p.stroke_px = static_cast<const int64_t*>(ptrs[P_STROKE_PX]);
  p.fills = static_cast<const int64_t*>(ptrs[P_FILLS]);
  p.fill_rows = static_cast<const int64_t*>(ptrs[P_FILL_ROWS]);
  p.groups = static_cast<const int64_t*>(ptrs[P_GROUPS]);
  p.tile_ptr = static_cast<const int64_t*>(ptrs[P_TILE_PTR]);
  p.pending = const_cast<void*>(ptrs[P_PENDING]);
  p.out = static_cast<uint8_t*>(const_cast<void*>(ptrs[P_OUT]));
  p.scratch = const_cast<void*>(ptrs[P_SCRATCH]);
  for (int i = 0; i < N_DIMS; ++i) p.d[i] = dims[i];
  return p;
}

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` (no synchronisation)
// and returns cudaGetLastError().  exact: 1 for (int64, f64), 0 for
// (int32, f32).

int osmr_dense_stroke_alpha(const void* const* ptrs, const int64_t* dims, int exact, int chain,
                            void* stream) {
  Params p = make_params(ptrs, dims);
  int64_t blocks = (p.d[D_NPX] + STROKE_THREADS - 1) / STROKE_THREADS;
  blocks = blocks < 132 * 64 ? blocks : 132 * 64;
  if (blocks < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact)
    dense_stroke_alpha<int64_t, double><<<(unsigned)blocks, STROKE_THREADS, 0, s>>>(p, chain != 0);
  else
    dense_stroke_alpha<int32_t, float><<<(unsigned)blocks, STROKE_THREADS, 0, s>>>(p, chain != 0);
  return (int)cudaGetLastError();
}

int osmr_dense_fill_alpha(const void* const* ptrs, const int64_t* dims, int exact, void* stream) {
  Params p = make_params(ptrs, dims);
  if (p.d[D_FILL_BLOCKS] < 1 || p.d[D_NROWS] < 1) return 0;
  if (p.d[D_EMAX] > SMEM_EDGES && p.scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (p.d[D_EMAX] <= SMEM_EDGES) p.scratch = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = (unsigned)p.d[D_FILL_BLOCKS];
  if (exact)
    dense_fill_alpha<int64_t, double><<<blocks, 32 * FILL_WARPS, 0, s>>>(p);
  else
    dense_fill_alpha<int32_t, float><<<blocks, 32 * FILL_WARPS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

int osmr_dense_blend_finalize(const void* const* ptrs, const int64_t* dims, int exact,
                              void* stream) {
  Params p = make_params(ptrs, dims);
  const int64_t ts = p.d[D_TS];
  dim3 grid((unsigned)((ts * ts + BAND_PX - 1) / BAND_PX), (unsigned)p.d[D_T]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (exact)
    dense_blend_finalize<double><<<grid, BLEND_THREADS, 0, s>>>(p);
  else
    dense_blend_finalize<float><<<grid, BLEND_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// Constants the host packing shares with this file.
int osmr_dense_constants(int64_t* out) {
  out[0] = N_PTRS;
  out[1] = N_DIMS;
  out[2] = SMEM_EDGES;
  out[3] = FILL_WARPS;
  out[4] = BAND_PX;
  return 0;
}

}  // extern "C"
