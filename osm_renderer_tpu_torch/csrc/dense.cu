// Dense closed-form tile renderer for Hopper (sm_90a): `precision =
// exact` (int64 / f64) and its fast twin (int32 / f32).
//
// Computes what osm_renderer_tpu/ops/render_jnp.py::render_batch (the
// JAX package's jitted device program for precision = exact; it reaches
// no Pallas kernel) computes, byte for byte, in the two phases of the
// port's plain version osm_renderer_tpu_torch/ops/render_dense.py, whose
// functions each device function below transcribes (file:line there):
//
// 1. dense_stroke_alpha: one warp a work unit, a rectangle of at most
//    UNIT_SIDE x UNIT_SIDE pixels of one stroke segment's window
//    (BatchPlan.strokes, cut by ops/dense_cuda.py::pack_plan).  It
//    evaluates _stroke_segment_alpha (:253, the reference's :158):
//    _stroke_opacity (:218), band_start (:311) with its two 6-step
//    corrections, start_alive (:324) and, with `chain`, the 11-step walk
//    chain (:356).  plan.stroke_passes only bounds the plain version's
//    temporaries; the kernel ignores it.
// 2. dense_fill_alpha: one warp a fill unit, at most R rows of one fill
//    item's window (BatchPlan.fills, all edge buckets E in one launch;
//    cut by ops/dense_cuda.py::fill_units).  It evaluates _fill_rows
//    (:429) for the unit's (row, edge) pairs and _fill_pixels (:442) for
//    its pixels.
// 3. dense_blend_finalize: one CTA per (tile, RECT x RECT pixels), one
//    warp per BLEND_ROWS rows of it, each lane one column, the RGBA of
//    its BLEND_ROWS pixels in registers (the f64 canvas never lives in
//    device memory).  It applies _color_blend (:190) or, for a group
//    with a pattern, _pattern_blend (:198) in paint order (the host's
//    per-tile group list sorted by chunk index) and writes
//    _finalize_rgb (:453) as (T, ts, ts, 3) u8.  BatchPlan.levels only
//    groups blends of disjoint pixels for the plain version; a pixel's
//    blend sequence is the same in paint order, so the kernel does not
//    need them.
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
//   the start distance's _sq_diff (:187), both channels of the colour
//   blend (:194-195), the pattern blend (:201-202) and the cap-shrunk
//   half-width (:248).  Each is a real fma()/fmaf() here.  Everything
//   else stays unfused: ops/build.py passes -fmad=false; never use
//   --use_fast_math.
// * _sqrt (:102) must round correctly: f64 sqrt does; f32 sqrtf does
//   under nvcc's default -prec-sqrt=true, and `/` is IEEE under
//   -prec-div=true.
// * Floor division.  torch.div(..., rounding_mode="floor") (:163) floors
//   where C's `/` truncates.  The fast path keeps the reference's f32
//   estimate and its four integer corrections (:164-172), and ceil_div2
//   (:176) negates around it.  The exact path divides through
//   FloorDiv64, a reciprocal made once a divisor (a multiply-high and one
//   correction step), which gives floor division's quotient for every
//   int64 numerator, wrapped values included: once a segment for the
//   stroke rules, whose every division is by the segment's two_mx, and
//   once an edge for the fill, whose divisions of an active row are all
//   by 2 * max(ady, 1) (on such a row ady >= 1, so max(2 * ady, 1), the
//   steep branch's divisor, is the same number).
// * Integer overflow.  Signed overflow is undefined in C++ and wraps in
//   torch.  Under FAST_COORD_BOUND (draw/primitives.py, checked by
//   parallel/renderer.py before a fast batch) and WINDOW_COORD_BOUND
//   (render_dense.py:52) every product of _stroke_segment_alpha and
//   _fill_rows stays in range (fast: |coord| < 12000, so dx*dx + dy*dy <
//   1.2e9 and A = 2*mn_d*n0 + 2*mx_d*m0 + mx_d - 1 < 1.3e9, under 2^31),
//   but past them (geometry the plan evaluates over the whole tile) it
//   does not.  So every integer +, - and * here goes through Wrap<I>,
//   which computes in the unsigned type and wraps as torch does;
//   comparisons and divisions read the signed value.
// * Casts.  .to(fi) of a float truncates as a C cast does; f2i spells out
//   the card's conversion (NaN -> 0, saturation past the range), which
//   is what torch's CUDA .to() does.  Windows come from the plan, which
//   encodes geometry past WINDOW_COORD_BOUND as a whole-tile window.
//
// What bounds each kernel on the H100, and what the design does about it:
//
// * dense_stroke_alpha: operations.  The pixel-level work is the f64
//   centre and start distances and _stroke_opacity (two or three square
//   roots, an fmod and a few divisions a pixel).  The rest of
//   _stroke_segment_alpha depends on the segment and the band index b
//   alone, not on the pixel: band_start(b) (a dozen floor divisions),
//   start_alive(band) and the walk chain's 11 start_alive evaluations.
//   A window has about L x 2W pixels but only about L + W bands, so a
//   kernel that evaluates them a pixel repeats each band's work across
//   the stroke's width.  So each warp takes one unit and
//   (a) builds the segment's constants once (make_seg; every lane holds
//       the same copy);
//   (b) pass 1: evaluates each pixel's centre distance cd, keeps (ballot
//       and prefix, in shared memory) the pixels with cd < lim, where
//       lim = fmax(sqrt(hw * hw) + 0.5, 1) >= feather_to (hlw never
//       exceeds sqrt(hw * hw): the cap shrink only lowers it, and every
//       step rounds monotonically), so every pixel of cd_op > 0 is kept
//       and no dropped pixel has an alpha above 0; and reduces the
//       kept pixels' band coordinate A to its minimum and maximum;
//   (c) the band table: for b in [max(floor(A_min / two_mx), 0),
//       min(floor(A_max / two_mx) + 1, hK)], which holds T and T + 1 of
//       every kept pixel, the lanes compute in parallel, once a band,
//       band_start(b).mn, start_alive(band) and, for a chained segment
//       (chain and a profile row with round caps), the first dead step
//       of the walk for mul = +1 and -1 (band_rule); chain_alive(b, mul,
//       jv) is then exactly "first dead step >= min(jv, 12)";
//   (d) pass 3: the kept pixels only, with every lane busy: cd,
//       start_distance, _stroke_opacity, one division for T, and table
//       lookups for bands T and T + 1 (stroke_alpha_table).
//   The rule for the table: a unit uses it when every coordinate of its
//   segment is under WINDOW_COORD_BOUND and its band range fits NB_CAP.
//   Under the bound nothing wraps, and a unit of h x w pixels spans at
//   most h + w bands (T moves by at most one a pixel step, as mn_d <=
//   mx_d), so NB_CAP = 2 * UNIT_SIDE always fits.  A unit past the bound
//   (the oversize scene) evaluates band_start, start_alive and the walk
//   per pixel (stroke_alpha).  A pixel
//   whose band the table lacks (the rule makes that impossible) falls
//   back to stroke_alpha as well.
// * dense_fill_alpha: bytes on paper (each fill's edges and its window's
//   pending values), latency in practice: the work is small (on bigcity
//   z15 x97, 2.45 M window pixels against ~2 active edges a row, at most
//   4), so what costs is each warp's chain of dependent steps.  So the
//   host cuts each item's window rows into units (ops/dense_cuda.py::
//   fill_units) of at most R rows (fill_unit_rows: the most, up to 32,
//   whose R x E crossings fit FILL_PAIRS with every edge active on every
//   row) and FILL_UNIT_PX pixels, widest bucket first, and each warp
//   takes one unit and
//   (a) reads its unit code, then the item's descriptor, a column a lane,
//       shuffled out to the warp;
//   (b) loads the item's edges once, a lane an edge (min(E, 32) lanes a
//       row, 32 / that rows a step), with their row-independent constants
//       (FillEdge: y range, adx, ady, sx, steep and, in exact precision,
//       the FloorDiv64 reciprocal), and tests the unit's (row, edge)
//       pairs in row-major, edge-minor steps; only active pairs divide;
//   (c) compacts each row's active pairs with a ballot, edge order kept,
//       into the row's own stretch of E entries of the warp's list (at
//       r * E; a count a row), in shared memory, or past FILL_PAIRS (R =
//       1) in a global scratch slice;
//   (d) ranks each active pair within its row by counting (stable_rank,
//       the inactive lanes' `big` key included), a lane a pair;
//   (e) runs _fill_pixels for the unit's pixels row-major, two a lane a
//       round, every lane busy, each over its row's short list (its first
//       four entries read at once), with coalesced pending addresses.
//   A unit is a chain of about four dependent loads (code, descriptor,
//   edges, then the list in shared memory) and a few rounds, where a row
//   of the first design took a binary search over the row prefix sums
//   (about 13 loads) and re-read and re-divided every edge.  The pixel
//   cap keeps the long units short (a whole-tile window, a wide fill);
//   the smaller FILL_PAIRS shortens the wide buckets' units (R = 4 at E =
//   64).  What is left is the warps' issue and latency: the crossings,
//   the ranks and the pixel rounds of ~10,000 units (PERF.md section 6).
// * dense_blend_finalize: bytes (the pending values in, the u8 tiles
//   out), and the latency of a walk over the tile's group descriptors
//   with one dependent load a group, were every thread to make it.
//   Instead each warp copies its tile's descriptors into shared memory 32
//   at a time with coalesced loads, keeps (ballot and prefix, paint
//   order kept) only the groups whose window meets its BLEND_ROWS x
//   RECT pixels, with their colour and pattern, and walks that short
//   list.  Pixel offsets within a window are 32-bit, the group's base
//   64-bit.  Four pixels a lane fit in 64 registers (f64) or 48 (f32),
//   so four or five 256-thread CTAs fit an SM.  The u8 RGB rows go through shared memory
//   and out as 16-byte stores when the tile's rows allow (ts % 32 == 0,
//   an aligned buffer), else one byte at a time with the tile's edge
//   masked.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int STROKE_WARPS = 8;
constexpr int STROKE_THREADS = 32 * STROKE_WARPS;
// Resident CTAs an SM each kernel's register budget is cut for (the
// fastest on the H100 of those tried; a few bytes spill): the f64 stroke
// kernel needs ~170 registers uncut, one CTA.
template <typename F> constexpr int stroke_min_blocks() { return sizeof(F) == 8 ? 2 : 4; }
template <typename F> constexpr int blend_min_blocks() { return sizeof(F) == 8 ? 4 : 5; }
constexpr int UNIT_SIDE = 32;                 // a stroke unit: at most UNIT_SIDE x UNIT_SIDE px
constexpr int NB_CAP = 2 * UNIT_SIDE;         // bands a unit's table holds
constexpr int FILL_WARPS = 4;                 // warps per fill CTA
constexpr int FILL_PAIRS = 256;               // a fill warp's list of crossings in shared memory
constexpr int FILL_MAX_ROWS = 32;             // rows a fill unit holds at most
constexpr int BLEND_WARPS = 8;
constexpr int BLEND_THREADS = 32 * BLEND_WARPS;
constexpr int RECT = 32;                      // a blend CTA's RECT x RECT pixels, a lane a column
constexpr int BLEND_ROWS = RECT / BLEND_WARPS;  // rows a blend warp owns
constexpr int JMAX_CHAIN = 12;                // the walk chain checks jp = 1 .. 11
// render_dense.WINDOW_COORD_BOUND: under it no product of the stroke
// rules wraps (the band table's rule).
constexpr int64_t EXACT_COORD_BOUND = int64_t(1) << 28;
constexpr int64_t FAST_COORD_BOUND = 12000;
// A stroke unit's band table as the kernel writes it for the tests
// (Params.tables): mode, b_lo, bands, lookups it lacked, then NB_CAP
// minor coordinates and NB_CAP rule words.
enum { UNIT_EMPTY = 0, UNIT_TABLE = 1, UNIT_PER_PIXEL = 2 };
constexpr int TABLE_COLS = 4 + 2 * NB_CAP;

// Pointer slots of the entry points' `ptrs` array (ops/dense_cuda.py
// fills it in this order).
enum {
  P_GEOM, P_TRAV, P_GPROF, P_COLOR, P_OPACITY, P_HW, P_PAT, P_PROFILES, P_PROF_TOTAL,
  P_PATTERNS, P_CANVAS, P_STROKES, P_FILLS, P_FILL_UNITS, P_GROUPS, P_TILE_PTR,
  P_PENDING, P_OUT, P_SCRATCH, P_UNITS, P_TABLES, N_PTRS
};
// Size slots of the entry points' `dims` array.
enum {
  D_T, D_G, D_C, D_NP, D_DS, D_NPAT, D_TS, D_NS, D_NF, D_NFU, D_EMAX, D_NG,
  D_FILL_BLOCKS, D_NU, N_DIMS
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
  static __host__ __device__ constexpr Wrap max() { return Wrap((I)(~(U)0 >> 1)); }
  static __host__ __device__ constexpr Wrap min() {
    return Wrap((I)(((U)1) << (8 * sizeof(I) - 1)));
  }
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

// Floor division (render_dense._floor_div), int32: the reference's f32
// estimate and its four integer corrections.
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

__host__ __device__ __forceinline__ Wrap<int32_t> ceil_div2(Wrap<int32_t> a, Wrap<int32_t> b) {
  return -floor_div(-a, b);
}

__host__ __device__ __forceinline__ uint64_t umulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// Floor division by a fixed divisor d > 0, for every int64 numerator n.
// With u = n + 2^63 (the sign bit flipped: 0 <= u < 2^64) and 2^63 =
// a * d + b (0 <= b < d), floor(n / d) = floor(u / d) - a - (r < b),
// where r = u - floor(u / d) * d.  floor(u / d) comes from m =
// floor((2^64 - 1) / d): u * m / 2^64 lies in (u / d - 1, u / d], so
// umulhi(u, m) is floor(u / d) or one less, and one correction step
// (r >= d) finds it.
struct FloorDiv64 {
  uint64_t d, m, a, b;
  FloorDiv64() = default;
  __host__ __device__ explicit FloorDiv64(int64_t divisor) {
    d = (uint64_t)divisor;
    m = ~(uint64_t)0 / d;
    const uint64_t half = (uint64_t)1 << 63;
    a = umulhi64(half, m);
    b = half - a * d;
    if (b >= d) {
      ++a;
      b -= d;
    }
  }
  __host__ __device__ __forceinline__ Wrap<int64_t> operator()(Wrap<int64_t> n) const {
    const uint64_t u = (uint64_t)n.v ^ ((uint64_t)1 << 63);
    uint64_t q = umulhi64(u, m), r = u - q * d;
    if (r >= d) {
      ++q;
      r -= d;
    }
    return Wrap<int64_t>((int64_t)(q - a) - (r < b ? 1 : 0));
  }
};

// Floor division by the segment's two_mx: the reciprocal in the exact
// precision, the reference's estimate (floor_div) in the fast one.
template <typename I> struct MxDiv;
template <>
struct MxDiv<int64_t> {
  FloorDiv64 f;
  MxDiv() = default;
  __host__ __device__ explicit MxDiv(Wrap<int64_t> d) : f(d.v) {}
  __host__ __device__ __forceinline__ Wrap<int64_t> operator()(Wrap<int64_t> n) const {
    return f(n);
  }
};
template <>
struct MxDiv<int32_t> {
  Wrap<int32_t> d;
  MxDiv() = default;
  __host__ __device__ explicit MxDiv(Wrap<int32_t> dv) : d(dv) {}
  __host__ __device__ __forceinline__ Wrap<int32_t> operator()(Wrap<int32_t> n) const {
    return floor_div(n, d);
  }
};

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
// Strokes (render_dense.py:205-388)
// --------------------------------------------------------------------------

// One segment's constants (the per-segment half of _stroke_segment_alpha).
template <typename I, typename F>
struct Seg {
  Wrap<I> p1x, p1y, mn0, mx0, mn_d, mx_d, mn_i, mx_i, numer_const, sdx, sdy, two_mx, K, hK;
  MxDiv<I> div_mx;  // floor division by two_mx
  bool swap, degenerate, any_orig;
  F denom, ratio, hw, opacity, prof_total, traveled;
  const F* prof;  // (DS, 8)
  int DS;
};

template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> c_of(const Seg<I, F>& s, Wrap<I> k) {
  return s.div_mx(2 * k * s.mn_d + s.mx_d - 1);
}

template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> h_of(const Seg<I, F>& s, Wrap<I> k) {
  return k + s.div_mx(2 * c_of(s, k) * s.mn_d + s.mx_d - 1);
}

// ceil(a / two_mx), as the walk chain's ceil_div (:353).
template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> ceil_div_mx(const Seg<I, F>& s, Wrap<I> a) {
  return s.div_mx(a + s.two_mx - 1);
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
  s.div_mx = MxDiv<I>(s.two_mx);
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

// _stroke_opacity (render_dense.py:218).
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
  F hlw = xsqrt(xfma(-cap_dist, cap_dist, s.hw * s.hw));  // FMA site (:248)
  F cd_op = opacity_by_center_distance(cd, hlw);
  Opacity<F> o;
  o.op = xfmin(sd_op, cd_op);
  o.alive = cd_op > (F)0;
  return o;
}

// The distance of (x, y) from the segment's line.
template <typename I, typename F>
__host__ __device__ __forceinline__ F center_distance(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y) {
  Wrap<I> raw = s.numer_const + s.sdy * x - s.sdx * y;
  return xabs((F)raw.v) / s.denom;
}

// A pixel's band coordinate A (:297): T = floor(A / two_mx) is its band.
template <typename I, typename F>
__host__ __device__ __forceinline__ Wrap<I> band_coord(const Seg<I, F>& s, Wrap<I> MN,
                                                       Wrap<I> MX) {
  Wrap<I> n0 = (MN - s.mn0) * s.mn_i, m0 = (MX - s.mx0) * s.mx_i;
  return 2 * s.mn_d * n0 + s.two_mx * m0 + (s.mx_d - 1);
}

// The start distance at (x, y) given its centre distance cd.
template <typename I, typename F>
__host__ __device__ __forceinline__ F start_distance(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y,
                                                     F cd) {
  if constexpr (sizeof(F) == 8) {
    // Exact path: the reference's rounding chain (line.rs:120-121).
    F dxp = (F)(x - s.p1x).v, dyp = (F)(y - s.p1y).v;
    F long_d = xsqrt(dxp * dxp + dyp * dyp);
    return xsqrt(xfmax(xfma(long_d, long_d, -(cd * cd)), (F)0));  // FMA site (:187)
  } else {
    Wrap<I> dot = (x - s.p1x) * s.sdx + (y - s.p1y) * s.sdy;
    return xabs((F)dot.v) / s.denom;
  }
}

template <typename I, typename F>
__host__ __device__ bool start_alive(const Seg<I, F>& s, Wrap<I> s_mn, Wrap<I> s_mx) {
  Wrap<I> sx = s.swap ? s_mx : s_mn, sy = s.swap ? s_mn : s_mx;
  F cd = center_distance(s, sx, sy);
  return stroke_opacity(s, cd, start_distance(s, sx, sy, cd)).alive;
}

template <typename I>
struct Band {
  Wrap<I> mn, mx, c_sel;
};

// band_start (:311).  Each correction loop stops at its first false
// test: k is then unchanged, so the remaining steps would repeat it.
template <typename I, typename F>
__host__ __device__ Band<I> band_start(const Seg<I, F>& s, Wrap<I> b) {
  Wrap<I> bc = wmin(wmax(b, 0), s.hK);
  Wrap<I> k = f2i<I>((F)bc.v * s.ratio);
  k = wmin(wmax(k, 0), s.K);
  for (int i = 0; i < 6 && k > 0 && h_of(s, k) > bc; ++i) k = k - 1;
  for (int i = 0; i < 6 && k < s.K && h_of(s, k + 1) <= bc; ++i) k = k + 1;
  bool is_gap = h_of(s, k) != bc;
  Band<I> out;
  out.c_sel = is_gap ? c_of(s, k + 1) : c_of(s, k);
  out.mn = s.mn0 + s.mn_i * out.c_sel;
  out.mx = s.mx0 + s.mx_i * k;
  return out;
}

// The walk chain (:356): every perpendicular pixel before jv must be
// in-line.
template <typename I, typename F>
__host__ __device__ bool chain_alive(const Seg<I, F>& s, Band<I> b,
                                     typename Same<Wrap<I>>::type mul, Wrap<I> jv) {
  Wrap<I> tcm = 2 * b.c_sel * s.mn_d;
  Wrap<I> G = wmax(ceil_div_mx(s, tcm - s.mx_d), 0);
  Wrap<I> e0 = mul * (tcm - s.two_mx * G);
  for (int jp = 1; jp < JMAX_CHAIN; ++jp) {
    if (Wrap<I>(jp) >= jv) break;  // this step and every later one pass
    Wrap<I> Cjp = wmax(ceil_div_mx(s, e0 + 2 * Wrap<I>(jp) * s.mn_d - s.mx_d), 0);
    Wrap<I> minor = b.mn + mul * s.mn_i * jp;
    Wrap<I> major = b.mx - mul * s.mx_i * Cjp;
    if (!start_alive(s, minor, major)) return false;
  }
  return true;
}

// The walk's first dead step jp in 1 .. 11 for `mul`, JMAX_CHAIN when
// every step is alive: chain_alive(b, mul, jv) is this >= min(jv, 12).
template <typename I, typename F>
__host__ __device__ int first_dead_step(const Seg<I, F>& s, Band<I> b,
                                        typename Same<Wrap<I>>::type mul) {
  Wrap<I> tcm = 2 * b.c_sel * s.mn_d;
  Wrap<I> G = wmax(ceil_div_mx(s, tcm - s.mx_d), 0);
  Wrap<I> e0 = mul * (tcm - s.two_mx * G);
  for (int jp = 1; jp < JMAX_CHAIN; ++jp) {
    Wrap<I> Cjp = wmax(ceil_div_mx(s, e0 + 2 * Wrap<I>(jp) * s.mn_d - s.mx_d), 0);
    Wrap<I> minor = b.mn + mul * s.mn_i * jp;
    Wrap<I> major = b.mx - mul * s.mx_i * Cjp;
    if (!start_alive(s, minor, major)) return jp;
  }
  return JMAX_CHAIN;
}

// One band's rules, as a word: bit 0 start_alive(band); for a chained
// segment and a live band, bits 1-4 and 5-8 the first dead step for mul
// = +1 and -1.  *mn: band_start(b).mn.
template <typename I, typename F>
__host__ __device__ unsigned band_rule(const Seg<I, F>& s, Wrap<I> b, bool chained, Wrap<I>* mn) {
  Band<I> bt = band_start(s, b);
  *mn = bt.mn;
  if (!start_alive(s, bt.mn, bt.mx)) return 0;
  if (!chained) return 1;
  return 1u | (unsigned)first_dead_step(s, bt, 1) << 1 | (unsigned)first_dead_step(s, bt, -1) << 5;
}

// A unit's band table: bands b_lo .. b_lo + nb - 1.
template <typename I>
struct BandTable {
  const I* mn;
  const uint16_t* rule;
  Wrap<I> b_lo;
  int nb;
  // b's row, or -1 when the table lacks it.
  __host__ __device__ int row(Wrap<I> b) const {
    Wrap<I> j = b - b_lo;
    return j >= 0 && j < Wrap<I>((I)nb) ? (int)j.v : -1;
  }
  __host__ __device__ bool alive(int j) const { return rule[j] & 1; }
  // chain_alive(b, mul, jv): mul = +1 when plus.
  __host__ __device__ bool chain_ok(int j, bool plus, Wrap<I> jv) const {
    int dead = (rule[j] >> (plus ? 1 : 5)) & 15;
    return Wrap<I>((I)dead) >= wmin(jv, Wrap<I>((I)JMAX_CHAIN));
  }
};

// _stroke_segment_alpha (render_dense.py:253) at one pixel, the band
// rules evaluated where the pixel needs them.
template <typename I, typename F>
__host__ __device__ F stroke_alpha(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y, bool chain) {
  F cd = center_distance(s, x, y);
  Opacity<F> o = stroke_opacity(s, cd, start_distance(s, x, y, cd));
  if (!o.alive || s.degenerate) return (F)0;
  Wrap<I> MN = s.swap ? y : x;
  Wrap<I> A = band_coord(s, MN, s.swap ? x : y);
  Wrap<I> T = s.div_mx(A);
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

// The same function, the band rules read from the unit's table.  A
// pixel whose band the table lacks runs stroke_alpha (*missed counts it).
template <typename I, typename F>
__host__ __device__ F stroke_alpha_table(const Seg<I, F>& s, Wrap<I> x, Wrap<I> y, bool chain,
                                         const BandTable<I>& tab, int* missed) {
  F cd = center_distance(s, x, y);
  Opacity<F> o = stroke_opacity(s, cd, start_distance(s, x, y, cd));
  if (!o.alive || s.degenerate) return (F)0;
  Wrap<I> MN = s.swap ? y : x;
  Wrap<I> A = band_coord(s, MN, s.swap ? x : y);
  Wrap<I> T = s.div_mx(A);
  bool edge_band = A - T * s.two_mx == s.two_mx - 1;
  bool need_T = A >= 0 && T <= s.hK;
  bool need_N = edge_band && A + 1 >= 0 && T + 1 <= s.hK;
  int jT = tab.row(T), jN = tab.row(T + 1);
  if ((need_T && jT < 0) || (need_N && jN < 0)) {
    ++*missed;
    return stroke_alpha(s, x, y, chain);
  }
  bool chained = chain && s.any_orig;
  if (need_T && tab.alive(jT)) {
    Wrap<I> dn = (MN - Wrap<I>(tab.mn[jT])) * s.mn_i;
    if ((!chained || tab.chain_ok(jT, dn >= 0, wabs(dn))) && (!edge_band || dn >= 0))
      return s.opacity * o.op;
  }
  if (!need_N) return (F)0;
  Wrap<I> dn = (MN - Wrap<I>(tab.mn[jN])) * s.mn_i;
  if (!(dn <= 0) || !tab.alive(jN)) return (F)0;
  if (chained && !tab.chain_ok(jN, false, -dn)) return (F)0;
  return s.opacity * o.op;
}

// --------------------------------------------------------------------------
// Fills (render_dense.py:396-450)
// --------------------------------------------------------------------------

template <typename I>
struct Crossing {
  Wrap<I> a, b;
  bool active;
};

// _fill_crossings' divisions of one edge: floor_div(., max(2 * ady, 1))
// (steep) and ceil_div2(., 2 * max(ady, 1)) (shallow).  Exact: one
// reciprocal, since on an active row ady >= 1 and the two divisors are
// the same number.  Fast: the reference's estimate by each divisor as it
// computes it (its int32 differences may wrap).
template <typename I> struct EdgeDiv;
template <>
struct EdgeDiv<int64_t> {
  FloorDiv64 f;
  EdgeDiv() = default;
  __host__ __device__ explicit EdgeDiv(Wrap<int64_t> ady) : f((2 * wmax(ady, 1)).v) {}
  __host__ __device__ __forceinline__ Wrap<int64_t> floor_steep(Wrap<int64_t> n) const {
    return f(n);
  }
  __host__ __device__ __forceinline__ Wrap<int64_t> ceil_shallow(Wrap<int64_t> n) const {
    return -f(-n);
  }
};
template <>
struct EdgeDiv<int32_t> {
  Wrap<int32_t> steep, shallow;
  EdgeDiv() = default;
  __host__ __device__ explicit EdgeDiv(Wrap<int32_t> ady)
      : steep(wmax(2 * ady, 1)), shallow(2 * wmax(ady, 1)) {}
  __host__ __device__ __forceinline__ Wrap<int32_t> floor_steep(Wrap<int32_t> n) const {
    return floor_div(n, steep);
  }
  __host__ __device__ __forceinline__ Wrap<int32_t> ceil_shallow(Wrap<int32_t> n) const {
    return ceil_div2(n, shallow);
  }
};

// One fill edge's row-independent constants (the per-edge half of
// _fill_crossings, render_dense.py:396).  live: a real edge (its lane is
// under the item's count) whose rows (ytop, ybot] meet the unit's; a
// dead one is never active and builds no divisor.
template <typename I>
struct FillEdge {
  Wrap<I> x1, y1, ytop, ybot, adx, ady;
  EdgeDiv<I> div;
  bool live, steep, neg;  // neg: sx = -1

  __host__ __device__ FillEdge() : live(false) {}
  __host__ __device__ FillEdge(Wrap<I> ex1, Wrap<I> ey1, Wrap<I> x2, Wrap<I> y2, bool real,
                               Wrap<I> row_lo, Wrap<I> row_hi)
      : x1(ex1), y1(ey1), ytop(wmin(ey1, y2)), ybot(wmax(ey1, y2)) {
    live = real && ytop < ybot && ytop < row_hi && ybot >= row_lo;
    adx = wabs(x2 - x1);
    ady = wabs(y2 - y1);
    steep = ady > adx;
    neg = !(x1 < x2);
    if (live) div = EdgeDiv<I>(ady);
  }

  // The crossing with `row`; a and b only when active (an inactive
  // edge's are never read).
  __host__ __device__ Crossing<I> crossing(Wrap<I> row) const {
    Crossing<I> c;
    c.active = live && row > ytop && row <= ybot;
    c.a = c.b = 0;
    if (!c.active) return c;
    const Wrap<I> sx = neg ? -1 : 1;
    const Wrap<I> j = wabs(row - y1);
    if (steep) {
      c.a = c.b = x1 + sx * div.floor_steep(2 * j * adx + ady);
      return c;
    }
    Wrap<I> i_min = wmin(wmax(div.ceil_shallow(adx * (2 * j - 1)), 0), adx);
    Wrap<I> i_max = wmin(wmax(div.ceil_shallow(adx * (2 * j + 1)) - 1, 0), adx);
    Wrap<I> lo = x1 + sx * i_min, hi = x1 + sx * i_max;
    c.a = wmin(lo, hi);
    c.b = wmax(lo, hi);
    return c;
  }
};

// The stable argsort rank (render_dense.py:432-436) of active entry i,
// edge e, of a row's active list (edge order), by counting: the active
// edges before it by (a, edge), plus the inactive lanes, whose sort key
// is `big`, that come before it (all of them when a_i > big, those of a
// lower edge when a_i == big).
template <typename I>
__host__ __device__ int stable_rank(const I* la, int n, int i, int e, int E) {
  const I big = sizeof(I) == 8 ? ((I)1 << 60) : ((I)1 << 30);
  I ai = la[i];
  int rank = 0;
  for (int j = 0; j < n; ++j) rank += la[j] < ai || (la[j] == ai && j < i);
  if (ai > big) rank += E - n;
  else if (ai == big) rank += e - i;
  return rank;
}

// _fill_pixels (render_dense.py:442) at column x over a row's active list.
// A row's stretch holds E >= 4 entries, so its first four are read
// together, unconditionally (one shared-memory latency, not a chain); the
// rest, where a row has more, in a loop.
template <typename I>
__host__ __device__ bool fill_filled(const I* la, const I* lb, const uint16_t* odd, int n,
                                     Wrap<I> x) {
  int N = 0;
  bool tail = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const I a = la[i], b = lb[i];
    const bool o = odd[i] != 0;
    if (i < n && a <= x.v) {
      ++N;
      tail = tail || (o && x.v <= b);
    }
  }
  for (int i = 4; i < n; ++i) {
    if (la[i] <= x.v) {
      ++N;
      tail = tail || (odd[i] && x.v <= lb[i]);
    }
  }
  bool parity = (N & 1) == 1 && !(N == n && (n & 1) == 1);
  return parity || tail;
}

// Rows a fill unit of bucket E holds (dense_cuda.fill_unit_rows): the
// most, up to FILL_MAX_ROWS, whose R x E crossings fit FILL_PAIRS with
// every edge active on every row; past FILL_PAIRS, one row, the list in
// global scratch.
__host__ __device__ __forceinline__ int fill_unit_rows(int64_t E) {
  return E > FILL_PAIRS ? 1 : (int)min64(FILL_MAX_ROWS, FILL_PAIRS / E);
}

// --------------------------------------------------------------------------
// Blends (render_dense.py:190-202, 453)
// --------------------------------------------------------------------------

template <typename F>
__host__ __device__ __forceinline__ void color_blend(F* C, const F* color, F m) {
  F one_m = (F)1 - m;
  for (int ch = 0; ch < 3; ++ch) C[ch] = xfma(color[ch], m, one_m * C[ch]);  // FMA site (:194)
  C[3] = xfma(one_m, C[3], m);                                              // FMA site (:195)
}

template <typename F>
__host__ __device__ __forceinline__ void pattern_blend(F* C, const F* pat, F m) {
  F one_a = xfma(-m, pat[3], (F)1);                                        // FMA site (:201)
  for (int ch = 0; ch < 4; ++ch) C[ch] = xfma(m, pat[ch], one_a * C[ch]);  // FMA site (:202)
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
  const int64_t* fills;     // (NF, FILL_COLS)
  const int64_t* fill_units; // (NFU,) fill units: item << 32 | first row << 8 | rows
  const int64_t* groups;    // (NG, GROUP_COLS), per tile in paint order
  const int64_t* tile_ptr;  // (T + 1,) each tile's range of groups
  void* pending;            // (pending_size,) F
  uint8_t* out;             // (T, ts, ts, 3)
  void* scratch;            // fill lists of units past FILL_PAIRS, or null
  const int64_t* units;     // (NU,) stroke units: item << 32 | row << 16 | column
  int64_t* tables;          // (NU, TABLE_COLS) band tables written for the tests, or null
  int64_t d[N_DIMS];
};

__device__ __forceinline__ void pending_max(float* p, float v) {
  int bits = __float_as_int(v);
  if (bits > 0) atomicMax(reinterpret_cast<int*>(p), bits);
}

__device__ __forceinline__ void pending_max(double* p, double v) {
  long long bits = __double_as_longlong(v);
  if (bits > 0) atomicMax(reinterpret_cast<long long*>(p), bits);
}

// A stroke work unit (Params.units[u]): its item, its pixels (rows ya ..
// ya + nh - 1, columns xa .. xa + nw - 1), its segment's constants, and
// whether every coordinate of the segment is under WINDOW_COORD_BOUND.
template <typename I, typename F>
struct Unit {
  const int64_t* it;
  int nh, nw;
  int64_t ya, xa;
  bool in_bound;
  Seg<I, F> s;
};

template <typename I, typename F>
__host__ __device__ Unit<I, F> load_unit(const Params& p, int64_t u) {
  const int64_t code = p.units[u];
  Unit<I, F> un;
  un.it = p.strokes + (code >> 32) * STROKE_COLS;
  const int64_t* it = un.it;
  const int uy = (int)((code >> 16) & 0xFFFF), ux = (int)(code & 0xFFFF);
  un.nh = (int)min64(UNIT_SIDE, it[S_H] - uy);
  un.nw = (int)min64(UNIT_SIDE, it[S_W] - ux);
  un.ya = it[S_Y0] + uy;
  un.xa = it[S_X0] + ux;
  const int64_t G = p.d[D_G], NP = p.d[D_NP], DS = p.d[D_DS];
  const int64_t tg = it[S_T] * G + it[S_SLOT], tc = it[S_T] * p.d[D_C] + it[S_C];
  const int32_t* g = p.geom + 4 * tg;
  const int64_t pidx = min64(max64(p.gprof[tg], 0), NP - 1);
  const int64_t bound = sizeof(I) == 8 ? EXACT_COORD_BOUND : FAST_COORD_BOUND;
  un.in_bound = true;
  for (int i = 0; i < 4; ++i)
    un.in_bound = un.in_bound && (g[i] < 0 ? -(int64_t)g[i] : g[i]) < bound;
  un.s = make_seg<I, F>((I)g[0], (I)g[1], (I)g[2], (I)g[3], static_cast<const F*>(p.hw)[tc],
                        static_cast<const F*>(p.opacity)[tc],
                        static_cast<const F*>(p.profiles) + pidx * DS * 8, (int)DS,
                        static_cast<const F*>(p.prof_total)[pidx],
                        static_cast<const F*>(p.trav)[tg]);
  return un;
}

template <typename I, typename F>
__global__ void __launch_bounds__(STROKE_THREADS, stroke_min_blocks<F>())
dense_stroke_alpha(const Params p, bool chain) {
  __shared__ uint16_t s_px[STROKE_WARPS][UNIT_SIDE * UNIT_SIDE];  // kept pixels: row * 32 + col
  __shared__ I s_mn[STROKE_WARPS][NB_CAP];
  __shared__ uint16_t s_rule[STROKE_WARPS][NB_CAP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  F* pending = static_cast<F*>(p.pending);
  for (int64_t u = (int64_t)blockIdx.x * STROKE_WARPS + warp; u < p.d[D_NU];
       u += (int64_t)gridDim.x * STROKE_WARPS) {
    const Unit<I, F> un = load_unit<I, F>(p, u);
    const Seg<I, F>& s = un.s;
    const int nh = un.nh, nw = un.nw;
    const int64_t ya = un.ya, xa = un.xa;
    int64_t* rec = p.tables == nullptr ? nullptr : p.tables + u * TABLE_COLS;

    // Pass 1: keep the pixels that can be in line; A's range over them.
    const F lim = xfmax(xsqrt(s.hw * s.hw) + (F)0.5, (F)1);
    int n_in = 0;
    Wrap<I> a_lo = Wrap<I>::max(), a_hi = Wrap<I>::min();
    for (int k0 = 0; k0 < nh * nw; k0 += 32) {
      const int k = k0 + lane;
      bool in = false;
      int ly = 0, lx = 0;
      if (k < nh * nw) {
        ly = k / nw;
        lx = k - ly * nw;
        const Wrap<I> x = (I)(xa + lx), y = (I)(ya + ly);
        in = center_distance(s, x, y) < lim;
        if (in) {
          const Wrap<I> A = band_coord(s, s.swap ? y : x, s.swap ? x : y);
          a_lo = wmin(a_lo, A);
          a_hi = wmax(a_hi, A);
        }
      }
      const unsigned m = __ballot_sync(FULL_MASK, in);
      if (in) s_px[warp][n_in + __popc(m & below)] = (uint16_t)(ly * UNIT_SIDE + lx);
      n_in += __popc(m);
    }
    if (n_in == 0) {
      if (rec != nullptr && lane == 0) rec[0] = UNIT_EMPTY;
      __syncwarp();
      continue;
    }
    for (int o = 16; o > 0; o >>= 1) {
      a_lo = wmin(a_lo, Wrap<I>(__shfl_xor_sync(FULL_MASK, a_lo.v, o)));
      a_hi = wmax(a_hi, Wrap<I>(__shfl_xor_sync(FULL_MASK, a_hi.v, o)));
    }

    // The band table, or the per-pixel rules (see the header).
    const Wrap<I> b_lo = wmax(s.div_mx(a_lo), 0);
    const Wrap<I> b_hi = wmin(s.div_mx(a_hi) + 1, s.hK);
    const int64_t nb64 = b_hi < b_lo ? 0 : (int64_t)b_hi.v - (int64_t)b_lo.v + 1;
    const bool table = un.in_bound && nb64 <= NB_CAP;
    const bool chained = chain && s.any_orig;
    const int nb = table ? (int)nb64 : 0;
    for (int j = lane; j < nb; j += 32) {
      Wrap<I> mn;
      s_rule[warp][j] = (uint16_t)band_rule(s, b_lo + Wrap<I>((I)j), chained, &mn);
      s_mn[warp][j] = mn.v;
    }
    __syncwarp();
    if (rec != nullptr) {
      if (lane == 0) {
        rec[0] = table ? UNIT_TABLE : UNIT_PER_PIXEL;
        rec[1] = b_lo.v;
        rec[2] = nb;
      }
      for (int j = lane; j < nb; j += 32) {
        rec[4 + j] = s_mn[warp][j];
        rec[4 + NB_CAP + j] = s_rule[warp][j];
      }
    }

    // Pass 3: the kept pixels, every lane busy.
    const BandTable<I> tab = {s_mn[warp], s_rule[warp], b_lo, nb};
    int missed = 0;
    for (int i = lane; i < n_in; i += 32) {
      const int q = s_px[warp][i];
      const int64_t y = ya + q / UNIT_SIDE, x = xa + q % UNIT_SIDE;
      const F alpha = table ? stroke_alpha_table(s, Wrap<I>((I)x), Wrap<I>((I)y), chain, tab,
                                                 &missed)
                            : stroke_alpha(s, Wrap<I>((I)x), Wrap<I>((I)y), chain);
      pending_max(pending + un.it[S_OFF] + y * un.it[S_PW] + x, alpha);
    }
    if (rec != nullptr && missed)
      atomicAdd(reinterpret_cast<unsigned long long*>(rec + 3), (unsigned long long)missed);
    __syncwarp();
  }
}

template <typename I, typename F>
__global__ void __launch_bounds__(32 * FILL_WARPS)
dense_fill_alpha(const Params p) {
  __shared__ I s_a[FILL_WARPS][FILL_PAIRS];
  __shared__ I s_b[FILL_WARPS][FILL_PAIRS];
  __shared__ uint16_t s_tag[FILL_WARPS][FILL_PAIRS];
  __shared__ int s_n[FILL_WARPS][FILL_MAX_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t G = p.d[D_G], e_max = p.d[D_EMAX];
  const int32_t* geom = p.geom;
  const F* opacity = static_cast<const F*>(p.opacity);
  F* pending = static_cast<F*>(p.pending);
  const int64_t gwarp = (int64_t)blockIdx.x * FILL_WARPS + warp;
  int* n_row = s_n[warp];
  for (int64_t u = gwarp; u < p.d[D_NFU]; u += (int64_t)gridDim.x * FILL_WARPS) {
    // (a) The unit, then its item's descriptor, a column a lane.
    const int64_t code = p.fill_units[u];
    const int64_t col = lane < FILL_COLS ? p.fills[(code >> 32) * FILL_COLS + lane] : 0;
    const int64_t t = __shfl_sync(FULL_MASK, col, F_T);
    const int64_t first = __shfl_sync(FULL_MASK, col, F_FIRST);
    const int64_t cnt = __shfl_sync(FULL_MASK, col, F_CNT);
    const int64_t w = __shfl_sync(FULL_MASK, col, F_W);
    const int64_t x0 = __shfl_sync(FULL_MASK, col, F_X0);
    const int E = (int)__shfl_sync(FULL_MASK, col, F_E);
    const int r0 = (int)((code >> 8) & 0xFFFFFF);
    const int nr = (int)min64(code & 0xFF, fill_unit_rows(E));  // the host's, within the list
    const int64_t ya = __shfl_sync(FULL_MASK, col, F_Y0) + r0;
    const int64_t pw = __shfl_sync(FULL_MASK, col, F_PW);
    F* prow = pending + __shfl_sync(FULL_MASK, col, F_OFF) + ya * pw;  // the unit's first row
    const F fop = opacity[t * p.d[D_C] + __shfl_sync(FULL_MASK, col, F_C)];
    // The unit's list: a stretch of E entries a row, at r * E.
    I* la = s_a[warp];
    I* lb = s_b[warp];
    uint16_t* tag = s_tag[warp];
    if (E > FILL_PAIRS) {
      char* base = static_cast<char*>(p.scratch) + gwarp * e_max * (2 * sizeof(I) + 2);
      la = reinterpret_cast<I*>(base);
      lb = la + e_max;
      tag = reinterpret_cast<uint16_t*>(lb + e_max);
    }
    if (lane < nr) n_row[lane] = 0;
    __syncwarp();

    // (b), (c) The (row, edge) pairs: epc edges a row, rps rows a step;
    // a lane keeps one edge over the unit's rows.
    const int epc = E < 32 ? E : 32, rps = 32 / epc;
    const int rl = lane / epc, el = lane - rl * epc;
    const unsigned seg = epc == 32 ? FULL_MASK : ((1u << epc) - 1u) << (rl * epc);
    const int64_t live = min64(cnt, E);
    const Wrap<I> row_lo = (I)ya, row_hi = (I)(ya + nr - 1);
    for (int64_t e0 = 0; e0 < live; e0 += epc) {
      const int64_t e = e0 + el;
      FillEdge<I> ed;
      if (e < live) {
        const int32_t* g = geom + 4 * (t * G + min64(first + e, G - 1));
        ed = FillEdge<I>((I)g[0], (I)g[1], (I)g[2], (I)g[3], true, row_lo, row_hi);
      }
      for (int rb = 0; rb < nr; rb += rps) {
        const int r = rb + rl;
        Crossing<I> c;
        c.active = false;
        if (r < nr) c = ed.crossing(Wrap<I>((I)(ya + r)));
        const unsigned m = __ballot_sync(FULL_MASK, c.active);
        if (m == 0) continue;
        const unsigned mine = m & seg;
        if (c.active) {
          const int at = r * E + n_row[r] + __popc(mine & below);
          la[at] = c.a.v;
          lb[at] = c.b.v;
          tag[at] = (uint16_t)e;
        }
        __syncwarp();
        if (el == 0 && r < nr) n_row[r] += __popc(mine);
        __syncwarp();
      }
    }

    // (d) Rank parity, a lane an active pair.  stable_rank reads every a
    // of its row but only its own entry's edge, so each thread may
    // overwrite its own entries' tags.
    for (int k = lane; k < nr * E; k += 32) {
      const int r = (int)((unsigned)k / (unsigned)E), i = k - r * E;
      const int n = n_row[r];
      if (i < n) tag[k] = (uint16_t)(stable_rank<I>(la + r * E, n, i, tag[k], E) & 1);
    }
    __syncwarp();

    // (e) The unit's pixels, row-major, two a lane a round: (r, lx) and
    // the pixel 32 after it, (r2, lx2).
    const unsigned wu = (unsigned)w, dr = 32 / wu, dx = 32 - dr * wu;
    const unsigned nru = (unsigned)nr;
    auto advance = [&](unsigned& rr, unsigned& xx) {
      rr += dr;
      xx += dx;
      if (xx >= wu) {
        xx -= wu;
        ++rr;
      }
    };
    unsigned r = lane / wu, lx = lane - r * wu;
    while (r < nru) {
      unsigned r2 = r, lx2 = lx;
      advance(r2, lx2);
      const bool f1 = fill_filled<I>(la + r * E, lb + r * E, tag + r * E, n_row[r],
                                     Wrap<I>((I)(x0 + lx)));
      const bool f2 = r2 < nru && fill_filled<I>(la + r2 * E, lb + r2 * E, tag + r2 * E,
                                                 n_row[r2], Wrap<I>((I)(x0 + lx2)));
      if (f1) pending_max(prow + r * pw + x0 + lx, fop);
      if (f2) pending_max(prow + r2 * pw + x0 + lx2, fop);
      r = r2;
      lx = lx2;
      advance(r, lx);
    }
    __syncwarp();
  }
}

// A group the blend warp meets: its window (tile pixels), pending base,
// colour and pattern (-1: none, else the clamped index).
template <typename F>
struct BlendGroup {
  int32_t y0, x0, h, w, pat;
  int64_t base;
  F color[3];
};

template <typename F>
__global__ void __launch_bounds__(BLEND_THREADS, blend_min_blocks<F>())
dense_blend_finalize(const Params p) {
  __shared__ int64_t s_desc[BLEND_WARPS][32 * GROUP_COLS];
  __shared__ BlendGroup<F> s_hit[BLEND_WARPS][32];
  __shared__ uint4 s_rgb[BLEND_WARPS][BLEND_ROWS * RECT * 3 / 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int ts = (int)p.d[D_TS], rects_x = (ts + RECT - 1) / RECT;
  const int64_t t = blockIdx.y, C = p.d[D_C], npat = p.d[D_NPAT];
  const int ylo = (int)(blockIdx.x / rects_x) * RECT + warp * BLEND_ROWS;
  const int xlo = (int)(blockIdx.x % rects_x) * RECT;
  if (ylo >= ts) return;  // the whole warp: past the tile's last row
  const int yhi = (int)min64(ylo + BLEND_ROWS, ts) - 1, xhi = (int)min64(xlo + RECT, ts) - 1;
  const int x = xlo + lane;
  const F* canvas = static_cast<const F*>(p.canvas);
  const F* color = static_cast<const F*>(p.color);
  const F* patterns = static_cast<const F*>(p.patterns);
  const F* pending = static_cast<const F*>(p.pending);
  F acc[BLEND_ROWS][4];
#pragma unroll
  for (int r = 0; r < BLEND_ROWS; ++r) {
    for (int ch = 0; ch < 3; ++ch) acc[r][ch] = canvas[ch];
    acc[r][3] = (F)1;
  }
  const int64_t g_end = p.tile_ptr[t + 1];
  for (int64_t g0 = p.tile_ptr[t]; g0 < g_end; g0 += 32) {
    // 32 descriptors in paint order, copied with coalesced loads.
    const int n = (int)min64(32, g_end - g0);
    const int64_t* src = p.groups + g0 * GROUP_COLS;
    for (int i = lane; i < n * GROUP_COLS; i += 32) s_desc[warp][i] = src[i];
    __syncwarp();
    const int64_t* gd = s_desc[warp] + lane * GROUP_COLS;
    const bool hit = lane < n && gd[G_Y0] <= yhi && gd[G_Y0] + gd[G_H] - 1 >= ylo
                     && gd[G_X0] <= xhi && gd[G_X0] + gd[G_W] - 1 >= xlo;
    const unsigned m = __ballot_sync(FULL_MASK, hit);
    if (hit) {
      BlendGroup<F>& e = s_hit[warp][__popc(m & below)];
      const int64_t tc = t * C + gd[G_C];
      const int32_t pat = p.pat[tc];
      e.y0 = (int32_t)gd[G_Y0];
      e.x0 = (int32_t)gd[G_X0];
      e.h = (int32_t)gd[G_H];
      e.w = (int32_t)gd[G_W];
      e.pat = pat < 0 ? -1 : (int32_t)min64(pat, npat - 1);
      e.base = gd[G_BASE];
      for (int ch = 0; ch < 3; ++ch) e.color[ch] = color[3 * tc + ch];
    }
    __syncwarp();
    const int hits = __popc(m);
    for (int k = 0; k < hits; ++k) {
      const BlendGroup<F>& e = s_hit[warp][k];
      const int lx = x - e.x0;
      if (x > xhi || lx < 0 || lx >= e.w) continue;
#pragma unroll
      for (int r = 0; r < BLEND_ROWS; ++r) {
        const int y = ylo + r, ly = y - e.y0;
        if (y > yhi || ly < 0 || ly >= e.h) continue;
        const F mv = pending[e.base + (ly * e.w + lx)];
        if (e.pat >= 0) {
          // fill.rs:36-40: a premultiplied icon sample a pixel, the fill
          // opacity ignored.
          const F* tp = patterns + ((int64_t)e.pat * ts * ts + (y * ts + x)) * 4;
          F pv[4] = {tp[0], tp[1], tp[2], tp[3]};
          pattern_blend(acc[r], pv, mv);
        } else {
          color_blend(acc[r], e.color, mv);
        }
      }
    }
    __syncwarp();
  }
  // The warp's rows as u8 RGB in shared memory, then out.
  uint8_t* rgb = reinterpret_cast<uint8_t*>(s_rgb[warp]);
#pragma unroll
  for (int r = 0; r < BLEND_ROWS; ++r) finalize_rgb(acc[r], rgb + (r * RECT + lane) * 3);
  __syncwarp();
  uint8_t* out = p.out + ((t * ts + ylo) * ts + xlo) * 3;
  if (ts % RECT == 0 && (reinterpret_cast<uintptr_t>(p.out) & 15) == 0) {
    constexpr int per_row = RECT * 3 / 16;  // 16-byte words a row
    for (int i = lane; i < BLEND_ROWS * per_row; i += 32) {
      const int r = i / per_row;
      reinterpret_cast<uint4*>(out + (int64_t)r * ts * 3)[i - r * per_row] = s_rgb[warp][i];
    }
  } else {
    for (int i = lane; i < BLEND_ROWS * RECT * 3; i += 32) {
      const int r = i / (RECT * 3), c = i - r * RECT * 3;
      if (ylo + r <= yhi && xlo + c / 3 <= xhi) out[(int64_t)r * ts * 3 + c] = rgb[i];
    }
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
  p.fills = static_cast<const int64_t*>(ptrs[P_FILLS]);
  p.fill_units = static_cast<const int64_t*>(ptrs[P_FILL_UNITS]);
  p.groups = static_cast<const int64_t*>(ptrs[P_GROUPS]);
  p.tile_ptr = static_cast<const int64_t*>(ptrs[P_TILE_PTR]);
  p.pending = const_cast<void*>(ptrs[P_PENDING]);
  p.out = static_cast<uint8_t*>(const_cast<void*>(ptrs[P_OUT]));
  p.scratch = const_cast<void*>(ptrs[P_SCRATCH]);
  p.units = static_cast<const int64_t*>(ptrs[P_UNITS]);
  p.tables = static_cast<int64_t*>(const_cast<void*>(ptrs[P_TABLES]));
  for (int i = 0; i < N_DIMS; ++i) p.d[i] = dims[i];
  return p;
}

template <typename K>
int kernel_attrs(K kernel, int threads, int64_t* out) {
  cudaFuncAttributes a;
  int rc = (int)cudaFuncGetAttributes(&a, kernel);
  if (rc != 0) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, 0);
  out[0] = a.numRegs;
  out[1] = (int64_t)a.localSizeBytes;
  out[2] = (int64_t)a.sharedSizeBytes;
  out[3] = blocks;
  return rc;
}

// Records `event` (a CUDA timing event of the caller's, or null) on `s`.
void stamp(void* event, cudaStream_t s) {
  if (event != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(event), s);
}

}  // namespace

extern "C" {

// Each entry point launches its kernel on `stream` (no synchronisation)
// and returns cudaGetLastError().  exact: 1 for (int64, f64), 0 for
// (int32, f32).  t_start, t_end: CUDA timing events recorded just before
// and just after the launch (neither when nothing launches), or null, so
// a pair holds the launch's device time and no host code.

int osmr_dense_stroke_alpha(const void* const* ptrs, const int64_t* dims, int exact, int chain,
                            void* stream, void* t_start, void* t_end) {
  Params p = make_params(ptrs, dims);
  int64_t blocks = (p.d[D_NU] + STROKE_WARPS - 1) / STROKE_WARPS;
  blocks = blocks < (1 << 30) ? blocks : (1 << 30);  // the warps stride over the rest
  if (blocks < 1) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stamp(t_start, s);
  if (exact)
    dense_stroke_alpha<int64_t, double><<<(unsigned)blocks, STROKE_THREADS, 0, s>>>(p, chain != 0);
  else
    dense_stroke_alpha<int32_t, float><<<(unsigned)blocks, STROKE_THREADS, 0, s>>>(p, chain != 0);
  const cudaError_t err = cudaGetLastError();
  stamp(t_end, s);
  return (int)err;
}

int osmr_dense_fill_alpha(const void* const* ptrs, const int64_t* dims, int exact, void* stream,
                          void* t_start, void* t_end) {
  Params p = make_params(ptrs, dims);
  if (p.d[D_FILL_BLOCKS] < 1 || p.d[D_NFU] < 1) return 0;
  if (p.d[D_EMAX] > FILL_PAIRS && p.scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (p.d[D_EMAX] <= FILL_PAIRS) p.scratch = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned blocks = (unsigned)p.d[D_FILL_BLOCKS];
  stamp(t_start, s);
  if (exact)
    dense_fill_alpha<int64_t, double><<<blocks, 32 * FILL_WARPS, 0, s>>>(p);
  else
    dense_fill_alpha<int32_t, float><<<blocks, 32 * FILL_WARPS, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  stamp(t_end, s);
  return (int)err;
}

int osmr_dense_blend_finalize(const void* const* ptrs, const int64_t* dims, int exact,
                              void* stream, void* t_start, void* t_end) {
  Params p = make_params(ptrs, dims);
  const int64_t rects = (p.d[D_TS] + RECT - 1) / RECT;
  dim3 grid((unsigned)(rects * rects), (unsigned)p.d[D_T]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stamp(t_start, s);
  if (exact)
    dense_blend_finalize<double><<<grid, BLEND_THREADS, 0, s>>>(p);
  else
    dense_blend_finalize<float><<<grid, BLEND_THREADS, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  stamp(t_end, s);
  return (int)err;
}

// Each kernel's registers a thread, local (spill) bytes, static shared
// bytes and resident CTAs an SM, four int64 a kernel in KERNELS' order
// (stroke, fill, blend), for one precision.
int osmr_dense_kernel_attrs(int exact, int64_t* out) {
  int rc = 0;
  if (exact) {
    rc = rc ? rc : kernel_attrs(dense_stroke_alpha<int64_t, double>, STROKE_THREADS, out);
    rc = rc ? rc : kernel_attrs(dense_fill_alpha<int64_t, double>, 32 * FILL_WARPS, out + 4);
    rc = rc ? rc : kernel_attrs(dense_blend_finalize<double>, BLEND_THREADS, out + 8);
  } else {
    rc = rc ? rc : kernel_attrs(dense_stroke_alpha<int32_t, float>, STROKE_THREADS, out);
    rc = rc ? rc : kernel_attrs(dense_fill_alpha<int32_t, float>, 32 * FILL_WARPS, out + 4);
    rc = rc ? rc : kernel_attrs(dense_blend_finalize<float>, BLEND_THREADS, out + 8);
  }
  return rc;
}

// Constants the host packing shares with this file.
int osmr_dense_constants(int64_t* out) {
  out[0] = N_PTRS;
  out[1] = N_DIMS;
  out[2] = FILL_PAIRS;
  out[3] = FILL_WARPS;
  out[4] = UNIT_SIDE;
  out[5] = TABLE_COLS;
  out[6] = EXACT_COORD_BOUND;
  out[7] = FAST_COORD_BOUND;
  out[8] = FILL_MAX_ROWS;
  return 0;
}

}  // extern "C"
