// Chunk-stream tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel osm_renderer_tpu/ops/render_pallas.py
// (make_render_kernel, launched by _render_body).  Same inputs (the
// host-built chunk layout of ops/chunk_layout.py), same f32/int32
// formulas, same u8 planar output (T, 4, ts, ts).
//
// Design.  The TPU kernel keeps a whole tile's f32 RGBA accumulator and
// pending-alpha plane in VMEM (1.25 MiB at ts = 256) while its
// sequential grid walks the tile's chunks.  That does not fit an SM, and
// CUDA blocks run in no order.  Here one block of 256 threads owns one
// (tile, 32-row band, 128-column half): the band is the layout's row
// block RB, the half is the column window of fills, tent lanes, work
// items and segments, so every band and window test below is exact at
// chunk granularity.  Each warp owns a 16-row x 32-column region and
// each thread one column of it (16 pixels).  The region's premultiplied
// RGBA and pending alpha live in shared memory (80 KB a block, two
// blocks an SM), private to the thread that owns the pixel, so no
// atomics and no state crosses threads or blocks.
//
// What bounds it on the H100.  The batch's bytes are small: the chunk
// arrays are read from L2 a few times over, and the output is 4 bytes a
// pixel, which 3.35 TB/s writes in ~0.01 ms for 97 tiles.  The time goes
// to per-pixel evaluation and to walking chunks, so the design cuts both:
//
// * Skip and prefetch chunks.  A warp reads 32 chunk headers at once and
//   ballots which of them matter to its block: a chunk that paints the
//   band in the block's window, a tile's first chunk (CI_FIRST reset),
//   and every CI_LAST chunk whose primitive rows [prim_y0, prim_y0 +
//   prim_nb) x RB meet the band, even when the chunk's own rows miss it
//   (KIND_LAYER chunks only blend).  Only chunks that paint the band are
//   staged: their lanes (geom, aux rows 0-2, trav, sprof; 4.5 KB) go to a
//   ring of two shared-memory buffers by cp.async, so chunk k+1 loads
//   while chunk k is evaluated.
// * Cull, then evaluate.  Each warp tests a staged chunk's lanes 32 at a
//   time, one lane per thread, against its region: a fill span's row and
//   [xlo, xhi], a tent lane's [y0, y1] x [xlo, xhi], a segment's padded
//   box, a work item's row block ((w >> 8) & 63) and column window.  The
//   survivors are the set bits of the ballot, visited in ascending lane
//   order, so every sum keeps the TPU kernel's order (the tent lanes'
//   ahi/alo are summed lane by lane) and no shared list or barrier is
//   needed.  A fill span then touches only its own row, a tent lane
//   evaluates its tent once per column and adds it to the rows it
//   covers, a work item evaluates only its 8 or 16 rows of the region,
//   and a segment's scalars load once per segment instead of per pixel.
// * Arena rows through the index.  `rows`, when given, maps a batch
//   chunk to its row of the device chunk arena for geom, trav, sprof,
//   aux and items, so the arena entry gathers nothing.
// * Labels in the finalize.  On the labeled arena entry the u8 finalize
//   also blends the device label slab's rows over the pixel it has just
//   written (parallel/label_slab.py's blit_planar, which the JAX package
//   ran in XLA after its kernel): a tile's (off, y0, n) triple maps its
//   rows [y0, y0 + n) to slab rows off + (y - y0), and each thread reads
//   the two i32 words of its own column.  The math is blit_planar's
//   int32 math, so the bytes are its bytes; rows outside the range keep
//   the render.  No other kernel runs after the render.
//
// The TPU evaluated per-pixel predicates through bf16 matmuls (fill
// coverage (U @ W) > 0.5, tent lanes split into an integer and a bf16
// fraction part) and vector windows.  They are evaluated directly per
// pixel here; the tent fraction is rounded to bf16 exactly as the
// matmul operand was, so lane values agree with the TPU kernel bit for
// bit.  Stroke work items and per-segment strokes are evaluated only
// inside the windows the TPU kernel evaluated them in: an item's window
// comes from its section (alive 8x128, steep 16x64 with the 64-column
// half given by the item's position in its group of four, dead-start
// 8x128), a segment's from its row blocks and 128-column halves.
//
// Floating point.  Built with -fmad=false: every membership test here
// (the feather compare on |sdy*x + nc - sdx*y| * inv_denom, cd <
// feather_to, op > 0, the tent plateau clamp) is a float compare, and
// contracting a*b + c into one FMA changes its rounding and can flip
// boundary pixels against the plain PyTorch version and the host's
// numpy tent verification, which round each product.  Division and
// sqrt stay IEEE (no --use_fast_math).  Exact integer floor division
// replaces the TPU's f32-estimate _floor_div_f (both are exact).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int CH = 128;      // lanes per chunk
constexpr int RB = 32;       // rows per chunk row block (= rows per block)
constexpr int DS = 4;        // dash-profile rows per profile
constexpr int NSEC = 12;     // work-item section slots per chunk
constexpr int NCI = 9;       // int scalars per chunk (see CI_*)
constexpr int NCF = 5;       // float scalars per chunk (see CF_*)
constexpr int JMAX_CHAIN = 12;

constexpr int HALF = 128;            // columns per block
constexpr int NTHREADS = 256;        // threads per block
constexpr int WROWS = 16;            // rows per warp region (pixels per thread)
constexpr int WCOLS = 32;            // columns per warp region
constexpr unsigned FULL = 0xFFFFFFFFu;
// One staged chunk: geom (4 x CH) i32, aux rows 0-2 (3 x CH) f32, trav
// (CH) f32, sprof (CH) i32, as 32-bit words.
constexpr int ST_GEOM = 0, ST_AUX = 4 * CH, ST_TRAV = 7 * CH, ST_SPROF = 8 * CH;
constexpr int STAGE_WORDS = 9 * CH;
constexpr int STAGE_PIECES = STAGE_WORDS / 4;   // 16-byte copies
// Shared memory: acc (4 x WROWS x NTHREADS) f32, pending (WROWS x
// NTHREADS) f32, two stages.
constexpr int SMEM_WORDS = 5 * WROWS * NTHREADS + 2 * STAGE_WORDS;
constexpr int SMEM_BYTES = SMEM_WORDS * 4;

enum {
  KIND_PAD = 0, KIND_FILL = 1, KIND_STROKE = 2, KIND_STROKE_SOLID = 3,
  KIND_FILL_IMAGE = 5, KIND_LAYER = 6, KIND_STROKE_DASH = 7,
  KIND_STROKE_SPAN = 9,
};
enum { CI_KIND, CI_CNT, CI_LAST, CI_Y0, CI_NB, CI_PRIM_Y0, CI_PRIM_NB, CI_PAT, CI_FIRST };
enum { CF_R, CF_G, CF_B, CF_OPACITY, CF_HW };
enum { MODE_ALIVE, MODE_DEAD };

struct Params {
  const int32_t* geom;        // (R, 4, CH)
  const float* trav;          // (R, CH)
  const int32_t* sprof;       // (R, CH)
  const float* aux;           // (R, 4, CH)
  const int32_t* items;       // (R, items_stride)
  const int32_t* rows;        // (C,) arena row of each chunk, or null: row = chunk
  const int32_t* isec;        // (C, NSEC)
  const int32_t* chunk_i;     // (C, NCI)
  const float* chunk_f;       // (C, NCF)
  const float* profiles;      // (NP, DS, 8)
  const float* prof_total;    // (NP,)
  const float* patterns;      // (NPat, 4, ts, ts)
  const float* canvas;        // (3,)
  const int32_t* tile_range;  // (T, 2) [begin, end) chunk indices
  const int32_t* label_tri;   // (T, 3) (off, y0, n) slab rows of each tile, or null
  const int32_t* label_plane; // (cap, 2, ts) label slab (label_slab.py), or null
  uint8_t* out;               // (T, 4, ts, ts)
  int items_stride;
  int ts;
};

__device__ __forceinline__ int floor_div(int u, int v) {  // v > 0
  int q = u / v;
  if ((u % v) != 0 && u < 0) --q;
  return q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Round to the nearest bf16 value (ties to even), kept as f32: the TPU
// kernel's tent-lane fraction operand.
__device__ __forceinline__ float bf16_round(float f) {
  unsigned u = __float_as_uint(f);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float feather(float cd, float hlw) {
  const float ff = fmaxf(hlw - 0.5f, 0.0f);
  const float ft = fmaxf(hlw + 0.5f, 1.0f);
  const float om = fminf(2.0f * hlw, 1.0f);
  const float v = cd < ff ? 1.0f : (cd < ft ? (ft - cd) / (ft - ff) : 0.0f);
  return om * v;
}

struct Seg {
  int p1x, p1y, p2x, p2y;
  bool swap;
  int mn0, mx0, mn_d, mx_d, mn_i, mx_i, two_mn, two_mx, nc, sdx, sdy, hK;
  float inv_denom, ratio;
};

__device__ __forceinline__ Seg load_seg(const int* g, const float* a, int sg) {
  Seg s;
  s.p1x = g[0 * CH + sg];
  s.p1y = g[1 * CH + sg];
  s.p2x = g[2 * CH + sg];
  s.p2y = g[3 * CH + sg];
  const int dxs = abs(s.p2x - s.p1x);
  const int dys = abs(s.p2y - s.p1y);
  s.swap = dxs > dys;
  s.mn0 = s.swap ? s.p1y : s.p1x;
  s.mx0 = s.swap ? s.p1x : s.p1y;
  s.mn_d = s.swap ? dys : dxs;
  s.mx_d = max(s.swap ? dxs : dys, 1);
  const int x_inc = s.p1x <= s.p2x ? 1 : -1;
  const int y_inc = s.p1y <= s.p2y ? 1 : -1;
  s.mn_i = s.swap ? y_inc : x_inc;
  s.mx_i = s.swap ? x_inc : y_inc;
  s.two_mn = 2 * s.mn_d;
  s.two_mx = 2 * s.mx_d;
  s.nc = s.p2x * s.p1y - s.p2y * s.p1x;
  s.sdx = s.p2x - s.p1x;
  s.sdy = s.p2y - s.p1y;
  s.inv_denom = a[0 * CH + sg];
  s.ratio = a[1 * CH + sg];
  s.hK = (int)a[2 * CH + sg];
  return s;
}

// Staircase state of the perpendicular walk (k, c, rc, g, rg).
struct Stair { int k, c, rc, g, rg; };

__device__ __forceinline__ Stair step_up(const Seg& s, const Stair& st) {
  int rc = st.rc + s.two_mn;
  const bool carry = rc >= s.two_mx;
  rc = carry ? rc - s.two_mx : rc;
  int rg2 = carry ? st.rg + s.two_mn : st.rg;
  const bool gcarry = rg2 >= s.two_mx;
  rg2 = gcarry ? rg2 - s.two_mx : rg2;
  return Stair{st.k + 1, carry ? st.c + 1 : st.c, rc,
               (carry && gcarry) ? st.g + 1 : st.g, carry ? rg2 : st.rg};
}

__device__ __forceinline__ Stair step_down(const Seg& s, const Stair& st) {
  int rc = st.rc - s.two_mn;
  const bool borrow = rc < 0;
  rc = borrow ? rc + s.two_mx : rc;
  int rg2 = borrow ? st.rg - s.two_mn : st.rg;
  const bool gborrow = rg2 < 0;
  rg2 = gborrow ? rg2 + s.two_mx : rg2;
  return Stair{st.k - 1, borrow ? st.c - 1 : st.c, rc,
               (borrow && gborrow) ? st.g - 1 : st.g, borrow ? rg2 : st.rg};
}

// Owner perpendicular of band bc: f32 estimate plus one correction
// step each way (render_pallas invert()).
__device__ __forceinline__ Stair invert(const Seg& s, int bc) {
  const int K = s.mx_d;
  const int k = clampi((int)((float)bc * s.ratio), 0, K);
  const int uc = s.two_mn * k + s.mx_d - 1;
  const int c = floor_div(uc, s.two_mx);
  const int ug = s.two_mn * c + s.mx_d - 1;
  const int g = floor_div(ug, s.two_mx);
  Stair st{k, c, uc - c * s.two_mx, g, ug - g * s.two_mx};
  if (st.k > 0 && st.k + st.g > bc) st = step_down(s, st);
  const Stair nxt = step_up(s, st);
  if (st.k < K && nxt.k + nxt.g <= bc) st = nxt;
  return st;
}

// Band T+1's owner (its backward branch) for band-edge pixels.
__device__ __forceinline__ void next_owner(const Seg& s, const Stair& st, int T,
                                           int& c_sel2, int& k2) {
  const int bc2 = clampi(T + 1, 0, s.hK);
  const Stair nxt = step_up(s, st);
  const bool take2 = st.k < s.mx_d && nxt.k + nxt.g <= bc2;
  k2 = take2 ? nxt.k : st.k;
  const int c2 = take2 ? nxt.c : st.c;
  const int g2 = take2 ? nxt.g : st.g;
  c_sel2 = ((k2 + g2) != bc2) ? c2 + 1 : c2;
}

// One dash profile: DS rows of (s_from, s_to, e_from, e_to, mul,
// has_orig, oa, ob) plus its total length.
struct Prof {
  const float* row;
  float total;
};

__device__ __forceinline__ float dash_dist(float trav, float sd, float total) {
  const float dist = trav + sd;
  return total > 0.0f ? dist - floorf(dist / total) * total : dist;
}

// Per-segment stroke opacity with round-cap half-width shrink
// (render_pallas stroke_impl(False).stroke_opacity).
__device__ __forceinline__ void stroke_opacity(const Prof& P, float trav, float hw,
                                               float cd, float sd, float& op,
                                               bool& in_line) {
  const float dist = dash_dist(trav, sd, P.total);
  float sd_op = 0.0f;
  float cap = INFINITY;
  bool any_rows = false;
#pragma unroll
  for (int i = 0; i < DS; ++i) {
    const float* r = P.row + i * 8;
    const float s_from = r[0], s_to = r[1], e_from = r[2], e_to = r[3];
    const float mul = r[4], has_orig = r[5], oa = r[6], ob = r[7];
    const bool in_range = dist >= s_from && dist <= e_to;
    const float basev = dist <= s_to ? (dist - s_from) / (s_to - s_from)
                        : (dist < e_from ? 1.0f : (e_to - dist) / (e_to - e_from));
    sd_op = fmaxf(sd_op, in_range ? mul * basev : 0.0f);
    const float cap_d = dist < oa ? oa - dist : (dist <= ob ? 0.0f : dist - ob);
    cap = fminf(cap, (in_range && has_orig > 0.0f) ? cap_d : INFINITY);
    any_rows = any_rows || (s_from < INFINITY);
  }
  sd_op = any_rows ? sd_op : 1.0f;
  cap = isinf(cap) ? 0.0f : cap;
  const float hlw = sqrtf(hw * hw - cap * cap);
  const float cd_op = feather(cd, hlw);
  op = fminf(sd_op, cd_op);
  in_line = cd_op > 0.0f;
}

// Walk start (s_mn, s_mx) alive under the dash profile (per-segment path).
__device__ __forceinline__ bool alive_dash(const Seg& s, const Prof& P, float trav,
                                           float hw, int s_mn, int s_mx) {
  const int s_x = s.swap ? s_mx : s_mn;
  const int s_y = s.swap ? s_mn : s_mx;
  const int raw_s = s.nc + s.sdy * s_x - s.sdx * s_y;
  const float cd_s = fabsf((float)raw_s) * s.inv_denom;
  const int dot_s = (s_x - s.p1x) * s.sdx + (s_y - s.p1y) * s.sdy;
  const float sd_s = fabsf((float)dot_s) * s.inv_denom;
  float op;
  bool alive;
  stroke_opacity(P, trav, hw, cd_s, sd_s, op, alive);
  return alive;
}

// Every intermediate pixel of the perpendicular up to the owner must be
// alive too when round caps make in_line non-monotone (walk-chain rule).
__device__ __forceinline__ bool chain_alive(const Seg& s, const Prof& P, float trav,
                                            float hw, int s_mn_v, int s_mx_v,
                                            int c_sel_v, int mul_v, int jv) {
  const int tcm = 2 * c_sel_v * s.mn_d;
  const int G = max(0, floor_div(tcm - s.mx_d + s.two_mx - 1, s.two_mx));
  const int e0 = mul_v * (tcm - s.two_mx * G);
  if (!(jv < (1 << 30))) return false;
  for (int jp = 1; jp < JMAX_CHAIN; ++jp) {
    if (jp >= jv) break;
    const int Cjp = max(0, floor_div(e0 + 2 * jp * s.mn_d - s.mx_d + s.two_mx - 1, s.two_mx));
    const int minor = s_mn_v + mul_v * s.mn_i * jp;
    const int major = s_mx_v - mul_v * s.mx_i * Cjp;
    if (!alive_dash(s, P, trav, hw, minor, major)) return false;
  }
  return true;
}

// KIND_STROKE: one pixel of one segment (render_pallas _general_impl,
// solid=False).  Returns the pixel's alpha (0 when not painted).
__device__ float stroke_segment_alpha(const Seg& s, const Prof& P, bool chain_on,
                                      float trav, float hw, float opacity, int x, int y) {
  const int raw = s.nc + s.sdy * x - s.sdx * y;
  const float cd = fabsf((float)raw) * s.inv_denom;
  const int dot = (x - s.p1x) * s.sdx + (y - s.p1y) * s.sdy;
  const float sd = fabsf((float)dot) * s.inv_denom;
  float op;
  bool in_line;
  stroke_opacity(P, trav, hw, cd, sd, op, in_line);
  if (!in_line) return 0.0f;

  const int MN = s.swap ? y : x;
  const int MX = s.swap ? x : y;
  const int n0 = (MN - s.mn0) * s.mn_i;
  const int m0 = (MX - s.mx0) * s.mx_i;
  const int A = s.two_mn * n0 + s.two_mx * m0 + (s.mx_d - 1);
  const int T = floor_div(A, s.two_mx);
  const bool edge = (A - T * s.two_mx) == (s.two_mx - 1);

  const int bc = clampi(T, 0, s.hK);
  const Stair st = invert(s, bc);
  const int c_sel = ((st.k + st.g) != bc) ? st.c + 1 : st.c;
  const int s_mn_T = s.mn0 + s.mn_i * c_sel;
  const int s_mx_T = s.mx0 + s.mx_i * st.k;
  const bool in_slab = A >= 0 && T <= s.hK;
  const int dn_T = (MN - s_mn_T) * s.mn_i;
  bool ok_T = in_slab && alive_dash(s, P, trav, hw, s_mn_T, s_mx_T);
  if (ok_T && chain_on) {
    ok_T = chain_alive(s, P, trav, hw, s_mn_T, s_mx_T, c_sel, dn_T >= 0 ? 1 : -1, abs(dn_T));
  }
  if (ok_T && (!edge || dn_T >= 0)) return opacity * op;
  if (!edge) return 0.0f;

  int c_sel2, k2;
  next_owner(s, st, T, c_sel2, k2);
  const int s_mn_N = s.mn0 + s.mn_i * c_sel2;
  const int s_mx_N = s.mx0 + s.mx_i * k2;
  const int dn_N = (MN - s_mn_N) * s.mn_i;
  bool ok_N = (A + 1 >= 0) && (T + 1 <= s.hK) && (dn_N <= 0) &&
              alive_dash(s, P, trav, hw, s_mn_N, s_mx_N);
  if (ok_N && chain_on) ok_N = chain_alive(s, P, trav, hw, s_mn_N, s_mx_N, c_sel2, -1, -dn_N);
  return ok_N ? opacity * op : 0.0f;
}

// KIND_STROKE_SOLID / KIND_STROKE_DASH: one pixel of one work item
// (render_pallas stroke_items_impl eval_group).
__device__ float stroke_item_alpha(const Seg& s, int mode, bool dashed, const Prof& P,
                                   float trav, float hw, float opacity, int x, int y) {
  const int raw = s.sdy * x + (s.nc - s.sdx * y);
  const float cd = fabsf((float)raw) * s.inv_denom;
  const float op = feather(cd, hw);
  if (!(op > 0.0f)) return 0.0f;
  const int MN = s.swap ? y : x;
  const int MX = s.swap ? x : y;

  float op_emit = op;
  if (dashed) {
    const int dot = (x - s.p1x) * s.sdx + (y - s.p1y) * s.sdy;
    const float sd = fabsf((float)dot) * s.inv_denom;
    const float dist = dash_dist(trav, sd, P.total);
    float sd_op = 0.0f;
    bool any_rows = false;
#pragma unroll
    for (int i = 0; i < DS; ++i) {
      const float* r = P.row + i * 8;
      const float s_from = r[0], s_to = r[1], e_from = r[2], e_to = r[3], mul = r[4];
      const bool in_range = dist >= s_from && dist <= e_to;
      const float basev = dist <= s_to ? (dist - s_from) / (s_to - s_from)
                          : (dist < e_from ? 1.0f : (e_to - dist) / (e_to - e_from));
      sd_op = fmaxf(sd_op, in_range ? mul * basev : 0.0f);
      any_rows = any_rows || (s_from < 1e30f);
    }
    sd_op = any_rows ? sd_op : 1.0f;
    op_emit = fminf(sd_op, op);
  }

  const int n0 = (MN - s.mn0) * s.mn_i;
  const int m0 = (MX - s.mx0) * s.mx_i;
  const int A = s.two_mn * n0 + s.two_mx * m0 + (s.mx_d - 1);
  const int T = floor_div(A, s.two_mx);
  const bool edge = (A - T * s.two_mx) == (s.two_mx - 1);
  const bool in_slab = A >= 0 && T <= s.hK;

  bool mask;
  if (mode == MODE_ALIVE) {
    const bool ok_edge = (in_slab && T < s.hK) || (T == s.hK && n0 >= s.mn_d) ||
                         (A == -1 && n0 <= 0);
    mask = edge ? ok_edge : in_slab;
  } else {
    const float feather_to = fmaxf(hw + 0.5f, 1.0f);
    const bool om_pos = fminf(2.0f * hw, 1.0f) > 0.0f;
    const int bc = clampi(T, 0, s.hK);
    const Stair st = invert(s, bc);
    const int c_sel = ((st.k + st.g) != bc) ? st.c + 1 : st.c;
    const int s_mn_T = s.mn0 + s.mn_i * c_sel;
    const int s_mx_T = s.mx0 + s.mx_i * st.k;
    const int dn_T = (MN - s_mn_T) * s.mn_i;
    bool ok_T = false;
    if (in_slab) {
      const int sx = s.swap ? s_mx_T : s_mn_T;
      const int sy = s.swap ? s_mn_T : s_mx_T;
      const int raw_s = s.nc + s.sdy * sx - s.sdx * sy;
      ok_T = (fabsf((float)raw_s) * s.inv_denom < feather_to) && om_pos;
    }
    mask = ok_T && (!edge || dn_T >= 0);
    if (!mask && edge && (A + 1 >= 0) && (T + 1 <= s.hK)) {
      int c_sel2, k2;
      next_owner(s, st, T, c_sel2, k2);
      const int s_mn_N = s.mn0 + s.mn_i * c_sel2;
      const int s_mx_N = s.mx0 + s.mx_i * k2;
      const int dn_N = (MN - s_mn_N) * s.mn_i;
      if (dn_N <= 0) {
        const int sx = s.swap ? s_mx_N : s_mn_N;
        const int sy = s.swap ? s_mn_N : s_mx_N;
        const int raw_s = s.nc + s.sdy * sx - s.sdx * sy;
        mask = (fabsf((float)raw_s) * s.inv_denom < feather_to) && om_pos;
      }
    }
  }
  return mask ? opacity * op_emit : 0.0f;
}

// ---------------------------------------------------------------------------
// The block's walk over its tile's chunks
// ---------------------------------------------------------------------------

// The asynchronous copies.  Outside nvcc's device pass (a host build of
// this file) a copy is a plain 16-byte copy, done when it is issued, and
// the waits have nothing to wait for.
#ifdef __CUDA_ARCH__
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most the most recently committed group is in flight.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
#else
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  memcpy(smem, gmem, 16);
}
__device__ __forceinline__ void cp_async_commit() {}
__device__ __forceinline__ void cp_async_wait_prev() {}
__device__ __forceinline__ void cp_async_wait_all() {}
#endif

// Where a block is: tile, 32-row band, 128-column half.
struct Place {
  int band, half, n_halves, item_halves;
};

// What chunk ch asks of a block.
enum { NEED_FIRST = 1, NEED_PAINT = 2, NEED_BLEND = 4 };

__device__ __forceinline__ int chunk_needs(const Params& p, int ch, const Place& pl) {
  const int* ci = p.chunk_i + (size_t)ch * NCI;
  const int kind = ci[CI_KIND];
  int need = ci[CI_FIRST] == 1 ? NEED_FIRST : 0;
  if (kind == KIND_PAD) return need;
  const int y0 = ci[CI_Y0];
  if (pl.band >= y0 && pl.band < y0 + ci[CI_NB]) {
    bool in_win = false;  // KIND_LAYER and the legacy kinds only blend
    if (kind == KIND_FILL || kind == KIND_FILL_IMAGE || kind == KIND_STROKE_SPAN) {
      const int colp1 = p.isec[(size_t)ch * NSEC];
      in_win = (colp1 >= 1 && colp1 <= pl.n_halves) ? pl.half == colp1 - 1 : true;
    } else if (kind == KIND_STROKE) {
      in_win = true;
    } else if (kind == KIND_STROKE_SOLID || kind == KIND_STROKE_DASH) {
      in_win = pl.half < pl.item_halves;
    }
    if (in_win) need |= NEED_PAINT;
  }
  if (ci[CI_LAST] == 1) {
    const int p0 = ci[CI_PRIM_Y0];
    if (pl.band >= p0 && pl.band < p0 + ci[CI_PRIM_NB]) need |= NEED_BLEND;
  }
  return need;
}

// The next chunk after `after` (< c_end) that this block needs, or
// c_end.  (wbase, wmask) is the current window of 32 chunk headers and
// the ballot of those needed; every warp of the block computes the same.
__device__ __forceinline__ int next_chunk(const Params& p, const Place& pl, int after, int c_end,
                                          int lane, int& wbase, unsigned& wmask) {
  for (;;) {
    const int off = after + 1 - wbase;
    const unsigned m = off <= 0 ? wmask : (off >= 32 ? 0u : (wmask & (FULL << off)));
    if (m) return wbase + __ffs(m) - 1;
    wbase += 32;
    if (wbase >= c_end) return c_end;
    const int ch = wbase + lane;
    wmask = __ballot_sync(FULL, ch < c_end && chunk_needs(p, ch, pl) != 0);
  }
}

// Queue the copy of arena row `row`'s lanes into one stage.
__device__ __forceinline__ void stage_chunk(const Params& p, int row, int* dst, int tid) {
  for (int piece = tid; piece < STAGE_PIECES; piece += NTHREADS) {
    const int w = piece * 4;
    const void* src;
    if (w < ST_AUX) {
      src = p.geom + (size_t)row * 4 * CH + w;
    } else if (w < ST_TRAV) {
      src = p.aux + (size_t)row * 4 * CH + (w - ST_AUX);
    } else if (w < ST_SPROF) {
      src = p.trav + (size_t)row * CH + (w - ST_TRAV);
    } else {
      src = p.sprof + (size_t)row * CH + (w - ST_SPROF);
    }
    cp_async16(dst + w, src);
  }
}

// The thread's pixels: column x, rows [wr0, wr0 + WROWS) of its warp's
// region [wr0, wr0 + WROWS) x [wc0, wc0 + WCOLS).  pend[k * NTHREADS] is
// row wr0 + k's pending alpha.
struct Px {
  float* pend;
  int x, wr0, wc0, lane, q;
};

__device__ __forceinline__ void fmax_into(float* v, float a) { *v = fmaxf(*v, a); }

// KIND_FILL, KIND_FILL_IMAGE: spans (y, xlo, xhi); a covered pixel takes
// the opacity.
__device__ __forceinline__ void paint_fill(const int* sg, float opacity, const Px& px) {
  for (int g = 0; g < CH; g += 32) {
    const int s = g + px.lane;
    const int ys = sg[s];
    unsigned m = __ballot_sync(FULL, ys >= px.wr0 && ys < px.wr0 + WROWS &&
                                         sg[CH + s] < px.wc0 + WCOLS && sg[2 * CH + s] >= px.wc0);
    while (m) {
      const int t = g + __ffs(m) - 1;
      m &= m - 1;
      if (px.x >= sg[CH + t] && px.x <= sg[2 * CH + t]) {
        fmax_into(px.pend + (sg[t] - px.wr0) * NTHREADS, opacity);
      }
    }
  }
}

// KIND_STROKE_SPAN: tent lanes over [y0, y1] x [xlo, xhi].  A lane's
// tent depends on x only, so it is evaluated once per column and added
// to every covered row, lanes in ascending order (ahi and alo apart, as
// the TPU's two matmuls summed them).
__device__ __forceinline__ void paint_span(const int* sg, const float* sa, float opacity,
                                           float hw, const Px& px) {
  const float plat255 = opacity * fminf(2.0f * hw, 1.0f) * 255.0f;
  const float xf = (float)px.x;
  float ahi[WROWS], alo[WROWS];
#pragma unroll
  for (int k = 0; k < WROWS; ++k) {
    ahi[k] = 0.0f;
    alo[k] = 0.0f;
  }
  bool any = false;
  for (int g = 0; g < CH; g += 32) {
    const int s = g + px.lane;
    unsigned m = __ballot_sync(FULL, sg[CH + s] >= px.wr0 && sg[s] < px.wr0 + WROWS &&
                                         sg[3 * CH + s] >= px.wc0 && sg[2 * CH + s] < px.wc0 + WCOLS);
    any = any || m != 0;
    while (m) {
      const int t = g + __ffs(m) - 1;
      m &= m - 1;
      if (px.x >= sg[2 * CH + t] && px.x <= sg[3 * CH + t]) {
        const float tent = sa[t] - sa[CH + t] * fabsf(xf - sa[2 * CH + t]);
        const float mv = fmaxf(fminf(tent, plat255), 0.0f);
        const float mi = floorf(mv);
        const float lo = bf16_round(mv - mi);
        const int k0 = sg[t] - px.wr0, k1 = sg[CH + t] - px.wr0;
#pragma unroll
        for (int k = 0; k < WROWS; ++k) {
          if (k >= k0 && k <= k1) {
            ahi[k] += mi;
            alo[k] += lo;
          }
        }
      }
    }
  }
  if (any) {
#pragma unroll
    for (int k = 0; k < WROWS; ++k) {
      fmax_into(px.pend + k * NTHREADS, (ahi[k] + alo[k]) * (float)(1.0 / 255.0));
    }
  }
}

// KIND_STROKE: each segment over its 32-row blocks x 128-column halves
// (the padded-box test of the TPU kernel's window list).
__device__ __forceinline__ void paint_segments(const Params& p, const int* sg, const float* sa,
                                               const float* strav, const int* ssprof, int cnt,
                                               float hw, float opacity, const Place& pl,
                                               const Px& px) {
  const int m = (int)ceilf(hw) + 2;
  const int col0 = pl.half * HALF;
  for (int g = 0; g < cnt; g += 32) {
    const int s = g + px.lane;
    bool hit = false;
    if (s < cnt) {
      const int p1x = sg[s], p1y = sg[CH + s], p2x = sg[2 * CH + s], p2y = sg[3 * CH + s];
      const int ylo = max(min(p1y, p2y) - m, 0);
      const int yhi = min(max(p1y, p2y) + m, p.ts - 1);
      const int blk0 = ylo / RB;
      const int nbs = (p1x == p2x && p1y == p2y) ? 0 : floor_div(yhi - blk0 * RB, RB) + 1;
      hit = pl.band >= blk0 && pl.band < blk0 + nbs &&
            min(p1x, p2x) - m < col0 + HALF && max(p1x, p2x) + m >= col0;
    }
    unsigned msk = __ballot_sync(FULL, hit);
    while (msk) {
      const int t = g + __ffs(msk) - 1;
      msk &= msk - 1;
      const Seg seg = load_seg(sg, sa, t);
      const int pidx = ssprof[t];
      const Prof P{p.profiles + (size_t)pidx * DS * 8, p.prof_total[pidx]};
      bool any_orig = false;
#pragma unroll
      for (int i = 0; i < DS; ++i) {
        any_orig = any_orig || (P.row[i * 8] < 1e30f && P.row[i * 8 + 5] > 0.0f);
      }
      const float trav = strav[t];
#pragma unroll 1
      for (int k = 0; k < WROWS; ++k) {
        fmax_into(px.pend + k * NTHREADS,
                  stroke_segment_alpha(seg, P, any_orig, trav, hw, opacity, px.x, px.wr0 + k));
      }
    }
  }
}

// KIND_STROKE_SOLID, KIND_STROKE_DASH: the work items of the block's
// column half, each over the rows of its window that the warp owns.
__device__ __forceinline__ void paint_items(const Params& p, const int* it, const int* sec,
                                            const int* sg, const float* sa, const float* strav,
                                            const int* ssprof, bool dashed, float hw,
                                            float opacity, const Place& pl, const Px& px) {
  for (int fam = 0; fam < 3; ++fam) {
    const int slot = 4 * fam + pl.half;
    const int start = slot > 0 ? sec[slot - 1] : 0;
    const int n4 = ((sec[slot] - start) >> 2) << 2;
    const bool steep = fam == 1;
    const int mode = fam == 2 ? MODE_DEAD : MODE_ALIVE;
    for (int g = 0; g < n4; g += 32) {
      const int i = g + px.lane;
      const int w = i < n4 ? it[start + i] : 0;
      const int rb = (w >> 8) & 63;
      // Steep: rows [rb*16, +16) and the 64-column half (i & 3) >> 1;
      // alive and dead-start: rows [rb*8, +8) of the 128-column half.
      const bool hit = i < n4 && (steep ? (rb == (px.wr0 >> 4) && (px.q >> 1) == ((i & 3) >> 1))
                                        : ((rb >> 1) == (px.wr0 >> 4)));
      unsigned m = __ballot_sync(FULL, hit);
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int wj = __shfl_sync(FULL, w, j);
        const int sgi = wj & 127;
        const Seg seg = load_seg(sg, sa, sgi);
        const int pidx = dashed ? ssprof[sgi] : 0;
        const Prof P{p.profiles + (size_t)pidx * DS * 8, p.prof_total[pidx]};
        const float trav = strav[sgi];
        const int k0 = steep ? 0 : ((wj >> 8) & 63) * 8 - px.wr0;
        const int k1 = steep ? WROWS : k0 + 8;
#pragma unroll 1
        for (int k = k0; k < k1; ++k) {
          fmax_into(px.pend + k * NTHREADS,
                    stroke_item_alpha(seg, mode, dashed, P, trav, hw, opacity, px.x, px.wr0 + k));
        }
      }
    }
  }
}

// CI_LAST: blend pending (or a pattern or layer) into acc over the
// thread's rows; the caller has checked that the primitive's rows cover
// the band.
__device__ __forceinline__ void blend_chunk(const Params& p, int kind, const int* ci,
                                            const float* cf, float* acc, float* pend,
                                            const Px& px) {
  const int pat = ci[CI_PAT];
  if (pat < 0) {
    const float cr = cf[CF_R], cg = cf[CF_G], cb = cf[CF_B];
#pragma unroll 4
    for (int k = 0; k < WROWS; ++k) {
      float* ak = acc + k * NTHREADS;
      const float a = pend[k * NTHREADS];
      const float keep = 1.0f - a;
      ak[0] = a * cr + keep * ak[0];
      ak[WROWS * NTHREADS] = a * cg + keep * ak[WROWS * NTHREADS];
      ak[2 * WROWS * NTHREADS] = a * cb + keep * ak[2 * WROWS * NTHREADS];
      ak[3 * WROWS * NTHREADS] = a + keep * ak[3 * WROWS * NTHREADS];
      pend[k * NTHREADS] = 0.0f;
    }
    return;
  }
  const int ts = p.ts;
  const size_t plane = (size_t)ts * ts;
  const float* pp0 = p.patterns + (size_t)pat * 4 * plane + (size_t)px.wr0 * ts + px.x;
#pragma unroll 4
  for (int k = 0; k < WROWS; ++k) {
    float* ak = acc + k * NTHREADS;
    const float* pp = pp0 + (size_t)k * ts;
    const float pr = pp[0], pg = pp[plane], pb = pp[2 * plane], pa = pp[3 * plane];
    if (kind == KIND_LAYER) {
      const float keep = 1.0f - pa;
      ak[0] = pr + keep * ak[0];
      ak[WROWS * NTHREADS] = pg + keep * ak[WROWS * NTHREADS];
      ak[2 * WROWS * NTHREADS] = pb + keep * ak[2 * WROWS * NTHREADS];
      ak[3 * WROWS * NTHREADS] = pa + keep * ak[3 * WROWS * NTHREADS];
    } else {
      const float mask = pend[k * NTHREADS];
      const float keep = 1.0f - mask * pa;
      ak[0] = mask * pr + keep * ak[0];
      ak[WROWS * NTHREADS] = mask * pg + keep * ak[WROWS * NTHREADS];
      ak[2 * WROWS * NTHREADS] = mask * pb + keep * ak[2 * WROWS * NTHREADS];
      ak[3 * WROWS * NTHREADS] = mask * pa + keep * ak[3 * WROWS * NTHREADS];
      pend[k * NTHREADS] = 0.0f;
    }
  }
}

__device__ __forceinline__ void reset_pixels(float* acc, float* pend, float cr, float cg,
                                             float cb) {
#pragma unroll 4
  for (int k = 0; k < WROWS; ++k) {
    float* ak = acc + k * NTHREADS;
    ak[0] = cr;
    ak[WROWS * NTHREADS] = cg;
    ak[2 * WROWS * NTHREADS] = cb;
    ak[3 * WROWS * NTHREADS] = 1.0f;
    pend[k * NTHREADS] = 0.0f;
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
render_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  // acc[c][k][tid] and pend[k][tid]: thread tid's own pixels.
  float* acc = smem + tid;
  float* pend = smem + 4 * WROWS * NTHREADS + tid;
  int* stage = reinterpret_cast<int*>(smem + 5 * WROWS * NTHREADS);

  const int ts = p.ts;
  const int tile = blockIdx.z;
  const int lane = tid & 31, warp = tid >> 5;
  Place pl;
  pl.band = blockIdx.y;
  pl.half = blockIdx.x;
  pl.n_halves = ts / HALF;
  pl.item_halves = min(pl.n_halves, 4);
  Px px;
  px.pend = pend;
  px.lane = lane;
  px.q = warp & 3;
  px.wc0 = pl.half * HALF + px.q * WCOLS;
  px.wr0 = pl.band * RB + (warp >> 2) * WROWS;
  px.x = px.wc0 + lane;

  const int c_begin = p.tile_range[2 * tile];
  const int c_end = p.tile_range[2 * tile + 1];
  const float cr0 = p.canvas[0], cg0 = p.canvas[1], cb0 = p.canvas[2];
  reset_pixels(acc, pend, cr0, cg0, cb0);

  int wbase = c_begin - 32;
  unsigned wmask = 0;
  int cur = next_chunk(p, pl, c_begin - 1, c_end, lane, wbase, wmask);
  int cur_need = cur < c_end ? chunk_needs(p, cur, pl) : 0;
  int slot = 0;
  if (cur_need & NEED_PAINT) stage_chunk(p, p.rows ? p.rows[cur] : cur, stage, tid);
  cp_async_commit();

  while (cur < c_end) {
    // Prefetch the next needed chunk's lanes into the other stage; the
    // barrier that closed the last painted chunk freed it.
    const int nxt = next_chunk(p, pl, cur, c_end, lane, wbase, wmask);
    const int nxt_need = nxt < c_end ? chunk_needs(p, nxt, pl) : 0;
    if (nxt_need & NEED_PAINT) {
      stage_chunk(p, p.rows ? p.rows[nxt] : nxt, stage + (slot ^ 1) * STAGE_WORDS, tid);
    }
    cp_async_commit();

    const int* ci = p.chunk_i + (size_t)cur * NCI;
    const float* cf = p.chunk_f + (size_t)cur * NCF;
    const int kind = ci[CI_KIND];
    if (cur_need & NEED_FIRST) reset_pixels(acc, pend, cr0, cg0, cb0);
    if (cur_need & NEED_PAINT) {
      cp_async_wait_prev();
      __syncthreads();
      const int* st = stage + slot * STAGE_WORDS;
      const int* sg = st + ST_GEOM;
      const float* sa = reinterpret_cast<const float*>(st + ST_AUX);
      const float* strav = reinterpret_cast<const float*>(st + ST_TRAV);
      const int* ssprof = st + ST_SPROF;
      const float opacity = cf[CF_OPACITY];
      const float hw = cf[CF_HW];
      if (kind == KIND_FILL || kind == KIND_FILL_IMAGE) {
        paint_fill(sg, opacity, px);
      } else if (kind == KIND_STROKE_SPAN) {
        paint_span(sg, sa, opacity, hw, px);
      } else if (kind == KIND_STROKE) {
        paint_segments(p, sg, sa, strav, ssprof, ci[CI_CNT], hw, opacity, pl, px);
      } else {
        const int row = p.rows ? p.rows[cur] : cur;
        paint_items(p, p.items + (size_t)row * p.items_stride, p.isec + (size_t)cur * NSEC, sg,
                    sa, strav, ssprof, kind == KIND_STROKE_DASH, hw, opacity, pl, px);
      }
      __syncthreads();  // every warp is done with this stage
    }
    if (cur_need & NEED_BLEND) blend_chunk(p, kind, ci, cf, acc, pend, px);
    cur = nxt;
    cur_need = nxt_need;
    slot ^= 1;
  }
  cp_async_wait_all();

  // The slab words of the thread's rows, all loads issued before the
  // first store (an out byte may alias them, so the compiler would not
  // hoist a later row's loads above an earlier row's stores): a colour
  // word and A = plane1 + 1, the identity (0, 65536) outside the tile's
  // label rows [y0, y0 + n).
  const bool labeled = p.label_tri != nullptr;
  unsigned lc[WROWS], la[WROWS];
  if (labeled) {
    const int loff = p.label_tri[3 * tile];
    const int ly0 = p.label_tri[3 * tile + 1];
    const int ln = p.label_tri[3 * tile + 2];
#pragma unroll
    for (int k = 0; k < WROWS; ++k) {
      const int dy = px.wr0 + k - ly0;
      const bool in = dy >= 0 && dy < ln;
      const int32_t* lr = p.label_plane + (size_t)(in ? loff + dy : 0) * 2 * ts + px.x;
      lc[k] = in ? (unsigned)lr[0] : 0u;
      la[k] = in ? (unsigned)lr[ts] + 1u : 65536u;
    }
  }
  const size_t plane = (size_t)ts * ts;
  uint8_t* o = p.out + (size_t)tile * 4 * plane + (size_t)px.wr0 * ts + px.x;
#pragma unroll
  for (int k = 0; k < WROWS; ++k) {
    const float* ak = acc + k * NTHREADS;
    const float acc_a = ak[3 * WROWS * NTHREADS];
    const float mul = acc_a == 0.0f ? 0.0f : 1.0f / acc_a;
    uint8_t* ok = o + (size_t)k * ts;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = 255.0f * ak[c * WROWS * NTHREADS] * mul;
      v = isnan(v) ? 0.0f : fminf(fmaxf(v, 0.0f), 255.0f);
      int out = (uint8_t)(int)truncf(v);
      if (labeled) {
        // blit_planar: (c * 65536 + A * base) >> 16, clamped to 255, in
        // wrapping int32 as torch computes it (at most 33.4M on slab
        // data); the identity words give base back.
        const unsigned cc = (lc[k] >> (8 * c)) & 255u;
        out = min((int)(cc * 65536u + la[k] * (unsigned)out) >> 16, 255);
      }
      ok[c * plane] = (uint8_t)out;
    }
    ok[3 * plane] = 255;
  }
}

// Records `event` (a CUDA timing event of the caller's, or null) on
// `stream`: the entries stamp one just before and one just after their
// launch, so a pair holds the launch's device time and no host code.
void stamp(void* event, void* stream) {
  if (event != nullptr) {
    cudaEventRecord(static_cast<cudaEvent_t>(event), static_cast<cudaStream_t>(stream));
  }
}

}  // namespace

extern "C" int osmr_render_planar(
    const int32_t* geom, const float* trav, const int32_t* sprof, const float* aux,
    const int32_t* items, int items_stride, const int32_t* rows, const int32_t* isec,
    const int32_t* chunk_i, const float* chunk_f, const float* profiles,
    const float* prof_total, const float* patterns, const float* canvas,
    const int32_t* tile_range, const int32_t* label_tri, const int32_t* label_plane,
    int label_cap, uint8_t* out, int n_tiles, int ts, void* stream, void* t_start,
    void* t_end) {
  // A labeled launch needs both label pointers and a slab of at least
  // its identity row; the caller has checked every triple against the
  // tile and the slab.
  if ((label_tri == nullptr) != (label_plane == nullptr) || (label_tri && label_cap < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{geom, trav, sprof, aux, items, rows, isec, chunk_i, chunk_f, profiles, prof_total,
           patterns, canvas, tile_range, label_tri, label_plane, out, items_stride, ts};
  const dim3 grid(ts / HALF, ts / RB, n_tiles);
  stamp(t_start, stream);
  render_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t launched = cudaGetLastError();
  stamp(t_end, stream);
  return static_cast<int>(launched);
}

// Threads a block, dynamic shared memory a block, and resident blocks an
// SM on the current device.
extern "C" int osmr_render_occupancy(int* threads, int* smem_bytes, int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  *threads = NTHREADS;
  *smem_bytes = SMEM_BYTES;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, render_kernel, NTHREADS,
                                                      SMEM_BYTES);
  return static_cast<int>(err);
}
