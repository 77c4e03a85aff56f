// Chunk-stream tile rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel osm_renderer_tpu/ops/render_pallas.py
// (make_render_kernel, launched by _render_body).  Same inputs (the
// host-built chunk layout of ops/chunk_layout.py), same f32/int32
// formulas, same u8 planar output (T, 4, ts, ts).
//
// Design.  The TPU kernel keeps a whole tile's f32 RGBA accumulator and
// pending-alpha plane in VMEM (1.25 MiB at ts = 256) while its
// sequential grid walks the tile's chunks.  That does not fit an SM's
// shared memory, and CUDA blocks run in no order.  Here each block owns
// one (tile, 8-row x 32-column pixel block) with one thread per pixel;
// the pixel's premultiplied RGBA and pending alpha live in registers.
// The block walks its tile's contiguous chunk range in paint order,
// skips chunks whose row blocks miss its rows, stages the chunk's lanes
// in shared memory, and writes the u8 planar output at the end.  No
// atomics and no state crosses blocks.
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
// What bounds it on the H100.  Per chunk a block re-reads the chunk's
// scalars and lanes (L2-resident, a few KB) and each in-range thread
// loops over up to 128 lanes or the chunk's work items, so the kernel
// is bound by per-pixel integer/f32 instruction issue and by blocks
// that walk chunks which miss them, not by device memory: a batch reads
// its chunk arrays once per 8-row band and writes 4 bytes per pixel.
// Making it fast (work culling per block, wider blocks, persistent
// scheduling) is later work; this kernel is the simple correct one.
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

namespace {

constexpr int CH = 128;      // lanes per chunk
constexpr int RB = 32;       // rows per chunk row block
constexpr int RB_I = 8;      // rows per alive / dead work-item window
constexpr int RB16 = 16;     // rows per steep work-item window
constexpr int DS = 4;        // dash-profile rows per profile
constexpr int NSEC = 12;     // work-item section slots per chunk
constexpr int NCI = 9;       // int scalars per chunk (see CI_*)
constexpr int NCF = 5;       // float scalars per chunk (see CF_*)
constexpr int BW = 32;       // pixel columns per block
constexpr int BH = 8;        // pixel rows per block
constexpr int JMAX_CHAIN = 12;

enum {
  KIND_PAD = 0, KIND_FILL = 1, KIND_STROKE = 2, KIND_STROKE_SOLID = 3,
  KIND_FILL_IMAGE = 5, KIND_LAYER = 6, KIND_STROKE_DASH = 7,
  KIND_STROKE_SPAN = 9,
};
enum { CI_KIND, CI_CNT, CI_LAST, CI_Y0, CI_NB, CI_PRIM_Y0, CI_PRIM_NB, CI_PAT, CI_FIRST };
enum { CF_R, CF_G, CF_B, CF_OPACITY, CF_HW };
enum { MODE_ALIVE, MODE_DEAD };

struct Params {
  const int32_t* geom;        // (C, 4, CH)
  const float* trav;          // (C, CH)
  const int32_t* sprof;       // (C, CH)
  const float* aux;           // (C, 4, CH)
  const int32_t* items;       // (C, it_width)
  const int32_t* isec;        // (C, NSEC)
  const int32_t* chunk_i;     // (C, NCI)
  const float* chunk_f;       // (C, NCF)
  const float* profiles;      // (NP, DS, 8)
  const float* prof_total;    // (NP,)
  const float* patterns;      // (NPat, 4, ts, ts)
  const float* canvas;        // (3,)
  const int32_t* tile_range;  // (T, 2) [begin, end) chunk indices
  uint8_t* out;               // (T, 4, ts, ts)
  int it_width;
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

__global__ void __launch_bounds__(BW * BH)
render_kernel(const Params p) {
  __shared__ int s_geom[4 * CH];
  __shared__ float s_aux[3 * CH];
  __shared__ float s_trav[CH];
  __shared__ int s_sprof[CH];

  const int ts = p.ts;
  const int tile = blockIdx.z;
  const int row0 = blockIdx.y * BH;
  const int x = blockIdx.x * BW + threadIdx.x;
  const int y = row0 + threadIdx.y;
  const int tid = threadIdx.y * BW + threadIdx.x;
  const int n_halves = ts / 128;
  const int item_halves = min(n_halves, 4);
  const int c_begin = p.tile_range[2 * tile];
  const int c_end = p.tile_range[2 * tile + 1];

  const float cr0 = p.canvas[0], cg0 = p.canvas[1], cb0 = p.canvas[2];
  float acc_r = cr0, acc_g = cg0, acc_b = cb0, acc_a = 1.0f;
  float pending = 0.0f;

  for (int ch = c_begin; ch < c_end; ++ch) {
    const int* ci = p.chunk_i + (size_t)ch * NCI;
    const float* cf = p.chunk_f + (size_t)ch * NCF;
    const int kind = ci[CI_KIND];
    if (ci[CI_FIRST] == 1) {
      acc_r = cr0; acc_g = cg0; acc_b = cb0; acc_a = 1.0f;
      pending = 0.0f;
    }
    if (kind == KIND_PAD) continue;

    const int y0 = ci[CI_Y0];
    const int nb = ci[CI_NB];
    const bool paints = kind == KIND_FILL || kind == KIND_FILL_IMAGE ||
                        kind == KIND_STROKE_SPAN || kind == KIND_STROKE ||
                        kind == KIND_STROKE_SOLID || kind == KIND_STROKE_DASH;
    // Block-uniform: 8-row blocks never straddle a 32-row chunk block.
    if (paints && row0 >= y0 * RB && row0 < (y0 + nb) * RB) {
      __syncthreads();  // previous chunk's lanes are no longer read
      const int* g = p.geom + (size_t)ch * 4 * CH;
      const float* a = p.aux + (size_t)ch * 4 * CH;
      for (int i = tid; i < 4 * CH; i += BW * BH) s_geom[i] = g[i];
      for (int i = tid; i < 3 * CH; i += BW * BH) s_aux[i] = a[i];
      for (int i = tid; i < CH; i += BW * BH) {
        s_trav[i] = p.trav[(size_t)ch * CH + i];
        s_sprof[i] = p.sprof[(size_t)ch * CH + i];
      }
      __syncthreads();

      const float opacity = cf[CF_OPACITY];
      const float hw = cf[CF_HW];
      const int colp1 = p.isec[(size_t)ch * NSEC];
      const bool in_win = (colp1 >= 1 && colp1 <= n_halves) ? ((x >> 7) == colp1 - 1) : true;

      if (kind == KIND_FILL || kind == KIND_FILL_IMAGE) {
        if (in_win) {
          bool covered = false;
          for (int s = 0; s < CH && !covered; ++s) {
            covered = s_geom[s] == y && x >= s_geom[CH + s] && x <= s_geom[2 * CH + s];
          }
          pending = fmaxf(pending, covered ? opacity : 0.0f);
        }
      } else if (kind == KIND_STROKE_SPAN) {
        if (in_win) {
          const float plat255 = opacity * fminf(2.0f * hw, 1.0f) * 255.0f;
          const float xf = (float)x;
          float ahi = 0.0f, alo = 0.0f;
          for (int s = 0; s < CH; ++s) {
            if (y >= s_geom[s] && y <= s_geom[CH + s] &&
                x >= s_geom[2 * CH + s] && x <= s_geom[3 * CH + s]) {
              const float tent = s_aux[s] - s_aux[CH + s] * fabsf(xf - s_aux[2 * CH + s]);
              const float m = fmaxf(fminf(tent, plat255), 0.0f);
              const float mi = floorf(m);
              ahi += mi;
              alo += bf16_round(m - mi);
            }
          }
          pending = fmaxf(pending, (ahi + alo) * (float)(1.0 / 255.0));
        }
      } else if (kind == KIND_STROKE) {
        const int cnt = ci[CI_CNT];
        const int m = (int)ceilf(hw) + 2;
        const int by = y / RB;
        const int col0 = (x >> 7) << 7;
        for (int sg = 0; sg < cnt; ++sg) {
          const int p1x = s_geom[sg], p1y = s_geom[CH + sg];
          const int p2x = s_geom[2 * CH + sg], p2y = s_geom[3 * CH + sg];
          const int ylo = max(min(p1y, p2y) - m, 0);
          const int yhi = min(max(p1y, p2y) + m, ts - 1);
          const int blk0 = ylo / RB;
          const int nbs = (p1x == p2x && p1y == p2y) ? 0 : floor_div(yhi - blk0 * RB, RB) + 1;
          if (by < blk0 || by >= blk0 + nbs) continue;
          if (!(min(p1x, p2x) - m < col0 + 128 && max(p1x, p2x) + m >= col0)) continue;
          const Seg seg = load_seg(s_geom, s_aux, sg);
          const int pidx = s_sprof[sg];
          const Prof P{p.profiles + (size_t)pidx * DS * 8, p.prof_total[pidx]};
          bool any_orig = false;
#pragma unroll
          for (int i = 0; i < DS; ++i) {
            any_orig = any_orig || (P.row[i * 8] < 1e30f && P.row[i * 8 + 5] > 0.0f);
          }
          pending = fmaxf(pending, stroke_segment_alpha(seg, P, any_orig, s_trav[sg], hw,
                                                        opacity, x, y));
        }
      } else {  // KIND_STROKE_SOLID, KIND_STROKE_DASH: work items
        const bool dashed = kind == KIND_STROKE_DASH;
        const int* it = p.items + (size_t)ch * p.it_width;
        const int* sec = p.isec + (size_t)ch * NSEC;
        const int half = x >> 7;
        if (half < item_halves) {
          for (int fam = 0; fam < 3; ++fam) {
            const int slot = 4 * fam + half;
            const int start = slot > 0 ? sec[slot - 1] : 0;
            const int n4 = ((sec[slot] - start) >> 2) << 2;
            const bool steep = fam == 1;
            const int mode = fam == 2 ? MODE_DEAD : MODE_ALIVE;
            for (int i = 0; i < n4; ++i) {
              const int w = it[start + i];
              const int rb = (w >> 8) & 63;
              const bool hit = steep ? ((y >> 4) == rb && ((x >> 6) & 1) == ((i & 3) >> 1))
                                     : ((y >> 3) == rb);
              if (!hit) continue;
              const int sg = w & 127;
              const Seg seg = load_seg(s_geom, s_aux, sg);
              const int pidx = dashed ? s_sprof[sg] : 0;
              const Prof P{p.profiles + (size_t)pidx * DS * 8, p.prof_total[pidx]};
              pending = fmaxf(pending, stroke_item_alpha(seg, mode, dashed, P, s_trav[sg], hw,
                                                         opacity, x, y));
            }
          }
        }
      }
    }

    if (ci[CI_LAST] == 1) {
      const int p0 = ci[CI_PRIM_Y0];
      const int pn = ci[CI_PRIM_NB];
      if (y >= p0 * RB && y < (p0 + pn) * RB) {
        const int pat = ci[CI_PAT];
        if (pat < 0) {
          const float a = pending;
          const float keep = 1.0f - a;
          acc_r = a * cf[CF_R] + keep * acc_r;
          acc_g = a * cf[CF_G] + keep * acc_g;
          acc_b = a * cf[CF_B] + keep * acc_b;
          acc_a = a + keep * acc_a;
          pending = 0.0f;
        } else {
          const size_t plane = (size_t)ts * ts;
          const float* pp = p.patterns + (size_t)pat * 4 * plane + (size_t)y * ts + x;
          const float pr = pp[0], pg = pp[plane], pb = pp[2 * plane], pa = pp[3 * plane];
          if (kind == KIND_LAYER) {
            const float keep = 1.0f - pa;
            acc_r = pr + keep * acc_r;
            acc_g = pg + keep * acc_g;
            acc_b = pb + keep * acc_b;
            acc_a = pa + keep * acc_a;
          } else {
            const float mask = pending;
            const float keep = 1.0f - mask * pa;
            acc_r = mask * pr + keep * acc_r;
            acc_g = mask * pg + keep * acc_g;
            acc_b = mask * pb + keep * acc_b;
            acc_a = mask * pa + keep * acc_a;
            pending = 0.0f;
          }
        }
      }
    }
  }

  const float mul = acc_a == 0.0f ? 0.0f : 1.0f / acc_a;
  const float accs[3] = {acc_r, acc_g, acc_b};
  const size_t plane = (size_t)ts * ts;
  uint8_t* o = p.out + (size_t)tile * 4 * plane + (size_t)y * ts + x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = 255.0f * accs[c] * mul;
    v = isnan(v) ? 0.0f : fminf(fmaxf(v, 0.0f), 255.0f);
    o[c * plane] = (uint8_t)(int)truncf(v);
  }
  o[3 * plane] = 255;
}

}  // namespace

extern "C" int osmr_render_planar(
    const int32_t* geom, const float* trav, const int32_t* sprof, const float* aux,
    const int32_t* items, int it_width, const int32_t* isec, const int32_t* chunk_i,
    const float* chunk_f, const float* profiles, const float* prof_total,
    const float* patterns, const float* canvas, const int32_t* tile_range,
    uint8_t* out, int n_tiles, int ts, void* stream) {
  Params p{geom, trav, sprof, aux, items, isec, chunk_i, chunk_f, profiles, prof_total,
           patterns, canvas, tile_range, out, it_width, ts};
  const dim3 grid(ts / BW, ts / BH, n_tiles);
  const dim3 block(BW, BH);
  render_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
