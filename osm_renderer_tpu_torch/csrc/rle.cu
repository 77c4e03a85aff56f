// Run-length wire kernels for Hopper (sm_90a): one launch per wire,
// straight from the planar pixels.
//
// Replace the Pallas TPU kernels of osm_renderer_tpu/ops/rle_pallas.py:
//   * osmr_rle_wire_v1 (the v1 wire): _emit_kernel, launched by
//     _emit_call via _emit_runs and encode_batch_wire_pallas;
//   * osmr_rle_wire_v2 (the v2 wire): _emit_kernel followed by
//     _expand_kernel (launched by _expand_call), the chain of
//     encode_wire_indexed_pallas, fused: the runs never leave the SM.
// The wire formats are those of osm_renderer_tpu/ops/rle.py
// (encode_batch_wire, encode_wire_indexed); ops/rle_cuda.py holds the
// wrappers and the plain versions these are held to bit for bit,
// header, content and zero tail alike, on fitting and overflowing caps.
// The wrappers count a v1 wire as one emit launch and a v2 wire as one
// emit and one expand, since its one kernel does the work of both TPU
// kernels.
//
// What bounds them on the H100: bytes.  Each reads 3 bytes a pixel (the
// RGB planes; alpha is never read) and writes the live wire: 4 bytes a
// run (v1), or 2 bytes a palette hit and 6 a literal (v2).  There is
// almost no arithmetic, so the design reads every pixel once with wide
// loads and writes every wire word once, in one launch with no
// intermediate array in device memory.  What holds it above that bound
// is latency, not bytes: each CTA's path is serial (ticket, loads,
// scan, a look-back that waits for its slowest predecessor's loads,
// writes), and a 97-tile batch at 256 px is about two waves of CTAs, so
// the second wave's loads do not overlap the first wave's look-back.
//
// Design.  One CTA of 256 threads per segment of whole 256-pixel blocks
// (BLOCK, the format's forced run boundary): 16 blocks (4096 pixels,
// 16 a thread, one 16-byte load from each colour plane) when ts * ts is
// a multiple of 4096 and the batch is 16-byte aligned, else one block
// (one pixel a thread).  A segment never straddles a tile.  A run
// starts at a colour change or at a block's first pixel.  Each thread
// counts the runs starting in its pixels; a warp scan and a block scan
// give each run its rank in the segment, and the runs go to shared
// memory by rank, so run r's length is start[r+1] - start[r].  The v2
// wire then looks each run's colour up in the palette: its index is the
// number of table entries below the colour, by a branchless 8-step
// binary search over the table in shared memory (1 word on a hit, 3 for
// a literal escape).  Each thread takes a contiguous share of the runs
// in rank order, so a thread whose pixels start many runs does not hold
// its warp, and runs LOOKUPS searches in lockstep so that their
// dependent shared loads overlap; table entry i sits at slot i + i / 32,
// so the probes of one search depth, a power of two apart, fall in
// distinct banks.  A second block scan gives each run its word offset
// in the segment.  Consecutive threads then write consecutive runs.
//
// Offsets across CTAs: the TPU kernels carried them across a sequential
// grid (the emit's VMEM carry, the expand's state_sm); CUDA blocks run
// in no order, so the segments' (runs, words) prefix is a single-pass
// scan by decoupled look-back.  A CTA takes its segment from a ticket
// counter when it starts, not from blockIdx, so every predecessor it
// waits on already holds an SM.  It publishes its aggregate, then its
// inclusive prefix, in one 64-bit status word (flag in bits 62-63,
// words in 31-61, runs in 0-30; the wrapper keeps 3 * T * ts * ts below
// 2**31); warp 0 reads 32 predecessors a probe and stops at the nearest
// inclusive prefix.  Tried on the H100 and slower or no faster: the
// whole CTA probing, 128 predecessors a warp probe, a backoff in the
// spin, persistent CTAs that claim their next segment ahead (a claimed
// segment publishes nothing until its CTA reaches it, and every later
// segment waits for it), and prefetching the batch into L2.
//
// The cap, exactly as the plain versions define it.  v1: runs at index
// >= rtot are not written; total_runs and n_runs[t] are uncapped.  v2:
// the plain version cuts the runs at min(total_runs, wcap) before
// counting words, so a run at index >= wcap counts no words, and a word
// at offset >= wcap is dropped, even inside a literal (a run's word
// offset is at least its index, so the word cap also drops every word
// of a run past the run cap).  The look-back carries uncapped prefixes,
// which equal the capped ones for every run below the cap.  Each
// segment adds the words of its runs below the cap to n_words[t] with
// atomicAdd, and raises total_words to its capped word prefix with
// atomicMax; the last segment raises it to total_runs, which gives
// total_words = max(words of the runs below the cap, total_runs).
//
// The wire and the scratch (ticket counter and status words) share one
// buffer, the scratch behind the wire; the C entries clear both with
// one cudaMemsetAsync on the caller's stream (the bar includes the
// wire's zero tail), then launch the kernel once.  Integer packing is
// done in uint32_t: (len - 1) << 24 with len = 256 and a 16-bit word in
// the high half both overflow int32.  The 16-bit words are stored as
// the uint16_t halves of the little-endian uint32 pairs, which is the
// same bits as lo | hi << 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = 256;  // pixels per forced-boundary block
constexpr int PAL_CAP = 255;
constexpr int32_t PAL_PAD = 0x7F7F7F7F;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LOOKUPS = 4;  // palette searches a thread runs in lockstep

// Segment status words of the look-back.
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long VALUE_MASK = (1ull << 62) - 1;
constexpr int WORD_SHIFT = 31;
constexpr unsigned long long RUN_MASK = (1ull << WORD_SHIFT) - 1;

// The table's entry i sits at shared slot i + i / 32: the binary
// search's probes at one depth lie a power of two apart, and unpadded
// they would share a few banks (up to 8-way conflicts).
constexpr int TAB_SLOTS = PAL_CAP + 1 + (PAL_CAP + 1) / 32;

__host__ __device__ constexpr int tab_slot(int i) { return i + (i >> 5); }

template <int PPT, bool V2>
struct Shared {
  static constexpr int SEG = THREADS * PPT;
  unsigned long long before;          // (runs, words) of the segments before
  unsigned int ticket;                // this CTA's segment
  uint32_t warp_sum[WARPS];
  uint32_t edge[WARPS];               // each warp's last pixel
  int32_t tab[TAB_SLOTS];             // the palette and PAL_PAD at tab_slot(i) (v2)
  uint32_t code[SEG];                 // run r: 0x00RRGGBB | palette index << 24 (v2; 255 = literal)
  uint16_t start[SEG + 1];            // run r's first pixel in the segment; SEG after the last
  uint16_t woff[V2 ? SEG + 1 : 1];    // run r's word offset in the segment; the segment's words after the last
};

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
}

// Exclusive prefix of x over the block's threads; *total gets the sum.
// Holds a barrier: every thread calls it.
__device__ __forceinline__ uint32_t block_scan(uint32_t x, uint32_t* warp_sum, uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t excl = incl - x;
  uint32_t sum = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const uint32_t s = warp_sum[w];
    excl += w < warp ? s : 0;
    sum += s;
  }
  *total = sum;
  return excl;
}

// Exclusive prefix of this CTA's segment, by decoupled look-back (warp
// 0 only).  Publishes the segment's inclusive prefix before returning.
__device__ unsigned long long look_back(unsigned long long* status, int seg,
                                        unsigned long long aggregate) {
  const int lane = threadIdx.x & 31;
  unsigned long long before = 0;
  if (seg > 0) {
    int newest = seg - 1;
    while (true) {
      const int pred = newest - lane;
      unsigned long long s;
      do {
        s = pred >= 0 ? load_status(status + pred) : FLAG_PREFIX;
      } while (!__all_sync(FULL, (s >> 62) != 0));
      const unsigned prefixes = __ballot_sync(FULL, (s >> 62) == 2);
      const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
      unsigned long long v = lane <= stop ? (s & VALUE_MASK) : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
      before += v;
      if (prefixes) break;
      newest -= 32;
    }
  }
  if (lane == 0) store_status(status + seg, FLAG_PREFIX | (before + aggregate));
  return before;
}

// One thread's pixels of a segment, as loaded: one 16-byte word a
// colour plane (PPT = 16) or one byte (PPT = 1).
template <int PPT>
struct Pixels {
  uint4 r, g, b;
};

template <>
struct Pixels<1> {
  uint32_t r, g, b;
};

template <int PPT>
__device__ __forceinline__ Pixels<PPT> load_pixels(const uint8_t* planar, int n_px, int seg) {
  constexpr int SEG = THREADS * PPT;
  const int segs_per_tile = n_px / SEG;
  const uint8_t* px = planar + static_cast<long long>(seg / segs_per_tile) * 4 * n_px
                      + static_cast<long long>(seg % segs_per_tile) * SEG + threadIdx.x * PPT;
  Pixels<PPT> p;
  if constexpr (PPT == 16) {
    p.r = __ldg(reinterpret_cast<const uint4*>(px));
    p.g = __ldg(reinterpret_cast<const uint4*>(px + n_px));
    p.b = __ldg(reinterpret_cast<const uint4*>(px + 2LL * n_px));
  } else {
    p.r = __ldg(px);
    p.g = __ldg(px + n_px);
    p.b = __ldg(px + 2LL * n_px);
  }
  return p;
}

// PPT: pixels a thread (16, or 1).  cap: rtot (v1) or wcap (v2).  One
// CTA a segment, taken by ticket when the CTA starts.
template <int PPT, bool V2>
__global__ void __launch_bounds__(THREADS) wire_kernel(
    const uint8_t* __restrict__ planar, int n_px, int n_tiles, int n_seg,
    const int32_t* __restrict__ table, int32_t* __restrict__ wire, int cap,
    unsigned long long* __restrict__ scratch) {
  constexpr int SEG = THREADS * PPT;
  __shared__ Shared<PPT, V2> sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* status = scratch + 1;
  if (tid == 0) sm.ticket = atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  if (V2) {
    for (int i = tid; i <= PAL_CAP; i += THREADS) {
      sm.tab[tab_slot(i)] = i < PAL_CAP ? table[i] : PAL_PAD;
    }
  }
  __syncthreads();
  const int seg = static_cast<int>(sm.ticket);
  const int tile = seg / (n_px / SEG);
  const Pixels<PPT> p = load_pixels<PPT>(planar, n_px, seg);

  // This thread's pixels as 0x00RRGGBB.
  uint32_t v[PPT];
  if constexpr (PPT == 16) {
    const uint32_t r[4] = {p.r.x, p.r.y, p.r.z, p.r.w};
    const uint32_t g[4] = {p.g.x, p.g.y, p.g.z, p.g.w};
    const uint32_t b[4] = {p.b.x, p.b.y, p.b.z, p.b.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = (byte_of(r, k) << 16) | (byte_of(g, k) << 8) | byte_of(b, k);
    }
  } else {
    v[0] = (p.r << 16) | (p.g << 8) | p.b;
  }

  // Run starts: a block's first pixel, or a colour change.
  uint32_t prev = __shfl_up_sync(FULL, v[PPT - 1], 1);
  if constexpr ((32 * PPT) % BLOCK != 0) {
    // A warp's first pixel may sit inside a block: it needs the last
    // pixel of the warp before.
    if (lane == 31) sm.edge[warp] = v[PPT - 1];
    __syncthreads();
    if (lane == 0 && warp > 0) prev = sm.edge[warp - 1];
  }
  const bool block_start = (tid * PPT) % BLOCK == 0;
  unsigned starts = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const bool s = k == 0 ? (block_start || v[0] != prev) : v[k] != v[k > 0 ? k - 1 : 0];
    starts |= static_cast<unsigned>(s) << k;
  }

  // Ranks, then this thread's runs to shared memory by rank.
  uint32_t seg_runs = 0;
  uint32_t rank = block_scan(static_cast<uint32_t>(__popc(starts)), sm.warp_sum, &seg_runs);
  const int n_runs = static_cast<int>(seg_runs);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if ((starts >> k) & 1u) {
      sm.start[rank] = static_cast<uint16_t>(tid * PPT + k);
      sm.code[rank] = v[k];
      ++rank;
    }
  }
  if (tid == 0) sm.start[n_runs] = static_cast<uint16_t>(SEG);
  uint32_t n_words = 0;
  if constexpr (V2) {
    // Palette lookups over the runs in rank order, a contiguous share a
    // thread (balanced however the runs sit among the pixels), then the
    // word offsets by a second block scan.
    __syncthreads();
    const int share = (n_runs + THREADS - 1) / THREADS;
    const int first = min(tid * share, n_runs);
    const int end = min(first + share, n_runs);
    uint32_t words = 0;
    for (int r0 = first; r0 < end; r0 += LOOKUPS) {
      // LOOKUPS searches in lockstep: their shared loads overlap.
      int32_t val[LOOKUPS];
      int pos[LOOKUPS];
#pragma unroll
      for (int j = 0; j < LOOKUPS; ++j) {
        val[j] = r0 + j < end ? static_cast<int32_t>(sm.code[r0 + j]) : 0;
        pos[j] = 0;
      }
#pragma unroll
      for (int half = (PAL_CAP + 1) / 2; half > 0; half >>= 1) {
#pragma unroll
        for (int j = 0; j < LOOKUPS; ++j) {
          pos[j] += sm.tab[tab_slot(pos[j] + half - 1)] < val[j] ? half : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < LOOKUPS; ++j) {
        if (r0 + j < end) {
          const bool hit = pos[j] < PAL_CAP && sm.tab[tab_slot(pos[j])] == val[j];
          sm.code[r0 + j] |= static_cast<uint32_t>(hit ? pos[j] : PAL_CAP) << 24;
          words += hit ? 1 : 3;
        }
      }
    }
    uint32_t woff = block_scan(words, sm.warp_sum, &n_words);
    for (int r = first; r < end; ++r) {
      sm.woff[r] = static_cast<uint16_t>(woff);
      woff += (sm.code[r] >> 24) < PAL_CAP ? 1 : 3;
    }
    if (tid == 0) sm.woff[n_runs] = static_cast<uint16_t>(n_words);
  }
  const unsigned long long aggregate =
      seg_runs | (static_cast<unsigned long long>(n_words) << WORD_SHIFT);
  if (warp == 0) {
    if (lane == 0 && seg > 0) store_status(status + seg, FLAG_AGGREGATE | aggregate);
    const unsigned long long before = look_back(status, seg, aggregate);
    if (lane == 0) sm.before = before;
  }
  __syncthreads();
  const long long runs_before = static_cast<long long>(sm.before & RUN_MASK);
  const long long words_before = static_cast<long long>(sm.before >> WORD_SHIFT);
  const bool last = seg == n_seg - 1;

  if constexpr (!V2) {
    // [T, total_runs, n_runs[T], packed[rtot]]
    uint32_t* packed = reinterpret_cast<uint32_t*>(wire + 2 + n_tiles);
    for (int r = tid; r < n_runs; r += THREADS) {
      const long long g = runs_before + r;
      if (g < cap) {
        const uint32_t len1 = static_cast<uint32_t>(sm.start[r + 1] - sm.start[r] - 1);
        packed[g] = (len1 << 24) | sm.code[r];
      }
    }
    if (tid == 0) {
      atomicAdd(wire + 2 + tile, n_runs);
      if (last) wire[1] = static_cast<int32_t>(runs_before + n_runs);
      if (seg == 0) wire[0] = n_tiles;
    }
  } else {
    // [T, total_words, total_runs, n_words[T], table[PAL_CAP], packed32[wcap / 2]]
    uint16_t* out = reinterpret_cast<uint16_t*>(wire + 3 + n_tiles + PAL_CAP);
    for (int r = tid; r < n_runs; r += THREADS) {
      const long long o = words_before + sm.woff[r];
      if (o >= cap) continue;
      const uint32_t len1 = static_cast<uint32_t>(sm.start[r + 1] - sm.start[r] - 1);
      const uint32_t c = sm.code[r];
      const uint32_t pi = c >> 24;
      if (pi < PAL_CAP) {
        out[o] = static_cast<uint16_t>((pi << 8) | len1);
      } else {
        const uint32_t val = c & 0xFFFFFFu;
        out[o] = static_cast<uint16_t>(0xFF00u | len1);
        if (o + 1 < cap) out[o + 1] = static_cast<uint16_t>(val & 0xFFFFu);
        if (o + 2 < cap) out[o + 2] = static_cast<uint16_t>(val >> 16);
      }
    }
    if (seg == 0 && tid < PAL_CAP) wire[3 + n_tiles + tid] = table[tid];
    if (tid == 0) {
      if (runs_before < cap) {
        // Words of this segment's runs below the run cap.
        const long long below = min(static_cast<long long>(n_runs), cap - runs_before);
        const int counted = sm.woff[below];
        if (counted) atomicAdd(wire + 3 + tile, counted);
        atomicMax(wire + 1, static_cast<int32_t>(words_before + counted));
      }
      if (last) {
        const int32_t total_runs = static_cast<int32_t>(runs_before + n_runs);
        wire[2] = total_runs;
        atomicMax(wire + 1, total_runs);
      }
      if (seg == 0) wire[0] = n_tiles;
    }
  }
}

// Records `event` (a CUDA timing event of the caller's, or null) on `s`:
// the entries stamp one just before their memset and one just after
// their launch, so a pair holds their device time and no host code.
void stamp(void* event, cudaStream_t s) {
  if (event != nullptr) cudaEventRecord(static_cast<cudaEvent_t>(event), s);
}

// Buffer layout, in int32 words: the wire (wire_words, padded to an even
// count), then the scratch: the ticket counter (one uint64) and one
// status word a segment.  One memset clears both.
template <bool V2>
int launch_wire(const uint8_t* planar, int n_tiles, int ts, int seg_px, const int32_t* table,
                int32_t* buf, long long wire_words, int cap, void* stream, void* t_start,
                void* t_end) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_px = static_cast<long long>(ts) * ts;
  const bool wide = seg_px == THREADS * 16;
  if (n_tiles < 1 || cap < 1 || (!wide && seg_px != THREADS) || n_px % seg_px != 0
      || 3 * n_tiles * n_px >= (1LL << 31)
      || (wide && reinterpret_cast<uintptr_t>(planar) % 16 != 0)
      || reinterpret_cast<uintptr_t>(buf) % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_seg = static_cast<int>(n_tiles * n_px / seg_px);
  const long long lead = wire_words + wire_words % 2;
  auto* scratch = reinterpret_cast<unsigned long long*>(buf + lead);
  stamp(t_start, s);
  cudaError_t err = cudaMemsetAsync(
      buf, 0, static_cast<size_t>(lead + 2 * (1 + static_cast<long long>(n_seg))) * 4, s);
  if (err != cudaSuccess) {
    stamp(t_end, s);
    return static_cast<int>(err);
  }
  if (wide) {
    wire_kernel<16, V2><<<n_seg, THREADS, 0, s>>>(planar, static_cast<int>(n_px), n_tiles, n_seg,
                                                 table, buf, cap, scratch);
  } else {
    wire_kernel<1, V2><<<n_seg, THREADS, 0, s>>>(planar, static_cast<int>(n_px), n_tiles, n_seg,
                                                table, buf, cap, scratch);
  }
  err = cudaGetLastError();
  stamp(t_end, s);
  return static_cast<int>(err);
}

}  // namespace

// planar: (T, 4, ts, ts) u8.  seg_px: pixels a segment, 4096 (ts * ts a
// multiple of 4096, planar 16-byte aligned) or 256.  buf: the v1 wire,
// (2 + T + rtot,) i32, padded to an even count, then the scratch, 2 + 2 *
// (T * ts * ts / seg_px) i32; 8-byte aligned.  t_start, t_end: CUDA
// timing events recorded just before the memset and just after the
// launch, or null.
extern "C" int osmr_rle_wire_v1(const uint8_t* planar, int n_tiles, int ts, int seg_px,
                                int32_t* buf, int rtot, void* stream, void* t_start,
                                void* t_end) {
  return launch_wire<false>(planar, n_tiles, ts, seg_px, nullptr, buf, 2LL + n_tiles + rtot,
                            rtot, stream, t_start, t_end);
}

// As osmr_rle_wire_v1, with table: (255,) palette, sorted ascending, and
// buf: the v2 wire, (3 + T + 255 + wcap / 2,) i32 (wcap even), then the
// scratch.
extern "C" int osmr_rle_wire_v2(const uint8_t* planar, int n_tiles, int ts, int seg_px,
                                const int32_t* table, int32_t* buf, int wcap, void* stream,
                                void* t_start, void* t_end) {
  return launch_wire<true>(planar, n_tiles, ts, seg_px, table, buf,
                           3LL + n_tiles + PAL_CAP + wcap / 2, wcap, stream, t_start, t_end);
}
