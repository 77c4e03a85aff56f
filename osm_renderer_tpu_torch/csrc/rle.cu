// Run-length wire kernels for Hopper (sm_90a): run emit (v1 wire) and
// palette expand (v2 wire).
//
// Replace the Pallas TPU kernels of osm_renderer_tpu/ops/rle_pallas.py:
//   * run emit: _emit_kernel, launched by _emit_call via _emit_runs;
//   * palette expand: _expand_kernel, launched by _expand_call via
//     encode_wire_indexed_pallas.
// The wire formats are those of osm_renderer_tpu/ops/rle.py
// (encode_batch_wire, encode_wire_indexed); ops/rle_cuda.py builds the
// wire headers around these kernels and holds their plain versions.
//
// Design.  A run never crosses a 256-pixel block (BLOCK), so the run
// emit is block-local: one CUDA block of 256 threads per pixel block,
// one thread per pixel.  A thread packs its pixel to 0x00RRGGBB and
// flags a run start at lane 0 or on a colour change; a warp ballot and
// a prefix over the 8 warp counts give each start its rank; run starts
// go to shared memory by rank, so run r's length is start[r+1] -
// start[r] (256 - start for the block's last run).  Run r of block b is
// written at off[b] + r, where off is the exclusive prefix sum of the
// per-block run counts (the counting kernel below, then one cumsum in
// the wrapper, as the JAX package left its prepass to XLA).  The TPU
// kernel's VMEM carry, lane rotations and chunked DMA existed because
// its grid ran in order and Mosaic wants aligned DMA; blocks here are
// independent and write their runs directly.
//
// The expand takes two passes because the TPU kernel's running word
// offset (state_sm) has no counterpart across CUDA blocks: the first
// gives each live run its word count (1 on a palette hit, 3 for a
// literal escape, 0 past total_runs), the wrapper takes the exclusive
// cumsum, and the second writes each run's words at its offset.  The
// palette index is the number of table entries below the colour, found
// by binary search over the table in shared memory with integer
// compares (the TPU kernel's f32 compares were an artefact of its
// vector unit).
//
// Integer packing is done in uint32_t: (len - 1) << 24 with len = 256
// and a 16-bit word in the high half both overflow int32.  The 16-bit
// words are stored as the uint16_t halves of the little-endian uint32
// pairs, which is the same bits as lo | hi << 16.
//
// Bounds.  Every write is masked by the cap (rtot runs, wcap words), so
// a batch that overflows its cap stays in bounds; the wrapper's header
// then reports a total above the cap and the host reads the raw planar
// batch instead.
//
// What bounds them on the H100: bytes moved.  The emit reads 3 bytes a
// pixel (the count pass reads them again) and writes 4 bytes a run; the
// expand reads 4 bytes a run twice and writes 2 or 6 bytes a run.  Both
// are simple on purpose: no vectorized loads, no fusion of the count
// pass, the emit and the expand.  Making them fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;   // pixels per forced-boundary block = threads
constexpr int WARPS = BLOCK / 32;
constexpr int PAL_CAP = 255;
constexpr int32_t PAL_PAD = 0x7F7F7F7F;

struct BlockRuns {
  uint32_t v;       // this thread's pixel, 0x00RRGGBB
  bool start;       // a run starts here
  int rank;         // runs starting before this pixel in the block
  int total;        // runs in the block
};

// One pixel per thread of the calling block's 256-pixel block b.
// `sv` (BLOCK) receives the block's pixels, `wsum` (WARPS) the per-warp
// run-start counts.
__device__ BlockRuns block_runs(const uint8_t* planar, int n_px, int blocks_per_tile,
                                uint32_t* sv, int* wsum) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long t = b / blocks_per_tile;
  const long long p = (b % blocks_per_tile) * BLOCK + tid;
  const uint8_t* base = planar + t * 4 * (long long)n_px;
  BlockRuns r;
  r.v = (static_cast<uint32_t>(base[p]) << 16) | (static_cast<uint32_t>(base[n_px + p]) << 8)
        | static_cast<uint32_t>(base[2LL * n_px + p]);
  sv[tid] = r.v;
  __syncthreads();
  r.start = tid == 0 || sv[tid - 1] != r.v;
  const unsigned ballot = __ballot_sync(0xffffffffu, r.start);
  if (lane == 0) wsum[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  int total = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? wsum[w] : 0;
    total += wsum[w];
  }
  r.rank = before + __popc(ballot & ((1u << lane) - 1u));
  r.total = total;
  return r;
}

__global__ void __launch_bounds__(BLOCK) count_runs_kernel(
    const uint8_t* planar, int n_px, int blocks_per_tile, int32_t* nb) {
  __shared__ uint32_t sv[BLOCK];
  __shared__ int wsum[WARPS];
  const BlockRuns r = block_runs(planar, n_px, blocks_per_tile, sv, wsum);
  if (threadIdx.x == 0) nb[blockIdx.x] = r.total;
}

__global__ void __launch_bounds__(BLOCK) emit_runs_kernel(
    const uint8_t* planar, int n_px, int blocks_per_tile, const int32_t* off,
    uint32_t* out, int rtot) {
  __shared__ uint32_t sv[BLOCK];
  __shared__ int wsum[WARPS];
  __shared__ int starts[BLOCK];
  const BlockRuns r = block_runs(planar, n_px, blocks_per_tile, sv, wsum);
  if (r.start) starts[r.rank] = threadIdx.x;
  __syncthreads();
  const int k = threadIdx.x;  // this thread writes run k of the block
  if (k >= r.total) return;
  const int s = starts[k];
  const int e = k + 1 < r.total ? starts[k + 1] : BLOCK;
  const long long idx = static_cast<long long>(off[blockIdx.x]) + k;
  if (idx < rtot) {
    out[idx] = (static_cast<uint32_t>(e - s - 1) << 24) | sv[s];
  }
}

// Palette index of `val`: entries of the 256-entry table (255 sorted
// entries plus PAL_PAD) that are < val.  A hit needs the entry there to
// equal val.
__device__ int palette_index(const int32_t* tab, int32_t val) {
  int lo = 0;
  int hi = PAL_CAP + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid] < val) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ void load_table(const int32_t* table, int32_t* tab) {
  for (int i = threadIdx.x; i <= PAL_CAP; i += blockDim.x) {
    tab[i] = i < PAL_CAP ? table[i] : PAL_PAD;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(256) word_counts_kernel(
    const uint32_t* runs, const int32_t* total_runs, int n, const int32_t* table,
    int32_t* wc) {
  __shared__ int32_t tab[PAL_CAP + 1];
  load_table(table, tab);
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  int count = 0;
  if (j < *total_runs) {
    const int32_t val = static_cast<int32_t>(runs[j] & 0xFFFFFFu);
    const int pi = palette_index(tab, val);
    count = (pi < PAL_CAP && tab[pi] == val) ? 1 : 3;
  }
  wc[j] = count;
}

__global__ void __launch_bounds__(256) expand_words_kernel(
    const uint32_t* runs, const int32_t* total_runs, int n, const int32_t* table,
    const int32_t* woff, uint16_t* words, int wcap) {
  __shared__ int32_t tab[PAL_CAP + 1];
  load_table(table, tab);
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n || j >= *total_runs) return;
  const uint32_t run = runs[j];
  const uint32_t val = run & 0xFFFFFFu;
  const uint32_t len1 = run >> 24;
  const int pi = palette_index(tab, static_cast<int32_t>(val));
  const long long o = woff[j];
  if (pi < PAL_CAP && tab[pi] == static_cast<int32_t>(val)) {
    if (o < wcap) words[o] = static_cast<uint16_t>((static_cast<uint32_t>(pi) << 8) | len1);
  } else {
    if (o < wcap) words[o] = static_cast<uint16_t>(0xFF00u | len1);
    if (o + 1 < wcap) words[o + 1] = static_cast<uint16_t>(val & 0xFFFFu);
    if (o + 2 < wcap) words[o + 2] = static_cast<uint16_t>(val >> 16);
  }
}

}  // namespace

// planar: (T, 4, ts, ts) u8.  nb: (T * ts * ts / 256,) run counts per block.
extern "C" int osmr_rle_count_runs(const uint8_t* planar, int n_tiles, int ts, int32_t* nb,
                                   void* stream) {
  const int n_px = ts * ts;
  const int blocks_per_tile = n_px / BLOCK;
  const unsigned grid = static_cast<unsigned>(n_tiles) * blocks_per_tile;
  count_runs_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      planar, n_px, blocks_per_tile, nb);
  return static_cast<int>(cudaGetLastError());
}

// off: exclusive prefix sum of nb.  out: (rtot,) packed runs; slots the
// batch does not fill are left as they were.
extern "C" int osmr_rle_emit_runs(const uint8_t* planar, int n_tiles, int ts,
                                  const int32_t* off, uint32_t* out, int rtot,
                                  void* stream) {
  const int n_px = ts * ts;
  const int blocks_per_tile = n_px / BLOCK;
  const unsigned grid = static_cast<unsigned>(n_tiles) * blocks_per_tile;
  emit_runs_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      planar, n_px, blocks_per_tile, off, out, rtot);
  return static_cast<int>(cudaGetLastError());
}

// runs: (n,) packed runs, live below *total_runs (a device scalar).
// table: (255,) sorted palette.  wc: (n,) words per run.
extern "C" int osmr_rle_word_counts(const uint32_t* runs, const int32_t* total_runs, int n,
                                    const int32_t* table, int32_t* wc, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  word_counts_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      runs, total_runs, n, table, wc);
  return static_cast<int>(cudaGetLastError());
}

// woff: exclusive prefix sum of wc.  words: (wcap,) u16; words the
// batch does not fill are left as they were.
extern "C" int osmr_rle_expand_words(const uint32_t* runs, const int32_t* total_runs, int n,
                                     const int32_t* table, const int32_t* woff,
                                     uint16_t* words, int wcap, void* stream) {
  const unsigned grid = static_cast<unsigned>((n + 255) / 256);
  expand_words_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      runs, total_runs, n, table, woff, words, wcap);
  return static_cast<int>(cudaGetLastError());
}
