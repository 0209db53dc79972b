// Batched local-alignment scores on the anti-diagonal (wavefront)
// schedule for Hopper (sm_90a): queries of up to 128 codes, any
// substitution matrix of up to 31 letters, linear gap of any sign.
//
// Replaces swtpu/kernels/pallas/sw_wavefront.py  _kernel (pallas_call
// :110; entry sw_wavefront_pallas :179). Its plain version is
// swtpu_torch/kernels/sw_wavefront.py::sw_wavefront_plain, which repeats
// the TPU kernel step by step; this kernel gives the same scores, bit for
// bit, and replays kernels/sw_wavefront.py::wavefront_stream_mirror step
// for step.
//
// Design. A stream of P pairs runs back to back through NL = 16 lanes of
// a warp (two streams a warp, a half-warp each), lane l holding the R = 8
// query positions (rows) p = 8 l .. 8 l + 7;
// kernels/sw_wavefront.py::wavefront_stream picks P. The stream's
// target columns are its pairs' targets one after another, each followed
// by a separator block of s columns, R <= s < 2R, so that a pair's period
// T = m + s is a multiple of R. At step d position p computes stream
// column d - p: the cells of a step are independent cells of one
// anti-diagonal. A lane's R cells a step take their up and diagonal
// inputs from the position above (in the lane, or lane l - 1's last
// position through one __shfl_up_sync a step; the stream's first lane
// takes the row-0 boundary), their left input from their own last step.
// So a lane idles only at the head and tail of the whole stream (the
// NL - 1 iterations of R steps before its first pair reaches it and after
// its last pair has passed), not around every pair: the TPU schedule's
// rhombus overhang is paid once a stream, not once a pair.
//
// The cell. H is kept minus the gap (D = H - gap; the boundary's D is
// -gap) and the gap is folded into the scores, so a cell is one
// __vimax3_s32_relu(D_diag + S', D_left, D_up) (ptxas: VIADDMNMX.RELU and
// VIMNMX.RELU) and the subtract; the best is half a three-way max a cell
// (two running maxima a lane). The relu floors H, not D: the cell is
// max(0, H_diag + S, H_left - gap, H_up - gap) for a gap of either sign.
//
// Scores come from a lane table in shared memory, each entry held for
// every lane (word 32 x entry + lane), so a warp's lookups hit 32 banks
// whatever the codes. Rows: the A letters and the pad (codes >= A;
// positions past n). Columns: 0 the separator, 1..A the letters, A + 1
// the pad (codes >= A); the wrapper builds the entries
// (sw_wavefront.py::_stream_table): S + gap, pads -2^20 + gap, the
// separator -2^30 (under a negative gap the pad's -2^20 + gap). A
// position keeps its row's byte address (lane included) and adds the
// column's offset. The wrapper picks the table's
// form (sw_wavefront.py::wavefront_form) and passes it: by columns, or by
// pairs of columns (PAIRS, alphabets of up to 4 letters, DNA: 6 columns;
// entry (row, a, b) = (S'(row, a), S'(row, b)), 64 words, 46 KB), where a
// position looks up its scores of two steps with one 8-byte load at
// every other step, half the lookups and their adds. Every lookup is made
// a step ahead of its use, so its latency overlaps the step before.
//
// Pair boundaries (gap >= 0). Every position must see H = 0 to its left
// and diagonal at a pair's first column. Because T is a multiple of R and
// s >= R, once a pair each lane reaches a step (the last of an iteration
// of R steps, the same slot for every lane) at which all its R positions
// stand in the separator block, its first position on the block's last
// column: there it sets their D to -gap. Every later separator cell then
// computes exactly H = 0 (its left and up are 0, its diagonal + -2^30 is
// below 0), which is the next pair's column-0 boundary; separator cells
// before that step hold values at most a real cell's of the pair (gap >=
// 0). At the same step the lane switches its R positions to the next
// pair's query rows (no position reads its row again before the next
// pair reaches it; the first position's lookup made a step ahead is made
// again) and folds its best: the pair's maximum is carried down the lanes,
// one __shfl_up_sync an iteration (lane l forces one iteration after lane
// l - 1), each lane storing its running maximum into the stream's result
// slots in shared memory (the last lane's is the pair's score); the
// stream writes its P scores at the end. No atomics.
//
// A negative gap (the TPU schedule's own score). There H grows by |gap| a
// step along every gap chain, through the phantom rows past n and the
// padded columns past m, and the score the TPU kernel returns (and its
// plain version) is the best over all 128 positions and exactly
// ceil((n + m - 1) / 32) x 32 steps, above the oracle's. A separator cell
// would then outscore its pair, so the stream holds one pair (P = 1, the
// wrapper's rule), its separator and every column outside the target
// score as the TPU's padded columns (the table's column 0 is the pad's),
// no lane forces, the loop runs that step count, and the stream's 16
// lanes reduce their maxima by shuffles at the end. The boundary D = -gap
// and the cell are the same for either sign.
//
// Codes. The block stages each stream's query rows ([P, 128] row
// addresses) in shared memory; target columns flow through a ring of 256
// words a stream (R columns a group, one group an iteration a lane, lane
// l at group it - l): every 8 iterations the stream's lanes store the
// chunk they loaded 8 iterations before (byte loads of the [B, m] codes,
// mapped to columns: the separator, a letter or the pad) and load the
// next, so no load waits.
//
// Bound: int32 issue. The function needs 4.5 int32 ops a real cell (a
// lookup's add, the diagonal's add, the three-way max, the subtract and
// half a max for the best; 1.5 of them on the ALU pipe) and one lookup;
// with the table by pairs of columns 4.0 and half a lookup (an add and a
// lookup serve two cells). What the schedule adds: separator cells (s / T
// of a stream), the head and tail (NL - 1 iterations a stream), a shuffle
// and a select a lane a step, the code loads, the refill every 8
// iterations and the forcing step once a pair a lane (the warp runs it in
// nearly every iteration: its lanes force in turn). Under a negative gap
// the stream of one pair runs 128 x ceil((n + m - 1) / 32) x 32 cells,
// twice a 128 x 128 pair's real cells. chip_smoke.py phase 2 counts the
// loop as compiled.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int POS = 128;       // query positions a stream (n <= 128)
constexpr int R = 8;           // query positions a lane
constexpr int NL = POS / R;    // lanes a stream
constexpr int SPW = 32 / NL;   // streams a warp
constexpr int WARPS = 4;       // warps a block
constexpr int SPB = WARPS * SPW;  // streams a block
constexpr int CHUNK = 8;       // groups (iterations) a ring refill
constexpr int RING = 256;      // ring words a stream: >= (2 CHUNK + NL - 1) R, a power of 2
constexpr int MAX_CODES = 32;  // A + 1
constexpr int MAX_PAIRS = 16;  // pairs a stream (its lanes write their scores, one a lane)
constexpr int PAIR_MAX_LETTERS = 4;  // alphabets the table by pairs of columns takes (DNA)
constexpr int SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_PAIRS <= NL, "a stream's lanes write its scores, one a lane");
static_assert(WARPS * 32 == POS, "a thread a query position when the rows are staged");
static_assert(SPB * RING >= MAX_CODES * (MAX_CODES + 1), "the ring area stages the table");

__device__ __forceinline__ int lookup(int addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ int2 lookup2(int addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ void load_words(int (&dst)[R], const int32_t* src) {
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const int4 v = *reinterpret_cast<const int4*>(src + i);
    dst[i] = v.x;
    dst[i + 1] = v.y;
    dst[i + 2] = v.z;
    dst[i + 3] = v.w;
  }
}

template <bool PAIRS>
__global__ void __launch_bounds__(WARPS * 32)
sw_wavefront_kernel(const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
                    const int32_t* __restrict__ table, int A, int32_t* __restrict__ out,
                    int B, int n, int m, int P, int T, int gap, int iters) {
  constexpr int PER = CHUNK * R / NL;  // codes a lane loads a refill
  static_assert(RING >= (2 * CHUNK + NL - 1) * R, "the ring holds a lane's groups");
  extern __shared__ __align__(16) int32_t smem[];
  const int cols = A + 2;  // target columns: the separator, A letters, the pad
  // a row's bytes in the lane table: an entry a column (32 words), or with
  // PAIRS an entry a pair of columns (64 words: a lane's two scores)
  const int row_bytes = PAIRS ? cols * cols * 256 : cols * 128;
  const int tab_words = (A + 1) * row_bytes / 4;
  int32_t* qrow_all = smem + tab_words;         // [SPB][P][POS] row addresses
  int32_t* ring_all = qrow_all + SPB * P * POS;  // [SPB][RING] target values
  // [SPB][P + NL] result slots: a lane writes its running maximum at each
  // of its forcing steps, the last lane last (a lane forces at most P + NL
  // - 1 times)
  int32_t* res_all = ring_all + SPB * RING;
  // the wrapper's [A + 1, A + 2] table, staged in the ring area (free until
  // the ring starts) so the lane table is built from shared memory
  int32_t* staged = ring_all;
  for (int w = threadIdx.x; w < (A + 1) * cols; w += WARPS * 32) staged[w] = __ldg(table + w);
  __syncthreads();
  const int sep = staged[0];  // column 0's score: the separator's, or the pad's
  if constexpr (PAIRS) {
    // entry (q, a, b): (S'(q, a), S'(q, b)) at words 64 ((q cols + a) cols + b) + 2 lane
    for (int rw = threadIdx.x >> 5; rw < (A + 1) * cols; rw += WARPS) {
      const int sa = staged[rw], q0 = rw / cols * cols;
      for (int b = 0; b < cols; ++b)
        *reinterpret_cast<int2*>(smem + (rw * cols + b) * 64 + 2 * (threadIdx.x & 31)) =
            make_int2(sa, staged[q0 + b]);
    }
  } else {
    for (int w = threadIdx.x; w < tab_words; w += WARPS * 32) smem[w] = staged[w >> 5];
  }
  const int tab0 = static_cast<int>(__cvta_generic_to_shared(smem));
  // a thread a query position p, over every (stream, pair) row of the block
  // (loads unrolled, so they are in flight together)
  {
    const int p = threadIdx.x;
    int s = 0, k = 0;  // the row's stream in the block and pair in the stream
#pragma unroll 8
    for (int sp = 0; sp < SPB * P; ++sp) {
      const int b = blockIdx.x * SPB * P + sp;
      int qi = A;
      if (p < n && b < B) qi = min(static_cast<int>(qs[static_cast<size_t>(b) * n + p]), A);
      qrow_all[sp * POS + p] = tab0 + qi * row_bytes + (PAIRS ? 8 : 4) * (s % SPW * NL + p / R);
      if (++k == P) {
        k = 0;
        ++s;
      }
    }
  }
  __syncthreads();  // the staged table is read: the ring area is free

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane % NL;                     // lane in the stream
  const int sb = warp * SPW + lane / NL;        // stream in the block
  const int b0 = (blockIdx.x * SPB + sb) * P;   // the stream's first pair
  int32_t* ring = ring_all + sb * RING;
  const int32_t* qrow = qrow_all + sb * P * POS + sl * R;

  // the ring's loader: this lane's PER columns of a chunk of CHUNK groups,
  // (kk, jj) = (pair, column) of the first of them
  int kk = sl * PER / T, jj = sl * PER - kk * T;
  const int dk = CHUNK * R / T, dj = CHUNK * R - dk * T;
  const int kvalid = min(P, B - b0);  // the stream's pairs in the batch
  const uint8_t* tp = ts + (static_cast<long long>(b0) + kk) * m + jj;  // code (kk, jj)
  // a lane's PER columns never straddle two pairs: PER divides R, R
  // divides T, and the first of them is a multiple of PER
  static_assert(R % PER == 0, "a lane's columns of a chunk lie in one pair");
  int raw[PER], raw1[PER];  // codes loaded, -1 for a separator column
  auto fetch = [&](int (&dst)[PER]) {
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[i] = jj + i < m && kk < kvalid ? tp[i] : -1;
    jj += dj;
    kk += dk;
    tp += dk * m + dj;
    if (jj >= T) {
      jj -= T;
      ++kk;
      tp += m - T;
    }
  };
  // a ring word: the column's offset in the lane table (with PAIRS, in
  // units of a column pair's entry: the loop combines two)
  auto put = [&](int chunk, const int (&src)[PER]) {
    int32_t* w = ring + ((chunk * CHUNK * R + sl * PER) & (RING - 1));
    int v[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = min(src[i] + 1, A + 1) << (PAIRS ? 8 : 7);
    if constexpr (PER == 4) {
      *reinterpret_cast<int4*>(w) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) w[i] = v[i];
    }
  };
  for (int w = sl; w < RING; w += NL) ring[w] = 0;  // separators before the stream
  __syncwarp();
  fetch(raw);
  fetch(raw1);
  put(0, raw);
  put(1, raw1);
  fetch(raw);  // chunk 2, stored at iteration CHUNK
  __syncthreads();
  if ((blockIdx.x * SPB + warp * SPW) * P >= B) return;  // the warp has no pair

  const int TG = T / R;  // iterations a pair
  int qo[R];             // the positions' table rows (byte addresses)
  load_words(qo, qrow);
  int h1[R], h2[R];      // D at steps d - 1 and d - 2
#pragma unroll
  for (int r = 0; r < R; ++r) h1[r] = h2[r] = -gap;
  int up1 = -gap, up2 = -gap;  // D of the position above this lane's first, d - 1 / d - 2
  // kf: pairs this lane has left; under a negative gap no lane forces
  int best0 = 0, best1 = 0, acc = 0, cnt = gap < 0 ? INT_MAX : sl + TG, kf = 0;
  int32_t* res = res_all + sb * (P + NL);
  const int32_t* qnext = qrow + (P > 1 ? POS : 0);  // the rows the next pair takes
  const int32_t* qlast = qrow + (P - 1) * POS;
  // prev / cur / nxt: the ring words (target values) the first position
  // took in the last iteration / takes in this one / in the next; pprev /
  // pcur (PAIRS): the entries of its pairs of steps (u, u + 1)
  int prev[R], cur[R], nxt[R], pprev[R], pcur[R];
  int2 nx[R];  // a position's lookup, made a step ahead (PAIRS: two steps' scores)
  int s2[R];   // PAIRS: the second score of a position's last lookup
  auto look = [&](int addr) { return PAIRS ? lookup2(addr) : make_int2(lookup(addr), 0); };
#pragma unroll
  for (int r = 0; r < R; ++r) {
    prev[r] = pprev[r] = 0;
    s2[r] = sep;  // the head's columns
  }
  load_words(cur, ring + ((-sl * R) & (RING - 1)));
  load_words(nxt, ring + (((1 - sl) * R) & (RING - 1)));
#pragma unroll
  for (int r = 0; r < R; r += PAIRS ? 2 : 1)
    nx[r] = look(qo[r] + (r ? 0 : PAIRS ? cur[0] * cols + cur[1] : cur[0]));
  // two iterations a pass (the rotation of the target values needs no
  // moves); the lane table by columns keeps one (two spill at 80 registers)
#pragma unroll (PAIRS ? 2 : 1)
  for (int it = 0; it < iters; ++it) {
    if (it > 0 && (it & (CHUNK - 1)) == 0) {  // refill the ring a chunk ahead
      __syncwarp();
      put(it / CHUNK + 1, raw);
      fetch(raw);
      __syncwarp();
    }
    load_words(nxt, ring + (((it + 1 - sl) * R) & (RING - 1)));
    if constexpr (PAIRS) {
#pragma unroll
      for (int u = 0; u < R; ++u) pcur[u] = cur[u] * cols + (u + 1 < R ? cur[u + 1] : nxt[0]);
    }
    // the first position's value at the next iteration's first step
    const int c0 = PAIRS ? nxt[0] * cols + nxt[1] : nxt[0];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      // position r holds the value the first position took r steps ago;
      // with PAIRS it looks up its scores of two steps at every other step
      int sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!PAIRS || ((u - r) & 1) == 0) {
          sc[r] = nx[r].x;
          s2[r] = nx[r].y;
        } else {
          sc[r] = s2[r];
        }
      }
      // the next step's lookups, a step ahead of their use
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int v = u + 1;
        if (PAIRS && ((v - r) & 1)) continue;
        int val;
        if (v >= R)  // the next iteration's first step
          val = r == 0 ? c0 : PAIRS ? pcur[R - r] : cur[R - r];
        else if (v >= r)
          val = PAIRS ? pcur[v - r] : cur[v - r];
        else
          val = PAIRS ? pprev[R + v - r] : prev[R + v - r];
        nx[r] = look(qo[r] + val);
      }
      int h[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int dg = r ? h2[r - 1] : up2;
        const int upv = r ? h1[r - 1] : up1;
        h[r] = __vimax3_s32_relu(dg + sc[r], h1[r], upv);
      }
#pragma unroll
      for (int r = 0; r < R; r += 2) {
        best0 = max(best0, h[r]);
        best1 = max(best1, h[r + 1]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        h2[r] = h1[r];
        h1[r] = h[r] - gap;
      }
      const int from = __shfl_up_sync(FULL, h1[R - 1], 1, NL);
      up2 = up1;
      up1 = sl ? from : -gap;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      prev[r] = cur[r];
      cur[r] = nxt[r];
      pprev[r] = pcur[r];
    }
    const int acc_in = __shfl_up_sync(FULL, acc, 1, NL);
    if (--cnt == 0) {  // every position of the lane stands in the separator block
      cnt = TG;
      acc = __vimax3_s32(sl ? acc_in : 0, best0, best1);
      best0 = best1 = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) h1[r] = -gap;
      res[kf++] = acc;
      load_words(qo, qnext);  // past the last pair: its rows again, never read
      if (qnext != qlast) qnext += POS;
      nx[0] = look(qo[0] + c0);  // the first position enters the next pair
    }
  }
  if (gap < 0) {  // one pair: the best over the stream's positions and steps
    int v = max(best0, best1);
#pragma unroll
    for (int o = NL / 2; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o, NL));
    if (sl == 0 && kvalid > 0) out[b0] = v;
    return;
  }
  __syncwarp();
  if (sl < kvalid) out[b0 + sl] = res[sl];  // P <= NL
}

// Bytes of shared memory a block takes: the lane table and, per stream,
// its query rows, ring and result slots (sw_wavefront.py::stream_smem).
size_t block_smem(int A, int P, bool pairs) {
  const size_t cols = A + 2;
  return 4 * ((A + 1) * (pairs ? cols * cols * 64 : cols * 32) +
              static_cast<size_t>(SPB) * (P * POS + RING + P + NL));
}

template <bool PAIRS>
int launch(const void* qs, const void* ts, const void* table, int A, void* out, int B,
           int n, int m, int P, int gap, size_t smem, cudaStream_t stream) {
  const int T = m + R + (R - m % R) % R;
  // iterations of R steps: a negative gap runs the TPU's step count,
  // n + m - 1 diagonals padded to 32 (sw_wavefront.py::wavefront_steps)
  const int steps = n + m - 1 <= 0 ? 0 : (n + m - 1 + 31) / 32 * 32;
  const int iters = gap < 0 ? steps / R : P * (T / R) + NL - 1;
  const long long streams = (static_cast<long long>(B) + P - 1) / P;
  const int blocks = static_cast<int>((streams + SPB - 1) / SPB);
  if (smem > 48 * 1024) {  // raise the kernel's limit once a device, to the most asked
    static int granted[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEVICES || static_cast<int>(smem) > granted[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          sw_wavefront_kernel<PAIRS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < MAX_DEVICES) granted[dev] = static_cast<int>(smem);
    }
  }
  sw_wavefront_kernel<PAIRS><<<blocks, WARPS * 32, smem, stream>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
      static_cast<const int32_t*>(table), A, static_cast<int32_t*>(out), B, n, m, P, T, gap,
      iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel with P = `pairs` pairs a stream and the lane table
// by pairs of columns when `paired` is nonzero, on `stream`, with the
// block's shared memory `smem` bytes as the wrapper counts it
// (sw_wavefront.py::stream_smem); returns cudaGetLastError().
// cudaErrorInvalidValue for n outside 0..128, an alphabet of more than 31
// letters (paired: 4), pairs outside 1..16, more than one pair a stream
// under a negative gap (a separator cell would then outscore the pair's
// cells) or an `smem` that is not the layout's. Pointers: qs [B, n] and
// ts [B, m] uint8 codes, table [A + 1, A + 2] int32
// (sw_wavefront.py::_stream_table: the scores + gap, column 0 the
// separator, or under a negative gap the pad, column A + 1 and row A the
// pad), out [B] int32. All on one device, contiguous; the wrapper checks
// that.
int swtpu_sw_wavefront(const void* qs, const void* ts, const void* table, int A, void* out,
                       int B, int n, int m, int pairs, int paired, int gap, long long smem,
                       void* stream) {
  if (n < 0 || n > POS || A < 1 || A + 1 > MAX_CODES || (paired && A > PAIR_MAX_LETTERS) ||
      B < 0 || m < 0 || pairs < 1 || pairs > MAX_PAIRS || (gap < 0 && pairs != 1) ||
      smem != static_cast<long long>(block_smem(A, pairs, paired)) || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return paired ? launch<true>(qs, ts, table, A, out, B, n, m, pairs, gap, smem, s)
                : launch<false>(qs, ts, table, A, out, B, n, m, pairs, gap, smem, s);
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
