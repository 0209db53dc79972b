// Batched Smith-Waterman in packed bf16 for Hopper (sm_90a): the
// reduced-precision tier of local-alignment scores, uniform scoring,
// linear gap.
//
// Replaces swtpu/kernels/pallas/sw_bf16.py _kernel (pallas_call :134, in
// _sw_bf16_impl). The TPU kernel doubles its lane count by running the
// DP in bfloat16 on (16, 128) tiles; here each thread runs two pairs at
// once in the two halves of a 32-bit word: pair 2k in the low half, pair
// 2k + 1 in the high half. For an odd batch the last thread's high half
// runs a pad pair of its own (query code 4, target code 5) whose score is
// not written, so the batch is never copied.
//
// Design. A thread reads its two pairs' codes as the caller holds them,
// [B, n] / [B, m] uint8 (no transposes): its target rows four codes at a
// time (one 32-bit load a pair when m % 4 == 0 and the rows are 4-byte
// aligned), spread into the two 16-bit halves with prmt, and its query
// rows once a sweep. Rows outer, ROWS = 16 query rows a sweep in
// registers, as a skewed tile: at step s row r computes column s - r
// from its own left state and from the state row r - 1 had a step
// earlier (its up) and two steps earlier (its diagonal), so the 16 cells
// of a step are independent; the unskewed tile ran its 8 rows as one
// chain of three dependent packed ops a row. The padded width mp is a
// multiple of 16, so every sweep opens with 16 steps in which row s
// starts at step s, runs whole groups of four steps and closes with 15
// steps in which row r ends at step mp + r - 1: the rows of each step are
// compile-time ranges and no cell is masked. The TPU wrapper's padding is
// made here: rows n..np - 1 (np = n rounded up to 8) are pad rows of code
// 4, columns m..mp - 1 pad columns of code 5; rows np.. of the last sweep
// (np % 16 == 8) hold a code no target byte equals and are not tracked
// apart: a cell's H never exceeds the largest H above or left of it plus
// its score, so such rows stay below the best. Row ROWS - 1 hands its H to
// the next sweep through an [mp, ceil(B / 2)] buffer of bf16 pairs, read
// by row 0 a group ahead (the first sweep reads none, the last writes
// none).
//
// Rounding. Every DP value is rounded to bf16 (round to nearest even)
// after every operation, as on the TPU (sw_bf16.py:96-110):
//   pre  = max(diag + s, 0)                  fma.rn.relu: one rounding
//   h    = max(pre, max(up, left) - gap)
//   best = max(best, pre)
// Each row keeps G = round(h - gap) beside h, and the cell is
// h = max(pre, G_left, G_up): rounding to nearest is monotone, so
// round(max(up, left) - gap) = max(round(up - gap), round(left - gap)),
// bit for bit. pre and h are never negative, and non-negative bf16 values
// order as their bit patterns do as signed 16-bit integers, while a
// negative G loses to pre either way, so the three-way max is one DPX
// __vimax3_s16x2 on both halves. The best is the largest h, which equals
// the largest pre: h is pre or a G, and a G is below the h it came from.
// Inside the exact range (every value an integer of magnitude <= 256
// after the wrapper divides the scoring by g = gcd(match, mismatch, gap))
// nothing rounds; above it the values drift, as on the TPU, and the
// promotion path re-runs every pair whose result reaches 255
// (batch/promote.py). bf16 cannot wrap, so there is no saturation logic.
//
// Scores. The TPU kernel tests for a match arithmetically,
// s = match - (match - mismatch) * min(d * d, 1) with d = q - t, so two
// equal codes match whatever they are, pads included: a query pad row
// (code 4) matches a target N (code 4). Here x = q ^ t per half (a code
// in the low byte), an indicator from one DPX op (min(x, 1), or
// max(1 - x, 0) from ~x), and one IMAD, indicator x step + base on the
// 32-bit word, selects between the two rescaled bf16 constants: base is
// the lower of the two bit patterns and step the difference, so no half
// carries into the other.
//
// Bound, by pipe. Two cells (a word) take five integer instructions (the
// xor, the indicator, the IMAD, the three-way max, half of a three-way
// max for the best, which folds two rows) and two packed bf16 ones
// (fma.relu, the subtract of G). The IMAD issues on the FMA pipe and the
// rest of the integer work on the ALU (64 lanes an SM a clock), so the
// ALU carries 1.75 instructions a cell and binds ahead of instruction
// issue (3.25 a cell at 128 lanes); chip_smoke.py's phase-2 probe
// measures the pipes' rates and counts the instructions as compiled. The
// bytes are 2 per pair-residue; the buffer's traffic, 0.25 B a cell,
// stays in L2 while the resident threads' rows fit its 50 MB.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;     // query rows a sweep
constexpr int GROUP = 4;     // steps a group: one target word a pair, the prefetch distance
constexpr int PAD_ROWS = 8;  // the TPU wrapper pads n to a multiple of this
constexpr int CHUNK = 16;    // and m to a multiple of this
constexpr int THREADS = 128;
constexpr uint32_t Q_PAD = 4u;
constexpr uint32_t T_PAD4 = 0x05050505u;  // four target pad codes
constexpr uint32_t NEVER = 0x100u;        // no target byte equals it: rows past np
constexpr uint32_t ONE2 = 0x00010001u;
constexpr uint32_t TWO2 = 0x00020002u;

struct Bf16Scoring {
  uint32_t base;  // packed bf16 pair: the lower of the two score patterns
  uint32_t step;  // the other minus it, 16 bits
  uint32_t gap;   // packed bf16 pair: the rescaled gap
  int g;          // scores are multiplied back by g in int32
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}

__device__ __forceinline__ uint32_t u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  return u32(__hsub2(bf2(a), bf2(b)));
}

// the registers of a sweep: row r holds query row i0 + r (0-based), both
// pairs in the two halves of each word
struct Tile {
  uint32_t qh[ROWS];    // the query codes
  uint32_t tc[ROWS];    // the target codes of the row's last column
  uint32_t h[ROWS];     // H of the row's last cell
  uint32_t gg[ROWS];    // G = round(H - gap) of it
  uint32_t dg[ROWS];    // H of the diagonal of the row's next cell
  uint32_t rb[ROWS / 2];  // the best H of rows 2p and 2p + 1
};

// what a sweep's steps share; the buffer is [mp, Bh] bf16 pairs, its
// columns kept as indices and turned into addresses only where in range
struct Sweep {
  uint32_t* buf;       // this thread's column 0 of the buffer (null with one sweep)
  int rd;              // row 0's refill: column s + GROUP
  int wr;              // row ROWS - 1's hand-off: column s - ROWS + 1
  size_t col;
  int mp;
  bool first, last;
  uint32_t base, step, gap;
};

// The cells of step s: rows LO..HI (the rest have not started or are
// done), in descending order so that each reads row r - 1's state of the
// step before. EQ: the base is the mismatch pattern and the indicator
// marks equal codes, else the base is the match and it marks unequal ones.
template <bool EQ, int LO, int HI>
__device__ __forceinline__ void cells(Tile& T, const Sweep& w, uint32_t tnew, uint32_t up_h) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const uint32_t up_g = LO == 0 ? sub2(up_h, w.gap) : 0u;
#pragma unroll
  for (int r = ROWS - 1; r >= LO; --r) {
    if (r > HI) continue;
    const uint32_t tr = r ? T.tc[r - 1] : tnew;
    const uint32_t uh = r ? T.h[r - 1] : up_h;
    const uint32_t ug = r ? T.gg[r - 1] : up_g;
    const uint32_t x = T.qh[r] ^ tr;
    const uint32_t ind = EQ ? __viaddmax_s16x2_relu(~x, TWO2, 0u)
                            : __vimin_s16x2_relu(x, ONE2);
    const uint32_t s = ind * w.step + w.base;
    const uint32_t pre = u32(__hfma2_relu(bf2(T.dg[r]), one, bf2(s)));
    const uint32_t hn = __vimax3_s16x2(pre, T.gg[r], ug);
    T.gg[r] = sub2(hn, w.gap);
    T.h[r] = hn;
    T.dg[r] = uh;
    T.tc[r] = tr;
  }
#pragma unroll
  for (int p = 0; p < ROWS / 2; ++p)
    if (2 * p + 1 >= LO && 2 * p <= HI) T.rb[p] = __vimax3_s16x2(T.rb[p], T.h[2 * p], T.h[2 * p + 1]);
}

// Step s: row 0 (LO == 0) takes the target codes of column s, half U of
// the group's spread words, and H above from ring slot U % GROUP, which
// refills with column s + GROUP; row ROWS - 1 (HI == ROWS - 1) hands
// column s - ROWS + 1 to the next sweep.
template <bool EQ, int LO, int HI, int U>
__device__ __forceinline__ void step(Tile& T, Sweep& w, uint32_t (&ring)[GROUP], int s,
                                     uint32_t m01, uint32_t m23) {
  uint32_t tn = 0, uh = 0;
  if (LO == 0) {
    tn = prmt(U < 2 ? m01 : m23, 0u, (U & 1) ? 0x4342u : 0x4140u);
    uh = ring[U];
    if (!w.first && s + GROUP < w.mp) ring[U] = __ldcg(w.buf + w.rd * w.col);
  }
  cells<EQ, LO, HI>(T, w, tn, uh);
  if (HI == ROWS - 1 && !w.last) __stcg(w.buf + w.wr * w.col, T.h[ROWS - 1]);
  ++w.rd;
  ++w.wr;
}

// four target codes of a pair from column j on; pads past m
__device__ __forceinline__ uint32_t codes4(const uint8_t* __restrict__ row, int j, int m,
                                           bool vec) {
  if (!row || j >= m) return T_PAD4;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + j));
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < GROUP; ++k)
    w |= (j + k < m ? static_cast<uint32_t>(__ldg(row + j + k)) : 5u) << (8 * k);
  return w;
}

// the two pairs' words of a group, as (column 0, column 1) and (column
// 2, column 3) byte pairs: the low pair's code in bytes 0 and 2
struct Codes {
  uint32_t m01, m23;
};

__device__ __forceinline__ Codes spread(uint32_t lo, uint32_t hi) {
  return Codes{prmt(lo, hi, 0x5140u), prmt(lo, hi, 0x7362u)};
}

template <bool EQ>
__device__ __forceinline__ void group(Tile& T, Sweep& w, uint32_t (&ring)[GROUP], int s0,
                                      Codes c) {
  step<EQ, 0, ROWS - 1, 0>(T, w, ring, s0, c.m01, c.m23);
  step<EQ, 0, ROWS - 1, 1>(T, w, ring, s0 + 1, c.m01, c.m23);
  step<EQ, 0, ROWS - 1, 2>(T, w, ring, s0 + 2, c.m01, c.m23);
  step<EQ, 0, ROWS - 1, 3>(T, w, ring, s0 + 3, c.m01, c.m23);
}

// the first ROWS steps, group K: rows 0..s (row s starts at step s)
template <bool EQ, int K>
__device__ __forceinline__ void opening(Tile& T, Sweep& w, uint32_t (&ring)[GROUP], Codes c) {
  step<EQ, 0, 4 * K, 0>(T, w, ring, 4 * K, c.m01, c.m23);
  step<EQ, 0, 4 * K + 1, 1>(T, w, ring, 4 * K + 1, c.m01, c.m23);
  step<EQ, 0, 4 * K + 2, 2>(T, w, ring, 4 * K + 2, c.m01, c.m23);
  step<EQ, 0, 4 * K + 3, 3>(T, w, ring, 4 * K + 3, c.m01, c.m23);
}

// the last ROWS - 1 steps, from s = mp + E: rows E + 1..ROWS - 1
template <bool EQ, int E>
__device__ __forceinline__ void closing(Tile& T, Sweep& w, uint32_t (&ring)[GROUP], int s) {
  if constexpr (E < ROWS - 1) {
    step<EQ, E + 1, ROWS - 1, 0>(T, w, ring, s, 0u, 0u);
    closing<EQ, E + 1>(T, w, ring, s + 1);
  }
}

template <bool EQ>
__global__ void __launch_bounds__(THREADS)
sw_bf16_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
               uint32_t* __restrict__ hrow, int32_t* __restrict__ score, int B, int n,
               int m, Bf16Scoring sc, bool vec) {
  const int k = blockIdx.x * THREADS + threadIdx.x;  // pairs 2k and 2k + 1
  const int Bh = (B + 1) / 2;
  if (k >= Bh) return;
  const bool hi = 2 * k + 1 < B;  // else the high half runs a pad pair
  const size_t sB = static_cast<size_t>(Bh);
  const int np = (n + PAD_ROWS - 1) / PAD_ROWS * PAD_ROWS;
  const int mp = (m + CHUNK - 1) / CHUNK * CHUNK;
  const uint8_t* q_lo = q + static_cast<size_t>(2 * k) * n;
  const uint8_t* q_hi = hi ? q_lo + n : nullptr;
  const uint8_t* t_lo = t + static_cast<size_t>(2 * k) * m;
  const uint8_t* t_hi = hi ? t_lo + m : nullptr;
  const uint32_t neg_gap = sub2(0u, sc.gap);  // G of an H of 0

  Sweep w{hrow ? hrow + k : nullptr, 0, 0, sB, mp, true, false, sc.base, sc.step, sc.gap};
  Tile T;
#pragma unroll
  for (int p = 0; p < ROWS / 2; ++p) T.rb[p] = 0u;
  uint32_t ring[GROUP];
  for (int i0 = 0; i0 < np && mp > 0; i0 += ROWS) {
    w.first = i0 == 0;
    w.last = i0 + ROWS >= np;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r;
      uint32_t c_lo = NEVER, c_hi = NEVER;
      if (i < n) {
        c_lo = __ldg(q_lo + i);
        c_hi = hi ? __ldg(q_hi + i) : Q_PAD;
      } else if (i < np) {
        c_lo = c_hi = Q_PAD;
      }
      T.qh[r] = c_lo | (c_hi << 16);
      T.tc[r] = 0u;
      T.h[r] = 0u;      // H[i][0]
      T.gg[r] = neg_gap;
      T.dg[r] = 0u;     // H[i - 1][0]
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) ring[u] = w.first ? 0u : __ldcg(w.buf + u * sB);
    w.rd = GROUP;
    w.wr = -(ROWS - 1);

    Codes c = spread(codes4(t_lo, 0, m, vec), codes4(t_hi, 0, m, vec));
    Codes cn = spread(codes4(t_lo, GROUP, m, vec), codes4(t_hi, GROUP, m, vec));
    opening<EQ, 0>(T, w, ring, c);
    c = cn;
    cn = spread(codes4(t_lo, 2 * GROUP, m, vec), codes4(t_hi, 2 * GROUP, m, vec));
    opening<EQ, 1>(T, w, ring, c);
    c = cn;
    cn = spread(codes4(t_lo, 3 * GROUP, m, vec), codes4(t_hi, 3 * GROUP, m, vec));
    opening<EQ, 2>(T, w, ring, c);
    c = cn;
    cn = spread(codes4(t_lo, 4 * GROUP, m, vec), codes4(t_hi, 4 * GROUP, m, vec));
    opening<EQ, 3>(T, w, ring, c);
    c = cn;
    for (int s0 = ROWS; s0 < mp; s0 += GROUP) {
      cn = spread(codes4(t_lo, s0 + GROUP, m, vec), codes4(t_hi, s0 + GROUP, m, vec));
      group<EQ>(T, w, ring, s0, c);
      c = cn;
    }
    closing<EQ, 0>(T, w, ring, mp);
  }

  uint32_t best = 0u;
#pragma unroll
  for (int p = 0; p < ROWS / 2; ++p) best = __vimax3_s16x2(best, T.rb[p], T.rb[p]);
  // every value is an integer, so the conversions are exact
  const __nv_bfloat162 b2 = bf2(best);
  score[2 * k] = static_cast<int>(__low2float(b2)) * sc.g;
  if (hi) score[2 * k + 1] = static_cast<int>(__high2float(b2)) * sc.g;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronise would not report
// it. Pointers: q [B, n] uint8, t [B, m] uint8, hrow [mp, ceil(B / 2)]
// uint32 with mp = m rounded up to 16 (unused, may be null, when n <= 8),
// score [B] int32. All on one device, all contiguous; the wrapper checks
// that. s_eq, s_ne and gap are bf16 bit patterns.
int swtpu_sw_bf16(const void* q, const void* t, void* hrow, void* score, int B, int n,
                  int m, int s_eq, int s_ne, int gap, int g, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const auto pair = [](uint32_t b) { return (b & 0xFFFFu) | ((b & 0xFFFFu) << 16); };
  const uint32_t eq = static_cast<uint32_t>(s_eq) & 0xFFFFu;
  const uint32_t ne = static_cast<uint32_t>(s_ne) & 0xFFFFu;
  // base the lower pattern, so that base + step never carries out of a half
  const bool eq_ind = ne < eq;
  // step in the low half only: indicator (0 or 1 a half) x step adds it
  // to each half on its own
  const Bf16Scoring sc{pair(eq_ind ? ne : eq), eq_ind ? eq - ne : ne - eq,
                       pair(static_cast<uint32_t>(gap)), g};
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 4 == 0;
  const dim3 grid(((B + 1) / 2 + THREADS - 1) / THREADS);
  const auto* qp = static_cast<const uint8_t*>(q);
  const auto* tp = static_cast<const uint8_t*>(t);
  auto* hp = static_cast<uint32_t*>(hrow);
  auto* sp = static_cast<int32_t*>(score);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (eq_ind)
    sw_bf16_kernel<true><<<grid, THREADS, 0, st>>>(qp, tp, hp, sp, B, n, m, sc, vec);
  else
    sw_bf16_kernel<false><<<grid, THREADS, 0, st>>>(qp, tp, hp, sp, B, n, m, sc, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
