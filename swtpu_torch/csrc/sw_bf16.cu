// Batched Smith-Waterman in packed bf16 for Hopper (sm_90a): the
// reduced-precision tier of local-alignment scores, uniform scoring,
// linear gap.
//
// Replaces swtpu/kernels/pallas/sw_bf16.py _kernel (pallas_call :134, in
// _sw_bf16_impl). The TPU kernel doubles its lane count by running the
// DP in bfloat16 on (16, 128) tiles; here each thread runs two pairs at
// once in the two halves of a __nv_bfloat162: pair 2k in the low half,
// pair 2k + 1 in the high half.
//
// Design. The row-scan skeleton of csrc/sw_rowscan.cu: the batch is the
// parallel axis, the wrapper hands the codes over transposed ([n, B] and
// [m, B] uint8, B even), so one 16-bit load gives a thread both pairs'
// codes and a warp's loads coalesce. ROWS query rows advance together
// through each column with their left H in registers; the previous-row
// buffer is [mp, B/2] 32-bit words (one bf16 pair each), read and written
// once per ROWS rows. The TPU kernel's (16, 128) tiles and chunked columns
// are TPU layout and are not carried over.
//
// Rounding. Every DP value is rounded to bf16 (round to nearest even)
// after every operation, in the TPU kernel's order (sw_bf16.py:96-110):
//   pre  = max(diag + s, 0)                  fma.rn.relu: one rounding
//   h    = max(pre, max(up, left) - gap)
//   best = max(best, pre)                    over pre, not h
// max(up - gap, left - gap) would round differently above the exact
// range, so the subtraction follows the max. Inside the exact range
// (every value an integer of magnitude <= 256 after the wrapper divides
// the scoring by g = gcd(match, mismatch, gap)) nothing rounds; above it
// the values drift, as on the TPU, and the promotion path re-runs every
// pair whose result reaches 255 (batch/promote.py). bf16 cannot wrap, so
// there is no saturation logic.
//
// Scores. The TPU kernel tests for a match arithmetically,
// s = match - (match - mismatch) * min(d * d, 1) with d = q - t, so two
// equal codes match whatever they are, pads included: a query pad row
// (code 4) matches a target N (code 4). Here the two codes of each half
// are compared as integers and s is selected from two packed constants
// that the wrapper rounds exactly as that formula does. Rows past n are
// pad rows of code 4 up to a multiple of ROWS, and columns past m are pad
// columns of code 5 up to a multiple of CHUNK: the TPU wrapper's padding
// (sw_bf16.py:224-234), which changes results, so it is reproduced.
//
// Bound. Per (row, column) step a thread does 4 integer ops for the two
// scores (xor, add, prmt, lop3) and 5 packed bf16 ops (fma.relu, max,
// sub, max, max): 9 instructions for two cells, against 9 int32 ops for
// ONE cell in sw_rowscan.cu. At Hopper's rates per SM and clock (64
// 32-bit integer results, 256 16-bit float results) the integer score
// select binds (2 ops per cell), ahead of the bf16 DP (5 results per
// cell) and of instruction dispatch (4.5 per cell at 128 lanes); the bytes
// are 2 per pair-residue. The design halves the integer work per cell by
// making each integer op serve both halves, and moves the DP itself onto
// the 16-bit float pipe. As measured (PERF.md) the kernel runs well under
// that bound: each row's H waits on three dependent packed ops, and at
// 32768 pairs one thread per two pairs leaves about one warp per
// scheduler to hide that latency. The previous-row buffer outgrows the
// 50 MB L2 above about 400,000 pairs of 128 columns. Later work: a 16-bit
// integer DPX variant (__viaddmax_s16x2) with its own exactness bound,
// reading the [B, L] layout directly, and more independent work per warp
// at small batch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 8;
constexpr int CHUNK = 16;
constexpr int THREADS = 128;
constexpr uint32_t Q_PAD2 = 0x0404u;  // the query pad code 4 in both bytes
constexpr uint32_t T_PAD2 = 0x0505u;  // the target pad code 5 in both bytes

struct Bf16Scoring {
  uint32_t s_eq;  // packed bf16 pair: the rescaled match score
  uint32_t s_ne;  // packed bf16 pair: the rescaled mismatch score
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

// Two uint8 codes (bytes 0 and 1) spread into the two 16-bit halves.
__device__ __forceinline__ uint32_t halves(uint32_t two_codes) {
  return prmt(two_codes, 0u, 0x4140u);
}

__global__ void __launch_bounds__(THREADS)
sw_bf16_kernel(const uint16_t* __restrict__ qT, const uint16_t* __restrict__ tT,
               uint32_t* __restrict__ hrow, int2* __restrict__ score, int Bh,
               int n, int m, Bf16Scoring sc) {
  const int k = blockIdx.x * THREADS + threadIdx.x;  // pairs 2k and 2k + 1
  if (k >= Bh) return;
  const size_t sB = static_cast<size_t>(Bh);
  const int mp = (m + CHUNK - 1) / CHUNK * CHUNK;
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 gap = bf2(sc.gap);

  // row 0: H = 0
  for (int j = 0; j < mp; ++j) hrow[j * sB + k] = 0u;

  __nv_bfloat162 best = zero;
  for (int i0 = 0; i0 < n && mp > 0; i0 += ROWS) {
    uint32_t qh[ROWS];                      // both pairs' query codes
    __nv_bfloat162 hl[ROWS], dg[ROWS], rb[ROWS];  // left H, diagonal H, best
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      qh[r] = halves(i0 + r < n ? qT[(i0 + r) * sB + k] : Q_PAD2);
      hl[r] = zero;
      dg[r] = zero;
      rb[r] = zero;
    }

    uint32_t t_next = m > 0 ? tT[k] : T_PAD2;
    uint32_t up_next = hrow[k];
    for (int j = 0; j < mp; ++j) {
      const uint32_t th = halves(t_next);
      __nv_bfloat162 up = bf2(up_next);  // H[i0 - 1][j + 1], then each row's
      if (j + 1 < mp) {
        const size_t o = (j + 1) * sB + k;
        t_next = j + 1 < m ? tT[o] : T_PAD2;
        up_next = hrow[o];
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        // bit 15 of each half is set iff the two codes differ (codes are
        // below 256, so the add cannot carry into the other half); prmt
        // copies that sign bit over the half
        const uint32_t ne = prmt((qh[r] ^ th) + 0x7FFF7FFFu, 0u, 0xBB99u);
        const uint32_t s = (sc.s_ne & ne) | (sc.s_eq & ~ne);
        const __nv_bfloat162 pre = __hfma2_relu(dg[r], one, bf2(s));
        const __nv_bfloat162 h = __hmax2(pre, __hsub2(__hmax2(up, hl[r]), gap));
        rb[r] = __hmax2(rb[r], pre);
        dg[r] = up;  // H[i - 1][j] is the diagonal of cell (i, j + 1)
        hl[r] = h;
        up = h;      // and H[i][j] is the cell above (i + 1, j)
      }
      hrow[j * sB + k] = u32(up);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) best = __hmax2(best, rb[r]);
  }

  // every value is an integer, so the conversions are exact
  score[k] = make_int2(static_cast<int>(__low2float(best)) * sc.g,
                       static_cast<int>(__high2float(best)) * sc.g);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError(): a
// refused launch never runs, and a later synchronise would not report
// it. Pointers: qT [n, 2 * Bh] uint8, tT [m, 2 * Bh] uint8, hrow
// [mp, Bh] uint32 with mp = m rounded up to 16, score [2 * Bh] int32 (8-byte
// aligned). All on one device, all contiguous; the wrapper checks that.
// s_eq, s_ne and gap are bf16 bit patterns.
int swtpu_sw_bf16(const void* qT, const void* tT, void* hrow, void* score,
                  int Bh, int n, int m, int s_eq, int s_ne, int gap, int g,
                  void* stream) {
  if (Bh <= 0) return static_cast<int>(cudaSuccess);
  const auto pair = [](int bits) {
    const uint32_t b = static_cast<uint32_t>(bits) & 0xFFFFu;
    return b | (b << 16);
  };
  const Bf16Scoring sc{pair(s_eq), pair(s_ne), pair(gap), g};
  const dim3 grid((Bh + THREADS - 1) / THREADS);
  sw_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(qT), static_cast<const uint16_t*>(tT),
      static_cast<uint32_t*>(hrow), static_cast<int2*>(score), Bh, n, m, sc);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
