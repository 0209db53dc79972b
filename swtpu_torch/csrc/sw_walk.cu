// Device traceback walkers for Hopper (sm_90a): the block tier's walk over
// its [n, W, B] band history and the per-round tier's walk over its
// [R, B, W] history, both writing the 2-bit move wire.
//
// Replaces XLA code, not a Pallas kernel (so no row of PERF.md's TPU table):
//   block_walk  swtpu/kernels/pallas/banded_block.py  _block_fwd_walk_impl  (:1275-1462)
//   xdrop_walk  swtpu/kernels/xla/banded_scan.py      _banded_fwd_walk_impl (:334-531)
// Each walks one pair's path from its endpoint to the origin with the host
// walkers' rules (oracle/banded_block.py::walk_block_history and
// batch/traceback.py::banded_traceback): a cell's value must equal its
// predecessor's plus the step's score, tie-break diag -> up -> left, dead
// and out-of-band cells read as -2^30. The block walk applies the
// block-end X-drop cutoff (the pair's score) to its final row y == n_rows
// and reads the gap chains at row 0 and, out of band, at column 0; the
// per-round walk starts at the largest band slot of the best round that
// holds the max and reads only rounds below n_rounds.
//
// The wire (decode_device_walk): per pair 20 bytes of little-endian int32
// meta (score, start y, start x, n_steps, ok) and then 2-bit moves, four
// a byte with move k at bits 2k (0 diag, 1 up, 2 left, 3 done), padded
// with 3s to a multiple of 64 moves (bytes of 255). ok is 0 when the walk
// stalls (no predecessor matches) or does not reach the origin.
//
// Design: one thread per pair, a serial loop of steps. The current cell's
// value rides the loop (it is the previous step's chosen neighbour); each
// step reads three history cells, two row bases (block) or two pos_y
// (per-round), one query and one target code; sixteen moves fill a 32-bit
// word before it is stored. Bound: the walk is a chain of dependent loads,
// so its latency, not the card's rate, binds it: a few hundred cycles a step
// from L2 or device memory. Later work: a warp per pair walking a chunk of
// steps ahead from cached history rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int MINF = -(1 << 30);

struct Packer {
  uint32_t* out;  // this pair's move words
  uint32_t word = 0;
  int nbits = 0, nwords = 0;

  __device__ __forceinline__ void push(int move) {
    word |= static_cast<uint32_t>(move) << nbits;
    nbits += 2;
    if (nbits == 32) {
      out[nwords++] = word;
      word = 0;
      nbits = 0;
    }
  }
  // pad with 'done' moves (bits 11) to the row's end
  __device__ __forceinline__ void finish(int total_words) {
    if (nbits) {
      out[nwords++] = word | (0xFFFFFFFFu << nbits);
      nbits = 0;
    }
    for (; nwords < total_words; ++nwords) out[nwords] = 0xFFFFFFFFu;
  }
};

__device__ __forceinline__ int sub_score(int yc, int xc, const int32_t* table, int stride,
                                         int match, int mismatch) {
  if (table) {
    const unsigned us = static_cast<unsigned>(stride);
    const int qi = static_cast<unsigned>(yc) < us ? yc : stride - 1;
    const int ti = static_cast<unsigned>(xc) < us ? xc : stride - 1;
    return table[qi * stride + ti];
  }
  return (yc >= 0 && xc >= 0 && yc == xc) ? match : -mismatch;
}

__device__ __forceinline__ void write_meta(uint8_t* row, int score, int sy, int sx,
                                           int nsteps, bool ok) {
  int32_t* meta = reinterpret_cast<int32_t*>(row);
  meta[0] = score;
  meta[1] = sy;
  meta[2] = sx;
  meta[3] = nsteps;
  meta[4] = ok ? 1 : 0;
}

struct BlockWalk {
  const int16_t* qT;     // [n, B]
  const int16_t* t;      // [B, m], -1 past each pair's length
  const int32_t* table;  // [stride, stride] or null
  const int32_t* hist;   // [n, W, B]
  const int32_t* bases;  // [NB, B]
  const int32_t* score;  // [B]
  const int32_t* end_y;
  const int32_t* end_j;
  const int32_t* n_rows;
  uint8_t* wire;         // [B, row_bytes]
  int B, n, m, W, K, X, match, mismatch, gap, stride, steps, row_bytes;
};

// walk_block_history.get(y, j) for pair b, with the final row's cutoff
__device__ __forceinline__ int block_val(const BlockWalk& a, int b, int y, int j, int nr,
                                         int score) {
  if (y == 0) {
    const int c = a.X - j * a.gap;
    return (j >= 0 && (c > 0 || j == 0)) ? c : MINF;
  }
  if (y >= 1 && y <= nr) {
    const size_t sB = static_cast<size_t>(a.B);
    const int yc = y - 1;
    const int rb = a.bases[static_cast<size_t>(yc / a.K) * sB + b] + yc % a.K;
    const int k = j - rb;
    if (k >= 0 && k < a.W) {
      int raw = a.hist[(static_cast<size_t>(yc) * a.W + k) * sB + b];
      if (y == nr && raw < score) raw = 0;  // the block-end X-drop of the final row
      return raw != 0 ? raw : MINF;
    }
    const int c = a.X - y * a.gap;
    return (j == 0 && c > 0) ? c : MINF;  // out-of-band column 0: the chain
  }
  return MINF;
}

__global__ void __launch_bounds__(THREADS) block_walk_kernel(BlockWalk a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const size_t sB = static_cast<size_t>(a.B);
  uint8_t* row = a.wire + static_cast<size_t>(b) * a.row_bytes;
  Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
  const int score = a.score[b], ey = a.end_y[b], ej = a.end_j[b], nr = a.n_rows[b];
  const int g = a.gap;
  int i = ey, j = ej, v = score + a.X, nsteps = 0;
  bool ok = true;
  for (int step = 0; step < a.steps; ++step) {
    if (i == 0 && j == 0) break;
    const int diag_v = block_val(a, b, i - 1, j - 1, nr, score);
    const int up_v = block_val(a, b, i - 1, j, nr, score);
    const int left_v = block_val(a, b, i, j - 1, nr, score);
    int s = 0;
    if (i > 0 && j > 0) {
      const int yc = a.qT[static_cast<size_t>(i - 1) * sB + b];
      const int xc = (j <= a.m) ? a.t[static_cast<size_t>(b) * a.m + j - 1] : -1;
      s = sub_score(yc, xc, a.table, a.stride, a.match, a.mismatch);
    }
    const bool can_d = i > 0 && j > 0 && diag_v > MINF && diag_v + s == v;
    const bool can_u = i > 0 && up_v > MINF && up_v - g == v;
    const bool can_l = j > 0 && left_v > MINF && left_v - g == v;
    if (!(can_d || can_u || can_l)) {
      ok = false;
      break;
    }
    const int move = can_d ? 0 : (can_u ? 1 : 2);
    pk.push(move);
    ++nsteps;
    i -= (move != 2);
    j -= (move != 1);
    v = can_d ? diag_v : (can_u ? up_v : left_v);
  }
  ok = ok && i == 0 && j == 0;
  write_meta(row, score, ey, ej, nsteps, ok);
  pk.finish(a.steps / 16);
}

struct XdropWalk {
  const int16_t* qp;       // [B, QL] padded query rows, -1 pads
  const int16_t* tp;       // [B, TL] padded target rows
  const int32_t* lens_q;   // [B]
  const int32_t* lens_t;   // [B]
  const int32_t* table;    // [stride, stride] or null
  const int32_t* hist;     // [R, B, W]
  const int32_t* posy;     // [R, B]
  const int32_t* score;    // [B]
  const int32_t* max_round;
  const int32_t* n_rounds;
  uint8_t* wire;
  int B, QL, TL, R, W, X, match, mismatch, gap, stride, steps, row_bytes;
};

__global__ void __launch_bounds__(THREADS) xdrop_walk_kernel(XdropWalk a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.B) return;
  const size_t sB = static_cast<size_t>(a.B);
  const int W = a.W;
  uint8_t* row = a.wire + static_cast<size_t>(b) * a.row_bytes;
  Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
  const int n = a.lens_q[b], m = a.lens_t[b], nrounds = a.n_rounds[b];
  const int score = a.score[b], target = score + a.X, r0 = a.max_round[b];
  auto clampR = [&](int r) { return min(max(r, 0), a.R - 1); };
  auto cell = [&](int r, int k) {
    return a.hist[(static_cast<size_t>(clampR(r)) * sB + b) * W + min(max(k, 0), W - 1)];
  };
  auto py = [&](int r) { return a.posy[static_cast<size_t>(clampR(r)) * sB + b]; };
  // start: the largest band slot of round max_round that holds the max
  const int py0 = py(r0);
  int kstar = -1;
  for (int k = 0; k < W; ++k) {
    const int yk = py0 + (W - 1 - k), xk = r0 - yk, vk = cell(r0, k);
    if (vk == target && vk != 0 && yk >= 0 && yk <= n && xk >= 0 && xk <= m) kstar = k;
  }
  const bool start_ok = kstar >= 0;
  const int sy = py0 + (W - 1 - max(kstar, 0)), sx = r0 - sy;
  auto val = [&](int raw, int y, int x, int k, int rnd) {
    const bool valid = y >= 0 && y <= n && x >= 0 && x <= m && rnd >= 0 &&
                       rnd < nrounds && k >= 0 && k < W;
    return (valid && raw != 0) ? raw : MINF;
  };
  int i = sy, j = sx, v = target, nsteps = 0;
  bool ok = start_ok;
  for (int step = 0; ok && step < a.steps; ++step) {
    if (i == 0 && j == 0) break;
    const int r = i + j;
    const int k_up = (W - 1) - ((i - 1) - py(r - 1));
    const int k_left = k_up - 1;
    const int k_diag = (W - 1) - ((i - 1) - py(r - 2));
    const int up_v = val(cell(r - 1, k_up), i - 1, j, k_up, r - 1);
    const int left_v = val(cell(r - 1, k_left), i, j - 1, k_left, r - 1);
    const int diag_v = val(cell(r - 2, k_diag), i - 1, j - 1, k_diag, r - 2);
    const int yc = a.qp[static_cast<size_t>(b) * a.QL + min(max(i, 0), a.QL - 1)];
    const int xc = a.tp[static_cast<size_t>(b) * a.TL + min(max(W + j - 1, 0), a.TL - 1)];
    const int s = sub_score(yc, xc, a.table, a.stride, a.match, a.mismatch);
    const bool can_d = i > 0 && j > 0 && diag_v + s == v;
    const bool can_u = i > 0 && up_v - a.gap == v;
    const bool can_l = j > 0 && left_v - a.gap == v;
    if (!(can_d || can_u || can_l)) {
      ok = false;
      break;
    }
    const int move = can_d ? 0 : (can_u ? 1 : 2);
    pk.push(move);
    ++nsteps;
    i -= (move != 2);
    j -= (move != 1);
    v = can_d ? diag_v : (can_u ? up_v : left_v);
  }
  ok = ok && i == 0 && j == 0;
  write_meta(row, score, sy, sx, nsteps, ok);
  pk.finish(a.steps / 16);
}

}  // namespace

extern "C" {

// The block walk on `stream`: one wire row per pair (see the head note).
// qT [n, B] int16, t [B, m] int16, table [stride, stride] int32 or null,
// hist [n, W, B], bases [NB, B], score / end_y / end_j / n_rows [B] int32,
// wire [B, row_bytes] uint8 with row_bytes = 20 + steps / 4 and steps a
// multiple of 64. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// bad steps / row_bytes / stride).
int swtpu_block_walk(const void* qT, const void* t, const void* table, const void* hist,
                     const void* bases, const void* score, const void* end_y,
                     const void* end_j, const void* n_rows, void* wire, int B, int n,
                     int m, int W, int K, int X, int match, int mismatch, int gap,
                     int stride, int steps, int row_bytes, void* stream) {
  if (steps <= 0 || steps % 64 || row_bytes != 20 + steps / 4 || W < 1 || K < 1 ||
      (table && (stride < 1 || stride > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const BlockWalk a{static_cast<const int16_t*>(qT), static_cast<const int16_t*>(t),
                    static_cast<const int32_t*>(table), static_cast<const int32_t*>(hist),
                    static_cast<const int32_t*>(bases), static_cast<const int32_t*>(score),
                    static_cast<const int32_t*>(end_y), static_cast<const int32_t*>(end_j),
                    static_cast<const int32_t*>(n_rows), static_cast<uint8_t*>(wire),
                    B, n, m, W, K, X, match, mismatch, gap, stride, steps, row_bytes};
  block_walk_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The per-round walk on `stream`. qp [B, QL] / tp [B, TL] int16 padded rows
// (kernels/banded_scan.py::_prep_padded), lens_q / lens_t [B] int32, table
// or null, hist [R, B, W] int32, posy [R, B], score / max_round / n_rounds
// [B], wire as for the block walk.
int swtpu_xdrop_walk(const void* qp, const void* tp, const void* lens_q, const void* lens_t,
                     const void* table, const void* hist, const void* posy,
                     const void* score, const void* max_round, const void* n_rounds,
                     void* wire, int B, int QL, int TL, int R, int W, int X, int match,
                     int mismatch, int gap, int stride, int steps, int row_bytes,
                     void* stream) {
  if (steps <= 0 || steps % 64 || row_bytes != 20 + steps / 4 || W < 1 || R < 1 ||
      QL < 1 || TL < 1 || (table && (stride < 1 || stride > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const XdropWalk a{static_cast<const int16_t*>(qp), static_cast<const int16_t*>(tp),
                    static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
                    static_cast<const int32_t*>(table), static_cast<const int32_t*>(hist),
                    static_cast<const int32_t*>(posy), static_cast<const int32_t*>(score),
                    static_cast<const int32_t*>(max_round),
                    static_cast<const int32_t*>(n_rounds), static_cast<uint8_t*>(wire),
                    B, QL, TL, R, W, X, match, mismatch, gap, stride, steps, row_bytes};
  xdrop_walk_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
