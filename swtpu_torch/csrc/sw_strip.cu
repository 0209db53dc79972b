// One R x C tile of a single long pair's local-alignment DP matrix for
// Hopper (sm_90a), from its top boundary row, left boundary column and
// corner: the long-pair strip tile, linear or affine (Gotoh) gaps, any
// substitution matrix of up to 30 letters.
//
// Replaces swtpu/kernels/pallas/longpair_strip.py  _strip_kernel
// (pallas_call :263; entries strip_tile :485, strip_tile_affine :505).
// Its plain version is the column-scan tile of
// swtpu_torch/kernels/longpair_strip.py (_tile_colscan, _tile_colscan_affine),
// which both kernels here equal bit for bit on every return: the bottom row
// H (and F), the right column H (and E), the tile best and its 1-based
// row-major-first endpoint ((0, 0) when the best is 0).
//
// The recurrence (both kernels). A thread owns BR consecutive rows and
// runs the TPU kernel's 1-column-skewed pipeline: at step s the thread of
// rank I computes column c = s - I of its rows, so its top input (the H of
// the row above at column c) is what rank I - 1 produced one step earlier.
// Each row's H (and E) lives in a register; the diagonal of its first row
// is the top value seen at the previous step (the left column and corner
// at c = 0). Scores come from the extended table in shared memory
// (kernels/sw_scan.py::_extended_table): every code >= the alphabet scores
// -2^20 under any matrix, in-length pads included, the rule of the plain
// tile (JAX's XLA tile). JAX's Pallas tile matches equal codes under a
// uniform matrix instead; the port follows its plain tile. The vertical
// chain follows the plain tile's closed forms: the linear H[i] =
// max(pre[i], H[i-1] - gap) and the affine F as JAX's decoupled chain F[i]
// = max(F[i-1] - ge, pre[i-1] - go), where pre is the E-and-diagonal
// candidate, not H, with the F boundary folded in at the tile's first row
// as max(top_f, -2^20) - ge: Gotoh's F for gap_open >= gap_extend. The
// plain tile takes these max-plus prefixes by log-doubling over shifts
// 1, 2, 4, ... that fill with -2^20; a filled term is at most -2^20 + S x
// |penalty| under a negative penalty (S the shifts' sum, < 2R), so the
// sequential chain here equals it for gaps of either sign while S x |gap|
// (Gotoh: S x max(0, -ge) + go) stays below 2^20, the bound
// longpair_strip.py::strip_refusal states (|gap| <= 32 at 16384 rows). So
// rank I - 1 hands rank I its last row's H, and for affine also its pre
// and F. The endpoint: per thread its best H and that cell's row and
// column, updated on a greater H or an equal one in a lower row (value,
// then least row, then that row's earliest column, as the columns arrive
// in order and a step's rows in order), then reduced (value, least row).
// The value and the row go in one key (H << log2 BR) | (BR - 1 - r) while
// every H of the tile stays below 2^27: the wrapper hands the kernel the
// largest boundary value (on the device, no sync) and how far H can climb
// across the tile above it (longpair_strip.py::h_reach: under a negative
// gap by |gap| a gap step), and a tile that could pass 2^27 keeps (value,
// row) apart (WIDE), a compare and three selects more a cell. The
// one-block kernel always keeps them apart.
//
// The pipelined kernel (strip_pipe_kernel<BR, AFFINE>, the one the tile
// entries launch). The tile is cut into row bands of 32 * BR rows, a warp
// each (one warp a CTA, so the bands spread over the SMs); lane L holds
// rows [L*BR, L*BR + BR) of its band and takes lane L - 1's last row, and
// the target code it used, by shuffle: no barrier. Lane 0 takes the band's
// top row from a ring over the lanes (lane c % 32 holds column c), loaded
// 8 columns at a time, 8 steps before it needs them: the tile's top row
// for band 0, else band - 1's last row, which the lane that owns it writes
// column by column as 64-bit words (value, column + 1): a reader that sees
// the tag sees the value, so neither side needs a fence, and a column not
// yet written is read again. Bands run
// concurrently a few dozen steps apart (the anti-diagonal of sub-tiles,
// JAX's sharded sweep with warps in place of devices); every warp must be
// resident at once (the grid is capped at the occupancy), and a warp takes
// bands in turn past that. Each band's best goes to scratch; the last band
// to finish merges them (row-major first). The rows of a step run
// branch-free (every table lookup first, then the chain of one add-max a
// row); a ragged last lane computes its rows past R on pad codes and masks
// them. BR and the band count come from the wrapper
// (longpair_strip.py::strip_plan: BR the power of two nearest 4R / C, so
// about C / 128 bands, the fastest BR in chip_smoke.py's sweep). Linear
// gaps hand over H alone, Gotoh H, pre and F.
//
// The one-block kernel (strip_tile_kernel<BR, AFFINE>, the earlier
// schedule, kept to be timed beside it): one CUDA block a tile, T =
// ceil(R / BR) <= 1024 threads, the boundary row crossing threads through
// a double-buffered shared-memory slot and one __syncthreads a step.
//
// Bound: int32 issue over the tile's cells (about 9 ops a cell linear, 14
// Gotoh, and one shared lookup: chip_smoke.py::strip_ops). The pipelined
// kernel is bound instead by a band's step latency (the shuffles, the
// lookups, the loop: a few hundred cycles a step, C + 31 steps a band)
// and the bands' lag behind each other (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_STRIDE = 32;
constexpr int NEGB = -(1 << 20);

constexpr int KEY_MAX = 1 << 27;  // H below it: H << 4 and 4 row bits fit 31 bits

struct Cand {
  int v, row, col;
};

// A thread's running best over its cells (value, row in the thread,
// column), row-major first: a greater H, or an equal H in a lower row of
// a later column (a column's rows arrive in order). WIDE keeps (value,
// row) apart; else one key (H << log2 BR) | (BR - 1 - r), for H < 2^27.
// An idle lane's -1 never wins. `take` forms the key whether or not the
// cell is real and tests both at once: nvcc compiled a nested test into a
// slower step of the pipelined kernel.
template <int BR, bool WIDE>
struct Best {
  static constexpr int LB = BR >= 16 ? 4 : BR >= 8 ? 3 : BR >= 4 ? 2 : BR >= 2 ? 1 : 0;
  int key = -1, row = 0, col = 0;  // WIDE: key is the value

  __device__ __forceinline__ void take(int h, int r, int c, bool real) {
    if constexpr (WIDE) {
      if (real && (h > key || (h == key && r < row))) {
        key = h;
        row = r;
        col = c;
      }
    } else {
      const int k = (h << LB) | (BR - 1 - r);
      if (real && k > key) {
        key = k;
        col = c;
      }
    }
  }

  __device__ __forceinline__ Cand cand(int row0) const {
    if constexpr (WIDE) return Cand{key, row0 + row, col};
    return Cand{key >> LB, row0 + (BR - 1 - (key & (BR - 1))), col};
  }
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.v > b.v || (a.v == b.v && a.row < b.row);
}

__device__ __forceinline__ Cand shfl_down(const Cand& c, int k) {
  return Cand{__shfl_down_sync(0xffffffffu, c.v, k),
              __shfl_down_sync(0xffffffffu, c.row, k),
              __shfl_down_sync(0xffffffffu, c.col, k)};
}

template <int BR, bool AFFINE>
__global__ void __launch_bounds__(MAX_THREADS, 1)
strip_tile_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                  const int32_t* __restrict__ table, int stride,
                  const int32_t* __restrict__ top, const int32_t* __restrict__ topf,
                  const int32_t* __restrict__ lext, const int32_t* __restrict__ lext_e,
                  int32_t* __restrict__ bottom, int32_t* __restrict__ bottom_f,
                  int32_t* __restrict__ right, int32_t* __restrict__ right_e,
                  int32_t* __restrict__ out3, int R, int C, int go, int ge) {
  constexpr int NP = (BR + 3) / 4;  // query codes, four to a register
  __shared__ int32_t tab[MAX_STRIDE * MAX_STRIDE];
  __shared__ int32_t xh[2][MAX_THREADS];  // each thread's last row at its column: H
  __shared__ int32_t xp[2][AFFINE ? MAX_THREADS : 1];  // pre (affine)
  __shared__ int32_t xf[2][AFFINE ? MAX_THREADS : 1];  // F (affine)
  __shared__ Cand warp_best[MAX_THREADS / 32];

  const int I = threadIdx.x;
  const int T = (R + BR - 1) / BR;  // threads with rows; the block is T rounded up to a warp
  for (int k = I; k < stride * stride; k += blockDim.x) tab[k] = table[k];
  const int pad = stride - 1;
  const int row0 = I * BR;
  const int nrows = min(BR, R - row0);  // >= 1 below T, <= 0 in the idle lanes past it

  uint32_t qp[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) qp[k] = 0;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const uint32_t code = r < nrows ? min(static_cast<int>(q[row0 + r]), pad) : pad;
    qp[r >> 2] |= code << (8 * (r & 3));
  }
  int H[BR];
  int E[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    H[r] = 0;
    E[r] = NEGB;
  }
  int top_prev = 0;  // H of the row above at the previous column
  Best<BR, true> best;
  // prefetched one step ahead: this thread's next target code and, for
  // thread 0, the next top values
  int t_next = t[0];
  int top_next = 0, topf_next = NEGB;
  if (I == 0) {
    top_next = top[0];
    if (AFFINE) topf_next = topf[0];
  }
  __syncthreads();

  const int steps = C + T - 1;
  for (int s = 0; s < steps; ++s) {
    const int c = s - I;
    const int buf = s & 1;
    if (I < T && c >= 0 && c < C) {
      const int tc = min(t_next, pad);
      int up_h, up_p, up_f;
      if (I == 0) {
        up_h = top_next;
        up_p = up_h;
        up_f = max(topf_next, NEGB);
      } else {
        up_h = xh[buf ^ 1][I - 1];
        up_p = up_f = 0;
        if constexpr (AFFINE) {
          up_p = xp[buf ^ 1][I - 1];
          up_f = xf[buf ^ 1][I - 1];
        }
      }
      if (c + 1 < C) {
        t_next = t[c + 1];
        if (I == 0) {
          top_next = top[c + 1];
          if (AFFINE) topf_next = topf[c + 1];
        }
      }
      int diag = top_prev;
      if (c == 0) {
        diag = lext[row0];
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (r < nrows) {
            H[r] = lext[row0 + r + 1];
            if (AFFINE) E[r] = lext_e[row0 + r + 1];
          }
        }
      }
      top_prev = up_h;
      const int* col = tab + tc;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (r < nrows) {
          const int qc = __byte_perm(qp[r >> 2], 0, 0x4440 | (r & 3));
          const int sc = col[qc * stride];
          const int left = H[r];
          int h;
          if constexpr (AFFINE) {
            const int e = max(E[r] - ge, left - go);
            const int pre = max(max(diag + sc, e), 0);
            const int f = max(up_f - ge, up_p - go);
            h = max(pre, f);
            E[r] = e;
            up_p = pre;
            up_f = f;
          } else {
            h = max(max(diag + sc, 0), max(up_h, left) - go);
          }
          diag = left;
          up_h = h;
          H[r] = h;
          best.take(h, r, c, true);
        }
      }
      xh[buf][I] = up_h;
      if constexpr (AFFINE) {
        xp[buf][I] = up_p;
        xf[buf][I] = up_f;
      }
      if (row0 + nrows == R) {
        bottom[c] = up_h;
        if (AFFINE) bottom_f[c] = up_f;
      }
      if (c == C - 1) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (r < nrows) {
            right[row0 + r] = H[r];
            if (AFFINE) right_e[row0 + r] = E[r];
          }
        }
      }
    }
    __syncthreads();
  }

  // the block's row-major-first best: (value, least row), then its column
  Cand cand = best.cand(row0);
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    const Cand o = shfl_down(cand, k);
    if ((I & 31) + k < 32 && better(o, cand)) cand = o;
  }
  if ((I & 31) == 0) warp_best[I >> 5] = cand;
  __syncthreads();
  if (I == 0) {
    Cand b = warp_best[0];
    for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w)
      if (better(warp_best[w], b)) b = warp_best[w];
    const bool zero = b.v <= 0;
    out3[0] = max(b.v, 0);
    out3[1] = zero ? 0 : b.row + 1;
    out3[2] = zero ? 0 : b.col + 1;
  }
}

template <int BR>
cudaError_t launch(bool affine, int threads, const uint8_t* q, const uint8_t* t,
                   const int32_t* table, int stride, const int32_t* top,
                   const int32_t* topf, const int32_t* lext, const int32_t* lext_e,
                   int32_t* bottom, int32_t* bottom_f, int32_t* right, int32_t* right_e,
                   int32_t* out3, int R, int C, int go, int ge, cudaStream_t stream) {
  if (affine)
    strip_tile_kernel<BR, true><<<1, threads, 0, stream>>>(
        q, t, table, stride, top, topf, lext, lext_e, bottom, bottom_f, right,
        right_e, out3, R, C, go, ge);
  else
    strip_tile_kernel<BR, false><<<1, threads, 0, stream>>>(
        q, t, table, stride, top, topf, lext, lext_e, bottom, bottom_f, right,
        right_e, out3, R, C, go, ge);
  return cudaGetLastError();
}

// --- the pipelined tile: a warp per row band, the bands on many SMs ---------

constexpr unsigned FULL = 0xffffffffu;

struct PipeArgs {
  const uint8_t* q;
  const uint8_t* t;
  const int32_t* table;
  const int32_t* top;
  const int32_t* topf;
  const int32_t* lext;
  const int32_t* lext_e;
  int32_t* bottom;
  int32_t* bottom_f;
  int32_t* right;
  int32_t* right_e;
  int32_t* out3;
  unsigned long long* hand;  // [bands - 1][AFFINE ? 3 : 1][C] zeroed: each band's last row, tagged
  int32_t* done;             // [1] zeroed: bands finished
  int32_t* cands;            // [bands][3]: each band's best (value, row, column)
  const int32_t* bmax;       // [1]: the largest boundary value (top, left, F, E)
  int stride, R, C, go, ge, bands;
  int reach;                 // how far H climbs above it in the tile, <= KEY_MAX
};

// A handed-over value and its tag (column + 1) in one 64-bit word: a
// reader that sees the tag sees the value, with no fence on either side.
__device__ __forceinline__ void put_tagged(unsigned long long* p, int v, int tag) {
  *reinterpret_cast<volatile unsigned long long*>(p) =
      (static_cast<unsigned long long>(static_cast<unsigned>(tag)) << 32) |
      static_cast<unsigned>(v);
}

__device__ __forceinline__ unsigned long long get_tagged(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ bool tagged_at(unsigned long long w, int col) {
  return static_cast<int>(w >> 32) == col + 1;
}

// One row band of 32 * BR rows on one warp: lane L owns rows [L*BR, L*BR +
// BR) of the band and computes column c = s - L at step s, so its top input
// is lane L - 1's last row from the step before (a shuffle) and its target
// code the one lane L - 1 used. Lane 0 takes the band's top row and the
// target codes from the ring: the tile's top row for band 0, else the last
// row of band - 1, which the lane that owns it writes as tagged words
// column by column.
template <int BR, bool AFFINE, bool WIDE>
__device__ void warp_band(const PipeArgs& a, const int32_t* tab, int band, int lane,
                          Cand& best) {
  constexpr int NP = (BR + 3) / 4;
  const int C = a.C, go = a.go, ge = a.ge, stride = a.stride;
  const int brow0 = band * 32 * BR;
  const int row0 = brow0 + lane * BR;
  const int nrows = min(BR, a.R - row0);  // <= 0 in the lanes past the tile
  const bool lastband = band == a.bands - 1;
  const int last_lane = lastband ? (a.R - 1 - brow0) / BR : 31;  // owns the band's last row
  constexpr int WORDS = AFFINE ? 3 : 1;  // H, and for Gotoh pre and F
  const unsigned long long* src =
      band ? a.hand + static_cast<size_t>(band - 1) * WORDS * C : nullptr;
  unsigned long long* dst =
      lastband ? nullptr : a.hand + static_cast<size_t>(band) * WORDS * C;
  const int pad = stride - 1;

  uint32_t qp[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) qp[k] = 0;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    const uint32_t code = r < nrows ? min(static_cast<int>(a.q[row0 + r]), pad) : pad;
    qp[r >> 2] |= code << (8 * (r & 3));
  }
  int H[BR], E[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    H[r] = 0;
    E[r] = NEGB;
  }

  // the band's top row (H, pre, F) and the target codes in a ring over the
  // lanes: lane c % 32 holds column c as tagged words (band 0 tags the
  // tile's top row itself), loaded SUB columns at a time, SUB steps before
  // lane 0 needs them, and checked then
  constexpr int SUB = 8;
  unsigned long long wH = 0, wP = 0, wF = 0;
  int wT = 0;
  auto load = [&](int col) {  // this lane's column col
    if (col >= C) return;
    wT = a.t[col];
    if (band) {
      wH = get_tagged(src + col);
      if (AFFINE) {
        wP = get_tagged(src + C + col);
        wF = get_tagged(src + 2 * C + col);
      }
    } else {
      const unsigned long long tag = static_cast<unsigned long long>(col + 1) << 32;
      wH = wP = tag | static_cast<unsigned>(a.top[col]);
      wF = tag | static_cast<unsigned>(AFFINE ? a.topf[col] : NEGB);
    }
  };
  auto loaded = [&](int col) {
    return col >= C || (tagged_at(wH, col) &&
                        (!AFFINE || (tagged_at(wP, col) && tagged_at(wF, col))));
  };
  // the lanes of columns [s0, s0 + SUB) load them
  auto issue = [&](int s0) {
    const int col = s0 + ((lane - s0) & 31);
    if (col < s0 + SUB) load(col);
  };
  // ... and wait until band - 1 has written them
  auto settle = [&](int s0) {
    const int col = s0 + ((lane - s0) & 31);
    const bool mine = col < s0 + SUB;
    bool ok = !mine || loaded(col);
    while (!__all_sync(FULL, ok)) {
      if (!ok) {
        __nanosleep(32);
        load(col);
        ok = loaded(col);
      }
    }
  };
  issue(0);
  settle(0);
  issue(SUB);

  int out_h = 0, out_p = 0, out_f = NEGB, out_t = 0;  // handed to lane + 1
  int top_prev = 0;
  Best<BR, WIDE> mine;
  const int steps = C + 31;
  for (int s = 0; s < steps; ++s) {
    if (s % SUB == 0 && s && s < C) {  // columns [s, s + SUB) become current
      settle(s);
      if (s + SUB < C) issue(s + SUB);
    }
    const int k = s & 31;
    const int th = __shfl_sync(FULL, static_cast<int>(wH), k);
    const int tt = __shfl_sync(FULL, wT, k);
    int tp = 0, tf = NEGB;
    if (AFFINE) {
      tp = __shfl_sync(FULL, static_cast<int>(wP), k);
      tf = __shfl_sync(FULL, static_cast<int>(wF), k);
    }
    int up_h = __shfl_up_sync(FULL, out_h, 1);
    int tc = __shfl_up_sync(FULL, out_t, 1);
    int up_p = 0, up_f = NEGB;
    if (AFFINE) {
      up_p = __shfl_up_sync(FULL, out_p, 1);
      up_f = __shfl_up_sync(FULL, out_f, 1);
    }
    if (lane == 0) {
      up_h = th;
      tc = tt;
      up_p = tp;
      up_f = max(tf, NEGB);
    }
    const int c = s - lane;
    if (c >= 0 && c < C && nrows > 0) {
      int diag = top_prev;
      if (c == 0) {
        diag = a.lext[row0];
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (r < nrows) {
            H[r] = a.lext[row0 + r + 1];
            if (AFFINE) E[r] = a.lext_e[row0 + r + 1];
          }
        }
      }
      top_prev = up_h;
      out_t = tc;
      // branch-free rows: every lookup first, then the chain; a ragged last
      // lane's rows past R compute on pad codes and are masked
      const int* col = tab + min(tc, pad);
      int sc[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r)
        sc[r] = col[static_cast<int>(__byte_perm(qp[r >> 2], 0, 0x4440 | (r & 3))) * stride];
      int last_h = up_h, last_p = up_p, last_f = up_f;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int left = H[r];
        int h;
        if constexpr (AFFINE) {
          const int e = max(E[r] - ge, left - go);
          const int pre = max(max(diag + sc[r], e), 0);
          const int f = max(up_f - ge, up_p - go);
          h = max(pre, f);
          E[r] = e;
          up_p = pre;
          up_f = f;
        } else {
          // the chain runs through up_h alone: one add-max a row
          h = max(max(max(diag + sc[r], 0), left - go), up_h - go);
        }
        diag = left;
        up_h = h;
        H[r] = h;
        const bool real = r < nrows;
        mine.take(h, r, c, real);
        last_h = real ? h : last_h;
        last_p = real ? up_p : last_p;
        last_f = real ? up_f : last_f;
      }
      out_h = last_h;
      out_p = last_p;
      out_f = last_f;
      if (lane == last_lane) {
        if (lastband) {
          a.bottom[c] = last_h;
          if (AFFINE) a.bottom_f[c] = last_f;
        } else {
          put_tagged(dst + c, last_h, c + 1);
          if (AFFINE) {
            put_tagged(dst + C + c, last_p, c + 1);
            put_tagged(dst + 2 * C + c, last_f, c + 1);
          }
        }
      }
      if (c == C - 1) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          if (r < nrows) {
            a.right[row0 + r] = H[r];
            if (AFFINE) a.right_e[row0 + r] = E[r];
          }
        }
      }
    }
  }
  // the band's row-major-first best
  Cand cand = mine.cand(row0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Cand x = shfl_down(cand, o);
    if (lane + o < 32 && better(x, cand)) cand = x;
  }
  if (lane == 0) best = cand;
}

template <int BR, bool AFFINE>
__global__ void __launch_bounds__(32) strip_pipe_kernel(PipeArgs a) {
  __shared__ int32_t tab[MAX_STRIDE * MAX_STRIDE];
  const int lane = threadIdx.x;
  for (int k = lane; k < a.stride * a.stride; k += 32) tab[k] = a.table[k];
  // the packed key while every H of the tile stays below 2^27
  const bool wide = max(__ldg(a.bmax), 0) >= KEY_MAX - a.reach;
  __syncwarp();
  for (int band = blockIdx.x; band < a.bands; band += gridDim.x) {
    Cand best{-1, 0, 0};
    if (wide)
      warp_band<BR, AFFINE, true>(a, tab, band, lane, best);
    else
      warp_band<BR, AFFINE, false>(a, tab, band, lane, best);
    if (lane == 0) {  // the last band to finish merges the bands' bests
      a.cands[3 * band] = best.v;
      a.cands[3 * band + 1] = best.row;
      a.cands[3 * band + 2] = best.col;
      __threadfence();
      if (atomicAdd(a.done, 1) == a.bands - 1) {
        __threadfence();
        Cand b{-1, 0, 0};
        for (int g = 0; g < a.bands; ++g) {
          const Cand o{__ldcg(a.cands + 3 * g), __ldcg(a.cands + 3 * g + 1),
                       __ldcg(a.cands + 3 * g + 2)};
          if (better(o, b)) b = o;
        }
        const bool zero = b.v <= 0;
        a.out3[0] = max(b.v, 0);
        a.out3[1] = zero ? 0 : b.row + 1;
        a.out3[2] = zero ? 0 : b.col + 1;
      }
    }
    __syncwarp();
  }
}

template <int BR>
cudaError_t launch_pipe(bool affine, PipeArgs a, cudaStream_t stream, int* grid_out) {
  auto kernel = affine ? strip_pipe_kernel<BR, true> : strip_pipe_kernel<BR, false>;
  // every warp must be resident at once: a band waits on the band above
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int grid = min(a.bands, per_sm * sms);
  *grid_out = grid;
  kernel<<<grid, 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one tile on `stream` and returns cudaGetLastError() (a refused
// launch never runs, and a later synchronise would not report it);
// cudaErrorInvalidValue for rows per thread outside {1, 2, 4, 8, 16}, a
// tile the threads cannot cover, or a table stride outside 1..32.
// Pointers: q [R] / t [C] uint8 codes, table [stride, stride] int32, top
// [C], lext [R + 1] (corner, then the left column), bottom [C], right [R],
// out3 [3] (best, end_i, end_j) int32; affine also topf [C], lext_e [R + 1]
// (-2^20, then the left column's E), bottom_f [C], right_e [R]. All on one
// device, contiguous; the wrapper checks that. The linear gap is go.
int swtpu_strip_tile(int affine, int br, const void* q, const void* t,
                     const void* table, int stride, const void* top,
                     const void* topf, const void* lext, const void* lext_e,
                     void* bottom, void* bottom_f, void* right, void* right_e,
                     void* out3, int R, int C, int go, int ge, void* stream) {
  if (R < 1 || C < 1 || stride < 1 || stride > MAX_STRIDE || br < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = (R + br - 1) / br;
  if (T > MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (T + 31) / 32 * 32;  // whole warps: the shuffles take full masks
  auto s = static_cast<cudaStream_t>(stream);
  auto q8 = static_cast<const uint8_t*>(q);
  auto t8 = static_cast<const uint8_t*>(t);
  auto tb = static_cast<const int32_t*>(table);
  auto tp = static_cast<const int32_t*>(top);
  auto tf = static_cast<const int32_t*>(topf);
  auto le = static_cast<const int32_t*>(lext);
  auto lee = static_cast<const int32_t*>(lext_e);
  auto bo = static_cast<int32_t*>(bottom);
  auto bf = static_cast<int32_t*>(bottom_f);
  auto ri = static_cast<int32_t*>(right);
  auto re = static_cast<int32_t*>(right_e);
  auto o3 = static_cast<int32_t*>(out3);
  switch (br) {
    case 1: return static_cast<int>(launch<1>(affine, threads, q8, t8, tb, stride, tp, tf, le, lee, bo, bf, ri, re, o3, R, C, go, ge, s));
    case 2: return static_cast<int>(launch<2>(affine, threads, q8, t8, tb, stride, tp, tf, le, lee, bo, bf, ri, re, o3, R, C, go, ge, s));
    case 4: return static_cast<int>(launch<4>(affine, threads, q8, t8, tb, stride, tp, tf, le, lee, bo, bf, ri, re, o3, R, C, go, ge, s));
    case 8: return static_cast<int>(launch<8>(affine, threads, q8, t8, tb, stride, tp, tf, le, lee, bo, bf, ri, re, o3, R, C, go, ge, s));
    case 16: return static_cast<int>(launch<16>(affine, threads, q8, t8, tb, stride, tp, tf, le, lee, bo, bf, ri, re, o3, R, C, go, ge, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pipelined tile on `stream`: the same contract as swtpu_strip_tile,
// in `bands` row bands of 32 * br rows (bands = ceil(R / (32 * br))), a
// warp each, as many warps as fit resident at once, each taking bands in
// turn. hand [(bands - 1) * (affine ? 3 : 1) * C] uint64 and done [1] int32 zeroed, cands
// [3 * bands] int32: scratch on the device; bmax [1] int32 the largest
// boundary value (top, lext, and for affine topf, lext_e), reach in 0..2^27
// how far H can climb above it in the tile (the endpoint's packed key
// runs where the two stay below 2^27); *grid_out gets the warps
// launched. Returns cudaGetLastError(), or cudaErrorInvalidValue for rows
// per thread outside {1, 2, 4, 8, 16}, a band count that does not match,
// a reach outside 0..2^27 or a table stride outside 1..32.
int swtpu_strip_pipe(int affine, int br, const void* q, const void* t, const void* table,
                     int stride, const void* top, const void* topf, const void* lext,
                     const void* lext_e, void* bottom, void* bottom_f, void* right,
                     void* right_e, void* out3, void* hand, void* done, void* cands,
                     const void* bmax, int R, int C, int go, int ge, int bands, int reach,
                     int* grid_out, void* stream) {
  if (R < 1 || C < 1 || stride < 1 || stride > MAX_STRIDE || br < 1 ||
      bands != (R + 32 * br - 1) / (32 * br) || reach < 0 || reach > KEY_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const PipeArgs a{static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(t),
                   static_cast<const int32_t*>(table), static_cast<const int32_t*>(top),
                   static_cast<const int32_t*>(topf), static_cast<const int32_t*>(lext),
                   static_cast<const int32_t*>(lext_e), static_cast<int32_t*>(bottom),
                   static_cast<int32_t*>(bottom_f), static_cast<int32_t*>(right),
                   static_cast<int32_t*>(right_e), static_cast<int32_t*>(out3),
                   static_cast<unsigned long long*>(hand), static_cast<int32_t*>(done),
                   static_cast<int32_t*>(cands), static_cast<const int32_t*>(bmax), stride,
                   R, C, go, ge, bands, reach};
  auto s = static_cast<cudaStream_t>(stream);
  switch (br) {
    case 1: return static_cast<int>(launch_pipe<1>(affine != 0, a, s, grid_out));
    case 2: return static_cast<int>(launch_pipe<2>(affine != 0, a, s, grid_out));
    case 4: return static_cast<int>(launch_pipe<4>(affine != 0, a, s, grid_out));
    case 8: return static_cast<int>(launch_pipe<8>(affine != 0, a, s, grid_out));
    case 16: return static_cast<int>(launch_pipe<16>(affine != 0, a, s, grid_out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
