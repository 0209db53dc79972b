// Block-adaptive banded X-drop semi-global alignment for Hopper (sm_90a):
// the block row-scan B9 as one launch for the whole forward, a warp per
// pair; for negative gap penalties the per-block B9, a thread per pair,
// fed by the corridor window gather B10; linear or affine (Gotoh) gaps,
// uniform or general-matrix scoring, per-pair query lengths on linear
// gaps, optional H-only band history.
//
// Replaces the block tier's three TPU kernels:
//   block_gather   swtpu/kernels/pallas/banded_block.py  _gather_kernel        (pallas_call :872)
//   block_rows     swtpu/kernels/pallas/banded_block.py  _block_kernel         (pallas_call :827)
//                  and                                   _block_kernel_folded  (pallas_call :761)
// The folded kernel puts band segments on idle sublanes when a small
// batch fills fewer than 8 rows of 128 pairs; the lanes of a warp hold one
// pair's slots here, so one kernel serves both contracts.
//
// Contract: oracle/banded_block.py (banded_xdrop_block, linear, and
// banded_xdrop_block_affine), batched as _banded_block_impl's loop runs it:
// the band is a corridor of W slots that slides +1 column a row (slot k of
// row y = b*K + r + 1 holds column base_b + r + k); values carry +X with 0
// dead; diag = prev[k], up = prev[k + 1], left the chain along the slots;
// dead neighbours never propagate (the oracle's dead tests); a slot
// holding column 0 is pinned to the gap chain (affine: H relu, F raw); the
// endpoint is the row-major first maximum (strict > across rows and
// blocks, first slot within a row). At the block end: X-drop of the
// carried row against the updated max, the history's last row of the
// block overwritten by its X-dropped version, the dead test, the first
// argmax, delta = clip(argmax - W/2, -D, D), carried[k] = zeroed[k + delta]
// (dead outside: 0, and EF_DEAD for F) as an index offset, not the TPU's
// barrel shifter. Uniform scoring matches only q == t with t >= 0 (a pad,
// -1, scores -mismatch); the matrix reads the banded extended table, whose
// rows and columns past the alphabet hold matrix.min(): any code outside
// [0, stride) is a pad there. The loop's bookkeeping
// (_banded_block_impl:993-1023): a done pair writes its frozen base and
// delta 0 and nothing else (the history was zeroed by the wrapper); a live
// pair writes bases[b], its delta (0 if the block ends it: dead, or its
// last block), n_rows = min(b*K + Kb, len_q) and the done flag. Rows past a
// pair's length (VARLEN) freeze: they commit nothing and the history
// repeats the last row, as the TPU kernel's commit masks leave it; the
// pair's own final row gets the block-end X-drop too (the wrapper fixup of
// banded_block.py:1181-1191, done here).
//
// Design of the one-launch forward (block_fwd_kernel<S, ...>). A warp
// carries one pair through every block; lane l holds slots [l*S, l*S + S)
// of the band row in registers, S = ceil(W / 32) (phantom slots past W
// hold 0 and feed nothing: the chain runs toward higher slots). The left
// chain h_k = max(a_k, h_{k-1} - g) over the diag/up candidates a_k is a
// max-plus scan: each lane's serial pass, a Hillis-Steele scan of the lane
// totals (5 shuffles, lane d away decayed by d*S*g), the carry into each
// lane and a second pass; Gotoh scans E's positive part the same way over
// a_k - go with step min(go, ge). Exact for gap penalties >= 0: the floor
// at 0 makes the oracle's dead tests redundant, and every slot left of
// the column-0 pin holds a negative column, dead since the start, so the
// pin needs no segment. Each lane keeps its own best (strict >, rows then
// slots), reduced at each block end (X-drop cutoff) and at the end
// (value, least row, least column). The corridor window is read in place
// from t16 at the pair's base into the warp's shared row (B10's function),
// the block's query codes beside it. A pair stops when it is done; the
// blocks after it get its frozen base and delta 0 as far as the host loop
// that polls every `poll` blocks would have run them, the last CTA to
// finish writing the rest once it sees every pair's count (threadfence
// reduction). Negative penalties keep the oracle's serial chain in the
// per-block kernel (block_rows_kernel<WR, ...>): a thread per pair, the
// band row in registers for W = 16-64 and shared memory above, one launch
// a block after B10's [Kb + W - 1, B] window (the wrapper's route).
//
// Bound: int32 issue (132 SMs x 64 lanes x SM clock) over the band cells:
// the function needs about 11 int32 ops a cell with uniform linear scoring,
// 25 Gotoh, the matrix 2 fewer and one shared-memory lookup, plus the
// row and block-end work (chip_smoke.py::block_ops). With 256-1024 pairs
// a warp a pair fills 2-8 warps an SM, so the latency of a row binds
// instead: the shuffle chain of the lane scan (6 in series) and the
// neighbour exchange (PERF.md section 6). History writes ([n, W, B],
// slot stride B) do not coalesce across the lanes of one pair; at 1024
// pairs they cost more than the forward itself (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;      // pairs per block, band rows in registers
constexpr int SMEM_THREADS = 64;  // pairs per block, band rows in shared memory
constexpr int MAX_STRIDE = 32;
constexpr int EF_DEAD = -(1 << 28);
constexpr int EF_CUT = -(1 << 27);  // EF_DEAD / 2
constexpr int MINF = -(1 << 30);

struct Args {
  const int16_t* qT;     // [n, B] query codes
  const int16_t* win;    // [Kb + W - 1, B] corridor window (B10)
  const int32_t* table;  // [stride, stride] or null (uniform scoring)
  const int32_t* lens_q; // [B] or null
  int32_t* carried;      // [W, B] H (+ [W, B] F for Gotoh), in place
  int32_t* state;        // [4, B]: base, max, end_y, end_j, in place
  int32_t* done;         // [B]
  int32_t* n_rows;       // [B]
  int32_t* bases;        // [NB, B]
  int32_t* deltas;       // [NB, B]
  int32_t* hist;         // [n, W, B] or null
  int B, n, W, bidx, y0, Kb, X, match, mismatch, gap, go, ge, D, stride;
};

template <int WR>
struct RegBand {
  int v[WR];
  __device__ __forceinline__ int& operator[](int k) { return v[k]; }
};

struct SmemBand {
  int* p;  // this thread's slot 0; slot k at p[k * SMEM_THREADS]
  __device__ __forceinline__ int& operator[](int k) { return p[k * SMEM_THREADS]; }
};

template <bool MATRIX>
__device__ __forceinline__ int score(const Args& a, const int32_t* tab, int qc, int qoff,
                                     int tc) {
  if (MATRIX) {
    const int ti = (static_cast<unsigned>(tc) < static_cast<unsigned>(a.stride)) ? tc
                                                                              : a.stride - 1;
    return tab[qoff + ti];
  }
  return (qc == tc && tc >= 0) ? a.match : -a.mismatch;
}

template <int WR, class Band>
__device__ __forceinline__ void write_row(const Args& a, Band& P, int Wrun, int y, int b) {
  const int W = WR > 0 ? WR : Wrun;
  const size_t sB = static_cast<size_t>(a.B);
  int32_t* row = a.hist + static_cast<size_t>(y - 1) * W * sB + b;
#pragma unroll
  for (int k = 0; k < W; ++k) row[k * sB] = P[k];
}

template <int WR, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST, class Band>
__device__ __forceinline__ void block_body(const Args& a, const int32_t* tab, Band& P,
                                           Band& PF, int b) {
  const int W = WR > 0 ? WR : a.W;
  const size_t sB = static_cast<size_t>(a.B);
  const int base = a.state[b];
  const size_t meta = static_cast<size_t>(a.bidx) * sB + b;
  a.bases[meta] = base;
  if (a.done[b]) {  // frozen: the history stays as the wrapper zeroed it
    a.deltas[meta] = 0;
    return;
  }
  int maxg = a.state[sB + b], end_y = a.state[2 * sB + b], end_j = a.state[3 * sB + b];
#pragma unroll
  for (int k = 0; k < W; ++k) P[k] = a.carried[k * sB + b];
  if (AFFINE) {
#pragma unroll
    for (int k = 0; k < W; ++k) PF[k] = a.carried[(W + k) * sB + b];
  }
  const int lens = VARLEN ? a.lens_q[b] : a.n;
  const int y0 = a.y0;
  int r = 0;
  for (; r < a.Kb; ++r) {
    const int y = y0 + r + 1;
    if (VARLEN && y > lens) break;  // rows past the pair's length freeze
    const int qc = a.qT[static_cast<size_t>(y - 1) * sB + b];
    const int qoff = MATRIX ? ((static_cast<unsigned>(qc) < static_cast<unsigned>(a.stride))
                                   ? qc : a.stride - 1) * a.stride
                            : 0;
    const int bpr = base + r;  // column of slot 0 in this row
    const int16_t* wrow = a.win + static_cast<size_t>(r) * sB + b;  // slot k: wrow[k * sB]
    int rowmax = 0;
    if constexpr (!AFFINE) {
      const int g = a.gap;
      const int pin = max(a.X - y * g, 0);  // the column-0 gap chain
      int left = (bpr == 1) ? pin : 0;      // left of slot 0: column 0 or dead
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int s = score<MATRIX>(a, tab, qc, qoff, wrow[k * sB]);
        const int pv = P[k];
        const int pn = (k + 1 < W) ? P[k + 1] : 0;
        const int diag = pv > 0 ? pv + s : 0;
        const int up = pn > 0 ? pn - g : 0;
        const int lf = left > 0 ? left - g : 0;
        int h = max(max(diag, up), max(lf, 0));
        h = (bpr + k == 0) ? pin : h;
        P[k] = h;
        left = h;
        rowmax = max(rowmax, h);
      }
    } else {
      const int go = a.go, ge = a.ge;
      const int chain = a.X - go - (y - 1) * ge;  // affine leading-gap chain, y >= 1
      const int pin_h = max(chain, 0);
      int hl = (bpr == 1) ? pin_h : 0;
      int el = EF_DEAD;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int s = score<MATRIX>(a, tab, qc, qoff, wrow[k * sB]);
        const int pv = P[k];
        const int pn = (k + 1 < W) ? P[k + 1] : 0;
        const int pfn = (k + 1 < W) ? PF[k + 1] : EF_DEAD;
        const int diag = pv > 0 ? pv + s : MINF;
        int f = max(pfn > EF_CUT ? pfn - ge : MINF, pn > 0 ? pn - go : MINF);
        int e = max(el > EF_CUT ? el - ge : MINF, hl > 0 ? hl - go : MINF);
        int v = max(max(diag, e), max(f, 0));
        if (bpr + k == 0) {  // column-0 pin: the chain in H (relu) and F (raw)
          v = pin_h;
          f = chain;
          e = MINF;
        }
        if (v == 0) {  // dead blocks all propagation
          e = EF_DEAD;
          f = EF_DEAD;
        }
        P[k] = v;
        PF[k] = max(f, EF_DEAD);
        hl = v;
        el = max(e, EF_DEAD);
        rowmax = max(rowmax, v);
      }
    }
    if (rowmax > maxg) {  // the row-major first maximum: first slot of the row
      int kk = 0;
#pragma unroll
      for (int k = W - 1; k >= 0; --k) kk = (P[k] == rowmax) ? k : kk;
      maxg = rowmax;
      end_y = y;
      end_j = bpr + kk;
    }
    if (HIST) write_row<WR>(a, P, W, y, b);
  }
  if (VARLEN && HIST) {
    for (; r < a.Kb; ++r) write_row<WR>(a, P, W, y0 + r + 1, b);
  }

  // block end: X-drop against the updated max, dead test, first argmax
  const int cutoff = maxg - a.X;
  int am_v = 0, am_k = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int z = P[k] < cutoff ? 0 : P[k];
    P[k] = z;
    if (AFFINE) PF[k] = (z == 0) ? EF_DEAD : PF[k];
    if (z > am_v) {
      am_v = z;
      am_k = k;
    }
  }
  const int last_y = y0 + a.Kb;
  if (HIST) {
    write_row<WR>(a, P, W, last_y, b);
    if (VARLEN && lens < last_y && lens > y0) write_row<WR>(a, P, W, lens, b);
  }
  const bool alive = am_v > 0;
  const int delta = alive ? min(max(am_k - W / 2, -a.D), a.D) : 0;
  // realign: carried[k] = zeroed[k + delta]; a slot with no source is dead
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int dst = k - delta;
    if (dst >= 0 && dst < W) a.carried[dst * sB + b] = P[k];
    const int src = k + delta;
    if (src < 0 || src >= W) a.carried[k * sB + b] = 0;
  }
  if (AFFINE) {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int dst = k - delta;
      if (dst >= 0 && dst < W) a.carried[(W + dst) * sB + b] = PF[k];
      const int src = k + delta;
      if (src < 0 || src >= W) a.carried[(W + k) * sB + b] = EF_DEAD;
    }
  }
  const bool last = last_y >= lens;
  a.deltas[meta] = (last || !alive) ? 0 : delta;
  a.state[b] = alive ? base + a.Kb + delta : base;
  a.state[sB + b] = maxg;
  a.state[2 * sB + b] = end_y;
  a.state[3 * sB + b] = end_j;
  a.n_rows[b] = min(last_y, lens);
  a.done[b] = (!alive || last) ? 1 : 0;
}

template <int WR, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST>
__global__ void __launch_bounds__(WR > 0 ? THREADS : SMEM_THREADS)
block_rows_kernel(Args a) {
  constexpr int NT = WR > 0 ? THREADS : SMEM_THREADS;
  extern __shared__ int32_t smem[];
  const int tab_words = MATRIX ? a.stride * a.stride : 0;
  if (MATRIX) {
    for (int k = threadIdx.x; k < tab_words; k += NT) smem[k] = a.table[k];
    __syncthreads();
  }
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= a.B) return;
  if constexpr (WR > 0) {
    RegBand<WR> P, PF;  // PF is unused (and eliminated) for linear gaps
    block_body<WR, AFFINE, MATRIX, VARLEN, HIST>(a, smem, P, PF, b);
  } else {
    SmemBand P{smem + tab_words + threadIdx.x};
    SmemBand PF{smem + tab_words + a.W * NT + threadIdx.x};
    block_body<0, AFFINE, MATRIX, VARLEN, HIST>(a, smem, P, PF, b);
  }
}

template <int WR, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  constexpr int NT = WR > 0 ? THREADS : SMEM_THREADS;
  size_t smem = MATRIX ? sizeof(int32_t) * a.stride * a.stride : 0;
  if (WR == 0) smem += sizeof(int32_t) * (AFFINE ? 2 : 1) * a.W * NT;
  auto kernel = block_rows_kernel<WR, AFFINE, MATRIX, VARLEN, HIST>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.B + NT - 1) / NT);
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <int WR, bool AFFINE, bool MATRIX, bool VARLEN>
cudaError_t pick_hist(const Args& a, cudaStream_t s) {
  return a.hist ? launch_rows<WR, AFFINE, MATRIX, VARLEN, true>(a, s)
                : launch_rows<WR, AFFINE, MATRIX, VARLEN, false>(a, s);
}

template <int WR, bool AFFINE, bool MATRIX>
cudaError_t pick_varlen(const Args& a, cudaStream_t s) {
  if constexpr (AFFINE) {
    if (a.lens_q) return cudaErrorInvalidValue;  // Gotoh takes no lengths
    return pick_hist<WR, true, MATRIX, false>(a, s);
  } else {
    return a.lens_q ? pick_hist<WR, false, MATRIX, true>(a, s)
                    : pick_hist<WR, false, MATRIX, false>(a, s);
  }
}

template <int WR>
cudaError_t pick_mode(bool affine, const Args& a, cudaStream_t s) {
  if (affine)
    return a.table ? pick_varlen<WR, true, true>(a, s) : pick_varlen<WR, true, false>(a, s);
  return a.table ? pick_varlen<WR, false, true>(a, s) : pick_varlen<WR, false, false>(a, s);
}

// --- the one-launch forward: a warp per pair -------------------------------

constexpr int FWD_WARPS = 2;  // pairs per CTA: few pairs spread over many SMs
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int WIN_MAX = 128;  // Kb + W - 1 <= 128 (block + width <= 129)
constexpr unsigned FULL = 0xffffffffu;

struct FwdArgs {
  const int16_t* qT;      // [n, B] query codes
  const int16_t* t16;     // [B, m] target codes, -1 past each pair's length
  const int32_t* table;   // [stride, stride] or null (uniform scoring)
  const int32_t* lens_q;  // [B] or null
  int32_t* carried;       // [W, B] H (+ [W, B] F for Gotoh): the start, then the end
  int32_t* state;         // [4, B]: base, max, end_y, end_j
  int32_t* done;          // [B]
  int32_t* n_rows;        // [B]
  int32_t* bases;         // [NB, B]
  int32_t* deltas;        // [NB, B]
  int32_t* hist;          // [n, W, B] or null (zeroed by the wrapper)
  int32_t* scratch;       // [2 + B] zeroed: CTAs finished, most live blocks, each pair's
  int B, n, m, W, K, X, match, mismatch, gap, go, ge, D, stride, early, poll;
};

__device__ __forceinline__ int sat_mul(int a, int b, int c) {  // a * b * c, capped
  const long long v = static_cast<long long>(a) * b * c;
  return v > 0x7fffffffLL ? 0x7fffffff : static_cast<int>(v);
}

// One pair's whole forward on one warp: lane l holds slots [l*S, l*S + S)
// of the band row (the ones past W are phantoms, 0, that feed nothing: the
// chain runs toward higher slots and slot W - 1's up neighbour is dead).
template <int S, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST>
__device__ void forward_pair(const FwdArgs& a, const int32_t* tab, int32_t* win,
                             int32_t* qrow, int b, int lane) {
  const int W = a.W;
  const size_t sB = static_cast<size_t>(a.B);
  const int NBf = a.n / a.K, Kt = a.n % a.K;
  const int NB = NBf + (Kt > 0);
  const int k0 = lane * S;  // this lane's first slot
  int P[S], PF[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    P[s] = k < W ? a.carried[k * sB + b] : 0;
    PF[s] = (AFFINE && k < W) ? a.carried[(W + k) * sB + b] : EF_DEAD;
  }
  // the decayed steps of the lane scan: d lanes carry d * S slots
  const int step = AFFINE ? min(a.go, a.ge) : a.gap;
  int stepd[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) stepd[i] = sat_mul(1 << i, S, step);
  int base = a.state[b];
  int lb_v = a.state[sB + b], lb_y = a.state[2 * sB + b], lb_j = a.state[3 * sB + b];
  const int lens = VARLEN ? a.lens_q[b] : a.n;
  int nrows = a.n_rows[b];
  bool done = a.done[b] != 0;
  int dlive = 0;
  for (int blk = 0; blk < NB && !done; ++blk) {
    const int Kb = blk < NBf ? a.K : Kt;
    const int y0 = blk * a.K, last_y = y0 + Kb;
    // the corridor window read in place (B10's function) and the block's
    // query codes, staged in this warp's shared rows
    for (int c = lane; c < Kb + W - 1; c += 32) {
      const long long pos = static_cast<long long>(base) + c - 1;
      win[c] = (pos >= 0 && pos < a.m) ? a.t16[static_cast<size_t>(b) * a.m + pos] : -1;
    }
    for (int r = lane; r < Kb; r += 32) qrow[r] = a.qT[static_cast<size_t>(y0 + r) * sB + b];
    __syncwarp();
    const int rows = VARLEN ? max(0, min(Kb, lens - y0)) : Kb;  // rows past lens freeze
    for (int r = 0; r < rows; ++r) {
      const int y = y0 + r + 1;
      const int qc = qrow[r];
      const int qoff = MATRIX ? ((static_cast<unsigned>(qc) < static_cast<unsigned>(a.stride))
                                     ? qc : a.stride - 1) * a.stride
                              : 0;
      const int bpr = base + r;  // column of slot 0 in this row
      const int pn_next = __shfl_down_sync(FULL, P[0], 1);  // the next lane's first slot
      const int pfn_next = AFFINE ? __shfl_down_sync(FULL, PF[0], 1) : EF_DEAD;
      int av[S], fv[S];
      // the chain's candidates: diag and up (Gotoh: and F), floored at 0
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s;
        int sc = 0;
        if (k < W) {
          const int tc = win[r + k];
          if (MATRIX) {
            sc = tab[qoff + ((static_cast<unsigned>(tc) < static_cast<unsigned>(a.stride))
                                 ? tc : a.stride - 1)];
          } else {
            sc = (qc == tc && tc >= 0) ? a.match : -a.mismatch;
          }
        }
        const int pv = P[s];
        const int pn = k + 1 >= W ? 0 : (s + 1 < S ? P[s + 1] : pn_next);
        if constexpr (!AFFINE) {
          const int diag = pv > 0 ? pv + sc : 0;
          const int up = pn > 0 ? pn - a.gap : 0;
          int v = max(max(diag, up), 0);
          if (bpr + k == 0) v = max(a.X - y * a.gap, 0);  // the column-0 pin
          av[s] = k < W ? v : 0;
          fv[s] = 0;
        } else {
          const int pfn = k + 1 >= W ? EF_DEAD : (s + 1 < S ? PF[s + 1] : pfn_next);
          const int diag = pv > 0 ? pv + sc : MINF;
          int f = max(pfn > EF_CUT ? pfn - a.ge : MINF, pn > 0 ? pn - a.go : MINF);
          int v = max(max(diag, f), 0);
          if (bpr + k == 0) {  // the column-0 pin: the chain in H (relu) and F (raw)
            const int chain = a.X - a.go - (y - 1) * a.ge;
            v = max(chain, 0);
            f = chain;
          }
          av[s] = k < W ? v : 0;
          fv[s] = f;
        }
      }
      // the left chain (Gotoh: E's positive part) as a max-plus scan:
      // the lane's serial pass, the warp scan of lane totals, the carry in
      int first;
      if constexpr (!AFFINE) {
        first = bpr == 1 ? max(a.X - y * a.gap, 0) : 0;
      } else {
        first = bpr == 1 ? max(max(a.X - a.go - (y - 1) * a.ge, 0) - a.go, 0) : 0;
      }
      int t = lane == 0 ? first : 0;
#pragma unroll
      for (int s = 0; s < S; ++s) t = max(AFFINE ? max(av[s] - a.go, 0) : av[s], t - step);
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int o = __shfl_up_sync(FULL, t, 1 << i);
        if (lane >= (1 << i)) t = max(t, o - stepd[i]);
      }
      int h = __shfl_up_sync(FULL, t, 1);
      if (lane == 0) h = first;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int k = k0 + s;
        int v;
        if constexpr (!AFFINE) {
          h = max(av[s], h - step);
          v = h;
        } else {  // h is z_{k-1}: E's positive part at slot k
          v = max(av[s], h);
          h = max(max(av[s] - a.go, 0), h - step);
          PF[s] = k < W ? (v == 0 ? EF_DEAD : max(fv[s], EF_DEAD)) : EF_DEAD;
        }
        P[s] = k < W ? v : 0;
        if (k < W && v > lb_v) {  // this lane's best: strict >, rows then slots
          lb_v = v;
          lb_y = y;
          lb_j = bpr + k;
        }
        if (HIST && k < W) a.hist[(static_cast<size_t>(y - 1) * W + k) * sB + b] = v;
      }
    }
    if (VARLEN && HIST) {  // the frozen rows repeat the last one
      for (int r = rows; r < Kb; ++r) {
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (k0 + s < W)
            a.hist[(static_cast<size_t>(y0 + r) * W + k0 + s) * sB + b] = P[s];
      }
    }

    // block end: X-drop against the max over the lanes, dead test, first argmax
    int M = lb_v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = max(M, __shfl_xor_sync(FULL, M, o));
    const int cutoff = M - a.X;
    int am_v = 0, am_k = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int k = k0 + s;
      const int z = (k < W && P[s] >= cutoff) ? P[s] : 0;
      P[s] = z;
      if (AFFINE && z == 0) PF[s] = EF_DEAD;
      if (z > am_v) {
        am_v = z;
        am_k = k;
      }
      if (HIST && k < W) {
        a.hist[(static_cast<size_t>(last_y - 1) * W + k) * sB + b] = z;
        if (VARLEN && lens < last_y && lens > y0)
          a.hist[(static_cast<size_t>(lens - 1) * W + k) * sB + b] = z;
      }
    }
    int top = am_v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(FULL, top, o));
    const unsigned at_top = __ballot_sync(FULL, am_v == top);
    am_k = __shfl_sync(FULL, am_k, __ffs(at_top) - 1);  // the first lane: least slot
    const bool alive = top > 0;
    const int delta = alive ? min(max(am_k - W / 2, -a.D), a.D) : 0;
    // realign: slot k takes slot k + delta (dead outside the band); the
    // source register index is the same on every lane
    int nP[S], nPF[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int q = s + delta;
      const int off = ((q % S) + S) % S;
      const int src_lane = lane + (q - off) / S;
      int v = P[0], vf = PF[0];
#pragma unroll
      for (int j = 1; j < S; ++j) {
        v = j == off ? P[j] : v;
        vf = j == off ? PF[j] : vf;
      }
      v = __shfl_sync(FULL, v, src_lane & 31);
      vf = AFFINE ? __shfl_sync(FULL, vf, src_lane & 31) : EF_DEAD;
      const int src = k0 + s + delta;
      const bool inr = k0 + s < W && src >= 0 && src < W;
      nP[s] = inr ? v : 0;
      nPF[s] = inr ? vf : EF_DEAD;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      P[s] = nP[s];
      PF[s] = nPF[s];
    }
    const bool last = last_y >= lens;
    if (lane == 0) {
      a.bases[blk * sB + b] = base;
      a.deltas[blk * sB + b] = (last || !alive) ? 0 : delta;
    }
    base = alive ? base + Kb + delta : base;
    nrows = min(last_y, lens);
    if (!alive || last) {
      done = true;
      dlive = blk + 1;
    }
    __syncwarp();  // the next block restages win / qrow
  }

  // the endpoint: the lanes' bests, row-major first (value, row, column)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int v = __shfl_xor_sync(FULL, lb_v, o);
    const int y = __shfl_xor_sync(FULL, lb_y, o);
    const int j = __shfl_xor_sync(FULL, lb_j, o);
    if (v > lb_v || (v == lb_v && (y < lb_y || (y == lb_y && j < lb_j)))) {
      lb_v = v;
      lb_y = y;
      lb_j = j;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = k0 + s;
    if (k < W) {
      a.carried[k * sB + b] = P[s];
      if (AFFINE) a.carried[(W + k) * sB + b] = PF[s];
    }
  }
  // blocks after the pair is done: its frozen base and delta 0, here up to
  // where the host loop's poll would have seen it done (the last CTA writes
  // the rest, up to where it would have seen every pair done)
  const int hi = a.early ? min(NBf, (dlive + a.poll - 1) / a.poll * a.poll) : NBf;
  for (int blk = dlive + lane; blk < hi; blk += 32) {
    a.bases[blk * sB + b] = base;
    a.deltas[blk * sB + b] = 0;
  }
  if (lane == 0) {
    if (Kt && dlive <= NBf) {  // the tail block always runs
      a.bases[NBf * sB + b] = base;
      a.deltas[NBf * sB + b] = 0;
    }
    a.state[b] = base;
    a.state[sB + b] = lb_v;
    a.state[2 * sB + b] = lb_y;
    a.state[3 * sB + b] = lb_j;
    a.n_rows[b] = nrows;
    a.done[b] = done ? 1 : 0;
    a.scratch[2 + b] = dlive;
    atomicMax(&a.scratch[1], dlive);
  }
}

template <int S, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST>
__global__ void __launch_bounds__(FWD_THREADS) block_fwd_kernel(FwdArgs a) {
  __shared__ int32_t tab[MATRIX ? MAX_STRIDE * MAX_STRIDE : 1];
  __shared__ int32_t win[FWD_WARPS][WIN_MAX];
  __shared__ int32_t qrow[FWD_WARPS][WIN_MAX];
  __shared__ int last_cta;
  if (MATRIX) {
    for (int k = threadIdx.x; k < a.stride * a.stride; k += FWD_THREADS) tab[k] = a.table[k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * FWD_WARPS + warp;
  if (b < a.B)
    forward_pair<S, AFFINE, MATRIX, VARLEN, HIST>(a, tab, win[warp], qrow[warp], b, lane);
  // the last CTA to finish sees every pair's live blocks (threadfence
  // reduction: each thread fences its writes before the CTA's ticket)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_cta = atomicAdd(&a.scratch[0], 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last_cta || !a.early) return;
  __threadfence();
  const int NBf = a.n / a.K;
  const int most = __ldcg(&a.scratch[1]);
  const int stop = min(NBf, (most + a.poll - 1) / a.poll * a.poll);
  const long long total = static_cast<long long>(stop) * a.B;
  for (long long i = threadIdx.x; i < total; i += FWD_THREADS) {
    const int blk = static_cast<int>(i / a.B), p = static_cast<int>(i % a.B);
    const int dl = __ldcg(&a.scratch[2 + p]);
    if (blk >= min(NBf, (dl + a.poll - 1) / a.poll * a.poll)) {
      a.bases[i] = __ldcg(&a.state[p]);
      a.deltas[i] = 0;
    }
  }
}

template <int S, bool AFFINE, bool MATRIX, bool VARLEN, bool HIST>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t s) {
  const dim3 grid((a.B + FWD_WARPS - 1) / FWD_WARPS);
  block_fwd_kernel<S, AFFINE, MATRIX, VARLEN, HIST><<<grid, FWD_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <int S, bool AFFINE, bool MATRIX>
cudaError_t fwd_pick(const FwdArgs& a, cudaStream_t s) {
  if constexpr (AFFINE) {
    if (a.lens_q) return cudaErrorInvalidValue;  // Gotoh takes no lengths
    return a.hist ? launch_fwd<S, true, MATRIX, false, true>(a, s)
                  : launch_fwd<S, true, MATRIX, false, false>(a, s);
  } else {
    if (a.lens_q)
      return a.hist ? launch_fwd<S, false, MATRIX, true, true>(a, s)
                    : launch_fwd<S, false, MATRIX, true, false>(a, s);
    return a.hist ? launch_fwd<S, false, MATRIX, false, true>(a, s)
                  : launch_fwd<S, false, MATRIX, false, false>(a, s);
  }
}

template <int S>
cudaError_t fwd_mode(bool affine, const FwdArgs& a, cudaStream_t s) {
  if (affine) return a.table ? fwd_pick<S, true, true>(a, s) : fwd_pick<S, true, false>(a, s);
  return a.table ? fwd_pick<S, false, true>(a, s) : fwd_pick<S, false, false>(a, s);
}

__global__ void block_gather_kernel(const int16_t* __restrict__ t,
                                    const int32_t* __restrict__ bases,
                                    int16_t* __restrict__ win, int B, int m, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * C) return;
  const int b = static_cast<int>(i % B);
  const int c = static_cast<int>(i / B);
  const int64_t pos = static_cast<int64_t>(bases[b]) + c - 1;
  win[i] = (pos >= 0 && pos < m) ? t[static_cast<int64_t>(b) * m + pos] : int16_t(-1);
}

}  // namespace

extern "C" {

// B10 on `stream`: win[c, b] = t[b, bases[b] + c - 1], -1 outside [0, m).
// t [B, m] int16, bases [B] int32, win [C, B] int16, contiguous, one device.
// Returns cudaGetLastError().
int swtpu_block_gather(const void* t, const void* bases, void* win, int B, int m, int C,
                       void* stream) {
  if (B <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const int64_t total = static_cast<int64_t>(B) * C;
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((total + threads - 1) / threads));
  block_gather_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(t), static_cast<const int32_t*>(bases),
      static_cast<int16_t*>(win), B, m, C);
  return static_cast<int>(cudaGetLastError());
}

// B9 on `stream`: block `bidx` (rows y0 + 1 .. y0 + Kb) for every pair not
// done, in place on carried / state / done / n_rows / bases / deltas /
// hist (see Args). table null: uniform scoring; lens_q null: every pair
// has n rows; hist null: no history. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width that is not a multiple of 16 in
// 16..128, a table stride outside 1..32, or Gotoh with lengths.
int swtpu_block_rows(int affine, const void* qT, const void* win, const void* table,
                     const void* lens_q, void* carried, void* state, void* done,
                     void* n_rows, void* bases, void* deltas, void* hist, int B, int n,
                     int W, int bidx, int y0, int Kb, int X, int match, int mismatch,
                     int gap, int go, int ge, int D, int stride, void* stream) {
  if (W < 16 || W > 128 || W % 16 || Kb < 1 ||
      (table && (stride < 1 || stride > MAX_STRIDE)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const Args a{static_cast<const int16_t*>(qT), static_cast<const int16_t*>(win),
               static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens_q),
               static_cast<int32_t*>(carried), static_cast<int32_t*>(state),
               static_cast<int32_t*>(done), static_cast<int32_t*>(n_rows),
               static_cast<int32_t*>(bases), static_cast<int32_t*>(deltas),
               static_cast<int32_t*>(hist), B, n, W, bidx, y0, Kb, X, match, mismatch,
               gap, go, ge, D, table ? stride : 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (W) {
    case 16: err = pick_mode<16>(affine != 0, a, s); break;
    case 32: err = pick_mode<32>(affine != 0, a, s); break;
    case 48: err = pick_mode<48>(affine != 0, a, s); break;
    case 64: err = pick_mode<64>(affine != 0, a, s); break;
    default: err = pick_mode<0>(affine != 0, a, s); break;
  }
  return static_cast<int>(err);
}

// B9 as one launch on `stream`: every block of every pair, a warp per
// pair, in place on carried / state / done / n_rows / bases / deltas / hist
// (see FwdArgs); scratch [2 + B] int32 zeroed. early: the blocks after
// every pair is done get bases / deltas as the host loop that polls every
// `poll` blocks would have left them. Gap penalties must be >= 0. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a width that is not a
// multiple of 16 in 16..128, block + width > 129, a table stride outside
// 1..32, negative gaps, or Gotoh with lengths.
int swtpu_block_forward(int affine, const void* qT, const void* t16, const void* table,
                        const void* lens_q, void* carried, void* state, void* done,
                        void* n_rows, void* bases, void* deltas, void* hist,
                        void* scratch, int B, int n, int m, int W, int K, int X,
                        int match, int mismatch, int gap, int go, int ge, int D,
                        int stride, int early, int poll, void* stream) {
  if (W < 16 || W > 128 || W % 16 || K < 1 || K + W > WIN_MAX + 1 || poll < 1 ||
      (table && (stride < 1 || stride > MAX_STRIDE)) ||
      (affine ? (go < 0 || ge < 0) : gap < 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const FwdArgs a{static_cast<const int16_t*>(qT), static_cast<const int16_t*>(t16),
                  static_cast<const int32_t*>(table), static_cast<const int32_t*>(lens_q),
                  static_cast<int32_t*>(carried), static_cast<int32_t*>(state),
                  static_cast<int32_t*>(done), static_cast<int32_t*>(n_rows),
                  static_cast<int32_t*>(bases), static_cast<int32_t*>(deltas),
                  static_cast<int32_t*>(hist), static_cast<int32_t*>(scratch),
                  B, n, m, W, K, X, match, mismatch, gap, go, ge, D,
                  table ? stride : 1, early, poll};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((W + 31) / 32) {
    case 1: err = fwd_mode<1>(affine != 0, a, s); break;
    case 2: err = fwd_mode<2>(affine != 0, a, s); break;
    case 3: err = fwd_mode<3>(affine != 0, a, s); break;
    default: err = fwd_mode<4>(affine != 0, a, s); break;
  }
  return static_cast<int>(err);
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
