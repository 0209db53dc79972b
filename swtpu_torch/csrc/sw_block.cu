// Block-adaptive banded X-drop semi-global alignment for Hopper (sm_90a):
// the corridor window gather (B10) and one block of K rows with its
// block-end work (B9), linear or affine (Gotoh) gaps, uniform or
// general-matrix scoring, per-pair query lengths on linear gaps, optional
// H-only band history.
//
// Replaces the block tier's three TPU kernels:
//   block_gather   swtpu/kernels/pallas/banded_block.py  _gather_kernel        (pallas_call :872)
//   block_rows     swtpu/kernels/pallas/banded_block.py  _block_kernel         (pallas_call :827)
//                  and                                   _block_kernel_folded  (pallas_call :761)
// The folded kernel puts band segments on idle sublanes when a small
// batch fills fewer than 8 rows of 128 pairs; a thread per pair has no
// idle sublanes, so one kernel serves both contracts.
//
// Contract: oracle/banded_block.py (banded_xdrop_block, linear, and
// banded_xdrop_block_affine), batched as _banded_block_impl's loop runs it:
// the band is a corridor of W slots that slides +1 column a row (slot k of
// row y = b*K + r + 1 holds column base_b + r + k); values carry +X with 0
// dead; diag = prev[k], up = prev[k + 1], left the serial chain along the
// slots; dead neighbours never propagate (the oracle's dead tests, kept as
// written); a slot holding column 0 is pinned to the gap chain (affine: H
// relu, F raw); the endpoint is the row-major first maximum (strict > across
// rows and blocks, first slot within a row). At the block end: X-drop of the
// carried row against the updated max, the history's last row of the block
// overwritten by its X-dropped version, the dead test, the first argmax,
// delta = clip(argmax - W/2, -D, D), carried[k] = zeroed[k + delta] (dead
// outside: 0, and EF_DEAD for F) as an index offset, not the TPU's barrel
// shifter. Uniform scoring matches only q == t with t >= 0 (a pad, -1,
// scores -mismatch); the matrix reads the banded extended table, whose rows
// and columns past the alphabet hold matrix.min(): any code outside
// [0, stride) is a pad there.
//
// The loop's bookkeeping (_banded_block_impl:993-1023) is in the kernel too:
// a done pair writes its frozen base and delta 0 and nothing else (the
// history was zeroed by the wrapper); a live pair writes bases[b], its
// delta (0 if the block ends it: dead, or its last block), n_rows =
// min(b*K + Kb, len_q), the done flag, its carried row and state. Rows
// past a pair's length (VARLEN) freeze: they commit nothing and the history
// repeats the last row, as the TPU kernel's commit masks leave it; the
// pair's own final row gets the block-end X-drop too (the wrapper fixup of
// banded_block.py:1181-1191, done here).
//
// Design. B10 is one thread per (window position, pair) writing the
// slot-major [C, B] int16 window, C = Kb + W - 1 (the TPU twin layout), so
// B9's window reads coalesce across a warp. B9 starts from the fixed band's
// thread-per-pair skeleton (csrc/sw_banded.cu): a thread owns one pair for
// the whole block, rows outer, slots inner. Its band row is updated in
// place: slot k's diag is prev[k] and its up prev[k + 1], which the row has
// not overwritten yet, and left is the register chain. The band row (and
// F for Gotoh) lives in REGISTERS for W = 16, 32, 48 and 64 (a fully
// unrolled slot loop over a compile-time width) and in SHARED MEMORY above
// that (W = 80 .. 128, slot k of thread t at [k * 64 + t], no bank
// conflicts). The matrix table is in shared memory.
//
// Bound: int32 issue (132 SMs x 64 lanes x SM clock) over the band cells:
// the oracle's recurrence needs about 19 int32 ops a cell with uniform
// linear scoring (score 4, diag 3, up 3, left 3, max 3, pin 2, row max 1),
// 34 Gotoh, the matrix 3 fewer and one shared-memory lookup; the block end
// adds about 5 W per pair (chip_smoke.py::block_ops). Bytes (history 4 B a
// cell when written, the window 2 B a cell read once from L1) stay under it.
// With few long pairs (8-256) a pair's serial left chain binds instead: a
// thread does W cells a row one after another. Later work: all blocks in
// one launch, the gather fused into the load stage, several threads per
// pair for small batches.

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

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
