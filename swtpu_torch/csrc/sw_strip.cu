// One R x C tile of a single long pair's local-alignment DP matrix for
// Hopper (sm_90a), from its top boundary row, left boundary column and
// corner: the long-pair strip tile, linear or affine (Gotoh) gaps, any
// substitution matrix of up to 30 letters.
//
// Replaces swtpu/kernels/pallas/longpair_strip.py  _strip_kernel
// (pallas_call :263; entries strip_tile :485, strip_tile_affine :505).
// Its plain version is the column-scan tile of
// swtpu_torch/kernels/longpair_strip.py (_tile_colscan, _tile_colscan_affine),
// which the kernel equals bit for bit on every return: the bottom row H
// (and F), the right column H (and E), the tile best and its 1-based
// row-major-first endpoint ((0, 0) when the best is 0).
//
// Design. One CUDA block per tile, T = ceil(R / BR) <= 1024 threads;
// thread I owns the BR consecutive rows [I*BR, I*BR + BR) (BR = 1, 2, 4,
// 8, 16: the smallest that fits R in 1024 threads; phantom rows past R in
// the last thread are skipped and feed nothing). The threads run the TPU
// kernel's 1-column-skewed pipeline: at step s thread I computes column
// c = s - I of its rows, so its top input (the H of the row above at
// column c) is what thread I - 1 produced one step earlier. That value
// crosses through a double-buffered shared-memory slot, one
// __syncthreads a step; thread 0 reads the tile's top row instead,
// prefetched one step ahead, as each thread prefetches its target code.
// Each row's H (and E) lives in a register; the diagonal of row 0 is the
// top value the thread saw at the previous step (the left column and
// corner at c = 0). Scores come from the extended table in shared memory
// (kernels/sw_scan.py::_extended_table): every code >= the alphabet
// scores -2^20 under any matrix, in-length pads included, the rule of the
// plain tile (JAX's XLA tile). JAX's Pallas tile matches equal codes
// under a uniform matrix instead; the port follows its plain tile.
//
// The vertical chain follows the plain tile's closed forms exactly: the
// linear H[i] = max(pre[i], H[i-1] - gap) (the max-plus prefix unrolled),
// and the affine F as JAX's decoupled chain F[i] = max(F[i-1] - ge,
// pre[i-1] - go), where pre is the E-and-diagonal candidate, not H (the
// prefix over pre - go), with the F boundary folded in at the tile's
// first row as max(top_f, -2^20) - ge. It is Gotoh's F for gap_open >=
// gap_extend and the plain tile's for any gaps >= 0. So thread I - 1
// hands thread I its last row's H, and for affine also its pre and F.
//
// Endpoint: per thread a candidate key (H << log2 BR) | (BR - 1 - r) and
// its column, updated on a strictly greater key, so within a thread the
// row-major-first rule (value, then least row, then that row's earliest
// column) holds as the columns arrive in order; the block then reduces
// (value, least row). H stays below 2^27 on any real pair (16384 rows at
// BLOSUM62's largest score is 2^18).
//
// Bound: one block on one of the card's 132 SMs, C + T - 1 steps of BR
// cells a thread with a block-wide barrier between steps; as written a
// cell costs about 12 int32 ops linear and 16 affine plus one shared
// lookup (score 3: byte extract, offset, lookup; H 4 / 8; endpoint 4).
// The instruction rate of one SM (4 x 32 lanes a clock) binds, not the card's:
// a single tile leaves 131 SMs idle. Running tiles of an anti-diagonal of
// tiles on many SMs is later work (ROADMAP.md queue B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_STRIDE = 32;
constexpr int NEGB = -(1 << 20);

struct Cand {
  int v, row, col;
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
  constexpr int LB = BR >= 16 ? 4 : BR >= 8 ? 3 : BR >= 4 ? 2 : BR >= 2 ? 1 : 0;
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
  int key = -1, bcol = 0;
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
          const int k = (h << LB) | (BR - 1 - r);
          if (k > key) {
            key = k;
            bcol = c;
          }
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

  // the block's row-major-first best: (value, least row), then its column;
  // an idle lane's key -1 reads as value -1 and never wins
  Cand cand{key >> LB, row0 + (BR - 1 - (key & (BR - 1))), bcol};
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

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
