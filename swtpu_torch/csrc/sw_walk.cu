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
// Design (block_walk_kernel, xdrop_walk_kernel): two phases, a map of the
// moves made in parallel and a walk that follows it. The move taken at a
// cell depends on that cell alone (its own value, its three neighbours',
// its substitution score), and the walk's stretch of history is known in
// advance: the block walk visits every row from its endpoint down to 0
// (i falls by 0 or 1 a step), the per-round walk every round from
// max_round down (r = i + j falls by 1 or 2). One launch runs producer
// CTAs and B follower CTAs; each CTA takes its role from a ticket (an
// atomic counter the wrapper zeroes), producers first, so a follower, which
// waits on producers, starts only after every producer has started, in
// whatever order the card schedules the CTAs.
//  - Producers. P CTAs a pair (enough that every CTA has an SM of its own
//    when pairs are few, two when the pairs fill the card) take the pair's
//    chunks of C rows (rounds) in turn, top chunk first. cp.async stages a
//    chunk's history rows (with the one or two below it that its
//    neighbours lie in) and their row bases / pos_y in shared memory,
//    double-buffered, the next chunk's copies in flight while this one is
//    mapped. The block walk's producers may map a group of G pairs
//    together (G x P CTAs a group; G = 8 from 64 pairs, device_walk.py's
//    default_group): its [n, W, B] history puts a pair's slots B ints
//    apart, so G = 8 neighbouring pairs make each staged copy a whole
//    32-byte sector; the group's chunks are anchored at its largest end
//    row, and rows are staged a sub-chunk at a time. The block walk makes
//    each staged cell's value once (dead cells, rows past n_rows, the
//    final row's X-drop cutoff) and each row's base, column-0 chain value
//    and start slot once a pair. Each lane maps a batch of 8 cells with
//    their code loads issued together and no branches, so the batch's
//    chains interleave, and writes for each cell one 32-bit entry to the
//    map in global memory: the move (bits 0-1), flags (exit: the next cell
//    is on row 0 (block) or the origin (per-round); cross: it lies in a
//    later chunk; stall: no predecessor, or a cell the walk never reaches)
//    and from bit 8 the shared-memory address of the next cell's entry in
//    the follower's ring (dynamic shared memory starts at the same address
//    in every CTA). A chunk's flag is raised after a fence.
//  - Followers. A pair's follower CTA has a prefetch warp, which copies each
//    chunk into a ring of NBUF chunks in shared memory (cp.async.cg, after
//    the chunk's flag) once the follower has left the chunk that held the
//    slot, and a follower lane. A branch a step costs a lone thread more
//    than the load itself, so the follower chases 16 entries a word
//    without one (every
//    entry names a valid address, so it reads on past a flagged one), then
//    commits the moves before the first flagged entry as one 2-bit word
//    (their kinds counted by popcount for the cursor) and handles that
//    entry apart: a stall ends the walk, an exit goes to the closed-form
//    row 0 (block: a gap chain of left moves), a cross waits for the next
//    chunk in the ring.
// The block walk's out-of-band column 0 has a map slot of its own (slot W
// of each row); at its start cell the producers take the walk's start
// value (score + X), which is that cell's own value (checked on the CPU
// mirror). A start the map cannot hold (not on a stored in-band cell nor
// column 0) is written in closed form: the all-dead pair's origin, the
// only such start forwards produce, as an empty path; any other as a
// stall (ok = 0), as the CPU mirrors refuse it.
//
// Bound: the follower's chain, one shared-memory load and a shift a step,
// against the 46 int32 operations and 24 bytes a step
// the walk needs (chip_smoke.py's WALK_OPS), which the card could do for
// all steps at once; the steps of a pair are a chain and cannot. Behind it,
// the producers' work: every band cell of every row on the path, W slots
// a row where the walk needs about one. With many pairs (128 16K-mers)
// that map is what binds.
//
// The earlier kernels (block_walk_serial_kernel, xdrop_walk_serial_kernel:
// one thread a pair, a serial chain of dependent device-memory loads a
// step) stay for timing beside these; no entry point launches them, nor do
// the map kernels.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;        // the serial kernels: a thread a pair
constexpr int MAP_THREADS = 256;   // a CTA of a map kernel (a follower CTA uses 64)
constexpr int NBUF = 4;            // chunks in a follower's ring
constexpr int MINF = -(1 << 30);
// map entry: the move in bits 0-1, flags, and from bit 8 the shared-memory
// address of the next entry in the follower's ring
constexpr uint32_t E_EXIT = 4, E_CROSS = 8, E_STALL = 16;
constexpr int BATCH = 8;  // cells a producer lane maps with its code loads in flight
constexpr int MAXG = 8;   // pairs a block-walk producer CTA maps in a group (or 1)

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
  // `nbits2` bits of moves at once (at most 32)
  __device__ __forceinline__ void push_bits(uint32_t bits, int nbits2) {
    uint64_t w = word | (static_cast<uint64_t>(bits) << nbits);
    nbits += nbits2;
    if (nbits >= 32) {
      out[nwords++] = static_cast<uint32_t>(w);
      w >>= 32;
      nbits -= 32;
    }
    word = static_cast<uint32_t>(w);
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

// -- the two phases' plumbing ------------------------------------------------

// a 4-byte cp.async into shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}
// a 16-byte cp.async through L2 only (the map other CTAs wrote)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ int ld_vol(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}
__device__ __forceinline__ void st_vol(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// The follower CTA's handshake between its prefetch warp and its follower.
struct Flags {
  int ready;   // chunks in the ring
  int fchunk;  // the chunk the follower reads
  int done;    // the follower has finished
};

// A producer CTA, after writing chunk c's entries to the map: every
// thread's stores are made visible, then the chunk's flag is raised.
__device__ __forceinline__ void publish(int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_vol(flag, 1);
}

// The follower CTA's prefetch warp: chunk by chunk from c0 (the follower's
// first), wait for the flag of chunk c, then copy its Sp entries into ring
// buffer c % NBUF once the follower has left the chunk that held it. One
// lane polls, asleep between polls.
__device__ void prefetch(uint32_t* ring, const uint32_t* map, const int* flags, Flags& f,
                         int c0, int nchunks, int Sp, int lane) {
  for (int c = c0; c < nchunks; ++c) {
    int stop = 0;
    if (lane == 0) {
      if (c - c0 >= NBUF)
        while (ld_vol(&f.fchunk) < c - NBUF + 1 && !ld_vol(&f.done)) __nanosleep(64);
      while (!ld_vol(flags + c) && !ld_vol(&f.done)) __nanosleep(128);
      stop = ld_vol(&f.done);
    }
    if (__shfl_sync(0xFFFFFFFFu, stop, 0)) return;
    __threadfence();
    const uint32_t* src = map + static_cast<size_t>(c) * Sp;
    uint32_t* dst = ring + (c % NBUF) * Sp;
    for (int e = 4 * lane; e < Sp; e += 128) cp_async16(dst + e, src + e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      st_vol(&f.ready, c + 1);
    }
  }
}

// The follower, entering chunk ch.
__device__ __forceinline__ void enter_chunk(Flags& f, int ch) {
  st_vol(&f.fchunk, ch);
  while (ld_vol(&f.ready) <= ch) __nanosleep(32);
  __threadfence_block();
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Follow the map from the entry at shared address `a`: push each move
// until a stall, an exit or the step cap; on a cross, wait for the chunk
// `chunk_of(i, j)` names. A branch a step would cost the lone thread more
// than the load, so the follower chases 16 entries a word without one,
// reading on past a flagged entry (every entry names a valid address),
// then commits the moves before the first flagged one and handles that
// one apart. Returns false on a stall.
template <typename ChunkOf>
__device__ __forceinline__ bool follow(uint32_t a, Flags& f, Packer& pk, int& i, int& j,
                                       int& nsteps, int steps, ChunkOf chunk_of) {
  for (;;) {
    uint32_t bits = 0, sa = 0;
    int first = 16;
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint32_t e = lds(a);
      const bool hit = first == 16 && (e & (E_EXIT | E_CROSS | E_STALL)) != 0;
      sa = hit ? a : sa;
      first = hit ? u : first;
      bits |= (e & 3u) << (2 * u);
      a = e >> 8;
    }
    const int k = min(first, steps - nsteps);  // the moves to commit
    if (k > 0) {
      const uint32_t mv = k == 16 ? bits : bits & ((1u << (2 * k)) - 1u);
      pk.push_bits(mv, 2 * k);
      nsteps += k;
      const uint32_t lo = mv & 0x55555555u, hi = (mv >> 1) & 0x55555555u;
      const int diag = k - __popc(lo | hi);
      i -= diag + __popc(lo & ~hi);
      j -= diag + __popc(hi & ~lo);
    }
    if (nsteps >= steps) return true;
    if (first == 16) continue;
    const uint32_t e = lds(sa);
    if (e & E_STALL) return false;
    const int mv = static_cast<int>(e & 3u);
    pk.push_bits(mv, 2);
    ++nsteps;
    i -= (mv != 2);
    j -= (mv != 1);
    if (e & E_EXIT) return true;
    enter_chunk(f, chunk_of(i, j));
    a = e >> 8;
  }
}

// A follower CTA's set-up: the flags, then its warps' roles (warp 0: the
// follower, warp 1: the prefetch, from chunk c0); returns the ring, or
// null for a thread that has nothing more to do.
__device__ __forceinline__ uint32_t* follower_setup(int32_t* smem, Flags& f, const uint32_t* map,
                                                    const int* flags, int c0, int nchunks,
                                                    int Sp) {
  const int tid = threadIdx.x;
  if (tid >= 64) return nullptr;
  if (tid == 0) {
    f.ready = c0;
    f.fchunk = c0;
    f.done = 0;
  }
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  // entries naming the ring's start: the follower's reads past a flagged
  // entry stay in the ring before the chunks arrive
  const uint32_t fill = static_cast<uint32_t>(__cvta_generic_to_shared(ring)) << 8;
  for (int e = tid; e < NBUF * Sp; e += 64) ring[e] = fill;
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
  if (tid >= 32) {
    prefetch(ring, map, flags, f, c0, nchunks, Sp, tid - 32);
    return nullptr;
  }
  return ring;
}

// A CTA's role: a ticket from a zeroed counter, so that the producers hold
// the first tickets and a follower (which waits on producers) starts only
// after every producer has started, whatever order the CTAs are scheduled in.
__device__ __forceinline__ int take_ticket(int* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1);
  __syncthreads();
  return ticket;
}

// Producer CTAs a pair: with a follower each, enough to give every CTA an
// SM of its own, and two when the pairs alone fill the card (more warps to
// hide the stage's latency). A block walk's group of G pairs takes G times
// as many.
inline int producers_per_pair(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(2, std::min(32, sms / B - 1));
}

// -- the block walk ----------------------------------------------------------

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
  uint32_t* map;         // [B, max_chunks, Sp] the map kernel's scratch
  int* flags;            // [B * max_chunks + 1] zeros: a chunk's map is written; a ticket
  int B, n, m, W, K, X, match, mismatch, gap, stride, steps, row_bytes, chunk, max_chunks;
  int group;             // pairs a producer CTA maps together (1 or MAXG)
  int nprod;             // producer CTAs a group
};

__device__ __forceinline__ int row_base(const BlockWalk& a, int b, int y) {
  return a.bases[static_cast<size_t>((y - 1) / a.K) * a.B + b] + (y - 1) % a.K;
}

// walk_block_history.get(y, j) for pair b, with the final row's cutoff
__device__ __forceinline__ int block_val(const BlockWalk& a, int b, int y, int j, int nr,
                                         int score) {
  if (y == 0) {
    const int c = a.X - j * a.gap;
    return (j >= 0 && (c > 0 || j == 0)) ? c : MINF;
  }
  if (y >= 1 && y <= nr) {
    const int k = j - row_base(a, b, y);
    if (k >= 0 && k < a.W) {
      int raw = a.hist[(static_cast<size_t>(y - 1) * a.W + k) * a.B + b];
      if (y == nr && raw < score) raw = 0;  // the block-end X-drop of the final row
      return raw != 0 ? raw : MINF;
    }
    const int c = a.X - y * a.gap;
    return (j == 0 && c > 0) ? c : MINF;  // out-of-band column 0: the chain
  }
  return MINF;
}

// One pair's walk on one thread, a serial chain of dependent loads a step.
__device__ void block_walk_serial(const BlockWalk& a, int b) {
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

__global__ void __launch_bounds__(THREADS) block_walk_serial_kernel(BlockWalk a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b < a.B) block_walk_serial(a, b);
}

// A chunk's entries, padded to 16 bytes (block walk: C rows of W + 1 slots).
__host__ __device__ inline int block_Sp(int W, int C) { return (C * (W + 1) + 3) & ~3; }
// Rows a producer stages at a time for a group of G pairs: the chunk for
// one pair; for more, as many as keep the stage within the follower's ring
__host__ __device__ inline int block_sub(int W, int C, int G) {
  if (G == 1) return C;
  const int rows = NBUF * block_Sp(W, C) / (2 * G * (W + 5)) - 1;
  return rows < 1 ? 1 : (rows < C ? rows : C);
}
// Shared memory of block_walk_kernel: a producer CTA's stage ([2][SC + 1][G]
// history rows of W + 1 ints, four ints a staged row of a pair) or a
// follower CTA's ring ([NBUF][Sp]).
__host__ __device__ inline size_t block_smem(int W, int C, int G) {
  const size_t stage = 2 * static_cast<size_t>(block_sub(W, C, G) + 1) * G * (W + 5);
  const size_t ring = static_cast<size_t>(NBUF) * block_Sp(W, C);
  return sizeof(int32_t) * (stage > ring ? stage : ring);
}

// The map's top row for the group of pairs gi: chunk c holds rows
// top - (c+1)C + 1 .. top - cC of each of its pairs (their largest end row,
// so that one staged row serves the whole group).
__device__ __forceinline__ int group_top(const BlockWalk& a, int gi) {
  int top = 0;
  for (int b = gi * a.group; b < min(a.B, (gi + 1) * a.group); ++b)
    top = max(top, min(max(a.end_y[b], 0), a.n));
  return top;
}

// The follower CTA of pair b.
__device__ void block_follower(const BlockWalk& a, int b, int32_t* smem, Flags& f) {
  const int tid = threadIdx.x, W = a.W, W1 = W + 1, C = a.chunk, X = a.X, g = a.gap;
  const int score = a.score[b], ey = a.end_y[b], ej = a.end_j[b], nr = a.n_rows[b];
  uint8_t* row = a.wire + static_cast<size_t>(b) * a.row_bytes;
  // the map holds a start on a stored row, in band or on column 0; forwards
  // give no other start but the all-dead pair's origin, an empty path
  const int rb_top = (ey >= 1 && ey <= nr) ? row_base(a, b, ey) : 0;
  const int k0 = ej - rb_top;
  if (!(ey >= 1 && ey <= nr && ((k0 >= 0 && k0 < W) || ej == 0))) {
    if (tid == 0) {
      write_meta(row, score, ey, ej, 0, ey == 0 && ej == 0);
      Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
      pk.finish(a.steps / 16);
    }
    return;
  }
  const int Sp = block_Sp(W, C), top = group_top(a, b / a.group);
  const int nchunks = (top + C - 1) / C, c0 = (top - ey) / C;
  const uint32_t* map = a.map + static_cast<size_t>(b) * a.max_chunks * Sp;
  const int* flags = a.flags + static_cast<size_t>(b) * a.max_chunks;
  const uint32_t* ring = follower_setup(smem, f, map, flags, c0, nchunks, Sp);
  if (!ring || tid != 0) return;
  Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
  int i = ey, j = ej, nsteps = 0;
  enter_chunk(f, c0);
  const int y_lo = top - (c0 + 1) * C + 1;  // chunk c0's lowest row
  const uint32_t g0 = (c0 % NBUF) * Sp + (ey - y_lo) * W1 + ((k0 >= 0 && k0 < W) ? k0 : W);
  bool ok = follow(static_cast<uint32_t>(__cvta_generic_to_shared(ring + g0)), f, pk, i, j,
                   nsteps, a.steps, [&](int y, int) { return (top - y) / C; });
  if (ok && i == 0) {  // row 0: the gap chain, left to the origin
    int v = X - j * g;
    while (j > 0 && nsteps < a.steps) {
      const int c = X - (j - 1) * g;
      const int left_v = (c > 0 || j == 1) ? c : MINF;
      if (!(left_v > MINF && left_v - g == v)) {
        ok = false;
        break;
      }
      pk.push(2);
      ++nsteps;
      --j;
      v = left_v;
    }
  }
  ok = ok && i == 0 && j == 0;
  write_meta(row, score, ey, ej, nsteps, ok);
  pk.finish(a.steps / 16);
  st_vol(&f.done, 1);
}

// A producer CTA of the group of pairs gi: chunks p, p + P, p + 2P, ... of
// each of its G pairs, SC rows staged at a time. With G > 1 the G pairs of a
// staged cell lie side by side in the [n, W, B] history, so a copy reads
// whole sectors. Each staged cell's value (block_val) is made once, and
// each row's base, column-0 chain value and start slot once a pair; a
// cell's entry then reads its own and its neighbours' values.
template <int G>
__device__ void block_producer(const BlockWalk& a, int gi, int p, int32_t* smem,
                               int32_t* stab) {
  static_assert(G == 1 || G == 8, "a pair or a group of 8 (lgG below)");
  constexpr int lgG = G == 1 ? 0 : 3;
  const int tid = threadIdx.x, P = a.nprod;
  const int W = a.W, W1 = W + 1, C = a.chunk, K = a.K, X = a.X, g = a.gap;
  const size_t sB = static_cast<size_t>(a.B);
  const int b0 = gi * G, Sp = block_Sp(W, C), SC = block_sub(W, C, G);
  __shared__ int par[4][MAXG];  // score, end_y, end_j, n_rows of the group's pairs
  if (tid < G) {
    const int b = b0 + tid, live = b < a.B;
    par[0][tid] = live ? a.score[b] : 0;
    par[1][tid] = live ? a.end_y[b] : 0;
    par[2][tid] = live ? a.end_j[b] : 0;
    par[3][tid] = live ? a.n_rows[b] : 0;  // a pair past B: every row dead
  }
  if (a.table)
    for (int e = tid; e < a.stride * a.stride; e += MAP_THREADS) stab[e] = a.table[e];
  __syncthreads();
  const int32_t* tab = a.table ? stab : nullptr;
  const int top = group_top(a, gi), nchunks = (top + C - 1) / C;
  const int nsub = (C + SC - 1) / SC;
  const int units = p < nchunks ? (nchunks - p + P - 1) / P * nsub : 0;
  // the ring's shared-memory address in the follower CTA: dynamic shared
  // memory starts at the same address in every CTA of the launch
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t stall = 3u | E_STALL | base << 8;
  const int srows = (SC + 1) * G;  // staged (row, pair)s of a buffer
  int32_t* stage = smem;           // [2][SC + 1][G][W + 1] history, then values
  // [2][4][SC + 1][G]: a (row, pair)'s base, column-0 value, start slot and
  // start value
  int32_t* info = stage + 2 * srows * W1;
  // unit u: sub-chunk u % nsub of chunk p + (u / nsub) P, its rows
  // y_hi - rows + 1 .. y_hi
  auto unit = [&](int u, int& c, int& y_hi, int& rows) {
    c = p + (u / nsub) * P;
    const int s = u % nsub;
    y_hi = top - c * C - s * SC;
    rows = min(SC, C - s * SC);
  };
  // the staged cells a thread handles: those of one pair (G divides
  // MAP_THREADS), (row, slot) stepping through the rows
  const int gg = tid & (G - 1), cstep = MAP_THREADS >> lgG;
  const int cdr = cstep / W, cdk = cstep % W;
  // stage unit u's rows, and the row below them, into buffer buf
  auto stage_unit = [&](int u, int buf) {
    int c, y_hi, rows;
    unit(u, c, y_hi, rows);
    const int y0 = y_hi - rows, b = b0 + gg, nrg = par[3][gg];
    int32_t* st = stage + buf * srows * W1;
    int r = (tid >> lgG) / W, k = (tid >> lgG) % W;
    for (int e = tid; e < (rows + 1) * W * G; e += MAP_THREADS) {
      const int y = y0 + r;
      const bool ok = y >= 1 && y <= nrg;  // rows past n_rows read as dead
      cp_async4(st + (r * G + gg) * W1 + k,
                ok ? a.hist + (static_cast<size_t>(y - 1) * W + k) * sB + b : a.hist, ok);
      r += cdr;
      k += cdk;
      if (k >= W) {
        k -= W;
        ++r;
      }
    }
    for (int e = tid; e < (rows + 1) * G; e += MAP_THREADS) {
      const int y = y0 + (e >> lgG), h = e & (G - 1);
      const bool ok = y >= 1 && y <= par[3][h];
      cp_async4(info + buf * 4 * srows + e,
                ok ? a.bases + static_cast<size_t>((y - 1) / K) * sB + b0 + h : a.bases, ok);
    }
    cp_async_commit();
  };

  if (units) stage_unit(0, 0);
  for (int u = 0; u < units; ++u) {
    const int buf = u & 1;
    if (u + 1 < units) {
      stage_unit(u + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u's rows are staged, every thread's copies
    int c, y_hi, rows;
    unit(u, c, y_hi, rows);
    const int y0 = y_hi - rows, y_lo = top - (c + 1) * C + 1;  // y_lo: the chunk's
    int32_t* st = stage + buf * srows * W1;
    int32_t* rbs = info + buf * 4 * srows;
    int32_t* col0 = rbs + srows;
    int32_t* sslot = col0 + srows;
    int32_t* sval = sslot + srows;
    // a (row, pair)'s base, column 0's chain value out of band, and the
    // slot of the pair's start if it lies on this row (W: column 0 out of
    // band), where the walk takes its start value score + X
    for (int e = tid; e < (rows + 1) * G; e += MAP_THREADS) {
      const int y = y0 + (e >> lgG), h = e & (G - 1);
      const bool live = y >= 1 && y <= par[3][h];
      const int rb = live ? rbs[e] + (y - 1) % K : 0, cy = X - y * g;
      const int ks = par[2][h] - rb;
      rbs[e] = rb;
      col0[e] = live && cy > 0 ? cy : MINF;
      sslot[e] = live && y == par[1][h] ? ((ks >= 0 && ks < W) ? ks : (par[2][h] == 0 ? W : -1))
                                        : -1;
      sval[e] = par[0][h] + X;
    }
    // every staged cell's value: dead cells (0) and rows past n_rows read
    // as -2^30, the final row's X-drop cutoff (the pair's score)
    {
      const int nrg = par[3][gg], scg = par[0][gg];
      int r = (tid >> lgG) / W, k = (tid >> lgG) % W;
      for (int e = tid; e < (rows + 1) * W * G; e += MAP_THREADS) {
        const int y = y0 + r;
        int32_t* cell = st + (r * G + gg) * W1 + k;
        const int raw = *cell;
        *cell = (y >= 1 && y <= nrg && raw != 0 && !(y == nrg && raw < scg)) ? raw : MINF;
        r += cdr;
        k += cdk;
        if (k >= W) {
          k -= W;
          ++r;
        }
      }
    }
    __syncthreads();
    // the entry of pair h's row y, slot k (slot W: column 0 out of band),
    // with the cell's query and target codes; 3 where the walk stalls or
    // never comes. Without branches: the cells of a batch then interleave.
    auto entry = [&](int h, int y, int k, int yc, int xc) -> uint32_t {
      const int i0 = (y - y0) * G + h, i1 = i0 - G;  // this row's and the one below
      const int rb = rbs[i0], rb1 = rbs[i1];
      const int32_t* vr = st + i0 * W1;
      const int32_t* vr1 = st + i1 * W1;
      const int j = k < W ? rb + k : 0;
      const bool cell = y >= 1 && (k < W || !(rb <= 0 && rb + W > 0));
      const int c0 = col0[i0], c01 = col0[i1];
      const int v = k == sslot[i0] ? sval[i0] : (k < W ? vr[k] : c0);
      // left (y, j - 1); up (y - 1, j) and diag (y - 1, j - 1), on row 0
      // its gap chain
      const int left_v = (k >= 1 && k < W) ? vr[max(k - 1, 0)] : (j == 1 ? c0 : MINF);
      const int ku = j - rb1, kd = ku - 1;
      const int r0u = X - j * g, r0d = r0u + g;
      const int up_st = (ku >= 0 && ku < W) ? vr1[min(max(ku, 0), W - 1)] : (j == 0 ? c01 : MINF);
      const int dg_st = (kd >= 0 && kd < W) ? vr1[min(max(kd, 0), W - 1)] : (j == 1 ? c01 : MINF);
      const int up_v = y == 1 ? ((j >= 0 && (r0u > 0 || j == 0)) ? r0u : MINF) : up_st;
      const int diag_v = y == 1 ? ((j >= 1 && (r0d > 0 || j == 1)) ? r0d : MINF) : dg_st;
      const int sc = j > 0 ? sub_score(yc, xc, tab, a.stride, a.match, a.mismatch) : 0;
      const bool can_d = j > 0 && diag_v > MINF && diag_v + sc == v;
      const bool can_u = up_v > MINF && up_v - g == v;
      const bool can_l = j > 0 && left_v > MINF && left_v - g == v;
      const int mv = can_d ? 0 : (can_u ? 1 : 2);
      const int ny = y - (mv != 2), nj = j - (mv != 1);
      // the next cell's slot (in band, else column 0's slot W) and chunk
      const int nk0 = nj - (ny == y ? rb : rb1);
      const int nk = (nk0 >= 0 && nk0 < W) ? nk0 : W;
      const bool cross = ny < y_lo;
      const uint32_t idx =
          ((c + cross) % NBUF) * Sp + (ny - y_lo + (cross ? C : 0)) * W1 + nk;
      const uint32_t ent = ny == 0 ? (mv | E_EXIT | base << 8)
                                   : (mv | (cross ? E_CROSS : 0u) | (base + 4 * idx) << 8);
      return (cell && v > MINF && (can_d || can_u || can_l)) ? ent : stall;
    };
    // cell e of the unit: slot e % W1 of (row, pair) q = e / W1, pair
    // q % G, row y0 + 1 + q / G
    const int S = rows * W1 * G, dq = MAP_THREADS / W1, dk = MAP_THREADS % W1;
    int q = tid / W1, k = tid % W1;
    for (int e0 = tid; e0 < S; e0 += BATCH * MAP_THREADS) {
      // a batch of cells: their code loads first, all in flight together
      int qs[BATCH], ks[BATCH], yc[BATCH], xc[BATCH];
#pragma unroll
      for (int u2 = 0; u2 < BATCH; ++u2) {
        qs[u2] = q;
        ks[u2] = k;
        const int h = q & (G - 1), y = y0 + 1 + (q >> lgG), b = b0 + h;
        const bool live = e0 + u2 * MAP_THREADS < S && y >= 1 && b < a.B;
        const int j = live && k < W ? rbs[(y - y0) * G + h] + k : 0;
        yc[u2] = j > 0 ? a.qT[static_cast<size_t>(y - 1) * sB + b] : -1;
        xc[u2] = j > 0 && j <= a.m ? a.t[static_cast<size_t>(b) * a.m + j - 1] : -1;
        q += dq;
        k += dk;
        if (k >= W1) {
          k -= W1;
          ++q;
        }
      }
#pragma unroll
      for (int u2 = 0; u2 < BATCH; ++u2) {
        const int h = qs[u2] & (G - 1), y = y0 + 1 + (qs[u2] >> lgG);
        if (e0 + u2 * MAP_THREADS < S && b0 + h < a.B)
          a.map[(static_cast<size_t>(b0 + h) * a.max_chunks + c) * Sp + (y - y_lo) * W1 +
                ks[u2]] = entry(h, y, ks[u2], yc[u2], xc[u2]);
      }
    }
    if (u % nsub == nsub - 1 || u + 1 == units) {
      // chunk c is mapped for every pair of the group: raise its flags (this
      // barrier also frees buffer buf for unit u + 2's copies)
      __threadfence();
      __syncthreads();
      if (tid < G && b0 + tid < a.B)
        st_vol(a.flags + static_cast<size_t>(b0 + tid) * a.max_chunks + c, 1);
    } else {
      __syncthreads();  // buffer buf is free for unit u + 2's copies
    }
  }
}

__global__ void __launch_bounds__(MAP_THREADS) block_walk_kernel(BlockWalk a) {
  extern __shared__ int32_t smem[];
  __shared__ Flags f;
  __shared__ int32_t stab[32 * 32];  // the substitution table, if any
  const int role = take_ticket(a.flags + static_cast<size_t>(a.B) * a.max_chunks);
  const int P = a.nprod, groups = (a.B + a.group - 1) / a.group;
  if (role >= groups * P) {
    block_follower(a, role - groups * P, smem, f);
    return;
  }
  const int gi = role / P, p = role % P;
  if (a.group == 1)
    block_producer<1>(a, gi, p, smem, stab);
  else
    block_producer<MAXG>(a, gi, p, smem, stab);
}

// -- the per-round walk ------------------------------------------------------

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
  uint32_t* map;
  int* flags;              // [B * max_chunks + 1] zeros: chunks' flags, then a ticket
  int B, QL, TL, R, W, X, match, mismatch, gap, stride, steps, row_bytes, chunk, max_chunks;
  int nprod;
};

__device__ void xdrop_walk_serial(const XdropWalk& a, int b) {
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

__global__ void __launch_bounds__(THREADS) xdrop_walk_serial_kernel(XdropWalk a) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b < a.B) xdrop_walk_serial(a, b);
}

// A chunk's entries, padded to 16 bytes (per-round walk: C rounds of W).
__host__ __device__ inline int xdrop_Sp(int W, int C) { return (C * W + 3) & ~3; }
// Shared memory of xdrop_walk_kernel: a producer CTA's stage ([2][C + 2][W]
// history rounds, [2][C + 2] pos_y) or a follower CTA's ring ([NBUF][Sp]).
__host__ __device__ inline size_t xdrop_smem(int W, int C) {
  const size_t stage = 2 * static_cast<size_t>(C + 2) * (W + 1);
  const size_t ring = static_cast<size_t>(NBUF) * xdrop_Sp(W, C);
  return sizeof(int32_t) * (stage > ring ? stage : ring);
}

__global__ void __launch_bounds__(MAP_THREADS) xdrop_walk_kernel(XdropWalk a) {
  extern __shared__ int32_t smem[];
  __shared__ Flags f;
  __shared__ int32_t stab[32 * 32];  // the substitution table, if any
  const int tid = threadIdx.x, P = a.nprod;
  const int role = take_ticket(a.flags + static_cast<size_t>(a.B) * a.max_chunks);
  const bool follower = role >= a.B * P;
  const int b = follower ? role - a.B * P : role / P;
  const int W = a.W, C = a.chunk, X = a.X;
  const size_t sB = static_cast<size_t>(a.B);
  const int n = a.lens_q[b], m = a.lens_t[b], nrounds = a.n_rounds[b];
  const int score = a.score[b], target = score + X, r0 = a.max_round[b];
  if (!(r0 >= 0 && r0 < nrounds && r0 < a.R)) {
    // a start the map cannot hold (forwards give none): the walk stalls
    if (follower && tid == 0) {
      uint8_t* row = a.wire + static_cast<size_t>(b) * a.row_bytes;
      write_meta(row, score, 0, 0, 0, false);
      Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
      pk.finish(a.steps / 16);
    }
    return;
  }
  const int S = C * W, Sp = xdrop_Sp(W, C);
  const int nchunks = (r0 + C - 1) / C;  // chunk c: rounds r0 - (c+1)C + 1 .. r0 - cC
  uint32_t* map = a.map + static_cast<size_t>(b) * a.max_chunks * Sp;
  int* flags = a.flags + static_cast<size_t>(b) * a.max_chunks;

  if (follower) {  // warp 0 finds the start, its lane 0 follows
    const uint32_t* ring = follower_setup(smem, f, map, flags, 0, nchunks, Sp);
    if (!ring) return;
    const int lane = tid;
    const int py0 = a.posy[static_cast<size_t>(r0) * sB + b];
    int kbest = -1;
    for (int k = lane; k < W; k += 32) {
      const int yk = py0 + (W - 1 - k), xk = r0 - yk;
      const int vk = a.hist[(static_cast<size_t>(r0) * sB + b) * W + k];
      if (vk == target && vk != 0 && yk >= 0 && yk <= n && xk >= 0 && xk <= m) kbest = k;
    }
    const int kstar = __reduce_max_sync(0xFFFFFFFFu, kbest);
    if (lane != 0) return;
    uint8_t* row = a.wire + static_cast<size_t>(b) * a.row_bytes;
    Packer pk{reinterpret_cast<uint32_t*>(row + 20)};
    const int sy = py0 + (W - 1 - max(kstar, 0)), sx = r0 - sy;
    int i = sy, j = sx, nsteps = 0;
    bool ok = kstar >= 0;
    if (ok && !(i == 0 && j == 0)) {
      enter_chunk(f, 0);
      ok = follow(static_cast<uint32_t>(__cvta_generic_to_shared(ring + (C - 1) * W + kstar)),
                  f, pk, i, j, nsteps, a.steps, [&](int y, int x) { return (r0 - (y + x)) / C; });
    }
    ok = ok && i == 0 && j == 0;
    write_meta(row, score, sy, sx, nsteps, ok);
    pk.finish(a.steps / 16);
    st_vol(&f.done, 1);
    return;
  }

  // a producer CTA: chunks p, p + P, p + 2P, ... of pair b
  const int p = role - b * P;
  if (a.table)
    for (int e = tid; e < a.stride * a.stride; e += MAP_THREADS) stab[e] = a.table[e];
  __syncthreads();
  const int32_t* tab = a.table ? stab : nullptr;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t stall = 3u | E_STALL | base << 8;
  int32_t* stage = smem;                   // [2][C + 2][W]
  int32_t* spy = stage + 2 * (C + 2) * W;  // [2][C + 2]
  // stage chunk c's rounds r0 - (c+1)C - 1 .. r0 - cC (the two below the
  // chunk too) into buffer buf
  auto stage_chunk = [&](int c, int buf) {
    const int rb0 = r0 - (c + 1) * C - 1;
    int32_t* st = stage + buf * (C + 2) * W;
    int s = tid / W, k = tid % W;
    const int ds = MAP_THREADS / W, dk = MAP_THREADS % W;
    for (int e = tid; e < (C + 2) * W; e += MAP_THREADS) {
      const int r = rb0 + s;
      const bool ok = r >= 0 && r < nrounds;  // other rounds read as dead
      cp_async4(st + e, ok ? a.hist + (static_cast<size_t>(r) * sB + b) * W + k : a.hist, ok);
      s += ds;
      k += dk;
      if (k >= W) {
        k -= W;
        ++s;
      }
    }
    for (int ss = tid; ss < C + 2; ss += MAP_THREADS) {
      const int r = rb0 + ss;
      const bool ok = r >= 0 && r < nrounds;
      cp_async4(spy + buf * (C + 2) + ss, ok ? a.posy + static_cast<size_t>(r) * sB + b : a.posy,
                ok);
    }
    cp_async_commit();
  };

  if (p < nchunks) stage_chunk(p, 0);
  for (int c = p, t = 0; c < nchunks; c += P, ++t) {
    const int buf = t & 1;
    if (c + P < nchunks) {
      stage_chunk(c + P, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c's rounds are staged
    const int r_hi = r0 - c * C, r_lo = r_hi - C + 1;
    const int32_t* st = stage + buf * (C + 2) * W;
    const int32_t* pys = spy + buf * (C + 2);
    // banded_traceback.get(y, x) of staged round r (index s = r - r_lo + 2),
    // slot k, without branches
    auto val = [&](int s, int r, int y, int x, int k) -> int {
      const bool valid = y >= 0 && y <= n && x >= 0 && x <= m && r >= 0 && r < nrounds &&
                         k >= 0 && k < W;
      const int raw = st[s * W + min(max(k, 0), W - 1)];
      return (valid && raw != 0) ? raw : MINF;
    };
    // the entry of in-chunk round q, slot k, with the cell's codes
    auto entry = [&](int q, int k, int yc, int xc) -> uint32_t {
      const int r = r_lo + q, s = q + 2;
      const int i = pys[s] + (W - 1 - k), j = r - i;
      const int v = val(s, r, i, j, k);
      const int k_up = (W - 1) - ((i - 1) - pys[s - 1]);
      const int k_diag = (W - 1) - ((i - 1) - pys[s - 2]);
      const int up_v = val(s - 1, r - 1, i - 1, j, k_up);
      const int left_v = val(s - 1, r - 1, i, j - 1, k_up - 1);
      const int diag_v = val(s - 2, r - 2, i - 1, j - 1, k_diag);
      const int sc = sub_score(yc, xc, tab, a.stride, a.match, a.mismatch);
      const bool can_d = i > 0 && j > 0 && diag_v + sc == v;
      const bool can_u = i > 0 && up_v - a.gap == v;
      const bool can_l = j > 0 && left_v - a.gap == v;
      const int mv = can_d ? 0 : (can_u ? 1 : 2);
      const int nr_ = r - 1 - (mv == 0);
      const int nk = mv == 0 ? k_diag : (mv == 1 ? k_up : k_up - 1);
      // its chunk: c, c + 1 or (C = 1, a diagonal) c + 2
      const int off = nr_ >= r_lo ? 0 : (nr_ >= r_lo - C ? 1 : 2);
      const uint32_t idx = ((c + off) % NBUF) * Sp + (nr_ - r_lo + off * C) * W + nk;
      const uint32_t ent = nr_ == 0 ? (mv | E_EXIT | base << 8)
                                    : (mv | (off ? E_CROSS : 0u) | (base + 4 * idx) << 8);
      return (r >= 1 && v > MINF && (can_d || can_u || can_l)) ? ent : stall;
    };
    uint32_t* out = map + static_cast<size_t>(c) * Sp;
    int q = tid / W, k = tid % W;
    const int dq = MAP_THREADS / W, dk = MAP_THREADS % W;
    for (int e0 = tid; e0 < S; e0 += BATCH * MAP_THREADS) {
      // a batch of cells: their code loads first, all in flight together
      int qs[BATCH], ks[BATCH], yc[BATCH], xc[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        qs[u] = q;
        ks[u] = k;
        const bool live = e0 + u * MAP_THREADS < S;
        const int i = live ? pys[q + 2] + (W - 1 - k) : 0, j = r_lo + q - i;
        yc[u] = live ? a.qp[static_cast<size_t>(b) * a.QL + min(max(i, 0), a.QL - 1)] : -1;
        xc[u] = live ? a.tp[static_cast<size_t>(b) * a.TL + min(max(W + j - 1, 0), a.TL - 1)]
                     : -1;
        q += dq;
        k += dk;
        if (k >= W) {
          k -= W;
          ++q;
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (e0 + u * MAP_THREADS < S)
          out[e0 + u * MAP_THREADS] = entry(qs[u], ks[u], yc[u], xc[u]);
    }
    publish(flags + c);
  }
}

// Launch a map kernel: `units` (pairs, or groups of G pairs) x P producer
// CTAs, P = G x producers_per_pair(B), and B follower CTAs, their roles
// handed out by ticket (producers first: they wait on nothing, so a
// follower that waits on a producer never holds the producer's place), with
// `smem` bytes of dynamic shared memory (above 48 KB only after opting in).
template <typename Kernel, typename Args>
int launch_map(Kernel kernel, Args a, int units, int G, size_t smem, void* stream) {
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  a.nprod = G * producers_per_pair(a.B);
  const long long grid = static_cast<long long>(units) * a.nprod + a.B;
  if (grid >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(grid), MAP_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The block walk on `stream`: one wire row per pair (see the head note).
// qT [n, B] int16, t [B, m] int16, table [stride, stride] int32 or null,
// hist [n, W, B], bases [NB, B], score / end_y / end_j / n_rows [B] int32,
// wire [B, row_bytes] uint8 with row_bytes = 20 + steps / 4 and steps a
// multiple of 64; `chunk` rows a map chunk (>= 1), or 0 for the earlier
// serial kernel; `group` pairs a producer CTA maps together (1 or 8); `map` [B, max_chunks, block_Sp(W, chunk)] int32 scratch and `flags`
// [B * max_chunks + 1] int32 zeros with max_chunks >= ceil(n / chunk).
// Returns cudaGetLastError() (cudaErrorInvalidValue for a bad steps /
// row_bytes / stride / chunk / group / scratch, or a chunk past shared
// memory).
int swtpu_block_walk(const void* qT, const void* t, const void* table, const void* hist,
                     const void* bases, const void* score, const void* end_y,
                     const void* end_j, const void* n_rows, void* wire, int B, int n,
                     int m, int W, int K, int X, int match, int mismatch, int gap,
                     int stride, int steps, int row_bytes, int chunk, int group, void* map,
                     void* flags, int max_chunks, void* stream) {
  if (steps <= 0 || steps % 64 || row_bytes != 20 + steps / 4 || W < 1 || K < 1 ||
      chunk < 0 || (group != 1 && group != MAXG) ||
      (chunk && (!map || !flags || max_chunks < (n + chunk - 1) / chunk)) ||
      (table && (stride < 1 || stride > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const BlockWalk a{static_cast<const int16_t*>(qT), static_cast<const int16_t*>(t),
                    static_cast<const int32_t*>(table), static_cast<const int32_t*>(hist),
                    static_cast<const int32_t*>(bases), static_cast<const int32_t*>(score),
                    static_cast<const int32_t*>(end_y), static_cast<const int32_t*>(end_j),
                    static_cast<const int32_t*>(n_rows), static_cast<uint8_t*>(wire),
                    static_cast<uint32_t*>(map), static_cast<int*>(flags),
                    B, n, m, W, K, X, match, mismatch, gap, stride, steps, row_bytes, chunk,
                    max_chunks, group, 0};
  if (chunk == 0) {
    block_walk_serial_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_map(block_walk_kernel, a, (B + group - 1) / group, group,
                    block_smem(W, chunk, group), stream);
}

// The per-round walk on `stream`. qp [B, QL] / tp [B, TL] int16 padded rows
// (kernels/banded_scan.py::_prep_padded), lens_q / lens_t [B] int32, table
// or null, hist [R, B, W] int32, posy [R, B], score / max_round / n_rounds
// [B], wire, chunk (rounds) and scratch as for the block walk, the map
// [B, max_chunks, xdrop_Sp(W, chunk)] with max_chunks >= ceil(R / chunk).
int swtpu_xdrop_walk(const void* qp, const void* tp, const void* lens_q, const void* lens_t,
                     const void* table, const void* hist, const void* posy,
                     const void* score, const void* max_round, const void* n_rounds,
                     void* wire, int B, int QL, int TL, int R, int W, int X, int match,
                     int mismatch, int gap, int stride, int steps, int row_bytes, int chunk,
                     void* map, void* flags, int max_chunks, void* stream) {
  if (steps <= 0 || steps % 64 || row_bytes != 20 + steps / 4 || W < 1 || R < 1 ||
      QL < 1 || TL < 1 || chunk < 0 ||
      (chunk && (!map || !flags || max_chunks < (R + chunk - 1) / chunk)) ||
      (table && (stride < 1 || stride > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  const XdropWalk a{static_cast<const int16_t*>(qp), static_cast<const int16_t*>(tp),
                    static_cast<const int32_t*>(lens_q), static_cast<const int32_t*>(lens_t),
                    static_cast<const int32_t*>(table), static_cast<const int32_t*>(hist),
                    static_cast<const int32_t*>(posy), static_cast<const int32_t*>(score),
                    static_cast<const int32_t*>(max_round),
                    static_cast<const int32_t*>(n_rounds), static_cast<uint8_t*>(wire),
                    static_cast<uint32_t*>(map), static_cast<int*>(flags),
                    B, QL, TL, R, W, X, match, mismatch, gap, stride, steps, row_bytes, chunk,
                    max_chunks, 0};
  if (chunk == 0) {
    xdrop_walk_serial_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_map(xdrop_walk_kernel, a, B, 1, xdrop_smem(W, chunk), stream);
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
