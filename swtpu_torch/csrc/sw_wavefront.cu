// Batched local-alignment scores on the anti-diagonal (wavefront)
// schedule for Hopper (sm_90a): queries of up to 128 codes, any
// substitution matrix of up to 31 letters, linear gap.
//
// Replaces swtpu/kernels/pallas/sw_wavefront.py  _kernel (pallas_call
// :110; entry sw_wavefront_pallas :179). Its plain version is
// swtpu_torch/kernels/sw_wavefront.py::sw_wavefront_plain, which repeats
// the TPU kernel step by step; this kernel equals it bit for bit.
//
// Design. One warp per pair; lane l holds the query positions p = 4l ..
// 4l + 3, so the 32 lanes cover the TPU's 128 positions (positions n..127
// are phantom: their query code is the pad, which scores -2^20). Step d
// is the TPU kernel's recurrence (sw_wavefront.py:27-31): position p
// computes cell (p + 1, d - p + 1) as
//   H_d[p] = max(H_{d-2}[p-1] + S[q[p], t[d-p]], H_{d-1}[p] - gap,
//                H_{d-1}[p-1] - gap, 0)
// with H_{d-1}[p-1] and H_{d-2}[p-1] of position 4l taken from lane l - 1
// through __shfl_up_sync (lane 0 takes 0, the TPU's lane-0 mask). The
// target codes slide along the positions: position p's code at step d + 1
// is position p - 1's at step d, so a lane shifts its four codes and
// takes lane l - 1's last through the same shuffle; lane 0 takes t[d + 1]
// from a 32-code window the warp loads together (one coalesced load
// every 32 steps, the next window loaded a window ahead). Codes off the
// target (d - p < 0 or >= m) and codes >= A score -2^20, as the TPU
// stream does. The warp runs n_steps = ceil((n + m - 1) / 32) * 32 steps,
// the TPU's padded count, so phantom cells decay exactly as there; the
// best over every cell is a running max per lane, then a warp max.
//
// The TPU kernel streams a precomputed [n_steps, 128, 128] int32 score
// stream (sw_wavefront.py::_prepare), a workaround for gathers on its
// vector unit; here each score is one lookup in the (A + 1) x (A + 1)
// table in shared memory.
//
// Bound: int32 throughput. As written a cell costs about 8 int32 ops (score:
// offset add and lookup; H: add, two subtracts, three maxes; the running
// max) and each step 3 shuffles a lane. The rhombus overhang (the 128 x
// n_steps cells computed against the n x m real ones) is the schedule's
// own cost: about half the work at 128 x 128.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // pairs a block
constexpr int MAX_CODES = 32;  // A + 1
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
sw_wavefront_kernel(const uint8_t* __restrict__ qs, const uint8_t* __restrict__ ts,
                    const int32_t* __restrict__ table, int A, int32_t* __restrict__ out,
                    int B, int n, int m, int n_steps, int gap) {
  __shared__ int32_t tab[MAX_CODES * MAX_CODES];
  const int A1 = A + 1;
  for (int k = threadIdx.x; k < A1 * A1; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const uint8_t* q = qs + static_cast<size_t>(b) * n;
  const uint8_t* t = ts + static_cast<size_t>(b) * m;

  int qrow[4];  // the table row of each position's query code
  int c[4];     // each position's target code at the current step
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = 4 * lane + k;
    qrow[k] = (p < n ? min(static_cast<int>(q[p]), A) : A) * A1;
    c[k] = A;
  }
  // the lane's target window: t[w0 + lane] (and the next window's)
  auto load = [&](int j) { return j < m ? min(static_cast<int>(t[j]), A) : A; };
  int win = load(lane);
  int win_next = load(32 + lane);
  if (lane == 0) c[0] = win;  // position 0 starts on t[0]; the rest off the target

  int h1[4] = {0, 0, 0, 0};  // H_{d-1}
  int h2[4] = {0, 0, 0, 0};  // H_{d-2}
  int up1 = 0, up2 = 0;      // H_{d-1}[4l - 1], H_{d-2}[4l - 1]
  int best = 0;
  for (int d = 0; d < n_steps; ++d) {
    int h[4];
    h[0] = max(max(up2 + tab[qrow[0] + c[0]], h1[0] - gap), max(up1 - gap, 0));
#pragma unroll
    for (int k = 1; k < 4; ++k)
      h[k] = max(max(h2[k - 1] + tab[qrow[k] + c[k]], h1[k] - gap),
                 max(h1[k - 1] - gap, 0));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      best = max(best, h[k]);
      h2[k] = h1[k];
      h1[k] = h[k];
    }
    const int from_left = __shfl_up_sync(FULL, h[3], 1);
    up2 = up1;
    up1 = lane ? from_left : 0;
    // codes for step d + 1
    const int dn = d + 1;
    if ((dn & 31) == 0) {
      win = win_next;
      win_next = load(dn + 32 + lane);
    }
    const int c_left = __shfl_up_sync(FULL, c[3], 1);
    const int c_new = __shfl_sync(FULL, win, dn & 31);
    c[3] = c[2];
    c[2] = c[1];
    c[1] = c[0];
    c[0] = lane ? c_left : c_new;
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) best = max(best, __shfl_down_sync(FULL, best, k));
  if (lane == 0) out[b] = best;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError();
// cudaErrorInvalidValue for n outside 0..128 or an alphabet of more than
// 31 letters. Pointers: qs [B, n] and ts [B, m] uint8 codes, table [A + 1,
// A + 1] int32 (the pad row and column at -2^20), out [B] int32. All on
// one device, contiguous; the wrapper checks that.
int swtpu_sw_wavefront(const void* qs, const void* ts, const void* table, int A,
                       void* out, int B, int n, int m, int n_steps, int gap,
                       void* stream) {
  if (n < 0 || n > 128 || A < 1 || A + 1 > MAX_CODES || B < 0 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  sw_wavefront_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(qs), static_cast<const uint8_t*>(ts),
      static_cast<const int32_t*>(table), A, static_cast<int32_t*>(out), B, n, m,
      n_steps, gap);
  return static_cast<int>(cudaGetLastError());
}

const char* swtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
