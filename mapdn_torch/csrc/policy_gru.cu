// The shared deterministic GRU policy, differentiated: its forward and the
// backward to its parameters, for the update step's policy loss.
//
// Replaces no TPU kernel: the JAX package left the policy to XLA
// (mapdn_tpu/nets/agents.py).  Added because the policy's forward and
// backward through PyTorch's ops took 74.3 of the 76.2 ms of device time of
// one policy update step at case322 (4,096 lanes x 32 steps x 38 agents =
// 4,980,736 rows a step): some 45 kernels, each a pass over 5M x 64 or 5M x
// 192 float32 intermediates that autograd keeps.  It computes what
// mapdn_torch.nets.policy_gru.policy_fwd_plain / policy_bwd_plain compute,
// which is MARLModel.policy -> RNNAgent.forward for hidden width 64,
// LayerNorm (eps 1e-6) and ReLU, one action, per row:
//   y1  = obs W1[:, :o]^T + W1[:, o + agent] + b1     (agent = row mod n:
//         the agent-id one-hot taken as one column of fc1, never built)
//   s   = relu(LayerNorm(y1))
//   r   = sigmoid(s Wir^T + bir + h Whr^T),  z = sigmoid(s Wiz^T + biz + h Whz^T)
//   hn  = h Whn^T + b_hn,  nn = tanh(s Win^T + bin + r hn)
//   h'  = (1 - z) nn + z h,  mean = h' Whead^T + bhead
// The forward writes the means and a float32 stash of what the backward
// needs, (xhat, r, z, nn, hn) a row and its 1/std; the backward reads the
// stash, obs and h, and the means' cotangent, and gives the gradients of
// every parameter (none to obs or h, which are data).
//
// What bounds it on an H100: FP32 FMAs.  A row costs 28.6 k FMA forward
// (case322: 62 x 64 + 2 x 64 x 192 + 64) and 41 k backward (the cotangent
// of the stem through W_ih, and the three weight gradients), 0.69 TFLOP a
// step at 67 TFLOP/s: 10.3 ms.  Its bytes, obs and h read twice, the stash
// written once and read once, 5M x 894 floats, take 5.3 ms at 3.35 TB/s.
// The design keeps every 64- and 192-wide intermediate other than the
// stash out of device memory:
//   * one persistent block of 16 warps an SM, the policy's weights staged
//     in shared memory once a block, rows padded to 68 floats so that a
//     lane's 16-byte load of its own row is conflict-free;
//   * forward: each warp owns 8 rows of a 128-row tile and each lane two
//     hidden units (lane, lane + 32); the three products are register
//     blocked, the lane's weight rows loaded 4 columns at a time against
//     broadcasts of each row's input; LayerNorm's statistics and the head
//     are warp shuffles, the gates stay in registers;
//   * backward: 64-row tiles; each warp turns its 4 rows' stash into the
//     gates' cotangents (one float4 a unit: r, z and n of the input path,
//     n of the hidden path) and, through a transposed copy of W_ih, the
//     stem's cotangent and LayerNorm's backward; then every thread adds the
//     tile's outer products to the 56 gradient entries it owns for the whole
//     kernel (a 2-unit x 4-column block of W_ih, W_hh and fc1), in
//     registers; the smaller gradients are summed per lane and per thread;
//   * both: a tile's loads from device memory are all issued before the
//     first is stored or used (the backward's stash loads fly across the
//     tile's barrier): with one block an SM, their latency is what the
//     warps wait on between tiles (PERF.md §7).
// Each block writes its partial gradients once; policy_reduce_kernel sums
// them over the blocks in a fixed order: no float atomics, so a run
// repeats bit for bit and a graph replay equals the uncaptured step.
//
// Obs wider than 64 columns (up to 128: case141's 66, case33's and
// case322's obs at history 2, 76 and 124).  Both kernels are templates on
// kT, the obs's 64-column tiles; kT = 1 (o <= 64) is the code above, and
// kT = 2 adds only what the second tile needs:
//   * forward: fc1's obs columns staged as two (64, 68) tiles; a warp's
//     8 rows of both tiles are loaded with its h rows, the second tile's
//     held in registers (16 floats a lane) while the first tile's product
//     runs in the warp's x buffer, then stored there for the second
//     product.  The sum over the columns keeps their order.  Shared memory
//     (bytes): 193,536 + 256 n_id at kT = 1, 210,944 + 256 n_id at kT = 2.
//   * backward: the tile's obs as two (64, 68) tiles, loaded with its h;
//     each thread owns the 2-unit x 4-column block of fc1 in both column
//     tiles, 64 gradient entries in registers in place of 56.  Shared
//     memory 203,776 + 256 n_id at kT = 1, 221,184 + 256 n_id at kT = 2,
//     so kT = 2 takes at most 44 agents within a block's 227 KB
//     (kMaxAgentsWide); the registers stay capped at 128 a thread by the
//     one 512-thread block an SM, and what does not fit spills to local
//     memory (kT = 1 already spills 56 bytes a thread).
// fc1's FMAs run over round4(o) columns, so o = 66 pays for 68: the
// counts of the benchmark (perfbench/policy_counting.py) take o.
//
// Numbers: FP32 FMAs throughout, precise expf, tanhf, sqrtf and IEEE
// division; no tensor cores (TF32 fails every cell's check, PERF.md §6).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH = 64;                   // hidden width
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = kH + 4;               // a 64-wide smem row: 68 floats
constexpr int kGS = 4 * kH + 4;          // a row of per-unit float4s: 260 floats
constexpr int kFwdRows = 8;              // rows a warp, forward
constexpr int kBwdRows = 4;              // rows a warp, backward
constexpr int kFwdTile = kWarps * kFwdRows;
constexpr int kBwdTile = kWarps * kBwdRows;
constexpr int kMaxAgents = 64;
constexpr int kMaxAgentsWide = 44;       // agents at kT = 2 (the backward's smem)
constexpr int kMaxObs = 2 * kH;
constexpr int kStash = 5;                // xhat, r, z, nn, hn
constexpr float kEps = 1e-6f;
constexpr unsigned kAll = 0xffffffffu;

struct Weights {
  const float* w1;      // (64, o + n_id)
  const float* b1;      // (64,)
  const float* ln_w;    // (64,)
  const float* ln_b;    // (64,)
  const float* w_ih;    // (192, 64)
  const float* w_hh;    // (192, 64)
  const float* b_ih;    // (192,)
  const float* b_hn;    // (64,)
  const float* w_head;  // (1, 64)
  const float* b_head;  // (1,)
};

struct Shape {
  long rows;
  int o;        // obs width, <= 64 kT
  int n_id;     // agents of the one-hot, 0 without ids
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kAll, v, d);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// ------------------------------------------------------------------ forward
// Shared memory (floats): w1o (kT, 64, kS) the obs columns of fc1, column
// 64 c + k of tile c at k, zero past o; w1id (n_id, 64) its id columns;
// w_ih, w_hh (192, kS); b1, ln_w, ln_b, b_hn, w_head (64 each), b_ih (192);
// then per warp x (kFwdRows, kS), which holds each obs tile in turn and the
// stem's output once the products have read them, and h (kFwdRows, kS).
template <int kT>
__host__ __device__ constexpr int fwd_floats(int n_id) {
  return kT * 64 * kS + n_id * 64 + 2 * 192 * kS + 5 * 64 + 192
         + kWarps * 2 * kFwdRows * kS;
}

template <int kT>
__global__ void __launch_bounds__(kThreads, 1)
policy_fwd_kernel(const Weights w, const Shape sh, const float* __restrict__ obs,
                  const float* __restrict__ hid, float* __restrict__ means,
                  float* __restrict__ stash, float* __restrict__ rstd_out) {
  extern __shared__ __align__(16) float sm[];
  const int o = sh.o, n_id = sh.n_id, in = o + n_id, o4 = round4(o);
  float* w1o = sm;
  float* w1id = w1o + kT * 64 * kS;
  float* wih = w1id + n_id * 64;
  float* whh = wih + 192 * kS;
  float* b1 = whh + 192 * kS;
  float* lnw = b1 + 64;
  float* lnb = lnw + 64;
  float* bhn = lnb + 64;
  float* whead = bhn + 64;
  float* bih = whead + 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = bih + 192 + warp * 2 * kFwdRows * kS;
  float* hs = xs + kFwdRows * kS;

#pragma unroll
  for (int c = 0; c < kT; ++c)
    for (int i = threadIdx.x; i < 64 * kS; i += kThreads) {
      const int j = i / kS, k = i % kS + 64 * c;
      const bool in_tile = kT == 1 || k < 64 * (c + 1);
      w1o[c * 64 * kS + i] = (k < o && in_tile) ? w.w1[j * in + k] : 0.f;
    }
  for (int i = threadIdx.x; i < n_id * 64; i += kThreads) {
    const int a = i / 64, j = i % 64;
    w1id[i] = w.w1[j * in + o + a];
  }
  for (int i = threadIdx.x; i < 192 * kS; i += kThreads) {
    const int j = i / kS, k = i % kS;
    wih[i] = k < kH ? w.w_ih[j * kH + k] : 0.f;
    whh[i] = k < kH ? w.w_hh[j * kH + k] : 0.f;
  }
  for (int i = threadIdx.x; i < 64; i += kThreads) {
    b1[i] = w.b1[i];
    lnw[i] = w.ln_w[i];
    lnb[i] = w.ln_b[i];
    bhn[i] = w.b_hn[i];
    whead[i] = w.w_head[i];
  }
  for (int i = threadIdx.x; i < 192; i += kThreads) bih[i] = w.b_ih[i];
  __syncthreads();
  const float bhead = w.b_head[0];

  const int j0 = lane, j1 = lane + 32;
  const long n_tiles = (sh.rows + kFwdTile - 1) / kFwdTile;
  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long r0 = t * kFwdTile + warp * kFwdRows;   // the warp's first row
    // the warp's rows of obs (zero past o and past the last row) and of h
    // into its buffers, every load issued before the first store; the
    // later obs tiles wait in registers for their turn in x
    float xv[kFwdRows][2 * kT];
    float4 hv[kFwdRows / 2];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const long r = r0 + i;
#pragma unroll
      for (int c = 0; c < 2 * kT; ++c) {
        const int k = lane + 32 * c;
        xv[i][c] = (k < o && r < sh.rows) ? obs[r * o + k] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kFwdRows / 2; ++q) {
      const int e = lane + 32 * q, i = e >> 4, k = (e & 15) * 4;
      const long r = r0 + i;
      hv[q] = r < sh.rows ? *reinterpret_cast<const float4*>(hid + r * kH + k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      xs[i * kS + lane] = xv[i][0];
      xs[i * kS + lane + 32] = xv[i][1];
    }
#pragma unroll
    for (int q = 0; q < kFwdRows / 2; ++q) {
      const int e = lane + 32 * q, i = e >> 4, k = (e & 15) * 4;
      *reinterpret_cast<float4*>(hs + i * kS + k) = hv[q];
    }
    __syncwarp();

    // fc1: y1 = obs W1o^T + W1[:, o + agent] + b1
    float y[kFwdRows][2];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const int a = n_id ? static_cast<int>((r0 + i) % n_id) : 0;
      y[i][0] = b1[j0] + (n_id ? w1id[a * 64 + j0] : 0.f);
      y[i][1] = b1[j1] + (n_id ? w1id[a * 64 + j1] : 0.f);
    }
#pragma unroll
    for (int c = 0; c < kT; ++c) {
      if (c > 0) {   // the next obs tile into x, once every lane has read the last
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kFwdRows; ++i) {
          xs[i * kS + lane] = xv[i][2 * c];
          xs[i * kS + lane + 32] = xv[i][2 * c + 1];
        }
        __syncwarp();
      }
      const float* w1c = w1o + c * 64 * kS;
      const int kn = kT == 1 ? o4 : min(o4 - 64 * c, 64);
      for (int k = 0; k < kn; k += 4) {
        const float4 wa = *reinterpret_cast<const float4*>(w1c + j0 * kS + k);
        const float4 wb = *reinterpret_cast<const float4*>(w1c + j1 * kS + k);
#pragma unroll
        for (int i = 0; i < kFwdRows; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + i * kS + k);
          y[i][0] = dot4(xv, wa, y[i][0]);
          y[i][1] = dot4(xv, wb, y[i][1]);
        }
      }
    }
    __syncwarp();   // every lane's reads of x precede the stem's writes
    // LayerNorm, ReLU; the stash's xhat and 1/std
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const long r = r0 + i;
      const float mean = warp_sum(y[i][0] + y[i][1]) * (1.f / kH);
      const float d0 = y[i][0] - mean, d1 = y[i][1] - mean;
      const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / kH);
      const float rstd = 1.f / sqrtf(var + kEps);
      const float x0 = d0 * rstd, x1 = d1 * rstd;
      xs[i * kS + j0] = fmaxf(fmaf(x0, lnw[j0], lnb[j0]), 0.f);
      xs[i * kS + j1] = fmaxf(fmaf(x1, lnw[j1], lnb[j1]), 0.f);
      if (r < sh.rows) {
        float* st = stash + r * (kStash * kH);
        st[j0] = x0;
        st[j1] = x1;
        if (lane == 0) rstd_out[r] = rstd;
      }
    }
    __syncwarp();

    // the GRU's products: r and z take both paths in one sum each
    float ar[kFwdRows][2], az[kFwdRows][2], ain[kFwdRows][2], ahn[kFwdRows][2];
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      ar[i][0] = bih[j0];       ar[i][1] = bih[j1];
      az[i][0] = bih[64 + j0];  az[i][1] = bih[64 + j1];
      ain[i][0] = bih[128 + j0]; ain[i][1] = bih[128 + j1];
      ahn[i][0] = bhn[j0];      ahn[i][1] = bhn[j1];
    }
#pragma unroll 1
    for (int k = 0; k < kH; k += 4) {
      const float4 r0a = *reinterpret_cast<const float4*>(wih + j0 * kS + k);
      const float4 r0b = *reinterpret_cast<const float4*>(wih + j1 * kS + k);
      const float4 z0a = *reinterpret_cast<const float4*>(wih + (64 + j0) * kS + k);
      const float4 z0b = *reinterpret_cast<const float4*>(wih + (64 + j1) * kS + k);
      const float4 n0a = *reinterpret_cast<const float4*>(wih + (128 + j0) * kS + k);
      const float4 n0b = *reinterpret_cast<const float4*>(wih + (128 + j1) * kS + k);
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        const float4 sv = *reinterpret_cast<const float4*>(xs + i * kS + k);
        ar[i][0] = dot4(sv, r0a, ar[i][0]);
        ar[i][1] = dot4(sv, r0b, ar[i][1]);
        az[i][0] = dot4(sv, z0a, az[i][0]);
        az[i][1] = dot4(sv, z0b, az[i][1]);
        ain[i][0] = dot4(sv, n0a, ain[i][0]);
        ain[i][1] = dot4(sv, n0b, ain[i][1]);
      }
    }
#pragma unroll 1
    for (int k = 0; k < kH; k += 4) {
      const float4 r0a = *reinterpret_cast<const float4*>(whh + j0 * kS + k);
      const float4 r0b = *reinterpret_cast<const float4*>(whh + j1 * kS + k);
      const float4 z0a = *reinterpret_cast<const float4*>(whh + (64 + j0) * kS + k);
      const float4 z0b = *reinterpret_cast<const float4*>(whh + (64 + j1) * kS + k);
      const float4 n0a = *reinterpret_cast<const float4*>(whh + (128 + j0) * kS + k);
      const float4 n0b = *reinterpret_cast<const float4*>(whh + (128 + j1) * kS + k);
#pragma unroll
      for (int i = 0; i < kFwdRows; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + i * kS + k);
        ar[i][0] = dot4(hv, r0a, ar[i][0]);
        ar[i][1] = dot4(hv, r0b, ar[i][1]);
        az[i][0] = dot4(hv, z0a, az[i][0]);
        az[i][1] = dot4(hv, z0b, az[i][1]);
        ahn[i][0] = dot4(hv, n0a, ahn[i][0]);
        ahn[i][1] = dot4(hv, n0b, ahn[i][1]);
      }
    }
    // the gates, the new hidden state, the head; the stash's gates
#pragma unroll
    for (int i = 0; i < kFwdRows; ++i) {
      const long r = r0 + i;
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = u ? j1 : j0;
        const float rg = sigmoid(ar[i][u]);
        const float zg = sigmoid(az[i][u]);
        const float ng = tanhf(fmaf(rg, ahn[i][u], ain[i][u]));
        const float h = hs[i * kS + j];
        const float hnew = fmaf(zg, h, (1.f - zg) * ng);
        part = fmaf(whead[j], hnew, part);
        if (r < sh.rows) {
          float* st = stash + r * (kStash * kH) + j;
          st[1 * kH] = rg;
          st[2 * kH] = zg;
          st[3 * kH] = ng;
          st[4 * kH] = ahn[i][u];
        }
      }
      const float m = warp_sum(part);
      if (lane == 0 && r < sh.rows) means[r] = m + bhead;
    }
    __syncwarp();   // the tile's reads of x and h precede the next tile's loads
  }
}

// ----------------------------------------------------------------- backward
// Shared memory (floats): wt (64, kGS), W_ih transposed by unit, the float4
// (W_ih[j][k], W_ih[64 + j][k], W_ih[128 + j][k], 0) at wt[k][4 j]; ln_w,
// ln_b, w_head (64 each); the tile's x (kT, kBwdTile, kS), column 64 c + k
// of tile c at k, and s, h and the stem's cotangent dy (kBwdTile, kS) each,
// the gates' cotangents g (kBwdTile, kGS) as the float4 (d r_pre, d z_pre,
// d n_pre, d hn) of each unit, the means' cotangents (kBwdTile); the id
// columns' gradient (n_id, 64).
template <int kT>
__host__ __device__ constexpr int bwd_floats(int n_id) {
  return 64 * kGS + 3 * 64 + (3 + kT) * kBwdTile * kS + kBwdTile * kGS + kBwdTile
         + n_id * 64;
}
static_assert(bwd_floats<2>(kMaxAgentsWide) * 4 <= 227 * 1024, "kT = 2 exceeds a block's smem");
static_assert(bwd_floats<1>(kMaxAgents) * 4 <= 227 * 1024, "kT = 1 exceeds a block's smem");

// partial gradients of one block: the parameters' flat layout, in the
// module's order (fc1 W and b, LayerNorm scale and bias, W_ih, W_hh, b_ih,
// b_hn, head W and b)
struct Offsets {
  int w1, b1, lnw, lnb, wih, whh, bih, bhn, whead, bhead, total;
};

__host__ __device__ Offsets offsets(int in) {
  Offsets f;
  f.w1 = 0;
  f.b1 = 64 * in;
  f.lnw = f.b1 + 64;
  f.lnb = f.lnw + 64;
  f.wih = f.lnb + 64;
  f.whh = f.wih + 192 * 64;
  f.bih = f.whh + 192 * 64;
  f.bhn = f.bih + 192;
  f.whead = f.bhn + 64;
  f.bhead = f.whead + 64;
  f.total = f.bhead + 1;
  return f;
}

template <int kT>
__global__ void __launch_bounds__(kThreads, 1)
policy_bwd_kernel(const Weights w, const Shape sh, const float* __restrict__ obs,
                  const float* __restrict__ hid, const float* __restrict__ dmeans,
                  const float* __restrict__ stash, const float* __restrict__ rstd_in,
                  float* __restrict__ partial) {
  extern __shared__ __align__(16) float sm[];
  const int o = sh.o, n_id = sh.n_id, in = o + n_id;
  float* wt = sm;
  float* lnw = wt + 64 * kGS;
  float* lnb = lnw + 64;
  float* whead = lnb + 64;
  float* xt = whead + 64;
  float* st = xt + kT * kBwdTile * kS;
  float* ht = st + kBwdTile * kS;
  float* dyt = ht + kBwdTile * kS;
  float* gt = dyt + kBwdTile * kS;
  float* dmt = gt + kBwdTile * kGS;
  float* idacc = dmt + kBwdTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < 64 * kGS; i += kThreads) {
    const int k = i / kGS, c = i % kGS, j = c >> 2, g = c & 3;
    wt[i] = (g < 3 && j < kH) ? w.w_ih[(g * kH + j) * kH + k] : 0.f;
  }
  for (int i = tid; i < 64; i += kThreads) {
    lnw[i] = w.ln_w[i];
    lnb[i] = w.ln_b[i];
    whead[i] = w.w_head[i];
  }
  for (int i = tid; i < n_id * 64; i += kThreads) idacc[i] = 0.f;
  __syncthreads();

  // the thread's block of W_ih, W_hh (3 gates x units 2tj, 2tj + 1 x
  // columns 4tk .. 4tk + 3) and fc1's obs columns (units x columns of
  // each obs tile)
  const int tk = tid & 15, tj = tid >> 4, kb = 4 * tk, ja = 2 * tj;
  float gih[3][2][4], ghh[3][2][4], g1[kT][2][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) gih[g][u][c] = ghh[g][u][c] = 0.f;
#pragma unroll
  for (int b = 0; b < kT; ++b)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) g1[b][u][c] = 0.f;
  // the lane's units' small gradients, over its warp's rows
  float lb1[2] = {0.f, 0.f}, lgam[2] = {0.f, 0.f}, lbet[2] = {0.f, 0.f};
  float lbih[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}}, lbhn[2] = {0.f, 0.f};
  float lwhead[2] = {0.f, 0.f}, lbhead = 0.f;

  const int j0 = lane, j1 = lane + 32;
  const long n_tiles = (sh.rows + kBwdTile - 1) / kBwdTile;
  for (long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long t0 = t * kBwdTile;
    // the tile's obs, h and means' cotangents (zero past o and past the
    // last row), every load issued before the first store
    {
      constexpr int kX = kBwdTile * kH / kThreads, kHv = kBwdTile * 16 / kThreads;
      float xv[kT][kX];
      float4 hv[kHv];
#pragma unroll
      for (int b = 0; b < kT; ++b)
#pragma unroll
        for (int q = 0; q < kX; ++q) {
          const int e = tid + kThreads * q, i = e >> 6, k = 64 * b + (e & 63);
          const long r = t0 + i;
          xv[b][q] = (k < o && r < sh.rows) ? obs[r * o + k] : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kHv; ++q) {
        const int e = tid + kThreads * q, i = e >> 4, k = (e & 15) * 4;
        const long r = t0 + i;
        hv[q] = r < sh.rows ? *reinterpret_cast<const float4*>(hid + r * kH + k)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float dv = (tid < kBwdTile && t0 + tid < sh.rows) ? dmeans[t0 + tid] : 0.f;
#pragma unroll
      for (int b = 0; b < kT; ++b)
#pragma unroll
        for (int q = 0; q < kX; ++q) {
          const int e = tid + kThreads * q;
          xt[b * kBwdTile * kS + (e >> 6) * kS + (e & 63)] = xv[b][q];
        }
#pragma unroll
      for (int q = 0; q < kHv; ++q) {
        const int e = tid + kThreads * q;
        *reinterpret_cast<float4*>(ht + (e >> 4) * kS + (e & 15) * 4) = hv[q];
      }
      if (tid < kBwdTile) dmt[tid] = dv;
    }
    // the warp's rows of the stash, in flight across the barrier
    float xh[kBwdRows][2], rs[kBwdRows], sv[kBwdRows][2][kStash - 1];
#pragma unroll
    for (int q = 0; q < kBwdRows; ++q) {
      const long r = t0 + warp * kBwdRows + q;
      const bool live = r < sh.rows;
      rs[q] = live ? rstd_in[r] : 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float* sp = stash + (live ? r : 0) * (kStash * kH) + (u ? j1 : j0);
        xh[q][u] = live ? sp[0] : 0.f;
#pragma unroll
        for (int c = 0; c < kStash - 1; ++c) sv[q][u][c] = live ? sp[(c + 1) * kH] : 0.f;
      }
    }
    __syncthreads();

    // the warp's rows: the gates' cotangents
#pragma unroll
    for (int q = 0; q < kBwdRows; ++q) {
      const int i = warp * kBwdRows + q;
      const float dm = dmt[i];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = u ? j1 : j0;
        const float x = xh[q][u];
        const float rg = sv[q][u][0], zg = sv[q][u][1], ng = sv[q][u][2], hn = sv[q][u][3];
        st[i * kS + j] = fmaxf(fmaf(x, lnw[j], lnb[j]), 0.f);
        const float h = ht[i * kS + j];
        const float hnew = fmaf(zg, h, (1.f - zg) * ng);
        lwhead[u] = fmaf(dm, hnew, lwhead[u]);
        const float dh = dm * whead[j];
        const float dz = dh * (h - ng);
        const float dn = dh * (1.f - zg) * (1.f - ng * ng);
        const float drp = dn * hn * rg * (1.f - rg);
        const float dzp = dz * zg * (1.f - zg);
        const float dhn = dn * rg;
        *reinterpret_cast<float4*>(gt + i * kGS + 4 * j) = make_float4(drp, dzp, dn, dhn);
        lbih[0][u] += drp;
        lbih[1][u] += dzp;
        lbih[2][u] += dn;
        lbhn[u] += dhn;
      }
      lbhead += dm;
    }
    __syncwarp();
    // the stem's cotangent ds = dgi W_ih, then LayerNorm's backward
    float ds[kBwdRows][2];
#pragma unroll
    for (int q = 0; q < kBwdRows; ++q) ds[q][0] = ds[q][1] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kH; ++j) {
      const float4 wa = *reinterpret_cast<const float4*>(wt + j0 * kGS + 4 * j);
      const float4 wb = *reinterpret_cast<const float4*>(wt + j1 * kGS + 4 * j);
#pragma unroll
      for (int q = 0; q < kBwdRows; ++q) {
        const float4 gv = *reinterpret_cast<const float4*>(
            gt + (warp * kBwdRows + q) * kGS + 4 * j);
        ds[q][0] = fmaf(gv.z, wa.z, fmaf(gv.y, wa.y, fmaf(gv.x, wa.x, ds[q][0])));
        ds[q][1] = fmaf(gv.z, wb.z, fmaf(gv.y, wb.y, fmaf(gv.x, wb.x, ds[q][1])));
      }
    }
#pragma unroll
    for (int q = 0; q < kBwdRows; ++q) {
      const int i = warp * kBwdRows + q;
      float dx[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = u ? j1 : j0;
        const float pre = fmaf(xh[q][u], lnw[j], lnb[j]);
        const float dy = pre > 0.f ? ds[q][u] : 0.f;
        lgam[u] = fmaf(dy, xh[q][u], lgam[u]);
        lbet[u] += dy;
        dx[u] = dy * lnw[j];
      }
      const float m1 = warp_sum(dx[0] + dx[1]) * (1.f / kH);
      const float m2 = warp_sum(fmaf(dx[0], xh[q][0], dx[1] * xh[q][1])) * (1.f / kH);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float d1 = rs[q] * (dx[u] - m1 - xh[q][u] * m2);
        dyt[i * kS + (u ? j1 : j0)] = d1;
        lb1[u] += d1;
      }
    }
    __syncthreads();

    // fc1's id columns: each (agent, unit) over the tile's rows of the agent
    for (int p = tid; p < n_id * 64; p += kThreads) {
      const int a = p >> 6, j = p & 63;
      int i = static_cast<int>(((a - t0 % n_id) % n_id + n_id) % n_id);
      float acc = 0.f;
      for (; i < kBwdTile; i += n_id) acc += dyt[i * kS + j];
      idacc[p] += acc;
    }
    // the tile's outer products into the thread's blocks
#pragma unroll 4
    for (int i = 0; i < kBwdTile; ++i) {
      const float4 sv = *reinterpret_cast<const float4*>(st + i * kS + kb);
      const float4 hv = *reinterpret_cast<const float4*>(ht + i * kS + kb);
      float x4[kT][4];
#pragma unroll
      for (int b = 0; b < kT; ++b) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + b * kBwdTile * kS + i * kS + kb);
        x4[b][0] = xv.x;
        x4[b][1] = xv.y;
        x4[b][2] = xv.z;
        x4[b][3] = xv.w;
      }
      const float2 dy = *reinterpret_cast<const float2*>(dyt + i * kS + ja);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 gv = *reinterpret_cast<const float4*>(gt + i * kGS + 4 * (ja + u));
        const float dyu = u ? dy.y : dy.x;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gih[0][u][c] = fmaf(gv.x, s4[c], gih[0][u][c]);
          gih[1][u][c] = fmaf(gv.y, s4[c], gih[1][u][c]);
          gih[2][u][c] = fmaf(gv.z, s4[c], gih[2][u][c]);
          ghh[0][u][c] = fmaf(gv.x, h4[c], ghh[0][u][c]);
          ghh[1][u][c] = fmaf(gv.y, h4[c], ghh[1][u][c]);
          ghh[2][u][c] = fmaf(gv.w, h4[c], ghh[2][u][c]);
#pragma unroll
          for (int b = 0; b < kT; ++b) g1[b][u][c] = fmaf(dyu, x4[b][c], g1[b][u][c]);
        }
      }
    }
    __syncthreads();   // the tile's reads precede the next tile's writes
  }

  // the block's partial gradients
  const Offsets f = offsets(in);
  float* out = partial + static_cast<long>(blockIdx.x) * f.total;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = ja + u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = kb + c;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        out[f.wih + (g * kH + j) * kH + k] = gih[g][u][c];
        out[f.whh + (g * kH + j) * kH + k] = ghh[g][u][c];
      }
#pragma unroll
      for (int b = 0; b < kT; ++b)
        if (64 * b + k < o) out[f.w1 + j * in + 64 * b + k] = g1[b][u][c];
    }
  }
  for (int p = tid; p < n_id * 64; p += kThreads) {
    const int a = p >> 6, j = p & 63;
    out[f.w1 + j * in + o + a] = idacc[p];
  }
  // the lanes' sums over the warps in order: 9 floats a unit a warp
  float* red = xt;   // the tiles are free now (the loop ended on a barrier)
  constexpr int kPer = 9;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    float* rw = red + (warp * kH + (u ? j1 : j0)) * kPer;
    rw[0] = lb1[u];
    rw[1] = lgam[u];
    rw[2] = lbet[u];
    rw[3] = lbih[0][u];
    rw[4] = lbih[1][u];
    rw[5] = lbih[2][u];
    rw[6] = lbhn[u];
    rw[7] = lwhead[u];
    rw[8] = lbhead;
  }
  __syncthreads();
  for (int p = tid; p < kH * 9; p += kThreads) {
    const int j = p / 9, c = p % 9;
    float acc = 0.f;
    for (int v = 0; v < kWarps; ++v) acc += red[(v * kH + j) * kPer + c];
    switch (c) {
      case 0: out[f.b1 + j] = acc; break;
      case 1: out[f.lnw + j] = acc; break;
      case 2: out[f.lnb + j] = acc; break;
      case 3: out[f.bih + j] = acc; break;
      case 4: out[f.bih + kH + j] = acc; break;
      case 5: out[f.bih + 2 * kH + j] = acc; break;
      case 6: out[f.bhn + j] = acc; break;
      case 7: out[f.whead + j] = acc; break;
      default:
        if (j == 0) out[f.bhead] = acc;   // every unit of a warp summed the same
        break;
    }
  }
}

// grads[p] = sum over blocks b = 0, 1, ... of partial[b][p], in that order
__global__ void policy_reduce_kernel(const float* __restrict__ partial, int blocks,
                                     int total, float* __restrict__ grads) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[static_cast<long>(b) * total + p];
  grads[p] = acc;
}

bool valid(long rows, int o, int n_id) {
  return rows >= 0 && o >= 1 && o <= kMaxObs && n_id >= 0
         && n_id <= (o <= kH ? kMaxAgents : kMaxAgentsWide);
}

template <typename K>
int raise_smem(K kernel, int bytes, int* set) {
  if (bytes <= *set) return 0;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *set = bytes;
  return 0;
}

Weights weights(const float* w1, const float* b1, const float* ln_w, const float* ln_b,
                const float* w_ih, const float* w_hh, const float* b_ih,
                const float* b_hn, const float* w_head, const float* b_head) {
  return Weights{w1, b1, ln_w, ln_b, w_ih, w_hh, b_ih, b_hn, w_head, b_head};
}

template <int kT>
int launch_forward(const Weights& w, const Shape& sh, const float* obs, const float* hid,
                   float* means, float* stash, float* rstd, int blocks, cudaStream_t s) {
  static int smem_set = 0;
  const int bytes = fwd_floats<kT>(sh.n_id) * static_cast<int>(sizeof(float));
  const int rc = raise_smem(policy_fwd_kernel<kT>, bytes, &smem_set);
  if (rc) return rc;
  policy_fwd_kernel<kT><<<blocks, kThreads, bytes, s>>>(w, sh, obs, hid, means, stash, rstd);
  return static_cast<int>(cudaGetLastError());
}

template <int kT>
int launch_backward(const Weights& w, const Shape& sh, const float* obs, const float* hid,
                    const float* dmeans, const float* stash, const float* rstd,
                    float* partial, int blocks, cudaStream_t s) {
  static int smem_set = 0;
  const int bytes = bwd_floats<kT>(sh.n_id) * static_cast<int>(sizeof(float));
  const int rc = raise_smem(policy_bwd_kernel<kT>, bytes, &smem_set);
  if (rc) return rc;
  policy_bwd_kernel<kT><<<blocks, kThreads, bytes, s>>>(w, sh, obs, hid, dmeans, stash, rstd,
                                                        partial);
  return static_cast<int>(cudaGetLastError());
}

template <int kT>
int kernel_config(int n_id, int* cfg) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, policy_fwd_kernel<kT>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cfg[0] = fwd_floats<kT>(n_id) * static_cast<int>(sizeof(float));
  cfg[1] = a.numRegs;
  cfg[2] = static_cast<int>(a.localSizeBytes);
  rc = cudaFuncGetAttributes(&a, policy_bwd_kernel<kT>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cfg[3] = bwd_floats<kT>(n_id) * static_cast<int>(sizeof(float));
  cfg[4] = a.numRegs;
  cfg[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// All arrays on the device, float32, contiguous: the parameters in the
// module's shapes (fc1 (64, o + n_id), ..., head (1, 64) and (1,)); obs
// (rows, o), hid (rows, 64); means (rows,), stash (rows, 5, 64), rstd
// (rows,); 1 <= o <= 128, n_id <= 64 (44 where o > 64).  `blocks` blocks of
// 512 threads.  Returns the cudaError_t of the launch (0 = ok).
int policy_gru_forward(const float* w1, const float* b1, const float* ln_w,
                       const float* ln_b, const float* w_ih, const float* w_hh,
                       const float* b_ih, const float* b_hn, const float* w_head,
                       const float* b_head, const float* obs, const float* hid,
                       float* means, float* stash, float* rstd, long rows, int o,
                       int n_id, int blocks, void* stream) {
  if (!valid(rows, o, n_id) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const Weights w = weights(w1, b1, ln_w, ln_b, w_ih, w_hh, b_ih, b_hn, w_head, b_head);
  const Shape sh{rows, o, n_id};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return o <= kH ? launch_forward<1>(w, sh, obs, hid, means, stash, rstd, blocks, s)
                 : launch_forward<2>(w, sh, obs, hid, means, stash, rstd, blocks, s);
}

// The backward from the forward's stash and rstd and the means' cotangent
// dmeans (rows,): each block's partial gradients into partial (blocks,
// total), then their sum over the blocks into grads (total,), the
// parameters flat in the module's order; total = policy_gru_params(o, n_id).
int policy_gru_backward(const float* w1, const float* b1, const float* ln_w,
                        const float* ln_b, const float* w_ih, const float* w_hh,
                        const float* b_ih, const float* b_hn, const float* w_head,
                        const float* b_head, const float* obs, const float* hid,
                        const float* dmeans, const float* stash, const float* rstd,
                        float* partial, float* grads, long rows, int o, int n_id,
                        int blocks, void* stream) {
  if (!valid(rows, o, n_id) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Weights w = weights(w1, b1, ln_w, ln_b, w_ih, w_hh, b_ih, b_hn, w_head, b_head);
  const Shape sh{rows, o, n_id};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = o <= kH
      ? launch_backward<1>(w, sh, obs, hid, dmeans, stash, rstd, partial, blocks, s)
      : launch_backward<2>(w, sh, obs, hid, dmeans, stash, rstd, partial, blocks, s);
  if (rc) return rc;
  const int total = offsets(o + n_id).total;
  policy_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(partial, blocks, total, grads);
  return static_cast<int>(cudaGetLastError());
}

// The number of the policy's parameters (the length of grads).
int policy_gru_params(int o, int n_id) { return offsets(o + n_id).total; }

// The resources of the kernels that obs width o runs: cfg receives
// {forward dynamic shared bytes, registers a thread, local bytes a thread,
// backward dynamic shared bytes, registers, local bytes}.  Returns a
// cudaError_t (0 = ok).
int policy_gru_config(int o, int n_id, int* cfg) {
  if (!valid(0, o, n_id)) return static_cast<int>(cudaErrorInvalidValue);
  return o <= kH ? kernel_config<1>(n_id, cfg) : kernel_config<2>(n_id, cfg);
}

const char* policy_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
