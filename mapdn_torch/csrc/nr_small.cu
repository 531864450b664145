// Whole-solve batched Newton-Raphson power flow for small grids (nb <= 64).
//
// Replaces mapdn_tpu/pf/pallas_nr.py::_nr_kernel_small (the Pallas TPU
// kernel behind nr_solve_pallas_small).  It computes the same packed
// algorithm as mapdn_torch.pf.fused_nr.nr_solve_small_ref:
//   mismatch   cur = Y [e-1; f] + rowsum,  F = (spec - [P; Q]) * mask
//   direction  d = W F, then inner_iters times d += W (F - J d), J d applied
//              matrix-free through Y
//   update     gated polar update v' = vm (1 + dnu) rot(dth)
//   stop       err = max|F| / s_ref < tol, non-finite err, or max vm^2 > 100
// with buses on rows and lanes on columns: every state array is (2nb, batch).
//
// What bounds it on an H100: operations, and the instructions that issue
// them.  Per lane and Newton iteration the function needs 8 products with
// the operators, ~36 kFLOP at case33 counted on their nonzeros, against
// ~1 KB of device-memory traffic per lane for the whole solve.  One block
// owns 32 lanes for the whole solve: each thread holds nb/8 buses of one
// lane (both halves) in registers, the operators sit in shared memory, and
// only the matvec inputs go through shared memory, Y's and W's in buffers
// of their own (10 barriers a Newton iteration instead of 17).  With 8192
// lanes there are two blocks (16 warps) an SM, so the products are paced
// by the issue of shared loads and FMAs and by how much of their latency
// 16 warps hide; the W products take three fifths of a Newton iteration,
// about half of that waiting on their coefficient loads (PERF.md).  The
// design cuts the work to the operators' nonzeros and keeps the inner
// loops free of branches:
//   * Buses are dealt to thread slots s = warp + 8 r as bus (s + 1) mod nb:
//     the live buses 1 .. n-1 fill the low slots, the padding and the slack
//     bus the high ones.  At case33 every warp holds 4 live buses and a
//     fifth slot that is dead in every warp.
//   * Y (about 6 % full at case33, a radial feeder) by compressed rows,
//     paired by bus: bus b's entries are the union of the columns of its two
//     rows b and nb + b (at case33 they hold the same columns), ascending,
//     each with both rows' values, copied into shared memory once a solve
//     with the column turned into a byte offset of the matvec input.  The 32
//     threads of a warp share their output rows, so the entry is a
//     broadcast and the input read x[col][lane] is conflict-free, and one of
//     each feeds two FMAs.
//   * W only on its live block, rows and columns [1, n) u [nb + 1, nb + n)
//     (outside it W is zero: the slack bus and the padding), dense there,
//     rows padded to 16 bytes, plus one zero row in shared memory.  The two
//     threads of lanes 2i and 2i + 1 share both lanes: the even one takes
//     the real-half rows of the warp's slots, the odd one the imaginary-half
//     rows, each for both lanes, 4 input columns at a time (two 16-byte
//     loads of the two lanes' inputs, the W input laid out (j/4, lane, 4)
//     over the live index j, and per slot one 16-byte load of its row's 4
//     coefficients for 8 FMAs), and a shuffle swaps the halves at the end.
//     Each coefficient load feeds both lanes; the imaginary-half rows start
//     16 bytes past a row boundary, so that a pair's two rows are read from
//     different banks.  A dead slot reads the zero row; the last slot group
//     is skipped when it is dead in every warp (at case33: 6 loads for 32
//     FMAs per 4 columns), and a warp with no live slot takes no W FMAs.
// A skipped zero term leaves every finite sum as it was (fmaf(0, x, acc) ==
// acc up to the sign of a zero), and every sum runs over the nonzero terms
// in ascending column order, as the dense product does, so on finite lanes
// the results are those of the dense products.
//
// Numbers: FP32 FMA throughout, precise sincosf, IEEE division.  The W
// products (a 64 x 64 by 64 x 32 product a block at case33) are not put on
// the tensor cores: TF32 or bf16 inputs lose the accuracy the port holds
// (the TPU kernel's bf16-pass direction raised false divergence from 2e-6 to
// 5e-5, pallas_nr.py:583-584), and 3xTF32 emulation is not tried here.
//
// Lanes are independent: a finished lane is gated to an exact no-op
// (cos 0 = 1, sin 0 = 0, scale 1), each lane's sums run in the same order
// whatever lanes share its block, and a block stops as soon as all its lanes
// are done.  fmaxf drops NaN where jnp.max propagates it, so a non-finite
// mismatch is carried as an explicit flag and reported as err = NaN (never
// converged).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;            // lanes per block: one warp wide
constexpr int kWarps = 8;             // buses are dealt round-robin to 8 warps
constexpr int kThreads = kLanes * kWarps;

struct Params {
  const float* spec;
  const float* v0;
  const int* y_busptr;    // (nb + 1,) pointers of Y's bus rows
  const int4* y_ent;      // (nnz,) {column, bits of row b, of row nb + b, 0}
  const float4* w_live;   // (2m, w_stride) floats, m = n - 1
  const float* rowsum;
  const float* mask;
  float* v_out;
  float* err_out;
  int* it_out;
  int batch, n, nnz, w_stride, max_iter, inner_iters;
  float tol;
};

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// dynamic shared memory, in this order, each part 16-byte aligned:
// W's live block (2m, w_stride), its imaginary-half rows shifted by 16
// bytes, and one zero row; Y's matvec input
// (2 nb, kLanes); W's matvec input (w_stride, kLanes); rowsum and mask
// (2 nb each); 3 x (kWarps, kLanes) partial maxima; Y's bus pointers
// (nb + 1) and entries (nnz int4, the column as a byte offset into Y's
// input).  The two inputs have buffers of their own, so that writing
// one never waits for the reads of the other.
struct Layout {
  int sx, sxw, srs, sred, busptr, ent, bytes;
  __host__ __device__ Layout(int nb, int n, int nnz, int w_stride) {
    const int m2 = 2 * nb;
    sx = 4 * (2 * (n - 1) + 1) * w_stride + 16;
    sxw = sx + 4 * kLanes * m2;
    srs = sxw + 4 * kLanes * w_stride;
    sred = srs + 8 * m2;
    busptr = sred + 4 * 3 * kWarps * kLanes;
    ent = busptr + round_up(4 * (nb + 1), 16);
    bytes = ent + 16 * nnz;
  }
};

// Thread slot s = warp + 8 r holds bus (s + 1) mod NB: the live buses
// 1 .. m (m = n - 1) take the slots below m, the padding and the slack bus
// the slots from m on, so that the W rows a warp skips are its last ones
template <int NB>
__device__ __forceinline__ int bus_of(int warp, int r) {
  const int s = warp + kWarps * r;
  return s + 1 < NB ? s + 1 : 0;
}

// acc_p/acc_q[r] = (Y x)[row b_r] / [row NB + b_r], x the (2 NB, kLanes)
// matvec input in shared memory, from Y's bus rows: bus b's entries are
// the union of the columns of its two rows, ascending, each {byte offset
// col * kLanes * 4 of x[col][0], bits of Y[b][col], bits of Y[NB + b][col],
// 0}.  One broadcast entry load and one x load feed both rows' FMAs; a
// column that only one row holds adds an exact zero term to the other.
template <int NBT>
__device__ __forceinline__ void y_product(const int* __restrict__ busptr,
                                          const int4* __restrict__ ent,
                                          const float* __restrict__ sx,
                                          int warp, int lane,
                                          float (&acc_p)[NBT],
                                          float (&acc_q)[NBT]) {
  constexpr int NB = kWarps * NBT;
  const char* sx_lane = reinterpret_cast<const char*>(sx + lane);
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int b = bus_of<NB>(warp, r);
    float ap = 0.f, aq = 0.f;
    const int j1 = busptr[b + 1];
#pragma unroll 2
    for (int j = busptr[b]; j < j1; ++j) {
      const int4 e = ent[j];
      const float x = *reinterpret_cast<const float*>(sx_lane + e.x);
      ap = fmaf(__int_as_float(e.y), x, ap);
      aq = fmaf(__int_as_float(e.z), x, aq);
    }
    acc_p[r] = ap;
    acc_q[r] = aq;
  }
}

// acc_p/acc_q[r] = (W x)[row b_r] / [row NB + b_r] from W's live block in
// shared memory, input columns in ascending live order, 4 at a time.  Row
// offsets wrow (in float4) point at the real-half rows of the slots for an
// even thread, the imaginary-half rows for an odd one, or at the zero row
// for a dead slot; the first R slots of each warp are computed, the rest
// are dead in every warp (zero).  sxw4 is the live input laid out (j/4,
// lane, 4); its entries past 2m are zeros, as are W's padding columns.  No
// branch inside: the loads of a chunk are independent of its FMAs.
template <int NBT, int R>
__device__ __forceinline__ void w_product(const float4* __restrict__ sw4,
                                          int stride4, const int (&wrow)[NBT],
                                          const float4* __restrict__ sxw4,
                                          int lane, float (&acc_p)[NBT],
                                          float (&acc_q)[NBT]) {
  // lanes 2i and 2i + 1 are shared by a thread pair: the even thread takes
  // the real-half rows (wrow = the p rows), the odd one the imaginary-half
  // rows, each for both lanes, so that each coefficient load feeds 8 FMAs
  const int l0 = lane & ~1;
  const bool odd = lane & 1;
  float a0[NBT], a1[NBT];
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    a0[r] = 0.f;
    a1[r] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < stride4; ++c) {
    const float4 x0 = sxw4[c * kLanes + l0];
    const float4 x1 = sxw4[c * kLanes + l0 + 1];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = sw4[wrow[r] + c];
      a0[r] = fmaf(a.x, x0.x, a0[r]);
      a0[r] = fmaf(a.y, x0.y, a0[r]);
      a0[r] = fmaf(a.z, x0.z, a0[r]);
      a0[r] = fmaf(a.w, x0.w, a0[r]);
      a1[r] = fmaf(a.x, x1.x, a1[r]);
      a1[r] = fmaf(a.y, x1.y, a1[r]);
      a1[r] = fmaf(a.z, x1.z, a1[r]);
      a1[r] = fmaf(a.w, x1.w, a1[r]);
    }
  }
  // swap: each thread keeps its own lane's sum and gives its partner's
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const float mine = odd ? a1[r] : a0[r];
    const float recv = __shfl_xor_sync(0xffffffffu, odd ? a0[r] : a1[r], 1);
    acc_p[r] = odd ? recv : mine;
    acc_q[r] = odd ? mine : recv;
  }
}

// Y's input: sx[row][lane] for rows b_r and NB + b_r
template <int NBT>
__device__ __forceinline__ void store_y(float* __restrict__ sx, int warp,
                                        int lane, const float (&p)[NBT],
                                        const float (&q)[NBT]) {
  constexpr int NB = kWarps * NBT;
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int b = bus_of<NB>(warp, r);
    sx[b * kLanes + lane] = p[r];
    sx[(NB + b) * kLanes + lane] = q[r];
  }
}

__device__ __forceinline__ int w_slot(int j, int lane) {
  return (j / 4 * kLanes + lane) * 4 + j % 4;
}

// W's input on the live index: j = s for the real half of the bus of live
// slot s = warp + 8 r < m, m + s for its imaginary half, laid out (j/4,
// lane, 4); the padding entries j in [2m, stride) stay zero
template <int NBT>
__device__ __forceinline__ void store_w(float* __restrict__ sxw, int warp,
                                        int lane, int m,
                                        const float (&p)[NBT],
                                        const float (&q)[NBT]) {
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int s = warp + kWarps * r;
    if (s < m) {
      sxw[w_slot(s, lane)] = p[r];
      sxw[w_slot(m + s, lane)] = q[r];
    }
  }
}

// Two blocks an SM (128 registers a thread) up to nb = 40: 8192 lanes are
// 256 blocks, which then run in one wave on 132 SMs
template <int NBT>
__global__ void __launch_bounds__(kThreads, NBT <= 5 ? 2 : 1)
    nr_small_kernel(const Params p) {
  constexpr int NB = kWarps * NBT;
  constexpr int M = 2 * NB;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(NB, p.n, p.nnz, p.w_stride);
  float4* sw4 = reinterpret_cast<float4*>(smem);
  float* sx = reinterpret_cast<float*>(smem + lay.sx);
  float* sxw = reinterpret_cast<float*>(smem + lay.sxw);
  float* srs = reinterpret_cast<float*>(smem + lay.srs);   // (M,) rowsum
  float* smk = srs + M;                                     // (M,) mask
  float* sred = reinterpret_cast<float*>(smem + lay.sred);
  int* busptr = reinterpret_cast<int*>(smem + lay.busptr);
  int4* ent = reinterpret_cast<int4*>(smem + lay.ent);

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int col = blockIdx.x * kLanes + lane;
  const bool in_batch = col < p.batch;
  const int m = p.n - 1;
  const int stride4 = p.w_stride / 4;

  // the imaginary-half rows start 16 bytes later than a row boundary, so
  // that a pair's two rows sit in different banks
  for (int i = threadIdx.x; i < 2 * m * stride4; i += kThreads)
    sw4[i < m * stride4 ? i : i + 1] = p.w_live[i];
  for (int i = threadIdx.x; i < stride4; i += kThreads)
    sw4[2 * m * stride4 + 1 + i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i <= NB; i += kThreads) busptr[i] = p.y_busptr[i];
  for (int i = threadIdx.x; i < p.nnz; i += kThreads) {
    const int4 e = p.y_ent[i];
    ent[i] = make_int4(e.x * kLanes * 4, e.y, e.z, 0);
  }
  for (int i = threadIdx.x; i < M; i += kThreads) {
    srs[i] = p.rowsum[i];
    smk[i] = p.mask[i];
  }
  if (warp == 0) {   // W's input past the live index
    for (int j = 2 * m; j < p.w_stride; ++j) sxw[w_slot(j, lane)] = 0.f;
  }

  // W's rows of this thread's slots (float4 offsets): live row s (even
  // thread) or m + s (odd) for a live slot s < m, the zero row for a dead one
  int wrow[NBT];
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int s = warp + kWarps * r;
    wrow[r] = s >= m ? 2 * m * stride4 + 1
                     : (lane & 1) ? (m + s) * stride4 + 1 : s * stride4;
  }
  // a warp whose slots are all dead takes no W FMAs; the last slot group
  // is computed only where some warp holds a live bus in it
  const bool w_live_warp = warp < m;
  const bool w_full = m > kWarps * (NBT - 1);
  auto w_product_all = [&](float (&acc_p)[NBT], float (&acc_q)[NBT]) {
    const float4* sxw4 = reinterpret_cast<const float4*>(sxw);
    if (!w_live_warp)
      w_product<NBT, 0>(sw4, stride4, wrow, sxw4, lane, acc_p, acc_q);
    else if (w_full)
      w_product<NBT, NBT>(sw4, stride4, wrow, sxw4, lane, acc_p, acc_q);
    else
      w_product<NBT, NBT - 1>(sw4, stride4, wrow, sxw4, lane, acc_p, acc_q);
  };

  // this thread's buses b_r of lane `col`, real and imag halves; lanes past
  // the batch run as flat no-load lanes (done at once, not stored)
  float e[NBT], f[NBT], sp[NBT], sq[NBT];
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int b = bus_of<NB>(warp, r);
    e[r] = in_batch ? p.v0[b * p.batch + col] : 1.f;
    f[r] = in_batch ? p.v0[(NB + b) * p.batch + col] : 0.f;
    sp[r] = in_batch ? p.spec[b * p.batch + col] * p.mask[b] : 0.f;
    sq[r] = in_batch ? p.spec[(NB + b) * p.batch + col] * p.mask[NB + b] : 0.f;
  }

  float* red_f = sred;                       // max |F| (or |spec|)
  float* red_nf = sred + kWarps * kLanes;    // any non-finite |F|
  float* red_v = sred + 2 * kWarps * kLanes;  // max vm^2

  // s_ref = max(max |spec|, 1) per lane
  float s_ref;
  {
    float mx = 0.f;
#pragma unroll
    for (int r = 0; r < NBT; ++r) mx = fmaxf(mx, fmaxf(fabsf(sp[r]), fabsf(sq[r])));
    red_f[warp * kLanes + lane] = mx;
    __syncthreads();   // also: the operators are in shared memory
    mx = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_f[w * kLanes + lane]);
    s_ref = fmaxf(mx, 1.f);
    __syncthreads();
  }

  float ir[NBT], ii[NBT], fp[NBT], fq[NBT];
  float err, vm2max;

  // cur = Y [e-1; f] + rowsum; F = (spec - [P; Q]) * mask; err, max vm^2
  auto mismatch = [&]() {
    float tp[NBT], tq[NBT];
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      tp[r] = e[r] - 1.f;
      tq[r] = f[r];
    }
    store_y<NBT>(sx, warp, lane, tp, tq);
    __syncthreads();
    y_product<NBT>(busptr, ent, sx, warp, lane, ir, ii);
    float mx = 0.f, vmax = 0.f, nonfinite = 0.f;
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      const int b = bus_of<NB>(warp, r);
      ir[r] += srs[b];
      ii[r] += srs[NB + b];
      fp[r] = (sp[r] - (e[r] * ir[r] + f[r] * ii[r])) * smk[b];
      fq[r] = (sq[r] - (f[r] * ir[r] - e[r] * ii[r])) * smk[NB + b];
      if (!isfinite(fp[r]) || !isfinite(fq[r])) nonfinite = 1.f;
      mx = fmaxf(mx, fmaxf(fabsf(fp[r]), fabsf(fq[r])));
      vmax = fmaxf(vmax, e[r] * e[r] + f[r] * f[r]);
    }
    red_f[warp * kLanes + lane] = mx;
    red_nf[warp * kLanes + lane] = nonfinite;
    red_v[warp * kLanes + lane] = vmax;
    __syncthreads();
    mx = 0.f;
    vmax = 0.f;
    nonfinite = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mx = fmaxf(mx, red_f[w * kLanes + lane]);
      nonfinite = fmaxf(nonfinite, red_nf[w * kLanes + lane]);
      vmax = fmaxf(vmax, red_v[w * kLanes + lane]);
    }
    err = nonfinite > 0.f ? __int_as_float(0x7fc00000) : mx / s_ref;
    vm2max = vmax;
  };

  mismatch();
  bool done = err < p.tol;   // NaN compares false: a NaN lane is not done
  done = done || !in_batch;
  int niter = 0;

  // Every store to an input buffer is ordered after the last reads of that
  // buffer by a barrier in between: the buffer's own barrier before the
  // other product, or the loop's barrier
  for (int it = 0; it < p.max_iter; ++it) {
    if (!__syncthreads_or(!done)) break;

    // Newton direction by preconditioned Richardson
    float dth[NBT], dnu[NBT], tp[NBT], tq[NBT];
    store_w<NBT>(sxw, warp, lane, m, fp, fq);
    __syncthreads();
    w_product_all(dth, dnu);
    for (int k = 0; k < p.inner_iters; ++k) {
      float de[NBT], df[NBT];
#pragma unroll
      for (int r = 0; r < NBT; ++r) {
        de[r] = -f[r] * dth[r] + e[r] * dnu[r];
        df[r] = e[r] * dth[r] + f[r] * dnu[r];
      }
      store_y<NBT>(sx, warp, lane, de, df);
      __syncthreads();
      y_product<NBT>(busptr, ent, sx, warp, lane, tp, tq);   // [dIr; dIi]
#pragma unroll
      for (int r = 0; r < NBT; ++r) {
        const int b = bus_of<NB>(warp, r);
        const float jp = (de[r] * ir[r] + e[r] * tp[r] + df[r] * ii[r] + f[r] * tq[r]) * smk[b];
        const float jq = (df[r] * ir[r] + f[r] * tp[r] - de[r] * ii[r] - e[r] * tq[r]) * smk[NB + b];
        tp[r] = fp[r] - jp;
        tq[r] = fq[r] - jq;
      }
      store_w<NBT>(sxw, warp, lane, m, tp, tq);
      __syncthreads();
      w_product_all(tp, tq);
#pragma unroll
      for (int r = 0; r < NBT; ++r) {
        dth[r] += tp[r];
        dnu[r] += tq[r];
      }
    }

    // gated polar update: a done lane is an exact no-op
    const float gate = done ? 0.f : 1.f;
    niter += done ? 0 : 1;
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      float s, c;
      sincosf(gate * dth[r], &s, &c);
      const float scale = 1.f + gate * dnu[r];
      const float e2 = scale * (e[r] * c - f[r] * s);
      const float f2 = scale * (f[r] * c + e[r] * s);
      e[r] = e2;
      f[r] = f2;
    }
    mismatch();
    const bool stop = !isfinite(err) || err < p.tol || vm2max > 100.f;
    done = done || stop;
  }

  if (in_batch) {
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      const int b = bus_of<NB>(warp, r);
      p.v_out[b * p.batch + col] = e[r];
      p.v_out[(NB + b) * p.batch + col] = f[r];
    }
    if (warp == 0) {
      p.err_out[col] = err;
      p.it_out[col] = niter;
    }
  }
}

template <int NBT>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = Layout(kWarps * NBT, p.n, p.nnz, p.w_stride).bytes;
  // raise the instance's dynamic shared-memory limit once, and again only
  // for a grid that needs more
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nr_small_kernel<NBT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = smem;
  }
  const int blocks = (p.batch + kLanes - 1) / kLanes;
  nr_small_kernel<NBT><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NBT>
int config(const Params& p, int* cfg) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, nr_small_kernel<NBT>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cfg[0] = Layout(kWarps * NBT, p.n, p.nnz, p.w_stride).bytes;
  cfg[1] = static_cast<int>(attr.sharedSizeBytes);
  cfg[2] = attr.numRegs;
  cfg[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// the instance of nb = 8 NBT: launch (cfg null) or report its config
int dispatch(const Params& p, int nb, int* cfg, cudaStream_t s) {
  switch (nb) {
#define NR_SMALL_CASE(NBT) \
    case 8 * NBT: return cfg ? config<NBT>(p, cfg) : launch<NBT>(p, s);
    NR_SMALL_CASE(1) NR_SMALL_CASE(2) NR_SMALL_CASE(3) NR_SMALL_CASE(4)
    NR_SMALL_CASE(5) NR_SMALL_CASE(6) NR_SMALL_CASE(7) NR_SMALL_CASE(8)
#undef NR_SMALL_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid(int nb, int n, int nnz, int w_stride) {
  return n >= 2 && n <= nb && nnz >= 0 && w_stride % 4 == 0 &&
         w_stride >= 2 * (n - 1);
}

}  // namespace

extern "C" {

// All arrays on the device, row-major, float32 unless named: spec/v0/v_out
// (2nb, batch); y_busptr int32 (nb + 1,) and y_ent int32 (nnz, 4) {column,
// bits of row b, bits of row nb + b, 0}: Y's bus rows (the union of the
// columns of rows b and nb + b, ascending); w_live (2 (n - 1), w_stride), W's live
// block with its rows padded to 16 bytes; rowsum/mask (2nb,); err_out
// float32 and it_out int32 (batch,).  Returns the cudaError_t of the launch
// (0 = ok).
int nr_small_launch(const float* spec, const float* v0, const int* y_busptr,
                    const int* y_ent, const float* w_live, const float* rowsum,
                    const float* mask, float* v_out, float* err_out,
                    int* it_out, int batch, int nb, int n, int nnz,
                    int w_stride, float tol, int max_iter, int inner_iters,
                    void* stream) {
  if (!valid(nb, n, nnz, w_stride)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const Params p{spec, v0, y_busptr, reinterpret_cast<const int4*>(y_ent),
                 reinterpret_cast<const float4*>(w_live), rowsum, mask, v_out,
                 err_out, it_out, batch, n, nnz, w_stride, max_iter,
                 inner_iters, tol};
  return dispatch(p, nb, nullptr, static_cast<cudaStream_t>(stream));
}

// The kernel instance of `nb` for a grid of n buses whose Y has `nnz`
// bus-row entries and whose W block has rows of `w_stride` floats: cfg receives
// {dynamic shared memory bytes, static shared memory bytes, registers a
// thread, local memory bytes a thread (stack frame and spills)}.  Returns a
// cudaError_t (0 = ok).
int nr_small_config(int nb, int n, int nnz, int w_stride, int* cfg) {
  if (!valid(nb, n, nnz, w_stride)) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n = n;
  p.nnz = nnz;
  p.w_stride = w_stride;
  return dispatch(p, nb, cfg, nullptr);
}

const char* nr_small_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
