// Whole-solve batched Newton-Raphson power flow for large grids
// (npad = 128, 256 or 384 padded buses; case322 has npad = 384).
//
// Replaces mapdn_tpu/pf/pallas_nr.py::_nr_kernel (the Pallas TPU kernel
// behind nr_solve_pallas).  It computes the same packed algorithm as
// mapdn_torch.pf.fused_nr.nr_solve_large_ref:
//   mismatch   cur = [e-1, f] Y + rowsum,  F = (spec - [P, Q]) * mask
//   direction  d = F W, then inner_iters times d += (F - J d) W, J d applied
//              matrix-free through Y
//   update     gated polar update v' = vm (1 + dnu) rot(dth)
//   stop       err = max|F| / s_ref < tol, non-finite err, or max vm^2 > 100
// with lanes on rows and buses on columns: every state array is
// (batch, 2 npad) of [real half | imag half], and the operators act by
// right-multiplication.
//
// What bounds it on an H100: FP32 operations, and the instructions that
// feed them.  The operators do not fit in a block's shared memory (each is
// 768 x 768 float32, 2.36 MB, at case322), so one block of npad threads
// owns 8 lanes for the whole solve: thread b owns bus b (columns b and
// npad + b) of every state vector of its 8 lanes, in registers, and only
// the matvec input of the 8 lanes goes through shared memory (8 x 2 npad
// floats), read as broadcasts.  Each operator element read feeds 8 FMAs,
// one per lane.  The operands are taken where the work is:
//   * Y (0.65 % full at case322) in compressed columns (CSC: row index and
//     value of each nonzero, rows ascending), copied into shared memory once
//     a solve; thread b walks columns b and npad + b.
//   * W only on its live block, the rows and columns [1, n) u [npad + 1,
//     npad + n), where it is dense: a compact (2m, stride) copy, m = n - 1,
//     streamed from L2 with each thread keeping kUnroll rows of loads in
//     flight.  Threads of the slack bus and of padding take no W FMAs.
// A skipped zero term leaves every finite sum as it was (fmaf(0, x, acc)
// == acc up to the sign of a zero), and each sum runs over the nonzeros in
// ascending row order, as the dense product does.  FP32 FMA throughout: no
// TF32 or bf16 (the TPU kernel's bf16-pass direction matmuls raised false
// divergence), precise sincosf, IEEE division.
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

constexpr int kLanes = 8;    // lanes per block; each thread holds all 8
constexpr int kUnroll = 64;  // W rows of loads in flight a thread

struct Params {
  const float* spec;
  const float* v0;
  const int* y_colptr;    // (2 npad + 1,) CSC column pointers of Y
  const int2* y_ent;      // (nnz,) {row, float bits of the value}
  const float* w_live;    // (2m, w_stride)
  const float* rowsum;
  const float* mask;
  float* v_out;
  float* err_out;
  int* it_out;
  int batch, n, nnz, w_stride, max_iter, inner_iters;
  float tol;
};

// Per-lane maxima over the block: every thread passes its own values for
// the 8 lanes and gets the block's maxima back.  `red` is kWarps x kLanes
// floats of shared memory; the caller's next barrier orders its reuse.
template <int NPAD>
__device__ __forceinline__ void block_max(float (&x)[kLanes], float* red) {
  constexpr int kWarps = NPAD / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x[l] = fmaxf(x[l], __shfl_xor_sync(0xffffffffu, x[l], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < kLanes; ++l) red[warp * kLanes + l] = x[l];
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    float m = red[l];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * kLanes + l]);
    x[l] = m;
  }
}

// acc[l] += a * x[k][l] for the 8 lanes, x the (2 NPAD, kLanes) matvec
// input in shared memory
__device__ __forceinline__ void fma_row(float a, const float4* __restrict__ sx4,
                                        int k, float (&acc)[kLanes]) {
  const float4 x0 = sx4[2 * k];
  const float4 x1 = sx4[2 * k + 1];
  const float xs[kLanes] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int l = 0; l < kLanes; ++l) acc[l] = fmaf(a, xs[l], acc[l]);
}

__device__ __forceinline__ void fma_row2(float a_p, float a_q,
                                         const float4* __restrict__ sx4, int k,
                                         float (&acc_p)[kLanes],
                                         float (&acc_q)[kLanes]) {
  const float4 x0 = sx4[2 * k];
  const float4 x1 = sx4[2 * k + 1];
  const float xs[kLanes] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    acc_p[l] = fmaf(a_p, xs[l], acc_p[l]);
    acc_q[l] = fmaf(a_q, xs[l], acc_q[l]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// acc_p/acc_q = (x Y)[:, b] / [:, NPAD + b] from Y's compressed columns in
// shared memory
template <int NPAD>
__device__ __forceinline__ void y_product(const int* __restrict__ colptr,
                                          const int2* __restrict__ ent,
                                          const float4* __restrict__ sx4, int b,
                                          float (&acc_p)[kLanes],
                                          float (&acc_q)[kLanes]) {
  zero(acc_p);
  zero(acc_q);
  for (int j = colptr[b]; j < colptr[b + 1]; ++j) {
    const int2 e = ent[j];
    fma_row(__int_as_float(e.y), sx4, e.x, acc_p);
  }
  for (int j = colptr[NPAD + b]; j < colptr[NPAD + b + 1]; ++j) {
    const int2 e = ent[j];
    fma_row(__int_as_float(e.y), sx4, e.x, acc_q);
  }
}

// (x W)[:, b], [:, NPAD + b] from W's live block, streamed from L2 (threads
// of buses 1 .. m).  The block's layout: (2m, stride) floats.  Row k is the
// input of bus 1 + k for k < m, of NPAD + 1 + k - m (the imaginary half)
// for m <= k < 2m; columns (2j, 2j + 1) are the outputs of bus j + 1 (its
// real and imaginary half), so thread b reads both its coefficients of a
// row with one 8-byte load.
template <int NPAD>
__device__ __forceinline__ void w_product(const float* __restrict__ w,
                                          int stride, int m, bool wlive,
                                          const float4* __restrict__ sx4,
                                          int b, float (&acc_p)[kLanes],
                                          float (&acc_q)[kLanes]) {
  zero(acc_p);
  zero(acc_q);
  if (!wlive) return;
  const float2* col = reinterpret_cast<const float2*>(w + 2 * (b - 1));
  const int s2 = stride / 2;
#pragma unroll kUnroll
  for (int k = 0; k < m; ++k) {
    const float2 a = __ldg(col + k * s2);
    fma_row2(a.x, a.y, sx4, k + 1, acc_p, acc_q);
  }
#pragma unroll kUnroll
  for (int k = m; k < 2 * m; ++k) {
    const float2 a = __ldg(col + k * s2);
    fma_row2(a.x, a.y, sx4, k + NPAD + 1 - m, acc_p, acc_q);
  }
}

// sx[b][l] = p[l], sx[NPAD + b][l] = q[l]
template <int NPAD>
__device__ __forceinline__ void store_x(float4* __restrict__ sx4, int b,
                                        const float (&p)[kLanes],
                                        const float (&q)[kLanes]) {
  sx4[2 * b] = make_float4(p[0], p[1], p[2], p[3]);
  sx4[2 * b + 1] = make_float4(p[4], p[5], p[6], p[7]);
  sx4[2 * (NPAD + b)] = make_float4(q[0], q[1], q[2], q[3]);
  sx4[2 * (NPAD + b) + 1] = make_float4(q[4], q[5], q[6], q[7]);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// dynamic shared memory: [Y colptr][Y entries]
__host__ __device__ inline int y_bytes(int npad, int nnz) {
  return round_up((2 * npad + 1) * 4, 16) + nnz * 8;
}

template <int NPAD>
__global__ void __launch_bounds__(NPAD, 1) nr_large_kernel(const Params p) {
  constexpr int M = 2 * NPAD;
  constexpr int kWarps = NPAD / 32;
  constexpr unsigned kAll = (1u << kLanes) - 1;
  __shared__ float4 sx4[M * kLanes / 4];       // (M, kLanes) matvec input
  __shared__ float sred[3][kWarps * kLanes];   // per-warp partial maxima
  __shared__ float s_ref[kLanes];
  __shared__ int s_niter[kLanes];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int b = threadIdx.x;                  // this thread's bus
  const int row0 = blockIdx.x * kLanes;
  const int m = p.n - 1;
  const bool wlive = b >= 1 && b <= m;

  int* colptr = reinterpret_cast<int*>(dyn);
  int2* ent = reinterpret_cast<int2*>(dyn + round_up((M + 1) * 4, 16));
  for (int i = b; i <= M; i += NPAD) colptr[i] = p.y_colptr[i];
  for (int i = b; i < p.nnz; i += NPAD) ent[i] = p.y_ent[i];

  // lanes past the batch run as done flat no-load lanes (not stored)
  float e[kLanes], f[kLanes];
  unsigned done = 0;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const long r = row0 + l;
    const bool live = r < p.batch;
    e[l] = live ? p.v0[r * M + b] : 1.f;
    f[l] = live ? p.v0[r * M + NPAD + b] : 0.f;
    done |= live ? 0u : 1u << l;
  }

  // the masked specified injections of lane l at this thread's bus
  auto spec_at = [&](int l, float& sp, float& sq) {
    const long r = row0 + l;
    const bool live = r < p.batch;
    sp = live ? __ldg(p.spec + r * M + b) * __ldg(p.mask + b) : 0.f;
    sq = live ? __ldg(p.spec + r * M + NPAD + b) * __ldg(p.mask + NPAD + b) : 0.f;
  };

  {  // s_ref = max(max |spec|, 1) per lane
    float sr[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      float sp, sq;
      spec_at(l, sp, sq);
      sr[l] = fmaxf(fabsf(sp), fabsf(sq));
    }
    block_max<NPAD>(sr, sred[0]);
    if (b < kLanes) {
      s_ref[b] = fmaxf(sr[b], 1.f);
      s_niter[b] = 0;
    }
  }

  float ir[kLanes], ii[kLanes], fp[kLanes], fq[kLanes], err[kLanes];

  // cur = [e-1, f] Y + rowsum; F = (spec - [P, Q]) * mask; err; returns the
  // lanes with max vm^2 > 100.  Entered after a barrier that orders the last
  // reads of sx and sred.
  auto mismatch = [&]() -> unsigned {
    float tp[kLanes], tq[kLanes], nonfinite[kLanes], vm2max[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      tp[l] = e[l] - 1.f;
      tq[l] = f[l];
    }
    store_x<NPAD>(sx4, b, tp, tq);
    __syncthreads();
    y_product<NPAD>(colptr, ent, sx4, b, ir, ii);
    const float mk_p = __ldg(p.mask + b), mk_q = __ldg(p.mask + NPAD + b);
    const float rs_p = __ldg(p.rowsum + b), rs_q = __ldg(p.rowsum + NPAD + b);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      float sp, sq;
      spec_at(l, sp, sq);
      ir[l] += rs_p;
      ii[l] += rs_q;
      fp[l] = (sp - (e[l] * ir[l] + f[l] * ii[l])) * mk_p;
      fq[l] = (sq - (f[l] * ir[l] - e[l] * ii[l])) * mk_q;
      nonfinite[l] = (!isfinite(fp[l]) || !isfinite(fq[l])) ? 1.f : 0.f;
      err[l] = fmaxf(fabsf(fp[l]), fabsf(fq[l]));
      vm2max[l] = e[l] * e[l] + f[l] * f[l];
    }
    block_max<NPAD>(err, sred[0]);
    block_max<NPAD>(nonfinite, sred[1]);
    block_max<NPAD>(vm2max, sred[2]);
    unsigned big = 0;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      err[l] = nonfinite[l] > 0.f ? __int_as_float(0x7fc00000) : err[l] / s_ref[l];
      big |= vm2max[l] > 100.f ? 1u << l : 0u;
    }
    return big;
  };

  __syncthreads();   // Y in shared memory; s_ref written
  mismatch();
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
    done |= err[l] < p.tol ? 1u << l : 0u;   // NaN compares false: not done

  for (int it = 0; it < p.max_iter; ++it) {
    // barrier: also orders this iteration's shared writes after last reads
    if (!__syncthreads_or(done != kAll)) break;

    // Newton direction by preconditioned Richardson
    float dth[kLanes], dnu[kLanes], tp[kLanes], tq[kLanes];
    store_x<NPAD>(sx4, b, fp, fq);
    __syncthreads();
    w_product<NPAD>(p.w_live, p.w_stride, m, wlive, sx4, b, dth, dnu);
    for (int k = 0; k < p.inner_iters; ++k) {
      float de[kLanes], df[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        de[l] = -f[l] * dth[l] + e[l] * dnu[l];
        df[l] = e[l] * dth[l] + f[l] * dnu[l];
      }
      __syncthreads();
      store_x<NPAD>(sx4, b, de, df);
      __syncthreads();
      y_product<NPAD>(colptr, ent, sx4, b, tp, tq);   // [dIr, dIi]
      const float mk_p = __ldg(p.mask + b), mk_q = __ldg(p.mask + NPAD + b);
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const float jp = (de[l] * ir[l] + e[l] * tp[l] + df[l] * ii[l] + f[l] * tq[l]) * mk_p;
        const float jq = (df[l] * ir[l] + f[l] * tp[l] - de[l] * ii[l] - e[l] * tq[l]) * mk_q;
        tp[l] = fp[l] - jp;
        tq[l] = fq[l] - jq;
      }
      __syncthreads();
      store_x<NPAD>(sx4, b, tp, tq);
      __syncthreads();
      w_product<NPAD>(p.w_live, p.w_stride, m, wlive, sx4, b, tp, tq);
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        dth[l] += tp[l];
        dnu[l] += tq[l];
      }
    }

    // gated polar update: a done lane is an exact no-op
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const bool dl = done >> l & 1u;
      const float gate = dl ? 0.f : 1.f;
      if (b == 0 && !dl) ++s_niter[l];
      float s, c;
      sincosf(gate * dth[l], &s, &c);
      const float scale = 1.f + gate * dnu[l];
      const float e2 = scale * (e[l] * c - f[l] * s);
      const float f2 = scale * (f[l] * c + e[l] * s);
      e[l] = e2;
      f[l] = f2;
    }
    __syncthreads();   // last W-matvec reads of sx precede the mismatch writes
    const unsigned big = mismatch();
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const bool stop = !isfinite(err[l]) || err[l] < p.tol;
      done |= stop ? 1u << l : 0u;
    }
    done |= big;
  }

#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const long r = row0 + l;
    if (r >= p.batch) continue;
    p.v_out[r * M + b] = e[l];
    p.v_out[r * M + NPAD + b] = f[l];
    if (b == 0) {
      p.err_out[r] = err[l];
      p.it_out[r] = s_niter[l];
    }
  }
}

template <int NPAD>
int launch(const Params& p, cudaStream_t stream) {
  const int dyn = y_bytes(NPAD, p.nnz);
  // static and dynamic shared memory together pass 48 KB: raise the
  // instance's limit once, and again only for a grid with more nonzeros
  static int smem_set = 0;
  if (dyn > smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nr_large_kernel<NPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = dyn;
  }
  const int blocks = (p.batch + kLanes - 1) / kLanes;
  nr_large_kernel<NPAD><<<blocks, NPAD, dyn, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int NPAD>
int config(int nnz, int* cfg) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, nr_large_kernel<NPAD>);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cfg[0] = y_bytes(NPAD, nnz);
  cfg[1] = static_cast<int>(attr.sharedSizeBytes);
  cfg[2] = attr.numRegs;
  cfg[3] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" {

// All arrays on the device, row-major, float32 unless named: spec/v0/v_out
// (batch, 2 npad); y_colptr int32 (2 npad + 1,) and y_ent int32 (nnz, 2)
// {row, float bits}: Y's compressed columns; w_live (2 (n - 1), w_stride);
// rowsum/mask (2 npad,); err_out float32 and it_out int32 (batch,).
// Returns the cudaError_t of the launch (0 = ok).
int nr_large_launch(const float* spec, const float* v0, const int* y_colptr,
                    const int* y_ent, const float* w_live, const float* rowsum,
                    const float* mask, float* v_out, float* err_out,
                    int* it_out, int batch, int npad, int n, int nnz,
                    int w_stride, float tol, int max_iter, int inner_iters,
                    void* stream) {
  if (n < 2 || n > npad || w_stride % 4 || w_stride < 2 * (n - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0) return 0;
  const Params p{spec, v0, y_colptr, reinterpret_cast<const int2*>(y_ent),
                 w_live, rowsum, mask, v_out, err_out, it_out, batch, n, nnz,
                 w_stride, max_iter, inner_iters, tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npad) {
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    case 384: return launch<384>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel instance of `npad` for a Y of `nnz` nonzeros: cfg receives
// {dynamic shared memory bytes, static shared memory bytes, registers a
// thread, local memory bytes a thread (stack frame and spills)}.  Returns a cudaError_t (0 = ok).
int nr_large_config(int npad, int nnz, int* cfg) {
  switch (npad) {
    case 128: return config<128>(nnz, cfg);
    case 256: return config<256>(nnz, cfg);
    case 384: return config<384>(nnz, cfg);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* nr_large_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
