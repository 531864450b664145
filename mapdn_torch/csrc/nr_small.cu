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
// What bounds it on an H100: operations.  Per lane and Newton iteration the
// function needs 8 products with the operators, ~36 kFLOP at case33 counted
// on their nonzeros (Y is about a tenth full), against ~1 KB of
// device-memory traffic per lane for the whole solve, so it sits far above
// the FP32 ridge point.  The kernel runs the products dense on the padded
// (2nb x 2nb) operators, ~102 kFLOP at nb = 40.  The design keeps every
// byte after the first read on chip: one block owns 32 lanes for the whole
// solve, both operators (2 x 25.6 KB at nb = 40) sit in shared memory, the
// per-lane state lives in registers (each thread owns nb/8 buses of one lane,
// both halves), and only the matvec input goes through shared memory.  The
// operator reads are warp-wide broadcasts (all 32 lanes of a warp share the
// row), the input reads are conflict-free rows.  FP32 FMA throughout: no
// TF32 or bf16 (the TPU kernel's bf16-pass direction matmuls raised false
// divergence), precise sincosf, IEEE division.
//
// Lanes are independent: a finished lane is gated to an exact no-op
// (cos 0 = 1, sin 0 = 0, scale 1), so results do not depend on how lanes are
// grouped into blocks, and a block stops as soon as all its lanes are done.
// fmaxf drops NaN where jnp.max propagates it, so a non-finite mismatch is
// carried as an explicit flag and reported as err = NaN (never converged).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;            // lanes per block: one warp wide
constexpr int kWarps = 8;             // buses are dealt round-robin to 8 warps
constexpr int kThreads = kLanes * kWarps;

// acc_p/acc_q[r] = (A x)[row b_r] / (A x)[row NB + b_r] for this thread's lane,
// x the (M, kLanes) matvec input in shared memory.
template <int NBT>
__device__ __forceinline__ void matvec(const float* __restrict__ a,
                                       const float* __restrict__ sx, int warp,
                                       int lane, float (&acc_p)[NBT],
                                       float (&acc_q)[NBT]) {
  constexpr int NB = kWarps * NBT;
  constexpr int M = 2 * NB;
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    acc_p[r] = 0.f;
    acc_q[r] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < M; ++k) {
    const float x = sx[k * kLanes + lane];
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      const int b = warp + kWarps * r;
      acc_p[r] = fmaf(a[b * M + k], x, acc_p[r]);
      acc_q[r] = fmaf(a[(NB + b) * M + k], x, acc_q[r]);
    }
  }
}

template <int NBT>
__device__ __forceinline__ void store_x(float* __restrict__ sx, int warp,
                                        int lane, const float (&p)[NBT],
                                        const float (&q)[NBT]) {
  constexpr int NB = kWarps * NBT;
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int b = warp + kWarps * r;
    sx[b * kLanes + lane] = p[r];
    sx[(NB + b) * kLanes + lane] = q[r];
  }
}

template <int NBT>
__global__ void __launch_bounds__(kThreads)
nr_small_kernel(const float* __restrict__ spec, const float* __restrict__ v0,
                const float* __restrict__ ymat, const float* __restrict__ wmat,
                const float* __restrict__ rowsum, const float* __restrict__ mask,
                float* __restrict__ v_out, float* __restrict__ err_out,
                int* __restrict__ it_out, int batch, float tol, int max_iter,
                int inner_iters) {
  constexpr int NB = kWarps * NBT;
  constexpr int M = 2 * NB;
  extern __shared__ float smem[];
  float* sy = smem;                      // (M, M) Y
  float* sw = sy + M * M;                // (M, M) W
  float* sx = sw + M * M;                // (M, kLanes) matvec input
  float* srs = sx + M * kLanes;          // (M,) rowsum
  float* smk = srs + M;                  // (M,) mask
  float* sred = smk + M;                 // 3 x (kWarps, kLanes) partials

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int col = blockIdx.x * kLanes + lane;
  const bool live = col < batch;

  for (int i = threadIdx.x; i < M * M; i += kThreads) {
    sy[i] = ymat[i];
    sw[i] = wmat[i];
  }
  for (int i = threadIdx.x; i < M; i += kThreads) {
    srs[i] = rowsum[i];
    smk[i] = mask[i];
  }

  // this thread's buses b_r = warp + 8 r of lane `col`, real and imag halves;
  // lanes past the batch run as flat no-load lanes (done at once, not stored)
  float e[NBT], f[NBT], sp[NBT], sq[NBT];
#pragma unroll
  for (int r = 0; r < NBT; ++r) {
    const int b = warp + kWarps * r;
    e[r] = live ? v0[b * batch + col] : 1.f;
    f[r] = live ? v0[(NB + b) * batch + col] : 0.f;
    sp[r] = live ? spec[b * batch + col] * mask[b] : 0.f;
    sq[r] = live ? spec[(NB + b) * batch + col] * mask[NB + b] : 0.f;
  }
  __syncthreads();

  float* red_f = sred;                       // max |F| (or |spec|)
  float* red_nf = sred + kWarps * kLanes;    // any non-finite |F|
  float* red_v = sred + 2 * kWarps * kLanes;  // max vm^2

  // s_ref = max(max |spec|, 1) per lane
  float s_ref;
  {
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < NBT; ++r) m = fmaxf(m, fmaxf(fabsf(sp[r]), fabsf(sq[r])));
    red_f[warp * kLanes + lane] = m;
    __syncthreads();
    m = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_f[w * kLanes + lane]);
    s_ref = fmaxf(m, 1.f);
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
    store_x<NBT>(sx, warp, lane, tp, tq);
    __syncthreads();
    matvec<NBT>(sy, sx, warp, lane, ir, ii);
    float m = 0.f, vmax = 0.f, nonfinite = 0.f;
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      const int b = warp + kWarps * r;
      ir[r] += srs[b];
      ii[r] += srs[NB + b];
      fp[r] = (sp[r] - (e[r] * ir[r] + f[r] * ii[r])) * smk[b];
      fq[r] = (sq[r] - (f[r] * ir[r] - e[r] * ii[r])) * smk[NB + b];
      if (!isfinite(fp[r]) || !isfinite(fq[r])) nonfinite = 1.f;
      m = fmaxf(m, fmaxf(fabsf(fp[r]), fabsf(fq[r])));
      vmax = fmaxf(vmax, e[r] * e[r] + f[r] * f[r]);
    }
    red_f[warp * kLanes + lane] = m;
    red_nf[warp * kLanes + lane] = nonfinite;
    red_v[warp * kLanes + lane] = vmax;
    __syncthreads();
    m = 0.f;
    vmax = 0.f;
    nonfinite = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      m = fmaxf(m, red_f[w * kLanes + lane]);
      nonfinite = fmaxf(nonfinite, red_nf[w * kLanes + lane]);
      vmax = fmaxf(vmax, red_v[w * kLanes + lane]);
    }
    err = nonfinite > 0.f ? __int_as_float(0x7fc00000) : m / s_ref;
    vm2max = vmax;
  };

  mismatch();
  bool done = err < tol;   // NaN compares false: a NaN lane is not done
  int niter = 0;

  for (int it = 0; it < max_iter; ++it) {
    // barrier: also orders this iteration's shared writes after last reads
    if (!__syncthreads_or(!done)) break;

    // Newton direction by preconditioned Richardson
    float dth[NBT], dnu[NBT], tp[NBT], tq[NBT];
    store_x<NBT>(sx, warp, lane, fp, fq);
    __syncthreads();
    matvec<NBT>(sw, sx, warp, lane, dth, dnu);
    for (int k = 0; k < inner_iters; ++k) {
      float de[NBT], df[NBT];
#pragma unroll
      for (int r = 0; r < NBT; ++r) {
        de[r] = -f[r] * dth[r] + e[r] * dnu[r];
        df[r] = e[r] * dth[r] + f[r] * dnu[r];
      }
      __syncthreads();
      store_x<NBT>(sx, warp, lane, de, df);
      __syncthreads();
      matvec<NBT>(sy, sx, warp, lane, tp, tq);   // [dIr; dIi]
#pragma unroll
      for (int r = 0; r < NBT; ++r) {
        const int b = warp + kWarps * r;
        const float jp = (de[r] * ir[r] + e[r] * tp[r] + df[r] * ii[r] + f[r] * tq[r]) * smk[b];
        const float jq = (df[r] * ir[r] + f[r] * tp[r] - de[r] * ii[r] - e[r] * tq[r]) * smk[NB + b];
        tp[r] = fp[r] - jp;
        tq[r] = fq[r] - jq;
      }
      __syncthreads();
      store_x<NBT>(sx, warp, lane, tp, tq);
      __syncthreads();
      matvec<NBT>(sw, sx, warp, lane, tp, tq);
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
    __syncthreads();   // last W-matvec reads of sx precede the mismatch writes
    mismatch();
    const bool stop = !isfinite(err) || err < tol || vm2max > 100.f;
    done = done || stop;
  }

  if (live) {
#pragma unroll
    for (int r = 0; r < NBT; ++r) {
      const int b = warp + kWarps * r;
      v_out[b * batch + col] = e[r];
      v_out[(NB + b) * batch + col] = f[r];
    }
    if (warp == 0) {
      err_out[col] = err;
      it_out[col] = niter;
    }
  }
}

template <int NBT>
int launch(const float* spec, const float* v0, const float* ymat,
           const float* wmat, const float* rowsum, const float* mask,
           float* v_out, float* err_out, int* it_out, int batch, float tol,
           int max_iter, int inner_iters, cudaStream_t stream) {
  constexpr int M = 2 * kWarps * NBT;
  const size_t smem =
      (2 * M * M + M * kLanes + 2 * M + 3 * kWarps * kLanes) * sizeof(float);
  // the shared-memory size is fixed per instance: set the attribute once
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        nr_small_kernel<NBT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    smem_set = true;
  }
  const int blocks = (batch + kLanes - 1) / kLanes;
  nr_small_kernel<NBT><<<blocks, kThreads, smem, stream>>>(
      spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol,
      max_iter, inner_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All arrays float32 (it_out int32) on the device, row-major:
// spec/v0/v_out (2nb, batch), ymat/wmat (2nb, 2nb), rowsum/mask (2nb,),
// err_out/it_out (batch,).  Returns the cudaError_t of the launch (0 = ok).
int nr_small_launch(const float* spec, const float* v0, const float* ymat,
                    const float* wmat, const float* rowsum, const float* mask,
                    float* v_out, float* err_out, int* it_out, int batch,
                    int nb, float tol, int max_iter, int inner_iters,
                    void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 8:  return launch<1>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 16: return launch<2>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 24: return launch<3>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 32: return launch<4>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 40: return launch<5>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 48: return launch<6>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 56: return launch<7>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 64: return launch<8>(spec, v0, ymat, wmat, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* nr_small_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
