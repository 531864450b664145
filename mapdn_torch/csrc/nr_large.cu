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
// (batch, 2 npad) of [real half | imag half], and the (2 npad, 2 npad)
// operators act by right-multiplication.
//
// What bounds it on an H100: operations, and in this design the L2 traffic
// that feeds them.  Per lane and Newton iteration the function needs 8
// products with the operators; at case322 counted on their nonzeros that is
// about 3.3 MFLOP (Y is 0.65 % full, W 70 %), against about 9 KB of
// device-memory traffic per lane for the whole solve, far above the FP32
// ridge point.  The operators do not fit on chip: each is 768 x 768 float32
// (2.36 MB) at case322, against 227 KB of shared memory a block, but both
// fit in the 50 MB L2.  So one block owns 8 lanes for the whole solve, and
// its per-lane state (v, spec, currents, mismatch, direction: about 30 KB a
// lane) lives in registers: thread b owns bus b, i.e. columns b and
// npad + b, of every state vector of its 8 lanes.  Only the matvec input of
// the 8 lanes goes through shared memory (8 x 2 npad floats, 24.6 KB at
// npad = 384), read as broadcasts.  Each product streams the operator from
// L2 row by row, coalesced across the block's threads, and each element
// loaded feeds 8 FMAs, one per lane.  The products run dense, Y included,
// for all 8 lanes while any of them iterates: at case322 that is about 3x
// the operations the nonzeros need, and each block reads the operator once
// per product, so L2 bandwidth sets the pace.  FP32 FMA throughout: no TF32
// or bf16 (the TPU kernel's bf16-pass direction matmuls raised false
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

constexpr int kLanes = 8;   // lanes per block; each thread holds all 8

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

// acc_p/acc_q[l] = (x A)[lane l, column b] / [lane l, column NPAD + b], with
// x the (2 NPAD, kLanes) matvec input in shared memory (sx[k * kLanes + l])
// and A row-major (2 NPAD, 2 NPAD) in global memory (read through L2).
template <int NPAD>
__device__ __forceinline__ void matvec(const float* __restrict__ a,
                                       const float4* __restrict__ sx4, int b,
                                       float (&acc_p)[kLanes],
                                       float (&acc_q)[kLanes]) {
  constexpr int M = 2 * NPAD;
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    acc_p[l] = 0.f;
    acc_q[l] = 0.f;
  }
  const float* col = a + b;
#pragma unroll 8
  for (int k = 0; k < M; ++k) {
    const float a_p = __ldg(col + k * M);
    const float a_q = __ldg(col + k * M + NPAD);
    const float4 x0 = sx4[2 * k];
    const float4 x1 = sx4[2 * k + 1];
    const float xs[kLanes] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      acc_p[l] = fmaf(a_p, xs[l], acc_p[l]);
      acc_q[l] = fmaf(a_q, xs[l], acc_q[l]);
    }
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

template <int NPAD>
__global__ void __launch_bounds__(NPAD, 1)
nr_large_kernel(const float* __restrict__ spec, const float* __restrict__ v0,
                const float* __restrict__ ypack, const float* __restrict__ wpack,
                const float* __restrict__ rowsum, const float* __restrict__ mask,
                float* __restrict__ v_out, float* __restrict__ err_out,
                int* __restrict__ it_out, int batch, float tol, int max_iter,
                int inner_iters) {
  constexpr int M = 2 * NPAD;
  constexpr int kWarps = NPAD / 32;
  __shared__ float4 sx4[M * kLanes / 4];       // (M, kLanes) matvec input
  __shared__ float sred[3][kWarps * kLanes];   // per-warp partial maxima

  const int b = threadIdx.x;                  // this thread's bus
  const int row0 = blockIdx.x * kLanes;
  const float mk_p = mask[b], mk_q = mask[NPAD + b];
  const float rs_p = rowsum[b], rs_q = rowsum[NPAD + b];

  // lanes past the batch run as done flat no-load lanes (not stored)
  float e[kLanes], f[kLanes], sp[kLanes], sq[kLanes];
  bool live[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    const long r = row0 + l;
    live[l] = r < batch;
    e[l] = live[l] ? v0[r * M + b] : 1.f;
    f[l] = live[l] ? v0[r * M + NPAD + b] : 0.f;
    sp[l] = live[l] ? spec[r * M + b] * mk_p : 0.f;
    sq[l] = live[l] ? spec[r * M + NPAD + b] * mk_q : 0.f;
  }

  // s_ref = max(max |spec|, 1) per lane
  float s_ref[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s_ref[l] = fmaxf(fabsf(sp[l]), fabsf(sq[l]));
  block_max<NPAD>(s_ref, sred[0]);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) s_ref[l] = fmaxf(s_ref[l], 1.f);

  float ir[kLanes], ii[kLanes], fp[kLanes], fq[kLanes];
  float err[kLanes], vm2max[kLanes];

  // cur = [e-1, f] Y + rowsum; F = (spec - [P, Q]) * mask; err, max vm^2.
  // Entered after a barrier that orders the last reads of sx and sred.
  auto mismatch = [&]() {
    float tp[kLanes], tq[kLanes], nonfinite[kLanes];
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      tp[l] = e[l] - 1.f;
      tq[l] = f[l];
    }
    store_x<NPAD>(sx4, b, tp, tq);
    __syncthreads();
    matvec<NPAD>(ypack, sx4, b, ir, ii);
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      ir[l] += rs_p;
      ii[l] += rs_q;
      fp[l] = (sp[l] - (e[l] * ir[l] + f[l] * ii[l])) * mk_p;
      fq[l] = (sq[l] - (f[l] * ir[l] - e[l] * ii[l])) * mk_q;
      nonfinite[l] = (!isfinite(fp[l]) || !isfinite(fq[l])) ? 1.f : 0.f;
      err[l] = fmaxf(fabsf(fp[l]), fabsf(fq[l]));
      vm2max[l] = e[l] * e[l] + f[l] * f[l];
    }
    block_max<NPAD>(err, sred[0]);
    block_max<NPAD>(nonfinite, sred[1]);
    block_max<NPAD>(vm2max, sred[2]);
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
      err[l] = nonfinite[l] > 0.f ? __int_as_float(0x7fc00000) : err[l] / s_ref[l];
  };

  __syncthreads();
  mismatch();
  bool done[kLanes];
  int niter[kLanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    done[l] = !live[l] || err[l] < tol;   // NaN compares false: not done
    niter[l] = 0;
  }

  for (int it = 0; it < max_iter; ++it) {
    bool active = false;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) active = active || !done[l];
    // barrier: also orders this iteration's shared writes after last reads
    if (!__syncthreads_or(active)) break;

    // Newton direction by preconditioned Richardson
    float dth[kLanes], dnu[kLanes], tp[kLanes], tq[kLanes];
    store_x<NPAD>(sx4, b, fp, fq);
    __syncthreads();
    matvec<NPAD>(wpack, sx4, b, dth, dnu);
    for (int k = 0; k < inner_iters; ++k) {
      float de[kLanes], df[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        de[l] = -f[l] * dth[l] + e[l] * dnu[l];
        df[l] = e[l] * dth[l] + f[l] * dnu[l];
      }
      __syncthreads();
      store_x<NPAD>(sx4, b, de, df);
      __syncthreads();
      matvec<NPAD>(ypack, sx4, b, tp, tq);   // [dIr, dIi]
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
      matvec<NPAD>(wpack, sx4, b, tp, tq);
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        dth[l] += tp[l];
        dnu[l] += tq[l];
      }
    }

    // gated polar update: a done lane is an exact no-op
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const float gate = done[l] ? 0.f : 1.f;
      niter[l] += done[l] ? 0 : 1;
      float s, c;
      sincosf(gate * dth[l], &s, &c);
      const float scale = 1.f + gate * dnu[l];
      const float e2 = scale * (e[l] * c - f[l] * s);
      const float f2 = scale * (f[l] * c + e[l] * s);
      e[l] = e2;
      f[l] = f2;
    }
    __syncthreads();   // last W-matvec reads of sx precede the mismatch writes
    mismatch();
#pragma unroll
    for (int l = 0; l < kLanes; ++l) {
      const bool stop = !isfinite(err[l]) || err[l] < tol || vm2max[l] > 100.f;
      done[l] = done[l] || stop;
    }
  }

#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    if (!live[l]) continue;
    const long r = row0 + l;
    v_out[r * M + b] = e[l];
    v_out[r * M + NPAD + b] = f[l];
    if (b == 0) {
      err_out[r] = err[l];
      it_out[r] = niter[l];
    }
  }
}

template <int NPAD>
int launch(const float* spec, const float* v0, const float* ypack,
           const float* wpack, const float* rowsum, const float* mask,
           float* v_out, float* err_out, int* it_out, int batch, float tol,
           int max_iter, int inner_iters, cudaStream_t stream) {
  const int blocks = (batch + kLanes - 1) / kLanes;
  nr_large_kernel<NPAD><<<blocks, NPAD, 0, stream>>>(
      spec, v0, ypack, wpack, rowsum, mask, v_out, err_out, it_out, batch, tol,
      max_iter, inner_iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// All arrays float32 (it_out int32) on the device, row-major:
// spec/v0/v_out (batch, 2 npad), ypack/wpack (2 npad, 2 npad),
// rowsum/mask (2 npad,), err_out/it_out (batch,).  Returns the cudaError_t
// of the launch (0 = ok).
int nr_large_launch(const float* spec, const float* v0, const float* ypack,
                    const float* wpack, const float* rowsum, const float* mask,
                    float* v_out, float* err_out, int* it_out, int batch,
                    int npad, float tol, int max_iter, int inner_iters,
                    void* stream) {
  if (batch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npad) {
    case 128: return launch<128>(spec, v0, ypack, wpack, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 256: return launch<256>(spec, v0, ypack, wpack, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    case 384: return launch<384>(spec, v0, ypack, wpack, rowsum, mask, v_out, err_out, it_out, batch, tol, max_iter, inner_iters, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* nr_large_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
