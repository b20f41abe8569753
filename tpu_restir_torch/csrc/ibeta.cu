// K10: the non-normalized incomplete beta B_x(a, b) in float64, the value
// of `mathx/special.py` `_ibeta_value` (the forward of `_IBetaX`), behind
// the Phong energy normalization `calc_i_m`.
//
// It replaces no TPU kernel: the JAX package takes XLA's `betainc`
// (tpu_restir/mathx/special.py), and the port's plain version evaluates
// the continued fraction of `_beta_cf` as 64 unrolled modified-Lentz steps
// of whole-tensor float64 PyTorch operations, ~2,850 launches a call,
// each streaming every lane through device memory for one operation.
//
// What bounds it on the H100: float64 arithmetic. A lane runs 128
// half-steps of 3 divisions (each ~10 instructions of the FP64 pipe) and
// ~11 products and sums, then one log, log1p and exp and three lgamma:
// ~5,000 FP64 instructions, against 24 bytes of input and output. At
// 1080p (2,073,600 lanes) that is ~0.6 ms at 16.75e12 FP64 instructions
// a second, and 50 MB, 15 us, of memory traffic.
//
// Design: one thread a lane, 256 threads a block, a grid-stride loop. The
// Lentz state (c, d, h), the constants qab, qap, qam and the loop counter
// live in registers; no shared memory, no early exit. The arithmetic is
// `_beta_cf`'s and `_ibeta_value`'s, operation for operation and in their
// order; with --fmad=false (kernels/ibeta.py FLAGS) every product and sum
// is rounded once, as PyTorch's one-operation-a-launch chain rounds it,
// and exp, log, log1p and lgamma are the device math library's, the ones
// PyTorch's CUDA operations call. So the result equals the plain version
// on the card bit for bit. b (and a, or x) may be one value broadcast to
// every lane: its step is 0.
//
// C interface (ctypes): the entry returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 64;        // _CF_STEPS of mathx/special.py
constexpr double kTiny = 1e-300;  // _TINY

// _nonzero: |v| < 1e-300 -> 1e-300 (a NaN stays NaN)
__device__ __forceinline__ double nonzero(double v) {
  return fabs(v) < kTiny ? kTiny : v;
}

// _beta_cf: the continued fraction of I_x(a, b) (Numerical Recipes'
// betacf), each expression grouped as Python evaluates the plain one
__device__ double beta_cf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0;
  double d = 1.0 / nonzero(1.0 - qab * x / qap);
  double h = d;
#pragma unroll 1
  for (int m = 1; m <= kSteps; ++m) {
    const double fm = (double)m, m2 = 2.0 * fm;
    double aa = fm * (b - fm) * x / ((qam + m2) * (a + m2));
    d = 1.0 / nonzero(1.0 + aa * d);
    c = nonzero(1.0 + aa / c);
    h = h * d * c;
    aa = -(a + fm) * (qab + fm) * x / ((a + m2) * (qap + m2));
    d = 1.0 / nonzero(1.0 + aa * d);
    c = nonzero(1.0 + aa / c);
    h = h * d * c;
  }
  return h;
}

// _ibeta_value: B_x(a, b), with the symmetry swap
// I_x(a, b) = 1 - I_{1-x}(b, a) where the fraction converges slowly
__device__ double ibeta_value(double x, double a, double b) {
  const bool swap = x > (a + 1.0) / (a + b + 2.0);
  const double xs = swap ? 1.0 - x : x;
  const double as = swap ? b : a;
  const double bs = swap ? a : b;
  const double front = exp(as * log(xs) + bs * log1p(-xs)) / as;
  const double part = front * beta_cf(as, bs, xs);
  const double full = exp(lgamma(a) + lgamma(b) - lgamma(a + b));
  return swap ? full - part : part;
}

__global__ void __launch_bounds__(kThreads)
ibeta_kernel(const double* __restrict__ x, int x_step,
             const double* __restrict__ a, int a_step,
             const double* __restrict__ b, int b_step, long long n,
             double* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = ibeta_value(x[i * x_step], a[i * a_step], b[i * b_step]);
}

}  // namespace

extern "C" {

// x, a, b: float64, each n contiguous lanes (step 1) or one value (step
// 0); out: n float64. Launched on `stream`; n > 0.
int ibeta(const void* x, int x_step, const void* a, int a_step,
          const void* b, int b_step, long long n, void* out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  ibeta_kernel<<<(unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30)),
                 kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, x_step, (const double*)a, a_step, (const double*)b,
      b_step, n, (double*)out);
  return (int)cudaGetLastError();
}

const char* ibeta_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
