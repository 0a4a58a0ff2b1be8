// The prover's three sparse products, a_j = <A_j, w>, b_j and c_j over Fr,
// on the card: one CSR SpMV over the rows of A, B and C, written straight
// into the H pipeline's inputs, (3, 8, n) limb-major Montgomery limbs.
//
// Replaces no Pallas kernel: the JAX package computes these products on the
// host, in C++ (native/gosnark_native.cpp, gosnark_sparse_matvec), and so
// did the port until this kernel; the host loop and the crossing of its
// three results were most of a real circuit's proof.
//
// Inputs, built once per constraint system (ops/r1cs_spmv.py):
//   indptr  (3n + 1) int32 row pointers over the 3n rows (A's n, then B's,
//           then C's; the rows past the system's constraints are empty);
//   cols    (nnz) int32 signal of each non-zero;
//   coef    (nnz) int32 index of each non-zero into the table; index 0 is
//           the coefficient 1, whose term is the witness value itself;
//   table   (k, 8) the distinct coefficients as c R mod r (Montgomery form),
//           32 bytes a row: mont_mul(c R, w) = c w, a plain value;
//   r2      R^2 mod r, the Montgomery entry of a row's plain sum;
//   w       (m, 8) the witness, plain canonical values, 32 bytes a signal
//           (the bytes as they crossed: one term's value is one sector);
//   long_rows the rows of more than long_len terms.
//
// Each row is a sum of plain values (field.cuh's add, canonical all the
// way), then one product by R^2: the output is the canonical Montgomery
// value, the same bits as the host products entered by K2.  The sum is
// exact in any order, so the split below changes no bit.
//
// Row lengths are skewed (circomlib's SHA-256: ~1 M rows of 1-3 terms and
// ~10 K linear rows of 65-164), so one launch has two kinds of blocks: the
// first long_blocks give each long row a warp, whose lanes stride over its
// terms and combine their partial sums by five shuffle rounds of a modular
// add; the rest give each row a thread and skip the long rows.  A thread's
// row is its neighbour's neighbour, so the outputs are written by
// coalesced limb-row stores.
//
// Bound on the H100 at the SHA-256 shape (3 x 2^20 rows, 5.86 M terms): by
// bytes ~190 MB (the CSR 60 MB, the witness 32 MB once, the output 100 MB)
// = 0.06 ms; by operations at most ~9 M products of 264 IMADs (a term with
// a coefficient other than 1, and a row's entry) = 0.15 ms.  The bound is
// operations, so the design does no product it can avoid (the coefficient 1,
// a table of distinct coefficients in Montgomery form so that a term is one
// product, one entry a row and not a term) and keeps a term's loads to two
// 16-byte reads of the witness row plus two 4-byte index reads.

#include "field.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

using P = gs::ModR;
using F = gs::Fp<P>;

// the 32-byte value at row i of a (k, 8) table, by two 16-byte loads
__device__ __forceinline__ F load_row(const uint32_t* __restrict__ base, long long i) {
  const uint4* p = reinterpret_cast<const uint4*>(base + 8 * i);
  const uint4 lo = __ldg(p), hi = __ldg(p + 1);
  F r;
  r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
  r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
  return r;
}

// the k-th non-zero's c w, plain
__device__ __forceinline__ F term(const int* __restrict__ cols, const int* __restrict__ coef,
                                  const uint32_t* __restrict__ table, const uint32_t* __restrict__ w,
                                  int k) {
  const F x = load_row(w, __ldg(cols + k));
  const int c = __ldg(coef + k);
  return c == 0 ? x : gs::mul<P>(load_row(table, c), x);
}

}  // namespace

__global__ void __launch_bounds__(256) r1cs_spmv_kernel(
    const int* __restrict__ indptr, const int* __restrict__ cols, const int* __restrict__ coef,
    const uint32_t* __restrict__ table, const uint32_t* __restrict__ r2, const uint32_t* __restrict__ w,
    const int* __restrict__ long_rows, int n_long, int long_blocks, int long_len,
    uint32_t* __restrict__ out, long long n) {
  F acc;
  gs::set_zero<P>(acc);
  long long g;
  if ((int)blockIdx.x < long_blocks) {  // a warp a long row
    const int row = (int)blockIdx.x * (blockDim.x / 32) + (int)(threadIdx.x / 32);
    if (row >= n_long) return;  // the whole warp
    const int lane = threadIdx.x & 31;
    g = __ldg(long_rows + row);
    const int end = __ldg(indptr + g + 1);
    for (int k = __ldg(indptr + g) + lane; k < end; k += 32) acc = gs::add<P>(acc, term(cols, coef, table, w, k));
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      F o;
#pragma unroll
      for (int j = 0; j < 8; ++j) o.v[j] = __shfl_xor_sync(0xffffffffu, acc.v[j], off);
      acc = gs::add<P>(acc, o);
    }
    if (lane) return;
  } else {  // a thread a row; long rows are their warps'
    g = (long long)(blockIdx.x - long_blocks) * blockDim.x + threadIdx.x;
    if (g >= 3 * n) return;
    const int start = __ldg(indptr + g), end = __ldg(indptr + g + 1);
    if (end - start > long_len) return;
    for (int k = start; k < end; ++k) acc = gs::add<P>(acc, term(cols, coef, table, w, k));
  }
  const long long mat = g / n;
  gs::store<P>(out + mat * 8 * n, gs::mul<P>(acc, load_row(r2, 0)), g - mat * n, n);
}

extern "C" int gs_r1cs_spmv(const void* indptr, const void* cols, const void* coef, const void* table,
                            const void* r2, const void* w, const void* long_rows, int n_long, int long_len,
                            void* out, long long n, void* stream) {
  const int threads = 256, warps = threads / 32;
  const long long long_blocks = (n_long + warps - 1) / warps;
  const long long blocks = long_blocks + (3 * n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  r1cs_spmv_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)indptr, (const int*)cols, (const int*)coef, (const uint32_t*)table, (const uint32_t*)r2,
      (const uint32_t*)w, (const int*)long_rows, n_long, (int)long_blocks, long_len, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* gs_errstr(int e) { return cudaGetErrorString((cudaError_t)e); }
#endif
