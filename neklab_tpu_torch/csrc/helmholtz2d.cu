// Fused local 2-D spectral-element Helmholtz apply for Hopper (sm_90a).
//
//   out = h1 * (Dr^T (g00 Dr u + g01 Ds u) + Ds^T (g01 Dr u + g11 Ds u)) + h2 * bm1 * u
//
// in the tensor-product form, per element e and point (s, r):
//   u_r[s,r] = sum_j D[r,j] u[s,j]        u_s[s,r] = sum_j D[s,j] u[j,r]
//   w_r = g00 u_r + g01 u_s               w_s = g01 u_r + g11 u_s
//   out[s,r] = h1 * (sum_i D[i,r] w_r[s,i] + sum_i D[i,s] w_s[i,r]) + h2 bm1 u
//
// Replaces neklab_tpu/ops/pallas_kernels.py::_helmholtz2d_call (the Pallas
// TPU kernel). That kernel applied dense [n^2, n^2] Kronecker matrices
// shaped for the TPU's matrix unit (n^2 flops per point); here each 1-D
// contraction costs n per point.
//
// Bound: device memory traffic. A call reads u ([B, n, n, nel]), g00, g01,
// g11, bm1 and D once and writes out: (2B + 4) n^2 nel + n^2 words, for
// (8n + 10) B n^2 nel flops. At the velocity CG's [2, 9, 9, 120] f32 that is
// 311 KB (0.093 us at 3.35 TB/s) against 1.6 MFLOP (0.024 us at 67 TFLOP/s
// f32); box2d's [2, 8, 8, 1024] f32 moves 2.1 MB (0.63 us). Calls this small
// never stream at the memory's rate: their time is set by how many SMs take
// part and by the length of each thread's chain of dependent loads and sums.
//
// The first design gave one thread per element, which walked its n^2 points
// in series, 32 elements to a block, the batch on gridDim.y and the geometry
// re-read for every batch entry: 8 blocks at [2, 9, 9, 120], 16.3 us there
// (0.6 % of the bound) and 11.8 us at [2, 8, 8, 1024] (5 %).
//
// This design works over (element, point):
//  * One thread per (element, point). A block takes TE consecutive elements
//    times all n^2 points: threadIdx.x is the element in the tile,
//    threadIdx.y the point. Consecutive threads take consecutive elements at
//    one point, so every global access is coalesced in the element-last
//    layout (TE = 8 in f32 reads whole 32-byte sectors). The ragged last
//    tile is masked here, not padded by the caller.
//  * Each thread keeps its point's g00, g01, g11 and h2 * bm1 in registers
//    and loops over a chunk of the leading batch inside the block, so a block
//    reads the geometry once. The tile narrows, and the batch is cut into
//    chunks over gridDim.y, as far as it takes to spread the call over the
//    SMs (launch_n).
//  * Per batch entry: u into shared memory; sync; the thread's u_r, u_s and
//    w_r, w_s (n-term sums over shared memory), w_r and w_s into shared
//    memory; sync; the transposed sums and the mass term, straight to device
//    memory. The next entry's u is loaded into a register while the sums run.
//  * n is a template parameter (2..12), so the sums unroll and (s, r) comes
//    from a constant divisor. D sits in shared memory; the threads of a warp
//    share at most 32 / TE points, so its reads are broadcasts.
//  * No tensor cores: f32 products on them would be TF32, which the port
//    forbids, and the contractions are only n <= 12 long. TMA and wgmma do not
//    pay for ~300 KB a call.
//
// The kernel counts its own runs: one thread of block (0, 0) adds one to a
// 64-bit counter in device memory, so runs replayed from a CUDA graph count.

#include <cuda_runtime.h>

namespace {

// Largest tile: at most 1024 threads (TE * n^2) to a block.
template <int N>
constexpr int max_tile() { return 8 * N * N <= 1024 ? 8 : 4; }

template <typename T, int N>
__global__ void __launch_bounds__(max_tile<N>() * N * N)
helmholtz2d_kernel(const T* __restrict__ u, const T* __restrict__ d,
                   const T* __restrict__ g00, const T* __restrict__ g01,
                   const T* __restrict__ g11, const T* __restrict__ bm1,
                   T* __restrict__ out, int batch, int chunk, int nel, T h1, T h2,
                   unsigned long long* __restrict__ runs) {
  constexpr int NP = N * N;
  extern __shared__ unsigned char smem_raw[];
  const int te = blockDim.x;
  T* sd = reinterpret_cast<T*>(smem_raw);  // [NP]      D, row-major
  T* su = sd + NP;                         // [NP][te]  u
  T* swr = su + NP * te;                   // [NP][te]  w_r
  T* sws = swr + NP * te;                  // [NP][te]  w_s

  const int tx = threadIdx.x;
  const int p = threadIdx.y;
  const int s = p / N, r = p - s * N;
  const int me = p * te + tx;
  const int e = blockIdx.x * te + tx;
  const bool valid = e < nel;
  const long long gi = (long long)p * nel + e;
  const long long entry = (long long)NP * nel;
  const int b0 = blockIdx.y * chunk;
  const int b1 = min(b0 + chunk, batch);

  if (me == 0 && blockIdx.x == 0 && blockIdx.y == 0) atomicAdd(runs, 1ULL);
  if (me < NP) sd[me] = d[me];

  T a00 = 0, a01 = 0, a11 = 0, mass = 0, unext = 0;
  if (valid) {
    a00 = g00[gi];
    a01 = g01[gi];
    a11 = g11[gi];
    mass = h2 * bm1[gi];
    unext = u[b0 * entry + gi];
  }

  for (int b = b0; b < b1; ++b) {
    const T uv = unext;
    su[me] = uv;
    __syncthreads();
    if (valid && b + 1 < b1) unext = u[(b + 1) * entry + gi];

    // reference gradients and metric fluxes
    T ur = 0, us = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      ur += sd[r * N + j] * su[(s * N + j) * te + tx];
      us += sd[s * N + j] * su[(j * N + r) * te + tx];
    }
    swr[me] = a00 * ur + a01 * us;
    sws[me] = a01 * ur + a11 * us;
    __syncthreads();

    // transposed contractions + mass term. The next entry may overwrite su
    // and then swr/sws only after every thread has passed this entry's
    // second sync and, for swr/sws, the next entry's first one.
    T acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      acc += sd[i * N + r] * swr[(s * N + i) * te + tx];
      acc += sd[i * N + s] * sws[(i * N + r) * te + tx];
    }
    if (valid) out[b * entry + gi] = h1 * acc + mass * uv;
  }
}

// The card's SM count, read once.
cudaError_t num_sms(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// The launcher chooses the tile from the shape and the card. Fewer, larger
// blocks read the geometry fewer times; more blocks put more SMs to work,
// and a long loop over the batch inside a block serializes. It starts from
// the largest tile with the whole batch in each block; while the grid holds
// fewer blocks than a quarter of the SMs, it halves the tile down to 4
// elements (16 bytes a point in f32), then the batch chunk; then it halves
// the chunk further while the grid still fits on the SMs or the chunk is
// longer than 8. On a 132-SM H100 that gives (4, 1) at [2, 9, 9, 120],
// (8, 2) at [2, 8, 8, 1024], (4, 6) at [81, 9, 9, 120] and (8, 8) at
// [64, 8, 8, 1024]: the fastest, or within 3 % of it, of the (elements,
// entries) tiles timed at those shapes (PERF.md).
template <typename T, int N>
int launch_n(const T* u, const T* d, const T* g00, const T* g01, const T* g11,
             const T* bm1, T* out, int batch, int nel, double h1, double h2,
             unsigned long long* runs, cudaStream_t stream) {
  constexpr int NP = N * N;
  auto blocks = [&](int te, int ch) {
    return (long long)((nel + te - 1) / te) * ((batch + ch - 1) / ch);
  };
  int sms = 0;
  const cudaError_t err = num_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  int tile = max_tile<N>();
  int chunk = batch;
  while (blocks(tile, chunk) < sms / 4) {
    if (tile > 4)
      tile /= 2;
    else if (chunk > 1)
      chunk = (chunk + 1) / 2;
    else
      break;
  }
  while (chunk > 8 || (chunk > 1 && blocks(tile, (chunk + 1) / 2) <= sms))
    chunk = (chunk + 1) / 2;
  const int tiles = (nel + tile - 1) / tile;
  const int chunks = (batch + chunk - 1) / chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (size_t)(NP + 3 * NP * tile);  // <= 24.2 KB
  dim3 grid(tiles, chunks);
  dim3 block(tile, NP);
  helmholtz2d_kernel<T, N><<<grid, block, smem, stream>>>(
      u, d, g00, g01, g11, bm1, out, batch, chunk, nel, (T)h1, (T)h2, runs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* d, const T* g00, const T* g01, const T* g11,
           const T* bm1, T* out, int batch, int nel, int n, double h1, double h2,
           unsigned long long* runs, void* stream) {
  if (nel < 1 || batch < 1 || runs == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define NEKLAB_HELMHOLTZ_CASE(NN) \
  case NN:                        \
    return launch_n<T, NN>(u, d, g00, g01, g11, bm1, out, batch, nel, h1, h2, runs, st);
  switch (n) {  // n = order + 1 = 2..12, as the wrapper admits
    NEKLAB_HELMHOLTZ_CASE(2)
    NEKLAB_HELMHOLTZ_CASE(3)
    NEKLAB_HELMHOLTZ_CASE(4)
    NEKLAB_HELMHOLTZ_CASE(5)
    NEKLAB_HELMHOLTZ_CASE(6)
    NEKLAB_HELMHOLTZ_CASE(7)
    NEKLAB_HELMHOLTZ_CASE(8)
    NEKLAB_HELMHOLTZ_CASE(9)
    NEKLAB_HELMHOLTZ_CASE(10)
    NEKLAB_HELMHOLTZ_CASE(11)
    NEKLAB_HELMHOLTZ_CASE(12)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEKLAB_HELMHOLTZ_CASE
}

}  // namespace

extern "C" {

int helmholtz2d_f32(const float* u, const float* d, const float* g00,
                    const float* g01, const float* g11, const float* bm1,
                    float* out, int batch, int nel, int n, double h1, double h2,
                    unsigned long long* runs, void* stream) {
  return launch<float>(u, d, g00, g01, g11, bm1, out, batch, nel, n, h1, h2, runs, stream);
}

int helmholtz2d_f64(const double* u, const double* d, const double* g00,
                    const double* g01, const double* g11, const double* bm1,
                    double* out, int batch, int nel, int n, double h1, double h2,
                    unsigned long long* runs, void* stream) {
  return launch<double>(u, d, g00, g01, g11, bm1, out, batch, nel, n, h1, h2, runs, stream);
}

}  // extern "C"
