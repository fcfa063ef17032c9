// The 3-D pressure operator E of the fractional step, matrix-free, as two
// kernels for Hopper (sm_90a):
//
//   E p = div_weak( c * Binv * vmask * dssum( grad_weak_t p ) ),  c = dt/g0
//
// on element-last fields (pressure [B, M, M, M, nel] on the Gauss grid,
// M = N - 2; velocity [3, B, N, N, N, nel] on the GLL grid; any batch B).
// Per element, with I = j12 [M, N] the GLL -> Gauss interpolation, D the
// GLL derivative and D_a the contraction along reference axis a (r, s, t):
//
//   kernel A   w = I^T (bm2 p)                       (three axes)
//              g_k = sum_a D_a^T (rx[a,k] w)          k = 0, 1, 2
//   kernel B   u_k = ((dssum g_k) vmask_k Binv) c     (the gather)
//              div = sum_k sum_a rx[a,k] D_a u_k
//              out = bm2 I div                        (three axes)
//
// These kernels replace no TPU kernel: the reference's 3-D E is plain XLA.
// On the card the same chain in PyTorch is ~25 launches, most of them over
// 9- or 24-wide intermediates, and its `dssum` gathers an 8-wide padded copy
// table.
//
// Bound: device memory traffic. A fused apply must read p, bm2 (twice), rx
// (twice: its 9 n^3 words an element are too many to keep on chip between
// the two kernels), Binv and the gather plan, and write and gather back one
// 3-component intermediate: about 25 N^3 + 4 M^3 words an element, 81 MB in
// f64 at the channel's 720 elements at N = 8 or the duct's 1,728 at N = 6,
// 24 us at 3.35 TB/s. The flops (~40 N^4 an element) are far below the
// compute bound; the on-chip work is shared-memory reads, n per point and
// contraction.
//
// The design:
//  * Threads are laid out so that neighbouring lanes take neighbouring
//    elements, the contiguous axis: a block takes TE consecutive elements
//    (threadIdx.x) times the N^2 (s, r) pencils of an element (threadIdx.y),
//    and each thread walks its pencil along t. Every global access is then
//    coalesced (TE = 4 in f64, 8 in f32: whole 32-byte sectors; fewer where
//    N^2 is large). The ragged last tile is masked. The grid's x axis runs
//    over the element tiles of each batch entry in turn, so any batch fits.
//  * The contractions go through shared memory, [point][TE] for an element
//    tile; D and I sit there too. The interpolations take one axis at a time
//    (M -> N along r, then s and t), so each costs M or N terms per point.
//  * A grid of these tiles is small (180 blocks in the channel), and each
//    thread's loads wait on one another: kernel A therefore takes one
//    component k per block (gridDim.z = 3), each block interpolating w
//    again from the small p; kernel B, which sums over k, gives each pencil
//    two threads (threadIdx.z), each with half the t points and half the
//    Gauss planes, and keeps the gathered u_k and the divergence in shared
//    memory. The gather loads every point's code, then its copy list's
//    count and first two positions, then the values, so that they are in
//    flight together.
//  * The gather is a sum in a fixed order with no atomics, so E gives the
//    same bits every call: an int32 code per node carries the node's three
//    velocity-mask bits and, for a node shared between elements, the offset
//    of its DOF's copy list in a compact int32 table (the count, then the
//    positions). Every copy of a DOF reads the same list in the same order,
//    so all copies receive the same sum. An interior node, one copy, has
//    offset 0, reads its own entry and nothing from the table.
//  * The mask is a bit, so vmask costs no field read; the product is taken
//    in the plain chain's order, ((sum * vmask) * Binv) * c.
//  * n = N is a template parameter, so every loop unrolls. It is built for
//    N = 4..8 (orders 3-7: the port's 3-D meshes are orders 4-7), which
//    keeps the build short: the large N compile slowest, and N = 4..12
//    takes about three times as long. Another order is one more case line
//    in `launch` (and `NS` in ops/e_kernel.py).
//  * Launch rules: both kernels go on the caller's stream with no
//    synchronisation, host read or allocation, so a CUDA graph captures
//    them; the wrapper allocates g and the output.
//
// Kernel B counts the pair's runs: one thread of block 0 adds one to a
// 64-bit counter in device memory (a plain increment: no other thread of
// the grid touches it), so runs replayed from a CUDA graph count.

#include <cuda_runtime.h>

namespace {

constexpr int kMinN = 4;
constexpr int kMaxN = 8;
constexpr int kMaxDevices = 64;  // cards whose shared-memory allowance is kept

// The tile: TE elements a block, 4 in f64 and 8 in f32 (32 bytes a row),
// at most 1024 threads (2 TE N^2 in kernel B) to a block.
template <typename T, int N>
constexpr int max_tile() {
  int te = sizeof(T) == 8 ? 4 : 8;
  while (2 * te * N * N > 1024) te /= 2;
  return te;
}

// Blocks of `threads` an SM that leave each thread about `regs` registers:
// a kernel's registers otherwise bound it to one or two blocks an SM.
constexpr int min_blocks(int threads, int regs) {
  return 65536 / (threads * regs) > 1 ? 65536 / (threads * regs) : 1;
}

// shared memory: D [N*N], I [M*N], `fields` field buffers [N^3][te]
template <typename T, int N>
size_t smem_bytes(int te, int fields) {
  return sizeof(T) * (size_t)(N * N + (N - 2) * N + fields * N * N * N * te);
}

template <typename T, int N>
__device__ __forceinline__ void load_basis(const T* __restrict__ d, const T* __restrict__ j12,
                                           T* sd, T* sj, int tid, int nthreads) {
  for (int i = tid; i < N * N; i += nthreads) sd[i] = d[i];
  for (int i = tid; i < (N - 2) * N; i += nthreads) sj[i] = j12[i];
}

// Kernel A: g_k = sum_a D_a^T (rx[a,k] I^T (bm2 p)) for one element tile
// of one batch entry (blockIdx.x: the tiles of entry 0, then of entry 1,
// ...) and one component k (blockIdx.z). The three components' blocks each
// interpolate w again, from the small p and bm2, so that three times as
// many blocks share the card.
template <typename T, int N>
__global__ void __launch_bounds__(max_tile<T, N>() * N * N,
                                  min_blocks(max_tile<T, N>() * N * N, 96))
e3d_grad_t_kernel(const T* __restrict__ p, const T* __restrict__ bm2, const T* __restrict__ rx,
                  const T* __restrict__ d, const T* __restrict__ j12, T* __restrict__ g,
                  int nel, int batch) {
  constexpr int M = N - 2, N3 = N * N * N, M3 = M * M * M;
  extern __shared__ unsigned char smem_raw[];
  const int te = blockDim.x;
  T* sd = reinterpret_cast<T*>(smem_raw);  // [N][N]  D, row-major
  T* sj = sd + N * N;                      // [M][N]  I, row-major
  T* buf0 = sj + M * N;                    // [N^3][te]
  T* buf1 = buf0 + N3 * te;                // [N^3][te]

  const int tx = threadIdx.x, q = threadIdx.y;
  const int s = q / N, r = q - s * N;
  const int tiles = (nel + te - 1) / te;
  const long long b = blockIdx.x / tiles;
  const int e = (blockIdx.x - (int)b * tiles) * te + tx;
  const bool valid = e < nel;
  const int k = blockIdx.z;
  const long long geo = (long long)N3 * nel;
  load_basis<T, N>(d, j12, sd, sj, q * te + tx, te * N * N);

  // bm2 p at the Gauss points, [c][b][a]
  if (s < M && r < M) {
    const T* pb = p + b * M3 * nel;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const int pt = (c * M + s) * M + r;
      const long long gi = (long long)pt * nel + e;
      buf0[pt * te + tx] = valid ? pb[gi] * bm2[gi] : T(0);
    }
  }
  __syncthreads();
  // I^T along r: [c][b][r]
  if (s < M) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T acc = 0;
#pragma unroll
      for (int a = 0; a < M; ++a) acc += sj[a * N + r] * buf0[((c * M + s) * M + a) * te + tx];
      buf1[((c * M + s) * N + r) * te + tx] = acc;
    }
  }
  __syncthreads();
  // I^T along s, then t, in registers: w on the thread's pencil
  T w[N];
  {
    T q2[M];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      T acc = 0;
#pragma unroll
      for (int bb = 0; bb < M; ++bb) acc += sj[bb * N + s] * buf1[((c * M + bb) * N + r) * te + tx];
      q2[c] = acc;
    }
#pragma unroll
    for (int t = 0; t < N; ++t) {
      T acc = 0;
#pragma unroll
      for (int c = 0; c < M; ++c) acc += sj[c * N + t] * q2[c];
      w[t] = acc;
    }
  }
  __syncthreads();

  // g_k = D_r^T (rx[0,k] w) + D_s^T (rx[1,k] w) + D_t^T (rx[2,k] w)
  T ft[N];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    const int pt = (t * N + s) * N + r;
    const long long gi = (long long)pt * nel + e;
    T r0 = 0, r1 = 0, r2 = 0;
    if (valid) {
      r0 = rx[(0 * 3 + k) * geo + gi];
      r1 = rx[(1 * 3 + k) * geo + gi];
      r2 = rx[(2 * 3 + k) * geo + gi];
    }
    buf0[pt * te + tx] = r0 * w[t];
    buf1[pt * te + tx] = r1 * w[t];
    ft[t] = r2 * w[t];
  }
  __syncthreads();
  T* gk = g + (k * (long long)batch + b) * geo;
#pragma unroll
  for (int t = 0; t < N; ++t) {
    T acc = 0;
#pragma unroll
    for (int m = 0; m < N; ++m) acc += sd[m * N + r] * buf0[((t * N + s) * N + m) * te + tx];
#pragma unroll
    for (int m = 0; m < N; ++m) acc += sd[m * N + s] * buf1[((t * N + m) * N + r) * te + tx];
#pragma unroll
    for (int m = 0; m < N; ++m) acc += sd[m * N + t] * ft[m];
    if (valid) gk[(long long)((t * N + s) * N + r) * nel + e] = acc;
  }
}

// Kernel B: out = bm2 I sum_k sum_a rx[a,k] D_a (c Binv vmask_k dssum g_k)
// for one element tile of one batch entry (blockIdx.x, as in kernel A).
// Each pencil has two threads (threadIdx.z), each taking half of its t
// points and half of the Gauss planes, so twice as many threads wait on the
// gather's and rx's loads; the gathered u_k and the divergence go through
// shared memory.
template <typename T, int N>
__global__ void __launch_bounds__(2 * max_tile<T, N>() * N * N,
                                  min_blocks(2 * max_tile<T, N>() * N * N, 96))
e3d_div_kernel(const T* __restrict__ g, const int* __restrict__ node,
               const int* __restrict__ table, const T* __restrict__ binv,
               const T* __restrict__ rx, const T* __restrict__ bm2, const T* __restrict__ d,
               const T* __restrict__ j12, T* __restrict__ out, int nel, int batch, T c,
               unsigned long long* __restrict__ runs) {
  constexpr int M = N - 2, N3 = N * N * N, M3 = M * M * M;
  constexpr int NH = (N + 1) / 2, MH = (M + 1) / 2;  // t points, Gauss planes a thread
  extern __shared__ unsigned char smem_raw[];
  const int te = blockDim.x;
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* sj = sd + N * N;
  T* u0 = sj + M * N;  // [4][N^3][te]: u_0, u_1, u_2, div
  T* u1 = u0 + N3 * te;
  T* u2 = u1 + N3 * te;
  T* dvs = u2 + N3 * te;

  const int tx = threadIdx.x, q = threadIdx.y, h = threadIdx.z;
  const int s = q / N, r = q - s * N;
  const int tiles = (nel + te - 1) / te;
  const long long b = blockIdx.x / tiles;
  const int e = (blockIdx.x - (int)b * tiles) * te + tx;
  const bool valid = e < nel;
  const long long geo = (long long)N3 * nel;
  const long long comp = (long long)batch * geo;
  if (blockIdx.x == 0 && tx == 0 && q == 0 && h == 0) *runs += 1ULL;
  load_basis<T, N>(d, j12, sd, sj, (h * N * N + q) * te + tx, 2 * te * N * N);

  // the direct-stiffness sum of g at the thread's points, masked and
  // scaled: every code first, then every copy list's count and first two
  // positions, then the sums, so that the loads of all points are in
  // flight together
  const T* gb = g + b * geo;
  int code[NH], cnt[NH], at0[NH], at1[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int t = h * NH + i;
    code[i] = (valid && t < N) ? node[((t * N + s) * N + r) * nel + e] : 0;
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int t = h * NH + i;
    const int off = code[i] >> 3;
    const int* list = table + off;  // the table's first three entries are padding
    cnt[i] = off ? list[0] : 1;
    at0[i] = off ? list[1] : ((valid && t < N) ? ((t * N + s) * N + r) * nel + e : 0);
    at1[i] = off ? list[2] : 0;
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int t = h * NH + i;
    if (t >= N) break;
    const int pt = (t * N + s) * N + r;
    T s0 = gb[at0[i]], s1 = gb[comp + at0[i]], s2 = gb[2 * comp + at0[i]];
    if (cnt[i] >= 2) {
      s0 += gb[at1[i]];
      s1 += gb[comp + at1[i]];
      s2 += gb[2 * comp + at1[i]];
      const int* list = table + (code[i] >> 3);
      for (int j = 2; j < cnt[i]; ++j) {
        const long long at = list[1 + j];
        s0 += gb[at];
        s1 += gb[comp + at];
        s2 += gb[2 * comp + at];
      }
    }
    const T bi = valid ? binv[(long long)pt * nel + e] : T(0);
    u0[pt * te + tx] = (code[i] & 1) ? (s0 * bi) * c : T(0);
    u1[pt * te + tx] = (code[i] & 2) ? (s1 * bi) * c : T(0);
    u2[pt * te + tx] = (code[i] & 4) ? (s2 * bi) * c : T(0);
  }
  __syncthreads();

  // div = sum_k (rx[0,k] D_r u_k + rx[1,k] D_s u_k + rx[2,k] D_t u_k)
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int t = h * NH + i;
    if (t >= N) break;
    const int pt = (t * N + s) * N + r;
    const long long gi = (long long)pt * nel + e;
    T acc = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T* uk = k == 0 ? u0 : (k == 1 ? u1 : u2);
      T dr = 0, ds = 0, dt = 0;
#pragma unroll
      for (int m = 0; m < N; ++m) dr += sd[r * N + m] * uk[((t * N + s) * N + m) * te + tx];
#pragma unroll
      for (int m = 0; m < N; ++m) ds += sd[s * N + m] * uk[((t * N + m) * N + r) * te + tx];
#pragma unroll
      for (int m = 0; m < N; ++m) dt += sd[t * N + m] * uk[((m * N + s) * N + r) * te + tx];
      if (valid)
        acc += rx[(0 * 3 + k) * geo + gi] * dr + rx[(1 * 3 + k) * geo + gi] * ds +
               rx[(2 * 3 + k) * geo + gi] * dt;
    }
    dvs[pt * te + tx] = acc;
  }
  __syncthreads();

  // I along t: u0 as [c][s][r]
#pragma unroll
  for (int i = 0; i < MH; ++i) {
    const int cc = h * MH + i;
    if (cc >= M) break;
    T acc = 0;
#pragma unroll
    for (int t = 0; t < N; ++t) acc += sj[cc * N + t] * dvs[((t * N + s) * N + r) * te + tx];
    u0[((cc * N + s) * N + r) * te + tx] = acc;
  }
  __syncthreads();
  // I along s: u1 as [c][b][r]
  if (s < M) {
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      const int cc = h * MH + i;
      if (cc >= M) break;
      T acc = 0;
#pragma unroll
      for (int ss = 0; ss < N; ++ss) acc += sj[s * N + ss] * u0[((cc * N + ss) * N + r) * te + tx];
      u1[((cc * M + s) * N + r) * te + tx] = acc;
    }
  }
  __syncthreads();
  // I along r, times bm2: out [c][b][a]
  if (s < M && r < M && valid) {
    T* ob = out + b * M3 * nel;
#pragma unroll
    for (int i = 0; i < MH; ++i) {
      const int cc = h * MH + i;
      if (cc >= M) break;
      T acc = 0;
#pragma unroll
      for (int rr = 0; rr < N; ++rr) acc += sj[r * N + rr] * u1[((cc * M + s) * N + rr) * te + tx];
      const long long gi = (long long)((cc * M + s) * M + r) * nel + e;
      ob[gi] = acc * bm2[gi];
    }
  }
}

// Kernels whose shared memory passes 48 KB are allowed it once a card (the
// attribute is the current device's): `allowed` holds the allowance given
// on each card.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t* allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <typename T, int N>
int launch_n(const T* p, const T* bm2, const T* rx, const T* binv, const T* d, const T* j12,
             const int* node, const int* table, T* g, T* out, int batch, int nel, double c,
             unsigned long long* runs, cudaStream_t stream) {
  static size_t allowed_a[kMaxDevices] = {}, allowed_b[kMaxDevices] = {};
  constexpr int te = max_tile<T, N>();
  const size_t smem_a = smem_bytes<T, N>(te, 2), smem_b = smem_bytes<T, N>(te, 4);
  const long long blocks = (long long)((nel + te - 1) / te) * batch;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(e3d_grad_t_kernel<T, N>, smem_a, allowed_a);
  if (err == cudaSuccess) err = allow_smem(e3d_div_kernel<T, N>, smem_b, allowed_b);
  if (err != cudaSuccess) return (int)err;
  e3d_grad_t_kernel<T, N><<<dim3((unsigned)blocks, 1, 3), dim3(te, N * N), smem_a, stream>>>(
      p, bm2, rx, d, j12, g, nel, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  e3d_div_kernel<T, N><<<dim3((unsigned)blocks), dim3(te, N * N, 2), smem_b, stream>>>(
      g, node, table, binv, rx, bm2, d, j12, out, nel, batch, (T)c, runs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* p, const T* bm2, const T* rx, const T* binv, const T* d, const T* j12,
           const int* node, const int* table, T* g, T* out, int batch, int nel, int n, double c,
           unsigned long long* runs, void* stream) {
  if (nel < 1 || batch < 1 || runs == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define NEKLAB_E3D_CASE(NN) \
  case NN:                  \
    return launch_n<T, NN>(p, bm2, rx, binv, d, j12, node, table, g, out, batch, nel, c, runs, st);
  static_assert(kMinN == 4 && kMaxN == 8, "the cases below list kMinN..kMaxN");
  switch (n) {  // n = order + 1 = 4..8 (n = 3 has no pressure points)
    NEKLAB_E3D_CASE(4)
    NEKLAB_E3D_CASE(5)
    NEKLAB_E3D_CASE(6)
    NEKLAB_E3D_CASE(7)
    NEKLAB_E3D_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEKLAB_E3D_CASE
}

}  // namespace

extern "C" {

// p [batch, M, M, M, nel]; bm2 [M, M, M, nel]; rx [3, 3, n, n, n, nel];
// binv [n, n, n, nel]; d [n, n]; j12 [M, n]; node [n^3 nel] and table: the
// gather plan (ops/e_kernel.py), n^3 nel below 2^31; g [3, batch, n, n, n,
// nel] scratch; out like p. Returns a cudaError_t.
int e3d_f32(const float* p, const float* bm2, const float* rx, const float* binv,
            const float* d, const float* j12, const int* node, const int* table, float* g,
            float* out, int batch, int nel, int n, double c, unsigned long long* runs,
            void* stream) {
  return launch<float>(p, bm2, rx, binv, d, j12, node, table, g, out, batch, nel, n, c, runs,
                       stream);
}

int e3d_f64(const double* p, const double* bm2, const double* rx, const double* binv,
            const double* d, const double* j12, const int* node, const int* table, double* g,
            double* out, int batch, int nel, int n, double c, unsigned long long* runs,
            void* stream) {
  return launch<double>(p, bm2, rx, binv, d, j12, node, table, g, out, batch, nel, n, c, runs,
                        stream);
}

}  // extern "C"
