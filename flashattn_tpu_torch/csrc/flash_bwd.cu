// Flash-attention backward: dq, dk, dv of o = softmax(q k^T * sm_scale) v,
// recomputing the probabilities from q, k and the forward's lse.
//
// Replaces the TPU kernels in flashattn_tpu/ops/flash_attention.py:
//   _bwd_dkv_kernel + _bwd_dq_kernel (wrapper _flash_bwd), the grid
//     backward: causal or not, sliding window, kv_lengths, GQA, cross
//     attention;
//   _bwd_subrow_kernel (wrapper _flash_bwd_subrow), the fused dense causal
//     backward of the bf16 training route;
//   _bwd_dq_loop_kernel + _bwd_dkv_loop_kernel (wrapper _flash_bwd_loop),
//     the split dense causal backward of the f32 training route.
// One pair of kernels computes all three functions.
//
// Math, for query row R and key c in R's live interval [lo, hi)
// (fa::dense_bounds, the policy of the forward kernel):
//   p = exp(s * sm_scale - lse_R) with s = q_R . k_c
//   dv_c += p do_R;   dp = do_R . v_c;   ds = p (dp - di_R) sm_scale
//   dq_R += ds k_c;   dk_c += ds q_R
// with di_R = o_R . do_R (computed by the caller).  Outside the interval
// p = 0, so a row with no live key (lse = -inf) gets dq = 0 and a key that
// no row sees (past kv_lengths) gets dk = dv = 0, without evaluating
// exp(s - lse) there.  GQA: query head h reads kv head h / (h_q / h_kv),
// and dk/dv sum over the group's query heads.
//
// What bounds it on the H100: like the forward (attn_core.cuh) this is the
// simple CUDA-core (FMA) version, bound by FP32 issue and shared-memory
// reads, not by HBM.  Design: two kernels, as the TPU grid backward splits
// them, so that no sum crosses blocks and nothing needs atomics:
//   dK/dV: a block owns 64 keys of one (batch, kv head), keeps their dk and
//     dv in registers, and walks every query head of its GQA group and
//     every 64-row query tile that can see one of its keys, computing the
//     score and dp tiles key-major (s^T = k q^T, dp^T = v do^T);
//   dQ: a block owns 64 query rows of one (batch, head), keeps their dq in
//     registers and walks the key tiles its rows can see.
// The score and dp tiles are computed in both kernels: 7 score-shaped
// products where the fused TPU subrow kernel issues 5.  All sums in f32;
// the outputs round once to the input dtype.

#include "attn_core.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BT = 64;                // rows of a query tile and of a key tile
constexpr int RG = 16, CG = 16;       // thread grid over a 64 x 64 tile
constexpr int NT = RG * CG;
constexpr int TR = BT / RG;           // tile rows per thread
constexpr int TC = BT / CG;           // tile columns per thread
constexpr int PS = BT + 4;            // padded stride of a 64 x 64 tile

template <int D> constexpr size_t smem_bytes() {
  return sizeof(float) *
         (4 * size_t(BT) * (D + 4) + 2 * size_t(BT) * PS + 2 * size_t(BT));
}

// Stage rows [row0, row0 + BT) of a (n, D) row-major matrix as f32 with
// stride D + 4; rows at or past n read as 0.
template <typename T, int D>
__device__ void stage(float* dst, const T* src, int row0, int n) {
  constexpr int DS = D + 4;
  for (int i = threadIdx.x; i < BT * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n) v = fa::load4(src + size_t(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * DS + c) = v;
  }
}

// acc[i][j] = sum_d a[rg + RG i][d] * b[cg + CG j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void dot_tile(const float* a, const float* b,
                                         float (&acc)[TR][TC]) {
  constexpr int DS = D + 4;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; dd += 4) {
    float4 av[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (rg + RG * i) * DS + dd);
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(b + (cg + CG * j) * DS + dd);
#pragma unroll
      for (int i = 0; i < TR; ++i)
        acc[i][j] += av[i].x * bv.x + av[i].y * bv.y + av[i].z * bv.z + av[i].w * bv.w;
    }
  }
}

// acc[i][e] += sum_t p[rg + RG i][t] * m[t][cg + CG e]: a 64 x 64 tile
// (stride PS) times a staged (64, D) tile.
template <int D>
__device__ __forceinline__ void tile_times(const float* p, const float* m,
                                           float (&acc)[TR][D / CG]) {
  constexpr int DS = D + 4;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
#pragma unroll 4
  for (int t = 0; t < BT; ++t) {
    float pr[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) pr[i] = p[(rg + RG * i) * PS + t];
#pragma unroll
    for (int e = 0; e < D / CG; ++e) {
      const float mv = m[t * DS + cg + CG * e];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i][e] += pr[i] * mv;
    }
  }
}

// p and ds of one (row R, key c) pair; p = 0 outside R's live interval.
__device__ __forceinline__ void prob(float s, float dp, int R, int c, int n_q,
                                     int kv_len, int causal, int window,
                                     float scale_log2, float sm_scale,
                                     float lse2, float di, float& p, float& ds) {
  int lo, hi;
  fa::dense_bounds(R, kv_len, causal, window, lo, hi);
  p = (R < n_q && c >= lo && c < hi) ? exp2f(s * scale_log2 - lse2) : 0.f;
  ds = p * (dp - di) * sm_scale;
}

// Per-row statistics of a query tile: lse in base 2 and di; 0 past n_q.
__device__ __forceinline__ void stage_stats(float* lse_s, float* di_s,
                                            const float* lse, const float* di,
                                            int row0, int n_q) {
  for (int i = threadIdx.x; i < BT; i += NT) {
    const int R = row0 + i;
    lse_s[i] = R < n_q ? lse[R] * LOG2E : 0.f;
    di_s[i] = R < n_q ? di[R] : 0.f;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, const float (&acc)[TR][D / CG],
                                           int row0, int n) {
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = row0 + rg + RG * i;
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < D / CG; ++e) fa::store1(dst + size_t(r) * D + cg + CG * e, acc[i][e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     const int* __restrict__ kv_lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int h_kv, int n_q, int n_kv,
                     int causal, int window, float sm_scale) {
  constexpr int DS = D + 4, CPT = D / CG;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * DS;
  float* q_s = v_s + BT * DS;
  float* do_s = q_s + BT * DS;
  float* p_s = do_s + BT * DS;
  float* ds_s = p_s + BT * PS;
  float* lse_s = ds_s + BT * PS;
  float* di_s = lse_s + BT;

  const int bk = blockIdx.x;                    // b * h_kv + kv head
  const int b = bk / h_kv, hk = bk % h_kv;
  const int group = h / h_kv;
  const int kt = blockIdx.y * BT;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  const float scale_log2 = sm_scale * LOG2E;

  const size_t kv_off = size_t(bk) * n_kv * D;
  stage<T, D>(k_s, k + kv_off, kt, n_kv);
  stage<T, D>(v_s, v + kv_off, kt, n_kv);

  float dk_acc[TR][CPT], dv_acc[TR][CPT];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < CPT; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // Query rows that can see a key of this tile: R >= kt when causal,
  // R < kt + BT - 1 + window with a window, none when the tile lies past
  // the valid keys.  The exact mask is applied per pair below.
  const int r_lo = causal ? kt : 0;
  int r_hi = window > 0 ? min(n_q, kt + BT - 1 + window) : n_q;
  if (kt >= kv_len) r_hi = 0;

  for (int g = 0; g < group; ++g) {
    const size_t bh = size_t(b) * h + hk * group + g;
    const T* qh = q + bh * n_q * D;
    const T* doh = dout + bh * n_q * D;
    for (int qt = (r_lo / BT) * BT; qt < r_hi; qt += BT) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(q_s, qh, qt, n_q);
      stage<T, D>(do_s, doh, qt, n_q);
      stage_stats(lse_s, di_s, lse + bh * n_q, di + bh * n_q, qt, n_q);
      __syncthreads();

      float s[TR][TC], dp[TR][TC];
      dot_tile<D>(k_s, q_s, s);                 // s^T: keys x queries
      dot_tile<D>(v_s, do_s, dp);               // dp^T
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int kr = rg + RG * i, qr = cg + CG * j;
          float p, ds;
          prob(s[i][j], dp[i][j], qt + qr, kt + kr, n_q, kv_len, causal, window,
               scale_log2, sm_scale, lse_s[qr], di_s[qr], p, ds);
          p_s[kr * PS + qr] = p;
          ds_s[kr * PS + qr] = ds;
        }
      __syncthreads();
      tile_times<D>(p_s, do_s, dv_acc);         // dv += p^T do
      tile_times<D>(ds_s, q_s, dk_acc);         // dk += ds^T q
    }
  }
  store_tile<T, D>(dk + kv_off, dk_acc, kt, n_kv);
  store_tile<T, D>(dv + kv_off, dv_acc, kt, n_kv);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    const int* __restrict__ kv_lengths, T* __restrict__ dq, int h,
                    int h_kv, int n_q, int n_kv, int causal, int window,
                    float sm_scale) {
  constexpr int DS = D + 4, CPT = D / CG;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BT * DS;
  float* k_s = do_s + BT * DS;
  float* v_s = k_s + BT * DS;
  float* ds_s = v_s + BT * DS;
  float* lse_s = ds_s + BT * PS;
  float* di_s = lse_s + BT;

  const int bh = blockIdx.x;                    // b * h + query head
  const int b = bh / h, hq = bh % h;
  const int hk = hq / (h / h_kv);
  const int qt = blockIdx.y * BT;
  const int kv_len = kv_lengths != nullptr ? min(n_kv, max(kv_lengths[b], 0)) : n_kv;
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  const float scale_log2 = sm_scale * LOG2E;

  const size_t q_off = size_t(bh) * n_q * D;
  const size_t kv_off = (size_t(b) * h_kv + hk) * n_kv * D;
  stage<T, D>(q_s, q + q_off, qt, n_q);
  stage<T, D>(do_s, dout + q_off, qt, n_q);
  stage_stats(lse_s, di_s, lse + size_t(bh) * n_q, di + size_t(bh) * n_q, qt, n_q);

  // The walk covers the union of the tile rows' live intervals.
  int walk_lo = 1 << 30, walk_hi = 0;
  for (int r = 0; r < min(BT, n_q - qt); ++r) {
    int lo, hi;
    fa::dense_bounds(qt + r, kv_len, causal, window, lo, hi);
    if (lo < hi) { walk_lo = min(walk_lo, lo); walk_hi = max(walk_hi, hi); }
  }

  float dq_acc[TR][CPT];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int e = 0; e < CPT; ++e) dq_acc[i][e] = 0.f;

  const int start = walk_hi > walk_lo ? (walk_lo / BT) * BT : 0;
  for (int kt = start; kt < walk_hi; kt += BT) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(k_s, k + kv_off, kt, n_kv);
    stage<T, D>(v_s, v + kv_off, kt, n_kv);
    __syncthreads();

    float s[TR][TC], dp[TR][TC];
    dot_tile<D>(q_s, k_s, s);
    dot_tile<D>(do_s, v_s, dp);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int qr = rg + RG * i, kr = cg + CG * j;
        float p, ds;
        prob(s[i][j], dp[i][j], qt + qr, kt + kr, n_q, kv_len, causal, window,
             scale_log2, sm_scale, lse_s[qr], di_s[qr], p, ds);
        ds_s[qr * PS + kr] = ds;
      }
    __syncthreads();
    tile_times<D>(ds_s, k_s, dq_acc);           // dq += ds k
  }
  store_tile<T, D>(dq + q_off, dq_acc, qt, n_q);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, const int* lens, void* dq,
                   void* dk, void* dv, int b, int h, int h_kv, int n_q, int n_kv,
                   int causal, int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto dkv_kernel = flash_bwd_dkv_kernel<T, D>;
  auto dq_kernel = flash_bwd_dq_kernel<T, D>;
  static cudaError_t opted = [&] {
    cudaError_t e = fa::allow_smem(dkv_kernel, smem);
    return e != cudaSuccess ? e : fa::allow_smem(dq_kernel, smem);
  }();
  if (opted != cudaSuccess) return opted;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (n_kv > 0) {
    dim3 grid(b * h_kv, (n_kv + BT - 1) / BT);
    dkv_kernel<<<grid, NT, smem, stream>>>(qt, kt, vt, dot, lse, di, lens,
                                           static_cast<T*>(dk), static_cast<T*>(dv),
                                           h, h_kv, n_q, n_kv, causal, window, sm_scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_q > 0) {
    dim3 grid(b * h, (n_q + BT - 1) / BT);
    dq_kernel<<<grid, NT, smem, stream>>>(qt, kt, vt, dot, lse, di, lens,
                                          static_cast<T*>(dq), h, h_kv, n_q, n_kv,
                                          causal, window, sm_scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       const int* lens, void* dq, void* dk, void* dv, int b, int h,
                       int h_kv, int n_q, int n_kv, int causal, int window,
                       float sm_scale, cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 64: return launch<T, 64>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    case 128: return launch<T, 128>(q, k, v, dout, lse, di, lens, dq, dk, dv, b, h, h_kv, n_q, n_kv, causal, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout, dq (b, h, n_q, d); k, v, dk, dv (b, h_kv, n_kv, d); lse and di
// (b, h, n_q) f32, lse in natural log.  kv_lengths (b,) int32 or null;
// window <= 0 means none.  Launches the dK/dV kernel, then the dQ kernel.
// dtype codes: 0 = float32, 1 = bfloat16.
extern "C" int fa_flash_bwd(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            const void* kv_lengths, void* dq, void* dk, void* dv,
                            int b, int h, int h_kv, int n_q, int n_kv, int d,
                            int causal, int window, float sm_scale, int dtype,
                            void* stream) {
  if (b == 0 || h == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_lengths);
  const float* l = static_cast<const float*>(lse);
  const float* dd = static_cast<const float*>(di);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, dout, l, dd, lens, dq, dk, dv, b, h, h_kv,
                             n_q, n_kv, causal, window, sm_scale, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, dout, l, dd, lens, dq, dk, dv, b, h,
                                     h_kv, n_q, n_kv, causal, window, sm_scale, st);
  return int(cudaErrorInvalidValue);
}
