// Inverse-CDF resampling of bin edges for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel uncertainty_nerf_gs_tpu/ops/pdf_pallas.py::
// resample_edges_tpu (body _resample_kernel). It computes what that kernel
// computes, per ray r:
//   w    = weights[r] + histogram_padding             (S bins)
//   pad  = max(eps - sum(w), 0);  pdf = (w + pad / S) / (sum(w) + pad)
//   cdf  = [0, clip(inclusive_cumsum(pdf), 0, 1)]     (S + 1 entries)
//   for each query u[r, j]: i = last index with cdf[i] <= u, clipped to
//   [0, S-1]; out = e0 + frac * (e1 - e0) with frac = (u - c0) /
//   max(c1 - c0, 1e-12) where c1 > c0, else 0.
//
// What bounds it on an H100: bytes. At R = 4096 rays, S = 256 bins, N = 97
// queries it reads weights, edges and u and writes the result once:
// 4096 * (256 + 257 + 97 + 97) * 4 B = 11.6 MB, about 3.5 us at 3.35 TB/s.
// At S = 96, N = 49 it moves 4.8 MB, about 1.4 us. The compares of the
// binary search (about R * N * log2(S + 1)) and the scan's adds cost little.
// At these sizes the launch itself (a few us) and the PyTorch call around it
// set the time in practice.
//
// What the design does about that: the whole resampler is ONE launch with
// no intermediate array in device memory. The plain PyTorch version runs a
// dozen kernels and writes an (R, S + 1, N) compare mask. Here one block of
// 128 threads owns one ray: it stages the ray's weights and edges in shared
// memory with coalesced loads, reduces and scans them there, and answers
// the ray's queries by binary search in shared memory. R blocks keep every
// SM busy at R = 4096; ragged R needs no padding, since each block only
// reads its own row. Nothing is allocated here; the wrapper allocates out.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Inclusive scan of one float per thread across the block. Returns this
// thread's inclusive prefix; *total receives the block's sum.
__device__ float block_inclusive_scan(float v, float* warp_sums, float* total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    float offset = 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) offset += warp_sums[w];
        sum += warp_sums[w];
    }
    *total = sum;
    __syncthreads();  // warp_sums may be reused by the caller
    return v + offset;
}

__global__ void __launch_bounds__(kThreads)
pdf_resample_kernel(const float* __restrict__ weights,
                    const float* __restrict__ edges,
                    const float* __restrict__ u,
                    float* __restrict__ out,
                    int num_bins, int num_queries,
                    float hist_pad, float eps) {
    extern __shared__ float smem[];
    float* cdf = smem;                  // num_bins + 1
    float* edg = smem + num_bins + 1;   // num_bins + 1
    __shared__ float warp_sums[kWarps];

    const int tid = threadIdx.x;
    const long long row = blockIdx.x;
    const float* w_row = weights + row * num_bins;
    const float* e_row = edges + row * (num_bins + 1);
    const float* u_row = u + row * num_queries;
    float* o_row = out + row * num_queries;

    // coalesced staging; cdf[i + 1] holds the padded weight of bin i for now
    for (int i = tid; i < num_bins; i += kThreads) {
        cdf[i + 1] = w_row[i] + hist_pad;
    }
    for (int i = tid; i <= num_bins; i += kThreads) edg[i] = e_row[i];
    __syncthreads();

    // each thread owns a contiguous run of bins
    const int per = (num_bins + kThreads - 1) / kThreads;
    const int lo = min(tid * per, num_bins);
    const int hi = min(lo + per, num_bins);

    float local = 0.0f;
    for (int i = lo; i < hi; ++i) local += cdf[i + 1];
    float w_sum;
    block_inclusive_scan(local, warp_sums, &w_sum);
    const float padding = fmaxf(eps - w_sum, 0.0f);
    const float pad_bin = padding / num_bins;
    const float denom = w_sum + padding;

    // pdf, then the inclusive scan of the pdf: sequential within a run,
    // a block scan across runs
    local = 0.0f;
    for (int i = lo; i < hi; ++i) {
        const float p = (cdf[i + 1] + pad_bin) / denom;
        cdf[i + 1] = p;
        local += p;
    }
    float unused;
    const float incl = block_inclusive_scan(local, warp_sums, &unused);
    float run = incl - local;
    for (int i = lo; i < hi; ++i) {
        run += cdf[i + 1];
        cdf[i + 1] = fminf(fmaxf(run, 0.0f), 1.0f);
    }
    if (tid == 0) cdf[0] = 0.0f;
    __syncthreads();

    for (int j = tid; j < num_queries; j += kThreads) {
        const float q = u_row[j];
        // count of cdf entries <= q, i.e. upper bound over cdf[0..S]
        int a = 0, b = num_bins + 1;
        while (a < b) {
            const int m = (a + b) >> 1;
            if (cdf[m] <= q) a = m + 1; else b = m;
        }
        const int idx = min(max(a - 1, 0), num_bins - 1);
        const float c0 = cdf[idx], c1 = cdf[idx + 1];
        const float e0 = edg[idx], e1 = edg[idx + 1];
        const float frac = c1 > c0 ? (q - c0) / fmaxf(c1 - c0, 1e-12f) : 0.0f;
        o_row[j] = e0 + frac * (e1 - e0);
    }
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous float32 arrays: weights (R, S), edges (R, S+1), u (R, N),
// out (R, N). Launches on `stream` and returns cudaGetLastError().
extern "C" int pdf_resample_f32(const float* weights, const float* edges,
                                const float* u, float* out,
                                int num_rays, int num_bins, int num_queries,
                                float hist_pad, float eps, void* stream) {
    const size_t smem = 2 * (static_cast<size_t>(num_bins) + 1) * sizeof(float);
    pdf_resample_kernel<<<num_rays, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        weights, edges, u, out, num_bins, num_queries, hist_pad, eps);
    return static_cast<int>(cudaGetLastError());
}
