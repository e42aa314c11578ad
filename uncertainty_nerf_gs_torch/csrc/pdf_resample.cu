// Inverse-CDF resampling of bin edges for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel uncertainty_nerf_gs_tpu/ops/pdf_pallas.py::
// resample_edges_tpu (body _resample_kernel). It computes what that kernel
// computes, per ray r, in the plain version's order of operations:
//   w    = weights[r] + histogram_padding             (S bins)
//   pad  = max(eps - sum(w), 0);  pdf = (w + pad / S) / (sum(w) + pad)
//   cdf  = [0, clip(inclusive_cumsum(pdf), 0, 1)]     (S + 1 entries)
//   for each query u[r, j]: i = last index with cdf[i] <= u, clipped to
//   [0, S-1]; out = e0 + frac * (e1 - e0) with frac = (u - c0) /
//   max(c1 - c0, 1e-12) where c1 > c0, else 0.
// The sums (the total, the normalised pdf and its scan) are taken in
// float64 and each cdf entry is rounded to float32 once: the cdf is then
// the correctly rounded one, up to float64's own error. The plain version
// (ops/pdf_resample.py::_k1_cdf) takes the same float64 sums in this
// kernel's association and nothing here contracts to an fma, so both give
// the same bits on the same inputs.
//
// What bounds it on an H100: bytes. At R = 4096 rays, S = 256 bins, N = 97
// queries with every row dense it reads weights, edges and u and writes the
// result once: 4096 * (256 + 257 + 97 + 97) * 4 B = 11.6 MB, about 3.5 us at
// 3.35 TB/s; at S = 96, N = 49, 4.8 MB, about 1.4 us. On the render path u
// is one row shared by every ray, and so are the first stage's edges, which
// leaves about 5.8 MB and 4.0 MB. In practice the launch (about 1.1 us for
// this grid, pdf_resample_floor) and each warp's chain of dependent steps
// set the time: every warp loads, then sums, scans and searches, and all of
// them do so at once, so the load phase and the compute phase of a launch
// hardly overlap.
//
// What the design does about that: one warp owns one ray, so nothing waits
// at a block barrier, only at __syncwarp, and up to 8 rays share a block:
// the 4096 warps of a chunk's launch are resident at once (512 blocks, at
// most 4 an SM), in one wave. The work a warp does through the shared-memory
// pipe is kept small, since 32 warps an SM share it:
//  * the weights go straight into registers: a lane owns 8 consecutive bins
//    of each 256-bin tile (4 of a 128-bin tile at S <= 128), loaded as
//    float4s where the row is 16-byte aligned; it sums, normalises and scans
//    them in registers, with one warp scan of the lanes' run totals per
//    tile, and writes its cdf entries as float4s. At S <= 256 that is one
//    tile; larger S sum every tile first and reload each for the scan.
//  * the edges, needed only by the interpolation, are copied to shared
//    memory with cp.async while the scan runs; the queries load meanwhile.
//  * the bracket search is binary lifting over the cdf padded with +inf to
//    a power of two, its step count a template parameter: a step is one
//    shared-memory load at a fixed offset, a compare and a select. A lane
//    searches 2 queries at once (4 when N > 64), and the stores are
//    coalesced.
// Rows of u and of edges are read through a row stride, so one row
// expanded over every ray (stride 0) is read in place and never copied.
// Nothing is allocated here; the wrapper allocates out.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRaysPerBlock = 8;
constexpr int kMaxSmemBytes = 48 * 1024;  // dynamic shared memory without opt-in
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int log2_ceil(int n) {
    int k = 0;
    while ((1 << k) < n) ++k;
    return k;
}

// cdf entries a warp keeps: S + 1, padded with +inf to the power of two
// the search spans
__host__ __device__ inline int cdf_width(int num_bins) {
    const int p = 1 << log2_ceil(num_bins);
    return p > num_bins + 1 ? p : num_bins + 1;
}

// a warp's slice of shared memory in floats: 3 floats of alignment, the
// cdf, 3 floats of slack for the last float4 store, the edges; a multiple
// of 4, so that every warp's cdf + 1 is 16-byte aligned
__host__ __device__ inline int slice_floats(int num_bins) {
    return (3 + cdf_width(num_bins) + 3 + num_bins + 1 + 3) & ~3;
}

// Rays a block serves: 8, or as many as fit 48 KB at large S (one at S = 4096).
int rays_per_block(int num_bins) {
    const int fit = kMaxSmemBytes / (slice_floats(num_bins) * static_cast<int>(sizeof(float)));
    return fit < 1 ? 1 : (fit < kMaxRaysPerBlock ? fit : kMaxRaysPerBlock);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// One float from global to shared memory without waiting for it (sm_80+).
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The weights of bins lo .. lo + kPer - 1 (0 past S), as float4s where
// they can be.
template <int kPer>
__device__ __forceinline__ void load_run(float (&w)[kPer], const float* __restrict__ w_row,
                                         int lo, int num_bins, bool vec) {
    if (vec) {
#pragma unroll
        for (int k = 0; k < kPer; k += 4) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (lo + k < num_bins) v = *reinterpret_cast<const float4*>(w_row + lo + k);
            w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) w[k] = lo + k < num_bins ? w_row[lo + k] : 0.0f;
    }
}

template <int kLog2P, int kQueries>
__global__ void __launch_bounds__(kMaxRaysPerBlock * 32, 4)
pdf_resample_kernel(const float* __restrict__ weights,
                    const float* __restrict__ edges, long long edges_stride,
                    const float* __restrict__ u, long long u_stride,
                    float* __restrict__ out,
                    int num_rays, int num_bins, int num_queries,
                    float hist_pad, float eps) {
    // bins a lane owns in a tile: 4 up to S = 128, so that 24 lanes share
    // S = 96; 8 beyond
    constexpr int kPer = kLog2P > 7 ? 8 : 4;
    constexpr int kTile = 32 * kPer;  // bins a warp scans at once
    extern __shared__ float smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
    if (row >= num_rays) return;  // the whole warp leaves together

    const int width = cdf_width(num_bins);
    float* cdf = smem + warp * slice_floats(num_bins) + 3;  // cdf + 1 is 16-byte aligned
    float* edg = cdf + width + 3;
    const float* w_row = weights + row * num_bins;
    const float* e_row = edges + row * edges_stride;
    const float* u_row = u + row * u_stride;
    float* o_row = out + row * num_queries;
    const bool vec = (num_bins & 3) == 0 && (reinterpret_cast<unsigned long long>(w_row) & 15) == 0;

    // everything in flight at once: the first tile's weights, the edges,
    // the first queries
    float w[kPer];
    load_run(w, w_row, kPer * lane, num_bins, vec);
    for (int i = lane; i <= num_bins; i += 32) copy_async(edg + i, e_row + i);
    float q[kQueries];
#pragma unroll
    for (int k = 0; k < kQueries; ++k)
        q[k] = lane + 32 * k < num_queries ? u_row[lane + 32 * k] : 0.0f;

    // the sums in float64: each cdf entry is rounded to float32 once
    const double hp = hist_pad;
    double local = 0.0;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
        if (kPer * lane + k < num_bins) local += static_cast<double>(w[k]) + hp;
    for (int base = kTile; base < num_bins; base += kTile) {
        float v[kPer];
        load_run(v, w_row, base + kPer * lane, num_bins, vec);
#pragma unroll
        for (int k = 0; k < kPer; ++k)
            if (base + kPer * lane + k < num_bins) local += static_cast<double>(v[k]) + hp;
    }
    const double w_sum = warp_sum(local);
    const double padding = fmax(static_cast<double>(eps) - w_sum, 0.0);
    const double pad_bin = padding / num_bins;
    const double denom = w_sum + padding;

    // the pdf's inclusive scan: sequential within a lane's run, a warp scan
    // of the run totals, a carry from tile to tile
    double carry = 0.0;
    for (int base = 0; base < num_bins; base += kTile) {
        const int lo = base + kPer * lane;
        if (base > 0) load_run(w, w_row, lo, num_bins, vec);
        double pdf[kPer];
        double run = 0.0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            pdf[k] = lo + k < num_bins ? ((static_cast<double>(w[k]) + hp) + pad_bin) / denom : 0.0;
            run += pdf[k];
        }
        double incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const double n = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += n;
        }
        double acc = __shfl_up_sync(kFull, incl, 1);
        acc = carry + (lane == 0 ? 0.0 : acc);
        carry += __shfl_sync(kFull, incl, 31);
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
            acc += pdf[k];
            // entries past S are +inf for the search
            w[k] = lo + k < num_bins ? static_cast<float>(fmin(fmax(acc, 0.0), 1.0))
                                     : __int_as_float(0x7f800000);
        }
#pragma unroll
        for (int k = 0; k < kPer; k += 4)
            if (lo + k + 1 < width)
                *reinterpret_cast<float4*>(cdf + 1 + lo + k) = make_float4(w[k], w[k + 1], w[k + 2], w[k + 3]);
    }
    for (int i = ((num_bins + kTile - 1) / kTile) * kTile + 1 + lane; i < width; i += 32)
        cdf[i] = __int_as_float(0x7f800000);
    if (lane == 0) cdf[0] = 0.0f;
    copy_async_wait();
    __syncwarp();

    // binary lifting: pos = count of cdf[1..] <= q over 2^kLog2P - 1
    // entries; the bracket is min(pos, S - 1)
    for (int j0 = lane; j0 < num_queries; j0 += 32 * kQueries) {
        int pos[kQueries];
#pragma unroll
        for (int k = 0; k < kQueries; ++k) pos[k] = 0;
#pragma unroll
        for (int s = kLog2P - 1; s >= 0; --s) {
#pragma unroll
            for (int k = 0; k < kQueries; ++k) {
                const int t = pos[k] + (1 << s);
                if (cdf[t] <= q[k]) pos[k] = t;
            }
        }
#pragma unroll
        for (int k = 0; k < kQueries; ++k) {
            const int j = j0 + 32 * k;
            if (j < num_queries) {
                const int idx = min(pos[k], num_bins - 1);
                const float c0 = cdf[idx], c1 = cdf[idx + 1];
                const float e0 = edg[idx], e1 = edg[idx + 1];
                const float frac = c1 > c0 ? (q[k] - c0) / fmaxf(c1 - c0, 1e-12f) : 0.0f;
                // no fma contraction: the plain version rounds the product
                o_row[j] = __fadd_rn(e0, __fmul_rn(frac, __fsub_rn(e1, e0)));
            }
            const int next = j + 32 * kQueries;
            q[k] = next < num_queries ? u_row[next] : 0.0f;
        }
    }
}

// K1's launch floor: no work, launched with K1's grid, block and shared memory.
__global__ void __launch_bounds__(kMaxRaysPerBlock * 32, 4) pdf_resample_floor() {}

dim3 grid_for(int num_rays, int num_bins) {
    const int rays = rays_per_block(num_bins);
    return dim3((num_rays + rays - 1) / rays);
}

size_t smem_for(int num_bins) {
    return static_cast<size_t>(rays_per_block(num_bins)) * slice_floats(num_bins) * sizeof(float);
}

template <int kLog2P>
cudaError_t launch(const float* weights, const float* edges, long long edges_stride,
                   const float* u, long long u_stride, float* out, int num_rays, int num_bins,
                   int num_queries, float hist_pad, float eps, cudaStream_t stream) {
    const dim3 grid = grid_for(num_rays, num_bins), block(rays_per_block(num_bins) * 32);
    const size_t smem = smem_for(num_bins);
    if (num_queries > 64)
        pdf_resample_kernel<kLog2P, 4><<<grid, block, smem, stream>>>(
            weights, edges, edges_stride, u, u_stride, out, num_rays, num_bins, num_queries,
            hist_pad, eps);
    else
        pdf_resample_kernel<kLog2P, 2><<<grid, block, smem, stream>>>(
            weights, edges, edges_stride, u, u_stride, out, num_rays, num_bins, num_queries,
            hist_pad, eps);
    return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to float32:
// weights (R, S) contiguous, 1 <= S <= 4096; edges (R, S+1) and u (R, N)
// rows of contiguous floats, edges_stride / u_stride floats apart (0: one
// row for every ray); out (R, N) contiguous. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int pdf_resample_f32(const float* weights,
                                const float* edges, long long edges_stride,
                                const float* u, long long u_stride, float* out,
                                int num_rays, int num_bins, int num_queries,
                                float hist_pad, float eps, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_CASE(k)                                                                       \
    case k:                                                                              \
        return static_cast<int>(launch<k>(weights, edges, edges_stride, u, u_stride, out, \
                                          num_rays, num_bins, num_queries, hist_pad, eps, s));
    switch (log2_ceil(num_bins)) {
        K1_CASE(0) K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5) K1_CASE(6)
        K1_CASE(7) K1_CASE(8) K1_CASE(9) K1_CASE(10) K1_CASE(11) K1_CASE(12)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K1_CASE
}

// The empty kernel with pdf_resample_f32's launch shape for (num_rays,
// num_bins): what a launch of that many warps costs before any work.
extern "C" int pdf_resample_floor_f32(int num_rays, int num_bins, void* stream) {
    pdf_resample_floor<<<grid_for(num_rays, num_bins), rays_per_block(num_bins) * 32,
                         smem_for(num_bins), static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
