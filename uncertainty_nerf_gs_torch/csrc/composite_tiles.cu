// Tile compositing of packed Gaussians for Hopper (sm_90a): forward (K2)
// and its analytic backward (K3).
//
// Replaces the Pallas TPU kernels of uncertainty_nerf_gs_tpu/ops/
// rasterize_pallas.py: _fwd_call (body _fwd_kernel) and _bwd_call (body
// _bwd_kernel), the two halves of the custom VJP composite_tiles. Each tile
// t of 16x16 pixels has K depth-sorted packed rows of D = 6 + C floats,
// [mu_x, mu_y, conic_a, conic_b, conic_c, opacity, payload_0..C-1], of which
// the first counts[t] are live. Per pixel, front to back:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  raw = opacity exp(-sigma)
//   alpha = min(0.999, raw), zeroed where sigma < 0 or alpha < 1/255
//   w = alpha T,  T *= max(1 - alpha, 1 - 0.999)
//   img[c] = sum w payload[c],  alpha_out = sum w.
// The backward, with g_w = payload . g_img + g_alpha, total = sum w g_w and
// prefix_k the inclusive prefix of w g_w, sets
//   g_alpha_k = T_k g_w - (total - prefix_k) / (1 - alpha_k),
// keeps it where sigma >= 0 and 1/255 <= raw < 0.999, and carries it to
// mu, the conic, the opacity, and w g_img for the payload. Both kernels
// walk the rows in batches of 128 and stop before a batch once the tile's
// largest T is at most 1e-8, as the Pallas kernels do, so the backward is
// the exact VJP of what the forward computed.
//
// What bounds them on an H100: operations. Each composited row x pixel pair
// costs about 22 + 2C float32 operations forward (the Gaussian, its exp,
// the gates, the blend) and about 78 + 6C backward (the recomputed forward
// of both passes, the six partials, w g_img, the row sums). At the repo's
// splat benchmark shape (65,536 slots, 640x480, capacity 384, C = 6: 1200
// tiles) the counts of chip_smoke.py's scene give 253,045 live rows, 6.5e7
// pairs: K2 needs 2.2 GFLOP, 33 us at 67 TFLOP/s, against 23 MB, 7 us at
// 3.35 TB/s; K3 7.4 GFLOP, 110 us, against 45 MB. chip_smoke.py computes
// both bounds from each run's own counts.
//
// What the design does about that bound: one block of 256 threads per tile,
// one pixel per thread, so each pair is computed once, in registers, with
// no (K, P) intermediate in device memory. A batch of rows is staged in
// shared memory with coalesced loads and read by all 256 threads as
// broadcasts. The forward keeps its C sums in registers. The backward needs
// each row's partials summed over the tile's 256 pixels: warp shuffles,
// then one shared-memory step across the 8 warps, written straight to
// g_packed[t, k, :] with no atomics, since each tile owns its rows. That
// per-row reduction, not the arithmetic, sets K3's time; making it cheaper
// (reducing several rows at once) is later work. Nothing is allocated here;
// the wrapper allocates the outputs.

#include <cuda_runtime.h>

namespace {

constexpr int kPixels = 256;  // 16 x 16 tile: one thread per pixel
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 128;  // rows per batch, the Pallas kernels' _K_CHUNK
constexpr int kMaxChannels = 16;
constexpr int kMaxWidth = 6 + kMaxChannels;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kMinOneMinus = static_cast<float>(1.0 - 0.999);
constexpr float kExitEps = 1e-8f;

struct Gaussian {
    float dx, dy, sigma, raw, alpha;
};

// The Gaussian is evaluated in the order of the plain version
// (ops/composite.py::_alphas), each product and sum rounded on its own, with
// no contraction into an fma, so that on the same inputs the kernels take the
// same gate decisions as the plain versions on the card: where raw sits at
// 1/255, a gate decided the other way moves a pixel by up to 4e-3, and where
// raw sits at 0.999 it switches that row's gradient at that pixel on or off.
__device__ __forceinline__ Gaussian evaluate(const float* row, float px, float py) {
    Gaussian g;
    g.dx = __fsub_rn(px, row[0]);
    g.dy = __fsub_rn(py, row[1]);
    const float quad = __fadd_rn(__fmul_rn(__fmul_rn(row[2], g.dx), g.dx),
                                 __fmul_rn(__fmul_rn(row[4], g.dy), g.dy));
    g.sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(row[3], g.dx), g.dy));
    g.raw = __fmul_rn(row[5], expf(-g.sigma));
    const float a = fminf(kAlphaClamp, g.raw);
    g.alpha = (g.sigma >= 0.0f && a >= kAlphaMin) ? a : 0.0f;
    return g;
}

// Copies rows [start, start + rows) of one tile into shared memory.
__device__ __forceinline__ void stage(const float* tile, float* smem, int start,
                                      int rows, int width) {
    const float* src = tile + static_cast<size_t>(start) * width;
    for (int i = threadIdx.x; i < rows * width; i += kPixels) smem[i] = src[i];
}

__global__ void __launch_bounds__(kPixels)
composite_fwd_kernel(const float* __restrict__ packed, const float* __restrict__ pix,
                     const int* __restrict__ counts, float* __restrict__ img,
                     float* __restrict__ alpha_out, int k, int c_chan) {
    __shared__ float rows[kBatch * kMaxWidth];
    const int width = 6 + c_chan;
    const size_t t = blockIdx.x;
    const int p = threadIdx.x;
    const float* tile = packed + t * k * width;
    const float px = pix[(t * kPixels + p) * 2];
    const float py = pix[(t * kPixels + p) * 2 + 1];
    const int n = min(max(counts[t], 0), k);

    float acc[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) acc[c] = 0.0f;
    float asum = 0.0f;
    float trans = 1.0f;
    for (int start = 0; start < n; start += kBatch) {
        // also the barrier before the batch buffer is overwritten
        if (!__syncthreads_or(trans > kExitEps)) break;
        const int m = min(kBatch, n - start);
        stage(tile, rows, start, m, width);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float* row = rows + j * width;
            const Gaussian g = evaluate(row, px, py);
            const float w = g.alpha * trans;
#pragma unroll
            for (int c = 0; c < kMaxChannels; ++c) {
                if (c < c_chan) acc[c] += w * row[6 + c];
            }
            asum += w;
            trans *= fmaxf(1.0f - g.alpha, kMinOneMinus);
        }
    }
    float* out = img + (t * kPixels + p) * c_chan;
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
        if (c < c_chan) out[c] = acc[c];
    }
    alpha_out[t * kPixels + p] = asum;
}

__global__ void __launch_bounds__(kPixels)
composite_bwd_kernel(const float* __restrict__ packed, const float* __restrict__ pix,
                     const int* __restrict__ counts, const float* __restrict__ g_img,
                     const float* __restrict__ g_alpha, float* __restrict__ g_packed,
                     int k, int c_chan) {
    __shared__ float rows[kBatch * kMaxWidth];
    __shared__ float partial[2][kWarps][kMaxWidth];  // double-buffered by row
    const int width = 6 + c_chan;
    const size_t t = blockIdx.x;
    const int p = threadIdx.x;
    const int lane = p & 31;
    const int warp = p >> 5;
    const float* tile = packed + t * k * width;
    float* g_tile = g_packed + t * k * width;
    const float px = pix[(t * kPixels + p) * 2];
    const float py = pix[(t * kPixels + p) * 2 + 1];
    const int n = min(max(counts[t], 0), k);

    float gi[kMaxChannels];
#pragma unroll
    for (int c = 0; c < kMaxChannels; ++c) {
        gi[c] = c < c_chan ? g_img[(t * kPixels + p) * c_chan + c] : 0.0f;
    }
    const float ga = g_alpha[t * kPixels + p];

    // pass A: total = sum of w g_w over the rows the forward composited
    float trans = 1.0f;
    float total = 0.0f;
    int batches = 0;
    for (int start = 0; start < n; start += kBatch) {
        if (!__syncthreads_or(trans > kExitEps)) break;
        const int m = min(kBatch, n - start);
        stage(tile, rows, start, m, width);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float* row = rows + j * width;
            const Gaussian g = evaluate(row, px, py);
            float gw = 0.0f;
#pragma unroll
            for (int c = 0; c < kMaxChannels; ++c) {
                if (c < c_chan) gw += row[6 + c] * gi[c];
            }
            gw += ga;
            total += g.alpha * trans * gw;
            trans *= fmaxf(1.0f - g.alpha, kMinOneMinus);
        }
        ++batches;
    }
    const int done = min(batches * kBatch, n);

    // pass B: per row, this pixel's partials, summed over the tile
    trans = 1.0f;
    float prefix = 0.0f;
    for (int b = 0; b < batches; ++b) {
        const int start = b * kBatch;
        const int m = min(kBatch, n - start);
        __syncthreads();  // every thread is done with the previous batch
        stage(tile, rows, start, m, width);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float* row = rows + j * width;
            const Gaussian g = evaluate(row, px, py);
            const float one_minus = fmaxf(1.0f - g.alpha, kMinOneMinus);
            const float w = g.alpha * trans;
            float gw = 0.0f;
#pragma unroll
            for (int c = 0; c < kMaxChannels; ++c) {
                if (c < c_chan) gw += row[6 + c] * gi[c];
            }
            gw += ga;
            prefix += w * gw;
            const bool live = g.sigma >= 0.0f && g.raw >= kAlphaMin && g.raw < kAlphaClamp;
            const float g_a = live ? trans * gw - (total - prefix) / one_minus : 0.0f;
            const float g_sigma = -g_a * g.raw;
            float v[kMaxWidth];
            v[0] = g_sigma * -(row[2] * g.dx + row[3] * g.dy);
            v[1] = g_sigma * -(row[4] * g.dy + row[3] * g.dx);
            v[2] = 0.5f * g_sigma * g.dx * g.dx;
            v[3] = g_sigma * g.dx * g.dy;
            v[4] = 0.5f * g_sigma * g.dy * g.dy;
            v[5] = g_a * expf(-g.sigma);
#pragma unroll
            for (int c = 0; c < kMaxChannels; ++c) v[6 + c] = w * gi[c];

            float (*slot)[kMaxWidth] = partial[(start + j) & 1];
#pragma unroll
            for (int i = 0; i < kMaxWidth; ++i) {
                if (i < width) {
                    float s = v[i];
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
                    if (lane == 0) slot[warp][i] = s;
                }
            }
            __syncthreads();
            if (p < width) {
                float s = 0.0f;
#pragma unroll
                for (int q = 0; q < kWarps; ++q) s += slot[q][p];
                g_tile[static_cast<size_t>(start + j) * width + p] = s;
            }
            trans *= one_minus;
        }
    }
    // rows the forward did not composite get no gradient
    for (int i = done * width + p; i < k * width; i += kPixels) g_tile[i] = 0.0f;
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous arrays: packed (T, K, 6 + C) float32, pix (T, 256, 2) float32,
// counts (T,) int32, img (T, 256, C), alpha (T, 256), g_img (T, 256, C),
// g_alpha (T, 256), g_packed (T, K, 6 + C), all float32. Each launches on
// `stream` and returns cudaGetLastError().
extern "C" int composite_fwd_f32(const float* packed, const float* pix, const int* counts,
                                 float* img, float* alpha, int num_tiles, int k,
                                 int c_chan, void* stream) {
    if (num_tiles < 1 || k < 1 || c_chan < 1 || c_chan > kMaxChannels) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    composite_fwd_kernel<<<num_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, pix, counts, img, alpha, k, c_chan);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int composite_bwd_f32(const float* packed, const float* pix, const int* counts,
                                 const float* g_img, const float* g_alpha, float* g_packed,
                                 int num_tiles, int k, int c_chan, void* stream) {
    if (num_tiles < 1 || k < 1 || c_chan < 1 || c_chan > kMaxChannels) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    composite_bwd_kernel<<<num_tiles, kPixels, 0, static_cast<cudaStream_t>(stream)>>>(
        packed, pix, counts, g_img, g_alpha, g_packed, k, c_chan);
    return static_cast<int>(cudaGetLastError());
}
