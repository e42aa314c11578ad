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
// mu, the conic, the opacity, and w g_img for the payload. It reads total
// from the forward's outputs, total = img . g_img + alpha_out g_alpha, so it
// composites the tile once, not twice. Both kernels walk the rows in
// batches of 128 and stop before a batch once the tile's largest T is at
// most 1e-8, as the Pallas kernels do; T is carried with the same
// arithmetic in both, so they take the same decisions and the backward is
// the exact VJP of what the forward computed.
//
// What bounds them on an H100: operations. Each composited row x pixel pair
// costs about 22 + 2C float32 operations forward (the Gaussian, its exp,
// the gates, the blend) and about 56 + 4C backward (the recomputed
// Gaussian, g_w, the suffix and g_alpha, the six partials, w g_img).
// chip_smoke.py computes both bounds from each run's own counts.
//
// What the design does about that bound. A batch of rows is staged in
// shared memory at a stride padded to a multiple of 4 floats and read back
// as float4 broadcasts. Each thread owns several pixels of the tile, so
// that every row read from shared memory serves all of them and their
// independent chains fill the pipelines; per pixel the blend stays
// sequential. The forward keeps its sums in registers. The backward needs
// each row's partials summed over the tile's 256 pixels. A thread first sums
// its own pixels; then a warp folds the partials of R rows at once: at each
// shuffle step a lane keeps half the values it holds and sends the other
// half, about R (6 + C) shuffles for R rows in place of 5 per value; one
// barrier per R rows, and the warps' sums are added in shared memory and
// stored as R contiguous rows of g_packed. Every sum is taken in a fixed
// order and no atomics are used: each tile owns its rows, and K3's output is
// the same bit for bit from run to run. Nothing is allocated here; the
// wrapper allocates the outputs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPixels = 256;  // 16 x 16 tile
constexpr int kBatch = 128;   // rows per batch, the Pallas kernels' _K_CHUNK
constexpr int kMaxChannels = 16;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kMinOneMinus = static_cast<float>(1.0 - 0.999);
constexpr float kExitEps = 1e-8f;

// pixels a thread owns: the forward's 64 threads a tile keep every tile of
// a full-width image resident at once; the backward's 128 leave registers
// for R rows of partials
constexpr int kFwdPixelsPerThread = 4;
constexpr int kBwdPixelsPerThread = 2;

// Kernels are instantiated for a channel bound CMAX (1, 6 or 16); a row is
// staged at stride round_up(6 + CMAX, 4), its pad columns zero.
__host__ __device__ constexpr int row_stride(int cmax) { return (6 + cmax + 3) / 4 * 4; }
// rows the backward reduces per barrier
__host__ __device__ constexpr int bwd_rows(int cmax) { return cmax <= 6 ? 8 : 4; }

struct Gaussian {
    float dx, dy, sigma, e, raw, alpha;  // e = exp(-sigma), raw = opacity e
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
    g.e = expf(-g.sigma);
    g.raw = __fmul_rn(row[5], g.e);
    const float a = fminf(kAlphaClamp, g.raw);
    g.alpha = (g.sigma >= 0.0f && a >= kAlphaMin) ? a : 0.0f;
    return g;
}

// Zeroes the pad columns [width, S) of every staged row; staging never
// writes them, so once per block suffices.
template <int S, int kThreads>
__device__ __forceinline__ void zero_pad(float* smem, int width) {
    const int pad = S - width;
    for (int i = threadIdx.x; i < kBatch * pad; i += kThreads) {
        const int r = i / pad;
        smem[r * S + width + (i - r * pad)] = 0.0f;
    }
}

// Copies rows [start, start + rows) of one tile into shared memory at
// stride S, as float4s where the rows allow it.
template <int S, int kThreads>
__device__ __forceinline__ void stage(const float* tile, float* smem, int start, int rows,
                                      int width) {
    const float* src = tile + static_cast<size_t>(start) * width;
    if (width % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int w4 = width / 4;
        const float4* src4 = reinterpret_cast<const float4*>(src);
        for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
            const int r = i / w4;
            reinterpret_cast<float4*>(smem + r * S)[i - r * w4] = src4[i];
        }
    } else {
        for (int i = threadIdx.x; i < rows * width; i += kThreads) {
            const int r = i / width;
            smem[r * S + (i - r * width)] = src[i];
        }
    }
}

template <int S>
__device__ __forceinline__ void load_row(const float* smem_row, float (&row)[S]) {
#pragma unroll
    for (int i = 0; i < S / 4; ++i) {
        const float4 q = reinterpret_cast<const float4*>(smem_row)[i];
        row[4 * i] = q.x;
        row[4 * i + 1] = q.y;
        row[4 * i + 2] = q.z;
        row[4 * i + 3] = q.w;
    }
}

// How many of a fold's five shuffle steps halve the N values a lane holds:
// halving goes on while N is even.
__host__ __device__ constexpr int fold_halvings(int n, int steps = 5) {
    return (steps == 0 || n % 2 != 0) ? 0 : 1 + fold_halvings(n / 2, steps - 1);
}

// Sums each of the first N values of v over the warp's 32 lanes. While N is
// even, a step keeps the lower or the upper half (by the lane's bit OFF) and
// adds the partner's copy of the same half, so the values held halve; once
// N is odd, a step adds the partner's values in place. After the five steps
// lane l holds in v[0, M) the sums of values (l >> (5 - H)) M + [0, M),
// H = fold_halvings(N), M = N >> H. Every sum is taken in a fixed order.
template <int N, int OFF, int NV>
__device__ __forceinline__ void warp_fold(float (&v)[NV], int lane) {
    if constexpr (OFF > 0) {
        if constexpr (N % 2 == 0) {
            constexpr int H = N / 2;
            const bool upper = (lane & OFF) != 0;
#pragma unroll
            for (int i = 0; i < H; ++i) {
                const float send = upper ? v[i] : v[i + H];
                const float keep = upper ? v[i + H] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
            }
            warp_fold<H, OFF / 2>(v, lane);
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], OFF);
            warp_fold<N, OFF / 2>(v, lane);
        }
    }
}

template <int CMAX>
__global__ void __launch_bounds__(kPixels / kFwdPixelsPerThread)
composite_fwd_kernel(const float* __restrict__ packed, const float* __restrict__ pix,
                     const int* __restrict__ counts, float* __restrict__ img,
                     float* __restrict__ alpha_out, int k, int c_chan) {
    constexpr int kPPT = kFwdPixelsPerThread;
    constexpr int kThreads = kPixels / kPPT;
    constexpr int S = row_stride(CMAX);
    __shared__ __align__(16) float rows[kBatch * S];
    const int width = 6 + c_chan;
    const size_t t = blockIdx.x;
    const float* tile = packed + t * k * width;
    const int n = min(max(counts[t], 0), k);
    zero_pad<S, kThreads>(rows, width);

    float px[kPPT], py[kPPT], trans[kPPT], asum[kPPT], acc[kPPT][CMAX];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
        const size_t p = t * kPixels + threadIdx.x + q * kThreads;
        px[q] = pix[p * 2];
        py[q] = pix[p * 2 + 1];
        trans[q] = 1.0f;
        asum[q] = 0.0f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) acc[q][c] = 0.0f;
    }
    for (int start = 0; start < n; start += kBatch) {
        bool open = false;
#pragma unroll
        for (int q = 0; q < kPPT; ++q) open |= trans[q] > kExitEps;
        // also the barrier before the batch buffer is overwritten
        if (!__syncthreads_or(open)) break;
        const int m = min(kBatch, n - start);
        stage<S, kThreads>(tile, rows, start, m, width);
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            float row[S];
            load_row<S>(rows + j * S, row);
#pragma unroll
            for (int q = 0; q < kPPT; ++q) {
                const Gaussian g = evaluate(row, px[q], py[q]);
                const float w = g.alpha * trans[q];
#pragma unroll
                for (int c = 0; c < CMAX; ++c) acc[q][c] += w * row[6 + c];  // pad columns are 0
                asum[q] += w;
                trans[q] *= fmaxf(1.0f - g.alpha, kMinOneMinus);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
        const size_t p = t * kPixels + threadIdx.x + q * kThreads;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
            if (c < c_chan) img[p * c_chan + c] = acc[q][c];
        }
        alpha_out[p] = asum[q];
    }
}

template <int CMAX>
__global__ void __launch_bounds__(kPixels / kBwdPixelsPerThread)
composite_bwd_kernel(const float* __restrict__ packed, const float* __restrict__ pix,
                     const int* __restrict__ counts, const float* __restrict__ img,
                     const float* __restrict__ alpha_out, const float* __restrict__ g_img,
                     const float* __restrict__ g_alpha, float* __restrict__ g_packed,
                     int k, int c_chan) {
    constexpr int kPPT = kBwdPixelsPerThread;
    constexpr int kThreads = kPixels / kPPT;
    constexpr int kWarps = kThreads / 32;
    constexpr int S = row_stride(CMAX);
    constexpr int D = 6 + CMAX;  // partials of one row
    constexpr int R = bwd_rows(CMAX);
    constexpr int NV = R * D;  // partials of R rows
    constexpr int H = fold_halvings(NV);
    constexpr int M = NV >> H;  // values a lane holds after the fold
    __shared__ __align__(16) float rows[kBatch * S];
    __shared__ float partial[2][kWarps][NV];  // double-buffered by row group
    const int width = 6 + c_chan;
    const size_t t = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float* tile = packed + t * k * width;
    float* g_tile = g_packed + t * k * width;
    const int n = min(max(counts[t], 0), k);
    zero_pad<S, kThreads>(rows, width);

    float px[kPPT], py[kPPT], gi[kPPT][CMAX], ga[kPPT], total[kPPT], trans[kPPT],
        prefix[kPPT];
#pragma unroll
    for (int q = 0; q < kPPT; ++q) {
        const size_t p = t * kPixels + threadIdx.x + q * kThreads;
        px[q] = pix[p * 2];
        py[q] = pix[p * 2 + 1];
        ga[q] = g_alpha[p];
        // total = sum of w g_w over the composited rows, from the outputs
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
            gi[q][c] = c < c_chan ? g_img[p * c_chan + c] : 0.0f;
            if (c < c_chan) s += img[p * c_chan + c] * gi[q][c];
        }
        total[q] = s + alpha_out[p] * ga[q];
        trans[q] = 1.0f;
        prefix[q] = 0.0f;
    }

    int done = 0;  // rows composited
    int group = 0;
    for (int start = 0; start < n; start += kBatch) {
        bool open = false;
#pragma unroll
        for (int q = 0; q < kPPT; ++q) open |= trans[q] > kExitEps;
        if (!__syncthreads_or(open)) break;  // K2's decision, on the same T
        const int m = min(kBatch, n - start);
        stage<S, kThreads>(tile, rows, start, m, width);
        __syncthreads();
        for (int j0 = 0; j0 < m; j0 += R, ++group) {
            const int live_rows = min(R, m - j0);
            float v[NV];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float* pr = v + r * D;
#pragma unroll
                for (int i = 0; i < D; ++i) pr[i] = 0.0f;
                if (r >= live_rows) continue;  // the same for every thread
                float row[S];
                load_row<S>(rows + (j0 + r) * S, row);
#pragma unroll
                for (int q = 0; q < kPPT; ++q) {
                    const Gaussian g = evaluate(row, px[q], py[q]);
                    const float one_minus = fmaxf(1.0f - g.alpha, kMinOneMinus);
                    const float w = g.alpha * trans[q];
                    float gw = 0.0f;
#pragma unroll
                    for (int c = 0; c < CMAX; ++c) gw += row[6 + c] * gi[q][c];
                    gw += ga[q];
                    prefix[q] += w * gw;
                    const bool live =
                        g.sigma >= 0.0f && g.raw >= kAlphaMin && g.raw < kAlphaClamp;
                    const float g_a =
                        live ? trans[q] * gw - __fdividef(total[q] - prefix[q], one_minus) : 0.0f;
                    const float g_sigma = -g_a * g.raw;
                    const float hx = 0.5f * g_sigma * g.dx;
                    const float hy = 0.5f * g_sigma * g.dy;
                    pr[0] -= g_sigma * (row[2] * g.dx + row[3] * g.dy);
                    pr[1] -= g_sigma * (row[4] * g.dy + row[3] * g.dx);
                    pr[2] += hx * g.dx;
                    pr[3] += g_sigma * g.dx * g.dy;
                    pr[4] += hy * g.dy;
                    pr[5] += g_a * g.e;
#pragma unroll
                    for (int c = 0; c < CMAX; ++c) pr[6 + c] += w * gi[q][c];
                    trans[q] *= one_minus;
                }
            }
            warp_fold<NV, 16>(v, lane);
            float* slot = &partial[group & 1][warp][0];
            if ((lane & ((1 << (5 - H)) - 1)) == 0) {
                const int base = (lane >> (5 - H)) * M;
#pragma unroll
                for (int i = 0; i < M; ++i) slot[base + i] = v[i];
            }
            __syncthreads();
            // R rows of g_packed, one contiguous store; rows past m get none
            for (int p = threadIdx.x; p < live_rows * width; p += kThreads) {
                const int r = p / width;
                const int i = r * D + (p - r * width);
                float s = 0.0f;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) s += partial[group & 1][w][i];
                g_tile[static_cast<size_t>(start + j0) * width + p] = s;
            }
        }
        done = start + m;
    }
    // rows the forward did not composite get no gradient
    for (int i = done * width + threadIdx.x; i < k * width; i += kThreads) g_tile[i] = 0.0f;
}

template <int CMAX>
int launch_fwd(const float* packed, const float* pix, const int* counts, float* img,
               float* alpha, int num_tiles, int k, int c_chan, cudaStream_t stream) {
    composite_fwd_kernel<CMAX><<<num_tiles, kPixels / kFwdPixelsPerThread, 0, stream>>>(
        packed, pix, counts, img, alpha, k, c_chan);
    return static_cast<int>(cudaGetLastError());
}

template <int CMAX>
int launch_bwd(const float* packed, const float* pix, const int* counts, const float* img,
               const float* alpha, const float* g_img, const float* g_alpha, float* g_packed,
               int num_tiles, int k, int c_chan, cudaStream_t stream) {
    composite_bwd_kernel<CMAX><<<num_tiles, kPixels / kBwdPixelsPerThread, 0, stream>>>(
        packed, pix, counts, img, alpha, g_img, g_alpha, g_packed, k, c_chan);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, loaded with ctypes. Pointers are device pointers to
// contiguous arrays: packed (T, K, 6 + C) float32, pix (T, 256, 2) float32,
// counts (T,) int32, img (T, 256, C), alpha (T, 256), g_img (T, 256, C),
// g_alpha (T, 256), g_packed (T, K, 6 + C), all float32. The backward's img
// and alpha are the forward's outputs for the same inputs. Each launches on
// `stream` and returns cudaGetLastError().
extern "C" int composite_fwd_f32(const float* packed, const float* pix, const int* counts,
                                 float* img, float* alpha, int num_tiles, int k,
                                 int c_chan, void* stream) {
    if (num_tiles < 1 || k < 1 || c_chan < 1 || c_chan > kMaxChannels) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    if (c_chan <= 1) return launch_fwd<1>(packed, pix, counts, img, alpha, num_tiles, k, c_chan, s);
    if (c_chan <= 6) return launch_fwd<6>(packed, pix, counts, img, alpha, num_tiles, k, c_chan, s);
    return launch_fwd<kMaxChannels>(packed, pix, counts, img, alpha, num_tiles, k, c_chan, s);
}

extern "C" int composite_bwd_f32(const float* packed, const float* pix, const int* counts,
                                 const float* img, const float* alpha, const float* g_img,
                                 const float* g_alpha, float* g_packed, int num_tiles, int k,
                                 int c_chan, void* stream) {
    if (num_tiles < 1 || k < 1 || c_chan < 1 || c_chan > kMaxChannels) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto s = static_cast<cudaStream_t>(stream);
    if (c_chan <= 1) {
        return launch_bwd<1>(packed, pix, counts, img, alpha, g_img, g_alpha, g_packed,
                             num_tiles, k, c_chan, s);
    }
    if (c_chan <= 6) {
        return launch_bwd<6>(packed, pix, counts, img, alpha, g_img, g_alpha, g_packed,
                             num_tiles, k, c_chan, s);
    }
    return launch_bwd<kMaxChannels>(packed, pix, counts, img, alpha, g_img, g_alpha, g_packed,
                                    num_tiles, k, c_chan, s);
}
