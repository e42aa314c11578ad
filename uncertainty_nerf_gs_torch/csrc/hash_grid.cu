// Hash-grid cell lookup for Hopper (sm_90a): forward (K4) and backward (K5).
//
// The TPU side has this lookup in uncertainty_nerf_gs_tpu/ops/encodings.py::
// cell_lookup (one row gather per sample and level, `tables[lvl][idx // cpr]`),
// and probed the row gather as a Pallas DMA kernel in experiments/jobs/
// 403_pallas_gather_probe.py::pallas_gather. Both kernels here compute, per
// sample i and level l, what uncertainty_nerf_gs_torch/ops/encodings.py::
// cell_indices and cell_lookup_reference compute:
//   scaled = pos * res                         (no fma contraction)
//   base   = min(floor(clamp(scaled, 0, float(res * (1 - 1e-7)))), res - 1)
//   frac   = scaled - base
//   idx    = bx + res * (by + res * bz)        where res^3 <= table_size,
//            (bx * 1 ^ by * 2654435761 ^ bz * 805459861) % table_size
//                                              otherwise, in uint32
//   w[c]   = (wx[c >> 2] * wy[(c >> 1) & 1]) * wz[c & 1],  wx = (1 - fx, fx)
//   K4: out[i, l * F + f] = sum_c w[c] * cell[l, idx, c, f]
//   K5: g_cells[l, idx, c, f] += w[c] * g_out[i, l * F + f]   (atomics)
//       g_pos[i, d] += res * sum_c dw[c]/dfrac_d * <cell[l, idx, c, :], g_out[i, l, :]>
// The cells are the JAX package's (L, n_rows, 128) rows read as (L, n_rows *
// 128 / (8 F), 8, F): a cell is 8 F consecutive floats (64 B at F = 2).
// The cell index must equal the plain version's bit for bit: a sample moved
// into the neighbouring cell reads other corners, and the features jump by
// the table's scale. So scaled, frac and the weights are formed with
// __fmul_rn / __fsub_rn in the plain version's order, and the clamp bound is
// the float the wrapper's Python scalar rounds to.
//
// What bounds them on an H100: bytes, and the latency of random 64-byte
// reads. A lookup reads 12 B of position (shared by the L lookups of a
// sample), one 64 B cell and writes 4 F B; the float work is about 60
// operations. At the training step's main field (4,096 rays x 48 samples x
// 16 levels) that is about 229 MB if every lookup's cell is counted, less
// where lookups share a cell (the coarse dense levels have 4,096 cells).
//
// What the design does about that: one thread per (sample, level), the
// level fastest, so a warp's output stores are contiguous, the L threads of
// a sample read its position from one cache line, and millions of
// independent 16-byte loads are in flight to hide the gather's latency; each
// cell is read as 2 F float4s. K5 scatters with one float atomic add per
// cell float: the coarse dense levels take every sample of a launch and
// their atomics contend, which a later PR can attack; the position gradient
// is added atomically across the L levels of a sample. Nothing is allocated
// here; the wrapper zero-fills g_cells and g_pos.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Levels {
    float res[kMaxLevels];  // float(res), the factor of scaled
    float hi[kMaxLevels];   // float(res * (1 - 1e-7)) rounded from double
    int ires[kMaxLevels];
    unsigned dense;         // bit l: level l indexes densely
};

struct Cell {
    unsigned idx;
    float w[3][2];  // per axis: (1 - frac, frac)
};

__device__ __forceinline__ Cell locate(const float p[3], const Levels& lv, int l,
                                       unsigned table_size) {
    Cell cell;
    int b[3];
    const int res = lv.ires[l];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float scaled = __fmul_rn(p[d], lv.res[l]);
        const float clamped = fminf(fmaxf(scaled, 0.0f), lv.hi[l]);
        b[d] = min(static_cast<int>(floorf(clamped)), res - 1);
        const float frac = __fsub_rn(scaled, static_cast<float>(b[d]));
        cell.w[d][0] = __fsub_rn(1.0f, frac);
        cell.w[d][1] = frac;
    }
    if ((lv.dense >> l) & 1u) {
        cell.idx = static_cast<unsigned>(b[0] + res * (b[1] + res * b[2]));
    } else {
        const unsigned h = static_cast<unsigned>(b[0]) ^
                           static_cast<unsigned>(b[1]) * 2654435761u ^
                           static_cast<unsigned>(b[2]) * 805459861u;
        cell.idx = h % table_size;
    }
    return cell;
}

__device__ __forceinline__ float corner_weight(const Cell& cell, int c) {
    return __fmul_rn(__fmul_rn(cell.w[0][c >> 2], cell.w[1][(c >> 1) & 1]), cell.w[2][c & 1]);
}

// The 8 F floats of one cell, read as 2 F float4s (cells are 16-byte aligned).
template <int F>
__device__ __forceinline__ void load_cell(const float* cell_ptr, float (&v)[8 * F]) {
    const float4* src = reinterpret_cast<const float4*>(cell_ptr);
#pragma unroll
    for (int k = 0; k < 2 * F; ++k) {
        const float4 q = __ldg(src + k);
        v[4 * k] = q.x;
        v[4 * k + 1] = q.y;
        v[4 * k + 2] = q.z;
        v[4 * k + 3] = q.w;
    }
}

template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_fwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ cells,
    float* __restrict__ out, int num_lookups, int num_levels, long long level_stride,
    unsigned table_size, Levels lv) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= num_lookups) return;
    const int i = t / num_levels;
    const int l = t - i * num_levels;
    const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
    const Cell cell = locate(p, lv, l, table_size);
    float v[8 * F];
    load_cell<F>(cells + l * level_stride + static_cast<long long>(cell.idx) * (8 * F), v);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float w = corner_weight(cell, c);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = fmaf(w, v[c * F + f], acc[f]);
    }
    // out is (n, L * F), level-major: lookup t's features are floats [t F, t F + F)
#pragma unroll
    for (int f = 0; f < F; ++f) out[static_cast<long long>(t) * F + f] = acc[f];
}

template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ cells,
    const float* __restrict__ g_out, float* __restrict__ g_cells, float* __restrict__ g_pos,
    int num_lookups, int num_levels, long long level_stride, unsigned table_size, Levels lv) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= num_lookups) return;
    const int i = t / num_levels;
    const int l = t - i * num_levels;
    const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
    const Cell cell = locate(p, lv, l, table_size);
    float g[F];
#pragma unroll
    for (int f = 0; f < F; ++f) g[f] = g_out[static_cast<long long>(t) * F + f];
    const long long offset = l * level_stride + static_cast<long long>(cell.idx) * (8 * F);
    float* dst = g_cells + offset;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float w = corner_weight(cell, c);
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(dst + c * F + f, w * g[f]);
    }
    if (g_pos == nullptr) return;
    float v[8 * F];
    load_cell<F>(cells + offset, v);
    float grad[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        float dot = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot = fmaf(v[c * F + f], g[f], dot);
        const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
        // d w[c] / d frac_x = (cx ? 1 : -1) * wy * wz, and likewise for y, z
        const float sx = cx ? 1.0f : -1.0f, sy = cy ? 1.0f : -1.0f, sz = cz ? 1.0f : -1.0f;
        grad[0] = fmaf(sx * cell.w[1][cy] * cell.w[2][cz], dot, grad[0]);
        grad[1] = fmaf(sy * cell.w[0][cx] * cell.w[2][cz], dot, grad[1]);
        grad[2] = fmaf(sz * cell.w[0][cx] * cell.w[1][cy], dot, grad[2]);
    }
    // d frac / d pos = res; the L levels of a sample add into one row
#pragma unroll
    for (int d = 0; d < 3; ++d) atomicAdd(g_pos + 3 * i + d, lv.res[l] * grad[d]);
}

// Per-level constants from the host's resolutions. Returns false on what the
// kernels do not take.
bool make_levels(const int* resolutions, int num_levels, int table_size, Levels* lv) {
    if (num_levels < 1 || num_levels > kMaxLevels || table_size < 1) return false;
    lv->dense = 0u;
    for (int l = 0; l < num_levels; ++l) {
        const int res = resolutions[l];
        if (res < 1) return false;
        lv->ires[l] = res;
        lv->res[l] = static_cast<float>(res);
        // torch.clamp(scaled, 0, res * (1 - 1e-7)) rounds its Python scalar
        // to float32: the same double product, rounded to nearest
        lv->hi[l] = static_cast<float>(static_cast<double>(res) * (1.0 - 1e-7));
        const long long cube = static_cast<long long>(res) * res * res;
        if (cube <= table_size) lv->dense |= 1u << l;
    }
    return true;
}

int blocks_for(int num_lookups) { return (num_lookups + kThreads - 1) / kThreads; }

}  // namespace

// C interface, loaded with ctypes. Device pointers to float32: positions
// (n, 3) contiguous; cells (L, n_rows, 128) contiguous, level_stride =
// n_rows * 128 floats, 16-byte aligned; out (n, L * F) contiguous.
// resolutions is a host array of L ints; features is F in {1, 2, 4, 8, 16};
// n * L < 2^31. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int cell_lookup_fwd_f32(const float* positions, const float* cells, float* out,
                                   int n, int num_levels, long long level_stride,
                                   int table_size, int features, const int* resolutions,
                                   void* stream) {
    Levels lv;
    if (!make_levels(resolutions, num_levels, table_size, &lv) || n < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int lookups = n * num_levels;
    if (lookups == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned ts = static_cast<unsigned>(table_size);
#define K4_CASE(f)                                                                      \
    case f:                                                                             \
        cell_lookup_fwd_kernel<f><<<blocks_for(lookups), kThreads, 0, s>>>(             \
            positions, cells, out, lookups, num_levels, level_stride, ts, lv);          \
        break;
    switch (features) {
        K4_CASE(1) K4_CASE(2) K4_CASE(4) K4_CASE(8) K4_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K4_CASE
    return static_cast<int>(cudaGetLastError());
}

// As cell_lookup_fwd_f32, with g_out (n, L * F) contiguous, g_cells of the
// cells' shape and g_pos (n, 3), both zero-filled by the caller; g_pos may
// be null, and then cells is not read.
extern "C" int cell_lookup_bwd_f32(const float* positions, const float* cells,
                                   const float* g_out, float* g_cells, float* g_pos, int n,
                                   int num_levels, long long level_stride, int table_size,
                                   int features, const int* resolutions, void* stream) {
    Levels lv;
    if (!make_levels(resolutions, num_levels, table_size, &lv) || n < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int lookups = n * num_levels;
    if (lookups == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned ts = static_cast<unsigned>(table_size);
#define K5_CASE(f)                                                                      \
    case f:                                                                             \
        cell_lookup_bwd_kernel<f><<<blocks_for(lookups), kThreads, 0, s>>>(             \
            positions, cells, g_out, g_cells, g_pos, lookups, num_levels, level_stride, \
            ts, lv);                                                                    \
        break;
    switch (features) {
        K5_CASE(1) K5_CASE(2) K5_CASE(4) K5_CASE(8) K5_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K5_CASE
    return static_cast<int>(cudaGetLastError());
}
