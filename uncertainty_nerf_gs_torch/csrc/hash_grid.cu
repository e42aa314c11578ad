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
//   K4: out[i, l * F + f] = sum_c w[c] * cell[l, idx, c, f], summed in the
//       tree ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))
//   K5: g_cells[l, idx, c, f] = sum over the lookups (i, l) of that cell of
//                               w[c] * g_out[i, l * F + f]
//       g_pos[i, d] = sum_l res_l * sum_c dw[c]/dfrac_d * <cell[l, idx, c, :], g_out[i, l, :]>
// The cells are the JAX package's (L, n_rows, 128) rows read as (L, n_rows *
// 128 / (8 F), 8, F): a cell is 8 F consecutive floats (64 B at F = 2).
// The cell index must equal the plain version's bit for bit: a sample moved
// into the neighbouring cell reads other corners, and the features jump by
// the table's scale. So scaled, frac and the weights are formed with
// __fmul_rn / __fsub_rn in the plain version's order, and the clamp bound is
// the float the wrapper's Python scalar rounds to.
//
// K4 replaces the row gather that experiments/jobs/403_pallas_gather_probe.py::
// pallas_gather probed for uncertainty_nerf_gs_tpu/ops/encodings.py::
// cell_lookup, and does the whole lookup: index, gather and trilerp of every
// level in one launch. What bounds it on an H100: bytes and the load path. A
// lookup reads one 64-byte cell (F = 2) and writes 4 F bytes; the float work
// (about 25 operations to locate the cell, 16 F to weigh and sum its
// corners) is far below the float32 rate. The proposals' touched tables
// (about 23 MB) stay in the 50 MB L2, so their limit is how many L1
// wavefronts and L2 requests the loads cost; the field's 10 hashed levels
// (32 MB each) do not fit, and it reads random 64-byte cells from DRAM. With
// one thread a lookup, each reading its cell as 2 F float4s of its own, a
// warp-wide load touches up to 32 lines, about 4 wavefronts a lookup.
// What the design does about that:
//   - A warp takes 32 consecutive samples and walks all L levels, one at a
//     time; lane s keeps sample s's position in registers and locates its
//     cell once a level.
//   - Shared reads: 2 F lanes share each lookup's read, one float4 of the
//     cell each, so a warp-wide load covers 32 / (2 F) whole cells of
//     consecutive samples (at most 8 lines at F = 2, about one wavefront a
//     lookup). The lanes take the cell index and the fractions from the
//     locating lane by __shfl_sync.
//   - Own reads: where neighbouring samples share cells (samples along a
//     ray at a coarse level), each lane reads its own cell; lanes that read
//     one cell share the wavefront, and the warp saves the shuffles and the
//     lanes' repeated weights. The warp counts the runs of equal cells among
//     its 32 lookups (one ballot) and takes own reads at kK4OwnMaxRuns runs
//     or fewer, shared reads above. Both load 2 F float4s a lane at F <= 2,
//     through the same load instructions, all in flight before any is used.
//   - The warps of a launch move through the levels roughly together, so
//     one level's table is hot in L2 at a time.
//   - Each lane rounds its corners' products (w[c] * value) and the sum is
//     taken in one tree for every F and both reads, ((c0 + c1) + (c2 + c3))
//     + ((c4 + c5) + (c6 + c7)): inside a lane for the corners it holds, then
//     by __shfl_xor_sync across lanes, with __fmul_rn / __fadd_rn so that
//     nvcc contracts nothing. cell_lookup_reference sums in the same tree,
//     so K4 equals its plain version bit for bit.
//   - The warp stages its samples' outputs in shared memory (32 floats a
//     sample a pass over the levels, 16.9 KB a block) and writes them as
//     whole lines of float4s, not F scalars a thread at a stride.
//   - Power-of-two tables (every table CellHashEncoding builds) reduce the
//     hash with & (table_size - 1) in place of a 32-bit division; the two
//     give the same index.
// The choices (one level in flight, the threshold, the stage's width, 8
// blocks an SM, the cell taken from the locating lane rather than located
// again by every lane) were timed on an H100 against the alternatives
// (PERF.md, section 6).

// K5. The function's own work is the same gather run backwards: read each
// lookup's position and g_out, write each touched cell's 8 F sums once, and
// for g_pos read each lookup's cell once more. So it is bound by bytes too
// (chip_smoke.py::grid_bound_ms counts them). A scatter with float atomics
// meets that bound only where cells are seldom shared, and the coarse dense
// levels take every sample of a launch (the field's level 0 has 4,096 cells
// for 196,608 lookups): their atomics serialise, and they add in an order
// that changes from launch to launch. K5 therefore sorts the lookups by cell
// and sums each cell's run in a fixed order, with no float atomic:
//   1. keys: one thread per (sample, level slot), a sample's levels padded to
//      a power of two of adjacent lanes. It writes the 32-bit key (level
//      above the cell index; at most 31 bits) and, where g_pos is asked for,
//      reads the cell and sums the sample's levels by a butterfly of warp
//      shuffles, in a fixed order, into g_pos: one plain store a sample.
//   2. a stable LSD radix sort of (key, lookup id), 8-bit digits (3 passes
//      for the field's 23 bits and the proposals' 20): per pass a 256-bin
//      histogram of each 4,096-key tile (integer atomics in shared memory),
//      an exclusive scan over (digit, tile), and a scatter that ranks each
//      key among its warp's equal digits with __match_any_sync, stages the
//      tile in shared memory in digit order and writes it out coalesced.
//      The keys start in lookup order, so equal keys end in ascending id.
//   3. a segmented reduction over the sorted entries, 256 to a warp: each
//      entry recomputes its weights from its position and reads its g_out;
//      each round of 32 entries is summed by a segmented Kogge-Stone scan of
//      warp shuffles, and a cell's run carries from round to round. A run
//      that ends in the warp's chunk is stored into g_cells with plain
//      stores; a run that crosses a chunk boundary leaves one partial a
//      chunk, and 4. one warp per such run adds its partials, a strided
//      chain a lane and a butterfly across the lanes, and stores the cell.
// Every float sum has an order fixed by the keys and the ids, so two launches
// on the same inputs give the same bits, and no chain of adds is longer than
// 256 entries (a chunk) or a 32nd of a run's chunks. What this costs on top of
// the function's own bytes: the keys (4 B a lookup, written and read), the
// three sort passes (about 20 B a lookup each), the sorted pairs read by the
// reduction, and the gathered positions and g_out read at 32-byte sectors in
// cell order rather than in sample order. The wrapper zero-fills g_cells (the
// dense gradient the optimizer reads) and allocates the scratch buffer whose
// size cell_lookup_bwd_scratch_bytes gives; nothing is allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoKey = 0xffffffffu;  // keys use at most 31 bits

// the sort: 256 threads rank a tile of 4,096 keys, 16 rounds of 32 keys a warp
constexpr int kRadix = 256;
constexpr int kDigitBits = 8;
constexpr int kMaxPasses = 4;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kScanItems = 8;  // counts a thread scans at once
static_assert(kSortThreads == kRadix, "one thread a digit");

// the segmented reduction: a warp sums a chunk of 8 rounds of 32 sorted entries
constexpr int kReduceRounds = 8;
constexpr int kChunk = 32 * kReduceRounds;
constexpr int kWarpsPerBlock = kThreads / 32;

struct Levels {
    float res[kMaxLevels];  // float(res), the factor of scaled
    float hi[kMaxLevels];   // float(res * (1 - 1e-7)) rounded from double
    int ires[kMaxLevels];
    unsigned dense;         // bit l: level l indexes densely
    unsigned hash_mask;     // table_size - 1 where it is a power of two, else 0
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
        cell.idx = lv.hash_mask ? h & lv.hash_mask : h % table_size;
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

template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float (&v)[N]) {
    static_assert(N % 4 == 0, "stored as float4s");
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
        d4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// -- K4: the forward ------------------------------------------------------------

constexpr int kK4Warps = 4;  // a block: 4 warps, 128 samples
constexpr int kK4Threads = 32 * kK4Warps;
constexpr int kK4Stage = 32;  // outputs a sample stages per pass over the levels
// A level whose 32 lookups form more runs of equal cells than this is read
// with shared reads; one with fewer, by each lane on its own.
constexpr int kK4OwnMaxRuns = 16;

template <int F>
struct K4Lanes {
    static constexpr int kParts = 2 * F;                    // lanes sharing a cell's read
    static constexpr int kPerLoad = 32 / kParts;            // lookups a shared warp-wide load
    static constexpr int kValues = F < 4 ? F : 4;           // features in a lane's float4
    static constexpr int kBatch = kParts < 4 ? kParts : 4;  // shared rounds loaded together
    static constexpr int kGroups = F / 4;                   // own reads a cell at F >= 4, a feature group each
    static constexpr int kOwnLoads = F <= 2 ? 2 * F : 8;    // float4s of one own read
};

// w[c] for corner c from the fractions, as corner_weight forms it.
__device__ __forceinline__ float k4_weight(const float frac[3], int c) {
    const float wx = c & 4 ? frac[0] : __fsub_rn(1.0f, frac[0]);
    const float wy = c & 2 ? frac[1] : __fsub_rn(1.0f, frac[1]);
    const float wz = c & 1 ? frac[2] : __fsub_rn(1.0f, frac[2]);
    return __fmul_rn(__fmul_rn(wx, wy), wz);
}

__device__ __forceinline__ float k4_tree(const float c[8]) {
    return __fadd_rn(__fadd_rn(__fadd_rn(c[0], c[1]), __fadd_rn(c[2], c[3])),
                     __fadd_rn(__fadd_rn(c[4], c[5]), __fadd_rn(c[6], c[7])));
}

// Runs of equal cells among the warp's 32 lookups at one level, in lane
// order: about the distinct cells where neighbouring samples share them.
__device__ __forceinline__ int k4_runs(unsigned idx, int lane) {
    const unsigned prev = __shfl_up_sync(kFull, idx, 1);
    return __popc(__ballot_sync(kFull, lane == 0 || prev != idx));
}

// Own read: float4 k of the lane's own cell for feature group g; the group's
// float4s hold x[c * kValues + f] for its corners c and features f.
template <int F>
__device__ __forceinline__ int k4_own_float4(int k, int g) {
    return F <= 2 ? k : k * (F / 4) + g;
}

// The lane's own lookup from the float4s of one own read (at F >= 4, one
// feature group): its kValues features into dst[0 ..].
template <int F>
__device__ __forceinline__ void k4_own_sum(const Cell& cell, const float4* v, float* dst) {
    using K = K4Lanes<F>;
    float x[4 * K::kOwnLoads];
#pragma unroll
    for (int k = 0; k < K::kOwnLoads; ++k) {
        x[4 * k] = v[k].x, x[4 * k + 1] = v[k].y, x[4 * k + 2] = v[k].z, x[4 * k + 3] = v[k].w;
    }
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = corner_weight(cell, c);
#pragma unroll
    for (int f = 0; f < K::kValues; ++f) {
        float prod[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) prod[c] = __fmul_rn(w[c], x[c * K::kValues + f]);
        dst[f] = k4_tree(prod);
    }
}

// One shared round: lane part q holds float4 q of a lookup's cell (corners
// 4q / F .. (4q + 3) / F). Each lane rounds its products and sums its
// corners; the lookup's lanes then add across, a group of g corners meeting
// the next g, g F / 4 lanes away, and store into dst, the lookup's staged
// features.
template <int F>
__device__ __forceinline__ void k4_shared_sum(float4 v, const float frac[3], int q, float* dst) {
    using K = K4Lanes<F>;
    const float x[4] = {v.x, v.y, v.z, v.w};
    float prod[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) prod[m] = __fmul_rn(k4_weight(frac, (4 * q + m) / F), x[m]);
    if constexpr (F == 2) {
        // reduce-scatter: lane part q keeps feature q & 1 and sends the other
        const bool odd = q & 1;
        const float s0 = __fadd_rn(prod[0], prod[2]), s1 = __fadd_rn(prod[1], prod[3]);
        float t = __fadd_rn(odd ? s1 : s0, __shfl_xor_sync(kFull, odd ? s0 : s1, 1));
        t = __fadd_rn(t, __shfl_xor_sync(kFull, t, 2));
        if (q < 2) dst[q] = t;
    } else {
        float s[K::kValues];
        if constexpr (F == 1) {
            s[0] = __fadd_rn(__fadd_rn(prod[0], prod[1]), __fadd_rn(prod[2], prod[3]));
        } else {
#pragma unroll
            for (int f = 0; f < K::kValues; ++f) s[f] = prod[f];
        }
#pragma unroll
        for (int g = F < 4 ? 4 / F : 1; g < 8; g *= 2) {
#pragma unroll
            for (int f = 0; f < K::kValues; ++f) s[f] = __fadd_rn(s[f], __shfl_xor_sync(kFull, s[f], g * F / 4));
        }
        if (4 * q < F) {  // lane part q holds features 4q .. 4q + kValues - 1
#pragma unroll
            for (int f = 0; f < K::kValues; ++f) dst[4 * q + f] = s[f];
        }
    }
}

// One warp a run of 32 samples, every level; see the note at the top.
// ptxas is held to 8 resident blocks an SM at F <= 2 (64 registers a
// thread) and 6 above (85), or it takes up to 255 at F >= 4.
template <int F>
__global__ void __launch_bounds__(kK4Threads, F <= 2 ? 8 : 6) cell_lookup_fwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ cells,
    float* __restrict__ out, int n, int num_levels, long long level_stride,
    unsigned table_size, Levels lv) {
    using K = K4Lanes<F>;
    constexpr int kWidth = kK4Stage > F ? kK4Stage : F;  // staged floats a sample a pass
    constexpr int kStride = kWidth + 1;  // padded against bank conflicts
    __shared__ float stage[kK4Warps][32 * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base = (static_cast<long long>(blockIdx.x) * kK4Warps + warp) * 32;
    if (base >= n) return;  // the whole warp
    const int valid = n - base < 32 ? static_cast<int>(n - base) : 32;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (lane < valid) {
#pragma unroll
        for (int d = 0; d < 3; ++d) p[d] = positions[3 * (base + lane) + d];
    }
    const int q = lane % K::kParts;  // this lane's float4 of a shared read
    const int j0 = lane / K::kParts;  // its lookup in a shared round, less the round's first
    float* buf = stage[warp];
    const int row = num_levels * F;
    const int levels_a_pass = kWidth / F < num_levels ? kWidth / F : num_levels;
    for (int l0 = 0; l0 < num_levels; l0 += levels_a_pass) {
        const int l1 = l0 + levels_a_pass < num_levels ? l0 + levels_a_pass : num_levels;
        for (int l = l0; l < l1; ++l) {
            const Cell cell = locate(p, lv, l, table_size);
            const bool shared = k4_runs(cell.idx, lane) > kK4OwnMaxRuns;
            const float4* level_cells = reinterpret_cast<const float4*>(cells + l * level_stride);
            if constexpr (F <= 2) {
                // Either read loads 2F float4s a lane, through the same load
                // instructions: a shared read's float4 k is part q of round
                // k's lookup, k * kPerLoad + j0; an own read's, float4 k of
                // the lane's cell.
                float4 v[2 * F];
#pragma unroll
                for (int k = 0; k < 2 * F; ++k) {
                    unsigned idx = cell.idx;
                    int part = k;
                    if (shared) {
                        idx = __shfl_sync(kFull, cell.idx, k * K::kPerLoad + j0);
                        part = q;
                    }
                    v[k] = __ldg(level_cells + static_cast<long long>(idx) * (2 * F) + part);
                }
                float* level_row = buf + (l - l0) * F;
                if (shared) {
#pragma unroll
                    for (int k = 0; k < 2 * F; ++k) {
                        const int src = k * K::kPerLoad + j0;
                        float frac[3];
#pragma unroll
                        for (int d = 0; d < 3; ++d) frac[d] = __shfl_sync(kFull, cell.w[d][1], src);
                        k4_shared_sum<F>(v[k], frac, q, level_row + src * kStride);
                    }
                } else {
                    k4_own_sum<F>(cell, v, level_row + lane * kStride);
                }
            } else {
                float* level_row = buf + (l - l0) * F;
                if (shared) {
                    // kBatch rounds' loads in flight at once
#pragma unroll
                    for (int r0 = 0; r0 < K::kParts; r0 += K::kBatch) {
                        float4 v[K::kBatch];
#pragma unroll
                        for (int b = 0; b < K::kBatch; ++b) {
                            const int src = (r0 + b) * K::kPerLoad + j0;
                            const unsigned idx = __shfl_sync(kFull, cell.idx, src);
                            v[b] = __ldg(level_cells + static_cast<long long>(idx) * (2 * F) + q);
                        }
#pragma unroll
                        for (int b = 0; b < K::kBatch; ++b) {
                            const int src = (r0 + b) * K::kPerLoad + j0;
                            float frac[3];
#pragma unroll
                            for (int d = 0; d < 3; ++d) frac[d] = __shfl_sync(kFull, cell.w[d][1], src);
                            k4_shared_sum<F>(v[b], frac, q, level_row + src * kStride);
                        }
                    }
                } else {
                    // the lane's own cell, a feature group at a time
#pragma unroll
                    for (int g = 0; g < K::kGroups; ++g) {
                        float4 v[K::kOwnLoads];
#pragma unroll
                        for (int k = 0; k < K::kOwnLoads; ++k)
                            v[k] = __ldg(level_cells + static_cast<long long>(cell.idx) * (2 * F) +
                                         k4_own_float4<F>(k, g));
                        k4_own_sum<F>(cell, v, level_row + lane * kStride + 4 * g);
                    }
                }
            }
        }
        // the staged outputs of levels [l0, l1): `width` floats a sample
        __syncwarp();
        const int width = (l1 - l0) * F;
        if (width == row) {
            // whole rows: the warp's samples are one contiguous run of floats,
            // 16-byte aligned (base is a multiple of 32), written as float4s
            float* dst = out + base * row;
            const int total = valid * row;
            for (int k = lane; k < total / 4; k += 32) {
                int s = 4 * k / width, j = 4 * k - s * width;
                float t[4];
#pragma unroll
                for (int m = 0; m < 4; ++m) {
                    t[m] = buf[s * kStride + j];
                    if (++j == width) j = 0, ++s;
                }
                reinterpret_cast<float4*>(dst)[k] = make_float4(t[0], t[1], t[2], t[3]);
            }
            for (int e = (total & ~3) + lane; e < total; e += 32) {
                const int s = e / width;
                dst[e] = buf[s * kStride + e - s * width];
            }
        } else {
            // a pass over part of the levels: each sample's run of `width`
            // floats, consecutive lanes on consecutive floats
            for (int e = lane; e < valid * width; e += 32) {
                const int s = e / width, j = e - s * width;
                out[(base + s) * row + l0 * F + j] = buf[s * kStride + j];
            }
        }
        __syncwarp();
    }
}

// -- K5, stage 1: keys, and the position gradient -----------------------------

// One thread per (sample, level slot); kSlots >= L is a power of two <= 32,
// so a sample's slots are adjacent lanes of one warp. Block 0 also zeroes the
// sort's digit totals. Every thread reaches the shuffles: none returns early.
template <int F, int kSlots>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_keys_kernel(
    const float* __restrict__ positions, const float* __restrict__ cells,
    const float* __restrict__ g_out, float* __restrict__ g_pos, unsigned* __restrict__ keys,
    unsigned* __restrict__ totals, int n, int num_levels, long long level_stride,
    unsigned table_size, int cell_bits, Levels lv) {
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < kMaxPasses * kRadix; k += kThreads) totals[k] = 0u;
    const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long i = g / kSlots;
    const int l = static_cast<int>(g % kSlots);
    const bool sample = i < n;
    float grad[3] = {0.0f, 0.0f, 0.0f};
    if (sample && l < num_levels) {
        const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
        const Cell cell = locate(p, lv, l, table_size);
        const long long t = i * num_levels + l;
        keys[t] = (static_cast<unsigned>(l) << cell_bits) | cell.idx;
        if (g_pos != nullptr) {
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f) g[f] = g_out[t * F + f];
            float v[8 * F];
            load_cell<F>(cells + l * level_stride + static_cast<long long>(cell.idx) * (8 * F), v);
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
            // d frac / d pos = res
#pragma unroll
            for (int d = 0; d < 3; ++d) grad[d] = lv.res[l] * grad[d];
        }
    }
    if (g_pos == nullptr) return;  // the same for every thread of the launch
    // the sample's levels, summed by a butterfly over its kSlots lanes
#pragma unroll
    for (int off = kSlots / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int d = 0; d < 3; ++d) grad[d] += __shfl_xor_sync(kFull, grad[d], off);
    }
    if (sample && l == 0) {
#pragma unroll
        for (int d = 0; d < 3; ++d) g_pos[3 * i + d] = grad[d];
    }
}

// -- K5, stage 2: the stable radix sort of (key, id) ---------------------------

// Exclusive scan of one unsigned a thread over the block; integer sums, so
// any order gives the same result. smem holds kSortWarps + 1 values; every
// thread of the block must call it.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* smem,
                                                         unsigned* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
    }
    if (lane == 31) smem[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const unsigned s = lane < kSortWarps ? smem[lane] : 0u;
        unsigned si = s;
#pragma unroll
        for (int off = 1; off < kSortWarps; off <<= 1) {
            const unsigned o = __shfl_up_sync(kFull, si, off);
            if (lane >= off) si += o;
        }
        __syncwarp();
        if (lane < kSortWarps) smem[lane] = si - s;
        if (lane == kSortWarps - 1) smem[kSortWarps] = si;
    }
    __syncthreads();
    const unsigned out = smem[warp] + incl - v;
    *total = smem[kSortWarps];
    __syncthreads();  // smem may be reused once every thread has read it
    return out;
}

// counts[d * num_tiles + b] = keys of tile b with digit d; totals[d] += it.
__global__ void __launch_bounds__(kSortThreads) cell_lookup_bwd_hist_kernel(
    const unsigned* __restrict__ keys, unsigned* __restrict__ counts,
    unsigned* __restrict__ totals, int num_keys, int num_tiles, int shift) {
    __shared__ unsigned hist[kRadix];
    hist[threadIdx.x] = 0u;
    __syncthreads();
    const long long tile0 = static_cast<long long>(blockIdx.x) * kSortTile;
#pragma unroll 4
    for (int k = 0; k < kSortItems; ++k) {
        const long long j = tile0 + k * kSortThreads + threadIdx.x;
        if (j < num_keys) atomicAdd(&hist[(keys[j] >> shift) & (kRadix - 1)], 1u);
    }
    __syncthreads();
    const unsigned c = hist[threadIdx.x];
    counts[static_cast<long long>(threadIdx.x) * num_tiles + blockIdx.x] = c;
    if (c) atomicAdd(&totals[threadIdx.x], c);
}

// One block a digit d: counts[d][b] becomes the position in the sorted
// output of tile b's first key with digit d.
__global__ void __launch_bounds__(kSortThreads) cell_lookup_bwd_scan_kernel(
    unsigned* __restrict__ counts, const unsigned* __restrict__ totals, int num_tiles) {
    __shared__ unsigned smem[kSortWarps + 1];
    const int d = blockIdx.x;
    unsigned base;
    block_exclusive_scan(threadIdx.x < d ? totals[threadIdx.x] : 0u, smem, &base);
    unsigned* row = counts + static_cast<long long>(d) * num_tiles;
    for (int t0 = 0; t0 < num_tiles; t0 += kSortThreads * kScanItems) {
        const int first = t0 + threadIdx.x * kScanItems;
        unsigned v[kScanItems];
        unsigned run = 0u;
#pragma unroll
        for (int k = 0; k < kScanItems; ++k) {
            v[k] = first + k < num_tiles ? row[first + k] : 0u;
            run += v[k];
        }
        unsigned total;
        unsigned acc = base + block_exclusive_scan(run, smem, &total);
#pragma unroll
        for (int k = 0; k < kScanItems; ++k) {
            if (first + k < num_tiles) row[first + k] = acc;
            acc += v[k];
        }
        base += total;
    }
}

// Moves tile b's keys (and ids; the first pass's ids are the positions) to
// their sorted places: ranked within each warp by __match_any_sync, in the
// order of their positions, so the sort is stable.
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads) cell_lookup_bwd_scatter_kernel(
    const unsigned* __restrict__ keys_in, const unsigned* __restrict__ ids_in,
    unsigned* __restrict__ keys_out, unsigned* __restrict__ ids_out,
    const unsigned* __restrict__ offsets, int num_keys, int num_tiles, int shift) {
    __shared__ unsigned warp_count[kSortWarps][kRadix];
    __shared__ unsigned digit_start[kRadix];
    __shared__ unsigned scan_smem[kSortWarps + 1];
    __shared__ unsigned s_keys[kSortTile];
    __shared__ unsigned s_ids[kSortTile];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < kSortWarps * kRadix; k += kSortThreads)
        (&warp_count[0][0])[k] = 0u;
    __syncthreads();

    const long long tile0 = static_cast<long long>(blockIdx.x) * kSortTile;
    const long long warp0 = tile0 + warp * (32 * kSortItems);
    const unsigned below_mask = (1u << lane) - 1u;
    unsigned key[kSortItems], id[kSortItems], rank[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const long long j = warp0 + r * 32 + lane;
        const bool valid = j < num_keys;
        key[r] = valid ? keys_in[j] : 0u;
        id[r] = valid ? (kFirst ? static_cast<unsigned>(j) : ids_in[j]) : 0u;
        const unsigned d = valid ? (key[r] >> shift) & (kRadix - 1) : kRadix;
        const unsigned peers = __match_any_sync(kFull, d);
        const unsigned below = __popc(peers & below_mask);
        const unsigned base = valid ? warp_count[warp][d] : 0u;
        __syncwarp();
        if (valid && below == 0) warp_count[warp][d] = base + __popc(peers);
        __syncwarp();
        rank[r] = base + below;
    }
    __syncthreads();

    // per digit (one a thread): each warp's offset among the tile's keys of
    // that digit, and the digit's first place in the tile's sorted order
    const int dt = threadIdx.x;
    unsigned sum = 0u;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
        const unsigned c = warp_count[w][dt];
        warp_count[w][dt] = sum;
        sum += c;
    }
    unsigned tile_total;
    digit_start[dt] = block_exclusive_scan(sum, scan_smem, &tile_total);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        if (warp0 + r * 32 + lane < num_keys) {
            const unsigned d = (key[r] >> shift) & (kRadix - 1);
            const unsigned pos = digit_start[d] + warp_count[warp][d] + rank[r];
            s_keys[pos] = key[r];
            s_ids[pos] = id[r];
        }
    }
    __syncthreads();

    const long long left = num_keys - tile0;
    const int count = left < kSortTile ? static_cast<int>(left) : kSortTile;
    for (int p = threadIdx.x; p < count; p += kSortThreads) {
        const unsigned k = s_keys[p];
        const unsigned d = (k >> shift) & (kRadix - 1);
        const long long dst = static_cast<long long>(offsets[static_cast<long long>(d) * num_tiles + blockIdx.x]) +
                              (p - digit_start[d]);
        keys_out[dst] = k;
        ids_out[dst] = s_ids[p];
    }
}

// -- K5, stage 3: the segmented reduction over the sorted entries --------------

// One warp a chunk of kChunk sorted entries. A cell's run that starts and
// ends in the chunk is stored into g_cells; the chunk's first run, where it
// began in an earlier chunk, goes to head[chunk]; its last run, where it
// begins in this chunk and goes on past it, to tail[chunk], and its key to
// tail_key[chunk] (kNoKey otherwise).
template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_reduce_kernel(
    const unsigned* __restrict__ skeys, const unsigned* __restrict__ sids,
    const float* __restrict__ positions, const float* __restrict__ g_out,
    float* __restrict__ g_cells, float* __restrict__ head, float* __restrict__ tail,
    unsigned* __restrict__ tail_key, int num_lookups, int num_levels, int cell_bits,
    long long level_stride, unsigned table_size, Levels lv) {
    constexpr int V = 8 * F;
    const int lane = threadIdx.x & 31;
    const long long chunk = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const long long lo = chunk * kChunk;
    if (lo >= num_lookups) return;  // the whole warp
    const long long hi = lo + kChunk < num_lookups ? lo + kChunk : num_lookups;
    const unsigned first_key = skeys[lo];
    const bool open_left = lo > 0 && skeys[lo - 1] == first_key;
    const unsigned cell_mask = (1u << cell_bits) - 1u;

    float carry[V];
#pragma unroll
    for (int k = 0; k < V; ++k) carry[k] = 0.0f;
    unsigned carry_key = kNoKey;
    for (long long base = lo; base < hi; base += 32) {
        const long long j = base + lane;
        const bool valid = j < hi;
        const unsigned key = valid ? skeys[j] : kNoKey;
        const unsigned next = valid && j + 1 < num_lookups ? skeys[j + 1] : kNoKey;
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = 0.0f;
        if (valid) {
            const unsigned id = sids[j];
            const int l = static_cast<int>(key >> cell_bits);
            const long long i = id / static_cast<unsigned>(num_levels);
            const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
            const Cell cell = locate(p, lv, l, table_size);
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f) g[f] = g_out[static_cast<long long>(id) * F + f];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float w = corner_weight(cell, c);
#pragma unroll
                for (int f = 0; f < F; ++f) v[c * F + f] = __fmul_rn(w, g[f]);
            }
        }
        // the run the previous round left open goes on in lane 0
        if (lane == 0 && key == carry_key) {
#pragma unroll
            for (int k = 0; k < V; ++k) v[k] = __fadd_rn(carry[k], v[k]);
        }
        // segmented inclusive scan: lane j adds lane j - off where both hold
        // the same key (keys are sorted, so the lanes between do too)
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned ko = __shfl_up_sync(kFull, key, off);
            const bool take = lane >= off && ko == key;
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const float o = __shfl_up_sync(kFull, v[k], off);
                if (take) v[k] = __fadd_rn(o, v[k]);
            }
        }
        const bool continues = valid && j + 1 < hi && next == key;
        const int carry_on = __shfl_sync(kFull, continues ? 1 : 0, 31);
        const unsigned last_key = __shfl_sync(kFull, key, 31);
        carry_key = carry_on ? last_key : kNoKey;
#pragma unroll
        for (int k = 0; k < V; ++k) carry[k] = __shfl_sync(kFull, v[k], 31);
        if (valid && !continues) {  // the end of a run inside this chunk
            float* dst;
            if (open_left && key == first_key) {
                dst = head + chunk * V;
            } else if (j + 1 == hi && next == key) {
                dst = tail + chunk * V;
            } else {
                dst = g_cells + static_cast<long long>(key >> cell_bits) * level_stride +
                      static_cast<long long>(key & cell_mask) * V;
            }
            store_floats(dst, v);
        }
    }
    if (lane == 0) {
        const unsigned last = skeys[hi - 1];
        const bool open_right = hi < num_lookups && skeys[hi] == last;
        const bool starts_here = !(open_left && last == first_key);
        tail_key[chunk] = open_right && starts_here ? last : kNoKey;
    }
}

// -- K5, stage 4: runs that cross chunk boundaries ----------------------------

// One warp a chunk whose tail opens a run: the run's partials are tail[chunk]
// and head[chunk + 1 .. last], last the final chunk that begins with the
// run's key. Lane j adds partials j, j + 32, ... in turn; a butterfly adds
// the lanes; lane 0 stores the cell.
template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_fixup_kernel(
    const unsigned* __restrict__ skeys, const float* __restrict__ head,
    const float* __restrict__ tail, const unsigned* __restrict__ tail_key,
    float* __restrict__ g_cells, long long num_chunks, int cell_bits, long long level_stride) {
    constexpr int V = 8 * F;
    constexpr int W = V < 16 ? V : 16;  // values a pass
    const int lane = threadIdx.x & 31;
    const long long chunk = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (chunk >= num_chunks) return;
    const unsigned key = tail_key[chunk];
    if (key == kNoKey) return;  // the whole warp
    long long last = chunk;
    for (long long c0 = chunk + 1;; c0 += 32) {
        const long long c = c0 + lane;
        const bool same = c < num_chunks && skeys[c * kChunk] == key;
        const unsigned run = __ballot_sync(kFull, same);
        if (run == kFull) continue;
        last = c0 + __ffs(~run) - 2;  // the chunk before the first that does not begin with key
        break;
    }
    const long long parts = last - chunk + 1;
    float* dst = g_cells + static_cast<long long>(key >> cell_bits) * level_stride +
                 static_cast<long long>(key & ((1u << cell_bits) - 1u)) * V;
    for (int v0 = 0; v0 < V; v0 += W) {
        float acc[W];
#pragma unroll
        for (int q = 0; q < W; ++q) acc[q] = 0.0f;
        for (long long it = lane; it < parts; it += 32) {
            const float* src = it == 0 ? tail + chunk * V : head + (chunk + it) * V;
#pragma unroll
            for (int q = 0; q < W; ++q) acc[q] = __fadd_rn(acc[q], src[v0 + q]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int q = 0; q < W; ++q) acc[q] = __fadd_rn(acc[q], __shfl_xor_sync(kFull, acc[q], off));
        }
        if (lane == 0) store_floats(dst + v0, acc);
    }
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
    const bool pow2 = (table_size & (table_size - 1)) == 0;
    lv->hash_mask = pow2 ? static_cast<unsigned>(table_size - 1) : 0u;
    return true;
}

int blocks_for(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

int ceil_log2(long long v) {
    int b = 0;
    while ((1LL << b) < v) ++b;
    return b;
}

// The key packs the level above the cell index: cell_bits for the index,
// at most 31 bits in all.
struct KeyLayout {
    int cell_bits;
    int passes;
};

bool key_layout(int num_levels, int table_size, KeyLayout* kl) {
    kl->cell_bits = ceil_log2(table_size);
    const int bits = ceil_log2(num_levels) + kl->cell_bits;
    if (bits > 31) return false;
    kl->passes = bits > 0 ? (bits + kDigitBits - 1) / kDigitBits : 1;
    return true;
}

// Scratch regions, each 256-byte aligned, carved from one buffer.
struct Scratch {
    unsigned* keys[2];
    unsigned* ids[2];
    unsigned* counts;
    unsigned* totals;
    float* head;
    float* tail;
    unsigned* tail_key;
};

long long carve(char* base, long long lookups, int features, Scratch* s) {
    long long off = 0;
    auto take = [&](long long bytes) {
        char* p = base == nullptr ? nullptr : base + off;
        off += (bytes + 255) & ~255LL;
        return p;
    };
    const long long tiles = (lookups + kSortTile - 1) / kSortTile;
    const long long chunks = (lookups + kChunk - 1) / kChunk;
    for (int k = 0; k < 2; ++k) s->keys[k] = reinterpret_cast<unsigned*>(take(4 * lookups));
    for (int k = 0; k < 2; ++k) s->ids[k] = reinterpret_cast<unsigned*>(take(4 * lookups));
    s->counts = reinterpret_cast<unsigned*>(take(4LL * kRadix * tiles));
    s->totals = reinterpret_cast<unsigned*>(take(4LL * kRadix * kMaxPasses));
    s->head = reinterpret_cast<float*>(take(4LL * 8 * features * chunks));
    s->tail = reinterpret_cast<float*>(take(4LL * 8 * features * chunks));
    s->tail_key = reinterpret_cast<unsigned*>(take(4 * chunks));
    return off;
}

template <int F>
cudaError_t launch_keys(const float* positions, const float* cells, const float* g_out,
                        float* g_pos, const Scratch& s, int n, int num_levels,
                        long long level_stride, unsigned table_size, int cell_bits,
                        const Levels& lv, cudaStream_t st) {
    const int slots = 1 << ceil_log2(num_levels);
    const long long threads = static_cast<long long>(n) * slots;
#define KEYS_CASE(k)                                                                           \
    case k:                                                                                    \
        cell_lookup_bwd_keys_kernel<F, k><<<blocks_for(threads), kThreads, 0, st>>>(           \
            positions, cells, g_out, g_pos, s.keys[0], s.totals, n, num_levels, level_stride,  \
            table_size, cell_bits, lv);                                                        \
        break;
    switch (slots) {
        KEYS_CASE(1) KEYS_CASE(2) KEYS_CASE(4) KEYS_CASE(8) KEYS_CASE(16) KEYS_CASE(32)
        default:
            return cudaErrorInvalidValue;
    }
#undef KEYS_CASE
    return cudaGetLastError();
}

// Sorts s.keys[0] (in lookup order) with the ids 0 .. num_keys - 1; the
// sorted keys and ids are left in s.keys[p & 1], s.ids[p & 1] after p passes.
cudaError_t radix_sort(const Scratch& s, int num_keys, int passes, cudaStream_t st) {
    const int tiles = (num_keys + kSortTile - 1) / kSortTile;
    for (int p = 0; p < passes; ++p) {
        const unsigned* kin = s.keys[p & 1];
        const unsigned* iin = s.ids[p & 1];
        unsigned* kout = s.keys[(p + 1) & 1];
        unsigned* iout = s.ids[(p + 1) & 1];
        unsigned* totals = s.totals + p * kRadix;
        const int shift = p * kDigitBits;
        cell_lookup_bwd_hist_kernel<<<tiles, kSortThreads, 0, st>>>(kin, s.counts, totals, num_keys,
                                                                     tiles, shift);
        cell_lookup_bwd_scan_kernel<<<kRadix, kSortThreads, 0, st>>>(s.counts, totals, tiles);
        if (p == 0)
            cell_lookup_bwd_scatter_kernel<true><<<tiles, kSortThreads, 0, st>>>(
                kin, nullptr, kout, iout, s.counts, num_keys, tiles, shift);
        else
            cell_lookup_bwd_scatter_kernel<false><<<tiles, kSortThreads, 0, st>>>(
                kin, iin, kout, iout, s.counts, num_keys, tiles, shift);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

template <int F>
cudaError_t launch_bwd(const float* positions, const float* cells, const float* g_out,
                       float* g_cells, float* g_pos, const Scratch& s, int n, int num_levels,
                       long long level_stride, unsigned table_size, const KeyLayout& kl,
                       const Levels& lv, cudaStream_t st) {
    const int lookups = n * num_levels;
    cudaError_t err = launch_keys<F>(positions, cells, g_out, g_pos, s, n, num_levels,
                                     level_stride, table_size, kl.cell_bits, lv, st);
    if (err != cudaSuccess) return err;
    err = radix_sort(s, lookups, kl.passes, st);
    if (err != cudaSuccess) return err;
    const unsigned* skeys = s.keys[kl.passes & 1];
    const unsigned* sids = s.ids[kl.passes & 1];
    const long long chunks = (lookups + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cell_lookup_bwd_reduce_kernel<F><<<blocks, kThreads, 0, st>>>(
        skeys, sids, positions, g_out, g_cells, s.head, s.tail, s.tail_key, lookups, num_levels,
        kl.cell_bits, level_stride, table_size, lv);
    cell_lookup_bwd_fixup_kernel<F><<<blocks, kThreads, 0, st>>>(
        skeys, s.head, s.tail, s.tail_key, g_cells, chunks, kl.cell_bits, level_stride);
    return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Device pointers to float32: positions
// (n, 3) contiguous; cells (L, n_rows, 128) contiguous, level_stride =
// n_rows * 128 floats, 16-byte aligned; out (n, L * F) contiguous, 16-byte
// aligned.
// resolutions is a host array of L ints; features is F in {1, 2, 4, 8, 16};
// n * L < 2^31. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int cell_lookup_fwd_f32(const float* positions, const float* cells, float* out,
                                   int n, int num_levels, long long level_stride,
                                   int table_size, int features, const int* resolutions,
                                   void* stream) {
    Levels lv;
    if (!make_levels(resolutions, num_levels, table_size, &lv) || n < 0 ||
        static_cast<long long>(n) * num_levels >= (1LL << 31) ||
        reinterpret_cast<unsigned long long>(cells) % 16 != 0 ||
        reinterpret_cast<unsigned long long>(out) % 16 != 0 || level_stride % 4 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned ts = static_cast<unsigned>(table_size);
    const int blocks = static_cast<int>((static_cast<long long>(n) + kK4Threads - 1) / kK4Threads);
#define K4_CASE(f)                                                                      \
    case f:                                                                             \
        cell_lookup_fwd_kernel<f><<<blocks, kK4Threads, 0, s>>>(                        \
            positions, cells, out, n, num_levels, level_stride, ts, lv);                \
        break;
    switch (features) {
        K4_CASE(1) K4_CASE(2) K4_CASE(4) K4_CASE(8) K4_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K4_CASE
    return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch K5 (and cell_lookup_sort_u32) needs for n samples, or -1
// for arguments the kernels do not take (the key would need more than 31
// bits, or n * L >= 2^31).
extern "C" long long cell_lookup_bwd_scratch_bytes(int n, int num_levels, int table_size,
                                                   int features) {
    KeyLayout kl;
    if (n < 0 || num_levels < 1 || num_levels > kMaxLevels || table_size < 1 ||
        !key_layout(num_levels, table_size, &kl))
        return -1;
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups >= (1LL << 31)) return -1;
    Scratch s;
    return carve(nullptr, lookups, features, &s);
}

// As cell_lookup_fwd_f32, with g_out (n, L * F) contiguous, g_cells of the
// cells' shape, zero-filled by the caller, g_pos (n, 3) or null (then cells
// is not read), and scratch of cell_lookup_bwd_scratch_bytes bytes, 256-byte
// aligned. Every cell that a lookup touches is stored once; g_pos is written
// in full.
extern "C" int cell_lookup_bwd_f32(const float* positions, const float* cells,
                                   const float* g_out, float* g_cells, float* g_pos, int n,
                                   int num_levels, long long level_stride, int table_size,
                                   int features, const int* resolutions, void* scratch,
                                   long long scratch_bytes, void* stream) {
    Levels lv;
    KeyLayout kl;
    if (!make_levels(resolutions, num_levels, table_size, &lv) || n < 0 ||
        !key_layout(num_levels, table_size, &kl))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups == 0) return 0;
    Scratch s;
    if (lookups >= (1LL << 31) ||
        carve(static_cast<char*>(scratch), lookups, features, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned ts = static_cast<unsigned>(table_size);
    cudaError_t err;
#define K5_CASE(f)                                                                              \
    case f:                                                                                     \
        err = launch_bwd<f>(positions, cells, g_out, g_cells, g_pos, s, n, num_levels,          \
                            level_stride, ts, kl, lv, st);                                      \
        break;
    switch (features) {
        K5_CASE(1) K5_CASE(2) K5_CASE(4) K5_CASE(8) K5_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K5_CASE
    return static_cast<int>(err);
}

// K5's first two stages alone, for checks: keys_out (n * L) gets each
// lookup's key in lookup order (i * L + l), sorted_out the keys sorted, and
// perm_out the stable permutation (the lookup id of each sorted key). int32
// outputs, contiguous; scratch as for cell_lookup_bwd_f32.
extern "C" int cell_lookup_sort_u32(const float* positions, int n, int num_levels,
                                    int table_size, const int* resolutions, unsigned* keys_out,
                                    unsigned* sorted_out, unsigned* perm_out, void* scratch,
                                    long long scratch_bytes, void* stream) {
    Levels lv;
    KeyLayout kl;
    if (!make_levels(resolutions, num_levels, table_size, &lv) || n < 0 ||
        !key_layout(num_levels, table_size, &kl))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups == 0) return 0;
    Scratch s;
    if (lookups >= (1LL << 31) || carve(static_cast<char*>(scratch), lookups, 1, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_keys<1>(positions, nullptr, nullptr, nullptr, s, n, num_levels, 0,
                                     static_cast<unsigned>(table_size), kl.cell_bits, lv, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = 4 * static_cast<size_t>(lookups);
    err = cudaMemcpyAsync(keys_out, s.keys[0], bytes, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = radix_sort(s, static_cast<int>(lookups), kl.passes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyAsync(sorted_out, s.keys[kl.passes & 1], bytes, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyAsync(perm_out, s.ids[kl.passes & 1], bytes, cudaMemcpyDeviceToDevice, st);
    return static_cast<int>(err);
}
