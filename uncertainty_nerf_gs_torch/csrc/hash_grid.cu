// Hash-grid cell lookup for Hopper (sm_90a): forward (K4), backward (K5), and
// the ensemble's forward on member-packed rows (K6, below K4, with a strided
// entry that lerps anchors along each ray).
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
//   idx    = bx + res * (by + res * bz)        where res^3 <= T_l,
//            (bx * 1 ^ by * 2654435761 ^ bz * 805459861) % T_l
//                                              otherwise, in uint32
//   w[c]   = (wx[c >> 2] * wy[(c >> 1) & 1]) * wz[c & 1],  wx = (1 - fx, fx)
//   K4: out[i, l * F + f] = sum_c w[c] * cell[l, idx, c, f], summed in the
//       tree ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7))
//   K5: g_cells[l, idx, c, f] = sum over the lookups (i, l) of that cell of
//                               w[c] * g_out[i, l * F + f]
//       g_pos[i, d] = sum_l res_l * sum_c dw[c]/dfrac_d * <cell[l, idx, c, :], g_out[i, l, :]>
// Each level has a table of its own, T_l cells (the JAX package's per-level
// tables: a stacked (L, n_rows, 128) cell layout, or the hybrid layout's
// res^3-cell dense levels beside its table_size-cell hashed ones), reached
// through a base pointer a level in the kernels' per-level constants, so that
// no level is copied to sit beside another. A level's (n_rows, 128) rows read
// as (n_rows * 128 / (8 F), 8, F): a cell is 8 F consecutive floats (64 B at
// F = 2). Offsets into a table are 64-bit: a hybrid dense level packed for
// the ensemble passes 2^32 bytes.
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
//   - A level whose table is a power of two (every hashed level the
//     encodings build) reduces the hash with & (T_l - 1) in place of a
//     32-bit division; the two give the same index.
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
//      a power of two of adjacent lanes. It writes the 32-bit key (the
//      level's first key, the cells of the levels before it summed, plus the
//      cell index: level-major, then by cell; below 2^31) and, where g_pos
//      is asked for, reads the cell and sums the sample's levels by a
//      butterfly of warp shuffles, in a fixed order, into g_pos: one plain
//      store a sample.
//   2. a stable LSD radix sort of (key, lookup id), 8-bit digits (3 passes
//      for the field's 23 bits, the hybrid field's 24 and the proposals' up
//      to 20): per pass a 256-bin
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
    float res[kMaxLevels];        // float(res), the factor of scaled
    float hi[kMaxLevels];         // float(res * (1 - 1e-7)) rounded from double
    int ires[kMaxLevels];
    unsigned size[kMaxLevels];    // T_l, the cells of level l's table
    unsigned mask[kMaxLevels];    // T_l - 1 where it is a power of two, else 0
    unsigned key0[kMaxLevels];    // K5: level l's first key, T_0 + ... + T_(l-1)
    const void* table[kMaxLevels];  // level l's cells (K6: its packed rows)
    float* grad[kMaxLevels];      // K5: level l's gradient, zero-filled, the table's shape
    unsigned dense;               // bit l: level l indexes densely
};

struct Cell {
    unsigned idx;
    float w[3][2];  // per axis: (1 - frac, frac)
};

__device__ __forceinline__ Cell locate(const float p[3], const Levels& lv, int l) {
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
        cell.idx = lv.mask[l] ? h & lv.mask[l] : h % lv.size[l];
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
    const float* __restrict__ positions, float* __restrict__ out, int n, int num_levels, Levels lv) {
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
            const Cell cell = locate(p, lv, l);
            const bool shared = k4_runs(cell.idx, lane) > kK4OwnMaxRuns;
            const float4* level_cells = static_cast<const float4*>(lv.table[l]);
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

// -- K6: the member-packed forward, the ensemble's lookup -------------------------

// K6 is K4 for an ensemble of M members stored side by side: a level's table
// is (T, 8, M, F), one packed row of 8 corners x M members x F features a
// cell (320 B at M = 5, F = 2), so that one cell index serves every member.
// It replaces the row gather of uncertainty_nerf_gs_tpu/ops/encodings.py::
// packed_cell_lookup and packed_cell_lookup_strided, the member-packed rows
// that experiments/jobs/403_pallas_gather_probe.py::pallas_gather probed at
// 2^19 rows. For each sample i, level l and member m:
//   out[m, i, l * F + f] = sum_c w[c] * row[l, idx, c, m, f]
// with idx and w from locate and corner_weight, summed in k4_tree's order, so
// that it equals its plain version (ops/encodings.py::
// packed_cell_lookup_reference) and M K4 launches on the members' own tables
// bit for bit. The strided entry takes rays of S samples and looks level l
// up only at its anchors a_j = min(j K_l, S - 1), j < NA = (S - 1) / K_l + 2
// (the last one past S - 1, clamped back), then lerps them along the ray in
// t_mid, for sample s in block b = s / K_l:
//   w   = clamp((t_s - t_a[b]) / max(t_a[b + 1] - t_a[b], 1e-12), 0, 1)
//   out = left * (1 - w) + right * w
// each step rounded once, as PyTorch's elementwise ops round it, so that it
// equals ops/encodings.py::packed_cell_lookup_strided_reference bit for bit;
// a level with K_l = 1 is the dense lookup at every sample. The anchors of
// all rays are numbered r * NA + j; a sample's two anchors are consecutive,
// and the anchors 32 consecutive samples need form one range.
//
// What bounds it on an H100: bytes. Each distinct row once (the field's fine
// levels from DRAM), the M-fold output (4 M L F bytes a sample: 126-210 MB a
// render chunk's call at M = 5) and the positions. A thread a sample reading
// member m's corners as F-float vectors issues 8 M loads a lookup, each
// touching up to 32 rows where the warp's rows differ, and writes 4 F bytes
// at a stride of 4 L F; that design sat at 5-22x its bound. This one:
//   - A warp takes 32 consecutive samples and walks the levels, as K4 does.
//     Each lane locates its lookup's cell (a strided level: one anchor a
//     lane), and one ballot marks the runs of equal cells among the 32.
//   - Each run's row is copied once, whole, into the warp's shared memory:
//     lane s hands run s's row to the copy engine (cp.async.bulk, whole
//     sectors, past the registers), and the warp's mbarrier counts the
//     bytes in. All of a level's copies are in flight at once. Rows sit 4
//     floats apart beyond their length (without the pad the sums' reads
//     conflict on banks).
//   - Each lane weighs and sums its own lookup for every member from shared
//     memory, with corner_weight and k4_tree.
//   - The M-fold output is staged in shared memory, member by member, and
//     written out as each sample's run of floats, consecutive lanes on
//     consecutive floats; where a pass covers whole rows, a member's stage
//     is the output's run itself, written as float4s (kK6Stage floats a
//     sample a pass, all members).
//   - One buffer of 32 rows a warp and one warp a block: the shared memory a
//     warp holds sets how many warps an SM keeps (about 30 KB a warp at M =
//     5, F = 2, so 7), and the lookups' latency is hidden by other warps,
//     not by the next level's copies. A second buffer with the next level's
//     copies in flight while this one is summed, 2 or 4 warps a block, a
//     larger or smaller stage, 16-byte cp.async copies by consecutive lanes
//     and a corner order that alternates between rows 8 slots apart were
//     each slower on an H100 (PERF.md, section 6); the next job's positions
//     still load while this one's rows copy.
//   - A strided level stages its anchors' features and each lane lerps its
//     sample from them. The lanes look up at most 32 anchors a round, a
//     round's last anchor being the next round's first, so that both anchors
//     of a sample fall in one round; two warps that share an anchor each look
//     it up.
// A warp's shared memory is its own and __syncwarp its only barrier. The
// launch's dynamic shared memory (k6_layout) holds kK6Warps such regions.
//
// The rows come in three types, as the JAX package's packed tables do
// (uncertainty_nerf_gs_tpu/ops/encodings.py::packed_cell_lookup):
//   - float32, as above;
//   - bf16, half the bytes; its lookup is the JAX package's bf16 one: each
//     corner weight rounded to bf16, each product w[c] * value rounded to
//     bf16, the 8 products summed in k4_tree's order in float32 and the sum
//     rounded to bf16 (round_bf16: to nearest, ties to even, as PyTorch's
//     float-to-bf16 conversion), so that it equals ops/encodings.py::
//     packed_cell_lookup_reference bit for bit;
//   - int8, a quarter of the bytes, with the level's scale s_l folded into
//     the weights: w[c] * s_l rounded once, times the row's value as a
//     float, summed as for float32.
// Rows whose bytes are a multiple of 16 (every float32 and bf16 row, int8 at
// even M F) are copied by cp.async.bulk; an int8 row of 8, 24, 40 or 56
// bytes is copied by the warp's lanes word by word, and the barrier's phase
// then completes with lane 0's arrival alone.

constexpr int kK6Warps = 1;
constexpr int kK6Threads = 32 * kK6Warps;
constexpr int kK6MaxMembers = 8;
constexpr int kK6Stage = 80;  // staged output floats a sample a pass, all members
// A level whose 32 lookups form at most this many runs of equal cells copies
// each run's row once; one with more, every lookup's row (the same copies
// where all 32 differ). Both give the same bits.
constexpr int kK6CopyRunsMax = 32;

// The packed rows' element types: float32, bf16 (its bits) and int8.
enum K6Type { kK6F32 = 0, kK6BF16 = 1, kK6Int8 = 2 };
typedef unsigned short bf16_bits;

struct K6Args {
    const float* positions;  // (n, 3)
    const float* t_mid;      // (n,), rays of `samples` samples; strided levels only
    const float* scales;     // int8 rows: level l's scale at scales[l]; null otherwise
    float* out;              // (M, n, L F)
    int n, num_levels, members, samples;
    int row_bytes;           // a packed row: 8 M F elements
    int bulk;                // rows copied by cp.async.bulk: row_bytes a multiple of 16
    int stride[kMaxLevels];  // K_l; 1 at every level of the dense entry
};

// A warp's region of shared memory, in floats: 32 rows, their cells' indices,
// the anchors' features, the output stage and the copies' mbarrier.
struct K6Layout {
    int row_stride;     // a row rounded up to 16 bytes, + 4 floats
    int anchor_stride;  // M F, odd
    int levels_a_pass;
    int stage_stride;   // levels_a_pass F, odd; the row where a pass covers whole rows
    int index_at, anchors_at, stage_at, bar_at, floats;
};

__host__ __device__ inline K6Layout k6_layout(int row_bytes, int members, int features, int num_levels) {
    K6Layout k;
    k.row_stride = (row_bytes + 15) / 16 * 4 + 4;
    k.anchor_stride = (members * features) | 1;
    const int per_pass = kK6Stage / (members * features);
    k.levels_a_pass = per_pass < 1 ? 1 : per_pass < num_levels ? per_pass : num_levels;
    // odd against bank conflicts; where a pass covers whole rows, the row
    // itself, so that a member's stage is the output's run of floats
    k.stage_stride = k.levels_a_pass == num_levels ? num_levels * features : (k.levels_a_pass * features) | 1;
    k.index_at = 32 * k.row_stride;
    k.anchors_at = k.index_at + 32;
    k.stage_at = k.anchors_at + 32 * k.anchor_stride;
    k.bar_at = (k.stage_at + members * 32 * k.stage_stride + 1) & ~1;  // 8-byte aligned
    // a multiple of 4, so that the next warp's rows are 16-byte aligned too
    k.floats = (k.bar_at + 2 + 3) & ~3;
    return k;
}

#ifdef __CUDACC__
// Device-only helpers; the host test harness (tests/host_cuda/cuda_shim.h)
// stands in for k6_shared, bar_init, bar_expect, bar_arrive, copy_row_bulk
// and bar_wait. The launch's dynamic shared memory:
__device__ __forceinline__ float* k6_shared() {
    extern __shared__ float4 k6_smem[];
    return reinterpret_cast<float*>(k6_smem);
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A warp's mbarrier: one arrival a phase, completed by its copies' bytes.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arrival of a phase whose copies bring `bytes`.
__device__ __forceinline__ void bar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_address(bar)),
                 "r"(bytes) : "memory");
}

// The arrival of a phase that waits for no copy.
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(bar)) : "memory");
}

// One whole row from global to shared memory by the copy engine (16-byte
// aligned, a multiple of 16 bytes); its bytes complete the barrier's phase.
__device__ __forceinline__ void copy_row_bulk(float* dst, const void* src, unsigned bytes,
                                              unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
            shared_address(dst)),
        "l"(src), "r"(bytes), "r"(shared_address(bar)) : "memory");
}

// Waits until the barrier's phase of parity `phase` has completed: its copies
// have landed and are visible to the thread.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned phase) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(shared_address(bar)),
        "r"(phase) : "memory");
}
#endif

// float -> bf16 -> float, to nearest with ties to even (PyTorch's
// float-to-bf16 conversion; a NaN becomes its quiet NaN 0x7FC0).
__device__ __forceinline__ float round_bf16(float x) {
    const unsigned u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float k6_value(float v) { return v; }
__device__ __forceinline__ float k6_value(bf16_bits v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ float k6_value(signed char v) { return static_cast<float>(v); }

// Where a warp's samples lie: the first sample `base`, `valid` of 32 in the
// launch, and (ray, sample) of the lane's own, the first and the last (rays
// of `samples` samples; the dense entry has samples = 1).
struct K6Warp {
    int base, valid, g, r, s, r0, s0, r1, s1;
};

// One (level, round) of a warp's walk. A dense level is one round; a strided
// level's rounds each look up up to 32 of the `anchors` anchors that the
// warp's samples need: anchors j0, j0 + 1, ... of ray r0, then on into the
// next rays (na anchors a ray).
struct K6Job {
    int level, round, rounds, k, na, j0, anchors;
};

__device__ __forceinline__ K6Job k6_job(const K6Args& a, const K6Warp& w, int level) {
    K6Job j;
    j.level = level;
    j.round = 0;
    j.rounds = 1;
    j.k = level < a.num_levels ? a.stride[level] : 1;
    j.na = j.j0 = j.anchors = 0;
    if (j.k > 1) {
        j.na = (a.samples - 1) / j.k + 2;
        j.j0 = w.s0 / j.k;  // the first sample's left anchor
        // to the last sample's right anchor
        j.anchors = (w.r1 - w.r0) * j.na + w.s1 / j.k + 2 - j.j0;
        j.rounds = (j.anchors - 2) / 31 + 1;
    }
    return j;
}

__device__ __forceinline__ K6Job k6_next(const K6Args& a, const K6Warp& w, K6Job j) {
    if (j.round + 1 < j.rounds) {
        ++j.round;
        return j;
    }
    return k6_job(a, w, j.level + 1);
}

// The position of the lane's lookup in `job`: its own sample's, or at a
// strided level anchor 31 round + lane of the warp's range (lanes past it
// repeat its last). Loaded a job ahead of its use.
__device__ __forceinline__ void k6_position(const K6Args& a, const K6Warp& w, const K6Job& job,
                                            const float p[3], int lane, float (&q)[3]) {
    q[0] = p[0], q[1] = p[1], q[2] = p[2];
    if (job.k > 1) {
        const int i = 31 * job.round + lane;
        const int j = job.j0 + (i < job.anchors ? i : job.anchors - 1);
        const int r = w.r0 + j / job.na;
        const int s = min((j % job.na) * job.k, a.samples - 1);
        const float* src = a.positions + 3 * (static_cast<long long>(r) * a.samples + s);
        q[0] = src[0], q[1] = src[1], q[2] = src[2];
    }
}

struct K6Lookup {
    Cell cell;
    int slot;      // its row among the job's rows
    int slots;     // rows the job copies
    bool writes;   // the lane names its row's cell in the index
    float t[3];    // a strided level: t of the lane's sample and of its two anchors
};

// Locates the lane's lookup at q and marks the runs of equal cells (at a
// strided level also loads the t the lerp needs); no shared memory yet.
__device__ __forceinline__ K6Lookup k6_locate(const K6Args& a, const Levels& lv, const K6Warp& w,
                                              const K6Job& job, const float q[3], int lane) {
    K6Lookup lk;
    if (job.k > 1) {
        const float* t = a.t_mid + static_cast<long long>(w.r) * a.samples;
        const int b = w.s / job.k;
        lk.t[0] = t[w.s], lk.t[1] = t[b * job.k], lk.t[2] = t[min((b + 1) * job.k, a.samples - 1)];
    }
    lk.cell = locate(q, lv, job.level);
    const unsigned idx = lk.cell.idx;
    const unsigned prev = __shfl_up_sync(kFull, idx, 1);
    const unsigned starts = __ballot_sync(kFull, lane == 0 || prev != idx);
    const int runs = __popc(starts);
    const bool once = runs <= kK6CopyRunsMax;
    lk.slot = once ? __popc(starts & ((2u << lane) - 1u)) - 1 : lane;
    lk.slots = once ? runs : 32;
    lk.writes = !once || ((starts >> lane) & 1u);
    return lk;
}

// Puts the copies of the job's rows into the warp's rows in flight (rows of
// a size cp.async.bulk does not take: copies them, word by word).
__device__ __forceinline__ void k6_copy(const K6Args& a, const Levels& lv, const K6Layout& k,
                                        const K6Job& job, const K6Lookup& lk, float* mine, int lane) {
    unsigned* index = reinterpret_cast<unsigned*>(mine + k.index_at);
    if (lk.writes) index[lk.slot] = lk.cell.idx;
    __syncwarp();
    // 64-bit offsets: a dense level packed for M members passes 2^32 bytes
    const char* level = static_cast<const char*>(lv.table[job.level]);
    unsigned long long* bar = reinterpret_cast<unsigned long long*>(mine + k.bar_at);
    if (a.bulk) {
        if (lane == 0) bar_expect(bar, static_cast<unsigned>(lk.slots * a.row_bytes));
        __syncwarp();
        if (lane < lk.slots)
            copy_row_bulk(mine + lane * k.row_stride, level + static_cast<long long>(index[lane]) * a.row_bytes,
                          static_cast<unsigned>(a.row_bytes), bar);
    } else {
        const int words = a.row_bytes / 4;
        for (int e = lane; e < lk.slots * words; e += 32) {
            const int s = e / words, w = e - s * words;
            mine[s * k.row_stride + w] =
                reinterpret_cast<const float*>(level + static_cast<long long>(index[s]) * a.row_bytes)[w];
        }
        __syncwarp();
        if (lane == 0) bar_arrive(bar);
    }
}

template <int F>
__device__ __forceinline__ void load_shared(const float* src, float (&v)[F]) {
    if constexpr (F == 1) {
        v[0] = src[0];
    } else if constexpr (F == 2) {
        const float2 q = *reinterpret_cast<const float2*>(src);
        v[0] = q.x, v[1] = q.y;
    } else {
        static_assert(F == 4, "F in {1, 2, 4}");
        const float4 q = *reinterpret_cast<const float4*>(src);
        v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    }
}

// Member m's F features of one lookup from its row (of element type T) in
// shared memory, with the weights as k6_finish prepares them for T.
template <int F, class T>
__device__ __forceinline__ void k6_member(const float* row, const float (&w)[8], int m, int members,
                                          float (&v)[F]) {
    constexpr bool kBf16 = sizeof(T) == 2;
    float x[8][F];
    if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int c = 0; c < 8; ++c) load_shared<F>(row + (c * members + m) * F, x[c]);
    } else {
        const T* r = reinterpret_cast<const T*>(row);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
            for (int f = 0; f < F; ++f) x[c][f] = k6_value(r[(c * members + m) * F + f]);
        }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
        float prod[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            prod[c] = __fmul_rn(w[c], x[c][f]);
            if constexpr (kBf16) prod[c] = round_bf16(prod[c]);
        }
        v[f] = k4_tree(prod);
        if constexpr (kBf16) v[f] = round_bf16(v[f]);
    }
}

// torch: (t - t_left) / clamp(t_right - t_left, min=1e-12), then clamp(w, 0,
// 1); each op rounded once, NaN passed through as torch.clamp passes it.
__device__ __forceinline__ float k6_lerp_weight(float t, float t_left, float t_right) {
    float d = __fsub_rn(t_right, t_left);
    d = isnan(d) ? d : fmaxf(d, static_cast<float>(1e-12));
    const float w = __fdiv_rn(__fsub_rn(t, t_left), d);
    return isnan(w) ? w : fminf(fmaxf(w, 0.0f), 1.0f);
}

// Waits for the job's rows, sums the lane's lookup for every member into the
// stage (a strided level: into the anchors' features, then lerps the lane's
// sample from them), and frees the rows.
template <int F, class T>
__device__ __forceinline__ void k6_finish(const K6Args& a, const K6Layout& k, const K6Warp& wp,
                                          const K6Job& job, const K6Lookup& lk, float* mine,
                                          unsigned phase, int lane) {
    bar_wait(reinterpret_cast<unsigned long long*>(mine + k.bar_at), phase);
    const float* row = mine + lk.slot * k.row_stride;
    float w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        w[c] = corner_weight(lk.cell, c);
        if constexpr (sizeof(T) == 2) w[c] = round_bf16(w[c]);
        if constexpr (sizeof(T) == 1) w[c] = __fmul_rn(w[c], a.scales[job.level]);
    }
    const int members = a.members;
    // member m's staged outputs: 32 samples at stage_stride
    float* stage = mine + k.stage_at + lane * k.stage_stride + job.level % k.levels_a_pass * F;
    const int member_stage = 32 * k.stage_stride;
    if (job.k == 1) {
#pragma unroll 4
        for (int m = 0; m < members; ++m) {
            float v[F];
            k6_member<F, T>(row, w, m, members, v);
#pragma unroll
            for (int f = 0; f < F; ++f) stage[m * member_stage + f] = v[f];
        }
    } else {
        float* anchors = mine + k.anchors_at;
#pragma unroll 4
        for (int m = 0; m < members; ++m) {
            float v[F];
            k6_member<F, T>(row, w, m, members, v);
#pragma unroll
            for (int f = 0; f < F; ++f) anchors[lane * k.anchor_stride + m * F + f] = v[f];
        }
        __syncwarp();
        const int b = wp.s / job.k;
        const int local = (wp.r - wp.r0) * job.na + b - job.j0 - 31 * job.round;
        if (local >= 0 && local < 31) {  // this round holds the sample's anchors b, b + 1
            const float wt = k6_lerp_weight(lk.t[0], lk.t[1], lk.t[2]);
            const float rest = __fsub_rn(1.0f, wt);
            const float* left = anchors + local * k.anchor_stride;
            const float* right = left + k.anchor_stride;
#pragma unroll 4
            for (int m = 0; m < members; ++m) {
#pragma unroll
                for (int f = 0; f < F; ++f)
                    stage[m * member_stage + f] =
                        __fadd_rn(__fmul_rn(left[m * F + f], rest), __fmul_rn(right[m * F + f], wt));
            }
        }
    }
    __syncwarp();
}

// The staged outputs of levels [l0, l1), member by member: each sample's run
// of (l1 - l0) F floats (one contiguous run of the warp's samples where the
// pass covers every level), consecutive lanes on consecutive floats.
template <int F>
__device__ __forceinline__ void k6_flush(const K6Args& a, const K6Layout& k, const K6Warp& w,
                                         const float* stage, int l0, int l1, int lane) {
    const int row = a.num_levels * F, width = (l1 - l0) * F;
    // float e = lane + 32 i of a member: sample e / width, float e % width,
    // carried forward without a division
    const int ds = 32 / width, dj = 32 - ds * width;
    for (int m = 0; m < a.members; ++m) {
        const float* src = stage + m * 32 * k.stage_stride;
        float* dst = a.out + (static_cast<long long>(m) * a.n + w.base) * row + l0 * F;
        int done = 0;
        if (k.stage_stride == row && (reinterpret_cast<unsigned long long>(dst) & 15u) == 0) {
            // whole rows, staged back to back: the warp's samples are one run
            const int quads = w.valid * row / 4;
#pragma unroll 4
            for (int q = lane; q < quads; q += 32)
                reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
            done = 4 * quads;
        }
        int s = (done + lane) / width, j = done + lane - s * width;
#pragma unroll 4
        while (s < w.valid) {
            dst[s * row + j] = src[s * k.stage_stride + j];
            s += ds, j += dj;
            if (j >= width) j -= width, ++s;
        }
    }
    __syncwarp();
}

// One warp's 32 samples, every level (both entries).
template <int F, class T>
__device__ __forceinline__ void k6_warp(const K6Args& a, const Levels& lv) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long first = (static_cast<long long>(blockIdx.x) * kK6Warps + warp) * 32;
    if (first >= a.n) return;  // the whole warp
    K6Warp w;
    w.base = static_cast<int>(first);
    w.valid = a.n - w.base < 32 ? a.n - w.base : 32;
    w.g = w.base + (lane < w.valid ? lane : w.valid - 1);  // lanes past n repeat the last sample
    w.r = w.g / a.samples, w.s = w.g - w.r * a.samples;
    w.r0 = w.base / a.samples, w.s0 = w.base - w.r0 * a.samples;
    const int last = w.base + w.valid - 1;
    w.r1 = last / a.samples, w.s1 = last - w.r1 * a.samples;
    const float* own = a.positions + 3LL * w.g;
    const float p[3] = {own[0], own[1], own[2]};
    const K6Layout k = k6_layout(a.row_bytes, a.members, F, a.num_levels);
    float* mine = k6_shared() + warp * k.floats;
    // a job's rows are copied and summed in turn; the next job's positions
    // load meanwhile
    K6Job job = k6_job(a, w, 0);
    float q[3];
    k6_position(a, w, job, p, lane, q);
    if (lane == 0) bar_init(reinterpret_cast<unsigned long long*>(mine + k.bar_at));
    __syncwarp();
    for (unsigned phase = 0;; phase ^= 1u) {
        const K6Lookup lk = k6_locate(a, lv, w, job, q, lane);
        const K6Job next = k6_next(a, w, job);
        if (next.level < a.num_levels) k6_position(a, w, next, p, lane, q);
        k6_copy(a, lv, k, job, lk, mine, lane);
        k6_finish<F, T>(a, k, w, job, lk, mine, phase, lane);
        const int l = job.level;
        if (job.round + 1 == job.rounds && ((l + 1) % k.levels_a_pass == 0 || l + 1 == a.num_levels))
            k6_flush<F>(a, k, w, mine + k.stage_at, l - l % k.levels_a_pass, l + 1, lane);
        if (next.level == a.num_levels) break;
        job = next;
    }
}

template <int F, class T>
__global__ void __launch_bounds__(kK6Threads) packed_lookup_fwd_kernel(K6Args a, Levels lv) {
    k6_warp<F, T>(a, lv);
}

template <int F, class T>
__global__ void __launch_bounds__(kK6Threads) packed_lookup_strided_kernel(K6Args a, Levels lv) {
    k6_warp<F, T>(a, lv);
}

// -- K5, stage 1: keys, and the position gradient -----------------------------

// One thread per (sample, level slot); kSlots >= L is a power of two <= 32,
// so a sample's slots are adjacent lanes of one warp. Block 0 also zeroes the
// sort's digit totals. Every thread reaches the shuffles: none returns early.
// keys and totals null: the positions-only mode (no table needs a gradient),
// the same arithmetic for g_pos.
template <int F, int kSlots>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_keys_kernel(
    const float* __restrict__ positions, const float* __restrict__ g_out,
    float* __restrict__ g_pos, unsigned* __restrict__ keys, unsigned* __restrict__ totals, int n,
    int num_levels, Levels lv) {
    if (totals != nullptr && blockIdx.x == 0)
        for (int k = threadIdx.x; k < kMaxPasses * kRadix; k += kThreads) totals[k] = 0u;
    const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long i = g / kSlots;
    const int l = static_cast<int>(g % kSlots);
    const bool sample = i < n;
    float grad[3] = {0.0f, 0.0f, 0.0f};
    if (sample && l < num_levels) {
        const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
        const Cell cell = locate(p, lv, l);
        const long long t = i * num_levels + l;
        if (keys != nullptr) keys[t] = lv.key0[l] + cell.idx;
        if (g_pos != nullptr) {
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f) g[f] = g_out[t * F + f];
            float v[8 * F];
            load_cell<F>(static_cast<const float*>(lv.table[l]) + static_cast<long long>(cell.idx) * (8 * F), v);
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

// -- K5 and K8, stages 3 and 4: the segmented sum over the sorted keys -------

// A sum policy P gives: V, the values a sorted element adds; values(id, v),
// the values of the element whose pair id is id, returning the level its
// key lies in; level(key), the level of a key; and dst(key, level), where
// the key's V sums are stored.
template <int N>
__device__ __forceinline__ void store_values(float* dst, const float (&v)[N]) {
    if constexpr (N % 4 == 0) {
        store_floats(dst, v);
    } else {
#pragma unroll
        for (int k = 0; k < N; ++k) dst[k] = v[k];
    }
}

// Stage 3: one warp a chunk of kChunk sorted keys. A key's run that starts
// and ends in the chunk is stored at its dst; the chunk's first run, where
// it began in an earlier chunk, goes to head[chunk]; its last run, where it
// begins in this chunk and goes on past it, to tail[chunk], and its key to
// tail_key[chunk] (kNoKey otherwise).
template <class P>
__device__ __forceinline__ void segmented_sum(const unsigned* __restrict__ skeys,
                                              const unsigned* __restrict__ sids, float* __restrict__ head,
                                              float* __restrict__ tail, unsigned* __restrict__ tail_key,
                                              long long num_keys, const P& pol) {
    constexpr int V = P::V;
    const int lane = threadIdx.x & 31;
    const long long chunk = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const long long lo = chunk * kChunk;
    if (lo >= num_keys) return;  // the whole warp
    const long long hi = lo + kChunk < num_keys ? lo + kChunk : num_keys;
    const unsigned first_key = skeys[lo];
    const bool open_left = lo > 0 && skeys[lo - 1] == first_key;

    float carry[V];
#pragma unroll
    for (int k = 0; k < V; ++k) carry[k] = 0.0f;
    unsigned carry_key = kNoKey;
    for (long long base = lo; base < hi; base += 32) {
        const long long j = base + lane;
        const bool valid = j < hi;
        const unsigned key = valid ? skeys[j] : kNoKey;
        const unsigned next = valid && j + 1 < num_keys ? skeys[j + 1] : kNoKey;
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = 0.0f;
        const int l = valid ? pol.values(sids[j], v) : 0;
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
                dst = pol.dst(key, l);
            }
            store_values(dst, v);
        }
    }
    if (lane == 0) {
        const unsigned last = skeys[hi - 1];
        const bool open_right = hi < num_keys && skeys[hi] == last;
        const bool starts_here = !(open_left && last == first_key);
        tail_key[chunk] = open_right && starts_here ? last : kNoKey;
    }
}

// Stage 4, runs that cross chunk boundaries: one warp a chunk whose tail
// opens a run. The run's partials are tail[chunk] and head[chunk + 1 ..
// last], last the final chunk that begins with the run's key. Lane j adds
// partials j, j + 32, ... in turn; a butterfly adds the lanes; lane 0 stores
// the key's sums.
template <class P>
__device__ __forceinline__ void segmented_sum_fixup(const unsigned* __restrict__ skeys,
                                                    const float* __restrict__ head, const float* __restrict__ tail,
                                                    const unsigned* __restrict__ tail_key, long long num_chunks,
                                                    const P& pol) {
    constexpr int V = P::V;
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
    float* dst = pol.dst(key, pol.level(key));
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
        if (lane == 0) store_values(dst + v0, acc);
    }
}

// K5's sums: a lookup (pair id i L + l) adds w_c g for its cell's 8 corners,
// 8 F values, to the cell's row of level l's gradient (key key0[l] + cell).
template <int F>
struct CellSum {
    static constexpr int V = 8 * F;
    const float* positions;
    const float* g_out;
    int num_levels;
    const Levels& lv;

    __device__ __forceinline__ int values(unsigned id, float (&v)[V]) const {
        const long long i = id / static_cast<unsigned>(num_levels);
        const int l = static_cast<int>(id - i * num_levels);
        const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
        const Cell cell = locate(p, lv, l);
        float g[F];
#pragma unroll
        for (int f = 0; f < F; ++f) g[f] = g_out[static_cast<long long>(id) * F + f];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const float w = corner_weight(cell, c);
#pragma unroll
            for (int f = 0; f < F; ++f) v[c * F + f] = __fmul_rn(w, g[f]);
        }
        return l;
    }
    // the key's level: the last whose first key is not above it
    __device__ __forceinline__ int level(unsigned key) const {
        int l = 0;
        while (l + 1 < num_levels && lv.key0[l + 1] <= key) ++l;
        return l;
    }
    __device__ __forceinline__ float* dst(unsigned key, int l) const {
        return lv.grad[l] + static_cast<long long>(key - lv.key0[l]) * V;
    }
};

// K5, stage 3.
template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_reduce_kernel(
    const unsigned* __restrict__ skeys, const unsigned* __restrict__ sids,
    const float* __restrict__ positions, const float* __restrict__ g_out,
    float* __restrict__ head, float* __restrict__ tail, unsigned* __restrict__ tail_key,
    int num_lookups, int num_levels, Levels lv) {
    segmented_sum(skeys, sids, head, tail, tail_key, num_lookups, CellSum<F>{positions, g_out, num_levels, lv});
}

// K5, stage 4.
template <int F>
__global__ void __launch_bounds__(kThreads) cell_lookup_bwd_fixup_kernel(
    const unsigned* __restrict__ skeys, const float* __restrict__ head,
    const float* __restrict__ tail, const unsigned* __restrict__ tail_key, long long num_chunks,
    int num_levels, Levels lv) {
    segmented_sum_fixup(skeys, head, tail, tail_key, num_chunks, CellSum<F>{nullptr, nullptr, num_levels, lv});
}

// Per-level constants from the host's resolutions, table sizes and table
// pointers (grads may be null). Returns false on what the kernels do not take:
// a level's table must be 16-byte aligned (K4 reads float4s, K5 stores them,
// K6 copies whole rows).
bool make_levels(const int* resolutions, int num_levels, const int* sizes, const void* const* tables,
                 float* const* grads, Levels* lv) {
    if (num_levels < 1 || num_levels > kMaxLevels) return false;
    lv->dense = 0u;
    long long key0 = 0;
    for (int l = 0; l < num_levels; ++l) {
        const int res = resolutions[l], size = sizes[l];
        if (res < 1 || size < 1) return false;
        lv->ires[l] = res;
        lv->res[l] = static_cast<float>(res);
        // torch.clamp(scaled, 0, res * (1 - 1e-7)) rounds its Python scalar
        // to float32: the same double product, rounded to nearest
        lv->hi[l] = static_cast<float>(static_cast<double>(res) * (1.0 - 1e-7));
        const long long cube = static_cast<long long>(res) * res * res;
        if (cube <= size) lv->dense |= 1u << l;
        lv->size[l] = static_cast<unsigned>(size);
        lv->mask[l] = (size & (size - 1)) == 0 ? static_cast<unsigned>(size - 1) : 0u;
        lv->key0[l] = static_cast<unsigned>(key0);  // K5 checks the total (key_layout)
        key0 += size;
        lv->table[l] = tables == nullptr ? nullptr : tables[l];
        lv->grad[l] = grads == nullptr ? nullptr : grads[l];
        if (reinterpret_cast<unsigned long long>(lv->table[l]) % 16 != 0 ||
            reinterpret_cast<unsigned long long>(lv->grad[l]) % 16 != 0)
            return false;
    }
    return true;
}

int blocks_for(long long threads) { return static_cast<int>((threads + kThreads - 1) / kThreads); }

int ceil_log2(long long v) {
    int b = 0;
    while ((1LL << b) < v) ++b;
    return b;
}

// The keys number every level's cells one after the other (level l's from
// key0[l]): below the cells of all levels summed, at most 2^31.
struct KeyLayout {
    int bits;
    int passes;
};

bool key_layout(int num_levels, const int* sizes, KeyLayout* kl) {
    long long total = 0;
    for (int l = 0; l < num_levels; ++l) total += sizes[l];
    kl->bits = ceil_log2(total);
    if (kl->bits > 31) return false;
    kl->passes = kl->bits > 0 ? (kl->bits + kDigitBits - 1) / kDigitBits : 1;
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

// K5's stage 1; s null: no keys, the positions-only mode.
template <int F>
cudaError_t launch_keys(const float* positions, const float* g_out, float* g_pos, const Scratch* s, int n,
                        int num_levels, const Levels& lv, cudaStream_t st) {
    const int slots = 1 << ceil_log2(num_levels);
    const long long threads = static_cast<long long>(n) * slots;
#define KEYS_CASE(k)                                                                         \
    case k:                                                                                  \
        cell_lookup_bwd_keys_kernel<F, k><<<blocks_for(threads), kThreads, 0, st>>>(         \
            positions, g_out, g_pos, s ? s->keys[0] : nullptr, s ? s->totals : nullptr, n,   \
            num_levels, lv);                                                                 \
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
cudaError_t launch_bwd(const float* positions, const float* g_out, float* g_pos, const Scratch& s, int n,
                       int num_levels, const KeyLayout& kl, const Levels& lv, cudaStream_t st) {
    const int lookups = n * num_levels;
    cudaError_t err = launch_keys<F>(positions, g_out, g_pos, &s, n, num_levels, lv, st);
    if (err != cudaSuccess) return err;
    err = radix_sort(s, lookups, kl.passes, st);
    if (err != cudaSuccess) return err;
    const unsigned* skeys = s.keys[kl.passes & 1];
    const unsigned* sids = s.ids[kl.passes & 1];
    const long long chunks = (lookups + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    cell_lookup_bwd_reduce_kernel<F><<<blocks, kThreads, 0, st>>>(
        skeys, sids, positions, g_out, s.head, s.tail, s.tail_key, lookups, num_levels, lv);
    cell_lookup_bwd_fixup_kernel<F><<<blocks, kThreads, 0, st>>>(
        skeys, s.head, s.tail, s.tail_key, chunks, num_levels, lv);
    return cudaGetLastError();
}


// Bytes of one packed row: 8 M F elements of the type.
int k6_row_bytes(int members, int features, int dtype) {
    return 8 * members * features * (dtype == kK6F32 ? 4 : dtype == kK6BF16 ? 2 : 1);
}

// K6's launch arguments from the entry points' (strides null: the dense
// entry). False on what the kernel does not take.
bool k6_args(const float* positions, const float* t_mid, const void* const* tables, const float* scales,
             float* out, long long n, int samples, int num_levels, const int* sizes, int members,
             int features, int dtype, const int* resolutions, const int* strides, K6Args* a, Levels* lv) {
    if (!make_levels(resolutions, num_levels, sizes, tables, nullptr, lv) || n < 0 ||
        n * num_levels >= (1LL << 31) || members < 1 || members > kK6MaxMembers ||
        (features != 1 && features != 2 && features != 4) || dtype < kK6F32 || dtype > kK6Int8 ||
        (dtype == kK6Int8) != (scales != nullptr) || reinterpret_cast<unsigned long long>(out) % 16 != 0)
        return false;
    a->positions = positions;
    a->t_mid = t_mid;
    a->scales = scales;
    a->out = out;
    a->n = static_cast<int>(n);
    a->num_levels = num_levels;
    a->members = members;
    a->samples = samples;
    a->row_bytes = k6_row_bytes(members, features, dtype);
    a->bulk = a->row_bytes % 16 == 0;
    for (int l = 0; l < num_levels; ++l) {
        a->stride[l] = strides == nullptr ? 1 : strides[l];
        if (a->stride[l] < 1 || (a->stride[l] > 1 && (samples < 1 || t_mid == nullptr))) return false;
    }
    return true;
}

// Dynamic shared memory of a K6 block.
int k6_shared_bytes(int members, int features, int dtype, int num_levels) {
    return kK6Warps * k6_layout(k6_row_bytes(members, features, dtype), members, features, num_levels).floats * 4;
}

template <int F, class T>
cudaError_t launch_k6(const K6Args& a, const Levels& lv, int dtype, bool strided, cudaStream_t st) {
    auto kernel = strided ? packed_lookup_strided_kernel<F, T> : packed_lookup_fwd_kernel<F, T>;
    const int bytes = k6_shared_bytes(a.members, F, dtype, a.num_levels);
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const int blocks = (a.n + kK6Threads - 1) / kK6Threads;
    kernel<<<blocks, kK6Threads, bytes, st>>>(a, lv);
    return cudaGetLastError();
}

template <int F>
cudaError_t launch_k6_type(const K6Args& a, const Levels& lv, int dtype, bool strided, cudaStream_t st) {
    switch (dtype) {
        case kK6F32: return launch_k6<F, float>(a, lv, dtype, strided, st);
        case kK6BF16: return launch_k6<F, bf16_bits>(a, lv, dtype, strided, st);
        case kK6Int8: return launch_k6<F, signed char>(a, lv, dtype, strided, st);
        default: return cudaErrorInvalidValue;
    }
}

int run_k6(const K6Args& a, const Levels& lv, int features, int dtype, bool strided, void* stream) {
    if (a.n == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (features) {
        case 1: return static_cast<int>(launch_k6_type<1>(a, lv, dtype, strided, st));
        case 2: return static_cast<int>(launch_k6_type<2>(a, lv, dtype, strided, st));
        case 4: return static_cast<int>(launch_k6_type<4>(a, lv, dtype, strided, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// -- K7 / K8: the corner layout's lookup, forward and backward ----------------
//
// The corner layout (uncertainty_nerf_gs_tpu/ops/encodings.py::
// hash_encoding_lookup, tcnn's semantics) stores each level's table as T
// entries of F features, (L, T, F) here, and reads each of a lookup's 8
// corners on its own: adjacent cells share their corner entries. The JAX
// package computes it with XLA gathers, not with a Pallas kernel; its
// counterpart here is a pair of kernels because the gather's transpose, a
// scatter-add, adds in arbitrary order on the card, and the nerfacto step
// repeats bit for bit. Per sample i, level l and corner k = 4 kx + 2 ky + kz:
//   scaled = pos * res, b = floor(scaled), frac = scaled - b (no clamp)
//   slot_k = x + res (y + res z)                  where (res + 1)^3 <= T (float32),
//            x ^ y * 2654435761 ^ z * 805459861   otherwise,
//            (x, y, z) = b + (kx, ky, kz) in wrapping uint32, then % T
//   w_k    = (wx[kx] * wy[ky]) * wz[kz],  wx = (1 - fx, fx)
//   K7: out[i, l F + f] = sum_k w_k table[l, slot_k, f], summed in k4_tree's
//       order ((c0 + c1) + (c2 + c3)) + ((c4 + c5) + (c6 + c7)) with
//       __fmul_rn / __fadd_rn, so that it equals hash_encoding_lookup_reference
//       (ops/encodings.py) bit for bit.
//   K8: g_table[l, s, f] = sum over the (lookup, corner) pairs with slot s of
//       w_k g_out[i, l F + f]; g_pos[i, d] = sum_l res_l sum_k dw_k/dfrac_d
//       <table[l, slot_k, :], g_out[i, l, :]>.
// What bounds them on an H100: bytes and the load path. K7 reads 8 entries
// of 4 F bytes a lookup, scattered over a level's table (the field's hashed
// levels are 4 MB at F = 2, so the 16 levels' 67 MB do not fit the 50 MB L2
// together, one level does), and writes 4 F bytes; its float work (about 70
// operations a lookup) is far below the float32 rate. K7's design is the
// simple one: a thread a (sample, level) lookup, threads of one sample on
// adjacent lanes so that the output is written in whole lines, each corner
// read as one F-wide vector load.
// K8 is K5's design on (lookup, corner) pairs: 1. keys: a thread a (sample,
// level slot), the slots of a sample adjacent lanes, writes the 8 keys
// l T + slot_k (below 2^31) and, where g_pos is asked for, reads the 8
// entries and sums the sample's levels by a butterfly in a fixed order;
// 2. K5's stable radix sort of (key, pair id), pair id = 8 (i L + l) + k;
// 3. a segmented reduction of 256 sorted pairs a warp, each pair's weight
// recomputed from its position, a run ending in the chunk stored with plain
// stores at g_table + key F; 4. runs that cross chunks summed by one warp
// each. No float atomic: every sum has an order fixed by the keys and the
// ids, so two launches give the same bits. Where no table needs a gradient
// (the pose gradient), only stage 1 runs, without keys: the same kernel and
// the same arithmetic, so its g_pos equals the full backward's bit for bit.
// The wrapper zero-fills g_table and sizes the scratch as
// hash_lookup_bwd_scratch_bytes says; nothing is allocated here.

constexpr int kCornerThreads = 256;

struct CornerLevels {
    float res[kMaxLevels];      // float(res), the factor of scaled
    unsigned ires[kMaxLevels];
    unsigned dense;             // bit l: level l indexes densely
    unsigned size;              // T, the entries of every level's table
    unsigned mask;              // T - 1 where T is a power of two, else 0
};

struct Corner {
    unsigned base[3];  // floor(scaled) as a wrapping uint32
    float w[3][2];     // per axis (1 - frac, frac)
};

__device__ __forceinline__ Corner corner_locate(const float p[3], const CornerLevels& lv, int l) {
    Corner c;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const float scaled = __fmul_rn(p[d], lv.res[l]);
        const float fl = floorf(scaled);
        const float frac = __fsub_rn(scaled, fl);
        c.base[d] = static_cast<unsigned>(static_cast<long long>(fl));
        c.w[d][0] = __fsub_rn(1.0f, frac);
        c.w[d][1] = frac;
    }
    return c;
}

// The table slot of corner k, in the JAX package's wrapping uint32 arithmetic.
__device__ __forceinline__ unsigned corner_slot(const Corner& c, const CornerLevels& lv, int l, int k) {
    const unsigned x = c.base[0] + static_cast<unsigned>(k >> 2);
    const unsigned y = c.base[1] + static_cast<unsigned>((k >> 1) & 1);
    const unsigned z = c.base[2] + static_cast<unsigned>(k & 1);
    unsigned h;
    if ((lv.dense >> l) & 1u) {
        const unsigned r = lv.ires[l];
        h = x + r * (y + r * z);
    } else {
        h = x ^ y * 2654435761u ^ z * 805459861u;
    }
    return lv.mask ? h & lv.mask : h % lv.size;
}

__device__ __forceinline__ float corner_w(const Corner& c, int k) {
    return __fmul_rn(__fmul_rn(c.w[0][k >> 2], c.w[1][(k >> 1) & 1]), c.w[2][k & 1]);
}

// The F floats of one entry, as one vector load where F allows it.
template <int F>
__device__ __forceinline__ void load_entry(const float* src, float (&v)[F]) {
    if constexpr (F == 1) {
        v[0] = __ldg(src);
    } else if constexpr (F == 2) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(src));
        v[0] = q.x;
        v[1] = q.y;
    } else {
        static_assert(F % 4 == 0, "F is 1, 2 or a multiple of 4");
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(src) + q);
            v[4 * q] = x.x;
            v[4 * q + 1] = x.y;
            v[4 * q + 2] = x.z;
            v[4 * q + 3] = x.w;
        }
    }
}

// K7: one thread a (sample, level) lookup, t = i L + l.
template <int F>
__global__ void __launch_bounds__(kCornerThreads) hash_lookup_fwd_kernel(
    const float* __restrict__ positions, const float* __restrict__ table, float* __restrict__ out, int n,
    int num_levels, CornerLevels lv) {
    const long long t = static_cast<long long>(blockIdx.x) * kCornerThreads + threadIdx.x;
    if (t >= static_cast<long long>(n) * num_levels) return;
    const long long i = t / num_levels;
    const int l = static_cast<int>(t - i * num_levels);
    const float p[3] = {__ldg(positions + 3 * i), __ldg(positions + 3 * i + 1), __ldg(positions + 3 * i + 2)};
    const Corner c = corner_locate(p, lv, l);
    const float* level = table + static_cast<long long>(l) * lv.size * F;
    float prod[8][F];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float v[F];
        load_entry<F>(level + static_cast<long long>(corner_slot(c, lv, l, k)) * F, v);
        const float w = corner_w(c, k);
#pragma unroll
        for (int f = 0; f < F; ++f) prod[k][f] = __fmul_rn(w, v[f]);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
        const float lo = __fadd_rn(__fadd_rn(prod[0][f], prod[1][f]), __fadd_rn(prod[2][f], prod[3][f]));
        const float hi = __fadd_rn(__fadd_rn(prod[4][f], prod[5][f]), __fadd_rn(prod[6][f], prod[7][f]));
        out[t * F + f] = __fadd_rn(lo, hi);
    }
}

// K8, stage 1: one thread a (sample, level slot); kSlots >= L a power of two
// <= 32, so a sample's slots are adjacent lanes of one warp. keys null: no
// keys (the positions-only mode); g_pos null: no position gradient. Block 0
// zeroes the sort's digit totals where they are given. Every thread reaches
// the shuffles: none returns early.
template <int F, int kSlots>
__global__ void __launch_bounds__(kThreads) hash_lookup_bwd_keys_kernel(
    const float* __restrict__ positions, const float* __restrict__ table, const float* __restrict__ g_out,
    float* __restrict__ g_pos, unsigned* __restrict__ keys, unsigned* __restrict__ totals, int n, int num_levels,
    CornerLevels lv) {
    if (totals != nullptr && blockIdx.x == 0)
        for (int k = threadIdx.x; k < kMaxPasses * kRadix; k += kThreads) totals[k] = 0u;
    const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long i = g / kSlots;
    const int l = static_cast<int>(g % kSlots);
    const bool sample = i < n;
    float grad[3] = {0.0f, 0.0f, 0.0f};
    if (sample && l < num_levels) {
        const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
        const Corner c = corner_locate(p, lv, l);
        const long long t = i * num_levels + l;
        const float* level = table + static_cast<long long>(l) * lv.size * F;
        float go[F];
        if (g_pos != nullptr) {
#pragma unroll
            for (int f = 0; f < F; ++f) go[f] = g_out[t * F + f];
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const unsigned slot = corner_slot(c, lv, l, k);
            if (keys != nullptr) keys[t * 8 + k] = static_cast<unsigned>(l) * lv.size + slot;
            if (g_pos == nullptr) continue;
            float v[F];
            load_entry<F>(level + static_cast<long long>(slot) * F, v);
            float dot = 0.0f;
#pragma unroll
            for (int f = 0; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(v[f], go[f]));
            const int kx = k >> 2, ky = (k >> 1) & 1, kz = k & 1;
            // d w_k / d frac_x = (kx ? 1 : -1) wy wz, and likewise for y, z
            const float dx = __fmul_rn(__fmul_rn(c.w[1][ky], c.w[2][kz]), dot);
            const float dy = __fmul_rn(__fmul_rn(c.w[0][kx], c.w[2][kz]), dot);
            const float dz = __fmul_rn(__fmul_rn(c.w[0][kx], c.w[1][ky]), dot);
            grad[0] = kx ? __fadd_rn(grad[0], dx) : __fsub_rn(grad[0], dx);
            grad[1] = ky ? __fadd_rn(grad[1], dy) : __fsub_rn(grad[1], dy);
            grad[2] = kz ? __fadd_rn(grad[2], dz) : __fsub_rn(grad[2], dz);
        }
        // d frac / d pos = res
#pragma unroll
        for (int d = 0; d < 3; ++d) grad[d] = __fmul_rn(lv.res[l], grad[d]);
    }
    if (g_pos == nullptr) return;  // the same for every thread of the launch
#pragma unroll
    for (int off = kSlots / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int d = 0; d < 3; ++d) grad[d] = __fadd_rn(grad[d], __shfl_xor_sync(kFull, grad[d], off));
    }
    if (sample && l == 0) {
#pragma unroll
        for (int d = 0; d < 3; ++d) g_pos[3 * i + d] = grad[d];
    }
}

// K8's sums: a (lookup, corner) pair (pair id 8 t + k, t = i L + l) adds
// w_k g, F values, to its entry's gradient (key l T + slot).
template <int F>
struct CornerSum {
    static constexpr int V = F;
    const float* positions;
    const float* g_out;
    float* g_table;
    int num_levels;
    const CornerLevels& lv;

    __device__ __forceinline__ int values(unsigned id, float (&v)[V]) const {
        const long long t = id >> 3;
        const int k = static_cast<int>(id & 7u);
        const long long i = t / num_levels;
        const int l = static_cast<int>(t - i * num_levels);
        const float p[3] = {positions[3 * i], positions[3 * i + 1], positions[3 * i + 2]};
        const float w = corner_w(corner_locate(p, lv, l), k);
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w, g_out[t * F + f]);
        return l;
    }
    __device__ __forceinline__ int level(unsigned) const { return 0; }
    __device__ __forceinline__ float* dst(unsigned key, int) const {
        return g_table + static_cast<long long>(key) * F;
    }
};

// K8, stage 3: the segmented sum of K5's stage 3 on (lookup, corner) pairs.
template <int F>
__global__ void __launch_bounds__(kThreads) hash_lookup_bwd_reduce_kernel(
    const unsigned* __restrict__ skeys, const unsigned* __restrict__ sids, const float* __restrict__ positions,
    const float* __restrict__ g_out, float* __restrict__ g_table, float* __restrict__ head,
    float* __restrict__ tail, unsigned* __restrict__ tail_key, int num_keys, int num_levels, CornerLevels lv) {
    segmented_sum(skeys, sids, head, tail, tail_key, num_keys, CornerSum<F>{positions, g_out, g_table, num_levels, lv});
}

// K8, stage 4: as K5's.
template <int F>
__global__ void __launch_bounds__(kThreads) hash_lookup_bwd_fixup_kernel(
    const unsigned* __restrict__ skeys, const float* __restrict__ head, const float* __restrict__ tail,
    const unsigned* __restrict__ tail_key, long long num_chunks, float* __restrict__ g_table, CornerLevels lv) {
    segmented_sum_fixup(skeys, head, tail, tail_key, num_chunks, CornerSum<F>{nullptr, nullptr, g_table, 0, lv});
}

// K7/K8's per-level constants. False on what the kernels do not take: the
// keys l T + slot must stay below 2^31.
bool corner_levels(const int* resolutions, int num_levels, int table_size, unsigned dense_mask,
                   CornerLevels* lv) {
    if (num_levels < 1 || num_levels > kMaxLevels || table_size < 1 ||
        static_cast<long long>(num_levels) * table_size > (1LL << 31))
        return false;
    for (int l = 0; l < num_levels; ++l) {
        if (resolutions[l] < 1) return false;
        lv->res[l] = static_cast<float>(resolutions[l]);
        lv->ires[l] = static_cast<unsigned>(resolutions[l]);
    }
    lv->dense = dense_mask;
    lv->size = static_cast<unsigned>(table_size);
    lv->mask = (table_size & (table_size - 1)) == 0 ? static_cast<unsigned>(table_size - 1) : 0u;
    return true;
}

template <int F>
cudaError_t launch_corner_fwd(const float* positions, const float* table, float* out, int n, int num_levels,
                              const CornerLevels& lv, cudaStream_t st) {
    const long long threads = static_cast<long long>(n) * num_levels;
    const int blocks = static_cast<int>((threads + kCornerThreads - 1) / kCornerThreads);
    hash_lookup_fwd_kernel<F><<<blocks, kCornerThreads, 0, st>>>(positions, table, out, n, num_levels, lv);
    return cudaGetLastError();
}

template <int F>
cudaError_t launch_corner_keys(const float* positions, const float* table, const float* g_out, float* g_pos,
                               unsigned* keys, unsigned* totals, int n, int num_levels, const CornerLevels& lv,
                               cudaStream_t st) {
    const int slots = 1 << ceil_log2(num_levels);
    const long long threads = static_cast<long long>(n) * slots;
#define CORNER_KEYS_CASE(k)                                                                          \
    case k:                                                                                          \
        hash_lookup_bwd_keys_kernel<F, k><<<blocks_for(threads), kThreads, 0, st>>>(                 \
            positions, table, g_out, g_pos, keys, totals, n, num_levels, lv);                        \
        break;
    switch (slots) {
        CORNER_KEYS_CASE(1) CORNER_KEYS_CASE(2) CORNER_KEYS_CASE(4) CORNER_KEYS_CASE(8)
        CORNER_KEYS_CASE(16) CORNER_KEYS_CASE(32)
        default:
            return cudaErrorInvalidValue;
    }
#undef CORNER_KEYS_CASE
    return cudaGetLastError();
}

// Every stage of K8, or stage 1 alone without keys where g_table is null.
template <int F>
cudaError_t launch_corner_bwd(const float* positions, const float* table, const float* g_out, float* g_table,
                              float* g_pos, const Scratch& s, int n, int num_levels, const CornerLevels& lv,
                              cudaStream_t st) {
    if (g_table == nullptr)
        return launch_corner_keys<F>(positions, table, g_out, g_pos, nullptr, nullptr, n, num_levels, lv, st);
    const int num_keys = 8 * n * num_levels;
    cudaError_t err = launch_corner_keys<F>(positions, table, g_out, g_pos, s.keys[0], s.totals, n, num_levels,
                                            lv, st);
    if (err != cudaSuccess) return err;
    const int bits = ceil_log2(static_cast<long long>(num_levels) * lv.size);
    const int passes = bits > 0 ? (bits + kDigitBits - 1) / kDigitBits : 1;
    err = radix_sort(s, num_keys, passes, st);
    if (err != cudaSuccess) return err;
    const unsigned* skeys = s.keys[passes & 1];
    const unsigned* sids = s.ids[passes & 1];
    const long long chunks = (static_cast<long long>(num_keys) + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    hash_lookup_bwd_reduce_kernel<F><<<blocks, kThreads, 0, st>>>(skeys, sids, positions, g_out, g_table, s.head,
                                                                  s.tail, s.tail_key, num_keys, num_levels, lv);
    hash_lookup_bwd_fixup_kernel<F><<<blocks, kThreads, 0, st>>>(skeys, s.head, s.tail, s.tail_key, chunks,
                                                                 g_table, lv);
    return cudaGetLastError();
}
}  // namespace

// C interface, loaded with ctypes. Host arrays of L entries: resolutions and
// sizes (T_l, the cells of level l's table) as ints, tables as device
// pointers, level l's table (T_l cells of 8 F floats: its (n_rows_l, 128)
// rows, 16-byte aligned). Device pointers to float32: positions (n, 3)
// contiguous; out (n, L * F) contiguous, 16-byte aligned. features is F in
// {1, 2, 4, 8, 16}; n * L < 2^31. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int cell_lookup_fwd_f32(const float* positions, const void* const* tables, float* out, int n,
                                   int num_levels, const int* sizes, int features, const int* resolutions,
                                   void* stream) {
    Levels lv;
    if (!make_levels(resolutions, num_levels, sizes, tables, nullptr, &lv) || n < 0 ||
        static_cast<long long>(n) * num_levels >= (1LL << 31) ||
        reinterpret_cast<unsigned long long>(out) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = static_cast<int>((static_cast<long long>(n) + kK4Threads - 1) / kK4Threads);
#define K4_CASE(f)                                                                          \
    case f:                                                                                 \
        cell_lookup_fwd_kernel<f><<<blocks, kK4Threads, 0, s>>>(positions, out, n, num_levels, lv); \
        break;
    switch (features) {
        K4_CASE(1) K4_CASE(2) K4_CASE(4) K4_CASE(8) K4_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K4_CASE
    return static_cast<int>(cudaGetLastError());
}

// K6. tables: level l's packed rows (T_l, 8, M, F) contiguous, 16-byte
// aligned, of dtype 0 (float32), 1 (bf16) or 2 (int8; then scales is a
// device array of L float32 scales, null otherwise); positions (n, 3)
// contiguous; out (M, n, L * F) float32 contiguous, 16-byte aligned. members
// is M in [1, 8]; features is F in {1, 2, 4}; n * L < 2^31. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int packed_cell_lookup_fwd(const float* positions, const void* const* tables, const float* scales,
                                      float* out, int n, int num_levels, const int* sizes, int members,
                                      int features, int dtype, const int* resolutions, void* stream) {
    K6Args a;
    Levels lv;
    if (!k6_args(positions, nullptr, tables, scales, out, n, 1, num_levels, sizes, members, features, dtype,
                 resolutions, nullptr, &a, &lv))
        return static_cast<int>(cudaErrorInvalidValue);
    return run_k6(a, lv, features, dtype, false, stream);
}

// K6's strided entry: positions (rays, samples, 3) and t_mid (rays, samples)
// contiguous; out (M, rays, samples, L * F); strides a host array of L ints
// >= 1, K_l of each level (1: looked up at every sample). Otherwise as
// packed_cell_lookup_fwd, with n = rays * samples.
extern "C" int packed_cell_lookup_strided_fwd(const float* positions, const float* t_mid,
                                              const void* const* tables, const float* scales, float* out,
                                              int rays, int samples, int num_levels, const int* sizes,
                                              int members, int features, int dtype, const int* resolutions,
                                              const int* strides, void* stream) {
    K6Args a;
    Levels lv;
    if (rays < 0 || samples < 1 ||
        !k6_args(positions, t_mid, tables, scales, out, static_cast<long long>(rays) * samples, samples,
                 num_levels, sizes, members, features, dtype, resolutions, strides, &a, &lv))
        return static_cast<int>(cudaErrorInvalidValue);
    return run_k6(a, lv, features, dtype, true, stream);
}

// Bytes of dynamic shared memory a K6 block takes (kK6Warps warps).
extern "C" int packed_cell_lookup_shared_bytes(int num_levels, int members, int features, int dtype) {
    return k6_shared_bytes(members, features, dtype, num_levels);
}

// Bytes of scratch K5 (and cell_lookup_sort_u32) needs for n samples, or -1
// for arguments the kernels do not take (the keys would need more than 31
// bits, or n * L >= 2^31).
extern "C" long long cell_lookup_bwd_scratch_bytes(int n, int num_levels, const int* sizes, int features) {
    KeyLayout kl;
    if (n < 0 || num_levels < 1 || num_levels > kMaxLevels) return -1;
    for (int l = 0; l < num_levels; ++l)
        if (sizes[l] < 1) return -1;
    if (!key_layout(num_levels, sizes, &kl)) return -1;
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups >= (1LL << 31)) return -1;
    Scratch s;
    return carve(nullptr, lookups, features, &s);
}

// As cell_lookup_fwd_f32, with g_out (n, L * F) contiguous, g_tables a host
// array of L device pointers, level l's gradient of its table's shape,
// zero-filled by the caller, 16-byte aligned, g_pos (n, 3) or null (then the
// tables are not read), and scratch of cell_lookup_bwd_scratch_bytes bytes,
// 256-byte aligned. Every cell that a lookup touches is stored once; g_pos is
// written in full. g_tables null: the positions-only mode, where no table
// needs a gradient: only stage 1 runs, without keys (no zero-fill, sort or
// reduction; scratch may be null), and g_pos equals the full backward's bit
// for bit.
extern "C" int cell_lookup_bwd_f32(const float* positions, const void* const* tables, const float* g_out,
                                   float* const* g_tables, float* g_pos, int n, int num_levels,
                                   const int* sizes, int features, const int* resolutions, void* scratch,
                                   long long scratch_bytes, void* stream) {
    Levels lv;
    KeyLayout kl;
    if (!make_levels(resolutions, num_levels, sizes, tables, g_tables, &lv) || n < 0 ||
        !key_layout(num_levels, sizes, &kl) || (g_tables == nullptr && g_pos == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int l = 0; l < num_levels && g_tables != nullptr; ++l)
        if (lv.grad[l] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups == 0) return 0;
    if (lookups >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    if (g_tables == nullptr) {
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        cudaError_t err;
#define K5_POS_CASE(f) \
    case f: err = launch_keys<f>(positions, g_out, g_pos, nullptr, n, num_levels, lv, st); break;
        switch (features) {
            K5_POS_CASE(1) K5_POS_CASE(2) K5_POS_CASE(4) K5_POS_CASE(8) K5_POS_CASE(16)
            default:
                return static_cast<int>(cudaErrorInvalidValue);
        }
#undef K5_POS_CASE
        return static_cast<int>(err);
    }
    Scratch s;
    if (lookups >= (1LL << 31) ||
        carve(static_cast<char*>(scratch), lookups, features, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define K5_CASE(f)                                                                   \
    case f:                                                                          \
        err = launch_bwd<f>(positions, g_out, g_pos, s, n, num_levels, kl, lv, st);  \
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
extern "C" int cell_lookup_sort_u32(const float* positions, int n, int num_levels, const int* sizes,
                                    const int* resolutions, unsigned* keys_out, unsigned* sorted_out,
                                    unsigned* perm_out, void* scratch, long long scratch_bytes, void* stream) {
    Levels lv;
    KeyLayout kl;
    if (!make_levels(resolutions, num_levels, sizes, nullptr, nullptr, &lv) || n < 0 ||
        !key_layout(num_levels, sizes, &kl))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long lookups = static_cast<long long>(n) * num_levels;
    if (lookups == 0) return 0;
    Scratch s;
    if (lookups >= (1LL << 31) || carve(static_cast<char*>(scratch), lookups, 1, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = launch_keys<1>(positions, nullptr, nullptr, &s, n, num_levels, lv, st);
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

// K5's stable radix sort alone, on plain u32 keys below 2^bits (bits in 1 ..
// 32): sorted_out (num_keys) gets the keys in ascending order and perm_out
// the stable permutation (the input position of each sorted key; equal keys
// keep their input order). Used by the splat path's packed-row backward
// (csrc/packed_rows.cu). Scratch of radix_sort_u32_scratch_bytes bytes,
// 256-byte aligned.
extern "C" long long radix_sort_u32_scratch_bytes(int num_keys) {
    if (num_keys < 0) return -1;
    Scratch s;
    return carve(nullptr, num_keys, 1, &s);
}

extern "C" int radix_sort_u32(const unsigned* keys, int num_keys, int bits, unsigned* sorted_out,
                              unsigned* perm_out, void* scratch, long long scratch_bytes,
                              void* stream) {
    if (num_keys < 0 || bits < 1 || bits > kDigitBits * kMaxPasses)
        return static_cast<int>(cudaErrorInvalidValue);
    if (num_keys == 0) return 0;
    Scratch s;
    if (carve(static_cast<char*>(scratch), num_keys, 1, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t bytes = 4 * static_cast<size_t>(num_keys);
    const int passes = (bits + kDigitBits - 1) / kDigitBits;
    cudaError_t err = cudaMemcpyAsync(s.keys[0], keys, bytes, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the histograms add into the digit totals (K5's keys kernel zeroes them)
    err = cudaMemsetAsync(s.totals, 0, 4 * kRadix * kMaxPasses, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = radix_sort(s, num_keys, passes, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyAsync(sorted_out, s.keys[passes & 1], bytes, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemcpyAsync(perm_out, s.ids[passes & 1], bytes, cudaMemcpyDeviceToDevice, st);
    return static_cast<int>(err);
}

// K7. table: (L, T, F) float32 contiguous, 16-byte aligned; positions (n, 3)
// contiguous; out (n, L * F) contiguous. resolutions a host array of L ints;
// dense_mask bit l: level l indexes densely ((res_l + 1)^3 <= T in float32,
// as the JAX package decides). features is F in {1, 2, 4, 8}; n * L < 2^31,
// L T <= 2^31. Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int hash_lookup_fwd_f32(const float* positions, const float* table, float* out, int n, int num_levels,
                                   int table_size, int features, const int* resolutions, unsigned dense_mask,
                                   void* stream) {
    CornerLevels lv;
    if (!corner_levels(resolutions, num_levels, table_size, dense_mask, &lv) || n < 0 ||
        static_cast<long long>(n) * num_levels >= (1LL << 31) || reinterpret_cast<unsigned long long>(table) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (features) {
        case 1: return static_cast<int>(launch_corner_fwd<1>(positions, table, out, n, num_levels, lv, st));
        case 2: return static_cast<int>(launch_corner_fwd<2>(positions, table, out, n, num_levels, lv, st));
        case 4: return static_cast<int>(launch_corner_fwd<4>(positions, table, out, n, num_levels, lv, st));
        case 8: return static_cast<int>(launch_corner_fwd<8>(positions, table, out, n, num_levels, lv, st));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Bytes of scratch K8 needs for n samples (8 n L keys and pair ids, twice,
// the sort's counts, the chunks' partial sums), or -1 for arguments it does
// not take (8 n L >= 2^31).
extern "C" long long hash_lookup_bwd_scratch_bytes(int n, int num_levels, int features) {
    if (n < 0 || num_levels < 1 || num_levels > kMaxLevels || features < 1) return -1;
    const long long keys = 8LL * n * num_levels;
    if (keys >= (1LL << 31)) return -1;
    Scratch s;
    return carve(nullptr, keys, features, &s);
}

// K8, as hash_lookup_fwd_f32, with g_out (n, L * F) contiguous; g_table (L,
// T, F) zero-filled by the caller, 16-byte aligned, or null (then only the
// position gradient is computed, no key is sorted and scratch may be null);
// g_pos (n, 3) or null; and scratch of hash_lookup_bwd_scratch_bytes bytes,
// 256-byte aligned. Every entry that a lookup touches is stored once; g_pos
// is written in full.
extern "C" int hash_lookup_bwd_f32(const float* positions, const float* table, const float* g_out,
                                   float* g_table, float* g_pos, int n, int num_levels, int table_size,
                                   int features, const int* resolutions, unsigned dense_mask, void* scratch,
                                   long long scratch_bytes, void* stream) {
    CornerLevels lv;
    if (!corner_levels(resolutions, num_levels, table_size, dense_mask, &lv) || n < 0 ||
        (g_table == nullptr && g_pos == nullptr) || 8LL * n * num_levels >= (1LL << 31) ||
        reinterpret_cast<unsigned long long>(table) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    Scratch s = {};
    if (g_table != nullptr &&
        carve(static_cast<char*>(scratch), 8LL * n * num_levels, features, &s) > scratch_bytes)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define K8_CASE(f)                                                                                    \
    case f:                                                                                           \
        err = launch_corner_bwd<f>(positions, table, g_out, g_table, g_pos, s, n, num_levels, lv, st); \
        break;
    switch (features) {
        K8_CASE(1) K8_CASE(2) K8_CASE(4) K8_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K8_CASE
    return static_cast<int>(err);
}
