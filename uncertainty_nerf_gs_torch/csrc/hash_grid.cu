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
// Where no table needs a gradient, K5 is one launch of a kernel of its own
// (cell_lookup_bwd_pos_kernel, K4's warp walk over the levels) that gives
// the keys kernel's g_pos bit for bit.

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

// A warp's staged outputs into `out`, rows of `row` floats, the warp's first
// sample `base` (a multiple of 32), `valid` samples staged `stride` floats
// apart: floats [first, first + width) of each row. A pass over whole rows
// writes the warp's samples as one contiguous run of floats, 16-byte aligned,
// as float4s; a pass over part of a row, each sample's run of `width` floats,
// consecutive lanes on consecutive floats. The warp may reuse its stage after.
__device__ __forceinline__ void stage_flush(const float* buf, int stride, float* out, long long base, int valid,
                                            int row, int first, int width, int lane) {
    if (width == row) {
        float* dst = out + base * row;
        const int total = valid * row;
        for (int k = lane; k < total / 4; k += 32) {
            int s = 4 * k / width, j = 4 * k - s * width;
            float t[4];
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                t[m] = buf[s * stride + j];
                if (++j == width) j = 0, ++s;
            }
            reinterpret_cast<float4*>(dst)[k] = make_float4(t[0], t[1], t[2], t[3]);
        }
        for (int e = (total & ~3) + lane; e < total; e += 32) {
            const int s = e / width;
            dst[e] = buf[s * stride + e - s * width];
        }
    } else {
        for (int e = lane; e < valid * width; e += 32) {
            const int s = e / width, j = e - s * width;
            out[(base + s) * row + first + j] = buf[s * stride + j];
        }
    }
    __syncwarp();
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
        __syncwarp();
        stage_flush(buf, kStride, out, base, valid, row, l0 * F, (l1 - l0) * F, lane);
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
// keys and totals null: g_pos alone (the positions-only mode has a kernel of
// its own, cell_lookup_bwd_pos_kernel, that gives the same bits).
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

// -- K5's positions-only mode: the position gradient alone ---------------------

// Where no table needs a gradient (the pose gradient's backward through K4),
// K5 runs this kernel alone: no keys, zero-fill, sort or reduction. What
// bounds it: bytes, as K4 (the positions, g_out and each touched cell read,
// g_pos written). The keys kernel's thread a (sample, level slot) left 3 of
// every 8 lanes idle at the proposals' 5 levels, re-read each sample's
// position in every lane, and loaded a 64-byte cell a lane even where the
// samples of a ray share it. Here, as in K4:
//   - A warp takes 32 consecutive samples and walks the levels; lane s keeps
//     sample s's position in registers and locates its cell once a level.
//     Where a level's table passes kK5PosPrefetchBytes (the field's hashed
//     levels, read from DRAM), the next level's cells and g_out are loaded
//     while this level's term is formed (F <= 4), the registers held to
//     kK5PosPrefetchBlocks blocks an SM; on tables that stay in L2 (the
//     proposals') the extra registers cost more than the overlap gains.
//   - Cells are read shared or own by what the warp sees: at more than
//     kK5PosOwnMaxRuns runs of equal cells among the 32 lookups, 2 F lanes
//     share each lookup's read (one float4 each) and form the dots of the
//     corners in their float4, which the lookup's lane takes from shared
//     memory; at fewer, each lane reads its own cell, and lanes that read one
//     cell share the wavefront. F >= 8 reads its own cells (a corner spans
//     two float4s).
//   - Each level's term is the keys kernel's: the corners' dots
//     <cell[c, :], g_out[i, l, :]> and the three chains over the corners by
//     fmaf, in its order, times res_l.
//   - Each lane keeps its levels' terms in shared memory (a column of its
//     own, no barrier) and sums them at the end in the tree of the keys
//     kernel's xor butterfly over kSlots, the next power of two >= L: slot l
//     meets slot l + kSlots / 2 first, then the pairs meet at kSlots / 4,
//     and so on; the slots past L add zeros. So g_pos equals the full
//     backward's bit for bit.
constexpr int kK5PosWarps = 4;  // a block: 4 warps, 128 samples
constexpr int kK5PosThreads = 32 * kK5PosWarps;
// A level whose 32 lookups form more runs of equal cells than this is read
// with shared reads; one with fewer, by each lane on its own.
constexpr int kK5PosOwnMaxRuns = 16;
// Where the largest level's table passes this, the next level's reads are
// issued before this level's term is formed (F <= 4), at this many blocks an
// SM (80 registers a thread).
constexpr long long kK5PosPrefetchBytes = 16LL << 20;
constexpr int kK5PosPrefetchBlocks = 6;

// The keys kernel's dot of one corner: fmaf over its F features in order.
template <int F>
__device__ __forceinline__ float k5_dot(const float* v, const float (&g)[F]) {
    float dot = 0.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) dot = fmaf(v[f], g[f], dot);
    return dot;
}

// The keys kernel's term of one level from its 8 corners' dots, res_l
// included. Its factor (sx * wy) * wz for d w[c] / d frac_x is +-(wy * wz):
// a product by -1 is exact, so the 12 products below are its 24 bit for bit.
__device__ __forceinline__ void k5_term(const Cell& cell, const float (&dots)[8], float res, float (&grad)[3]) {
    float yz[2][2], xz[2][2], xy[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            yz[a][b] = __fmul_rn(cell.w[1][a], cell.w[2][b]);
            xz[a][b] = __fmul_rn(cell.w[0][a], cell.w[2][b]);
            xy[a][b] = __fmul_rn(cell.w[0][a], cell.w[1][b]);
        }
    }
    grad[0] = grad[1] = grad[2] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float dot = dots[c];
        const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
        // d w[c] / d frac_x = (cx ? 1 : -1) * wy * wz, and likewise for y, z
        grad[0] = fmaf(cx ? yz[cy][cz] : -yz[cy][cz], dot, grad[0]);
        grad[1] = fmaf(cy ? xz[cx][cz] : -xz[cx][cz], dot, grad[1]);
        grad[2] = fmaf(cz ? xy[cx][cy] : -xy[cx][cy], dot, grad[2]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) grad[d] = __fmul_rn(res, grad[d]);  // d frac / d pos = res
}

// One level's reads for a lane of the positions-only mode (F <= 4): its
// cell, its g_out and the 2 F float4s it loads, of a shared read (part q of
// round k's lookup) or of an own read (its own cell), through the same load
// instructions. The warp issues the next level's while it sums this one's.
template <int F>
struct K5PosLevel {
    Cell cell;
    float g[F];
    float4 v[2 * F];
    bool shared;
};

template <int F>
__device__ __forceinline__ void k5_pos_fetch(K5PosLevel<F>& x, const float p[3], const float* __restrict__ g_out,
                                             long long i, bool valid, int num_levels, int l, const Levels& lv,
                                             int lane) {
    constexpr int kParts = 2 * F, kPerLoad = 32 / kParts;
    x.cell = locate(p, lv, l);
#pragma unroll
    for (int f = 0; f < F; ++f) x.g[f] = valid ? g_out[(i * num_levels + l) * F + f] : 0.0f;
    x.shared = k4_runs(x.cell.idx, lane) > kK5PosOwnMaxRuns;
    const float4* level_cells = static_cast<const float4*>(lv.table[l]);
    const int q = lane % kParts, j0 = lane / kParts;
#pragma unroll
    for (int k = 0; k < kParts; ++k) {
        unsigned idx = x.cell.idx;
        int part = k;
        if (x.shared) {
            idx = __shfl_sync(kFull, x.cell.idx, k * kPerLoad + j0);
            part = q;
        }
        x.v[k] = __ldg(level_cells + static_cast<long long>(idx) * kParts + part);
    }
}

// The lane's level term from its fetched reads. A shared read's lanes form
// the dots of the corners in their float4 (corners 4q / F .. (4q + 3) / F
// of round k's lookup) and leave them in `dots` for the lookup's lane.
template <int F>
__device__ __forceinline__ void k5_pos_term(const K5PosLevel<F>& x, float (*dots)[9], float res, int lane,
                                            float (&term)[3]) {
    constexpr int kParts = 2 * F, kPerLoad = 32 / kParts;
    float dv[8];
    if (x.shared) {
        const int q = lane % kParts, j0 = lane / kParts;
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
            const int j = k * kPerLoad + j0;
            float gj[F];
#pragma unroll
            for (int f = 0; f < F; ++f) gj[f] = __shfl_sync(kFull, x.g[f], j);
            const float v[4] = {x.v[k].x, x.v[k].y, x.v[k].z, x.v[k].w};
#pragma unroll
            for (int m = 0; m < 4 / F; ++m) dots[j][4 * q / F + m] = k5_dot<F>(v + m * F, gj);
        }
        __syncwarp();
#pragma unroll
        for (int c = 0; c < 8; ++c) dv[c] = dots[lane][c];
        __syncwarp();  // the next level may write again
    } else {
        float v[8 * F];
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
            v[4 * k] = x.v[k].x, v[4 * k + 1] = x.v[k].y, v[4 * k + 2] = x.v[k].z, v[4 * k + 3] = x.v[k].w;
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) dv[c] = k5_dot<F>(v + c * F, x.g);
    }
    k5_term(x.cell, dv, res, term);
}

#ifdef __CUDACC__
// The positions-only kernel's dynamic shared memory (the host test harness
// stands in): each warp's terms, [slot][d][lane].
__device__ __forceinline__ float* k5_pos_shared() {
    extern __shared__ float k5_pos_smem[];
    return k5_pos_smem;
}
#endif

// One warp a run of 32 samples, every level; slots = kSlots.
template <int F, bool kPrefetch>
__global__ void __launch_bounds__(kK5PosThreads, kPrefetch ? kK5PosPrefetchBlocks : 1) cell_lookup_bwd_pos_kernel(
    const float* __restrict__ positions, const float* __restrict__ g_out, float* __restrict__ g_pos, int n,
    int num_levels, int slots, Levels lv) {
    __shared__ float dots[kK5PosWarps][32][9];  // a lookup's corners' dots, padded against bank conflicts
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base = (static_cast<long long>(blockIdx.x) * kK5PosWarps + warp) * 32;
    if (base >= n) return;  // the whole warp
    const long long i = base + lane;
    const bool valid = i < n;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (valid) {
#pragma unroll
        for (int d = 0; d < 3; ++d) p[d] = positions[3 * i + d];
    }
    float* terms = k5_pos_shared() + warp * slots * 3 * 32 + lane;  // terms[(l * 3 + d) * 32]
    K5PosLevel<F <= 4 ? F : 1> next;
    if constexpr (F <= 4 && kPrefetch) k5_pos_fetch<F>(next, p, g_out, i, valid, num_levels, 0, lv, lane);
    for (int l = 0; l < num_levels; ++l) {
        float term[3];
        if constexpr (F <= 4 && kPrefetch) {
            const K5PosLevel<F> cur = next;
            if (l + 1 < num_levels) k5_pos_fetch<F>(next, p, g_out, i, valid, num_levels, l + 1, lv, lane);
            k5_pos_term<F>(cur, dots[warp], lv.res[l], lane, term);
        } else if constexpr (F <= 4) {
            k5_pos_fetch<F>(next, p, g_out, i, valid, num_levels, l, lv, lane);
            k5_pos_term<F>(next, dots[warp], lv.res[l], lane, term);
        } else {
            // a corner spans two float4s: each lane reads its own cell
            const Cell cell = locate(p, lv, l);
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f) g[f] = valid ? g_out[(i * num_levels + l) * F + f] : 0.0f;
            float v[8 * F];
            load_cell<F>(static_cast<const float*>(lv.table[l]) + static_cast<long long>(cell.idx) * (8 * F), v);
            float dv[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) dv[c] = k5_dot<F>(v + c * F, g);
            k5_term(cell, dv, lv.res[l], term);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) terms[(l * 3 + d) * 32] = term[d];
    }
    // the butterfly's tree: slot s meets slot s + half; the first round's
    // slots past L are zeros (every later slot is a sum)
    for (int half = slots >> 1; half > 0; half >>= 1) {
        for (int s = 0; s < half; ++s) {
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                const float other = s + half < num_levels ? terms[((s + half) * 3 + d) * 32] : 0.0f;
                terms[(s * 3 + d) * 32] = __fadd_rn(terms[(s * 3 + d) * 32], other);
            }
        }
        num_levels = half;  // every slot below half now holds a sum
    }
    if (valid) {
#pragma unroll
        for (int d = 0; d < 3; ++d) g_pos[3 * i + d] = terms[d * 32];
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
// num_keys_dev, where given, holds the count of keys on the device (the grid
// covers the most there can be; tiles past the count write zero counts).
__global__ void __launch_bounds__(kSortThreads) cell_lookup_bwd_hist_kernel(
    const unsigned* __restrict__ keys, unsigned* __restrict__ counts,
    unsigned* __restrict__ totals, int num_keys, int num_tiles, int shift,
    const unsigned* __restrict__ num_keys_dev) {
    __shared__ unsigned hist[kRadix];
    if (num_keys_dev != nullptr) num_keys = static_cast<int>(*num_keys_dev);
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
// order of their positions, so the sort is stable. Tile b holds the keys
// from b * tile_stride on: its tile_counts[b] keys where tile_counts is
// given (K8's windows of partials), else those below the count (num_keys_dev
// on the device where given, else num_keys).
template <bool kFirst>
__global__ void __launch_bounds__(kSortThreads) cell_lookup_bwd_scatter_kernel(
    const unsigned* __restrict__ keys_in, const unsigned* __restrict__ ids_in,
    unsigned* __restrict__ keys_out, unsigned* __restrict__ ids_out,
    const unsigned* __restrict__ offsets, int num_keys, int num_tiles, int shift,
    const unsigned* __restrict__ num_keys_dev, const unsigned* __restrict__ tile_counts, int tile_stride) {
    __shared__ unsigned warp_count[kSortWarps][kRadix];
    __shared__ unsigned digit_start[kRadix];
    __shared__ unsigned scan_smem[kSortWarps + 1];
    __shared__ unsigned s_keys[kSortTile];
    __shared__ unsigned s_ids[kSortTile];
    const long long tile0 = static_cast<long long>(blockIdx.x) * tile_stride;
    const long long left = tile_counts != nullptr ? static_cast<long long>(tile_counts[blockIdx.x])
                           : (num_keys_dev != nullptr ? static_cast<long long>(*num_keys_dev) : num_keys) - tile0;
    const int count = left < kSortTile ? (left > 0 ? static_cast<int>(left) : 0) : kSortTile;
    if (count == 0) return;  // the whole block: a tile past the count
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < kSortWarps * kRadix; k += kSortThreads)
        (&warp_count[0][0])[k] = 0u;
    __syncthreads();

    const int warp0 = warp * (32 * kSortItems);
    const unsigned below_mask = (1u << lane) - 1u;
    unsigned key[kSortItems], id[kSortItems], rank[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
        const int local = warp0 + r * 32 + lane;
        const long long j = tile0 + local;
        const bool valid = local < count;
        key[r] = valid ? keys_in[j] : 0u;
        id[r] = valid ? (kFirst ? static_cast<unsigned>(j) : ids_in[j]) : 0u;
        rank[r] = 0u;
        if (warp0 + r * 32 >= count) continue;  // the whole warp: a round past the tile's keys
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
        if (warp0 + r * 32 + lane < count) {
            const unsigned d = (key[r] >> shift) & (kRadix - 1);
            const unsigned pos = digit_start[d] + warp_count[warp][d] + rank[r];
            s_keys[pos] = key[r];
            s_ids[pos] = id[r];
        }
    }
    __syncthreads();

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

// Bytes of the positions-only kernel's dynamic shared memory: each warp's
// terms, kSlots x 3 x 32 floats.
int k5_pos_shared_bytes(int num_levels) { return kK5PosWarps * (1 << ceil_log2(num_levels)) * 3 * 32 * 4; }

// K5's positions-only mode.
template <int F>
cudaError_t launch_pos(const float* positions, const float* g_out, float* g_pos, int n, int num_levels,
                       const Levels& lv, cudaStream_t st) {
    const long long warps = (static_cast<long long>(n) + 31) / 32;
    const int blocks = static_cast<int>((warps + kK5PosWarps - 1) / kK5PosWarps);
    const int bytes = k5_pos_shared_bytes(num_levels);
    long long table_bytes = 0;
    for (int l = 0; l < num_levels; ++l)
        if (static_cast<long long>(lv.size[l]) * 32 * F > table_bytes) table_bytes = static_cast<long long>(lv.size[l]) * 32 * F;
    auto kernel = table_bytes > kK5PosPrefetchBytes ? cell_lookup_bwd_pos_kernel<F, true>
                                                    : cell_lookup_bwd_pos_kernel<F, false>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kK5PosThreads, bytes, st>>>(positions, g_out, g_pos, n, num_levels, 1 << ceil_log2(num_levels),
                                                 lv);
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
                                                                     tiles, shift, nullptr);
        cell_lookup_bwd_scan_kernel<<<kRadix, kSortThreads, 0, st>>>(s.counts, totals, tiles);
        if (p == 0)
            cell_lookup_bwd_scatter_kernel<true><<<tiles, kSortThreads, 0, st>>>(
                kin, nullptr, kout, iout, s.counts, num_keys, tiles, shift, nullptr, nullptr, kSortTile);
        else
            cell_lookup_bwd_scatter_kernel<false><<<tiles, kSortThreads, 0, st>>>(
                kin, iin, kout, iout, s.counts, num_keys, tiles, shift, nullptr, nullptr, kSortTile);
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
// operations a lookup) is far below the float32 rate. Each 8-byte entry is
// read as a 32-byte sector, so what limits it is how many sectors and load
// requests the lookups cost, and whether the level's table is in L2.
// K7's design: where the levels' tables together pass half the L2 (the
// field's 67 MB), the level walk on K4's structure:
//   - A warp takes 32 consecutive samples and walks the levels one at a
//     time; lane s keeps sample s's position and locates its cell once a
//     level. The warps of a launch move through the levels roughly
//     together, so one level's table is hot in L2 at a time.
//   - Own reads: where the warp's cells repeat in runs (coarse levels,
//     samples along a ray: at most kK7OwnMaxRuns runs of equal cells among
//     the 32, counted by one ballot), each lane reads its own 8 corners, all
//     in flight at once; lanes in one cell load the same entries in one
//     instruction.
//   - Pair reads otherwise: two lanes take a lookup, one its 4 corners with
//     kx = 0, the other the 4 with kx = 1, so that corner (0, ky, kz) and
//     (1, ky, kz) load in one instruction. Their slots differ only in x's low
//     bits (dense: x and x + 1; hashed: by x ^ (x + 1), below 4 unless x % 4
//     is 3), so at F = 2 the two entries share a 32-byte sector most of the
//     time. A lane takes its lookup's cell and fractions by __shfl_sync.
//   - Either way the sum is k4_tree's: in a pair each lane sums its four
//     corners, ((c0 + c1) + (c2 + c3)) or ((c4 + c5) + (c6 + c7)), and the
//     two add across by __shfl_xor_sync; both reads give the same bits.
//   - The warp stages its samples' outputs in shared memory and writes them
//     as whole lines (stage_flush, K4's), not F scalars a thread at a stride.
// Where the tables fit (the proposals' 5.2 MB), every level stays hot in L2
// anyway, and the walk's 64 registers a thread keep fewer loads in flight
// than a thread a (sample, level) lookup, which was faster there on an H100
// (PERF.md, section 6): those tables take that one
// (hash_lookup_fwd_lookup_kernel). Both give the plain version's bits.
//
// K8's own work is K7's gather run backwards: read each lookup's position and
// g_out, write each touched entry's F sums once, and for g_pos read each
// lookup's 8 entries once more. A scatter with float atomics would add in an
// order that changes from launch to launch, and a step has 83 M (lookup,
// corner) pairs (proposal 0's 41.9 M on 5 x 131,072 entries, 64 a entry),
// most of whose duplicates sit next to each other in lookup order (the
// samples of a ray). K8 therefore reduces where the duplicates are, then
// sorts what is left:
//   1. A tile stage: one block a tile of 256 consecutive samples, a thread a
//      sample, walking the levels. It reads positions and g_out once,
//      coalesced, and at each level forms each lookup's 8 (slot, w_k g)
//      pairs. Each warp first sums the runs of equal cells among its 32
//      consecutive lookups corner by corner (a segmented scan of shuffles),
//      so that a run gives 8 items; the block's items, in lookup order, are
//      sorted by slot in shared memory with a stable LSD radix sort (digits
//      of at most 10 bits over the slot's bits: 2 passes up to 20 bits;
//      ranked within each warp by __match_any_sync, K5's scatter in shared
//      memory); each run of equal slots is summed in that order (a thread's
//      8 sorted items in turn, a run that spans threads continued from
//      thread to thread); and one partial (key l T + slot, F sums) a
//      distinct slot is written, the block's levels one after the other in
//      its range of (L + 1) / 2 windows of 4,096 partials, each window
//      counted in the histogram of the key's low digit for the global
//      sort's first pass. g_pos comes from the same pass, with the same
//      arithmetic and the same tree over the levels as before: each level's
//      term, then the butterfly of a sample's levels padded to a power of
//      two, taken level by level in shared memory. Without a table gradient
//      (the pose gradient) the stage runs without its pairs, and its g_pos
//      equals the full backward's bit for bit.
//   2. K5's stable radix sort of (key, partial id), 8-bit digits: its first
//      pass takes the windows in place (their counts and histograms from the
//      tile stage), the later passes the dense partials, their count read on
//      the device (the grid covers the most there can be, so nothing is read
//      back to the host and the step stays capturable).
//   3. K5's segmented sum over the sorted partials, each reading its F sums
//      by id, and 4. its fixup for runs that cross chunks.
// Every float sum has an order fixed by the inputs: inside a tile, the scan's
// over a warp's cell runs, then item (lookup) order; across tiles, tile
// order, which the stable sort keeps. So two launches give the same bits,
// with no float atomic (integer atomics only: the histograms and the
// partials' count). What this costs beside the function's own bytes: the
// partials (written, sorted in 3 passes, read back) and the shared-memory
// sort of every tile-level's items. The wrapper zero-fills g_table and sizes
// the scratch as hash_lookup_bwd_scratch_bytes says (for every pair a
// partial, the most there can be); nothing is allocated here.

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

// -- K7 -------------------------------------------------------------------------

constexpr int kK7Warps = 4;  // a block: 4 warps, 128 samples
constexpr int kK7Threads = 32 * kK7Warps;
constexpr int kK7Stage = 32;  // outputs a sample stages per pass over the levels
// A level whose 32 lookups lie in at most this many runs of equal cells is
// read by each lane on its own; one with more, by lane pairs.
constexpr int kK7OwnMaxRuns = 8;
// The walk where the levels' tables together pass half the 50 MB L2; below
// that, a thread a lookup (hash_lookup_fwd_lookup_kernel).
constexpr long long kK7WalkBytes = 25LL << 20;
constexpr int kK7LookupThreads = 256;

// Runs of equal cells among the warp's 32 lookups at one level, in lane order.
__device__ __forceinline__ int k7_runs(const Corner& c, int lane) {
    const unsigned px = __shfl_up_sync(kFull, c.base[0], 1);
    const unsigned py = __shfl_up_sync(kFull, c.base[1], 1);
    const unsigned pz = __shfl_up_sync(kFull, c.base[2], 1);
    return __popc(__ballot_sync(kFull, lane == 0 || px != c.base[0] || py != c.base[1] || pz != c.base[2]));
}

// The entries of corners k0 .. k0 + 3 of the lookup at c, all four in flight.
template <int F>
__device__ __forceinline__ void k7_load(const Corner& c, const float* level, const CornerLevels& lv, int l, int k0,
                                        float (&v)[4][F]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) load_entry<F>(level + static_cast<long long>(corner_slot(c, lv, l, k0 + q)) * F, v[q]);
}

// ((c0 + c1) + (c2 + c3)) over corners k0 .. k0 + 3, c_q = w_(k0 + q) entry_q
// rounded: half of k4_tree.
template <int F>
__device__ __forceinline__ void k7_half(const Corner& c, const float (&v)[4][F], int k0, float (&s)[F]) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = corner_w(c, k0 + q);
#pragma unroll
    for (int f = 0; f < F; ++f)
        s[f] = __fadd_rn(__fadd_rn(__fmul_rn(w[0], v[0][f]), __fmul_rn(w[1], v[1][f])),
                         __fadd_rn(__fmul_rn(w[2], v[2][f]), __fmul_rn(w[3], v[3][f])));
}

// One warp a run of 32 samples, every level; see the note at the top.
template <int F>
__global__ void __launch_bounds__(kK7Threads) hash_lookup_fwd_walk_kernel(
    const float* __restrict__ positions, const float* __restrict__ table, float* __restrict__ out, int n,
    int num_levels, CornerLevels lv) {
    constexpr int kWidth = kK7Stage > F ? kK7Stage : F;  // staged floats a sample a pass
    constexpr int kStride = kWidth + 1;  // padded against bank conflicts
    __shared__ float stage[kK7Warps][32 * kStride];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long base = (static_cast<long long>(blockIdx.x) * kK7Warps + warp) * 32;
    if (base >= n) return;  // the whole warp
    const int valid = n - base < 32 ? static_cast<int>(n - base) : 32;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (lane < valid) {
#pragma unroll
        for (int d = 0; d < 3; ++d) p[d] = __ldg(positions + 3 * (base + lane) + d);
    }
    float* buf = stage[warp];
    const int row = num_levels * F;
    const int levels_a_pass = kWidth / F < num_levels ? kWidth / F : num_levels;
    for (int l0 = 0; l0 < num_levels; l0 += levels_a_pass) {
        const int l1 = l0 + levels_a_pass < num_levels ? l0 + levels_a_pass : num_levels;
        for (int l = l0; l < l1; ++l) {
            const Corner c = corner_locate(p, lv, l);
            const float* level = table + static_cast<long long>(l) * lv.size * F;
            float* level_row = buf + (l - l0) * F;
            if (k7_runs(c, lane) <= kK7OwnMaxRuns) {
                float v0[4][F], v1[4][F];
                k7_load<F>(c, level, lv, l, 0, v0);
                k7_load<F>(c, level, lv, l, 4, v1);
                float lo[F], hi[F];
                k7_half<F>(c, v0, 0, lo);
                k7_half<F>(c, v1, 4, hi);
#pragma unroll
                for (int f = 0; f < F; ++f) level_row[lane * kStride + f] = __fadd_rn(lo[f], hi[f]);
            } else {
                // lane pair j of round r takes lookup 16 r + j: the even lane
                // its corners with kx = 0, the odd lane those with kx = 1
                const int kx = lane & 1;
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int src = 16 * r + (lane >> 1);
                    Corner pc;
#pragma unroll
                    for (int d = 0; d < 3; ++d) {
                        pc.base[d] = __shfl_sync(kFull, c.base[d], src);
                        pc.w[d][1] = __shfl_sync(kFull, c.w[d][1], src);
                        pc.w[d][0] = __fsub_rn(1.0f, pc.w[d][1]);
                    }
                    float v[4][F], s[F];
                    k7_load<F>(pc, level, lv, l, 4 * kx, v);
                    k7_half<F>(pc, v, 4 * kx, s);
#pragma unroll
                    for (int f = 0; f < F; ++f) {
                        const float sum = __fadd_rn(s[f], __shfl_xor_sync(kFull, s[f], 1));
                        if (kx == 0) level_row[src * kStride + f] = sum;
                    }
                }
            }
        }
        __syncwarp();
        stage_flush(buf, kStride, out, base, valid, row, l0 * F, (l1 - l0) * F, lane);
    }
}

// K7 where the tables fit the L2 with room to spare: one thread a (sample,
// level) lookup, t = i L + l, its 8 corners read as F-wide vector loads and
// summed in k4_tree's order. Every table stays hot, and a thread a lookup
// keeps more loads in flight than a warp walking the levels.
template <int F>
__global__ void __launch_bounds__(kK7LookupThreads) hash_lookup_fwd_lookup_kernel(
    const float* __restrict__ positions, const float* __restrict__ table, float* __restrict__ out, int n,
    int num_levels, CornerLevels lv) {
    const long long t = static_cast<long long>(blockIdx.x) * kK7LookupThreads + threadIdx.x;
    if (t >= static_cast<long long>(n) * num_levels) return;
    const long long i = t / num_levels;
    const int l = static_cast<int>(t - i * num_levels);
    const float p[3] = {__ldg(positions + 3 * i), __ldg(positions + 3 * i + 1), __ldg(positions + 3 * i + 2)};
    const Corner c = corner_locate(p, lv, l);
    const float* level = table + static_cast<long long>(l) * lv.size * F;
    float v0[4][F], v1[4][F], lo[F], hi[F];
    k7_load<F>(c, level, lv, l, 0, v0);
    k7_load<F>(c, level, lv, l, 4, v1);
    k7_half<F>(c, v0, 0, lo);
    k7_half<F>(c, v1, 4, hi);
#pragma unroll
    for (int f = 0; f < F; ++f) out[t * F + f] = __fadd_rn(lo[f], hi[f]);
}

// -- K8 -------------------------------------------------------------------------

constexpr int kK8Lookups = 256;                      // a tile: one level's lookups of 256 consecutive samples
constexpr int kK8Threads = kK8Lookups;               // a thread a sample
constexpr int kK8Warps = kK8Threads / 32;
constexpr int kK8Pairs = 8 * kK8Lookups;             // a tile-level's (lookup, corner) pairs
constexpr int kK8Items = kK8Pairs / kK8Threads;      // sorted items a thread sums, and sort rounds a warp
constexpr int kK8DigitBits = 10;                     // the widest digit of the tile's sort
constexpr int kK8Radix = 1 << kK8DigitBits;
constexpr int kK8DigitsAThread = kK8Radix / kK8Threads;
constexpr int kK8Parts = kRadix * kMaxPasses;        // where the partials' count sits among the digit totals
static_assert(kK8Threads == kSortThreads && kK8Threads == kRadix, "block_exclusive_scan's block; a thread a digit");
// A block writes its levels' partials one after the other, from the start of
// its range of (L + 1) / 2 windows of kSortTile partials (two levels' pairs a
// window); a window is a tile of the global sort's first pass.
static_assert(2 * kK8Pairs == kSortTile, "a window holds two levels' pairs");

// The tile stage's dynamic shared memory, byte offsets. With pairs: the
// items' slots and sums (where the items were written) and their ids (two
// buffers, the sort's), the sort's counters (16 bits: a warp ranks at most
// 256 items) and digit starts, pass 0's histogram of each of the block's
// windows, the threads' run partials; always: the block scan's and the
// position gradient's butterfly (half a sample's padded levels, 3 floats
// each).
struct K8Layout {
    int keys, ids, vals, counters, digits, hist, head, tail, flags, scan, acc, bytes;
};

__host__ __device__ inline int k8_take(int& off, int bytes) {
    const int at = off;
    off += (bytes + 15) & ~15;
    return at;
}

__host__ __device__ inline K8Layout k8_layout(int features, bool pairs, int half, int windows) {
    K8Layout k = {};
    int off = 0;
    if (pairs) {
        k.keys = k8_take(off, kK8Pairs * 4);
        k.ids = k8_take(off, 2 * kK8Pairs * 2);
        k.vals = k8_take(off, kK8Pairs * features * 4);
        k.counters = k8_take(off, kK8Warps * kK8Radix * 2);
        k.digits = k8_take(off, kK8Radix * 2);
        k.hist = k8_take(off, windows * kRadix * 4);
        k.head = k8_take(off, features * kK8Threads * 4);
        k.tail = k8_take(off, features * kK8Threads * 4);
        k.flags = k8_take(off, kK8Threads * 4);
    }
    k.scan = k8_take(off, (kSortWarps + 1) * 4);
    k.acc = k8_take(off, half * 3 * kK8Threads * 4);
    k.bytes = off;
    return k;
}

#ifdef __CUDACC__
// The tile stage's dynamic shared memory (the host test harness stands in).
__device__ __forceinline__ char* k8_shared() {
    extern __shared__ float4 k8_smem[];
    return reinterpret_cast<char*>(k8_smem);
}
#endif

struct K8Args {
    const float* positions;   // (n, 3)
    const float* table;       // (L, T, F)
    const float* g_out;       // (n, L F)
    float* g_pos;             // (n, 3), or null
    unsigned* part_keys;      // windows x kSortTile: a block's partials' keys, from its range's start
    float* part_vals;         // windows x kSortTile x F: their sums
    unsigned* window_count;   // partials a window
    unsigned* counts;         // [digit][window]: the sort's first histograms
    unsigned* totals;         // the sort's digit totals, zeroed, and at kK8Parts the partials in all
    int n, num_levels;
    int block_windows;        // windows a block: (L + 1) / 2
    int windows;              // windows in all
    int slots;                // a sample's levels padded to a power of two
    int slot_bits;            // bits of a slot: ceil(log2 T)
};

// The 8 entries a lookup at level l reads, all in flight at once.
template <int F>
__device__ __forceinline__ void corner_entries(const Corner& c, const float* level, const CornerLevels& lv, int l,
                                               float (&v)[8][F]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) load_entry<F>(level + static_cast<long long>(corner_slot(c, lv, l, k)) * F, v[k]);
}

// Level l's term of a lookup's position gradient from its entries v, with g
// its g_out: res_l sum_k dw_k/dfrac <entry_k, g>, in the same operations and
// order as ever.
template <int F>
__device__ __forceinline__ void corner_pos_grad(const Corner& c, const float (&v)[8][F], float res,
                                                const float (&g)[F], float (&grad)[3]) {
    grad[0] = grad[1] = grad[2] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float dot = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) dot = __fadd_rn(dot, __fmul_rn(v[k][f], g[f]));
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
    for (int d = 0; d < 3; ++d) grad[d] = __fmul_rn(res, grad[d]);
}

// One stable pass of the tile's sort in shared memory: the `count` item ids
// from iin to iout by the digit (keys[id] >> shift) & (radix - 1), radix a
// power of two from 256 to kK8Radix. Warp w ranks items [256 w, 256 w +
// 256), 32 a round, among its equal digits by __match_any_sync (K5's
// scatter); rounds past the count are skipped. Every thread calls it.
__device__ __forceinline__ void k8_sort_pass(const unsigned* keys, const unsigned short* iin, unsigned short* iout,
                                             int count, int shift, int radix, unsigned short* counters,
                                             unsigned short* digit_start, unsigned* scan_smem) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const unsigned mask = static_cast<unsigned>(radix - 1);
    for (int e = t; e < kK8Warps * radix / 2; e += kK8Threads) reinterpret_cast<unsigned*>(counters)[e] = 0u;
    __syncthreads();
    unsigned short* mine = counters + warp * radix;
    const int warp0 = warp * (32 * kK8Items);
    const unsigned below_mask = (1u << lane) - 1u;
    // every round's peers first (their latency overlaps), then the warp's
    // running counts round by round
    unsigned digit[kK8Items], rank[kK8Items];
    unsigned short id[kK8Items];
#pragma unroll
    for (int r = 0; r < kK8Items; ++r) {
        const int j = warp0 + r * 32 + lane;
        const bool valid = j < count;
        id[r] = valid ? iin[j] : 0;
        digit[r] = valid ? (keys[id[r]] >> shift) & mask : kK8Radix;
        rank[r] = warp0 + r * 32 < count ? __match_any_sync(kFull, digit[r]) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kK8Items; ++r) {
        if (warp0 + r * 32 >= count) break;  // the whole warp: rounds past the count
        const bool valid = warp0 + r * 32 + lane < count;
        const unsigned peers = rank[r];
        const unsigned base = valid ? mine[digit[r]] : 0u;
        __syncwarp();
        if (valid && __popc(peers & below_mask) == 0)
            mine[digit[r]] = static_cast<unsigned short>(base + __popc(peers));
        __syncwarp();
        rank[r] = base + __popc(peers & below_mask);
    }
    __syncthreads();
    // digits `per` t ..: each warp's offset among the digit's items, then the
    // digits' first places in the sorted order
    const int per = radix / kK8Threads;
    unsigned total[kK8DigitsAThread], run = 0u;
#pragma unroll
    for (int q = 0; q < kK8DigitsAThread; ++q) {
        total[q] = 0u;
        if (q >= per) continue;
        const int d = per * t + q;
#pragma unroll
        for (int w = 0; w < kK8Warps; ++w) {
            const unsigned c = counters[w * radix + d];
            counters[w * radix + d] = static_cast<unsigned short>(total[q]);
            total[q] += c;
        }
        run += total[q];
    }
    unsigned all;
    unsigned start = block_exclusive_scan(run, scan_smem, &all);
#pragma unroll
    for (int q = 0; q < kK8DigitsAThread; ++q) {
        if (q < per) digit_start[per * t + q] = static_cast<unsigned short>(start);
        start += total[q];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kK8Items; ++r) {
        if (warp0 + r * 32 + lane < count)
            iout[digit_start[digit[r]] + mine[digit[r]] + rank[r]] = id[r];
    }
    __syncthreads();
}

// One level of a tile (see the note at the top). Every thread of the block
// calls it with its own lookup's corner and g_out, and `done`, the block's
// partials so far. The warp first sums each
// run of equal cells among its consecutive lookups corner by corner (a
// segmented scan of shuffles), so that a run gives 8 items, not 8 pairs a
// lookup; the block's items, in lookup order, are then sorted by slot and
// each slot's sum written as the block's next partial, counted in its
// window's pass-0 histogram. Returns the level's partials.
template <int F>
__device__ __forceinline__ unsigned k8_tile_level(const K8Args& a, const CornerLevels& lv, const K8Layout& k,
                                                  char* smem, const Corner& c, const float (&go)[F], int l,
                                                  unsigned done) {
    unsigned* keys = reinterpret_cast<unsigned*>(smem + k.keys);
    unsigned short* ids = reinterpret_cast<unsigned short*>(smem + k.ids);
    float* vals = reinterpret_cast<float*>(smem + k.vals);
    unsigned* hist = reinterpret_cast<unsigned*>(smem + k.hist);
    float* head = reinterpret_cast<float*>(smem + k.head);
    float* tail = reinterpret_cast<float*>(smem + k.tail);
    unsigned* flags = reinterpret_cast<unsigned*>(smem + k.flags);
    unsigned* scan_smem = reinterpret_cast<unsigned*>(smem + k.scan);
    const int t = threadIdx.x, lane = t & 31;
    const long long first = static_cast<long long>(blockIdx.x) * kK8Lookups;
    const int lookups = a.n - first < kK8Lookups ? static_cast<int>(a.n - first) : kK8Lookups;
    const bool live = t < lookups;

    // the warp's runs of equal cells, in lane order (a lookup past n starts
    // one of its own and gives no item)
    const unsigned px = __shfl_up_sync(kFull, c.base[0], 1);
    const unsigned py = __shfl_up_sync(kFull, c.base[1], 1);
    const unsigned pz = __shfl_up_sync(kFull, c.base[2], 1);
    const bool prev_live = __shfl_up_sync(kFull, live ? 1 : 0, 1) != 0;
    const unsigned starts = __ballot_sync(
        kFull, lane == 0 || px != c.base[0] || py != c.base[1] || pz != c.base[2] || live != prev_live);
    const unsigned ends = ((starts >> 1) | (1u << 31)) & __ballot_sync(kFull, live);
    float v[8][F];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        const float w = corner_w(c, q);
#pragma unroll
        for (int f = 0; f < F; ++f) v[q][f] = __fmul_rn(w, go[f]);
    }
    if (starts != kFull) {
        // segmented inclusive scan: lane j adds lane j - off where both lie
        // in the run that begins at lane `run_head`
        const int run_head = 31 - __clz(starts & ((2u << lane) - 1u));
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
#pragma unroll
                for (int f = 0; f < F; ++f) {
                    const float o = __shfl_up_sync(kFull, v[q][f], off);
                    if (lane - off >= run_head) v[q][f] = __fadd_rn(o, v[q][f]);
                }
            }
        }
    }
    // each run's last lane writes its 8 items: after the block's earlier
    // warps' items, then the warp's earlier runs'
    const int mine = 8 * __popc(ends);
    unsigned items;
    const unsigned warp_base = block_exclusive_scan(lane == 0 ? mine : 0u, scan_smem, &items);
    const unsigned base = __shfl_sync(kFull, warp_base, 0);
    if ((ends >> lane) & 1u) {
        const int at = static_cast<int>(base) + 8 * __popc(ends & ((1u << lane) - 1u));
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            keys[at + q] = corner_slot(c, lv, l, q);
            ids[at + q] = static_cast<unsigned short>(at + q);
#pragma unroll
            for (int f = 0; f < F; ++f) vals[(at + q) * F + f] = v[q][f];
        }
    }
    __syncthreads();
    const int count = static_cast<int>(items);
    int in = 0;
    if (a.slot_bits > 0) {
        const int passes = (a.slot_bits + kK8DigitBits - 1) / kK8DigitBits;
        const int width = (a.slot_bits + passes - 1) / passes;
        const int radix = 1 << (width > kDigitBits ? width : kDigitBits);  // 256 at the least: a thread a digit
        for (int shift = 0; shift < a.slot_bits; shift += width, in ^= 1)
            k8_sort_pass(keys, ids + in * kK8Pairs, ids + (in ^ 1) * kK8Pairs, count, shift, radix,
                         reinterpret_cast<unsigned short*>(smem + k.counters),
                         reinterpret_cast<unsigned short*>(smem + k.digits), scan_smem);
    }
    const unsigned short* si = ids + in * kK8Pairs;

    // thread t sums sorted items [8 t, 8 t + 8) in turn; the runs of equal
    // slots are numbered in order across the block
    const int i0 = kK8Items * t;
    const int here = count - i0 < 0 ? 0 : count - i0 < kK8Items ? count - i0 : kK8Items;
    unsigned key[kK8Items];
    unsigned short id[kK8Items];
    unsigned slot_starts = 0u;
    unsigned prev = i0 > 0 && here > 0 ? keys[si[i0 - 1]] : kNoKey;
#pragma unroll
    for (int m = 0; m < kK8Items; ++m) {
        id[m] = m < here ? si[i0 + m] : 0;
        key[m] = m < here ? keys[id[m]] : kNoKey;
        if (m < here && key[m] != prev) slot_starts |= 1u << m;
        prev = key[m];
    }
    unsigned runs;
    const unsigned run0 = block_exclusive_scan(__popc(slot_starts), scan_smem, &runs);
    const long long range = static_cast<long long>(blockIdx.x) * a.block_windows * kSortTile;
    const unsigned key0 = static_cast<unsigned>(l) * lv.size;
    auto emit = [&](unsigned run, unsigned slot, const float (&s)[F]) {
        const unsigned p = done + run;  // the block's partial p: window p / kSortTile
        a.part_keys[range + p] = key0 + slot;
#pragma unroll
        for (int f = 0; f < F; ++f) a.part_vals[(range + p) * F + f] = s[f];
        atomicAdd(&hist[(p / kSortTile) * kRadix + ((key0 + slot) & (kRadix - 1))], 1u);
    };
    // `open`: the chunk began inside an earlier thread's run, still summing it
    bool open = here > 0 && !(slot_starts & 1u);
    unsigned run = run0 - 1u;  // the run being summed
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int m = 0; m < kK8Items; ++m) {
        if (m >= here) break;
        if ((slot_starts >> m) & 1u) {
            if (m > 0) {  // the run that ended at m - 1
                if (open) {
#pragma unroll
                    for (int f = 0; f < F; ++f) head[t * F + f] = acc[f];
                    open = false;
                } else {
                    emit(run, key[m - 1], acc);
                }
            }
            ++run;
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = 0.0f;
        }
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], vals[id[m] * F + f]);
    }
    // flags bit 0: the run that came into the chunk ends in it; bit 1: the
    // chunk's last run goes on into the next chunk (its sum so far in tail)
    unsigned flag = slot_starts ? 1u : 0u;
    if (here > 0) {
        const bool continues = i0 + here < count && keys[si[i0 + here]] == key[here - 1];
        if (open) {
#pragma unroll
            for (int f = 0; f < F; ++f) head[t * F + f] = acc[f];
            if (!continues) flag = 1u;
        } else if (continues) {
#pragma unroll
            for (int f = 0; f < F; ++f) tail[t * F + f] = acc[f];
            flag |= 2u;
        } else {
            emit(run, key[here - 1], acc);
        }
    }
    flags[t] = flag;
    __syncthreads();
    if (flag & 2u) {  // the run that starts here and goes on: its chunks in order
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = tail[t * F + f];
        for (int u = t + 1; u < kK8Threads; ++u) {
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], head[u * F + f]);
            if (flags[u] & 1u) break;
        }
        emit(run, key[here - 1], acc);
    }
    __syncthreads();  // the shared memory is the next level's
    return runs;
}

// K8's tile stage (kPairs) or, without a table gradient, its position
// gradient alone: a block a tile of 256 samples, a thread a sample, walking
// the levels and the padded ones (whose term is 0).
template <int F, bool kPairs>
__global__ void __launch_bounds__(kK8Threads) hash_lookup_bwd_tile_kernel(K8Args a, CornerLevels lv) {
    char* smem = k8_shared();
    const int half = a.slots / 2;
    const K8Layout k = k8_layout(F, kPairs, half, a.block_windows);
    float* acc = reinterpret_cast<float*>(smem + k.acc);  // [half][3][thread]
    const int t = threadIdx.x;
    if constexpr (kPairs) {
        unsigned* hist = reinterpret_cast<unsigned*>(smem + k.hist);
        for (int e = t; e < a.block_windows * kRadix; e += kK8Threads) hist[e] = 0u;
    }
    const long long i = static_cast<long long>(blockIdx.x) * kK8Lookups + t;
    const bool sample = i < a.n;
    float p[3] = {0.0f, 0.0f, 0.0f};
    if (sample) {
#pragma unroll
        for (int d = 0; d < 3; ++d) p[d] = a.positions[3 * i + d];
    }
    float gpos[3] = {0.0f, 0.0f, 0.0f};
    unsigned parts = 0u;
    // the next level's cell and entries load while this level is summed
    const bool reads = a.g_pos != nullptr && sample;
    Corner c = corner_locate(p, lv, 0);
    float v[8][F];
    if (reads) corner_entries<F>(c, a.table, lv, 0, v);
    for (int l = 0; l < a.slots; ++l) {
        float grad[3] = {0.0f, 0.0f, 0.0f};
        if (l < a.num_levels) {
            float go[F];
#pragma unroll
            for (int f = 0; f < F; ++f) go[f] = sample ? a.g_out[(i * a.num_levels + l) * F + f] : 0.0f;
            Corner next = c;
            float v_next[8][F];
            if (l + 1 < a.num_levels) {
                next = corner_locate(p, lv, l + 1);
                if (reads) corner_entries<F>(next, a.table + static_cast<long long>(l + 1) * lv.size * F, lv, l + 1,
                                             v_next);
            }
            if (reads) corner_pos_grad<F>(c, v, lv.res[l], go, grad);
            if constexpr (kPairs) parts += k8_tile_level<F>(a, lv, k, smem, c, go, l, parts);
            c = next;
            if (reads && l + 1 < a.num_levels) {
#pragma unroll
                for (int q = 0; q < 8; ++q) {
#pragma unroll
                    for (int f = 0; f < F; ++f) v[q][f] = v_next[q][f];
                }
            }
        }
        // the butterfly over the padded levels, its first step level by
        // level: lane q < half took lane q + half's term
        if (a.g_pos != nullptr) {
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                if (half == 0) {
                    gpos[d] = grad[d];
                } else {
                    float* slot = acc + ((l % half) * 3 + d) * kK8Threads + t;
                    *slot = l < half ? grad[d] : __fadd_rn(*slot, grad[d]);
                }
            }
        }
    }
    if (a.g_pos != nullptr) {
        for (int off = half / 2; off > 0; off >>= 1) {
            for (int q = 0; q < off; ++q) {
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    acc[(q * 3 + d) * kK8Threads + t] =
                        __fadd_rn(acc[(q * 3 + d) * kK8Threads + t], acc[((q + off) * 3 + d) * kK8Threads + t]);
            }
        }
        if (half > 0) {
#pragma unroll
            for (int d = 0; d < 3; ++d) gpos[d] = acc[d * kK8Threads + t];
        }
        if (sample) {
#pragma unroll
            for (int d = 0; d < 3; ++d) a.g_pos[3 * i + d] = gpos[d];
        }
    }
    if constexpr (kPairs) {
        // each window's histogram and count (a thread a digit), the digit
        // totals, and the block's partials into the count of all
        const unsigned* hist = reinterpret_cast<const unsigned*>(smem + k.hist);
        unsigned total = 0u;
        for (int w = 0; w < a.block_windows; ++w) {
            const long long window = static_cast<long long>(blockIdx.x) * a.block_windows + w;
            const unsigned c = hist[w * kRadix + t];
            a.counts[t * static_cast<long long>(a.windows) + window] = c;
            total += c;
            if (t == 0) {
                const long long left = static_cast<long long>(parts) - static_cast<long long>(w) * kSortTile;
                a.window_count[window] = static_cast<unsigned>(left < 0 ? 0 : left < kSortTile ? left : kSortTile);
            }
        }
        unsigned* totals = a.totals;
        if (total) atomicAdd(&totals[t], total);
        if (t == 0) atomicAdd(&totals[kK8Parts], parts);
    }
}

// K8's partial sums: the sorted partial `id` adds its F sums to its entry's
// gradient (key l T + slot).
template <int F>
struct PartialSum {
    static constexpr int V = F;
    const float* vals;
    float* g_table;

    __device__ __forceinline__ int values(unsigned id, float (&v)[V]) const {
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = vals[static_cast<long long>(id) * F + f];
        return 0;
    }
    __device__ __forceinline__ int level(unsigned) const { return 0; }
    __device__ __forceinline__ float* dst(unsigned key, int) const {
        return g_table + static_cast<long long>(key) * F;
    }
};

// K8, stage 3: K5's segmented sum over the sorted partials, their count on
// the device.
template <int F>
__global__ void __launch_bounds__(kThreads) hash_lookup_bwd_reduce_kernel(
    const unsigned* __restrict__ skeys, const unsigned* __restrict__ sids, const float* __restrict__ vals,
    float* __restrict__ g_table, float* __restrict__ head, float* __restrict__ tail, unsigned* __restrict__ tail_key,
    const unsigned* __restrict__ num_parts) {
    segmented_sum(skeys, sids, head, tail, tail_key, static_cast<long long>(*num_parts),
                  PartialSum<F>{vals, g_table});
}

// K8, stage 4: as K5's.
template <int F>
__global__ void __launch_bounds__(kThreads) hash_lookup_bwd_fixup_kernel(
    const unsigned* __restrict__ skeys, const float* __restrict__ head, const float* __restrict__ tail,
    const unsigned* __restrict__ tail_key, const unsigned* __restrict__ num_parts, float* __restrict__ g_table) {
    const long long chunks = (static_cast<long long>(*num_parts) + kChunk - 1) / kChunk;
    segmented_sum_fixup(skeys, head, tail, tail_key, chunks, PartialSum<F>{nullptr, g_table});
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
    if (static_cast<long long>(num_levels) * lv.size * F * 4 > kK7WalkBytes) {
        const int blocks = static_cast<int>((static_cast<long long>(n) + kK7Threads - 1) / kK7Threads);
        hash_lookup_fwd_walk_kernel<F><<<blocks, kK7Threads, 0, st>>>(positions, table, out, n, num_levels, lv);
    } else {
        const long long threads = static_cast<long long>(n) * num_levels;
        const int blocks = static_cast<int>((threads + kK7LookupThreads - 1) / kK7LookupThreads);
        hash_lookup_fwd_lookup_kernel<F><<<blocks, kK7LookupThreads, 0, st>>>(positions, table, out, n, num_levels,
                                                                              lv);
    }
    return cudaGetLastError();
}

// K8's scratch regions, each 256-byte aligned, carved from one buffer: the
// blocks' partials (keys in keys[0], the sort's first input), the sort's
// other buffers, the histograms, the digit totals with the partials' count
// after them, the windows' counts and the segmented sum's chunk partials.
struct K8Scratch {
    unsigned* keys[2];
    unsigned* ids[2];
    float* vals;
    unsigned* counts;
    unsigned* totals;
    unsigned* num_parts;
    unsigned* window_count;
    float* head;
    float* tail;
    unsigned* tail_key;
};

constexpr int kK8Zeroed = kK8Parts + 1;  // the digit totals and the partials' count

// Windows of kSortTile partials: (L + 1) / 2 a tile of kK8Lookups samples.
long long k8_windows(long long n, int num_levels) {
    return (n + kK8Lookups - 1) / kK8Lookups * ((num_levels + 1) / 2);
}

long long carve_k8(char* base, long long windows, int features, K8Scratch* s) {
    long long off = 0;
    auto take = [&](long long bytes) {
        char* p = base == nullptr ? nullptr : base + off;
        off += (bytes + 255) & ~255LL;
        return p;
    };
    const long long cap = windows * kSortTile;  // room for every pair a partial: the most there can be
    const long long chunks = (cap + kChunk - 1) / kChunk;
    for (int k = 0; k < 2; ++k) s->keys[k] = reinterpret_cast<unsigned*>(take(4 * cap));
    for (int k = 0; k < 2; ++k) s->ids[k] = reinterpret_cast<unsigned*>(take(4 * cap));
    s->vals = reinterpret_cast<float*>(take(4 * features * cap));
    s->counts = reinterpret_cast<unsigned*>(take(4LL * kRadix * windows));
    s->totals = reinterpret_cast<unsigned*>(take(4LL * kK8Zeroed));
    s->num_parts = s->totals == nullptr ? nullptr : s->totals + kK8Parts;
    s->window_count = reinterpret_cast<unsigned*>(take(4 * windows));
    s->head = reinterpret_cast<float*>(take(4LL * features * chunks));
    s->tail = reinterpret_cast<float*>(take(4LL * features * chunks));
    s->tail_key = reinterpret_cast<unsigned*>(take(4 * chunks));
    return off;
}

// Every stage of K8, or the tile stage alone without pairs where g_table is
// null (scratch may then be null).
template <int F>
cudaError_t launch_corner_bwd(const float* positions, const float* table, const float* g_out, float* g_table,
                              float* g_pos, char* scratch, int n, int num_levels, const CornerLevels& lv,
                              cudaStream_t st) {
    const int tiles = (n + kK8Lookups - 1) / kK8Lookups;
    K8Args a = {};
    a.positions = positions;
    a.table = table;
    a.g_out = g_out;
    a.g_pos = g_pos;
    a.n = n;
    a.num_levels = num_levels;
    a.block_windows = (num_levels + 1) / 2;
    a.windows = tiles * a.block_windows;
    a.slots = 1 << ceil_log2(num_levels);
    a.slot_bits = ceil_log2(lv.size);
    const bool pairs = g_table != nullptr;
    const int bytes = k8_layout(F, pairs, a.slots / 2, a.block_windows).bytes;
    auto tile_kernel = pairs ? hash_lookup_bwd_tile_kernel<F, true> : hash_lookup_bwd_tile_kernel<F, false>;
    cudaError_t err = cudaFuncSetAttribute(tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (!pairs) {
        tile_kernel<<<tiles, kK8Threads, bytes, st>>>(a, lv);
        return cudaGetLastError();
    }
    K8Scratch s;
    carve_k8(scratch, a.windows, F, &s);
    a.part_keys = s.keys[0];
    a.part_vals = s.vals;
    a.window_count = s.window_count;
    a.counts = s.counts;
    a.totals = s.totals;
    err = cudaMemsetAsync(s.totals, 0, 4 * kK8Zeroed, st);
    if (err != cudaSuccess) return err;
    tile_kernel<<<tiles, kK8Threads, bytes, st>>>(a, lv);
    // the stable sort of the partials: pass 0 over the windows, with the
    // tile stage's histograms; the later passes over the dense partials
    const int bits = ceil_log2(static_cast<long long>(num_levels) * lv.size);
    const int passes = bits > kDigitBits ? (bits + kDigitBits - 1) / kDigitBits : 1;
    cell_lookup_bwd_scan_kernel<<<kRadix, kSortThreads, 0, st>>>(s.counts, s.totals, a.windows);
    cell_lookup_bwd_scatter_kernel<true><<<a.windows, kSortThreads, 0, st>>>(
        s.keys[0], nullptr, s.keys[1], s.ids[1], s.counts, 0, a.windows, 0, nullptr, s.window_count, kSortTile);
    const long long cap = static_cast<long long>(a.windows) * kSortTile;
    const int sort_tiles = a.windows;
    for (int p = 1; p < passes; ++p) {
        const unsigned* kin = s.keys[p & 1];
        const unsigned* iin = s.ids[p & 1];
        unsigned* totals = s.totals + p * kRadix;
        const int shift = p * kDigitBits;
        cell_lookup_bwd_hist_kernel<<<sort_tiles, kSortThreads, 0, st>>>(kin, s.counts, totals, 0, sort_tiles,
                                                                          shift, s.num_parts);
        cell_lookup_bwd_scan_kernel<<<kRadix, kSortThreads, 0, st>>>(s.counts, totals, sort_tiles);
        cell_lookup_bwd_scatter_kernel<false><<<sort_tiles, kSortThreads, 0, st>>>(
            kin, iin, s.keys[(p + 1) & 1], s.ids[(p + 1) & 1], s.counts, 0, sort_tiles, shift, s.num_parts, nullptr,
            kSortTile);
    }
    const unsigned* skeys = s.keys[passes & 1];
    const unsigned* sids = s.ids[passes & 1];
    const long long chunks = (cap + kChunk - 1) / kChunk;
    const int blocks = static_cast<int>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    hash_lookup_bwd_reduce_kernel<F><<<blocks, kThreads, 0, st>>>(skeys, sids, s.vals, g_table, s.head, s.tail,
                                                                  s.tail_key, s.num_parts);
    hash_lookup_bwd_fixup_kernel<F><<<blocks, kThreads, 0, st>>>(skeys, s.head, s.tail, s.tail_key, s.num_parts,
                                                                 g_table);
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
// needs a gradient: one launch of cell_lookup_bwd_pos_kernel (no keys,
// zero-fill, sort or reduction; scratch may be null), and g_pos equals the
// full backward's bit for bit.
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
    case f: err = launch_pos<f>(positions, g_out, g_pos, n, num_levels, lv, st); break;
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
// keep their input order), on keys of the caller's choosing; no wrapper of
// the package calls it (the splat path's packed-row backward sorts by row
// in csrc/packed_rows.cu). Scratch of radix_sort_u32_scratch_bytes bytes,
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
// contiguous; out (n, L * F) contiguous, 16-byte aligned. resolutions a host
// array of L ints; dense_mask bit l: level l indexes densely ((res_l + 1)^3 <=
// T in float32, as the JAX package decides). features is F in {1, 2, 4, 8};
// n * L < 2^31, L T <= 2^31. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int hash_lookup_fwd_f32(const float* positions, const float* table, float* out, int n, int num_levels,
                                   int table_size, int features, const int* resolutions, unsigned dense_mask,
                                   void* stream) {
    CornerLevels lv;
    if (!corner_levels(resolutions, num_levels, table_size, dense_mask, &lv) || n < 0 ||
        static_cast<long long>(n) * num_levels >= (1LL << 31) || reinterpret_cast<unsigned long long>(table) % 16 ||
        reinterpret_cast<unsigned long long>(out) % 16)
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

// Bytes of scratch K8 needs for n samples (room for a partial per (lookup,
// corner) pair, 256 samples a tile: its keys, the sort's keys and ids, the
// partials' sums, the histograms and the chunks' partial sums), or -1 for
// arguments it does not take (the pairs of the tiles reach 2^31).
extern "C" long long hash_lookup_bwd_scratch_bytes(int n, int num_levels, int features) {
    if (n < 0 || num_levels < 1 || num_levels > kMaxLevels || features < 1) return -1;
    const long long windows = k8_windows(n, num_levels);
    if (windows * kSortTile >= (1LL << 31)) return -1;
    K8Scratch s;
    return carve_k8(nullptr, windows, features, &s);
}

// K8, as hash_lookup_fwd_f32, with g_out (n, L * F) contiguous; g_table (L,
// T, F) zero-filled by the caller, 16-byte aligned, or null (then only the
// position gradient is computed, no pair is formed and scratch may be null);
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
        reinterpret_cast<unsigned long long>(table) % 16 || reinterpret_cast<unsigned long long>(g_table) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    if (g_table != nullptr) {
        const long long windows = k8_windows(n, num_levels);
        K8Scratch s;
        if (windows * kSortTile >= (1LL << 31) || carve_k8(nullptr, windows, features, &s) > scratch_bytes ||
            scratch == nullptr)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    char* sc = static_cast<char*>(scratch);
    cudaError_t err;
#define K8_CASE(f)                                                                                     \
    case f:                                                                                            \
        err = launch_corner_bwd<f>(positions, table, g_out, g_table, g_pos, sc, n, num_levels, lv, st); \
        break;
    switch (features) {
        K8_CASE(1) K8_CASE(2) K8_CASE(4) K8_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K8_CASE
    return static_cast<int>(err);
}
