// Backward of the splat path's packed-row gather, for Hopper (sm_90a).
//
// uncertainty_nerf_gs_torch/ops/rasterize.py::select_and_pack gathers the
// depth-sorted Gaussians' rows into one (T, K, D) buffer, D = 6 + C:
//   packed[t, k, :] = src[idx[t, k], :]
// with src (n + 1, D) and row n the pad row that fills every slot past a
// tile's count. This file is its backward,
//   g_src[r, :] = sum over the live slots (t, k < counts[t]) with
//                 idx[t, k] == r of g_packed[t, k, :],
// added in ascending slot order t * K + k, with g_src[n, :] = 0. It is not a
// TPU kernel: the JAX package gets this function from XLA as the transpose
// of a gather. It replaces the scatter of F.embedding's backward, which
// walked all T x K indices, pad slots included, and added with float
// atomics in an order that changed from launch to launch.
//
// What bounds it on an H100: bytes. The function reads each live slot's D
// floats once and writes the n + 1 rows of g_src once; it does no float
// work beyond one add an element. Beyond the bytes, two things: the order
// of each row's adds is fixed (ascending slot), and the number of live
// slots exists only on the device. Every buffer is sized from T, K and n,
// nothing is read back to the host, and a call is five launches (a memset
// and four kernels), so that a training step that runs it can be captured
// in a CUDA graph. It is a counting sort of the live slots by row:
//   0. one memset zeroes the rows' counts and the scan's block ticket and
//      block states.
//   1. count: a block a tile walks its first counts[t] slots; each live slot
//      adds one to its row's count by an integer atomic and keeps what the
//      atomic returns, its place in the row's run (the counts do not depend
//      on the order; the places do, and step 4 orders them).
//   2. scan: one pass over the n + 1 counts with decoupled look-back (each
//      block takes a ticket, publishes its total, and its first warp reads
//      32 predecessors' states at a time, adding totals back to the nearest
//      one that carries its inclusive prefix) gives start[r], row r's first
//      place among the live slots, and start[n + 1], their number.
//   3. place: each live slot writes its slot number t K + k at start[r] plus
//      its place; no atomic.
//   4. order and sum: _compact (ops/rasterize.py) keeps each tile's live
//      ids in ascending order, so a row lies at most once in a tile and its
//      run is at most T long, and ascending slot order is ascending tile
//      order. A thread takes a row whose run is at most 32 long: it sorts
//      the slots in registers by a bitonic network (8 wide up to 8 slots,
//      32 wide above) and adds the rows in order, loading a group of rows
//      (each 48-byte row at D = 12 as three float4s) before adding any. A
//      longer run goes to a warp: a bitmap of the run's tiles in shared
//      memory ranks its slots (a slot's rank is the number of the run's
//      tiles before its own) into `sorted`; the warp copies up to 128 ranked
//      rows at a time into shared memory and lane c adds column c from left
//      to right. Every add is __fadd_rn from 0.0f in ascending slot order,
//      so two launches give the same bits and ops/rasterize.py::
//      packed_rows_vjp_reference agrees bit for bit. g_src is written once
//      in full; a row no live slot names, and the pad row, get 0. No float
//      atomic.
// The wrapper (ops/rasterize.py::packed_rows_bwd) allocates g_src and the
// scratch whose size packed_rows_scratch_bytes gives; nothing is allocated
// here.

#include <cuda_runtime.h>

namespace {

constexpr int kCountThreads = 128;
constexpr int kCountItems = 4;  // slots a thread of the count and place kernels has in flight
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kSumThreads = 128;  // a thread a row, kSumThreads rows a block
constexpr int kSumMinBlocks = 1;  // resident blocks an SM asked of ptxas
constexpr int kSumWarps = kSumThreads / 32;
constexpr int kThreadRun = 32;    // the longest run a thread sorts and sums
constexpr int kMaxWidth = 32;     // D: lane c of a warp adds column c
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // past a run's end; slots lie below T K < 2^32
// a scan block's state: its total (low 32 bits) and what it covers
constexpr unsigned long long kAggregate = 1ull << 32;  // the block's own counts
constexpr unsigned long long kInclusive = 2ull << 32;  // every count up to the block's last

// Scratch regions carved from one buffer; the first three are zeroed.
struct Scratch {
    unsigned* counts;            // n + 1: the live slots a row
    unsigned* ticket;            // the scan's next block
    unsigned long long* states;  // a scan block's state
    long long zeroed;            // bytes of the three above
    unsigned* start;             // n + 2: row r's run is [start[r], start[r + 1])
    unsigned* list;              // T K: each row's run of slots, unordered
    unsigned* sorted;            // T K: a slot's place in its run (steps 1-3), then a long run in slot order
};

long long scan_blocks(int num_rows) { return (static_cast<long long>(num_rows) + 2 + kScanTile - 1) / kScanTile; }

long long carve(char* base, int num_tiles, int capacity, int num_rows, Scratch* s) {
    long long off = 0;
    auto take = [&](long long bytes, long long align) {
        off = (off + align - 1) / align * align;
        char* p = base == nullptr ? nullptr : base + off;
        off += bytes;
        return p;
    };
    const long long slots = static_cast<long long>(num_tiles) * capacity;
    s->counts = reinterpret_cast<unsigned*>(take(4LL * (num_rows + 1), 256));
    s->ticket = reinterpret_cast<unsigned*>(take(4, 8));
    s->states = reinterpret_cast<unsigned long long*>(take(8 * scan_blocks(num_rows), 8));
    s->zeroed = off;
    s->start = reinterpret_cast<unsigned*>(take(4LL * (num_rows + 2), 256));
    s->list = reinterpret_cast<unsigned*>(take(4 * slots, 256));
    s->sorted = reinterpret_cast<unsigned*>(take(4 * slots, 256));
    return (off + 255) / 256 * 256;
}

// 1. One block a tile: each live slot adds one to its row's count and keeps
// its place in the row's run, place[t K + k].
__global__ void __launch_bounds__(kCountThreads) packed_rows_count_kernel(
    const long long* __restrict__ idx, const int* __restrict__ counts, unsigned* __restrict__ row_counts,
    unsigned* __restrict__ place, int capacity, long long idx_stride, int num_rows) {
    const int t = blockIdx.x;
    const int live = min(counts[t], capacity);
    const long long* ids = idx + t * idx_stride;
    unsigned* places = place + static_cast<long long>(t) * capacity;
    for (int k0 = threadIdx.x; k0 < live; k0 += kCountThreads * kCountItems) {
        long long r[kCountItems];
#pragma unroll
        for (int u = 0; u < kCountItems; ++u) {
            const int k = k0 + u * kCountThreads;
            r[u] = k < live ? ids[k] : -1;
        }
#pragma unroll
        for (int u = 0; u < kCountItems; ++u)
            if (r[u] >= 0 && r[u] < num_rows) places[k0 + u * kCountThreads] = atomicAdd(&row_counts[r[u]], 1u);
    }
}

// Exclusive scan of one unsigned a thread over the block; integer sums, so
// any order gives the same result. Every thread of the block calls it.
__device__ __forceinline__ unsigned block_exclusive_scan(unsigned v, unsigned* smem, unsigned* total) {
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
        const unsigned s = lane < kScanWarps ? smem[lane] : 0u;
        unsigned si = s;
#pragma unroll
        for (int off = 1; off < kScanWarps; off <<= 1) {
            const unsigned o = __shfl_up_sync(kFull, si, off);
            if (lane >= off) si += o;
        }
        __syncwarp();
        if (lane < kScanWarps) smem[lane] = si - s;
        if (lane == kScanWarps - 1) smem[kScanWarps] = si;
    }
    __syncthreads();
    const unsigned out = smem[warp] + incl - v;
    *total = smem[kScanWarps];
    return out;
}

__device__ __forceinline__ void store_state(unsigned long long* p, unsigned long long v) { atomicExch(p, v); }
__device__ __forceinline__ unsigned long long load_state(const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    return v;
}

// 2. start[j] = counts[0] + ... + counts[j - 1] for j in [0, n + 1]; the
// blocks take kScanTile outputs each, in the order of their tickets, so
// that a block waits only on blocks that are running or done.
__global__ void __launch_bounds__(kScanThreads) packed_rows_scan_kernel(
    const unsigned* __restrict__ row_counts, unsigned* __restrict__ start, unsigned* ticket,
    unsigned long long* states, int num_rows) {
    __shared__ unsigned smem[kScanWarps + 1];
    __shared__ unsigned s_block, s_prefix;
    if (threadIdx.x == 0) s_block = atomicAdd(ticket, 1u);
    __syncthreads();
    const unsigned b = s_block;
    const long long first = static_cast<long long>(b) * kScanTile + threadIdx.x * kScanItems;
    unsigned v[kScanItems];
    unsigned run = 0u;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        v[k] = first + k <= num_rows ? row_counts[first + k] : 0u;
        run += v[k];
    }
    unsigned total;
    const unsigned offset = block_exclusive_scan(run, smem, &total);
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        if (lane == 0) store_state(&states[b], (b == 0 ? kInclusive : kAggregate) | total);
        // look back: lane i reads the state of block b - 1 - i of the window;
        // before block 0 stands an inclusive prefix of 0
        unsigned prefix = 0u;
        for (long long j0 = static_cast<long long>(b) - 1;; j0 -= 32) {
            const long long j = j0 - lane;
            unsigned long long s = kInclusive;
            if (j >= 0) {
                do {
                    s = load_state(&states[j]);
                } while ((s >> 32) == 0);
            }
            const unsigned inclusive = __ballot_sync(kFull, (s >> 32) == (kInclusive >> 32));
            if (inclusive != 0u) {
                // the nearest inclusive state ends the look-back
                prefix += warp_sum(lane < __ffs(inclusive) ? static_cast<unsigned>(s) : 0u);
                break;
            }
            prefix += warp_sum(static_cast<unsigned>(s));
        }
        if (lane == 0) {
            if (b > 0) store_state(&states[b], kInclusive | (prefix + total));
            s_prefix = prefix;
        }
    }
    __syncthreads();
    unsigned acc = s_prefix + offset;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        if (first + k <= num_rows + 1) start[first + k] = acc;
        acc += v[k];
    }
}

// 3. One block a tile: each live slot writes its slot number at its place
// in its row's run.
__global__ void __launch_bounds__(kCountThreads) packed_rows_place_kernel(
    const long long* __restrict__ idx, const int* __restrict__ counts, const unsigned* __restrict__ start,
    const unsigned* __restrict__ place, unsigned* __restrict__ list, int capacity, long long idx_stride,
    int num_rows) {
    const int t = blockIdx.x;
    const int live = min(counts[t], capacity);
    const long long* ids = idx + t * idx_stride;
    const unsigned slot0 = static_cast<unsigned>(t) * static_cast<unsigned>(capacity);
    for (int k0 = threadIdx.x; k0 < live; k0 += kCountThreads * kCountItems) {
        long long r[kCountItems];
        unsigned at[kCountItems];
#pragma unroll
        for (int u = 0; u < kCountItems; ++u) {
            const int k = k0 + u * kCountThreads;
            r[u] = k < live ? ids[k] : -1;
            at[u] = r[u] >= 0 && r[u] < num_rows ? place[slot0 + k] : 0u;
        }
#pragma unroll
        for (int u = 0; u < kCountItems; ++u)
            if (r[u] >= 0 && r[u] < num_rows) at[u] += start[r[u]];
#pragma unroll
        for (int u = 0; u < kCountItems; ++u)
            if (r[u] >= 0 && r[u] < num_rows) list[at[u]] = slot0 + k0 + u * kCountThreads;
    }
}

#ifdef __CUDACC__
// The order-and-sum kernel's dynamic shared memory (the host test harness
// stands in).
__device__ __forceinline__ unsigned* packed_rows_shared() {
    extern __shared__ unsigned packed_rows_smem[];
    return packed_rows_smem;
}
#endif

__device__ __forceinline__ void compare_swap(unsigned& a, unsigned& b) {
    const unsigned lo = min(a, b);
    b = max(a, b);
    a = lo;
}

// Bitonic sort of N keys in registers, ascending; N a power of two.
template <int N>
__device__ __forceinline__ void bitonic_sort(unsigned (&a)[N]) {
#pragma unroll
    for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const int l = i ^ j;
                if (l > i) {
                    if ((i & k) == 0) compare_swap(a[i], a[l]);
                    else compare_swap(a[l], a[i]);
                }
            }
        }
    }
}

// A g_packed row's `width` floats into x (float4s where vec).
template <int kMaxD>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int width, bool vec, float (&x)[kMaxD]) {
    if (vec) {
#pragma unroll
        for (int q = 0; q < kMaxD / 4; ++q) {
            if (4 * q < width) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(row) + q);
                x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
            }
        }
    } else {
#pragma unroll
        for (int c = 0; c < kMaxD; ++c)
            if (c < width) x[c] = __ldg(row + c);
    }
}

// A thread's row of m <= kN slots: sorted, added in order a group of rows
// at a time (the group's loads issued before its adds), stored.
template <int kMaxD, int kN>
__device__ __forceinline__ void thread_row(long long r, unsigned begin, unsigned m, const unsigned* __restrict__ list,
                                           const float* __restrict__ g_packed, float* __restrict__ g_src, int width,
                                           bool vec) {
    constexpr int kGroup = kMaxD <= 12 ? 4 : 2;
    unsigned s[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) s[j] = j < static_cast<int>(m) ? list[begin + j] : kNone;
    bitonic_sort<kN>(s);
    float acc[kMaxD];
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int j0 = 0; j0 < kN; j0 += kGroup) {
        if (j0 >= static_cast<int>(m)) break;
        float x[kGroup][kMaxD];
#pragma unroll
        for (int u = 0; u < kGroup; ++u)
            if (j0 + u < static_cast<int>(m)) load_row<kMaxD>(g_packed + static_cast<long long>(s[j0 + u]) * width, width, vec, x[u]);
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
            if (j0 + u < static_cast<int>(m)) {
#pragma unroll
                for (int c = 0; c < kMaxD; ++c)
                    if (c < width) acc[c] = __fadd_rn(acc[c], x[u][c]);
            }
        }
    }
    float* dst = g_src + r * width;
    if (vec) {
#pragma unroll
        for (int q = 0; q < kMaxD / 4; ++q)
            if (4 * q < width)
                reinterpret_cast<float4*>(dst)[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else {
#pragma unroll
        for (int c = 0; c < kMaxD; ++c)
            if (c < width) dst[c] = acc[c];
    }
}

// 32-row chunks a warp stages at once for a long run.
template <int kMaxD>
constexpr int kWarpChunks = kMaxD <= 12 ? 4 : 1;

// A warp's row of m > kThreadRun slots. bits and pre hold `words` words,
// the stage 32 kWarpChunks rows of `width` floats; the warp may reuse
// them after.
template <int kMaxD>
__device__ __forceinline__ void warp_row(long long r, unsigned begin, unsigned m, const unsigned* __restrict__ list,
                                         unsigned* sorted, const float* __restrict__ g_packed,
                                         float* __restrict__ g_src, int width, bool vec, int capacity, int words,
                                         unsigned* bits, unsigned* pre, float* stage, int lane) {
    constexpr int kChunks = kWarpChunks<kMaxD>;
    // the run's tiles as a bitmap; a slot's rank is the count of the run's
    // tiles before its own
    for (int w = lane; w < words; w += 32) bits[w] = 0u;
    __syncwarp();
    for (unsigned j = lane; j < m; j += 32) {
        const unsigned t = list[begin + j] / static_cast<unsigned>(capacity);
        atomicOr(&bits[t >> 5], 1u << (t & 31));
    }
    __syncwarp();
    unsigned carry = 0u;
    for (int w0 = 0; w0 < words; w0 += 32) {
        const int w = w0 + lane;
        const unsigned c = w < words ? static_cast<unsigned>(__popc(bits[w])) : 0u;
        unsigned incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned o = __shfl_up_sync(kFull, incl, off);
            if (lane >= off) incl += o;
        }
        if (w < words) pre[w] = carry + incl - c;
        carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    for (unsigned j = lane; j < m; j += 32) {
        const unsigned s = list[begin + j];
        const unsigned t = s / static_cast<unsigned>(capacity);
        sorted[begin + pre[t >> 5] + __popc(bits[t >> 5] & ((1u << (t & 31)) - 1u))] = s;
    }
    __syncwarp();
    float acc = 0.0f;
    for (unsigned j0 = 0; j0 < m; j0 += 32 * kChunks) {
        unsigned s[kChunks];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            const unsigned j = j0 + 32 * u + lane;
            s[u] = j < m ? __ldcg(sorted + begin + j) : kNone;
        }
        float x[kChunks][kMaxD];
#pragma unroll
        for (int u = 0; u < kChunks; ++u)
            if (s[u] != kNone) load_row<kMaxD>(g_packed + static_cast<long long>(s[u]) * width, width, vec, x[u]);
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
            if (s[u] != kNone) {
#pragma unroll
                for (int c = 0; c < kMaxD; ++c)
                    if (c < width) stage[(32 * u + lane) * width + c] = x[u][c];
            }
        }
        __syncwarp();
        const unsigned n = m - j0 < 32u * kChunks ? m - j0 : 32u * kChunks;
        if (lane < width) {
#pragma unroll 8
            for (unsigned j = 0; j < n; ++j) acc = __fadd_rn(acc, stage[j * width + lane]);
        }
        __syncwarp();
    }
    if (lane < width) g_src[r * width + lane] = acc;
}

// 4. A thread a row with a run of at most kThreadRun slots, then the
// block's longer runs shared out among its warps. A block takes the rows
// blockIdx.x + i `blocks` apart: the long runs are the large Gaussians near
// the camera, the first rows in depth order, and so are spread over the
// blocks. The pad row's run is empty.
template <int kMaxD>
__global__ void __launch_bounds__(kSumThreads, kSumMinBlocks) packed_rows_sum_kernel(
    const unsigned* __restrict__ start, const unsigned* __restrict__ list, unsigned* sorted,
    const float* __restrict__ g_packed, float* __restrict__ g_src, int num_rows, int width, int capacity,
    int words, int vec, int blocks) {
    __shared__ unsigned queue[kSumThreads];
    __shared__ unsigned queued;
    if (threadIdx.x == 0) queued = 0u;
    __syncthreads();
    if (static_cast<long long>(threadIdx.x) * blocks + blockIdx.x <= num_rows) {
        const long long r = static_cast<long long>(threadIdx.x) * blocks + blockIdx.x;
        const unsigned begin = start[r], m = start[r + 1] - begin;
        if (m <= 8)
            thread_row<kMaxD, 8>(r, begin, m, list, g_packed, g_src, width, vec != 0);
        else if (m <= kThreadRun)
            thread_row<kMaxD, kThreadRun>(r, begin, m, list, g_packed, g_src, width, vec != 0);
        else
            queue[atomicAdd(&queued, 1u)] = threadIdx.x;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned* bits = packed_rows_shared() + warp * (2 * words + 32 * kWarpChunks<kMaxD> * width);
    unsigned* pre = bits + words;
    float* stage = reinterpret_cast<float*>(pre + words);
    for (unsigned q = warp; q < queued; q += kSumWarps) {
        const long long r = static_cast<long long>(queue[q]) * blocks + blockIdx.x;
        const unsigned begin = start[r], m = start[r + 1] - begin;
        warp_row<kMaxD>(r, begin, m, list, sorted, g_packed, g_src, width, vec != 0, capacity, words, bits, pre,
                        stage, lane);
    }
}

int sum_shared_bytes(int words, int width) {
    const int chunks = width <= 12 ? kWarpChunks<12> : kWarpChunks<kMaxWidth>;
    return kSumWarps * (2 * words + 32 * chunks * width) * 4;
}

}  // namespace

// Bytes of scratch packed_rows_bwd_f32 needs, from the shapes alone, or -1
// for shapes it does not take.
extern "C" long long packed_rows_scratch_bytes(int num_tiles, int capacity, int num_rows) {
    if (num_tiles < 0 || capacity < 1 || num_rows < 0 || num_rows >= (1 << 30) ||
        static_cast<long long>(num_tiles) * capacity >= (1LL << 32) - 1)
        return -1;
    Scratch s;
    return carve(nullptr, num_tiles, capacity, num_rows, &s);
}

// idx (T, K) int64 with rows idx_stride apart (select_and_pack's is a slice
// of a wider buffer) and counts (T,) int32 as select_and_pack gives them;
// g_packed (T, K, width) float32 contiguous; g_src (num_rows + 1, width)
// float32 contiguous, written in full; scratch of packed_rows_scratch_bytes
// bytes, 256-byte aligned, its contents arbitrary. width in [1, 32]. Five
// launches on `stream` (fewer where T is 0); returns the first CUDA error,
// or cudaErrorInvalidValue for arguments the kernels do not take.
extern "C" int packed_rows_bwd_f32(const long long* idx, const int* counts, const float* g_packed, float* g_src,
                                   void* scratch, long long scratch_bytes, int num_tiles, int capacity,
                                   long long idx_stride, int width, int num_rows, void* stream) {
    const long long need = packed_rows_scratch_bytes(num_tiles, capacity, num_rows);
    if (need < 0 || scratch == nullptr || scratch_bytes < need || idx_stride < capacity || width < 1 ||
        width > kMaxWidth)
        return static_cast<int>(cudaErrorInvalidValue);
    const int words = num_tiles > 0 ? (num_tiles + 31) / 32 : 1;
    const int smem = sum_shared_bytes(words, width);
    if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    Scratch s;
    carve(static_cast<char*>(scratch), num_tiles, capacity, num_rows, &s);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(s.counts, 0, s.zeroed, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (num_tiles > 0) {
        packed_rows_count_kernel<<<num_tiles, kCountThreads, 0, st>>>(idx, counts, s.counts, s.sorted, capacity,
                                                                      idx_stride, num_rows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    packed_rows_scan_kernel<<<static_cast<int>(scan_blocks(num_rows)), kScanThreads, 0, st>>>(
        s.counts, s.start, s.ticket, s.states, num_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (num_tiles > 0) {
        packed_rows_place_kernel<<<num_tiles, kCountThreads, 0, st>>>(idx, counts, s.start, s.sorted, s.list,
                                                                      capacity, idx_stride, num_rows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int vec = width % 4 == 0 && reinterpret_cast<unsigned long long>(g_packed) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(g_src) % 16 == 0;
    const int blocks = static_cast<int>((static_cast<long long>(num_rows) + kSumThreads) / kSumThreads);
    auto kernel = width <= 12 ? packed_rows_sum_kernel<12> : packed_rows_sum_kernel<kMaxWidth>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kSumThreads, smem, st>>>(s.start, s.list, s.sorted, g_packed, g_src, num_rows, width, capacity,
                                              words, vec, blocks);
    return static_cast<int>(cudaGetLastError());
}
