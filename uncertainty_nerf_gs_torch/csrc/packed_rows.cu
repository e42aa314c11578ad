// Backward of the splat path's packed-row gather, for Hopper (sm_90a).
//
// uncertainty_nerf_gs_torch/ops/rasterize.py::select_and_pack gathers the
// depth-sorted Gaussians' rows into one (T, K, D) buffer, D = 6 + C:
//   packed[t, k, :] = src[idx[t, k], :]
// with src (n + 1, D) and row n the pad row that fills every slot past a
// tile's count. This file is its backward,
//   g_src[r, :] = sum over the live slots (t, k < counts[t]) with
//                 idx[t, k] == r of g_packed[t, k, :],
// with g_src[n, :] = 0. It is not a TPU kernel: the JAX package gets this
// function from XLA as the transpose of a gather. It replaces the scatter of
// F.embedding's backward, which walked all T x K indices, pad slots
// included, and added with float atomics in an order that changed from
// launch to launch.
//
// What bounds it on an H100: bytes. The function reads each live slot's D
// floats once and writes the n + 1 rows of g_src once; it does no float
// work beyond one add an element. What the design does about that, and
// about the order of the sums:
//   1. keys: one block a tile walks only its first counts[t] slots and
//      writes, at the tile's offset among the live slots, the Gaussian id
//      (the key) and the slot t * K + k. The live slots are so listed in
//      ascending (tile, slot) order.
//   2. K5's stable LSD radix sort (csrc/hash_grid.cu::radix_sort_u32) sorts
//      the keys; equal keys keep their ascending (tile, slot) order.
//   3. sum: one thread an element (r, c) of g_src finds row r's run of the
//      sorted keys by binary search and adds its entries' g_packed[slot, c]
//      from left to right, in ascending (tile, slot) order, with __fadd_rn;
//      it stores the sum once. A row no live slot names, and the pad row,
//      get 0. No float atomic: two launches give the same bits, and
//      ops/rasterize.py::packed_rows_vjp_reference adds in the same order,
//      so the two agree bit for bit.
// The wrapper (ops/rasterize.py::packed_rows_bwd) computes the tiles'
// offsets, allocates every output and the sort's scratch; nothing is
// allocated here.

#include <cuda_runtime.h>

namespace {

constexpr int kKeyThreads = 128;
constexpr int kSumThreads = 256;

// One block a tile: its live slots' keys and slot indices at the tile's offset.
__global__ void __launch_bounds__(kKeyThreads) packed_rows_keys_kernel(
    const long long* __restrict__ idx, const int* __restrict__ counts,
    const int* __restrict__ offsets, unsigned* __restrict__ keys, unsigned* __restrict__ slots,
    int capacity, long long idx_stride) {
    const int t = blockIdx.x;
    const int count = counts[t];
    const int base = offsets[t];
    const long long row0 = static_cast<long long>(t) * capacity;
    for (int k = threadIdx.x; k < count; k += kKeyThreads) {
        keys[base + k] = static_cast<unsigned>(idx[t * idx_stride + k]);
        slots[base + k] = static_cast<unsigned>(row0 + k);
    }
}

// The first position in skeys[0 .. n) whose key is not below v.
__device__ __forceinline__ int lower_bound(const unsigned* __restrict__ skeys, int n, unsigned v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (skeys[mid] < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// One thread an element of g_src: row r's entries added in sorted order.
__global__ void __launch_bounds__(kSumThreads) packed_rows_sum_kernel(
    const unsigned* __restrict__ skeys, const unsigned* __restrict__ perm,
    const unsigned* __restrict__ slots, const float* __restrict__ g_packed,
    float* __restrict__ g_src, int num_live, int num_rows, int width) {
    const long long e = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
    if (e >= static_cast<long long>(num_rows + 1) * width) return;
    const int r = static_cast<int>(e / width);
    const int c = static_cast<int>(e % width);
    float acc = 0.0f;
    if (r < num_rows) {  // row num_rows is the pad row: always zero
        const int lo = lower_bound(skeys, num_live, static_cast<unsigned>(r));
        const int hi = lower_bound(skeys, num_live, static_cast<unsigned>(r) + 1u);
        for (int j = lo; j < hi; ++j)
            acc = __fadd_rn(acc, g_packed[static_cast<long long>(slots[perm[j]]) * width + c]);
    }
    g_src[e] = acc;
}

}  // namespace

// Step 1. idx (T, K) int64 with rows idx_stride apart (select_and_pack's is a
// slice of a wider buffer) and counts (T,) int32 as select_and_pack gives
// them, offsets (T,) int32 the exclusive prefix sum of counts; keys and
// slots (sum of counts) uint32. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int packed_rows_keys(const long long* idx, const int* counts, const int* offsets,
                                unsigned* keys, unsigned* slots, int num_tiles, int capacity,
                                long long idx_stride, void* stream) {
    if (num_tiles < 0 || capacity < 1 || idx_stride < capacity ||
        static_cast<long long>(num_tiles) * capacity >= (1LL << 32))
        return static_cast<int>(cudaErrorInvalidValue);
    if (num_tiles == 0) return 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    packed_rows_keys_kernel<<<num_tiles, kKeyThreads, 0, st>>>(
        idx, counts, offsets, keys, slots, capacity, idx_stride);
    return static_cast<int>(cudaGetLastError());
}

// Step 3. skeys and perm (num_live) uint32 from radix_sort_u32 of keys,
// slots from packed_rows_keys, g_packed (T, K, width) float32 contiguous;
// g_src (num_rows + 1, width) float32 contiguous, written in full.
extern "C" int packed_rows_sum(const unsigned* skeys, const unsigned* perm, const unsigned* slots,
                               const float* g_packed, float* g_src, int num_live, int num_rows,
                               int width, void* stream) {
    if (num_live < 0 || num_rows < 0 || width < 1 ||
        static_cast<long long>(num_rows + 1) * width >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long elements = static_cast<long long>(num_rows + 1) * width;
    const int blocks = static_cast<int>((elements + kSumThreads - 1) / kSumThreads);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    packed_rows_sum_kernel<<<blocks, kSumThreads, 0, st>>>(
        skeys, perm, slots, g_packed, g_src, num_live, num_rows, width);
    return static_cast<int>(cudaGetLastError());
}
