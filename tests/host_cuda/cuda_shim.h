// Host stand-ins for the CUDA builtins that csrc/hash_grid.cu,
// csrc/packed_rows.cu and csrc/adam.cu use, so that their sources compile with g++ and their
// kernels run on the CPU: each warp is
// 32 host threads (run_warp), and every shuffle, ballot, __match_any_sync and
// __syncwarp is a meeting of the 32 at a barrier. A whole block runs as its
// threads at once (host_launch, which also stands in for the <<<...>>>
// launch where a test rewrites it so): __syncthreads is a barrier of the
// block's threads, __shared__ variables are statics (one block runs at a
// time), the launch's dynamic shared memory is a buffer filled with 0xff
// bytes, and the integer atomics are host atomics. Float arithmetic is IEEE single
// precision; compile with -ffp-contract=off so that nothing is fused, as
// __fmul_rn / __fadd_rn guarantee on the card, and __fmaf_rn rounds once. K6's device-only helpers
// (its dynamic shared memory, mbarrier and cp.async.bulk row copies) are
// stood in for below: a copy lands at once, so the host run cannot show a
// missing wait.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <random>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __restrict__

struct float2 {
    float x, y;
};
struct float4 {
    float x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3_ {
    unsigned x, y, z;
};
thread_local uint3_ threadIdx;
uint3_ blockIdx;

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
using std::isnan;
inline unsigned __float_as_uint(float x) {
    unsigned u;
    std::memcpy(&u, &x, 4);
    return u;
}
inline float __uint_as_float(unsigned u) {
    float x;
    std::memcpy(&x, &u, 4);
    return x;
}
template <class T>
T __ldg(const T* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
inline int __clz(unsigned v) { return v ? __builtin_clz(v) : 32; }

// A block run by host_launch: its threads are fibers on the one host thread
// that runs the launch, switched round robin (ucontext), so that a barrier
// costs a turn of each fiber rather than a wake-up of hundreds of host
// threads.
struct FiberBlock {
    std::vector<ucontext_t> ctx;
    std::vector<std::unique_ptr<char[]>> stacks;
    std::vector<char> done;
    ucontext_t scheduler;
    int current = 0;
    std::function<void()> body;
};
inline thread_local FiberBlock* fiber_block = nullptr;

// Back to the scheduler, which resumes the block's next fiber.
inline void fiber_yield() { swapcontext(&fiber_block->ctx[fiber_block->current], &fiber_block->scheduler); }

// A barrier of n threads: of a block's fibers, each waiting fiber yielding
// until the last arrives; of host threads (run_warp's lanes), each waiting
// thread yielding for a while, then sleeping until the last arrives.
struct HostBarrier {
    explicit HostBarrier(int n) : n(n) {}
    void arrive_and_wait() {
        const unsigned gen = generation.load(std::memory_order_acquire);
        if (count.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
            count.store(0, std::memory_order_relaxed);
            generation.fetch_add(1, std::memory_order_release);
            if (fiber_block == nullptr) generation.notify_all();
            return;
        }
        if (fiber_block != nullptr) {
            while (generation.load(std::memory_order_acquire) == gen) fiber_yield();
            return;
        }
        for (int spin = 0; spin < 64; ++spin) {
            if (generation.load(std::memory_order_acquire) != gen) return;
            std::this_thread::yield();
        }
        while (generation.load(std::memory_order_acquire) == gen) generation.wait(gen, std::memory_order_acquire);
    }
    const int n;
    std::atomic<int> count{0};
    std::atomic<unsigned> generation{0};
};

// the warp the calling thread belongs to, and its block's barrier
struct Warp {
    HostBarrier meet{32};
    uint32_t slots[32];
};
inline thread_local Warp* current_warp = nullptr;
inline thread_local HostBarrier* block_barrier = nullptr;

inline uint32_t exchange(uint32_t v, int src) {
    const int lane = threadIdx.x & 31;
    current_warp->slots[lane] = v;
    current_warp->meet.arrive_and_wait();
    const uint32_t r = current_warp->slots[src & 31];
    current_warp->meet.arrive_and_wait();
    return r;
}
template <class T>
uint32_t to_bits(T v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    return u;
}
template <class T>
T from_bits(uint32_t u) {
    T v;
    std::memcpy(&v, &u, 4);
    return v;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) { return from_bits<T>(exchange(to_bits(v), src)); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
    return from_bits<T>(exchange(to_bits(v), (threadIdx.x & 31) ^ mask));
}
template <class T>
T __shfl_up_sync(unsigned, T v, int delta) {
    const int lane = threadIdx.x & 31;
    return from_bits<T>(exchange(to_bits(v), lane >= delta ? lane - delta : lane));
}
inline unsigned __ballot_sync(unsigned, int pred) {
    const int lane = threadIdx.x & 31;
    current_warp->slots[lane] = pred ? 1u : 0u;
    current_warp->meet.arrive_and_wait();
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= current_warp->slots[i] << i;
    current_warp->meet.arrive_and_wait();
    return m;
}
inline void __syncwarp() { current_warp->meet.arrive_and_wait(); }

inline unsigned __match_any_sync(unsigned, unsigned v) {
    const int lane = threadIdx.x & 31;
    current_warp->slots[lane] = v;
    current_warp->meet.arrive_and_wait();
    unsigned m = 0;
    for (int i = 0; i < 32; ++i) m |= (current_warp->slots[i] == v ? 1u : 0u) << i;
    current_warp->meet.arrive_and_wait();
    return m;
}
inline void __syncthreads() {
    if (block_barrier == nullptr) std::abort();  // only a block run by host_launch has one
    block_barrier->arrive_and_wait();
}
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_RELAXED); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
    return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicSub(unsigned* p, unsigned v) { return __atomic_fetch_sub(p, v, __ATOMIC_RELAXED); }
inline unsigned atomicOr(unsigned* p, unsigned v) { return __atomic_fetch_or(p, v, __ATOMIC_RELAXED); }
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
    return __atomic_exchange_n(p, v, __ATOMIC_RELAXED);
}
template <class T>
T __ldcg(const T* p) { return *p; }
inline unsigned __brev(unsigned v) {
    unsigned r = 0;
    for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
    return r;
}

// the launch's dynamic shared memory (K8's tile stage, K5's positions-only
// mode, the packed-row sum)
inline std::vector<float4> host_dynamic_shared;
inline char* k8_shared() { return reinterpret_cast<char*>(host_dynamic_shared.data()); }
inline unsigned* packed_rows_shared() { return reinterpret_cast<unsigned*>(host_dynamic_shared.data()); }
inline float* k5_pos_shared() { return reinterpret_cast<float*>(host_dynamic_shared.data()); }

// K6's helpers: the block's dynamic shared memory (the harness sizes it;
// one block runs at a time), its mbarrier (an arrival without copies, too)
// and its bulk row copies
inline std::vector<float4> k6_host_shared;
inline float* k6_shared() { return reinterpret_cast<float*>(k6_host_shared.data()); }
inline void bar_init(unsigned long long*) {}
inline void bar_expect(unsigned long long*, unsigned) {}
inline void bar_arrive(unsigned long long*) {}
inline void copy_row_bulk(float* dst, const void* src, unsigned bytes, unsigned long long*) {
    std::memcpy(dst, src, bytes);
}
// on the card every lane's own wait makes the copies visible to it; here the
// lanes' copies are their own stores, so the lanes meet
inline void bar_wait(unsigned long long*, unsigned) { __syncwarp(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaMemcpyDeviceToDevice = 3 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T>
cudaError_t cudaFuncSetAttribute(T, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t bytes, int, cudaStream_t) {
    std::memcpy(dst, src, bytes);
    return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* dst, int value, size_t bytes, cudaStream_t) {
    std::memset(dst, value, bytes);
    return cudaSuccess;
}

// Runs `body(lane)` on 32 threads as warp `warp` of block `block`.
template <class Body>
void run_warp(unsigned block, unsigned warp, Body body) {
    Warp w;
    current_warp = &w;
    blockIdx.x = block;
    std::vector<std::thread> lanes;
    for (unsigned lane = 0; lane < 32; ++lane)
        lanes.emplace_back([&, lane] {
            threadIdx.x = warp * 32 + lane;
            current_warp = &w;
            body();
        });
    for (auto& t : lanes) t.join();
}

// Runs `body()` as every thread of `grid` blocks of `threads` threads, one
// block at a time: the block's threads as fibers (FiberBlock), its warps
// meeting at their own barriers and the block at one of its own.
inline void fiber_entry() {
    FiberBlock* fb = fiber_block;
    fb->body();
    fb->done[fb->current] = 1;
    swapcontext(&fb->ctx[fb->current], &fb->scheduler);  // not resumed
}

// Nonzero: host_run_grid runs a launch's blocks in an order shuffled by this
// seed, as the card may run them in any order.
inline unsigned host_block_shuffle = 0;

template <class Body>
void host_run_grid(long long grid, int threads, size_t smem, Body body) {
    constexpr size_t kStack = 1 << 18;
    host_dynamic_shared.assign((smem + 15) / 16, float4{});
    std::unique_ptr<Warp[]> warps(new Warp[threads / 32]);
    HostBarrier sync(threads);
    FiberBlock fb;
    fb.body = body;
    fb.ctx.resize(threads);
    fb.done.assign(threads, 0);
    for (int t = 0; t < threads; ++t) fb.stacks.emplace_back(new char[kStack]);
    fiber_block = &fb;
    block_barrier = &sync;
    std::vector<long long> order(grid);
    for (long long b = 0; b < grid; ++b) order[b] = b;
    if (host_block_shuffle != 0) std::shuffle(order.begin(), order.end(), std::mt19937(host_block_shuffle));
    for (const long long b : order) {
        blockIdx.x = static_cast<unsigned>(b);
        std::memset(host_dynamic_shared.data(), 0xff, host_dynamic_shared.size() * sizeof(float4));
        for (int t = 0; t < threads; ++t) {
            getcontext(&fb.ctx[t]);
            fb.ctx[t].uc_stack.ss_sp = fb.stacks[t].get();
            fb.ctx[t].uc_stack.ss_size = kStack;
            fb.ctx[t].uc_link = nullptr;
            makecontext(&fb.ctx[t], fiber_entry, 0);
            fb.done[t] = 0;
        }
        for (int left = threads; left > 0;) {
            left = 0;
            for (int t = 0; t < threads; ++t) {
                if (fb.done[t]) continue;
                fb.current = t;
                threadIdx.x = static_cast<unsigned>(t);
                current_warp = &warps[t / 32];
                swapcontext(&fb.scheduler, &fb.ctx[t]);
                left += !fb.done[t];
            }
        }
    }
    fiber_block = nullptr;
    block_barrier = nullptr;
}

// kernel<<<grid, threads[, smem[, stream]]>>>(args...) on the host, as
// host_launch(kernel, grid, threads[, smem[, stream]])(args...).
template <class Kernel>
auto host_launch(Kernel kernel, long long grid, int threads, size_t smem = 0, cudaStream_t = nullptr) {
    return [=](auto... args) { host_run_grid(grid, threads, smem, [&] { kernel(args...); }); };
}
