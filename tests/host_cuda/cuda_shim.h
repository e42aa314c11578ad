// Host stand-ins for the CUDA builtins that csrc/hash_grid.cu uses, so that
// its source compiles with g++ and its K4 kernel runs on the CPU: each warp
// is 32 host threads (run_warp), and every shuffle, ballot and __syncwarp is
// a meeting of the 32 at a barrier. Float arithmetic is IEEE single
// precision; compile with -ffp-contract=off so that nothing is fused, as
// __fmul_rn / __fadd_rn guarantee on the card. K4 and K6 are run this way:
// K5's kernels compile but use shared memory across warps and integer
// atomics that the stand-ins here do not model. K6's device-only helpers
// (its dynamic shared memory, mbarrier and cp.async.bulk row copies) are
// stood in for below: a copy lands at once, so the host run cannot show a
// missing wait.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
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

// the warp the calling thread belongs to: one at a time
struct Warp {
    std::barrier<> meet{32};
    uint32_t slots[32];
};
inline Warp* current_warp;

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

// K5's stand-ins: they compile, and are not run here
inline unsigned __match_any_sync(unsigned, unsigned) { return 0; }
inline void __syncthreads() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    const unsigned old = *p;
    *p += v;
    return old;
}

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
inline cudaError_t cudaMemcpyAsync(void*, const void*, size_t, int, cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t) { return cudaSuccess; }

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
            body();
        });
    for (auto& t : lanes) t.join();
}
