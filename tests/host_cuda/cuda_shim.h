// Host stand-ins for the CUDA builtins that csrc/hash_grid.cu uses, so that
// its source compiles with g++ and its K4 kernel runs on the CPU: each warp
// is 32 host threads (run_warp), and every shuffle, ballot and __syncwarp is
// a meeting of the 32 at a barrier. Float arithmetic is IEEE single
// precision; compile with -ffp-contract=off so that nothing is fused, as
// __fmul_rn / __fadd_rn guarantee on the card. Only K4 is run this way: K5's
// kernels compile but use shared memory across warps and integer atomics
// that the stand-ins here do not model.
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

struct float4 {
    float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct uint3_ {
    unsigned x, y, z;
};
thread_local uint3_ threadIdx;
uint3_ blockIdx;

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaMemcpyDeviceToDevice = 3 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemcpyAsync(void*, const void*, size_t, int, cudaStream_t) { return cudaSuccess; }

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
