// The Adam update of every param group in one pass, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package gets Adam from optax, and XLA fuses
// its update. The port's engine/optimizers.py::ScheduledAdam ran it as
// eight foreach passes a group (lerp, mul, addcmul, sqrt, div, add, div,
// addcdiv), which move about 80 bytes a parameter; this kernel moves 28.
// For each element of each tensor, in the eight passes' order and rounding:
//   m = lerp(m, g, 1 - b1)             fmaf(1 - b1, g - m, m)
//   v = v * b2
//   v = v + (1 - b2) * g * g           fmaf(1 - b2, g * g, v)
//   p = p * (1 - lr * wd)              only where the group decays
//   d = sqrt(v) / sqrt(1 - b2^t)
//   d = d + eps
//   d = d / (lr / (1 - b1^t))
//   p = p - m / d                      addcdiv with value -1: one rounding
// Each operation is an explicit IEEE intrinsic (__fmul_rn, __fdiv_rn,
// __fsqrt_rn, ...), and __fmaf_rn exactly where ATen's foreach kernels fuse
// (lerp's small-weight form and addcmul), so nvcc contracts nothing else and
// the result equals the eight passes bit for bit. The group's scalars
// (1 - lr wd, sqrt(1 - b2^t), lr / (1 - b1^t)) are 0-dim device tensors the
// optimizer computes before the launch; the kernel reads them, so a captured
// CUDA graph replays with the step's own lr and counts.
//
// What bounds it on an H100: bytes. Per element it reads p, g, m and v and
// writes p, m and v once: 28 B, 4.35 GB over active-nerfacto's 155 M
// parameters, 1.30 ms at 3.35 TB/s. What the design does about it:
//  * one launch covers every group's tensors. The table of tensors rides in
//    the kernel's parameters (by value, under 4 KB), so a graph keeps it and
//    nothing is copied to the device; a longer list is cut into launches
//    (ops/adam.py::plan_launches).
//  * a block takes 1,024 float4s (4,096 elements) of one tensor, and each
//    thread loads its 4 float4s of each of the 4 arrays before it computes,
//    so 256 B a thread are in flight. Where the four addresses share their
//    offset from 16 bytes, the first 0-3 elements (the head) and the last 0-3
//    (the tail) are read as scalars by the tensor's first block and the rest
//    as float4s; a tensor whose four addresses differ there (a view at an
//    odd offset into a stacked buffer beside a gradient of its own) is read
//    as scalars, 16 a thread, still coalesced.
//  * a block finds its tensor by a binary search over the tensors' first
//    blocks, read from the parameter bank.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;                          // float4s a thread
constexpr int kBlockVecs = kThreads * kVecPerThread;      // float4s a block
constexpr int kBlockScalars = kBlockVecs * 4;             // elements a block on the scalar path
constexpr int kMaxGroups = 16;
constexpr int kMaxTensors = 72;

struct AdamGroup {
    const float* decay;      // 1 - lr * wd, or null where the group does not decay
    const float* bc2_sqrt;   // sqrt(1 - b2^t)
    const float* step_size;  // lr / (1 - b1^t)
    float eps;
};

struct AdamTensor {
    float* p;
    const float* g;
    float* m;
    float* v;
    long long numel;
    int first_block;
    short group;  // into AdamTable::groups
    short head;   // elements before the first float4, or -1: scalars only
};

struct AdamTable {
    AdamGroup groups[kMaxGroups];
    AdamTensor tensors[kMaxTensors];
    int num_tensors;
    float one_minus_b1;
    float b2;
    float one_minus_b2;
};
static_assert(sizeof(AdamTable) <= 4096, "the table rides in the kernel's parameters");

struct Scalars {
    float w1, b2, c2, decay, bc2, step, eps;
    bool decays;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Scalars& s) {
    m = __fmaf_rn(s.w1, __fsub_rn(g, m), m);
    v = __fmul_rn(v, s.b2);
    v = __fmaf_rn(s.c2, __fmul_rn(g, g), v);
    if (s.decays) p = __fmul_rn(p, s.decay);
    float d = __fdiv_rn(__fsqrt_rn(v), s.bc2);
    d = __fdiv_rn(__fadd_rn(d, s.eps), s.step);
    p = __fsub_rn(p, __fdiv_rn(m, d));
}

__device__ __forceinline__ void update_at(const AdamTensor& t, long long i, const Scalars& s) {
    float p = t.p[i], m = t.m[i], v = t.v[i];
    update(p, t.g[i], m, v, s);
    t.p[i] = p;
    t.m[i] = m;
    t.v[i] = v;
}

__global__ void __launch_bounds__(kThreads) adam_multi_tensor_apply_kernel(const AdamTable table) {
    const int block = blockIdx.x;
    int lo = 0, hi = table.num_tensors - 1;
    while (lo < hi) {  // the last tensor whose first block is at or before this one
        const int mid = (lo + hi + 1) >> 1;
        if (table.tensors[mid].first_block <= block) lo = mid;
        else hi = mid - 1;
    }
    const AdamTensor t = table.tensors[lo];
    const AdamGroup grp = table.groups[t.group];
    Scalars s;
    s.w1 = table.one_minus_b1;
    s.b2 = table.b2;
    s.c2 = table.one_minus_b2;
    s.decays = grp.decay != nullptr;
    s.decay = s.decays ? *grp.decay : 1.0f;
    s.bc2 = *grp.bc2_sqrt;
    s.step = *grp.step_size;
    s.eps = grp.eps;
    const long long chunk = block - t.first_block;

    if (t.head < 0) {
        const long long base = chunk * kBlockScalars + threadIdx.x;
#pragma unroll 4
        for (int k = 0; k < kBlockScalars / kThreads; ++k) {
            const long long i = base + static_cast<long long>(k) * kThreads;
            if (i < t.numel) update_at(t, i, s);
        }
        return;
    }

    const long long vecs = (t.numel - t.head) >> 2;
    float4* p4 = reinterpret_cast<float4*>(t.p + t.head);
    const float4* g4 = reinterpret_cast<const float4*>(t.g + t.head);
    float4* m4 = reinterpret_cast<float4*>(t.m + t.head);
    float4* v4 = reinterpret_cast<float4*>(t.v + t.head);
    const long long base = chunk * kBlockVecs + threadIdx.x;
    float4 P[kVecPerThread], G[kVecPerThread], M[kVecPerThread], V[kVecPerThread];
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
        const long long i = base + k * kThreads;
        if (i < vecs) {
            P[k] = p4[i];
            G[k] = g4[i];
            M[k] = m4[i];
            V[k] = v4[i];
        }
    }
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
        const long long i = base + k * kThreads;
        if (i < vecs) {
            update(P[k].x, G[k].x, M[k].x, V[k].x, s);
            update(P[k].y, G[k].y, M[k].y, V[k].y, s);
            update(P[k].z, G[k].z, M[k].z, V[k].z, s);
            update(P[k].w, G[k].w, M[k].w, V[k].w, s);
            p4[i] = P[k];
            m4[i] = M[k];
            v4[i] = V[k];
        }
    }
    if (chunk == 0) {  // the head and the tail, 0-3 elements each
        const int tail = static_cast<int>((t.numel - t.head) & 3);
        const int j = threadIdx.x;
        if (j < t.head) update_at(t, j, s);
        else if (j < t.head + tail) update_at(t, t.head + 4 * vecs + (j - t.head), s);
    }
}

}  // namespace

// The table's layout, for the wrapper to hold its ctypes mirror against:
// out[0] sizeof(AdamTable), out[1] kMaxTensors, out[2] kMaxGroups, out[3]
// float4s a block, out[4] elements a block on the scalar path.
extern "C" void adam_table_layout(int* out) {
    out[0] = static_cast<int>(sizeof(AdamTable));
    out[1] = kMaxTensors;
    out[2] = kMaxGroups;
    out[3] = kBlockVecs;
    out[4] = kBlockScalars;
}

// One launch of num_blocks blocks over the table (host memory, copied into
// the launch's parameters). Returns the launch's CUDA error.
extern "C" int adam_update_f32(const void* table, int num_blocks, void* stream) {
    adam_multi_tensor_apply_kernel<<<num_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        *static_cast<const AdamTable*>(table));
    return static_cast<int>(cudaGetLastError());
}
