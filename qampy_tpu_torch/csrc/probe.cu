// Latency probe, for Hopper (sm_90a).
//
// qtt_probe_latency measures, on one SM, the latencies that bound the two
// LMS trainers of equaliser.cu (B1, B9), whose time is a chain of dependent
// steps: a dependent float add, a dependent fused multiply-add, a warp
// shuffle followed by an add (one butterfly step), rde's register lookup
// (ballot, popc, shuffle, and an add), a dependent shared-memory load, and a CTA
// barrier at the launch's thread count. Each is a loop of `iters`
// dependent repetitions between two clock64() reads of thread 0, so the
// result is cycles per repetition; the SM clock comes from clock64()
// against %globaltimer over the whole kernel. Two throughputs follow, with
// every warp of the CTA at work: independent 16-byte shared-memory loads
// without bank conflicts and independent fused multiply-adds, in SM cycles
// per warp instruction. It replaces no TPU kernel:
// the chain bounds in PERF.md are reckoned from its numbers.
#include <cuda_runtime.h>

namespace {

constexpr int kProbeValues = 10;  // floats written by one launch

__device__ __forceinline__ long long tick() {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
    return t;
}

__device__ __forceinline__ unsigned long long wall_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)::"memory");
    return t;
}

// out: [fadd, ffma, shuffle+add, ballot+popc+shuffle+add, shared load, barrier]
// in cycles per repetition, then the SM clock in GHz and the thread count,
// then SM cycles per warp-wide 16-byte shared load and per warp-wide FFMA.
__global__ void latency_kernel(float* __restrict__ out, const float* __restrict__ in, int iters) {
    __shared__ int chase[32];
    __shared__ float4 wide[1024];         // 16 KB for the load throughput
    constexpr unsigned kFull = 0xffffffffu;
    const int tid = threadIdx.x;
    const float c = in[0];
    // lane-dependent, or the compiler drops the shuffles of a uniform value
    float v = in[1] + c * (float)tid;
    if (tid < 32) chase[tid] = (tid + (int)in[2]) & 31;
    for (int i = tid; i < 1024; i += blockDim.x) wide[i] = make_float4(c, c, c, c);
    __syncthreads();
    const unsigned long long w0 = wall_ns();
    const long long k0 = tick();
    float res[6];

    long long t0 = tick();
#pragma unroll 16
    for (int i = 0; i < iters; ++i) v = __fadd_rn(v, c);
    asm volatile("" : "+f"(v));
    res[0] = (float)(tick() - t0);

    t0 = tick();
#pragma unroll 16
    for (int i = 0; i < iters; ++i) v = __fmaf_rn(v, c, c);
    asm volatile("" : "+f"(v));
    res[1] = (float)(tick() - t0);

    t0 = tick();
#pragma unroll 16
    for (int i = 0; i < iters; ++i) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, 16));
    asm volatile("" : "+f"(v));
    res[2] = (float)(tick() - t0);

    t0 = tick();
    // as B9 reads rde's ring: lane l holds boundary l and code l; the add
    // closes the chain (subtract the fadd above for the lookup alone)
    const float bnd = in[1] + c * (float)(tid & 31), code = in[1] - c * (float)(tid & 7);
#pragma unroll 16
    for (int i = 0; i < iters; ++i)
        v = __fadd_rn(__shfl_sync(kFull, code, __popc(__ballot_sync(kFull, v > bnd))), c);
    asm volatile("" : "+f"(v));
    res[3] = (float)(tick() - t0);

    int p = tid & 31;
    t0 = tick();
#pragma unroll 16
    for (int i = 0; i < iters; ++i) p = chase[p];
    asm volatile("" : "+r"(p));
    res[4] = (float)(tick() - t0);

    t0 = tick();
#pragma unroll 16
    for (int i = 0; i < iters; ++i) __syncthreads();
    res[5] = (float)(tick() - t0);

    // throughput: every warp issues independent 16-byte loads, then FFMAs
    float4 acc = make_float4(v, v, v, v);
    __syncthreads();
    t0 = tick();
#pragma unroll 8
    for (int i = 0; i < iters; ++i) {
        const float4 x = wide[(tid + 32 * i) & 1023];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
    }
    __syncthreads();
    const float lds_cycles = (float)(tick() - t0);
    float a0 = acc.x, a1 = acc.y, a2 = acc.z, a3 = acc.w, a4 = v, a5 = c, a6 = v + c, a7 = v - c;
    __syncthreads();
    t0 = tick();
#pragma unroll 4
    for (int i = 0; i < iters; ++i) {
        a0 = __fmaf_rn(a0, c, v);
        a1 = __fmaf_rn(a1, c, v);
        a2 = __fmaf_rn(a2, c, v);
        a3 = __fmaf_rn(a3, c, v);
        a4 = __fmaf_rn(a4, c, v);
        a5 = __fmaf_rn(a5, c, v);
        a6 = __fmaf_rn(a6, c, v);
        a7 = __fmaf_rn(a7, c, v);
    }
    __syncthreads();
    const float ffma_cycles = (float)(tick() - t0);
    v = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));

    const long long k1 = tick();
    const unsigned long long w1 = wall_ns();
    if (tid == 0) {
        for (int i = 0; i < 6; ++i) out[i] = res[i] / (float)iters;
        out[6] = (float)(k1 - k0) / (float)(w1 - w0);
        out[7] = (float)blockDim.x;
        const float nwarps = (float)(blockDim.x >> 5);
        out[8] = lds_cycles / ((float)iters * nwarps);
        out[9] = ffma_cycles / (8.0f * (float)iters * nwarps);
    }
    // keep the chains alive
    if (v == 123.456f && p == 77) out[0] = v;
}

}  // namespace

extern "C" {

int qtt_probe_values() { return kProbeValues; }

// out: kProbeValues floats on the device; in: three floats (an addend, a
// start value, the stride of the shared-memory chase); one CTA of `threads`.
int qtt_probe_latency(float* out, const float* in, int iters, int threads, void* stream) {
    if (threads < 32 || threads > 1024 || threads % 32 || iters < 1)
        return (int)cudaErrorInvalidValue;
    latency_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(out, in, iters);
    return (int)cudaGetLastError();
}

}  // extern "C"
