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
//
// The cost probes of the JAX package (tools/probe_pallas_overhead.py,
// tools/probe_interleave.py), asked again of the H100 (chip_smoke.py phase
// 2): qtt_probe_empty launches empty kernels (the launch latency);
// qtt_probe_copy copies planes with a given number of CTAs and threads (the
// cost of a CTA, the frame filter's old and new grids); qtt_probe_argmin
// forms A candidates per sample and keeps the first least (the reduce and
// write that build_expand isolates); qtt_probe_deinterleave writes complex64
// samples as float32 planes (the layout question of probe_interleave.py).
// They measure and feed no path.
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

__global__ void empty_kernel() {}

// CTA b copies float4 [b per, (b + 1) per) of n4; the rest of n after 4 n4 by CTA 0.
__global__ void copy_kernel(const float4* __restrict__ src, float4* __restrict__ dst, long long n4,
                            long long per, const float* __restrict__ s1, float* __restrict__ d1,
                            long long n) {
    const long long lo = blockIdx.x * per, hi = min(n4, lo + per);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = src[i];
    if (blockIdx.x == 0)
        for (long long i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) d1[i] = s1[i];
}

// out[i] = the first a of the least x[i] * (a + 1), a < A
__global__ void argmin_kernel(const float* __restrict__ x, int* __restrict__ out, long long n,
                              int A) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const float v = x[i];
        float best = v;
        int at = 0;
        for (int a = 1; a < A; ++a) {
            const float c = v * (float)(a + 1);
            if (c < best) {
                best = c;
                at = a;
            }
        }
        out[i] = at;
    }
}

// (nmodes, L) complex64 samples to (2 nmodes, L) float32 planes
__global__ void deinterleave_kernel(const float2* __restrict__ z, float* __restrict__ planes,
                                    int nmodes, long long L) {
    const long long n = nmodes * L;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        const float2 v = z[i];
        const long long m = i / L, k = i - m * L;
        planes[m * L + k] = v.x;
        planes[(nmodes + m) * L + k] = v.y;
    }
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

int qtt_probe_empty(int n, void* stream) {
    for (int i = 0; i < n; ++i) empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// n floats from src to dst (both 16-byte aligned) by `ctas` CTAs of `threads`.
int qtt_probe_copy(const float* src, float* dst, long long n, int threads, int ctas,
                   void* stream) {
    if (threads < 32 || threads > 1024 || ctas < 1 || n < 0) return (int)cudaErrorInvalidValue;
    const long long n4 = n / 4, per = (n4 + ctas - 1) / ctas;
    copy_kernel<<<ctas, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(src), reinterpret_cast<float4*>(dst), n4, per, src, dst,
        n);
    return (int)cudaGetLastError();
}

int qtt_probe_argmin(const float* x, int* out, long long n, int A, void* stream) {
    if (A < 1) return (int)cudaErrorInvalidValue;
    argmin_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(x, out, n, A);
    return (int)cudaGetLastError();
}

int qtt_probe_deinterleave(const float* z, float* planes, int nmodes, long long L,
                           void* stream) {
    deinterleave_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float2*>(z), planes, nmodes, L);
    return (int)cudaGetLastError();
}

}  // extern "C"
