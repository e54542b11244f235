// Carrier-recovery kernels of the blind receiver, for Hopper (sm_90a).
//
// B3  qtt_bps_idx: blind phase search on a square grid. For each sample and
//     each of A test angles: rotate, squared distance to the nearest grid
//     point (per axis floor(x+0.5) clamped to the levels), sum over the 2N
//     window around the sample, argmin over the angles (lowest index wins
//     ties). Positions [N, L-N) are written with that index, the rest with 0.
//     Replaces qampy_tpu/ops/phase_pallas.py bps_idx_pallas (_bps_kernel,
//     _make_dist_fn, _windowed_sums).
//     Bound: arithmetic and shared-memory traffic (about 20 operations per
//     (sample, angle) for the distance and 2N adds per (sample, angle) for
//     the windows), on a decimated input of a few MB. Design: one CTA per
//     (mode, tile of T samples); the tile and its 2N-1 neighbours are staged
//     in shared memory, then the whole (A x (T+2N-1)) distance table; each
//     thread sums its windows from that table in float32 and keeps the first
//     minimum. Tiles overlap by 2N-1 samples, so every window is exact
//     wherever it falls and no state crosses CTAs.
//
// B4  qtt_interp_rotate: ph = a[i/dx] + b[i/dx]*(i%dx), out = E exp(sign j ph).
//     Replaces qampy_tpu/ops/phase_pallas.py interp_rotate_planes_pallas
//     (_interp_rotate_kernel). Bound: device memory (read two planes and the
//     coefficients, write two planes). Design: one thread per sample. The
//     phase is formed in float32 with round-to-nearest products (no
//     contraction into an FMA, so it equals the plain version's), and
//     sincosf is the precise one: the unwrapped phase grows to many radians
//     over a long capture, where the fast intrinsics lose accuracy. This
//     file must never be built with --use_fast_math.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBpsTile = 128;     // decimated samples per CTA, one per thread
constexpr int kRotThreads = 256;

__global__ void bps_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                           long long L, const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t, int A, int N, float c0,
                           float nm1, int* __restrict__ out) {
    extern __shared__ float sm[];
    const int N2 = 2 * N;
    const int W = kBpsTile + N2 - 1;
    float* dist = sm;                 // (A, W)
    float* ct = dist + A * W;         // (A,)
    float* st = ct + A;               // (A,)
    float* xr_s = st + A;             // (W,)
    float* xi_s = xr_s + W;           // (W,)
    const long long row = (long long)blockIdx.y * L;
    const long long j0 = (long long)blockIdx.x * kBpsTile;
    const long long g0 = j0 - N + 1;  // first sample of the tile's windows

    for (int a = threadIdx.x; a < A; a += blockDim.x) {
        ct[a] = cos_t[a];
        st[a] = sin_t[a];
    }
    for (int u = threadIdx.x; u < W; u += blockDim.x) {
        const long long g = g0 + u;
        const bool in = g >= 0 && g < L;
        xr_s[u] = in ? er[row + g] : 0.f;
        xi_s[u] = in ? ei[row + g] : 0.f;
    }
    __syncthreads();
    for (int q = threadIdx.x; q < A * W; q += blockDim.x) {
        const int a = q / W, u = q - a * W;
        const float x = xr_s[u], y = xi_s[u];
        const float ur = __fsub_rn(__fsub_rn(__fmul_rn(x, ct[a]), __fmul_rn(y, st[a])), c0);
        const float ui = __fsub_rn(__fadd_rn(__fmul_rn(x, st[a]), __fmul_rn(y, ct[a])), c0);
        const float fr = ur - fminf(fmaxf(floorf(ur + 0.5f), 0.f), nm1);
        const float fi = ui - fminf(fmaxf(floorf(ui + 0.5f), 0.f), nm1);
        dist[q] = __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
    }
    __syncthreads();

    const long long j = j0 + threadIdx.x;
    if (j >= L) return;
    int best = 0;
    if (j >= N && j < L - N) {
        float bs = INFINITY;
        for (int a = 0; a < A; ++a) {
            const float* d = dist + a * W + threadIdx.x;
            float acc = 0.f;
            for (int n = 0; n < N2; ++n) acc += d[n];
            if (acc < bs) {
                bs = acc;
                best = a;
            }
        }
    }
    out[row + j] = best;
}

__global__ void interp_rotate_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                                     const float* __restrict__ a, const float* __restrict__ b,
                                     long long L, long long nb, int dx, int sign,
                                     float* __restrict__ outr, float* __restrict__ outi) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= L) return;
    const long long m = blockIdx.y;
    const long long k = i / dx;
    const float frac = (float)(i - k * dx);
    const float ph = __fadd_rn(a[m * nb + k], __fmul_rn(b[m * nb + k], frac));
    float s, c;
    sincosf(ph, &s, &c);
    const float x = er[m * L + i], y = ei[m * L + i];
    if (sign > 0) {   // E exp(+j ph)
        outr[m * L + i] = __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
        outi[m * L + i] = __fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c));
    } else {          // E exp(-j ph)
        outr[m * L + i] = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
        outi[m * L + i] = __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
    }
}

}  // namespace

extern "C" {

long long qtt_bps_smem(int A, int N) {
    const long long W = kBpsTile + 2LL * N - 1;
    return 4 * (A * W + 2LL * A + 2 * W);
}

int qtt_bps_idx(const float* er, const float* ei, int nmodes, long long L, const float* cos_t,
                const float* sin_t, int A, int N, float c0, float nm1, int* out,
                void* stream) {
    const size_t smem = (size_t)qtt_bps_smem(A, N);
    if (smem > 48 * 1024) {
        const int rc = (int)cudaFuncSetAttribute(
            (const void*)bps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc) return rc;
    }
    const dim3 grid((unsigned)((L + kBpsTile - 1) / kBpsTile), (unsigned)nmodes);
    bps_kernel<<<grid, kBpsTile, smem, (cudaStream_t)stream>>>(er, ei, L, cos_t, sin_t, A, N,
                                                               c0, nm1, out);
    return (int)cudaGetLastError();
}

int qtt_interp_rotate(const float* er, const float* ei, const float* a, const float* b,
                      int nmodes, long long L, long long nb, int dx, int sign, float* outr,
                      float* outi, void* stream) {
    const dim3 grid((unsigned)((L + kRotThreads - 1) / kRotThreads), (unsigned)nmodes);
    interp_rotate_kernel<<<grid, kRotThreads, 0, (cudaStream_t)stream>>>(er, ei, a, b, L, nb,
                                                                         dx, sign, outr, outi);
    return (int)cudaGetLastError();
}

}  // extern "C"
