// Carrier-recovery kernels of the blind receiver, for Hopper (sm_90a).
//
// B3  qtt_bps_idx: blind phase search. For each sample and each of A test
//     angles: rotate, distance to the nearest constellation point
//     (grid_dist below, one function for every kind of constellation), sum
//     over the 2N window around the sample, argmin over the angles (lowest
//     index wins ties). Positions [N, L-N) are written with that index, the
//     rest with 0.
//     Replaces qampy_tpu/ops/phase_pallas.py bps_idx_pallas (_bps_kernel,
//     _make_dist_fn, _windowed_sums).
//     Bound: float32 instructions (every product and sum rounded on its own,
//     so one instruction each: about 23 per (sample, angle) for the rotation
//     and an analytic distance, 5 per (sample, angle, point) for a general
//     alphabet), then the window sums' shared-memory loads. Design: one CTA
//     of kBpsThreads threads per (mode, tile of T positions); each thread
//     owns a run of R consecutive positions (T = kBpsThreads R; the launch
//     plan bps_plan picks R from L so that the grid keeps ~2 CTAs per SM, at
//     most 16, and 8 on a general alphabet, whose point loop gains more from
//     CTAs per SM than from longer runs).
//     The tile's T + 2N - 1 samples are staged once in shared memory; then,
//     chunk by chunk of kBpsChunk angles, the CTA fills a table of T + 2N - 1
//     slots, each one sample's distances at the chunk's angles (a thread
//     takes one sample and its kBpsChunk rotations at a time; a general
//     alphabet's points are restaged as float4 [2 re, 2 im, |s|^2, 0], one
//     16-byte broadcast load serving the chunk's angles), and each thread
//     sums the windows of its run: the run's first window in full, then
//     sliding, s += (entering - leaving), so a run's R windows cost 2N +
//     2(R-1) slot loads (16 bytes each, for all the chunk's angles) instead
//     of 2N R; every run starts exact, so the rounding drift is bounded by
//     R (windows of up to kBpsFullWindow samples are each summed in full).
//     The run's best sums and indices stay in registers across chunks
//     (angles in increasing order, strict <: the first minimum wins), so
//     shared memory does not grow with A, nor with the alphabet beyond its
//     table. The table is padded by a slot every run (bps_pad), so lanes
//     whose runs start R slots apart fall on distinct banks. Tiles overlap
//     by 2N-1 samples and no state crosses CTAs; the indices leave through
//     shared memory in coalesced stores.
//     qtt_bps_idx_bf16 sums the windows in bf16 in the order of the reference's
//     win_dtype=bf16 at reference tile T, bit for bit (section "bf16 windows"
//     below): per chunk a fill rounds the distances into a table, each thread
//     builds S_2..S_8 in registers over run + 1 consecutive slots, then walks
//     one residue class mod 8 over its run of windows (positions 8 apart), the
//     doubling levels above 8 and the components of 2N of at least 8 in
//     registers; two barriers a chunk, runs of at most kBfMaxRun = 8 (bf_plan).
//     Instances by window type: float32, bf16 with 2N < 64, bf16 with 2N >= 64
//     (the walk's longer register rings kept out of the shorter windows' code).
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
//
// B5  qtt_cpe_coeffs: the pilot CPE's phase math for one row (mode, frame) of
//     filtered symbols: the pilots z_j sit at off + j*stride; ph_j =
//     atan2(Im, Re) of conj(pil_j) z_j; a 2*pi unwrap as ph_j - 2*pi*s_j, s the
//     prefix sum of the jump counts floor(d_j/(2*pi) + 0.5) of d_j = ph_j -
//     ph_{j-1} (d_0 = 0); a cpe_avg-point moving average pavg; then per block
//     k of dx symbols, with la = k - n_head: a = pavg[la] and b = (pavg[la+1]
//     - pavg[la])/dx inside, a = pavg[0] or pavg[npts-1] and b = 0 outside.
//     Replaces qampy_tpu/ops/phase_pallas.py cpe_coeffs_pallas
//     (_cpe_coeffs_kernel, its in-kernel use_atan2 form: CUDA has atan2f,
//     which Mosaic lacked). Bound: device memory (4 bytes per pilot and plane
//     in, the known pilots, (a, b) out) where the pilots arrive contiguous, as
//     B2's frame entry gathers them on the pilot chain's path; read strided
//     from the filter output each pilot and plane pulls a 32-byte sector.
//     Design: one CTA of kCpeThreads threads per row walks the row in tiles
//     of kCpeTile pilots. The tile's loads come first and coalesced
//     (neighbouring threads on neighbouring pilots, any stride), the phases
//     (atan2f) go to shared memory, and from there each thread takes
//     kCpeItems consecutive ones as a float4: it counts their jumps, one
//     block scan (int32: exact in any order) gives the unwrapped u, and the
//     count and the last phase carry to the next tile. The tile's u sits in
//     shared memory behind a halo of the cpe_avg values before it, so the
//     averages that end in the tile, and the one before them, are summed
//     there once each in the plain version's order; the tile writes the
//     (a, b) of the blocks whose averages it holds (cpe_plan; the head where
//     pavg[0] ends, the tail in the last tile) as 16-byte vectors. No pilot
//     count is too long; shared memory is 4 (halo + 2 kCpeTile + 36) bytes,
//     the halo cpe_avg rounded up to 4: past 48 KB opted in (cpe_avg above
//     8,156), past 227 KB refused (above 53,980). Every product and sum is
//     rounded on its own (no FMA contraction), so the result equals the plain
//     version's but for atan2f against torch.atan2 (an ulp).
//
// B6  qtt_rotate: out = E exp(sign j ph) for a given per-sample phase.
//     Replaces qampy_tpu/ops/phase_pallas.py rotate_planes_pallas
//     (_rotate_kernel). Bound: device memory (read three planes, write two).
//     Design: one thread per sample, the arithmetic of B4 (precise sincosf,
//     round-to-nearest products).
//
// B7  qtt_unwrap_derotate: the pi/2 unwrap u_i = ph_i - (pi/2) M_i, M the
//     inclusive prefix sum of the jump counts m_i = floor(d_i (2/pi) + 0.5)
//     of d_i = ph_i - ph_{i-1} (d_0 = 0), then out = E exp(+j u).
//     Replaces qampy_tpu/ops/phase_pallas.py unwrap_derotate_pallas
//     (_unwrap_derotate_kernel), which carries (previous phase, count) from
//     tile to tile of its sequential grid. Bound: device memory (read three
//     planes, write two: 20 bytes per sample). Design: one launch, a
//     single-pass scan with decoupled look-back (Merrill and Garland 2016).
//     A CTA of kUnwrapThreads threads takes the next tile of its row from a
//     per-row ticket (atomicAdd), so it waits only on tiles whose CTAs have
//     started and no schedule deadlocks (it loads the tile of its launch index
//     while the ticket comes back, and again where the ticket differs). A
//     thread owns kUnwrapItems consecutive samples, loaded and stored as
//     16-byte vectors of each plane where the five planes share their
//     alignment (a row's tiles start up to 3 samples before its first aligned
//     sample; the ragged ends and planes of different alignment take scalar
//     accesses); the previous phase of its first sample
//     comes from the neighbour lane by a shuffle, only a warp's first lane
//     reads it from memory. The tile's counts are scanned in the block; its
//     total is published in a 64-bit status word (flag and int32 value, one
//     store), warp 0 sums its predecessors' words back to the nearest
//     inclusive one, 32 at a time, and publishes the tile's inclusive prefix.
//     Counts are int32, so any summation order gives the same M and u equals
//     the plain version's bit for bit; d (2/pi) + 0.5 and (pi/2) M are rounded
//     op by op (no FMA contraction, which would flip a count within an ulp of
//     an odd multiple of pi/4 and turn the rest of the row by a quarter), and
//     the rotation is B4's (precise sincosf): the output equals B6's rotation
//     by the plain unwrap bit for bit.
//
// B8  qtt_bps_fine: the fine stage of the two-stage phase search. Sample i
//     tries B angles ph1_i + delta_b, built from cos/sin(ph1_i) and the
//     host tables cd/sd = cos/sin(delta_b)/d0 by the angle-addition form;
//     then B3's distance (any kind), 2N window sums and argmin (first minimum
//     wins) at [N, L-N), 0 elsewhere; the output is the phase (ph1_i + d0f) +
//     ddf * idx_i. Replaces qampy_tpu/ops/phase_pallas.py bps_fine_pallas
//     (_bps_fine_kernel). Bound: float32 instructions (B3's per offset, plus
//     6 for the angle), then the window sums' shared-memory loads. Design: B3's
//     tiled search with a per-sample angle (bps_fine_kernel over B3's helpers:
//     the slots, gen_dists, bps_run_sums, the tile's indices). Each staged
//     sample is a float4 [x, y, cos ph1, sin ph1], one precise sincosf per
//     staged sample; per chunk of kBpsChunk offsets cd/sd sit in registers and
//     the fill forms each offset's angle and rotation op by op, in the plain
//     version's order; the runs of sliding window sums and the float4 points
//     of a general alphabet are B3's; the epilogue writes the phase. The launch
//     plan fine_plan takes B3's run rule (from kFineMaxRun = 8 and kFineMaxRunGen = 8:
//     runs of 16 cost 1.4x on the square grid, measured) and
//     halves the run until the CTA fits 227 KB; where even runs of one do not
//     fit (half-windows of thousands of samples), it takes slots of one offset
//     and reads the samples, their angle and the points where they lie, so
//     that shared memory holds 4 bytes per staged sample, no more than the
//     first design's table at B = 1. qtt_bps_fine_bf16: B3's bf16 windows
//     (bf_chunk) after B8's fill, runs of at most kBfFineMaxRun = 8.
//
// B10 qtt_unwrap_slopes: the decimated blind chain's glue between B3 and B4.
//     From B3's best-angle indices idx on the decimated grid: the phase
//     phd_j = lo + step idx_j, the jump counts m_j = floor(d_j (2/pi) + 0.5)
//     of d_j = phd_j - phd_{j-1} (m_0 = 0), their inclusive prefix sum M in
//     int32, a_j = phu_j = phd_j - (pi/2) M_j and b_j = (phu_{j+1} - phu_j) /
//     dec, the last b of a row 0. Replaces no TPU kernel: the reference leaves
//     this glue to XLA (qampy_tpu/ops/chain.py, the decimated branch), and as
//     plain tensor ops it is ~20 launches around a torch.cumsum that scans a
//     long row with a few threads (0.33 ms for 2 x 2^18 on an H100). Bound:
//     device memory (4 bytes of index in, 8 bytes of (a, b) out per decimated
//     sample). Design: B7's single-pass scan with decoupled look-back on the
//     decimated row: a CTA of kSlopeThreads threads takes its tile from the
//     row's ticket (take_ticket, ticket_tile), a thread owns kSlopeItems
//     consecutive samples (16-byte vectors where the row allows), the phase
//     before its first sample and after its last come from the neighbour
//     lanes by shuffles (a warp's edge lanes read them from memory), the
//     counts are scanned in the block and across tiles through B7's status
//     words (tile_exclusive_prefix); those three helpers are B7's too. A
//     tile's last slope needs the next tile's first phu: the thread adds
//     that sample's count to its own inclusive M, so no second pass. Every
//     product and sum is rounded on its own in the plain version's order,
//     the division by pi/2 as PyTorch does it on the card (a product with the
//     float32 reciprocal, which equals 2/pi rounded) and by dec as a product
//     with 1/dec rounded; the counts are int32, so (a, b) equal the plain
//     version run on the card bit for bit, and are the same from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "grid.cuh"

namespace {

constexpr int kBpsThreads = 128;  // B3: threads of a CTA, each owning a run of positions
constexpr int kBpsMaxRun = 16;    // B3: positions of a run, at most
constexpr int kBpsMaxRunGen = 8;  // B3: the same on a general alphabet
constexpr int kBpsChunk = 4;      // B3: angles per pass over the tile
constexpr int kBpsMinCtas = 256;  // B3: runs shrink until the grid has this many CTAs
constexpr int kBpsFullWindow = 4; // B3, B8: windows of at most this many samples are not slid
constexpr int kFineMaxRun = 8;    // B8: positions of a run, at most
constexpr int kFineMaxRunGen = 8; // B8: the same on a general alphabet
constexpr int kFineMaxRunNarrow = 4;   // B8: the same with slots of one offset
constexpr int kBfMaxRun = 8;      // B3 with bf16 windows: windows of a thread, at most
constexpr int kBfFineMaxRun = 8;  // B8 with bf16 windows: the same (B8's)
constexpr int kBfClass = 8;       // bf16 windows: the residue classes a tile is walked in
constexpr int kBfLookback = 128;  // bf16 windows: the previous tile's columns a tail reads
// B3's and B8's window type (template BF): float32, or bf16 with a top level of at most 32
// (2N < 64: the walks' levels above 8 take few registers) or of 64 or 128
constexpr int kF32 = 0, kBfShort = 1, kBfLong = 2;
constexpr long long kSmemLimit = 227 * 1024;   // shared memory a CTA can have
constexpr int kRotThreads = 256;
constexpr long long kStaticSmem = 48 * 1024;   // shared memory a CTA has without opting in
constexpr int kCpeThreads = 512;  // B5: threads of a CTA, one CTA per row
constexpr int kCpeItems = 4;      // B5: consecutive pilots (and blocks) per thread: a float4
constexpr int kCpeTile = kCpeItems * kCpeThreads;   // B5: pilots per pass over the row
static_assert(kCpeItems == 4, "B5 moves a thread's pilots and phases as one float4");
constexpr int kUnwrapThreads = 512;
constexpr int kUnwrapItems = 4;   // B7: consecutive samples per thread, a multiple of 4
constexpr int kUnwrapTile = kUnwrapItems * kUnwrapThreads;
constexpr unsigned long long kUnwrapAggregate = 1ull << 32;   // B7 status flags, above the value
constexpr unsigned long long kUnwrapInclusive = 2ull << 32;
constexpr int kSlopeThreads = 256;
constexpr int kSlopeItems = 8;    // B10: consecutive decimated samples per thread, a multiple of 4
constexpr int kSlopeTile = kSlopeItems * kSlopeThreads;

// Exclusive prefix sum of v over the block's threads (blockDim.x a multiple
// of 32); *total, if given, receives the block's sum. Every thread of the
// block must call it; warp_sum is 32 ints of shared memory, free again on return.
__device__ int block_exclusive_scan(int v, int* warp_sum, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < nwarps ? warp_sum[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += t;
        }
        warp_sum[lane] = w;
    }
    __syncthreads();
    const int before = incl - v + (warp > 0 ? warp_sum[warp - 1] : 0);
    if (total) *total = warp_sum[nwarps - 1];
    __syncthreads();
    return before;
}

// u - clamp(r, lo, hi), r = floor(u + 0.5): the offset from the nearest level in [lo, hi]
__device__ __forceinline__ float level_offset(float u, float r, float lo, float hi) {
    return __fsub_rn(u, fminf(fmaxf(r, lo), hi));
}

// Distance of the rotated sample (xr, xi), pre-scaled by the tables, to the
// nearest point: the four forms of the reference's _make_dist_fn, with every
// product and sum rounded on its own in the plain version's order. kRect and
// kCross give the squared distance in units of d0^2; kGen gives
// -max_k(2<z, s_k> - |s_k|^2), the squared distance less |z|^2, which no
// angle changes.
template <int KIND>
__device__ __forceinline__ float grid_dist(float xr, float xi, const GridArgs& g,
                                           const float* __restrict__ pts) {
    if (KIND == kGen) {
        float best = -INFINITY;
        for (int k = 0; k < g.npts; ++k) {
            const float t = __fsub_rn(__fadd_rn(__fmul_rn(xr, pts[3 * k]),
                                                __fmul_rn(xi, pts[3 * k + 1])), pts[3 * k + 2]);
            best = fmaxf(best, t);
        }
        return -best;
    }
    if (KIND == kRect) {
        const float ur = __fsub_rn(xr, g.g0), ui = __fsub_rn(xi, g.g1);
        const float fr = level_offset(ur, floorf(__fadd_rn(ur, 0.5f)), 0.f, g.g2);
        const float fi = level_offset(ui, floorf(__fadd_rn(ui, 0.5f)), 0.f, g.g3);
        return __fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi));
    }
    // the cross is the union of two rectangles: the closer of the two clamps
    const float nm1 = g.g2, c = g.g3, cm = g.g2 - g.g3;   // small whole numbers: exact
    const float ur = __fsub_rn(xr, g.g0), ui = __fsub_rn(xi, g.g1);
    const float rx = floorf(__fadd_rn(ur, 0.5f)), ry = floorf(__fadd_rn(ui, 0.5f));
    const float far = level_offset(ur, rx, 0.f, nm1), fai = level_offset(ui, ry, c, cm);
    const float fbr = level_offset(ur, rx, c, cm), fbi = level_offset(ui, ry, 0.f, nm1);
    return fminf(__fadd_rn(__fmul_rn(far, far), __fmul_rn(fai, fai)),
                 __fadd_rn(__fmul_rn(fbr, fbr), __fmul_rn(fbi, fbi)));
}

// A general alphabet's (npts, 3) table into shared memory as float4 [2 re, 2 im, |s|^2, 0]
__device__ __forceinline__ void stage_points(float4* dst, const float* __restrict__ src, int npts) {
    for (int k = threadIdx.x; k < npts; k += blockDim.x)
        dst[k] = make_float4(src[3 * k], src[3 * k + 1], src[3 * k + 2], 0.f);
}

// B3: the place of staged sample or tile position u in the padded table, one
// slot of padding every run of 2^sh (sh = 31 for runs of one: no padding), so
// that lanes whose runs start R slots apart fall on distinct banks.
__device__ __forceinline__ int bps_pad(int u, int sh) { return u + (u >> sh); }

// B3, B8: one slot of the distance table, a sample's distances at the chunk's C angles
template <int C>
struct alignas(sizeof(float) * C >= 16 ? 16 : sizeof(float) * C) Slot {
    float v[C];
};
using BpsSlot = Slot<kBpsChunk>;

// One slot of a bf16 table: the chunk's 4 angles as two packed pairs
struct alignas(8) BfSlot {
    __nv_bfloat162 v[2];
};
static_assert(kBpsChunk == 4, "a bf16 slot holds 4 angles");

__device__ __forceinline__ BfSlot bf_round(const float (&d)[kBpsChunk]) {
    BfSlot b;
    b.v[0] = __floats2bfloat162_rn(d[0], d[1]);
    b.v[1] = __floats2bfloat162_rn(d[2], d[3]);
    return b;
}

__device__ __forceinline__ BfSlot bf_zero() {
    BfSlot z;
    z.v[0] = z.v[1] = __float2bfloat162_rn(0.f);
    return z;
}

// (A BfSlot is chosen by if, never by ?:, which selects an aggregate through local memory.)
__device__ __forceinline__ BfSlot bf_add(BfSlot a, const BfSlot& b) {
    a.v[0] = __hadd2(a.v[0], b.v[0]);
    a.v[1] = __hadd2(a.v[1], b.v[1]);
    return a;
}


// B3's launch: R positions per thread, a tile of T = kBpsThreads R positions
// per CTA, kBpsChunk angles per pass, the CTA's shared-memory bytes (the gen
// table as float4, the padded table of BpsSlot, the staged samples as
// float2, in that order, each aligned) and the CTAs of the grid.
// ops/phase_cuda.py bps_plan is the same rule.
struct BpsPlan {
    long long run, tile, chunk, smem, ctas;
};

// The longest run, from max_run down, at which the grid still has kBpsMinCtas CTAs
long long bps_run(int nmodes, long long L, int max_run) {
    long long run = max_run;
    while (run > 1 && nmodes * ((L + kBpsThreads * run - 1) / (kBpsThreads * run)) < kBpsMinCtas)
        run /= 2;
    return run;
}

// Slots of a table of W staged samples padded for runs of `run`
long long bps_slots(long long W, long long run) {
    return run > 1 ? W + ((W - 1) >> __builtin_ctzll(run)) : W;
}

BpsPlan bps_plan(int nmodes, long long L, int N, int npts) {
    BpsPlan p;
    p.run = bps_run(nmodes, L, npts > 0 ? kBpsMaxRunGen : kBpsMaxRun);
    p.tile = kBpsThreads * p.run;
    p.chunk = kBpsChunk;
    const long long W = p.tile + 2LL * N - 1;
    p.smem = 16LL * npts + 8 * W + (long long)sizeof(BpsSlot) * bps_slots(W, p.run);
    p.ctas = nmodes * ((L + p.tile - 1) / p.tile);
    return p;
}

// B8's launch (ops/phase_cuda.py fine_plan is the same rule): B3's run rule
// from kFineMaxRun (kFineMaxRunGen on a general alphabet), halved while the
// CTA would not fit kSmemLimit: the gen table as float4, the padded table of
// kBpsChunk-offset slots and the staged samples as float4 [x, y, cos, sin].
// Where no run fits, slots of one offset (chunk 1) over max(W, tile)
// samples, nothing else staged, from runs of at most kFineMaxRunNarrow.
long long fine_smem(long long run, long long chunk, int N, int npts) {
    const long long tile = kBpsThreads * run, W = tile + 2LL * N - 1;
    if (chunk == 1) return 4 * bps_slots(W > tile ? W : tile, run);
    return 16LL * npts + 16 * W + (long long)sizeof(BpsSlot) * bps_slots(W, run);
}

BpsPlan fine_plan(int nmodes, long long L, int N, int npts) {
    BpsPlan p;
    const long long first = bps_run(nmodes, L, npts > 0 ? kFineMaxRunGen : kFineMaxRun);
    for (p.chunk = kBpsChunk;; p.chunk = 1) {
        for (p.run = p.chunk > 1 || first < kFineMaxRunNarrow ? first : kFineMaxRunNarrow;;
             p.run /= 2) {
            p.smem = fine_smem(p.run, p.chunk, N, npts);
            if (p.smem <= kSmemLimit || p.run == 1) break;
        }
        if (p.smem <= kSmemLimit || p.chunk == 1) break;
    }
    p.tile = kBpsThreads * p.run;
    p.ctas = nmodes * ((L + p.tile - 1) / p.tile);
    return p;
}

// The launch of B3 or B8 with bf16 windows at reference tile T (ops/phase_cuda.py bf16_plan is
// the same rule): runs from kBfMaxRun (B8: kBfFineMaxRun) down by B3's rule, then halved while
// the CTA would not fit kSmemLimit: the gen table as float4, the staged samples (float2 in B3,
// float4 in B8), the chunk's distances, S_g and each component of 2N below g (W slots of 8
// bytes each), and per reference-tile boundary that the CTA's windows cross the tail's 128
// distances and its 2N slots (bf_tile).

// The tables the walks read: S_g, and one per component of 2N below g = min(8, top)
long long bf_tables(int N) {
    const int N2 = 2 * N, top = 1 << (31 - __builtin_clz(N2)), g = top < kBfClass ? top : kBfClass;
    return 1 + __builtin_popcount(N2 & (g - 1));
}

long long bf_bounds(long long tile, int N, int T) { return (tile + 2LL * N - 2) / T + 1; }

long long bf_smem(long long run, int N, int npts, int T, bool fine) {
    const long long tile = kBpsThreads * run, W = tile + 2LL * N - 1;
    return 16LL * npts + (fine ? 16 : 8) * W + 8 * W + 8 * bf_tables(N) * W +
           8 * (kBfLookback + 2LL * N) * bf_bounds(tile, N, T);
}

BpsPlan bf_plan(int nmodes, long long L, int N, int npts, int T, bool fine) {
    BpsPlan p;
    for (p.run = bps_run(nmodes, L, fine ? kBfFineMaxRun : kBfMaxRun);; p.run /= 2) {
        p.smem = bf_smem(p.run, N, npts, T, fine);
        if (p.smem <= kSmemLimit || p.run == 1) break;
    }
    p.tile = kBpsThreads * p.run;
    p.chunk = kBpsChunk;
    p.ctas = nmodes * ((L + p.tile - 1) / p.tile);
    return p;
}

// Whether a bf16 window launch takes (N, T): the reference's _windowed_sums needs
// 2N <= 128 (its tails come from one lane tile), 2N < T, and T a multiple of 128.
bool bf_takes(int N, int T) { return N >= 1 && 2 * N <= kBfLookback && 2 * N < T && T % 128 == 0; }

// A general alphabet's distances of one sample at the chunk's C
// rotations, in grid_dist<kGen>'s arithmetic: each float4 point, loaded once,
// serves every angle.
template <int C>
__device__ __forceinline__ void gen_dists(const float (&xr)[C], const float (&xi)[C],
                                          const float4* pts, int npts, float (&d)[C]) {
    float best[C];
#pragma unroll
    for (int k = 0; k < C; ++k) best[k] = -INFINITY;
    for (int p = 0; p < npts; ++p) {
        const float4 q = pts[p];
#pragma unroll
        for (int k = 0; k < C; ++k)
            best[k] = fmaxf(best[k], __fsub_rn(__fadd_rn(__fmul_rn(xr[k], q.x),
                                                         __fmul_rn(xi[k], q.y)), q.z));
    }
#pragma unroll
    for (int k = 0; k < C; ++k) d[k] = -best[k];
}

// The distances of sample (x, y) rotated by the chunk's C pre-scaled angles
// (c[k], s[k]): the points from the float4 table pts in shared memory where
// C > 1, else from the (npts, 3) table pts_g where it lies.
template <int KIND, int C>
__device__ __forceinline__ void chunk_dists(float x, float y, const float (&c)[C],
                                            const float (&s)[C], const GridArgs& g,
                                            const float4* pts, const float* __restrict__ pts_g,
                                            float (&d)[C]) {
    float xr[C], xi[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        xr[k] = __fsub_rn(__fmul_rn(x, c[k]), __fmul_rn(y, s[k]));
        xi[k] = __fadd_rn(__fmul_rn(x, s[k]), __fmul_rn(y, c[k]));
    }
    if constexpr (KIND == kGen && C > 1) {
        gen_dists(xr, xi, pts, g.npts, d);
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k) d[k] = grid_dist<KIND>(xr[k], xi[k], g, pts_g);
    }
}

// The distance table of one chunk (angles ct[k], st[k] for k < na) for all W
// staged samples: a thread takes one sample at a time and all its rotations,
// and stores them as one slot.
template <int KIND, class TabSlot>
__device__ __forceinline__ void bps_fill(const float2* xs, int W, int sh,
                                         const float* __restrict__ ct,
                                         const float* __restrict__ st, int na, const GridArgs& g,
                                         const float4* pts, TabSlot* tab) {
    float c[kBpsChunk], s[kBpsChunk];
#pragma unroll
    for (int k = 0; k < kBpsChunk; ++k) {
        c[k] = k < na ? ct[k] : 0.f;
        s[k] = k < na ? st[k] : 0.f;
    }
    constexpr int kUnroll = KIND == kGen ? 1 : 2;   // a point loop is long enough alone
#pragma unroll kUnroll
    for (int u = threadIdx.x; u < W; u += kBpsThreads) {
        const float2 z = xs[u];
        BpsSlot d;
        chunk_dists<KIND>(z.x, z.y, c, s, g, pts, nullptr, d.v);
        if constexpr (sizeof(TabSlot) == sizeof(BpsSlot))
            tab[bps_pad(u, sh)] = d;
        else
            tab[bps_pad(u, sh)] = bf_round(d.v);   // bf16 windows: the distances rounded
    }
}

// The window sums of the thread's run (positions p0 .. p0+run-1 of the tile,
// run <= R) at the chunk's angles a0 + k, k < na, into the run's best sums and
// indices. The first window is summed in full, the next ones slide; windows of
// at most kBpsFullWindow samples are each summed in full (as cheap, and a
// slide's rounding, up to an ulp of the largest value slid through, would
// outgrow such a window's own).
template <int R, int C>
__device__ __forceinline__ void bps_run_sums(const Slot<C>* tab, int sh, int p0, int run, int N2,
                                             int a0, int na, float (&bs)[R], int (&bi)[R]) {
    float s[C];
#pragma unroll
    for (int k = 0; k < C; ++k) s[k] = 0.f;
    for (int n = 0; n < N2; ++n) {
        const Slot<C> e = tab[bps_pad(p0 + n, sh)];
#pragma unroll
        for (int k = 0; k < C; ++k) s[k] += e.v[k];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r == run) break;
        if (r > 0 && N2 <= kBpsFullWindow) {
#pragma unroll
            for (int k = 0; k < C; ++k) s[k] = 0.f;
            for (int n = 0; n < N2; ++n) {
                const Slot<C> e = tab[bps_pad(p0 + r + n, sh)];
#pragma unroll
                for (int k = 0; k < C; ++k) s[k] += e.v[k];
            }
        } else if (r > 0) {
            const Slot<C> e = tab[bps_pad(p0 + r - 1 + N2, sh)], l = tab[bps_pad(p0 + r - 1, sh)];
#pragma unroll
            for (int k = 0; k < C; ++k) s[k] += e.v[k] - l.v[k];
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (k < na && s[k] < bs[r]) {
                bs[r] = s[k];
                bi[r] = a0 + k;
            }
        }
    }
}

// The tile's indices (its run's best, 0 outside [N, L-N)) into shared memory
// at `table`, padded as the slots, for coalesced stores; all threads.
template <int R>
__device__ __forceinline__ const int* bps_tile_indices(void* table, int sh, int p0, int run,
                                                       long long j0, long long L, int N,
                                                       const int (&bi)[R]) {
    __syncthreads();   // every run's sums are done with the table
    int* idx = reinterpret_cast<int*>(table);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r == run) break;
        const long long j = j0 + p0 + r;
        idx[bps_pad(p0 + r, sh)] = j >= N && j < L - N ? bi[r] : 0;
    }
    __syncthreads();
    return idx;
}

// ---- bf16 windows (B3 and B8 with a bf16 tile T) ----------------------------------
//
// The reference's _windowed_sums with win_dtype=bf16 (phase_pallas.py:39-80), in its
// order: the row is cut into tiles of T columns; each distance is rounded to bf16; the
// power-of-two running sums S_2w[c] = S_w[c] + S_w[c - w] (S_w[c - w] = 0 where c < w in
// the tile) are built by doubling, every add rounded to bf16; the window ending at column c
// is S_w1[c] + S_w2[c - w1] + S_w3[c - w1 - w2] + ..., the binary components w1 > w2 > ...
// of 2N largest first, a term 0 where its column falls before the tile; the first 2N
// columns then add the previous tile's tail, tail[c] = C[127] - C[128 - 2N + c], C the
// doubling prefix sums of that tile's last 128 distances (0 for the first tile). A slot
// holds a sample's 4 values as two packed pairs: every add is one __hadd2 for two angles.
//
// The design: with top the largest power of two in 2N and g = min(8, top), every term that a
// level above g or a component of at least g reads, S_w[c - o] with w and o multiples of g,
// lies in the residue class of c mod g. Per chunk: the fill rounds the distances into a table
// (and one distance a thread of each tail's 128 samples); after a barrier each thread builds
// S_2, S_4, S_8 in registers over run + 1 consecutive slots and the 7 before them (bf_build:
// the CTA's W slots in one pass, every thread busy) and stores S_g and the components of 2N
// below g, while a warp per crossed reference-tile boundary forms its tail by shuffles; after
// a second barrier each thread walks one residue class over its run of windows (bf_walk): the
// levels above g and the components of at least g come from registers, S_g and the rest from
// the tables. A reference tile starts at a multiple of 128 columns, so it starts step 0 of
// every class: the zero-fill before a tile is a level's predicate on the step, m >= w / 8.

__device__ __forceinline__ BfSlot bf_shfl_up(BfSlot a, int d) {
    BfSlot b;
    b.v[0] = __shfl_up_sync(0xffffffffu, a.v[0], d, 32);
    b.v[1] = __shfl_up_sync(0xffffffffu, a.v[1], d, 32);
    return b;
}

__device__ __forceinline__ BfSlot bf_shfl(BfSlot a, int lane) {
    BfSlot b;
    b.v[0] = __shfl_sync(0xffffffffu, a.v[0], lane, 32);
    b.v[1] = __shfl_sync(0xffffffffu, a.v[1], lane, 32);
    return b;
}

// A tail of the reference tile that begins at b, from the distances c[q] (bf16) of samples
// b - 128 + 4 lane + q at the chunk's angles, one warp: out[k] = C[127] - C[128 - N2 + k] for
// k < N2, C the doubling prefix C[i] += C[i - sh] (sh = 1 .. 64), in registers and shuffles.
__device__ __forceinline__ void bf_tail(BfSlot (&c)[4], BfSlot* out, int N2) {
    const int lane = threadIdx.x & 31;
    {   // sh = 1 and 2 within the lane's 4 columns (and the lane before)
        const BfSlot p3 = bf_shfl_up(c[3], 1);
        BfSlot n[4] = {c[0], bf_add(c[1], c[0]), bf_add(c[2], c[1]), bf_add(c[3], c[2])};
        if (lane > 0) n[0] = bf_add(c[0], p3);
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = n[q];
    }
    {
        const BfSlot p2 = bf_shfl_up(c[2], 1), p3 = bf_shfl_up(c[3], 1);
        BfSlot n[4] = {c[0], c[1], bf_add(c[2], c[0]), bf_add(c[3], c[1])};
        if (lane > 0) {
            n[0] = bf_add(c[0], p2);
            n[1] = bf_add(c[1], p3);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = n[q];
    }
#pragma unroll
    for (int dl = 1; dl < 32; dl *= 2) {   // sh = 4 dl
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const BfSlot p = bf_shfl_up(c[q], dl);
            if (lane >= dl) c[q] = bf_add(c[q], p);
        }
    }
    const BfSlot total = bf_shfl(c[3], 31);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int k = 4 * lane + q - (kBfLookback - N2);
        if (k >= 0) {
            BfSlot t;
            t.v[0] = __hsub2(total.v[0], c[q].v[0]);
            t.v[1] = __hsub2(total.v[1], c[q].v[1]);
            out[k] = t;
        }
    }
}

// The first reference-tile start b >= T whose tail a window ending in [e0, ...) may need:
// the least multiple of T above e0 - N2, at least T.
__device__ __forceinline__ long long bf_first_bound(long long e0, int N2, int T) {
    const long long lo = e0 - N2 + 1;
    const long long b = lo <= 0 ? T : (lo + T - 1) / T * T;
    return b < T ? T : b;
}

// A CTA's bf16 tables after its staged samples (bf_smem): the chunk's distances (W slots),
// S_g and each component of 2N below g (W slots each), the tails' distances (128 a boundary) and
// the tails (N2 a boundary), for the nb reference-tile boundaries from b_lo whose first N2
// columns hold some of the CTA's window ends.
struct BfTile {
    BfSlot *d, *sg, *c4, *c2, *tdist, *tails;   // c4, c2: S_g's table where 2N lacks them
    int W, N2, T, J, col0, nb;
    bool has_c4, has_c2;
    long long b_lo;
};

__device__ __forceinline__ BfTile bf_tile(void* at, int N, int T, int run, long long j0) {
    BfTile t;
    const int N2 = 2 * N, tile = kBpsThreads * run, top = 1 << (31 - __clz(N2));
    const int g = top < kBfClass ? top : kBfClass;
    t.W = tile + N2 - 1;
    t.N2 = N2;
    t.T = T;
    t.J = 31 - __clz(top / g);
    t.d = reinterpret_cast<BfSlot*>(at);
    t.sg = t.d + t.W;
    BfSlot* next = t.sg + t.W;
    t.has_c4 = g == 8 && (N2 & 4);
    t.c4 = t.has_c4 ? next : t.sg;
    if (t.has_c4) next += t.W;
    t.has_c2 = g >= 4 && (N2 & 2);
    t.c2 = t.has_c2 ? next : t.sg;
    if (t.has_c2) next += t.W;
    t.b_lo = bf_first_bound(j0 + N, N2, T);
    const long long hi = j0 + tile + N;   // past the CTA's last window end
    t.nb = t.b_lo < hi ? (int)((hi - t.b_lo + T - 1) / T) : 0;
    t.tdist = next;
    t.tails = next + kBfLookback * t.nb;
    const long long s0 = j0 - N + 1;      // the sample of staged slot 0
    t.col0 = (int)((s0 % T + T) % T);
    return t;
}

// The sample of tail distance v (< 128 nb): b_lo + (v / 128) T - 128 + v % 128
__device__ __forceinline__ long long bf_tail_sample(const BfTile& t, int v) {
    return t.b_lo + (long long)(v / kBfLookback) * t.T - kBfLookback + v % kBfLookback;
}

// A thread's walk: tile positions p0 + 8 k (k < run) of residue class p0 % 8, p0 = 8 run q + i
// for thread i + 8 q; window k ends at staged slot ue0 + 8 k, row sample e0 + 8 k, column
// c0 + 8 k of the reference tile whose tails are row tr0 (that tile's) or tr0 + 1 (the next).
struct BfWalk {
    int p0, ue0, c0;
    long long e0, tr0;
};

__device__ __forceinline__ BfWalk bf_walk_start(const BfTile& t, long long j0, int run, int N) {
    BfWalk w;
    w.p0 = kBfClass * run * (threadIdx.x / kBfClass) + threadIdx.x % kBfClass;
    w.ue0 = w.p0 + t.N2 - 1;
    w.e0 = j0 + w.p0 + N;
    w.c0 = (int)(w.e0 % t.T);
    const long long b = w.e0 - w.c0;   // below b_lo, the next tile's row is 0
    w.tr0 = b >= t.b_lo ? (b - t.b_lo) / t.T : -1;
    return w;
}

// S_2, S_4, S_8 (up to g) of the thread's G consecutive slots u0 = G threadIdx.x .. u0 + G - 1,
// streamed over those and the 7 slots before them: at step i (slot u0 - 7 + i, its column c)
// S_2 = d + d[-1], S_4 = S_2 + S_2[-2], S_8 = S_4 + S_4[-4], each term 0 where c is below its
// shift; S_g and the components of 2N below g go to their tables from step 7 on. The 7 values
// a later step reads pass down scalars (renamed away once unrolled; an array indexed by a
// value chosen at run time would go to local memory). G = run + 1 covers the W = 128 run +
// 2N - 1 slots.
template <int G>
__device__ __forceinline__ void bf_build(const BfTile& t) {
    int u0 = G * threadIdx.x;
    asm volatile("" : "+r"(u0));   // recomputed in every chunk (bf_chunk)
    const int W = t.W, T = t.T;
    const int top = 1 << (31 - __clz(t.N2)), g = top < kBfClass ? top : kBfClass;
    int c = (t.col0 + u0 - (kBfClass - 1)) % T;   // the column of slot u0 - 7
    if (c < 0) c += T;
    BfSlot d1 = bf_zero(), s2_1 = d1, s2_2 = d1, s4_1 = d1, s4_2 = d1, s4_3 = d1, s4_4 = d1;
#pragma unroll
    for (int i = 0; i < G + kBfClass - 1; ++i) {
        const int u = u0 + i - (kBfClass - 1);
        BfSlot d = bf_zero();
        if (u >= 0 && u < W) d = t.d[u];
        BfSlot s2 = d, s4, s8;
        if (c >= 1) s2 = bf_add(s2, d1);
        s4 = s2;
        if (c >= 2) s4 = bf_add(s4, s2_2);
        if (i >= kBfClass - 1 && u < W) {
            s8 = s4;
            if (c >= 4) s8 = bf_add(s8, s4_4);
            if (g == 2)
                t.sg[u] = s2;
            else if (g == 4)
                t.sg[u] = s4;
            else
                t.sg[u] = s8;
            if (t.has_c4) t.c4[u] = s4;
            if (t.has_c2) t.c2[u] = s2;
        }
        d1 = d;
        s2_2 = s2_1;
        s2_1 = s2;
        s4_4 = s4_3;
        s4_3 = s4_2;
        s4_2 = s4_1;
        s4_1 = s4;
        c = c + 1 == T ? 0 : c + 1;
    }
}

// Walk steps before a thread's first window at J = log2(top / g): the history its levels above
// g (L_j[k] = L_{j-1}[k] + L_{j-1}[k - 2^(j-1)], L_0 = S_g) and components of at least g read.
__host__ __device__ constexpr int bf_warmup(int J) {
    return J == 0 ? 0 : J == 1 ? 1 : J == 2 ? 5 : J == 3 ? 13 : 15;
}

// The bf16 windows of the thread's run (BfWalk) at the chunk's angles a0 + k, k < na, into
// the run's best sums and indices (float32 compare, strict <: the first minimum wins). Step s
// of the walk is window k = s - H (H = bf_warmup(J) steps of history first); lv[j][s] is level
// 8 2^j at step s, in registers: every index is static once the loop is unrolled, O16 too (the
// steps back to component 16 at J = 3, 12 where 2N has 32, else 8), since an index chosen at
// run time would put lv in local memory.
template <int J, int O16, int R>
__device__ __forceinline__ void bf_walk(const BfTile& t, const BfWalk& w, int run, int a0,
                                        int na, float (&bs)[R], int (&bi)[R]) {
    constexpr int H = bf_warmup(J);
    const int N2 = t.N2, T = t.T;
    BfSlot lv[J + 1][H + R];
#pragma unroll
    for (int s = 0; s < H + R; ++s) {
        const int k = s - H;
        if (k >= run) break;
        const int u = w.ue0 + kBfClass * k;
        int c = w.c0 + kBfClass * k;
        c = c < 0 ? c + T : c >= T ? c - T : c;
        const int m = c / kBfClass;   // the step of the class in its reference tile
        lv[0][s] = t.sg[u > 0 ? u : 0];
#pragma unroll
        for (int j = 1; j <= J; ++j) {
            const int h = 1 << (j - 1);
            lv[j][s] = lv[j - 1][s];
            if (s >= h && m >= h) lv[j][s] = bf_add(lv[j][s], lv[j - 1][s >= h ? s - h : 0]);
        }
        if (s < H) continue;   // warm-up
        BfSlot acc = lv[J][s];
        // the components of 2N below top, largest first; offsets in steps of 8 columns
        if constexpr (J == 3) {
            if ((N2 & 32) && m >= 8) acc = bf_add(acc, lv[2][s >= 8 ? s - 8 : 0]);
            if ((N2 & 16) && m >= O16) acc = bf_add(acc, lv[1][s >= O16 ? s - O16 : 0]);
        } else if constexpr (J == 2) {
            if ((N2 & 16) && m >= 4) acc = bf_add(acc, lv[1][s >= 4 ? s - 4 : 0]);
        }
        if (J >= 1 && (N2 & 8) && c >= (N2 & ~15))
            acc = bf_add(acc, t.sg[u - (N2 & ~15)]);
        if (t.has_c4 && c >= (N2 & ~7)) acc = bf_add(acc, t.c4[u - (N2 & ~7)]);
        if (t.has_c2 && c >= (N2 & ~3)) acc = bf_add(acc, t.c2[u - (N2 & ~3)]);
        if (c < N2 && w.e0 + kBfClass * k >= T)
            acc = bf_add(acc, t.tails[(w.tr0 + (w.c0 + kBfClass * k >= T)) * N2 + c]);
        const float v[kBpsChunk] = {__low2float(acc.v[0]), __high2float(acc.v[0]),
                                    __low2float(acc.v[1]), __high2float(acc.v[1])};
#pragma unroll
        for (int a = 0; a < kBpsChunk; ++a) {
            if (a < na && v[a] < bs[k]) {
                bs[k] = v[a];
                bi[k] = a0 + a;
            }
        }
    }
}

// One chunk's window sums after its fill (the distances in t.d, the tails' in t.tdist), all
// threads: a barrier, the build and the tails, a barrier, the walk. The next chunk's fill
// writes only t.d and t.tdist, which no walk reads, so it needs no barrier before it.
template <int BF, int R>
__device__ __forceinline__ void bf_chunk(const BfTile& t, const BfWalk& w, int run, int a0,
                                         int na, float (&bs)[R], int (&bi)[R]) {
    __syncthreads();   // the distances are written, and every walk of the previous chunk done
    // the walk's and the build's index arithmetic is the same in every chunk: recomputed per
    // chunk from bases the compiler cannot see through, or hoisting it would hold a register
    // per address for the whole kernel
    BfTile tc = t;
    BfWalk wc = w;
    asm volatile("" : "+r"(tc.col0), "+r"(wc.ue0), "+r"(wc.c0), "+l"(wc.e0), "+l"(wc.tr0));
    switch (run) {
        case 1: bf_build<2>(tc); break;
        case 2: bf_build<3>(tc); break;
        case 4: bf_build<5>(tc); break;
        case 8: bf_build<9>(tc); break;
        case 16: if constexpr (R >= 16) bf_build<17>(tc); break;
    }
    for (int i = threadIdx.x >> 5; i < t.nb; i += kBpsThreads / 32) {
        BfSlot c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) c[q] = t.tdist[i * kBfLookback + 4 * (threadIdx.x & 31) + q];
        bf_tail(c, t.tails + i * t.N2, t.N2);
    }
    __syncthreads();   // S_g, the components and the tails are written
    if constexpr (BF == kBfShort) {
        switch (t.J) {
            case 0: bf_walk<0, 0>(tc, wc, run, a0, na, bs, bi); break;
            case 1: bf_walk<1, 0>(tc, wc, run, a0, na, bs, bi); break;
            default: bf_walk<2, 0>(tc, wc, run, a0, na, bs, bi); break;
        }
    } else if (t.J == 4) {
        bf_walk<4, 0>(tc, wc, run, a0, na, bs, bi);
    } else if (t.N2 & 32) {
        bf_walk<3, 12>(tc, wc, run, a0, na, bs, bi);
    } else {
        bf_walk<3, 8>(tc, wc, run, a0, na, bs, bi);
    }
}

// The tile's indices (the run's best, 0 outside [N, L-N)) into shared memory over the
// distance table, which no walk reads; a barrier, then every thread may read them.
template <int R>
__device__ __forceinline__ const int* bf_tile_indices(const BfTile& t, const BfWalk& w, int run,
                                                      long long j0, long long L, int N,
                                                      const int (&bi)[R]) {
    int* idx = reinterpret_cast<int*>(t.d);
#pragma unroll
    for (int k = 0; k < R; ++k) {
        if (k == run) break;
        const int p = w.p0 + kBfClass * k;
        const long long j = j0 + p;
        idx[p] = j >= N && j < L - N ? bi[k] : 0;
    }
    __syncthreads();
    return idx;
}

template <int KIND, int BF>
__device__ __forceinline__ void
    bps_search(const float* __restrict__ er, const float* __restrict__ ei, long long L,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int A, int N,
               const GridArgs& g, const float* __restrict__ pts_g, int run, int T,
               int* __restrict__ out) {
    extern __shared__ float4 bps_sm[];
    const int N2 = 2 * N, tile = kBpsThreads * run, W = tile + N2 - 1;
    const int sh = run > 1 ? __ffs(run) - 1 : 31;
    const int ts = bps_pad(W - 1, sh) + 1;                   // slots of the float32 table
    float4* pts = bps_sm;                                     // (npts,), kGen only
    // float32 windows: the slot table, then the samples; bf16 windows (T > 0): the samples,
    // then the bf16 tables (bf_tile)
    BpsSlot* tab = reinterpret_cast<BpsSlot*>(pts + g.npts);  // (ts,)
    float2* xs = BF != kF32 ? reinterpret_cast<float2*>(pts + g.npts)
                    : reinterpret_cast<float2*>(tab + ts);    // (W,) samples
    const long long row = (long long)blockIdx.y * L;
    const long long j0 = (long long)blockIdx.x * tile;
    const long long s0 = j0 - N + 1;  // staged sample u is sample s0 + u of the row

    if constexpr (KIND == kGen) stage_points(pts, pts_g, g.npts);
    for (int u = threadIdx.x; u < W; u += kBpsThreads) {
        const long long s = s0 + u;
        const bool in = s >= 0 && s < L;
        xs[u] = make_float2(in ? er[row + s] : 0.f, in ? ei[row + s] : 0.f);
    }
    constexpr int R = BF != kF32 ? kBfMaxRun : KIND == kGen ? kBpsMaxRunGen : kBpsMaxRun;
    float bs[R];   // the run's best sums and indices in registers
    int bi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        bs[r] = INFINITY;
        bi[r] = 0;
    }
    if constexpr (BF != kF32) {
        const BfTile bt = bf_tile(xs + W, N, T, run, j0);
        const BfWalk w = bf_walk_start(bt, j0, run, N);
        __syncthreads();  // the samples are staged
        for (int a0 = 0; a0 < A; a0 += kBpsChunk) {
            const int na = min(kBpsChunk, A - a0);
            bps_fill<KIND>(xs, W, 31, cos_t + a0, sin_t + a0, na, g, pts, bt.d);
            // one distance a thread of each tail's samples, with the fill's arithmetic
            float c[kBpsChunk], s[kBpsChunk];
#pragma unroll
            for (int k = 0; k < kBpsChunk; ++k) {
                c[k] = k < na ? cos_t[a0 + k] : 0.f;
                s[k] = k < na ? sin_t[a0 + k] : 0.f;
            }
            for (int v = threadIdx.x; v < kBfLookback * bt.nb; v += kBpsThreads) {
                const long long x = bf_tail_sample(bt, v);
                BpsSlot d;
                chunk_dists<KIND>(x < L ? er[row + x] : 0.f, x < L ? ei[row + x] : 0.f, c, s, g,
                                  pts, nullptr, d.v);
                bt.tdist[v] = bf_round(d.v);
            }
            bf_chunk<BF>(bt, w, run, a0, na, bs, bi);
        }
        const int* idx = bf_tile_indices(bt, w, run, j0, L, N, bi);
        for (int p = threadIdx.x; p < tile; p += kBpsThreads) {
            const long long j = j0 + p;
            if (j < L) out[row + j] = idx[p];
        }
        return;
    }
    const int p0 = threadIdx.x * run;
    for (int a0 = 0; a0 < A; a0 += kBpsChunk) {
        const int na = min(kBpsChunk, A - a0);
        __syncthreads();  // the samples are staged, the previous chunk's sums are done
        bps_fill<KIND>(xs, W, sh, cos_t + a0, sin_t + a0, na, g, pts, tab);
        __syncthreads();
        bps_run_sums(tab, sh, p0, run, N2, a0, na, bs, bi);
    }
    const int* idx = bps_tile_indices(tab, sh, p0, run, j0, L, N, bi);
    for (int p = threadIdx.x; p < tile; p += kBpsThreads) {
        const long long j = j0 + p;
        if (j < L) out[row + j] = idx[bps_pad(p, sh)];
    }
}

// B8: B3's search with a per-sample angle. C: offsets per slot, kBpsChunk
// with the samples (float4 [x, y, cos ph1, sin ph1]) and a general
// alphabet's points staged, or 1 with nothing staged (fine_plan). BF: bf16
// windows at reference tile T (C = kBpsChunk; B3's bf16 tables after the float4 samples).
template <int KIND, int C, int BF>
__device__ __forceinline__ void
    bps_fine_search(const float* __restrict__ er, const float* __restrict__ ei,
                    const float* __restrict__ ph1, long long L, const float* __restrict__ cd,
                    const float* __restrict__ sd, int B, int N, const GridArgs& g,
                    const float* __restrict__ pts_g, int run, int T, float d0f, float ddf,
                    float* __restrict__ out) {
    constexpr bool kStaged = C > 1;
    static_assert(BF == kF32 || C == kBpsChunk, "bf16 windows take slots of kBpsChunk offsets");
    extern __shared__ float4 bps_sm[];
    const int N2 = 2 * N, tile = kBpsThreads * run, W = tile + N2 - 1;
    const int sh = run > 1 ? __ffs(run) - 1 : 31;
    const int ts = bps_pad(W - 1, sh) + 1;                   // slots of the float32 table
    float4* pts = bps_sm;                                     // (npts,), kGen and staged only
    Slot<C>* tab = reinterpret_cast<Slot<C>*>(kStaged ? pts + g.npts : bps_sm);
    float4* xs = BF != kF32 ? pts + g.npts
                            : reinterpret_cast<float4*>(tab + ts);   // (W,), staged only
    const long long row = (long long)blockIdx.y * L;
    const long long j0 = (long long)blockIdx.x * tile;
    const long long s0 = j0 - N + 1;  // staged sample u is sample s0 + u of the row

    // row sample q as [x, y, cos ph1, sin ph1]; outside the row a zero sample at angle 0
    auto sample_at = [=](long long q) {
        const bool in = q >= 0 && q < L;
        float sn, cs;
        sincosf(in ? ph1[row + q] : 0.f, &sn, &cs);
        return make_float4(in ? er[row + q] : 0.f, in ? ei[row + q] : 0.f, cs, sn);
    };
    auto sample = [=](int u) { return sample_at(s0 + u); };
    if constexpr (kStaged) {
        if constexpr (KIND == kGen) stage_points(pts, pts_g, g.npts);
#pragma unroll 4
        for (int u = threadIdx.x; u < W; u += kBpsThreads) xs[u] = sample(u);
    }
    // bf16 windows: the distances of sample z at the chunk's offsets (c, s), as the fill below
    auto fine_dists = [&](const float4& z, const float (&c)[C], const float (&s)[C],
                          float (&d)[C]) {
        float ca[C], sa[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
            ca[k] = __fsub_rn(__fmul_rn(z.z, c[k]), __fmul_rn(z.w, s[k]));
            sa[k] = __fadd_rn(__fmul_rn(z.w, c[k]), __fmul_rn(z.z, s[k]));
        }
        chunk_dists<KIND>(z.x, z.y, ca, sa, g, pts, pts_g, d);
    };
    constexpr int kUnroll = KIND == kGen || !kStaged ? 1 : 2;
    constexpr int R = BF != kF32 ? kBfFineMaxRun
                         : !kStaged ? kFineMaxRunNarrow : KIND == kGen ? kFineMaxRunGen
                                                                        : kFineMaxRun;
    float bs[R];   // the run's best sums and indices in registers
    int bi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        bs[r] = INFINITY;
        bi[r] = 0;
    }
    // the phases of the tile's positions from their indices, idx[at(p)] for position p
    auto store = [&](const int* idx, auto at) {
        for (int p = threadIdx.x; p < tile; p += kBpsThreads) {
            const long long j = j0 + p;
            if (j < L)
                out[row + j] = __fadd_rn(__fadd_rn(ph1[row + j], d0f),
                                         __fmul_rn(ddf, (float)idx[at(p)]));
        }
    };
    if constexpr (BF != kF32) {
        const BfTile bt = bf_tile(xs + W, N, T, run, j0);
        const BfWalk w = bf_walk_start(bt, j0, run, N);
        __syncthreads();  // the samples are staged
        for (int b0 = 0; b0 < B; b0 += C) {
            const int nb = min(C, B - b0);
            float c[C], s[C];
#pragma unroll
            for (int k = 0; k < C; ++k) {
                c[k] = k < nb ? cd[b0 + k] : 0.f;
                s[k] = k < nb ? sd[b0 + k] : 0.f;
            }
#pragma unroll kUnroll
            for (int u = threadIdx.x; u < W; u += kBpsThreads) {
                Slot<C> d;
                fine_dists(xs[u], c, s, d.v);
                bt.d[u] = bf_round(d.v);   // the distances rounded to bf16
            }
            // one distance a thread of each tail's samples, with the fill's arithmetic
            for (int v = threadIdx.x; v < kBfLookback * bt.nb; v += kBpsThreads) {
                Slot<C> d;
                fine_dists(sample_at(bf_tail_sample(bt, v)), c, s, d.v);
                bt.tdist[v] = bf_round(d.v);
            }
            bf_chunk<BF>(bt, w, run, b0, nb, bs, bi);
        }
        store(bf_tile_indices(bt, w, run, j0, L, N, bi), [](int p) { return p; });
        return;
    }
    const int p0 = threadIdx.x * run;
    for (int b0 = 0; b0 < B; b0 += C) {
        const int nb = min(C, B - b0);
        float c[C], s[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
            c[k] = k < nb ? cd[b0 + k] : 0.f;
            s[k] = k < nb ? sd[b0 + k] : 0.f;
        }
        __syncthreads();  // the samples are staged, the previous chunk's sums are done
#pragma unroll kUnroll
        for (int u = threadIdx.x; u < W; u += kBpsThreads) {
            const float4 z = kStaged ? xs[u] : sample(u);
            // the offsets' angles ph1 + delta_b by angle addition, as bps_fine_distances
            float ca[C], sa[C];
#pragma unroll
            for (int k = 0; k < C; ++k) {
                ca[k] = __fsub_rn(__fmul_rn(z.z, c[k]), __fmul_rn(z.w, s[k]));
                sa[k] = __fadd_rn(__fmul_rn(z.w, c[k]), __fmul_rn(z.z, s[k]));
            }
            Slot<C> d;
            chunk_dists<KIND>(z.x, z.y, ca, sa, g, pts, pts_g, d.v);
            tab[bps_pad(u, sh)] = d;
        }
        __syncthreads();
        bps_run_sums(tab, sh, p0, run, N2, b0, nb, bs, bi);
    }
    store(bps_tile_indices(tab, sh, p0, run, j0, L, N, bi), [&](int p) { return bps_pad(p, sh); });
}

// B3's and B8's kernels: float32 windows, and bf16 windows by 2N (BF: kBfShort, kBfLong).
// The bf16 ones ask for one resident CTA an SM: with the thread bound alone ptxas held some of
// them to 96 registers and spilled (the H100 build's log).
template <int KIND>
__global__ void __launch_bounds__(kBpsThreads)
    bps_kernel(const float* __restrict__ er, const float* __restrict__ ei, long long L,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t, int A, int N,
               GridArgs g, const float* __restrict__ pts_g, int run, int T,
               int* __restrict__ out) {
    bps_search<KIND, kF32>(er, ei, L, cos_t, sin_t, A, N, g, pts_g, run, T, out);
}

template <int KIND, int BF>
__global__ void __launch_bounds__(kBpsThreads, 1)
    bps_kernel_bf16(const float* __restrict__ er, const float* __restrict__ ei, long long L,
                    const float* __restrict__ cos_t, const float* __restrict__ sin_t, int A,
                    int N, GridArgs g, const float* __restrict__ pts_g, int run, int T,
                    int* __restrict__ out) {
    bps_search<KIND, BF>(er, ei, L, cos_t, sin_t, A, N, g, pts_g, run, T, out);
}

template <int KIND, int C>
__global__ void __launch_bounds__(kBpsThreads)
    bps_fine_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                    const float* __restrict__ ph1, long long L, const float* __restrict__ cd,
                    const float* __restrict__ sd, int B, int N, GridArgs g,
                    const float* __restrict__ pts_g, int run, int T, float d0f, float ddf,
                    float* __restrict__ out) {
    bps_fine_search<KIND, C, kF32>(er, ei, ph1, L, cd, sd, B, N, g, pts_g, run, T, d0f, ddf,
                                   out);
}

template <int KIND, int BF>
__global__ void __launch_bounds__(kBpsThreads, 1)
    bps_fine_kernel_bf16(const float* __restrict__ er, const float* __restrict__ ei,
                         const float* __restrict__ ph1, long long L, const float* __restrict__ cd,
                         const float* __restrict__ sd, int B, int N, GridArgs g,
                         const float* __restrict__ pts_g, int run, int T, float d0f, float ddf,
                         float* __restrict__ out) {
    bps_fine_search<KIND, kBpsChunk, BF>(er, ei, ph1, L, cd, sd, B, N, g, pts_g, run, T, d0f,
                                         ddf, out);
}

// (x + j y) exp(sign j ph), each product and sum rounded on its own
__device__ __forceinline__ void rotate_one(float x, float y, float ph, int sign, float* o_r,
                                           float* o_i) {
    float s, c;
    sincosf(ph, &s, &c);
    if (sign > 0) {   // E exp(+j ph)
        *o_r = __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
        *o_i = __fadd_rn(__fmul_rn(x, s), __fmul_rn(y, c));
    } else {          // E exp(-j ph)
        *o_r = __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
        *o_i = __fsub_rn(__fmul_rn(y, c), __fmul_rn(x, s));
    }
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
    rotate_one(er[m * L + i], ei[m * L + i], ph, sign, outr + m * L + i, outi + m * L + i);
}

__global__ void rotate_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                              const float* __restrict__ ph, long long n, int sign,
                              float* __restrict__ outr, float* __restrict__ outi) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    rotate_one(er[i], ei[i], ph[i], sign, outr + i, outi + i);
}

// B5's halo: the cpe_avg unwrapped phases before a tile, rounded up to 4 so that the tile's
// own start on a 16-byte boundary
inline __host__ __device__ int cpe_halo(int cpe_avg) { return (cpe_avg + 3) & ~3; }

// B5's launch plan (qtt_cpe_plan; ops/phase_cuda.py cpe_plan on the host): a row's
// pilots that the average reaches, npts + cpe_avg - 1, in tiles of kCpeTile; the halo
// holds the last cpe_avg unwrapped phases before a tile (the average of a tile's first
// block reaches back cpe_avg - 1 pilots, and its left neighbour's one more)
struct CpePlan {
    long long tile, tiles, halo, smem, ctas, opt_in;
};
inline CpePlan cpe_plan(long long rows, int npts, int cpe_avg) {
    CpePlan p;
    p.tile = kCpeTile;
    p.tiles = ((long long)npts + cpe_avg - 1 + kCpeTile - 1) / kCpeTile;
    p.halo = cpe_halo(cpe_avg);
    // the halo and the tile's u; the tile's phases, then its averages (one more than a tile,
    // rounded up to 4); the scan's warp sums
    p.smem = 4 * (p.halo + 2 * (long long)kCpeTile + 4 + 32);
    p.ctas = rows;
    p.opt_in = p.smem > kStaticSmem;
    return p;
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return ((unsigned long long)p & 15) == 0;
}

// pavg[l] = (u[l+c-1] + ... + u[l]) / c, summed in that order (the plain version's), from
// u_l = u[l] in shared memory
__device__ __forceinline__ float cpe_pavg(const float* u_l, int c) {
    float acc = u_l[c - 1];
    for (int k = 1; k < c; ++k) acc = __fadd_rn(acc, u_l[c - 1 - k]);
    return __fdiv_rn(acc, (float)c);
}

// One CTA per row; see the note at the top (B5).
__global__ void __launch_bounds__(kCpeThreads)
cpe_coeffs_kernel(const float* __restrict__ symr, const float* __restrict__ symi, long long ld,
                  int off, int stride, const float* __restrict__ pil_r,
                  const float* __restrict__ pil_i, int rows_per_pilot, int npil, int n_head,
                  int npts, int dx, int cpe_avg, int nbt, float two_pi, float inv_two_pi,
                  float* __restrict__ a_out, float* __restrict__ b_out) {
    constexpr int K = kCpeItems, T = kCpeTile;
    extern __shared__ float4 sm4[];
    const int H = cpe_avg, Hp = cpe_halo(cpe_avg);
    float* u_s = reinterpret_cast<float*>(sm4);        // u[j0 - Hp .. j0 + T) of tile j0
    float* ph_s = u_s + Hp + T;                        // the tile's phases, then its averages
    int* warp_sum = reinterpret_cast<int*>(ph_s + T + 4);
    const long long row = blockIdx.x;
    const int t = threadIdx.x;
    const float* zr = symr + row * ld + off;
    const float* zi = symi + row * ld + off;
    const float* pr = pil_r + (row / rows_per_pilot) * npil;
    const float* pi = pil_i + (row / rows_per_pilot) * npil;
    float* a_row = a_out + row * nbt;
    float* b_row = b_out + row * nbt;
    const bool vec_out = aligned16(a_row) && aligned16(b_row);
    const int nuse = npts + cpe_avg - 1;               // the pilots the average reaches
    int count = 0;                                     // the jumps before the tile
    float carry = 0.f;                                 // the phase of the pilot before it
    for (int j0 = 0; j0 < nuse; j0 += T) {
        const int j1 = min(j0 + T, nuse), n = j1 - j0;
        // the tile's phases: pilot j0 + i by thread i mod kCpeThreads (neighbouring threads
        // on neighbouring pilots), every load first
        float xr[K], xi[K], wr[K], wi[K];
#pragma unroll
        for (int q = 0; q < K; ++q) {
            const int i = t + q * kCpeThreads;
            const bool in = i < n;
            const int j = in ? j0 + i : 0;
            xr[q] = in ? zr[(long long)j * stride] : 0.f;
            xi[q] = in ? zi[(long long)j * stride] : 0.f;
            wr[q] = in ? pr[j] : 0.f;
            wi[q] = in ? pi[j] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < K; ++q)
            ph_s[t + q * kCpeThreads] =
                atan2f(__fsub_rn(__fmul_rn(wr[q], xi[q]), __fmul_rn(wi[q], xr[q])),
                       __fadd_rn(__fmul_rn(wr[q], xr[q]), __fmul_rn(wi[q], xi[q])));
        __syncthreads();
        // each thread's K consecutive pilots from here on
        const float4 v = reinterpret_cast<const float4*>(ph_s)[t];
        const float ph[K] = {v.x, v.y, v.z, v.w};
        const float before = t > 0 ? ph_s[K * t - 1] : carry;
        const float next_carry = ph_s[T - 1];
        // jump counts, rounded op by op (a step of exactly +pi counts), prefix-summed in int32
        int incl[K], own = 0;
#pragma unroll
        for (int q = 0; q < K; ++q) {
            const int j = j0 + K * t + q;
            if (j > 0 && j < j1) {
                const float d = __fsub_rn(ph[q], q ? ph[q - 1] : before);
                own += (int)floorf(__fadd_rn(__fmul_rn(d, inv_two_pi), 0.5f));
            }
            incl[q] = own;
        }
        int total;
        const int excl = count + block_exclusive_scan(own, warp_sum, &total);   // syncs
        float u[K];
#pragma unroll
        for (int q = 0; q < K; ++q)
            u[q] = __fsub_rn(ph[q], __fmul_rn(two_pi, (float)(excl + incl[q])));
        reinterpret_cast<float4*>(u_s + Hp)[t] = make_float4(u[0], u[1], u[2], u[3]);
        __syncthreads();

        // the averages pavg[p0 .. p1) end in this tile; it decides the blocks whose la (or,
        // inside, la + 1) is among them: the head (la < 0) where pavg[0] ends, the tail
        // (la >= npts - 1) where pavg[npts - 1] ends
        const int p0 = max(0, j0 - cpe_avg + 1), p1 = min(npts, j1 - cpe_avg + 1);
        if (p0 < p1) {
            // the averages pavg[l0 .. p1) (the one before the tile's first, where it has one),
            // over the phases in ph_s
            const int l0 = max(p0 - 1, 0);
            const float* u_base = u_s + Hp - j0;       // u_base[l] = u[l]
            for (int i = t; i < p1 - l0; i += kCpeThreads)
                ph_s[i] = cpe_pavg(u_base + l0 + i, cpe_avg);
            __syncthreads();
            const int k_lo = p0 == 0 ? 0 : min(nbt, max(0, p0 - 1 + n_head));
            const int k_hi = p1 == npts ? nbt : min(nbt, max(0, p1 - 1 + n_head));
            const float first = ph_s[0], last = p1 == npts ? ph_s[npts - 1 - l0] : 0.f;
            for (int kb = (k_lo & ~(K - 1)) + K * t; kb < k_hi; kb += T) {
                float av[K], bv[K];
#pragma unroll
                for (int q = 0; q < K; ++q) {
                    const int la = kb + q - n_head, i = min(max(la - l0, 0), p1 - l0 - 1);
                    const bool mid = la >= 0 && la < npts - 1;
                    const float lo = ph_s[i], hi = ph_s[min(i + 1, p1 - l0 - 1)];
                    av[q] = la < 0 ? first : (mid ? lo : last);
                    bv[q] = mid ? __fdiv_rn(__fsub_rn(hi, lo), (float)dx) : 0.f;
                }
                if (vec_out && kb >= k_lo && kb + K <= k_hi) {
                    *reinterpret_cast<float4*>(a_row + kb) =
                        make_float4(av[0], av[1], av[2], av[3]);
                    *reinterpret_cast<float4*>(b_row + kb) =
                        make_float4(bv[0], bv[1], bv[2], bv[3]);
                } else {
#pragma unroll
                    for (int q = 0; q < K; ++q) {
                        const int k = kb + q;
                        if (k >= k_lo && k < k_hi) {
                            a_row[k] = av[q];
                            b_row[k] = bv[q];
                        }
                    }
                }
            }
        }
        count += total;
        carry = next_carry;
        if (j1 < nuse) {
            // the next tile's halo: u[j1 - H .. j1), in passes (it may be longer than a tile)
            for (int i0 = 0; i0 < H; i0 += kCpeThreads) {
                const int i = i0 + t;
                const float v = i < H ? u_s[Hp - H + T + i] : 0.f;
                __syncthreads();
                if (i < H) u_s[Hp - H + i] = v;
            }
        }
        __syncthreads();                               // ph_s and u_s free for the next tile
    }
}

// B7: the tiles of a row of L samples: from up to 3 samples before the
// row's first 16-byte aligned one (its head), kUnwrapTile samples each
long long unwrap_tiles(long long L) { return (L + 3 + kUnwrapTile - 1) / kUnwrapTile; }

// B7: the jump count of sample i of a row (0 at i = 0 and outside the row) from
// its phase p and the previous sample's, rounded op by op
__device__ __forceinline__ int quarter_jump(float p, float before, long long i, long long L,
                                            float inv_half_pi) {
    if (i < 1 || i >= L) return 0;
    return (int)floorf(__fadd_rn(__fmul_rn(__fsub_rn(p, before), inv_half_pi), 0.5f));
}

// B7: warp 0's look-back from tile t of a row: the sum of its predecessors'
// counts, read from their status words (flag << 32 | value) 32 at a time back
// to the nearest inclusive one; a word not yet published is read again. Tiles
// before the row's first count as an inclusive 0.
__device__ __forceinline__ int unwrap_look_back(const unsigned long long* status, int t) {
    const int lane = threadIdx.x & 31;
    int excl = 0;
    for (int k = t - 1;; k -= 32) {
        const int j = k - lane;   // lane 0 the nearest predecessor
        unsigned long long w = kUnwrapInclusive;
        if (j >= 0) {
            do {
                w = *reinterpret_cast<const volatile unsigned long long*>(status + j);
            } while ((w >> 32) == 0);
        }
        const unsigned incl = __ballot_sync(0xffffffffu, (w >> 32) == (kUnwrapInclusive >> 32));
        const int stop = incl ? __ffs(incl) - 1 : 32;
        int v = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (incl) return excl;
    }
}

// B7 and B10: thread 0 takes the CTA's ticket from its row's counter (zero at launch)
__device__ __forceinline__ void take_ticket(unsigned long long* ticket, int* shared_int) {
    if (threadIdx.x == 0) *shared_int = (int)atomicAdd(ticket, 1ull);
}

// B7 and B10: the tile that take_ticket's ticket names. load(tile) fills the thread's
// registers. Tickets mostly come in launch order: that tile is loaded while the ticket comes
// back, and another only where the ticket names it. Every thread of the block calls it (it
// syncs).
template <class Load>
__device__ __forceinline__ int ticket_tile(const int* shared_int, Load load) {
    load(blockIdx.x);
    __syncthreads();
    const int t = *shared_int;   // this CTA's tile: its predecessors' CTAs have all started
    if (t != (int)blockIdx.x) load(t);
    return t;
}

// B7 and B10: the sum of the counts `own` of tile t's predecessors in its row and of the
// threads before this one in the tile: the block's exclusive scan; warp 0 publishes the
// tile's aggregate, looks back (unwrap_look_back) and publishes the tile's inclusive sum.
// Every thread of the block calls it (it syncs).
__device__ __forceinline__ int tile_exclusive_prefix(unsigned long long* status, int t, int own,
                                                     int* warp_sum, int* shared_int) {
    const int lane = threadIdx.x & 31;
    int total;
    const int in_tile = block_exclusive_scan(own, warp_sum, &total);
    if (threadIdx.x < 32) {
        int excl = 0;
        if (t > 0) {
            if (lane == 0)
                *reinterpret_cast<volatile unsigned long long*>(status + t) =
                    kUnwrapAggregate | (unsigned)total;
            excl = unwrap_look_back(status, t);
        }
        if (lane == 0) {
            *reinterpret_cast<volatile unsigned long long*>(status + t) =
                kUnwrapInclusive | (unsigned)(excl + total);
            *shared_int = excl;
        }
    }
    __syncthreads();
    return *shared_int + in_tile;
}

// B7. phase: the alignment (in floats, mod 4) of the five planes' storage where
// they share it, -1 where they do not (then every access is scalar). scratch:
// the rows' tickets, then their status words, (rows, ntiles), zero at launch.
__global__ void __launch_bounds__(kUnwrapThreads)
    unwrap_kernel(const float* __restrict__ er, const float* __restrict__ ei,
                  const float* __restrict__ ph, long long L, int phase, float half_pi,
                  float inv_half_pi, int ntiles, unsigned long long* __restrict__ scratch,
                  float* __restrict__ outr, float* __restrict__ outi) {
    __shared__ int warp_sum[32];
    __shared__ int shared_int;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.y * L;
    unsigned long long* status = scratch + gridDim.y + (long long)blockIdx.y * ntiles;
    take_ticket(scratch + blockIdx.y, &shared_int);

    // the thread's samples i0 .. i0+kUnwrapItems-1 of a tile, in groups of 4 that lie on
    // 16-byte boundaries where the planes share their alignment
    constexpr int K = kUnwrapItems;
    const long long head = phase >= 0 ? (phase + row) & 3 : 0;
    float p[K], x[K], y[K];
    long long i0;
    auto load = [&](int tile) {
        i0 = (long long)tile * kUnwrapTile + (long long)K * threadIdx.x - head;
#pragma unroll
        for (int q0 = 0; q0 < K; q0 += 4) {
            const long long i = i0 + q0;
            if (phase >= 0 && i >= 0 && i + 4 <= L) {
                const float4 a = *reinterpret_cast<const float4*>(ph + row + i);
                const float4 b = *reinterpret_cast<const float4*>(er + row + i);
                const float4 c = *reinterpret_cast<const float4*>(ei + row + i);
                p[q0] = a.x, p[q0 + 1] = a.y, p[q0 + 2] = a.z, p[q0 + 3] = a.w;
                x[q0] = b.x, x[q0 + 1] = b.y, x[q0 + 2] = b.z, x[q0 + 3] = b.w;
                y[q0] = c.x, y[q0 + 1] = c.y, y[q0 + 2] = c.z, y[q0 + 3] = c.w;
            } else {
#pragma unroll
                for (int q = q0; q < q0 + 4; ++q) {
                    const bool in = i0 + q >= 0 && i0 + q < L;
                    p[q] = in ? ph[row + i0 + q] : 0.f;
                    x[q] = in ? er[row + i0 + q] : 0.f;
                    y[q] = in ? ei[row + i0 + q] : 0.f;
                }
            }
        }
    };
    const int t = ticket_tile(&shared_int, load);
    // the phase before the first sample: the neighbour lane's last; a warp's first lane reads it
    float before = __shfl_up_sync(0xffffffffu, p[K - 1], 1);
    if (lane == 0 && i0 >= 1 && i0 <= L) before = ph[row + i0 - 1];
    int m[K], own = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
        m[q] = quarter_jump(p[q], q ? p[q - 1] : before, i0 + q, L, inv_half_pi);
        own += m[q];
    }
    int M = tile_exclusive_prefix(status, t, own, warp_sum, &shared_int);
    float o_r[K], o_i[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
        M += m[q];
        rotate_one(x[q], y[q], __fsub_rn(p[q], __fmul_rn(half_pi, (float)M)), 1, o_r + q, o_i + q);
    }
#pragma unroll
    for (int q0 = 0; q0 < K; q0 += 4) {
        const long long i = i0 + q0;
        if (phase >= 0 && i >= 0 && i + 4 <= L) {
            *reinterpret_cast<float4*>(outr + row + i) =
                make_float4(o_r[q0], o_r[q0 + 1], o_r[q0 + 2], o_r[q0 + 3]);
            *reinterpret_cast<float4*>(outi + row + i) =
                make_float4(o_i[q0], o_i[q0 + 1], o_i[q0 + 2], o_i[q0 + 3]);
        } else {
#pragma unroll
            for (int q = q0; q < q0 + 4; ++q) {
                if (i0 + q >= 0 && i0 + q < L) {
                    outr[row + i0 + q] = o_r[q];
                    outi[row + i0 + q] = o_i[q];
                }
            }
        }
    }
}

// B10: the tiles of a row of L decimated samples, kSlopeTile samples each
long long slope_tiles(long long L) { return (L + kSlopeTile - 1) / kSlopeTile; }

// B10: the decimated phase lo + step idx, each operation rounded on its own
__device__ __forceinline__ float decimated_phase(int idx, float lo, float step) {
    return __fadd_rn(lo, __fmul_rn(step, (float)idx));
}

// B10. vec: whether idx, a and b may be read and written as 16-byte vectors (their storage
// 16-byte aligned, L a multiple of 4). scratch: the rows' tickets, then their status words,
// (rows, ntiles), zero at launch.
__global__ void __launch_bounds__(kSlopeThreads)
    unwrap_slopes_kernel(const int* __restrict__ idx, long long L, int vec, float lo, float step,
                         float half_pi, float inv_half_pi, float inv_dec, int ntiles,
                         unsigned long long* __restrict__ scratch, float* __restrict__ a,
                         float* __restrict__ b) {
    __shared__ int warp_sum[32];
    __shared__ int shared_int;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.y * L;
    unsigned long long* status = scratch + gridDim.y + (long long)blockIdx.y * ntiles;
    take_ticket(scratch + blockIdx.y, &shared_int);

    constexpr int K = kSlopeItems;
    float p[K];
    long long i0;
    auto load = [&](int tile) {
        i0 = (long long)tile * kSlopeTile + (long long)K * threadIdx.x;
        if (vec && i0 + K <= L) {
#pragma unroll
            for (int q0 = 0; q0 < K; q0 += 4) {
                const int4 v = *reinterpret_cast<const int4*>(idx + row + i0 + q0);
                p[q0] = decimated_phase(v.x, lo, step);
                p[q0 + 1] = decimated_phase(v.y, lo, step);
                p[q0 + 2] = decimated_phase(v.z, lo, step);
                p[q0 + 3] = decimated_phase(v.w, lo, step);
            }
        } else {
#pragma unroll
            for (int q = 0; q < K; ++q)
                p[q] = i0 + q < L ? decimated_phase(idx[row + i0 + q], lo, step) : 0.f;
        }
    };
    const int t = ticket_tile(&shared_int, load);
    // the phases before the first sample and after the last: the neighbour lanes'; a warp's
    // first and last lanes read them
    float before = __shfl_up_sync(0xffffffffu, p[K - 1], 1);
    if (lane == 0 && i0 >= 1 && i0 <= L) before = decimated_phase(idx[row + i0 - 1], lo, step);
    float after = __shfl_down_sync(0xffffffffu, p[0], 1);
    if (lane == 31 && i0 + K < L) after = decimated_phase(idx[row + i0 + K], lo, step);
    int m[K], own = 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
        m[q] = quarter_jump(p[q], q ? p[q - 1] : before, i0 + q, L, inv_half_pi);
        own += m[q];
    }
    const int m_after = quarter_jump(after, p[K - 1], i0 + K, L, inv_half_pi);
    int M = tile_exclusive_prefix(status, t, own, warp_sum, &shared_int);
    float u[K + 1], s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
        M += m[q];
        u[q] = __fsub_rn(p[q], __fmul_rn(half_pi, (float)M));
    }
    u[K] = __fsub_rn(after, __fmul_rn(half_pi, (float)(M + m_after)));
#pragma unroll
    for (int q = 0; q < K; ++q)
        s[q] = i0 + q + 1 < L ? __fmul_rn(__fsub_rn(u[q + 1], u[q]), inv_dec) : 0.f;
    if (vec && i0 + K <= L) {
#pragma unroll
        for (int q0 = 0; q0 < K; q0 += 4) {
            *reinterpret_cast<float4*>(a + row + i0 + q0) =
                make_float4(u[q0], u[q0 + 1], u[q0 + 2], u[q0 + 3]);
            *reinterpret_cast<float4*>(b + row + i0 + q0) =
                make_float4(s[q0], s[q0 + 1], s[q0 + 2], s[q0 + 3]);
        }
    } else {
#pragma unroll
        for (int q = 0; q < K; ++q) {
            if (i0 + q < L) {
                a[row + i0 + q] = u[q];
                b[row + i0 + q] = s[q];
            }
        }
    }
}

// B3's and B8's instances by grid kind (and offsets per slot, window type)
#define QTT_BPS(kind)                                                              \
    ((kind) == kRect ? bps_kernel<kRect> : (kind) == kCross ? bps_kernel<kCross> : bps_kernel<kGen>)

#define QTT_BPS_BF16(kind, BF)                                                     \
    ((kind) == kRect    ? bps_kernel_bf16<kRect, BF>                               \
     : (kind) == kCross ? bps_kernel_bf16<kCross, BF>                              \
                        : bps_kernel_bf16<kGen, BF>)

#define QTT_FINE(kind, C)                                                          \
    ((kind) == kRect    ? bps_fine_kernel<kRect, C>                                \
     : (kind) == kCross ? bps_fine_kernel<kCross, C>                               \
                        : bps_fine_kernel<kGen, C>)

#define QTT_FINE_BF16(kind, BF)                                                    \
    ((kind) == kRect    ? bps_fine_kernel_bf16<kRect, BF>                          \
     : (kind) == kCross ? bps_fine_kernel_bf16<kCross, BF>                         \
                        : bps_fine_kernel_bf16<kGen, BF>)

int set_smem(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

}  // namespace

extern "C" {

// B3's launch plan (bps_plan) into plan[5]: run, tile, chunk, shared-memory
// bytes, CTAs. npts: the points of a general alphabet (0 for the analytic kinds).
void qtt_bps_plan(int nmodes, long long L, int N, int npts, long long* plan) {
    const BpsPlan p = bps_plan(nmodes, L, N, npts);
    plan[0] = p.run;
    plan[1] = p.tile;
    plan[2] = p.chunk;
    plan[3] = p.smem;
    plan[4] = p.ctas;
}

// kind: a GridKind; g0..g3: its constants in units of the spacing (grid.cuh
// GridArgs); pts: for kGen the (npts, 3) float32 table on the device, else unused.
int qtt_bps_idx(const float* er, const float* ei, int nmodes, long long L, const float* cos_t,
                const float* sin_t, int A, int N, int kind, float g0, float g1, float g2,
                float g3, const float* pts, int npts, int* out, void* stream) {
    if (kind < kRect || kind > kGen || (kind == kGen) != (npts > 0) || (npts > 0 && !pts) ||
        A < 1 || N < 0)
        return (int)cudaErrorInvalidValue;
    if (nmodes == 0 || L == 0) return 0;
    const BpsPlan p = bps_plan(nmodes, L, N, npts);
    const auto fn = QTT_BPS(kind);
    const int rc = set_smem((const void*)fn, (size_t)p.smem);
    if (rc) return rc;
    const GridArgs g = {kind, 1.f, g0, g1, g2, g3, npts};
    const dim3 grid((unsigned)(p.ctas / nmodes), (unsigned)nmodes);
    fn<<<grid, kBpsThreads, (size_t)p.smem, (cudaStream_t)stream>>>(er, ei, L, cos_t, sin_t, A, N,
                                                                    g, pts, (int)p.run, 0, out);
    return (int)cudaGetLastError();
}

// B3 and B8's launch plan with bf16 windows at reference tile T (bf_plan) into plan[5]:
// run, tile, angles per pass, shared-memory bytes, CTAs. fine: B8's (samples as float4).
void qtt_bps_bf16_plan(int fine, int nmodes, long long L, int N, int npts, int T,
                       long long* plan) {
    const BpsPlan p = bf_plan(nmodes, L, N, npts, T, fine != 0);
    plan[0] = p.run;
    plan[1] = p.tile;
    plan[2] = p.chunk;
    plan[3] = p.smem;
    plan[4] = p.ctas;
}

// qtt_bps_idx with the window sums in bf16, in the order of the reference's tiles of T
// samples (bf_takes says which N and T).
int qtt_bps_idx_bf16(const float* er, const float* ei, int nmodes, long long L,
                     const float* cos_t, const float* sin_t, int A, int N, int T, int kind,
                     float g0, float g1, float g2, float g3, const float* pts, int npts, int* out,
                     void* stream) {
    if (kind < kRect || kind > kGen || (kind == kGen) != (npts > 0) || (npts > 0 && !pts) ||
        A < 1 || !bf_takes(N, T))
        return (int)cudaErrorInvalidValue;
    if (nmodes == 0 || L == 0) return 0;
    const BpsPlan p = bf_plan(nmodes, L, N, npts, T, false);
    if (p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    const auto fn = 2 * N < 64 ? QTT_BPS_BF16(kind, kBfShort) : QTT_BPS_BF16(kind, kBfLong);
    const int rc = set_smem((const void*)fn, (size_t)p.smem);
    if (rc) return rc;
    const GridArgs g = {kind, 1.f, g0, g1, g2, g3, npts};
    const dim3 grid((unsigned)(p.ctas / nmodes), (unsigned)nmodes);
    fn<<<grid, kBpsThreads, (size_t)p.smem, (cudaStream_t)stream>>>(er, ei, L, cos_t, sin_t, A, N,
                                                                    g, pts, (int)p.run, T, out);
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

int qtt_rotate(const float* er, const float* ei, const float* ph, long long n, int sign,
               float* outr, float* outi, void* stream) {
    const unsigned grid = (unsigned)((n + kRotThreads - 1) / kRotThreads);
    rotate_kernel<<<grid, kRotThreads, 0, (cudaStream_t)stream>>>(er, ei, ph, n, sign, outr,
                                                                  outi);
    return (int)cudaGetLastError();
}

// B5's launch plan (cpe_plan) into plan[6]: tile, tiles, halo, shared-memory bytes,
// CTAs, whether the launch opts in to more than 48 KB.
void qtt_cpe_plan(long long rows, int npts, int cpe_avg, long long* plan) {
    const CpePlan p = cpe_plan(rows, npts, cpe_avg);
    const long long v[6] = {p.tile, p.tiles, p.halo, p.smem, p.ctas, p.opt_in};
    for (int i = 0; i < 6; ++i) plan[i] = v[i];
}

// symr/symi: (rows, ld) filtered symbols, the pilots at off + j stride; pil_r/pil_i:
// (rows/rows_per_pilot, npil); a_out/b_out: (rows, nbt).
int qtt_cpe_coeffs(const float* symr, const float* symi, int rows, long long ld, int off,
                   int stride, const float* pil_r, const float* pil_i, int rows_per_pilot,
                   int npil, int n_head, int npts, int dx, int cpe_avg, int nbt, float two_pi,
                   float inv_two_pi, float* a_out, float* b_out, void* stream) {
    if (rows < 0 || stride < 1 || cpe_avg < 1 || npts < 2 || npts + cpe_avg - 1 > npil ||
        n_head < 0 || nbt < 1 || rows_per_pilot < 1)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return 0;
    const CpePlan p = cpe_plan(rows, npts, cpe_avg);
    if (p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    if (p.opt_in) {
        const int rc = set_smem((const void*)cpe_coeffs_kernel, (size_t)p.smem);
        if (rc) return rc;
    }
    cpe_coeffs_kernel<<<(unsigned)p.ctas, kCpeThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
        symr, symi, ld, off, stride, pil_r, pil_i, rows_per_pilot, npil, n_head, npts, dx,
        cpe_avg, nbt, two_pi, inv_two_pi, a_out, b_out);
    return (int)cudaGetLastError();
}

// Tiles per row of B7: the wrapper's scratch is rows + rows * qtt_unwrap_tiles(L)
// 64-bit words, zeroed (the rows' tickets, then the tiles' status words).
int qtt_unwrap_tiles(long long L) { return (int)unwrap_tiles(L); }

// er/ei/ph/outr/outi: (rows, L); scratch: as qtt_unwrap_tiles says.
int qtt_unwrap_derotate(const float* er, const float* ei, const float* ph, int rows, long long L,
                        float half_pi, float inv_half_pi, unsigned long long* scratch,
                        float* outr, float* outi, void* stream) {
    if (rows == 0 || L == 0) return 0;
    const int ntiles = (int)unwrap_tiles(L);
    // 16-byte accesses where the five planes' storage shares its alignment
    const unsigned long long a = (unsigned long long)ph & 15;
    const bool same = ((unsigned long long)er & 15) == a && ((unsigned long long)ei & 15) == a &&
                      ((unsigned long long)outr & 15) == a && ((unsigned long long)outi & 15) == a;
    const int phase = same && (a & 3) == 0 ? (int)(a >> 2) : -1;
    const dim3 grid((unsigned)ntiles, (unsigned)rows);
    unwrap_kernel<<<grid, kUnwrapThreads, 0, (cudaStream_t)stream>>>(
        er, ei, ph, L, phase, half_pi, inv_half_pi, ntiles, scratch, outr, outi);
    return (int)cudaGetLastError();
}

// Tiles per row of B10. The wrapper sizes its scratch by its own copy of this rule
// (slopes_plan): rows + rows * tiles 64-bit words, zeroed (the rows' tickets, then the tiles'
// status words); the card tests hold the two equal.
int qtt_unwrap_slopes_tiles(long long L) { return (int)slope_tiles(L); }

// idx: (rows, L) int32; a/b: (rows, L) float32; scratch: as qtt_unwrap_slopes_tiles says.
int qtt_unwrap_slopes(const int* idx, int rows, long long L, float lo, float step, float half_pi,
                      float inv_half_pi, float inv_dec, unsigned long long* scratch, float* a,
                      float* b, void* stream) {
    if (rows == 0 || L == 0) return 0;
    const int ntiles = (int)slope_tiles(L);
    const bool vec = L % 4 == 0 && (((unsigned long long)idx | (unsigned long long)a |
                                     (unsigned long long)b) & 15) == 0;
    const dim3 grid((unsigned)ntiles, (unsigned)rows);
    unwrap_slopes_kernel<<<grid, kSlopeThreads, 0, (cudaStream_t)stream>>>(
        idx, L, vec, lo, step, half_pi, inv_half_pi, inv_dec, ntiles, scratch, a, b);
    return (int)cudaGetLastError();
}

// B8's launch plan (fine_plan) into plan[5]: run, tile, offsets per slot,
// shared-memory bytes, CTAs.
void qtt_bps_fine_plan(int nmodes, long long L, int N, int npts, long long* plan) {
    const BpsPlan p = fine_plan(nmodes, L, N, npts);
    plan[0] = p.run;
    plan[1] = p.tile;
    plan[2] = p.chunk;
    plan[3] = p.smem;
    plan[4] = p.ctas;
}

// kind, g0..g3, pts, npts: as in qtt_bps_idx.
int qtt_bps_fine(const float* er, const float* ei, const float* ph1, int nmodes, long long L,
                 const float* cd, const float* sd, int B, int N, int kind, float g0, float g1,
                 float g2, float g3, const float* pts, int npts, float d0f, float ddf, float* out,
                 void* stream) {
    if (kind < kRect || kind > kGen || (kind == kGen) != (npts > 0) || (npts > 0 && !pts) ||
        B < 1 || N < 0)
        return (int)cudaErrorInvalidValue;
    if (nmodes == 0 || L == 0) return 0;
    const BpsPlan p = fine_plan(nmodes, L, N, npts);
    if (p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    const auto fn = p.chunk == 1 ? QTT_FINE(kind, 1) : QTT_FINE(kind, kBpsChunk);
    const int rc = set_smem((const void*)fn, (size_t)p.smem);
    if (rc) return rc;
    const GridArgs g = {kind, 1.f, g0, g1, g2, g3, npts};
    const dim3 grid((unsigned)(p.ctas / nmodes), (unsigned)nmodes);
    fn<<<grid, kBpsThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
        er, ei, ph1, L, cd, sd, B, N, g, pts, (int)p.run, 0, d0f, ddf, out);
    return (int)cudaGetLastError();
}

// qtt_bps_fine with the window sums in bf16 at reference tile T, as qtt_bps_idx_bf16.
int qtt_bps_fine_bf16(const float* er, const float* ei, const float* ph1, int nmodes, long long L,
                      const float* cd, const float* sd, int B, int N, int T, int kind, float g0,
                      float g1, float g2, float g3, const float* pts, int npts, float d0f,
                      float ddf, float* out, void* stream) {
    if (kind < kRect || kind > kGen || (kind == kGen) != (npts > 0) || (npts > 0 && !pts) ||
        B < 1 || !bf_takes(N, T))
        return (int)cudaErrorInvalidValue;
    if (nmodes == 0 || L == 0) return 0;
    const BpsPlan p = bf_plan(nmodes, L, N, npts, T, true);
    if (p.smem > kSmemLimit) return (int)cudaErrorInvalidValue;
    const auto fn = 2 * N < 64 ? QTT_FINE_BF16(kind, kBfShort) : QTT_FINE_BF16(kind, kBfLong);
    const int rc = set_smem((const void*)fn, (size_t)p.smem);
    if (rc) return rc;
    const GridArgs g = {kind, 1.f, g0, g1, g2, g3, npts};
    const dim3 grid((unsigned)(p.ctas / nmodes), (unsigned)nmodes);
    fn<<<grid, kBpsThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
        er, ei, ph1, L, cd, sd, B, N, g, pts, (int)p.run, T, d0f, ddf, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
