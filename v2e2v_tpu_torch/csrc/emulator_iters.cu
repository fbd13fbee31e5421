// K3 for Hopper: the DVS emulator's per-frame-pair event-iteration loop.
//
// Replaces v2e2v_tpu/ops/pallas/emulator_iters.py::emulator_iters_pallas
// (_iters_kernel). For every pixel of a [B, H, W] plane and iterations
// i < max_iters (the event timestamp ts_i = tf_base + ts_step[b] * (i + 1)
// while i < num_iters[b], else 0):
//
//   m   = counts >= i + 1                                   candidate event
//   m  |= shot noise, while i < num_iters[b]:
//          (pol > 0 and r > 1 - p_on) or (pol < 0 and r < p_off)
//   m  &= (ts_i - mem) > Tr       when the row's gate is set (suppress only)
//   mem = ts_i where m and gate
//   final += m;  voxel[k] += pol * m * max(0, 1 - |ts_i - k|)   k < num_bins
//
// The uniforms r are either an input rand01 [I, B, H, W] (explicit mode) or
// made here (internal mode) by a counter-based Philox4x32-10 keyed by the
// per-(pair, row) 64-bit seed and counted by (pixel, i / 4): one Philox call
// gives the uniforms of four iterations, each from the top 24 bits of its
// lane, (bits >> 8) * 2^-24, as the Pallas kernel takes them.
//
// Design. The Pallas kernel keeps a whole plane in ~8.5 MB of VMEM; none of
// that is needed here: one thread per pixel over a flat B*H*W grid
// (coalesced loads), the iteration loop, mem, final and the num_bins sums in
// registers, the per-row scalars read from small arrays indexed by b, and the
// voxel written straight into [B, H, W, num_bins]. A pixel's loop stops after
// its last possible event: its own count and, with shot noise, num_iters[b].
// Every float operation is rounded as written (__fadd_rn / __fmul_rn, no
// contraction into FMAs), so the outputs equal the plain PyTorch version's
// bit for bit (v2e2v_tpu_torch/ops/cuda/emulator_iters.py).
//
// Bound on an H100: the inputs are read once and the outputs written once,
// 6 planes in (24 B/pixel) and num_bins + 2 out (28 B/pixel at 5 bins), plus
// 4 B per pixel and active iteration of rand01 in explicit mode: 18.0 MB at
// B = 8, 180x240 (5.4 us at 3.35 TB/s) internal, up to 62.2 MB (18.6 us) with
// all 32 iterations explicit. Its 8 + 2 * num_bins flops per pixel-iteration
// are far below that, so it is bound by memory and by launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_BINS = 16;
constexpr int THREADS = 256;

enum { SHOT_NONE = 0, SHOT_EXPLICIT = 1, SHOT_INTERNAL = 2 };

// Philox4x32-10 (Salmon et al., SC'11; the Random123 and curand generator).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x);
    const unsigned lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z);
    const unsigned lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

template <int SHOT>
__global__ void __launch_bounds__(THREADS) emulator_iters_kernel(
    const int* __restrict__ counts, const float* __restrict__ pol,
    const float* __restrict__ mem_in, const float* __restrict__ trf,
    const float* __restrict__ one_minus_on, const float* __restrict__ off_prob,
    const float* __restrict__ rand01, const unsigned long long* __restrict__ seed,
    const float* __restrict__ ts_step, const int* __restrict__ num_iters,
    const int* __restrict__ gate, float tf_base, float* __restrict__ voxel,
    float* __restrict__ mem_out, int* __restrict__ final_out, int B, int HW, int num_bins,
    int max_iters) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * HW) return;
  const int b = (int)(idx / HW);
  const int pix = (int)(idx - (long long)b * HW);

  const int cnt = counts[idx];
  const float p = pol[idx];
  const float tr = trf[idx];
  float mem = mem_in[idx];
  float om = 0.f, of = 0.f;
  uint2 key = make_uint2(0u, 0u);
  if (SHOT != SHOT_NONE) {
    om = one_minus_on[idx];
    of = off_prob[idx];
  }
  if (SHOT == SHOT_INTERNAL) {
    const unsigned long long s = seed[b];
    key = make_uint2((unsigned)s, (unsigned)(s >> 32));
  }
  const float step = ts_step[b];
  const int nit = num_iters[b];
  const bool g = gate[b] != 0;

  // nothing fires once i >= count and (with shot noise) i >= num_iters
  int last = cnt;
  if (SHOT != SHOT_NONE) last = max(last, nit);
  last = min(last, max_iters);

  float acc[MAX_BINS];
#pragma unroll
  for (int k = 0; k < MAX_BINS; ++k) acc[k] = 0.f;
  int fin = 0;
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);

  for (int i = 0; i < last; ++i) {
    const bool active = i < nit;
    bool m = cnt >= i + 1;
    if (SHOT != SHOT_NONE && active) {
      float r;
      if (SHOT == SHOT_EXPLICIT) {
        r = rand01[((long long)i * B + b) * HW + pix];
      } else {
        const int lane = i & 3;
        if (lane == 0) bits = philox4x32_10(make_uint4((unsigned)pix, (unsigned)(i >> 2), 0u, 0u), key);
        const unsigned u = lane == 0 ? bits.x : lane == 1 ? bits.y : lane == 2 ? bits.z : bits.w;
        r = (float)(u >> 8) * 5.9604644775390625e-08f;  // 2^-24
      }
      m = m || (p > 0.f && r > om) || (p < 0.f && r < of);
    }
    const float ts = active ? __fadd_rn(tf_base, __fmul_rn(step, (float)(i + 1))) : 0.f;
    if (g) {
      m = m && __fsub_rn(ts, mem) > tr;
      if (m) mem = ts;
    }
    if (m) {
      ++fin;
#pragma unroll
      for (int k = 0; k < MAX_BINS; ++k) {
        if (k < num_bins) {
          const float w = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(ts, (float)k))));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(p, w));
        }
      }
    }
  }

  mem_out[idx] = mem;
  final_out[idx] = fin;
  float* v = voxel + idx * num_bins;
#pragma unroll
  for (int k = 0; k < MAX_BINS; ++k)
    if (k < num_bins) v[k] = acc[k];
}

template <int SHOT>
cudaError_t launch(const void* counts, const void* pol, const void* mem_in, const void* trf,
                   const void* om, const void* off, const void* rand01, const void* seed,
                   const void* ts_step, const void* num_iters, const void* gate, float tf_base,
                   void* voxel, void* mem_out, void* final_out, int B, int HW, int num_bins,
                   int max_iters, cudaStream_t stream) {
  const long long n = (long long)B * HW;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  emulator_iters_kernel<SHOT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const int*>(counts), static_cast<const float*>(pol),
      static_cast<const float*>(mem_in), static_cast<const float*>(trf),
      static_cast<const float*>(om), static_cast<const float*>(off),
      static_cast<const float*>(rand01), static_cast<const unsigned long long*>(seed),
      static_cast<const float*>(ts_step), static_cast<const int*>(num_iters),
      static_cast<const int*>(gate), tf_base, static_cast<float*>(voxel),
      static_cast<float*>(mem_out), static_cast<int*>(final_out), B, HW, num_bins, max_iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One frame pair's iteration loop. shot_mode: 0 = no shot noise (om, off,
// rand01 and seed unused), 1 = explicit rand01 [max_iters, B, H, W],
// 2 = internal Philox keyed by seed [B] (uint64). counts, num_iters, gate are
// int32; the rest float32; voxel is [B, H, W, num_bins]. Returns the
// cudaError_t of the launch.
int v2e_emulator_iters(const void* counts, const void* pol, const void* mem_in,
                       const void* trf, const void* om, const void* off, const void* rand01,
                       const void* seed, const void* ts_step, const void* num_iters,
                       const void* gate, float tf_base, void* voxel, void* mem_out,
                       void* final_out, int B, int H, int W, int num_bins, int max_iters,
                       int shot_mode, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)B * H * W > (1LL << 31) - 1 || num_bins < 1 ||
      num_bins > MAX_BINS || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = H * W;
  switch (shot_mode) {
    case SHOT_NONE:
      return (int)launch<SHOT_NONE>(counts, pol, mem_in, trf, om, off, rand01, seed, ts_step,
                                    num_iters, gate, tf_base, voxel, mem_out, final_out, B, hw,
                                    num_bins, max_iters, s);
    case SHOT_EXPLICIT:
      return (int)launch<SHOT_EXPLICIT>(counts, pol, mem_in, trf, om, off, rand01, seed,
                                        ts_step, num_iters, gate, tf_base, voxel, mem_out,
                                        final_out, B, hw, num_bins, max_iters, s);
    case SHOT_INTERNAL:
      return (int)launch<SHOT_INTERNAL>(counts, pol, mem_in, trf, om, off, rand01, seed,
                                        ts_step, num_iters, gate, tf_base, voxel, mem_out,
                                        final_out, B, hw, num_bins, max_iters, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
