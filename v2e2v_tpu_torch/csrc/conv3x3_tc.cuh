// The bfloat16 body of the reflect-padded 3x3 convolution of conv3x3.cuh, on
// Hopper's tensor cores: an implicit GEMM with wgmma, its operands staged in
// shared memory by cp.async. It computes what conv3x3.cuh states, for
// T = __nv_bfloat16, with the same ConvArgs and the same five epilogues:
//
// out[b, y, x, co] = epilogue(bias[co] + sum over the inputs s of
//     sum_{dy, dx, ci} x_s[b, reflect(y + dy - 1), reflect(x + dx - 1), ci]
//                      * w_s[(dy * 3 + dx), ci, co])
//
// The GEMM of a block: M = its 16x8 output pixels, N = a chunk of NB (64 or
// 128) output channels, K = 9 taps x the channels of each input, in chunks
// of 64. Two consumer warpgroups take 8 output rows each (M = 64 per
// wgmma.m64nNk16), and all 256 threads copy the input tiles.
//
// - A, the input, without an im2col: a haloed 18x10 input tile of one chunk
//   of 64 channels is staged as bf16, [ci / 8][18][10][8], so each pixel's 8
//   channels are one 16-byte row. Eight neighbouring pixels of a tile row are
//   then one 8x16-byte wgmma core matrix, and the A operand of tap (dy, dx)
//   is the same tile shifted by (dy * 10 + dx) * 16 bytes: the 9 taps read one
//   staged tile through 9 descriptors (no-swizzle mode, core matrices 160
//   bytes apart along M and 2880 bytes apart along K). It is copied with
//   16-byte cp.async, each thread computing reflected (or, past a ragged
//   edge, clamped) source rows, channels past cin zero-filled, and
//   double-buffered, so the next chunk (or the second input) loads while the
//   current one is multiplied.
// - B, the taps, laid out once by the wrapper (ops/cuda/conv_tc.py) in the
//   ring's byte order: a tap's 64 x NB slice is [ci / 8][NB / 8][8 ci][8 co],
//   each 16-byte row 8 neighbouring output channels, read N-major (wgmma's
//   B-transpose bit), zeros past cin and cout. One thread loads a slice with
//   one cp.async.bulk that completes on the slot's mbarrier; slices cycle
//   through a ring of STAGES buffers, loaded two steps ahead. (The first
//   design copied the slices with 16-byte cp.async from every thread; on an
//   H100 that ran the D conv at under half this design's rate, by
//   scripts/time_torch_kernels.py: issuing the copies held it back.)
// - Each thread makes its input copies visible to the async proxy
//   (fence.proxy.async) before the block's barrier, and a ring slot or input
//   buffer is refilled only after the wgmma groups that read it have retired
//   (wgmma.wait_group 1 at the end of every step, the barrier at the top).
// - Sums are float32 in registers (NB / 2 a thread); the epilogue reads the
//   accumulator fragment (rows = pixels, pairs of neighbouring columns =
//   channels), loads each pixel's epilogue operands before its stores, and
//   stores bf16 pairs, or float32 pairs for EPI_PRE, masking rows and columns
//   past H and W and channels past cout.
//
// Bound: operations (989 TFLOP/s of bf16 on an H100); its L2 traffic is the
// taps, re-read by every block (9 x cin x NB x 2 bytes for 2 x 128 x 9 x cin
// x NB operations). Shared memory: 4 x 64 x NB x 2 bytes of ring, 2 x 23,040
// bytes of input and the 4 mbarriers, 111,648 bytes a block at NB = 128, so
// two blocks fit on an SM.
#pragma once

#include <cstdint>

#include "conv3x3.cuh"

namespace v2e {
namespace tc {

constexpr int TILE_H = 16;     // output rows per block, 8 per consumer warpgroup
constexpr int TILE_W = 8;      // output columns per block: one core matrix of pixels
constexpr int WARPGROUPS = 2;  // consumer warpgroups per block
constexpr int THREADS = 128 * WARPGROUPS;
constexpr int IN_H = TILE_H + 2;
constexpr int IN_W = TILE_W + 2;
constexpr int KCH = 64;        // input channels per K chunk
constexpr int STAGES = 4;      // tap slices in the ring
constexpr int IN_BYTES = KCH / 8 * IN_H * IN_W * 16;  // one staged input chunk
constexpr uint32_t A_SBO = IN_W * 16;                 // next core matrix along M
constexpr uint32_t A_LBO = IN_H * IN_W * 16;          // next core matrix along K

__host__ __device__ constexpr int slot_bytes(int nb) { return KCH * nb * 2; }

// Output channels per block: 64 up to cout = 64, else 128 (grid axis z walks
// ceil(cout / NB) chunks).
inline int n_block(int cout) { return cout > 64 ? 128 : 64; }

inline size_t smem_bytes(int nb) {
  return (size_t)STAGES * slot_bytes(nb) + 2 * IN_BYTES + 8 * STAGES;
}

// smem_u32, cp_async16, cp_async_commit, cp_async_wait, mbar_init, bulk_load
// and mbar_wait are conv3x3.cuh's (namespace v2e).

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of the accumulators across the
// wgmma fences and waits.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// core matrices along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

#define V2E_F8(d, i)                                                                          \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A (64 x 16, K-major) * B (16 x N, N-major), float32 sums of bf16.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : V2E_F8(d, 0), V2E_F8(d, 8), V2E_F8(d, 16), V2E_F8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : V2E_F8(d, 0), V2E_F8(d, 8), V2E_F8(d, 16), V2E_F8(d, 24), V2E_F8(d, 32),
        V2E_F8(d, 40), V2E_F8(d, 48), V2E_F8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

#undef V2E_F8

// The body of one block; ista.cu and core.cu wrap it in __global__s of their
// own names. gridDim = (ceil(H / 16) * ceil(W / 8), B, ceil(cout / NB)),
// blockDim.x = THREADS, dynamic shared memory smem_bytes(NB). Here the taps
// a.wa and a.wb are laid out by ops/cuda/conv_tc.py::wgmma_taps: for each
// NB-channel output block, 64-channel K chunk and tap, one contiguous slice
// in the ring's byte order.
template <int EPI, int NB>
__device__ __forceinline__ void conv3x3_block(const ConvArgs& a, uint8_t* smem) {
  using bf16 = __nv_bfloat16;
  const int H = a.H, W = a.W, cout = a.cout;
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / a.tiles_w) * TILE_H;
  const int w0 = (blockIdx.x % a.tiles_w) * TILE_W;
  const int nca = (a.cin_a + KCH - 1) / KCH;
  const int ncb = two_inputs(EPI) ? (a.cin_b + KCH - 1) / KCH : 0;
  const int steps = 9 * (nca + ncb);  // one step per (K chunk, tap)
  const uint32_t ring = smem_u32(smem);
  const uint32_t inbuf = ring + STAGES * slot_bytes(NB);
  const uint32_t bars = inbuf + 2 * IN_BYTES;  // STAGES mbarriers

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Issues the copies of step s: its tap slice (one bulk copy by thread 0)
  // and, at a chunk's first tap, the chunk's haloed input tile (16-byte
  // cp.async by every thread, channels past cin zero-filled).
  auto load = [&](int s) {
    const int c = s / 9, t = s - 9 * c;
    const bool second = c >= nca;
    const int cin = second ? a.cin_b : a.cin_a;
    const int kc = second ? c - nca : c;
    if (tid == 0) {
      const bf16* w = static_cast<const bf16*>(second ? a.wb : a.wa);
      const size_t slice = (((size_t)blockIdx.z * ((cin + KCH - 1) / KCH) + kc) * 9 + t);
      bulk_load(ring + (s % STAGES) * slot_bytes(NB), w + slice * KCH * NB, slot_bytes(NB),
                bars + 8 * (s % STAGES));
    }
    if (t == 0) {
      const uint32_t buf = inbuf + (c & 1) * IN_BYTES;
      const bf16* x = static_cast<const bf16*>(second ? a.xb : a.xa) + (size_t)b * H * W * cin;
      for (int p = tid; p < 8 * IN_H * IN_W; p += THREADS) {
        const int pix = p / 8, g = p % 8;
        const int iy = pix / IN_W, ix = pix - iy * IN_W;
        const int gy = reflect(h0 - 1 + iy, H), gx = reflect(w0 - 1 + ix, W);
        const int gci = kc * KCH + 8 * g;
        const bool ok = gci < cin;
        cp_async16(buf + ((g * IN_H + iy) * IN_W + ix) * 16,
                   ok ? x + ((size_t)gy * W + gx) * cin + gci : x, ok);
      }
    }
  };

  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  fence_acc(acc);

  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 3>();  // this thread's input copies of step s have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; step s - 2's wgmma groups have retired
    if (s + STAGES - 2 < steps) load(s + STAGES - 2);
    cp_async_commit();
    mbar_wait(bars + 8 * (s % STAGES), (s / STAGES) & 1);  // step s's tap slice

    const int c = s / 9, t = s - 9 * c;
    const uint32_t a0 = inbuf + (c & 1) * IN_BYTES + ((8 * wg + t / 3) * IN_W + t % 3) * 16;
    const uint32_t b0 = ring + (s % STAGES) * slot_bytes(NB);
    constexpr uint32_t B_LBO = NB * 16, B_SBO = 128;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < KCH / 16; ++q)
      wgmma_bf16<NB>(acc, smem_desc(a0 + 2 * q * A_LBO, A_LBO, A_SBO),
                     smem_desc(b0 + 2 * q * B_LBO, B_LBO, B_SBO));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4j + 2hh + e] holds pixel (row 2 * warp + hh of this warpgroup's 8,
  // column lane / 4) and channel 8j + 2 (lane % 4) + e of the block's NB.
  const int lane = tid % 32, warp = (tid / 32) % 4;
  const int ox = w0 + lane / 4;
  const int cq = blockIdx.z * NB + 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int oy = h0 + 8 * wg + 2 * warp + hh;
    if (oy >= H || ox >= W) continue;
    const size_t base = (((size_t)b * H + oy) * W + ox) * cout;
    float2 other[NB / 8];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int co = cq + 8 * j;
      other[j] = make_float2(0.f, 0.f);
      if (co >= cout) continue;
      if (EPI == EPI_D || EPI == EPI_P)
        other[j] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(a.other) + base + co));
      else if (EPI == EPI_OUT_GATE)
        other[j] = *reinterpret_cast<const float2*>(static_cast<const float*>(a.other) + base + co);
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
      const int co = cq + 8 * j;
      if (co >= cout) continue;
      const float v[2] = {acc[4 * j + 2 * hh] + a.bias[co], acc[4 * j + 2 * hh + 1] + a.bias[co + 1]};
      const float o[2] = {other[j].x, other[j].y};
      if (EPI == EPI_PRE) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + co) = make_float2(v[0], v[1]);
      } else {
        float res[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (EPI == EPI_D) {
            res[e] = o[e] - v[e];
          } else if (EPI == EPI_P) {
            const float lam = a.lam[co + e];
            const float y = v[e] + o[e];
            res[e] = fmaxf(y - lam, 0.f) - fmaxf(-y - lam, 0.f);
          } else if (EPI == EPI_RELU) {
            res[e] = fmaxf(v[e], 0.f);
          } else {  // EPI_OUT_GATE
            res[e] = sigmoid(v[e]) * tanhf(o[e]);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.out) + base + co) =
            __floats2bfloat162_rn(res[0], res[1]);
      }
    }
  }
}

// Launches kernel (a __global__ taking ConvArgs that runs conv3x3_block<EPI,
// nb>) over the whole output on stream; returns the launch's cudaError_t.
template <typename Kernel>
cudaError_t launch(Kernel kernel, ConvArgs a, int B, int nb, cudaStream_t stream) {
  const size_t smem = smem_bytes(nb);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  a.co_block = nb;
  a.tiles_w = (a.W + TILE_W - 1) / TILE_W;
  const int tiles_h = (a.H + TILE_H - 1) / TILE_H;
  const dim3 grid(a.tiles_w * tiles_h, B, (a.cout + nb - 1) / nb);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace v2e
