// The reflect-padded 3x3 convolution that kernels K1 (ista.cu) and K2 (core.cu)
// are built from, with its fused per-channel epilogues.
//
// out[b, y, x, co] = epilogue(bias[co] + sum over the inputs s of
//     sum_{dy, dx, ci} x_s[b, reflect(y + dy - 1), reflect(x + dx - 1), ci]
//                      * w_s[(dy * 3 + dx), ci, co])
//
// Up to two NHWC inputs feed one sum, so a conv on a channel concat (the
// gates of ConvLSTC and ConvLSTM) never materialises the concat. Bias and
// lambda are float32; every sum is float32.
//
// K1 and K2 run their float32 convs on the body below and their bfloat16
// convs on the tensor-core body of conv3x3_tc.cuh (same ConvArgs and
// epilogues). Float32 stays on the CUDA cores because its contract is float32
// products and float32 sums (FFMA), which the tensor cores (TF32 at best) do
// not give. Bound: operations, 2 * 9 * B*H*W * cin * cout at the 67 TFLOP/s
// of float32 FFMA on an H100 SXM; its bytes (inputs and output once, ~30 MB
// for a D conv at B = 8, 90x120) take a tenth of that at 3.35 TB/s.
//
// Design: a direct convolution on CUDA cores, its operands staged in shared
// memory asynchronously.
// - A block owns a TH x (8 * GX)-pixel output tile and 64 output channels
//   (grid axis z walks ceil(cout / 64) chunks); 64 * GX threads, each
//   holding 8 neighbouring pixels of one tile row x 8 channels = 64 float32
//   accumulators. Its input row of 10 values per channel is loaded once and
//   serves the three horizontal taps (3 x 64 FFMAs per 10 + 6 x 16-byte
//   shared loads). A warp is 4 tile rows x 8 channel groups: each 16-byte
//   load of taps is 128 contiguous bytes shared by the warp's rows, each
//   16-byte load of inputs one address per row, rows 32 banks apart (row
//   pitch = 32 mod 128 bytes): no bank conflict.
// - K runs in chunks of 16 input channels (a last chunk of 8 when cin % 16
//   == 8 is zero-filled). Each chunk's haloed input tile is staged as
//   [ci / 4][TH + 2][8 GX + 2][4 ci] by 16-byte cp.async.cg, every thread
//   copying fixed pixels whose reflected (past a ragged edge, clamped) source
//   it computes once per block; channels past cin are zero-filled. Its taps,
//   laid out once by the wrapper (ops/cuda/conv_tc.py::simt_taps) as
//   contiguous [9][16 ci][64 co] slices, arrive by one cp.async.bulk that
//   completes on the stage's mbarrier. Two stages form a ring: chunk k + 1
//   is copied under the FFMAs of chunk k; one __syncthreads per chunk.
//   Within a chunk, each thread loads the next input row into registers
//   while it multiplies the current one (ptxas: 240 registers, no spills;
//   one 256-thread block per SM).
// - The tile grows with the grid: 8x32 pixels (256 threads, each staged tap
//   serving 256 pixels) when that gives at least one block per SM, else 8x16,
//   else 8x8, so that batch 1 at 90x120 still fills the card's 132 SMs.
// - No run-time integer division in the staging or the inner loop: the copy
//   assignment is fixed per thread, and tile constants are compile-time.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace v2e {

// What a conv does with bias + sum before it stores out[o] (o = NHWC index):
//   EPI_D        T: cast(other_T[o] - v)              (ISTA D conv, other = x1)
//   EPI_P        T: cast(softshrink(v + other_T[o], lam[co]))  (other = old z)
//   EPI_PRE      float32: v                           (gate pre-activations)
//   EPI_RELU     T: cast(relu(v))
//   EPI_OUT_GATE T: cast(sigmoid(v) * tanh(other_f32[o]))  (other = f32 cell)
enum Epilogue { EPI_D = 0, EPI_P = 1, EPI_PRE = 2, EPI_RELU = 3, EPI_OUT_GATE = 4 };

// Only these epilogues take a second input; the others compile without its
// loop (K1's convs are EPI_D and EPI_P).
__host__ __device__ constexpr bool two_inputs(int epi) {
  return epi == EPI_PRE || epi == EPI_OUT_GATE;
}

struct ConvArgs {
  const void* xa;      // NHWC input [B, H, W, cin_a]
  const void* wa;      // taps [9, cin_a, cout], laid out by ops/cuda/conv_tc.py
                       // (simt_taps for float32, wgmma_taps for bfloat16)
  const void* xb;      // second input [B, H, W, cin_b], or none: cin_b == 0
  const void* wb;      // taps [9, cin_b, cout], laid out as wa
  int cin_a, cin_b;
  const float* bias;   // [cout]
  const void* other;   // see Epilogue
  const float* lam;    // [cout], EPI_P only
  void* out;           // [B, H, W, cout]
  int H, W, cout, co_block, tiles_w;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// torch padding_mode='reflect' for a 1-pixel halo: -1 -> 1, n -> n-2. Rows
// and columns past the halo belong to a ragged tile's masked outputs and are
// only clamped.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// Channel counts the entry points take: multiples of 8.
inline bool conv_shape_ok(int epi, int B, int H, int W, int cin_a, int cin_b, int cout) {
  return B >= 1 && B <= 65535 && H >= 2 && W >= 2 && cin_a >= 8 && cin_a % 8 == 0 &&
         cin_b >= 0 && cin_b % 8 == 0 && (two_inputs(epi) || cin_b == 0) && cout >= 8 &&
         cout % 8 == 0;
}

// ---------------------------------------------------------------------------
// The float32 body.

constexpr int TH = 8;                           // output tile rows
constexpr int PX = 8;                           // output pixels per thread, along a row
constexpr int CO = 8;                           // output channels per thread
constexpr int CO_BLOCK = 64;                    // output channels per block
constexpr int KC = 16;                          // input channels per chunk
constexpr int STAGES = 2;                       // chunks in the shared-memory ring
constexpr int SLICE_BYTES = 9 * KC * CO_BLOCK * 4;  // one chunk's taps, [9][KC][CO_BLOCK]

// A TH x 8 GX-pixel tile, GX = 1, 2 or 4.
template <int GX>
struct Tile {
  static constexpr int TW = PX * GX;
  static constexpr int IH = TH + 2, IW = TW + 2;
  static constexpr int THREADS = TH * GX * (CO_BLOCK / CO);
  // 16-byte units per 4-channel plane of the staged input: IH * IW, padded
  // to 2 mod 8 so that a quad's copies of one pixel's 4 planes hit 4 banks
  static constexpr int PLANE = IH * IW + (10 - IH * IW % 8) % 8;
  static constexpr int STAGE_BYTES = SLICE_BYTES + KC / 4 * PLANE * 16;
  static constexpr int COPIES = (KC / 4 * IH * IW + THREADS - 1) / THREADS;  // per thread
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 8 * STAGES;
  static_assert(TH == 8, "a warp covers 4 tile rows; a column group 2 warps");
  static_assert(THREADS % (KC / 4) == 0, "each thread copies one fixed 4-channel plane");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy from global to shared memory; zero-fills when !valid (src is
// then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier of a stage, completed by the bytes of the bulk copy that fills
// its taps.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The body of one block; each source wraps it in a __global__ of its own name
// so that a profile tells its kernels apart. gridDim = (ceil(H / TH) *
// tiles_w, B, ceil(cout / CO_BLOCK)), blockDim.x = Tile<GX>::THREADS, dynamic
// shared memory Tile<GX>::SMEM_BYTES; the taps a.wa and a.wb laid out by
// simt_taps: [ceil(cout / 64)][ceil(cin / 16)][9][16][64] float32, zeros past
// cin and cout. Every tensor starts on a 16-byte boundary.
template <int EPI, int GX>
__device__ __forceinline__ void conv3x3_block(const ConvArgs& a, uint8_t* smem) {
  using Tl = Tile<GX>;
  const int H = a.H, W = a.W, cout = a.cout;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane_id = tid % 32;
  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / a.tiles_w) * TH;
  const int w0 = (blockIdx.x % a.tiles_w) * Tl::TW;
  const int co0 = blockIdx.z * CO_BLOCK;
  // this thread's outputs: tile row r, columns c0 .. c0 + 7, channels
  // co0 + 4 cg + (0..3) and co0 + 32 + 4 cg + (0..3)
  const int cg = lane_id % 8;
  const int r = (warp % 2) * 4 + lane_id / 8;
  const int c0 = (warp / 2) * PX;
  const int nca = (a.cin_a + KC - 1) / KC;
  const int nchunks = nca + (two_inputs(EPI) ? (a.cin_b + KC - 1) / KC : 0);
  const uint32_t ring = smem_u32(smem);
  const uint32_t bars = ring + STAGES * Tl::STAGE_BYTES;

  // The copies of this thread, the same in every chunk: plane g (channels
  // 4g .. 4g + 3 of the chunk) of the staged pixels tid / 4 + k * THREADS / 4,
  // each read from source pixel pix[k] (reflected, then clamped).
  const int g = tid % (KC / 4);
  int pix[Tl::COPIES];
#pragma unroll
  for (int k = 0; k < Tl::COPIES; ++k) {
    const int p = tid / (KC / 4) + k * (Tl::THREADS / (KC / 4));
    const int iy = p / Tl::IW, ix = p - iy * Tl::IW;
    pix[k] = reflect(h0 - 1 + iy, H) * W + reflect(w0 - 1 + ix, W);
  }

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Issues the copies of chunk c into stage s: its tap slice (one bulk copy
  // by thread 0) and its haloed input tile (16-byte cp.async by every
  // thread).
  auto load = [&](int c, int s) {
    const bool second = c >= nca;
    const int cin = second ? a.cin_b : a.cin_a;
    const int kc = second ? c - nca : c;
    const uint32_t stage = ring + s * Tl::STAGE_BYTES;
    if (tid == 0) {
      const float* w = static_cast<const float*>(second ? a.wb : a.wa);
      const size_t slice = (size_t)blockIdx.z * ((cin + KC - 1) / KC) + kc;
      bulk_load(stage, w + slice * (SLICE_BYTES / 4), SLICE_BYTES, bars + 8 * s);
    }
    const float* x = static_cast<const float*>(second ? a.xb : a.xa) + (size_t)b * H * W * cin;
    const int ci = kc * KC + 4 * g;
    const bool ok = ci < cin;
    const uint32_t dst = stage + SLICE_BYTES + (g * Tl::PLANE + tid / (KC / 4)) * 16;
#pragma unroll
    for (int k = 0; k < Tl::COPIES; ++k) {
      const int p = tid / (KC / 4) + k * (Tl::THREADS / (KC / 4));
      if (k < Tl::COPIES - 1 || p < Tl::IH * Tl::IW)
        cp_async16(dst + k * (Tl::THREADS / (KC / 4)) * 16,
                   ok ? x + (size_t)pix[k] * cin + ci : x, ok);
    }
  };

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int i = 0; i < CO; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % STAGES;
    cp_async_wait<STAGES - 2>();  // this thread's input copies of chunk c have landed
    __syncthreads();  // everyone's have; chunk c - 1's stage is no longer read
    if (c + STAGES - 1 < nchunks) load(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();
    mbar_wait(bars + 8 * s, (c / STAGES) & 1);  // chunk c's taps

    const float4* in4 = reinterpret_cast<const float4*>(smem + s * Tl::STAGE_BYTES + SLICE_BYTES);
    const float4* w4 = reinterpret_cast<const float4*>(smem + s * Tl::STAGE_BYTES);
    // Step it = 4 dy + q adds taps (dy, 0..2) of channels 4q .. 4q + 3: input
    // row r + dy of plane q, columns c0 .. c0 + 9 (vc), loaded one step
    // ahead into vn while the 768 FFMAs of this step run.
    auto step = [&](int it, const float4 (&vc)[PX + 2], float4 (&vn)[PX + 2]) {
      if (it + 1 < 3 * KC / 4) {
        const int dy = (it + 1) / (KC / 4), q = (it + 1) % (KC / 4);
        const float4* row = in4 + q * Tl::PLANE + (r + dy) * Tl::IW + c0;
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) vn[j] = row[j];
      }
      const int dy = it / (KC / 4), q = it % (KC / 4);
      // taps (dy, dx) of channel 4q + e: 64 floats, this thread's two float4s
      const float4* wrow = w4 + (dy * 3 * KC + 4 * q) * (CO_BLOCK / 4) + cg;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa = wrow[(dx * KC + e) * (CO_BLOCK / 4)];
          const float4 wb = wrow[(dx * KC + e) * (CO_BLOCK / 4) + 8];
          const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < PX; ++j) {
            const float xv = lane(vc[j + dx], e);
#pragma unroll
            for (int i = 0; i < CO; ++i) acc[j][i] = fmaf(xv, wv[i], acc[j][i]);
          }
        }
      }
    };
    float4 va[PX + 2], vb[PX + 2];
#pragma unroll
    for (int j = 0; j < PX + 2; ++j) va[j] = in4[r * Tl::IW + c0 + j];
#pragma unroll 1
    for (int it = 0; it < 3 * KC / 4; it += 2) {  // ping-pong between va and vb
      step(it, va, vb);
      step(it + 1, vb, va);
    }
  }

  const int oy = h0 + r;
  if (oy >= H) return;
  // The epilogue reads each pixel's operands before it stores the pixel: no
  // output aliases an input, but the compiler cannot know that, so a load
  // placed after a store would wait for the store.
  const int ch0 = co0 + 4 * cg;  // channels ch0 .. ch0 + 3 and ch0 + 32 .. ch0 + 35
  const bool half_ok[2] = {ch0 < cout, ch0 + 32 < cout};
  float bias[CO], lam[CO];
#pragma unroll
  for (int i = 0; i < CO; ++i) {
    const int co = ch0 + 32 * (i / 4) + i % 4;
    bias[i] = half_ok[i / 4] ? a.bias[co] : 0.f;
    lam[i] = EPI == EPI_P && half_ok[i / 4] ? a.lam[co] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = w0 + c0 + j;
    if (ox >= W) break;
    const size_t base = (((size_t)b * H + oy) * W + ox) * cout + ch0;
    float4 other[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      other[h] = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((EPI == EPI_D || EPI == EPI_P || EPI == EPI_OUT_GATE) && half_ok[h])
        other[h] = *reinterpret_cast<const float4*>(static_cast<const float*>(a.other) + base +
                                                    32 * h);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!half_ok[h]) continue;
      float res[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * h + e;
        const float v = acc[j][i] + bias[i];
        const float o = lane(other[h], e);
        if (EPI == EPI_PRE) {
          res[e] = v;
        } else if (EPI == EPI_D) {
          res[e] = o - v;
        } else if (EPI == EPI_P) {
          const float y = v + o;
          res[e] = fmaxf(y - lam[i], 0.f) - fmaxf(-y - lam[i], 0.f);
        } else if (EPI == EPI_RELU) {
          res[e] = fmaxf(v, 0.f);
        } else {  // EPI_OUT_GATE
          res[e] = sigmoid(v) * tanhf(o);
        }
      }
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + base + 32 * h) =
          make_float4(res[0], res[1], res[2], res[3]);
    }
  }
}

using ConvKernel = void (*)(ConvArgs);

inline long long conv_blocks(int B, int H, int W, int cout, int gx) {
  return (long long)((H + TH - 1) / TH) * ((W + PX * gx - 1) / (PX * gx)) * B *
         ((cout + CO_BLOCK - 1) / CO_BLOCK);
}

// Column groups of the tile a launch takes: the widest whose grid holds at
// least one block per SM.
inline int conv_tile_groups(int B, int H, int W, int cout, int sms) {
  if (conv_blocks(B, H, W, cout, 4) >= sms) return 4;
  return conv_blocks(B, H, W, cout, 2) >= sms ? 2 : 1;
}

inline int conv_smem_bytes(int gx) {
  return gx == 4 ? Tile<4>::SMEM_BYTES : gx == 2 ? Tile<2>::SMEM_BYTES : Tile<1>::SMEM_BYTES;
}

inline cudaError_t conv_sms(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Launches the float32 conv over the whole output on stream: kernels holds
// the source's __global__ for GX = 1, 2 and 4. Returns the launch's
// cudaError_t.
inline cudaError_t launch_conv3x3(const ConvKernel (&kernels)[3], ConvArgs a, int B,
                                  cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = conv_sms(&sms);
  if (err != cudaSuccess) return err;
  const int gx = conv_tile_groups(B, a.H, a.W, a.cout, sms);
  const ConvKernel kernel = kernels[gx == 4 ? 2 : gx - 1];
  const int smem = conv_smem_bytes(gx);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  a.tiles_w = (a.W + PX * gx - 1) / (PX * gx);
  const dim3 grid(a.tiles_w * ((a.H + TH - 1) / TH), B, (a.cout + CO_BLOCK - 1) / CO_BLOCK);
  kernel<<<grid, TH * gx * (CO_BLOCK / CO), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace v2e
