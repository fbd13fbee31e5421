// The reflect-padded 3x3 convolution that kernels K1 (ista.cu) and K2 (core.cu)
// are built from, with its fused per-channel epilogues.
//
// out[b, y, x, co] = epilogue(bias[co] + sum over the inputs s of
//     sum_{dy, dx, ci} x_s[b, reflect(y + dy - 1), reflect(x + dx - 1), ci]
//                      * w_s[(dy * 3 + dx), ci, co])
//
// Up to two NHWC inputs feed one sum, so a conv on a channel concat (the
// gates of ConvLSTC and ConvLSTM) never materialises the concat. Weights are
// taps [9, cin_s, cout] in the activation type T; bias and lambda are
// float32; every sum is float32.
//
// K1 and K2 run their float32 convs on the body below and their bfloat16
// convs on the tensor-core body of conv3x3_tc.cuh (same ConvArgs and
// epilogues, taps laid out for wgmma). Float32 stays here because its
// contract is exact float32 sums, which the tensor cores (TF32 at best) do
// not give; on CUDA cores it is bound by operations at 67 TFLOP/s and runs at
// 16-18 TFLOP/s.
//
// Design: a SIMT direct convolution. A block owns an 8x16 output tile and a
// chunk of co_block <= 128 output channels (grid axis z walks the chunks, so
// any cout % 8 == 0 runs), stages an 8-channel chunk of the input tile (with
// its 1-pixel reflect halo) and of the 9 taps in shared memory as float32,
// and each thread keeps a 4-pixel x 8-channel float32 accumulator in
// registers, reusing each loaded input row for the three horizontal taps.
// 4 * co_block <= 512 threads, so ptxas may give each thread 128 registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace v2e {

constexpr int TH = 8;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int KC = 8;    // input channels staged per shared-memory chunk
constexpr int PX = 4;    // output pixels per thread, along a row
constexpr int CO = 8;    // output channels per thread
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int PIX_GROUPS = TH * TW / PX;  // 32 pixel groups per tile
constexpr int MAX_CO_BLOCK = 128;

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
  const void* wa;      // taps [9, cin_a, cout] (laid out by wgmma_taps for conv3x3_tc.cuh)
  const void* xb;      // second input [B, H, W, cin_b], or none: cin_b == 0
  const void* wb;      // taps [9, cin_b, cout]
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

// The body of one block; each source wraps it in a __global__ of its own name
// so that a profile tells its kernels apart. gridDim = (tiles_h * tiles_w, B,
// cout / co_block), blockDim.x = PIX_GROUPS * co_block / CO.
template <typename T, int EPI>
__device__ __forceinline__ void conv3x3_block(const ConvArgs& a, float* smem) {
  const int co_blk = a.co_block;
  float* w_s = smem;                     // [9][KC][co_blk]
  float* in_s = w_s + 9 * KC * co_blk;  // [KC][IH][IW]

  const int H = a.H, W = a.W, cout = a.cout;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * co_blk;
  const int h0 = (blockIdx.x / a.tiles_w) * TH;
  const int w0 = (blockIdx.x % a.tiles_w) * TW;
  const int ncg = co_blk / CO;
  const int tid = threadIdx.x;
  const int cg = tid % ncg;
  const int pg = tid / ncg;
  const int r = pg / (TW / PX);
  const int c0 = (pg % (TW / PX)) * PX;
  const int nthreads = blockDim.x;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int i = 0; i < CO; ++i) acc[j][i] = 0.f;

  // adds one input's conv to acc (called once per input, so that no array
  // of the kernel's parameters is indexed at run time)
  auto accumulate = [&](const void* x, const void* wt, int cin) {
    const T* xb = static_cast<const T*>(x) + (size_t)b * H * W * cin;
    const T* w = static_cast<const T*>(wt);
    for (int k0 = 0; k0 < cin; k0 += KC) {
      for (int e = tid; e < 9 * KC * co_blk; e += nthreads) {
        const int co = e % co_blk;
        const int k = (e / co_blk) % KC;
        const int t = e / (co_blk * KC);
        w_s[e] = to_f32(w[((size_t)t * cin + k0 + k) * cout + co0 + co]);
      }
      for (int e = tid; e < IH * IW * KC; e += nthreads) {
        const int k = e % KC;
        const int pix = e / KC;
        const int iy = pix / IW;
        const int ix = pix % IW;
        const int gy = reflect(h0 - 1 + iy, H);
        const int gx = reflect(w0 - 1 + ix, W);
        in_s[(k * IH + iy) * IW + ix] = to_f32(xb[((size_t)gy * W + gx) * cin + k0 + k]);
      }
      __syncthreads();

#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 2
        for (int k = 0; k < KC; ++k) {
          const float* row = in_s + (k * IH + r + dy) * IW + c0;
          float v[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) v[j] = row[j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4* wp = reinterpret_cast<const float4*>(
                w_s + ((dy * 3 + dx) * KC + k) * co_blk + cg * CO);
            const float4 wa = wp[0];
            const float4 wb = wp[1];
            const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < PX; ++j)
#pragma unroll
              for (int i = 0; i < CO; ++i) acc[j][i] = fmaf(v[j + dx], wv[i], acc[j][i]);
          }
        }
      }
      __syncthreads();
    }
  };
  accumulate(a.xa, a.wa, a.cin_a);
  if (two_inputs(EPI) && a.cin_b > 0) accumulate(a.xb, a.wb, a.cin_b);

  const int oy = h0 + r;
  if (oy >= H) return;
  // The epilogue reads each pixel's operands before it stores the pixel: no
  // output aliases an input, but the compiler cannot know that, so a load
  // placed after a store would wait for the store.
  const int ch0 = co0 + cg * CO;
  float bias[CO], lam[CO];
#pragma unroll
  for (int i = 0; i < CO; ++i) {
    bias[i] = a.bias[ch0 + i];
    lam[i] = EPI == EPI_P ? a.lam[ch0 + i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = w0 + c0 + j;
    if (ox >= W) break;
    const size_t base = (((size_t)b * H + oy) * W + ox) * cout + ch0;
    float other[CO];
#pragma unroll
    for (int i = 0; i < CO; ++i) {
      other[i] = EPI == EPI_D || EPI == EPI_P
                     ? to_f32(static_cast<const T*>(a.other)[base + i])
                 : EPI == EPI_OUT_GATE ? static_cast<const float*>(a.other)[base + i]
                                       : 0.f;
    }
#pragma unroll
    for (int i = 0; i < CO; ++i) {
      const float v = acc[j][i] + bias[i];
      if (EPI == EPI_PRE) {
        static_cast<float*>(a.out)[base + i] = v;
        continue;
      }
      float res;
      if (EPI == EPI_D) {
        res = other[i] - v;
      } else if (EPI == EPI_P) {
        const float y = v + other[i];
        res = fmaxf(y - lam[i], 0.f) - fmaxf(-y - lam[i], 0.f);
      } else if (EPI == EPI_RELU) {
        res = fmaxf(v, 0.f);
      } else {  // EPI_OUT_GATE
        res = sigmoid(v) * tanhf(other[i]);
      }
      static_cast<T*>(a.out)[base + i] = from_f32<T>(res);
    }
  }
}

// Output channels per block: the fewest chunks of at most MAX_CO_BLOCK
// channels, each a multiple of CO, that split cout evenly.
inline int co_block_for(int cout) {
  const int groups = cout / CO;
  int chunks = (groups * CO + MAX_CO_BLOCK - 1) / MAX_CO_BLOCK;
  while (groups % chunks) ++chunks;
  return cout / chunks;
}

inline size_t conv_smem_bytes(int co_block) {
  return (size_t)(9 * KC * co_block + KC * IH * IW) * sizeof(float);
}

inline bool conv_shape_ok(int epi, int B, int H, int W, int cin_a, int cin_b, int cout) {
  return B >= 1 && B <= 65535 && H >= 2 && W >= 2 && cin_a >= KC && cin_a % KC == 0 &&
         cin_b >= 0 && cin_b % KC == 0 && (two_inputs(epi) || cin_b == 0) && cout >= CO &&
         cout % CO == 0;
}

// Launches kernel (a __global__ taking ConvArgs) over the whole output on
// stream; returns the launch's cudaError_t.
template <typename Kernel>
cudaError_t launch_conv3x3(Kernel kernel, ConvArgs a, int B, cudaStream_t stream) {
  a.co_block = co_block_for(a.cout);
  const size_t smem = conv_smem_bytes(a.co_block);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  a.tiles_w = (a.W + TW - 1) / TW;
  const int tiles_h = (a.H + TH - 1) / TH;
  const dim3 grid(a.tiles_w * tiles_h, B, a.cout / a.co_block);
  kernel<<<grid, PIX_GROUPS * (a.co_block / CO), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace v2e
