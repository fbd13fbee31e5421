// K1 for Hopper: the weight-tied ISTA loop of CISTA-LSTC.
//
// Replaces v2e2v_tpu/ops/pallas/ista.py::ista_loop_pallas (_ista_kernel).
// One ISTA iteration is two reflect-padded 3x3 convolutions with fused
// epilogues, and the wrapper (v2e2v_tpu_torch/ops/cuda/ista.py) launches this
// kernel 2 x depth times on PyTorch's current stream:
//
//   MODE_D: xm = cast(x1 - (conv3x3_reflect(z, D) + b_D))          2C -> C
//   MODE_P: z' = cast(softshrink(conv3x3_reflect(xm, P) + b_P + z, lambda))
//                                                                  C -> 2C
//
// z' goes to the other buffer of a ping-pong pair, so the neighbours of a
// tile still read the old z. Activations are float32 or bfloat16; taps,
// biases and lambda arrive already cast to the activation type (as in the
// Pallas kernel) and every sum is float32.
//
// Bound on an H100: 2 * 9 * B*H*W * (2C*C + C*2C) * depth FLOPs, which is
// 127 GFLOP per pool step at the flagship shape (B = 8, 90x120, C = 64,
// depth 5): 1.9 ms at the 67 TFLOP/s of float32 on CUDA cores, 0.13 ms at the
// 989 TFLOP/s of bfloat16 on tensor cores. The bytes it must move (x1, z in,
// z out, ~110 MB in float32) take 33 us at 3.35 TB/s, so it is bound by
// operations. This first design is a plain SIMT direct convolution: a block
// owns an 8x16 output tile and every output channel, stages an 8-channel
// chunk of the input tile (with its 1-pixel reflect halo) and of the 9 taps in
// shared memory as float32, and each thread keeps a 4-pixel x 8-channel
// float32 accumulator in registers, reusing each loaded input row for the
// three horizontal taps. It does not use the tensor cores; wgmma with TMA
// loads and a persistent kernel are the way to the bfloat16 bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;    // output tile rows
constexpr int TW = 16;   // output tile columns
constexpr int KC = 8;    // input channels staged per shared-memory chunk
constexpr int PX = 4;    // output pixels per thread, along a row
constexpr int CO = 8;    // output channels per thread
constexpr int IH = TH + 2;
constexpr int IW = TW + 2;
constexpr int PIX_GROUPS = TH * TW / PX;  // 32 pixel groups per tile

enum { MODE_D = 0, MODE_P = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// torch padding_mode='reflect' for a 1-pixel halo: -1 -> 1, n -> n-2. Rows
// and columns past the halo belong to a ragged tile's masked outputs and are
// only clamped.
__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : i;
  i = i >= n ? 2 * (n - 1) - i : i;
  return min(max(i, 0), n - 1);
}

// x: [B, H, W, cin]; w: taps [9, cin, cout]; bias: [cout];
// other: x1 [B, H, W, cout] (MODE_D) or the old z [B, H, W, cout] (MODE_P);
// lam: [cout] (MODE_P only); out: [B, H, W, cout].
// blockDim.x == PIX_GROUPS * cout / CO <= 512 (cout <= 128, so that ptxas may
// give each thread 128 registers); gridDim = (tiles_h * tiles_w, B).
template <typename T, int MODE>
__global__ void __launch_bounds__(512) ista_conv3x3_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ other, const T* __restrict__ lam, T* __restrict__ out,
    int H, int W, int cin, int cout, int tiles_w) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [9][KC][cout]
  float* in_s = w_s + 9 * KC * cout;             // [KC][IH][IW]

  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int ncg = cout / CO;
  const int tid = threadIdx.x;
  const int cg = tid % ncg;
  const int pg = tid / ncg;
  const int r = pg / (TW / PX);
  const int c0 = (pg % (TW / PX)) * PX;
  const int nthreads = blockDim.x;
  const T* xb = x + (size_t)b * H * W * cin;

  float acc[PX][CO];
#pragma unroll
  for (int j = 0; j < PX; ++j)
#pragma unroll
    for (int i = 0; i < CO; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += KC) {
    for (int e = tid; e < 9 * KC * cout; e += nthreads) {
      const int co = e % cout;
      const int k = (e / cout) % KC;
      const int t = e / (cout * KC);
      w_s[e] = to_f32(w[((size_t)t * cin + k0 + k) * cout + co]);
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
        float a[PX + 2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) a[j] = row[j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w_s + ((dy * 3 + dx) * KC + k) * cout + cg * CO);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[CO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int i = 0; i < CO; ++i) acc[j][i] = fmaf(a[j + dx], wv[i], acc[j][i]);
        }
      }
    }
    __syncthreads();
  }

  const int oy = h0 + r;
  if (oy >= H) return;
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    const int ox = w0 + c0 + j;
    if (ox >= W) break;
    const size_t base = (((size_t)b * H + oy) * W + ox) * cout + cg * CO;
#pragma unroll
    for (int i = 0; i < CO; ++i) {
      const float v = acc[j][i] + to_f32(bias[cg * CO + i]);
      if (MODE == MODE_D) {
        out[base + i] = from_f32<T>(to_f32(other[base + i]) - v);
      } else {
        const float y = v + to_f32(other[base + i]);
        const float l = to_f32(lam[cg * CO + i]);
        out[base + i] = from_f32<T>(fmaxf(y - l, 0.f) - fmaxf(-y - l, 0.f));
      }
    }
  }
}

size_t smem_bytes(int cout) { return (size_t)(9 * KC * cout + KC * IH * IW) * sizeof(float); }

template <typename T, int MODE>
cudaError_t launch(const void* x, const void* w, const void* bias, const void* other,
                   const void* lam, void* out, int B, int H, int W, int cin, int cout,
                   cudaStream_t stream) {
  auto kernel = ista_conv3x3_kernel<T, MODE>;
  const size_t smem = smem_bytes(cout);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_w * tiles_h, B);
  kernel<<<grid, PIX_GROUPS * (cout / CO), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(other), static_cast<const T*>(lam), static_cast<T*>(out), H, W,
      cin, cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One conv of the ISTA loop. dtype: 0 = float32, 1 = bfloat16; mode: 0 = D
// conv with the x1 - (.) epilogue, 1 = P conv with the + z, softshrink
// epilogue. Returns the cudaError_t of the launch.
int v2e_ista_conv3x3(int dtype, int mode, const void* x, const void* w, const void* bias,
                     const void* other, const void* lam, void* out, int B, int H, int W,
                     int cin, int cout, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || cin < KC || cin % KC || cout < CO ||
      cout % CO || PIX_GROUPS * (cout / CO) > 512 || (mode != MODE_D && mode != MODE_P) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(mode == MODE_D
                     ? launch<float, MODE_D>(x, w, bias, other, lam, out, B, H, W, cin, cout, s)
                     : launch<float, MODE_P>(x, w, bias, other, lam, out, B, H, W, cin, cout, s));
  return (int)(mode == MODE_D
                   ? launch<__nv_bfloat16, MODE_D>(x, w, bias, other, lam, out, B, H, W, cin,
                                                   cout, s)
                   : launch<__nv_bfloat16, MODE_P>(x, w, bias, other, lam, out, B, H, W, cin,
                                                   cout, s));
}

// Dynamic shared memory of one block of the conv with cout output channels.
int v2e_ista_conv3x3_smem_bytes(int cout) { return (int)smem_bytes(cout); }

const char* v2e_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
