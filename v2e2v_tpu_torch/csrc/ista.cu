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
// Pallas kernel; the wrapper hands the cast bias and lambda over as float32)
// and every sum is float32.
//
// Bound on an H100: 2 * 9 * B*H*W * (2C*C + C*2C) * depth FLOPs, which is
// 127 GFLOP per pool step at the flagship shape (B = 8, 90x120, C = 64,
// depth 5): 1.9 ms at the 67 TFLOP/s of float32 on CUDA cores, 0.13 ms at the
// 989 TFLOP/s of bfloat16 on tensor cores. The bytes it must move (x1, z in,
// z out, ~110 MB in float32) take 33 us at 3.35 TB/s, so it is bound by
// operations in both types. Float32 (float32 products and sums, so no tensor
// cores) runs on the conv of conv3x3.cuh: FFMA on CUDA cores, 8x32-pixel x
// 64-channel tiles (8x16 or 8x8 where the grid would not fill the card, as
// for the D conv at batch 1), 64 accumulators a thread, inputs and taps
// staged by cp.async and cp.async.bulk through a ring, the taps laid out once
// by the wrapper. Bfloat16 runs on the wgmma implicit GEMM of conv3x3_tc.cuh
// (16x8 output tiles, 64 or 128 output channels a block, the input tile
// staged once per 64-channel chunk and read by all 9 taps, the taps laid out
// once by the wrapper and streamed by cp.async.bulk through a ring). Both
// take any C % 8 == 0 and tensors on 16-byte boundaries.

#include "conv3x3.cuh"
#include "conv3x3_tc.cuh"

namespace {

using v2e::ConvArgs;

template <int MODE, int GX>
__global__ void __launch_bounds__(v2e::Tile<GX>::THREADS, 1) ista_conv3x3_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  v2e::conv3x3_block<MODE, GX>(a, reinterpret_cast<uint8_t*>(smem4));
}

template <int MODE>
cudaError_t launch_f32(const ConvArgs& a, int B, cudaStream_t s) {
  const v2e::ConvKernel kernels[3] = {ista_conv3x3_kernel<MODE, 1>, ista_conv3x3_kernel<MODE, 2>,
                                      ista_conv3x3_kernel<MODE, 4>};
  return v2e::launch_conv3x3(kernels, a, B, s);
}

template <int MODE, int NB>
__global__ void __launch_bounds__(v2e::tc::THREADS, 2) ista_conv3x3_tc_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  v2e::tc::conv3x3_block<MODE, NB>(a, reinterpret_cast<uint8_t*>(smem4));
}

template <int MODE>
cudaError_t launch_tc(const ConvArgs& a, int B, cudaStream_t s) {
  return v2e::tc::n_block(a.cout) == 128
             ? v2e::tc::launch(ista_conv3x3_tc_kernel<MODE, 128>, a, B, 128, s)
             : v2e::tc::launch(ista_conv3x3_tc_kernel<MODE, 64>, a, B, 64, s);
}

// float32 on the CUDA cores, bfloat16 on the tensor cores
cudaError_t launch(int dtype, int mode, const ConvArgs& a, int B, cudaStream_t s) {
  if (dtype == 0)
    return mode == v2e::EPI_D ? launch_f32<v2e::EPI_D>(a, B, s) : launch_f32<v2e::EPI_P>(a, B, s);
  return mode == v2e::EPI_D ? launch_tc<v2e::EPI_D>(a, B, s) : launch_tc<v2e::EPI_P>(a, B, s);
}

}  // namespace

extern "C" {

// One conv of the ISTA loop. dtype: 0 = float32, 1 = bfloat16; mode: 0 = D
// conv with the x1 - (.) epilogue, 1 = P conv with the + z, softshrink
// epilogue. x, w, other and out are of the dtype (w: taps [9, cin, cout] laid
// out by ops/cuda/conv_tc.py, simt_taps in float32 and wgmma_taps in
// bfloat16; every tensor on a 16-byte boundary); bias [cout] and lam [cout]
// (mode 1 only) are float32.
// Returns the cudaError_t of the launch.
int v2e_ista_conv3x3(int dtype, int mode, const void* x, const void* w, const void* bias,
                     const void* other, const void* lam, void* out, int B, int H, int W,
                     int cin, int cout, void* stream) {
  if (!v2e::conv_shape_ok(mode, B, H, W, cin, 0, cout) || (mode != v2e::EPI_D && mode != v2e::EPI_P) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.xa = x;
  a.wa = w;
  a.cin_a = cin;
  a.bias = static_cast<const float*>(bias);
  a.other = other;
  a.lam = static_cast<const float*>(lam);
  a.out = out;
  a.H = H;
  a.W = W;
  a.cout = cout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch(dtype, mode, a, B, s);
}

// The float32 conv's tile for a conv of B x H x W x cout outputs on the
// current device: its width in pixels (8, 16 or 32; 8 rows), or -1 if the
// device cannot be queried.
int v2e_conv3x3_tile_w(int B, int H, int W, int cout) {
  int sms = 0;
  if (v2e::conv_sms(&sms) != cudaSuccess) return -1;
  return v2e::PX * v2e::conv_tile_groups(B, H, W, cout, sms);
}

// Dynamic shared memory of one block: the float32 conv's for a tile tile_w
// pixels wide, and the bfloat16 (tensor-core) conv's for cout channels.
int v2e_conv3x3_smem_bytes(int tile_w) { return v2e::conv_smem_bytes(tile_w / v2e::PX); }

int v2e_conv3x3_tc_smem_bytes(int cout) {
  return (int)v2e::tc::smem_bytes(v2e::tc::n_block(cout));
}

const char* v2e_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
