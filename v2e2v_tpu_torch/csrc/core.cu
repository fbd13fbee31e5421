// K2 for Hopper: the half-resolution core of one CISTA-LSTC step.
//
// Replaces v2e2v_tpu/ops/pallas/core.py::cista_core_pallas (_core_kernel):
// ConvLSTC, depth weight-tied ISTA iterations, relu(Dg conv), ConvLSTM. The
// Pallas kernel keeps a whole [H*W, C] plane and the recurrent state in
// ~110 MB of VMEM for the step; an H100 block has 227 KB, so here every conv
// is a launch of the tiled reflect conv of conv3x3.cuh, its elementwise work
// in its epilogue, and the two cell updates that need channels from two
// output chunks are small kernels of their own. The wrapper
// (v2e2v_tpu_torch/ops/cuda/core.py) issues 7 + 2 * depth launches on
// PyTorch's current stream:
//
//   pre_g  = conv(x1, wg_x) + conv(z, wg_z) + b_g            EPI_PRE   C+2C -> 4C
//   z0     = conv(x1, w_p0) + b_p0                           EPI_PRE   C -> 2C
//   lstc_cell: in, forget = sigmoid(pre_g); cell32 = forget * cell + in * z0;
//              cell' = cast(cell32), z0_t = cast(z0)
//   z'     = cast(sigmoid(conv(z0_t, wog_z0) + conv(z, wog_z) + b_og)
//                 * tanh(cell32))                            EPI_OUT_GATE
//   depth x { xm = cast(x1 - (conv(z', w_d) + b_d))          EPI_D
//             z' = cast(softshrink(conv(xm, w_p) + b_p + z', lambda)) }  EPI_P
//   xg     = cast(relu(conv(z', w_dg) + b_dg))               EPI_RELU
//   pre_l  = conv(xg, wl_x) + conv(dg_h, wl_h) + b_l         EPI_PRE   C+C -> 4C
//   lstm_cell: i, r, o = sigmoid, g = tanh of pre_l;
//              hc = r * dg_c + i * g; dg_c' = cast(hc), dg_h' = cast(o * tanh(hc))
//
// These are the Pallas kernel's cast points: the gate and cell algebra is
// float32, the cell stays float32 (in scratch) between the cell update and the
// out gate, and z0 is cast to the activation type only where it feeds the out
// gate's conv. Taps are in the activation type T; biases and lambda float32.
// The ISTA iterate ping-pongs between two buffers, and every output is a new
// buffer, so the inputs stay as they were.
//
// Bound on an H100: 2 * 9 * B*H*W * 52 * C^2 FLOPs for the convs (gates 12,
// P0 2, out gates 8, ISTA 4 per iteration, Dg 2, ConvLSTM gates 8, in units of
// C^2 multiply-adds per tap and pixel, at depth 5), 331 GFLOP at B = 8,
// 90x120, C = 64: 4.94 ms at the 67 TFLOP/s of float32 on CUDA cores, 0.335 ms
// at the 989 TFLOP/s of bfloat16 on tensor cores. Its activations in and out
// (~288 MB in float32) take 86 us at 3.35 TB/s, so it is bound by operations.
// Float32 (float32 products and sums) runs its convs on the FFMA conv of
// conv3x3.cuh (8x32-pixel x 64-channel tiles, 64 accumulators a thread,
// operands staged asynchronously through a ring); bfloat16 runs them on the
// wgmma implicit GEMM of conv3x3_tc.cuh, with the same epilogues. The next
// step to the bound is fusing the launches (the float32 cell and gate
// pre-activations kept on chip).

#include "conv3x3.cuh"
#include "conv3x3_tc.cuh"

namespace {

using v2e::ConvArgs;
using v2e::from_f32;
using v2e::sigmoid;
using v2e::to_f32;

template <int EPI, int GX>
__global__ void __launch_bounds__(v2e::Tile<GX>::THREADS, 1) core_conv3x3_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  v2e::conv3x3_block<EPI, GX>(a, reinterpret_cast<uint8_t*>(smem4));
}

// ConvLSTC cell over n = pixels * c2 elements (c2 = 2C): pre_g [P, 2 * c2]
// holds the in gates then the forget gates of each pixel.
template <typename T>
__global__ void core_lstc_cell_kernel(const float* __restrict__ pre_g,
                                      const float* __restrict__ z0,
                                      const T* __restrict__ cell_in, float* __restrict__ cell32,
                                      T* __restrict__ cell_out, T* __restrict__ z0_out,
                                      size_t n, int c2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t p = i / c2;
  const int k = (int)(i % c2);
  const float in_g = sigmoid(pre_g[p * 2 * c2 + k]);
  const float forget_g = sigmoid(pre_g[p * 2 * c2 + c2 + k]);
  const float z0v = z0[i];
  const float cell = forget_g * to_f32(cell_in[i]) + in_g * z0v;
  cell32[i] = cell;
  cell_out[i] = from_f32<T>(cell);
  z0_out[i] = from_f32<T>(z0v);
}

// ConvLSTM cell over n = pixels * c elements: pre_l [P, 4c] holds the in,
// remember, out and cell gates of each pixel, in that order.
template <typename T>
__global__ void core_lstm_cell_kernel(const float* __restrict__ pre_l,
                                      const T* __restrict__ c_in, T* __restrict__ h_out,
                                      T* __restrict__ c_out, size_t n, int c) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* g = pre_l + (i / c) * 4 * c + (int)(i % c);
  const float in_g = sigmoid(g[0]);
  const float rem_g = sigmoid(g[c]);
  const float out_g = sigmoid(g[2 * c]);
  const float cell_g = tanhf(g[3 * c]);
  const float hc = rem_g * to_f32(c_in[i]) + in_g * cell_g;
  c_out[i] = from_f32<T>(hc);
  h_out[i] = from_f32<T>(out_g * tanhf(hc));
}

template <int EPI, int NB>
__global__ void __launch_bounds__(v2e::tc::THREADS, 2) core_conv3x3_tc_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  v2e::tc::conv3x3_block<EPI, NB>(a, reinterpret_cast<uint8_t*>(smem4));
}

// float32 on the CUDA cores, bfloat16 on the tensor cores
template <int EPI>
cudaError_t launch_epi(int dtype, const ConvArgs& a, int B, cudaStream_t s) {
  if (dtype == 0) {
    const v2e::ConvKernel kernels[3] = {core_conv3x3_kernel<EPI, 1>, core_conv3x3_kernel<EPI, 2>,
                                        core_conv3x3_kernel<EPI, 4>};
    return v2e::launch_conv3x3(kernels, a, B, s);
  }
  return v2e::tc::n_block(a.cout) == 128
             ? v2e::tc::launch(core_conv3x3_tc_kernel<EPI, 128>, a, B, 128, s)
             : v2e::tc::launch(core_conv3x3_tc_kernel<EPI, 64>, a, B, 64, s);
}

cudaError_t launch_conv(int dtype, int epi, const ConvArgs& a, int B, cudaStream_t s) {
  switch (epi) {
    case v2e::EPI_D: return launch_epi<v2e::EPI_D>(dtype, a, B, s);
    case v2e::EPI_P: return launch_epi<v2e::EPI_P>(dtype, a, B, s);
    case v2e::EPI_PRE: return launch_epi<v2e::EPI_PRE>(dtype, a, B, s);
    case v2e::EPI_RELU: return launch_epi<v2e::EPI_RELU>(dtype, a, B, s);
    default: return launch_epi<v2e::EPI_OUT_GATE>(dtype, a, B, s);
  }
}

constexpr int EW_THREADS = 256;

inline unsigned ew_blocks(size_t n) { return (unsigned)((n + EW_THREADS - 1) / EW_THREADS); }

}  // namespace

extern "C" {

// One conv of the core. dtype: 0 = float32, 1 = bfloat16; epi: the
// v2e::Epilogue. xa [B, H, W, cin_a] with taps wa [9, cin_a, cout], and
// optionally xb [B, H, W, cin_b] with wb [9, cin_b, cout] (cin_b = 0: none);
// the taps laid out by ops/cuda/conv_tc.py (simt_taps in float32, wgmma_taps
// in bfloat16) and every tensor on a 16-byte boundary;
// bias [cout] float32; other and lam as the epilogue needs them; out
// [B, H, W, cout], float32 for EPI_PRE and of the dtype otherwise. Returns the
// cudaError_t of the launch.
int v2e_core_conv3x3(int dtype, int epi, const void* xa, const void* wa, int cin_a,
                     const void* xb, const void* wb, int cin_b, const void* bias,
                     const void* other, const void* lam, void* out, int B, int H, int W,
                     int cout, void* stream) {
  if (!v2e::conv_shape_ok(epi, B, H, W, cin_a, cin_b, cout) || epi < v2e::EPI_D ||
      epi > v2e::EPI_OUT_GATE || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  ConvArgs a{};
  a.xa = xa;
  a.wa = wa;
  a.cin_a = cin_a;
  a.xb = xb;
  a.wb = wb;
  a.cin_b = cin_b;
  a.bias = static_cast<const float*>(bias);
  a.other = other;
  a.lam = static_cast<const float*>(lam);
  a.out = out;
  a.H = H;
  a.W = W;
  a.cout = cout;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_conv(dtype, epi, a, B, s);
}

// The ConvLSTC cell update over pixels x c2 elements (see above).
int v2e_core_lstc_cell(int dtype, const void* pre_g, const void* z0, const void* cell_in,
                       void* cell32, void* cell_out, void* z0_out, int pixels, int c2,
                       void* stream) {
  if (pixels < 1 || c2 < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)pixels * c2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(pre_g);
  const auto* z = static_cast<const float*>(z0);
  auto* c32 = static_cast<float*>(cell32);
  if (dtype == 0)
    core_lstc_cell_kernel<float><<<ew_blocks(n), EW_THREADS, 0, s>>>(
        g, z, static_cast<const float*>(cell_in), c32, static_cast<float*>(cell_out),
        static_cast<float*>(z0_out), n, c2);
  else
    core_lstc_cell_kernel<__nv_bfloat16><<<ew_blocks(n), EW_THREADS, 0, s>>>(
        g, z, static_cast<const __nv_bfloat16*>(cell_in), c32,
        static_cast<__nv_bfloat16*>(cell_out), static_cast<__nv_bfloat16*>(z0_out), n, c2);
  return (int)cudaGetLastError();
}

// The ConvLSTM cell update over pixels x c elements (see above).
int v2e_core_lstm_cell(int dtype, const void* pre_l, const void* c_in, void* h_out,
                       void* c_out, int pixels, int c, void* stream) {
  if (pixels < 1 || c < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)pixels * c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(pre_l);
  if (dtype == 0)
    core_lstm_cell_kernel<float><<<ew_blocks(n), EW_THREADS, 0, s>>>(
        g, static_cast<const float*>(c_in), static_cast<float*>(h_out),
        static_cast<float*>(c_out), n, c);
  else
    core_lstm_cell_kernel<__nv_bfloat16><<<ew_blocks(n), EW_THREADS, 0, s>>>(
        g, static_cast<const __nv_bfloat16*>(c_in), static_cast<__nv_bfloat16*>(h_out),
        static_cast<__nv_bfloat16*>(c_out), n, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
