// The dynamic activation scale of int8 inference: one reduction kernel per
// conv site, beside kernel K4 (qconv3x3.cu), which reads the scale it writes.
//
// Replaces the eager passes of ops/qconv.py::_dynamic_scale (abs and amax of
// each part, the maximum of two parts, the product with f32(1 / 127), the
// select) and, in the JAX package, the scale of quantize_activation
// (v2e2v_tpu/ops/qconv.py:74-75, jnp.max(jnp.abs(x)) / 127.0 as compiled XLA
// computes it, 0 -> 1). The wrapper is v2e2v_tpu_torch/ops/cuda/qscale.py.
//
// s_x = max(max |xa|, max |xb|) * f32(1 / 127), 1 where that is 0
//
// over one float32 or bfloat16 tensor or the two parts of a channel concat,
// written as a float32 scalar on the device: no host sync, no memset.
//
// Bound: bytes, each input read once (the gates' 192 channels at B = 8,
// 90x120 in float32: 66 MB, 20 us at 3.35 TB/s).
//
// Design: every thread takes 16-byte loads in a grid-stride loop over both
// parts (a tail of fewer than 16 bytes element by element) and keeps the
// largest |x| as the bits of the float with the sign cleared, compared as
// unsigned integers: that orders finite values and infinities as floats and
// puts a NaN above them, so a NaN propagates as it does in torch.amax. A
// bfloat16 is the upper half of a float32, so its bits shift into the same
// order. Warp shuffles and one shared word per warp give each block's
// maximum, which it writes to its slot of a work buffer before it takes a
// ticket (an atomic add on the buffer's last word); the block that takes the
// last ticket reduces the slots, writes s_x and sets the ticket back to 0
// for the next call. The work buffer is the wrapper's, one per device and
// stream, zeroed once when it is made.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 528;  // 4 blocks of 256 threads on each of an H100's 132 SMs
constexpr float INV_127 = 1.0f / 127.0f;  // f32(1 / f32(127)), as numerics.div_const

__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7FFFFFFFu; }
__device__ __forceinline__ uint32_t abs_bits(__nv_bfloat16 v) {
  return (static_cast<uint32_t>(__bfloat16_as_ushort(v)) & 0x7FFFu) << 16;
}
__device__ __forceinline__ uint32_t word_max(uint32_t w, float) { return w & 0x7FFFFFFFu; }
__device__ __forceinline__ uint32_t word_max(uint32_t w, __nv_bfloat16) {
  return max((w & 0x7FFFu) << 16, w & 0x7FFF0000u);
}

template <typename T>
__device__ __forceinline__ uint32_t part_max(const T* x, long long n, long long t0,
                                             long long stride, uint32_t m) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4* v = reinterpret_cast<const uint4*>(x);
  const long long nv = n / VEC;
  for (long long i = t0; i < nv; i += stride) {
    const uint4 q = __ldg(v + i);
    m = max(m, max(max(word_max(q.x, T()), word_max(q.y, T())),
                   max(word_max(q.z, T()), word_max(q.w, T()))));
  }
  for (long long i = nv * VEC + t0; i < n; i += stride) m = max(m, abs_bits(x[i]));
  return m;
}

// The largest of every thread's m, in thread 0 (all threads take part).
__device__ __forceinline__ uint32_t block_max(uint32_t m, uint32_t* warp_max) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < THREADS / 32; ++w) m = max(m, warp_max[w]);
  return m;
}

// gridDim.x <= MAX_BLOCKS, blockDim.x = THREADS. work: MAX_BLOCKS slots and
// the ticket, which is 0 between calls.
template <typename T>
__global__ void __launch_bounds__(THREADS) qscale_kernel(const T* xa, long long na, const T* xb,
                                                         long long nb, uint32_t* work,
                                                         float* s_x) {
  __shared__ uint32_t warp_max[THREADS / 32];
  __shared__ bool last;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  uint32_t m = part_max(xa, na, t0, stride, 0u);
  if (nb) m = part_max(xb, nb, t0, stride, m);
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) {
    work[blockIdx.x] = m;
    __threadfence();  // the slot is visible before the ticket is taken
    last = atomicAdd(&work[MAX_BLOCKS], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  __threadfence();
  m = 0;
  for (int i = threadIdx.x; i < gridDim.x; i += THREADS) m = max(m, __ldcg(&work[i]));
  __syncthreads();  // warp_max is free again
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) {
    const float s = __fmul_rn(__uint_as_float(m), INV_127);
    *s_x = s == 0.f ? 1.f : s;
    work[MAX_BLOCKS] = 0;
  }
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// s_x (a float32 scalar) = max |x| / 127 over xa [na elements] and xb [nb
// elements, or none: nb == 0], both float32 (bf16 == 0) or bfloat16, 1 where
// that is 0. work: v2e_qscale_work_words() uint32 words, zero before the
// first call and left so. Needs xa and xb on 16-byte boundaries. Returns the
// cudaError_t of the launch.
int v2e_qscale(const void* xa, long long na, const void* xb, long long nb, int bf16, void* work,
               void* s_x, void* stream) {
  if (na < 1 || nb < 0 || !aligned(xa) || (nb && !aligned(xb)) || !work || !s_x)
    return (int)cudaErrorInvalidValue;
  const long long vec = bf16 ? 8 : 4;
  const long long n16 = (na + vec - 1) / vec + (nb + vec - 1) / vec;  // 16-byte loads
  const long long want = (n16 + 4LL * THREADS - 1) / (4LL * THREADS);   // 4 loads a thread or more
  const int blocks = (int)(want < 1 ? 1 : want > MAX_BLOCKS ? MAX_BLOCKS : want);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w = static_cast<uint32_t*>(work);
  float* out = static_cast<float*>(s_x);
  if (bf16)
    qscale_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xa), na, static_cast<const __nv_bfloat16*>(xb), nb, w,
        out);
  else
    qscale_kernel<float><<<blocks, THREADS, 0, s>>>(static_cast<const float*>(xa), na,
                                                    static_cast<const float*>(xb), nb, w, out);
  return (int)cudaGetLastError();
}

// Words of the work buffer v2e_qscale takes.
int v2e_qscale_work_words() { return MAX_BLOCKS + 1; }

}  // extern "C"
