// The skeleton shared by the GLS element kernel (gls_element.cu), the
// GLS lattice kernel (gls_lattice.cu) and the GD lattice kernel
// (gd_lattice.cu) on Hopper (sm_90a).
//
// Each reads row blocks [R, E] (element index fastest) and writes [R', E].
// A launch is a persistent grid: at most as many blocks as fit on the
// card at once (the occupancy times the SM count, sized by the caller),
// each loading its constant tables into shared memory once (B3 takes its
// tables in the kernel parameters) and then walking element tiles of BE
// elements with a grid-stride loop.  A tile's
// rows (an R x BE box of each input) are loaded asynchronously into a
// ring of two shared-memory stages, so tile i+1 is in flight while tile i
// computes.  An input's elements are 4 bytes (f32, row pitch E) or 2
// bytes (bf16, the frozen linearization state of B1 and B2, row pitch
// Inputs::narrow_pitch, an even number of elements); each stays in its own
// type in the stage and is widened to f32 where the kernel reads it.  Two
// load paths, chosen by the caller per launch:
//   LOAD_TMA          one cp.async.bulk.tensor per input and stage, issued
//                     by one thread and completed on an mbarrier; needs
//                     every row pitch a multiple of 16 bytes (E % 4 == 0
//                     for f32 rows) and 16-byte aligned rows.  The
//                     tensor maps are encoded on the host, kept in a cache
//                     keyed by (address, element type, E, pitch, rows,
//                     box), and passed as __grid_constant__;
//   LOAD_CP_ASYNC_4   cp.async of 4 bytes per f32 element or bf16 pair, for
//                     any f32 pitch and any even bf16 pitch.
// (A 16-byte cp.async path was measured against TMA and lost at 47 of 48
// staged shape-variants: PERF.md.)  A ragged last tile is zero-filled by
// both paths (src-size 0, or 2 for a bf16 pair with one element left, for
// cp.async; out-of-bounds fill for TMA); nothing is read past E.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace tiles {

constexpr int LOAD_CP_ASYNC_4 = 0;
constexpr int LOAD_TMA = 1;
constexpr int STAGES = 2;
constexpr int MAX_INPUTS = 6;

// shared-memory offsets are rounded to 32 floats (128 bytes), the
// alignment a TMA destination needs
__host__ __device__ constexpr int pad32(int n) { return (n + 31) / 32 * 32; }

// words (4 bytes) of one input's R x BE box of `esz`-byte elements in a
// stage, rounded up to 128 bytes
__host__ __device__ constexpr int box_words(int rows, int be, int esz) {
  return pad32(rows * be * esz / 4);
}

// The input rows of one launch: pointer and row count per input, each
// input's tensor map for the TMA path, and the row pitch (elements) of its
// 2-byte inputs.  A 4-byte input's row pitch is E.
struct Inputs {
  CUtensorMap maps[MAX_INPUTS];
  const void* ptr[MAX_INPUTS];
  int rows[MAX_INPUTS];
  int64_t narrow_pitch;
};

// The state type of a kernel instance from its element bytes (4: f32, 2:
// bf16), and the widening read of one element
template <int SE>
using state_t = typename std::conditional<SE == 4, float, __nv_bfloat16>::type;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element i of a row block of type T staged at `base` in shared memory
template <class T>
__device__ __forceinline__ float ld(const float* base, int i) {
  return widen(reinterpret_cast<const T*>(base)[i]);
}

// element i of a row block of type T in global memory, through the
// read-only cache
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_rows(float* dst, const CUtensorMap* map,
                                              int e0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(e0), "r"(0),
      "r"(smem_u32(bar))
      : "memory");
}

// The ring of STAGES stages.  A stage holds, per input k, an R_k x BE box
// of ESZ[k]-byte elements at word offset OFF[k] (0 for an input the
// variant does not read).
template <int BE, int THREADS, int NIN>
struct Ring {
  float* base;          // stage 0; stage s at base + s * stage_floats
  int stage_floats;
  uint64_t* bars;       // STAGES mbarriers (TMA path)
  int path;

  __device__ __forceinline__ float* stage(int s) const {
    return base + s * stage_floats;
  }

  // First call, by every thread, before the block's first barrier.
  __device__ __forceinline__ void init(int tid) const {
    if (path == LOAD_TMA && tid == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) mbar_init(bars + s);
      mbar_fence_init();
    }
  }

  // Starts the loads of tile `e0 / BE` into stage s (every thread calls).
  __device__ __forceinline__ void issue(const Inputs& in, const int (&off)[NIN],
                                        const int (&esz)[NIN],
                                        uint32_t stage_bytes, int64_t E,
                                        int64_t e0, int s, int tid) const {
    float* dst = stage(s);
    if (path == LOAD_TMA) {
      if (tid == 0) {
        mbar_expect_tx(bars + s, stage_bytes);
#pragma unroll
        for (int k = 0; k < NIN; ++k)
          if (in.rows[k] > 0)
            tma_load_rows(dst + off[k], &in.maps[k], (int)e0, bars + s);
      }
      return;
    }
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      const int R = in.rows[k];
      float* d = dst + off[k];
      if (esz[k] == 4) {
        const float* src = static_cast<const float*>(in.ptr[k]);
        for (int i = tid; i < R * BE; i += THREADS) {
          const int r = i / BE, c = i % BE;
          const bool ok = e0 + c < E;
          cp_async4(d + r * BE + c, ok ? src + (int64_t)r * E + e0 + c : src,
                    ok ? 4 : 0);
        }
      } else {
        // bf16: one 4-byte copy per pair (c, c + 1), c even, of a row whose
        // pitch is even, so every pair is 4-byte aligned; a pair with one
        // element left copies 2 bytes and zero-fills the other
        const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(in.ptr[k]);
        const int64_t P = in.narrow_pitch;
        constexpr int HALF = BE / 2;
        for (int i = tid; i < R * HALF; i += THREADS) {
          const int r = i / HALF, c = 2 * (i % HALF);
          const int64_t left = E - (e0 + c);
          const int bytes = left >= 2 ? 4 : (left == 1 ? 2 : 0);
          cp_async4(d + r * HALF + c / 2,
                    bytes ? src + (int64_t)r * P + e0 + c : src, bytes);
        }
      }
    }
    cp_async_commit();
  }

  // No load this iteration: keeps the cp.async group count uniform.
  __device__ __forceinline__ void skip() const {
    if (path != LOAD_TMA) cp_async_commit();
  }

  // Waits for the stage of iteration `it` (every thread calls; a
  // __syncthreads must follow before the stage is read).
  __device__ __forceinline__ void wait(int it) const {
    if (path == LOAD_TMA)
      mbar_wait(bars + (it % STAGES), (uint32_t)((it / STAGES) & 1));
    else
      cp_async_wait_prev();
  }
};

// ---------------------------------------------------------------- host --
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// The tensor map of one input [rows, E] of `esz`-byte elements (f32 or
// bf16) with row pitch `pitch` elements and box BE x rows.  A map depends
// on nothing else, so each is encoded once and kept: the solver loops
// reuse a handful of addresses, and encoding on every launch would add
// host time to every launch.  The key holds the element type too: the
// caching allocator hands one address to an f32 and then a bf16 buffer of
// the same E, rows and box.  The MAP_CACHE entries are replaced in turn.
constexpr int MAP_CACHE = 64;

inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int64_t E,
                              int64_t pitch, int rows, int box, int esz) {
  struct Key {
    const void* ptr;
    int64_t E, pitch;
    int rows, box, esz;
  };
  static std::mutex mu;
  static Key keys[MAP_CACHE];
  static CUtensorMap maps[MAP_CACHE];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i].ptr == ptr && keys[i].E == E && keys[i].pitch == pitch &&
        keys[i].rows == rows && keys[i].box == box && keys[i].esz == esz) {
      *map = maps[i];
      return cudaSuccess;
    }
  EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  cuuint64_t dims[2] = {(cuuint64_t)E, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)pitch * esz};
  cuuint32_t boxdim[2] = {(cuuint32_t)box, (cuuint32_t)rows};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(&maps[next],
                        esz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(ptr), dims, strides, boxdim, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = Key{ptr, E, pitch, rows, box, esz};
  *map = maps[next];
  next = (next + 1) % MAP_CACHE;
  if (used < MAP_CACHE) ++used;
  return cudaSuccess;
}

// Fills in.maps for the TMA path (inputs with 0 rows are skipped); input
// k has esz[k]-byte elements.
inline cudaError_t encode_inputs(Inputs& in, int n, int64_t E, int BE,
                                 const int* esz) {
  for (int k = 0; k < n; ++k) {
    if (in.rows[k] == 0) continue;
    const int64_t pitch = esz[k] == 4 ? E : in.narrow_pitch;
    const cudaError_t err = tensor_map(&in.maps[k], in.ptr[k], E, pitch,
                                       in.rows[k], BE, esz[k]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Opts the kernel in to `smem` bytes of dynamic shared memory (once) and
// returns how many of its blocks fit on one SM.
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                       smem);
}

}  // namespace tiles
