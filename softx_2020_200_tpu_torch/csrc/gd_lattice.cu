// Grad-div Taylor-Hood (GD) lattice kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel B3: softx_2020_200_tpu/ops/pallas_lattice_gd.py,
// _build_gd_kernel (:59), with its constant tables from _gd_affine_tables
// (:36), launched through pl.pallas_call at :229.  On a lattice whose
// elements are all translates of one box the geometry folds into constant
// matrices: Tv [(d+1)*nq, nnv] (values and the d physical gradients of the
// Q(k+1) velocity basis at the quadrature points), Tp [nq, nnp] (values of
// the Qk pressure basis), and their projections Pv [nnv, (d+1)*nq] and
// Pp [nnp, nq] (transposes with det J * w folded in).  Every element does
//   interpolate:  vel_i, grad vel_i = Tv @ u_i;  p = Tp @ u_p
//   physics:      a_v = alpha0 u + u_prev + (u.grad)u - f
//                 a_g = nu grad u + (gamma div u - p) I;  a_p = div u
//   project:      out_i = Pv @ [a_v_i; a_g_i*];  out_p = Pp @ a_p
// as the TPU kernel does in its body.  The GD weak form has no
// stabilization parameter, so the tangent is the exact Jacobian action:
//   a_v = alpha0 du + (du.grad)u + (u.grad)du,  a_g = nu grad du
//         + (gamma div du - dp) I,  a_p = div du
// (it reads neither u_prev nor f).  The products are f32 on the CUDA cores
// (no tensor cores, so no TF32), as the TPU kernel's HIGHEST-precision dots.
//
// Two variants (MODE): PRIMAL, the residual; TANGENT, the directional
// derivative along due.
//
// Layout: mixed component-major rows with the element index fastest, as
// B3's: ue[RS, E] with RS = d*nnv + nnp (velocity component i at rows
// i*nnv + n, then the pressure at rows d*nnv + m), due like ue,
// vpe[d*nnv, E], fq[d*nq, E] (row i*nq + q); out[RS, E].  Compiled for
// Q2-Q1 in 2D and 3D with 3 Gauss points per axis.  A block takes BE
// elements (32 in 2D, 16 in 3D) and runs max(nq, nnv)*BE threads in two
// phases:
//   A  thread (q, e) interpolates, evaluates the physics at quadrature
//      point q of element e and stages its (d+1)*d + 1 coefficients in
//      shared memory;
//   B  thread (n, e) projects: out[i*nnv + n, e] = sum_r Pv[n, r] C_i[r, e]
//      for each velocity component i, and for n < nnp the pressure row.
// The tables (2.2 KB in 2D; 25 KB in 3D, Tv and Pv 108 x 27 each), the
// block's input rows and its coefficients (3D: 351 per element) live in
// shared memory (3D: about 58 KB a block, above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute), and no thread holds an
// element's 89 output accumulators, which would spill as B1's do at 3D Q2.
// Loads and stores of a row are coalesced over e; table reads are
// broadcasts within a warp; the ragged tail is masked.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): the 2D tangent moves 66 floats per element (ue, due, out: 22
// rows each) against about 4 kFLOP: memory-bound.  The 3D tangent moves
// 267 floats per element against about 55 kFLOP (interpolation 2 x 4 x
// 108 x 27 multiply-adds and projection 3 x 108 x 27 + 8 x 27):
// compute-bound.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgd_lattice.so gd_lattice.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;

template <int D>
struct Shape {
  static constexpr int NNV = (D == 2) ? 9 : 27;   // Q2 velocity nodes
  static constexpr int NNP = (D == 2) ? 4 : 8;    // Q1 pressure nodes
  static constexpr int NQ = (D == 2) ? 9 : 27;    // 3-point Gauss
  static constexpr int RS = D * NNV + NNP;        // mixed state rows
  static constexpr int MV = (D + 1) * NQ;         // rows of Tv
  static constexpr int SLOTS = NQ > NNV ? NQ : NNV;
  static constexpr int BE = (D == 2) ? 32 : 16;
  static constexpr int THREADS = SLOTS * BE;
  static constexpr int TABLES = 2 * MV * NNV + 2 * NQ * NNP;
  static constexpr int CROWS = D * MV + NQ;       // staged coefficients
};

template <int D, int MODE>
constexpr int smem_floats() {
  using S = Shape<D>;
  return S::TABLES + (S::RS * (MODE == TANGENT ? 2 : 1) +
                      (MODE == PRIMAL ? D * S::NNV : 0) + S::CROWS) *
                         S::BE;
}

struct Params {
  const float* ue;
  const float* due;
  const float* vpe;
  const float* fq;
  const float* tables;
  float* out;
  int64_t E;
  float nu, gamma, alpha0;
};

// value (b = 0) and gradients (b = 1..D) of the staged velocity component
// rows `rows` [NNV][BE] at quadrature point q (NB = 1: the value only)
template <class S, int NB>
__device__ __forceinline__ void interp_v(const float* sTv, const float* rows,
                                         int q, int el, float (&acc)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
#pragma unroll
  for (int n = 0; n < S::NNV; ++n) {
    const float u = rows[n * S::BE + el];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] += sTv[(b * S::NQ + q) * S::NNV + n] * u;
  }
}

// the pressure value of the staged rows `rows` [NNP][BE] at point q
template <class S>
__device__ __forceinline__ float interp_p(const float* sTp, const float* rows,
                                          int q, int el) {
  float s = 0.0f;
#pragma unroll
  for (int m = 0; m < S::NNP; ++m) s += sTp[q * S::NNP + m] * rows[m * S::BE + el];
  return s;
}

template <int D, int MODE>
__global__ void __launch_bounds__(Shape<D>::THREADS)
    gd_lattice_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int NNV = S::NNV;
  constexpr int NNP = S::NNP;
  constexpr int NQ = S::NQ;
  constexpr int RS = S::RS;
  constexpr int MV = S::MV;
  constexpr int BE = S::BE;

  extern __shared__ float smem[];
  float* sTv = smem;                        // Tv [MV][NNV]
  float* sPv = sTv + MV * NNV;              // Pv [NNV][MV]
  float* sTp = sPv + NNV * MV;              // Tp [NQ][NNP]
  float* sPp = sTp + NQ * NNP;              // Pp [NNP][NQ]
  float* sU = sPp + NNP * NQ;               // ue rows [RS][BE]
  float* sX = sU + RS * BE;                 // due [RS][BE] or vpe [D*NNV][BE]
  float* sC = sX + (MODE == TANGENT ? RS : D * NNV) * BE;  // [CROWS][BE]

  const int tid = threadIdx.x;
  const int el = tid % BE;
  const int slot = tid / BE;                // q in phase A, n in phase B
  const int64_t E = p.E;
  const int64_t e0 = (int64_t)blockIdx.x * BE;
  const int64_t e = e0 + el;

  for (int i = tid; i < S::TABLES; i += S::THREADS) sTv[i] = p.tables[i];
  for (int i = tid; i < RS * BE; i += S::THREADS) {
    const int64_t g = e0 + i % BE;
    const int64_t src = (int64_t)(i / BE) * E + g;
    sU[i] = g < E ? p.ue[src] : 0.0f;
    if constexpr (MODE == TANGENT) sX[i] = g < E ? p.due[src] : 0.0f;
  }
  if constexpr (MODE == PRIMAL) {
    for (int i = tid; i < D * NNV * BE; i += S::THREADS) {
      const int64_t g = e0 + i % BE;
      sX[i] = g < E ? p.vpe[(int64_t)(i / BE) * E + g] : 0.0f;
    }
  }
  __syncthreads();

  // ---- phase A: quadrature point q of element el ------------------------
  if (slot < NQ) {
    const int q = slot;
    const float nu = p.nu, gamma = p.gamma, alpha0 = p.alpha0;

    float vel[D], gvel[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float a[D + 1];
      interp_v<S, D + 1>(sTv, sU + i * NNV * BE, q, el, a);
      vel[i] = a[0];
#pragma unroll
      for (int j = 0; j < D; ++j) gvel[i][j] = a[1 + j];
    }

    float a_v[D], a_g[D][D], a_p;
    if constexpr (MODE == PRIMAL) {
      const float pq = interp_p<S>(sTp, sU + D * NNV * BE, q, el);
      float div = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) div += gvel[i][i];
      const float gd_p = gamma * div - pq;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float upv[1];
        interp_v<S, 1>(sTv, sX + i * NNV * BE, q, el, upv);
        const float f = e < E ? p.fq[(int64_t)(i * NQ + q) * E + e] : 0.0f;
        float conv = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) conv += gvel[i][j] * vel[j];
        a_v[i] = alpha0 * vel[i] + upv[0] + conv - f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          a_g[i][j] = nu * gvel[i][j] + (i == j ? gd_p : 0.0f);
      }
      a_p = div;
    } else {
      float dvel[D], dgvel[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float a[D + 1];
        interp_v<S, D + 1>(sTv, sX + i * NNV * BE, q, el, a);
        dvel[i] = a[0];
#pragma unroll
        for (int j = 0; j < D; ++j) dgvel[i][j] = a[1 + j];
      }
      const float dpq = interp_p<S>(sTp, sX + D * NNV * BE, q, el);
      float ddiv = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) ddiv += dgvel[i][i];
      const float gd_p = gamma * ddiv - dpq;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float dconv = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          dconv += dgvel[i][j] * vel[j] + gvel[i][j] * dvel[j];
        a_v[i] = alpha0 * dvel[i] + dconv;
#pragma unroll
        for (int j = 0; j < D; ++j)
          a_g[i][j] = nu * dgvel[i][j] + (i == j ? gd_p : 0.0f);
      }
      a_p = ddiv;
    }

    // stage: row (i*MV + b*NQ + q) for velocity component i, block b
    // (value, gradients); row (D*MV + q) for the pressure
    float* cq = sC + q * BE + el;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      cq[(i * MV) * BE] = a_v[i];
#pragma unroll
      for (int j = 0; j < D; ++j) cq[(i * MV + (1 + j) * NQ) * BE] = a_g[i][j];
    }
    cq[(D * MV) * BE] = a_p;
  }
  __syncthreads();

  // ---- phase B: node n of element el ------------------------------------
  const int n = slot;
  if (e >= E || n >= NNV) return;
  const float* Prow = sPv + n * MV;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const float* ci = sC + (i * MV) * BE + el;
    float s = 0.0f;
#pragma unroll 9
    for (int r = 0; r < MV; ++r) s += Prow[r] * ci[r * BE];
    p.out[(int64_t)(i * NNV + n) * E + e] = s;
  }
  if (n < NNP) {
    const float* Pp = sPp + n * NQ;
    const float* cp = sC + (D * MV) * BE + el;
    float s = 0.0f;
#pragma unroll 9
    for (int r = 0; r < NQ; ++r) s += Pp[r] * cp[r * BE];
    p.out[(int64_t)(D * NNV + n) * E + e] = s;
  }
}

template <int D, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<D>;
  constexpr size_t smem = sizeof(float) * smem_floats<D, MODE>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gd_lattice_kernel<D, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int64_t blocks = (p.E + S::BE - 1) / S::BE;
  if (blocks == 0) return cudaSuccess;
  gd_lattice_kernel<D, MODE><<<(unsigned)blocks, S::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mode(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case PRIMAL: return launch<D, PRIMAL>(p, stream);
    case TANGENT: return launch<D, TANGENT>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one variant on `stream`.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for a (dim, pressure degree,
// mode) that is not compiled.  Does not synchronise and allocates nothing.
extern "C" int gd_lattice_launch(
    int dim, int degree_pressure, int mode,
    const void* ue, const void* due, const void* vpe, const void* fq,
    const void* tables, void* out, int64_t n_elements,
    float nu, float gamma, float alpha0, void* stream) {
  Params p;
  p.ue = static_cast<const float*>(ue);
  p.due = static_cast<const float*>(due);
  p.vpe = static_cast<const float*>(vpe);
  p.fq = static_cast<const float*>(fq);
  p.tables = static_cast<const float*>(tables);
  p.out = static_cast<float*>(out);
  p.E = n_elements;
  p.nu = nu;
  p.gamma = gamma;
  p.alpha0 = alpha0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (degree_pressure != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dim) {
    case 2: err = launch_mode<2>(mode, p, s); break;
    case 3: err = launch_mode<3>(mode, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
