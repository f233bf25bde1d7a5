// GLS Navier-Stokes lattice kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel B2: softx_2020_200_tpu/ops/pallas_lattice.py,
// _build_kernel (:103), with its constant tables from _affine_tables (:66),
// launched through pl.pallas_call at :391.  On a lattice whose elements are
// all translates of one box the geometry folds into two constant matrices:
// T_all [(d+2)*nq, nn] (values, the d physical gradients and the Laplacian
// of the basis at the quadrature points) and T_proj [nn, (d+2)*nq] (T_all
// transposed with det J * w folded in).  Every element then does
//   interpolate:  prim_k = T_all @ u_k          (per component k)
//   physics:      r_m = a0 u + sum a_i u^{n-i} + (u.grad)u + grad p
//                       - nu lap u - f;  tau = (sdt^2 + 4|u|^2/h^2
//                       + 9 (4 nu/h^2)^2)^-1/2; Galerkin, SUPG, PSPG,
//                       GLS-viscous-adjoint and LSIC coefficients
//   project:      out_k = T_proj @ coeffs_k     (the quadrature sum)
// as the TPU kernel does in its own body.  The products are f32 on the
// CUDA cores (no tensor cores, so no TF32).
//
// Three variants (MODE):
//   PRIMAL   the residual, full tau;
//   TANGENT  the directional derivative along due, tau and the LSIC
//            coefficient frozen (B2's tangent);
//   PROBE    the tangent along the one-hot direction (probe_node,
//            probe_comp) for every element, without a direction array; it
//            writes the c outputs of node probe_node into the node-block
//            array out[nn, c*c, E] at rows i*c + probe_comp.
//
// Layout: component-major rows with the element index fastest, as B2's:
// ue[c*nn, E] (row k*nn + n), due[c*nn, E], up[d*nn, E], fq[d*nq, E] (row
// i*nq + q); out[c*nn, E].  Compiled for Q1 and Q2 in 2D and 3D with
// (degree + 1) Gauss points per axis, and for Q1 with 3 points per axis,
// which the Q1 levels of a Q2 deck's multigrid hierarchy use (as in the
// JAX package).  A block takes BE elements (32; 16 when nq or nn is 27)
// and runs max(nq, nn)*BE threads in two phases:
//   A  thread (q, e) interpolates, evaluates the physics at quadrature
//      point q of element e and stages its coefficients in shared memory;
//   B  thread (n, e) projects: out[k, n, e] = sum_r T_proj[n, r] C_k[r, e].
// The tables (3D Q2: 2 x 135 x 27 f32 = 29 KB), the block's input rows and
// its coefficients (3D Q2: 513 per element) live in shared memory, so no
// thread holds an element's c*nn accumulators (108 at 3D Q2), which is
// what spilled B1's one-thread-per-element design at 3D Q2.  Loads and
// stores of a row are coalesced over e; table reads are broadcasts within
// a warp (one q or n per warp); the ragged tail is masked.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): at 3D Q1 an element moves 448 B in the primal (ue 32, up 24,
// fq 24, out 32 floats) and 576 B in the tangent, against about 5.7 and
// 8.6 kFLOP, 13-15 FLOP/B, under the f32 ridge of about 20: memory-bound,
// about 35 us primal at the 64^3 box.  At 3D Q2 about 60 kFLOP against
// 1,512 B per element: compute-bound.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgls_lattice.so gls_lattice.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;
constexpr int PROBE = 2;

template <int D, int K, int Q>
struct Shape {
  static constexpr int N1 = K + 1;
  static constexpr int NN = (D == 2) ? N1 * N1 : N1 * N1 * N1;
  static constexpr int NQ = (D == 2) ? Q * Q : Q * Q * Q;   // Q-point Gauss
  static constexpr int C = D + 1;
  static constexpr int M = (D + 2) * NQ;      // rows of T_all
  static constexpr int MNL = (D + 1) * NQ;    // value + gradient rows
  static constexpr int SLOTS = NQ > NN ? NQ : NN;
  static constexpr int BE = (SLOTS * 32 <= 512) ? 32 : 16;
  static constexpr int THREADS = SLOTS * BE;
  static constexpr int TABLES = 2 * M * NN;
  static constexpr int CROWS = D * M + MNL;   // staged coefficients per element
};

template <int D, int K, int Q, int MODE>
constexpr int smem_floats() {
  using S = Shape<D, K, Q>;
  return S::TABLES +
         (S::C * S::NN * (MODE == TANGENT ? 2 : 1) + D * S::NN + S::CROWS) *
             S::BE;
}

struct Params {
  const float* ue;
  const float* due;
  const float* up;
  const float* fq;
  const float* tables;
  float* out;
  int64_t E;
  float nu, h, alpha0, sdt;
  int supg, pspg, gls_adjoint, lsic;
  int probe_node, probe_comp;
};

// value (b = 0), gradients (b = 1..D) and Laplacian (b = D+1) of the
// staged component rows `rows` [NN][BE] at quadrature point q
template <class S, int NB>
__device__ __forceinline__ void interpolate(const float* sT, const float* rows,
                                            int q, int el, float (&acc)[NB]) {
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
#pragma unroll
  for (int n = 0; n < S::NN; ++n) {
    const float u = rows[n * S::BE + el];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] += sT[(b * S::NQ + q) * S::NN + n] * u;
  }
}

template <int D, int K, int Q, int MODE>
__global__ void __launch_bounds__(Shape<D, K, Q>::THREADS)
    gls_lattice_kernel(const Params p) {
  using S = Shape<D, K, Q>;
  constexpr int NN = S::NN;
  constexpr int NQ = S::NQ;
  constexpr int C = S::C;
  constexpr int M = S::M;
  constexpr int MNL = S::MNL;
  constexpr int BE = S::BE;

  extern __shared__ float smem[];
  float* sT = smem;                         // T_all [M][NN]
  float* sP = sT + M * NN;                  // T_proj [NN][M]
  float* sU = sP + NN * M;                  // ue rows [C*NN][BE]
  float* sDU = sU + C * NN * BE;            // due rows (TANGENT)
  float* sUP = sDU + (MODE == TANGENT ? C * NN * BE : 0);  // up [D*NN][BE]
  float* sC = sUP + D * NN * BE;            // coefficients [CROWS][BE]

  const int tid = threadIdx.x;
  const int el = tid % BE;
  const int slot = tid / BE;                // q in phase A, n in phase B
  const int64_t E = p.E;
  const int64_t e0 = (int64_t)blockIdx.x * BE;
  const int64_t e = e0 + el;

  for (int i = tid; i < S::TABLES; i += S::THREADS) sT[i] = p.tables[i];
  for (int i = tid; i < C * NN * BE; i += S::THREADS) {
    const int64_t g = e0 + i % BE;
    const int64_t src = (int64_t)(i / BE) * E + g;
    sU[i] = g < E ? p.ue[src] : 0.0f;
    if constexpr (MODE == TANGENT) sDU[i] = g < E ? p.due[src] : 0.0f;
  }
  for (int i = tid; i < D * NN * BE; i += S::THREADS) {
    const int64_t g = e0 + i % BE;
    sUP[i] = g < E ? p.up[(int64_t)(i / BE) * E + g] : 0.0f;
  }
  __syncthreads();

  // ---- phase A: quadrature point q of element el ------------------------
  if (slot < NQ) {
    const int q = slot;
    const float nu = p.nu, alpha0 = p.alpha0, sdt = p.sdt, h = p.h;
    const float inv_h2 = 1.0f / (h * h);
    const float visc_term = 9.0f * (4.0f * nu) * (4.0f * nu) * inv_h2 * inv_h2;

    float vel[D], gvel[D][D], lap[D], pr, gp[D], upv[D], f[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float a[D + 2];
      interpolate<S, D + 2>(sT, sU + k * NN * BE, q, el, a);
      vel[k] = a[0];
#pragma unroll
      for (int j = 0; j < D; ++j) gvel[k][j] = a[1 + j];
      lap[k] = a[D + 1];
      float b[1];
      interpolate<S, 1>(sT, sUP + k * NN * BE, q, el, b);
      upv[k] = b[0];
      f[k] = e < E ? p.fq[(int64_t)(k * NQ + q) * E + e] : 0.0f;
    }
    {
      float a[D + 1];
      interpolate<S, D + 1>(sT, sU + D * NN * BE, q, el, a);
      pr = a[0];
#pragma unroll
      for (int j = 0; j < D; ++j) gp[j] = a[1 + j];
    }

    float udot[D], conv[D], r_m[D];
    float div = 0.0f, umag2 = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      udot[i] = alpha0 * vel[i] + upv[i];
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += gvel[i][j] * vel[j];
      conv[i] = s;
      r_m[i] = udot[i] + conv[i] + gp[i] - nu * lap[i] - f[i];
      div += gvel[i][i];
      umag2 += vel[i] * vel[i];
    }
    const float tau = 1.0f / sqrtf(sdt * sdt + 4.0f * umag2 * inv_h2 +
                                   visc_term);
    const float tau_l = 0.5f * sqrtf(umag2) * h;

    float a_v[D], a_g[D][D], a_p, a_pg[D], a_lap[D];
    if constexpr (MODE == PRIMAL) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a_v[i] = udot[i] + conv[i] - f[i];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          a_g[i][j] = nu * gvel[i][j] - (i == j ? pr : 0.0f);
          if (p.supg) a_g[i][j] += tau * r_m[i] * vel[j];
        }
        if (p.lsic) a_g[i][i] += tau_l * div;
        a_pg[i] = p.pspg ? tau * r_m[i] : 0.0f;
        a_lap[i] = p.gls_adjoint ? -tau * nu * r_m[i] : 0.0f;
      }
      a_p = div;
    } else {
      // direction fields: from due (TANGENT) or the one-hot probe (PROBE)
      float dvel[D], dgvel[D][D], dlap[D], dp, dgp[D];
      if constexpr (MODE == TANGENT) {
#pragma unroll
        for (int k = 0; k < D; ++k) {
          float a[D + 2];
          interpolate<S, D + 2>(sT, sDU + k * NN * BE, q, el, a);
          dvel[k] = a[0];
#pragma unroll
          for (int j = 0; j < D; ++j) dgvel[k][j] = a[1 + j];
          dlap[k] = a[D + 1];
        }
        float a[D + 1];
        interpolate<S, D + 1>(sT, sDU + D * NN * BE, q, el, a);
        dp = a[0];
#pragma unroll
        for (int j = 0; j < D; ++j) dgp[j] = a[1 + j];
      } else {
        const int n0 = p.probe_node, j0 = p.probe_comp;
        float t[D + 2];
#pragma unroll
        for (int b = 0; b < D + 2; ++b) t[b] = sT[(b * NQ + q) * NN + n0];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const bool hot = (k == j0);
          dvel[k] = hot ? t[0] : 0.0f;
#pragma unroll
          for (int j = 0; j < D; ++j) dgvel[k][j] = hot ? t[1 + j] : 0.0f;
          dlap[k] = hot ? t[D + 1] : 0.0f;
        }
        dp = (j0 == D) ? t[0] : 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) dgp[j] = (j0 == D) ? t[1 + j] : 0.0f;
      }

      float ddiv = 0.0f, dr_m[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float dudot = alpha0 * dvel[i];
        float dconv = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          dconv += dgvel[i][j] * vel[j] + gvel[i][j] * dvel[j];
        dr_m[i] = dudot + dconv + dgp[i] - nu * dlap[i];
        ddiv += dgvel[i][i];
        a_v[i] = dudot + dconv;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          a_g[i][j] = nu * dgvel[i][j] - (i == j ? dp : 0.0f);
          if (p.supg) a_g[i][j] += tau * (dr_m[i] * vel[j] + r_m[i] * dvel[j]);
        }
        if (p.lsic) a_g[i][i] += tau_l * ddiv;
        a_pg[i] = p.pspg ? tau * dr_m[i] : 0.0f;
        a_lap[i] = p.gls_adjoint ? -tau * nu * dr_m[i] : 0.0f;
      }
      a_p = ddiv;
    }

    // stage: row (i*M + b*NQ + q) for velocity component i, block b
    // (value, gradients, Laplacian); row (D*M + b*NQ + q) for pressure
    float* cq = sC + q * BE + el;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      cq[(i * M) * BE] = a_v[i];
#pragma unroll
      for (int j = 0; j < D; ++j) cq[(i * M + (1 + j) * NQ) * BE] = a_g[i][j];
      cq[(i * M + (D + 1) * NQ) * BE] = a_lap[i];
    }
    cq[(D * M) * BE] = a_p;
#pragma unroll
    for (int j = 0; j < D; ++j) cq[(D * M + (1 + j) * NQ) * BE] = a_pg[j];
  }
  __syncthreads();

  // ---- phase B: node n of element el ------------------------------------
  const int n = slot;
  if (e >= E || n >= NN) return;
  if constexpr (MODE == PROBE) {
    if (n != p.probe_node) return;
  }
  const float* Prow = sP + n * M;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float* ck = sC + (k * M) * BE + el;
    const int rows = (k < D) ? M : MNL;
    float s = 0.0f;
#pragma unroll 9
    for (int r = 0; r < rows; ++r) s += Prow[r] * ck[r * BE];
    if constexpr (MODE == PROBE) {
      p.out[(int64_t)(n * C * C + k * C + p.probe_comp) * E + e] = s;
    } else {
      p.out[(int64_t)(k * NN + n) * E + e] = s;
    }
  }
}

template <int D, int K, int Q, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<D, K, Q>;
  constexpr size_t smem = sizeof(float) * smem_floats<D, K, Q, MODE>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gls_lattice_kernel<D, K, Q, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int64_t blocks = (p.E + S::BE - 1) / S::BE;
  if (blocks == 0) return cudaSuccess;
  gls_lattice_kernel<D, K, Q, MODE>
      <<<(unsigned)blocks, S::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int K, int Q>
cudaError_t launch_mode(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case PRIMAL: return launch<D, K, Q, PRIMAL>(p, stream);
    case TANGENT: return launch<D, K, Q, TANGENT>(p, stream);
    case PROBE: return launch<D, K, Q, PROBE>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one variant on `stream`.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for a (dim, degree, points
// per axis, mode) that is not compiled.  Does not synchronise and
// allocates nothing.
extern "C" int gls_lattice_launch(
    int dim, int degree, int n_q1d, int mode,
    const void* ue, const void* due, const void* up, const void* fq,
    const void* tables, void* out, int64_t n_elements,
    float nu, float h, float alpha0, float sdt,
    int supg, int pspg, int gls_adjoint, int lsic,
    int probe_node, int probe_comp, void* stream) {
  Params p;
  p.ue = static_cast<const float*>(ue);
  p.due = static_cast<const float*>(due);
  p.up = static_cast<const float*>(up);
  p.fq = static_cast<const float*>(fq);
  p.tables = static_cast<const float*>(tables);
  p.out = static_cast<float*>(out);
  p.E = n_elements;
  p.nu = nu;
  p.h = h;
  p.alpha0 = alpha0;
  p.sdt = sdt;
  p.supg = supg;
  p.pspg = pspg;
  p.gls_adjoint = gls_adjoint;
  p.lsic = lsic;
  p.probe_node = probe_node;
  p.probe_comp = probe_comp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int key = dim * 100 + degree * 10 + n_q1d;
  switch (key) {
    case 212: err = launch_mode<2, 1, 2>(mode, p, s); break;
    case 213: err = launch_mode<2, 1, 3>(mode, p, s); break;
    case 223: err = launch_mode<2, 2, 3>(mode, p, s); break;
    case 312: err = launch_mode<3, 1, 2>(mode, p, s); break;
    case 313: err = launch_mode<3, 1, 3>(mode, p, s); break;
    case 323: err = launch_mode<3, 2, 3>(mode, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
