// GLS Navier-Stokes element kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel B1: softx_2020_200_tpu/ops/pallas_gls.py,
// _build_kernel (:218) with its body _physics (:45), launched through
// pl.pallas_call at :413.  For every element and quadrature point it
// computes J from the node coordinates and det J, J^-1 in closed form;
// values, physical gradients and affine-chain-rule Laplacians of (u, p);
// the strong residual r_m = a0 u + sum a_i u^{n-i} + (u.grad)u + grad p
// - nu lap u - f; tau = (sdt^2 + 4|u|^2/h^2 + 9 (4 nu/h^2)^2)^-1/2; the
// Galerkin, SUPG, PSPG, GLS-viscous-adjoint and LSIC coefficients; and the
// transpose contraction back to the nn*(d+1) nodal outputs.
//
// Three variants (MODE):
//   PRIMAL   the residual, full tau;
//   TANGENT  the directional derivative along due, tau frozen (the LSIC
//            coefficient is frozen as well, as in B1);
//   PROBE    the tangent along the one-hot direction (probe_node,
//            probe_comp) for every element, without reading a direction
//            array; it writes only the c outputs of node probe_node into
//            the node-block array out[nn, c*c, E] at rows i*c + probe_comp.
//
// Layout: SoA rows with the element index fastest, so neighbouring threads
// read neighbouring addresses: ue[nn*c, E], due[nn*c, E], xe[nn*d, E],
// up[nn*d, E], fq[nq*d, E], h[E]; out[nn*c, E].  One thread per element;
// the ragged tail is masked, nothing is padded.  The tables B[nq, nn],
// G[nq, nn*d], H[nq, nn*d*d] and w[nq] arrive packed in one array and are
// staged in shared memory, where every thread of a warp reads the same
// entry (a broadcast).
//
// What bounds it on an H100: at 3D Q1 the TPU kernel's own estimate is
// about 10 kFLOP per element (softx_2020_200_tpu/ops/pallas_lattice.py:
// 20-25) against about 550 B of f32 traffic (ue, xe, up, fq, h in, r out),
// ~18 FLOP/B, near the card's f32 ridge (67 TFLOP/s over 3.35 TB/s ~ 20
// FLOP/B), so neither bound dominates by much; this first design keeps
// each element's state in registers and reads each input once.  At 3D Q2
// (nn = nq = 27, c = 4) the per-thread state (ue, xe, up, the
// accumulators, and due for the tangent) exceeds the 255-register limit
// and spills to local memory; that is accepted for now.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgls_element.so gls_element.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;
constexpr int PROBE = 2;

template <int D, int K>
struct Shape {
  static constexpr int N1 = K + 1;
  static constexpr int NN = (D == 2) ? N1 * N1 : N1 * N1 * N1;
  static constexpr int NQ = NN;          // (degree + 1)-point Gauss rule
  static constexpr int C = D + 1;
  static constexpr int TB = NQ * NN;
  static constexpr int TG = NQ * NN * D;
  static constexpr int TH = NQ * NN * D * D;
  static constexpr int TABLES = TB + TG + TH + NQ;
};

struct Params {
  const float* ue;
  const float* due;
  const float* xe;
  const float* up;
  const float* fq;
  const float* h;
  const float* tables;
  float* out;
  int64_t E;
  float nu, alpha0, sdt;
  int supg, pspg, gls_adjoint, lsic;
  int probe_node, probe_comp;
};

template <int D>
__device__ __forceinline__ float inverse(const float (&J)[D][D],
                                         float (&Ji)[D][D]) {
  if constexpr (D == 2) {
    const float det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float idet = 1.0f / det;
    Ji[0][0] = J[1][1] * idet;
    Ji[0][1] = -J[0][1] * idet;
    Ji[1][0] = -J[1][0] * idet;
    Ji[1][1] = J[0][0] * idet;
    return det;
  } else {
    const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const float c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const float c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const float c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const float c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const float c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const float c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const float c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const float c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    const float idet = 1.0f / det;
    Ji[0][0] = c00 * idet; Ji[0][1] = c10 * idet; Ji[0][2] = c20 * idet;
    Ji[1][0] = c01 * idet; Ji[1][1] = c11 * idet; Ji[1][2] = c21 * idet;
    Ji[2][0] = c02 * idet; Ji[2][1] = c12 * idet; Ji[2][2] = c22 * idet;
    return det;
  }
}

template <int D, int K, int MODE>
__global__ void __launch_bounds__(128) gls_element_kernel(const Params p) {
  using S = Shape<D, K>;
  constexpr int NN = S::NN;
  constexpr int NQ = S::NQ;
  constexpr int C = S::C;

  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < S::TABLES; i += blockDim.x)
    tab[i] = p.tables[i];
  __syncthreads();
  const float* sB = tab;
  const float* sG = sB + S::TB;
  const float* sH = sG + S::TG;
  const float* sw = sH + S::TH;

  const int64_t E = p.E;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;

  float ue[NN * C], xe[NN * D], up[NN * D];
#pragma unroll
  for (int r = 0; r < NN * C; ++r) ue[r] = p.ue[r * E + e];
#pragma unroll
  for (int r = 0; r < NN * D; ++r) {
    xe[r] = p.xe[r * E + e];
    up[r] = p.up[r * E + e];
  }
  float due[MODE == TANGENT ? NN * C : 1];
  if constexpr (MODE == TANGENT) {
#pragma unroll
    for (int r = 0; r < NN * C; ++r) due[r] = p.due[r * E + e];
  }
  constexpr int NACC = (MODE == PROBE) ? C : NN * C;
  float acc[NACC];
#pragma unroll
  for (int r = 0; r < NACC; ++r) acc[r] = 0.0f;

  const float nu = p.nu, alpha0 = p.alpha0, sdt = p.sdt;
  const float h = p.h[e];
  const float inv_h2 = 1.0f / (h * h);
  const float visc_term = 9.0f * (4.0f * nu) * (4.0f * nu) * inv_h2 * inv_h2;
  const int n0 = p.probe_node, j0 = p.probe_comp;

#pragma unroll 1
  for (int q = 0; q < NQ; ++q) {
    const float* Bq = sB + q * NN;
    const float* Gq = sG + q * NN * D;
    const float* Hq = sH + q * NN * D * D;

    // ---- geometry: J[i][j] = sum_n xe[n, i] G[q, n, j] ----------------
    float J[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int n = 0; n < NN; ++n) s += xe[n * D + i] * Gq[n * D + j];
        J[i][j] = s;
      }
    float Ji[D][D];
    const float det = inverse<D>(J, Ji);
    const float scale = det * sw[q];

    // K[a][b] = sum_i Ji[a][i] Ji[b][i]; lap_phi[n] = H[q, n, a, b] K[a][b]
    float Km[D][D];
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int b = 0; b < D; ++b) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) s += Ji[a][i] * Ji[b][i];
        Km[a][b] = s;
      }
    float lap_phi[NN];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int b = 0; b < D; ++b) s += Hq[n * D * D + a * D + b] * Km[a][b];
      lap_phi[n] = s;
    }

    // ---- values and physical gradients of (u, p) -----------------------
    float uq[C], grad[C][D];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float v = 0.0f, dref[D];
#pragma unroll
      for (int a = 0; a < D; ++a) dref[a] = 0.0f;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const float c = ue[n * C + k];
        v += Bq[n] * c;
#pragma unroll
        for (int a = 0; a < D; ++a) dref[a] += Gq[n * D + a] * c;
      }
      uq[k] = v;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) s += dref[a] * Ji[a][i];
        grad[k][i] = s;
      }
    }
    float lap[D], upq[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f, t = 0.0f;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        s += lap_phi[n] * ue[n * C + i];
        t += Bq[n] * up[n * D + i];
      }
      lap[i] = s;
      upq[i] = t;
    }

    // ---- strong residual, divergence, tau -------------------------------
    float udot[D], conv[D], r_m[D];
    float div = 0.0f, umag2 = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      udot[i] = alpha0 * uq[i] + upq[i];
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += grad[i][j] * uq[j];
      conv[i] = s;
      const float f = p.fq[(int64_t)(q * D + i) * E + e];
      r_m[i] = udot[i] + conv[i] + grad[D][i] - nu * lap[i] - f;
      div += grad[i][i];
      umag2 += uq[i] * uq[i];
      if constexpr (MODE == PRIMAL) conv[i] -= f;   // a_v needs udot+conv-f
    }
    const float tau = 1.0f / sqrtf(sdt * sdt + 4.0f * umag2 * inv_h2
                                   + visc_term);

    // ---- weak-form coefficient fields (pre-multiplied by det J * w) ------
    float a_v[D], a_g[D][D], a_p, a_pg[D], a_lap[D];
    if constexpr (MODE == PRIMAL) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a_v[i] = scale * (udot[i] + conv[i]);
#pragma unroll
        for (int j = 0; j < D; ++j) {
          a_g[i][j] = scale * nu * grad[i][j] - (i == j ? scale * uq[D] : 0.0f);
          if (p.supg) a_g[i][j] += scale * tau * r_m[i] * uq[j];
        }
        if (p.lsic) a_g[i][i] += 0.5f * sqrtf(umag2) * h * scale * div;
        a_pg[i] = p.pspg ? scale * tau * r_m[i] : 0.0f;
        a_lap[i] = p.gls_adjoint ? -scale * tau * nu * r_m[i] : 0.0f;
      }
      a_p = scale * div;
    } else {
      // direction fields: from due (TANGENT) or the one-hot probe (PROBE)
      float duq[C], dgrad[C][D], dlap[D];
      if constexpr (MODE == TANGENT) {
#pragma unroll
        for (int k = 0; k < C; ++k) {
          float v = 0.0f, dref[D];
#pragma unroll
          for (int a = 0; a < D; ++a) dref[a] = 0.0f;
#pragma unroll
          for (int n = 0; n < NN; ++n) {
            const float c = due[n * C + k];
            v += Bq[n] * c;
#pragma unroll
            for (int a = 0; a < D; ++a) dref[a] += Gq[n * D + a] * c;
          }
          duq[k] = v;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            float s = 0.0f;
#pragma unroll
            for (int a = 0; a < D; ++a) s += dref[a] * Ji[a][i];
            dgrad[k][i] = s;
          }
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int n = 0; n < NN; ++n) s += lap_phi[n] * due[n * C + i];
          dlap[i] = s;
        }
      } else {
        const float bn = Bq[n0];
        float gphys[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int a = 0; a < D; ++a) s += Gq[n0 * D + a] * Ji[a][i];
          gphys[i] = s;
        }
        float lpn = 0.0f;
#pragma unroll
        for (int n = 0; n < NN; ++n)
          if (n == n0) lpn = lap_phi[n];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          const bool hot = (k == j0);
          duq[k] = hot ? bn : 0.0f;
#pragma unroll
          for (int i = 0; i < D; ++i) dgrad[k][i] = hot ? gphys[i] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < D; ++i) dlap[i] = (i == j0) ? lpn : 0.0f;
      }

      float ddiv = 0.0f;
      float dr_m[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float dudot = alpha0 * duq[i];
        float dconv = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j)
          dconv += dgrad[i][j] * uq[j] + grad[i][j] * duq[j];
        dr_m[i] = dudot + dconv + dgrad[D][i] - nu * dlap[i];
        ddiv += dgrad[i][i];
        a_v[i] = scale * (dudot + dconv);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int j = 0; j < D; ++j) {
          a_g[i][j] = scale * nu * dgrad[i][j] - (i == j ? scale * duq[D] : 0.0f);
          if (p.supg)
            a_g[i][j] += scale * tau * (dr_m[i] * uq[j] + r_m[i] * duq[j]);
        }
        if (p.lsic) a_g[i][i] += 0.5f * sqrtf(umag2) * h * scale * ddiv;
        a_pg[i] = p.pspg ? scale * tau * dr_m[i] : 0.0f;
        a_lap[i] = p.gls_adjoint ? -scale * tau * nu * dr_m[i] : 0.0f;
      }
      a_p = scale * ddiv;
    }

    // ---- transpose contractions back to nodes ---------------------------
    float ag_ref[D][D], apg_ref[D];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += a_pg[j] * Ji[a][j];
      apg_ref[a] = s;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float t = 0.0f;
#pragma unroll
        for (int j = 0; j < D; ++j) t += a_g[i][j] * Ji[a][j];
        ag_ref[i][a] = t;
      }
    }
    if constexpr (MODE == PROBE) {
      float gn[D], lpn = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a) gn[a] = Gq[n0 * D + a];
#pragma unroll
      for (int n = 0; n < NN; ++n)
        if (n == n0) lpn = lap_phi[n];
      const float bn = Bq[n0];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = bn * a_v[i] + lpn * a_lap[i];
#pragma unroll
        for (int a = 0; a < D; ++a) s += gn[a] * ag_ref[i][a];
        acc[i] += s;
      }
      float s = bn * a_p;
#pragma unroll
      for (int a = 0; a < D; ++a) s += gn[a] * apg_ref[a];
      acc[D] += s;
    } else {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const float bn = Bq[n];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = bn * a_v[i] + lap_phi[n] * a_lap[i];
#pragma unroll
          for (int a = 0; a < D; ++a) s += Gq[n * D + a] * ag_ref[i][a];
          acc[n * C + i] += s;
        }
        float s = bn * a_p;
#pragma unroll
        for (int a = 0; a < D; ++a) s += Gq[n * D + a] * apg_ref[a];
        acc[n * C + D] += s;
      }
    }
  }

  if constexpr (MODE == PROBE) {
#pragma unroll
    for (int i = 0; i < C; ++i)
      p.out[(int64_t)(n0 * C * C + i * C + j0) * E + e] = acc[i];
  } else {
#pragma unroll
    for (int r = 0; r < NN * C; ++r) p.out[r * E + e] = acc[r];
  }
}

template <int D, int K, int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using S = Shape<D, K>;
  constexpr int threads = 128;
  const size_t smem = sizeof(float) * S::TABLES;
  const int64_t blocks = (p.E + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  gls_element_kernel<D, K, MODE>
      <<<(unsigned)blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int K>
cudaError_t launch_mode(int mode, const Params& p, cudaStream_t stream) {
  switch (mode) {
    case PRIMAL: return launch<D, K, PRIMAL>(p, stream);
    case TANGENT: return launch<D, K, TANGENT>(p, stream);
    case PROBE: return launch<D, K, PROBE>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches one variant on `stream`.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for a (dim, degree, mode)
// that is not compiled.  Does not synchronise and allocates nothing.
extern "C" int gls_element_launch(
    int dim, int degree, int mode,
    const void* ue, const void* due, const void* xe, const void* up,
    const void* fq, const void* h, const void* tables, void* out,
    int64_t n_elements, float nu, float alpha0, float sdt,
    int supg, int pspg, int gls_adjoint, int lsic,
    int probe_node, int probe_comp, void* stream) {
  Params p;
  p.ue = static_cast<const float*>(ue);
  p.due = static_cast<const float*>(due);
  p.xe = static_cast<const float*>(xe);
  p.up = static_cast<const float*>(up);
  p.fq = static_cast<const float*>(fq);
  p.h = static_cast<const float*>(h);
  p.tables = static_cast<const float*>(tables);
  p.out = static_cast<float*>(out);
  p.E = n_elements;
  p.nu = nu;
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
  if (dim == 2 && degree == 1) err = launch_mode<2, 1>(mode, p, s);
  else if (dim == 2 && degree == 2) err = launch_mode<2, 2>(mode, p, s);
  else if (dim == 3 && degree == 1) err = launch_mode<3, 1>(mode, p, s);
  else if (dim == 3 && degree == 2) err = launch_mode<3, 2>(mode, p, s);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
