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
// transpose contraction back to the nn*(d+1) nodal outputs.  The time
// derivative a0 u + sum a_i u^{n-i} is interpolated from its nodal values
// (one fmaf per node), a small difference of two large terms: f32 then
// rounds the small result and not a0 times the interpolated u.
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
// Quadrature: Q1 and Q2 with degree + 1 Gauss points per axis, and Q1
// with 3 points per axis (Q1 = 3 below) on the STAGED route only: the
// multigrid levels under a Q2 mesh's Q1 p-level keep the fine level's
// rule, as in the JAX package's forest hierarchy (ops/multigrid.py).
//
// Layout: SoA rows with the element index fastest: ue[nn*c, E],
// due[nn*c, E], xe[nn*d, E], up[nn*d, E], fq[nq*d, E], h[E];
// out[nn*c, E].  The tables arrive packed in one array: B[nq][nn],
// G[nq][nn][d], Hs[nq][nn][d(d+1)/2] (the symmetric reference Hessians,
// off-diagonal pairs summed) and w[nq].
//
// State type (SE, bytes per element): the tangent and the probe are also
// compiled for a bf16 state (SE = 2), B1's state_dtype=bfloat16
// (pallas_gls.py:287-295, :451-455): ue, xe, up, fq and h arrive as bf16
// rows at an even row pitch (the caller's, padded to 8 elements so TMA
// takes them), stay bf16 in the ring stage (half its bytes) or go straight
// to registers, and are widened to f32 where they are read; due, the
// arithmetic and out stay f32.  At the Taylor-Couette shape the tangent's
// bytes fall from 136 to 95 f32-word equivalents per element, which puts
// its bound on the operations (1.6 us) rather than the bytes (1.4 us).
//
// Operand type (OE, bytes per element of the direction, the tables and
// the output): all three modes are also compiled with every operand in
// bf16 (SE = OE = 2), B1 built with a bf16 compute dtype
// (pallas_gls.py:220, :241-245, :397): ue, due, xe, up, fq and h arrive as
// bf16 rows at one even pitch, the tables B, G, Hs and w are bf16 (staged
// as bf16), and each output is rounded once to bf16 (round to nearest
// even) where it is stored, at the rows' pitch.  The arithmetic inside
// stays f32: the TPU kernel computes in bf16 op by op, a rounding sequence
// no second compiler reproduces, and f32 inside keeps one kernel body for
// every instance (a difference of rounding, not of function).
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s f32 without tensor
// cores): at the Taylor-Couette shape (2D Q2, E = 12,288) the tangent moves
// 136 words per element (2.0 us) against about 9 kFLOP (1.7 us): bytes,
// barely, and the two are close at every compiled shape.  In practice
// neither binds: the first design (one thread per element, 128-thread
// blocks) ran 96 blocks of 4 warps for 132 SMs at that shape, each thread
// a long dependent chain over the points (latency), and at 3D Q2 its 108
// accumulators per thread spilled.
//
// Two routes, on the skeleton of persistent_tiles.cuh (a persistent grid
// of at most occupancy x SMs blocks); the caller picks one per launch from
// the shape and E (ops/gls_kernel.py):
//   STAGED     every shape.  A block stages the tables once, then per tile
//              of BE elements (32; 16 at 27 nodes or points) the rows
//              arrive in a
//              two-stage ring by TMA (4-byte cp.async where the row pitch
//              is not a multiple of 16 bytes) while the previous tile
//              computes.  Phase A, one thread per (quadrature point,
//              element): J, det J, J^-1 and Km = J^-1 J^-T, values,
//              gradients and Laplacians (lap_phi[n] = Hs[q, n, :] . Km),
//              the physics, and the point's reference-frame coefficients
//              (a_v, ag_ref = a_g J^-T, apg_ref, a_p, a_lap, Km) into
//              shared memory.  Phase B, one thread per (node, element):
//              the contraction with B, G and Hs (a block has max(nq, nn)
//              threads per element: those past nq idle in phase A, those
//              past nn in phase B).  No thread holds an
//              element's nn*c accumulators, so 3D Q2 does not spill; the
//              cost is shared-memory traffic (each point re-reads its
//              element's rows, each node its points' coefficients), which
//              bounds this route where E is large.
//   REGISTERS  2D and 3D Q1, 2D Q2: `split` (1, 2 or 4) adjacent threads
//              per element with its rows in registers, each walking every
//              split-th point into its own accumulators, summed by warp
//              shuffles; tables in shared memory as broadcasts.  Fewer
//              shared-memory loads per element than STAGED; it needs
//              enough elements to fill the card, which the split helps on
//              small 2D meshes.
// The caller takes REGISTERS from 64 elements per SM on, STAGED below.
// What bounds this design: STAGED issues one shared-memory load per
// product (each point re-reads its element's rows, each node its points'
// coefficients), and at the Taylor-Couette shape a block gets one tile, so
// the ring has nothing to overlap; REGISTERS holds an element's rows and
// accumulators in 200-odd registers, so an SM keeps only 4 blocks of 64
// threads, each thread a long dependent chain over its points.  Both stay
// about 4x over the 2D Q2 bound.  Measured times of both routes and
// splits: PERF.md.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgls_element.so gls_element.cu

#include "persistent_tiles.cuh"

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;
constexpr int PROBE = 2;
constexpr int STAGED = 0;
constexpr int REGISTERS = 1;
constexpr int REG_THREADS = 64;

using tiles::pad32;

template <int D, int K, int MODE, int SE = 4, int OE = 4, int Q1 = K + 1>
struct Shape {
  static constexpr int N1 = K + 1;
  static constexpr int NN = (D == 2) ? N1 * N1 : N1 * N1 * N1;
  static constexpr int NQ = (D == 2) ? Q1 * Q1 : Q1 * Q1 * Q1;  // Gauss
  static constexpr int C = D + 1;
  static constexpr int NH = D * (D + 1) / 2;
  static constexpr int TB = NQ * NN;
  static constexpr int TG = NQ * NN * D;
  static constexpr int TH = NQ * NN * NH;
  static constexpr int TABLES = TB + TG + TH + NQ;
  // STAGED: one thread per (point, element) in phase A and per (node,
  // element) in phase B
  static constexpr int SLOTS = NQ > NN ? NQ : NN;
  static constexpr int BE = (SLOTS * 32 <= 512) ? 32 : 16;
  static constexpr int THREADS = SLOTS * BE;
  // staged coefficients per (point, element): a_v[D], ag_ref[D][D],
  // apg_ref[D], a_p, a_lap[D], Km (symmetric)[NH]
  static constexpr int AV = 0, AG = D, APG = D + D * D, AP = APG + D,
                       ALAP = AP + 1, KM = ALAP + D, NCOEF = KM + NH;
  // inputs: ue, due, xe, up, fq, h; the frozen state and the geometry
  // SE-byte elements (f32, or bf16 in the bf16-state and bf16-operand
  // instances), the direction due, like the tables and the output,
  // OE-byte elements
  static constexpr int R_UE = NN * C, R_DUE = MODE == TANGENT ? NN * C : 0,
                       R_XE = NN * D, R_UP = NN * D, R_FQ = NQ * D, R_H = 1;
  static constexpr int O_UE = 0,
                       O_DUE = O_UE + tiles::box_words(R_UE, BE, SE),
                       O_XE = O_DUE + tiles::box_words(R_DUE, BE, OE),
                       O_UP = O_XE + tiles::box_words(R_XE, BE, SE),
                       O_FQ = O_UP + tiles::box_words(R_UP, BE, SE),
                       O_H = O_FQ + tiles::box_words(R_FQ, BE, SE),
                       STAGE = O_H + tiles::box_words(R_H, BE, SE);
  static constexpr int STAGE_BYTES =
      BE * (SE * (R_UE + R_XE + R_UP + R_FQ + R_H) + OE * R_DUE);
  static constexpr int TABLE_WORDS = tiles::table_words(TABLES, OE);
  static constexpr int SMEM_FLOATS =
      TABLE_WORDS + tiles::STAGES * STAGE + NQ * NCOEF * BE;
};

struct Params {
  tiles::Inputs in;
  const void* tables;   // OE-byte elements, like out
  void* out;
  int64_t E;
  float nu, alpha0, sdt;
  int supg, pspg, gls_adjoint, lsic;
  int probe_node, probe_comp;
  int path;
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

// The pointwise weak form at one quadrature point, shared by both routes:
// from the values, physical gradients and Laplacians of (u, p), the time
// derivative upq (interpolated from a0 u + sum a_i u^{n-i} at the nodes)
// and f (and of the direction for the tangent and the probe), the
// coefficients pre-multiplied by det J * w: a_v against phi, a_g against
// grad phi, a_lap against lap phi, a_p against psi, a_pg against grad psi.
template <int D, int MODE>
__device__ __forceinline__ void weak_form(
    const Params& p, float h, float scale, const float (&uq)[D + 1],
    const float (&grad)[D + 1][D], const float (&lap)[D],
    const float (&upq)[D], const float (&f)[D], const float (&duq)[D + 1],
    const float (&dgrad)[D + 1][D], const float (&dlap)[D], float (&a_v)[D],
    float (&a_g)[D][D], float& a_p, float (&a_pg)[D], float (&a_lap)[D]) {
  const float nu = p.nu, alpha0 = p.alpha0, sdt = p.sdt;
  const float inv_h2 = 1.0f / (h * h);
  const float visc_term = 9.0f * (4.0f * nu) * (4.0f * nu) * inv_h2 * inv_h2;
  float udot[D], conv[D], r_m[D];
  float div = 0.0f, umag2 = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    udot[i] = upq[i];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) s += grad[i][j] * uq[j];
    conv[i] = s;
    r_m[i] = udot[i] + conv[i] + grad[D][i] - nu * lap[i] - f[i];
    div += grad[i][i];
    umag2 += uq[i] * uq[i];
  }
  const float tau = 1.0f / sqrtf(sdt * sdt + 4.0f * umag2 * inv_h2 +
                                 visc_term);
  const float tau_l = 0.5f * sqrtf(umag2) * h;
  if constexpr (MODE == PRIMAL) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      a_v[i] = scale * (udot[i] + conv[i] - f[i]);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        a_g[i][j] = scale * nu * grad[i][j] - (i == j ? scale * uq[D] : 0.0f);
        if (p.supg) a_g[i][j] += scale * tau * r_m[i] * uq[j];
      }
      if (p.lsic) a_g[i][i] += tau_l * scale * div;
      a_pg[i] = p.pspg ? scale * tau * r_m[i] : 0.0f;
      a_lap[i] = p.gls_adjoint ? -scale * tau * nu * r_m[i] : 0.0f;
    }
    a_p = scale * div;
  } else {
    float ddiv = 0.0f, dr_m[D];
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
      if (p.lsic) a_g[i][i] += tau_l * scale * ddiv;
      a_pg[i] = p.pspg ? scale * tau * dr_m[i] : 0.0f;
      a_lap[i] = p.gls_adjoint ? -scale * tau * nu * dr_m[i] : 0.0f;
    }
    a_p = scale * ddiv;
  }
}

// The one-hot direction (node n0, component j0) at a point: value bn,
// physical gradient gphys and Laplacian lpn of basis function n0.
template <int D>
__device__ __forceinline__ void probe_direction(
    float bn, const float (&gphys)[D], float lpn, int j0, float (&duq)[D + 1],
    float (&dgrad)[D + 1][D], float (&dlap)[D]) {
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    const bool hot = (k == j0);
    duq[k] = hot ? bn : 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) dgrad[k][i] = hot ? gphys[i] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < D; ++i) dlap[i] = (i == j0) ? lpn : 0.0f;
}

// Km = J^-1 J^-T, symmetric: entries (a, b) with a <= b
template <int D>
__device__ __forceinline__ void metric(const float (&Ji)[D][D],
                                       float (&Ks)[D * (D + 1) / 2]) {
  int k = 0;
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = a; b < D; ++b) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < D; ++i) s += Ji[a][i] * Ji[b][i];
      Ks[k++] = s;
    }
}

// ------------------------------------------------------------- STAGED --
// Phase A: point q of element el of the staged tile `st`; writes the
// point's NCOEF coefficients to cq[k * BE].
template <int D, int K, int MODE, int SE, int OE, int Q1>
__device__ __forceinline__ void point_coefficients(
    const Params& p, const tiles::state_t<OE>* tab, const float* st, int q,
    int el, float* cq) {
  using S = Shape<D, K, MODE, SE, OE, Q1>;
  using T = tiles::state_t<SE>;
  using TO = tiles::state_t<OE>;
  constexpr int NN = S::NN, C = S::C, BE = S::BE, NH = S::NH;
  constexpr bool TAN = MODE == TANGENT;
  // at 27 nodes the node loops unroll by 9: fully unrolled, the loads
  // the compiler hoists ahead push the 3D Q2 tangent past its registers
  constexpr int NU = NN == 27 ? 9 : NN;
  const TO* sB = tab;
  const TO* sG = sB + S::TB;
  const TO* sH = sG + S::TG;
  const TO* sw = sH + S::TH;

  // geometry first: J[i][j] = sum_n xe[n, i] G[q, n, j], J^-1 and Km
  float J[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) J[i][j] = 0.0f;
#pragma unroll (NU)
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float x = tiles::ld<T>(st + S::O_XE, (n * D + i) * BE + el);
#pragma unroll
      for (int j = 0; j < D; ++j)
        J[i][j] += x * tiles::widen(sG[(q * NN + n) * D + j]);
    }
  float Ji[D][D], Ks[NH];
  const float scale = inverse<D>(J, Ji) * tiles::widen(sw[q]);
  metric<D>(Ji, Ks);

  // then one pass over the nodes, each table entry loaded once: values
  // and reference gradients of the C components of u (and of due),
  // Laplacians of the velocity (lap_phi[n] = Hs[q, n, :] . Km), and the
  // value of the time derivative a0 u + u^{n-i} terms
  float v[C], dref[C][D], lap[D], upq[D];
  float dv[TAN ? C : 1], ddref[TAN ? C : 1][D], dl[TAN ? D : 1];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    v[k] = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) dref[k][a] = 0.0f;
    if constexpr (TAN) {
      dv[k] = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a) ddref[k][a] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    lap[i] = upq[i] = 0.0f;
    if constexpr (TAN) dl[i] = 0.0f;
  }
#pragma unroll (NU)
  for (int n = 0; n < NN; ++n) {
    const float bn = tiles::widen(sB[q * NN + n]);
    float g[D], lp = 0.0f;
#pragma unroll
    for (int a = 0; a < D; ++a) g[a] = tiles::widen(sG[(q * NN + n) * D + a]);
#pragma unroll
    for (int k = 0; k < NH; ++k)
      lp += tiles::widen(sH[(q * NN + n) * NH + k]) * Ks[k];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float u = tiles::ld<T>(st + S::O_UE, (n * C + k) * BE + el);
      v[k] += bn * u;
#pragma unroll
      for (int a = 0; a < D; ++a) dref[k][a] += g[a] * u;
      if (k < D) {
        lap[k] += lp * u;
        upq[k] += bn * fmaf(p.alpha0, u,
                            tiles::ld<T>(st + S::O_UP, (n * D + k) * BE + el));
      }
      if constexpr (TAN) {
        const float du = tiles::ld<TO>(st + S::O_DUE, (n * C + k) * BE + el);
        dv[k] += bn * du;
#pragma unroll
        for (int a = 0; a < D; ++a) ddref[k][a] += g[a] * du;
        if (k < D) dl[k] += lp * du;
      }
    }
  }

  // physical gradients: reference gradients times J^-1
  float grad[C][D], f[D];
  float duq[C], dgrad[C][D], dlap[D];
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f, t = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a) {
        s += dref[k][a] * Ji[a][i];
        if constexpr (TAN) t += ddref[k][a] * Ji[a][i];
      }
      grad[k][i] = s;
      if constexpr (TAN) dgrad[k][i] = t;
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
    f[i] = tiles::ld<T>(st + S::O_FQ, (q * D + i) * BE + el);
  if constexpr (TAN) {
#pragma unroll
    for (int k = 0; k < C; ++k) duq[k] = dv[k];
#pragma unroll
    for (int i = 0; i < D; ++i) dlap[i] = dl[i];
  } else if constexpr (MODE == PROBE) {
    const int n0 = p.probe_node;
    float gphys[D], lpn = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a)
        s += tiles::widen(sG[(q * NN + n0) * D + a]) * Ji[a][i];
      gphys[i] = s;
    }
#pragma unroll
    for (int k = 0; k < NH; ++k)
      lpn += tiles::widen(sH[(q * NN + n0) * NH + k]) * Ks[k];
    probe_direction<D>(tiles::widen(sB[q * NN + n0]), gphys, lpn,
                       p.probe_comp, duq, dgrad, dlap);
  }
  float a_v[D], a_g[D][D], a_p, a_pg[D], a_lap[D];
  weak_form<D, MODE>(p, tiles::ld<T>(st + S::O_H, el), scale, v, grad, lap,
                     upq, f, duq, dgrad, dlap, a_v, a_g, a_p, a_pg, a_lap);

  // stage the reference-frame coefficients: ag_ref = a_g J^-T,
  // apg_ref = J^-1 a_pg
#pragma unroll
  for (int a = 0; a < D; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) s += a_pg[j] * Ji[a][j];
    cq[(S::APG + a) * BE] = s;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) t += a_g[i][j] * Ji[a][j];
      cq[(S::AG + i * D + a) * BE] = t;
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    cq[(S::AV + i) * BE] = a_v[i];
    cq[(S::ALAP + i) * BE] = a_lap[i];
  }
  cq[S::AP * BE] = a_p;
#pragma unroll
  for (int k = 0; k < NH; ++k) cq[(S::KM + k) * BE] = Ks[k];
}

// Phase B: node n of element el: acc[i] = sum_q (B a_v + G . ag_ref +
// lap_phi a_lap)_i, acc[D] = sum_q (B a_p + G . apg_ref).
template <int D, int K, int MODE, int OE, int Q1>
__device__ __forceinline__ void node_contraction(
    const tiles::state_t<OE>* tab, const float* coef, int n, int el,
    float (&acc)[D + 1]) {
  using S = Shape<D, K, MODE, 4, OE, Q1>;
  using TO = tiles::state_t<OE>;
  constexpr int NN = S::NN, NQ = S::NQ, BE = S::BE, NH = S::NH;
  const TO* sB = tab;
  const TO* sG = sB + S::TB;
  const TO* sH = sG + S::TG;
#pragma unroll
  for (int i = 0; i <= D; ++i) acc[i] = 0.0f;
#pragma unroll 3
  for (int q = 0; q < NQ; ++q) {
    const float* cq = coef + q * S::NCOEF * BE + el;
    const float bn = tiles::widen(sB[q * NN + n]);
    float g[D];
#pragma unroll
    for (int a = 0; a < D; ++a) g[a] = tiles::widen(sG[(q * NN + n) * D + a]);
    float lp = 0.0f;
#pragma unroll
    for (int k = 0; k < NH; ++k)
      lp += tiles::widen(sH[(q * NN + n) * NH + k]) * cq[(S::KM + k) * BE];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float s = bn * cq[(S::AV + i) * BE] + lp * cq[(S::ALAP + i) * BE];
#pragma unroll
      for (int a = 0; a < D; ++a) s += g[a] * cq[(S::AG + i * D + a) * BE];
      acc[i] += s;
    }
    float s = bn * cq[S::AP * BE];
#pragma unroll
    for (int a = 0; a < D; ++a) s += g[a] * cq[(S::APG + a) * BE];
    acc[D] += s;
  }
}

template <int D, int K, int MODE, int SE, int OE, int Q1>
__global__ void __launch_bounds__(Shape<D, K, MODE, SE, OE, Q1>::THREADS)
    gls_element_kernel(const __grid_constant__ Params p) {
  using S = Shape<D, K, MODE, SE, OE, Q1>;
  using TO = tiles::state_t<OE>;
  constexpr int BE = S::BE, C = S::C;

  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[tiles::STAGES];
  TO* tab = reinterpret_cast<TO*>(smem);
  float* stages = smem + S::TABLE_WORDS;
  float* coef = stages + tiles::STAGES * S::STAGE;
  const tiles::Ring<BE, S::THREADS, 6> ring{stages, S::STAGE, bars, p.path};
  constexpr int off[6] = {S::O_UE, S::O_DUE, S::O_XE, S::O_UP, S::O_FQ,
                          S::O_H};
  constexpr int esz[6] = {SE, OE, SE, SE, SE, SE};
  const TO* tables = static_cast<const TO*>(p.tables);
  TO* out = static_cast<TO*>(p.out);
  // the output's row pitch: E for f32, the rows' pitch for bf16
  const int64_t OP = OE == 4 ? p.E : p.in.narrow_pitch;

  const int tid = threadIdx.x;
  const int el = tid % BE;
  const int slot = tid / BE;                // q in phase A, n in phase B
  const int64_t E = p.E;
  const int64_t ntiles = (E + BE - 1) / BE;

  // the first tile's loads start before the tables are staged, so the
  // two latencies overlap
  ring.init(tid);
  int64_t t = blockIdx.x;
  if (t < ntiles)
    ring.issue(p.in, off, esz, S::STAGE_BYTES, E, t * BE, 0, tid);
  for (int i = tid; i < S::TABLES; i += S::THREADS) tab[i] = tables[i];
  __syncthreads();

  for (int it = 0; t < ntiles; ++it, t += gridDim.x) {
    const int s = it % tiles::STAGES;
    const int64_t next = t + gridDim.x;
    if (next < ntiles)
      ring.issue(p.in, off, esz, S::STAGE_BYTES, E, next * BE, s ^ 1,
                 tid);
    else
      ring.skip();
    ring.wait(it);
    __syncthreads();

    if (slot < S::NQ)
      point_coefficients<D, K, MODE, SE, OE, Q1>(
          p, tab, ring.stage(s), slot, el, coef + slot * S::NCOEF * BE + el);
    __syncthreads();

    const int64_t e = t * BE + el;
    const int n = slot;
    if (n < S::NN && e < E && (MODE != PROBE || n == p.probe_node)) {
      float acc[C];
      node_contraction<D, K, MODE, OE, Q1>(tab, coef, n, el, acc);
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int64_t row = MODE == PROBE ? n * C * C + i * C + p.probe_comp
                                          : n * C + i;
        out[row * OP + e] = tiles::narrow<TO>(acc[i]);
      }
    }
  }
}

// ---------------------------------------------------------- REGISTERS --
// `split` (1, 2 or 4) adjacent threads per element, each with the
// element's rows loaded straight from the input rows into registers
// (coalesced over e), the tables staged in shared memory once per block
// and read as broadcasts.  Each thread walks every split-th point and
// projects it into its own nn*c accumulators; the split threads' sums
// are added with warp shuffles.  Splitting shortens each thread's chain
// where one thread per element would leave the card mostly idle.
// Compiled where the state fits the registers (not 3D Q2), with SPLIT 1,
// 2 or 4 in 2D and 1 in 3D (whose state fills the registers, and whose
// meshes fill the card with one thread per element).  At the
// Taylor-Couette shape (2D Q2, 12,288 elements) the tangent takes 2, the
// primal and the probe, with fewer registers, 4.
template <int D, int K, int MODE, int SPLIT, int SE, int OE>
__global__ void __launch_bounds__(REG_THREADS)
    gls_element_reg_kernel(const __grid_constant__ Params p) {
  using S = Shape<D, K, MODE, SE, OE>;
  using T = tiles::state_t<SE>;
  using TO = tiles::state_t<OE>;
  constexpr int NN = S::NN, NQ = S::NQ, C = S::C, NH = S::NH;
  constexpr bool TAN = MODE == TANGENT;
  extern __shared__ __align__(128) float smem[];
  TO* tab = reinterpret_cast<TO*>(smem);
  const TO* sB = tab;
  const TO* sG = sB + S::TB;
  const TO* sH = sG + S::TG;
  const TO* sw = sH + S::TH;
  const TO* tables = static_cast<const TO*>(p.tables);
  for (int i = threadIdx.x; i < S::TABLES; i += REG_THREADS)
    tab[i] = tables[i];
  __syncthreads();

  const int64_t E = p.E;
  // the state rows' pitch: E for f32, the caller's for bf16; the
  // direction's and the output's likewise
  const int64_t P = SE == 4 ? E : p.in.narrow_pitch;
  const int64_t PO = OE == 4 ? E : p.in.narrow_pitch;
  TO* out = static_cast<TO*>(p.out);
  const T* gue = static_cast<const T*>(p.in.ptr[0]);
  const TO* gdue = static_cast<const TO*>(p.in.ptr[1]);
  const T* gxe = static_cast<const T*>(p.in.ptr[2]);
  const T* gup = static_cast<const T*>(p.in.ptr[3]);
  const T* gfq = static_cast<const T*>(p.in.ptr[4]);
  const T* gh = static_cast<const T*>(p.in.ptr[5]);
  const int n0 = p.probe_node, j0 = p.probe_comp;
  constexpr int split = SPLIT, per_block = REG_THREADS / SPLIT;
  const int part = threadIdx.x % split;
  // the loop bound is the same for every thread of the block, so whole
  // warps reach the shuffles; the threads past E load element E - 1 and
  // store nothing
  for (int64_t base = (int64_t)blockIdx.x * per_block; base < E;
       base += (int64_t)gridDim.x * per_block) {
    const int64_t e = base + threadIdx.x / split;
    const bool live = e < E;
    const int64_t ec = live ? e : E - 1;
    float ue[NN * C], xe[NN * D], up[NN * D], due[TAN ? NN * C : 1];
#pragma unroll
    for (int r = 0; r < NN * C; ++r) ue[r] = tiles::ldg(gue + r * P + ec);
#pragma unroll
    for (int r = 0; r < NN * D; ++r) {
      xe[r] = tiles::ldg(gxe + r * P + ec);
      up[r] = tiles::ldg(gup + r * P + ec);
    }
    if constexpr (TAN) {
#pragma unroll
      for (int r = 0; r < NN * C; ++r) due[r] = tiles::ldg(gdue + r * PO + ec);
    }
    const float h = tiles::ldg(gh + ec);
    constexpr int NACC = MODE == PROBE ? C : NN * C;
    float acc[NACC];
#pragma unroll
    for (int r = 0; r < NACC; ++r) acc[r] = 0.0f;

#pragma unroll 1
    for (int q = part; q < NQ; q += split) {
      const TO* Bq = sB + q * NN;
      const TO* Gq = sG + q * NN * D;
      const TO* Hq = sH + q * NN * NH;
      float J[D][D];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int n = 0; n < NN; ++n)
            s += xe[n * D + i] * tiles::widen(Gq[n * D + j]);
          J[i][j] = s;
        }
      float Ji[D][D], Ks[NH];
      const float scale = inverse<D>(J, Ji) * tiles::widen(sw[q]);
      metric<D>(Ji, Ks);
      float lap_phi[NN];
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < NH; ++k) s += tiles::widen(Hq[n * NH + k]) * Ks[k];
        lap_phi[n] = s;
      }

      // values, physical gradients and Laplacians of u (and of due)
      float uq[C], grad[C][D], lap[D], upq[D], f[D];
      float duq[C], dgrad[C][D], dlap[D];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float v = 0.0f, dv = 0.0f, dref[D], ddref[D];
#pragma unroll
        for (int a = 0; a < D; ++a) dref[a] = ddref[a] = 0.0f;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float c = ue[n * C + k];
          v += tiles::widen(Bq[n]) * c;
#pragma unroll
          for (int a = 0; a < D; ++a)
            dref[a] += tiles::widen(Gq[n * D + a]) * c;
          if constexpr (TAN) {
            const float dc = due[n * C + k];
            dv += tiles::widen(Bq[n]) * dc;
#pragma unroll
            for (int a = 0; a < D; ++a)
              ddref[a] += tiles::widen(Gq[n * D + a]) * dc;
          }
        }
        uq[k] = v;
        if constexpr (TAN) duq[k] = dv;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = 0.0f, t = 0.0f;
#pragma unroll
          for (int a = 0; a < D; ++a) {
            s += dref[a] * Ji[a][i];
            if constexpr (TAN) t += ddref[a] * Ji[a][i];
          }
          grad[k][i] = s;
          if constexpr (TAN) dgrad[k][i] = t;
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float s = 0.0f, t = 0.0f, ds = 0.0f;
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          s += lap_phi[n] * ue[n * C + i];
          t += tiles::widen(Bq[n]) *
               fmaf(p.alpha0, ue[n * C + i], up[n * D + i]);
          if constexpr (TAN) ds += lap_phi[n] * due[n * C + i];
        }
        lap[i] = s;
        upq[i] = t;
        if constexpr (TAN) dlap[i] = ds;
        f[i] = tiles::ldg(gfq + (int64_t)(q * D + i) * P + ec);
      }
      float gn[D], lpn = 0.0f, bn0 = 0.0f;
      if constexpr (MODE == PROBE) {
#pragma unroll
        for (int a = 0; a < D; ++a) gn[a] = tiles::widen(Gq[n0 * D + a]);
        bn0 = tiles::widen(Bq[n0]);
#pragma unroll
        for (int k = 0; k < NH; ++k)
          lpn += tiles::widen(Hq[n0 * NH + k]) * Ks[k];
        float gphys[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = 0.0f;
#pragma unroll
          for (int a = 0; a < D; ++a) s += gn[a] * Ji[a][i];
          gphys[i] = s;
        }
        probe_direction<D>(bn0, gphys, lpn, j0, duq, dgrad, dlap);
      }
      float a_v[D], a_g[D][D], a_p, a_pg[D], a_lap[D];
      weak_form<D, MODE>(p, h, scale, uq, grad, lap, upq, f, duq, dgrad, dlap,
                         a_v, a_g, a_p, a_pg, a_lap);

      // transpose contraction back to the nodes
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
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = bn0 * a_v[i] + lpn * a_lap[i];
#pragma unroll
          for (int a = 0; a < D; ++a) s += gn[a] * ag_ref[i][a];
          acc[i] += s;
        }
        float s = bn0 * a_p;
#pragma unroll
        for (int a = 0; a < D; ++a) s += gn[a] * apg_ref[a];
        acc[D] += s;
      } else {
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          const float bn = tiles::widen(Bq[n]);
#pragma unroll
          for (int i = 0; i < D; ++i) {
            float s = bn * a_v[i] + lap_phi[n] * a_lap[i];
#pragma unroll
            for (int a = 0; a < D; ++a)
              s += tiles::widen(Gq[n * D + a]) * ag_ref[i][a];
            acc[n * C + i] += s;
          }
          float s = bn * a_p;
#pragma unroll
          for (int a = 0; a < D; ++a)
            s += tiles::widen(Gq[n * D + a]) * apg_ref[a];
          acc[n * C + D] += s;
        }
      }
    }
#pragma unroll
    for (int off = 1; off < split; off <<= 1)
#pragma unroll
      for (int r = 0; r < NACC; ++r)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    if (!live || part != 0) continue;
    if constexpr (MODE == PROBE) {
#pragma unroll
      for (int i = 0; i < C; ++i)
        out[(int64_t)(n0 * C * C + i * C + j0) * PO + e] =
            tiles::narrow<TO>(acc[i]);
    } else {
#pragma unroll
      for (int r = 0; r < NN * C; ++r)
        out[r * PO + e] = tiles::narrow<TO>(acc[r]);
    }
  }
}

// ----------------------------------------------------------- dispatch --
template <int D, int K>
constexpr bool has_split(int split) {
  return !(D == 3 && K == 2) &&
         (split == 1 || (D == 2 && (split == 2 || split == 4)));
}

// (blocks per SM, shared-memory bytes, threads) of one variant, cached
template <int D, int K, int MODE, int SPLIT, int SE, int OE>
cudaError_t reg_config(int* blocks, int* smem_bytes, int* threads) {
  constexpr size_t smem =
      sizeof(tiles::state_t<OE>) * Shape<D, K, MODE, SE, OE>::TABLES;
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = tiles::occupancy(
        gls_element_reg_kernel<D, K, MODE, SPLIT, SE, OE>, REG_THREADS, smem,
        &cached);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = (int)smem;
  *threads = REG_THREADS;
  return cudaSuccess;
}

template <int D, int K, int MODE, int SE, int OE, int Q1>
cudaError_t staged_config(int* blocks, int* smem_bytes, int* threads) {
  using S = Shape<D, K, MODE, SE, OE, Q1>;
  constexpr size_t smem = sizeof(float) * S::SMEM_FLOATS;
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = tiles::occupancy(
        gls_element_kernel<D, K, MODE, SE, OE, Q1>, S::THREADS, smem,
        &cached);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = (int)smem;
  *threads = S::THREADS;
  return cudaSuccess;
}

template <int D, int K, int MODE, int SPLIT, int SE, int OE>
cudaError_t reg_run(bool query, const Params& p, int grid, cudaStream_t s,
                    int* blocks, int* smem, int* threads) {
  if constexpr (has_split<D, K>(SPLIT)) {
    cudaError_t err = reg_config<D, K, MODE, SPLIT, SE, OE>(blocks, smem,
                                                            threads);
    if (err != cudaSuccess || query || p.E == 0 || grid <= 0) return err;
    gls_element_reg_kernel<D, K, MODE, SPLIT, SE, OE>
        <<<grid, REG_THREADS, *smem, s>>>(p);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// REGISTERS is compiled for the (degree + 1)-point rule only
template <int D, int K, int MODE, int SE, int OE, int Q1>
cudaError_t run(int route, int split, bool query, Params& p, int grid,
                cudaStream_t s, int* blocks, int* smem, int* threads) {
  using S = Shape<D, K, MODE, SE, OE, Q1>;
  if (route == REGISTERS) {
    if constexpr (Q1 != K + 1) return cudaErrorInvalidValue;
    switch (split) {
      case 1: return reg_run<D, K, MODE, 1, SE, OE>(query, p, grid, s, blocks, smem, threads);
      case 2: return reg_run<D, K, MODE, 2, SE, OE>(query, p, grid, s, blocks, smem, threads);
      case 4: return reg_run<D, K, MODE, 4, SE, OE>(query, p, grid, s, blocks, smem, threads);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != STAGED) return cudaErrorInvalidValue;
  cudaError_t err = staged_config<D, K, MODE, SE, OE, Q1>(blocks, smem,
                                                          threads);
  if (err != cudaSuccess || query || p.E == 0 || grid <= 0) return err;
  p.in.rows[0] = S::R_UE;
  p.in.rows[1] = S::R_DUE;
  p.in.rows[2] = S::R_XE;
  p.in.rows[3] = S::R_UP;
  p.in.rows[4] = S::R_FQ;
  p.in.rows[5] = S::R_H;
  if (p.path == tiles::LOAD_TMA) {
    const int esz[6] = {SE, OE, SE, SE, SE, SE};
    err = tiles::encode_inputs(p.in, 6, p.E, S::BE, esz);
    if (err != cudaSuccess) return err;
  }
  gls_element_kernel<D, K, MODE, SE, OE, Q1>
      <<<grid, S::THREADS, *smem, s>>>(p);
  return cudaGetLastError();
}

// f32 (`state_bytes` = `operand_bytes` = 4); the tangent and the probe
// with a bf16 state (2, 4); every mode with bf16 operands (2, 2)
template <int D, int K, int Q1>
cudaError_t dispatch(int mode, int state_bytes, int operand_bytes, int route,
                     int split, bool query, Params& p, int grid,
                     cudaStream_t s, int* blocks, int* smem, int* threads) {
  switch (mode * 100 + state_bytes * 10 + operand_bytes) {
    case PRIMAL * 100 + 44:
      return run<D, K, PRIMAL, 4, 4, Q1>(route, split, query, p, grid, s,
                                         blocks, smem, threads);
    case TANGENT * 100 + 44:
      return run<D, K, TANGENT, 4, 4, Q1>(route, split, query, p, grid, s,
                                          blocks, smem, threads);
    case PROBE * 100 + 44:
      return run<D, K, PROBE, 4, 4, Q1>(route, split, query, p, grid, s,
                                        blocks, smem, threads);
    case TANGENT * 100 + 24:
      return run<D, K, TANGENT, 2, 4, Q1>(route, split, query, p, grid, s,
                                          blocks, smem, threads);
    case PROBE * 100 + 24:
      return run<D, K, PROBE, 2, 4, Q1>(route, split, query, p, grid, s,
                                        blocks, smem, threads);
    case PRIMAL * 100 + 22:
      return run<D, K, PRIMAL, 2, 2, Q1>(route, split, query, p, grid, s,
                                         blocks, smem, threads);
    case TANGENT * 100 + 22:
      return run<D, K, TANGENT, 2, 2, Q1>(route, split, query, p, grid, s,
                                          blocks, smem, threads);
    case PROBE * 100 + 22:
      return run<D, K, PROBE, 2, 2, Q1>(route, split, query, p, grid, s,
                                        blocks, smem, threads);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_shape(int dim, int degree, int points, int mode,
                           int state_bytes, int operand_bytes, int route,
                           int split, bool query, Params& p, int grid,
                           cudaStream_t s, int* blocks, int* smem,
                           int* threads) {
  switch (dim * 100 + degree * 10 + points) {
    case 212:
      return dispatch<2, 1, 2>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    case 213:
      return dispatch<2, 1, 3>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    case 223:
      return dispatch<2, 2, 3>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    case 312:
      return dispatch<3, 1, 2>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    case 313:
      return dispatch<3, 1, 3>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    case 323:
      return dispatch<3, 2, 3>(mode, state_bytes, operand_bytes, route,
                               split, query, p, grid, s, blocks, smem,
                               threads);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The variant's blocks per SM (after opting it in to its dynamic shared
// memory), shared-memory bytes and threads per block on route STAGED (0)
// or REGISTERS (1, with `split` threads per element), with `points` Gauss
// points per axis, state rows of `state_bytes` (4: f32; 2: bf16) and a
// direction, tables and output of `operand_bytes` (4: f32; 2: bf16, with
// bf16 state rows); the caller sizes the persistent grid from them.
// Returns a CUDA error code (cudaErrorInvalidValue for a variant that is
// not compiled).
extern "C" int gls_element_config(int dim, int degree, int points, int mode,
                                  int state_bytes, int operand_bytes,
                                  int route, int split, int* blocks_per_sm,
                                  int* smem_bytes, int* threads) {
  Params p{};
  return static_cast<int>(dispatch_shape(dim, degree, points, mode,
                                         state_bytes, operand_bytes, route,
                                         split, true, p, 0, nullptr,
                                         blocks_per_sm, smem_bytes, threads));
}

// Launches one variant on `stream` with `grid` blocks, on route STAGED (0)
// with load path `path` (tiles::LOAD_*; TMA needs every row pitch a
// multiple of 16 bytes and 16-byte aligned inputs) or REGISTERS (1) with
// `split` threads per element (1, 2 or 4 in 2D, 1 in 3D; REG_THREADS /
// split elements a block).  The state rows ue, xe, up, fq and h are f32
// (`state_bytes` 4, row pitch E) or bf16 (2, row pitch `state_pitch`,
// even, and 4-byte aligned rows); due, the tables and out are f32
// (`operand_bytes` 4; due and out with row pitch E) or, with bf16 state
// rows, bf16 (2; due and out at the rows' pitch `state_pitch`).  Returns
// cudaGetLastError() after the launch (0 on success);
// cudaErrorInvalidValue for a (dim, degree, points, mode, state and
// operand types, route) that is not compiled.  Does not synchronise and
// allocates nothing.
extern "C" int gls_element_launch(
    int dim, int degree, int points, int mode, int state_bytes,
    int operand_bytes, const void* ue, const void* due, const void* xe,
    const void* up,
    const void* fq, const void* h, const void* tables, void* out,
    int64_t n_elements, int64_t state_pitch, float nu, float alpha0,
    float sdt, int supg, int pspg, int gls_adjoint, int lsic,
    int probe_node, int probe_comp, int route, int split, int grid,
    int path, void* stream) {
  if (path != tiles::LOAD_CP_ASYNC_4 && path != tiles::LOAD_TMA)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.in.ptr[0] = ue;
  p.in.ptr[1] = due;
  p.in.ptr[2] = xe;
  p.in.ptr[3] = up;
  p.in.ptr[4] = fq;
  p.in.ptr[5] = h;
  p.in.narrow_pitch = state_pitch;
  p.tables = tables;
  p.out = out;
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
  p.path = path;
  int blocks, smem, threads;
  return static_cast<int>(dispatch_shape(dim, degree, points, mode,
                                         state_bytes, operand_bytes, route,
                                         split, false, p, grid,
                                         static_cast<cudaStream_t>(stream),
                                         &blocks, &smem, &threads));
}
