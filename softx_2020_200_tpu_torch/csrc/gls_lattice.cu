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
// CUDA cores (no tensor cores, so no TF32).  The time derivative a0 u +
// sum a_i u^{n-i} is interpolated from its nodal values (one fmaf per
// node), a small difference of two large terms: f32 then rounds the small
// result and not a0 times the interpolated u.
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
// JAX package).
//
// State type (SE, bytes per element): the tangent and the probe are also
// compiled for a bf16 state (SE = 2), B2's state_dtype=bfloat16
// (pallas_lattice.py:357-360, :421-424): ue, up and fq arrive as bf16 rows
// at an even row pitch, stay bf16 in the ring stage or go straight to
// registers, and are widened to f32 where they are read; the products with
// T_all and T_proj, due and out stay f32 (B2's one-pass bf16 matrix-unit
// product under state_dtype is a rate trick of the TPU and is not
// ported).  At TGV 32^3 the tangent's bytes fall from 144 to 104 f32-word
// equivalents per element (bytes 4.1 us, operations 4.4 us).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): at 3D Q1 an element moves 448 B in the primal and 576 B in the
// tangent against about 5.7 and 8.6 kFLOP: memory-bound (5.6 us for the
// tangent at 32^3).  At 3D Q2 about 60 kFLOP against 1,512 B per element:
// compute-bound.  The first design ran one block per 32 (or 16) elements
// strictly in sequence: restage the tables, copy the rows with scalar
// loads, interpolate at two shared-memory loads per FMA, project; nothing
// hid the load latency, and the shared-memory load issue rate, not the
// memory, set its time at 3D Q1.
//
// Two routes, on the skeleton of persistent_tiles.cuh (a persistent grid
// of at most occupancy x SMs blocks, walking element tiles):
//   STAGED     every compiled shape.  A block stages the tables once, then
//              per tile of BE elements (32; 16 when nq or nn is 27) the
//              rows arrive in a two-stage ring by TMA (4-byte cp.async
//              where the row pitch is not a multiple of 16 bytes) while the
//              previous tile computes: thread (q, e) interpolates and
//              evaluates the physics at point q into shared-memory
//              coefficients (phase A), then thread (n, e) projects (phase
//              B).  No thread holds an element's c*nn accumulators.
//   REGISTERS  Q1 with 2 points per axis on a lattice of boxes only: one
//              thread per element, its rows loaded straight into registers
//              with coalesced loads, the tables passed as a
//              __grid_constant__ kernel parameter so the unrolled products
//              read them as constant operands (no shared memory at all);
//              the Laplacian rows, zero for a multilinear basis on a box,
//              are left out: the launch is refused unless the caller
//              confirms they are zero (not on a sheared lattice).
// STAGED loads each table entry once per point for every component
// (one pass over the nodes) and each T_proj entry once per node for every
// component, but its cost is still shared-memory traffic; REGISTERS moves
// only the rows.  The caller picks the route per launch from the shape and
// E: REGISTERS where one thread per element fills the card (from 128
// elements per SM on; ops/lattice_kernel.py).  What bounds this design:
// STAGED, the shared-memory load issue (one load per product) that set
// the first design's time too, now with the tables staged once per block
// and the next tile's rows in flight; REGISTERS, at 3D Q1, occupancy (about
// 170 registers a thread, 12 warps an SM) with the FMAs of the unrolled
// products, about 2x over the byte bound.  Measured times of both routes:
// PERF.md.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgls_lattice.so gls_lattice.cu

#include <string.h>

#include "persistent_tiles.cuh"

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;
constexpr int PROBE = 2;
constexpr int STAGED = 0;
constexpr int REGISTERS = 1;
constexpr int REG_THREADS = 128;

using tiles::pad32;

template <int D, int K, int Q, int MODE, int SE = 4>
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
  // inputs: ue, due, up, fq; due is f32, the frozen state ue, up and fq
  // SE-byte elements: f32, or bf16 in the bf16-state tangent and probe
  static constexpr int R_UE = C * NN, R_DUE = MODE == TANGENT ? C * NN : 0,
                       R_UP = D * NN, R_FQ = D * NQ;
  static constexpr int O_UE = 0,
                       O_DUE = O_UE + tiles::box_words(R_UE, BE, SE),
                       O_UP = O_DUE + tiles::box_words(R_DUE, BE, 4),
                       O_FQ = O_UP + tiles::box_words(R_UP, BE, SE),
                       STAGE = O_FQ + tiles::box_words(R_FQ, BE, SE);
  static constexpr int STAGE_BYTES =
      BE * (SE * (R_UE + R_UP + R_FQ) + 4 * R_DUE);
  static constexpr int SMEM_FLOATS =
      pad32(TABLES) + tiles::STAGES * STAGE + CROWS * BE;
};

struct Physics {
  float nu, h, alpha0, sdt;
  int supg, pspg, gls_adjoint, lsic;
  int probe_node, probe_comp;
};

struct Params {
  tiles::Inputs in;
  const float* tables;
  float* out;
  int64_t E;
  Physics ph;
  int path;
};

// The pointwise weak form at one quadrature point, as B2's body writes it:
// from the values, gradients and Laplacians of (u, p) (and of the
// direction for the tangent and the probe) and s = udot - f, the
// coefficients against phi (a_v), grad phi (a_g), lap phi (a_lap) for the
// velocity and against psi (a_p), grad psi (a_pg) for the pressure.
template <int D, int MODE>
struct Point {
  float vel[D], gvel[D][D], lap[D], pr, gp[D], s[D];
  float dvel[D], dgvel[D][D], dlap[D], dp, dgp[D];

  __device__ __forceinline__ void coefficients(
      const Physics& ph, float (&a_v)[D], float (&a_g)[D][D],
      float (&a_lap)[D], float& a_p, float (&a_pg)[D]) const {
    const float nu = ph.nu, h = ph.h, alpha0 = ph.alpha0, sdt = ph.sdt;
    const float inv_h2 = 1.0f / (h * h);
    const float visc_term = 9.0f * (4.0f * nu) * (4.0f * nu) * inv_h2 * inv_h2;
    float conv[D], r_m[D];
    float div = 0.0f, umag2 = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float c = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) c += gvel[i][j] * vel[j];
      conv[i] = c;
      r_m[i] = s[i] + conv[i] + gp[i] - nu * lap[i];
      div += gvel[i][i];
      umag2 += vel[i] * vel[i];
    }
    const float tau = 1.0f / sqrtf(sdt * sdt + 4.0f * umag2 * inv_h2 +
                                   visc_term);
    const float tau_l = 0.5f * sqrtf(umag2) * h;
    if constexpr (MODE == PRIMAL) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a_v[i] = s[i] + conv[i];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          a_g[i][j] = nu * gvel[i][j] - (i == j ? pr : 0.0f);
          if (ph.supg) a_g[i][j] += tau * r_m[i] * vel[j];
        }
        if (ph.lsic) a_g[i][i] += tau_l * div;
        a_pg[i] = ph.pspg ? tau * r_m[i] : 0.0f;
        a_lap[i] = ph.gls_adjoint ? -tau * nu * r_m[i] : 0.0f;
      }
      a_p = div;
    } else {
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
          if (ph.supg)
            a_g[i][j] += tau * (dr_m[i] * vel[j] + r_m[i] * dvel[j]);
        }
        if (ph.lsic) a_g[i][i] += tau_l * ddiv;
        a_pg[i] = ph.pspg ? tau * dr_m[i] : 0.0f;
        a_lap[i] = ph.gls_adjoint ? -tau * nu * dr_m[i] : 0.0f;
      }
      a_p = ddiv;
    }
  }

  // the one-hot probe direction from the table column of node n0:
  // t[b] = T_all[b*NQ + q, n0], b = 0..D+1
  __device__ __forceinline__ void probe(const float (&t)[D + 2], int j0) {
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
};

// ------------------------------------------------------------- STAGED --
// Phase A: point q of element el of the staged tile `st` into the
// coefficient rows sC [CROWS][BE]: row (i*M + b*NQ + q) for velocity
// component i and block b (value, gradients, Laplacian); row
// (D*M + b*NQ + q) for the pressure
template <int D, int K, int Q, int MODE, int SE>
__device__ __forceinline__ void stage_point(const Physics& ph, const float* sT,
                                            const float* st, int q, int el,
                                            float* sC) {
  using S = Shape<D, K, Q, MODE, SE>;
  using T = tiles::state_t<SE>;
  constexpr int NN = S::NN, NQ = S::NQ, M = S::M, BE = S::BE, C = S::C;
  constexpr bool TAN = MODE == TANGENT;
  // one pass over the nodes, each table entry T_all[b*NQ + q, n] loaded
  // once: value (b = 0), gradients (1..D) and Laplacian (D+1) of every
  // component of u (and of due), and the value of a0 u + u^{n-i} terms
  float a[C][D + 2], da[TAN ? C : 1][D + 2], upv[D];
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int b = 0; b < D + 2; ++b) {
      a[k][b] = 0.0f;
      if constexpr (TAN) da[k][b] = 0.0f;
    }
#pragma unroll
  for (int i = 0; i < D; ++i) upv[i] = 0.0f;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float t[D + 2];
#pragma unroll
    for (int b = 0; b < D + 2; ++b) t[b] = sT[(b * NQ + q) * NN + n];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float u = tiles::ld<T>(st + S::O_UE, (k * NN + n) * BE + el);
#pragma unroll
      for (int b = 0; b < D + 2; ++b) a[k][b] += t[b] * u;
      if (k < D)
        upv[k] += t[0] * fmaf(ph.alpha0, u,
                              tiles::ld<T>(st + S::O_UP, (k * NN + n) * BE + el));
      if constexpr (TAN) {
        const float du = st[S::O_DUE + (k * NN + n) * BE + el];
#pragma unroll
        for (int b = 0; b < D + 2; ++b) da[k][b] += t[b] * du;
      }
    }
  }

  Point<D, MODE> pt;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    pt.vel[k] = a[k][0];
    pt.lap[k] = a[k][D + 1];
    pt.s[k] = upv[k] - tiles::ld<T>(st + S::O_FQ, (k * NQ + q) * BE + el);
#pragma unroll
    for (int j = 0; j < D; ++j) pt.gvel[k][j] = a[k][1 + j];
  }
  pt.pr = a[D][0];
#pragma unroll
  for (int j = 0; j < D; ++j) pt.gp[j] = a[D][1 + j];
  if constexpr (TAN) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      pt.dvel[k] = da[k][0];
      pt.dlap[k] = da[k][D + 1];
#pragma unroll
      for (int j = 0; j < D; ++j) pt.dgvel[k][j] = da[k][1 + j];
    }
    pt.dp = da[D][0];
#pragma unroll
    for (int j = 0; j < D; ++j) pt.dgp[j] = da[D][1 + j];
  } else if constexpr (MODE == PROBE) {
    float t[D + 2];
#pragma unroll
    for (int b = 0; b < D + 2; ++b) t[b] = sT[(b * NQ + q) * NN + ph.probe_node];
    pt.probe(t, ph.probe_comp);
  }
  float a_v[D], a_g[D][D], a_lap[D], a_p, a_pg[D];
  pt.coefficients(ph, a_v, a_g, a_lap, a_p, a_pg);

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

template <int D, int K, int Q, int MODE, int SE>
__global__ void __launch_bounds__(Shape<D, K, Q, MODE, SE>::THREADS)
    gls_lattice_kernel(const __grid_constant__ Params p) {
  using S = Shape<D, K, Q, MODE, SE>;
  constexpr int NN = S::NN, NQ = S::NQ, C = S::C, M = S::M, MNL = S::MNL,
                BE = S::BE;

  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[tiles::STAGES];
  float* sT = smem;                         // T_all [M][NN]
  const float* sP = sT + M * NN;            // T_proj [NN][M]
  float* stages = smem + pad32(S::TABLES);
  float* sC = stages + tiles::STAGES * S::STAGE;   // coefficients
  const tiles::Ring<BE, S::THREADS, 4> ring{stages, S::STAGE, bars, p.path};
  constexpr int off[4] = {S::O_UE, S::O_DUE, S::O_UP, S::O_FQ};
  constexpr int esz[4] = {SE, 4, SE, SE};

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
  for (int i = tid; i < S::TABLES; i += S::THREADS) sT[i] = p.tables[i];
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

    if (slot < NQ)
      stage_point<D, K, Q, MODE, SE>(p.ph, sT, ring.stage(s), slot, el,
                                     sC);
    __syncthreads();

    // phase B: node n of element el
    const int n = slot;
    const int64_t e = t * BE + el;
    if (e < E && n < NN && (MODE != PROBE || n == p.ph.probe_node)) {
      // each T_proj entry loaded once for all C components
      const float* Prow = sP + n * M;
      const float* cn = sC + el;
      float acc[C];
#pragma unroll
      for (int k = 0; k < C; ++k) acc[k] = 0.0f;
#pragma unroll 4
      for (int r = 0; r < MNL; ++r) {
        const float pr = Prow[r];
#pragma unroll
        for (int k = 0; k < C; ++k) acc[k] += pr * cn[(k * M + r) * BE];
      }
#pragma unroll 4
      for (int r = MNL; r < M; ++r) {
        const float pr = Prow[r];
#pragma unroll
        for (int k = 0; k < D; ++k) acc[k] += pr * cn[(k * M + r) * BE];
      }
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int64_t row = MODE == PROBE ? n * C * C + k * C + p.ph.probe_comp
                                          : k * NN + n;
        p.out[row * E + e] = acc[k];
      }
    }
  }
}

// ---------------------------------------------------------- REGISTERS --
// Q1 on a lattice of boxes: the basis is multilinear and the element axis-
// aligned, so the Laplacian rows of T_all (and columns of T_proj) are zero
// and this route leaves them out (the caller takes it only then).
template <int D>
struct RegShape {
  static constexpr int NN = D == 2 ? 4 : 8;   // Q1
  static constexpr int NQ = NN;               // 2 points per axis
  static constexpr int C = D + 1;
  static constexpr int M = (D + 2) * NQ;      // rows of the packed T_all
  static constexpr int MNL = (D + 1) * NQ;    // its value + gradient rows
};

template <int D, int SE>
struct RegParams {
  const tiles::state_t<SE>* ue;
  const float* due;
  const tiles::state_t<SE>* up;
  const tiles::state_t<SE>* fq;
  float* out;
  int64_t E;
  int64_t pitch;      // row pitch of ue, up and fq (E for f32)
  Physics ph;
  float T[RegShape<D>::MNL * RegShape<D>::NN];   // T_all [MNL][NN]
  float P[RegShape<D>::NN * RegShape<D>::MNL];   // T_proj [NN][MNL]
};

template <int D, int MODE, int SE>
__global__ void __launch_bounds__(REG_THREADS)
    gls_lattice_reg_kernel(const __grid_constant__ RegParams<D, SE> p) {
  using S = RegShape<D>;
  constexpr int NN = S::NN, NQ = S::NQ, C = S::C, M = S::MNL;
  const int64_t E = p.E;
  const int64_t P = SE == 4 ? E : p.pitch;
  const int n0 = p.ph.probe_node, j0 = p.ph.probe_comp;
  for (int64_t e = (int64_t)blockIdx.x * REG_THREADS + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * REG_THREADS) {
    float u[C * NN], du[MODE == TANGENT ? C * NN : 1];
#pragma unroll
    for (int r = 0; r < C * NN; ++r) u[r] = tiles::ldg(p.ue + r * P + e);
    if constexpr (MODE == TANGENT) {
#pragma unroll
      for (int r = 0; r < C * NN; ++r) du[r] = __ldg(p.due + r * E + e);
    }
    constexpr int NACC = MODE == PROBE ? C : C * NN;
    float acc[NACC];
#pragma unroll
    for (int r = 0; r < NACC; ++r) acc[r] = 0.0f;

    // the 3D tangent walks the points one at a time (its state, u, due
    // and the accumulators, fills the registers), reading the tables by a
    // uniform index; the rest unrolls the points.  u^{n-i} is read at
    // each point (from L1 after the first), not held.
#pragma unroll (D == 3 && MODE == TANGENT ? 1 : NQ)
    for (int q = 0; q < NQ; ++q) {
      Point<D, MODE> pt;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        float a[D + 1], da[D + 1];
#pragma unroll
        for (int b = 0; b <= D; ++b) {
          a[b] = 0.0f;
          da[b] = 0.0f;
        }
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int b = 0; b <= D; ++b) {
            const float t = p.T[(b * NQ + q) * NN + n];
            a[b] += t * u[k * NN + n];
            if constexpr (MODE == TANGENT) da[b] += t * du[k * NN + n];
          }
        if (k < D) {
          pt.vel[k] = a[0];
          pt.lap[k] = 0.0f;
          float s = -tiles::ldg(p.fq + (k * NQ + q) * P + e);
#pragma unroll
          for (int n = 0; n < NN; ++n)
            s += p.T[q * NN + n] *
                 fmaf(p.ph.alpha0, u[k * NN + n],
                      tiles::ldg(p.up + (k * NN + n) * P + e));
          pt.s[k] = s;
#pragma unroll
          for (int j = 0; j < D; ++j) pt.gvel[k][j] = a[1 + j];
          if constexpr (MODE == TANGENT) {
            pt.dvel[k] = da[0];
            pt.dlap[k] = 0.0f;
#pragma unroll
            for (int j = 0; j < D; ++j) pt.dgvel[k][j] = da[1 + j];
          }
        } else {
          pt.pr = a[0];
#pragma unroll
          for (int j = 0; j < D; ++j) pt.gp[j] = a[1 + j];
          if constexpr (MODE == TANGENT) {
            pt.dp = da[0];
#pragma unroll
            for (int j = 0; j < D; ++j) pt.dgp[j] = da[1 + j];
          }
        }
      }
      if constexpr (MODE == PROBE) {
        float t[D + 2];
#pragma unroll
        for (int b = 0; b <= D; ++b) t[b] = p.T[(b * NQ + q) * NN + n0];
        t[D + 1] = 0.0f;
        pt.probe(t, j0);
      }
      float a_v[D], a_g[D][D], a_lap[D], a_p, a_pg[D];
      pt.coefficients(p.ph, a_v, a_g, a_lap, a_p, a_pg);

      // project: out[k, n] += sum_b T_proj[n, b*NQ + q] coeff_k[b] (a_lap
      // meets the zero Laplacian columns)
      if constexpr (MODE == PROBE) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          float s = p.P[n0 * M + q] * a_v[i];
#pragma unroll
          for (int j = 0; j < D; ++j) s += p.P[n0 * M + (1 + j) * NQ + q] * a_g[i][j];
          acc[i] += s;
        }
        float s = p.P[n0 * M + q] * a_p;
#pragma unroll
        for (int j = 0; j < D; ++j) s += p.P[n0 * M + (1 + j) * NQ + q] * a_pg[j];
        acc[D] += s;
      } else {
#pragma unroll
        for (int n = 0; n < NN; ++n) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
            float s = p.P[n * M + q] * a_v[i];
#pragma unroll
            for (int j = 0; j < D; ++j)
              s += p.P[n * M + (1 + j) * NQ + q] * a_g[i][j];
            acc[i * NN + n] += s;
          }
          float s = p.P[n * M + q] * a_p;
#pragma unroll
          for (int j = 0; j < D; ++j) s += p.P[n * M + (1 + j) * NQ + q] * a_pg[j];
          acc[D * NN + n] += s;
        }
      }
    }
    if constexpr (MODE == PROBE) {
#pragma unroll
      for (int i = 0; i < C; ++i) p.out[(n0 * C * C + i * C + j0) * E + e] = acc[i];
    } else {
#pragma unroll
      for (int r = 0; r < C * NN; ++r) p.out[r * E + e] = acc[r];
    }
  }
}

// ----------------------------------------------------------- dispatch --
struct Launch {
  const void* ue;
  const float* due;
  const void* up;
  const void* fq;
  const float* tables;
  const float* host_tables;
  float* out;
  int64_t E, pitch;
  Physics ph;
  int grid, path, laplacian_free;
  cudaStream_t stream;
};

template <int D, int K, int Q, int MODE, int SE>
cudaError_t staged_config(int* blocks, int* smem_bytes, int* threads) {
  using S = Shape<D, K, Q, MODE, SE>;
  constexpr size_t smem = sizeof(float) * S::SMEM_FLOATS;
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = tiles::occupancy(
        gls_lattice_kernel<D, K, Q, MODE, SE>, S::THREADS, smem, &cached);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = (int)smem;
  *threads = S::THREADS;
  return cudaSuccess;
}

template <int D, int K, int Q, int MODE, int SE>
cudaError_t staged_launch(const Launch& a) {
  using S = Shape<D, K, Q, MODE, SE>;
  int blocks, smem, threads;
  cudaError_t err = staged_config<D, K, Q, MODE, SE>(&blocks, &smem,
                                                     &threads);
  if (err != cudaSuccess) return err;
  if (a.E == 0 || a.grid <= 0) return cudaSuccess;
  Params p{};
  p.in.ptr[0] = a.ue;
  p.in.ptr[1] = a.due;
  p.in.ptr[2] = a.up;
  p.in.ptr[3] = a.fq;
  p.in.rows[0] = S::R_UE;
  p.in.rows[1] = S::R_DUE;
  p.in.rows[2] = S::R_UP;
  p.in.rows[3] = S::R_FQ;
  p.in.narrow_pitch = a.pitch;
  p.tables = a.tables;
  p.out = a.out;
  p.E = a.E;
  p.ph = a.ph;
  p.path = a.path;
  if (p.path == tiles::LOAD_TMA) {
    const int esz[4] = {SE, 4, SE, SE};
    err = tiles::encode_inputs(p.in, 4, a.E, S::BE, esz);
    if (err != cudaSuccess) return err;
  }
  gls_lattice_kernel<D, K, Q, MODE, SE>
      <<<a.grid, S::THREADS, smem, a.stream>>>(p);
  return cudaGetLastError();
}

template <int D, int MODE, int SE>
cudaError_t reg_config(int* blocks, int* smem_bytes, int* threads) {
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, gls_lattice_reg_kernel<D, MODE, SE>, REG_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = 0;
  *threads = REG_THREADS;
  return cudaSuccess;
}

template <int D, int MODE, int SE>
cudaError_t reg_launch(const Launch& a) {
  using S = RegShape<D>;
  using T = tiles::state_t<SE>;
  int blocks, smem, threads;
  cudaError_t err = reg_config<D, MODE, SE>(&blocks, &smem, &threads);
  if (err != cudaSuccess) return err;
  if (a.E == 0 || a.grid <= 0) return cudaSuccess;
  RegParams<D, SE> p{};
  p.ue = static_cast<const T*>(a.ue);
  p.due = a.due;
  p.up = static_cast<const T*>(a.up);
  p.fq = static_cast<const T*>(a.fq);
  p.out = a.out;
  p.E = a.E;
  p.pitch = a.pitch;
  p.ph = a.ph;
  // the tables travel in the kernel parameters, copied from the caller's
  // host copy (no device read, so the launch can be captured in a graph)
  // (T_all's first MNL rows; T_proj's first MNL columns).  The Laplacian
  // rows left out must be zero, which the caller confirms
  // (`laplacian_free`): refused otherwise
  if (!a.host_tables || !a.laplacian_free) return cudaErrorInvalidValue;
  memcpy(p.T, a.host_tables, sizeof(p.T));
  for (int n = 0; n < S::NN; ++n)
    memcpy(p.P + n * S::MNL, a.host_tables + S::M * S::NN + n * S::M,
           sizeof(float) * S::MNL);
  gls_lattice_reg_kernel<D, MODE, SE><<<a.grid, REG_THREADS, 0, a.stream>>>(p);
  return cudaGetLastError();
}

// one variant: the primal reads f32 state only; the tangent and the probe,
// f32 or bf16 state (SE 4 or 2)
template <int D, int K, int Q, int MODE, int SE>
cudaError_t variant(int route, bool query, const Launch& a, int* blocks,
                    int* smem, int* threads) {
  if (route == REGISTERS) {
    if constexpr (K == 1 && Q == 2)
      return query ? reg_config<D, MODE, SE>(blocks, smem, threads)
                   : reg_launch<D, MODE, SE>(a);
    return cudaErrorInvalidValue;
  }
  if (route != STAGED) return cudaErrorInvalidValue;
  return query ? staged_config<D, K, Q, MODE, SE>(blocks, smem, threads)
               : staged_launch<D, K, Q, MODE, SE>(a);
}

template <int D, int K, int Q>
cudaError_t dispatch(int mode, int state_bytes, int route, bool query,
                     const Launch& a, int* blocks, int* smem, int* threads) {
  switch (mode * 10 + state_bytes) {
    case PRIMAL * 10 + 4: return variant<D, K, Q, PRIMAL, 4>(route, query, a, blocks, smem, threads);
    case TANGENT * 10 + 4: return variant<D, K, Q, TANGENT, 4>(route, query, a, blocks, smem, threads);
    case PROBE * 10 + 4: return variant<D, K, Q, PROBE, 4>(route, query, a, blocks, smem, threads);
    case TANGENT * 10 + 2: return variant<D, K, Q, TANGENT, 2>(route, query, a, blocks, smem, threads);
    case PROBE * 10 + 2: return variant<D, K, Q, PROBE, 2>(route, query, a, blocks, smem, threads);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_shape(int dim, int degree, int n_q1d, int mode,
                           int state_bytes, int route, bool query,
                           const Launch& a, int* blocks, int* smem,
                           int* threads) {
  switch (dim * 100 + degree * 10 + n_q1d) {
    case 212: return dispatch<2, 1, 2>(mode, state_bytes, route, query, a, blocks, smem, threads);
    case 213: return dispatch<2, 1, 3>(mode, state_bytes, route, query, a, blocks, smem, threads);
    case 223: return dispatch<2, 2, 3>(mode, state_bytes, route, query, a, blocks, smem, threads);
    case 312: return dispatch<3, 1, 2>(mode, state_bytes, route, query, a, blocks, smem, threads);
    case 313: return dispatch<3, 1, 3>(mode, state_bytes, route, query, a, blocks, smem, threads);
    case 323: return dispatch<3, 2, 3>(mode, state_bytes, route, query, a, blocks, smem, threads);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The variant's blocks per SM (after opting it in to its dynamic shared
// memory), shared-memory bytes and threads per block, with state rows of
// `state_bytes` (4: f32; 2: bf16, tangent and probe only); the caller
// sizes the persistent grid from them.  Returns a CUDA error code.
extern "C" int gls_lattice_config(int dim, int degree, int n_q1d, int mode,
                                  int state_bytes, int route,
                                  int* blocks_per_sm, int* smem_bytes,
                                  int* threads) {
  Launch a{};
  return static_cast<int>(dispatch_shape(dim, degree, n_q1d, mode,
                                         state_bytes, route, true, a,
                                         blocks_per_sm, smem_bytes, threads));
}

// Launches one variant on `stream` with `grid` blocks: route STAGED (0)
// with load path `path` (tiles::LOAD_*; TMA needs every row pitch a
// multiple of 16 bytes and 16-byte aligned inputs) and the packed tables
// `tables` on the card, or REGISTERS (1, Q1 with 2 points per axis) with
// the same tables in host memory (`host_tables`), whose Laplacian rows must
// be zero (a lattice of boxes), as the caller confirms with
// `laplacian_free` = 1.  The state rows ue, up and fq are f32
// (`state_bytes` 4, row pitch E) or, for the tangent and the probe, bf16
// (2, row pitch `state_pitch`, even, and 4-byte aligned rows); due and out
// are f32 with row pitch E.  Returns cudaGetLastError() after the launch
// (0 on success); cudaErrorInvalidValue for a (dim, degree, points per
// axis, mode, state type, route) that is not compiled or REGISTERS without
// `laplacian_free`.  Does not synchronise and allocates nothing.
extern "C" int gls_lattice_launch(
    int dim, int degree, int n_q1d, int mode, int state_bytes,
    const void* ue, const void* due, const void* up, const void* fq,
    const void* tables, const void* host_tables, void* out,
    int64_t n_elements, int64_t state_pitch, float nu, float h, float alpha0,
    float sdt, int supg, int pspg, int gls_adjoint, int lsic,
    int probe_node, int probe_comp, int route, int grid, int path,
    int laplacian_free, void* stream) {
  if (path != tiles::LOAD_CP_ASYNC_4 && path != tiles::LOAD_TMA)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{};
  a.ue = ue;
  a.due = static_cast<const float*>(due);
  a.up = up;
  a.fq = fq;
  a.tables = static_cast<const float*>(tables);
  a.host_tables = static_cast<const float*>(host_tables);
  a.out = static_cast<float*>(out);
  a.E = n_elements;
  a.pitch = state_pitch;
  a.ph = Physics{nu, h, alpha0, sdt, supg, pspg, gls_adjoint, lsic,
                 probe_node, probe_comp};
  a.grid = grid;
  a.path = path;
  a.laplacian_free = laplacian_free;
  a.stream = static_cast<cudaStream_t>(stream);
  int blocks, smem, threads;
  return static_cast<int>(dispatch_shape(dim, degree, n_q1d, mode,
                                         state_bytes, route, false, a,
                                         &blocks, &smem, &threads));
}
