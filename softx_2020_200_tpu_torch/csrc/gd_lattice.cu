// Grad-div Taylor-Hood (GD) lattice kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel B3: softx_2020_200_tpu/ops/pallas_lattice_gd.py,
// _build_gd_kernel (:59), with its constant tables from _gd_affine_tables
// (:36), launched through pl.pallas_call at :229.  The TPU kernel runs, per
// element of a lattice of translates of one element,
//   interpolate:  vel_i, grad vel_i = Tv @ u_i;  p = Tp @ u_p
//   physics:      a_v = alpha0 u + u_prev + (u.grad)u - f
//                 a_g = nu grad u + (gamma div u - p) I;  a_p = div u
//   project:      out_i = Pv @ [a_v_i; a_g_i*];  out_p = Pp @ a_p
// with dense tables Tv [(d+1)*nq, nnv], Tp [nq, nnp] and their transposes
// Pv, Pp (det J * w folded in).  The GD weak form has no stabilization
// parameter, so the tangent is the exact Jacobian action:
//   a_v = alpha0 du + (du.grad)u + (u.grad)du,  a_g = nu grad du
//         + (gamma div du - dp) I,  a_p = div du
// (it reads neither u_prev nor f).  Two variants (MODE): PRIMAL, the
// residual; TANGENT, the directional derivative along due.
//
// Sum factorization.  The Q2 velocity and Q1 pressure bases are tensor
// products in lexicographic order (axis 0 fastest), and so are the 3
// Gauss points per axis.  So this kernel computes the same function from
// 1D tables: V, D (values and derivatives of the 1D Q2 basis at the 3
// points, 3 x 3) and Vp (the 1D Q1 values, 3 x 2).  Values and the d
// reference gradients of a velocity component come out of d passes of
// 3-term contractions (3D: 729 multiply-adds a component against the
// 2,916 of Tv @ u; the pressure takes 2-term passes), J^-1 maps them to
// physical gradients (any affine translate: J^-1 is a full d x d matrix),
// the physics runs per point, J^-1 maps the gradient coefficients back to
// reference ones (b_a = sum_j J^-1[a][j] a_g[j]), and the transposed
// passes sum over the points with det J * w folded into the 1D weighted
// tables VW, DW, VpW (axis 0: VW0, DW0, VpW0 also carry det J).  All
// tables, with J^-1, travel in the kernel's __grid_constant__ parameters,
// and every loop over points, nodes and 1D terms is unrolled, so each
// table entry is a constant-bank operand of its FMA, never a load.  The
// products are f32 on the CUDA cores: no tensor cores, so no TF32, as the
// TPU kernel's HIGHEST-precision dots.
//
// Layout: mixed component-major rows with the element index fastest, as
// B3's: ue[RS, E] with RS = d*nnv + nnp (velocity component i at rows
// i*nnv + n, then the pressure at rows d*nnv + m), due like ue,
// vpe[d*nnv, E], fq[d*nq, E] (row i*nq + q); out[RS, E].  Compiled for
// Q2-Q1 in 2D and 3D with 3 Gauss points per axis.
//
// Two routes, on the skeleton of persistent_tiles.cuh (a persistent grid
// of at most occupancy x SMs blocks, walking element tiles):
//   STAGED     2D and 3D.  Tiles of BE = 32 elements arrive in a two-stage
//              ring by TMA (4-byte cp.async where the row pitch is not a
//              multiple of 16 bytes) while the previous tile computes.
//              Thread (pencil p, element e), 3^(d-1) pencils: a warp is
//              the 32 elements of one pencil, so every shared-memory
//              access is conflict-free and its row index warp-uniform.
//              Each pass reads a pencil of 3 values once and writes the
//              3-6 results it feeds; the last interpolation pass keeps its
//              3 points in registers, where the physics and the first
//              transposed pass run.  3D interpolates u, then due (or
//              u_prev), one after the other, to keep the scratch at 2 x
//              261 rows per element (2 blocks per SM in the tangent).
//   REGISTERS  2D only, from REG_MIN_PER_SM elements per SM on: one thread
//              per element, its 22 state rows (and 22 direction rows) in
//              registers, loaded with coalesced loads; no shared memory.
// Shared-memory accesses per element (thread loads and stores; the ring
// is filled by TMA or cp.async): STAGED tangent 280 in 2D and 2,720 in 3D
// (the first design: about 2,500 and 40,600), STAGED primal 262 and
// 2,315; REGISTERS none.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores): the 2D tangent moves 264 B per element against about 2.4 kFLOP
// of the sum-factorized form: bytes.  The 3D tangent moves 1,068 B
// against about 19.5 kFLOP: bytes too, by a little (10.4 against 9.6 us
// at 32^3; chip_smoke._bound_gd counts both).
// The first design's time was set by one shared-memory load per
// multiply-add (tables indexed by a thread-dependent point); this one
// reads no table from shared memory, moves a tenth of the shared-memory
// traffic and a quarter of the FMAs, and overlaps the next tile's loads.
// What bounds this design: STAGED, the passes' syncs and shared-memory
// round trips between them with 9 (2D: 3) warps a block; REGISTERS, the
// registers of one thread per element.  Measured: PERF.md.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libgd_lattice.so gd_lattice.cu

#include <string.h>

#include "persistent_tiles.cuh"

namespace {

constexpr int PRIMAL = 0;
constexpr int TANGENT = 1;
constexpr int STAGED = 0;
constexpr int REGISTERS = 1;
constexpr int REG_THREADS = 128;
constexpr int BE = 32;       // elements of a STAGED tile: one warp

using tiles::pad32;

// The 1D tables of the reference element and the lattice's J^-1, packed
// on the host (ops/lattice_gd_kernel.py::gd_1d_tables, same order).
struct Tables {
  float V[3][3];     // Q2 values       V[q][n]
  float D[3][3];     // Q2 derivatives  D[q][n]
  float Vp[3][2];    // Q1 values       Vp[q][m]
  float VW[3][3];    // V * w[q]        (axes 1, 2 of the projection)
  float DW[3][3];    // D * w[q]
  float VpW[3][2];   // Vp * w[q]
  float VW0[3][3];   // V * w[q] * det J  (axis 0)
  float DW0[3][3];
  float VpW0[3][2];
  float Jinv[3][3];  // Jinv[a][j] = d xi_a / d x_j (top-left d x d)
};
constexpr int TABLE_FLOATS = sizeof(Tables) / sizeof(float);
static_assert(TABLE_FLOATS == 81, "Tables layout");

struct Physics {
  float nu, gamma, alpha0;
};

template <int D, int MODE>
struct Shape {
  static constexpr int NNV = (D == 2) ? 9 : 27;   // Q2 velocity nodes
  static constexpr int NNP = (D == 2) ? 4 : 8;    // Q1 pressure nodes
  static constexpr int NQ = NNV;                  // 3-point Gauss
  static constexpr int RS = D * NNV + NNP;        // mixed state rows
  static constexpr int PENC = NNV / 3;            // pencils of a pass
  static constexpr int THREADS = PENC * BE;
  static constexpr bool TAN = MODE == TANGENT;
  // ring inputs: ue, due, vpe, fq
  static constexpr int R_UE = RS, R_DUE = TAN ? RS : 0,
                       R_VPE = TAN ? 0 : D * NNV, R_FQ = TAN ? 0 : D * NQ;
  static constexpr int O_UE = 0, O_DUE = O_UE + pad32(R_UE * BE),
                       O_VPE = O_DUE + pad32(R_DUE * BE),
                       O_FQ = O_VPE + pad32(R_VPE * BE),
                       STAGE = O_FQ + pad32(R_FQ * BE);
  static constexpr int STAGE_BYTES = 4 * BE * (R_UE + R_DUE + R_VPE + R_FQ);
  // scratch rows per element.  2D: S0 holds both groups' first pass
  // (velocity components of group g at rows g*36 + c*18, the pressure at
  // 72), S1 the first transposed pass (42 rows).  3D: S0 holds a group's
  // first pass (component c at c*54, pressure at 162) and later the
  // axis-2 transposed pass (c*81, pressure 243); S1 the second pass (c*81,
  // pressure 243) and later the axis-1 transposed pass (c*54, 162).
  static constexpr int S0 = (D == 2) ? 78 : 261;
  static constexpr int S1 = (D == 2) ? 42 : 261;
  static constexpr int SMEM_FLOATS = tiles::STAGES * STAGE + (S0 + S1) * BE;
};

// ------------------------------------------------------------ physics --
// One quadrature point: u's value and reference gradients (component i,
// axis a), the second group's (due's value and reference gradients in the
// tangent; u_prev's value in the primal), the pressure (p or dp) and f.
template <int D>
struct PointIn {
  float vel[D], gr[D][D];
  float x[D], xgr[D][D];
  float pr;
  float f[D];
};

// The coefficients at one point: a_v against phi, the reference-frame
// gradient coefficients b[i][a] = sum_j J^-1[a][j] a_g[i][j] against
// d phi / d xi_a, and a_p against psi.
template <int D, int MODE>
__device__ __forceinline__ void physics(const Tables& T, const Physics& ph,
                                        const PointIn<D>& in, float (&a_v)[D],
                                        float (&b)[D][D], float& a_p) {
  float g[D][D];     // physical gradients of u: g[i][j] = d u_i / d x_j
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < D; ++a) s += in.gr[i][a] * T.Jinv[a][j];
      g[i][j] = s;
    }
  float a_g[D][D];
  if constexpr (MODE == PRIMAL) {
    float div = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) div += g[i][i];
    const float gd_p = ph.gamma * div - in.pr;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float conv = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) conv += g[i][j] * in.vel[j];
      a_v[i] = ph.alpha0 * in.vel[i] + in.x[i] + conv - in.f[i];
#pragma unroll
      for (int j = 0; j < D; ++j)
        a_g[i][j] = ph.nu * g[i][j] + (i == j ? gd_p : 0.0f);
    }
    a_p = div;
  } else {
    float dg[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int a = 0; a < D; ++a) s += in.xgr[i][a] * T.Jinv[a][j];
        dg[i][j] = s;
      }
    float ddiv = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) ddiv += dg[i][i];
    const float gd_p = ph.gamma * ddiv - in.pr;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float dconv = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j)
        dconv += dg[i][j] * in.vel[j] + g[i][j] * in.x[j];
      a_v[i] = ph.alpha0 * in.x[i] + dconv;
#pragma unroll
      for (int j = 0; j < D; ++j)
        a_g[i][j] = ph.nu * dg[i][j] + (i == j ? gd_p : 0.0f);
    }
    a_p = ddiv;
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int a = 0; a < D; ++a) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) s += T.Jinv[a][j] * a_g[i][j];
      b[i][a] = s;
    }
}

// y[o] = sum_k M[o][k] x[k] over 3 (or 2) terms, o = 0..2
template <int K>
__device__ __forceinline__ float dot1(const float (&M)[3][K], int o,
                                      const float (&x)[K]) {
  float s = M[o][0] * x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) s += M[o][k] * x[k];
  return s;
}

// transposed: y[n] = sum_q M[q][n] x[q], q = 0..2
template <int K>
__device__ __forceinline__ float tdot1(const float (&M)[3][K], int n,
                                       const float (&x)[3]) {
  return M[0][n] * x[0] + M[1][n] * x[1] + M[2][n] * x[2];
}

// ------------------------------------------------------------- STAGED --
// Every shared-memory array below is [rows][BE] with the element fastest;
// `at(base, row)` is element el's entry.
struct Rows {
  float* base;
  int el;
  __device__ __forceinline__ float& operator[](int row) const {
    return base[row * BE + el];
  }
};
struct CRows {
  const float* base;
  int el;
  __device__ __forceinline__ float operator[](int row) const {
    return base[row * BE + el];
  }
};

// Pass over axis 0, pencil pc (the other axes' node indices, 3^(d-1) of
// them): from u's nodes n0 + 3 pc of each velocity component (rows c*NNV)
// to A[q0 + 3 pc] = sum V[q0][n0] u (field 0) and, with GRAD, B = sum
// D[q0][n0] u (field 1, NNV rows on), component c at c*(2 or 1)*NNV of
// `s`; with PRES and pc < NNP/2, the pressure (rows D*NNV + m0 + 2 pc) to
// P0[q0 + 3 pc] of `sp`.
template <int D, bool GRAD, bool PRES>
__device__ __forceinline__ void pass0(const Tables& T, CRows u, Rows s,
                                      Rows sp, int pc) {
  constexpr int NNV = D == 2 ? 9 : 27, NNP = D == 2 ? 4 : 8;
  constexpr int CS = GRAD ? 2 * NNV : NNV;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float x[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) x[k] = u[c * NNV + 3 * pc + k];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      s[c * CS + 3 * pc + q] = dot1(T.V, q, x);
      if constexpr (GRAD) s[c * CS + NNV + 3 * pc + q] = dot1(T.D, q, x);
    }
  }
  if constexpr (PRES) {
    if (pc < NNP / 2) {
      float y[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) y[m] = u[D * NNV + 2 * pc + m];
#pragma unroll
      for (int q = 0; q < 3; ++q) sp[3 * pc + q] = dot1(T.Vp, q, y);
    }
  }
}

// 3D pass over axis 1, pencil pc = (q0, n2): from A, B [q0 + 3 n1 + 9 n2]
// (component stride 54, or 27 without GRAD) to AA = V.A (field 0), AD =
// D.A (field 1), BA = V.B (field 2) at [q0 + 3 q1 + 9 n2] (component
// stride 81, or 27); the pressure, pc = (q0, m2) < 6, from
// P0[q0 + 3 m1 + 6 m2] to P1[q0 + 3 q1 + 9 m2].
template <bool GRAD, bool PRES>
__device__ __forceinline__ void pass1(const Tables& T, CRows s, CRows sp,
                                      Rows o, Rows op, int pc) {
  constexpr int CI = GRAD ? 54 : 27, CO = GRAD ? 81 : 27;
  const int q0 = pc % 3, hi = pc / 3;
  const int ib = q0 + 9 * hi;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j] = s[c * CI + ib + 3 * j];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      o[c * CO + ib + 3 * q] = dot1(T.V, q, a);
      if constexpr (GRAD) o[c * CO + 27 + ib + 3 * q] = dot1(T.D, q, a);
    }
    if constexpr (GRAD) {
      float bb[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) bb[j] = s[c * CI + 27 + ib + 3 * j];
#pragma unroll
      for (int q = 0; q < 3; ++q) o[c * CO + 54 + ib + 3 * q] = dot1(T.V, q, bb);
    }
  }
  if constexpr (PRES) {
    if (pc < 6) {
      float y[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) y[j] = sp[q0 + 3 * j + 6 * hi];
#pragma unroll
      for (int q = 0; q < 3; ++q) op[q0 + 3 * q + 9 * hi] = dot1(T.Vp, q, y);
    }
  }
}

// The last pass (axis d-1), pencil pc = the other axes' point indices:
// the 3 points pc + LS*t (LS = 3 in 2D, 9 in 3D) into registers.  Inputs
// per component (stride D*NNV with GRAD, else NNV): field 0 carries V on
// every earlier axis, field f >= 1 D on axis d-1-f.  G selects the
// group: 1 fills u's value and reference gradients, 2 the second group's
// (x, and xgr with GRAD); PRES fills the pressure from sp.
template <int D, int G, bool GRAD, bool PRES>
__device__ __forceinline__ void last_pass(const Tables& T, CRows s, CRows sp,
                                          int pc, PointIn<D> (&pt)[3]) {
  constexpr int NNV = D == 2 ? 9 : 27, LS = D == 2 ? 3 : 9;
  constexpr int NF = GRAD ? D : 1, CS = NF * NNV;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float r[NF][3];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int k = 0; k < 3; ++k) r[f][k] = s[c * CS + f * NNV + pc + LS * k];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float g[D];
      const float val = dot1(T.V, t, r[0]);
      if constexpr (GRAD) {
        g[D - 1] = dot1(T.D, t, r[0]);
#pragma unroll
        for (int f = 1; f < NF; ++f) g[D - 1 - f] = dot1(T.V, t, r[f]);
      }
      if constexpr (G == 1) {
        pt[t].vel[c] = val;
#pragma unroll
        for (int a = 0; a < D; ++a) pt[t].gr[c][a] = g[a];
      } else {
        pt[t].x[c] = val;
        if constexpr (GRAD) {
#pragma unroll
          for (int a = 0; a < D; ++a) pt[t].xgr[c][a] = g[a];
        }
      }
    }
  }
  if constexpr (PRES) {
    float y[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) y[j] = sp[pc + LS * j];
#pragma unroll
    for (int t = 0; t < 3; ++t) pt[t].pr = dot1(T.Vp, t, y);
  }
}

struct Params {
  tiles::Inputs in;
  float* out;
  int64_t E;
  Physics ph;
  int path;
  Tables tab;
};

template <int D, int MODE>
__global__ void __launch_bounds__(Shape<D, MODE>::THREADS)
    gd_lattice_kernel(const __grid_constant__ Params p) {
  using S = Shape<D, MODE>;
  constexpr int NNV = S::NNV, NNP = S::NNP, NQ = S::NQ;
  constexpr int LS = D == 2 ? 3 : 9;
  constexpr bool TAN = S::TAN;
  const Tables& T = p.tab;

  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t bars[tiles::STAGES];
  float* stages = smem;
  float* s0 = stages + tiles::STAGES * S::STAGE;
  float* s1 = s0 + S::S0 * BE;
  const tiles::Ring<BE, S::THREADS, 4> ring{stages, S::STAGE, bars, p.path};
  constexpr int off[4] = {S::O_UE, S::O_DUE, S::O_VPE, S::O_FQ};
  constexpr int esz[4] = {4, 4, 4, 4};           // f32 rows only

  const int tid = threadIdx.x;
  const int el = tid % BE;
  const int pc = tid / BE;                  // the pencil: warp-uniform
  const int64_t E = p.E;
  const int64_t ntiles = (E + BE - 1) / BE;

  ring.init(tid);
  int64_t t = blockIdx.x;
  if (t < ntiles)
    ring.issue(p.in, off, esz, S::STAGE_BYTES, E, t * BE, 0, tid);
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
    const float* st = ring.stage(s);
    const CRows ue{st + S::O_UE * 1, el};
    const CRows xin{st + (TAN ? S::O_DUE : S::O_VPE), el};

    // ---- interpolation: u (group 1), then due or u_prev (group 2) ----
    PointIn<D> pt[3];
    if constexpr (D == 2) {
      // both groups' first pass at once: group g at rows g*36, the
      // pressure (u's in the primal, due's in the tangent) at 72
      pass0<2, true, !TAN>(T, ue, Rows{s0, el}, Rows{s0 + 72 * BE, el}, pc);
      pass0<2, TAN, TAN>(T, xin, Rows{s0 + 36 * BE, el},
                         Rows{s0 + 72 * BE, el}, pc);
      __syncthreads();
      last_pass<2, 1, true, !TAN>(T, CRows{s0, el}, CRows{s0 + 72 * BE, el},
                                  pc, pt);
      last_pass<2, 2, TAN, TAN>(T, CRows{s0 + 36 * BE, el},
                                CRows{s0 + 72 * BE, el}, pc, pt);
    } else {
      pass0<3, true, !TAN>(T, ue, Rows{s0, el}, Rows{s0 + 162 * BE, el}, pc);
      __syncthreads();
      pass1<true, !TAN>(T, CRows{s0, el}, CRows{s0 + 162 * BE, el},
                        Rows{s1, el}, Rows{s1 + 243 * BE, el}, pc);
      __syncthreads();
      last_pass<3, 1, true, !TAN>(T, CRows{s1, el}, CRows{s1 + 243 * BE, el},
                                  pc, pt);
      pass0<3, TAN, TAN>(T, xin, Rows{s0, el}, Rows{s0 + 162 * BE, el}, pc);
      __syncthreads();
      pass1<TAN, TAN>(T, CRows{s0, el}, CRows{s0 + 162 * BE, el},
                      Rows{s1, el}, Rows{s1 + 243 * BE, el}, pc);
      __syncthreads();
      last_pass<3, 2, TAN, TAN>(T, CRows{s1, el}, CRows{s1 + 243 * BE, el},
                                pc, pt);
    }
    if constexpr (!TAN) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < D; ++i)
          pt[q].f[i] = st[S::O_FQ + (i * NQ + pc + LS * q) * BE + el];
    }

    // ---- physics and the transposed pass over axis d-1, in registers ----
    // acc[c][0][n] = sum_t VW[t][n] a_v + DW[t][n] b[c][d-1]; acc[c][f][n]
    // = sum_t VW[t][n] b[c][d-1-f]; accp[m] = sum_t VpW[t][m] a_p
    float acc[D][D][3], accp[2] = {0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < D; ++c)
#pragma unroll
      for (int f = 0; f < D; ++f)
#pragma unroll
        for (int n = 0; n < 3; ++n) acc[c][f][n] = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float a_v[D], b[D][D], a_p;
      physics<D, MODE>(T, p.ph, pt[q], a_v, b, a_p);
#pragma unroll
      for (int c = 0; c < D; ++c)
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          acc[c][0][n] += T.VW[q][n] * a_v[c] + T.DW[q][n] * b[c][D - 1];
#pragma unroll
          for (int f = 1; f < D; ++f) acc[c][f][n] += T.VW[q][n] * b[c][D - 1 - f];
        }
#pragma unroll
      for (int m = 0; m < 2; ++m) accp[m] += T.VpW[q][m] * a_p;
    }
    // stored at [pc + LS*n] per component (stride D*NNV) and field
    // (stride NNV), the pressure at [pc + LS*m] after them: 2D into S1
    // (free since the last tile), 3D into S0 (last read by pass1 above)
    {
      const Rows o{D == 2 ? s1 : s0, el};
#pragma unroll
      for (int c = 0; c < D; ++c)
#pragma unroll
        for (int f = 0; f < D; ++f)
#pragma unroll
          for (int n = 0; n < 3; ++n)
            o[c * D * NNV + f * NNV + pc + LS * n] = acc[c][f][n];
#pragma unroll
      for (int m = 0; m < 2; ++m) o[D * D * NNV + pc + LS * m] = accp[m];
    }
    __syncthreads();
    if constexpr (D == 3) {
      // axis 1, pencil (q0, n2): Z = VW.X + DW.Y1 (field 0), W = VW.Y0
      // (field 1) at [q0 + 3 n1 + 9 n2] (component stride 54) into S1;
      // the pressure, pencil (q0, m2) < 6, to [q0 + 3 m1 + 6 m2] at 162
      const CRows x{s0, el};
      const Rows o{s1, el};
      const int q0 = pc % 3, hi = pc / 3, ib = q0 + 9 * hi;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float X[3], Y1[3], Y0[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          X[k] = x[c * 81 + ib + 3 * k];
          Y1[k] = x[c * 81 + 27 + ib + 3 * k];
          Y0[k] = x[c * 81 + 54 + ib + 3 * k];
        }
#pragma unroll
        for (int n = 0; n < 3; ++n) {
          o[c * 54 + ib + 3 * n] = tdot1(T.VW, n, X) + tdot1(T.DW, n, Y1);
          o[c * 54 + 27 + ib + 3 * n] = tdot1(T.VW, n, Y0);
        }
      }
      if (pc < 6) {
        float y[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) y[k] = x[243 + q0 + 3 * k + 9 * hi];
#pragma unroll
        for (int m = 0; m < 2; ++m) o[162 + q0 + 3 * m + 6 * hi] = tdot1(T.VpW, m, y);
      }
      __syncthreads();
    }

    // ---- axis 0, pencil pc: the nodes n0 + 3 pc (m0 + 2 pc) -----------
    const int64_t e = t * BE + el;
    if (e < E) {
      const CRows x{s1, el};
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float z[3], w[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          z[q] = x[c * 2 * NNV + 3 * pc + q];
          w[q] = x[c * 2 * NNV + NNV + 3 * pc + q];
        }
#pragma unroll
        for (int n = 0; n < 3; ++n)
          p.out[(int64_t)(c * NNV + 3 * pc + n) * E + e] =
              tdot1(T.VW0, n, z) + tdot1(T.DW0, n, w);
      }
      if (pc < NNP / 2) {
        float y[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) y[q] = x[2 * D * NNV + 3 * pc + q];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          p.out[(int64_t)(D * NNV + 2 * pc + m) * E + e] = tdot1(T.VpW0, m, y);
      }
    }
  }
}

// ---------------------------------------------------------- REGISTERS --
// 2D: one thread per element.  Its 22 rows of u (and 22 of due, or 18 of
// u_prev) stay in registers; per q0 the axis-0 pass of every component,
// then per q1 the axis-1 pass, the physics and the transposed axis-1
// pass, then the transposed axis-0 pass into the 22 output accumulators.
struct RegParams {
  const float* ue;
  const float* due;
  const float* vpe;
  const float* fq;
  float* out;
  int64_t E;
  Physics ph;
  Tables tab;
};

template <int MODE>
__global__ void __launch_bounds__(REG_THREADS)
    gd_lattice_reg_kernel(const __grid_constant__ RegParams p) {
  constexpr int D = 2, NNV = 9, RS = 22;
  constexpr bool TAN = MODE == TANGENT;
  constexpr int RX = TAN ? RS : D * NNV;
  const Tables& T = p.tab;
  const int64_t E = p.E;
  for (int64_t e = (int64_t)blockIdx.x * REG_THREADS + threadIdx.x; e < E;
       e += (int64_t)gridDim.x * REG_THREADS) {
    float u[RS], x[RX], out[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) {
      u[r] = __ldg(p.ue + r * E + e);
      out[r] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < RX; ++r) x[r] = __ldg((TAN ? p.due : p.vpe) + r * E + e);
#pragma unroll
    for (int q0 = 0; q0 < 3; ++q0) {
      // axis 0 at q0: A = V.u, B = D.u per component and n1 (x likewise;
      // values only for u_prev); the pressure's (u's or due's) per m1
      float A[D][3], B[D][3], XA[D][3], XB[D][3], P[2];
#pragma unroll
      for (int c = 0; c < D; ++c)
#pragma unroll
        for (int n1 = 0; n1 < 3; ++n1) {
          float a = 0.0f, b = 0.0f, xa = 0.0f, xb = 0.0f;
#pragma unroll
          for (int n0 = 0; n0 < 3; ++n0) {
            const int r = c * NNV + n0 + 3 * n1;
            a += T.V[q0][n0] * u[r];
            b += T.D[q0][n0] * u[r];
            xa += T.V[q0][n0] * x[r];
            if constexpr (TAN) xb += T.D[q0][n0] * x[r];
          }
          A[c][n1] = a;
          B[c][n1] = b;
          XA[c][n1] = xa;
          XB[c][n1] = xb;
        }
#pragma unroll
      for (int m1 = 0; m1 < 2; ++m1) {
        const int r = D * NNV + 2 * m1;
        if constexpr (TAN)
          P[m1] = T.Vp[q0][0] * x[r] + T.Vp[q0][1] * x[r + 1];
        else
          P[m1] = T.Vp[q0][0] * u[r] + T.Vp[q0][1] * u[r + 1];
      }

      float X[D][3], Y[D][3], Pt[2] = {0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < D; ++c)
#pragma unroll
        for (int n = 0; n < 3; ++n) X[c][n] = Y[c][n] = 0.0f;
#pragma unroll
      for (int q1 = 0; q1 < 3; ++q1) {
        PointIn<D> pt;
#pragma unroll
        for (int c = 0; c < D; ++c) {
          pt.vel[c] = dot1(T.V, q1, A[c]);
          pt.gr[c][1] = dot1(T.D, q1, A[c]);
          pt.gr[c][0] = dot1(T.V, q1, B[c]);
          pt.x[c] = dot1(T.V, q1, XA[c]);
          if constexpr (TAN) {
            pt.xgr[c][1] = dot1(T.D, q1, XA[c]);
            pt.xgr[c][0] = dot1(T.V, q1, XB[c]);
          } else {
            pt.f[c] = __ldg(p.fq + (c * NNV + q0 + 3 * q1) * E + e);
          }
        }
        pt.pr = dot1(T.Vp, q1, P);
        float a_v[D], b[D][D], a_p;
        physics<D, MODE>(T, p.ph, pt, a_v, b, a_p);
#pragma unroll
        for (int c = 0; c < D; ++c)
#pragma unroll
          for (int n = 0; n < 3; ++n) {
            X[c][n] += T.VW[q1][n] * a_v[c] + T.DW[q1][n] * b[c][1];
            Y[c][n] += T.VW[q1][n] * b[c][0];
          }
#pragma unroll
        for (int m = 0; m < 2; ++m) Pt[m] += T.VpW[q1][m] * a_p;
      }
      // transposed axis 0 at q0
#pragma unroll
      for (int c = 0; c < D; ++c)
#pragma unroll
        for (int n1 = 0; n1 < 3; ++n1)
#pragma unroll
          for (int n0 = 0; n0 < 3; ++n0)
            out[c * NNV + n0 + 3 * n1] +=
                T.VW0[q0][n0] * X[c][n1] + T.DW0[q0][n0] * Y[c][n1];
#pragma unroll
      for (int m1 = 0; m1 < 2; ++m1)
#pragma unroll
        for (int m0 = 0; m0 < 2; ++m0)
          out[D * NNV + m0 + 2 * m1] += T.VpW0[q0][m0] * Pt[m1];
    }
#pragma unroll
    for (int r = 0; r < RS; ++r) p.out[r * E + e] = out[r];
  }
}

// ----------------------------------------------------------- dispatch --
struct Launch {
  const float* ue;
  const float* due;
  const float* vpe;
  const float* fq;
  const float* host_tables;
  float* out;
  int64_t E;
  Physics ph;
  int grid, path;
  cudaStream_t stream;
};

template <int D, int MODE>
cudaError_t staged_config(int* blocks, int* smem_bytes, int* threads) {
  using S = Shape<D, MODE>;
  constexpr size_t smem = sizeof(float) * S::SMEM_FLOATS;
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = tiles::occupancy(gd_lattice_kernel<D, MODE>,
                                             S::THREADS, smem, &cached);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = (int)smem;
  *threads = S::THREADS;
  return cudaSuccess;
}

template <int D, int MODE>
cudaError_t staged_launch(const Launch& a) {
  using S = Shape<D, MODE>;
  int blocks, smem, threads;
  cudaError_t err = staged_config<D, MODE>(&blocks, &smem, &threads);
  if (err != cudaSuccess) return err;
  if (a.E == 0 || a.grid <= 0) return cudaSuccess;
  Params p{};
  p.in.ptr[0] = a.ue;
  p.in.ptr[1] = a.due;
  p.in.ptr[2] = a.vpe;
  p.in.ptr[3] = a.fq;
  p.in.rows[0] = S::R_UE;
  p.in.rows[1] = S::R_DUE;
  p.in.rows[2] = S::R_VPE;
  p.in.rows[3] = S::R_FQ;
  p.out = a.out;
  p.E = a.E;
  p.ph = a.ph;
  p.path = a.path;
  memcpy(&p.tab, a.host_tables, sizeof(Tables));
  if (p.path == tiles::LOAD_TMA) {
    const int esz[4] = {4, 4, 4, 4};
    err = tiles::encode_inputs(p.in, 4, a.E, BE, esz);
    if (err != cudaSuccess) return err;
  }
  gd_lattice_kernel<D, MODE><<<a.grid, S::THREADS, smem, a.stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t reg_config(int* blocks, int* smem_bytes, int* threads) {
  static int cached = 0;
  if (!cached) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, gd_lattice_reg_kernel<MODE>, REG_THREADS, 0);
    if (err != cudaSuccess) return err;
  }
  *blocks = cached;
  *smem_bytes = 0;
  *threads = REG_THREADS;
  return cudaSuccess;
}

template <int MODE>
cudaError_t reg_launch(const Launch& a) {
  int blocks, smem, threads;
  cudaError_t err = reg_config<MODE>(&blocks, &smem, &threads);
  if (err != cudaSuccess) return err;
  if (a.E == 0 || a.grid <= 0) return cudaSuccess;
  RegParams p{};
  p.ue = a.ue;
  p.due = a.due;
  p.vpe = a.vpe;
  p.fq = a.fq;
  p.out = a.out;
  p.E = a.E;
  p.ph = a.ph;
  memcpy(&p.tab, a.host_tables, sizeof(Tables));
  gd_lattice_reg_kernel<MODE><<<a.grid, REG_THREADS, 0, a.stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int mode, int route, bool query, const Launch& a,
                     int* blocks, int* smem, int* threads) {
  if (route == REGISTERS) {
    if constexpr (D == 2) {
      switch (mode) {
        case PRIMAL: return query ? reg_config<PRIMAL>(blocks, smem, threads) : reg_launch<PRIMAL>(a);
        case TANGENT: return query ? reg_config<TANGENT>(blocks, smem, threads) : reg_launch<TANGENT>(a);
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaErrorInvalidValue;
  }
  if (route != STAGED) return cudaErrorInvalidValue;
  switch (mode) {
    case PRIMAL: return query ? staged_config<D, PRIMAL>(blocks, smem, threads) : staged_launch<D, PRIMAL>(a);
    case TANGENT: return query ? staged_config<D, TANGENT>(blocks, smem, threads) : staged_launch<D, TANGENT>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_shape(int dim, int degree_pressure, int mode, int route,
                           bool query, const Launch& a, int* blocks,
                           int* smem, int* threads) {
  if (degree_pressure != 1) return cudaErrorInvalidValue;
  switch (dim) {
    case 2: return dispatch<2>(mode, route, query, a, blocks, smem, threads);
    case 3: return dispatch<3>(mode, route, query, a, blocks, smem, threads);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The variant's blocks per SM (after opting it in to its dynamic shared
// memory), shared-memory bytes and threads per block; the caller sizes
// the persistent grid from them.  Returns a CUDA error code.
extern "C" int gd_lattice_config(int dim, int degree_pressure, int mode,
                                 int route, int* blocks_per_sm,
                                 int* smem_bytes, int* threads) {
  Launch a{};
  return static_cast<int>(dispatch_shape(dim, degree_pressure, mode, route,
                                         true, a, blocks_per_sm, smem_bytes,
                                         threads));
}

// Launches one variant on `stream` with `grid` blocks: route STAGED (0)
// with load path `path` (tiles::LOAD_*; TMA needs E % 4 == 0 and 16-byte
// aligned inputs), or REGISTERS (1, 2D only).  `host_tables` are the 81
// floats of the 1D tables and J^-1 in host memory (Tables' order), copied
// into the kernel's parameters.  Returns cudaGetLastError() after the
// launch (0 on success); cudaErrorInvalidValue for a (dim, pressure
// degree, mode, route) that is not compiled, an unknown load path or no
// tables.  Does not synchronise and allocates nothing.
extern "C" int gd_lattice_launch(
    int dim, int degree_pressure, int mode,
    const void* ue, const void* due, const void* vpe, const void* fq,
    const void* host_tables, void* out, int64_t n_elements,
    float nu, float gamma, float alpha0, int route, int grid, int path,
    void* stream) {
  if ((path != tiles::LOAD_CP_ASYNC_4 && path != tiles::LOAD_TMA) ||
      !host_tables)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{};
  a.ue = static_cast<const float*>(ue);
  a.due = static_cast<const float*>(due);
  a.vpe = static_cast<const float*>(vpe);
  a.fq = static_cast<const float*>(fq);
  a.host_tables = static_cast<const float*>(host_tables);
  a.out = static_cast<float*>(out);
  a.E = n_elements;
  a.ph = Physics{nu, gamma, alpha0};
  a.grid = grid;
  a.path = path;
  a.stream = static_cast<cudaStream_t>(stream);
  int blocks, smem, threads;
  return static_cast<int>(dispatch_shape(dim, degree_pressure, mode, route,
                                         false, a, &blocks, &smem, &threads));
}
