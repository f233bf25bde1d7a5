#!/usr/bin/env python3
"""Smoke run of the PyTorch package (``softx_2020_200_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, needs CUDA
    python3 chip_smoke.py --write-decks D  # write the main-path decks

Phases (each prints its own lines; any failed check raises):

1. environment: card name and power limit, torch / CUDA / nvcc / triton
   versions;
2. build: ``nvcc`` compiles the GLS element kernel from
   ``softx_2020_200_tpu_torch/csrc/gls_element.cu``;
3. kernel parity and timing: the CUDA kernel against its plain PyTorch
   version (primal, frozen-tau tangent, node-block probes) for Q1/Q2 in
   2D/3D on non-affine geometry, without and with LSIC; then, at each of
   the main path's shapes, the same comparison and kernel and plain
   times;
4. main path, 2D steady: Taylor-Couette (Q2 on a curved shell) at
   refinements 3 and 5 (12,288 cells) through the
   ``gls_navier_stokes_2d`` app on ``cuda``;
5. main path, 3D transient: the Taylor-Green vortex on a periodic 32^3
   Q1 box, BDF2, 3 steps, through ``gls_navier_stokes_3d``.

Phases 4 and 5 hold their physics numbers against the JAX package run
on the CPU in float64 on the same decks (``JAX_REFERENCE`` below).  The
line before the last lists the kernels with their launch counts in the
main-path runs, errors and times; the last line of standard output is
the JSON contract line ``{"ok": true, "device": {...}}``.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel against its plain version, both float32 on the card: max-abs
# error over the max-abs scale of the plain result, the bar the JAX
# package holds its TPU kernel to (tests/test_pallas_kernel.py)
KERNEL_RTOL = 5e-6

# The main-path decks: the repo's examples, cut to size.
#
# Taylor-Couette runs twice.  At refinement 3 (768 Q2 cells) GMRES(100)
# with block-Jacobi converges the Newton solve, and the L2 errors are held
# against the JAX package.  At refinement 5 (12,288 cells, 149,760 DoF)
# it does not: in the JAX package on the CPU in f64, block-Jacobi stalls
# Newton at residual 4.0e-2 (L2 error 1.05e-1), and its default GMG falls
# back to block-Jacobi on this mesh with the same result, so there is no
# JAX value to hold the card against.  The card runs refinement 5 with
# GMRES(1000) and 4 Newton iterations, and its L2 errors are held to
# the decay the discretisation promises from the refinement-3 reference.
def _tc(refinement: int):
    return [("initial refinement", str(refinement)),
            ("number mesh adapt", "0"),
            ("subsection analytical solution", "set verbosity = verbose"),
            ("subsection simulation control", "set log precision = 8"),
            ("subsection linear solver", "set preconditioner = block_jacobi")]


DECKS = {
    "taylor_couette_r3.prm": ("examples/taylor_couette_mms.prm", _tc(3)),
    "taylor_couette_r5.prm": ("examples/taylor_couette_mms.prm", _tc(5) + [
        ("subsection linear solver", "set max krylov vectors = 1000"),
        ("subsection linear solver", "set max iters = 20000"),
        ("max iterations", "4"),
    ]),
    "tgv32_3steps.prm": ("examples/tgv3d_re1600.prm", [
        ("time end", "0.15"),
        ("subsection linear solver", "set preconditioner = block_jacobi"),
    ]),
}

# The JAX package on the CPU in float64 on taylor_couette_r3.prm and
# tgv32_3steps.prm, written by
#   python3 chip_smoke.py --write-decks DIR && cd DIR &&
#   SOFTX_NO_COMPILE_CACHE=1 JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \
#     PYTHONPATH=<repo> python -m softx_2020_200_tpu.apps.gls_navier_stokes_2d \
#     taylor_couette_r3.prm
#   (and python -m softx_2020_200_tpu.apps.gls_navier_stokes_3d
#   tgv32_3steps.prm)
JAX_REFERENCE = {
    "taylor_couette_r3.prm": {"l2_velocity": 1.16973573e-04,
                              "l2_pressure": 2.28645617e-05},
    "tgv32_3steps.prm": {
        "kinetic_energy": [1.225846e-01, 1.225584e-01, 1.225327e-01],
        "enstrophy": [3.686351e-01, 3.688408e-01, 3.692374e-01]},
}

# Tolerances of the card's float32 runs against the float64 reference.
# L2 errors at refinement 3, relative: float32 runs of this deck came
# within 0.15% of the reference (the port on an H100: 0.036% velocity,
# 0.048% pressure; on the CPU: 0.148% and 0.082%), and the same deck
# with one stabilization term dropped (gls viscous adjoint = false, f64)
# moves them by 17.6% and 1.72%.  0.5% passes the first and fails the
# second.
L2_RTOL = 5e-3
# Refinement 5 against refinement 3 (h / 4): Q2 velocity errors fall as
# h^3 (64x) and pressure as h^2 (16x); the card's run must show at least
# 8x and 4x, which leaves room for the f32 floor and the inexact solves.
L2_DECAY_VELOCITY, L2_DECAY_PRESSURE = 8.0, 4.0
# KE and enstrophy per step: integrals of an O(1) field after Newton to
# 1e-6 in both runs; f32 rounding of the state moves them by about 1e-7
# relative, and the reference prints 7 digits.
ENERGY_RTOL = 1e-5


def deck_text(name: str) -> str:
    """The deck ``name`` of DECKS: its example with the edits applied.
    An edit ``(key, value)`` replaces ``set key = ...``; an edit
    ``("subsection S", line)`` adds ``line`` at the top of subsection S."""
    src, edits = DECKS[name]
    with open(os.path.join(ROOT, src)) as fh:
        text = fh.read()
    for key, value in edits:
        if key.startswith("subsection "):
            pat = re.compile(rf"^([ \t]*){re.escape(key)}[ \t]*$", re.M)
            text, n = pat.subn(lambda m: f"{m.group(0)}\n{m.group(1)}  "
                               f"{value}", text, count=1)
        else:
            pat = re.compile(rf"^([ \t]*set[ \t]+{re.escape(key)}[ \t]*=).*$", re.M)
            text, n = pat.subn(lambda m: f"{m.group(1)} {value}", text,
                               count=1)
        if n != 1:
            raise ValueError(f"{src}: cannot apply edit {key!r}")
    return text


def write_decks(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    for name in DECKS:
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(deck_text(name))


class Failed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise Failed(what)


def run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"
    return (out.stdout or out.stderr).strip()


# ----------------------------------------------------------------------
# phase 1
# ----------------------------------------------------------------------
def phase_environment(torch) -> str:
    print("== phase 1: environment")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    from softx_2020_200_tpu_torch.ops.gls_kernel import find_nvcc
    nvcc = run([find_nvcc(), "--version"]).splitlines()
    print(f"nvcc: {nvcc[-1] if nvcc else 'unavailable'}")
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton: not installed")
    return smi.splitlines()[0] if smi else smi


# ----------------------------------------------------------------------
# phase 2
# ----------------------------------------------------------------------
def phase_build():
    print("== phase 2: build")
    from softx_2020_200_tpu_torch.ops import gls_kernel
    build = gls_kernel.get_build()
    print(f"built {os.path.relpath(build.path, ROOT)} in "
          f"{build.seconds:.2f} s")
    # ptxas reports each template instance <dim, degree, mode> by its
    # mangled name, then its registers and spills
    modes = {"0": "primal", "1": "tangent", "2": "probe"}
    for line in build.log.splitlines():
        inst = re.search(r"gls_element_kernelILi(\d)ELi(\d)ELi(\d)E", line)
        if inst and "Compiling entry" in line:
            d, k, mode = inst.groups()
            print(f"  ptxas d={d} k={k} {modes[mode]}:")
        elif "registers" in line or "spill" in line or "error" in line:
            print(f"    {line.replace('ptxas info    :', '').strip()}")
    return build


# ----------------------------------------------------------------------
# phase 3
# ----------------------------------------------------------------------
def _space(dim: int, degree: int, cells: int, seed: int):
    """A non-affine FE space: a curved shell in 2D, a box with randomly
    moved interior vertices in 3D."""
    import numpy as np
    from softx_2020_200_tpu_torch.fem import mesh as M
    from softx_2020_200_tpu_torch.fem.dof import FESpace
    if dim == 2:
        m = M.generate_mesh("hyper_shell", "0, 0 : 0.25 : 1 : 12 : true",
                            dim=2, initial_refinement=cells)
    else:
        m = M.subdivided_hyper_rectangle([0.0] * 3, [1.0] * 3,
                                         [cells] * 3, True, dim=3)
        v = m.vertices
        inner = np.all((v > 1e-9) & (v < 1 - 1e-9), axis=1)
        rng = np.random.default_rng(seed)
        v[inner] += rng.uniform(-0.2, 0.2, (int(inner.sum()), 3)) / cells
    return FESpace(m, degree)


def _inputs(torch, op, seed: int):
    g = torch.Generator().manual_seed(seed)
    N, c, d = op.n_nodes, op.nc, op.dim
    E = op.space.n_elements

    def rnd(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g, dtype=torch.float64)
                ).to(op.device, op.dtype)

    return dict(u=rnd(N, c, s=0.3), v=rnd(N, c), prev=rnd(N, d, s=0.2),
                fq=rnd(E, op.n_q, d))


def _rel(torch, a, b) -> tuple[float, float]:
    err = float((a - b).abs().max())
    return err, err / float(b.abs().max())


def _median_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events
    around each run, after one warm-up)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _variants(torch, space, device, seed: int, lsic: bool = False):
    """(kernel calls, plain calls) on one space with seeded float32
    inputs: the primal residual, the tangent and the node blocks.  The
    plain tangent and node blocks differentiate with tau (and the LSIC
    coefficient) frozen, as the kernel does."""
    from softx_2020_200_tpu_torch.ops.batched_kernel import (
        node_blocks_batched, tangent_batched)
    from softx_2020_200_tpu_torch.solvers.gls import GLSOperator, StabFlags
    frozen_flags = StabFlags(lsic=lsic, frozen_tau=True)
    op = GLSOperator(space, nu=0.01, stab=frozen_flags, dtype=torch.float32,
                     device=device)
    x = _inputs(torch, op, seed=seed)
    k = op.kernel
    ue, due = op._soa(x["u"]), op._soa(x["v"])
    args = (op.xe_soa, op._soa(x["prev"]), op._fq_soa(x["fq"]), op.h,
            1.5, 20.0)
    full, frozen = k.plain(StabFlags(lsic=lsic)), k.plain(frozen_flags)
    kernel = {"primal": lambda: k.residual(ue, *args),
              "tangent": lambda: k.tangent(ue, due, *args),
              "node blocks": lambda: k.node_blocks(ue, *args)}
    plain = {"primal": lambda: full(ue, *args),
             "tangent": lambda: tangent_batched(frozen, ue, due, *args),
             "node blocks": lambda: node_blocks_batched(frozen, ue, *args)}
    return kernel, plain


def _compare(torch, label: str, E: int, kernel, plain) -> float:
    """Each kernel output against the plain one; the worst max-abs
    error.  Raises if one is off by more than KERNEL_RTOL of scale."""
    worst = 0.0
    for what in kernel:
        got, want = kernel[what](), plain[what]()
        torch.cuda.synchronize()
        err, rel = _rel(torch, got, want)
        worst = max(worst, err)
        print(f"  {label:28s} E={E:7d} {what:11s} max_abs_err {err:.3e}  "
              f"rel {rel:.3e}")
        check(rel < KERNEL_RTOL and bool(torch.isfinite(got).all()),
              f"kernel {what} {label} E={E}: rel error {rel:.3e}")
    return worst


# Parity meshes (dim, degree, refinement or cells per axis): 192, 192,
# 216 and 216 elements, so each launch spans two 128-thread blocks and
# ends in a ragged one.  Each runs without and with LSIC.
PARITY_SHAPES = ((2, 1, 2), (2, 2, 2), (3, 1, 6), (3, 2, 6))


def phase_kernel_parity(torch, device) -> float:
    print("== phase 3: kernel parity (CUDA kernel vs plain PyTorch, "
          f"float32, tolerance {KERNEL_RTOL:g} of the max-abs scale)")
    worst = 0.0
    for dim, degree, cells in PARITY_SHAPES:
        space = _space(dim, degree, cells, seed=dim * 10 + degree)
        for lsic in (False, True):
            kernel, plain = _variants(torch, space, device,
                                      seed=dim * 10 + degree, lsic=lsic)
            label = f"d={dim} k={degree}{' lsic' if lsic else ''}"
            worst = max(worst, _compare(torch, label, space.n_elements,
                                        kernel, plain))
    return worst


# the main path's shapes: (label, dim, degree, refinement or cells/axis)
TIMING_SHAPES = (("2D Q2 Taylor-Couette r3", 2, 2, 3),
                 ("2D Q2 Taylor-Couette r5", 2, 2, 5),
                 ("3D Q1 TGV 32^3", 3, 1, 32),
                 ("3D Q1 box 64^3", 3, 1, 64))


def phase_kernel_times(torch, device) -> tuple[dict, float]:
    """Kernel against plain at the main path's shapes: compared first,
    then timed.  Returns the times and the worst max-abs error."""
    print("== phase 3b: parity and times at the main path's shapes "
          "(median of 20, ms)")
    times, worst = {}, 0.0
    for label, dim, degree, cells in TIMING_SHAPES:
        space = _space(dim, degree, cells, seed=7)
        kernel, plain = _variants(torch, space, device, seed=3)
        worst = max(worst, _compare(torch, label, space.n_elements,
                                    kernel, plain))
        times[label] = row = {}
        for what in kernel:
            row[what] = (_median_ms(torch, kernel[what]),
                         _median_ms(torch, plain[what]))
            print(f"  {label:28s} E={space.n_elements:7d} {what:11s} "
                  f"kernel {row[what][0]:10.4f} ms  plain "
                  f"{row[what][1]:10.4f} ms")
        del kernel, plain
        torch.cuda.empty_cache()
    return times, worst


# ----------------------------------------------------------------------
# phases 4 and 5
# ----------------------------------------------------------------------
_NUM = r"([-+]?\d+\.?\d*(?:[eE][-+]?\d+)?)"


def drive_app(torch, dim: int, deck: str) -> dict:
    """Run the deck through the port's CLI entry point on the card; its
    output is echoed and returned with the launch count and memory."""
    from softx_2020_200_tpu_torch.apps.common import run_app
    from softx_2020_200_tpu_torch.ops.gls_kernel import GLSElementKernel
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, deck)
        with open(path, "w") as fh:
            fh.write(deck_text(deck))
        cwd = os.getcwd()
        os.chdir(tmp)
        buf = io.StringIO()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        GLSElementKernel.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run_app(dim, [path], device="cuda",
                             dtype=torch.float32)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        seconds = time.perf_counter() - t0
        launches = GLSElementKernel.launches
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  | {line}")
    check(rc == 0, f"{deck}: app returned {rc}")
    stats = re.search(
        rf"Newton summary: {_NUM} solves, {_NUM} iterations, {_NUM} "
        rf"linear iterations, {_NUM} s per Newton iteration, {_NUM} host "
        rf"syncs per Newton iteration", out)
    check(stats is not None, f"{deck}: no Newton summary line")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    res = dict(out=out, seconds=seconds, launches=launches, peak_mib=peak,
               newton_iterations=int(stats.group(2)),
               linear_iterations=int(stats.group(3)),
               s_per_newton=float(stats.group(4)),
               syncs_per_newton=float(stats.group(5)))
    print(f"  wall {seconds:.2f} s, Newton iterations "
          f"{res['newton_iterations']}, GMRES iterations "
          f"{res['linear_iterations']}, {res['s_per_newton']:.4f} s per "
          f"Newton iteration, {res['syncs_per_newton']:.1f} host syncs per "
          f"Newton iteration, peak device memory {peak:.1f} MiB, GLS "
          f"kernel launches {launches}")
    check(launches > 0, f"{deck}: the GLS kernel was never launched")
    return res


def _close(got: float, want: float, rtol: float) -> bool:
    return abs(got - want) <= rtol * abs(want)


def _l2_errors(deck: str, out: str) -> tuple[float, float]:
    m = re.findall(rf"L2 error velocity : {_NUM}  L2 error pressure: {_NUM}",
                   out)
    check(len(m) == 1, f"{deck}: expected one L2 line, found {len(m)}")
    return float(m[0][0]), float(m[0][1])


def phase_couette(torch) -> list[dict]:
    print("== phase 4: main path, 2D steady Taylor-Couette (Q2, curved "
          "shell), refinement 3 against JAX, then refinement 5")
    deck = "taylor_couette_r3.prm"
    r3 = drive_app(torch, 2, deck)
    ref = JAX_REFERENCE[deck]
    errors = dict(zip(("velocity", "pressure"), _l2_errors(deck, r3["out"])))
    for what, got in errors.items():
        want = ref[f"l2_{what}"]
        print(f"  L2 error {what}: card f32 {got:.8e}, JAX CPU f64 "
              f"{want:.8e}, rel diff {abs(got - want) / want:.3e} (bound "
              f"{L2_RTOL:g})")
        check(_close(got, want, L2_RTOL),
              f"L2 error {what} {got} vs reference {want}")

    deck = "taylor_couette_r5.prm"
    r5 = drive_app(torch, 2, deck)
    for (what, decay), got in zip(
            (("velocity", L2_DECAY_VELOCITY), ("pressure", L2_DECAY_PRESSURE)),
            _l2_errors(deck, r5["out"])):
        want = ref[f"l2_{what}"]
        print(f"  L2 error {what} at refinement 5: {got:.8e}, "
              f"{want / got:.1f}x below the refinement-3 reference (at "
              f"least {decay:g}x required)")
        check(got * decay <= want, f"refinement 5: L2 error {what} {got}")
    return [r3, r5]


def phase_tgv(torch) -> dict:
    print("== phase 5: main path, 3D transient TGV (Q1, periodic 32^3, "
          "BDF2, 3 steps)")
    deck = "tgv32_3steps.prm"
    res = drive_app(torch, 3, deck)
    m = re.findall(rf"kinetic-energy: {_NUM}  enstrophy: {_NUM}", res["out"])
    ref = JAX_REFERENCE[deck]
    check(len(m) == len(ref["kinetic_energy"]),
          f"{deck}: expected {len(ref['kinetic_energy'])} steps, found "
          f"{len(m)}")
    for step, ((ke, en), ke_ref, en_ref) in enumerate(
            zip(m, ref["kinetic_energy"], ref["enstrophy"]), start=1):
        ke, en = float(ke), float(en)
        print(f"  step {step}: KE {ke:.6e} (JAX {ke_ref:.6e}), enstrophy "
              f"{en:.6e} (JAX {en_ref:.6e})")
        check(_close(ke, ke_ref, ENERGY_RTOL), f"step {step}: KE {ke}")
        check(_close(en, en_ref, ENERGY_RTOL), f"step {step}: enstrophy "
              f"{en}")
    return res


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--write-decks", metavar="DIR",
                        help="write the main-path decks to DIR and stop")
    args = parser.parse_args(argv)
    if args.write_decks:
        write_decks(args.write_decks)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda")

    smi = phase_environment(torch)
    phase_build()
    worst = phase_kernel_parity(torch, device)
    times, worst_at_scale = phase_kernel_times(torch, device)
    worst = max(worst, worst_at_scale)
    runs = phase_couette(torch) + [phase_tgv(torch)]

    from softx_2020_200_tpu_torch.ops.gls_kernel import SOURCE
    t_kernel, t_plain = times["3D Q1 TGV 32^3"]["tangent"]
    entry = {
        "name": "gls_element",
        "route": "cuda",
        "source": os.path.relpath(SOURCE, ROOT),
        "replaces": "softx_2020_200_tpu/ops/pallas_gls.py:218",
        "launches": sum(r["launches"] for r in runs),
        "max_abs_err": worst,
        "ms": t_kernel,
        "plain_ms": t_plain,
    }
    print(smi)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
