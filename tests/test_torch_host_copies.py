"""The PyTorch package's host layer against the JAX package.

The NumPy-only host modules are copies (their imports may differ); decks
parse to equal parameters in both packages; meshes and DoF numbering are
identical, which is what lets a JAX state move across unchanged
(``interop.state_from_numpy``); and the port's apps never import jax.
"""

import ast
import dataclasses
import enum
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softx_2020_200_tpu.core.parameters import \
    SimulationParameters as JaxParameters
from softx_2020_200_tpu.fem import mesh as jax_mesh
from softx_2020_200_tpu.fem.dof import FESpace as JaxFESpace
from softx_2020_200_tpu_torch.core.parameters import SimulationParameters
from softx_2020_200_tpu_torch.fem import mesh as port_mesh
from softx_2020_200_tpu_torch.fem.dof import FESpace
from softx_2020_200_tpu_torch.interop import state_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "softx_2020_200_tpu")
PORT_PKG = os.path.join(ROOT, "softx_2020_200_tpu_torch")

COPIES = ["core/prm.py", "core/parameters.py", "core/bdf.py",
          "core/sdirk.py", "core/simulation_control.py",
          "core/pvd_handler.py", "core/timer.py", "fem/quadrature.py",
          "fem/basis.py", "fem/mesh.py", "fem/dof.py", "fem/forest.py",
          "fem/gmsh_io.py", "solvers/kelly.py", "utils/tables.py",
          "utils/vtu.py", "native.py", "parallel/partition.py",
          "apps/navier_stokes_parameter_template.py"]

# what a copy may leave out of its original: code that needs jax
DROPPED = {"core/timer.py": {"jax_trace"}}


# functions of JAX modules that the port copies on their own (their
# modules import jax): (JAX module, JAX name, port module, port name)
FUNCTION_COPIES = [
    ("ops/pallas_lattice.py", "_affine_tables", "ops/lattice_kernel.py",
     "affine_tables"),
    ("ops/multigrid.py", "_transfer_maps", "ops/multigrid.py",
     "_transfer_maps"),
    ("ops/pallas_lattice_gd.py", "_gd_affine_tables",
     "ops/lattice_gd_kernel.py", "gd_affine_tables"),
    ("ops/multigrid.py", "_coarsen_forest", "ops/multigrid.py",
     "_coarsen_forest"),
    ("fem/geometry.py", "det_and_inv", "fem/host_geometry.py",
     "det_and_inv"),
    ("fem/geometry.py", "face_measure_and_normal", "fem/host_geometry.py",
     "face_measure_and_normal"),
] + [("fem/transfer.py", name, "fem/transfer.py", name)
     for name in ("_new_node_base_positions", "_locate_in_forest_loop",
                  "_encode", "locate_in_forest")]


class _StripImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    visit_ImportFrom = visit_Import


def _code(path, dropped=frozenset()):
    """The module's code without its docstring, its imports and the
    top-level functions named in ``dropped``."""
    tree = _StripImports().visit(ast.parse(open(path).read()))
    body = [n for n in tree.body
            if not (isinstance(n, ast.Expr)
                    and isinstance(n.value, ast.Constant))
            and getattr(n, "name", None) not in dropped]
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("rel", COPIES)
def test_host_module_is_a_copy(rel):
    original = _code(os.path.join(JAX_PKG, rel), DROPPED.get(rel, set()))
    copy = _code(os.path.join(PORT_PKG, rel))
    assert copy == original


def _function_body(path, name):
    """The body of top-level function ``name`` without its docstring."""
    fn = next(n for n in ast.parse(open(path).read()).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    return [ast.dump(n) for n in fn.body
            if not (isinstance(n, ast.Expr)
                    and isinstance(n.value, ast.Constant))]


@pytest.mark.parametrize("jax_rel,jax_name,port_rel,port_name",
                         FUNCTION_COPIES, ids=[f[1] for f in FUNCTION_COPIES])
def test_host_function_is_a_copy(jax_rel, jax_name, port_rel, port_name):
    assert (_function_body(os.path.join(PORT_PKG, port_rel), port_name)
            == _function_body(os.path.join(JAX_PKG, jax_rel), jax_name))


def _plain(obj):
    """Dataclasses/enums -> plain dicts/values (the two packages' classes
    differ, their contents must not)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    return obj


DECKS = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.prm"))
               + glob.glob(os.path.join(ROOT, "examples", "*.prm")))


@pytest.mark.parametrize("deck", DECKS, ids=os.path.basename)
def test_decks_parse_equal(deck):
    dim = 3 if any(k in deck for k in ("3d", "sphere")) else 2
    a = JaxParameters.from_file(deck, dim=dim)
    b = SimulationParameters.from_file(deck, dim=dim)
    assert _plain(b) == _plain(a)


MESHES = {
    "hyper_cube": lambda m: m.hyper_cube(0.0, 1.0, colorize=True, dim=2)
    .refine_uniform(2),
    "hyper_shell": lambda m: m.hyper_shell([0.0, 0.0], 0.25, 1.0, 8)
    .refine_uniform(1),
    "channel_with_cylinder": lambda m: m.channel_with_cylinder(),
    "periodic_box": lambda m: m.subdivided_hyper_rectangle(
        [0.0] * 3, [1.0] * 3, [3, 2, 2], colorize=True, dim=3),
}


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("degree", [1, 2])
def test_mesh_and_numbering_identical(name, degree):
    ma = MESHES[name](jax_mesh)
    mb = MESHES[name](port_mesh)
    if name == "periodic_box":
        for m in (ma, mb):
            m.periodic += [(0, 1, 0), (2, 3, 1)]
    sa, sb = JaxFESpace(ma, degree), FESpace(mb, degree)
    np.testing.assert_array_equal(sb.nodes, sa.nodes)
    np.testing.assert_array_equal(sb.elem_nodes, sa.elem_nodes)
    np.testing.assert_array_equal(sb.element_coords(), sa.element_coords())
    assert sorted(sb.boundary_nodes) == sorted(sa.boundary_nodes)
    for bid in sa.boundary_nodes:
        np.testing.assert_array_equal(sb.boundary_nodes[bid],
                                      sa.boundary_nodes[bid])

    # a JAX state carried across keeps its values node by node
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal((sa.n_nodes, sa.dim + 1)))
    prev = [jnp.asarray(rng.standard_normal((sa.n_nodes, sa.dim + 1)))]
    ut, pt = state_from_numpy(np.asarray(u), [np.asarray(p) for p in prev],
                              device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(ut.numpy()[sb.elem_nodes],
                                  np.asarray(u)[sa.elem_nodes])
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(prev[0]))


def test_parameter_template_roundtrips(capsys):
    """The template app prints the JAX package's default deck, and the
    deck parses back, to the JAX package's parameters
    (``tests/test_postprocessing.py::test_parameter_template_roundtrips``)."""
    from softx_2020_200_tpu.apps import \
        navier_stokes_parameter_template as jax_template
    from softx_2020_200_tpu.core.prm import parse_prm as jax_parse_prm
    from softx_2020_200_tpu_torch.apps import \
        navier_stokes_parameter_template as template
    from softx_2020_200_tpu_torch.core.prm import parse_prm
    for dim in (2, 3):
        assert template.main([str(dim)]) == 0
        text = capsys.readouterr().out
        assert jax_template.main([str(dim)]) == 0
        assert capsys.readouterr().out == text
        prm = SimulationParameters(dim=dim).parse(parse_prm(text))
        assert prm.fem.velocity_order == 1
        assert _plain(prm) == _plain(
            JaxParameters(dim=dim).parse(jax_parse_prm(text)))


def test_apps_never_import_jax(tmp_path):
    """Importing the port's apps and kernel, lattice, multigrid and
    sharded modules, and running tiny GLS and GD decks on the CPU
    (lattices: the strided layout and the lattice kernels' plain
    versions; SDIRK2 with additive Schwarz and a checkpoint, a restart of
    it, pseudo-transient continuation; Kelly cycles on a forest with
    forest multigrid; the Couette and GD decks over 2 shards) leaves jax
    out of sys.modules."""
    decks = {}
    sdirk = [("time end      = 0.2", "time end      = {end}"),
             ("subsection linear solver\n", "subsection linear solver\n"
              "  set preconditioner = additive_schwarz\n"),
             ("subsection test\n", "subsection restart\n  set checkpoint "
              "= true\n  set restart = {restart}\nend\nsubsection test\n")]
    for name, src, edits in (
            ("couette_gls", "couette_gls",
             [("initial refinement = 3", "initial refinement = 1")]),
            ("gd_mms_bdf2", "gd_mms_bdf2",
             [("initial refinement = 2", "initial refinement = 1")]),
            ("couette_ptc", "couette_gls",
             [("initial refinement = 3", "initial refinement = 1"),
              ("subsection non-linear solver\n",
               "subsection non-linear solver\n"
               "  set solver = pseudo_transient\n")]),
            ("sdirk_a", "sdirk_np8", sdirk),
            ("sdirk_b", "sdirk_np8", sdirk),
            ("kelly_steady", "kelly_steady", [])):
        decks[name] = tmp_path / f"{name}.prm"
        text = open(os.path.join(ROOT, "tests", "golden",
                                 f"{src}.prm")).read()
        for old, new in edits:
            new = new.format(restart=str(name == "sdirk_b").lower(),
                             end=0.15 if name == "sdirk_b" else 0.1)
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        decks[name].write_text(text)
    runs = "".join(
        f"rc = {app}.main([{str(decks[name])!r}] + {shards} + args)\n"
        "assert rc == 0\n"
        for app, name, shards in (
            ("gls_navier_stokes_2d", "couette_gls", []),
            ("gd_navier_stokes_2d", "gd_mms_bdf2", []),
            ("gls_navier_stokes_2d", "couette_ptc", []),
            ("gls_navier_stokes_2d", "sdirk_a", []),
            ("gls_navier_stokes_2d", "sdirk_b", []),
            ("gls_navier_stokes_2d", "kelly_steady", []),
            ("gls_navier_stokes_2d", "couette_gls", ["2"]),
            ("gd_navier_stokes_2d", "gd_mms_bdf2", ["2"])))
    code = (
        "import sys\n"
        "pre = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "from softx_2020_200_tpu_torch.apps import gls_navier_stokes_2d\n"
        "from softx_2020_200_tpu_torch.apps import gls_navier_stokes_3d\n"
        "from softx_2020_200_tpu_torch.apps import gd_navier_stokes_2d\n"
        "from softx_2020_200_tpu_torch.apps import gd_navier_stokes_3d\n"
        "from softx_2020_200_tpu_torch.apps import "
        "navier_stokes_parameter_template\n"
        "from softx_2020_200_tpu_torch.ops import (cuda_build, "
        "gd_multigrid, lattice_gd_kernel, lattice_kernel, multigrid, "
        "structured)\n"
        "from softx_2020_200_tpu_torch.parallel import (partition, "
        "sharded, sharded_gd)\n"
        "args = ['--device', 'cpu', '--dtype', 'float64']\n"
        + runs +
        "new = {m for m in sys.modules if m.split('.')[0] == 'jax'} - pre\n"
        "assert not new, sorted(new)\n"
        "assert 'softx_2020_200_tpu' not in sys.modules\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout
    # the Couette decks print one L2 line each, the GD deck one per step
    # (three), the SDIRK legs one per step (two, then one after the
    # restart); the Couette and GD decks again over 2 shards
    assert out.stdout.count("L2 error velocity") == 12
