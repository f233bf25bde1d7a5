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
          "fem/basis.py", "fem/mesh.py", "fem/dof.py", "utils/tables.py",
          "utils/vtu.py", "native.py"]

# what a copy may leave out of its original: code that needs jax
DROPPED = {"core/timer.py": {"jax_trace"}}


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


def test_apps_never_import_jax(tmp_path):
    """Importing the port's apps and running a tiny deck on the CPU
    leaves jax out of sys.modules."""
    deck = tmp_path / "tiny.prm"
    deck.write_text(open(os.path.join(ROOT, "tests", "golden",
                                      "couette_gls.prm")).read()
                    .replace("initial refinement = 3",
                             "initial refinement = 1"))
    code = (
        "import sys\n"
        "pre = {m for m in sys.modules if m.split('.')[0] == 'jax'}\n"
        "from softx_2020_200_tpu_torch.apps import gls_navier_stokes_2d\n"
        "from softx_2020_200_tpu_torch.apps import gls_navier_stokes_3d\n"
        f"rc = gls_navier_stokes_2d.main([{str(deck)!r}, '--device', "
        "'cpu', '--dtype', 'float64'])\n"
        "assert rc == 0\n"
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
    assert "L2 error velocity" in out.stdout
