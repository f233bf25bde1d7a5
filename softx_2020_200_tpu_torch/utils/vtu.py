"""VTU / PVTU field output (DataOut equivalent — SURVEY.md §2.2
``write_output_results``).

Writes XML UnstructuredGrid ``.vtu`` files with inline base64 binary
arrays.  High-order Qk elements are written as k^dim linear sub-cells
(the reference's ``subdivision`` high-order visualization), so any
ParaView build renders them.  A ``.pvtu`` wrapper supports multi-part
(sharded) output; the time series master is ``PVDHandler``.
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np

VTK_QUAD = 9
VTK_HEXAHEDRON = 12


def _b64(arr: np.ndarray) -> str:
    raw = arr.tobytes()
    header = struct.pack("<I", len(raw))
    return base64.b64encode(header + raw).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_comp: int | None = None) -> str:
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    dtype_name = {np.dtype("float32"): "Float32",
                  np.dtype("int32"): "Int32",
                  np.dtype("int64"): "Int64",
                  np.dtype("uint8"): "UInt8"}[arr.dtype]
    ncomp_attr = f' NumberOfComponents="{n_comp}"' if n_comp else ""
    return (f'<DataArray type="{dtype_name}" Name="{name}"{ncomp_attr} '
            f'format="binary">\n{_b64(arr)}\n</DataArray>')


def subcell_connectivity(elem_nodes: np.ndarray, degree: int,
                         dim: int) -> np.ndarray:
    """Split each Qk element into k^dim linear VTK cells.

    elem_nodes: [E, (k+1)^dim]; returns [E * k^dim, 2^dim] in VTK corner
    order (counterclockwise quad / VTK hexahedron ordering).
    """
    n1d = degree + 1
    cells = []
    if dim == 2:
        def lat(i, j):
            return i + n1d * j
        for j in range(degree):
            for i in range(degree):
                cells.append([lat(i, j), lat(i + 1, j),
                              lat(i + 1, j + 1), lat(i, j + 1)])
    else:
        def lat(i, j, k):
            return i + n1d * (j + n1d * k)
        for k in range(degree):
            for j in range(degree):
                for i in range(degree):
                    cells.append([
                        lat(i, j, k), lat(i + 1, j, k),
                        lat(i + 1, j + 1, k), lat(i, j + 1, k),
                        lat(i, j, k + 1), lat(i + 1, j, k + 1),
                        lat(i + 1, j + 1, k + 1), lat(i, j + 1, k + 1)])
    sub = np.asarray(cells, dtype=np.int64)              # [k^dim, 2^dim]
    out = elem_nodes[:, sub]                              # [E, k^dim, 2^dim]
    return out.reshape(-1, 2 ** dim)


def write_vtu(path: str, points: np.ndarray, cells: np.ndarray,
              point_data: dict[str, np.ndarray]) -> None:
    """points[N, dim]; cells[C, 2^dim] (VTK order); point_data name->array
    ([N] scalars or [N, k] vectors — vectors are padded to 3 components).
    """
    N, dim = points.shape
    C = cells.shape[0]
    pts3 = np.zeros((N, 3), dtype=np.float32)
    pts3[:, :dim] = points
    ctype = VTK_QUAD if cells.shape[1] == 4 else VTK_HEXAHEDRON

    pd_xml = []
    for name, arr in point_data.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            pd_xml.append(_data_array(name, arr.astype(np.float32)))
        else:
            a3 = np.zeros((N, 3), dtype=np.float32)
            a3[:, :arr.shape[1]] = arr
            pd_xml.append(_data_array(name, a3, n_comp=3))

    conn = cells.astype(np.int64).reshape(-1)
    offsets = (np.arange(1, C + 1) * cells.shape[1]).astype(np.int64)
    types = np.full(C, ctype, dtype=np.uint8)

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian" header_type="UInt32">
<UnstructuredGrid>
<Piece NumberOfPoints="{N}" NumberOfCells="{C}">
<Points>
{_data_array("Points", pts3, n_comp=3)}
</Points>
<Cells>
{_data_array("connectivity", conn)}
{_data_array("offsets", offsets)}
{_data_array("types", types)}
</Cells>
<PointData>
{chr(10).join(pd_xml)}
</PointData>
</Piece>
</UnstructuredGrid>
</VTKFile>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(xml)


def subdivide_patches(space, point_data: dict[str, np.ndarray],
                      subdivision: int):
    """deal.II ``build_patches(subdivision)`` equivalent: sample every
    element on an (s+1)^dim reference lattice and emit disconnected
    per-element patches (points duplicated at element interfaces, like
    the reference's DataOut patches).

    Returns (points, cells, point_data) ready for ``write_vtu``.
    """
    s = int(subdivision)
    dim = space.dim
    n1d = s + 1
    # reference lattice (lexicographic, axis 0 fastest — matches the
    # basis node convention)
    axes = [np.linspace(0.0, 1.0, n1d)] * dim
    grids = np.meshgrid(*axes, indexing="ij")
    ref = np.stack([g.reshape(-1, order="F") for g in grids], axis=-1)
    B, _, _ = space.basis.tabulate(ref)              # [n_lat, nn]
    xe = space.element_coords()                       # [E, nn, d]
    E = xe.shape[0]
    pts = np.einsum("ln,end->eld", B, xe).reshape(-1, dim)
    out_data = {}
    for name, arr in point_data.items():
        arr = np.asarray(arr)
        ae = arr[space.elem_nodes]                    # [E, nn, ...] or [E, nn]
        if ae.ndim == 2:
            vals = np.einsum("ln,en->el", B, ae).reshape(-1)
        else:
            vals = np.einsum("ln,enc->elc", B, ae).reshape(
                -1, ae.shape[-1])
        out_data[name] = vals
    # per-element lattice subcells, offset per element
    lat_ids = np.arange(E)[:, None] * (n1d ** dim) + \
        np.arange(n1d ** dim)[None, :]
    cells = subcell_connectivity(lat_ids, s, dim)
    return pts, cells, out_data


def write_grouped_output(outdir: str, basename: str, points: np.ndarray,
                         cells: np.ndarray,
                         point_data: dict[str, np.ndarray],
                         group_files: int) -> str:
    """Reference ``write_vtu_with_pvtu_record`` parity: split the cells
    into ``group_files`` pieces (each .vtu holding only its own points)
    under a .pvtu master.  Returns the master's file name."""
    g = max(1, int(group_files))
    pieces = []
    chunks = np.array_split(np.arange(cells.shape[0]), g)
    for gi, chunk in enumerate(chunks):
        if chunk.size == 0:
            continue
        sub = cells[chunk]
        ids, inv = np.unique(sub.reshape(-1), return_inverse=True)
        sub_cells = inv.reshape(sub.shape)
        sub_data = {k: np.asarray(v)[ids] for k, v in point_data.items()}
        name = f"{basename}.{gi}.vtu"
        write_vtu(os.path.join(outdir, name), points[ids], sub_cells,
                  sub_data)
        pieces.append(name)
    master = f"{basename}.pvtu"
    names = {}
    for k, v in point_data.items():
        v = np.asarray(v)
        names[k] = 3 if v.ndim > 1 else 1
    write_pvtu(os.path.join(outdir, master), pieces, names)
    return master


def write_pvtu(path: str, piece_files: list[str],
               point_data_names: dict[str, int]) -> None:
    """Parallel wrapper: point_data_names maps name -> n_components."""
    pd = []
    for name, nc in point_data_names.items():
        ncomp = f' NumberOfComponents="{nc}"' if nc > 1 else ""
        pd.append(f'<PDataArray type="Float32" Name="{name}"{ncomp}/>')
    pieces = "\n".join(f'<Piece Source="{os.path.basename(f)}"/>'
                       for f in piece_files)
    xml = f"""<?xml version="1.0"?>
<VTKFile type="PUnstructuredGrid" version="0.1" byte_order="LittleEndian">
<PUnstructuredGrid GhostLevel="0">
<PPoints><PDataArray type="Float32" Name="Points" NumberOfComponents="3"/></PPoints>
<PPointData>
{chr(10).join(pd)}
</PPointData>
{pieces}
</PUnstructuredGrid>
</VTKFile>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(xml)
