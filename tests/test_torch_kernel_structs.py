"""The ctypes structures the port passes to its CUDA kernels mirror the C
structs of `ops/cuda/csrc/` field by field: the same names in the same
order, `int` as c_int, `float` as c_float, a nested struct as its ctypes
structure and an array as a ctypes array.  A struct read with another
field order would hand the kernel wrong geometry without any error, and
the kernels build and run only on the card, so the sources are read
here."""

import ctypes
import re
from pathlib import Path

import pytest

from pde_multigrid_tpu_torch.ops.cuda import blocked3d as BL
from pde_multigrid_tpu_torch.ops.cuda import masked_block as MB
from pde_multigrid_tpu_torch.ops.cuda import padded3d as PD
from pde_multigrid_tpu_torch.ops.cuda import reduced2d as RD
from pde_multigrid_tpu_torch.ops.cuda import relax1d as R1
from pde_multigrid_tpu_torch.ops.cuda import relax2d as R2
from pde_multigrid_tpu_torch.ops.cuda import resident as RS
from pde_multigrid_tpu_torch.ops.cuda import resident3d as RS3
from pde_multigrid_tpu_torch.ops.cuda import slab2d as SL
from pde_multigrid_tpu_torch.ops.cuda import subtree as S
from pde_multigrid_tpu_torch.ops.cuda import transfer as TR
from pde_multigrid_tpu_torch.ops.cuda import zebra_line as ZL

CSRC = Path(MB.__file__).resolve().parent / "csrc"


def _c_fields(source: str, struct: str):
    """[(name, type)] of `struct NAME { ... };` in csrc/`source`: an array
    field's type is "TYPE[]"."""
    text = (CSRC / source).read_text()
    m = re.search(r"struct %s \{(.*?)\n\};" % struct, text, re.S)
    assert m, (source, struct)
    body = re.sub(r"//[^\n]*", "", m.group(1))
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = decl.split(None, 1)
        for name in (n.strip() for n in names.split(",")):
            arr = name.endswith("]")
            fields.append((name.split("[")[0], ctype + "[]" * arr))
    return fields


def _py_fields(cls):
    names = {ctypes.c_int: "int", ctypes.c_float: "float"}
    out = []
    for name, t in cls._fields_:
        if issubclass(t, ctypes.Array):
            out.append((name, _struct_name(t._type_) + "[]"))
        else:
            out.append((name, names.get(t) or _struct_name(t)))
    return out


def _struct_name(t):
    return {S.SubLevelParams: "SubLevel"}.get(t, t.__name__)


@pytest.mark.parametrize("source,struct,cls", [
    ("resident3d.cu", "Resident3DParams", RS3.Resident3DParams),
    ("halves3d.cuh", "SubLevel", S.SubLevelParams),
    ("subtree.cu", "SubtreeParams", S.SubtreeParams),
    ("masked_block.cu", "MaskedChunkLayout", MB.MaskedChunkLayout),
    ("resident.cu", "HJBLeg", RS.HJBLegLayout),
    ("relax1d.cu", "Relax1DLayout", R1.Relax1DLayout),
    ("relax1d.cu", "Poisson1D", R1.Poisson1DParams),
    ("reduced2d.cu", "Reduced2DLayout", RD.Reduced2DLayout),
    ("blocked3d.cu", "Blocked3DLayout", BL.Blocked3DLayout),
    ("slab2d.cu", "HJBSlab", SL.HJBSlabLayout),
    ("poisson2d.cuh", "Poisson2D", R2.Poisson2DParams),
    ("transfer.cu", "RestrictLayout", TR.RestrictLayout),
    ("transfer.cu", "ProlongLayout", TR.ProlongLayout),
    ("transfer.cu", "ResidualLayout", TR.ResidualLayout),
    ("zebra_line.cu", "ZebraLineParams", ZL.ZebraLineParams),
    ("poisson3d.cuh", "Poisson3D", PD.Poisson3DParams),
    ("padded3d.cu", "Padded3DLayout", PD.Padded3DLayout),
])
def test_ctypes_struct_mirrors_the_c_struct(source, struct, cls):
    assert _py_fields(cls) == _c_fields(source, struct)


def test_resident3d_params_carry_the_layout():
    """Resident3DParams of a split level carries its layout: the cluster,
    threads, shared memory and halo planes `layout` gives, v at 0 and f
    after this CTA's points."""
    from pde_multigrid_tpu_torch import grid as TG
    from pde_multigrid_tpu_torch.models import Poisson as TPoisson

    g = TG.build_geometries((65,) * 3, ((0.0, 1.0),) * 3, wrap=True)[0]
    lay = RS3.layout(g)
    p = RS3._params(g, 7, False)
    assert (p.lev.nctas, p.threads, p.smem_bytes, p.halo_off,
            p.halo_plane) == (lay["nctas"], lay["threads"],
                              lay["smem_bytes"], *lay["halo"])
    assert (p.lev.v_off, p.lev.f_off, p.nsweeps, p.halves) == (
        0, 64**3 // 16, 7, 0)
    assert (p.lev.lx, p.lev.ly, p.lev.lz) == (6, 6, 6)
    assert TPoisson  # the level's constants come from Poisson's spacing
