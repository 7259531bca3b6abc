"""Self-contained PLY point-cloud IO (numpy only): the PyTorch port's copy
of pcc_tpu/io/ply.py (xyz, and the RGB and normal columns eval reads).

Supports ascii, binary_little_endian and binary_big_endian vertex elements;
tolerates upper/lowercase x/y/z like the reference's pn_kit.py:27-30.
"""

from __future__ import annotations

import os

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(f):
    """Returns (fmt, elements). elements: list of [name, count, props]."""
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tokens = line.strip().split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"format":
            fmt = tokens[1].decode()
        elif key == b"element":
            elements.append([tokens[1].decode(), int(tokens[2]), []])
        elif key == b"property":
            if tokens[1] == b"list":
                elements[-1][2].append(("list", tokens[2].decode(),
                                        tokens[3].decode(), tokens[4].decode()))
            else:
                elements[-1][2].append(("scalar", tokens[1].decode(),
                                        tokens[2].decode()))
        elif key == b"end_header":
            break
    return fmt, elements


def read_point_cloud(filepath: str) -> np.ndarray:
    """Read the vertex x/y/z columns of a .ply file as float32 [N, 3]."""
    return _read_vertex_data(filepath, with_attributes=False)[0]


_NORMAL_COLS = ("nx", "ny", "nz")
_RGB_COLS = ("red", "green", "blue")


def read_point_cloud_attr(filepath: str):
    """Read xyz plus RGB attributes if present.

    Returns (pc [N, 3] float32, rgb [N, 3] uint8 or None)."""
    pc, rgb, _ = _read_vertex_data(filepath, with_attributes=True)
    return pc, rgb


def read_point_cloud_normals(filepath: str):
    """Read xyz plus per-vertex normals if present (nx/ny/nz columns).

    Returns (pc [N, 3] float32, normals [N, 3] float32 or None). The
    reference's eval uses file normals when the PLY carries them instead of
    estimating them (eval.py:59-60)."""
    pc, _, normals = _read_vertex_data(filepath, with_attributes=True)
    return pc, normals


def _read_vertex_data(filepath: str, with_attributes: bool):
    """(xyz [N, 3] float32, rgb [N, 3] uint8 or None, normals [N, 3] float32
    or None) of the vertex element; rgb and normals only `with_attributes`."""
    with open(filepath, "rb") as f:
        fmt, elements = _parse_header(f)
        byte_order = {"binary_little_endian": "<",
                      "binary_big_endian": ">"}.get(fmt, "")
        out = rgb = normals = None
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                if name == "vertex":
                    raise ValueError("list properties on vertex element unsupported")
                # ascii rows are line-delimited and skip trivially; a binary
                # list element has data-dependent size, so one before the
                # vertices hides their offset, and nothing after it is read
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                elif count > 0:
                    if out is None:
                        raise ValueError(
                            f"binary list element '{name}' precedes the vertex "
                            "element; cannot compute the vertex data offset")
                    break
                continue
            dtype = np.dtype([(p[2], byte_order + _PLY_TYPES[p[1]]) for p in props])
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                arr = np.array(rows, dtype=np.float64).reshape(count, len(props))
                data = np.rec.fromarrays(arr.T, names=[p[2] for p in props])
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                     count=count)
            if name != "vertex":
                continue
            names = data.dtype.names
            cols = []
            for axis in ("x", "y", "z"):
                col = axis if axis in names else axis.upper()
                if col not in names:
                    raise ValueError(f"vertex element missing {axis} column")
                cols.append(np.asarray(data[col], dtype=np.float32))
            out = np.stack(cols, axis=1)
            if with_attributes and all(c in names for c in _RGB_COLS):
                rgb = np.stack([np.asarray(data[c]) for c in _RGB_COLS],
                               axis=1).astype(np.uint8)
            if with_attributes and all(c in names for c in _NORMAL_COLS):
                normals = np.stack([np.asarray(data[c], dtype=np.float32)
                                    for c in _NORMAL_COLS], axis=1)
        if out is None:
            raise ValueError("no vertex element in PLY file")
        return out, rgb, normals


def read_point_clouds(files) -> np.ndarray:
    """Read equal-sized .ply clouds into one [M, N, 3] float32 array
    (pcc_tpu.io.read_point_clouds; reference pn_kit.py:33-37)."""
    files = list(files)
    if not files:
        return np.zeros((0, 0, 3), dtype=np.float32)
    return np.stack([read_point_cloud(f) for f in files], axis=0)


def save_point_cloud(pc: np.ndarray, filename: str, path: str = "./viewing/",
                     rgb: np.ndarray | None = None,
                     normals: np.ndarray | None = None) -> str:
    """Write [N, 3] float32 points, optionally with [N, 3] float32 normals
    and [N, 3] uint8 RGB, as binary_little_endian PLY (reference
    pn_kit.py:39-42 signature; the bytes of pcc_tpu's writer)."""
    pc = np.ascontiguousarray(np.asarray(pc, dtype=np.float32).reshape(-1, 3))
    os.makedirs(path, exist_ok=True)
    out_path = os.path.join(path, filename)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        fields += [(c, "<f4") for c in _NORMAL_COLS]
        props += [f"property float {c}" for c in _NORMAL_COLS]
    if rgb is not None:
        rgb = np.asarray(rgb, dtype=np.uint8).reshape(-1, 3)
        fields += [(c, "u1") for c in _RGB_COLS]
        props += [f"property uchar {c}" for c in _RGB_COLS]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {pc.shape[0]}\n"
        + "\n".join(props) + "\n"
        "end_header\n"
    )
    rec = np.zeros(pc.shape[0], dtype=fields)
    for i, c in enumerate("xyz"):
        rec[c] = pc[:, i]
    for cols, vals in ((_NORMAL_COLS, normals), (_RGB_COLS, rgb)):
        if vals is not None:
            if vals.shape[0] != pc.shape[0]:
                raise ValueError(f"{vals.shape[0]} attribute rows for {pc.shape[0]} points")
            for i, c in enumerate(cols):
                rec[c] = vals[:, i]
    with open(out_path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
    return out_path
