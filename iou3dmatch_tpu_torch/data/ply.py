"""Minimal PLY reader (no plyfile dependency).

Supports the formats the ScanNet meshes use: ``binary_little_endian 1.0``
and ``ascii 1.0`` vertex elements with float x/y/z and optional uchar
red/green/blue[/alpha]. Replaces the reference's plyfile usage
(scannet/scannet_utils.py:44-75).

The port's copy of ``iou3dmatch_tpu/data/ply.py``.
"""
import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_vertices(filename):
    """Returns a structured numpy array of the vertex element."""
    with open(filename, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{filename}: not a ply file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in ply header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[4], "list", tokens[2], tokens[3]))
                else:
                    cur[2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        endian = "<" if "little" in fmt else ">"
        out = None
        for name, count, props in elements:
            if name == "vertex":
                if any(p[1] == "list" for p in props):
                    raise ValueError("list properties on vertex unsupported")
                dtype = np.dtype([(p[0], endian + p[1]) for p in props])
                if fmt == "ascii":
                    rows = [f.readline().split() for _ in range(count)]
                    out = np.array(
                        [tuple(r[: len(props)]) for r in rows], dtype=dtype
                    )
                else:
                    out = np.frombuffer(
                        f.read(count * dtype.itemsize), dtype=dtype, count=count
                    )
                return out
            # Skip non-vertex elements that precede vertex (rare)
            if fmt == "ascii":
                for _ in range(count):
                    f.readline()
            else:
                raise ValueError(
                    f"cannot skip binary element {name!r} before vertex"
                )
        raise ValueError("no vertex element found")


def read_mesh_vertices(filename):
    """(N, 3) float32 XYZ (scannet_utils.read_mesh_vertices)."""
    v = read_ply_vertices(filename)
    return np.stack(
        [v["x"], v["y"], v["z"]], axis=1
    ).astype(np.float32)


def read_mesh_vertices_rgb(filename):
    """(N, 6) float32 XYZRGB, RGB in 0-255
    (scannet_utils.read_mesh_vertices_rgb)."""
    v = read_ply_vertices(filename)
    return np.stack(
        [v["x"], v["y"], v["z"], v["red"], v["green"], v["blue"]], axis=1
    ).astype(np.float32)
