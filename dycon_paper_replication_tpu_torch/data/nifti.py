"""Minimal NIfTI-1/NIfTI-2 volume reader and writer (numpy only, no nibabel).

The port's own copy of dycon_paper_replication_tpu/data/nifti.py (the port
imports nothing of the JAX package). The preprocessing pipelines (the
reference's BraTS19_DataPreprocessing.py / ISLES22_DataPreprocessing.py)
only need `nib.load(path).get_fdata()`:
the raw voxel array in the file's stored (Fortran) axis order, with the
scl_slope/scl_inter affine scaling applied. This module implements
exactly that surface for .nii and .nii.gz files, from the NIfTI-1
(348-byte header) and NIfTI-2 (540-byte header) specifications.

Not supported (raises ValueError): ANALYZE 7.5 files, RGB/complex
datatypes, extension-relocated data (magic "ni1"/"ni2" two-file pairs).
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

# NIfTI datatype code -> numpy dtype (spec section "datatype")
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}


class NiftiImage:
    """Parsed NIfTI volume: `.shape`, `.zooms` (voxel sizes), `.dataobj`."""

    def __init__(self, data: np.ndarray, zooms: tuple[float, ...]):
        self.dataobj = data
        self.shape = data.shape
        self.zooms = zooms

    def get_fdata(self) -> np.ndarray:
        return np.asanyarray(self.dataobj, dtype=np.float64)


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def load(path: str) -> NiftiImage:
    """Load a .nii / .nii.gz volume (NIfTI-1 or NIfTI-2, either endian)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    raw = _read_bytes(path)
    if len(raw) < 348:
        raise ValueError(f"{path}: too short for a NIfTI header")

    sizeof_hdr_le = struct.unpack_from("<i", raw, 0)[0]
    sizeof_hdr_be = struct.unpack_from(">i", raw, 0)[0]
    if sizeof_hdr_le == 348 or sizeof_hdr_be == 348:
        bo = "<" if sizeof_hdr_le == 348 else ">"
        return _load_n1(path, raw, bo)
    if sizeof_hdr_le == 540 or sizeof_hdr_be == 540:
        bo = "<" if sizeof_hdr_le == 540 else ">"
        return _load_n2(path, raw, bo)
    raise ValueError(f"{path}: not a NIfTI-1/2 file (sizeof_hdr={sizeof_hdr_le})")


def _load_n1(path: str, raw: bytes, bo: str) -> NiftiImage:
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad NIfTI-1 magic {magic!r}")
    if magic[:3] == b"ni1":
        raise ValueError(f"{path}: two-file (.hdr/.img) NIfTI not supported")

    dim = struct.unpack_from(bo + "8h", raw, 40)
    datatype = struct.unpack_from(bo + "h", raw, 70)[0]
    pixdim = struct.unpack_from(bo + "8f", raw, 76)
    vox_offset = int(struct.unpack_from(bo + "f", raw, 108)[0])
    scl_slope = struct.unpack_from(bo + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(bo + "f", raw, 116)[0]
    return _assemble(path, raw, bo, dim, datatype, pixdim, vox_offset, scl_slope, scl_inter)


def _load_n2(path: str, raw: bytes, bo: str) -> NiftiImage:
    magic = raw[4:8]
    if magic[:3] not in (b"n+2", b"ni2"):
        raise ValueError(f"{path}: bad NIfTI-2 magic {magic!r}")
    if magic[:3] == b"ni2":
        raise ValueError(f"{path}: two-file NIfTI-2 not supported")

    datatype = struct.unpack_from(bo + "h", raw, 12)[0]
    dim = struct.unpack_from(bo + "8q", raw, 16)
    pixdim = struct.unpack_from(bo + "8d", raw, 104)
    vox_offset = struct.unpack_from(bo + "q", raw, 168)[0]
    scl_slope = struct.unpack_from(bo + "d", raw, 176)[0]
    scl_inter = struct.unpack_from(bo + "d", raw, 184)[0]
    return _assemble(path, raw, bo, dim, datatype, pixdim, vox_offset, scl_slope, scl_inter)


def _assemble(path, raw, bo, dim, datatype, pixdim, vox_offset, scl_slope, scl_inter):
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid ndim {ndim}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    # trailing singleton time/volume axes are common; drop them like nibabel's
    # squeeze on get_fdata consumers expect for 3-D medical volumes
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(bo)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dt, count=count, offset=vox_offset)
    # NIfTI stores Fortran order: first axis fastest
    data = data.reshape(shape, order="F")

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter
    zooms = tuple(float(p) for p in pixdim[1 : 1 + len(shape)])
    return NiftiImage(np.ascontiguousarray(data), zooms)


def save(path: str, data: np.ndarray, zooms: tuple[float, ...] | None = None) -> None:
    """Write a minimal single-file NIfTI-1 volume (used by tests/fixtures)."""
    data = np.asarray(data)
    code = None
    for c, t in _DTYPES.items():
        if np.dtype(t) == data.dtype:
            code = c
            break
    if code is None:
        data = data.astype(np.float32)
        code = 16
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pixdim = [0.0] + list(zooms or (1.0,) * ndim) + [0.0] * (7 - ndim)

    hdr = bytearray(352)  # 348 header + 4 extension bytes
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
