"""TPUSIDX2 index files, read and written from torch tensors.

The format of ``tpu_search/index/serialize.py``, so an index saved by
either package loads in the other::

    MAGIC "TPUSIDX2" | u64 header_len | header JSON | raw section bytes

The header carries the index metadata and a ``sections`` table of
``{name, dtype, shape, offset}`` (offsets from the data start).  bfloat16
sections hold the raw 16-bit patterns; here they are written and read
through ``Tensor.view(torch.int16)``, with no bf16 numpy type.  Device
tensors stream to the file in fixed row chunks (peak host memory is one
chunk), and reads memory-map the file.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "MAGIC",
    "is_streamed_file",
    "read_file",
    "tensor_section",
    "upload_rows",
    "write_file",
]

MAGIC = b"TPUSIDX2"

_CHUNK_BYTES = 64 << 20  # per streamed chunk: bounds peak host memory

# Section dtype name -> numpy dtype of the raw bytes on disk.
_NP_DTYPES = {
    "int8": np.dtype(np.int8),
    "uint8": np.dtype(np.uint8),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "float32": np.dtype(np.float32),
    "bool": np.dtype(np.bool_),
    "bfloat16": np.dtype(np.uint16),
}

_TORCH_DTYPES = {
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def _np_dtype(name: str) -> np.dtype:
    try:
        return _NP_DTYPES[name]
    except KeyError:
        raise ValueError(f"Unknown section dtype: {name}") from None


def is_streamed_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def write_file(
    path: str,
    header: Dict,
    sections: List[Tuple[str, str, Tuple[int, ...], Iterable[np.ndarray]]],
) -> None:
    """Write ``(name, dtype, shape, chunk_iter)`` sections after a JSON
    header; the file is replaced atomically (written under a name of this
    process's own first, so processes writing one path never share it)."""
    meta = []
    offset = 0
    for name, dtype, shape, _ in sections:
        nbytes = int(np.prod(shape, dtype=np.int64)) * _np_dtype(dtype).itemsize
        meta.append(
            {"name": name, "dtype": dtype, "shape": list(shape), "offset": offset}
        )
        offset += nbytes
    full_header = dict(header)
    full_header["sections"] = meta
    blob = json.dumps(full_header).encode("utf-8")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for (name, dtype, shape, chunks), _m in zip(sections, meta):
                want = int(np.prod(shape, dtype=np.int64)) * _np_dtype(
                    dtype
                ).itemsize
                written = 0
                for chunk in chunks:
                    chunk = np.ascontiguousarray(chunk)
                    if chunk.dtype != _np_dtype(dtype):
                        raise ValueError(
                            f"section {name}: chunk dtype {chunk.dtype} "
                            f"!= {dtype}"
                        )
                    f.write(chunk.tobytes())
                    written += chunk.nbytes
                if written != want:
                    raise ValueError(
                        f"section {name}: wrote {written} bytes, expected {want}"
                    )
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def read_file(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Parse the header and memory-map every section (bfloat16 sections
    come back as their raw uint16 patterns)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"Not a TPUSIDX2 file: {path}")
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
        data_start = f.tell()
    arrays: Dict[str, np.ndarray] = {}
    for m in header["sections"]:
        shape = tuple(m["shape"])
        if int(np.prod(shape, dtype=np.int64)) == 0:
            arrays[m["name"]] = np.empty(shape, dtype=_np_dtype(m["dtype"]))
            continue
        arrays[m["name"]] = np.memmap(
            path, dtype=_np_dtype(m["dtype"]), mode="r",
            offset=data_start + m["offset"], shape=shape,
        )
    return header, arrays


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.bool:
        return t.to(torch.uint8).numpy()
    return t.numpy()


def _iter_rows(t: torch.Tensor, count: int) -> Iterator[np.ndarray]:
    row_bytes = max(1, int(np.prod(t.shape[1:], dtype=np.int64))) * t.element_size()
    step = max(1, _CHUNK_BYTES // row_bytes)
    for start in range(0, count, step):
        yield _to_numpy(t[start: min(count, start + step)])


def tensor_section(
    name: str, dtype: str, tensor: Optional[torch.Tensor], count: int
) -> Tuple[str, str, Tuple[int, ...], Iterable[np.ndarray]]:
    """A ``write_file`` section streaming the first ``count`` rows."""
    if tensor is None or count <= 0:
        tail = () if tensor is None else tuple(tensor.shape[1:])
        return name, dtype, (0,) + tail, iter(())
    return name, dtype, (count,) + tuple(tensor.shape[1:]), _iter_rows(
        tensor, count
    )


def upload_rows(
    source: np.ndarray,
    dtype_name: str,
    capacity: int,
    device: torch.device,
) -> torch.Tensor:
    """Host rows (typically a memmap) -> a zero-padded ``[capacity, ...]``
    tensor of the section's dtype on ``device``, one chunk at a time."""
    dtype = _TORCH_DTYPES[dtype_name]
    count = source.shape[0]
    row_shape = tuple(source.shape[1:])
    out = torch.zeros((capacity,) + row_shape, dtype=dtype, device=device)
    row_bytes = max(1, int(np.prod(row_shape, dtype=np.int64))) * source.itemsize
    step = max(1, _CHUNK_BYTES // row_bytes)
    for start in range(0, count, step):
        blk = np.array(source[start: start + step])  # writable host copy
        if dtype == torch.bfloat16:
            t = torch.from_numpy(blk.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(blk)
        out[start: start + blk.shape[0]].copy_(t)
    return out
