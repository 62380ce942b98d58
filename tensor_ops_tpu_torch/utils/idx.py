"""IDX file format codec (the MNIST container format).

The reference reads MNIST through the ``mnist-idx`` Haskell package joined
with ``labeledIntData`` (``app/MNIST.hs:159-192``); this is the rebuild's
own ~60-line parser (SURVEY.md §2.4).

Format: magic ``[0, 0, dtype, ndim]``, then ``ndim`` big-endian uint32
dims, then row-major data.
"""

from __future__ import annotations

import struct

import numpy as np

_DTYPES = {
    0x08: np.uint8,
    0x09: np.int8,
    0x0B: np.dtype(">i2"),
    0x0C: np.dtype(">i4"),
    0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def decode_idx(data: bytes) -> np.ndarray:
    """Decode an IDX byte string to an ndarray."""
    if len(data) < 4:
        raise ValueError("IDX: truncated header")
    zero1, zero2, dtype_code, ndim = struct.unpack(">BBBB", data[:4])
    if zero1 != 0 or zero2 != 0:
        raise ValueError("IDX: bad magic (first two bytes must be zero)")
    if dtype_code not in _DTYPES:
        raise ValueError(f"IDX: unknown dtype code 0x{dtype_code:02x}")
    dims = struct.unpack(f">{ndim}I", data[4 : 4 + 4 * ndim])
    dt = np.dtype(_DTYPES[dtype_code])
    count = int(np.prod(dims)) if dims else 1
    body = np.frombuffer(data, dtype=dt, count=count, offset=4 + 4 * ndim)
    if body.size != count:
        raise ValueError(f"IDX: expected {count} elements, got {body.size}")
    return body.reshape(dims)


def encode_idx(arr: np.ndarray) -> bytes:
    """Encode an ndarray as IDX (ubyte or big-endian numeric)."""
    code = None
    for c, dt in _DTYPES.items():
        if np.dtype(dt) == arr.dtype:
            code = c
            break
    if code is None:
        raise ValueError(f"IDX: unsupported dtype {arr.dtype}")
    head = struct.pack(">BBBB", 0, 0, code, arr.ndim)
    head += struct.pack(f">{arr.ndim}I", *arr.shape)
    return head + arr.tobytes()


def labeled_data(labels: np.ndarray, images: np.ndarray) -> list:
    """Join an IDX1 label vector with an IDX3 image tensor into
    ``[(label, flat_pixels)]`` (the ``labeledIntData`` join,
    ``app/MNIST.hs:186-189``)."""
    if labels.shape[0] != images.shape[0]:
        raise ValueError(
            f"IDX: {labels.shape[0]} labels vs {images.shape[0]} images"
        )
    flat = images.reshape(images.shape[0], -1)
    return [(int(l), flat[i]) for i, l in enumerate(labels)]
