"""flax's msgpack serialisation of a state tree, without flax.

``flax.serialization.to_bytes`` writes a state dict (nested dicts with
string keys, ``None`` and array leaves) as msgpack, each array as the
extension type 1: a msgpack ``(shape, dtype name, C-order bytes)``
triple. The checkpoints and serving artifacts of both packages are that
encoding, so the port writes and reads it here:

- :func:`packb` is ``msgpack.packb`` with flax's hook (small trees);
- :func:`pack_array` gives the same bytes in one numpy buffer, each
  array's data copied into it once with the GIL released, so a 1.3 GB
  training state is neither copied per leaf, per extension and per
  enclosing map, nor stalls the training thread while a writer thread
  packs it;
- :func:`unpackb` reads either package's bytes into nested dicts of
  numpy arrays (read-only views of the payload).

flax splits a leaf above 1 GiB into chunks; no model of the port has one,
and :func:`pack_array` refuses it rather than writing what flax would
not.
"""

from __future__ import annotations

import struct
from typing import List

import msgpack
import numpy as np

EXT_NDARRAY = 1  # flax.serialization's msgpack ext type for ndarrays
MAX_CHUNK_SIZE = 2 ** 30  # flax's MAX_CHUNK_SIZE


def ext_pack(x):
    """``default=`` hook of ``msgpack.packb``: an ndarray as flax's ext."""
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(EXT_NDARRAY, msgpack.packb(
            (x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True))
    raise TypeError(f"cannot serialize {type(x).__name__} as flax msgpack")


def ext_unpack(code: int, data: bytes):
    if code != EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def packb(tree) -> bytes:
    return msgpack.packb(tree, default=ext_pack, strict_types=True)


def unpackb(payload: bytes):
    return msgpack.unpackb(payload, ext_hook=ext_unpack, raw=False)


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    return b"\xc6" + struct.pack(">I", n)


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _ext_header(n: int, code: int) -> bytes:
    if n in _FIXEXT:
        return bytes([_FIXEXT[n], code])
    if n < 1 << 8:
        return b"\xc7" + struct.pack(">Bb", n, code)
    if n < 1 << 16:
        return b"\xc8" + struct.pack(">Hb", n, code)
    return b"\xc9" + struct.pack(">Ib", n, code)


def _pack_into(tree, out: List) -> None:
    if isinstance(tree, dict):
        out.append(_map_header(len(tree)))
        for k, v in tree.items():
            if type(k) is not str:
                raise TypeError(f"state-dict key {k!r} is not a str")
            out.append(msgpack.packb(k))
            _pack_into(v, out)
    elif isinstance(tree, np.ndarray):
        # (np.ascontiguousarray would make a 0-d leaf 1-d)
        a = tree if tree.flags.c_contiguous else np.ascontiguousarray(tree)
        if a.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(
                f"a {a.nbytes}-byte leaf: flax chunks leaves above "
                f"{MAX_CHUNK_SIZE} bytes, which this writer does not")
        head = (b"\x93" + msgpack.packb(a.shape) + msgpack.packb(a.dtype.name)
                + _bin_header(a.nbytes))
        out.append(_ext_header(len(head) + a.nbytes, EXT_NDARRAY) + head)
        out.append(a.reshape(-1).view(np.uint8).data)
    else:
        out.append(msgpack.packb(tree, default=ext_pack, strict_types=True))


def pack_array(tree) -> np.ndarray:
    """The bytes of :func:`packb` ``(tree)`` as one uint8 array:
    ``pack_array(t).tobytes() == packb(t)``."""
    pieces: List = []
    _pack_into(tree, pieces)
    out = np.empty(sum(len(p) for p in pieces), np.uint8)
    pos = 0
    for p in pieces:
        # numpy copies without the GIL (bytes.join of views holds it)
        out[pos: pos + len(p)] = np.frombuffer(p, np.uint8)
        pos += len(p)
    return out
