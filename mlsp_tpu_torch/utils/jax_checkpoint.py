"""Read the JAX package's msgpack `.ckpt` files without JAX or msgpack.

`mlsp_tpu.utils.checkpoint.save_train_state` writes
`flax.serialization.to_bytes({"params", "batch_stats", "opt_state",
"step", "epoch", "metrics"})`: a msgpack document whose arrays are
extension types. This module decodes the subset flax writes, in pure
Python:

  * nil, bools, ints (fixint, uint8-64, int8-64), float32 and float64;
  * str and bin (flax packs with `use_bin_type=True`), arrays and maps
    (keys may be str or int), all lengths big-endian;
  * ext (fixext 1/2/4/8/16, ext 8/16/32): code 1, an ndarray, whose
    payload is itself msgpack (shape, dtype name, C-order bytes); code 3,
    a numpy scalar (the same payload, 0-d); code 2, a Python complex;
  * flax's chunked arrays (`__msgpack_chunked_array__`, above 1 GiB).

Dtype names are numpy's, plus `bfloat16`, whose uint16 bits are widened
to float32. Anything else, a truncated document or bytes after its end
raise ValueError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated at byte {self.pos} (needs {n} more "
                             f"of {len(self.data)})")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", self.bin), 0xC5: ("H", self.bin),
                 0xC6: ("I", self.bin), 0xD9: ("B", self.str),
                 0xDA: ("H", self.str), 0xDB: ("I", self.str),
                 0xDC: ("H", self.array), 0xDD: ("I", self.array),
                 0xDE: ("H", self.map), 0xDF: ("I", self.map),
                 0xC7: ("B", self.ext), 0xC8: ("H", self.ext),
                 0xC9: ("I", self.ext)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} is no msgpack "
                         "type")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = bytes(self.take(n))
        if code == _EXT_COMPLEX:
            re, im = _decode(payload)
            return complex(re, im)
        if code not in (_EXT_NDARRAY, _EXT_SCALAR):
            raise ValueError(f"msgpack extension type {code} is not one "
                             "flax writes")
        arr = _ndarray(payload)
        return arr[()] if code == _EXT_SCALAR else arr


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = _decode(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, np.dtype(name)).copy()
    return arr.reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _decode(data: bytes):
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the end of the "
                         "document")
    return out


def decode(data: bytes):
    """A msgpack document as flax writes it -> Python dicts, lists,
    scalars and numpy arrays."""
    return _unchunk(_decode(data))


def read_train_state(path: str) -> dict:
    """The payload of a JAX `save_train_state` file: a dict with at least
    "params" and "batch_stats" (nested dicts of numpy arrays). Raises
    ValueError naming `path` for anything else."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        raw = decode(data)
    except (ValueError, struct.error, UnicodeDecodeError, TypeError) as e:
        raise ValueError(f"checkpoint {path!r} is neither a mlsp_tpu_torch "
                         f"checkpoint nor a readable JAX .ckpt: {e}") from e
    if not isinstance(raw, dict) or not {"params", "batch_stats"} <= set(raw):
        raise ValueError(f"checkpoint {path!r} is a msgpack document but not "
                         "a JAX train state (no params/batch_stats)")
    return raw
