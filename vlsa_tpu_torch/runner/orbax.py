"""vlsa_tpu's orbax checkpoints read without orbax or TensorStore
(counterpart of the orbax branch of vlsa_tpu/runner/ckpt.py).

`save_checkpoint(..., backend="orbax")` in vlsa_tpu writes a directory
`<path>.orbax` through orbax's `PyTreeCheckpointer`:

  * `_METADATA` (JSON): `tree_metadata` maps each leaf's key path, such as
    "('model', 'a', 'kernel')", to its keys and its `value_type`
    (`np.ndarray`, `scalar`, or an empty `Dict` where optax has a
    MaskedNode);
  * an OCDBT key-value store (TensorStore's "OCDBT" on-disk format): the
    root `manifest.ocdbt` and each process's `ocdbt.process_<i>/`, whose
    b-tree nodes and values lie in `d/<name>` data files;
  * in that store, one zarr v2 array a leaf, under the key path joined by
    "." (`model.a.kernel/.zarray`, chunks `model.a.kernel/0.0`), each chunk
    compressed with zstd.

Every OCDBT file starts with a header: a magic number (big-endian;
0x0cdb3a2a a manifest, 0x0cdb20de a b-tree node), the file's length
(uint64le), the format version (varint) and the compression (varint: 0
none, 1 zstd), and ends with the CRC-32C of everything before it.  A
manifest holds the store's config (uuid, kind, the inline and node size
limits, the version tree's arity, the compression with its zstd level as
int32le), a data file table (paths prefix-compressed against the one
before, each split into a base path and a relative one) and the version
tree's newest leaf entries: per version its generation, the root node's
height and location (file, offset, length) and statistics, and a commit
time.  A b-tree node holds its height, its own data file table and its
entries: keys prefix-compressed against the one before and relative to
the prefix the parent's entry gives (an interior entry's subtree common
prefix); a leaf entry's value is inline or a (file, offset, length)
reference, an interior entry's child node a reference.  Integers are
LEB128 varints, and each field is a column over the node's entries.

`read_orbax_checkpoint(dir)` returns the tree vlsa_tpu's
`load_checkpoint` returns for that directory: nested dicts of numpy
arrays (bfloat16 leaves as torch.bfloat16 tensors: numpy has no such type
without ml_dtypes), an empty dict for each MaskedNode, and Python numbers
for scalars (the epoch).  zstd comes from `utils.zstd`, CRC-32C from here:
nothing of orbax, TensorStore or a zstd module is imported.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.zstd import decompress

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_HEADER = 14  # magic, length, version and compression (a varint of one byte each here)


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """The fields of a decoded OCDBT body, read in order."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.at, self.what = buf, 0, what

    def fail(self, msg: str):
        raise ValueError(f"{self.what}: {msg}")

    def byte(self) -> int:
        if self.at >= len(self.buf):
            self.fail("cut short")
        self.at += 1
        return self.buf[self.at - 1]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("a varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.at + n > len(self.buf):
            self.fail("cut short")
        self.at += n
        return self.buf[self.at - n:self.at]


def _body(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one OCDBT file (a manifest, or a node cut out of a data
    file), checked against its header and its CRC-32C and decompressed."""
    if len(blob) < _HEADER + 4 or int.from_bytes(blob[:4], "big") != magic:
        raise ValueError(f"{what}: not an OCDBT {'manifest' if magic == _MANIFEST_MAGIC else 'node'}")
    if int.from_bytes(blob[4:12], "little") != len(blob):
        raise ValueError(f"{what}: its header gives another length")
    head = _Reader(blob[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version}")
    if int.from_bytes(blob[-4:], "little") != crc32c(blob[:-4]):
        raise ValueError(f"{what}: its CRC-32C does not match")
    body = blob[12 + head.at:-4]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        raise ValueError(f"{what}: compression method {compression}")
    return body


def _data_file_table(r: _Reader) -> List[str]:
    """A data file table: each file's path (base path and relative path
    joined), relative to the directory of the manifest."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    _base = r.varints(n)
    paths: List[str] = []
    for i in range(n):
        if prefix[i] > (len(paths[-1]) if paths else 0):
            r.fail("a data file path prefix longer than the path before")
        head = paths[-1][:prefix[i]] if paths else ""
        paths.append(head + r.raw(suffix[i]).decode())
    return paths


class _Store:
    """One OCDBT store: its data files and the newest version's root."""

    def __init__(self, directory: str):
        self.dir = directory
        path = os.path.join(directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(_body(f.read(), _MANIFEST_MAGIC, path), path)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            r.fail(f"manifest kind {kind} (only 'single' manifests are read)")
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:
            r.raw(4)  # the zstd level, int32le
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("a manifest with no version")
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        r.raw(8 * n)  # commit times; references to older versions' nodes follow, unread
        last = max(range(n), key=generation.__getitem__)
        # an empty tree's root names no file (the empty path, no length)
        self.root = None if length[last] == 0 or file_id[last] >= len(files) \
            or not files[file_id[last]] else (files[file_id[last]], offset[last],
                                                length[last], height[last])

    def _read(self, path: str, offset: int, length: int) -> bytes:
        full = os.path.join(self.dir, path)
        with open(full, "rb") as f:
            f.seek(offset)
            blob = f.read(length)
        if len(blob) != length:
            raise ValueError(f"{full}: {length} bytes at {offset} are past its end")
        return blob

    def items(self) -> Dict[str, bytes]:
        """{key: value} of every entry of the newest version."""
        out: Dict[str, bytes] = {}
        if self.root is not None:
            path, offset, length, height = self.root
            self._node(path, offset, length, height, b"", out)
        return out

    def _node(self, path, offset, length, height, prefix: bytes, out: dict):
        what = f"{os.path.join(self.dir, path)}@{offset}"
        r = _Reader(_body(self._read(path, offset, length), _NODE_MAGIC, what), what)
        if r.byte() != height:
            r.fail("a node of another height than its parent gives")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("an empty node")
        key_prefix = [0] + r.varints(n - 1)
        key_suffix = r.varints(n)
        common = r.varints(n) if height else None
        keys: List[bytes] = []
        for i in range(n):
            head = keys[-1][:key_prefix[i]] if keys else b""
            keys.append(head + r.raw(key_suffix[i]))
        if height:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            for i in range(n):
                self._node(files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            r.fail("a value of unknown kind")
        ids, offs = r.varints(len(indirect)), r.varints(len(indirect))
        where = dict(zip(indirect, zip(ids, offs)))
        for i in range(n):
            if i in where:
                fid, off = where[i]
                value = self._read(files[fid], off, lengths[i])
            else:
                value = r.raw(lengths[i])
            out[(prefix + keys[i]).decode()] = value


def read_ocdbt(directory: str) -> Dict[str, bytes]:
    """Every key and value of the OCDBT store in `directory` (its root
    manifest, else each process's `ocdbt.process_<i>/` store)."""
    if os.path.exists(os.path.join(directory, "manifest.ocdbt")):
        return _Store(directory).items()
    out: Dict[str, bytes] = {}
    subs = sorted(d for d in os.listdir(directory) if d.startswith("ocdbt.process_"))
    if not subs:
        raise ValueError(f"{directory}: no OCDBT manifest")
    for sub in subs:
        out.update(_Store(os.path.join(directory, sub)).items())
    return out


def _zarr_array(name: str, kv: Dict[str, bytes]):
    """The zarr v2 array `name` of the store: numpy, or a torch.bfloat16
    tensor for bfloat16."""
    meta = json.loads(kv[f"{name}/.zarray"])
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: a zarr array this reader does not take: {meta}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    if fill is None or bf16:
        out.fill(0 if fill is None else np.array(fill, np.float32).view(np.uint32) >> 16)
    else:
        out.fill(fill)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in kv:
            continue  # a chunk all of the fill value
        raw = kv[key]
        raw = decompress(raw) if compressor is not None else raw
        chunk = np.frombuffer(raw, dtype)
        if chunk.size != int(np.prod(chunks)):
            raise ValueError(f"{key}: {chunk.size} values for a chunk of {chunks}")
        chunk = chunk.reshape(chunks)
        lo = [i * c for i, c in zip(index, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    if bf16:
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out


def read_orbax_checkpoint(directory: str) -> dict:
    """The tree `orbax.checkpoint.PyTreeCheckpointer().restore(directory)`
    gives for a checkpoint vlsa_tpu's `save_checkpoint` wrote (see the
    module's docstring)."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: only OCDBT stores of zarr v2 arrays are read")
    kv = read_ocdbt(directory)
    tree: dict = {}
    for path, entry in meta["tree_metadata"].items():
        keys = [k["key"] for k in entry["key_metadata"]] if "key_metadata" in entry \
            else list(ast.literal_eval(path))
        if any(k.get("key_type", 2) != 2 for k in entry.get("key_metadata", [])):
            raise ValueError(f"{directory}: {path} is not a tree of dicts")
        value = entry["value_metadata"]
        kind = value["value_type"]
        if value.get("skip_deserialize"):
            if kind != "Dict":
                raise ValueError(f"{directory}: {path}: an empty {kind}")
            leaf = {}
        else:
            leaf = _zarr_array(".".join(str(k) for k in keys), kv)
            if kind == "scalar":
                leaf = leaf.item()
            elif kind not in ("np.ndarray", "jax.Array"):
                raise ValueError(f"{directory}: {path}: value type {kind}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(str(k), {})
        node[str(keys[-1])] = leaf
    return tree


def orbax_dir(path: str) -> Optional[str]:
    """The orbax directory vlsa_tpu's `load_checkpoint(path)` would read
    (`path + ".orbax"`, or `path` itself where it ends in ".orbax"), else
    None."""
    if os.path.isdir(path + ".orbax"):
        return path + ".orbax"
    if path.endswith(".orbax"):
        return path
    return None
