"""Checkpoints: an npz of raw leaf bytes plus a json manifest (port of
``repro/checkpoint/store.py``), byte-compatible with the reference's: a
checkpoint either package writes, the other restores.

Layout: ``save(path, tree, step=N)`` writes the step-versioned
subdirectory ``path/step_0000000N/`` through a temp dir and an atomic
``os.replace``, so a crash mid-save leaves at most a stale ``.tmp-*``
dir and never a broken checkpoint. ``keep`` prunes to the newest N
steps. ``latest_step`` and ``restore`` scan the subdirs, ignore partial
ones, and still read the flat single-manifest layout (``step=None``).
``extra`` rides in the manifest (the session's ``batches_consumed``).

A leaf's key is its path in the reference's order
(``repro_torch.tree.tree_flatten_with_path``: dict keys sorted, fields
by name, sequence indices as ``[0]``), and ``arrays.npz`` holds leaf
``i`` of that order as ``leaf_i``, its bytes as uint8 with the dtype's
name in the manifest. bfloat16 goes through a torch byte view, so no
``ml_dtypes`` is needed.

``codec="uniform_amax:7"`` (any ``comm`` spec) stores the float leaves
under the ``codec_keys`` top-level keys (the optimizer moments m, v, e,
es) as wire buffers, payload and scale, through ``Codec.encode`` (#5 on
the card) and ``WireBuffer.decode`` (K6); masters and counters stay
exact. Lossy by construction: exactly the codec's grid error.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import shutil
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.comm.codec import WireBuffer, get_codec
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp-"

MOMENT_KEYS = ("m", "v", "e", "es")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "uint8": torch.uint8, "uint32": torch.uint32,
                 "bool": torch.bool}


def dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _TORCH_DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"no checkpoint dtype for {dtype}")


def _leaf_bytes(v):
    """A leaf (tensor, numpy array or number) -> (flat uint8 bytes, dtype
    name, shape)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return raw, dtype_name(t.dtype), list(t.shape)
    arr = np.asarray(v)
    shape = list(arr.shape)
    arr = np.ascontiguousarray(arr)
    return arr.view(np.uint8).reshape(-1), str(arr.dtype), shape


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """Flat uint8 bytes -> a CPU tensor of ``dtype`` and ``shape``."""
    raw = np.ascontiguousarray(raw).view(np.uint8)
    if not raw.flags.writeable:
        raw = raw.copy()
    return torch.from_numpy(raw).view(_TORCH_DTYPES[dtype]).reshape(shape)


def _step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def _list_steps(path: str) -> List[int]:
    """Step numbers of the complete (manifest-bearing) versioned subdirs."""
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    steps = []
    for n in names:
        if not n.startswith(_STEP_PREFIX):
            continue
        if not os.path.exists(os.path.join(path, n, "manifest.json")):
            continue  # partial dir (crash before the atomic rename)
        try:
            steps.append(int(n[len(_STEP_PREFIX):]))
        except ValueError:
            continue
    return sorted(steps)


def _resolve_dir(path: str, step: Optional[int] = None) -> str:
    """Directory holding the requested (default: latest) checkpoint;
    ``path`` itself for the flat layout."""
    if step is not None:
        return os.path.join(path, _step_dirname(step))
    steps = _list_steps(path)
    if steps:
        return os.path.join(path, _step_dirname(steps[-1]))
    return path


@dataclasses.dataclass
class EncodedLeaf:
    """A leaf to be stored as its codec's wire buffer (payload and
    scale) and the dtype it decodes back to."""

    buf: WireBuffer
    dtype: str


def codec_eligible(key: str, v,
                   codec_keys: Sequence[str] = MOMENT_KEYS) -> bool:
    """The reference's rule: a float leaf of more than one element under
    a ``codec_keys`` top-level key (its bfloat16 is no numpy float)."""
    return (isinstance(v, torch.Tensor) and key.split("/", 1)[0] in
            codec_keys and v.dtype in (torch.float16, torch.float32,
                                       torch.float64) and v.numel() > 1)


def encode_leaves(tree: Any, codec: str,
                  codec_keys: Sequence[str] = MOMENT_KEYS) -> Any:
    """``tree`` with every codec-eligible leaf replaced by its
    :class:`EncodedLeaf`, encoded where the leaf lies (#5 on the card)."""
    cd = get_codec(codec)

    def leaf(k, v):
        if not codec_eligible(k, v, codec_keys):
            return v
        return EncodedLeaf(cd.encode(v.detach()), dtype_name(v.dtype))
    return tree_map_with_path(leaf, tree)


def _write_payload(d: str, tree: Any, step: Optional[int],
                   extra: Optional[Dict], codec: Optional[str] = None,
                   codec_keys: Sequence[str] = MOMENT_KEYS) -> None:
    os.makedirs(d, exist_ok=True)
    if codec is not None:
        tree = encode_leaves(tree, codec, codec_keys)
    arrays = {}
    manifest = {"step": step, "leaves": []}
    if extra:
        manifest["extra"] = extra
    for i, (k, v) in enumerate(tree_flatten_with_path(tree)):
        name = f"leaf_{i}"
        if isinstance(v, EncodedLeaf):
            arrays[name] = v.buf.payload.cpu().numpy()
            arrays[f"{name}_scale"] = v.buf.scale.cpu().numpy()
            manifest["leaves"].append(
                {"key": k, "name": name, "dtype": v.dtype,
                 "shape": list(v.buf.shape), "codec": v.buf.spec})
            continue
        # raw bytes: npz would mangle non-native dtypes (bfloat16 -> |V2)
        raw, dtype, shape = _leaf_bytes(v)
        arrays[name] = raw
        manifest["leaves"].append(
            {"key": k, "name": name, "dtype": dtype, "shape": shape})
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def save(path: str, tree: Any, step: Optional[int] = None,
         keep: Optional[int] = None, extra: Optional[Dict] = None,
         codec: Optional[str] = None,
         codec_keys: Sequence[str] = MOMENT_KEYS) -> str:
    """Write one checkpoint of ``tree`` (tensors on any device, numpy
    arrays or numbers); returns the directory written.

    With ``step``, writes ``path/step_XXXXXXXX/`` atomically (temp dir +
    ``os.replace``) and, with ``keep``, prunes to the newest ``keep``
    versioned checkpoints. Without ``step``, writes the flat layout
    directly into ``path``. ``codec`` stores the ``codec_keys`` subtrees
    as wire buffers (see the module docstring); leaves already encoded
    (:class:`EncodedLeaf`) are written as they are."""
    if step is None:
        _write_payload(path, tree, None, extra, codec, codec_keys)
        return path
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, _step_dirname(step))
    tmp = os.path.join(path,
                       f"{_TMP_PREFIX}{_step_dirname(step)}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _write_payload(tmp, tree, step, extra, codec, codec_keys)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if keep is not None and keep > 0:
        for s in _list_steps(path)[:-keep]:
            shutil.rmtree(os.path.join(path, _step_dirname(s)),
                          ignore_errors=True)
    return final


class _Npz:
    """The arrays of an npz by name, each read when asked for. A stored
    (uncompressed) member, which is what ``np.savez`` writes, is read
    from its offset in the file with one call and checked against its
    CRC-32, as ``zipfile`` checks it (``np.load`` reads through zipfile in
    256 KiB pieces, several times slower); any other member goes through
    ``np.lib.format.read_array``."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._zip = zipfile.ZipFile(self._fh)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._zip.close()
        self._fh.close()

    def __getitem__(self, name: str) -> np.ndarray:
        info = self._zip.getinfo(f"{name}.npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self._zip.open(info) as f:
                return np.lib.format.read_array(f)
        # the local header: 30 bytes, then the name and the extra field
        self._fh.seek(info.header_offset)
        local = self._fh.read(30)
        skip = int.from_bytes(local[26:28], "little") + \
            int.from_bytes(local[28:30], "little")
        self._fh.seek(info.header_offset + 30 + skip)
        raw = np.empty(info.file_size, np.uint8)
        if self._fh.readinto(memoryview(raw)) != info.file_size or \
                zlib.crc32(raw) != info.CRC:
            raise IOError(f"{name}: a short read or a bad CRC-32")
        head = io.BytesIO(raw[:4096].tobytes())
        version = np.lib.format.read_magic(head)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(head)
        return raw[head.tell():].view(dtype).reshape(
            shape, order="F" if fortran else "C")


def restore(path: str, like: Any, device=None,
            step: Optional[int] = None,
            sink: Optional[Callable] = None) -> Any:
    """The checkpoint (the latest, or ``step``) as a tree shaped like
    ``like``: each leaf a tensor of the stored dtype and shape, on
    ``device`` (default: the ``like`` leaf's device where it is a
    tensor, else the CPU). Codec leaves decode through
    ``WireBuffer.decode`` on that device (K6 on the card). The stored
    shape must equal the ``like`` leaf's.

    With ``sink``, each leaf goes to ``sink(key, t)`` as soon as it is
    read, and what ``sink`` returns takes its place in the tree: a raw
    leaf as a CPU tensor over the bytes read (not moved to ``device``), a
    codec leaf decoded on ``device``. So a caller can copy each leaf
    where it belongs with one leaf in memory at a time."""
    d = _resolve_dir(path, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {l["key"]: l for l in manifest["leaves"]}
    with _Npz(os.path.join(d, "arrays.npz")) as data:
        def leaf(k, v):
            ent = by_key[k]
            dev = device if device is not None else (
                v.device if isinstance(v, torch.Tensor) else "cpu")
            raw = data[ent["name"]]
            shape = tuple(ent["shape"])
            if ent.get("codec"):
                wb = WireBuffer(
                    payload=torch.from_numpy(np.array(raw)).to(dev),
                    scale=torch.from_numpy(
                        np.array(data[f"{ent['name']}_scale"])).to(dev),
                    spec=ent["codec"], shape=shape)
                t = wb.decode().to(_TORCH_DTYPES[ent["dtype"]])
            else:
                t = _from_bytes(raw, ent["dtype"], shape)
                if sink is None:
                    t = t.to(dev)
            want = tuple(getattr(v, "shape", np.shape(v)))
            if tuple(t.shape) != want:
                raise ValueError(f"{k}: stored shape {tuple(t.shape)} != "
                                 f"{want}")
            return t if sink is None else sink(k, t)
        return tree_map_with_path(leaf, like)


def latest_step(path: str) -> Optional[int]:
    steps = _list_steps(path)
    if steps:
        return steps[-1]
    try:  # flat layout
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None


def read_extra(path: str, step: Optional[int] = None) -> Dict:
    """Host-side resume metadata stored beside a checkpoint."""
    d = _resolve_dir(path, step)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("extra") or {}
    except FileNotFoundError:
        return {}
