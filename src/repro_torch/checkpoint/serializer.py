"""Tree <-> key-value serialization for burst-buffer checkpoints.

Counterpart of ``repro/checkpoint/serializer.py`` with the same format, byte
for byte, so a checkpoint written by one package restores in the other:

- one payload per leaf, keyed by its tree path in JAX's flatten order
  (dict keys sorted, NamedTuple fields as ``.name``, sequence indices);
- a plain leaf is its raw little-endian bytes plus a dtype string
  (``"bfloat16"`` written as JAX writes it);
- a quantized leaf is int8 bytes followed by f32 scales, one per
  ``QUANT_BLOCK`` elements, the flat leaf zero-padded to a whole block;
- the manifest is the same JSON, keys in the same order.

Unlike the reference, which fetches each leaf to the host and quantizes
there, quantization runs where the leaf lives: on the card a leaf is
quantized by the CUDA kernel and only the int8 payload and the scales cross
to the host; restore copies the payload to the target leaf's device and
dequantizes there. Leaves come back in the dtype they were saved with.
A DTensor leaf is written as its whole value, so a checkpoint does not
depend on the mesh it was saved from (``launch/elastic.py`` restores it
onto another).
"""
from __future__ import annotations

import json
import math
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

QUANT_BLOCK = 2048


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path entry, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def tree_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's flatten order; ``None`` is an empty subtree."""
    out: List[Tuple[str, Any]] = []
    _collect_paths(tree, [], out)
    return out


def _collect_paths(t, prefix, out):
    # module-level recursion: a closure that calls itself would keep ``out``
    # (every leaf of the tree) alive until the garbage collector runs
    if t is None:
        return
    kids = _children(t)
    if kids is None:
        out.append(("/".join(prefix), t))
        return
    for key, child in kids:
        _collect_paths(child, prefix + [key], out)


def tree_map_with_path(fn, tree, prefix=()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(prefix), tree)
    new = [tree_map_with_path(fn, c, prefix + (k,)) for k, c in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    return type(tree)(new)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name for a torch dtype ("float32", "bfloat16", "int32")."""
    return str(dtype).removeprefix("torch.")


def default_quant_policy(path: str, leaf) -> bool:
    """Quantize optimizer moments only (m/v/vr/vc); never params or scalars."""
    if leaf.dim() < 2 or leaf.numel() < QUANT_BLOCK:
        return False
    head = path.split("/", 1)[0]
    return head in ("opt_state",) and not path.endswith("step")


def _host_bytes(t: torch.Tensor) -> memoryview:
    """``t``'s bytes on the host, as a read-only view of one host copy of
    the tensor: the buffer's chunks are views of it until its servers copy
    them into their stores (no ``tobytes`` copy, and no copy of each chunk
    sliced from one)."""
    if not t.numel():      # a zero-size leaf (Adafactor's (0,) sentinels)
        return memoryview(b"")
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    # the view must not alias a live CPU tensor that a later step updates
    host = flat.cpu() if flat.is_cuda else flat.clone()
    return memoryview(host.numpy()).toreadonly()


def _device_bytes(payload: bytes, device) -> torch.Tensor:
    """A uint8 copy of ``payload`` on ``device``."""
    with warnings.catch_warnings():
        # the tensor aliases the read-only bytes only until the copy below
        warnings.filterwarnings("ignore", message="The given buffer is not "
                                "writable")
        return torch.frombuffer(payload, dtype=torch.uint8).to(device,
                                                               copy=True)


def _whole(leaf: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (gathered from its mesh: every rank of the
    mesh serializes the same leaves in the same order), as the reference's
    ``np.asarray`` gathers a sharded array; any other tensor as it is."""
    if type(leaf) is torch.Tensor:
        return leaf
    from torch.distributed.tensor import DTensor
    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def serialize_leaf(leaf: torch.Tensor, quantize: bool
                   ) -> Tuple[memoryview, dict]:
    """Returns (payload, metadata dict); the payload is a read-only
    bytes-like view. A DTensor leaf is written as its whole value, byte for
    byte the checkpoint of the plain tensor."""
    leaf = _whole(leaf)
    meta = {"shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype),
            "quant": False}
    if not quantize:
        return _host_bytes(leaf), meta
    flat = leaf.detach().reshape(-1).to(torch.float32)
    pad = (-flat.shape[0]) % QUANT_BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    q, scales = kops.quantize_blockwise(flat.contiguous(), block=QUANT_BLOCK)
    # one device-to-host copy of the int8 payload and its scales
    data = _host_bytes(torch.cat([q, scales.view(torch.int8)]))
    meta.update(quant=True, pad=int(pad), nq=q.numel(), block=QUANT_BLOCK)
    return data, meta


def deserialize_leaf(payload: bytes, meta: dict, device="cpu"):
    """A tensor on ``device`` in the saved shape and dtype. Raises on a
    payload of another length than the metadata implies (a short read
    must not come back as whatever memory an empty tensor holds)."""
    shape = tuple(meta["shape"])
    dtype = getattr(torch, meta["dtype"])
    want = (meta["nq"] + 4 * (meta["nq"] // meta["block"]) if meta["quant"]
            else math.prod(shape) * dtype.itemsize)
    if len(payload) != want:
        raise ValueError(f"{meta.get('name', 'leaf')}: payload of "
                         f"{len(payload)} bytes, {want} expected for "
                         f"{meta['dtype']} {list(shape)}")
    if not payload:         # a zero-size leaf
        return torch.empty(shape, dtype=dtype, device=device)
    raw = _device_bytes(payload, device)
    if not meta["quant"]:
        return raw.view(dtype).reshape(shape)
    nq = meta["nq"]
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    x = kops.dequantize_blockwise(raw[:nq].view(torch.int8),
                                  raw[nq:].view(torch.float32),
                                  block=meta["block"], out_dtype=out_dtype)
    return x[:math.prod(shape)].reshape(shape).to(dtype)


def serialize_leaves(tree, quant_policy: Optional[Callable] = None,
                     manifest: Optional[dict] = None
                     ) -> Iterator[Tuple[str, memoryview, dict]]:
    """Yields (key, payload, metadata) leaf by leaf, in manifest order, each
    payload made only when the one before it has been taken, so a caller
    that writes each away holds one leaf's bytes on the host at a time.
    ``manifest`` (a dict) is filled as ``serialize_tree`` returns it."""
    quant_policy = quant_policy or (lambda p, l: False)
    manifest = {} if manifest is None else manifest
    manifest.update(leaves=[], treedef=None)
    offset = 0
    for name, leaf in tree_paths(tree):
        data, meta = serialize_leaf(leaf, quant_policy(name, leaf))
        meta.update(name=name, offset=offset, nbytes=len(data))
        manifest["leaves"].append(meta)
        offset += len(data)
        yield name, data, meta
        del data
    manifest["total_bytes"] = offset


def serialize_tree(tree, quant_policy: Optional[Callable] = None
                   ) -> Tuple[Dict[str, bytes], dict]:
    """Returns ({key: payload}, manifest). Manifest records order, offsets
    (for the logical checkpoint file), and per-leaf metadata."""
    manifest: dict = {}
    payloads = {name: bytes(data) for name, data, _ in
                serialize_leaves(tree, quant_policy, manifest)}
    return payloads, manifest


def deserialize_tree(target_tree, payloads: Dict[str, bytes], manifest: dict):
    """Rebuild tensors in the structure of ``target_tree`` (e.g. a freshly
    initialized state), each on its target leaf's device."""
    metas = {m["name"]: m for m in manifest["leaves"]}
    return tree_map_with_path(
        lambda name, leaf: deserialize_leaf(
            payloads[name], metas[name],
            device=getattr(leaf, "device", "cpu")),
        target_tree)


def manifest_bytes(manifest: dict) -> bytes:
    return json.dumps(manifest).encode()


def manifest_from_bytes(data: bytes) -> dict:
    return json.loads(data.decode())
