"""The reference's own reader of the shipped tracker checkpoint
(`pretrained/droid_dba.msgpack`): the msgpack wire format of a flax
parameter tree, decoded by a small reader, and the flax module paths
mapped onto the network's parameter names (kernels HWIO -> OIHW).

Frozen copy of the reader and the name mapping of the port's
`models/weights.py`, taken when the benchmark was written: it imports
nothing of the program, so the reference reads the weights itself.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .droid_net import DroidNet


def _unpack(buf, pos, ext_hook):
    b = buf[pos]
    pos += 1

    def raw(n):
        nonlocal pos
        out = buf[pos:pos + n]
        pos += n
        return out

    def num(fmt):
        return struct.unpack(">" + fmt, raw(struct.calcsize(fmt)))[0]

    def seq(n, as_map):
        nonlocal pos
        items = []
        for _ in range(2 * n if as_map else n):
            v, pos = _unpack(buf, pos, ext_hook)
            items.append(v)
        return dict(zip(items[::2], items[1::2])) if as_map else items

    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8f:
        return seq(b & 0x0f, True), pos
    if 0x90 <= b <= 0x9f:
        return seq(b & 0x0f, False), pos
    if 0xa0 <= b <= 0xbf:
        return bytes(raw(b & 0x1f)).decode(), pos
    if b == 0xc0:
        return None, pos
    if b in (0xc2, 0xc3):
        return b == 0xc3, pos
    if b in (0xc4, 0xc5, 0xc6):                    # bin 8/16/32
        return bytes(raw(num("BHI"[b - 0xc4]))), pos
    if b in (0xc7, 0xc8, 0xc9):                    # ext 8/16/32
        n = num("BHI"[b - 0xc7])
        code = num("b")
        return ext_hook(code, bytes(raw(n))), pos
    if b in (0xca, 0xcb):
        return num("fd"[b - 0xca]), pos
    if 0xcc <= b <= 0xcf:
        return num("BHIQ"[b - 0xcc]), pos
    if 0xd0 <= b <= 0xd3:
        return num("bhiq"[b - 0xd0]), pos
    if 0xd4 <= b <= 0xd8:                          # fixext 1/2/4/8/16
        code = num("b")
        return ext_hook(code, bytes(raw(1 << (b - 0xd4)))), pos
    if b in (0xd9, 0xda, 0xdb):                    # str 8/16/32
        return bytes(raw(num("BHI"[b - 0xd9]))).decode(), pos
    if b in (0xdc, 0xdd):
        return seq(num("HI"[b - 0xdc]), False), pos
    if b in (0xde, 0xdf):
        return seq(num("HI"[b - 0xde]), True), pos
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")


def _flax_ext(code, data):
    """flax.serialization's ext type 1: an ndarray as (shape, dtype name,
    buffer)."""
    if code != 1:
        raise ValueError(f"msgpack: unsupported flax ext type {code}")
    shape, dtype, buffer = _unpack(memoryview(data), 0, _flax_ext)[0]
    return np.frombuffer(buffer, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_msgpack_tree(path):
    """A flax-serialised parameter tree as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    tree, pos = _unpack(memoryview(data), 0, _flax_ext)
    if pos != len(data):
        raise ValueError(f"{path}: {len(data) - pos} trailing bytes")
    return tree


def _enc_mapping(prefix: str):
    """torch name → flax path for a BasicEncoder."""
    m = {f"{prefix}.conv1": (prefix, "conv1"),
         f"{prefix}.conv2": (prefix, "conv2")}
    for L in ("layer1", "layer2", "layer3"):
        for i in range(2):
            for c in ("conv1", "conv2"):
                m[f"{prefix}.{L}.{i}.{c}"] = (prefix, f"{L}_{i}", c)
            m[f"{prefix}.{L}.{i}.downsample.0"] = (prefix, f"{L}_{i}",
                                                   "downsample")
    return m


_UPDATE_MAPPING = {
    "update.corr_encoder.0": ("update", "corr_enc_0"),
    "update.corr_encoder.2": ("update", "corr_enc_2"),
    "update.flow_encoder.0": ("update", "flow_enc_0"),
    "update.flow_encoder.2": ("update", "flow_enc_2"),
    "update.weight.0": ("update", "weight_0"),
    "update.weight.2": ("update", "weight_2"),
    "update.delta.0": ("update", "delta_0"),
    "update.delta.2": ("update", "delta_2"),
    "update.gru.convz": ("update", "gru", "convz"),
    "update.gru.convr": ("update", "gru", "convr"),
    "update.gru.convq": ("update", "gru", "convq"),
    "update.gru.w": ("update", "gru", "w"),
    "update.gru.convz_glo": ("update", "gru", "convz_glo"),
    "update.gru.convr_glo": ("update", "gru", "convr_glo"),
    "update.gru.convq_glo": ("update", "gru", "convq_glo"),
    "update.agg.conv1": ("update", "agg", "conv1"),
    "update.agg.conv2": ("update", "agg", "conv2"),
    "update.agg.eta.0": ("update", "agg", "eta_0"),
    "update.agg.upmask.0": ("update", "agg", "upmask_0"),
}

MAPPING = {**_enc_mapping("fnet"), **_enc_mapping("cnet"), **_UPDATE_MAPPING}


def flax_tree_to_state_dict(tree) -> dict:
    """A flax DroidNet parameter tree (nested dicts of arrays, kernels
    HWIO) → a state dict under the checkpoint's torch names (OIHW)."""
    state = {}
    for tname, path in MAPPING.items():
        node = tree
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
            if node is None:
                break
        if node is None:
            continue
        state[f"{tname}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1)))
        state[f"{tname}.bias"] = torch.from_numpy(
            np.array(node["bias"], np.float32))
    return state


def load_network(path, device):
    """The tracker network in float32 on `device`, its weights read from
    the checkpoint at `path`."""
    model = DroidNet(device="cpu")
    model.load_state_dict(flax_tree_to_state_dict(read_msgpack_tree(path)),
                          strict=True)
    return model.to(device=device, dtype=torch.float32)
