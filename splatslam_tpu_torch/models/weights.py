"""Tracker weights: a flax `.msgpack` checkpoint or a torch `droid.pth` →
a DroidNet (counterpart of splatslam_tpu/models/weights.py).

  * `.msgpack` (the in-repo checkpoints): the flax serialisation is plain
    msgpack whose arrays are ext type 1 holding (shape, dtype, buffer); it
    is decoded here by a small reader of the msgpack wire format, so neither
    flax nor a msgpack package is needed. Kernels go HWIO → OIHW and the
    flax module path maps onto the checkpoint's torch names.
  * `droid.pth`: the reference surgery (src/slam.py:74-85) — the `module.`
    DataParallel prefix is stripped and the delta/weight heads are sliced to
    2 output channels.

`load_droid_params` falls back between checkpoints exactly as the JAX
package does, with the same printed warnings, and records which file the
weights came from in `model.weights_source` ("random" when none was found).
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .. import resolve_device
from .droid_net import DroidNet, compute_dtype

FALLBACKS = ("pretrained/droid_dba.msgpack",
             "pretrained/droid_selftrained.msgpack")


# ---------------------------------------------------------------------------
# msgpack wire format (the subset a serialised parameter tree uses, and the
# rest of the scalar and container types for good measure)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# name mapping
# ---------------------------------------------------------------------------

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


def torch_state_to_state_dict(state_dict) -> dict:
    """A reference `droid.pth` state dict → this DroidNet's: `module.`
    stripped (slam.py:77), the delta/weight heads sliced to 2 output
    channels (slam.py:79-82), names outside the network dropped."""
    state = {k.replace("module.", ""): torch.as_tensor(np.asarray(v))
             for k, v in state_dict.items()}
    for head in ("update.weight.2", "update.delta.2"):
        for leaf in ("weight", "bias"):
            if f"{head}.{leaf}" in state:
                state[f"{head}.{leaf}"] = state[f"{head}.{leaf}"][:2]
    names = {f"{t}.{leaf}" for t in MAPPING for leaf in ("weight", "bias")}
    return {k: v.float() for k, v in state.items() if k in names}


def _model_from_state(state, device, dtype, source):
    model = DroidNet(device="cpu")
    # cnet's stride-1 blocks have no downsample; every other name must be
    # there, and none may be left over
    model.load_state_dict(state, strict=True)
    model.to(device=device, dtype=dtype)
    model.weights_source = source
    return model


def _load_file(path, device, dtype):
    if path.endswith(".msgpack"):
        state = flax_tree_to_state_dict(read_msgpack_tree(path))
    else:
        state = torch_state_to_state_dict(
            torch.load(path, map_location="cpu"))
    return _model_from_state(state, device, dtype, path)


def load_droid_params(path: str, device=None, dtype=None, generator=None):
    """The tracker network with its weights, on `device` (None is the GPU)
    in `dtype` (None is compute_dtype()): the configured torch `droid.pth`
    or flax `.msgpack`; else, loudly, an in-repo checkpoint; else, loudly, a
    random initialisation from `generator` (seed 0 when None).
    `model.weights_source` names the file that was loaded, or "random"."""
    device = resolve_device(device)
    dtype = compute_dtype() if dtype is None else dtype
    if path and os.path.exists(path):
        return _load_file(path, device, dtype)
    if path:
        # fail LOUD on a configured-but-missing path: silently falling back
        # to other weights turns a config typo into garbage tracking with
        # nothing in the log
        print(f"[weights] WARNING: tracking.pretrained={path!r} does not "
              "exist — falling back to in-repo checkpoints", flush=True)
    # prefer the stage-2 net (trained through the differentiable BA layer)
    # over the flow-only stage-1 net
    for alt in FALLBACKS:
        if os.path.exists(alt):
            print(f"[weights] loading {alt}", flush=True)
            return _load_file(alt, device, dtype)
    print("[weights] WARNING: no checkpoint found — RANDOM tracker weights "
          "(oracle mode unaffected)", flush=True)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = DroidNet(device="cpu", generator=generator)
    return model.to(device=device, dtype=dtype)
