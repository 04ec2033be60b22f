"""Persistence and checkpoint helpers (counterpart of
`dust_tpu/utils/helper.py`).

An episode carry (the generator, the observation, the controller, SVMPC
and MPF states: tensors in frozen dataclasses, tuples and dicts)
round-trips through one file with its `torch.Generator` states, CPU or
CUDA, so a resumed episode equals an uninterrupted one bit for bit. The
file holds only tensors, numbers, strings and containers (read back with
`torch.load(weights_only=True)`); a dataclass is stored by its module and
name and rebuilt from its fields.

`save_progress` writes `config.yaml` with PyYAML.
`create_video_from_plots` stitches PNG frames into an MP4 with moviepy or
OpenCV.
"""

from __future__ import annotations

import dataclasses
import importlib
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device


def get_project_root():
    return Path(__file__).parent.parent.parent


def _map_tree(fn, tree):
    """fn on every leaf of a tree of dicts, lists, tuples and dataclasses
    (rebuilt with their fields)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tree(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return fn(tree)


def to_numpy_tree(tree):
    """Tensors in a tree -> numpy arrays (one host copy each, for
    pickling)."""
    return _map_tree(lambda x: to_np(x) if isinstance(x, torch.Tensor)
                     else x, tree)


def save_progress(folder_name=None, data=None, params=None, fig=None,
                  fig_name="plot.pdf", root=None):
    """Timestamped results folder `data/local/<name>/` under `root` (the
    project root by default) with an optional data pickle, config yaml
    and figure, as the reference lays it out."""
    if folder_name is None:
        folder_name = time.strftime("%Y%m%d-%H%M%S")
    root_path = Path(root) if root is not None else get_project_root()
    folder_path = root_path / "data" / "local" / str(folder_name)
    folder_path.mkdir(parents=True, exist_ok=True)
    if fig is not None:
        plot_path = folder_path / "plots"
        plot_path.mkdir(exist_ok=True)
        fig.savefig(plot_path / fig_name)
    if data is not None:
        with (folder_path / "data.pkl").open("wb") as fh:
            pickle.dump(to_numpy_tree(data), fh)
    if params is not None:
        import yaml

        with (folder_path / "config.yaml").open("w") as fh:
            yaml.dump(params, fh)
    return folder_path


def _encode(obj):
    """A carry as tensors, numbers, strings and containers only."""
    if isinstance(obj, torch.Generator):
        return {"__generator__": str(obj.device), "state": obj.get_state()}
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": obj.detach().cpu(), "device": str(obj.device)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {"__dict__": [(k, _encode(v)) for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"__" + type(obj).__name__ + "__": [_encode(v) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _decode(obj, device):
    if not isinstance(obj, dict):
        return obj
    if "__generator__" in obj:
        gen = torch.Generator(device=device or obj["__generator__"])
        gen.set_state(obj["state"])
        return gen
    if "__tensor__" in obj:
        return obj["__tensor__"].to(device or obj["device"])
    if "__dataclass__" in obj:
        module, name = obj["__dataclass__"].split(":")
        cls = importlib.import_module(module)
        for part in name.split("."):
            cls = getattr(cls, part)
        return cls(**{k: _decode(v, device)
                      for k, v in obj["fields"].items()})
    if "__dict__" in obj:
        return {k: _decode(v, device) for k, v in obj["__dict__"]}
    if "__list__" in obj:
        return [_decode(v, device) for v in obj["__list__"]]
    return tuple(_decode(v, device) for v in obj["__tuple__"])


def save_checkpoint(path, carry, step=None, extra=None):
    """Checkpoint an episode carry (and metadata) for a deterministic
    resume: every tensor, dataclass and `torch.Generator` state of
    `carry`. `extra` holds numbers, strings, tensors and containers."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"carry": _encode(carry), "step": step,
                "extra": _encode(extra)}, path)
    return path


def load_checkpoint(path, device=None):
    """Returns (carry, step, extra): the carry rebuilt with its tensors
    and generators on the devices they were saved from (or on `device`)."""
    payload = torch.load(path, weights_only=True)
    dev = None if device is None else str(resolve_device(device))
    return (_decode(payload["carry"], dev), payload["step"],
            _decode(payload["extra"], dev))


def create_video_from_plots(save_path, plot_path=None, fps=20):
    """Stitch the PNG frames of `plot_path` (default `save_path/plots`)
    into `save_path/video.mp4`, with moviepy where it is installed, else
    OpenCV's VideoWriter; returns the video's path, or None (with a
    message) where neither is installed or there are no frames."""
    save_path = Path(save_path)
    if plot_path is None:
        plot_path = save_path / "plots"
    out = save_path / "video.mp4"
    try:
        import moviepy.editor as mpy
    except ImportError:
        pass
    else:
        video = mpy.ImageSequenceClip(str(plot_path), fps=fps)
        video.write_videofile(str(out))
        return out
    try:
        import cv2
    except ImportError:
        print("Neither MoviePy nor OpenCV available. Aborting video "
              "creation.")
        return None
    frames = sorted(Path(plot_path).glob("*.png"))
    if not frames:
        print(f"No PNG frames in {plot_path}. Aborting video creation.")
        return None
    first = cv2.imread(str(frames[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        str(out), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        print("OpenCV VideoWriter failed to open. Aborting video creation.")
        return None
    try:
        for frame in frames:
            img = cv2.imread(str(frame))
            if img.shape[:2] != (h, w):
                img = cv2.resize(img, (w, h))
            writer.write(img)
    finally:
        writer.release()
    return out


def to_np(x):
    """A tensor (or a list of them) as numpy arrays on the host."""
    if isinstance(x, list):
        return [to_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_np(x, device="cuda"):
    """A numpy array (or a list of them) as tensors on `device`."""
    dev = resolve_device(device)
    if isinstance(x, list):
        return [torch.as_tensor(v, device=dev) for v in x]
    return torch.as_tensor(x, device=dev)
