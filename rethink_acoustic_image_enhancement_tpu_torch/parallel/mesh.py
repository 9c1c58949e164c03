"""Device meshes (the JAX package's ``parallel/mesh.py``).

A mesh is a (data, spatial, model) grid of devices, the axes named as the
JAX package names them:

  * ``data``: batches split over copies of a model, one a device
    (``devices=[...]`` on the predictors, ``eval/infer.py``);
  * ``spatial``: one image's rows split into bands, one a device
    (``parallel/spatial.py``, ``TeacherPredictor(mesh=...)``); in training
    one a rank (``train.spatial_shard``, ``parallel.init_grid``), not a
    mesh;
  * ``model``: tensor parallelism, one model split over the devices of the
    axis, shard j holding its heads and hidden channels of every
    TransformerBlock (``parallel/tensor.py``, ``models/shards.py``): in
    serving ``TeacherPredictor(mesh=...)``; in training one a rank
    (``train.model_shard``, ``parallel.init_grid``, ``RankShards``), not a
    mesh.

The JAX module's ``batch_sharding``, ``replicated`` and
``shard_batch_pytree`` are XLA placements (shardings that ``jit`` reads) and
have no counterpart: the port places its tensors itself, band by band or
copy by copy. ``process_shard`` is ``parallel/collectives.py``'s.
``model_param_specs`` (every conv's output channels sharded, XLA inserting
the collectives) has none either: the port splits each block's weights
itself, by heads and by hidden channels (``models/shards.py``:
``shard_teacher`` for serving, ``shard_module`` and ``shard_layout`` for
training), and adds the partial sums itself. Its second defect (grouped-conv
kernel gradients scaled on a ``model`` axis) is XLA's: the port's
``train.model_shard`` still sets ``dwconv_shift``, so that it trains the
model the JAX package trains.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SPATIAL_AXIS, MODEL_AXIS)


class Mesh:
    """A (data, spatial, model) grid of ``torch.device``s; ``shape`` maps
    each axis name to its size, as JAX's ``mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is a {len(AXES)}-D grid of devices, "
                             f"got shape {devices.shape}")
        self.devices = devices
        self.axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def spatial_devices(self) -> list[torch.device]:
        """The devices of the first spatial row: the bands of one image."""
        return list(self.devices[0, :, 0])

    def data_devices(self) -> list[torch.device]:
        """The devices along the data axis (spatial and model index 0)."""
        return list(self.devices[:, 0, 0])

    def model_devices(self) -> list[torch.device]:
        """The devices along the model axis (data and spatial index 0): the
        shards of one model."""
        return list(self.devices[0, 0, :])

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(n_data: int | None = None, n_spatial: int = 1, n_model: int = 1,
              devices: Sequence[str | torch.device] | None = None) -> Mesh:
    """A (data, spatial, model) mesh over ``devices``: every CUDA device
    when None (raises where there is none; name ``devices=["cpu"] * n`` for
    the CPU). ``n_data`` None takes what the other axes leave. Raises the
    JAX package's ValueError when the grid needs more devices than given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[...] (for example "
                "['cpu'] * n) to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // (n_spatial * n_model)
    need = n_data * n_spatial * n_model
    if need > len(devices):
        raise ValueError(
            f"mesh {n_data}x{n_spatial}x{n_model} needs {need} devices, "
            f"have {len(devices)}")
    if need < 1:
        raise ValueError(f"mesh {n_data}x{n_spatial}x{n_model} has no device")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_data, n_spatial, n_model))
