"""Spatial sharding: halo-exchange convolution over the ranks of a space axis.

Counterpart of ``yolodl_tpu/parallel/spatial.py``.  The reference shards the
**height** of an NHWC tensor over a ``shard_map`` mesh axis and gives each
shard its neighbours' boundary rows with ``lax.ppermute``.  Here each shard
is a rank of a ``parallel/mesh.py`` :class:`SpaceMesh`, the tensors are NCHW
(the height is dim 2), and the rows travel point to point between
neighbouring ranks (``mesh.py`` :func:`neighbour_exchange`: every send
and receive of an exchange posted before any is waited on).  A convolution of the
extended block with the usual padding in W only equals the unsharded
convolution on this shard's rows.

:func:`spatial_conv2d` is the building block; :func:`make_spatial_forward`
runs a whole height-local function over the mesh.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .mesh import SpaceMesh, _GatherAxis, _HaloRows, _single, make_space_mesh  # noqa: F401

Tensor = torch.Tensor

SPACE_AXIS = "space"


def halo_exchange(x_local: Tensor, halo: int, axis=None, fill: float = 0.0) -> Tensor:
    """Extend a height-sharded NCHW block with ``halo`` rows from each
    neighbour on ``axis`` (a space axis, ``SpaceMesh.space``; None is one
    shard): ``[B, C, Hl, W]`` → ``[B, C, Hl + 2·halo, W]``.

    ``fill`` is the global-boundary value: 0 for convolution padding,
    -inf for max pooling.  The rows travel point to point between the
    neighbouring ranks (``mesh.py`` :func:`neighbour_exchange`); the
    backward returns each halo's gradient to the rank it came from, which
    adds it to its boundary rows."""
    if halo == 0:
        return x_local
    if _single(axis):
        edge = x_local.new_full(x_local[:, :, :halo].shape, fill)
        return torch.cat([edge, x_local, edge], dim=2)
    if x_local.shape[2] < halo:
        raise ValueError(f"a shard of {x_local.shape[2]} rows cannot give a halo of {halo}")
    return _HaloRows.apply(x_local, halo, axis, fill)


def spatial_conv2d(x_local: Tensor, w: Tensor, padding: int, stride: int = 1,
                   axis=None) -> Tensor:
    """Convolution of a height-sharded NCHW tensor with the OIHW kernel
    ``w``, exact against the unsharded one.

    Requires ``padding == (k-1)//2`` ("same"-family) and each local height
    divisible by ``stride``: the YOLO conv family (k3s1, k3s2, k1s1)
    satisfies both when shards are even-sized.
    """
    kh = w.shape[2]
    if padding != (kh - 1) // 2:
        raise ValueError("spatial_conv2d supports same-padding convs only")
    # the height is padded by the halo (the global top and bottom shards
    # receive `fill` rows, the global zero padding); the width as usual
    x_ext = halo_exchange(x_local, padding, axis)
    return F.conv2d(x_ext, w.to(x_local.dtype), stride=stride, padding=(0, padding))


def make_spatial_forward(forward: Callable, mesh: SpaceMesh) -> Callable:
    """Run a height-local ``forward(x_local)`` over ``mesh``'s space axis.

    ``forward`` must be built from :func:`spatial_conv2d` (with ``axis=
    mesh.space``) and elementwise ops (nothing that reduces across rows).
    The returned function takes the full NCHW tensor on every rank, runs
    ``forward`` on this rank's rows and returns the full output, gathered
    along the height.  That output stands for the reference's
    height-sharded one: a loss over it, computed alike on every rank, is
    one loss, so the gather's backward keeps this rank's rows of the
    gradient, with no sum (the input's gradient then lies in each rank's
    own rows of it)."""
    space = mesh.space

    def run(x: Tensor) -> Tensor:
        h = x.shape[2]
        if h % space.world_size:
            raise ValueError(f"height {h} is not divisible by {space.world_size} shards")
        part = h // space.world_size
        y = forward(x[:, :, space.rank * part:(space.rank + 1) * part])
        return y if _single(space) else _GatherAxis.apply(y, space, 2)

    return run
