"""Point clouds made from a seed on the device: the benchmark's inputs.

A shape is the surface of a few parts (boxes and ellipsoids, as a chair
or a lamp is made of seat, legs, shade), each with its own half-extents,
centre and rotation; its points are split evenly over its parts, and the
shape is centred on its centroid and scaled into the unit sphere, as
ShapeNetPart's clouds are. Everything is drawn in a few large calls from
one ``torch.Generator`` on the device, so the same seed gives the same
clouds and making them costs milliseconds.

The parameters come from a workload file's ``clouds`` object:
``parts`` (parts a shape), ``box_share`` (the chance that a part is a
box), ``half_extent`` ([low, high] of a part's half-extents) and
``spread`` (a part's centre is uniform in [-spread, spread]^3).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tensor = torch.Tensor


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for the ``stream``-th use of ``seed`` (any whole
    number): independent streams for weights, inputs and sampling."""
    words = np.random.SeedSequence([int(seed), int(stream)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for the ``stream``-th use of ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def _rotations(q: Tensor) -> Tensor:
    """(..., 4) unnormalized quaternions -> (..., 3, 3) rotations."""
    w, x, y, z = (q / q.norm(dim=-1, keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


@torch.no_grad()
def make_clouds(count: int, num_point: int, params: Dict,
                g: torch.Generator, device: torch.device) -> Tensor:
    """(count, num_point, 3) f32 clouds on ``device``, drawn from ``g``."""
    parts = int(params["parts"])
    lo, hi = params["half_extent"]
    spread = float(params["spread"])
    kw = dict(generator=g, device=device)
    half = torch.rand((count, parts, 3), **kw) * (hi - lo) + lo
    centre = (torch.rand((count, parts, 3), **kw) * 2 - 1) * spread
    rot = _rotations(torch.randn((count, parts, 4), **kw))
    is_box = torch.rand((count, parts), **kw) < float(params["box_share"])
    part = torch.arange(num_point, device=device) % parts          # (N,)
    # Ellipsoid: a uniform direction on the sphere, stretched.
    u = torch.randn((count, num_point, 3), **kw)
    ell = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    # Box: uniform on a face chosen by axis and sign.
    box = torch.rand((count, num_point, 3), **kw) * 2 - 1
    axis = torch.randint(0, 3, (count, num_point), **kw)
    sign = torch.where(torch.rand((count, num_point), **kw) < 0.5, -1.0, 1.0)
    box.scatter_(2, axis[..., None], sign[..., None])
    pts = torch.where(is_box[:, part, None], box, ell) * half[:, part]
    pts = torch.einsum("snij,snj->sni", rot[:, part], pts) + centre[:, part]
    pts = pts - pts.mean(dim=1, keepdim=True)
    return (pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]).contiguous()
