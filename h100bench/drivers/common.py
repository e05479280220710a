"""What the drivers share: the program's model from a configuration, the
inputs made from the seed, and completion times read on the device."""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from .. import configs
from ..reference.darknet import Network


def network(config: Dict) -> Network:
    return Network(configs.cfg_text(config), config["resolution"])


def program_model(config: Dict, device):
    """The program's model of ``config`` on ``device`` (its own seeded
    initialisation, which the harness's weights then replace)."""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.models import YoloModel

    graph = graph_from_darknet(dk.Darknet.from_str(configs.cfg_text(config)))
    return YoloModel(graph, device=device)


def smooth_images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """[n, 3, size, size] float32 in [0, 1]: noise at three scales, so that
    the picture has structure at every level of the network."""
    out = torch.zeros((n, 3, size, size), device=device)
    for cells, weight in ((size // 32, 0.6), (size // 8, 0.3), (size, 0.1)):
        noise = torch.rand((n, 3, cells, cells), generator=gen, device=device)
        out += weight * torch.nn.functional.interpolate(noise, size=(size, size), mode="bilinear",
                                                         align_corners=False)
    return out.clamp_(0.0, 1.0)


def frames_u8(gen: torch.Generator, sizes: List[tuple], device) -> List:
    """Source frames [h, w, 3] uint8 on the host, one of each (h, w)."""
    out = []
    for h, w in sizes:
        img = torch.zeros((1, 3, h, w), device=device)
        for cells, weight in ((24, 0.6), (96, 0.3)):
            noise = torch.rand((1, 3, cells, cells * w // h), generator=gen, device=device)
            img += weight * torch.nn.functional.interpolate(noise, size=(h, w), mode="bilinear",
                                                            align_corners=False)
        img += 0.1 * torch.rand((1, 3, h, w), generator=gen, device=device)
        out.append((img[0].permute(1, 2, 0).clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy())
    return out


class Clock:
    """Completion times of queued work, in seconds from :meth:`start`: on a
    card from events recorded behind the work, elsewhere by waiting."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: List = []

    def start(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
            self.origin = torch.cuda.Event(enable_timing=True)
            self.origin.record()
        self.t0 = time.perf_counter()
        return self.t0

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter() - self.t0)

    def wait(self, back: int) -> None:
        """Wait until the work ``back`` marks before the last has ended."""
        if self.cuda and len(self.marks) > back:
            self.marks[-1 - back].synchronize()

    def times(self) -> List[float]:
        if not self.cuda:
            return list(self.marks)
        torch.cuda.synchronize()
        return [self.origin.elapsed_time(e) / 1e3 for e in self.marks]


def leaf_name(program_name: str) -> str:
    """``layers.layer12.bn.scale`` → ``12.scale``, the reference's name."""
    parts = program_name.split(".")
    return f"{parts[1][len('layer'):]}.{parts[-1]}"


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
