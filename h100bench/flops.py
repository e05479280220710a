"""Parameters and forward FLOPs of a darknet network, per image.

A frozen copy of the measured program's ``graph/cost.py`` arithmetic for
the section kinds the reference reads: a conv has k*k*in_c*out_c weights,
a bias when it is not batch-normalized, a scale and a shift when it is,
and 2*k*k*in_c*out_c multiply-adds per output pixel; every other kind
counts 0, as darknet's BFLOPs column does.
"""

from __future__ import annotations

from typing import Tuple

from .reference.darknet import Network


def network_cost(net: Network) -> Tuple[int, int]:
    """(parameters, forward FLOPs of one image)."""
    params = flops = 0
    for layer in net.convs:
        k, ci, co = layer.opts["k"], layer.opts["in_c"], layer.out_c
        params += k * k * ci * co + (2 * co if layer.opts["bn"] else co)
        flops += 2 * k * k * ci * co * layer.out_hw[0] * layer.out_hw[1]
    return params, flops
