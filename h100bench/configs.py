"""A configuration: ``configs/<name>.json``, its darknet cfg beside it.

The JSON holds the darknet cfg's file name (``cfg``), the [net] keys as
they are run (``resolution``, the cfg's width and height; ``batch``,
``subdivisions``), the compute dtype, the optimizer the training step
runs, and which of these differ from the source (``reduced``, with the
source's values in ``source_values``).  ``cfg_text`` is the darknet cfg
with the run's input size written into [net], so that the anchors, which
darknet gives in pixels of the net input, are read against that size by
both sides.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> Dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        config = json.load(f)
    config["name"] = name
    return config


def cfg_text(config: Dict, size: int = 0) -> str:
    """The darknet cfg, [net] width and height set to ``size`` (the
    configuration's own when 0)."""
    with open(os.path.join(HERE, "configs", config["cfg"])) as f:
        text = f.read()
    size = size or config["resolution"]
    end = text.index("\n[")          # [net] is the first section
    net, body = text[:end], text[end:]
    for key in ("width", "height"):
        net = re.sub(rf"(?m)^\s*{key}\s*=.*$", f"{key}={size}", net)
    return net + body
